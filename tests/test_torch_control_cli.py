"""The port's distillation CLIs and the MPC CLI's gradient, ensemble and
oracle controllers on the CPU at tiny sizes (`--device cpu`, 10 steps a
window or 130^2 grids, narrow surrogate checkpoints written here):

* `scripts.datagen_pools` writes `pools.json` with the JAX CLI's keys and
  one `pools<i>.npz` an episode of the layout both packages read, the
  uniform harvest and the DAgger one under a CEM + polish searcher on the
  tracked `ref500_h8s4` weights (its proposals first in each pool);
* `scripts.datagen_onpolicy` writes `env.json` and recorded episodes that
  the port's loader reads back;
* `scripts.train_pools` fine-tunes on those pools and episodes, logging
  finite losses to `metrics.jsonl` and writing checkpoints;
* `scripts.train_bc` clones the recorded episodes into a one-shot policy
  checkpoint;
* `scripts.mpc` with `--controller gradient|ensemble|oracle` writes the
  result JSON with the JAX CLI's keys, `beta` set for the ensemble only.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from waves_jl_tpu_torch.data import load_episode
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.scripts import (datagen_onpolicy, datagen_pools, mpc, train_bc,
                                        train_pools)
from waves_jl_tpu_torch.scripts.datagen import build_env
from waves_jl_tpu_torch.train.checkpoint import load_step, save_checkpoint

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURROGATE = os.path.join(ROOT, "models/ref500_h8s4/checkpoint_step=2600")
NARROW = ["--elements", "32", "--h-size", "16", "--nfreq", "12"]
POOLS_JSON = {"n", "rerank_n", "pool", "horizon", "alpha", "epsilon", "steps", "actions",
              "episodes", "refine_samples", "refine_elites", "checkpoint", "searcher_samples",
              "shots", "polish", "polish_topk", "polish_lr"}
with open(os.path.join(ROOT, "mpc_results_bc_policy.json")) as f:
    MPC_KEYS = set(json.load(f))


def narrow_checkpoint(path, seed: int) -> str:
    """A narrow flagship (32 elements, h 16, nfreq 12) drawn from `seed`."""
    model = AcousticEnergyModel(build_triple_ring_design_space(device="cpu"), 1000.0,
                                elements=32, h_size=16, nfreq=12, seed=seed, device="cpu")
    save_checkpoint(str(path), model, None, 0)
    return str(path)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """A narrow checkpoint, a uniform pool harvest and recorded episodes."""
    root = tmp_path_factory.mktemp("cli")
    ckpt = narrow_checkpoint(root / "narrow", seed=0)
    datagen_pools.main(["--out", str(root / "pools"), "--episodes", "2", "--n", "160",
                        "--rerank-n", "130", "--steps", "10", "--actions", "2", "--pool", "3",
                        "--horizon", "1", "--epsilon", "0.5", "--refine-samples", "1",
                        "--refine-elites", "2", "--device", "cpu"])
    datagen_onpolicy.main(["--out", str(root / "onpol"), "--checkpoint", ckpt, *NARROW,
                           "--episodes", "2", "--n", "130", "--steps", "10", "--actions", "2",
                           "--shots", "4", "--horizon", "1", "--format", "npz",
                           "--device", "cpu"])
    return root, ckpt


def test_datagen_pools_writes_pools_either_package_reads(made):
    root, _ = made
    with open(root / "pools" / "pools.json") as f:
        meta = json.load(f)
    assert set(meta) == POOLS_JSON and meta["pool"] == 3 and meta["searcher_samples"] == 0
    pools = datagen_pools.load_pools(str(root / "pools" / "pools2.npz"), build_env(130, 10, 1,
                                                                                   "cpu"))
    assert pools["y_true"].shape == pools["penalty"].shape == (2, 4)  # 2 states, 3 + 1 refined
    assert pools["s_wave"].shape == (2, 128, 128, 4) and pools["t0"].shape == (2,)
    assert pools["a"].config.cylinders.r.shape == (2, 4, 1, 18)
    assert pools["s_design"].config.cylinders.r.shape == (2, 18)
    assert bool(torch.isfinite(pools["y_true"]).all()) and float(pools["penalty"].min()) > 0
    np.testing.assert_array_equal(pools["t0"].numpy(), np.float32([0, 10]) * np.float32(1e-5))


def test_datagen_pools_dagger_harvest(tmp_path):
    datagen_pools.main(["--out", str(tmp_path), "--episodes", "1", "--n", "130",
                        "--rerank-n", "130", "--steps", "20", "--actions", "1", "--pool", "3",
                        "--horizon", "1", "--checkpoint", SURROGATE, "--latent-stride", "4",
                        "--shots", "4", "--cem-iters", "1", "--cem-elites", "2",
                        "--searcher-samples", "2", "--polish", "1", "--polish-topk", "1",
                        "--device", "cpu"])
    with open(tmp_path / "pools.json") as f:
        meta = json.load(f)
    assert meta["searcher_samples"] == 2 and meta["shots"] == 4 and meta["polish"] == 1
    pools = datagen_pools.load_pools(str(tmp_path / "pools1.npz"), build_env(130, 20, 1, "cpu"))
    assert pools["y_true"].shape == (1, 3) and bool(torch.isfinite(pools["y_true"]).all())


def test_datagen_onpolicy_writes_recorded_episodes(made):
    root, ckpt = made
    with open(root / "onpol" / "env.json") as f:
        meta = json.load(f)
    assert meta["onpolicy"]["checkpoint"] == ckpt and meta["integration_steps"] == 10
    ep = load_episode(str(root / "onpol" / "episodes" / "episode2.npz"), device=None)
    assert ep.s_wave.shape == (2, 128, 128, 4) and ep.y.shape == (2, 11, 3)
    assert ep.s_tspan.shape == (2, 11) and ep.a.config.cylinders.r.shape == (2, 18)
    assert bool(torch.isfinite(ep.y).all())


def test_train_pools_cli(made, tmp_path):
    root, ckpt = made
    train_pools.main(["--data", str(root / "onpol"), "--pools", str(root / "pools"),
                      "--init-from", ckpt, "--out", str(tmp_path), *NARROW, "--steps", "10",
                      "--latent-stride", "1", "--horizon", "1", "--epochs", "1", "--batch", "2",
                      "--batch-pools", "1", "--val-every", "1", "--device", "cpu"])
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]  # before, then each of 2 updates
    for r in recs[1:]:
        assert all(math.isfinite(r[k]) for k in ("anchor", "rank", "val_mse"))
    assert load_step(str(tmp_path / "checkpoint_step=2")) == 2


def test_train_bc_cli(made, tmp_path):
    root, _ = made
    train_bc.main(["--data", str(root / "onpol"), "--out", str(tmp_path), "--h-size", "16",
                   "--epochs", "1", "--batch", "2", "--val-every", "1", "--device", "cpu"])
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2 and all(math.isfinite(r["train_loss"]) for r in recs)
    assert load_step(str(tmp_path / "checkpoint_step=2")) == 2


@pytest.mark.parametrize("controller", ["gradient", "ensemble", "oracle"])
def test_mpc_cli_new_controllers(made, tmp_path, controller):
    root, ckpt = made
    args = {"gradient": ["--checkpoint", ckpt, *NARROW, "--shots", "8"],
            "ensemble": ["--checkpoint", ckpt, narrow_checkpoint(tmp_path / "second", seed=1),
                         *NARROW, "--shots", "4", "--beta", "0.5"],
            "oracle": ["--shots", "2"]}[controller]
    out = tmp_path / "result.json"
    result = mpc.main(["--controller", controller, *args, "--latent-stride", "4", "--n", "130",
                       "--actions", "1", "--horizon", "1", "--locations", "1", "--episodes", "1",
                       "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == result
    assert set(result) == MPC_KEYS and result["controller"] == controller
    assert math.isfinite(result["mean_decrease"])
    assert result["beta"] == (0.5 if controller == "ensemble" else None)
    assert result["checkpoint"] == (None if controller == "oracle" else
                                    ckpt if controller == "gradient" else args[1:3])
