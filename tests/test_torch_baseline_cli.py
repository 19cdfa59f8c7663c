"""The baselines' CLIs on the CPU at narrow width (elements 64, h_size 8,
nfreq 8), on one 3-action episode of the port's datagen with 100 steps a
window (48^2, 16^2 observations) saved as the datagen CLI saves it:

- `scripts/train.py --model node` and `--model pinn` take one update each,
  and the checkpoint each writes loads in the JAX package's
  `load_checkpoint` (parameters and Adam's state), its parameters bit for
  bit the port's;
- `scripts/prediction.py --acoustic --node --pinn` gives, for horizons 1
  and 2, the per-sample scattered-energy MSEs of a direct computation (the
  same samples one at a time: 1e-6 relative, the PINN's chunked
  `predict_energy` against its forward 1e-4), writes them to its JSON,
  resumes from it, and refuses to overwrite it;
- its `loess` smoother is `scripts_tpu/prediction.py`'s, bit for bit;
- a tiny `scripts/pinn_acceptance.py` run has finite, falling losses and a
  finite energy error, as JAX's `test_pinn_acceptance_smoke`.
"""
import importlib.util
import json
import os
import re

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_node import port_episode, port_space, rel, to_jax

import waves_jl_tpu as w
from waves_jl_tpu.models import NODEEnergyModel as JaxNODE
from waves_jl_tpu.models import WaveControlPINN as JaxPINN
from waves_jl_tpu.train import load_checkpoint as jax_load
from waves_jl_tpu_torch.data import prepare_data, save_episode
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.models.node import NODEEnergyModel
from waves_jl_tpu_torch.models.pinn import WaveControlPINN
from waves_jl_tpu_torch.scripts import pinn_acceptance, prediction, train
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, save_checkpoint
from waves_jl_tpu_torch.utils.trees import tree_map

torch.set_num_threads(1)
WIDTH = dict(elements=64, h_size=8, nfreq=8)
FLAGS = ["--elements", "64", "--h-size", "8", "--nfreq", "8", "--device", "cpu"]


def port_model(which: str):
    space = port_space()
    if which == "node":
        return NODEEnergyModel(space, integration_steps=100, device="cpu", **WIDTH)
    if which == "pinn":
        return WaveControlPINN(space, 1000.0, integration_steps=100, device="cpu", **WIDTH)
    return AcousticEnergyModel(space, 1000.0, integration_steps=100, device="cpu", **WIDTH)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The dataset, and each baseline trained by the CLI for one update."""
    tmp = tmp_path_factory.mktemp("baselines")
    data = tmp / "data"
    os.makedirs(data / "episodes")
    episode = port_episode(seed=0, actions=3, steps=100)
    save_episode(episode, str(data / "episodes" / "episode1.npz"))
    out = {}
    for which in ("node", "pinn"):
        out[which] = str(tmp / which)
        train.main(["--data", str(data), "--out", out[which], "--model", which, "--episodes",
                    "1", "--horizon", "1", "--epochs", "1", "--batch", "3", "--accumulate", "1",
                    "--val-every", "1", "--val-batches", "1", "--lr", "1e-3", *FLAGS])
    return tmp, episode, out


@pytest.mark.parametrize("which", ["node", "pinn"])
def test_train_cli_checkpoint_loads_in_jax(run, which):
    _, episode, out = run
    dirs = sorted(d for d in os.listdir(out[which]) if d.startswith("checkpoint_step="))
    assert dirs == ["checkpoint_step=1"]  # one update
    records = [json.loads(x) for x in open(os.path.join(out[which], "metrics.jsonl"))]
    assert len(records) == 1 and np.isfinite(records[0]["train_loss"])
    path = os.path.join(out[which], dirs[0])

    batch = to_jax(prepare_data(episode, 1))
    space = w.build_triple_ring_design_space()
    jm = (JaxNODE.create(design_space=space, integration_steps=100, **WIDTH) if which == "node"
          else JaxPINN.create(design_space=space, source_freq=1000.0, integration_steps=100,
                              **WIDTH))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    params, opt_state, step = jax_load(path, like,
                                       opt_state_like=jax.eval_shape(optax.adam(1e-3).init, like))
    assert step == 1 and int(opt_state[0].count) == 1
    pm = port_model(which)
    assert load_model_checkpoint(pm, path) == 1
    got = from_jax_params(jax.tree_util.tree_map(np.asarray, params), kind=type(pm).__name__)
    assert set(got) == set(pm.state_dict())
    for k, v in pm.state_dict().items():
        assert torch.equal(got[k], v), k


def test_prediction_cli_gives_the_direct_mse(run):
    tmp, episode, out = run
    ckpt = {which: os.path.join(out[which], "checkpoint_step=1") for which in ("node", "pinn")}
    ckpt["acoustic"] = str(tmp / "acoustic")
    save_checkpoint(ckpt["acoustic"], port_model("acoustic"), step=0)
    js = str(tmp / "errors.json")
    argv = ["--data", str(tmp / "data"), "--acoustic", ckpt["acoustic"], "--node", ckpt["node"],
            "--pinn", ckpt["pinn"], "--episodes", "1", "--horizons", "1", "2", "--batch", "1",
            "--batches", "10", "--json-out", js, *FLAGS]
    got = prediction.main(argv)
    with open(js) as f:
        assert json.load(f) == {k: {str(h): v for h, v in r.items()} for k, r in got.items()}

    for which in ("acoustic", "node", "pinn"):
        model = port_model(which)
        load_model_checkpoint(model, ckpt[which])
        assert sorted(got[which]) == [1, 2]
        for h in (1, 2):
            data = prepare_data(episode, h)
            want = []
            with torch.no_grad():
                for i in range(data["t"].shape[0]):
                    pred = model(tree_map(lambda v: v[i:i + 1], data))
                    p_sc = pred if which == "node" else pred[:, :, 2]
                    want.append(float(((p_sc - data["y"][i:i + 1, :, 2]) ** 2).mean()))
            tol = 1e-4 if which == "pinn" else 1e-6
            assert len(got[which][h]) == 4 - h
            assert rel(sorted(got[which][h]), sorted(want)) <= tol, (which, h)

    assert prediction.main(argv + ["--resume"]) == got
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        prediction.main(argv)


def test_loess_is_the_jax_scripts():
    spec = importlib.util.spec_from_file_location("jax_prediction", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts_tpu",
        "prediction.py"))
    jax_prediction = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_prediction)
    rng = np.random.default_rng(4)
    for x, degree in (([2, 4, 6, 8, 10, 15, 20], 1), (np.arange(12.0), 2), ([1, 2], 1)):
        y = rng.standard_normal(len(x))
        np.testing.assert_array_equal(prediction.loess(x, y, degree=degree),
                                      jax_prediction.loess(x, y, degree=degree))


def test_pinn_acceptance_smoke(capsys):
    err = pinn_acceptance.main(["--device", "cpu", "--elements", "64", "--steps", "20",
                                "--h-size", "16", "--depth", "3", "--iters", "40", "--chunk",
                                "10"])
    totals = [float(m) for m in re.findall(r"total (\S+)", capsys.readouterr().out)]
    assert len(totals) == 4 and np.isfinite(totals).all()
    assert all(b < a for a, b in zip(totals, totals[1:])), totals
    assert np.isfinite(err)
