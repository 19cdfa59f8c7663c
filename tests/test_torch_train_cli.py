"""The port's train CLI and checkpoint averaging, on the CPU: the datagen
CLI writes 3 episodes at 130^2 (8 steps a window, 3 windows), the train CLI
trains the flagship at narrow width on them (`--horizons 1 2
--latent-stride 2`, two cycles), and its newest checkpoint loads in the
JAX package's `load_checkpoint` (parameters and the accumulating
optimizer's state) and predicts what the port's model predicts from it
(1e-5 relative); `scripts/avg_checkpoints.py` averages the run's two
checkpoints as `scripts_tpu/avg_checkpoints.py` does, bit for bit; each
checkpoint directory holds the windowed trainer's dashboard (the flagship's
`make_plots_acoustic` on the validation windows), with no "plotting
failed" line; the option that waits for its port (the train CLI's `--dp` on
the CPU) exits non-zero with a message, and so does `--dp` with
`--stream`; the MPC CLI's `--fused-episode`, ported since, is no longer
refused and fails only on its missing checkpoint."""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_train_model import jax_space, port_space, rel, to_port_batch

from waves_jl_tpu.data import load_episode as jax_load_episode
from waves_jl_tpu.data import prepare_data as jax_prepare_data
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu.train import load_checkpoint as jax_load
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.scripts import avg_checkpoints
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--elements", "64", "--h-size", "8", "--nfreq", "8", "--steps", "8"]


def run(*args):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env, check=False)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    data, out = str(tmp / "data"), str(tmp / "run")
    proc = run("waves_jl_tpu_torch.scripts.datagen", "--episodes", "3", "--n", "130", "--steps",
               "8", "--actions", "3", "--format", "npz", "--device", "cpu", "--out", data)
    assert proc.returncode == 0, proc.stderr
    proc = run("waves_jl_tpu_torch.scripts.train", "--data", data, "--out", out, "--horizons",
               "1", "2", "--latent-stride", "2", "--epochs", "1", "--batch", "2",
               "--accumulate", "2", "--val-every", "1", "--lr", "1e-3", "--sc-weight", "4",
               "--device", "cpu", *WIDTH)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "plotting failed" not in proc.stdout
    checkpoints = [d for d in os.listdir(out) if d.startswith("checkpoint_step=")]
    assert checkpoints
    for d in checkpoints:
        assert {"pml.png", "force.png", "tot1.png", "inc2.png",
                "sc2.png"} <= set(os.listdir(os.path.join(out, d))), d
    return data, out


def test_train_cli_checkpoint_loads_in_jax(trained):
    data, out = trained
    steps = sorted(int(d.split("=")[1]) for d in os.listdir(out) if d.startswith("checkpoint_"))
    assert len(steps) == 2
    records = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in records] == steps
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)

    ep = jax_load_episode(os.path.join(data, "episodes", "episode3.npz"), device=False)
    batch = jax.tree_util.tree_map(lambda x: x[:2], jax_prepare_data(ep, 2, 2))
    jm = JaxModel.create(design_space=jax_space(), source_freq=1000.0, elements=64, h_size=8,
                         nfreq=8, integration_steps=4, dt=2e-5)
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    opt = optax.MultiSteps(optax.adam(1e-3), every_k_schedule=2)
    path = os.path.join(out, f"checkpoint_step={steps[-1]}")
    params, opt_state, step = jax_load(path, like, opt_state_like=jax.eval_shape(opt.init, like))
    assert step == steps[-1] and int(opt_state.gradient_step) == steps[-1]
    pm = AcousticEnergyModel(port_space(), 1000.0, elements=64, h_size=8, nfreq=8,
                             integration_steps=4, dt=2e-5, device="cpu")
    assert load_model_checkpoint(pm, path) == steps[-1]
    with torch.no_grad():
        got = pm(to_port_batch(batch)).numpy()
    assert rel(got, np.asarray(jm(params, batch))) <= 1e-5


def test_avg_checkpoints_matches_jax_script(trained, tmp_path):
    _, out = trained
    spec = importlib.util.spec_from_file_location(
        "jax_avg", os.path.join(ROOT, "scripts_tpu", "avg_checkpoints.py"))
    jax_avg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_avg)
    steps = avg_checkpoints.checkpoint_steps(out)
    assert steps == jax_avg.checkpoint_steps(out) and len(steps) == 2
    avg_checkpoints.main(["--run", out, "--last", "2", "--out", str(tmp_path / "port")])
    jax_avg.save_average(out, steps, str(tmp_path / "jax"))
    with np.load(tmp_path / "port" / "params.npz") as a, np.load(tmp_path / "jax" /
                                                               "params.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert (json.loads((tmp_path / "port" / "meta.json").read_text())
            == json.loads((tmp_path / "jax" / "meta.json").read_text()))


@pytest.mark.parametrize("script,args", [
    ("train", ["--data", "{tmp}", "--out", "{tmp}/o", "--dp"]),
    ("mpc", ["--controller", "hybrid", "--fused-episode", "--checkpoint", "x", "--out",
             "{tmp}/r.json"]),
])
def test_options_that_wait_exit_with_a_message(script, args, tmp_path):
    proc = run(f"waves_jl_tpu_torch.scripts.{script}", "--device", "cpu",
               *[a.format(tmp=tmp_path) for a in args])
    assert proc.returncode != 0
    if script == "mpc":  # --fused-episode is ported: the run fails on the missing checkpoint
        assert "not yet ported" not in proc.stderr and "x/params.npz" in proc.stderr
    else:
        assert "not yet ported" in proc.stderr


@pytest.mark.parametrize("args,message", [
    (["--dp", "--stream"], "--dp with --stream: the streaming trainer is single-device"),
], ids=["stream"])
def test_dp_combinations_exit_with_their_message(args, message, tmp_path):
    proc = run("waves_jl_tpu_torch.scripts.train", "--data", str(tmp_path), "--out",
               str(tmp_path / "o"), *args)
    assert proc.returncode != 0 and message in proc.stderr
