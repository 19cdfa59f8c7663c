"""The port's drawing CLIs on the CPU at small sizes, with one narrow
surrogate checkpoint written by the port (elements 64, h_size 8, nfreq 8):

- `scripts/render.py` (130^2, 1 action, frames resized to 40^2) writes
  its video (a GIF here, where there is no ffmpeg);
- `scripts/latent_space.py` writes its two drawings with a finite MSE;
- `scripts/mpc.py --render` renders an episode of the chosen controller
  after the protocol (random shooting); these three CLIs' windows are cut
  to 10 steps;
- the train CLI's per-checkpoint dashboard on the dense trainer (the
  windowed one is in tests/test_torch_train_cli.py), with no "plotting
  failed" line;
- `scripts/prediction.py --out` writes its plot, and `error_bands` is the
  JAX script's loess line and band on the same errors (1e-12);
- `scripts/pinn_acceptance.py --out` writes its three figures.

The demos `pml_demo` and `adjoint_demo` are held against JAX's in
tests/test_torch_demos.py.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from test_torch_node import port_episode
from test_torch_train_model import episodes

from waves_jl_tpu_torch.data import save_episode
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.scripts import (datagen, latent_space, mpc, pinn_acceptance, prediction,
                                        render, train)
from waves_jl_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--elements", "64", "--h-size", "8", "--nfreq", "8"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ck") / "checkpoint_step=0")
    model = AcousticEnergyModel(build_triple_ring_design_space(device="cpu"), 1000.0,
                                elements=64, h_size=8, nfreq=8, device="cpu")
    save_checkpoint(path, model, step=0)
    return path


def ten_step_windows(monkeypatch, module):
    """The CLI's env with windows of 10 steps, so it stays small on the CPU."""
    monkeypatch.setattr(module, "build_env",
                        lambda n, steps, actions, dev: datagen.build_env(n, 10, actions, dev))


def test_render_cli_writes_its_video(tmp_path, monkeypatch):
    ten_step_windows(monkeypatch, render)
    out = tmp_path / "vid.mp4"
    signals = render.main(["--n", "130", "--actions", "1", "--render-size", "40", "--device",
                           "cpu", "--out", str(out)])
    assert signals.shape == (1, 11, 3) and np.isfinite(signals).all()
    assert os.path.getsize(tmp_path / "vid.gif") > 0


def test_latent_space_cli_writes_its_dashboard(checkpoint, tmp_path, monkeypatch):
    ten_step_windows(monkeypatch, latent_space)
    r = latent_space.main(["--checkpoint", checkpoint, "--n", "130", "--actions", "2",
                           "--latent-stride", "2", *WIDTH, "--device", "cpu",
                           "--out", str(tmp_path)])
    assert r["y"].shape == (21, 3) and r["y_hat"].shape == (11, 3) and np.isfinite(r["mse"])
    assert r["z"].shape == (11, 4, 64)
    assert {"real_vs_latent_sc.png", "latent_sc.gif"} <= set(os.listdir(tmp_path))


def test_mpc_cli_renders_the_controller(checkpoint, tmp_path, monkeypatch, capsys):
    ten_step_windows(monkeypatch, mpc)
    video = tmp_path / "mpc.mp4"
    result = mpc.main(["--controller", "random_shooting", "--checkpoint", checkpoint,
                       "--latent-stride", "10", "--shots", "4", "--horizon", "1", "--n", "130",
                       "--actions", "2", "--locations", "1", "--episodes", "1", *WIDTH,
                       "--device", "cpu", "--out", str(tmp_path / "r.json"),
                       "--render", str(video)])
    assert np.isfinite(result["mean_decrease"])
    assert f"rendered {video}" in capsys.readouterr().out.splitlines()
    assert os.path.getsize(tmp_path / "mpc.gif") > 0


def test_train_cli_draws_each_checkpoint(tmp_path, capsys):
    data = tmp_path / "data"
    os.makedirs(data / "episodes")
    _, eps = episodes(3, seed=5)
    for i, ep in enumerate(eps):
        save_episode(ep, str(data / "episodes" / f"episode{i + 1}.npz"))
    train.main(["--data", str(data), "--out", str(tmp_path / "run"), "--horizon", "1",
                "--episodes", "3", "--epochs", "1", "--batch", "4", "--accumulate", "1",
                "--val-every", "3", "--steps", "8", *WIDTH, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "plotting failed" not in out
    drawn = set(os.listdir(tmp_path / "run" / "checkpoint_step=3"))
    assert {"pml.png", "force.png", "tot1.png", "inc1.png", "sc1.png", "sc2.png"} <= drawn


def test_prediction_cli_draws_its_plot(checkpoint, tmp_path):
    data = tmp_path / "data"
    os.makedirs(data / "episodes")
    save_episode(port_episode(seed=0, actions=2, steps=100),
                 str(data / "episodes" / "episode1.npz"))
    png = tmp_path / "plots" / "errors.png"
    got = prediction.main(["--data", str(data), "--acoustic", checkpoint, "--episodes", "1",
                           "--horizons", "1", "2", "--batch", "1", "--batches", "2",
                           "--json-out", str(tmp_path / "e.json"), "--out", str(png), *WIDTH,
                           "--device", "cpu"])
    assert sorted(got["acoustic"]) == [1, 2] and os.path.getsize(png) > 0
    # the plot's lines and bands, as the JAX script computes them
    spec = importlib.util.spec_from_file_location(
        "jax_prediction", os.path.join(ROOT, "scripts_tpu", "prediction.py"))
    jax_prediction = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_prediction)
    rng = np.random.default_rng(0)
    results = {"acoustic": {h: rng.uniform(0, 1, 5).tolist() for h in (2, 4, 6, 8)},
               "node": {h: rng.uniform(0, 1, 3).tolist() for h in (8, 2, 4)}}
    for name, (hs, means, smooth, half) in prediction.error_bands(results).items():
        errs = results[name]
        assert hs == sorted(errs)
        want_means = [float(np.mean(errs[h])) for h in hs]
        assert means == want_means
        np.testing.assert_allclose(smooth, jax_prediction.loess(hs, want_means), rtol=1e-12)
        np.testing.assert_allclose(half, [1.92 * float(np.std(errs[h])) / np.sqrt(len(errs[h]))
                                          for h in hs], rtol=1e-12)
    with open(tmp_path / "e.json") as f:
        assert json.load(f)["acoustic"].keys() == {"1", "2"}


def test_pinn_acceptance_cli_draws_its_figures(tmp_path):
    err = pinn_acceptance.main(["--device", "cpu", "--elements", "64", "--steps", "20",
                                "--h-size", "16", "--depth", "3", "--iters", "20", "--chunk",
                                "10", "--out", str(tmp_path / "fig")])
    assert np.isfinite(err)
    assert {"energy.png", "sol.png", "frames.png"} <= set(os.listdir(tmp_path / "fig"))
