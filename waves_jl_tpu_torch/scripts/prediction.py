"""Horizon-sweep prediction error of trained surrogates on the card (the
port of `scripts_tpu/prediction.py`): for each horizon, the per-sample MSE
of the scattered-energy prediction of the flagship (`--acoustic`), the
neural-ODE baseline (`--node`) and the PINN baseline (`--pinn`), written
to `--json-out` as {model: {horizon: [mse, ...]}} and flushed after every
horizon, so `--resume` picks up where a run stopped:

    python -m waves_jl_tpu_torch.scripts.prediction --data data/run1 \\
        --acoustic models/ref500_h8s4/checkpoint_step=2600 --latent-stride 4 \\
        --node models/ref500_node_r4b/checkpoint_step=2040 \\
        --pinn models/ref500_pinn_r4/checkpoint_step=2000 --horizons 2 4 8

`--out PATH` also draws the comparison plot there (needs matplotlib): each
model's mean MSE per horizon, its `loess` line and a band of 1.92 standard
errors about it (`error_bands`). `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from waves_jl_tpu_torch.data import (concat_datasets, dataloader, load_episode,
                                     load_episodes_shard, prepare_data)
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.node import NODEEnergyModel
from waves_jl_tpu_torch.models.pinn import WaveControlPINN
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
from waves_jl_tpu_torch.utils.trees import tree_map



@torch.no_grad()
def sweep(model, eps, horizons, batch: int, batches: int, scalar_out: bool, stride: int = 1,
          fwd_fn=None, done: dict | None = None, on_horizon=None) -> dict:
    """{horizon: per-sample MSE list} over at most `batches` shuffled
    minibatches of each horizon's windows. `done` (horizon -> errors)
    seeds results and skips those horizons; `on_horizon(errors so far)`
    runs after each new horizon, so a caller can persist partial
    results."""
    errors = dict(done or {})
    fwd = fwd_fn or model
    for h in horizons:
        if h in errors:
            print(f"horizon {h}: mse {np.mean(errors[h]):.5g} (resumed)", flush=True)
            continue
        data = concat_datasets([prepare_data(ep, h, stride) for ep in eps])
        errs = []
        for i, b in enumerate(dataloader(data, batch, torch.Generator().manual_seed(0))):
            pred = fwd(b).cpu().numpy()
            y_sc = b["y"][:, :, 2].cpu().numpy()
            p_sc = pred if scalar_out else pred[:, :, 2]
            errs.extend(((p_sc - y_sc) ** 2).mean(axis=1).tolist())
            if i + 1 >= batches:
                break
        errors[h] = errs
        print(f"horizon {h}: mse {np.mean(errs):.5g}", flush=True)
        if on_horizon is not None:
            on_horizon(dict(errors))
    return errors


def loess(x, y, frac: float = 0.6, degree: int = 1):
    """Locally weighted least squares (tricube weights) of y over x,
    evaluated at each x: the comparison plot's smoother."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    if n < degree + 2:
        return y
    k = max(degree + 2, int(np.ceil(frac * n)))
    out = np.empty(n)
    for i, xi in enumerate(x):
        d = np.abs(x - xi)
        idx = np.argsort(d)[:k]
        dmax = d[idx].max()
        w = (1 - (d[idx] / max(dmax, 1e-12)) ** 3) ** 3
        A = np.vander(x[idx] - xi, degree + 1, increasing=True)
        coef, *_ = np.linalg.lstsq(A * w[:, None], y[idx] * w, rcond=None)
        out[i] = coef[0]
    return out


def error_bands(results: dict) -> dict:
    """{model: (horizons, mean MSE each, its loess line, half-width of the
    band: 1.92 standard deviations over the square root of the samples)}
    of a sweep's {model: {horizon: [mse, ...]}}, in horizon order."""
    bands = {}
    for name, errs in results.items():
        hs = sorted(errs)
        means = [float(np.mean(errs[h])) for h in hs]
        half = np.array([1.92 * float(np.std(errs[h])) / np.sqrt(max(len(errs[h]), 1))
                         for h in hs])
        bands[name] = (hs, means, loess(hs, means), half)
    return bands


def plot_errors(results: dict, path: str) -> None:
    """The comparison plot of `error_bands` at `path`."""
    from waves_jl_tpu_torch.viz.plot import pyplot

    plt = pyplot()
    fig, ax = plt.subplots()
    colors = {"acoustic": "green", "node": "red", "pinn": "purple"}
    labels = {"acoustic": "Ours (PML)", "node": "NeuralODE", "pinn": "PINC"}
    for name, (hs, means, smooth, half) in error_bands(results).items():
        ax.plot(hs, smooth, color=colors[name], label=labels[name])
        ax.fill_between(hs, smooth - half, smooth + half, color=colors[name], alpha=0.1)
        ax.scatter(hs, means, color=colors[name], s=12)
    ax.set_xlabel("Prediction horizon (actions)")
    ax.set_ylabel("Scattered-energy MSE")
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def load_eval_episodes(data_dir: str, episodes: int, device) -> list:
    """The last `episodes` episode files of a dataset dir (sorted by name),
    or the first `episodes` of its shard."""
    paths = sorted(glob.glob(os.path.join(data_dir, "episodes", "episode*.npz"))
                   + glob.glob(os.path.join(data_dir, "episodes", "episode*.wbin")))
    if paths:
        return [load_episode(p, device=device) for p in paths[-episodes:]]
    eps = load_episodes_shard(os.path.join(data_dir, "data.wshard"), limit=episodes)
    return [tree_map(lambda v: v.to(device), ep) for ep in eps]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True)
    p.add_argument("--acoustic", default=None)
    p.add_argument("--node", default=None)
    p.add_argument("--pinn", default=None)
    p.add_argument("--episodes", type=int, default=30)
    p.add_argument("--horizons", type=int, nargs="+", default=[2, 4, 6, 8, 10, 15, 20])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--out", default=None, help="path of the error plot (none by default)")
    p.add_argument("--json-out", default="prediction_errors.json")
    p.add_argument("--force", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="seed from an existing --json-out and skip its (model, horizon) "
                        "entries; partial results are flushed after every horizon")
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--nfreq", type=int, default=500)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--latent-stride", type=int, default=1,
                   help="latent-dt coarsening of the acoustic checkpoint")
    p.add_argument("--pinn-chunk", type=int, default=16,
                   help="PINN field-net time rows a chunk (0: the unchunked forward)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if os.path.exists(args.json_out) and not (args.force or args.resume):
        sys.exit(f"refusing to overwrite {args.json_out} (pass --force, --resume or --json-out)")
    prior = {}
    if args.resume and os.path.exists(args.json_out):
        with open(args.json_out) as f:
            prior = {k: {int(h): v for h, v in r.items()} for k, r in json.load(f).items()}
        print(f"resuming from {args.json_out}: { {k: len(v) for k, v in prior.items()} }",
              flush=True)

    dev = resolve_device(args.device)
    eps = load_eval_episodes(args.data, args.episodes, dev)
    print(f"{len(eps)} evaluation episodes", flush=True)
    space = build_triple_ring_design_space(device=dev)
    kw = dict(elements=args.elements, h_size=args.h_size, nfreq=args.nfreq,
              in_channels=int(eps[0].s_wave.shape[-1]), device=dev)
    stride = args.latent_stride
    specs = [
        ("acoustic", args.acoustic, lambda: AcousticEnergyModel(
            space, 1000.0, integration_steps=100 // stride, dt=1e-5 * stride, **kw), False,
         stride),
        ("node", args.node, lambda: NODEEnergyModel(space, integration_steps=100, **kw), True, 1),
        ("pinn", args.pinn, lambda: WaveControlPINN(space, 1000.0, integration_steps=100, **kw),
         False, 1),
    ]
    results = {}
    for name, ckpt, make, scalar_out, mstride in specs:
        if ckpt is None:
            continue
        model = make()
        load_model_checkpoint(model, ckpt)
        fwd_fn = None
        if name == "pinn" and args.pinn_chunk:
            fwd_fn = functools.partial(model.predict_energy, time_chunk=args.pinn_chunk)

        def flush_partial(errors_so_far, _name=name):
            snap = dict(results)
            snap[_name] = errors_so_far
            with open(args.json_out, "w") as f:
                json.dump({k: {str(hh): v for hh, v in r.items()} for k, r in snap.items()}, f)

        results[name] = sweep(model, eps, args.horizons, args.batch, args.batches, scalar_out,
                              mstride, fwd_fn=fwd_fn, done=prior.get(name),
                              on_horizon=flush_partial)
        del model

    with open(args.json_out, "w") as f:
        json.dump({k: {str(h): v for h, v in r.items()} for k, r in results.items()}, f)
    print(f"wrote {args.json_out}")
    if args.out:
        plot_errors(results, args.out)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
