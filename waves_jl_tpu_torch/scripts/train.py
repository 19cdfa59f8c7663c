"""Train a surrogate on the card (the port of `scripts_tpu/train.py`).

Loads episodes (a dataset dir with `data.wshard` or `episodes/episode*.npz`
/ `.wbin`, or a `.wshard` file; several dirs are concatenated, each split
90/10 into training and validation), then trains the flagship
`AcousticEnergyModel` (`--model acoustic`), the neural-ODE baseline
(`--model node`, `node_loss`) or the PINN baseline (`--model pinn`,
`WaveControlPINNLoss`, horizon-1 windows only) with Adam and gradient
accumulation, validating and writing a `checkpoint_step=N` directory (the
JAX package's format) and `metrics.jsonl` under `--out`:

    python -m waves_jl_tpu_torch.scripts.train --data data/run1 --out models/run1 \\
        --horizons 1 4 8 --latent-stride 4 --sc-weight 4 --init-from <checkpoint>
    python -m waves_jl_tpu_torch.scripts.train --data data/run1 --out models/pinn \\
        --model pinn --horizon 1

`--latent-stride`, `--loss ranking` and `--sc-weight` are the flagship's
options, as in the JAX CLI (a stride above 1 exits for a baseline; the
loss options do not apply to it).

`--horizons` trains every listed window length from one windowed store on
the card, `--horizon` one length over prepared windows, `--stream` one
length from host-resident episodes. `--device cpu` trains on the CPU.
`--dp` trains data-parallel over every card of the machine (one replica of
the model a card, the gradients averaged each micro-step); the streaming
trainer is single-device, and the CLI's mesh is made of cards. Each
checkpoint directory also gets the model's dashboard (`viz.make_plots_*` on
one validation batch); a plot that fails prints why and training goes on.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from waves_jl_tpu_torch.constants import WATER
from waves_jl_tpu_torch.data import dataloader, load_episode, load_episodes_shard, prepare_dataset
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.models.acoustic_energy_model import (AcousticEnergyModel, energy_loss,
                                                             energy_loss_ranking)
from waves_jl_tpu_torch.models.node import NODEEnergyModel, node_loss
from waves_jl_tpu_torch.models.pinn import WaveControlPINN, WaveControlPINNLoss
from waves_jl_tpu_torch.parallel.mesh import make_mesh
from waves_jl_tpu_torch.train import TrainConfig, train, train_streaming, train_windowed
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
from waves_jl_tpu_torch.train.windows import gather_window_batch, stack_episodes
from waves_jl_tpu_torch.utils.trees import tree_map


def _load_episodes_dir(data_dir: str, episodes: int) -> list:
    shard = data_dir if data_dir.endswith(".wshard") else os.path.join(data_dir, "data.wshard")
    if os.path.exists(shard):
        return load_episodes_shard(shard, limit=episodes)
    paths = sorted(
        glob.glob(os.path.join(data_dir, "episodes", "episode*.npz"))
        + glob.glob(os.path.join(data_dir, "episodes", "episode*.wbin")),
        key=lambda p: int("".join(c for c in os.path.basename(p) if c.isdigit())),
    )[:episodes]
    if not paths:
        raise SystemExit(f"no episodes under {data_dir}")
    return [load_episode(p, device=None) for p in paths]


def load_episodes_split(data_dirs, episodes: int, train_val_split: float = 0.9):
    """Episodes of each dir (at most `episodes` a dir) split 90/10 per dir,
    so validation covers every source; on the CPU."""
    train_eps, val_eps = [], []
    for d in [data_dirs] if isinstance(data_dirs, str) else data_dirs:
        eps = _load_episodes_dir(d, episodes)
        idx = int(round(len(eps) * train_val_split))
        train_eps.extend(eps[:idx])
        val_eps.extend(eps[idx:] or eps[-1:])
    return train_eps, val_eps


def load_dataset(data_dirs, episodes: int, horizon: int, train_val_split: float = 0.9,
                 stride: int = 1):
    """(train, validation) windowed datasets of the dirs' episodes, split
    per dir as `load_episodes_split` splits them; on the CPU."""
    train_eps, val_eps = load_episodes_split(data_dirs, episodes, train_val_split)
    return prepare_dataset(train_eps, horizon, stride), prepare_dataset(val_eps, horizon, stride)


def build_model(args, in_channels: int, device):
    """The model the flags name, at their widths, with its loss: (model,
    loss_fn)."""
    if args.steps % args.latent_stride:
        raise SystemExit(f"latent stride {args.latent_stride} must divide {args.steps}")
    if args.latent_stride > 1 and args.model != "acoustic":
        raise SystemExit("--latent-stride is acoustic-only")
    space = build_triple_ring_design_space(device=device)
    kw = dict(elements=args.elements, latent_grid_size=args.latent_gs, h_size=args.h_size,
              nfreq=args.nfreq, integration_steps=args.steps // args.latent_stride,
              in_channels=in_channels, seed=args.seed, device=device)
    if args.model == "node":
        model = NODEEnergyModel(space, **kw)
        return model, lambda b: node_loss(model, b)
    if args.model == "pinn":
        model = WaveControlPINN(space, 1000.0, **kw)
        return model, WaveControlPINNLoss(model=model, c0=WATER)
    model = AcousticEnergyModel(space, 1000.0, pml_width=args.pml_width,
                                pml_scale=args.pml_scale, dt=1e-5 * args.latent_stride, **kw)
    if args.loss == "ranking":
        return model, lambda b: energy_loss_ranking(model, b, beta=args.ranking_beta)
    return model, lambda b: energy_loss(model, b, sc_weight=args.sc_weight)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True, nargs="+",
                   help="dataset dir(s) or .wshard file(s); several are concatenated")
    p.add_argument("--out", required=True)
    p.add_argument("--model", choices=["acoustic", "node", "pinn"], default="acoustic")
    p.add_argument("--episodes", type=int, default=500)
    p.add_argument("--horizon", type=int, default=1)
    p.add_argument("--horizons", type=int, nargs="+", default=None,
                   help="mixed-horizon training over the windowed store (overrides --horizon)")
    p.add_argument("--latent-stride", type=int, default=1,
                   help="latent-dt coarsening: stride-times fewer latent steps a window, "
                        "targets subsampled to match")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--accumulate", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--val-every", type=int, default=20)
    p.add_argument("--val-batches", type=int, default=None,
                   help="validation minibatches per pass (default: val-every)")
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--nfreq", type=int, default=500)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--latent-gs", type=float, default=100.0)
    p.add_argument("--pml-width", type=float, default=10.0)
    p.add_argument("--pml-scale", type=float, default=10000.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--loss", choices=["mse", "ranking"], default="mse",
                   help="'ranking' adds the cumulative scattered-energy term")
    p.add_argument("--ranking-beta", type=float, default=1.0)
    p.add_argument("--sc-weight", type=float, default=1.0,
                   help="scattered-channel weight of the mse loss (mean-normalised)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over every card (one replica of the model a card)")
    p.add_argument("--stream", action="store_true",
                   help="host-resident episode store, one upload a chunk; fixed --horizon")
    p.add_argument("--init-from", type=str, default=None,
                   help="checkpoint dir to initialise the parameters from")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Exit with a clear message for a combination the port does not run."""
    if args.stream and args.horizons:
        sys.exit("--stream trains one fixed --horizon")
    if args.dp and args.stream:
        sys.exit("--dp with --stream: the streaming trainer is single-device")
    if args.dp and torch.device(args.device).type != "cuda":
        sys.exit(f"--dp --device {args.device} is not yet ported: the CLI's data-parallel mesh is "
                 "made of the machine's cards (make_mesh()); a CPU mesh is the library's, "
                 "make_mesh(devices=['cpu'] * n)")


def make_plot_hook(args, val_eps):
    """on_checkpoint(path, model): the model's dashboard in the checkpoint
    directory, drawn on one validation batch as the JAX CLI picks it:
    `--batch` copies of the window of the last of `--horizons` at action 0
    of the first validation episode (zero indices), or the first shuffled
    minibatch (torch seed 1) of the `--horizon` windows. A failure prints
    and training goes on."""
    from waves_jl_tpu_torch.viz import make_plots_acoustic, make_plots_node, make_plots_pinn

    def batch_on(device):
        if args.horizons:
            store = stack_episodes(val_eps, device=None)
            idx = torch.zeros((args.batch, 2), dtype=torch.long)
            batch = gather_window_batch(store, idx, args.horizons[-1], args.latent_stride)
        else:
            val = prepare_dataset(val_eps, args.horizon, args.latent_stride)
            batch = next(iter(dataloader(val, args.batch, torch.Generator().manual_seed(1))))
        return tree_map(lambda x: x.to(device), batch)

    def on_checkpoint(path, model):
        try:
            batch = batch_on(next(model.parameters()).device)
            if args.model == "acoustic":
                make_plots_acoustic(model, batch, path, samples=2)
            elif args.model == "node":
                make_plots_node(model, batch, path, samples=2)
            else:
                make_plots_pinn(model, batch, path, samples=2)
        except Exception as e:  # plots must never kill training
            print(f"plotting failed: {e}", flush=True)

    return on_checkpoint


def main(argv=None) -> None:
    args = parse_args(argv)
    check_ported(args)
    dev = resolve_device(args.device)
    train_eps, val_eps = load_episodes_split(args.data, args.episodes)
    print(f"{len(train_eps)} training and {len(val_eps)} validation episodes", flush=True)
    in_ch = int(train_eps[0].s_wave.shape[-1])
    model, loss_fn = build_model(args, in_ch, dev)
    if args.init_from:
        step0 = load_model_checkpoint(model, args.init_from)
        print(f"initialized params from {args.init_from} (step {step0})", flush=True)

    os.makedirs(args.out, exist_ok=True)
    config = TrainConfig(lr=args.lr, batch_size=args.batch, accumulate=args.accumulate,
                         epochs=args.epochs, val_every=args.val_every,
                         val_batches=args.val_batches or args.val_every,
                         checkpoint_dir=args.out,
                         metrics_path=os.path.join(args.out, "metrics.jsonl"), seed=args.seed)
    stride = args.latent_stride
    plots = make_plot_hook(args, val_eps)
    mesh, replicate = None, None
    if args.dp:
        mesh = make_mesh()
        replicate = lambda device: build_model(args, in_ch, device)  # noqa: E731
        print(f"data-parallel over {mesh.size} devices", flush=True)
    if args.stream:
        print(f"streaming over {len(train_eps)} host-resident episodes", flush=True)
        train_streaming(loss_fn, model, train_eps, prepare_dataset(val_eps, args.horizon, stride),
                        config, horizon=args.horizon, stride=stride, on_checkpoint=plots)
    elif args.horizons:
        train_windowed(loss_fn, model, train_eps, val_eps, config,
                       horizons=tuple(args.horizons), stride=stride, mesh=mesh,
                       replicate=replicate, on_checkpoint=plots)
    else:
        train(loss_fn, model, prepare_dataset(train_eps, args.horizon, stride),
              prepare_dataset(val_eps, args.horizon, stride), config, mesh=mesh,
              replicate=replicate, on_checkpoint=plots)


if __name__ == "__main__":
    main()
