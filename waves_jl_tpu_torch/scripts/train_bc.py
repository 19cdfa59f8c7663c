"""Behaviour-clone a search controller into a one-shot policy, on the card
(the port of `scripts_tpu/train_bc.py`).

The record controller (CEM + gradient polish on the distilled surrogate)
is amortised into `models.policy.AmortizedPolicy`: one forward pass an
action and no candidate rollout. It learns from the controller's own
episodes, recorded with `scripts.datagen_onpolicy --controller cem
--polish ... --epsilon 0`, by `train.loop.train` on `bc_loss`; checkpoints
load in either package, and `scripts.mpc --controller policy` evaluates
them:

    python -m waves_jl_tpu_torch.scripts.train_bc --data data/bc_traces --out models/bc \\
        [--epochs 20 --batch 32 --lr 3e-4 --h-size 256]

`--device cpu` trains on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from waves_jl_tpu_torch.designs import build_action_space, build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.models.policy import AmortizedPolicy, bc_loss
from waves_jl_tpu_torch.scripts.train import load_episodes_split
from waves_jl_tpu_torch.train import TrainConfig, train
from waves_jl_tpu_torch.utils.trees import tree_map


def episodes_to_bc_dataset(eps) -> dict:
    """Every window's (observation, design, chosen action) of recorded
    controller episodes, stacked into one dataset under the episodes'
    field names."""
    return tree_map(lambda *xs: torch.cat(xs), *[{"s_wave": ep.s_wave, "s_design": ep.s_design,
                                                  "a": ep.a} for ep in eps])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True, nargs="+",
                   help="recorded controller episode dir(s) (datagen_onpolicy --epsilon 0)")
    p.add_argument("--out", required=True)
    p.add_argument("--episodes", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--accumulate", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--val-every", type=int, default=50)
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--action-scale", type=float, default=0.25,
                   help="the env's action scale, action_speed x dt x steps (250 x 1e-5 x 100)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    train_eps, val_eps = load_episodes_split(args.data, args.episodes)
    train_data = episodes_to_bc_dataset(train_eps)
    val_data = episodes_to_bc_dataset(val_eps)
    print(f"{train_data['s_wave'].shape[0]} train / {val_data['s_wave'].shape[0]} val "
          "state-action pairs", flush=True)

    space = build_triple_ring_design_space(device=dev)
    policy = AmortizedPolicy.create(space, build_action_space(space.low, args.action_scale),
                                    h_size=args.h_size,
                                    in_channels=int(train_data["s_wave"].shape[-1]),
                                    seed=args.seed, device=dev)
    os.makedirs(args.out, exist_ok=True)
    config = TrainConfig(lr=args.lr, batch_size=args.batch, accumulate=args.accumulate,
                         epochs=args.epochs, val_every=args.val_every,
                         val_batches=args.val_every, checkpoint_dir=args.out,
                         metrics_path=os.path.join(args.out, "metrics.jsonl"), seed=args.seed)
    train(lambda b: bc_loss(policy, b), policy.net, train_data, val_data, config)


if __name__ == "__main__":
    main()
