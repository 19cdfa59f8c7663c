"""Render a random-policy episode to a video (the port of
`scripts_tpu/render.py`):

    python -m waves_jl_tpu_torch.scripts.render --out vid.mp4 --n 700 --render-size 350

The episode runs on the card through the exact one-launch kernel; each
window's field is kept every 10 steps and, with `--render-size`, resized on
the card before one pull to the host. Drawing needs matplotlib; without ffmpeg
the video is a GIF or a directory of PNG frames beside `--out`. `--device
cpu` runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.env import RandomDesignPolicy
from waves_jl_tpu_torch.scripts.datagen import build_env
from waves_jl_tpu_torch.viz.episode import render_episode


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="vid.mp4")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--actions", type=int, default=10)
    p.add_argument("--field", choices=["tot", "inc", "sc"], default="tot")
    p.add_argument("--bound", type=float, default=1.0)
    p.add_argument("--energy", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render-size", type=int, default=None,
                   help="frame size after the on-device resize (e.g. 350 for a 700^2 run)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    env = build_env(args.n, 100, args.actions, dev)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    signals = render_episode(env, RandomDesignPolicy(env.action_space), generator, args.out,
                             field=args.field, bound=args.bound, energy=args.energy,
                             render_size=args.render_size)
    print(f"rendered {args.out}; final window scattered energy {float(signals[-1, -1, 2]):.4g}",
          flush=True)
    return signals


if __name__ == "__main__":
    main()
