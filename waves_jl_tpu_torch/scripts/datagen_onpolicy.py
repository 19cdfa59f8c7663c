"""On-policy episodes, rolled under a surrogate's MPC controller on the card
(the port of `scripts_tpu/datagen_onpolicy.py`).

Control evaluates the surrogate on the states the controller visits, which
random-policy episodes rarely reach. This rolls episodes with the
controller (random shooting, or CEM with an optional gradient polish, the
traces behaviour cloning learns from), each window's action replaced by a
uniform one with probability `--epsilon`, and saves them in the episode
format, to mix into a fine-tune (`scripts.train --data <random> <onpolicy>`)
or to clone (`scripts.train_bc`):

    python -m waves_jl_tpu_torch.scripts.datagen_onpolicy --episodes 200 \\
        --out data/onpol --checkpoint models/ref500_h8s4/checkpoint_step=2600 \\
        --latent-stride 4 [--epsilon 0.25 --horizon 5 --shots 256]

`--device cpu` runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from waves_jl_tpu_torch.constants import WATER
from waves_jl_tpu_torch.control.mpc import (CEMShooting, RandomShooting,
                                            make_mpc_episode_recorded)
from waves_jl_tpu_torch.data import save_episode
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.env import env_reset
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.scripts.datagen import GRID_SIZE, SOURCE_FREQ, build_env
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--episodes", type=int, default=200)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--epsilon", type=float, default=0.25,
                   help="probability a window of a uniform action instead of the controller's")
    p.add_argument("--horizon", type=int, default=5)
    p.add_argument("--shots", type=int, default=256)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--controller", choices=["random_shooting", "cem"], default="random_shooting",
                   help="cem (with --polish) records the record controller's traces")
    p.add_argument("--cem-iters", type=int, default=3)
    p.add_argument("--cem-elites", type=int, default=32)
    p.add_argument("--polish", type=int, default=0, help="gradient-polish steps on the elites")
    p.add_argument("--polish-topk", type=int, default=16)
    p.add_argument("--polish-lr", type=float, default=0.02)
    p.add_argument("--latent-stride", type=int, default=1)
    p.add_argument("--n", type=int, default=700)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--actions", type=int, default=20)
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--nfreq", type=int, default=500)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--format", choices=["wbin", "npz"], default="wbin")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(os.path.join(args.out, "episodes"), exist_ok=True)
    env = build_env(args.n, args.steps, args.actions, dev)
    with open(os.path.join(args.out, "env.json"), "w") as f:
        json.dump({"n": args.n, "integration_steps": args.steps, "actions": args.actions,
                   "grid_size": GRID_SIZE, "c0": float(WATER), "source_freq": SOURCE_FREQ,
                   "onpolicy": {"checkpoint": args.checkpoint, "epsilon": args.epsilon,
                                "horizon": args.horizon, "shots": args.shots,
                                "controller": args.controller, "cem_iters": args.cem_iters,
                                "cem_elites": args.cem_elites, "polish": args.polish,
                                "polish_topk": args.polish_topk}}, f)

    model = AcousticEnergyModel(build_triple_ring_design_space(device=dev), SOURCE_FREQ,
                                elements=args.elements, h_size=args.h_size, nfreq=args.nfreq,
                                integration_steps=args.steps // args.latent_stride,
                                dt=1e-5 * args.latent_stride, device=dev)
    step_no = load_model_checkpoint(model, args.checkpoint)
    print(f"loaded checkpoint step {step_no} ({args.checkpoint})", flush=True)
    if args.controller == "cem":
        mpc = CEMShooting(model=model, horizon=args.horizon, shots=args.shots, alpha=args.alpha,
                          iters=args.cem_iters, elites=args.cem_elites, polish_steps=args.polish,
                          polish_topk=args.polish_topk, polish_lr=args.polish_lr)
    else:
        mpc = RandomShooting(model=model, horizon=args.horizon, shots=args.shots,
                             alpha=args.alpha)
    run = make_mpc_episode_recorded(env, mpc, epsilon=args.epsilon)

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    t_start = last = time.time()
    for i in range(args.episodes):
        _, ep = run(env_reset(env, generator), generator)
        save_episode(ep, os.path.join(args.out, "episodes", f"episode{i + 1}.{args.format}"))
        now = time.time()
        print(f"episode {i + 1}/{args.episodes} ({now - last:.2f}s)", flush=True)
        last = now
    total = time.time() - t_start
    print(f"TOTAL {args.episodes} episodes in {total:.1f}s "
          f"({total / args.episodes:.2f}s/episode)", flush=True)


if __name__ == "__main__":
    main()
