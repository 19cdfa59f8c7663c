"""Dataset generation on the card (the port of `scripts_tpu/datagen.py`).

Builds the n^2 env with the triple-ring design space and a random-position
Gaussian source, rolls N episodes with the random policy on the kernel
path (K5, the split d/dx, with the radii-only rasterisation), and saves
them with the env config:

    python -m waves_jl_tpu_torch.scripts.datagen --episodes 500 --out data/run1

`--format wbin` (the default) writes one native `.wbin` bundle an episode,
`npz` compressed npz, `shard` one `data.wshard` for the whole run; either
package loads what the other wrote. `--no-fused` runs the plain PyTorch
`env_step` instead of the kernel. `--device cpu` runs the plain path on the
CPU.
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
from waves_jl_tpu_torch.data import (generate_episode, generate_episodes_chunked,
                                     open_episodes_shard, save_episode)
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.dims import build_grid, two_dim
from waves_jl_tpu_torch.env import RandomDesignPolicy, make_wave_env
from waves_jl_tpu_torch.sources import GaussianSource

SOURCE_FREQ = 1000.0
GRID_SIZE = 15.0


def build_env(n: int = 700, integration_steps: int = 100, actions: int = 20, device="cuda"):
    """The datagen env: n^2 grid over +-15, triple-ring cloak, a Gaussian
    source drawn on x = -10, y in [-10, 10], 1 kHz."""
    dim = two_dim(GRID_SIZE, n, device=resolve_device(device))
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                   [1.0], SOURCE_FREQ)
    return make_wave_env(dim, build_triple_ring_design_space(device=dim.x.device), source,
                         integration_steps=integration_steps, actions=actions)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--episodes", type=int, default=500)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n", type=int, default=700)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--actions", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--format", choices=["wbin", "npz", "shard"], default="wbin",
                   help="wbin = native mmap store, one file an episode; shard = every "
                        "episode streamed into one data.wshard")
    p.add_argument("--no-fused", action="store_true",
                   help="use the plain PyTorch env_step instead of the kernel")
    p.add_argument("--chunk", type=int, default=10,
                   help="episodes copied to the host together on the kernel path")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    os.makedirs(os.path.join(args.out, "episodes"), exist_ok=True)
    env = build_env(args.n, args.steps, args.actions, args.device)
    policy = RandomDesignPolicy(env.action_space)
    with open(os.path.join(args.out, "env.json"), "w") as f:
        json.dump({"n": args.n, "integration_steps": args.steps, "actions": args.actions,
                   "grid_size": GRID_SIZE, "c0": float(WATER), "source_freq": SOURCE_FREQ}, f)

    generator = torch.Generator(device=env.device).manual_seed(args.seed)
    shard = (open_episodes_shard(os.path.join(args.out, "data.wshard"))
             if args.format == "shard" else None)
    last = [time.time()]

    def save(i, ep):
        if shard is not None:
            shard.append(ep)
        else:
            save_episode(ep, os.path.join(args.out, "episodes", f"episode{i + 1}.{args.format}"))
        now = time.time()
        print(f"episode {i + 1}/{args.episodes} ({now - last[0]:.2f}s since previous)",
              flush=True)
        last[0] = now

    t_start = time.time()
    if args.no_fused:
        for i in range(args.episodes):
            save(i, generate_episode(env, policy, generator)[1])
    else:
        generate_episodes_chunked(env, policy, generator, args.episodes, chunk=args.chunk,
                                  on_episode=save)
    if shard is not None:
        shard.finish()
    total = time.time() - t_start
    print(f"TOTAL {args.episodes} episodes in {total:.1f}s "
          f"({total / args.episodes:.2f}s/episode)", flush=True)


if __name__ == "__main__":
    main()
