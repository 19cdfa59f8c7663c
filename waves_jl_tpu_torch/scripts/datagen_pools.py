"""Exactly scored candidate pools for the ranking fine-tune, on the card
(the port of `scripts_tpu/datagen_pools.py`).

At each state of an episode the probe (`control.mpc.PoolProbe`) scores K
uniform candidate action sequences in the simulator, on the coarser
`--rerank-n` grid, K at a time through the batched kernel, and records the
pool; the episode advances under the exact argmin, or with probability
`--epsilon` a uniform action. With `--checkpoint` the harvest is a DAgger
step: `--searcher-samples` of each pool are a CEM (+ `--polish`)
searcher's cheapest proposals on that surrogate, and the episode advances
under the searcher's choice.

    python -m waves_jl_tpu_torch.scripts.datagen_pools --episodes 40 --out data/pools \\
        [--pool 16 --horizon 5 --rerank-n 350 --epsilon 0.2]

Writes `pools.json` and `pools<i>.npz` an episode in the JAX package's
layout, so either package reads the other's pools; fine-tune with
`waves_jl_tpu_torch.scripts.train_pools`. `--device cpu` runs the plain
path on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from waves_jl_tpu_torch.control.mpc import CEMShooting, make_pool_probe_fused
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset, env_terminated
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.scripts.datagen import build_env
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map

# a pool's fields in the probe's order; the design and action trees are
# saved leaf by leaf
POOL_FIELDS = ("s_wave", "s_design", "t0", "a", "y_true", "penalty")
TREES = ("s_design", "a")


def save_pools(path: str, pools: list[dict]) -> None:
    """Stack an episode's pools and save them as one compressed npz in the
    JAX package's layout: the plain fields under their names, the trees'
    leaves as `s_design_<i>` and `a_<i>` in leaf order."""
    stacked = tree_map(lambda *xs: torch.stack(xs), *pools)
    flat = {name: stacked[name].detach().cpu().numpy() for name in POOL_FIELDS
            if name not in TREES}
    for prefix in TREES:
        for i, leaf in enumerate(tree_leaves(stacked[prefix])):
            flat[f"{prefix}_{i}"] = leaf.detach().cpu().numpy()
    np.savez_compressed(path, **flat)


def load_pools(path: str, env, device=None) -> dict:
    """An npz of pools written by either package, its trees rebuilt on the
    structure of `env`'s design and action spaces; on `device` (None: the
    CPU)."""
    def tensor(a):
        t = torch.from_numpy(np.array(a))
        return t if device is None else t.to(device)

    like = {"s_design": env.design_space.low, "a": env.action_space.low}
    with np.load(path) as data:
        def field(name):
            if name not in TREES:
                return tensor(data[name])
            leaves = iter(tensor(data[f"{name}_{i}"])
                          for i in range(len(tree_leaves(like[name]))))
            return tree_map(lambda _: next(leaves), like[name])

        return {name: field(name) for name in POOL_FIELDS}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--episodes", type=int, default=40)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--pool", type=int, default=16, help="candidates scored exactly a state")
    p.add_argument("--horizon", type=int, default=5)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--epsilon", type=float, default=0.2,
                   help="probability a window of advancing with a uniform action instead of "
                        "the exact argmin")
    p.add_argument("--n", type=int, default=700)
    p.add_argument("--rerank-n", type=int, default=350,
                   help="grid of the exact pool scoring (the ranking of the full grid at "
                        "about (n/m)^2 less cost)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--actions", type=int, default=20)
    p.add_argument("--refine-samples", type=int, default=0,
                   help="candidates drawn around the exact elites and added to each pool")
    p.add_argument("--refine-elites", type=int, default=4)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="distilled surrogate checkpoint: the DAgger harvest under its CEM "
                        "searcher")
    p.add_argument("--searcher-samples", type=int, default=8)
    p.add_argument("--cem-iters", type=int, default=3)
    p.add_argument("--cem-elites", type=int, default=32)
    p.add_argument("--polish", type=int, default=0,
                   help="gradient-polish steps of the DAgger searcher")
    p.add_argument("--polish-topk", type=int, default=16)
    p.add_argument("--polish-lr", type=float, default=0.02)
    p.add_argument("--shots", type=int, default=256)
    p.add_argument("--latent-stride", type=int, default=4)
    p.add_argument("--seed", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_searcher(args, dev):
    """The DAgger harvest's CEM searcher on the `--checkpoint` surrogate."""
    model = AcousticEnergyModel(build_triple_ring_design_space(device=dev), 1000.0,
                                elements=1024, h_size=256, nfreq=500,
                                integration_steps=args.steps // args.latent_stride,
                                dt=1e-5 * args.latent_stride, device=dev)
    step_no = load_model_checkpoint(model, args.checkpoint)
    print(f"DAgger harvest under CEM on checkpoint step {step_no}", flush=True)
    return CEMShooting(model=model, horizon=args.horizon, shots=args.shots, alpha=args.alpha,
                       iters=args.cem_iters, elites=args.cem_elites, polish_steps=args.polish,
                       polish_topk=args.polish_topk, polish_lr=args.polish_lr)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    env = build_env(args.n, args.steps, args.actions, dev)
    rerank_env = (build_env(args.rerank_n, args.steps, args.actions, dev)
                  if args.rerank_n and args.rerank_n != args.n else None)
    dagger = bool(args.checkpoint)
    with open(os.path.join(args.out, "pools.json"), "w") as f:
        json.dump({"n": args.n, "rerank_n": args.rerank_n, "pool": args.pool,
                   "horizon": args.horizon, "alpha": args.alpha, "epsilon": args.epsilon,
                   "steps": args.steps, "actions": args.actions, "episodes": args.episodes,
                   "refine_samples": args.refine_samples, "refine_elites": args.refine_elites,
                   "checkpoint": args.checkpoint,
                   "searcher_samples": args.searcher_samples if dagger else 0,
                   "shots": args.shots if dagger else None,
                   "polish": args.polish if dagger else 0,
                   "polish_topk": args.polish_topk, "polish_lr": args.polish_lr}, f)

    searcher = build_searcher(args, dev) if dagger else None
    probe, step = make_pool_probe_fused(
        env, K=args.pool, horizon=args.horizon, alpha=args.alpha, rerank_env=rerank_env,
        refine_samples=args.refine_samples, refine_elites=args.refine_elites,
        searcher=searcher, searcher_samples=args.searcher_samples if dagger else 0)
    policy = RandomDesignPolicy(env.action_space)
    rng = np.random.default_rng(args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    t_start = time.time()
    for i in range(args.episodes):
        state = env_reset(env, generator)
        pools, last = [], time.time()
        while not env_terminated(env, state):
            pool, a_best = probe(state, generator)
            pools.append(tree_map(lambda v: v.cpu(), pool))
            a = policy(generator) if rng.random() < args.epsilon else a_best
            state, _ = step(state, a)
        save_pools(os.path.join(args.out, f"pools{i + 1}.npz"), pools)
        print(f"episode {i + 1}/{args.episodes}: {len(pools)} pools "
              f"({time.time() - last:.2f}s)", flush=True)
    total = time.time() - t_start
    print(f"TOTAL {args.episodes} episodes in {total:.1f}s "
          f"({total / args.episodes:.2f}s/episode)", flush=True)


if __name__ == "__main__":
    main()
