"""MPC evaluation on the card (the port of `scripts_tpu/mpc.py`).

Loads a surrogate (or one-shot policy) checkpoint, runs controlled episodes
and random-policy episodes from the same resets, and reports the decrease
in scattered energy: `--locations` fixed source positions on x = -10,
`--episodes` resets each, the tail mean of the scattered energy over the
second half of an episode (the reference `scripts/test.jl:36-41`).

    python -m waves_jl_tpu_torch.scripts.mpc --controller cem \\
        --checkpoint models/ref500_h8s4_pools3/checkpoint_step=1450 \\
        --latent-stride 4 --cem-polish 10 --cem-polish-topk 16

Controllers: `random_shooting`, `cem` (`--cem-*`), `gradient` (projected
gradient descent on `max(8, shots // 8)` sequences), `ensemble` (several
`--checkpoint`s, `--beta`), `hybrid` (`--topk`, `--hybrid-cem`,
`--rerank-n`, `--exact-rounds`; each episode in one call,
`make_hybrid_episode_fused`, so `--fused-episode` changes nothing),
`oracle` (shooting in the simulator itself, no checkpoint) and `policy`
(a one-shot policy checkpoint).
`--fast` ranks with each surrogate's bf16 form (`fast_ranking`: the latent
state and its derivative contraction in bf16). `--render PATH` renders one
more episode of the chosen controller after the protocol: its scattered
energy density every 10 steps, resized on the card to at most 350^2
(drawing needs matplotlib). The result JSON has the
keys of the JAX CLI's. Draws
come from torch generators seeded from `--seed`, the location and the
episode, so the decreases are the port's own. `--device cpu` runs the
plain path on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from waves_jl_tpu_torch.control.mpc import (CEMShooting, EnsembleShooting, GradientShooting,
                                            RandomShooting, make_action_episode,
                                            make_hybrid_episode_fused, make_mpc_episode_fused,
                                            make_oracle_action_fused, make_policy_episode_fused)
from waves_jl_tpu_torch.data import make_episode_fused
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.env import RandomDesignPolicy, env_observe, env_reset
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.policy import AmortizedPolicy
from waves_jl_tpu_torch.scripts.datagen import build_env
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_policy_checkpoint
from waves_jl_tpu_torch.utils.gaussians import build_normal
from waves_jl_tpu_torch.utils.trees import tree_stack

def scattered_tail_mean(signals: np.ndarray) -> float:
    """Mean scattered energy over the second half of the episode's steps
    (the reference `scripts/test.jl:36-41`); signals (A, T+1, 3)."""
    sc = signals[:, :, 2].reshape(-1)
    return float(sc[len(sc) // 2:].mean())


def fixed_source_state(env, generator: torch.Generator, y_pos: float):
    """A reset with the source pinned at (-10, y_pos): the reference
    protocol's fixed locations on the source line x = -10
    (`scripts/test.jl:8-18`)."""
    state = env_reset(env, generator)
    src = state.source
    mu = torch.tensor([[-10.0, float(y_pos)]], dtype=torch.float32, device=env.device)
    src = dataclasses.replace(src, mu_low=mu, mu_high=mu,
                              shape=build_normal(src.grid, mu, src.sigma, src.a))
    return dataclasses.replace(state, source=src)


def episode_generators(seed: int, location: int, episode: int, device):
    """(reset, controller, random policy) generators of one episode, seeded
    from (seed, location, episode)."""
    seeds = np.random.SeedSequence([seed, location, episode]).generate_state(3)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", default=None,
                   help="unused; kept for the JAX CLI's launchers (the protocol builds its "
                        "own env and resets)")
    p.add_argument("--checkpoint", default=None, nargs="+",
                   help="surrogate checkpoint(s): several for --controller ensemble, a "
                        "one-shot policy's for --controller policy, none for --controller "
                        "oracle")
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--locations", type=int, default=5,
                   help="fixed source y-locations (reference scripts/test.jl)")
    p.add_argument("--fast", action="store_true",
                   help="bf16 latent ranking (the surrogates' fast_ranking)")
    p.add_argument("--horizon", type=int, default=5)
    p.add_argument("--shots", type=int, default=256)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--actions", type=int, default=20)
    p.add_argument("--n", type=int, default=700)
    p.add_argument("--controller", default="random_shooting",
                   choices=["random_shooting", "cem", "gradient", "oracle", "ensemble",
                            "hybrid", "policy"])
    p.add_argument("--policy-h-size", type=int, default=256,
                   help="policy net width (--controller policy)")
    p.add_argument("--beta", type=float, default=1.0,
                   help="ensemble disagreement weight")
    p.add_argument("--topk", type=int, default=8,
                   help="hybrid: candidates the simulator re-ranks")
    p.add_argument("--hybrid-cem", action="store_true",
                   help="hybrid: prune a CEM-refined pool instead of uniform samples")
    p.add_argument("--rerank-n", type=int, default=None,
                   help="hybrid: grid size of a coarser exact re-rank (the action is still "
                        "applied at --n)")
    p.add_argument("--batched-rerank", action="store_true",
                   help="hybrid: re-rank the top-k together through the batched kernel; "
                        "the port always does")
    p.add_argument("--exact-rounds", type=int, default=1,
                   help="hybrid: exact-CEM refinement rounds")
    p.add_argument("--exact-elites", type=int, default=8)
    p.add_argument("--fused-episode", action="store_true",
                   help="hybrid: each episode in one call, no read of the card between "
                        "actions; the port always does")
    p.add_argument("--cem-iters", type=int, default=3)
    p.add_argument("--cem-elites", type=int, default=32)
    p.add_argument("--cem-polish", type=int, default=0,
                   help="gradient-polish steps on the top-k sequences after the search")
    p.add_argument("--cem-polish-topk", type=int, default=8)
    p.add_argument("--cem-polish-lr", type=float, default=0.02)
    p.add_argument("--cem-warm", action="store_true",
                   help="receding-horizon warm start from the previous plan")
    p.add_argument("--latent-stride", type=int, default=1,
                   help="latent-dt coarsening of the surrogate checkpoint (as it was trained)")
    p.add_argument("--render", type=str, default=None,
                   help="video path of one more episode of the controller, rendered after the "
                        "protocol")
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--nfreq", type=int, default=500)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="mpc_results.json",
                   help="result JSON path; an existing file is kept unless --force")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_controller(args, env, dev):
    """(run, select) of the chosen controller: run(state, generator) ->
    (final_state, signals (A, T+1, 3), ...) a whole episode, and
    select(generator, state) -> action one selection."""
    space = build_triple_ring_design_space(device=dev)
    if args.controller == "policy":
        if len(args.checkpoint) != 1:
            sys.exit("--controller policy takes one checkpoint")
        policy = AmortizedPolicy.create(space, env.action_space, h_size=args.policy_h_size,
                                        device=dev)
        step_no = load_policy_checkpoint(policy.net, args.checkpoint[0])
        print(f"loaded policy checkpoint step {step_no} ({args.checkpoint[0]})", flush=True)
        return (make_policy_episode_fused(env, policy),
                lambda g, s: policy.action(env_observe(env, s).wave, s.design))
    if args.controller == "oracle":  # shooting in the simulator needs no surrogate
        act, step = make_oracle_action_fused(env, horizon=args.horizon, shots=args.shots,
                                             alpha=args.alpha)
        return make_action_episode(env, act, step), lambda g, s: act(s, g)[0]
    if args.controller != "ensemble" and len(args.checkpoint) != 1:
        sys.exit("multiple checkpoints require --controller ensemble")
    models = []
    for ck in args.checkpoint:
        models.append(AcousticEnergyModel(space, 1000.0, elements=args.elements,
                                          h_size=args.h_size, nfreq=args.nfreq,
                                          integration_steps=100 // args.latent_stride,
                                          dt=1e-5 * args.latent_stride, device=dev))
        step_no = load_model_checkpoint(models[-1], ck)
        print(f"loaded checkpoint step {step_no} ({ck})", flush=True)
    if args.fast:
        models = [m.fast_ranking() for m in models]
    model = models[0]
    mpc = None
    if args.controller == "ensemble":
        mpc = EnsembleShooting(models=tuple(models), horizon=args.horizon, shots=args.shots,
                               alpha=args.alpha, beta=args.beta)
    elif args.controller == "gradient":
        mpc = GradientShooting(model=model, horizon=args.horizon, shots=max(8, args.shots // 8),
                               alpha=args.alpha)
    elif args.controller == "random_shooting":
        mpc = RandomShooting(model=model, horizon=args.horizon, shots=args.shots,
                             alpha=args.alpha)
    elif args.controller == "cem":
        mpc = CEMShooting(model=model, horizon=args.horizon, shots=args.shots, alpha=args.alpha,
                          iters=args.cem_iters, elites=args.cem_elites, warm=args.cem_warm,
                          polish_steps=args.cem_polish, polish_topk=args.cem_polish_topk,
                          polish_lr=args.cem_polish_lr)
    if mpc is not None:  # a selection alone starts cold, as the JAX CLI's render does
        return make_mpc_episode_fused(env, mpc), lambda g, s: mpc(env, s, g)[0]
    searcher = (CEMShooting(model=model, horizon=args.horizon, shots=args.shots,
                            alpha=args.alpha, iters=args.cem_iters, elites=args.cem_elites)
                if args.hybrid_cem else None)
    rerank_env = build_env(args.rerank_n, 100, args.actions, dev) if args.rerank_n else None
    run = make_hybrid_episode_fused(
        env, model, horizon=args.horizon, shots=args.shots, topk=args.topk, alpha=args.alpha,
        rerank_env=rerank_env, exact_rounds=args.exact_rounds, exact_elites=args.exact_elites,
        searcher=searcher)
    return run, lambda g, s: run.act(s, g)[0]


def main(argv=None) -> dict:
    args = parse_args(argv)
    if os.path.exists(args.out) and not args.force:
        sys.exit(f"refusing to overwrite {args.out} (pass --force or --out)")
    if args.controller != "oracle" and not args.checkpoint:
        sys.exit("--checkpoint is required for surrogate controllers")
    dev = resolve_device(args.device)
    if args.fast:
        print("fast-ranking mode: bf16 latent matmul", flush=True)
    env = build_env(args.n, 100, args.actions, dev)
    run_mpc, select = build_controller(args, env, dev)
    run_rnd = make_episode_fused(env)
    policy = RandomDesignPolicy(env.action_space)

    def synced_seconds(t0: float) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time() - t0

    locations = np.linspace(-10.0, 10.0, args.locations) if args.locations > 1 else [0.0]
    per_location, episode_times = [], []
    for li, y_pos in enumerate(locations):
        mpc_tails, rnd_tails = [], []
        for ep in range(args.episodes):
            g_reset, g_mpc, g_rnd = episode_generators(args.seed, li, ep, dev)
            state = fixed_source_state(env, g_reset, y_pos)

            t0 = time.time()
            mpc_sig = run_mpc(state, g_mpc)[1]
            el = synced_seconds(t0)
            episode_times.append(el)
            mpc_sig = mpc_sig.cpu().numpy()

            actions = tree_stack([policy(g_rnd) for _ in range(env.actions)])
            rnd_sig = run_rnd(state, actions)[1].y.cpu().numpy()

            m, r = scattered_tail_mean(mpc_sig), scattered_tail_mean(rnd_sig)
            mpc_tails.append(m)
            rnd_tails.append(r)
            print(f"loc {li + 1} ep {ep + 1}: mpc={m:.4g} random={r:.4g} "
                  f"({el:.2f}s/episode)", flush=True)
        m, r = float(np.mean(mpc_tails)), float(np.mean(rnd_tails))
        dec = (r - m) / r if r > 0 else 0.0
        per_location.append(dec)
        print(f"location {li + 1} (y={y_pos:+.1f}): decrease={dec:.1%}", flush=True)

    c = args.controller
    result = {
        "percentage_decrease": per_location,
        "mean_decrease": float(np.mean(per_location)),
        "controller": c,
        "checkpoint": (args.checkpoint[0] if args.checkpoint and len(args.checkpoint) == 1
                       else args.checkpoint),
        "beta": args.beta if c == "ensemble" else None,
        "topk": args.topk if c == "hybrid" else None,
        "rerank_n": args.rerank_n if c == "hybrid" else None,
        "hybrid_cem": args.hybrid_cem if c == "hybrid" else None,
        "cem_warm": args.cem_warm if c == "cem" else None,
        "cem_polish": args.cem_polish if c == "cem" and args.cem_polish else None,
        "exact_rounds": args.exact_rounds if c == "hybrid" else None,
        "actions": args.actions,
        "shots": args.shots,
        "horizon": args.horizon,
        "latent_stride": args.latent_stride,
        "protocol": f"{args.locations} locations x {args.episodes} episodes, "
                    f"tail-mean scattered energy (scripts/test.jl)",
        "mpc_episode_seconds": {
            "first": episode_times[0] if episode_times else None,
            "warm_mean": float(np.mean(episode_times[1:])) if len(episode_times) > 1 else None,
        },
    }
    print(json.dumps(result), flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"wrote {args.out}", flush=True)
    if args.render:
        render_controller_episode(args, env, select, dev)
    return result


def render_controller_episode(args, env, select, dev) -> None:
    """One more episode of the controller from a reset drawn from --seed,
    rendered to --render: the scattered energy density (bound 0.2) every 10
    steps, resized on the card to min(350, n)^2."""
    from waves_jl_tpu_torch.viz.episode import render_episode

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    render_episode(env, select, generator, args.render, field="sc", bound=0.2, energy=True,
                   render_size=min(350, args.n), state_aware=True)
    print(f"rendered {args.render}", flush=True)


if __name__ == "__main__":
    main()
