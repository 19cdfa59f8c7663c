"""Ranking-distillation fine-tune on exactly scored candidate pools, on the
card (the port of `scripts_tpu/train_pools.py`).

Fine-tunes a flagship checkpoint on the window MSE of a random-episode
dataset (`energy_loss`, the calibration anchor) plus `--lam` times
`pool_ranking_loss` on the pools `scripts.datagen_pools` wrote, under plain
Adam. Pools of different sizes K are grouped and their batches interleaved
in one shuffled schedule. Each validation reports the window MSE and, over
the live pools of the held-out files, the z-scored MSE, the Spearman rank
correlation, the top-1 agreement and the mean normalised regret (the true
energy the surrogate's argmin gives away against the pool's best), writes
them to `metrics.jsonl`, and saves a checkpoint either package loads:

    python -m waves_jl_tpu_torch.scripts.train_pools --data data/ref500 --pools data/pools \\
        --init-from models/ref500_h8s4_ft/checkpoint_step=1320 \\
        --out models/ref500_h8s4_pools [--latent-stride 4 --lr 3e-5]

`--device cpu` trains on the CPU.
"""
from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from waves_jl_tpu_torch.data import dataloader
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.models.acoustic_energy_model import (AcousticEnergyModel, energy_loss,
                                                             pool_ranking_loss)
from waves_jl_tpu_torch.models.layers import full_float32
from waves_jl_tpu_torch.physics.dynamics import build_tspan
from waves_jl_tpu_torch.scripts.datagen import build_env
from waves_jl_tpu_torch.scripts.datagen_pools import load_pools
from waves_jl_tpu_torch.scripts.train import load_dataset
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, save_checkpoint
from waves_jl_tpu_torch.train.optim import Adam, apply_updates
from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map

METRICS = ("pool_zmse", "spearman", "top1", "regret")


def concat_pools(pool_dicts: list[dict]) -> dict:
    return tree_map(lambda *xs: torch.cat(xs), *pool_dicts)


def index_pools(pools: dict, idx) -> dict:
    return tree_map(lambda v: v[idx], pools)


@torch.no_grad()
def predict_pools(model, pools: dict) -> np.ndarray:
    """(P, K) the surrogate's cumulative scattered energy of each pool's
    candidates, pool by pool on the model's device."""
    dev = next(model.parameters()).device
    K = pools["y_true"].shape[1]
    H = tree_leaves(pools["a"])[0].shape[2]
    tgrid = torch.from_numpy(build_tspan(0.0, model.integrator.dt,
                                         model.integration_steps * H)).to(dev)
    out = []
    for p in range(pools["y_true"].shape[0]):
        pool = tree_map(lambda v: v[p].to(dev), pools)
        t = (pool["t0"] + tgrid)[None].expand(K, tgrid.shape[0])
        out.append(model.predict_shot_energy(pool["s_wave"], pool["s_design"], pool["a"], t))
    return torch.stack(out).cpu().numpy()


def pool_metrics(model, pools: dict, batch_p: int = 8) -> dict:
    """z-MSE, Spearman rank correlation, top-1 agreement and mean normalised
    regret over the live pools, on the host, as the JAX package computes
    them; like it, only whole batches of `batch_p` pools are evaluated."""
    n = pools["y_true"].shape[0]
    n -= n % batch_p
    nan = {k: float("nan") for k in METRICS}
    if n == 0:
        return {**nan, "live_pools": 0, "total_pools": 0}
    e_hat = predict_pools(model, index_pools(pools, slice(0, n)))
    y = pools["y_true"][:n].cpu().numpy()
    # drop the pools without a signal (every candidate about equal, such as
    # before the wavefront): ranks mean nothing there and the loss weighs
    # them zero
    live = y.std(1) > 0.01 * np.abs(y.mean(1)) + 1e-9
    e_hat, y = e_hat[live], y[live]
    if len(y) == 0:
        return {**nan, "live_pools": 0, "total_pools": n}

    def zscore(v):
        return (v - v.mean(1, keepdims=True)) / (v.std(1, keepdims=True) + 1e-6)

    zmse = float(((zscore(e_hat) - zscore(y)) ** 2).mean())
    r_e = np.argsort(np.argsort(e_hat, axis=1), axis=1)
    r_y = np.argsort(np.argsort(y, axis=1), axis=1)
    spear = float(np.mean([np.corrcoef(a, b)[0, 1] for a, b in zip(r_e, r_y)]))
    top1 = float(np.mean(e_hat.argmin(1) == y.argmin(1)))
    picked = y[np.arange(len(y)), e_hat.argmin(1)]
    spread = y.max(1) - y.min(1) + 1e-9
    regret = float(np.mean((picked - y.min(1)) / spread))
    return {"pool_zmse": zmse, "spearman": spear, "top1": top1, "regret": regret,
            "live_pools": int(live.sum()), "total_pools": n}


def pool_objective(model, wbatch: dict, pbatch: dict, lam: float = 1.0, tau: float = 1.0,
                   listwise_weight: float = 0.5):
    """(anchor + lam x rank, anchor, rank): the window MSE of `wbatch` and
    the pool ranking loss of `pbatch`."""
    anchor = energy_loss(model, wbatch)
    rank = pool_ranking_loss(model, pbatch, tau=tau, listwise_weight=listwise_weight)
    return anchor + lam * rank, anchor, rank


def make_pool_update(model, lr: float, lam: float = 1.0, tau: float = 1.0,
                     listwise_weight: float = 0.5):
    """(opt, update): plain Adam (`optax.adam(lr)`) over the model's
    parameters, and update(opt_state, wbatch, pbatch) -> (opt_state, anchor,
    rank) one step on `pool_objective`, in IEEE float32, the losses left on
    the device."""
    opt = Adam(lr)
    params = dict(model.named_parameters())

    def update(opt_state, wbatch: dict, pbatch: dict):
        with full_float32():
            total, anchor, rank = pool_objective(model, wbatch, pbatch, lam, tau,
                                                 listwise_weight)
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        updates, opt_state = opt.update(grads, opt_state)
        apply_updates(params, updates)
        return opt_state, anchor.detach(), rank.detach()

    return opt, update


def load_pool_groups(pool_dirs, env) -> tuple[list, list]:
    """(train, validation) pools grouped by K, one concatenated dict a
    group: each group's last tenth of files (at least one) validates."""
    by_k: dict[int, list] = {}
    for pdir in pool_dirs:
        paths = sorted(glob.glob(os.path.join(pdir, "pools*.npz")),
                       key=lambda q: int("".join(c for c in os.path.basename(q) if c.isdigit())))
        if not paths:
            raise SystemExit(f"no pools under {pdir}")
        for q in paths:
            ps = load_pools(q, env)
            by_k.setdefault(int(ps["y_true"].shape[1]), []).append(ps)
    train_groups, val_groups = [], []
    for k_size in sorted(by_k):
        sets = by_k[k_size]
        if len(sets) < 2:
            raise SystemExit(f"pools of K={k_size}: one file, none left to train on")
        n_val = max(1, len(sets) // 10)
        val_groups.append(concat_pools(sets[-n_val:]))
        train_groups.append(concat_pools(sets[:-n_val]))
        print(f"pools K={k_size}: {int(train_groups[-1]['y_true'].shape[0])} train / "
              f"{int(val_groups[-1]['y_true'].shape[0])} val", flush=True)
    return train_groups, val_groups


def combined_metrics(model, val_groups: list) -> dict:
    """`pool_metrics` over each K-group's validation pools, combined
    weighted by live pools."""
    per = [pool_metrics(model, vg) for vg in val_groups]
    live = [m for m in per if m["live_pools"]]
    tot = sum(m["live_pools"] for m in live) or 1
    comb = ({k: sum(m[k] * m["live_pools"] for m in live) / tot for k in METRICS} if live
            else {k: float("nan") for k in METRICS})
    comb["live_pools"] = sum(m["live_pools"] for m in per)
    comb["total_pools"] = sum(m["total_pools"] for m in per)
    if len(per) > 1:
        comb["regret_by_k"] = {str(int(vg["y_true"].shape[1])): m["regret"]
                               for vg, m in zip(val_groups, per)}
    return comb


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--pools", required=True, nargs="+",
                   help="pool dir(s); pools of different sizes K are grouped and interleaved")
    p.add_argument("--init-from", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--episodes", type=int, default=500)
    p.add_argument("--horizon", type=int, default=8,
                   help="window horizon of the anchor MSE dataset")
    p.add_argument("--latent-stride", type=int, default=4)
    p.add_argument("--epochs", type=int, default=8, help="passes over the pool set")
    p.add_argument("--batch", type=int, default=8, help="anchor window batch")
    p.add_argument("--batch-pools", type=int, default=4, help="pools an update")
    p.add_argument("--lam", type=float, default=1.0,
                   help="weight of the pool ranking loss against the window MSE")
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--listwise-weight", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--val-every", type=int, default=50)
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--nfreq", type=int, default=500)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # the spaces' structure for loading pools; this grid is never integrated
    train_groups, val_groups = load_pool_groups(args.pools, build_env(256, args.steps, 1, "cpu"))
    train_groups = [tree_map(lambda v: v.to(dev), g) for g in train_groups]
    train_data, val_data = (tree_map(lambda v: v.to(dev), d) for d in
                            load_dataset(args.data, args.episodes, args.horizon,
                                         stride=args.latent_stride))

    model = AcousticEnergyModel(build_triple_ring_design_space(device=dev), 1000.0,
                                elements=args.elements, h_size=args.h_size, nfreq=args.nfreq,
                                integration_steps=args.steps // args.latent_stride,
                                dt=1e-5 * args.latent_stride, device=dev)
    step0 = load_model_checkpoint(model, args.init_from)
    print(f"initialized from {args.init_from} (step {step0})", flush=True)
    opt, update = make_pool_update(model, args.lr, args.lam, args.tau, args.listwise_weight)
    opt_state = opt.init(dict(model.named_parameters()))

    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "metrics.jsonl")

    def log(rec):
        with open(metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def val_mse(step):
        batches = dataloader(val_data, args.batch, torch.Generator().manual_seed(step))
        with torch.no_grad(), full_float32():
            return float(np.mean([float(energy_loss(model, b))
                                  for b in itertools.islice(batches, 10)]))

    base = combined_metrics(model, val_groups)
    print(f"BEFORE: {base}", flush=True)
    log({"step": 0, **base})

    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    step, best = 0, (float("inf"), None)
    for epoch in range(args.epochs):
        # one shuffled schedule of (group, batch start) over every K-group
        schedule, perms = [], []
        for g, tg in enumerate(train_groups):
            n_pools = int(tg["y_true"].shape[0])
            perms.append(rng.permutation(n_pools))
            schedule += [(g, s) for s in
                         range(0, n_pools - n_pools % args.batch_pools, args.batch_pools)]
        rng.shuffle(schedule)
        wb_iter = dataloader(train_data, args.batch, gen)
        for bi, (g, s) in enumerate(schedule):
            wbatch = next(wb_iter, None)
            if wbatch is None:  # the anchor set ran out: a fresh shuffle
                wb_iter = dataloader(train_data, args.batch, gen)
                wbatch = next(wb_iter)
            idx = torch.as_tensor(perms[g][s:s + args.batch_pools], device=dev)
            t0 = time.time()
            opt_state, anchor, rank = update(opt_state, wbatch, index_pools(train_groups[g], idx))
            step += 1
            if step % args.val_every == 0 or bi + 1 == len(schedule):
                pm = combined_metrics(model, val_groups)
                rec = {"step": step, "epoch": epoch, "anchor": float(anchor),
                       "rank": float(rank), "val_mse": val_mse(step), **pm,
                       "step_time": time.time() - t0}
                print(json.dumps(rec), flush=True)
                log(rec)
                save_checkpoint(os.path.join(args.out, f"checkpoint_step={step}"), model,
                                opt_state, step)
                if pm["regret"] < best[0]:
                    best = (pm["regret"], step)
    print(f"best val regret {best[0]:.4f} @ step {best[1]}", flush=True)


if __name__ == "__main__":
    main()
