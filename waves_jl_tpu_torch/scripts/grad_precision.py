"""The float32 gradient of a baseline's loss on the card, held leaf by leaf
against the CPU's and against float64.

    python -m waves_jl_tpu_torch.scripts.grad_precision [--json-out FILE]

Generates episodes on the card at the datagen CLI's operating point
(700^2, 20 actions of 100 steps) as `chip_smoke.py`'s phase 7 draws them
(generator seed 70, a chunk of 10 discarded, then a chunk of 10 of which
the first 4 are kept), draws one-sample horizon-1 windows from them as
phase 11 draws its first batch (numpy seed 11; window 0 is the window
phase 11 holds the gradients on), and for each of the four windows and
each model (the tracked checkpoints at the reference widths) computes the
loss's gradient:

* in float32 on the card and on the CPU, and in float64 on both;
* in float32 on the card with the constants made on the host: the CPU
  model's buffers (the sin bases) and latent grid copied in, and every
  `torch.linspace` (the PINN loss's time grid) computed on the host;
* for the NODE, in float32 on the card with the rollout's checkpoint
  "none" as well as "sqrt", under `torch.use_deterministic_algorithms`,
  and with the loss's gradients with respect to the wave encoder's z0,
  the design encoder's knots Y and the latent trajectory, which tell the
  stage a difference enters at; and its stages one at a time on each
  device, from float64's inputs and upstream gradients rounded to float32
  (`node_stages_apart`);
* with TF32 on in every matmul and convolution on the card, the control:
  what a precision fault reads.

Each distance is the largest absolute difference over the leaf's largest
magnitude. It prints the worst leaf of each comparison and writes every
leaf's distances, with the card's name and power limit, to FILE. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import subprocess

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKPOINTS = {"node": "models/ref500_node_r4b/checkpoint_step=2040",
               "pinn": "models/ref500_pinn_r4/checkpoint_step=2000"}
WIDTH = dict(elements=1024, h_size=256, nfreq=500)
SIZE, WINDOWS, SEED = 700, 4, 11  # phase 11's grid, batch and numpy seed
DEVICE = "cuda"
# How far each leaf of a baseline's float32 loss gradient on the card may
# lie from the CPU's float32 gradient and from float64 on the card, as a
# share of the leaf's largest magnitude: (leaf-name prefix, limit), the
# first match applies. Set from this script's readings on an H100, on
# phase 11's four windows (PERF.md, section 6): with TF32 off, the largest
# distance of either comparison is 2.2e-4 on the NODE's leaves, 3.9e-4 on
# the PINN's encoders and compressor and 7.9e-3 on its field net (float32
# on the CPU lies up to 2.2e-4, 4.2e-4 and 1.2e-3 from float64 on them);
# each limit is 2.3-2.6x the first three. With
# TF32 on, the control, the worst leaf reads 2.7e-2 to 1.4 and the median
# leaf 7.2e-3 to 7.7e-2.
LEAF_LIMITS = {"node": (("", 5e-4),),
               "pinn": (("field_net.", 2e-2), ("", 1e-3))}


def leaf_limit(kind: str, leaf: str) -> float:
    """The limit of `leaf` of the "node" or "pinn" loss gradient."""
    return next(limit for prefix, limit in LEAF_LIMITS[kind] if leaf.startswith(prefix))


def leaves_beyond(kind: str, grads: dict, want: dict) -> tuple[dict, dict]:
    """(distance of every leaf of `grads` from `want`, the leaves beyond
    their limits with (distance, limit)), both keyed by leaf name."""
    dist = {k: rel(grads[k], want[k]) for k in want}
    return dist, {k: (d, leaf_limit(kind, k)) for k, d in dist.items() if d > leaf_limit(kind, k)}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


class _KeepTF32:
    """Stands in for `torch.backends.cuda.matmul` or `torch.backends.cudnn`
    and drops writes to `allow_tf32`, so `full_float32` cannot turn TF32 off."""

    def __init__(self, real):
        object.__setattr__(self, "_real", real)

    def __getattr__(self, key):
        return getattr(self._real, key)

    def __setattr__(self, key, value):
        if key != "allow_tf32":
            setattr(self._real, key, value)


@contextlib.contextmanager
def tf32_on():
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = True
    torch.backends.cuda.matmul, torch.backends.cudnn = _KeepTF32(mm), _KeepTF32(dnn)
    try:
        yield
    finally:
        torch.backends.cuda.matmul, torch.backends.cudnn = mm, dnn
        mm.allow_tf32, dnn.allow_tf32 = old


@contextlib.contextmanager
def host_linspace():
    real = torch.linspace

    def linspace(*args, device=None, **kwargs):
        return real(*args, device="cpu", **kwargs).to(device)

    torch.linspace = linspace
    try:
        yield
    finally:
        torch.linspace = real


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def host_constants(model, cpu_model):
    """A copy of `model` with `cpu_model`'s buffers and latent grid."""
    out = copy.deepcopy(model)
    bufs = dict(cpu_model.named_buffers())
    with torch.no_grad():
        for name, b in out.named_buffers():
            b.copy_(bufs[name])
    if hasattr(out, "latent_dim"):
        out.latent_dim = dataclasses.replace(out.latent_dim, x=cpu_model.latent_dim.x.to(
            out.latent_dim.x.device))
    return out


def node_grads(model, batch) -> dict:
    """node_loss's gradient by leaf, and by stage ("z0", "Y", "traj")."""
    from ..models.design_encoder import unroll_design_sequence
    from ..models.layers import full_float32
    from ..models.node import node_loss
    from ..utils.interp import LinearInterpolation

    with full_float32():
        z0 = model.wave_encoder(batch["s_wave"])[:, None]
        vecs = unroll_design_sequence(model.design_space, batch["s_design"], batch["a"])
        Y = model.design_mlp(vecs)
        C = LinearInterpolation(X=batch["t"][:, ::model.integration_steps], Y=Y)
        traj = model.integrator(z0, batch["t"], C)
        pred = (torch.sum(traj[:, :, 0] ** 2, dim=-1) * model.dx).transpose(0, 1)
        loss = torch.mean((pred - batch["y"][:, :, 2]) ** 2)
        with torch.no_grad():
            same = rel(loss, node_loss(model, batch))
        assert same < 1e-6, f"the staged loss is node_loss's ({same:.3e} apart)"
        stages = {"stage:z0": z0, "stage:Y": Y, "stage:traj": traj}
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, [*stages.values(), *params.values()])
    return dict(zip([*stages, *params], grads))


def node_stages_apart(model, model64, batch, batch64) -> dict:
    """The NODE's float32 stages one at a time, each from float64's inputs
    rounded to float32 and held against float64: the forward's z0, knots Y,
    trajectory (steps 1, 10 and 100), prediction and residual (prediction
    less target); the backward of the readout (to the trajectory), of the
    rollout (to z0 and Y), of the design encoder and of the wave encoder
    (to their leaves), each fed float64's upstream gradient."""
    from ..models.design_encoder import unroll_design_sequence
    from ..models.layers import full_float32
    from ..utils.interp import LinearInterpolation

    def run(m, b, z0=None, Y=None):
        if z0 is None:
            z0 = m.wave_encoder(b["s_wave"])[:, None]
            Y = m.design_mlp(unroll_design_sequence(m.design_space, b["s_design"], b["a"]))
        traj = m.integrator(z0, b["t"], LinearInterpolation(
            X=b["t"][:, ::m.integration_steps], Y=Y))
        pred = (torch.sum(traj[:, :, 0] ** 2, dim=-1) * m.dx).transpose(0, 1)
        return z0, Y, traj, pred, pred - b["y"][:, :, 2]

    def loss_of(resid):
        return torch.mean(resid ** 2)

    out = {}
    with full_float32():
        z0_64, Y64, traj64, pred64, res64 = run(model64, batch64)
        enc = {k: v for k, v in model64.named_parameters()
               if k.startswith(("design_mlp.", "wave_encoder."))}
        g64 = dict(zip(["traj", "Y", "z0", *enc], torch.autograd.grad(
            loss_of(res64), [traj64, Y64, z0_64, *enc.values()])))
        with torch.no_grad():
            z0, Y, traj, pred, res = run(model, batch)
        for k, (a, r) in {"z0": (z0, z0_64), "Y": (Y, Y64), "traj step 1": (traj[1], traj64[1]),
                          "traj step 10": (traj[10], traj64[10]),
                          "traj step 100": (traj[-1], traj64[-1]), "prediction": (pred, pred64),
                          "residual": (res, res64)}.items():
            out[f"forward {k}"] = rel(a, r)
        t32 = traj64.detach().float().requires_grad_()
        pred = (torch.sum(t32[:, :, 0] ** 2, dim=-1) * model.dx).transpose(0, 1)
        (g,) = torch.autograd.grad(loss_of(pred - batch["y"][:, :, 2]), [t32])
        out["readout backward: trajectory"] = rel(g, g64["traj"])
        z0r, Yr = (v.detach().float().requires_grad_() for v in (z0_64, Y64))
        _, _, traj, _, _ = run(model, batch, z0r, Yr)
        out["rollout alone: traj step 100"] = rel(traj[-1], traj64[-1])
        gz0, gY = torch.autograd.grad(traj, [z0r, Yr], grad_outputs=g64["traj"].float())
        out["rollout backward alone: z0"], out["rollout backward alone: Y"] = (
            rel(gz0, g64["z0"]), rel(gY, g64["Y"]))
        params = dict(model.named_parameters())
        vecs = unroll_design_sequence(model.design_space, batch["s_design"], batch["a"])
        for name, stage, x, up in (
                ("design encoder", model.design_mlp, vecs, g64["Y"]),
                ("wave encoder", lambda v: model.wave_encoder(v)[:, None], batch["s_wave"],
                 g64["z0"])):
            prefix = "design_mlp." if name == "design encoder" else "wave_encoder."
            ks = [k for k in params if k.startswith(prefix)]
            gs = torch.autograd.grad(stage(x), [params[k] for k in ks], grad_outputs=up.float())
            worst = max(ks, key=lambda k, d=dict(zip(ks, gs)): rel(d[k], g64[k]))
            out[f"{name} backward alone: worst leaf"] = rel(dict(zip(ks, gs))[worst], g64[worst])
    return out


def pinn_grads(model, batch) -> dict:
    from ..constants import WATER
    from ..models.layers import full_float32
    from ..models.pinn import WaveControlPINNLoss

    params = dict(model.named_parameters())
    with full_float32():
        loss = WaveControlPINNLoss(model=model, c0=WATER)(batch)
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def main(argv=None) -> dict:
    from ..data import generate_episodes_chunked, make_episode_chunk_fused
    from ..designs import build_triple_ring_design_space
    from ..env import RandomDesignPolicy as Policy
    from ..models.node import NODEEnergyModel
    from ..models.pinn import WaveControlPINN
    from ..train import gather_window_batch, stack_episodes
    from ..train.checkpoint import load_model_checkpoint
    from ..utils.trees import tree_map
    from .datagen import build_env

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)

    dev, cpu = torch.device(DEVICE), torch.device("cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, f"torch {torch.__version__}", flush=True)
    env = build_env(SIZE, 100, 20, dev)
    policy, gen = Policy(env.action_space), torch.Generator(device=dev).manual_seed(70)
    run_chunk = make_episode_chunk_fused(env)
    generate_episodes_chunked(env, policy, gen, 10, 10, run_chunk)
    store = stack_episodes(generate_episodes_chunked(env, policy, gen, 10, 10, run_chunk)[:4], dev)
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.integers(0, 4, WINDOWS), rng.integers(0, 20, WINDOWS)], -1)

    def build(which, device):
        space = build_triple_ring_design_space(device=device)
        model = (NODEEnergyModel(space, device=device, **WIDTH) if which == "node"
                 else WaveControlPINN(space, 1000.0, device=device, **WIDTH))
        load_model_checkpoint(model, os.path.join(ROOT, CHECKPOINTS[which]))
        return model

    report = {"device": smi, "torch": torch.__version__, "windows": idx.tolist(), "models": {}}
    for which in ("node", "pinn"):
        grads_of = node_grads if which == "node" else pinn_grads
        card, host = build(which, dev), build(which, cpu)
        card64, host64 = copy.deepcopy(card).double(), copy.deepcopy(host).double()
        hostc = host_constants(card, host)
        sqrt_none = None
        if which == "node":
            sqrt_none = copy.deepcopy(card)
            sqrt_none.integrator = dataclasses.replace(sqrt_none.integrator, checkpoint="none")
        basis = {n: rel(b, dict(host.named_buffers())[n]) for n, b in card.named_buffers()}
        print(f"{which}: buffers on the card against the CPU's: {basis}", flush=True)
        runs = {}
        for w, (e, s) in enumerate(idx):
            b = gather_window_batch(store, torch.as_tensor([[e, s]], device=dev), 1)
            b64 = tree_map(lambda v: v.double() if v.is_floating_point() else v, b)
            on_cpu = tree_map(lambda v: v.cpu(), b)
            g = {"card": grads_of(card, b), "cpu": grads_of(host, on_cpu),
                 "card64": grads_of(card64, b64), "cpu64": grads_of(host64, tree_map(
                     lambda v: v.cpu(), b64))}
            with host_linspace():
                g["card_host_constants"] = grads_of(hostc, b)
            with deterministic():
                g["card_deterministic"] = grads_of(card, b)
            if sqrt_none is not None:
                g["card_checkpoint_none"] = grads_of(sqrt_none, b)
            with tf32_on():
                g["card_tf32"] = grads_of(card, b)
            pairs = [("card", "cpu"), ("card", "card64"), ("cpu", "cpu64"), ("card64", "cpu64"),
                     ("card_host_constants", "cpu"), ("card_host_constants", "cpu64"),
                     ("card_deterministic", "cpu"), ("card_tf32", "cpu"), ("card_tf32", "card64")]
            if sqrt_none is not None:
                pairs.append(("card_checkpoint_none", "cpu"))
            for a, r in pairs:
                leaves = {k: rel(g[a][k], g[r][k]) for k in g[r]}
                runs.setdefault(f"{a} vs {r}", []).append(leaves)
                params = {k: v for k, v in leaves.items() if not k.startswith("stage:")}
                worst = max(params, key=params.get)
                stages = "".join(f", {k[6:]} {v:.3e}" for k, v in leaves.items()
                                 if k.startswith("stage:"))
                print(f"{which} window {w} ({e}, {s}): {a} vs {r}: worst leaf "
                      f"{params[worst]:.3e} ({worst}), median "
                      f"{float(np.median(list(params.values()))):.3e}{stages}", flush=True)
            if which == "node":
                for name, m, m64, bb, bb64 in (("card", card, card64, b, b64),
                                               ("cpu", host, host64, on_cpu,
                                                tree_map(lambda v: v.cpu(), b64))):
                    apart = node_stages_apart(m, m64, bb, bb64)
                    runs.setdefault(f"{name} stages apart vs float64", []).append(apart)
                    print(f"{which} window {w} ({e}, {s}): {name} stages apart against float64: "
                          + ", ".join(f"{k} {v:.3e}" for k, v in apart.items()), flush=True)
        report["models"][which] = {"buffers": basis, "runs": runs}
        del card, host, card64, host64, hostc, sqrt_none
        torch.cuda.empty_cache()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f)
    return report


if __name__ == "__main__":
    main()
