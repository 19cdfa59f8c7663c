"""The standalone-PINN acceptance run on the card (the port of
`scripts_tpu/pinn_acceptance.py`).

1. `SimpleWave`: a 2-field (u, v) 1D transmission system with a spatially
   varying speed and a PML, a third dynamics on the shared `Integrator`.
2. Its ground-truth rollout by RK4 from a zero field under a `BumpSource`.
3. A coordinate MLP (x/L, t/T) -> (u, v), trained with Adam against the
   finite-difference residuals of that system, with IC, boundary and
   energy supervision.
4. The mean relative error of the trained MLP's energy curve, printed and
   returned.

    python -m waves_jl_tpu_torch.scripts.pinn_acceptance --iters 5000

`--out DIR` also draws the JAX script's three figures there (needs
matplotlib; no default): energy.png, sol.png and frames.png.
`--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
from dataclasses import dataclass

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch
import torch.nn.functional as F

from waves_jl_tpu_torch.constants import WATER
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.dims import build_dirichlet, one_dim
from waves_jl_tpu_torch.models.layers import full_float32
from waves_jl_tpu_torch.ops.fd import gradient_matrix
from waves_jl_tpu_torch.ops.pml import build_pml
from waves_jl_tpu_torch.physics.dynamics import Integrator, build_tspan
from waves_jl_tpu_torch.train.optim import Adam, apply_updates
from waves_jl_tpu_torch.utils.gaussians import build_normal



@dataclass(frozen=True)
class SimpleWave:
    """x (E, 2) fields (u, v); theta the source, t -> (E,):
        u_t = WATER c grad(v) - pml u        (Dirichlet-masked)
        v_t = WATER c grad(u + f) - pml v
    """

    grad: torch.Tensor  # (E, E) finite-difference gradient
    c: torch.Tensor  # (E,) wavespeed profile
    pml: torch.Tensor  # (E,)
    bc: torch.Tensor  # (E,)

    def __call__(self, x, t, theta):
        f = theta(t)
        u, v = x[:, 0], x[:, 1]
        u_t = (WATER * self.c * (self.grad @ v) - self.pml * u) * self.bc
        v_t = WATER * self.c * (self.grad @ (u + f)) - self.pml * v
        return torch.stack([u_t, v_t], dim=1)


@dataclass(frozen=True)
class BumpSource:
    shape: torch.Tensor  # (E,)
    freq: float

    def __call__(self, t):
        return self.shape * torch.sin(2.0 * math.pi * self.freq * t)


def mlp_init(generator: torch.Generator, sizes: list, device) -> list:
    """[{"w": (m, n), "b": (n,)}] of a coordinate MLP: weights uniform in
    +-sqrt(6 / m), zero biases, drawn on the CPU from `generator`."""
    params = []
    for m, n in zip(sizes, sizes[1:]):
        lim = math.sqrt(6.0 / m)
        w = (torch.rand(m, n, generator=generator) * 2.0 - 1.0) * lim
        params.append({"w": w.to(device), "b": torch.zeros(n, device=device)})
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    """x (..., 2) -> (..., 2), leaky_relu between the layers."""
    for layer in params[:-1]:
        x = F.leaky_relu(x @ layer["w"] + layer["b"], 0.01)
    return x @ params[-1]["w"] + params[-1]["b"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="directory of the figures (none by default)")
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--latent-gs", type=float, default=100.0)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--depth", type=int, default=15)
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--chunk", type=int, default=100, help="iterations between loss lines")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


@full_float32()
def run(args) -> dict:
    """Steps 1-4 at the flags' sizes; returns what the figures draw, on the
    host: {"rel_energy_err", "x" (E,), "u_true", "u_pinn" (E, T+1), "e_true",
    "e_pinn" (T+1,)}."""
    dev = resolve_device(args.device)
    dim = one_dim(args.latent_gs, args.elements, device=dev)
    x = dim.x
    dx = float(x[1] - x[0])
    dt = 1e-5
    T = args.steps

    # spatially varying speed and a PML
    c = torch.sin(5.0 * 2.0 * math.pi / 10.0 * x) / 2.0 + 1.0
    pml = build_pml(dim, 3.0, 10000.0)
    dyn = SimpleWave(grad=gradient_matrix(x), c=c, pml=pml, bc=build_dirichlet(dim))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    source = BumpSource(shape=build_normal(x, f32([-2.0, 2.0, 3.0]), f32([0.3, 0.3, 0.4]),
                                           f32([1.0, -1.0, 1.0])), freq=1000.0)

    # the ground truth
    tspan = torch.from_numpy(build_tspan(0.0, dt, T)).to(dev)  # (T+1,)
    with torch.no_grad():
        z = Integrator(dynamics=dyn, dt=dt)(torch.zeros(args.elements, 2, device=dev), tspan,
                                            source)  # (T+1, E, 2)
    u_true = z[:, :, 0].T  # (E, T+1)
    energy_true = torch.sum(u_true**2, dim=0) * dx
    f_t = torch.stack([source(s) for s in tspan], dim=1)  # (E, T+1)

    # the coordinate grid: (x/L, t/(dt T)) pairs
    xg = (x[:, None] / args.latent_gs).expand(args.elements, T + 1)
    tg = (tspan[None, :] / (dt * T)).expand(args.elements, T + 1)
    grid = torch.stack([xg, tg], dim=-1)  # (E, T+1, 2)
    grad_x = gradient_matrix(x)
    grad_t = gradient_matrix(tspan)

    def losses(params):
        out = mlp_apply(params, grid)  # (E, T+1, 2)
        u, v = out[..., 0], out[..., 1]
        u_t = u @ grad_t.T
        v_t = v @ grad_t.T
        n_u = (WATER * c[:, None] * (grad_x @ v) - pml[:, None] * u) * dyn.bc[:, None]
        n_v = WATER * c[:, None] * (grad_x @ (u + f_t)) - pml[:, None] * v
        energy = torch.sum(u**2, dim=0) * dx

        def mse(a, b):
            return torch.mean((a - b) ** 2)

        return {"u": mse(u_t, n_u) / WATER, "v": mse(v_t, n_v) / WATER,
                "boundary": torch.mean(u[0] ** 2) + torch.mean(u[-1] ** 2),
                "ic": mse(out[:, 0, :], z[0]), "energy": mse(energy, energy_true)}

    def total(params):
        l = losses(params)
        return l["u"] + l["v"] + 100.0 * WATER * (l["boundary"] + l["ic"]) + l["energy"]

    layers = mlp_init(torch.Generator().manual_seed(args.seed),
                      [2] + [args.h_size] * args.depth + [2], dev)
    params = {f"{i}.{k}": v.requires_grad_(True) for i, layer in enumerate(layers)
              for k, v in layer.items()}

    def as_layers():
        return [{k: params[f"{i}.{k}"] for k in ("w", "b")} for i in range(len(layers))]

    opt = Adam(args.lr)
    opt_state = opt.init(params)
    t0 = time.time()
    done = 0
    while done < args.iters:
        k = min(args.chunk, args.iters - done)
        for _ in range(k):
            loss = total(as_layers())
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            updates, opt_state = opt.update(grads, opt_state)
            apply_updates(params, updates)
        done += k
        with torch.no_grad():
            l = {name: float(v) for name, v in losses(as_layers()).items()}
        print(f"iter {done}/{args.iters} total {float(loss.detach()):.5g} "
              f"u {l['u']:.4g} v {l['v']:.4g} b {l['boundary']:.4g} "
              f"ic {l['ic']:.4g} e {l['energy']:.4g}", flush=True)
    print(f"trained in {time.time() - t0:.1f}s")

    with torch.no_grad():
        u_pinn = mlp_apply(as_layers(), grid)[..., 0].cpu().numpy()
    e_pinn = (u_pinn**2).sum(0) * dx
    e_true = energy_true.cpu().numpy()
    rel_energy_err = float(np.abs(e_pinn - e_true).mean() / (np.abs(e_true).mean() + 1e-12))
    print(f"mean relative energy error: {rel_energy_err:.4f}")
    return {"rel_energy_err": rel_energy_err, "x": x.cpu().numpy(),
            "u_true": u_true.cpu().numpy(), "u_pinn": u_pinn, "e_true": e_true, "e_pinn": e_pinn}


def draw_figures(r: dict, out: str) -> None:
    """energy.png (the two energy curves), sol.png (the two fields over
    (x, step)) and frames.png (both at four steps) in `out`."""
    from waves_jl_tpu_torch.viz.plot import pyplot

    plt = pyplot()
    os.makedirs(out, exist_ok=True)
    T = r["u_true"].shape[1] - 1
    fig, ax = plt.subplots()
    ax.plot(r["e_true"], label="Ground Truth")
    ax.plot(r["e_pinn"], label="PINN")
    ax.legend(loc="upper left")
    ax.set_xlabel("step")
    ax.set_ylabel("energy")
    fig.savefig(os.path.join(out, "energy.png"), dpi=120)
    plt.close(fig)

    fig, axs = plt.subplots(1, 2, figsize=(10, 4))
    for a, (img, title) in zip(axs, [(r["u_true"], "Ground Truth"), (r["u_pinn"], "PINN")]):
        a.imshow(img, aspect="auto", origin="lower", cmap="seismic")
        a.set_title(title)
        a.set_xlabel("time step")
        a.set_ylabel("x")
    fig.savefig(os.path.join(out, "sol.png"), dpi=120)
    plt.close(fig)

    fig, axs = plt.subplots(2, 2, figsize=(10, 6))
    for a, i in zip(axs.ravel(), [0, T // 3, 2 * T // 3, T]):
        a.plot(r["x"], r["u_true"][:, i], label="GT")
        a.plot(r["x"], r["u_pinn"][:, i], label="PINN")
        a.set_title(f"step {i}")
        a.set_ylim(-2, 2)
    axs[0, 0].legend()
    fig.savefig(os.path.join(out, "frames.png"), dpi=120)
    plt.close(fig)


def main(argv=None) -> float:
    args = parse_args(argv)
    r = run(args)
    if args.out:
        draw_figures(r, args.out)
        print(f"wrote {args.out}/energy.png, sol.png, frames.png")
    return r["rel_energy_err"]


if __name__ == "__main__":
    main()
