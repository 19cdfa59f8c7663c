"""Latent-sensitivity demo (the port of `scripts_tpu/adjoint_demo.py`):
optimise the sine coefficients of a latent initial condition so that the
rolled-out displacement hits a Gaussian target, by autograd through the
1-D latent integrator in "sqrt" checkpointing and the port's optax-equal
Adam:

    python -m waves_jl_tpu_torch.scripts.adjoint_demo --steps 300 --iters 10

The final loss must be below the first. `--out` draws the rollout and the
final field against the target (needs matplotlib). `--device cpu` runs on
the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from waves_jl_tpu_torch.constants import WATER
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.dims import one_dim
from waves_jl_tpu_torch.models.layers import embed_sin, full_float32, sin_basis
from waves_jl_tpu_torch.physics.dynamics import (Integrator, build_tspan,
                                                 make_acoustic_dynamics_1d)
from waves_jl_tpu_torch.sources import Source
from waves_jl_tpu_torch.train.optim import Adam, apply_updates
from waves_jl_tpu_torch.utils.gaussians import build_normal
from waves_jl_tpu_torch.utils.interp import LinearInterpolation

GRID_SIZE = 15.0
DT = 1e-5


class AdjointProblem:
    """The demo's latent system at `elements` points and `steps` steps:
    `loss(coefs)` is the mean squared distance of the final displacement
    from the target plus 0.005 |coefs|, for coefs (1, 4, nfreq)."""

    def __init__(self, steps: int = 300, nfreq: int = 50, elements: int = 1024, device="cuda"):
        dev = resolve_device(device)
        self.device = dev
        self.latent_dim = one_dim(GRID_SIZE, elements, device=dev)
        dyn = make_acoustic_dynamics_1d(self.latent_dim, WATER, 5.0, 10000.0)
        self.integrator = Integrator(dynamics=dyn, dt=DT, checkpoint="sqrt")

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        self.target = build_normal(self.latent_dim.x, f32([0.0]), f32([0.3]), f32([1.0]))
        self.basis = sin_basis(elements, GRID_SIZE, nfreq, dev)
        self.tspan = torch.from_numpy(build_tspan(0.0, DT, steps)).to(dev)[None]  # (1, T+1)
        C = LinearInterpolation(X=self.tspan[:, [0, -1]],
                                Y=torch.ones((1, 2, elements), dtype=torch.float32, device=dev))
        F = Source(shape=torch.zeros((1, elements), dtype=torch.float32, device=dev),
                   freq=f32(1.0))
        self.theta = (C, F, (dyn.pml / dyn.pml[0])[None])

    def rollout(self, coefs: torch.Tensor) -> torch.Tensor:
        """(T+1, 1, 4, E) latent trajectory from the coefficients."""
        return self.integrator(embed_sin(self.basis, coefs), self.tspan, self.theta)

    @full_float32()
    def loss(self, coefs: torch.Tensor) -> torch.Tensor:
        z = self.rollout(coefs)
        return torch.mean((z[-1, 0, 0] - self.target) ** 2) + 0.005 * torch.linalg.norm(coefs)


def optimise(problem: AdjointProblem, coefs: torch.Tensor, iters: int, lr: float = 5e-2,
             log=print) -> tuple[torch.Tensor, list]:
    """`iters` Adam steps on problem.loss from coefs; returns (the final
    coefficients, the loss before each step)."""
    params = {"coefs": coefs.detach().clone().requires_grad_(True)}
    opt = Adam(lr)
    state = opt.init(params)
    losses = []
    for i in range(iters):
        loss = problem.loss(params["coefs"])
        (grad,) = torch.autograd.grad(loss, [params["coefs"]])
        updates, state = opt.update({"coefs": grad}, state)
        apply_updates(params, updates)
        losses.append(float(loss.detach()))
        log(f"iter {i}: loss {losses[-1]:.6g}")
    return params["coefs"].detach(), losses


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--nfreq", type=int, default=50)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="figure path (none by default)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    problem = AdjointProblem(args.steps, args.nfreq, args.elements, args.device)
    g = torch.Generator().manual_seed(args.seed)
    coefs0 = (torch.randn((1, 4, args.nfreq), generator=g) * 0.01).to(problem.device)
    coefs, losses = optimise(problem, coefs0, args.iters,
                             log=lambda m: print(m, flush=True))
    if not losses[-1] < losses[0]:
        raise SystemExit("adjoint optimization did not improve")
    if args.out:
        from waves_jl_tpu_torch.viz.plot import pyplot

        with torch.no_grad():
            z = problem.rollout(coefs)[:, 0, 0].cpu().numpy()  # (T+1, E)
        x = problem.latent_dim.x.cpu().numpy()
        plt = pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].imshow(z, aspect="auto", cmap="cividis")
        axes[0].set_title("Optimized rollout u(x, t)")
        axes[1].plot(x, z[-1], label="final")
        axes[1].plot(x, problem.target.cpu().numpy(), label="target")
        axes[1].legend()
        fig.savefig(args.out, dpi=120)
        plt.close(fig)
        print(f"wrote {args.out}")
    return losses


if __name__ == "__main__":
    main()
