"""Dynamics beyond the acoustic cloak (counterpart of
`waves_jl_tpu/physics/extra.py`): any `rhs(u, t, theta) -> du` steps
through the same `Integrator`. An undamped 3-field wave ("pandemic", after
the reference's `scripts/pandemic.jl`) and a combustion-style
reaction-diffusion system ("wildfire", after `scripts/old_wildfire.jl`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import WATER
from ..dims import TwoDim, build_dirichlet, get_dx, get_dy
from ..ops.fd import fd_dx, fd_dy


@dataclass(frozen=True)
class PandemicDynamics:
    """dU = c0 (dVx/dx + dVy/dy); dVx = c0 d(U+f)/dx; dVy = c0 d(U+f)/dy,
    with c0 the speed in water. theta = (F,): t -> source field."""

    bc: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor

    def __call__(self, x, t, theta):
        (F,) = theta
        f = F(t)
        U, Vx, Vy = x[0], x[1], x[2]
        Vxx = fd_dx(Vx, self.dx)
        Vyy = fd_dy(Vy, self.dy)
        Uf = U + f
        Ux = fd_dx(Uf, self.dx)
        Uy = fd_dy(Uf, self.dy)
        dU = WATER * (Vxx + Vyy)
        dVx = WATER * Ux
        dVy = WATER * Uy
        return torch.stack([dU * self.bc, dVx, dVy], dim=0)


def make_pandemic_dynamics(dim: TwoDim) -> PandemicDynamics:
    return PandemicDynamics(bc=build_dirichlet(dim), dx=get_dx(dim), dy=get_dy(dim))


@dataclass(frozen=True)
class WildfireDynamics:
    """Temperature T with diffusion, wind advection, an Arrhenius-like burn
    and Newton cooling, and the fuel fraction X the burn consumes. State
    (2, nx, ny) = [T, X]; theta unused (autonomous)."""

    dx: torch.Tensor
    dy: torch.Tensor
    kappa: torch.Tensor  # diffusivity
    wind: torch.Tensor  # (2,) wind velocity
    t_ambient: torch.Tensor
    t_ign: torch.Tensor
    rate: torch.Tensor  # reaction rate scale
    heat: torch.Tensor  # heat release per unit fuel
    cool: torch.Tensor  # Newton cooling coefficient

    def __call__(self, x, t, theta):
        T, X = x[0], x[1]
        Tx = fd_dx(T, self.dx)
        Ty = fd_dy(T, self.dy)
        lap = fd_dx(Tx, self.dx) + fd_dy(Ty, self.dy)
        adv = self.wind[0] * Tx + self.wind[1] * Ty
        ignited = torch.sigmoid((T - self.t_ign) * 0.05)
        burn = self.rate * ignited * torch.clamp(X, min=0.0) * torch.exp(
            -self.t_ign / torch.clamp(T, min=1.0))
        dT = self.kappa * lap - adv + self.heat * burn - self.cool * (T - self.t_ambient)
        return torch.stack([dT, -burn], dim=0)


def make_wildfire_dynamics(dim: TwoDim, kappa: float = 0.5, wind=(0.5, 0.0),
                           t_ambient: float = 298.15, t_ign: float = 431.6, rate: float = 5.0,
                           heat: float = 200.0, cool: float = 0.05) -> WildfireDynamics:
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dim.x.device)

    return WildfireDynamics(dx=get_dx(dim), dy=get_dy(dim), kappa=f32(kappa), wind=f32(wind),
                            t_ambient=f32(t_ambient), t_ign=f32(t_ign), rate=f32(rate),
                            heat=f32(heat), cool=f32(cool))
