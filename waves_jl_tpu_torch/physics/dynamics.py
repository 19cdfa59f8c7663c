"""Dynamics and time integration (counterpart of
`waves_jl_tpu/physics/dynamics.py`).

* `runge_kutta`: classic RK4 increment with the JAX package's op order.
* `Integrator`: steps a dynamics `rhs(u, t, theta) -> du` over a time grid,
  shared or per sample, with the JAX package's three checkpoint modes.
* `AcousticDynamics2D`: split-field PML acoustic system over 12 channels,
  the total field (design speed) and the incident field (ambient c0). This
  is the plain reference of the fused RK4 kernel's equations.
* `AcousticDynamics3D`: the same system in 3-D over 16 channels, an
  extension the JAX package makes beyond the reference.
* `AcousticDynamics1D`: the surrogate's 4-field latent system with learned
  PML, batched; the spatial derivative is a dense (E, E) matmul.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dims import OneDim, ThreeDim, TwoDim, build_dirichlet, get_dx, get_dy
from ..ops.fd import fd_d, fd_dx, fd_dy, gradient_matrix
from ..ops.pml import build_pml


def xla_linspace(lo: float, hi: float, n: int) -> np.ndarray:
    """(n,) float32 points from lo to hi, computed on the host as XLA
    compiles `jnp.linspace(lo, hi, n)`: its lo (1 - k/(n-1)) + hi (k/(n-1))
    with the division turned into a product with c = 1/(n-1) and hi (k c)
    into k (hi c), then hi itself. Where XLA's vector code contracts a
    point's sum into an FMA, that point rounds one ulp apart."""
    f = np.float32
    lo, hi = f(lo), f(hi)
    k = np.arange(n - 1, dtype=f)
    c = f(1.0) / f(n - 1)
    out = lo * (f(1.0) - k * c) + k * (hi * c)
    return np.concatenate([out, np.array([hi], f)])


def build_tspan(ti: float, dt: float, steps: int) -> np.ndarray:
    """(steps+1,) float32 time points from ti to tf = ti + steps dt, as
    `jnp.linspace(ti, tf, steps + 1)` gives them (`xla_linspace`)."""
    return xla_linspace(ti, ti + steps * dt, steps + 1)


def runge_kutta(f, u, t, theta, dt):
    """One RK4 increment (times dt). A dynamics with `at(t, theta) -> rhs(u)`
    has its time-dependent terms evaluated once for both midpoint stages."""
    at = getattr(f, "at", None) or (lambda s, th: lambda v: f(v, s, th))
    f0, fh, f1 = at(t, theta), at(t + 0.5 * dt, theta), at(t + dt, theta)
    k1 = f0(u)
    k2 = fh(u + 0.5 * dt * k1)
    k3 = fh(u + 0.5 * dt * k2)
    k4 = f1(u + dt * k3)
    du = (1.0 / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return du * dt


@dataclass(frozen=True)
class Integrator:
    """Steps `dynamics` over a time grid.

    checkpoint: "none" | "step" | "sqrt", what autograd keeps for the
    backward pass (`torch.utils.checkpoint`, non-reentrant); the values are
    the same in every mode, only memory and time differ:
      - "none": every step's activations;
      - "step": each step's input state, the step recomputed on backward;
      - "sqrt": chunks of int(sqrt(T)) steps, each recomputed on backward
        from its first state; the remainder runs unchunked.
    """

    dynamics: Any
    integration_function: Callable = runge_kutta
    dt: float = 1e-5
    checkpoint: str = "none"

    def step(self, u, t, theta):
        return u + self.integration_function(self.dynamics, u, t, theta, self.dt)

    def _steps(self, u, ts, theta) -> list:
        out = []
        for t in ts:
            u = self.step(u, t, theta)
            out.append(u)
        return out

    def __call__(self, u0, tspan, theta) -> torch.Tensor:
        """Trajectory (T+1, ...) with u0 first. tspan (T+1,) shared times
        (host or tensor) or (B, T+1) per-sample times, stepped with each
        sample's own (B,) time."""
        ts = list(tspan[:-1] if tspan.ndim == 1 else tspan.T[:-1])
        mode = self.checkpoint if torch.is_grad_enabled() else "none"
        if mode == "none":
            traj = self._steps(u0, ts, theta)
        elif mode == "step":
            traj = [u0]
            for t in ts:
                traj.append(checkpoint(self.step, traj[-1], t, theta, use_reentrant=False))
            traj = traj[1:]
        elif mode == "sqrt":
            chunk = max(1, int(len(ts) ** 0.5))
            n_main = len(ts) // chunk * chunk
            traj, u = [], u0
            for i in range(0, n_main, chunk):
                part = checkpoint(lambda v, tc: torch.stack(self._steps(v, tc, theta)), u,
                                  ts[i:i + chunk], use_reentrant=False)
                traj.extend(part.unbind(0))
                u = traj[-1]
            traj.extend(self._steps(u, ts[n_main:], theta))
        else:
            raise ValueError(f"checkpoint must be 'none', 'step' or 'sqrt', not {self.checkpoint!r}")
        return torch.stack([u0, *traj], dim=0)

    def rollout_final(self, u0, tspan, theta) -> torch.Tensor:
        """The final state alone, no trajectory kept."""
        u = u0
        for t in (tspan[:-1] if tspan.ndim == 1 else tspan.T[:-1]):
            u = self.step(u, t, theta)
        return u


def acoustic_rhs_2d(x, c, f, pml, bc, dx, dy):
    """One stack of the split-field PML system. x: (6, nx, ny) fields
    U, Vx, Vy, Psix, Psiy, Omega; c speed (field or scalar); f source field;
    pml (nx, ny) varying along x (sigma_y is its transpose)."""
    U, Vx, Vy, Px, Py, Om = x[0], x[1], x[2], x[3], x[4], x[5]
    b = c**2
    sx = pml
    sy = pml.T
    Vxx = fd_dx(Vx, dx)
    Vyy = fd_dy(Vy, dy)
    Uf = U + f
    Ux = fd_dx(Uf, dx)
    Uy = fd_dy(Uf, dy)
    dU = b * (Vxx + Vyy) + Px + Py - (sx + sy) * U - Om
    dVx = Ux - sx * Vx
    dVy = Uy - sy * Vy
    dPx = b * sx * Vyy
    dPy = b * sy * Vxx
    dOm = sx * sy * U
    return torch.stack([bc * dU, dVx, dVy, dPx, dPy, dOm], dim=0)


@dataclass(frozen=True)
class AcousticDynamics2D:
    """theta = (C, F): t -> speed field and t -> source field."""

    c0: float
    pml: torch.Tensor  # (nx, ny)
    bc: torch.Tensor  # (nx, ny)
    dx: torch.Tensor
    dy: torch.Tensor

    def __call__(self, x, t, theta):
        C, F = theta
        c = C(t)
        f = F(t)
        dtot = acoustic_rhs_2d(x[0:6], c, f, self.pml, self.bc, self.dx, self.dy)
        c0 = torch.tensor(self.c0, dtype=torch.float32, device=x.device)
        dinc = acoustic_rhs_2d(x[6:12], c0, f, self.pml, self.bc, self.dx, self.dy)
        return torch.cat([dtot, dinc], dim=0)


def make_acoustic_dynamics_2d(dim: TwoDim, c0: float, pml_width: float,
                              pml_scale: float) -> AcousticDynamics2D:
    return AcousticDynamics2D(
        c0=float(c0),
        pml=build_pml(dim, pml_width, pml_scale),
        bc=build_dirichlet(dim),
        dx=get_dx(dim),
        dy=get_dy(dim),
    )


def acoustic_rhs_3d(x, c, f, prof, bc, spacing):
    """One stack of the 3-D split-field PML system. x: (8, nx, ny, nz)
    fields U, Vx, Vy, Vz, Psix, Psiy, Psiz, Omega; c speed (field or
    scalar); f source field; prof (n,) sigma profile broadcast along each
    axis; bc Dirichlet mask; spacing uniform. Each Psi_i damps the
    divergence of the other axes' velocities and Omega integrates the
    pairwise sigma products (the triple product is dropped), as in the JAX
    package."""
    U, Vx, Vy, Vz, Px, Py, Pz, Om = (x[i] for i in range(8))
    b = c**2
    sx = prof[:, None, None]
    sy = prof[None, :, None]
    sz = prof[None, None, :]
    Vxx = fd_d(Vx, spacing, -3)
    Vyy = fd_d(Vy, spacing, -2)
    Vzz = fd_d(Vz, spacing, -1)
    Uf = U + f
    Ux = fd_d(Uf, spacing, -3)
    Uy = fd_d(Uf, spacing, -2)
    Uz = fd_d(Uf, spacing, -1)
    dU = b * (Vxx + Vyy + Vzz) + Px + Py + Pz - (sx + sy + sz) * U - Om
    dVx = Ux - sx * Vx
    dVy = Uy - sy * Vy
    dVz = Uz - sz * Vz
    dPx = b * sx * (Vyy + Vzz)
    dPy = b * sy * (Vxx + Vzz)
    dPz = b * sz * (Vxx + Vyy)
    dOm = (sx * sy + sy * sz + sz * sx) * U
    return torch.stack([bc * dU, dVx, dVy, dVz, dPx, dPy, dPz, dOm], dim=0)


@dataclass(frozen=True)
class AcousticDynamics3D:
    """Total and incident stacks over 16 channels, the 3-D counterpart of
    `AcousticDynamics2D`. theta = (C, F): t -> speed (field or scalar) and
    t -> source field."""

    c0: float
    prof: torch.Tensor  # (n,)
    bc: torch.Tensor  # (nx, ny, nz)
    spacing: torch.Tensor

    def __call__(self, x, t, theta):
        C, F = theta
        c = C(t)
        f = F(t)
        dtot = acoustic_rhs_3d(x[0:8], c, f, self.prof, self.bc, self.spacing)
        dinc = acoustic_rhs_3d(x[8:16], self.c0, f, self.prof, self.bc, self.spacing)
        return torch.cat([dtot, dinc], dim=0)


def make_acoustic_dynamics_3d(dim: ThreeDim, c0: float, pml_width: float,
                              pml_scale: float) -> AcousticDynamics3D:
    return AcousticDynamics3D(
        c0=float(c0),
        prof=build_pml(dim, pml_width, pml_scale),
        bc=build_dirichlet(dim),
        spacing=get_dx(dim),
    )


@dataclass(frozen=True)
class AcousticDynamics1D:
    """Batched latent system. x: (B, 4, E) fields U_tot, V_tot, U_inc, V_inc;
    theta = (C, F, PML): C(t) -> (B, E) latent speed, F(t) -> (B, E) latent
    source, PML (B, E) learned profile scaled by pml[0].

    `state_dtype="bfloat16"` runs the whole stage in bf16: sigma, C(t),
    F(t), the state and the masks, the contraction accumulated in float32
    and rounded to bf16 once (cuBLAS's reduced-precision bf16 reduction is
    off in the models' calls, `full_float32`). Energies drift about 1e-2
    relative in bf16 state: MPC ranking only (`fast_ranking`). Default
    float32."""

    c0: float
    grad: torch.Tensor  # (E, E)
    pml: torch.Tensor  # (E,); only pml[0] (the boundary value) is used
    bc: torch.Tensor  # (E,)
    state_dtype: str = "float32"

    def __post_init__(self):
        dev = self.grad.device
        dt = torch.bfloat16 if self.state_dtype == "bfloat16" else torch.float32
        # constant masks of the field-broadcast form, built once, in the state's type
        object.__setattr__(self, "_dtype", dt)
        object.__setattr__(self, "_c0", torch.tensor(self.c0, dtype=dt, device=dev))
        object.__setattr__(self, "_perm", torch.tensor([1, 0, 3, 2], device=dev))
        object.__setattr__(self, "_e_uf",
                           torch.tensor([0.0, 1.0, 0.0, 1.0], dtype=dt, device=dev)[None, :, None])
        tot = torch.tensor([True, True, False, False], device=dev)[None, :, None]
        object.__setattr__(self, "_tot", tot)
        bc_mask = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)[None, :, None] * (
            self.bc[None, None, :] - 1.0) + 1.0
        object.__setattr__(self, "_bc_mask", bc_mask.to(dt))
        object.__setattr__(self, "_grad", self.grad.to(dt))

    def at(self, t, theta):
        """The right-hand side at time t, x -> du, with C(t) and F(t)
        evaluated once."""
        C, F, PML = theta
        dt = self._dtype
        sigma = (self.pml[0] * PML).to(dt)
        c = C(t).to(dt)
        f = F(t).to(dt)
        fe = f[:, None] * self._e_uf
        coef = self._c0 * torch.where(self._tot, c[:, None], torch.ones_like(c[:, None]))

        def rhs(x):
            # y = x[:, perm] + f * e_uf; d = y @ grad^T; du = coef * d - sigma * x
            x = x.to(dt)
            d = torch.matmul(x[:, self._perm] + fe, self._grad.T)
            return (coef * d - sigma[:, None] * x) * self._bc_mask

        return rhs

    def __call__(self, x, t, theta):
        return self.at(t, theta)(x)


def make_acoustic_dynamics_1d(dim: OneDim, c0: float, pml_width: float,
                              pml_scale: float) -> AcousticDynamics1D:
    return AcousticDynamics1D(
        c0=float(c0),
        grad=gradient_matrix(dim.x),
        pml=build_pml(dim, pml_width, pml_scale),
        bc=build_dirichlet(dim),
    )
