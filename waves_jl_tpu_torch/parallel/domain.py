"""Domain-decomposed 2D FDTD in plain PyTorch: the grid's y axis cut over a
device mesh (counterpart of `waves_jl_tpu/parallel/domain.py`).

One process holds the list of per-shard slabs, slab k on the mesh's device
k. The 3-point y stencils take one halo column from each neighbour (a
column copy, peer to peer where the slabs lie on different cards);
one-sided stencils apply only at the true domain edges. The PML, Dirichlet
mask, source shape and rasterisation grid are cut alongside the state; the
design and the times are shared.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..designs import DesignInterpolator, speed
from ..ops.fd import fd_dx, fd_dy
from ..utils.trees import tree_map
from .mesh import Mesh


def split_columns(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> list:
    """x cut along `dim` into mesh.size equal contiguous slabs, slab k on
    the mesh's device k."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"{x.shape[dim]} columns do not split into {mesh.size} shards")
    return [s.to(d).contiguous() for s, d in zip(torch.tensor_split(x, mesh.size, dim=dim),
                                                  mesh.devices)]


def fd_dy_halo(slabs: list, dy) -> list:
    """d/dy of a y-sharded field given as its slabs (..., nx, ny_local),
    with one halo column from each neighbour; one-sided stencils at the
    global boundary shards."""
    dy = float(dy)
    if len(slabs) == 1:
        return [fd_dy(slabs[0], dy)]
    out = []
    for k, u in enumerate(slabs):
        zero = torch.zeros_like(u[..., :1])
        from_left = slabs[k - 1][..., -1:].to(u.device) if k > 0 else zero
        from_right = slabs[k + 1][..., :1].to(u.device) if k < len(slabs) - 1 else zero
        up = torch.cat([from_left, u, from_right], dim=-1)
        d = (up[..., 2:] - up[..., :-2]) / (2.0 * dy)
        if k == 0:
            d[..., :1] = (-3.0 * u[..., :1] + 4.0 * u[..., 1:2] - u[..., 2:3]) / (2.0 * dy)
        if k == len(slabs) - 1:
            d[..., -1:] = (u[..., -3:-2] - 4.0 * u[..., -2:-1] + 3.0 * u[..., -1:]) / (2.0 * dy)
        out.append(d)
    return out


def acoustic_rhs_2d_sharded(x: list, c: list, f: list, sx: list, sy: list, bc: list, dx,
                            dy) -> list:
    """Single-stack PML acoustic RHS on y-sharded slabs: x the (6, nx,
    ny_local) fields of each shard; c, f, sx, sy and bc each shard's speed
    (a field or a 0-d tensor), source field, sigma_x, sigma_y and Dirichlet
    mask. Returns each shard's (6, nx, ny_local) derivative."""
    dx = float(dx)
    Vyy = fd_dy_halo([xk[2] for xk in x], dy)
    Uf = [xk[0] + fk for xk, fk in zip(x, f)]
    Uy = fd_dy_halo(Uf, dy)
    out = []
    for k, xk in enumerate(x):
        U, Vx, Vy, Px, Py, Om = xk[0], xk[1], xk[2], xk[3], xk[4], xk[5]
        b = c[k] ** 2
        Vxx = fd_dx(Vx, dx)
        Ux = fd_dx(Uf[k], dx)
        dU = b * (Vxx + Vyy[k]) + Px + Py - (sx[k] + sy[k]) * U - Om
        dVx = Ux - sx[k] * Vx
        dVy = Uy[k] - sy[k] * Vy
        dPx = b * sx[k] * Vyy[k]
        dPy = b * sy[k] * Vxx
        dOm = sx[k] * sy[k] * U
        out.append(torch.stack([bc[k] * dU, dVx, dVy, dPx, dPy, dOm], dim=0))
    return out


def sum_in_order(parts: list, device) -> torch.Tensor:
    """parts[0] + parts[1] + ... on `device`, in shard order (the psum)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def make_sharded_rollout(mesh: Mesh, c0: float, dx, dy, steps: int, dt: float):
    """Build a y-sharded FDTD rollout over the mesh's devices.

    rollout(u0, tspan, interp, grid, f_shape, f_freq, sx, sy, bc, d_omega)
    -> (u_final, signal) with u0 (12, nx, ny), tspan (steps+1,) host times,
    interp a `DesignInterpolator` rasterised per shard on its slab of grid
    (nx, ny, 2), f_shape, sx, sy, bc (nx, ny). Returns the final global
    state on the mesh's first device and the per-step [tot, inc, sc]
    energies times d_omega, summed over shards.
    """
    c0, dt = float(c0), float(dt)
    f = np.float32

    def rollout(u0, tspan, interp, grid, f_shape, f_freq, sx, sy, bc, d_omega):
        if len(tspan) != steps + 1:
            raise ValueError(f"tspan has {len(tspan)} times, expected {steps + 1}")
        devs = mesh.devices
        us = split_columns(u0, mesh)
        grids = split_columns(grid, mesh, dim=1)
        shapes, sxs, sys, bcs = (split_columns(a, mesh) for a in (f_shape, sx, sy, bc))
        interps = [DesignInterpolator(tree_map(lambda v: v.to(d), interp.initial),
                                      tree_map(lambda v: v.to(d), interp.final),
                                      interp.ti, interp.tf) for d in devs]
        c_inc = [torch.tensor(c0, dtype=torch.float32, device=d) for d in devs]
        freq, dom = f(float(f_freq)), float(d_omega)

        def rhs(xs, t):
            cs = [speed(it(t), g, c0) for it, g in zip(interps, grids)]
            sn = float(np.sin(f(2.0 * math.pi) * f(t) * freq))
            fs = [s * sn for s in shapes]
            dtot = acoustic_rhs_2d_sharded([x[0:6] for x in xs], cs, fs, sxs, sys, bcs, dx, dy)
            dinc = acoustic_rhs_2d_sharded([x[6:12] for x in xs], c_inc, fs, sxs, sys, bcs,
                                           dx, dy)
            return [torch.cat([a, b], dim=0) for a, b in zip(dtot, dinc)]

        def rk4_step(xs, t):
            th, t1 = f(t + f(0.5 * dt)), f(t + f(dt))
            k1 = rhs(xs, t)
            k2 = rhs([u + 0.5 * dt * k for u, k in zip(xs, k1)], th)
            k3 = rhs([u + 0.5 * dt * k for u, k in zip(xs, k2)], th)
            k4 = rhs([u + dt * k for u, k in zip(xs, k3)], t1)
            return [u + dt * (a + 2.0 * b + 2.0 * c + d) / 6.0
                    for u, a, b, c, d in zip(xs, k1, k2, k3, k4)]

        def energy(xs):
            parts = []
            for u in xs:
                sc = u[0] - u[6]
                parts.append(torch.stack([torch.sum(u[0] ** 2) * dom, torch.sum(u[6] ** 2) * dom,
                                          torch.sum(sc ** 2) * dom]))
            return sum_in_order(parts, devs[0])

        signal = [energy(us)]
        for t in tspan[:-1]:
            us = rk4_step(us, f(t))
            signal.append(energy(us))
        return torch.cat([u.to(devs[0]) for u in us], dim=-1), torch.stack(signal)

    return rollout
