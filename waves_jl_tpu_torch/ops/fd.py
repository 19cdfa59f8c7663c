"""Finite-difference operators (counterpart of `waves_jl_tpu/ops/fd.py`).

Interior (u[i+1]-u[i-1])/(2 dx); one-sided rows (-3u0+4u1-u2)/(2 dx) and
(u[-3]-4u[-2]+3u[-1])/(2 dx) at the two ends.
"""
from __future__ import annotations

import torch


def gradient_matrix(x: torch.Tensor) -> torch.Tensor:
    """Dense (N, N) first-derivative operator; row i maps u -> du/dx at i."""
    n = x.shape[0]
    dx = (x[-1] - x[0]) / (n - 1)
    grad = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    i = torch.arange(1, n - 1, device=x.device)
    grad[i, i - 1] = -1.0
    grad[i, i + 1] = 1.0
    grad[0, 0], grad[0, 1], grad[0, 2] = -3.0, 4.0, -1.0
    grad[n - 1, n - 3], grad[n - 1, n - 2], grad[n - 1, n - 1] = 1.0, -4.0, 3.0
    return grad / (2.0 * dx)


def laplacian_matrix(x: torch.Tensor) -> torch.Tensor:
    """Dense (N, N) second-derivative operator: (1, -2, 1) / dx^2 inside,
    and the one-sided rows (2, -5, 4, -1) / dx^3 at the two ends. The ends
    divide by dx^3, copied from the reference's operator (sic)."""
    n = x.shape[0]
    dx = (x[-1] - x[0]) / (n - 1)
    lap = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    i = torch.arange(1, n - 1, device=x.device)
    lap[i, i - 1] = 1.0
    lap[i, i] = -2.0
    lap[i, i + 1] = 1.0
    lap = lap / dx**2
    b = torch.tensor([2.0, -5.0, 4.0, -1.0], dtype=torch.float32, device=x.device) / dx**3
    lap[0, 0:4] = b
    lap[n - 1, n - 4:n] = b.flip(0)
    return lap


def _d_last(v: torch.Tensor, spacing) -> torch.Tensor:
    interior = v[..., 2:] - v[..., :-2]
    left = -3.0 * v[..., :1] + 4.0 * v[..., 1:2] - v[..., 2:3]
    right = v[..., -3:-2] - 4.0 * v[..., -2:-1] + 3.0 * v[..., -1:]
    return torch.cat([left, interior, right], dim=-1) / (2.0 * spacing)


def fd_d(u: torch.Tensor, spacing, axis: int) -> torch.Tensor:
    """First derivative along any axis with `fd_dx`'s stencils."""
    return torch.movedim(_d_last(torch.movedim(u, axis, -1), spacing), -1, axis)


def fd_grad_1d(u: torch.Tensor, dx, axis: int = -1) -> torch.Tensor:
    """First derivative along `axis` by the stencil; `gradient_matrix @ u`."""
    return fd_d(u, dx, axis)


def fd_dx(u: torch.Tensor, dx) -> torch.Tensor:
    """d/dx of a field laid out (..., nx, ny): derivative along axis -2."""
    interior = u[..., 2:, :] - u[..., :-2, :]
    left = -3.0 * u[..., :1, :] + 4.0 * u[..., 1:2, :] - u[..., 2:3, :]
    right = u[..., -3:-2, :] - 4.0 * u[..., -2:-1, :] + 3.0 * u[..., -1:, :]
    return torch.cat([left, interior, right], dim=-2) / (2.0 * dx)


def fd_dy(u: torch.Tensor, dy) -> torch.Tensor:
    """d/dy of a field laid out (..., nx, ny): derivative along axis -1."""
    interior = u[..., 2:] - u[..., :-2]
    left = -3.0 * u[..., :1] + 4.0 * u[..., 1:2] - u[..., 2:3]
    right = u[..., -3:-2] - 4.0 * u[..., -2:-1] + 3.0 * u[..., -1:]
    return torch.cat([left, interior, right], dim=-1) / (2.0 * dy)


def divergence(u: torch.Tensor, dx, dy) -> torch.Tensor:
    """d/dx u + d/dy u of a field laid out (..., nx, ny)."""
    return fd_dx(u, dx) + fd_dy(u, dy)


def _dx_taps(u: torch.Tensor) -> torch.Tensor:
    """2 dx times d/dx along axis -2: central differences, one-sided at rows
    0 and n-1, in the fused kernel's op order."""
    central = u[..., 2:, :] - u[..., :-2, :]
    left = -3.0 * u[..., :1, :] + 4.0 * u[..., 1:2, :] - u[..., 2:3, :]
    right = 3.0 * u[..., -1:, :] - 4.0 * u[..., -2:-1, :] + u[..., -3:-2, :]
    return torch.cat([left, central, right], dim=-2)


def dx_edge_aware(u: torch.Tensor, inv2d: float) -> torch.Tensor:
    """d/dx along axis -2 in the fused kernel's form and op order: central
    differences, one-sided at rows 0 and n-1, times 1/(2 dx)."""
    return _dx_taps(u) * inv2d


def split_bf16(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) float32 tensors with hi = bf16(u) and lo = bf16(u - hi),
    both rounded to nearest even: 16 of u's 24 mantissa bits."""
    hi = u.to(torch.bfloat16).to(torch.float32)
    return hi, (u - hi).to(torch.bfloat16).to(torch.float32)


def dx_split_bf16(u: torch.Tensor, inv2d: float) -> torch.Tensor:
    """d/dx along axis -2 as the JAX fused kernel's default `x_matmul` mode
    computes it (`waves_jl_tpu/ops/pallas_fd.py:278-310`): the stencil
    matrix D times bf16(u) and times bf16(u - bf16(u)), each product summed
    in float32, (D hi + D lo) / (2 dx). D's entries are small integers, so
    every product is exact and a row's sum rounds as the stencil's taps do."""
    hi, lo = split_bf16(u)
    return (_dx_taps(hi) + _dx_taps(lo)) * inv2d


def dy_edge_aware(u: torch.Tensor, inv2d: float) -> torch.Tensor:
    """d/dy along axis -1, as `dx_edge_aware`."""
    central = u[..., 2:] - u[..., :-2]
    left = -3.0 * u[..., :1] + 4.0 * u[..., 1:2] - u[..., 2:3]
    right = 3.0 * u[..., -1:] - 4.0 * u[..., -2:-1] + u[..., -3:-2]
    return torch.cat([left, central, right], dim=-1) * inv2d
