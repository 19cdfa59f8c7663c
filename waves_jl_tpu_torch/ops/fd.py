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


def dx_edge_aware(u: torch.Tensor, inv2d: float) -> torch.Tensor:
    """d/dx along axis -2 in the fused kernel's form and op order: central
    differences, one-sided at rows 0 and n-1, times 1/(2 dx)."""
    central = u[..., 2:, :] - u[..., :-2, :]
    left = -3.0 * u[..., :1, :] + 4.0 * u[..., 1:2, :] - u[..., 2:3, :]
    right = 3.0 * u[..., -1:, :] - 4.0 * u[..., -2:-1, :] + u[..., -3:-2, :]
    return torch.cat([left, central, right], dim=-2) * inv2d


def dy_edge_aware(u: torch.Tensor, inv2d: float) -> torch.Tensor:
    """d/dy along axis -1, as `dx_edge_aware`."""
    central = u[..., 2:] - u[..., :-2]
    left = -3.0 * u[..., :1] + 4.0 * u[..., 1:2] - u[..., 2:3]
    right = 3.0 * u[..., -1:] - 4.0 * u[..., -2:-1] + u[..., -3:-2]
    return torch.cat([left, central, right], dim=-1) * inv2d
