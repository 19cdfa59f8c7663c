"""Interpolation utilities (counterpart of `flatten_repeated_last_dim` and
`LinearInterpolation` in `waves_jl_tpu/utils/interp.py`).

Linear interpolation: X (B, K) increasing knots; Y (B, K, E); t (B,) ->
(B, E). t is clamped into [X[:, 0], X[:, -1]], as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def flatten_repeated_last_dim(x: torch.Tensor) -> torch.Tensor:
    """Join K consecutive windows of length T that share endpoints:
    x (..., K, T) with x[..., i, -1] == x[..., i+1, 0] ->
    (..., T + (K-1)(T-1)), the first window whole and each later one
    without its first point."""
    head = x[..., 0, :]
    tail = x[..., 1:, 1:]
    tail = tail.reshape(*tail.shape[:-2], tail.shape[-2] * tail.shape[-1])
    return torch.cat([head, tail], dim=-1)


def linear_interp(X: torch.Tensor, Y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    tb = torch.minimum(torch.maximum(t[:, None], X[:, :1]), X[:, -1:])
    l, r = X[:, :-1], X[:, 1:]
    final = (r == r[:, -1:]) & (r[:, -1:] == tb)
    m = (((l <= tb) & (tb < r)) | final).to(Y.dtype)
    x0 = torch.sum(l * m, dim=1)
    y0 = torch.einsum("bk,bke->be", m, Y[:, :-1, :])
    dX = r - l
    slope = (Y[:, 1:, :] - Y[:, :-1, :]) / torch.where(dX == 0, torch.ones_like(dX), dX)[..., None]
    dydx = torch.einsum("bk,bke->be", m, slope)
    return y0 + (tb[:, 0] - x0)[:, None] * dydx


@dataclass(frozen=True)
class LinearInterpolation:
    X: torch.Tensor  # (B, K)
    Y: torch.Tensor  # (B, K, E)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return linear_interp(self.X, self.Y, t)
