"""Batched linear interpolation over time knots (counterpart of
`LinearInterpolation` in `waves_jl_tpu/utils/interp.py`).

X: (B, K) increasing knots; Y: (B, K, E); t: (B,) -> (B, E). t is clamped
into [X[:, 0], X[:, -1]], as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


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
