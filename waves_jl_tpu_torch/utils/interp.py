"""Interpolation utilities (counterpart of `waves_jl_tpu/utils/interp.py`:
`flatten_repeated_last_dim`, `LinearInterpolation`, `PolynomialInterpolation`
and `evaluate_over_time`).

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
    return LinearInterpolation(X, Y)(t)


@dataclass(frozen=True)
class LinearInterpolation:
    """C(t) over knots X (B, K) with values Y (B, K, E). The segments'
    bounds and slopes are derived once, when the interpolant is built, so a
    rollout that calls it at every stage records only the per-call
    operations."""

    X: torch.Tensor  # (B, K)
    Y: torch.Tensor  # (B, K, E)

    def __post_init__(self):
        X, Y = self.X, self.Y
        l, r = X[:, :-1], X[:, 1:]
        dX = r - l
        slope = (Y[:, 1:, :] - Y[:, :-1, :]) / torch.where(dX == 0, torch.ones_like(dX), dX)[..., None]
        object.__setattr__(self, "_l", l)
        object.__setattr__(self, "_r", r)
        object.__setattr__(self, "_at_end", r == r[:, -1:])
        object.__setattr__(self, "_slope", slope)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        X, l, r = self.X, self._l, self._r
        tb = torch.minimum(torch.maximum(t[:, None], X[:, :1]), X[:, -1:])
        final = self._at_end & (r[:, -1:] == tb)
        m = (((l <= tb) & (tb < r)) | final).to(self.Y.dtype)
        x0 = torch.sum(l * m, dim=1)
        y0 = torch.einsum("bk,bke->be", m, self.Y[:, :-1, :])
        dydx = torch.einsum("bk,bke->be", m, self._slope)
        return y0 + (tb[:, 0] - x0)[:, None] * dydx


@dataclass(frozen=True)
class PolynomialInterpolation:
    """Lagrange polynomial through the knots X (B, K) with values Y
    (B, K, E): t (B,) -> (B, E). Each factor is divided by the largest
    |X| of its row and offset by 1e-5 before the products, as in the JAX
    package (and the reference)."""

    X: torch.Tensor  # (B, K)
    Y: torch.Tensor  # (B, K, E)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        X, Y = self.X, self.Y
        K = X.shape[1]
        eye = torch.eye(K, dtype=Y.dtype, device=Y.device)
        scale = torch.max(torch.abs(X), dim=1).values[:, None, None]  # (B, 1, 1)
        # numerator: prod over j != k of (X_j - t)
        n = eye[None] + (1.0 - eye)[None] * (X[:, :, None] - t[:, None, None])
        numer = torch.prod(n / scale + 1e-5, dim=1)  # (B, K)
        # denominator: prod over j of (X_j - X_k), the diagonal taken as 1
        d = (X[:, :, None] - X[:, None, :]) + eye[None]
        denom = torch.prod(d / scale + 1e-5, dim=1)  # (B, K)
        return torch.einsum("bk,bke->be", numer / denom, Y)


def evaluate_over_time(f, t: torch.Tensor) -> torch.Tensor:
    """A batched time-callable f, (B,) -> (B, E), over a (B, T) time grid:
    (B, T, E), one call a column."""
    return torch.stack([f(t[:, i]) for i in range(t.shape[1])], dim=1)
