"""Gaussian bumps (counterpart of `waves_jl_tpu/utils/gaussians.py`)."""
from __future__ import annotations

import math

import torch


def build_normal(grid, mu, sigma, a) -> torch.Tensor:
    """Sum of S Gaussians: over a 1D grid x (E,) -> (E,), mu, sigma and a
    (S,); over a 2D grid (nx, ny, 2) -> (nx, ny), mu (S, 2), sigma and a
    (S,)."""
    if grid.ndim == 1:
        f = (1.0 / (sigma[None, :] * math.sqrt(2.0 * math.pi))) * a[None, :] * torch.exp(
            -((grid[:, None] - mu[None, :]) ** 2) / (2.0 * sigma[None, :] ** 2))
        return torch.sum(f, dim=1)
    if grid.ndim != 3:
        raise ValueError(f"expected an (E,) or (nx, ny, 2) grid, got shape {tuple(grid.shape)}")
    d2 = torch.sum((grid[:, :, None, :] - mu[None, None, :, :]) ** 2, dim=-1)
    f = (1.0 / (2.0 * math.pi * sigma**2))[None, None, :] * a[None, None, :] * torch.exp(
        -d2 / (2.0 * sigma**2)[None, None, :]
    )
    return torch.sum(f, dim=-1)
