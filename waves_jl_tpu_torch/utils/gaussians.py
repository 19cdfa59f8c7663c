"""Gaussian bumps (counterpart of `waves_jl_tpu/utils/gaussians.py`)."""
from __future__ import annotations

import math

import torch


def build_normal_1d(x, mu, sigma, a) -> torch.Tensor:
    """Sum of S Gaussians over a 1D grid x (E,) -> (E,); mu, sigma, a (S,)."""
    f = (1.0 / (sigma[None, :] * math.sqrt(2.0 * math.pi))) * a[None, :] * torch.exp(
        -((x[:, None] - mu[None, :]) ** 2) / (2.0 * sigma[None, :] ** 2))
    return torch.sum(f, dim=1)


def build_normal_2d(grid, mu, sigma, a) -> torch.Tensor:
    """Sum of S Gaussians over a 2D grid (nx, ny, 2) -> (nx, ny); mu (S, 2),
    sigma and a (S,)."""
    d2 = torch.sum((grid[:, :, None, :] - mu[None, None, :, :]) ** 2, dim=-1)
    f = (1.0 / (2.0 * math.pi * sigma**2))[None, None, :] * a[None, None, :] * torch.exp(
        -d2 / (2.0 * sigma**2)[None, None, :]
    )
    return torch.sum(f, dim=-1)


def build_normal(grid, mu, sigma, a) -> torch.Tensor:
    """`build_normal_1d` over an (E,) grid, `build_normal_2d` over an
    (nx, ny, 2) one."""
    if grid.ndim == 1:
        return build_normal_1d(grid, mu, sigma, a)
    if grid.ndim != 3:
        raise ValueError(f"expected an (E,) or (nx, ny, 2) grid, got shape {tuple(grid.shape)}")
    return build_normal_2d(grid, mu, sigma, a)
