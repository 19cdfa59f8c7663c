"""Field metrics: masks, displacement, energy, flux (counterpart of
`waves_jl_tpu/ops/metrics.py`)."""
from __future__ import annotations

import torch

from ..dims import TwoDim, build_grid
from ..models.layers import full_float32
from .fd import laplacian_matrix


def circle_mask(dim: TwoDim, radius: float) -> torch.Tensor:
    """Boolean (nx, ny) mask of the points within `radius` of the origin."""
    return torch.sum(build_grid(dim) ** 2, dim=-1) < radius**2


def displacement(wave: torch.Tensor) -> torch.Tensor:
    """The displacement channel of a channels-first state."""
    return wave[0]


def energy(u: torch.Tensor) -> torch.Tensor:
    """Pointwise energy u^2."""
    return u**2


@full_float32()
def flux(u: torch.Tensor, laplace: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Flux of a field u (..., n, n) through the masked region, the sum over
    the mask of L u + (L u^T)^T: two dense matmuls a frame in IEEE float32
    (TF32 off), leading dimensions batched."""
    f = laplace @ u + (laplace @ u.transpose(-1, -2)).transpose(-1, -2)
    return torch.sum(f * mask, dim=(-2, -1))


__all__ = ["circle_mask", "displacement", "energy", "flux", "laplacian_matrix"]
