"""Perfectly matched layer profiles (counterpart of `waves_jl_tpu/ops/pml.py`)."""
from __future__ import annotations

import torch

from ..dims import OneDim, ThreeDim, TwoDim


def build_pml(dim, width: float, scale: float) -> torch.Tensor:
    """Cubic-ramp PML profile sigma.

    OneDim -> (nx,); TwoDim -> (nx, ny) varying along x, constant along y
    (sigma_y is its transpose); ThreeDim -> the (nx,) profile along x,
    which the 3-D dynamics broadcasts along each axis.
    """
    if isinstance(dim, OneDim):
        x = torch.abs(dim.x)
        start = torch.minimum(x[0], x[-1]) - width
        ramp = torch.clamp(torch.clamp(x - start, min=0.0) / width, 0.0, 1.0)
        return ramp**3 * scale
    if isinstance(dim, (TwoDim, ThreeDim)):
        x = torch.abs(dim.x)
        region = x > x[0] - width
        # normalised by the smallest |x| inside the region, as the reference
        xmin = torch.min(torch.where(region, x, torch.full_like(x, float("inf"))))
        ramp = torch.where(region, (x - xmin) / width, torch.zeros_like(x))
        pml_x = ramp**3 * scale
        if isinstance(dim, ThreeDim):
            return pml_x
        return pml_x[:, None].expand(dim.x.shape[0], dim.y.shape[0]).contiguous()
    raise TypeError(f"unsupported dim type {type(dim)}")
