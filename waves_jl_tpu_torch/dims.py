"""Grid primitives (counterpart of `waves_jl_tpu/dims.py`).

Fields are laid out `(..., nx, ny)`: channels lead, space trails, as in the
JAX package. All tensors are float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .device import resolve_device


@dataclass(frozen=True)
class OneDim:
    x: torch.Tensor

    @property
    def shape(self):
        return (self.x.shape[0],)


@dataclass(frozen=True)
class TwoDim:
    x: torch.Tensor
    y: torch.Tensor

    @property
    def shape(self):
        return (self.x.shape[0], self.y.shape[0])


def one_dim(grid_size: float, n: int, device="cuda") -> OneDim:
    """n points on [-grid_size, grid_size]."""
    dev = resolve_device(device)
    return OneDim(torch.linspace(-grid_size, grid_size, n, dtype=torch.float32, device=dev))


def two_dim(grid_size: float, n: int, device="cuda") -> TwoDim:
    """n x n points on [-grid_size, grid_size]^2."""
    dev = resolve_device(device)
    ax = torch.linspace(-grid_size, grid_size, n, dtype=torch.float32, device=dev)
    return TwoDim(ax, ax)


def build_grid(dim):
    """OneDim -> (nx,); TwoDim -> (nx, ny, 2) with [..., 0] the x coordinate
    (varies along axis 0) and [..., 1] the y coordinate."""
    if isinstance(dim, OneDim):
        return dim.x
    if isinstance(dim, TwoDim):
        nx, ny = dim.shape
        gx = dim.x[:, None].expand(nx, ny)
        gy = dim.y[None, :].expand(nx, ny)
        return torch.stack([gx, gy], dim=-1)
    raise TypeError(f"unsupported dim type {type(dim)}")


def build_dirichlet(dim) -> torch.Tensor:
    """1 in the interior, 0 on the domain boundary."""
    bc = torch.ones(dim.shape, dtype=torch.float32, device=dim.x.device)
    if isinstance(dim, OneDim):
        bc[0] = 0.0
        bc[-1] = 0.0
        return bc
    if isinstance(dim, TwoDim):
        bc[0, :] = 0.0
        bc[-1, :] = 0.0
        bc[:, 0] = 0.0
        bc[:, -1] = 0.0
        return bc
    raise TypeError(f"unsupported dim type {type(dim)}")


def get_dx(dim) -> torch.Tensor:
    """Mean grid spacing along x."""
    return torch.mean(torch.diff(dim.x))


def get_dy(dim) -> torch.Tensor:
    return torch.mean(torch.diff(dim.y))
