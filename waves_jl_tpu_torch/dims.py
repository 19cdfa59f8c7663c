"""Grid primitives (counterpart of `waves_jl_tpu/dims.py`).

Fields are laid out `(..., nx, ny)`: channels lead, space trails, as in the
JAX package. All tensors are float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


@dataclass(frozen=True)
class ThreeDim:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def shape(self):
        return (self.x.shape[0], self.y.shape[0], self.z.shape[0])


def one_dim(grid_size: float, n: int, device="cuda") -> OneDim:
    """n points on [-grid_size, grid_size]."""
    dev = resolve_device(device)
    return OneDim(torch.linspace(-grid_size, grid_size, n, dtype=torch.float32, device=dev))


def spacing_axis(grid_size: float, delta: float) -> np.ndarray:
    """The float32 points -grid_size, -grid_size + delta, ... up to
    grid_size + delta / 2, as the JAX package's `jnp.arange` with a step
    gives them: it hands a float step to `np.arange` in float32, whose point
    count is the ceiling of (stop - start) / step in float64 and whose
    points are start + i (the float32 second point minus start)."""
    return np.arange(-grid_size, grid_size + 0.5 * delta, delta, dtype=np.float32)


def one_dim_spacing(grid_size: float, delta: float, device="cuda") -> OneDim:
    """Points delta apart on [-grid_size, grid_size]."""
    return OneDim(torch.from_numpy(spacing_axis(grid_size, delta)).to(resolve_device(device)))


def two_dim(grid_size: float, n: int, device="cuda") -> TwoDim:
    """n x n points on [-grid_size, grid_size]^2."""
    dev = resolve_device(device)
    ax = torch.linspace(-grid_size, grid_size, n, dtype=torch.float32, device=dev)
    return TwoDim(ax, ax)


def two_dim_spacing(grid_size: float, delta: float, device="cuda") -> TwoDim:
    """Points delta apart on [-grid_size, grid_size]^2."""
    ax = torch.from_numpy(spacing_axis(grid_size, delta)).to(resolve_device(device))
    return TwoDim(ax, ax)


def three_dim(grid_size: float, n: int, device="cuda") -> ThreeDim:
    """n x n x n points on [-grid_size, grid_size]^3."""
    dev = resolve_device(device)
    ax = torch.linspace(-grid_size, grid_size, n, dtype=torch.float32, device=dev)
    return ThreeDim(ax, ax, ax)


def build_grid(dim):
    """OneDim -> (nx,); TwoDim -> (nx, ny, 2) with [..., 0] the x coordinate
    (varies along axis 0) and [..., 1] the y coordinate; ThreeDim ->
    (nx, ny, nz, 3), the "ij" meshgrid."""
    if isinstance(dim, OneDim):
        return dim.x
    if isinstance(dim, TwoDim):
        nx, ny = dim.shape
        gx = dim.x[:, None].expand(nx, ny)
        gy = dim.y[None, :].expand(nx, ny)
        return torch.stack([gx, gy], dim=-1)
    if isinstance(dim, ThreeDim):
        return torch.stack(torch.meshgrid(dim.x, dim.y, dim.z, indexing="ij"), dim=-1)
    raise TypeError(f"unsupported dim type {type(dim)}")


def build_wave(dim, fields: int) -> torch.Tensor:
    """Zero state (fields, *dim.shape) on the grid's device."""
    return torch.zeros((fields, *dim.shape), dtype=torch.float32, device=dim.x.device)


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
    if isinstance(dim, ThreeDim):
        for axis in range(3):
            bc.select(axis, 0).zero_()
            bc.select(axis, -1).zero_()
        return bc
    raise TypeError(f"unsupported dim type {type(dim)}")


def get_dx(dim) -> torch.Tensor:
    """Mean grid spacing along x."""
    return torch.mean(torch.diff(dim.x))


def get_dy(dim) -> torch.Tensor:
    return torch.mean(torch.diff(dim.y))


def get_dz(dim) -> torch.Tensor:
    return torch.mean(torch.diff(dim.z))
