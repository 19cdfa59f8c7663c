"""Wave sources (counterpart of `waves_jl_tpu/sources.py`).

A source is a static spatial shape modulated by sin(2 pi f t), or the zero
`NoSource`. The Gaussian
source redraws its centre uniformly in [mu_low, mu_high] on `resample`,
from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .utils.gaussians import build_normal


def _modulate(shape: torch.Tensor, freq, t):
    """shape * sin(2 pi f t); a (B,) t modulates a (B, ...) shape per row."""
    t = torch.as_tensor(t, dtype=torch.float32, device=shape.device)
    s = torch.sin(2.0 * math.pi * t * freq)
    if t.ndim == 0:
        return shape * s
    return shape * s.reshape(s.shape + (1,) * (shape.ndim - s.ndim))


@dataclass(frozen=True)
class NoSource:
    """The zero source: a float32 0 at any time."""

    def __call__(self, t):
        return torch.tensor(0.0, dtype=torch.float32)


@dataclass(frozen=True)
class Source:
    shape: torch.Tensor
    freq: torch.Tensor

    def __call__(self, t):
        return _modulate(self.shape, self.freq, t)


@dataclass(frozen=True)
class GaussianSource:
    grid: torch.Tensor  # (nx, ny, 2)
    mu_low: torch.Tensor  # (S, 2)
    mu_high: torch.Tensor
    sigma: torch.Tensor  # (S,)
    a: torch.Tensor  # (S,)
    shape: torch.Tensor  # current rasterised shape
    freq: torch.Tensor

    @classmethod
    def create(cls, grid, mu_low, mu_high, sigma, a, freq) -> "GaussianSource":
        """The shape starts centred at mu_high, as in the JAX package."""
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=grid.device)

        mu_low, mu_high, sigma, a = f32(mu_low), f32(mu_high), f32(sigma), f32(a)
        shape = build_normal(grid, mu_high, sigma, a)
        return cls(grid, mu_low, mu_high, sigma, a, shape, f32(freq))

    def resample(self, generator: torch.Generator) -> "GaussianSource":
        eps = torch.rand(self.mu_low.shape, generator=generator,
                         device=self.mu_low.device, dtype=torch.float32)
        mu = (self.mu_high - self.mu_low) * eps + self.mu_low
        return self.with_center(mu)

    def with_center(self, mu: torch.Tensor) -> "GaussianSource":
        """A copy whose bumps sit at `mu` (the draw `resample` makes)."""
        shape = build_normal(self.grid, mu, self.sigma, self.a)
        return GaussianSource(self.grid, self.mu_low, self.mu_high, self.sigma,
                              self.a, shape, self.freq)

    def __call__(self, t):
        return _modulate(self.shape, self.freq, t)
