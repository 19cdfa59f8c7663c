"""Neural building blocks (counterpart of `waves_jl_tpu/models/layers.py`).

Images enter the port's modules channels-last, as in the JAX package, and
go NCHW at the convolution stack.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def full_float32():
    """Run the enclosed matmuls and cuDNN convolutions in IEEE float32, not
    TF32 (which cuDNN allows by default), and bf16 matmuls with float32
    accumulation to the end, not cuBLAS's reduced-precision reduction
    (JAX's `preferred_element_type=float32`): the precision the models are
    held to against the JAX package. Usable as a decorator; restores the
    flags."""
    cuda_mm = torch.backends.cuda.matmul
    mm, conv = cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32
    bf16 = cuda_mm.allow_bf16_reduced_precision_reduction
    cuda_mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        cuda_mm.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
        cuda_mm.allow_bf16_reduced_precision_reduction = bf16


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Fill `weight` as flax's default kernel initialiser (`lecun_normal`)
    draws: a normal truncated at +-2 sigma, sigma corrected for the
    truncation so that the variance is 1 / fan_in. Drawn on the CPU from
    `generator` by the inverse CDF, as `jax.random.truncated_normal` draws."""
    lo, hi = torch.erf(torch.tensor(-2.0 / np.sqrt(2.0))), torch.erf(torch.tensor(2.0 / np.sqrt(2.0)))
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    z = np.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978  # the std of a unit normal cut at +-2
    with torch.no_grad():
        weight.copy_((z * std).to(weight.dtype))


def init_flax_like_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every `nn.Conv1d`, `nn.Conv2d` and `nn.Linear` of
    `module` as flax's `nn.Conv` and `nn.Dense` start: `lecun_normal`
    kernels (fan_in = in_ch times the kernel's size for a conv, in_features
    for a dense layer) and zero biases, drawn in module order from
    `generator`. The values differ from JAX's, the distribution does not."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def sin_basis(elements: int, grid_size: float, nfreq: int, device) -> torch.Tensor:
    """(E, nfreq) basis Phi[e, k] = sin(pi (k+1) (x_e - C) / L) on the
    latent grid [-grid_size, grid_size], C = L / 2."""
    x = torch.linspace(-grid_size, grid_size, elements, dtype=torch.float32, device=device)
    L = x[-1] - x[0]
    C = L / 2.0
    k = torch.arange(1, nfreq + 1, dtype=torch.float32, device=device)
    phase = np.float32(np.pi) * k[None, :] * (x[:, None] - C) / L
    return torch.sin(phase)


def embed_sin(basis: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """coefs (..., nfreq) -> fields (..., E), normalised by sqrt(nfreq)."""
    nfreq = basis.shape[1]
    return torch.matmul(coefs / np.sqrt(np.float32(nfreq)), basis.T)


def localization_coords(h: int, w: int, device) -> torch.Tensor:
    """(2, h, w) coordinate channels in [-1, 1]: x down the rows, y along."""
    gx = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    gy = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return torch.stack([gx, gy], dim=0)


class ResidualBlock(nn.Module):
    """conv3x3 - act - conv3x3, plus a 1x1 skip, act, 2x2 max pool.
    `dtype=torch.bfloat16` runs the block in bf16 on bf16 casts of the
    weights, which stay float32 (flax's `nn.Conv(dtype=)`)."""

    def __init__(self, in_ch: int, features: int, dtype=None):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, features, 3, padding=1)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(in_ch, features, 1)
        self.dtype = dtype

    def _conv(self, conv: nn.Conv2d, x):
        if self.dtype is None:
            return conv(x)
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        padding=conv.padding)

    def forward(self, x):
        main = self._conv(self.conv1, leaky_relu(self._conv(self.conv0, x)))
        return F.max_pool2d(leaky_relu(main + self._conv(self.conv2, x)), 2)


class MLP(nn.Module):
    def __init__(self, in_features: int, features: list[int]):
        super().__init__()
        dims = [in_features, *features]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = leaky_relu(x)
        return x


class CNNBase(nn.Module):
    """x + 1e-5, coordinate channels, three residual blocks, global max pool.
    `dtype=torch.bfloat16` runs the blocks in bf16 (parameters float32,
    the pooled output cast back to the input's type)."""

    def __init__(self, in_ch: int, h_size: int, dtype=None):
        super().__init__()
        self.blocks = nn.ModuleList([ResidualBlock(in_ch + 2, 32, dtype),
                                     ResidualBlock(32, 64, dtype),
                                     ResidualBlock(64, h_size, dtype)])

    def forward(self, x):
        """x (B, C, H, W) -> (B, h_size)."""
        b, _, h, w = x.shape
        coords = localization_coords(h, w, x.device)[None].expand(b, 2, h, w)
        x = torch.cat([x + 1e-5, coords], dim=1)
        dtype = x.dtype
        for block in self.blocks:
            x = block(x)
        return torch.amax(x, dim=(2, 3)).to(dtype)
