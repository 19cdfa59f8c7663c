"""Wave encoders (counterpart of `waves_jl_tpu/models/wave_encoder.py`).
`WaveEncoder`: observation images -> 6 latent 1D fields, a CNN base, then 6
three-layer MLP heads whose nfreq coefficients go through a fixed sine
basis; field 6 (the PML) is squared. `WaveEncoderScalarHead`: the CNN base
and one dense layer, the NODE baseline's encoder."""
from __future__ import annotations

import torch
from torch import nn

from .layers import MLP, CNNBase, embed_sin, full_float32, sin_basis

N_LATENT_FIELDS = 6  # u_tot, v_tot, u_inc, v_inc, f, pml


class WaveEncoder(nn.Module):
    def __init__(self, in_ch: int, h_size: int, nfreq: int, elements: int,
                 latent_grid_size: float, device=None, conv_dtype=None):
        """`conv_dtype=torch.bfloat16` runs the CNN base's convolutions in
        bf16 (`CNNBase(dtype=)`); the heads stay float32."""
        super().__init__()
        self.cnn = CNNBase(in_ch, h_size, conv_dtype)
        self.heads = nn.ModuleList(MLP(h_size, [h_size, h_size, nfreq])
                                   for _ in range(N_LATENT_FIELDS))
        self.register_buffer("basis", sin_basis(elements, latent_grid_size, nfreq, device),
                             persistent=False)

    @full_float32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, res, res, C) channels last -> (B, 6, E)."""
        h = self.cnn(x.permute(0, 3, 1, 2))
        coefs = torch.stack([head(h) for head in self.heads], dim=1)
        fields = embed_sin(self.basis, coefs)
        return torch.cat([fields[:, :5], fields[:, 5:] ** 2], dim=1)


class WaveEncoderScalarHead(nn.Module):
    """CNN base, then one dense layer to `out` features."""

    def __init__(self, in_ch: int, h_size: int, out: int):
        super().__init__()
        self.cnn = CNNBase(in_ch, h_size)
        self.head = nn.Linear(h_size, out)

    @full_float32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, res, res, C) channels last -> (B, out)."""
        return self.head(self.cnn(x.permute(0, 3, 1, 2)))
