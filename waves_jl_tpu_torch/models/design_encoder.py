"""Design encoder: action sequences -> time-interpolated latent wavespeed
(counterpart of `waves_jl_tpu/models/design_encoder.py`). The sequence is
unrolled through the design-space clamp, each design normalised to
[-1, 1], mapped by a 5-layer MLP to nfreq coefficients, embedded on the
latent grid, squashed to (0, 2) and interpolated over the action knots."""
from __future__ import annotations

import torch
from torch import nn

from ..designs import DesignSpace, normalize_design
from ..utils.interp import LinearInterpolation
from ..utils.trees import tree_leaves, tree_map
from .layers import MLP, embed_sin, sin_basis


def unroll_design_sequence(space: DesignSpace, d0, actions) -> torch.Tensor:
    """d_{i+1} = clamp(d_i + a_i). d0: designs with leading (B,); actions:
    leading (B, H). Returns (B, H+1, A) normalised design vectors."""
    horizon = tree_leaves(actions)[0].shape[1]
    d = d0
    vecs = [normalize_design(d, space)]
    for h in range(horizon):
        d = space(d, tree_map(lambda x: x[:, h], actions))
        vecs.append(normalize_design(d, space))
    return torch.stack(vecs, dim=1)


class DesignMLP(nn.Module):
    """Normalised design vectors (B, K, A) -> latent speed fields (B, K, E) in (0, 2)."""

    def __init__(self, in_features: int, h_size: int, nfreq: int, elements: int,
                 latent_grid_size: float, device=None):
        super().__init__()
        self.mlp = MLP(in_features, [h_size, h_size, h_size, h_size, nfreq])
        self.register_buffer("basis", sin_basis(elements, latent_grid_size, nfreq, device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 2.0 * torch.sigmoid(embed_sin(self.basis, self.mlp(x)))


def design_encoder_apply(mlp: DesignMLP, space: DesignSpace, d0, actions, t: torch.Tensor,
                         integration_steps: int) -> LinearInterpolation:
    """C(t) over the action-boundary knots t[:, ::integration_steps]."""
    vecs = unroll_design_sequence(space, d0, actions)
    return LinearInterpolation(X=t[:, ::integration_steps], Y=mlp(vecs))
