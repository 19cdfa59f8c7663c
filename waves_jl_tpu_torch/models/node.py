"""NODEEnergyModel, the neural-ODE baseline (counterpart of
`waves_jl_tpu/models/node.py`).

The latent dynamics is a black-box MLP over (z, C(t)) stepped by the same
RK4 `Integrator` as the flagship's physics; the readout is one scalar
energy a time, sum(z^2) dx, trained against the scattered channel only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..designs import DesignSpace
from ..device import resolve_device
from ..physics.dynamics import Integrator
from .design_encoder import DesignMLP, design_encoder_apply
from .layers import MLP, full_float32, init_flax_like_
from .wave_encoder import WaveEncoderScalarHead


@dataclass(frozen=True)
class NODEDynamics:
    """rhs(z, t, C) = MLP([z[:, 0]; C(t)])[:, None], z (B, 1, E)."""

    mlp: nn.Module

    def at(self, t, theta):
        """The right-hand side at time t, z -> dz, with C(t) evaluated once."""
        c = theta(t)  # (B, E)
        return lambda z: self.mlp(torch.cat([z[:, 0], c], dim=-1))[:, None, :]

    def __call__(self, z, t, theta):
        return self.at(t, theta)(z)


class NODEEnergyModel(nn.Module):
    def __init__(self, design_space: DesignSpace, elements: int = 1024,
                 latent_grid_size: float = 100.0, h_size: int = 256, nfreq: int = 500,
                 dt: float = 1e-5, integration_steps: int = 100, checkpoint: str = "sqrt",
                 in_channels: int = 4, seed: int = 0, device="cuda"):
        """Reference hyperparameters; `checkpoint` is the rollout's mode
        under autograd (`physics.dynamics.Integrator`); the weights start as
        flax's initialisers draw them, from `seed`."""
        super().__init__()
        dev = resolve_device(device)
        self.design_space = design_space
        self.n_elements = int(elements)
        self.latent_grid_size = float(latent_grid_size)
        self.integration_steps = int(integration_steps)
        n_design = design_space.low.to_vec().shape[-1]
        self.wave_encoder = WaveEncoderScalarHead(in_channels, h_size, elements)
        self.design_mlp = DesignMLP(n_design, h_size, nfreq, elements, latent_grid_size, dev)
        self.dynamics = MLP(2 * elements, [elements] * 4)
        self.integrator = Integrator(dynamics=NODEDynamics(self.dynamics), dt=dt,
                                     checkpoint=checkpoint)
        init_flax_like_(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    @property
    def dx(self) -> float:
        return 2.0 * self.latent_grid_size / (self.n_elements - 1)

    def generate_latent_solution(self, batch: dict) -> torch.Tensor:
        """(L, B, 1, E) latent trajectory, each sample stepped on its own
        time grid batch["t"] (B, L)."""
        z0 = self.wave_encoder(batch["s_wave"])[:, None]
        C = design_encoder_apply(self.design_mlp, self.design_space, batch["s_design"],
                                 batch["a"], batch["t"], self.integration_steps)
        return self.integrator(z0, batch["t"], C)

    @full_float32()
    def forward(self, batch: dict) -> torch.Tensor:
        """(B, L) predicted scalar energy."""
        z = self.generate_latent_solution(batch)
        return (torch.sum(z[:, :, 0] ** 2, dim=-1) * self.dx).transpose(0, 1)


def node_loss(model: NODEEnergyModel, batch: dict) -> torch.Tensor:
    """MSE against the scattered energy alone."""
    return torch.mean((model(batch) - batch["y"][:, :, 2]) ** 2)
