"""AcousticEnergyModel, the flagship surrogate (counterpart of
`waves_jl_tpu/models/acoustic_energy_model.py`).

Wave encoder -> initial latent fields, latent source shape and learned PML;
design encoder -> latent speed C(t); a latent 1D acoustic RK4 rollout; the
energy readout sum(z^2) dx of the total, incident and scattered fields.
The parameters live in the module; the clamp unroll and the physics carry
none.
"""
from __future__ import annotations

import torch
from torch import nn

from ..designs import DesignSpace
from ..device import resolve_device
from ..dims import one_dim
from ..physics.dynamics import Integrator, make_acoustic_dynamics_1d
from ..sources import Source
from ..utils.trees import tree_map
from .design_encoder import DesignMLP, design_encoder_apply
from .layers import full_float32
from .wave_encoder import WaveEncoder


def compute_latent_energy(z: torch.Tensor, dx: float) -> torch.Tensor:
    """z (L, B, 4, E) time-leading latent trajectory -> (B, L, 3)
    [tot, inc, sc] energies."""
    tot, inc = z[:, :, 0], z[:, :, 2]
    sc = tot - inc
    e = torch.stack([torch.sum(tot**2, dim=-1) * dx, torch.sum(inc**2, dim=-1) * dx,
                     torch.sum(sc**2, dim=-1) * dx], dim=-1)
    return e.transpose(0, 1)


class AcousticEnergyModel(nn.Module):
    def __init__(self, design_space: DesignSpace, source_freq: float, elements: int = 1024,
                 latent_grid_size: float = 100.0, h_size: int = 256, nfreq: int = 500,
                 pml_width: float = 10.0, pml_scale: float = 10000.0, c0: float = 1531.0,
                 dt: float = 1e-5, integration_steps: int = 100, in_channels: int = 4,
                 device="cuda"):
        """Reference hyperparameters; `in_channels` counts the observation's
        channels (3 frames and the source shape)."""
        super().__init__()
        dev = resolve_device(device)
        self.design_space = design_space
        self.latent_dim = one_dim(latent_grid_size, elements, device=dev)
        self.integrator = Integrator(
            dynamics=make_acoustic_dynamics_1d(self.latent_dim, c0, pml_width, pml_scale), dt=dt)
        self.n_elements = int(elements)
        self.latent_grid_size = float(latent_grid_size)
        self.source_freq = float(source_freq)
        self.integration_steps = int(integration_steps)
        n_design = design_space.low.to_vec().shape[-1]
        self.wave_encoder = WaveEncoder(in_channels, h_size, nfreq, elements, latent_grid_size, dev)
        self.design_mlp = DesignMLP(n_design, h_size, nfreq, elements, latent_grid_size, dev)
        self.to(dev)

    @property
    def dx(self) -> float:
        return 2.0 * self.latent_grid_size / (self.n_elements - 1)

    def encode_wave(self, obs_wave: torch.Tensor) -> torch.Tensor:
        """(6, E) latent fields for one observation (res, res, C)."""
        return self.wave_encoder(obs_wave[None])[0]

    def _shot_setup(self, obs_wave, s_design, actions, t, x=None):
        """One observation and S candidate sequences: the encoded wave
        broadcast to S shots and the per-shot latent speed."""
        S = t.shape[0]
        if x is None:
            x = self.encode_wave(obs_wave)
        xb = x[None].expand(S, *x.shape)
        z0 = xb[:, 0:4].contiguous()
        F = Source(shape=xb[:, 4], freq=torch.tensor(self.source_freq, dtype=torch.float32,
                                                      device=x.device))
        PML = xb[:, 5]
        s_design_s = tree_map(lambda v: v[None].expand(S, *v.shape), s_design)
        C = design_encoder_apply(self.design_mlp, self.design_space, s_design_s, actions, t,
                                 self.integration_steps)
        return z0, (C, F, PML)

    @torch.no_grad()
    def predict_shot_energy(self, obs_wave, s_design, actions, t, x=None) -> torch.Tensor:
        """(S,) cumulative scattered latent energy of S candidate action
        sequences from one observation, summed over the time grid t (S, L).
        obs_wave (res, res, C); s_design one design; actions with leading
        (S, H); x optionally a precomputed `encode_wave`. Without gradients:
        the selection path."""
        return self.shot_energy(obs_wave, s_design, actions, t, x)

    @full_float32()
    def shot_energy(self, obs_wave, s_design, actions, t, x=None) -> torch.Tensor:
        """`predict_shot_energy` where autograd may run through it, as CEM's
        gradient polish does through the actions. JAX's `remat=True` saves
        memory, not values; here plain autograd keeps every latent step's
        activations (tens to hundreds of MB for 16 shots x 125 steps at
        1,024 elements, well inside the card), so no step is recomputed."""
        z, theta = self._shot_setup(obs_wave, s_design, actions, t, x)
        dx = self.dx

        def sc_energy(z):
            sc = z[:, 0] - z[:, 2]
            return torch.sum(sc * sc, dim=-1) * dx

        acc = sc_energy(z)
        for tt in t.T[:-1]:
            z = self.integrator.step(z, tt, theta)
            acc = acc + sc_energy(z)
        return acc
