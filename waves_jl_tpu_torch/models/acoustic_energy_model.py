"""AcousticEnergyModel, the flagship surrogate (counterpart of
`waves_jl_tpu/models/acoustic_energy_model.py`).

Wave encoder -> initial latent fields, latent source shape and learned PML;
design encoder -> latent speed C(t); a latent 1D acoustic RK4 rollout; the
energy readout sum(z^2) dx of the total, incident and scattered fields.
The parameters live in the module; the clamp unroll and the physics carry
none. The training losses (`energy_loss`, `energy_loss_ranking`,
`pool_ranking_loss`) differentiate through `forward` and `shot_energy`;
`predict_shot_energy` is the selection's path, without gradients.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..designs import DesignSpace
from ..device import resolve_device
from ..dims import one_dim
from ..physics.dynamics import Integrator, build_tspan, make_acoustic_dynamics_1d
from ..sources import Source
from ..utils.trees import tree_leaves, tree_map
from .design_encoder import DesignMLP, design_encoder_apply
from .layers import embed_sin, full_float32, init_flax_like_
from .wave_encoder import WaveEncoder


def compute_latent_energy(z: torch.Tensor, dx: float) -> torch.Tensor:
    """z (L, B, 4, E) time-leading latent trajectory -> (B, L, 3)
    [tot, inc, sc] energies."""
    tot, inc = z[:, :, 0], z[:, :, 2]
    sc = tot - inc
    e = torch.stack([torch.sum(tot**2, dim=-1) * dx, torch.sum(inc**2, dim=-1) * dx,
                     torch.sum(sc**2, dim=-1) * dx], dim=-1)
    return e.transpose(0, 1)


@dataclass(frozen=True)
class SinusoidalSource:
    """Learnable latent source: shape = sine basis (coefs). Present for
    parity with the JAX package; the flagship takes its latent source shape
    from the wave encoder."""

    basis: torch.Tensor  # (E, nfreq)
    freq: float

    def init_coefs(self, generator: torch.Generator, nfreq: int) -> torch.Tensor:
        """(nfreq,) normal coefficients over sqrt(nfreq), drawn on the CPU."""
        coefs = torch.randn(nfreq, generator=generator) / np.sqrt(np.float32(nfreq))
        return coefs.to(self.basis.device)

    def shape(self, coefs: torch.Tensor) -> torch.Tensor:
        return embed_sin(self.basis, coefs)


class AcousticEnergyModel(nn.Module):
    def __init__(self, design_space: DesignSpace, source_freq: float, elements: int = 1024,
                 latent_grid_size: float = 100.0, h_size: int = 256, nfreq: int = 500,
                 pml_width: float = 10.0, pml_scale: float = 10000.0, c0: float = 1531.0,
                 dt: float = 1e-5, integration_steps: int = 100, in_channels: int = 4,
                 checkpoint: str = "sqrt", seed: int = 0, device="cuda", conv_dtype=None):
        """Reference hyperparameters; `in_channels` counts the observation's
        channels (3 frames and the source shape). `checkpoint` is the latent
        rollout's mode under autograd (`physics.dynamics.Integrator`); the
        weights start as flax's initialisers draw them, from `seed`.
        `conv_dtype=torch.bfloat16` runs the wave encoder's convolutions in
        bf16, the parameters staying float32: an opt-in speed mode."""
        super().__init__()
        dev = resolve_device(device)
        self.design_space = design_space
        self.latent_dim = one_dim(latent_grid_size, elements, device=dev)
        self.integrator = Integrator(
            dynamics=make_acoustic_dynamics_1d(self.latent_dim, c0, pml_width, pml_scale), dt=dt,
            checkpoint=checkpoint)
        self.n_elements = int(elements)
        self.latent_grid_size = float(latent_grid_size)
        self.source_freq = float(source_freq)
        self.integration_steps = int(integration_steps)
        n_design = design_space.low.to_vec().shape[-1]
        self.wave_encoder = WaveEncoder(in_channels, h_size, nfreq, elements, latent_grid_size, dev,
                                        conv_dtype)
        self.design_mlp = DesignMLP(n_design, h_size, nfreq, elements, latent_grid_size, dev)
        init_flax_like_(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    @property
    def dx(self) -> float:
        return 2.0 * self.latent_grid_size / (self.n_elements - 1)

    def fast_ranking(self) -> "AcousticEnergyModel":
        """The model for MPC action ranking in bf16: the latent state and
        its derivative contraction in bf16 (`state_dtype="bfloat16"`), the
        rollout at checkpoint "none". It shares this model's parameters
        and modules: no second copy, and a change to either is seen by
        both."""
        fast = copy.copy(self)
        dyn = dataclasses.replace(self.integrator.dynamics, state_dtype="bfloat16")
        fast.integrator = dataclasses.replace(self.integrator, dynamics=dyn, checkpoint="none")
        return fast

    def _source_freq(self, like: torch.Tensor) -> torch.Tensor:
        """The source frequency as a float32 tensor on `like`'s device, made
        once a device: a copy from the host waits for the card."""
        cache = self.__dict__.setdefault("_freq_on", {})
        if like.device not in cache:
            cache[like.device] = torch.tensor(self.source_freq, dtype=torch.float32,
                                              device=like.device)
        return cache[like.device]

    def get_parameters_and_initial_condition(self, batch: dict):
        """(z0 (B, 4, E), theta = (C, F, PML)) of a batch: s_wave (B, res,
        res, C), s_design and actions with leading (B,) and (B, H), t (B, L)."""
        x = self.wave_encoder(batch["s_wave"])  # (B, 6, E)
        F = Source(shape=x[:, 4], freq=self._source_freq(x))
        C = design_encoder_apply(self.design_mlp, self.design_space, batch["s_design"],
                                 batch["a"], batch["t"], self.integration_steps)
        return x[:, 0:4], (C, F, x[:, 5])

    def generate_latent_solution(self, batch: dict) -> torch.Tensor:
        """(L, B, 4, E) latent trajectory, each sample stepped on its own
        time grid batch["t"] (B, L)."""
        z0, theta = self.get_parameters_and_initial_condition(batch)
        return self.integrator(z0, batch["t"], theta)

    @full_float32()
    def forward(self, batch: dict) -> torch.Tensor:
        """(B, L, 3) predicted [tot, inc, sc] energies."""
        return compute_latent_energy(self.generate_latent_solution(batch), self.dx)

    @full_float32()
    def predict_shots(self, obs_wave, s_design, actions, t) -> torch.Tensor:
        """One observation, S candidate action sequences (leading (S, H)),
        t (S, L) -> (S, L, 3) energies; the wave is encoded once."""
        z0, theta = self._shot_setup(obs_wave, s_design, actions, t)
        return compute_latent_energy(self.integrator(z0, t, theta), self.dx)

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
        F = Source(shape=xb[:, 4], freq=self._source_freq(x))
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


def energy_loss(model: AcousticEnergyModel, batch: dict, sc_weight: float = 1.0) -> torch.Tensor:
    """MSE over the three energy channels. `sc_weight` > 1 up-weights the
    scattered channel, mean-normalised by 3 / (2 + w) so the loss scale
    stays comparable across weights; 1.0 is the equal-weight loss."""
    se = (model(batch) - batch["y"]) ** 2
    if sc_weight == 1.0:
        return torch.mean(se)
    w = torch.tensor([1.0, 1.0, float(sc_weight)], dtype=se.dtype, device=se.device)
    return torch.mean(se * w) * (3.0 / (2.0 + float(sc_weight)))


def energy_loss_ranking(model: AcousticEnergyModel, batch: dict,
                        beta: float = 1.0) -> torch.Tensor:
    """Curve MSE plus beta times the squared error of the time-cumulative
    scattered energy over the window's length (what random shooting ranks
    candidates by)."""
    pred = model(batch)
    curve = torch.mean((pred - batch["y"]) ** 2)
    L = pred.shape[1]
    cum = torch.mean(((torch.sum(pred[:, :, 2], dim=1) - torch.sum(batch["y"][:, :, 2], dim=1))
                      / L) ** 2)
    return curve + beta * cum


def pool_ranking_loss(model: AcousticEnergyModel, pools: dict, tau: float = 1.0,
                      listwise_weight: float = 0.5) -> torch.Tensor:
    """Ranking distillation on exact-evaluated candidate pools: per pool the
    surrogate's cumulative scattered energies of K candidate sequences
    (`shot_energy`) are matched to the true ones in z-scored units, each
    pool weighted by its relative true spread, plus a listwise softmax
    cross-entropy at temperature `tau`.

    pools: {"s_wave": (P, res, res, C), "s_design": designs with leading
    (P,), "t0": (P,), "a": actions with leading (P, K, H), "y_true": (P, K)}.
    """
    K = pools["y_true"].shape[1]
    H = tree_leaves(pools["a"])[0].shape[2]
    tgrid = torch.from_numpy(build_tspan(0.0, model.integrator.dt, model.integration_steps * H))
    tgrid = tgrid.to(pools["y_true"].device)
    e_hat = torch.stack([
        model.shot_energy(pools["s_wave"][p], tree_map(lambda v: v[p], pools["s_design"]),
                          tree_map(lambda v: v[p], pools["a"]),
                          (pools["t0"][p] + tgrid)[None].expand(K, tgrid.shape[0]))
        for p in range(pools["y_true"].shape[0])])  # (P, K)

    def z(v):
        return (v - v.mean(dim=1, keepdim=True)) / (v.std(dim=1, keepdim=True, unbiased=False)
                                                    + 1e-6)

    y = pools["y_true"].to(torch.float32)
    ze, zy = z(e_hat), z(y)
    sd = y.std(dim=1, unbiased=False)
    w = sd / (sd + 0.01 * torch.abs(y.mean(dim=1)) + 1e-6)  # (P,)
    wsum = torch.sum(w) + 1e-6
    zmse = torch.sum(w * torch.mean((ze - zy) ** 2, dim=1)) / wsum
    p_true = torch.softmax(-zy / tau, dim=1)
    logq = torch.log_softmax(-ze / tau, dim=1)
    listwise = torch.sum(w * (-torch.sum(p_true * logq, dim=1))) / wsum
    return zmse + listwise_weight * listwise
