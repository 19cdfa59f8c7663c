"""WaveControlPINN, the physics-informed baseline (counterpart of
`waves_jl_tpu/models/pinn.py`).

The wave and design encoders; a 1D-conv `Compressor` that squeezes the
latent fields, the source shape, the PML and the window's two speed knots
into a vector l; a `PINNFieldNet` evaluated over the (l, x/L, t/T) grid of
one action window; the windows unrolled one after another, each starting
from the last row of the one before; and `WaveControlPINNLoss`, the
finite-difference physics residual with IC, BC and energy supervision.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..designs import DesignSpace
from ..device import resolve_device
from ..dims import build_dirichlet, one_dim
from ..ops.fd import gradient_matrix
from ..physics.dynamics import xla_linspace
from ..sources import Source
from ..utils.interp import evaluate_over_time
from .design_encoder import DesignMLP, design_encoder_apply
from .layers import MLP, full_float32, init_flax_like_, leaky_relu
from .wave_encoder import WaveEncoder


class Compressor(nn.Module):
    """Seven width-2 convolutions, max-pooled by 2 after the second and the
    fourth, then the maximum over the elements: (B, E, C) channels last ->
    (B, out_size). Each convolution pads as flax's "SAME" pads an even
    kernel, 0 elements on the left and 1 on the right."""

    def __init__(self, in_ch: int, h_size: int, out_size: int):
        super().__init__()
        widths = [in_ch] + [h_size] * 6 + [out_size]
        self.convs = nn.ModuleList(nn.Conv1d(a, b, 2) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)  # (B, C, E)
        for i, conv in enumerate(self.convs):
            x = conv(F.pad(x, (0, 1)))
            if i < len(self.convs) - 1:
                x = leaky_relu(x)
            if i in (1, 3):
                x = F.max_pool1d(x, 2)
        return torch.amax(x, dim=2)


class PINNFieldNet(nn.Module):
    """8 dense layers, then 4 parallel [h, h, 1] heads: (..., in_features)
    -> (..., 4)."""

    def __init__(self, in_features: int, h_size: int):
        super().__init__()
        self.dense = nn.ModuleList(nn.Linear(in_features if i == 0 else h_size, h_size)
                                   for i in range(8))
        self.heads = nn.ModuleList(MLP(h_size, [h_size, h_size, 1]) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense:
            x = leaky_relu(layer(x))
        return torch.cat([head(x) for head in self.heads], dim=-1)


def build_pinn_grid(elements: int, grid_size: float, steps: int, dt: float,
                    device="cpu") -> torch.Tensor:
    """(steps+1, E, 2) normalised (x/L, t/T) coordinates, t normalised by
    dt (steps+1) as the JAX package has it; both axes are its
    `jnp.linspace`'s float32 points (`xla_linspace`)."""
    f = np.float32
    x = xla_linspace(-grid_size, grid_size, elements) / f(grid_size)
    t = xla_linspace(0.0, steps * dt, steps + 1) / f(dt * (steps + 1))
    grid = np.stack([np.broadcast_to(x[None, :], (steps + 1, elements)),
                     np.broadcast_to(t[:, None], (steps + 1, elements))], axis=-1)
    return torch.from_numpy(grid).to(device)


def _energies(sol: torch.Tensor, dx: float) -> torch.Tensor:
    """(..., 4, E) fields -> (..., 3) [tot, inc, sc] energies."""
    tot, inc = sol[..., 0, :], sol[..., 2, :]
    sc = tot - inc
    return torch.stack([torch.sum(tot**2, -1) * dx, torch.sum(inc**2, -1) * dx,
                        torch.sum(sc**2, -1) * dx], dim=-1)


class WaveControlPINN(nn.Module):
    def __init__(self, design_space: DesignSpace, source_freq: float, elements: int = 1024,
                 latent_grid_size: float = 100.0, h_size: int = 256, nfreq: int = 500,
                 l_size: int = 64, dt: float = 1e-5, integration_steps: int = 100,
                 in_channels: int = 4, seed: int = 0, device="cuda"):
        """Reference hyperparameters; the weights start as flax's
        initialisers draw them, from `seed`."""
        super().__init__()
        dev = resolve_device(device)
        self.design_space = design_space
        self.latent_dim = one_dim(latent_grid_size, elements, device=dev)
        self.n_elements = int(elements)
        self.latent_grid_size = float(latent_grid_size)
        self.source_freq = float(source_freq)
        self.integration_steps = int(integration_steps)
        self.dt = float(dt)
        self.l_size = int(l_size)
        n_design = design_space.low.to_vec().shape[-1]
        self.wave_encoder = WaveEncoder(in_channels, h_size, nfreq, elements, latent_grid_size,
                                        dev)
        self.design_mlp = DesignMLP(n_design, h_size, nfreq, elements, latent_grid_size, dev)
        self.compressor = Compressor(8, h_size, l_size)
        self.field_net = PINNFieldNet(l_size + 2, h_size)
        self.register_buffer("grid", build_pinn_grid(elements, latent_grid_size,
                                                     integration_steps, dt, dev),
                             persistent=False)
        init_flax_like_(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    @property
    def dx(self) -> float:
        return 2.0 * self.latent_grid_size / (self.n_elements - 1)

    def compress(self, x, f, pml, c_pair) -> torch.Tensor:
        """x (B, 4, E), f and pml (B, E), c_pair (B, 2, E) -> l (B, l_size)."""
        chans = torch.cat([x, f[:, None], pml[:, None], c_pair], dim=1)  # (B, 8, E)
        return self.compressor(chans.transpose(1, 2))

    def pinn_window(self, l: torch.Tensor, time_chunk: int | None = None) -> torch.Tensor:
        """The field net over the window's (T+1, E) grid for each latent
        vector l (B, l_size) -> (B, T+1, 4, E). `time_chunk` evaluates that
        many time rows at a time, so the live activations are (B,
        time_chunk E, h) and not (B, (T+1) E, h)."""
        T1, E = self.grid.shape[:2]
        B = l.shape[0]
        chunk = T1 if time_chunk is None else min(time_chunk, T1)

        def eval_points(pts):  # (P, 2) -> (B, P, 4)
            P = pts.shape[0]
            inp = torch.cat([l[:, None, :].expand(B, P, l.shape[-1]),
                             pts[None].expand(B, P, 2)], dim=-1)
            return self.field_net(inp)

        out = torch.cat([eval_points(self.grid[r:r + chunk].reshape(-1, 2))
                         for r in range(0, T1, chunk)], dim=1)
        return out.reshape(B, T1, E, 4).transpose(2, 3)

    def encode(self, batch: dict):
        """(z0 (B, 4, E), source shape f (B, E), pml (B, E), C) of a batch."""
        x = self.wave_encoder(batch["s_wave"])  # (B, 6, E)
        C = design_encoder_apply(self.design_mlp, self.design_space, batch["s_design"],
                                 batch["a"], batch["t"], self.integration_steps)
        return x[:, 0:4], x[:, 4], x[:, 5], C

    def _windows(self, batch: dict, readout, time_chunk: int | None = None) -> torch.Tensor:
        """Unroll the action windows, each from the last row of the one
        before; `readout` maps a window (B, T+1, 4, E) to what is kept, and
        the windows' shared endpoints are joined: (B, L, ...)."""
        z0, f, pml, C = self.encode(batch)
        c = evaluate_over_time(C, batch["t"][:, ::self.integration_steps])  # (B, H+1, E)
        x, outs = z0, []
        for h in range(c.shape[1] - 1):
            sol = self.pinn_window(self.compress(x, f, pml, c[:, h:h + 2]), time_chunk)
            x = sol[:, -1]
            out = readout(sol)
            outs.append(out if h == 0 else out[:, 1:])
        return torch.cat(outs, dim=1)

    @full_float32()
    def generate_latent_solution(self, batch: dict) -> torch.Tensor:
        """(B, L, 4, E) latent fields over the joined windows."""
        return self._windows(batch, lambda sol: sol)

    @full_float32()
    def predict_energy(self, batch: dict, time_chunk: int | None = None) -> torch.Tensor:
        """(B, L, 3) energies, each window reduced to its energies as soon as
        it is evaluated: `forward`'s values without keeping the (B, L, 4, E)
        fields, and with `time_chunk` without (B, (T+1) E, h) activations."""
        return self._windows(batch, lambda sol: _energies(sol, self.dx), time_chunk)

    @full_float32()
    def forward(self, batch: dict) -> torch.Tensor:
        """(B, L, 3) predicted [tot, inc, sc] energies."""
        return _energies(self.generate_latent_solution(batch), self.dx)


@dataclass(frozen=True)
class WaveControlPINNLoss:
    """Physics residual + IC + BC + energy supervision on horizon-1 windows:
    energy MSE + 0.01 (100 c0 (ic + bc) + f / c0)."""

    model: WaveControlPINN
    c0: float
    pml_scale: float = 10000.0

    @full_float32()
    def __call__(self, batch: dict) -> torch.Tensor:
        model = self.model
        z0, f_shape, pml, C = model.encode(batch)
        t = batch["t"]  # (B, T+1)
        assert t.shape[1] == model.integration_steps + 1, (
            "WaveControlPINNLoss trains on horizon-1 windows (reference "
            "scripts/main.jl:127); prepare the dataset with horizon=1 "
            f"(got a length-{t.shape[1]} joined window)"
        )
        F_ = Source(shape=f_shape, freq=torch.tensor(model.source_freq, dtype=torch.float32,
                                                       device=t.device))
        c_knots = evaluate_over_time(C, t[:, ::model.integration_steps])  # (B, 2, E)
        sol = model.pinn_window(model.compress(z0, f_shape, pml, c_knots))  # (B, T+1, 4, E)

        steps = model.integration_steps
        gx = gradient_matrix(model.latent_dim.x)  # (E, E)
        gt = gradient_matrix(torch.linspace(0.0, steps * model.dt, steps + 1,
                                            dtype=torch.float32, device=t.device))
        u_tot, v_tot = sol[:, :, 0], sol[:, :, 1]  # (B, T+1, E)
        u_inc, v_inc = sol[:, :, 2], sol[:, :, 3]

        def ddt(u):
            return torch.einsum("ij,bje->bie", gt.to(u.dtype), u)

        def ddx(u):
            return torch.einsum("ke,bte->btk", gx.to(u.dtype), u)

        c = evaluate_over_time(C, t)  # (B, T+1, E)
        f = evaluate_over_time(F_, t)
        sig = self.pml_scale * pml[:, None, :]
        bc = build_dirichlet(model.latent_dim)[None, None, :]
        c0 = self.c0
        n_u_tot = (c0 * c * ddx(v_tot) - sig * u_tot) * bc
        n_v_tot = c0 * c * ddx(u_tot + f) - sig * v_tot
        n_u_inc = (c0 * ddx(v_inc) - sig * u_inc) * bc
        n_v_inc = c0 * ddx(u_inc + f) - sig * v_inc

        def mse(a, b):
            return torch.mean((a - b) ** 2)

        f_loss = (mse(ddt(u_tot), n_u_tot) + mse(ddt(v_tot), n_v_tot)
                  + mse(ddt(u_inc), n_u_inc) + mse(ddt(v_inc), n_v_inc))
        ic_loss = mse(sol[:, 0], z0)
        E = sol.shape[-1]
        bc_loss = torch.mean(sol[:, :, [0, 2]][..., [0, E - 1]] ** 2)
        physics_loss = 100.0 * c0 * (ic_loss + bc_loss) + f_loss / c0
        return mse(_energies(sol, model.dx), batch["y"]) + 0.01 * physics_loss
