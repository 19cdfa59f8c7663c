"""Environment around the wave simulator (counterpart of
`waves_jl_tpu/env.py`).

A frozen `WaveEnv` holds the static parameters and an explicit `EnvState`
is stepped by functions `(env, state, action) -> (state', info)`. Random
draws come from an explicit `torch.Generator`. `env_step` is the plain
PyTorch path, an RK4 step at a time; `physics.fused.make_env_step_fused` is
the kernel path the main loop runs. `env_step_full` and `env_step_flux`,
which give the full fields for rendering and the flux, take the kernel
with the exact stencil (`physics.fused.make_env_step_full`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .constants import WATER
from .designs import DesignInterpolator, DesignSpace, SpeedField, build_action_space
from .dims import TwoDim, build_grid, get_dx, get_dy
from .physics.dynamics import Integrator, build_tspan, make_acoustic_dynamics_2d

FRAMESKIP = 10  # frame history stride
N_FRAMES = 3


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a linear, antialiased resize along
    one axis, computed as `jax.image.resize(method="linear")` computes them:
    a triangle kernel widened by 1/scale when downsampling, each output's
    weights normalised to sum to one."""
    f = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * f(inv_scale) - f(0.0) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kernel_scale
    w = np.maximum(f(0.0), f(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).T.astype(f)


@dataclass(frozen=True)
class WaveEnv:
    dim: TwoDim
    grid: torch.Tensor  # (nx, ny, 2)
    design_space: DesignSpace
    action_space: DesignSpace
    source: Any  # template source, resampled on reset
    integrator: Integrator
    resize_x: torch.Tensor  # (res_x, nx) observation weights
    resize_y: torch.Tensor  # (res_y, ny)
    resolution: tuple = (128, 128)
    dt: float = 1e-5
    integration_steps: int = 100
    actions: int = 10

    @property
    def c0(self) -> float:
        return self.integrator.dynamics.c0

    @property
    def device(self) -> torch.device:
        return self.grid.device


@dataclass(frozen=True)
class EnvState:
    wave: torch.Tensor  # (N_FRAMES, 12, nx, ny) frame history, last = current
    design: Any
    source: Any
    signal: torch.Tensor  # (steps+1, 3) [tot, inc, sc] energies of the last window
    time_step: int


@dataclass(frozen=True)
class WaveEnvState:
    """Observation: 3 displacement frames and the source shape resized to
    `resolution`, channels last; the window's tspan; the current design."""

    tspan: np.ndarray
    wave: torch.Tensor  # (res, res, N_FRAMES + 1)
    design: Any


def make_wave_env(dim: TwoDim, design_space: DesignSpace, source, action_speed: float = 250.0,
                  c0: float = WATER, pml_width: float = 2.0, pml_scale: float = 20000.0,
                  resolution: tuple = (128, 128), dt: float = 1e-5,
                  integration_steps: int = 100, actions: int = 10) -> WaveEnv:
    """The environment on the device of `dim`, with the reference defaults."""
    if not all(s > r for s, r in zip(dim.shape, resolution)):
        raise ValueError("resolution must be less than the simulation grid")
    dev = dim.x.device
    dynamics = make_acoustic_dynamics_2d(dim, c0, pml_width, pml_scale)
    # action scale = action_speed * dt * steps
    scale = action_speed * dt * integration_steps
    return WaveEnv(
        dim=dim,
        grid=build_grid(dim),
        design_space=design_space,
        action_space=build_action_space(design_space.low, scale),
        source=source,
        integrator=Integrator(dynamics=dynamics, dt=dt),
        resize_x=torch.from_numpy(resize_weights(dim.shape[0], resolution[0])).to(dev),
        resize_y=torch.from_numpy(resize_weights(dim.shape[1], resolution[1])).to(dev),
        resolution=tuple(resolution),
        dt=float(dt),
        integration_steps=int(integration_steps),
        actions=int(actions),
    )


def env_reset(env: WaveEnv, generator: torch.Generator) -> EnvState:
    """Zero wave, random design, resampled source."""
    design = env.design_space.sample(generator)
    source = env.source.resample(generator) if hasattr(env.source, "resample") else env.source
    return EnvState(
        wave=torch.zeros((N_FRAMES, 12, *env.dim.shape), dtype=torch.float32, device=env.device),
        design=design,
        source=source,
        signal=torch.zeros((env.integration_steps + 1, 3), dtype=torch.float32, device=env.device),
        time_step=0,
    )


def env_time(env: WaveEnv, state: EnvState) -> np.float32:
    return np.float32(state.time_step) * np.float32(env.dt)


def env_tspan(env: WaveEnv, state: EnvState) -> np.ndarray:
    """The window's (steps+1,) float32 times, on the host."""
    return env_time(env, state) + build_tspan(0.0, env.dt, env.integration_steps)


def frame_segments(steps: int) -> list[int]:
    """Step counts between the frames kept: the last N_FRAMES-1 segments
    are FRAMESKIP steps long."""
    fs = min(FRAMESKIP, steps // (N_FRAMES - 1))
    return [steps - (N_FRAMES - 1) * fs] + [fs] * (N_FRAMES - 1)


def _energy_triple(u: torch.Tensor, d_omega) -> torch.Tensor:
    sc = u[0] - u[6]
    return torch.stack([torch.sum(u[0] ** 2), torch.sum(u[6] ** 2), torch.sum(sc**2)]) * d_omega


def env_step(env: WaveEnv, state: EnvState, action) -> tuple[EnvState, dict]:
    """One action window on the plain path: clamp the action, lerp the
    design, integrate the window an RK4 step at a time, keep the energy
    signal and the frame history."""
    tspan = env_tspan(env, state)
    next_design = env.design_space(state.design, action)
    interp = DesignInterpolator(state.design, next_design, float(tspan[0]), float(tspan[-1]))
    theta = (SpeedField(interp=interp, grid=env.grid, c0=env.c0), state.source)
    d_omega = get_dx(env.dim) * get_dy(env.dim)

    u = state.wave[-1]
    frames = []
    energies = [_energy_triple(u, d_omega)[None]]
    k = 0
    for seg in frame_segments(env.integration_steps):
        for _ in range(seg):
            u = env.integrator.step(u, tspan[k], theta)
            energies.append(_energy_triple(u, d_omega)[None])
            k += 1
        frames.append(u)
    new_state = EnvState(
        wave=torch.stack(frames, dim=0),
        design=next_design,
        source=state.source,
        signal=torch.cat(energies, dim=0),
        time_step=state.time_step + env.integration_steps,
    )
    return new_state, {"tspan": tspan}


def env_step_full(env: WaveEnv, state: EnvState, action, render_size: int | None = None,
                  time_stride: int = 1) -> tuple[EnvState, dict]:
    """`env_step` that also returns the displacement trajectories u_tot and
    u_inc of the window, (steps // time_stride + 1, n, n) each, resized on
    the device to render_size^2 where given, for rendering. It runs the
    exact one-launch kernel on the card and its plain version on the CPU
    (`physics.fused.make_env_step_full`, which a caller stepping many
    windows builds once); the signal stays full resolution."""
    from .physics.fused import make_env_step_full

    return make_env_step_full(env)(state, action, render_size, time_stride)


def env_step_flux(env: WaveEnv, state: EnvState, action,
                  mask_radius: float = 2.0) -> tuple[EnvState, dict]:
    """`env_step_full` at full resolution, with info["flux"] (steps+1,): the
    flux of each step's scattered field u_tot - u_inc through the disc of
    `mask_radius` about the origin (`ops.metrics.flux` with the
    `laplacian_matrix` of the x axis)."""
    from .ops.fd import laplacian_matrix
    from .ops.metrics import circle_mask, flux

    lap = laplacian_matrix(env.dim.x)
    mask = circle_mask(env.dim, mask_radius).to(torch.float32)
    new_state, info = env_step_full(env, state, action)
    info["flux"] = flux(info["u_tot"] - info["u_inc"], lap, mask)
    return new_state, info


def env_observe(env: WaveEnv, state: EnvState) -> WaveEnvState:
    """3 displacement frames and the source shape, resized to `resolution`
    with the antialiased linear weights of `resize_weights`, channels last;
    for K stacked states (wave (K, 3, 12, n, n)) the images lead with K."""
    img = torch.cat([state.wave[..., 0, :, :], state.source.shape[..., None, :, :]],
                    dim=-3)  # (..., 4, nx, ny)
    small = torch.matmul(torch.matmul(env.resize_x, img), env.resize_y.T)  # (..., 4, rx, ry)
    return WaveEnvState(tspan=env_tspan(env, state), wave=small.movedim(-3, -1),
                        design=state.design)


def env_reward(state: EnvState) -> torch.Tensor:
    """Sum of the last window's signal (the reference `src/env.jl:147-149`)."""
    return torch.sum(state.signal)


def env_terminated(env: WaveEnv, state: EnvState) -> bool:
    """True once the episode has run its env.actions windows."""
    return state.time_step >= env.actions * env.integration_steps


@dataclass(frozen=True)
class RandomDesignPolicy:
    """Uniform random actions."""

    action_space: DesignSpace

    def __call__(self, generator: torch.Generator):
        return self.action_space.sample(generator)
