"""An episode's full fields, rolled out and rendered (counterpart of
`waves_jl_tpu/viz/episode.py`).

Each window runs on the device through the exact one-launch kernel
(`physics.fused.make_env_step_full`), is strided in time and resized there,
and reaches the host in one pull a window; the design of each frame is
interpolated on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FRAMES_PER_SECOND
from ..designs import DesignInterpolator
from ..env import WaveEnv, env_reset, env_terminated
from ..utils.trees import tree_map
from .plot import render_video


def _to_host(design):
    return tree_map(lambda x: x.detach().cpu(), design)


def rollout_fields(env: WaveEnv, policy, generator: torch.Generator, field: str = "tot",
                   stride: int = 10, state=None, render_size: int | None = None,
                   state_aware: bool = False):
    """Roll a whole episode from `state` (a reset drawn from `generator`
    where None), keeping the chosen displacement field ("tot", "inc" or
    "sc") every `stride` steps, resized on the device to render_size^2
    where given. The policy's form is explicit: policy(generator, state)
    -> action with `state_aware` (a controller), else policy(generator).

    Returns (times (F,), frames (F, r, r), the design at each frame on the
    CPU, signals (A, steps+1, 3)), numpy arrays but the designs; a window's
    first frame is the previous window's last and is kept once."""
    from ..physics.fused import make_env_step_full

    if field not in ("tot", "inc", "sc"):
        raise ValueError(f"field must be 'tot', 'inc' or 'sc', not {field!r}")
    if state is None:
        state = env_reset(env, generator)
    step_full = make_env_step_full(env)
    frames, times, designs, signals = [], [], [], []
    while not env_terminated(env, state):
        action = policy(generator, state) if state_aware else policy(generator)
        before = _to_host(state.design)
        state, info = step_full(state, action, render_size=render_size, time_stride=stride)
        u_tot, u_inc = info["u_tot"], info["u_inc"]
        u = {"tot": u_tot, "inc": u_inc, "sc": u_tot - u_inc}[field].cpu().numpy()
        tspan = info["tspan"]
        interp = DesignInterpolator(before, _to_host(state.design), float(tspan[0]),
                                    float(tspan[-1]))
        for i in range(0 if not frames else 1, len(tspan)):
            frames.append(u[i])
            times.append(tspan[i])
            designs.append(interp(tspan[i]))
        signals.append(state.signal.cpu().numpy())
    return np.asarray(times), np.stack(frames), designs, np.stack(signals)


def render_episode(env: WaveEnv, policy, generator: torch.Generator, path: str,
                   field: str = "tot", bound: float = 1.0, energy: bool = False, stride: int = 10,
                   state=None, render_size: int | None = None, state_aware: bool = False):
    """Render one episode (`rollout_fields`) to a video at `path` (a GIF
    or a directory of PNG frames beside it without ffmpeg); returns the
    signals (A, steps+1, 3)."""
    _, frames, designs, signals = rollout_fields(env, policy, generator, field, stride, state,
                                                 render_size, state_aware)
    gs = float(env.dim.x[-1])
    render_video(frames, (-gs, gs, -gs, gs), path, designs=designs, fps=FRAMES_PER_SECOND,
                 bound=bound, energy=energy)
    return signals
