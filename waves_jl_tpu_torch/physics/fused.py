"""The fused RK4 kernel wired into the environment's action window
(counterpart of `waves_jl_tpu/physics/fused.py`).

Gives the same signal and frames as `env_step`, with each RK4 step in the
fused kernel. The state stays a contiguous (12, n, n) float32 tensor; the
JAX package's padded TPU layout has no counterpart here.
`make_rerank_rollout` advances K candidate states at once through the
candidate-batched kernel K3, the hybrid controller's exact re-rank, and
`make_env_step_fused` K independent episodes' windows when the state
leads with K, batched datagen.

Each takes `x_matmul=True` by default, as in the JAX package: d/dx in the
bf16 hi/lo split form of the JAX kernel's default mode (K5);
`x_matmul=False` takes the exact stencil of K1-K3. Both drive a window
through `fused_rk4_window`: on the card, the radii-only mode (the triple
ring's) and the general one (moving cylinders, the free field), in either
d/dx form, take one launch a step (or a call of `steps_per_call` steps
where asked), with the window's state buffers and energy partials made
once and reduced once.

`steps_per_call` follows the JAX package's step times: the window and the
env step take calls of two steps where every frame segment is even, else
one (`default_steps_per_call`), the re-rank two where the window's steps
are even; sub-step st of a call from t runs from float32(t + float32(st
dt)) (`ops.fused_rk4.substep_times`), on the card and in the plain route
alike. By default (`steps_per_call=None`) the card takes one launch of
the one-step kernel at each of those times, which on the H100 is faster a
step than the kernel that takes two or four steps a launch (PERF.md); an
explicit `steps_per_call` launches that many steps at once, at the same
times and to the same state bit for bit. The paths whose JAX counterpart
is XLA's `env_step` step at the window's `tspan` times: `make_env_step_full`,
and batched datagen.
"""
from __future__ import annotations

import numpy as np
import torch

from ..designs import DesignInterpolator, design_cylinders
from ..env import EnvState, WaveEnv, env_tspan, frame_segments, resize_weights
from ..models.layers import full_float32
from ..ops.fused_rk4 import (StepConfig, call_step_times, fused_rk4_window,
                             fused_rk4_window_reference, select_owner, select_owner_batched,
                             select_owner_batched_reference, select_owner_reference)
from ..utils.trees import tree_leaves, tree_map


def cyl_params(d1, d2, device) -> torch.Tensor:
    """(..., 8, n_cyl) [p1x, p1y, r1, c1, p2x, p2y, r2, c2] lerp endpoints,
    with the designs' leading batch dimensions (what `jax.vmap(cyl_params)`
    gives in the JAX package); an empty (8, 0) tensor on `device` when
    there is no design."""
    c1 = design_cylinders(d1)
    c2 = design_cylinders(d2)
    if c1 is None:
        return torch.zeros((8, 0), dtype=torch.float32, device=device)
    return torch.stack([c1.pos[..., 0], c1.pos[..., 1], c1.r, c1.c,
                        c2.pos[..., 0], c2.pos[..., 1], c2.r, c2.c], dim=-2)


def radii_only_ok(space) -> bool:
    """True when the radii-only kernel is exact for every design in `space`:
    positions and speeds are fixed and the circles at their largest radii
    are pairwise disjoint, so each cell has one owning cylinder."""
    lo = design_cylinders(space.low)
    hi = design_cylinders(space.high)
    if lo is None:
        return False
    pos_lo, pos_hi = lo.pos.cpu().numpy(), hi.pos.cpu().numpy()
    if not (np.array_equal(pos_lo, pos_hi)
            and np.array_equal(lo.c.cpu().numpy(), hi.c.cpu().numpy())):
        return False
    rmax = hi.r.cpu().numpy()
    d = np.sqrt(((pos_lo[:, None, :] - pos_lo[None, :, :]) ** 2).sum(-1))
    sep = rmax[:, None] + rmax[None, :]
    iu = np.triu_indices(len(rmax), k=1)
    return bool((d[iu] > sep[iu]).all())


def step_config(env: WaveEnv) -> StepConfig:
    """Kernel parameters of the environment, as Python floats like the JAX
    package computes them."""
    n = env.dim.shape[0]
    return StepConfig(
        n=n,
        spacing=float(2.0 * float(env.dim.x[-1]) / (n - 1)),
        x_min=float(env.dim.x[0]),
        dt=float(env.dt),
        c0=float(env.c0),
        freq=float(env.source.freq),
    )


def default_steps_per_call(steps: int) -> int:
    """The JAX window's steps a kernel call (waves_jl_tpu/physics/fused.py:
    101-104): 2 where every frame segment of a window of `steps` is even,
    else 1."""
    return 2 if all(seg % 2 == 0 for seg in frame_segments(steps)) else 1


def make_fused_window(env: WaveEnv, x_matmul: bool = True, plain: bool = False,
                      steps_per_call: int | None = None):
    """Action window through the fused kernel; radii-only (K2) when
    `radii_only_ok` holds for the design space, else general (K1); with the
    split d/dx (K5) if `x_matmul`. `plain` takes the plain step on any
    device (the reference the card holds the kernel to) at the same step
    times; the CPU takes it anyway. Calls start at every spc-th time of the
    window's `tspan`, and the steps of a call at its `substep_times`, as in
    the JAX window (with one step a call, at `tspan`'s times). With
    `steps_per_call` None, spc is `default_steps_per_call`, the JAX
    package's rule, and the card takes one launch a step at those times;
    an int is spc, a launch of that many steps (a frame segment it does not
    divide raises).

    Returns window(u, shape, tspan, cyl, fields_every=0) -> (u_final,
    frames, signal): u the (12, n, n) state, shape the (n, n) source shape,
    tspan the window's (steps+1,) float32 host times, cyl from
    `cyl_params`. frames are the states at the ends of the frame segments
    and signal is (steps+1, 3) energies times the cell area, from the
    kernel's partials at every step. With `fields_every` > 0 a fourth
    value, (1 + steps // fields_every, 2, n, n): u_tot and u_inc of u and
    of the state after every fields_every-th step (`fused_rk4_window`,
    which refuses a fields_every that a launch's steps do not divide).

    With a leading axis K on u (K, 12, n, n), shape (K, n, n) and cyl
    (K, 8, n_cyl), K independent states advance together through the
    candidate-batched kernel (K3, or batched K5), the same launches and,
    radii-only, one batched owner pass a window: each state's frames and
    final state are what the window gives it alone, bit for bit, and the
    signal is (K, steps+1, 3) (its energy partials summed in another
    order). `fields_every` takes one state only.
    """
    cfg = step_config(env)
    steps = env.integration_steps
    spc = default_steps_per_call(steps) if steps_per_call is None else int(steps_per_call)
    per_launch = 1 if steps_per_call is None else spc
    if any(seg % spc for seg in frame_segments(steps)):
        raise ValueError(f"steps_per_call {spc} does not divide the frame segments "
                         f"{frame_segments(steps)}")
    frame_ends = (np.cumsum(frame_segments(steps)) - 1).tolist()
    stepped = sorted({e for e in frame_ends if e >= 0})  # steps that end a frame segment
    radii = radii_only_ok(env.design_space)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    d_omega = cfg.spacing * cfg.spacing
    run = fused_rk4_window_reference if plain else fused_rk4_window
    owner_of = select_owner_reference if plain else select_owner
    owners_of = select_owner_batched_reference if plain else select_owner_batched

    def window(u, shape, tspan, cyl, fields_every: int = 0):
        ti, tf = float(tspan[0]), float(tspan[-1])
        batch = u.dim() == 4
        owner = (owners_of if batch else owner_of)(cyl, cfg) if radii else None
        if batch:
            sc = u[:, 0] - u[:, 6]
            e0 = torch.stack([torch.sum(u[:, 0] * u[:, 0], dim=(-2, -1)),
                              torch.sum(u[:, 6] * u[:, 6], dim=(-2, -1)),
                              torch.sum(sc * sc, dim=(-2, -1))], dim=-1)
        else:
            sc = u[0] - u[6]
            e0 = torch.stack([torch.sum(u[0] * u[0]), torch.sum(u[6] * u[6]),
                              torch.sum(sc * sc)])
        times = call_step_times(tspan[:steps:spc], spc, cfg.dt)
        kept, energies, *fields = run(u, shape, prof, cyl, owner, times, ti, tf, cfg, stepped,
                                      x_matmul, fields_every, per_launch)
        after = dict(zip(stepped, kept))  # an empty segment's frame is the state before it
        frames = [after.get(e, u) for e in frame_ends]
        signal = torch.cat([e0[None], energies]) * d_omega
        return (frames[-1], frames, signal.transpose(0, 1) if batch else signal, *fields)

    return window


def make_env_step_full(env: WaveEnv, plain: bool = False):
    """Counterpart of the JAX package's `env_step_full`: the window of
    `make_fused_window` with the exact stencil of JAX's `env.integrator`
    (`x_matmul=False`; K2 and its owner pass, or K1) at one step a call, at
    the window's `tspan` times as `env_step` steps, `plain` as there, the
    fields copied out at the time stride. Returns step(state, action,
    render_size=None, time_stride=1) -> (state', info): the state as
    `env_step` gives it, info {"tspan", "u_tot", "u_inc", "interp"} with
    the trajectories (steps // time_stride + 1, n, n) at every
    time_stride-th time, resized on the device to render_size^2 with the
    observation's antialiased linear weights (`resize_weights`, in IEEE
    float32) where render_size is below the grid's size. The signal stays
    full resolution."""
    window = make_fused_window(env, x_matmul=False, plain=plain, steps_per_call=1)
    n = env.dim.shape[0]
    weights = {}

    def resize(u, size):
        if size not in weights:
            weights[size] = torch.from_numpy(resize_weights(n, size)).to(env.device)
        w = weights[size]
        with full_float32():
            return torch.matmul(torch.matmul(w, u), w.T)

    def step(state: EnvState, action, render_size: int | None = None, time_stride: int = 1):
        tspan = env_tspan(env, state)
        next_design = env.design_space(state.design, action)
        cyl = cyl_params(state.design, next_design, env.device).contiguous()
        _, frames, signal, fields = window(state.wave[-1], state.source.shape, tspan, cyl,
                                           time_stride)
        new_state = EnvState(wave=torch.stack(frames, dim=0), design=next_design,
                             source=state.source, signal=signal,
                             time_step=state.time_step + env.integration_steps)
        u_tot, u_inc = fields[:, 0], fields[:, 1]
        if render_size is not None and render_size < n:
            u_tot, u_inc = resize(u_tot, render_size), resize(u_inc, render_size)
        interp = DesignInterpolator(state.design, next_design, float(tspan[0]), float(tspan[-1]))
        return new_state, {"tspan": tspan[::time_stride], "u_tot": u_tot, "u_inc": u_inc,
                           "interp": interp}

    return step


def make_env_step_fused(env: WaveEnv, x_matmul: bool = True, steps_per_call: int | None = None,
                        plain: bool = False):
    """Fused counterpart of `env_step`: returns step(state, action) ->
    (state', info). `x_matmul`, `steps_per_call` (None: the JAX package's
    rule) and `plain` as for `make_fused_window`.

    A state whose wave, design, source and signal lead with K (one time
    step for all) and actions with leading K advance together through the
    candidate-batched kernel (K3, or batched K5): each state as the window
    would advance it alone, the counterpart of the JAX package's vmapped
    `env_step` at `x_matmul=False` with `steps_per_call=1`."""
    window = make_fused_window(env, x_matmul, plain=plain, steps_per_call=steps_per_call)

    def step(state: EnvState, action):
        tspan = env_tspan(env, state)
        next_design = env.design_space(state.design, action)
        cyl = cyl_params(state.design, next_design, env.device).contiguous()
        _, frames, signal = window(state.wave[..., -1, :, :, :].contiguous(), state.source.shape,
                                   tspan, cyl)
        new_state = EnvState(
            wave=torch.stack(frames, dim=-4),
            design=next_design,
            source=state.source,
            signal=signal,
            time_step=state.time_step + env.integration_steps,
        )
        return new_state, {"tspan": tspan}

    return step


def rerank_steps_per_call(steps: int) -> int:
    """The JAX re-rank's steps a kernel call (waves_jl_tpu/physics/fused.py:
    170): 2 where the window's steps are even, else 1."""
    return 2 if steps % 2 == 0 else 1


def rerank_step_times(t_i: np.float32, steps: int, dt: float,
                      steps_per_call: int | None = None) -> list[np.float32]:
    """float32 times of a re-rank window's steps from t_i, as the JAX
    re-rank forms them (:205): kernel calls at t_i + float32(m) dt for
    every spc-th step m (`rerank_steps_per_call` unless given), each call's
    steps at its `substep_times`."""
    f = np.float32
    spc = rerank_steps_per_call(steps) if steps_per_call is None else steps_per_call
    calls = [f(t_i + f(f(m) * f(dt))) for m in range(0, steps, spc)]
    return [f(ts) for ts in call_step_times(calls, spc, dt)]


def make_rerank_rollout(env: WaveEnv, horizon: int, x_matmul: bool = True,
                        steps_per_call: int | None = None):
    """K-candidate exact re-rank rollout for the hybrid controller: all K
    action sequences advance through the simulator together through the
    candidate-batched kernel (K3, or batched K5), instead of K rollouts in
    turn, at the JAX re-rank's step times (`rerank_step_times`). With
    `steps_per_call` None, spc is `rerank_steps_per_call` and the card takes
    one launch a step; an int is spc, a launch of that many steps.
    Radii-only when `radii_only_ok` holds for the design space, with one
    batched owner pass a window; general otherwise; with the split d/dx
    (K5) if `x_matmul`.

    Returns rollout(state, elite, t0) -> (K,) cumulative scattered energy
    over `horizon` windows, sum_h sum(signal_h[1:, 2]) for each candidate:
    elite holds actions with leading (K, horizon), t0 is the window start
    time. Window times are float32 in the JAX package's arithmetic:
    tf = t_i + steps dt, and the next window starts at that tf.
    """
    cfg = step_config(env)
    radii = radii_only_ok(env.design_space)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    steps = env.integration_steps
    spc = rerank_steps_per_call(steps) if steps_per_call is None else steps_per_call
    per_launch = 1 if steps_per_call is None else spc
    d_omega = cfg.spacing * cfg.spacing
    f = np.float32

    def rollout(state: EnvState, elite, t0):
        shape = state.source.shape
        k = tree_leaves(elite)[0].shape[0]
        u = state.wave[-1].expand(k, *state.wave.shape[1:]).contiguous()
        designs = tree_map(lambda x: x.expand(k, *x.shape), state.design)
        t_i = f(t0)
        per_window = []
        for h in range(horizon):
            next_designs = env.design_space(designs, tree_map(lambda x: x[:, h], elite))
            cyl = cyl_params(designs, next_designs, env.device).contiguous()
            owner = select_owner_batched(cyl, cfg) if radii else None
            tf = f(t_i + f(steps * cfg.dt))
            times = [float(ts) for ts in rerank_step_times(t_i, steps, cfg.dt, spc)]
            (u,), e = fused_rk4_window(u, shape, prof, cyl, owner, times, float(t_i), float(tf),
                                       cfg, [steps - 1], x_matmul, steps_per_call=per_launch)
            per_window.append(e[:, :, 2].sum(dim=0))
            designs, t_i = next_designs, tf
        return torch.stack(per_window).sum(dim=0) * d_omega

    return rollout
