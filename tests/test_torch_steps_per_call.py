"""Two and four RK4 steps a launch (`steps_per_call`), checked on the CPU.

`rk4_steps_tiled` (csrc/fused_rk4_multi.cu) runs spc steps of a tile from
the tile and a band of 4 spc cells a side, each step's regions shrinking by
one cell a stage but not at the domain's edges, the combine on the whole
region where a step's state is valid and the tile after the last. The
sub-steps start at the JAX kernel's times float32(t + float32(st dt))
(waves_jl_tpu/ops/pallas_fd.py:362). `fused_rk4_step_tiled_reference(...,
steps_per_call=spc)` decomposes the launch the same way in plain PyTorch;
here it is held:

* bit for bit on the state against spc chained whole-grid plain steps
  (`fused_rk4_step_reference(..., steps_per_call=spc)`), at n = 45 and 48,
  spc 2 and 4, split and exact d/dx, radii-only and general (moving
  cylinders), one state and each of K = 3 candidates; energies (spc, 3)
  within 1e-6 (the tiles' partial sums add in another order);
* against the Pallas kernel in interpret mode with `steps_per_call=2`,
  `x_matmul=True, radii_only=True` (the main paths' mode), within 2e-7 on
  the state and 1e-6 on the energies, the tolerances of
  tests/test_torch_tiled_step.py. Four steps with the 16-cell band are in
  tests/test_torch_steps_per_call_ghost16.py.

The windows' step times: the default window of the 700^2 env steps at
JAX's sub-step times of two-step calls, bit for bit a float32
re-computation of `tspan[::2] + st dt` from the JAX package's `env_tspan`,
over the 20 windows of an episode, one step a launch; `steps_per_call=2`
takes the same times two a launch; one step a call keeps `tspan`'s times,
and the paths whose JAX counterpart is XLA's `env_step`
(`make_env_step_full`, batched datagen) take one step a call. A window
refuses a steps_per_call that does not divide its frame segments, and
`fused_rk4_window` a kept step inside a call. `tile_cylinders`, the
general rasterisation's count in the kernels' bound, is the tile-by-tile
count of `cull_cylinders`. The CUDA kernel runs only on a card: tests/test_torch_gpu.py holds it
against the plain version there, bit for bit.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import _cyl, rel, t

import waves_jl_tpu as w
from waves_jl_tpu.env import env_tspan as jax_env_tspan
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch import data as tdata
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics import fused as pf

torch.set_num_threads(1)
STATE_TOL, ENERGY_TOL = 2e-7, 1e-6
T0, TI, TF = 2e-4, 0.0, 1e-3  # a mid-window lerp weight


def _inputs(n, k=None, moving=False, seed=0):
    """(cfg, u, shape, prof, cyl, owner): one state (12, n, n) for k None,
    else k candidates, each with its own state and radii; owner None for
    moving cylinders (the general mode)."""
    rng = np.random.default_rng(seed + n)
    spacing = 2.0 * 15.0 / (n - 1)
    cfg = fk.StepConfig(n=n, spacing=spacing, x_min=-15.0, dt=1e-5, c0=1531.0, freq=1000.0)
    grid = w.build_grid(w.two_dim(15.0, n))
    shape = np.asarray(w.build_normal(grid, jnp.array([[-3.0, 2.0]]), jnp.array([2.4]),
                                      jnp.array([1.0])))
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    cyl = _cyl(moving=moving)
    lead = () if k is None else (k,)
    u = (rng.standard_normal((*lead, 12, n, n)) * 1e-3).astype(np.float32)
    if k is not None:
        cyl = np.repeat(cyl[None], k, axis=0)
        cyl[:, [2, 6]] *= rng.uniform(0.7, 1.0, (k, 1, cyl.shape[-1])).astype(np.float32)
    cyl = t(cyl)
    owner = None
    if not moving:
        owner = (fk.select_owner_reference(cyl, cfg) if k is None
                 else fk.select_owner_batched_reference(cyl, cfg))
    return cfg, t(u), t(shape), t(pml[:, 0]), cyl, owner


@pytest.mark.parametrize("general", [False, True], ids=["radii_only", "general"])
@pytest.mark.parametrize("x_matmul", [True, False], ids=["split", "exact"])
@pytest.mark.parametrize("spc", [2, 4])
@pytest.mark.parametrize("n", [45, 48])
def test_band_step_equals_chained_plain_steps(n, spc, x_matmul, general):
    cfg, u, shape, prof, cyl, owner = _inputs(n, moving=general)
    got = fk.fused_rk4_step_tiled_reference(u, shape, prof, owner, T0, TI, TF, cfg,
                                            x_matmul=x_matmul, cyl=cyl, steps_per_call=spc)
    want = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                       x_matmul=x_matmul, steps_per_call=spc)
    assert got[0].shape == (12, n, n) and got[1].shape == want[1].shape == (spc, 3)
    assert torch.equal(got[0], want[0])
    assert rel(got[1].numpy(), want[1].numpy()) <= ENERGY_TOL
    # spc chained one-step calls at the sub-step times give the same state
    chained = u
    for ts in fk.substep_times(T0, spc, cfg.dt):
        chained, _ = fk.fused_rk4_step_reference(chained, shape, prof, cyl, owner, float(ts), TI,
                                                 TF, cfg, x_matmul=x_matmul)
    assert torch.equal(chained, want[0])


@pytest.mark.parametrize("general", [False, True], ids=["radii_only", "general"])
@pytest.mark.parametrize("spc", [2, 4])
@pytest.mark.parametrize("n", [45, 48])
def test_band_step_of_each_candidate_equals_batched_plain_steps(n, spc, general):
    k = 3
    cfg, u, shape, prof, cyl, owner = _inputs(n, k, moving=general)
    want = fk.fused_rk4_step_batched_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                               x_matmul=True, steps_per_call=spc)
    assert want[1].shape == (k, spc, 3)
    assert not torch.equal(want[0][0], want[0][1])  # the candidates differ
    for b in range(k):
        got = fk.fused_rk4_step_tiled_reference(u[b], shape, prof,
                                                None if owner is None else owner[b], T0, TI, TF,
                                                cfg, cyl=cyl[b], steps_per_call=spc)
        assert torch.equal(got[0], want[0][b])
        assert rel(got[1].numpy(), want[1][b].numpy()) <= ENERGY_TOL


def test_band_step_matches_pallas_two_steps_a_call():
    n, spc = 48, 2
    cfg, u, shape, prof, cyl, owner = _inputs(n)
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    scalars = np.array([T0, TI, TF, 0.0], np.float32)
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=spc, radii_only=True, x_matmul=True)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u.numpy()), 48),
                  shape_pad=pad_state(jnp.asarray(shape.numpy())[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars),
                  cyl=jnp.asarray(cyl.numpy()))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)
    got, e = fk.fused_rk4_step_tiled_reference(u, shape, prof, owner, T0, TI, TF, cfg,
                                               steps_per_call=spc)
    assert ej.shape == tuple(e.shape) == (spc, 3)
    assert rel(got.numpy(), uj) <= STATE_TOL
    assert rel(e.numpy(), ej) <= ENERGY_TOL


def _env(n, steps, actions=20):
    dim = tdims.two_dim(15.0, n, device="cpu")
    src = tsrc.GaussianSource.create(tdims.build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                     [0.3], [1.0], 1000.0)
    return tenv.make_wave_env(dim, td.build_triple_ring_design_space(device="cpu"), src,
                              resolution=(16, 16), integration_steps=steps, actions=actions)


def _recorded_windows(monkeypatch, env, make, windows, **kw):
    """The (step times, steps_per_call) each of `windows` windows of `env`
    hands `fused_rk4_window`, the window from make(env, **kw) run at time
    steps 0, steps, 2 steps, ... with the kernel route replaced by a
    recorder (nothing is stepped)."""
    calls = []

    def record(u, shape, prof, cyl, owner, times, ti, tf, cfg, keep, x_matmul=False,
               fields_every=0, steps_per_call=1):
        calls.append(([float(x) for x in times], steps_per_call))
        out = [u] * len(keep), torch.zeros((len(times), 3))
        if fields_every:
            out += (torch.zeros((1 + len(times) // fields_every, 2, *u.shape[-2:])),)
        return out

    monkeypatch.setattr(pf, "fused_rk4_window", record)
    monkeypatch.setattr(pf, "fused_rk4_window_reference", record)
    window = make(env, **kw)
    gen = torch.Generator().manual_seed(0)
    state = tenv.env_reset(env, gen)
    cyl = pf.cyl_params(state.design, state.design, "cpu").contiguous()
    for k in range(windows):
        st = tenv.EnvState(state.wave, state.design, state.source, state.signal,
                           k * env.integration_steps)
        window(st.wave[-1], st.source.shape, tenv.env_tspan(env, st), cyl)
    return calls


def _jax_sub_step_times_checked(calls, steps, dt, launch):
    """Assert each recorded window's times are JAX's sub-step times of
    two-step calls, bit for bit, taken `launch` steps a launch; return how
    many differ from `tspan`'s."""
    f = np.float32
    differ = 0
    for k, (times, spc) in enumerate(calls):
        assert spc == launch
        jt = np.asarray(jax_env_tspan(types.SimpleNamespace(dt=dt, integration_steps=steps),
                                      types.SimpleNamespace(time_step=jnp.int32(k * steps))))
        want = [float(f(jt[c] + f(st * dt))) for c in range(0, steps, 2) for st in range(2)]
        assert times == want  # bit for bit
        differ += sum(a != float(b) for a, b in zip(times, jt[:steps]))
    return differ


def test_default_window_step_times_are_jax_sub_step_times(monkeypatch):
    steps, windows, dt = 100, 20, 1e-5
    env = _env(700, steps)
    assert pf.default_steps_per_call(steps) == 2
    calls = _recorded_windows(monkeypatch, env, pf.make_fused_window, windows)
    # one step a launch, at the sub-step times of JAX's two-step calls
    assert _jax_sub_step_times_checked(calls, steps, dt, 1) > 0  # not all tspan's


def test_two_steps_a_launch_take_the_default_window_times(monkeypatch):
    steps, dt = 100, 1e-5
    env = _env(700, steps)
    calls = _recorded_windows(monkeypatch, env, pf.make_fused_window, 4, steps_per_call=2)
    assert _jax_sub_step_times_checked(calls, steps, dt, 2) > 0


def test_tile_cylinders_counts_what_each_tile_keeps():
    cfg, *_, cyl, _ = _inputs(45, moving=True)
    coord = fk._coords(cfg, "cpu")[0]
    for w in (0.0, 0.5, 1.0):
        total = 0
        for i0 in range(0, cfg.n, fk.TILE[0]):
            xs = coord[i0:i0 + fk.TILE[0]]
            for j0 in range(0, cfg.n, fk.TILE[1]):
                ys = coord[j0:j0 + fk.TILE[1]]
                total += int(fk.cull_cylinders(cyl, w, xs, ys, cfg.spacing).sum()) * len(xs) * len(ys)
        assert fk.tile_cylinders(cyl, cfg, w) == pytest.approx(total / cfg.n ** 2, rel=1e-12)
        assert 0 < fk.tile_cylinders(cyl, cfg, w) < cyl.shape[1]
    assert fk.tile_cylinders(torch.stack([cyl, cyl]), cfg) == fk.tile_cylinders(cyl, cfg)


def test_one_step_a_call_keeps_tspan_times(monkeypatch):
    steps = 20
    env = _env(32, steps)
    for make, kw in ((pf.make_fused_window, {"steps_per_call": 1}),
                     (pf.make_fused_window, {"steps_per_call": 1, "plain": True})):
        calls = _recorded_windows(monkeypatch, env, make, 3, **kw)
        for k, (times, spc) in enumerate(calls):
            st = types.SimpleNamespace(time_step=k * steps)
            assert spc == 1
            assert times == [float(x) for x in tenv.env_tspan(env, st)[:steps]]


def test_exact_full_window_and_batched_datagen_take_one_step_a_call(monkeypatch):
    env = _env(32, 20, actions=1)
    spcs = []
    real = pf.make_fused_window

    def spy(env_, *args, **kw):
        spcs.append(kw.get("steps_per_call"))
        return real(env_, *args, **kw)

    monkeypatch.setattr(pf, "make_fused_window", spy)
    pf.make_env_step_full(env)
    pf.make_env_step_fused(env)
    tdata.make_episode_batch_fused(env)
    tdata.make_episode_fused(env)
    assert spcs == [1, None, 1, None]  # None: the JAX package's rule


def test_window_refuses_what_its_calls_cannot_take():
    env = _env(32, 25)  # frame segments [5, 10, 10]
    assert pf.default_steps_per_call(25) == 1
    with pytest.raises(ValueError, match="does not divide"):
        pf.make_fused_window(env, steps_per_call=2)
    cfg, u, shape, prof, cyl, owner = _inputs(45)
    times = fk.call_step_times([T0, T0 + 2e-5], 2, cfg.dt)
    with pytest.raises(ValueError, match="last of a call"):
        fk.fused_rk4_window(u, shape, prof, cyl, owner, times, TI, TF, cfg, [0], True,
                            steps_per_call=2)
    with pytest.raises(ValueError, match="sub-step times"):
        fk.fused_rk4_window(u, shape, prof, cyl, owner, [T0, T0 + 1e-5, T0 + 2e-5, T0 + 3e-5],
                            TI, TF, cfg, [3], True, steps_per_call=2)
    kept, e = fk.fused_rk4_window(u, shape, prof, cyl, owner, times, TI, TF, cfg, [1, 3], True,
                                  steps_per_call=2)
    want, _ = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                          x_matmul=True, steps_per_call=2)
    assert e.shape == (4, 3) and torch.equal(kept[0], want)
