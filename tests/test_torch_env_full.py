"""The full-field window (`physics.fused.make_env_step_full`: the fused
window with u_tot and u_inc copied out), and `env_step_full` and
`env_step_flux` on it, against the JAX package on the
same draws, at 48^2 with 10-step windows:

- `env_step_full` over two chained windows, at stride 1 and at
  `render_size` 24 with `time_stride` 5, against JAX's (XLA's exact
  stencil): frames and fields within 1e-5 of their largest magnitude, the
  signal within 1e-5 relative, the strided times equal;
- `env_step_flux` against JAX's: flux within 1e-5 relative;
- the CPU window bit for bit its plain kernel steps: its state and signal
  are `make_env_step_fused(x_matmul=False)`'s and its fields the channels
  (0, 6) of `fused_rk4_step_reference` stepped by hand, on the triple ring
  (K2's route) and on moving cylinders (K1's); `plain=True` gives the same;
- the window against the plain `Integrator`'s `env_step`: 1e-5 relative.

The window's CUDA route is held against its plain route on the card
(tests/test_torch_gpu.py, `chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.env import RandomDesignPolicy as JaxPolicy
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.env import env_step_flux as jax_env_step_flux
from waves_jl_tpu.env import env_step_full as jax_env_step_full
from waves_jl_tpu.env import make_wave_env as jax_make_wave_env
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import (cyl_params, make_env_step_fused,
                                              make_env_step_full, radii_only_ok, step_config)

torch.set_num_threads(1)
N, STEPS, RES = 48, 10, (16, 16)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def port_cloak(jd):
    """The port's Cloak with a JAX cloak's leaves."""
    cy, core = jd.config.cylinders, jd.core
    return td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(t(cy.pos), t(cy.r), t(cy.c))),
                    td.Cylinders(t(core.pos), t(core.r), t(core.c)))


def envs(n: int = N, steps: int = STEPS, actions: int = 2):
    """The triple-ring env in both packages."""
    jdim = w.two_dim(15.0, n)
    jsrc = w.GaussianSource.create(w.build_grid(jdim), jnp.array([[-10.0, -10.0]]),
                                   jnp.array([[-10.0, 10.0]]), jnp.array([0.3]),
                                   jnp.array([1.0]), 1000.0)
    je = jax_make_wave_env(jdim, w.build_triple_ring_design_space(), jsrc, resolution=RES,
                           integration_steps=steps, actions=actions)
    pdim = tdims.two_dim(15.0, n, device="cpu")
    psrc = tsrc.GaussianSource.create(tdims.build_grid(pdim), [[-10.0, -10.0]],
                                      [[-10.0, 10.0]], [0.3], [1.0], 1000.0)
    pe = tenv.make_wave_env(pdim, td.build_triple_ring_design_space(device="cpu"), psrc,
                            resolution=RES, integration_steps=steps, actions=actions)
    return je, pe


def starts(je, pe, seed: int = 0, actions: int = 2):
    """JAX's reset and its random actions, and the port's reset holding
    the same design and source shape and the same actions."""
    js = jax_env_reset(je, jax.random.PRNGKey(seed))
    policy = JaxPolicy(je.action_space)
    jacts = [policy(jax.random.PRNGKey(seed + 1 + k)) for k in range(actions)]
    ps = tenv.env_reset(pe, torch.Generator().manual_seed(seed))
    src = ps.source
    src = tsrc.GaussianSource(src.grid, src.mu_low, src.mu_high, src.sigma, src.a,
                              t(js.source.shape), src.freq)
    ps = tenv.EnvState(ps.wave, port_cloak(js.design), src, ps.signal, 0)
    return js, ps, jacts, [port_cloak(a) for a in jacts]


def held(port_state, port_info, jax_state, jax_info, tol=1e-5):
    assert rel(port_state.wave.numpy(), jax_state.wave) <= tol
    assert rel(port_state.signal.numpy(), jax_state.signal) <= tol
    assert port_state.time_step == int(jax_state.time_step)
    np.testing.assert_array_equal(port_info["tspan"], np.asarray(jax_info["tspan"]))
    for k in ("u_tot", "u_inc"):
        assert port_info[k].shape == tuple(jax_info[k].shape)
        assert rel(port_info[k].numpy(), jax_info[k]) <= tol, k
    assert port_info["interp"].ti == float(jax_info["interp"].ti)
    assert port_info["interp"].tf == float(jax_info["interp"].tf)


@pytest.mark.parametrize("render_size,time_stride", [(None, 1), (24, 5)])
def test_env_step_full_matches_jax(render_size, time_stride):
    je, pe = envs()
    js, ps, jacts, pacts = starts(je, pe)
    jstep = jax.jit(lambda s, a: jax_env_step_full(je, s, a, render_size=render_size,
                                                   time_stride=time_stride))
    for ja, pa in zip(jacts, pacts):
        js, jinfo = jstep(js, ja)
        ps, pinfo = tenv.env_step_full(pe, ps, pa, render_size=render_size,
                                       time_stride=time_stride)
        held(ps, pinfo, js, jinfo)
    size = render_size or N
    assert pinfo["u_tot"].shape == (STEPS // time_stride + 1, size, size)
    assert float(ps.signal[:, 0].max()) > 0.0


def test_env_step_flux_matches_jax():
    je, pe = envs()
    js, ps, jacts, pacts = starts(je, pe, seed=3)
    jstep = jax.jit(lambda s, a: jax_env_step_flux(je, s, a))
    for ja, pa in zip(jacts, pacts):
        js, jinfo = jstep(js, ja)
        ps, pinfo = tenv.env_step_flux(pe, ps, pa)
        held(ps, pinfo, js, jinfo)
    assert pinfo["flux"].shape == (STEPS + 1,)
    assert float(np.abs(np.asarray(jinfo["flux"])).max()) > 0.0
    assert rel(pinfo["flux"].numpy(), jinfo["flux"]) <= 1e-5


def position_env(pe):
    """`pe` with the triple ring's cylinders free to move: K1's route."""
    space = pe.design_space
    lo, hi = space.low, space.high
    move = lambda d, v: td.Cloak(td.AdjustablePositionScatterers(td.Cylinders(  # noqa: E731
        d.config.cylinders.pos + v, torch.full_like(d.config.cylinders.r, 0.6),
        d.config.cylinders.c)), d.core)
    return tenv.make_wave_env(pe.dim, td.DesignSpace(move(lo, -0.5), move(hi, 0.5)), pe.source,
                              resolution=RES, integration_steps=STEPS, actions=2)


@pytest.mark.parametrize("mode", ["radii_only", "general"])
def test_cpu_window_is_its_plain_steps_bit_for_bit(mode):
    _, pe = envs()
    if mode == "general":
        pe = position_env(pe)
    assert radii_only_ok(pe.design_space) == (mode == "radii_only")
    gen = torch.Generator().manual_seed(5)
    state = tenv.env_reset(pe, gen)
    policy = tenv.RandomDesignPolicy(pe.action_space)
    state, _ = make_env_step_fused(pe, x_matmul=False)(state, policy(gen))  # a wave to step
    action = policy(gen)
    got, info = make_env_step_full(pe)(state, action, time_stride=3)
    plain, plain_info = make_env_step_full(pe, plain=True)(state, action, time_stride=3)
    want, _ = make_env_step_fused(pe, x_matmul=False)(state, action)
    for a, b in ((got.wave, want.wave), (got.signal, want.signal), (plain.wave, want.wave),
                 (info["u_tot"], plain_info["u_tot"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the fields: channels (0, 6) of the plain kernel step, stepped by hand
    cfg = step_config(pe)
    tspan = tenv.env_tspan(pe, state)
    cyl = cyl_params(state.design, got.design, "cpu").contiguous()
    owner = fk.select_owner_reference(cyl, cfg) if mode == "radii_only" else None
    prof = pe.integrator.dynamics.pml[:, 0].contiguous()
    u, fields = state.wave[-1], [state.wave[-1][0::6]]
    for k in range(STEPS):
        u, _ = fk.fused_rk4_step_reference(u, state.source.shape, prof, cyl, owner,
                                           float(tspan[k]), float(tspan[0]), float(tspan[-1]),
                                           cfg)
        if (k + 1) % 3 == 0:
            fields.append(u[0::6])
    fields = torch.stack(fields)
    torch.testing.assert_close(info["u_tot"], fields[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(info["u_inc"], fields[:, 1], rtol=0, atol=0)
    np.testing.assert_array_equal(info["tspan"], tspan[::3])
    # and the plain integrator's window (another op order) within 1e-5
    ref, _ = tenv.env_step(pe, state, action)
    assert rel(got.wave.numpy(), ref.wave.numpy()) <= 1e-5
    assert rel(got.signal.numpy(), ref.signal.numpy()) <= 1e-5
