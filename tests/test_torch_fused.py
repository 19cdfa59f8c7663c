"""The port's fused RK4 step and window against the JAX package.

* The plain version of the kernel (`fused_rk4_step_reference`) against the
  Pallas kernel in interpret mode with the exact f32 stencil
  (`x_matmul=False`), radii-only and general, one and two steps a call
  (two plain calls against the kernel's two sub-steps), to
  1e-6 relative: both run the same float32 operations in the same order,
  so only sin and the energy sums round apart.
* The port's fused env window at its default (`x_matmul=True`, the bf16
  split d/dx) against the JAX `env_step` (XLA) over two chained windows,
  to 1e-5 relative on signal and frames, the bound the JAX package holds
  its own default fused window to (tests/test_fused.py).
* `env_observe` against JAX to atol 2e-5, as tests/test_fused.py holds the
  observation.
* K1's plain version against K2's on the triple ring.
The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py holds it
against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.env import RandomDesignPolicy as JaxPolicy
from waves_jl_tpu.env import env_observe as jax_env_observe
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.env import env_step as jax_env_step
from waves_jl_tpu.env import make_wave_env as jax_make_wave_env
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import cyl_params, make_env_step_fused, step_config

torch.set_num_threads(1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _cyl(moving: bool) -> np.ndarray:
    """(8, 4): three ring cylinders and the core, radii drawn in numpy;
    `moving` shifts the end positions so the cylinders travel."""
    rng = np.random.default_rng(11)
    pos = np.asarray(w.build_triple_ring_design_space().low.config.cylinders.pos)[[0, 6, 12]]
    pos = np.concatenate([pos, [[5.0, 0.0]]]).astype(np.float32)
    r1 = np.r_[rng.uniform(0.6, 1.0, 3), 2.0]
    r2 = np.r_[rng.uniform(0.6, 1.0, 3), 2.0]
    c = np.full(4, 3 * 344.0)
    pos2 = pos + (np.array([0.7, -0.4]) if moving else 0.0)
    return np.stack([pos[:, 0], pos[:, 1], r1, c, pos2[:, 0], pos2[:, 1], r2, c]).astype(np.float32)


def plain_steps(u, shape, prof, cyl, owner, t0, ti, tf, cfg, steps):
    """`steps` calls of the plain step from t0, each at the time the Pallas
    kernel gives its sub-step (float32 t0 + k dt). Returns (u, energies
    (steps, 3))."""
    es = []
    for k in range(steps):
        t_k = float(np.float32(t0) + np.float32(k * cfg.dt))
        u, e = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, t_k, ti, tf, cfg)
        es.append(e)
    return u, torch.stack(es)


@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_plain_step_matches_pallas_kernel(radii_only, steps_per_call):
    n = 48
    spacing = 2.0 * 15.0 / (n - 1)
    rng = np.random.default_rng(steps_per_call)
    u = (rng.standard_normal((12, n, n)) * 1e-3).astype(np.float32)
    grid = w.build_grid(w.two_dim(15.0, n))
    shape = np.asarray(w.build_normal(grid, jnp.array([[-3.0, 2.0]]), jnp.array([2.4]),
                                      jnp.array([1.0])))
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    cyl = _cyl(moving=not radii_only)
    scalars = np.array([2e-4, 0.0, 1e-3, 0.0], np.float32)  # mid-window lerp weight

    step = make_fused_acoustic_step(
        n=n, spacing=spacing, dt=1e-5, c0=1531.0, freq=1000.0, n_cyl=cyl.shape[1],
        x_min=-15.0, interpret=True, steps_per_call=steps_per_call, radii_only=radii_only,
        x_matmul=False)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u), 48),
                  shape_pad=pad_state(jnp.asarray(shape)[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars), cyl=jnp.asarray(cyl))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)

    cfg = fk.StepConfig(n=n, spacing=spacing, x_min=-15.0, dt=1e-5, c0=1531.0, freq=1000.0)
    owner = fk.select_owner_reference(t(cyl), cfg) if radii_only else None
    if owner is not None:
        assert int((owner[0] < owner[1] ** 2).sum()) > 10  # cylinders cover cells
    ut, et = plain_steps(t(u), t(shape), t(pml[:, 0]), t(cyl), owner, *map(float, scalars[:3]),
                         cfg, steps_per_call)
    assert ut.shape == (12, n, n) and et.shape == (steps_per_call, 3)
    assert rel(ut.numpy(), uj) <= 1e-6
    assert rel(et.numpy(), ej) <= 1e-6


def test_plain_general_matches_plain_radii_only_on_triple_ring():
    n = 96
    cfg = fk.StepConfig(n=n, spacing=2.0 * 15.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                        freq=1000.0)
    space = td.build_triple_ring_design_space(device="cpu")
    gen = torch.Generator().manual_seed(0)
    cyl = cyl_params(space.sample(gen), space.sample(gen), "cpu").contiguous()
    u = torch.from_numpy((np.random.default_rng(0).standard_normal((12, n, n)) * 1e-3)
                         .astype(np.float32))
    shape = torch.zeros(n, n)
    prof = torch.zeros(n)
    owner = fk.select_owner_reference(cyl, cfg)
    assert int((owner[0] < owner[1] ** 2).sum()) > 50
    ug, eg = plain_steps(u, shape, prof, cyl, None, 2e-4, 0.0, 1e-3, cfg, 2)
    ur, er = plain_steps(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg, 2)
    assert rel(ur.numpy(), ug.numpy()) <= 1e-7
    assert rel(er.numpy(), eg.numpy()) <= 1e-7


def test_wrapper_takes_the_plain_version_on_cpu():
    n = 32
    cfg = fk.StepConfig(n=n, spacing=2.0 * 15.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                        freq=1000.0)
    cyl = t(_cyl(moving=False))
    u = torch.from_numpy((np.random.default_rng(1).standard_normal((12, n, n)) * 1e-3)
                         .astype(np.float32))
    shape, prof = torch.ones(n, n), torch.linspace(0.0, 1.0, n)
    fk.reset_launch_counts()
    owner = fk.select_owner(cyl, cfg)
    torch.testing.assert_close(owner, fk.select_owner_reference(cyl, cfg), rtol=0, atol=0)
    for o in (owner, None):
        got = fk.fused_rk4_step(u, shape, prof, cyl, o, 1e-4, 0.0, 1e-3, cfg)
        want = fk.fused_rk4_step_reference(u, shape, prof, cyl, o, 1e-4, 0.0, 1e-3, cfg)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in fk.launch_counts.values())  # nothing launched


def _envs(n=64, steps=20):
    """The same environment in both packages, with the port's design, source
    and action set to the JAX draws."""
    jdim = w.two_dim(15.0, n)
    jsrc = w.GaussianSource.create(w.build_grid(jdim), jnp.array([[-10.0, -10.0]]),
                                   jnp.array([[-10.0, 10.0]]), jnp.array([0.3]),
                                   jnp.array([1.0]), 1000.0)
    je = jax_make_wave_env(jdim, w.build_triple_ring_design_space(), jsrc, resolution=(32, 32),
                           integration_steps=steps, actions=2)
    pdim = tdims.two_dim(15.0, n, device="cpu")
    psrc = tsrc.GaussianSource.create(tdims.build_grid(pdim), [[-10.0, -10.0]],
                                      [[-10.0, 10.0]], [0.3], [1.0], 1000.0)
    pe = tenv.make_wave_env(pdim, td.build_triple_ring_design_space(device="cpu"), psrc,
                            resolution=(32, 32), integration_steps=steps, actions=2)
    return je, pe


def _port_cloak(space, jd):
    """A port design/action with the JAX draw's radii."""
    z = space.low
    return td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        torch.zeros_like(z.config.cylinders.pos), t(jd.config.cylinders.r),
        torch.zeros_like(z.config.cylinders.c))), td.Cylinders(
        torch.zeros_like(z.core.pos), torch.zeros_like(z.core.r), torch.zeros_like(z.core.c)))


def test_fused_window_and_observation_match_jax():
    je, pe = _envs()
    js = jax_env_reset(je, jax.random.PRNGKey(0))
    policy = JaxPolicy(je.action_space)
    jacts = [policy(jax.random.PRNGKey(k)) for k in (1, 2)]
    # the port starts from the JAX draw: its ring radii, its source shape
    design = pe.design_space.low
    design = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        design.config.cylinders.pos, t(js.design.config.cylinders.r),
        design.config.cylinders.c)), design.core)
    ps = tenv.env_reset(pe, torch.Generator().manual_seed(0))
    src = ps.source
    src = tsrc.GaussianSource(src.grid, src.mu_low, src.mu_high, src.sigma, src.a,
                              t(js.source.shape), src.freq)
    ps = tenv.EnvState(ps.wave, design, src, ps.signal, 0)
    step = make_env_step_fused(pe)
    assert step_config(pe).n == 64
    pplain = ps
    for ja in jacts:
        js, jinfo = jax_env_step(je, js, ja)
        pa = _port_cloak(pe.design_space, ja)
        ps, info = step(ps, pa)
        pplain, _ = tenv.env_step(pe, pplain, pa)
        assert rel(info["tspan"], np.asarray(jinfo["tspan"])) <= 1e-6
        for port in (ps, pplain):
            assert port.time_step == int(js.time_step)
            assert rel(port.signal.numpy(), np.asarray(js.signal)) <= 1e-5
            assert rel(port.wave.numpy(), np.asarray(js.wave)) <= 1e-5
    assert float(np.abs(np.asarray(js.wave)).max()) > 0.0
    jo, po = jax_env_observe(je, js), tenv.env_observe(pe, ps)
    assert po.wave.shape == (32, 32, 4)
    np.testing.assert_allclose(po.wave.numpy(), np.asarray(jo.wave), rtol=0, atol=2e-5)
    assert rel(po.tspan, np.asarray(jo.tspan)) <= 1e-6


@pytest.mark.parametrize("n_in,n_out", [(700, 128), (64, 32)])
def test_observation_resize_matches_jax_image_resize(n_in, n_out):
    img = np.random.default_rng(n_in).standard_normal((n_in, n_in, 4)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (n_out, n_out, 4), method="linear"))
    wx = torch.from_numpy(tenv.resize_weights(n_in, n_out))
    got = torch.matmul(torch.matmul(wx, t(img).permute(2, 0, 1)), wx.T).permute(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
