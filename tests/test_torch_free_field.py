"""The port's free-field env (`DesignSpace(NoDesign(), NoDesign())`), the
counterpart of tests/test_robustness.py:13-46, on the CPU:

* the plain `env_step`: finite, tot == inc (1e-6 relative), sc < 1e-10;
* the fused window with n_cyl = 0, the general kernel K1's plain version,
  against the plain `env_step` to 1e-5 of the signal's largest magnitude
  (JAX holds its Pallas window to the same);
* the port's plain and fused windows against the JAX package's free-field
  `env_step` on the same source shape, 1e-5 relative;
* the empty design through `to_vec`, `normalize_design`,
  `compute_action_cost`, `cyl_params` and `radii_only_ok`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import waves_jl_tpu as w
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.env import env_step as jax_env_step
from waves_jl_tpu.env import make_wave_env as jax_make_wave_env
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.control.mpc import compute_action_cost
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import cyl_params, make_env_step_fused, radii_only_ok

torch.set_num_threads(1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_env(n=64, steps=10):
    dim = tdims.two_dim(15.0, n, device="cpu")
    source = tsrc.GaussianSource.create(tdims.build_grid(dim), [[-10.0, -10.0]],
                                        [[-10.0, 10.0]], [0.3], [1.0], 1000.0)
    space = td.DesignSpace(td.NoDesign(), td.NoDesign())
    return tenv.make_wave_env(dim, space, source, resolution=(16, 16), integration_steps=steps,
                              actions=2)


def reset(env, seed=0):
    gen = torch.Generator().manual_seed(seed)
    state = tenv.env_reset(env, gen)
    return state, tenv.RandomDesignPolicy(env.action_space)(gen)


def test_no_design_env():
    env = port_env()
    assert env.action_space == td.DesignSpace(td.NoDesign(), td.NoDesign())
    state, action = reset(env)
    assert action == td.NoDesign() and state.design == td.NoDesign()
    state2, _ = tenv.env_step(env, state, action)
    sig = state2.signal.numpy()
    assert np.isfinite(sig).all() and sig[:, 0].max() > 0.0
    np.testing.assert_allclose(sig[:, 0], sig[:, 1], rtol=1e-6)  # tot == inc
    assert sig[:, 2].max() < 1e-10  # u_sc == 0


def test_no_design_fused_matches_plain():
    env = port_env(n=96, steps=10)
    assert not radii_only_ok(env.design_space)  # the general kernel K1
    state, action = reset(env)
    plain, _ = tenv.env_step(env, state, action)
    fused, _ = make_env_step_fused(env)(state, action)
    scale = max(float(plain.signal.abs().max()), 1e-30)
    assert float((plain.signal - fused.signal).abs().max()) < 1e-5 * scale
    assert fused.signal.shape == (11, 3) and float(fused.signal[:, 2].max()) == 0.0


def test_no_design_signal_matches_jax():
    n, steps = 64, 10
    jdim = w.two_dim(15.0, n)
    jsrc = w.GaussianSource.create(w.build_grid(jdim), jnp.array([[-10.0, -10.0]]),
                                   jnp.array([[-10.0, 10.0]]), jnp.array([0.3]),
                                   jnp.array([1.0]), 1000.0)
    je = jax_make_wave_env(jdim, w.DesignSpace(w.NoDesign(), w.NoDesign()), jsrc,
                           resolution=(16, 16), integration_steps=steps, actions=2)
    js = jax_env_reset(je, jax.random.PRNGKey(0))
    js, _ = jax_env_step(je, js, je.action_space.sample(jax.random.PRNGKey(1)))
    env = port_env(n, steps)
    state, action = reset(env)
    src = state.source  # the JAX draw's source shape
    src = tsrc.GaussianSource(src.grid, src.mu_low, src.mu_high, src.sigma, src.a,
                              torch.from_numpy(np.array(js.source.shape)), src.freq)
    state = tenv.EnvState(state.wave, state.design, src, state.signal, 0)
    for port, _ in (tenv.env_step(env, state, action), make_env_step_fused(env)(state, action)):
        assert rel(port.signal.numpy(), np.asarray(js.signal)) <= 1e-5
        assert rel(port.wave.numpy(), np.asarray(js.wave)) <= 1e-5


def test_empty_design_through_the_design_helpers():
    nd = td.NoDesign()
    space = td.build_action_space(nd, 0.25)
    assert space == td.DesignSpace(nd, nd)
    v = nd.to_vec(device="meta")
    assert v.shape == (0,) and v.dtype == torch.float32 and v.device.type == "meta"
    assert td.normalize_design(nd, space).shape == (0,)
    assert float(compute_action_cost(nd)) == 0.0
    cyl = cyl_params(nd, nd, "cpu")
    assert cyl.shape == (8, 0)
    cfg = fk.StepConfig(n=16, spacing=0.1, x_min=-0.75, dt=1e-5, c0=1531.0, freq=1000.0)
    owner = fk.select_owner(cyl, cfg)  # no cylinder owns a cell: c0 everywhere
    assert owner.shape == (5, 16, 16) and bool((owner[0] == 1e30).all())
