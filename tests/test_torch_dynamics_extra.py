"""The port's 3-D grid and dynamics, the extra dynamics, `NoSource` and
`PolynomialInterpolation` against the JAX package, on the CPU.

Every comparison is held to 1e-5 relative on the same numpy inputs:
`three_dim`, `build_grid`, `build_dirichlet`, `build_pml` and `get_dz`;
`acoustic_rhs_3d` and a 20-step RK4 rollout of `AcousticDynamics3D` at
n = 12; the pandemic and wildfire right-hand sides and 10-step rollouts;
`PolynomialInterpolation` away from and at its knots. The JAX 3-D smoke's
properties (`tests/test_dynamics.py::test_acoustic_3d_smoke`: finite, the
scattered field zero when both stacks share the ambient speed, Dirichlet
faces zero, the PML taking energy out) hold for the port at n = 32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.physics.extra import make_pandemic_dynamics as jax_make_pandemic
from waves_jl_tpu.physics.extra import make_wildfire_dynamics as jax_make_wildfire
from waves_jl_tpu.utils.interp import PolynomialInterpolation as JaxPolynomialInterpolation
import waves_jl_tpu_torch as tw
from waves_jl_tpu_torch.physics.extra import make_pandemic_dynamics, make_wildfire_dynamics
from waves_jl_tpu_torch.utils.interp import PolynomialInterpolation

torch.set_num_threads(1)
TOL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_three_dim_grid_mask_pml_and_spacing_match_jax():
    jd, pd = w.three_dim(5.0, 12), tw.three_dim(5.0, 12, device="cpu")
    assert pd.shape == jd.shape == (12, 12, 12)
    for a, b in ((pd.x, jd.x), (pd.y, jd.y), (pd.z, jd.z)):
        assert rel(a.numpy(), b) <= TOL
    g = tw.build_grid(pd)
    assert g.shape == (12, 12, 12, 3)
    assert rel(g.numpy(), w.build_grid(jd)) <= TOL
    np.testing.assert_array_equal(tw.build_dirichlet(pd).numpy(), np.asarray(w.build_dirichlet(jd)))
    assert tw.build_wave(pd, 16).shape == (16, 12, 12, 12)
    prof = tw.build_pml(pd, 1.0, 20000.0)
    assert prof.shape == (12,)
    assert rel(prof.numpy(), w.build_pml(jd, 1.0, 20000.0)) <= TOL
    assert rel(tw.get_dz(pd).numpy(), w.get_dz(jd)) <= TOL


def _waves_3d(n: int, seed: int) -> np.ndarray:
    """A smooth (16, n, n, n) state whose total and incident stacks differ."""
    x = np.linspace(-5.0, 5.0, n, dtype=np.float32)
    rng = np.random.default_rng(seed)
    u = np.zeros((16, n, n, n), np.float32)
    for ch in range(16):
        c = rng.uniform(-2.0, 2.0, 3)
        u[ch] = 1e-2 * np.exp(-((x[:, None, None] - c[0]) ** 2 + (x[None, :, None] - c[1]) ** 2
                                + (x[None, None, :] - c[2]) ** 2) / 4.0)
    return u


def _theta_3d(n: int):
    """(C, F) in both packages: a speed field over the grid and a Gaussian
    source at the origin at 1 kHz."""
    x = np.linspace(-5.0, 5.0, n, dtype=np.float32)
    r2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
    c = (w.WATER * (1.0 + 0.5 * np.exp(-r2 / 2.0))).astype(np.float32)
    shape = np.exp(-r2 / (2.0 * 0.5**2)).astype(np.float32)
    jth = (lambda s: jnp.asarray(c), lambda s: jnp.asarray(shape) * jnp.sin(2.0 * jnp.pi * 1000.0 * s))
    pth = (lambda s: t(c), lambda s: t(shape) * torch.sin(torch.tensor(2.0 * np.pi * 1000.0) * s))
    return jth, pth


def test_acoustic_rhs_3d_and_rollout_match_jax():
    n = 12
    jdyn = w.make_acoustic_dynamics_3d(w.three_dim(5.0, n), w.WATER, 1.0, 20000.0)
    pdyn = tw.make_acoustic_dynamics_3d(tw.three_dim(5.0, n, device="cpu"), w.WATER, 1.0,
                                        20000.0)
    u = _waves_3d(n, 0)
    jth, pth = _theta_3d(n)
    want = np.asarray(jdyn(jnp.asarray(u), jnp.float32(2e-4), jth))
    got = pdyn(t(u), torch.tensor(2e-4), pth)
    assert got.shape == (16, n, n, n)
    assert rel(got.numpy(), want) <= TOL
    tspan = w.build_tspan(0.0, 1e-5, 20)
    jtraj = np.asarray(jax.jit(lambda v: w.Integrator(dynamics=jdyn, dt=1e-5)(v, tspan, jth))(
        jnp.asarray(u)))
    ptraj = tw.Integrator(dynamics=pdyn, dt=1e-5)(t(u), tw.build_tspan(0.0, 1e-5, 20), pth)
    assert ptraj.shape == (21, 16, n, n, n)
    assert rel(ptraj.numpy(), jtraj) <= TOL


def test_acoustic_3d_smoke_properties():
    n = 32
    dim = tw.three_dim(5.0, n, device="cpu")
    dyn = tw.make_acoustic_dynamics_3d(dim, tw.WATER, 1.0, 20000.0)
    shape = torch.exp(-(tw.build_grid(dim) ** 2).sum(-1) / (2.0 * 0.3**2))
    theta = (lambda s: torch.tensor(tw.WATER, dtype=torch.float32),
             lambda s: shape * torch.sin(torch.tensor(2.0 * np.pi * 1000.0) * s))
    traj = tw.Integrator(dynamics=dyn, dt=1e-5)(tw.build_wave(dim, 16),
                                                tw.build_tspan(0.0, 1e-5, 120), theta).numpy()
    assert traj.shape == (121, 16, n, n, n) and np.isfinite(traj).all()
    np.testing.assert_allclose(traj[:, 0], traj[:, 8], atol=1e-6)  # no scattered field
    assert (traj[:, 0, 0] == 0).all() and (traj[:, 0, :, :, 0] == 0).all()  # Dirichlet faces
    e = (traj[:, 0] ** 2).sum(axis=(1, 2, 3))
    assert e.max() > 0 and e[-1] < 0.8 * e.max()


def _rollout_pair(jdyn, pdyn, u0, jth, pth, dt, steps):
    tspan = w.build_tspan(0.0, dt, steps)
    want = np.asarray(jax.jit(lambda v: w.Integrator(dynamics=jdyn, dt=dt)(v, tspan, jth))(
        jnp.asarray(u0)))
    got = tw.Integrator(dynamics=pdyn, dt=dt)(t(u0), tw.build_tspan(0.0, dt, steps), pth)
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["pandemic", "wildfire"])
def test_extra_dynamics_match_jax(kind):
    n = 32
    rng = np.random.default_rng(1)
    if kind == "pandemic":
        jdim, pdim = w.two_dim(5.0, n), tw.two_dim(5.0, n, device="cpu")
        jdyn, pdyn = jax_make_pandemic(jdim), make_pandemic_dynamics(pdim)
        shape = np.asarray(w.build_normal(w.build_grid(jdim), jnp.array([[0.0, 0.0]]),
                                          jnp.array([0.3]), jnp.array([1.0])))
        jth = (w.Source(shape=jnp.asarray(shape), freq=jnp.float32(1000.0)),)
        pth = (tw.Source(shape=t(shape), freq=torch.tensor(1000.0)),)
        u0 = (rng.standard_normal((3, n, n)) * 1e-3).astype(np.float32)
        dt, s = 1e-5, np.float32(2.5e-4)
    else:
        jdim, pdim = w.two_dim(100.0, n), tw.two_dim(100.0, n, device="cpu")
        jdyn, pdyn = jax_make_wildfire(jdim), make_wildfire_dynamics(pdim)
        jth = pth = ()
        x = np.linspace(-100.0, 100.0, n, dtype=np.float32)
        hot = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2.0 * 20.0**2))
        u0 = np.stack([298.15 + 600.0 * hot, 1.0 - 0.1 * rng.random((n, n))]).astype(np.float32)
        dt, s = 1e-3, np.float32(0.0)
    want = np.asarray(jdyn(jnp.asarray(u0), jnp.float32(s), jth))
    got = pdyn(t(u0), torch.tensor(s), pth)
    assert got.shape == u0.shape and rel(got.numpy(), want) <= TOL
    got, want = _rollout_pair(jdyn, pdyn, u0, jth, pth, dt, 10)
    assert got.shape == (11, *u0.shape) and np.isfinite(got).all()
    assert rel(got, want) <= TOL


def test_no_source_is_zero():
    f = tw.NoSource()(torch.tensor(1e-3))
    assert f.dtype == torch.float32 and f.shape == () and float(f) == 0.0
    assert float(w.NoSource()(jnp.float32(1e-3))) == float(f)
    u = torch.ones(3, 4)
    torch.testing.assert_close(u + f, u, rtol=0, atol=0)


def test_polynomial_interpolation_matches_jax():
    B, K, E = 3, 5, 7
    rng = np.random.default_rng(2)
    X = np.sort(rng.uniform(-1.0, 1.0, (B, K)), axis=1).astype(np.float32)
    Y = rng.standard_normal((B, K, E)).astype(np.float32)
    jinterp = JaxPolynomialInterpolation(jnp.asarray(X), jnp.asarray(Y))
    pinterp = PolynomialInterpolation(t(X), t(Y))
    for s in (rng.uniform(-1.0, 1.0, B).astype(np.float32), X[:, 2]):
        want = np.asarray(jinterp(jnp.asarray(s)))
        got = pinterp(t(s))
        assert got.shape == (B, E) and rel(got.numpy(), want) <= TOL
    # the 1e-5 offsets keep it near, not at, the knot values
    np.testing.assert_allclose(pinterp(t(X[:, 2])).numpy(), Y[:, 2], rtol=2e-3, atol=2e-3)
