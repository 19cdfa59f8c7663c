"""The port's grids, operators, PML, sources, designs, interpolation and
plain dynamics held against the JAX package and the golden NumPy
equations on the same numpy inputs. Tolerance: 1e-5 relative to the
largest magnitude unless a test says otherwise (float32 throughout; the
two frameworks round a few operations apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
import golden_numpy as g
from waves_jl_tpu.designs import cylinders_speed as jax_cylinders_speed
from waves_jl_tpu.physics.fused import cyl_params as jax_cyl_params
from waves_jl_tpu.physics.fused import radii_only_ok as jax_radii_only_ok
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.ops import fd as tfd
from waves_jl_tpu_torch.ops.pml import build_pml
from waves_jl_tpu_torch.physics import dynamics as tdyn
from waves_jl_tpu_torch.physics.fused import cyl_params, radii_only_ok
from waves_jl_tpu_torch.utils.interp import linear_interp

torch.set_num_threads(1)
REL = 1e-5


def close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdims.two_dim(15.0, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.build_triple_ring_design_space()


@pytest.mark.parametrize("n", [17, 64])
def test_dims_grid_and_dirichlet(n):
    jd = w.two_dim(15.0, n)
    pd = tdims.two_dim(15.0, n, device="cpu")
    close(pd.x.numpy(), np.asarray(jd.x), 1e-6)
    close(tdims.build_grid(pd).numpy(), np.asarray(w.build_grid(jd)), 1e-6)
    np.testing.assert_array_equal(tdims.build_dirichlet(pd).numpy(), g.dirichlet_2d_np(n, n))
    close(float(tdims.get_dx(pd)), float(w.get_dx(jd)), 1e-6)


@pytest.mark.parametrize("n", [16, 33])
def test_gradient_matrix_and_stencils(n):
    x = np.linspace(-3.0, 3.0, n).astype(np.float32)
    gm = tfd.gradient_matrix(t(x)).numpy()
    close(gm, g.gradient_matrix_np(x))
    close(gm, np.asarray(w.gradient_matrix(jnp.asarray(x))))
    rng = np.random.default_rng(n)
    u = rng.standard_normal((3, n, n + 2)).astype(np.float32)
    dx = 0.37
    close(tfd.fd_dx(t(u), dx).numpy(), np.asarray(w.fd_dx(jnp.asarray(u), dx)))
    close(tfd.fd_dy(t(u), dx).numpy(), np.asarray(w.fd_dy(jnp.asarray(u), dx)))
    # the kernel's edge-aware form computes the same derivative
    close(tfd.dx_edge_aware(t(u), 1.0 / (2.0 * dx)).numpy(), np.asarray(w.fd_dx(jnp.asarray(u), dx)))
    close(tfd.dy_edge_aware(t(u), 1.0 / (2.0 * dx)).numpy(), np.asarray(w.fd_dy(jnp.asarray(u), dx)))


def test_pml_profiles():
    n = 64
    pd = tdims.two_dim(15.0, n, device="cpu")
    p2 = build_pml(pd, 2.0, 20000.0).numpy()
    close(p2, np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0)))
    close(p2, g.build_pml_2d_np(pd.x.numpy(), n, 2.0, 20000.0))
    od = tdims.one_dim(100.0, 128, device="cpu")
    p1 = build_pml(od, 10.0, 10000.0).numpy()
    close(p1, np.asarray(w.build_pml(w.one_dim(100.0, 128), 10.0, 10000.0)))
    close(p1, g.build_pml_1d_np(od.x.numpy(), 10.0, 10000.0))


def test_gaussian_source_create_resample_and_modulation():
    n = 48
    jgrid = w.build_grid(w.two_dim(15.0, n))
    pgrid = tdims.build_grid(tdims.two_dim(15.0, n, device="cpu"))
    args = ([[-10.0, -10.0]], [[-10.0, 10.0]], [0.3 * 8], [1.0], 1000.0)
    js = w.GaussianSource.create(jgrid, *[jnp.asarray(a) for a in args[:4]], args[4])
    ps = tsrc.GaussianSource.create(pgrid, *args)
    close(ps.shape.numpy(), np.asarray(js.shape))
    mu = np.array([[-10.0, 3.7]], np.float32)
    close(ps.with_center(t(mu)).shape.numpy(),
          np.asarray(w.build_normal(jgrid, jnp.asarray(mu), js.sigma, js.a)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):  # the centre redraws inside [mu_low, mu_high]
        s = ps.resample(gen)
        peak = np.unravel_index(np.argmax(s.shape.numpy()), s.shape.shape)
        assert abs(pgrid[peak][0].item() + 10.0) < 0.7 and abs(pgrid[peak][1].item()) <= 10.7
    tt = np.float32(3.3e-4)
    close(ps(tt).numpy(), np.asarray(js(jnp.float32(tt))))


def _jax_ring_design(r):
    space = w.build_triple_ring_design_space()
    lo = space.low
    return w.Cloak(w.AdjustableRadiiScatterers(
        w.Cylinders(lo.config.cylinders.pos, jnp.asarray(r), lo.config.cylinders.c)), lo.core)


def _port_ring_design(space, r):
    lo = space.low
    return td.Cloak(td.AdjustableRadiiScatterers(
        td.Cylinders(lo.config.cylinders.pos, t(r), lo.config.cylinders.c)), lo.core)


def test_triple_ring_space_clamp_sample_and_action_space():
    jsp = w.build_triple_ring_design_space()
    psp = td.build_triple_ring_design_space(device="cpu")
    close(psp.low.config.cylinders.pos.numpy(), np.asarray(jsp.low.config.cylinders.pos), 1e-6)
    for a, b in [(psp.low.to_vec(), jsp.low.to_vec()), (psp.high.to_vec(), jsp.high.to_vec())]:
        close(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(1)
    r = rng.uniform(0.2, 1.0, 18).astype(np.float32)
    da = rng.uniform(-0.5, 0.5, 18).astype(np.float32)
    jd, pd = _jax_ring_design(r), _port_ring_design(psp, r)
    jact = w.build_action_space(jsp.low, 0.25)
    pact = td.build_action_space(psp.low, 0.25)
    close(pact.high.to_vec().numpy(), np.asarray(jact.high.to_vec()))
    jz = jax.tree_util.tree_map(jnp.zeros_like, jsp.low)
    ja = w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(jz.config.cylinders.pos, jnp.asarray(da),
                                                         jz.config.cylinders.c)), jz.core)
    pa = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        torch.zeros(18, 2), t(da), torch.zeros(18))), td.Cylinders(torch.zeros(1, 2), torch.zeros(1),
                                                                    torch.zeros(1)))
    close(psp(pd, pa).to_vec().numpy(), np.asarray(jsp(jd, ja).to_vec()))
    close(td.normalize_design(psp(pd, pa), psp).numpy(),
          np.asarray(w.normalize_design(jsp(jd, ja), jsp)))
    # draws stay inside the box, with batch dimensions on every leaf
    s = pact.sample(torch.Generator().manual_seed(0), batch=(4, 3))
    assert s.config.cylinders.r.shape == (4, 3, 18) and s.core.pos.shape == (4, 3, 1, 2)
    assert float(s.config.cylinders.r.abs().max()) <= 0.25
    assert float(s.core.r.abs().max()) == 0.0 and float(s.config.cylinders.pos.abs().max()) == 0.0
    assert s.to_vec().shape == (4, 3, 18)


def test_rasterization_cyl_params_and_radii_only():
    n = 96
    jsp = w.build_triple_ring_design_space()
    psp = td.build_triple_ring_design_space(device="cpu")
    rng = np.random.default_rng(2)
    r1, r2 = (rng.uniform(0.2, 1.0, 18).astype(np.float32) for _ in range(2))
    jd1, jd2 = _jax_ring_design(r1), _jax_ring_design(r2)
    pd1, pd2 = _port_ring_design(psp, r1), _port_ring_design(psp, r2)
    close(cyl_params(pd1, pd2, "cpu").numpy(), np.asarray(jax_cyl_params(jd1, jd2)), 1e-6)
    assert radii_only_ok(psp) and jax_radii_only_ok(jsp)
    jgrid = w.build_grid(w.two_dim(15.0, n))
    pgrid = tdims.build_grid(tdims.two_dim(15.0, n, device="cpu"))
    pc = td.speed(pd1, pgrid, 1531.0).numpy()
    jc = np.asarray(w.speed(jd1, jgrid, 1531.0))
    assert (pc != 1531.0).sum() > 20  # the cylinders cover cells at this size
    close(pc, jc)
    # overlapping cylinders sum their speeds
    cyls = td.Cylinders(t([[0.0, 0.0], [0.5, 0.0]]), t([2.0, 2.0]), t([100.0, 200.0]))
    jc2 = w.Cylinders(jnp.asarray([[0.0, 0.0], [0.5, 0.0]]), jnp.asarray([2.0, 2.0]),
                      jnp.asarray([100.0, 200.0]))
    sp = td.cylinders_speed(cyls, pgrid, 1531.0).numpy()
    assert (sp == 300.0).sum() > 0
    close(sp, np.asarray(jax_cylinders_speed(jc2, jgrid, 1531.0)))
    moving = td.DesignSpace(td.AdjustablePositionScatterers(cyls),
                            td.AdjustablePositionScatterers(td.Cylinders(cyls.pos + 1.0, cyls.r,
                                                                         cyls.c)))
    assert not radii_only_ok(moving)


def test_linear_interp():
    rng = np.random.default_rng(3)
    X = np.cumsum(rng.uniform(0.1, 1.0, (4, 6)), axis=1).astype(np.float32)
    Y = rng.standard_normal((4, 6, 7)).astype(np.float32)
    for tt in [X[:, 0], X[:, -1], X[:, 2] + 0.05, X[:, -1] + 1.0, X[:, 0] - 1.0]:
        tt = tt.astype(np.float32)
        close(linear_interp(t(X), t(Y), t(tt)).numpy(),
              np.asarray(w.linear_interp(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(tt))))


def test_acoustic_rhs_and_rk4_against_golden():
    n = 24
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((12, n, n)) * 1e-2).astype(np.float32)
    pd = tdims.two_dim(15.0, n, device="cpu")
    dyn = tdyn.make_acoustic_dynamics_2d(pd, 1531.0, 2.0, 20000.0)
    c = rng.uniform(1000.0, 2000.0, (n, n)).astype(np.float32)
    f = rng.standard_normal((n, n)).astype(np.float32)
    got = dyn(t(x), 0.0, (lambda _t: t(c), lambda _t: t(f))).numpy()
    G = g.gradient_matrix_np(pd.x.numpy())
    want = g.acoustic_rhs_12ch_np(np.moveaxis(x, 0, -1), c, 1531.0, f, G, dyn.pml.numpy(),
                                  dyn.bc.numpy())
    close(got, np.moveaxis(want, -1, 0), 1e-4)  # golden uses dense matmuls: other rounding
    integ = tdyn.Integrator(dynamics=dyn, dt=1e-5)
    theta = (lambda _t: t(c), lambda _t: t(f) * 0.0)
    traj = integ(t(x), tdyn.build_tspan(0.0, 1e-5, 3), theta).numpy()
    ref = g.rk4_rollout_2d_np(np.moveaxis(x, 0, -1), np.arange(4) * 1e-5,
                              lambda u, _t: g.acoustic_rhs_12ch_np(u, c, 1531.0, f * 0.0, G,
                                                                   dyn.pml.numpy(), dyn.bc.numpy()),
                              1e-5)
    close(traj, np.moveaxis(ref, -1, 1))
    close(tdyn.build_tspan(2e-3, 1e-5, 100), np.asarray(w.build_tspan(2e-3, 1e-5, 100)), 1e-6)


def test_latent_dynamics_1d_against_jax():
    E, B = 64, 3
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, 4, E)) * 0.1).astype(np.float32)
    c = rng.uniform(0.5, 1.5, (B, E)).astype(np.float32)
    f = rng.standard_normal((B, E)).astype(np.float32)
    pml = rng.uniform(0.0, 1.0, (B, E)).astype(np.float32)
    jdyn = w.make_acoustic_dynamics_1d(w.one_dim(100.0, E), 1531.0, 10.0, 10000.0)
    pdyn = tdyn.make_acoustic_dynamics_1d(tdims.one_dim(100.0, E, device="cpu"), 1531.0, 10.0, 10000.0)
    jtheta = (lambda _t: jnp.asarray(c), lambda _t: jnp.asarray(f), jnp.asarray(pml))
    ptheta = (lambda _t: t(c), lambda _t: t(f), t(pml))
    close(pdyn(t(x), 0.0, ptheta).numpy(), np.asarray(jdyn(jnp.asarray(x), 0.0, jtheta)))
    G = g.gradient_matrix_np(np.asarray(w.one_dim(100.0, E).x))
    sigma = float(pdyn.pml[0]) * pml[0]
    want = g.acoustic_rhs_1d_np(x[0].T, c[0], f[0], sigma, 1531.0, G, pdyn.bc.numpy())
    close(pdyn(t(x), 0.0, ptheta).numpy()[0], want.T, 1e-4)
