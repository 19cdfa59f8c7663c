"""The port's tree arithmetic, grids by spacing, finite-difference
operators, field metrics and design helpers against the JAX package on the
same numpy-made inputs:

- `tree_add`, `tree_sub`, `tree_mul`, `tree_scale`, `tree_lerp`,
  `tree_concat` and the designs' `+ - * /` and `zero()`: 1e-6 relative;
- `one_dim_spacing`/`two_dim_spacing`: the point count and every point
  bit for bit JAX's (its `jnp.arange` with a float step is numpy's float32
  arange), `build_wave` zeros of JAX's shape;
- `laplacian_matrix` (its dx^3 boundary rows included), `fd_grad_1d`,
  `divergence`, `fd_d`: 1e-6 relative;
- `circle_mask`, `displacement`, `energy` equal; `flux` 1e-4 relative, the
  bound `tests/test_parity_extras.py` holds JAX's to;
- `location_mask` equal, `design_to_circles`, `multi_design_interpolation`
  inside and outside the windows, and the simple and rectangular design
  spaces at 1e-6; `radii_only_ok` picks the radii-only kernel (K2) for
  both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu import designs as jd
from waves_jl_tpu import dims as jdims
from waves_jl_tpu.ops import fd as jfd
from waves_jl_tpu.ops import metrics as jmetrics
from waves_jl_tpu.physics.fused import radii_only_ok as jax_radii_only_ok
from waves_jl_tpu.utils import trees as jtrees
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch.ops import fd as tfd
from waves_jl_tpu_torch.ops import metrics as tmetrics
from waves_jl_tpu_torch.physics.fused import radii_only_ok
from waves_jl_tpu_torch.utils import trees as ttrees

torch.set_num_threads(1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def cloaks(seed: int):
    """Two triple-ring cloaks with numpy-drawn leaves: (jax, port) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        pos, r, c = (rng.standard_normal(s).astype(np.float32) for s in ((18, 2), (18,), (18,)))
        core = [rng.standard_normal(s).astype(np.float32) for s in ((1, 2), (1,), (1,))]
        jring = w.AdjustableRadiiScatterers(w.Cylinders(*map(jnp.asarray, (pos, r, c))))
        out.append((w.Cloak(jring, w.Cylinders(*map(jnp.asarray, core))),
                    td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(t(pos), t(r), t(c))),
                             td.Cylinders(*map(t, core)))))
    return out


def leaves_close(jtree, ptree, tol=1e-6):
    jl = jax.tree_util.tree_leaves(jtree)
    pl = ttrees.tree_leaves(ptree)
    assert len(jl) == len(pl)
    for a, b in zip(pl, jl):
        assert a.shape == tuple(b.shape)
        assert rel(a.numpy(), b) <= tol


@pytest.mark.parametrize("op", ["add", "sub", "mul", "scale", "lerp", "concat"])
def test_tree_arithmetic_matches_jax(op):
    (ja, pa), (jb, pb) = cloaks(0)
    jax_fn = {"add": lambda: jtrees.tree_add(ja, jb), "sub": lambda: jtrees.tree_sub(ja, jb),
              "mul": lambda: jtrees.tree_mul(ja, jb), "scale": lambda: jtrees.tree_scale(ja, 0.37),
              "lerp": lambda: jtrees.tree_lerp(ja, jb, 0.29),
              "concat": lambda: jtrees.tree_concat([ja, jb], axis=0)}[op]
    port_fn = {"add": lambda: ttrees.tree_add(pa, pb), "sub": lambda: ttrees.tree_sub(pa, pb),
               "mul": lambda: ttrees.tree_mul(pa, pb),
               "scale": lambda: ttrees.tree_scale(pa, 0.37),
               "lerp": lambda: ttrees.tree_lerp(pa, pb, 0.29),
               "concat": lambda: ttrees.tree_concat([pa, pb], dim=0)}[op]
    leaves_close(jax_fn(), port_fn())


@pytest.mark.parametrize("expr", ["d + e", "d - e", "d * e", "2.5 * d", "d * 2.5", "d / 4.0",
                                  "d + 1.5", "1.5 + d", "d - 0.5", "d.zero()"])
def test_design_algebra_matches_jax(expr):
    (jdd, pd), (je, pe) = cloaks(1)
    leaves_close(eval(expr, {"d": jdd, "e": je}), eval(expr, {"d": pd, "e": pe}))


@pytest.mark.parametrize("grid_size,delta", [(15.0, 0.1), (15.0, 0.3), (1.0, 0.07), (2.5, 0.5),
                                             (10.0, 1.0 / 3.0)])
def test_spacing_grids_are_jax_points(grid_size, delta):
    j1, p1 = jdims.one_dim_spacing(grid_size, delta), tdims.one_dim_spacing(grid_size, delta,
                                                                            device="cpu")
    j2, p2 = jdims.two_dim_spacing(grid_size, delta), tdims.two_dim_spacing(grid_size, delta,
                                                                            device="cpu")
    for pa, ja in ((p1.x, j1.x), (p2.x, j2.x), (p2.y, j2.y)):
        assert pa.dtype == torch.float32 and pa.shape == ja.shape
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    for jdim, pdim in ((j1, p1), (j2, p2)):
        wave = tdims.build_wave(pdim, 3)
        assert wave.shape == jdims.build_wave(jdim, 3).shape and not wave.any()


@pytest.mark.parametrize("n", [5, 48, 131])
def test_laplacian_matrix_matches_jax(n):
    x = np.linspace(-15.0, 15.0, n).astype(np.float32)
    got, want = tfd.laplacian_matrix(t(x)).numpy(), np.asarray(jfd.laplacian_matrix(jnp.asarray(x)))
    assert rel(got, want) <= 1e-6
    dx = (x[-1] - x[0]) / (n - 1)
    # the ends divide by dx^3, as the reference does (sic)
    assert abs(got[0, 0] * dx**3 - 2.0) < 1e-4 and abs(got[1, 1] * dx**2 + 2.0) < 1e-4


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_fd_derivatives_match_jax(axis):
    rng = np.random.default_rng(2)
    u = rng.standard_normal((7, 9, 11)).astype(np.float32)
    assert rel(tfd.fd_d(t(u), 0.3, axis).numpy(),
               np.asarray(jfd.fd_d(jnp.asarray(u), 0.3, axis))) <= 1e-6
    assert rel(tfd.fd_grad_1d(t(u), 0.3, axis).numpy(),
               np.asarray(jfd.fd_grad_1d(jnp.asarray(u), 0.3, axis))) <= 1e-6
    if axis == -1:
        x = np.linspace(-1.0, 1.0, 11).astype(np.float32)
        mat = tfd.gradient_matrix(t(x))
        got = tfd.fd_grad_1d(t(u), (x[-1] - x[0]) / 10).numpy()
        assert rel(got, (t(u) @ mat.T).numpy()) <= 1e-5
    assert rel(tfd.divergence(t(u), 0.3, 0.7).numpy(),
               np.asarray(jfd.divergence(jnp.asarray(u), 0.3, 0.7))) <= 1e-6


@pytest.mark.parametrize("n,radius", [(48, 2.0), (64, 5.5)])
def test_metrics_match_jax(n, radius):
    jdim, pdim = w.two_dim(15.0, n), tdims.two_dim(15.0, n, device="cpu")
    mask_j, mask_p = jmetrics.circle_mask(jdim, radius), tmetrics.circle_mask(pdim, radius)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    rng = np.random.default_rng(n)
    wave = rng.standard_normal((12, n, n)).astype(np.float32)
    np.testing.assert_array_equal(tmetrics.displacement(t(wave)).numpy(), wave[0])
    np.testing.assert_array_equal(tmetrics.energy(t(wave[0])).numpy(),
                                  np.asarray(jmetrics.energy(jnp.asarray(wave[0]))))
    lap_j, lap_p = jmetrics.laplacian_matrix(jdim.x), tmetrics.laplacian_matrix(pdim.x)
    u = wave[3]
    want = float(jmetrics.flux(jnp.asarray(u), lap_j, mask_j.astype(jnp.float32)))
    got = tmetrics.flux(t(u), lap_p, mask_p.float())
    assert got.shape == () and abs(float(got) - want) <= 1e-4 * abs(want)
    # a batch of fields: one flux each
    batch = tmetrics.flux(t(wave[:3]), lap_p, mask_p.float())
    assert batch.shape == (3,) and float(batch[0]) == float(tmetrics.flux(t(wave[0]), lap_p,
                                                                          mask_p.float()))


def test_location_mask_and_circles_match_jax():
    (jdd, pd), _ = cloaks(3)
    grid = np.asarray(w.build_grid(w.two_dim(15.0, 40)))
    jc = jd.stack_cylinders(jdd.config.cylinders, jdd.core)
    pc = td.design_cylinders(pd)
    jc = w.Cylinders(jc.pos * 5.0, jnp.abs(jc.r) * 2.0, jc.c)
    pc = td.Cylinders(pc.pos * 5.0, pc.r.abs() * 2.0, pc.c)
    mask = td.location_mask(pc, t(grid))
    assert mask.shape == (40, 40, 19) and int(mask.sum()) > 0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jd.location_mask(jc, jnp.asarray(grid))))
    got, want = td.design_to_circles(pd), jd.design_to_circles(jdd)
    assert len(got) == len(want) == 19
    assert rel(np.array(got), np.array(want)) <= 1e-6
    assert td.design_to_circles(td.NoDesign()) == [] and td.design_to_circles(None) == []


@pytest.mark.parametrize("tq", [0.0, 0.4e-3, 1.0e-3, 1.7e-3, 2.0e-3, -1.0e-3, 3.5e-3])
def test_multi_design_interpolation_matches_jax(tq):
    (ja, pa), (jb, pb) = cloaks(4)
    (jc, pc), _ = cloaks(5)
    jin = [jd.DesignInterpolator(ja, jb, jnp.float32(0.0), jnp.float32(1e-3)),
           jd.DesignInterpolator(jb, jc, jnp.float32(1e-3), jnp.float32(2e-3))]
    pin = [td.DesignInterpolator(pa, pb, 0.0, 1e-3), td.DesignInterpolator(pb, pc, 1e-3, 2e-3)]
    leaves_close(jd.multi_design_interpolation(jin, jnp.float32(tq)),
                 td.multi_design_interpolation(pin, tq))


@pytest.mark.parametrize("which", ["simple", "rectangular"])
def test_design_spaces_match_jax_and_take_radii_only(which):
    if which == "simple":
        js, ps = jd.build_simple_radii_design_space(), td.build_simple_radii_design_space("cpu")
    else:
        js, ps = (jd.build_rectangular_grid_design_space(),
                  td.build_rectangular_grid_design_space("cpu"))
        np.testing.assert_allclose(td.build_rectangular_grid(3, 4, 0.7, "cpu").numpy(),
                                   np.asarray(jd.build_rectangular_grid(3, 4, 0.7)), rtol=1e-6,
                                   atol=1e-6)
    leaves_close(js.low, ps.low)
    leaves_close(js.high, ps.high)
    # K2 (radii-only, with its owner pass) for both: fixed positions and
    # speeds, circles disjoint at their largest radii
    assert radii_only_ok(ps) and jax_radii_only_ok(js)
