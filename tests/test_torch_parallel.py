"""The port's `parallel/` mesh and plain domain-decomposed FDTD
(`parallel/mesh.py`, `parallel/domain.py`) on the CPU:

* `make_mesh`: a mesh of named devices, one per shard; asking for more
  CUDA devices than exist raises, as does a mesh of mixed device types;
* `fd_dy_halo` on 1-8 slabs against the single-device one-sided/central
  stencil `fd_dy`: equal (the same float32 operations);
* `make_sharded_rollout` on 8 CPU shards against the JAX package's on its
  8-device virtual CPU mesh, N = 64, 40 steps, at the tolerances
  tests/test_parallel.py holds JAX's sharded rollout to against its
  single-device one (signal 2e-5 and state 1e-5 of their largest
  magnitude), with the design drawn in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.parallel import make_mesh as jax_make_mesh
from waves_jl_tpu.parallel import make_sharded_rollout as jax_make_sharded_rollout
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch.ops.fd import fd_dy
from waves_jl_tpu_torch.parallel import fd_dy_halo, make_mesh, make_sharded_rollout
from waves_jl_tpu_torch.parallel.domain import split_columns

torch.set_num_threads(1)
N = 64
C0 = float(w.WATER)
DT = 1e-5


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_make_mesh():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="one type"):
        make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(3, devices=["cpu", "cpu"])


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_fd_dy_halo_matches_single_device_stencil(shards):
    u = t(np.random.default_rng(shards).standard_normal((2, 16, N)))
    dy = 2.0 * 5.0 / (N - 1)
    slabs = split_columns(u, make_mesh(devices=["cpu"] * shards))
    assert [s.shape[-1] for s in slabs] == [N // shards] * shards
    got = torch.cat(fd_dy_halo(slabs, dy), dim=-1)
    torch.testing.assert_close(got, fd_dy(u, dy), rtol=0, atol=0)


def _port_cloak(jd):
    cy, core = jd.config.cylinders, jd.core
    return td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(t(cy.pos), t(cy.r), t(cy.c))),
                    td.Cylinders(t(core.pos), t(core.r), t(core.c)))


def test_sharded_rollout_matches_jax():
    dim = w.two_dim(5.0, N)
    grid = w.build_grid(dim)
    dyn = w.make_acoustic_dynamics_2d(dim, C0, 1.0, 20000.0)
    space = w.build_triple_ring_design_space()
    design = space.sample(jax.random.PRNGKey(0))
    d2 = space(design, w.build_action_space(design, 0.25).sample(jax.random.PRNGKey(1)))
    steps = 40
    tspan = w.build_tspan(0.0, DT, steps)
    shape = w.build_normal(grid, jnp.array([[0.0, 0.0]]), jnp.array([0.3]), jnp.array([1.0]))
    d_omega = float(w.get_dx(dim)) ** 2
    sy = jnp.asarray(np.asarray(dyn.pml).T)
    u0 = w.build_wave(dim, 12)

    jroll = jax_make_sharded_rollout(jax_make_mesh(8, axis_name="space"), C0, dyn.dx, dyn.dy,
                                     steps, DT, axis_name="space")
    interp = w.DesignInterpolator(design, d2, tspan[0], tspan[-1])
    uj, sj = jroll(u0, tspan, interp, grid, shape, jnp.float32(1000.0), dyn.pml, sy, dyn.bc,
                   jnp.float32(d_omega))
    uj, sj = np.asarray(uj), np.asarray(sj)

    ts = np.asarray(tspan)
    pinterp = td.DesignInterpolator(_port_cloak(design), _port_cloak(d2), float(ts[0]),
                                    float(ts[-1]))
    pgrid = tdims.build_grid(tdims.two_dim(5.0, N, device="cpu"))
    proll = make_sharded_rollout(make_mesh(devices=["cpu"] * 8), C0, float(dyn.dx),
                                 float(dyn.dy), steps, DT)
    up, sp = proll(t(u0), ts, pinterp, pgrid, t(shape), 1000.0, t(dyn.pml), t(sy), t(dyn.bc),
                   d_omega)
    assert up.shape == (12, N, N) and sp.shape == (steps + 1, 3)
    scale = np.abs(sj).max()
    assert scale > 0.0
    np.testing.assert_allclose(sp.numpy(), sj, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(up.numpy(), uj, rtol=0, atol=1e-5 * float(np.abs(uj).max()))
