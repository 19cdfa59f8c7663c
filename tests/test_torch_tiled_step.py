"""The one-launch step's tile decomposition, checked on the CPU.

`rk4_step_tiled` (csrc/fused_rk4.cu), K5 radii-only in one launch a step,
computes each tile's step from the tile and a 4-cell halo, the four stages
on regions that shrink by one cell a side a stage but not at the domain's
edges, and one more halo cell before a one-cell tile on the last row or
column. `fused_rk4_step_tiled_reference` decomposes the step the same way
in plain PyTorch; here it is held:

* against the whole-grid plain step `fused_rk4_step_reference(...,
  x_matmul=True)`, bit for bit on the state, at n = 45 and 48 with the
  kernel's 16 x 24 tiles and with tiles that leave partial and one-cell
  tiles on the domain's edges, one state and K = 3 candidates; energies
  within 1e-6 (the tiles' partial sums add in another order);
* against the Pallas kernel in interpret mode with `x_matmul=True,
  radii_only=True`, two steps a call, within 2e-7 on the state and 1e-6 on
  the energies, the tolerances of tests/test_torch_xmatmul.py.

A halo too thin, a stage region too wide, or a one-sided edge stencil read
outside its region shows here as differing cells. The CUDA kernel runs
only on a card: tests/test_torch_gpu.py holds it against the plain version
there, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import _cyl, rel, t

import waves_jl_tpu as w
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
STATE_TOL, ENERGY_TOL = 2e-7, 1e-6
T0, TI, TF = 2e-4, 0.0, 1e-3  # a mid-window lerp weight


def _inputs(n, k=None, seed=0):
    """(cfg, u, shape, prof, cyl, owner): one state (12, n, n) for k None,
    else k candidates, each with its own state and radii."""
    rng = np.random.default_rng(seed + n)
    spacing = 2.0 * 15.0 / (n - 1)
    cfg = fk.StepConfig(n=n, spacing=spacing, x_min=-15.0, dt=1e-5, c0=1531.0, freq=1000.0)
    grid = w.build_grid(w.two_dim(15.0, n))
    shape = np.asarray(w.build_normal(grid, jnp.array([[-3.0, 2.0]]), jnp.array([2.4]),
                                      jnp.array([1.0])))
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    cyl = _cyl(moving=False)
    lead = () if k is None else (k,)
    u = (rng.standard_normal((*lead, 12, n, n)) * 1e-3).astype(np.float32)
    if k is not None:
        cyl = np.repeat(cyl[None], k, axis=0)
        cyl[:, [2, 6]] *= rng.uniform(0.7, 1.0, (k, 1, cyl.shape[-1])).astype(np.float32)
    cyl = t(cyl)
    owner = (fk.select_owner_reference(cyl, cfg) if k is None
             else fk.select_owner_batched_reference(cyl, cfg))
    return cfg, t(u), t(shape), t(pml[:, 0]), cyl, owner


# n, tile: 45 leaves partial tiles on both axes with the kernel's tile and a
# one-row edge tile with 11 rows (45 = 4 x 11 + 1); 48 a one-column edge
# tile with 47 columns and partial tiles with 13 x 10
CASES = [(45, fk.TILE), (45, (11, 7)), (48, (7, 47)), (48, (13, 10))]


@pytest.mark.parametrize("n,tile", CASES)
def test_tiled_step_equals_whole_grid_plain_step(n, tile):
    cfg, u, shape, prof, cyl, owner = _inputs(n)
    got, want = (u, None), (u, None)
    for t0 in (T0, T0 + cfg.dt):  # two chained steps
        got = fk.fused_rk4_step_tiled_reference(got[0], shape, prof, owner, t0, TI, TF, cfg, tile)
        want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, owner, t0, TI, TF, cfg,
                                           x_matmul=True)
    assert got[0].shape == (12, n, n) and got[1].shape == (3,)
    assert torch.equal(got[0], want[0])
    assert rel(got[1].numpy(), want[1].numpy()) <= ENERGY_TOL


@pytest.mark.parametrize("n,tile", [(45, fk.TILE), (48, (13, 10))])
def test_tiled_step_of_each_candidate_equals_batched_plain_step(n, tile):
    k = 3
    cfg, u, shape, prof, cyl, owner = _inputs(n, k)
    want = fk.fused_rk4_step_batched_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                               x_matmul=True)
    got = [fk.fused_rk4_step_tiled_reference(u[b], shape, prof, owner[b], T0, TI, TF, cfg, tile)
           for b in range(k)]
    assert not torch.equal(want[0][0], want[0][1])  # the candidates differ
    for b in range(k):
        assert torch.equal(got[b][0], want[0][b])
        assert rel(got[b][1].numpy(), want[1][b].numpy()) <= ENERGY_TOL


def test_tiled_step_matches_pallas_default_mode():
    n, tile, steps = 48, (13, 10), 2
    cfg, u, shape, prof, cyl, owner = _inputs(n)
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    scalars = np.array([T0, TI, TF, 0.0], np.float32)
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=steps, radii_only=True, x_matmul=True)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u.numpy()), 48),
                  shape_pad=pad_state(jnp.asarray(shape.numpy())[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars),
                  cyl=jnp.asarray(cyl.numpy()))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)

    got, es = u, []
    for k in range(steps):  # the Pallas kernel's sub-step times, float32 t0 + k dt
        t_k = float(np.float32(T0) + np.float32(k * cfg.dt))
        got, e = fk.fused_rk4_step_tiled_reference(got, shape, prof, owner, t_k, TI, TF, cfg,
                                                   tile)
        es.append(e)
    assert rel(got.numpy(), uj) <= STATE_TOL
    assert rel(torch.stack(es).numpy(), ej) <= ENERGY_TOL
