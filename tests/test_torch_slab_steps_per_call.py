"""Two and four steps a launch on column slabs (K4 and K4-XM at
`steps_per_call` 2 and 4), checked on the CPU.

`rk4_steps_tiled<XM, GENERAL, SPC, true>` (csrc/fused_rk4_multi.cu) steps a
card's slabs of a y-sharded grid spc steps in one launch, each slab with a
halo of 4 spc columns a side (the JAX kernel's `y_ghost >= HALO *
steps_per_call`). `fused_rk4_step_tiled_reference(..., slab=,
steps_per_call=)` decomposes the launch the same way in plain PyTorch; here
it is held:

* against the Pallas kernel in interpret mode on each slab of n = 48 in 3
  shards of 16 (`ny_local=16, y_ghost=8, steps_per_call=2,
  radii_only=True, x_matmul=True`), within 2e-7 on the owned state and
  1e-6 on each sub-step's energies, the tolerances of
  tests/test_torch_tiled_step_slab.py;
* against the plain slab steps (`fused_rk4_step_reference(...,
  steps_per_call=)`, halos zeroed after the last step alone) bit for bit on
  the whole slab, and on the owned columns against the whole grid's plain
  steps, at spc 2 (n = 48 in 3 shards; n = 50 in 2, a one-cell tile on the
  domain's last column) and spc 4 (n = 64 in 2), both d/dx forms and both
  rasterisations; every tile's region with its band lies in its slab.

And the sharded rollout around it: `build_stacked_rollout(...,
steps_per_call=spc)` over `SlabWindow`'s plain path against chained
one-step slab steps at the sub-step times (`build_rollout` at one step a
launch) and against the whole grid's plain window at the same spc, bit for
bit on the state; the halo exchange at halo 8 and 16 in any grouping; the
owner fields of the wider slabs against the whole grid's columns; and the
ValueErrors of shards too thin for their halo, of windows that spc does
not divide and of a slab whose halo is not 4 columns a step.

The CUDA kernel runs only on a card: tests/test_torch_gpu.py holds it
against the plain version there, bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import _cyl, rel, t
from test_torch_tiled_step import T0, TF, TI, _inputs

from waves_jl_tpu.ops.pallas_fd import GHOST, LANE, make_fused_acoustic_step, padded_dims
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.parallel import make_mesh
from waves_jl_tpu_torch.parallel.fused_domain import (build_rollout, build_stacked_rollout,
                                                      cut_slabs, exchange_halos, shard_slabs)

torch.set_num_threads(1)
STATE_TOL, ENERGY_TOL = 2e-7, 1e-6
HALO = fk.HALO
# n, shards, spc: 16-column shards at two steps (the thinnest); 25-column
# ones, whose last tile is one cell on the domain's last column; 32-column
# shards at four steps (the thinnest)
CASES = [(48, 3, 2), (50, 2, 2), (64, 2, 4)]


def _slab_inputs(n, shards, spc, moving):
    """(cfg, slabs with a 4 spc-column halo, global state, each slab's state
    and source shape, the global source shape, prof, cyl): the ring
    cylinders fixed, or moving in the window."""
    cfg, u, shape, prof, cyl, _ = _inputs(n)
    if moving:
        cyl = t(_cyl(moving=True))
    slabs = shard_slabs(n, shards, HALO * spc)
    cpus = ["cpu"] * shards
    return cfg, slabs, u, cut_slabs(u, slabs, cpus), cut_slabs(shape, slabs, cpus), shape, prof, cyl


def _tspan(spc, calls, dt):
    """(calls spc + 1,) float32 times: `calls` calls of spc steps from T0,
    each call's steps at its sub-step times."""
    starts = [float(np.float32(T0) + np.float32(c * spc * dt)) for c in range(calls)]
    times = fk.call_step_times(starts, spc, dt)
    return np.array(times + [float(np.float32(times[-1]) + np.float32(dt))], np.float32)


def test_slab_band_tiles_match_pallas_sharded_mode():
    n, shards, spc = 48, 3, 2
    cfg, slabs, _, us, shapes, _, prof, cyl = _slab_inputs(n, shards, spc, False)
    ny, yg = n // shards, HALO * spc
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=spc, ny_local=ny, y_ghost=yg,
        radii_only=True, x_matmul=True)
    px, _, _ = padded_dims(n, 48)
    py = math.ceil((ny + 2 * yg) / LANE) * LANE
    prof_np = prof.numpy()
    prof_x = jnp.asarray(np.pad(prof_np, (GHOST, px - GHOST - n), mode="edge")[:, None])
    prof_ext = np.pad(prof_np, (yg, yg), mode="edge")
    for k, (slab, u_k, shape_k) in enumerate(zip(slabs, us, shapes)):
        w = slab.w
        assert w == ny + 2 * yg
        u_pad = np.zeros((12, px, py), np.float32)
        u_pad[:, GHOST:GHOST + n, :w] = u_k.numpy()
        shape_pad = np.zeros((px, py), np.float32)
        shape_pad[GHOST:GHOST + n, :w] = shape_k.numpy()
        prof_y = np.pad(prof_ext[k * ny:k * ny + w], (0, py - w), mode="edge")[None, :]
        scalars = np.array([T0, TI, TF, k * ny], np.float32)
        uj, ej = step(u_pad=jnp.asarray(u_pad), shape_pad=jnp.asarray(shape_pad), prof_x=prof_x,
                      prof_y=jnp.asarray(prof_y), scalars=jnp.asarray(scalars),
                      cyl=jnp.asarray(cyl.numpy()))
        uj = np.asarray(uj)[:, GHOST:GHOST + n, yg:yg + ny]
        own = fk.select_owner_reference(cyl, cfg, slab)
        got, e = fk.fused_rk4_step_tiled_reference(u_k, shape_k, prof, own, T0, TI, TF, cfg,
                                                   slab=slab, steps_per_call=spc)
        assert e.shape == (spc, 3)
        assert rel(got[:, :, yg:yg + ny].numpy(), uj) <= STATE_TOL
        for st in range(spc):  # each sub-step's energies
            assert rel(e[st].numpy(), np.asarray(ej)[st]) <= ENERGY_TOL


@pytest.mark.parametrize("x_matmul", [True, False])
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n,shards,spc", CASES)
def test_slab_band_tiles_equal_plain_slab_steps(n, shards, spc, radii_only, x_matmul):
    cfg, slabs, u, us, shapes, shape, prof, cyl = _slab_inputs(n, shards, spc, not radii_only)
    owner = fk.select_owner_reference(cyl, cfg) if radii_only else None
    whole = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                        x_matmul=x_matmul, steps_per_call=spc)[0]
    h = HALO * spc
    for slab, u_k, shape_k in zip(slabs, us, shapes):
        own = fk.select_owner_reference(cyl, cfg, slab) if radii_only else None
        got = fk.fused_rk4_step_tiled_reference(u_k, shape_k, prof, own, T0, TI, TF, cfg,
                                                x_matmul=x_matmul,
                                                cyl=None if radii_only else cyl, slab=slab,
                                                steps_per_call=spc)
        want = fk.fused_rk4_step_reference(u_k, shape_k, prof, cyl, own, T0, TI, TF, cfg, slab,
                                           x_matmul, spc)
        assert got[0].shape == (12, n, slab.w) and got[1].shape == (spc, 3)
        assert torch.equal(got[0], want[0])
        halos = torch.cat([got[0][:, :, :h], got[0][:, :, -h:]], dim=-1)
        assert bool((halos == 0).all())  # the halo contract
        start = slab.col0 + h
        assert torch.equal(got[0][:, :, h:h + slab.ny], whole[:, :, start:start + slab.ny])
        assert rel(got[1].numpy(), want[1].numpy()) <= ENERGY_TOL


# the cases above; the main path's 4 shards at 700^2 at two and four steps
REGION_CASES = [*CASES, (700, 4, 2), (700, 4, 4)]


@pytest.mark.parametrize("n,shards,spc", REGION_CASES)
def test_every_band_region_lies_in_its_slab(n, shards, spc):
    one_cell = False
    for slab in shard_slabs(n, shards, HALO * spc):
        own0 = slab.col0 + slab.halo
        ends = []
        for j0 in range(own0, own0 + slab.ny, fk.TILE[1]):
            j1, lo, hi = fk._tile_region(j0, fk.TILE[1], n, own0 + slab.ny, halo=HALO * spc)
            assert own0 <= j0 <= j1 < own0 + slab.ny  # the tile in the owned columns
            assert slab.col0 <= lo and hi < slab.col0 + slab.w  # the region in the slab
            one_cell |= j0 == j1 == n - 1
            ends.append(j1)
        assert ends[-1] == own0 + slab.ny - 1  # the tiles cover the owned columns
    assert one_cell == ((n, shards, spc) == (50, 2, 2))


@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n,shards,spc", [(48, 3, 2), (64, 2, 4)])
def test_stacked_rollout_equals_chained_one_step_slab_steps(n, shards, spc, radii_only,
                                                            x_matmul):
    cfg, _, u, _, _, shape, prof, cyl = _slab_inputs(n, shards, spc, not radii_only)
    tspan = _tspan(spc, 2, cfg.dt)
    mesh = make_mesh(devices=["cpu"] * shards)
    got = build_stacked_rollout(mesh, cfg, cyl.shape[1], radii_only, x_matmul, spc)(
        u, tspan, cyl, shape, prof)
    want = build_rollout(mesh, cfg, cyl.shape[1], radii_only, fk.fused_rk4_step_reference,
                         fk.select_owner_reference, x_matmul)(u, tspan, cyl, shape, prof)
    assert got[0].shape == (12, n, n) and got[1].shape == (2 * spc + 1, 3)
    assert torch.equal(got[0], want[0])
    assert rel(got[1].numpy(), want[1].numpy()) <= ENERGY_TOL
    assert not torch.equal(got[0], u)


@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n,shards,spc", [(48, 3, 2), (64, 2, 4)])
def test_stacked_rollout_equals_whole_grid_window(n, shards, spc, radii_only, x_matmul):
    cfg, _, u, _, _, shape, prof, cyl = _slab_inputs(n, shards, spc, not radii_only)
    tspan = _tspan(spc, 2, cfg.dt)
    ti, tf = float(tspan[0]), float(tspan[-1])
    mesh = make_mesh(devices=["cpu"] * shards)
    got = build_stacked_rollout(mesh, cfg, cyl.shape[1], radii_only, x_matmul, spc)(
        u, tspan, cyl, shape, prof)
    owner = fk.select_owner_reference(cyl, cfg) if radii_only else None
    times = [float(x) for x in tspan[:-1]]
    (whole,), e = fk.fused_rk4_window_reference(u, shape, prof, cyl, owner, times, ti, tf, cfg,
                                                [len(times) - 1], x_matmul,
                                                steps_per_call=spc)
    assert torch.equal(got[0], whole)
    assert rel(got[1][1:].numpy(), e.numpy()) <= ENERGY_TOL


@pytest.mark.parametrize("groups", [[1, 1, 1, 1], [2, 2], [1, 3], [4]])
@pytest.mark.parametrize("halo", [8, 16])
def test_wide_halo_exchange_equals_slab_by_slab(halo, groups):
    n, shards = 8 * halo, 4  # shards of 2 halo columns, the thinnest
    rng = np.random.default_rng(halo)
    slabs = shard_slabs(n, shards, halo)
    assert all(s.w == n // shards + 2 * halo for s in slabs)
    us = [t(rng.standard_normal((12, 5, s.w))) for s in slabs]
    want = [u.clone() for u in us]
    exchange_halos([u[None] for u in want], n // shards, halo)
    ny = n // shards
    for k in range(1, shards):  # each inner halo holds its neighbour's edge columns
        assert torch.equal(want[k][..., :halo], us[k - 1][..., ny:ny + halo])
        assert torch.equal(want[k - 1][..., halo + ny:], us[k][..., halo:2 * halo])
    bounds = np.cumsum([0, *groups])
    stacked = [torch.stack(us[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    exchange_halos(stacked, n // shards, halo)
    got = [x for g in stacked for x in g]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("halo", [8, 16])
def test_wide_slab_owner_fields_equal_the_whole_grid_columns(halo):
    n, shards = 96, 3
    cfg, _, _, _, cyl, _ = _inputs(n)
    whole = fk.select_owner_reference(cyl, cfg)
    slabs = shard_slabs(n, shards, halo)
    stacked = fk.select_owner_slabs_reference(cyl, cfg, slabs)
    assert stacked.shape == (shards, 5, n, n // shards + 2 * halo)
    for slab, got in zip(slabs, stacked):
        lo, hi = max(slab.col0, 0), min(slab.col0 + slab.w, n)
        assert torch.equal(got[:, :, lo - slab.col0:hi - slab.col0], whole[:, :, lo:hi])
        assert torch.equal(got, fk.select_owner_tiled_reference(cyl, cfg, slab))
    # slab z starts at col0 + z (w - 2 halo): the fields of the second slab
    # differ from those at the offset of a 4-column halo
    shifted = fk.Slab(w=slabs[1].w, col0=slabs[0].col0 + slabs[1].w - 2 * HALO, halo=halo)
    assert not torch.equal(stacked[1], fk.select_owner_reference(cyl, cfg, shifted))


def test_value_errors():
    cfg, slabs, u, us, shapes, shape, prof, cyl = _slab_inputs(48, 3, 2, False)
    with pytest.raises(ValueError, match="too thin for the 16-column halo"):
        shard_slabs(48, 3, 16)
    mesh = make_mesh(devices=["cpu"] * 3)
    odd = _tspan(1, 3, cfg.dt)  # 3 steps
    for build in (lambda: build_stacked_rollout(mesh, cfg, cyl.shape[1], True, True, 2),
                  lambda: build_rollout(mesh, cfg, cyl.shape[1], True,
                                        fk.fused_rk4_step_reference, fk.select_owner_reference,
                                        True, 2)):
        with pytest.raises(ValueError, match="3 steps are not whole calls of 2"):
            build()(u, odd, cyl, shape, prof)
    with pytest.raises(ValueError, match="is not one of"):
        build_stacked_rollout(mesh, cfg, cyl.shape[1], True, True, 3)
    with pytest.raises(ValueError, match="not whole calls of 2"):
        fk.SlabWindow(torch.stack(us), torch.stack(shapes), prof, cyl, None, TI, TF, cfg, slabs,
                      3, steps_per_call=2)
    # a slab's halo is 4 columns a step of a launch
    narrow = shard_slabs(48, 3)
    with pytest.raises(ValueError, match="takes steps_per_call 1, not 2"):
        fk.fused_rk4_step_reference(cut_slabs(u, narrow, ["cpu"] * 3)[0],
                                    cut_slabs(shape, narrow, ["cpu"] * 3)[0], prof, cyl, None,
                                    T0, TI, TF, cfg, narrow[0], steps_per_call=2)
    with pytest.raises(ValueError, match="takes steps_per_call 2, not 1"):
        fk.fused_rk4_step_tiled_reference(us[0], shapes[0], prof, None, T0, TI, TF, cfg, cyl=cyl,
                                          slab=slabs[0])
