"""The radii-only owner pass with cylinders culled by box, checked on the CPU.

`select_owner_kernel` (csrc/fused_rk4.cu) gives each cell the owner fields
[d2, r1, r2 - r1, c1, c2 - c1] of the cylinder with the smallest gap
d2 - rmax^2 among those whose box [p - rmax, p + rmax], widened by one
spacing, holds the cell, and [1e30, 0, 0, 0, 0] where no box does; each
block tests only the cylinders whose box meets its tile. The fields used
to be taken over all cylinders (`select_owner_all_cylinders` below). Here
the plain versions are held:

* against that definition: the fields are equal wherever a cylinder covers
  the cell at its largest radius (gap < 0), and the wavespeed every stage
  reads from them is equal everywhere, at several lerp weights;
* through the step: a radii-only window's plain state and energies are
  bit for bit the same with either definition's fields, for one design,
  K = 3 candidates, and the sharded rollout on 1, 2 and 4 slabs, though
  the fields differ away from the cylinders;
* tile by tile: `select_owner_tiled_reference`, the kernel's tiles with
  the per-tile cull, equals the whole-grid plain version bit for bit, on
  grids that are not a multiple of the tile, on slabs, for a box that just
  reaches a tile's last row and column and one that just misses them, a
  cylinder across a slab boundary, 80 cylinders (two chunks of the
  kernel's table) and none;
* against the Pallas kernel in interpret mode, radii-only with the split
  d/dx (`x_matmul=True`, two steps a call), whose fields come from its own
  block cull: within 2e-7 on the state and 1e-6 on the energies, the
  tolerances of tests/test_torch_tiled_step.py.

The CUDA kernel runs only on a card: tests/test_torch_gpu.py holds it
against these plain versions there, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import rel, t

import waves_jl_tpu as w
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.parallel import make_fused_sharded_rollout, make_mesh
from waves_jl_tpu_torch.parallel.fused_domain import build_rollout, shard_slabs
from waves_jl_tpu_torch.physics.fused import cyl_params

torch.set_num_threads(1)
STATE_TOL, ENERGY_TOL = 2e-7, 1e-6
T0, TI, TF = 2e-4, 0.0, 1e-3  # a mid-window lerp weight
SENTINEL = torch.tensor([1e30, 0.0, 0.0, 0.0, 0.0])


def select_owner_all_cylinders(cyl, cfg, slab=None):
    """The owner fields as they were defined before the cull: each cell's
    owner is the cylinder with the smallest gap d2 - rmax^2 over all
    cylinders (first in order on ties). Returns (fields (5, n, w), the
    smallest gap (n, w))."""
    xs = cfg.x_min + torch.arange(cfg.n, dtype=torch.float32) * cfg.spacing
    ys = xs if slab is None else cfg.x_min + slab.columns("cpu").to(torch.float32) * cfg.spacing
    x, y = xs[:, None], ys[None, :]
    shape = (xs.shape[0], ys.shape[0])
    best = torch.full(shape, 1e30, dtype=torch.float32)
    d2o = best.clone()
    r1, dr, c1, dc = (torch.zeros(shape, dtype=torch.float32) for _ in range(4))
    for q in range(cyl.shape[1]):
        ddx = x - cyl[0, q]
        ddy = y - cyl[1, q]
        d2 = ddx * ddx + ddy * ddy
        rmax = torch.maximum(cyl[2, q], cyl[6, q])
        gap = d2 - rmax * rmax
        upd = gap < best
        best = torch.where(upd, gap, best)
        d2o = torch.where(upd, d2, d2o)
        r1 = torch.where(upd, cyl[2, q], r1)
        dr = torch.where(upd, cyl[6, q] - cyl[2, q], dr)
        c1 = torch.where(upd, cyl[3, q], c1)
        dc = torch.where(upd, cyl[7, q] - cyl[3, q], dc)
    return torch.stack([d2o, r1, dr, c1, dc]), best


def _config(n):
    return fk.StepConfig(n=n, spacing=30.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                         freq=1000.0)


def _ring(k=None, seed=0):
    """(8, 19) cylinders of the triple ring, or (k, 8, 19) candidates, each
    radius lerping between two draws from its box [low, high]."""
    rng = np.random.default_rng(seed)
    space = build_triple_ring_design_space(device="cpu")
    cyl = cyl_params(space.low, space.high, "cpu").numpy()
    lo, hi = cyl[2].copy(), cyl[6].copy()
    lead = () if k is None else (k,)
    cyl = np.broadcast_to(cyl, (*lead, *cyl.shape)).copy()
    cyl[..., 2, :] = rng.uniform(lo, hi, (*lead, lo.shape[0]))
    cyl[..., 6, :] = rng.uniform(lo, hi, (*lead, lo.shape[0]))
    return t(cyl)


def _stage_speed(owner, weight, c0):
    """The wavespeed a stage reads from owner fields at lerp weight
    `weight`, in `fused_rk4_step_reference`'s arithmetic."""
    r = owner[1] + weight * owner[2]
    return torch.where(owner[0] < r * r, owner[3] + weight * owner[4], torch.full_like(r, c0))


@pytest.mark.parametrize("n,shards", [(45, None), (70, None), (96, 4)])
def test_new_fields_equal_old_where_a_cylinder_covers_the_cell(n, shards):
    cfg, cyl = _config(n), _ring(seed=n)
    for slab in [None] if shards is None else shard_slabs(n, shards):
        new = fk.select_owner_reference(cyl, cfg, slab)
        old, gap = select_owner_all_cylinders(cyl, cfg, slab)
        covered = gap < 0
        assert torch.equal(new[:, covered], old[:, covered])
        # where no box holds a cell the fields are the sentinel
        far = new[0] == 1e30
        assert torch.equal(new[:, far], SENTINEL[:, None].expand(5, int(far.sum())))
        if slab is None:
            assert bool(covered.any()) and bool(far.any())
        # the stage's wavespeed, the fields' only use, is unchanged
        for weight in (0.0, 0.37, 1.0):
            assert torch.equal(_stage_speed(new, weight, cfg.c0), _stage_speed(old, weight, cfg.c0))


@pytest.mark.parametrize("form", ["single", "batched", "slabs1", "slabs2", "slabs4"])
def test_window_state_is_unchanged_by_the_new_fields(form):
    n, steps = 48, 3
    cfg = _config(n)
    rng = np.random.default_rng(7)
    k = 3 if form == "batched" else None
    cyl = _ring(k, seed=3)
    lead = () if k is None else (k,)
    u = t(rng.standard_normal((*lead, 12, n, n)) * 1e-3)
    shape, prof = t(rng.random((n, n))), t(rng.random(n) * 100.0)
    tspan = np.float32(T0) + np.arange(steps + 1, dtype=np.float32) * np.float32(cfg.dt)
    ti, tf = float(tspan[0]), float(tspan[-1])
    if form.startswith("slabs"):
        shards = int(form[len("slabs"):])
        mesh = make_mesh(devices=["cpu"] * shards)
        new = make_fused_sharded_rollout(mesh, n, cfg.spacing, cfg.dt, cfg.c0, cfg.freq,
                                         cyl.shape[1], cfg.x_min, radii_only=True)(
            u, tspan, cyl, shape, prof)
        old = build_rollout(mesh, cfg, cyl.shape[1], True, fk.fused_rk4_step_reference,
                            lambda c, cfg_, s: select_owner_all_cylinders(c, cfg_, s)[0])(
            u, tspan, cyl, shape, prof)
        slabs = shard_slabs(n, shards)
        assert not torch.equal(fk.select_owner_slabs(cyl, cfg, slabs),
                               torch.stack([select_owner_all_cylinders(cyl, cfg, s)[0]
                                            for s in slabs]))
        assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
        return
    if k is None:
        owners = (fk.select_owner(cyl, cfg), select_owner_all_cylinders(cyl, cfg)[0])
        step = fk.fused_rk4_step_reference
    else:
        owners = (fk.select_owner_batched(cyl, cfg),
                  torch.stack([select_owner_all_cylinders(c, cfg)[0] for c in cyl]))
        step = fk.fused_rk4_step_batched_reference
    assert not torch.equal(*owners)  # the fields differ away from the cylinders
    runs = []
    for owner in owners:
        v, es = u, []
        for t0 in tspan[:-1]:
            v, e = step(v, shape, prof, cyl, owner, float(t0), ti, tf, cfg, x_matmul=True)
            es.append(e)
        runs.append((v, torch.stack(es)))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


# n, tile: grids that are not a multiple of the kernel's 16 x 64 tile (45,
# 70, 97) and a 13 x 10 tile that leaves one-cell edge tiles at 40
@pytest.mark.parametrize("n,tile", [(45, fk.OWNER_TILE), (70, fk.OWNER_TILE),
                                    (97, fk.OWNER_TILE), (40, (13, 13))])
def test_tiled_fields_equal_whole_grid_fields(n, tile):
    cfg = _config(n)
    for cyl in _ring(3, seed=n):
        want = fk.select_owner_reference(cyl, cfg)
        assert torch.equal(fk.select_owner_tiled_reference(cyl, cfg, tile=tile), want)


@pytest.mark.parametrize("n,shards", [(48, 4), (96, 4), (140, 2)])
def test_tiled_fields_on_slabs_equal_plain_slab_fields(n, shards):
    cfg, cyl = _config(n), _ring(seed=1)
    slabs = shard_slabs(n, shards)
    whole = fk.select_owner_reference(cyl, cfg)
    stacked = fk.select_owner_slabs(cyl, cfg, slabs)  # the plain version on the CPU
    assert tuple(stacked.shape) == (shards, 5, n, slabs[0].w)
    for slab, got in zip(slabs, stacked):
        assert torch.equal(got, fk.select_owner_reference(cyl, cfg, slab))
        assert torch.equal(fk.select_owner_tiled_reference(cyl, cfg, slab), got)
        # a slab's columns inside the domain carry the whole grid's fields
        cols = slab.columns("cpu")
        inside = (cols >= 0) & (cols < n)
        assert torch.equal(got[:, :, inside], whole[:, :, cols[inside]])


def _exact_config(n):
    """A grid whose coordinates -10 + 0.25 i are exact in float32."""
    return fk.StepConfig(n=n, spacing=0.25, x_min=-10.0, dt=1e-5, c0=1531.0, freq=1000.0)


@pytest.mark.parametrize("offset", [0.0, 2.0 ** -8])
def test_box_at_a_tile_edge(offset):
    """A cylinder of largest radius 0.5 (reach 0.75) whose box starts at the
    last row (15) and last column (63) of the first 16 x 64 tile when
    offset is 0, and just past them, in the next tiles, when it is not."""
    n = 80
    cfg = _exact_config(n)
    x15, y63 = -10.0 + 15 * 0.25, -10.0 + 63 * 0.25
    px, py = x15 + 0.75 + offset, y63 + 0.75 + offset
    cyl = t([[px], [py], [0.5], [1032.0], [px], [py], [0.25], [1032.0]])
    assert float(fk.owner_boxes(cyl, cfg.spacing)[0, 0]) == x15 + offset
    got = fk.select_owner_reference(cyl, cfg)
    assert torch.equal(fk.select_owner_tiled_reference(cyl, cfg), got)
    owned = got[0] < 1e30
    reach = offset == 0.0
    assert bool(owned[15, 63]) == reach and bool(owned[16, 64])
    assert not bool(owned[14].any()) and not bool(owned[:, 62].any())
    assert bool(owned[15].any()) == reach and bool(owned[:, 63].any()) == reach


def test_cylinder_across_a_slab_boundary():
    n, shards = 48, 4
    cfg = _config(n)
    ys = cfg.x_min + np.arange(n) * cfg.spacing
    # centred on global column 24, the first of slab 2 and the right halo of slab 1
    cyl = t([[0.0], [ys[24]], [1.2], [1032.0], [0.0], [ys[24]], [1.5], [1032.0]])
    whole = fk.select_owner_reference(cyl, cfg)
    assert bool((whole[0][:, 20:24] < whole[1][:, 20:24] ** 2).any())  # covers slab 1's cells
    assert bool((whole[0][:, 24:28] < whole[1][:, 24:28] ** 2).any())  # and slab 2's
    for slab in shard_slabs(n, shards):
        got = fk.select_owner_reference(cyl, cfg, slab)
        assert torch.equal(fk.select_owner_tiled_reference(cyl, cfg, slab, (16, 5)), got)
        cols = slab.columns("cpu")
        inside = (cols >= 0) & (cols < n)
        assert torch.equal(got[:, :, inside], whole[:, :, cols[inside]])


def test_eighty_cylinders_take_two_chunks():
    from chip_smoke import cylinder_grid

    n = 100
    cfg = _config(n)
    grid = cylinder_grid(moving=False)
    cyl = t(grid)
    new = fk.select_owner_reference(cyl, cfg)
    old, gap = select_owner_all_cylinders(cyl, cfg)
    assert torch.equal(fk.select_owner_tiled_reference(cyl, cfg), new)
    assert torch.equal(new[:, gap < 0], old[:, gap < 0])
    # cylinders of both chunks of 64 own cells
    owned_r1 = set(torch.unique(new[1][gap < 0]).tolist())
    assert {float(np.float32(r)) for r in grid[2, :64]} & owned_r1
    assert {float(np.float32(r)) for r in grid[2, 64:]} & owned_r1


def test_no_cylinder_gives_the_sentinel_everywhere():
    n = 45
    cfg = _config(n)
    cyl = torch.zeros((8, 0))
    want = SENTINEL[:, None, None].expand(5, n, n)
    assert torch.equal(fk.select_owner_reference(cyl, cfg), want)
    assert torch.equal(fk.select_owner_tiled_reference(cyl, cfg), want)
    slabs = shard_slabs(n - 1, 4)  # 44 = 4 x 11
    cfg44 = _config(n - 1)
    assert torch.equal(fk.select_owner_slabs(cyl, cfg44, slabs),
                       SENTINEL[None, :, None, None].expand(4, 5, n - 1, slabs[0].w))


def test_owner_pass_matches_pallas_radii_only_step():
    n, steps = 48, 2
    cfg = _config(n)
    rng = np.random.default_rng(5)
    cyl = _ring(seed=5)
    u = t(rng.standard_normal((12, n, n)) * 1e-3)
    grid = w.build_grid(w.two_dim(15.0, n))
    shape = t(np.asarray(w.build_normal(grid, jnp.array([[3.0, 2.0]]), jnp.array([2.4]),
                                        jnp.array([1.0]))))
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    owner = fk.select_owner(cyl, cfg)
    assert not torch.equal(owner, select_owner_all_cylinders(cyl, cfg)[0])
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=steps, radii_only=True, x_matmul=True)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u.numpy()), 48),
                  shape_pad=pad_state(jnp.asarray(shape.numpy())[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y,
                  scalars=jnp.asarray(np.array([T0, TI, TF, 0.0], np.float32)),
                  cyl=jnp.asarray(cyl.numpy()))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)
    got, es = u, []
    for k in range(steps):  # the Pallas kernel's sub-step times, float32 t0 + k dt
        t_k = float(np.float32(T0) + np.float32(k * cfg.dt))
        got, e = fk.fused_rk4_step_reference(got, shape, t(pml[:, 0]), cyl, owner, t_k, TI, TF,
                                             cfg, x_matmul=True)
        es.append(e)
    assert rel(got.numpy(), uj) <= STATE_TOL
    assert rel(torch.stack(es).numpy(), ej) <= ENERGY_TOL
