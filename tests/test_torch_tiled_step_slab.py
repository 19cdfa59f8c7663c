"""The one-launch step on column slabs (K4, K4-XM), checked on the CPU.

`rk4_step_tiled` (csrc/fused_rk4.cu) steps all of a card's slabs of a
y-sharded grid in one launch: each slab's tiles cover its owned columns
alone, each tile's region (the tile and a 4-cell halo, in global rows and
columns) lies inside the slab, and the slab's halo columns are written 0.
`fused_rk4_step_tiled_reference(..., slab=)` decomposes the step the same
way in plain PyTorch; here it is held:

* against the plain slab step `fused_rk4_step_reference(..., slab=)`, bit
  for bit on the whole slab (every owned column, and the halo columns,
  which both write 0), and on the owned columns against the whole-grid
  plain step, at n = 45 in 3 shards of 15 with the kernel's 16 x 24 tiles
  (partial tiles on both axes), and at n = 48 in 4 shards of 12 with
  13 x 10 tiles and with 13 x 11 tiles, which leave a one-cell tile on the
  domain's last column; both d/dx forms, radii-only on the ring cylinders
  and general with moving ones; energies within 1e-6 (the tiles' partial
  sums add in another order);
* tile by tile: every region lies inside its slab, for these cases and for
  the kernel's tile on the main path's shards at 700^2 and on the thinnest
  shards;
* against the Pallas kernel in interpret mode on each slab of n = 48 in 4
  shards (`ny_local=12, y_ghost=HALO, x_matmul=True, radii_only=True`),
  within 2e-7 on the owned state and 1e-6 on the energies, the tolerances
  of tests/test_torch_tiled_step.py;
* and the stacked path around it: the halo exchange of stacked slabs in
  any grouping equals the slab-by-slab one, `fused_rk4_step_slabs` equals
  the plain step of each slab, and the stacked rollout
  (`build_stacked_rollout`, which `make_fused_sharded_rollout` builds,
  here over `SlabWindow`'s plain path) equals the plain slab-by-slab
  rollout (`build_rollout` over the `*_reference` versions) bit for bit.

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
# n, shards, tile: 45 = 3 x 15 with the kernel's tile; 48 = 4 x 12 with
# 13 x 10 tiles, and with 13 x 11, a one-cell tile on column 47
CASES = [(45, 3, fk.TILE), (48, 4, (13, 10)), (48, 4, (13, 11))]


def _slab_inputs(n, shards, moving):
    """(cfg, slabs, global state, each slab's state and source shape, prof,
    cyl): the ring cylinders fixed, or moving in the window."""
    cfg, u, shape, prof, cyl, _ = _inputs(n)
    if moving:
        cyl = t(_cyl(moving=True))
    slabs = shard_slabs(n, shards)
    cpus = ["cpu"] * shards
    return cfg, slabs, u, cut_slabs(u, slabs, cpus), cut_slabs(shape, slabs, cpus), shape, prof, cyl


@pytest.mark.parametrize("x_matmul", [True, False])
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n,shards,tile", CASES)
def test_slab_tiles_equal_plain_slab_step(n, shards, tile, radii_only, x_matmul):
    cfg, slabs, u, us, shapes, shape, prof, cyl = _slab_inputs(n, shards, not radii_only)
    owner = fk.select_owner_reference(cyl, cfg) if radii_only else None
    whole = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                        x_matmul=x_matmul)[0]
    for slab, u_k, shape_k in zip(slabs, us, shapes):
        own = fk.select_owner_reference(cyl, cfg, slab) if radii_only else None
        got = fk.fused_rk4_step_tiled_reference(u_k, shape_k, prof, own, T0, TI, TF, cfg, tile,
                                                x_matmul, None if radii_only else cyl, slab)
        want = fk.fused_rk4_step_reference(u_k, shape_k, prof, cyl, own, T0, TI, TF, cfg, slab,
                                           x_matmul)
        assert got[0].shape == (12, n, slab.w)
        assert torch.equal(got[0], want[0])
        halos = torch.cat([got[0][:, :, :HALO], got[0][:, :, -HALO:]], dim=-1)
        assert bool((halos == 0).all())  # the halo contract
        start = slab.col0 + HALO
        assert torch.equal(got[0][:, :, HALO:HALO + slab.ny], whole[:, :, start:start + slab.ny])
        assert rel(got[1].numpy(), want[1].numpy()) <= ENERGY_TOL


# the cases above; the main path's 1, 2 and 4 shards at 700^2 (175 columns:
# a last tile of 7); shards of 2 HALO = 8 columns, the thinnest; those
# with a one-cell tile on the domain's last column
REGION_CASES = [*CASES, (700, 1, fk.TILE), (700, 2, fk.TILE), (700, 4, fk.TILE),
                (64, 8, fk.TILE), (64, 8, (16, 7)), (33, 3, (16, 10))]
ONE_CELL = [(48, 4, (13, 11)), (64, 8, (16, 7)), (33, 3, (16, 10))]


@pytest.mark.parametrize("n,shards,tile", REGION_CASES)
def test_every_tile_region_lies_in_its_slab(n, shards, tile):
    one_cell = False
    for slab in shard_slabs(n, shards):
        own0 = slab.col0 + HALO
        ends = []
        for j0 in range(own0, own0 + slab.ny, tile[1]):
            j1, lo, hi = fk._tile_region(j0, tile[1], n, own0 + slab.ny)
            assert own0 <= j0 <= j1 < own0 + slab.ny  # the tile in the owned columns
            assert slab.col0 <= lo and hi < slab.col0 + slab.w  # the region in the slab
            one_cell |= j0 == j1 == n - 1
            ends.append(j1)
        assert ends[-1] == own0 + slab.ny - 1  # the tiles cover the owned columns
    assert one_cell == ((n, shards, tile) in ONE_CELL)


def test_slab_tiles_match_pallas_sharded_mode():
    n, shards, tile = 48, 4, (13, 10)
    cfg, slabs, _, us, shapes, _, prof, cyl = _slab_inputs(n, shards, False)
    ny = n // shards
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=1, ny_local=ny, y_ghost=HALO,
        radii_only=True, x_matmul=True)
    px, _, _ = padded_dims(n, 48)
    py = math.ceil((ny + 2 * HALO) / LANE) * LANE
    prof_np = prof.numpy()
    prof_x = jnp.asarray(np.pad(prof_np, (GHOST, px - GHOST - n), mode="edge")[:, None])
    prof_ext = np.pad(prof_np, (HALO, HALO), mode="edge")
    for k, (slab, u_k, shape_k) in enumerate(zip(slabs, us, shapes)):
        w = slab.w
        u_pad = np.zeros((12, px, py), np.float32)
        u_pad[:, GHOST:GHOST + n, :w] = u_k.numpy()
        shape_pad = np.zeros((px, py), np.float32)
        shape_pad[GHOST:GHOST + n, :w] = shape_k.numpy()
        prof_y = np.pad(prof_ext[k * ny:k * ny + w], (0, py - w), mode="edge")[None, :]
        scalars = np.array([T0, TI, TF, k * ny], np.float32)
        uj, ej = step(u_pad=jnp.asarray(u_pad), shape_pad=jnp.asarray(shape_pad), prof_x=prof_x,
                      prof_y=jnp.asarray(prof_y), scalars=jnp.asarray(scalars),
                      cyl=jnp.asarray(cyl.numpy()))
        uj = np.asarray(uj)[:, GHOST:GHOST + n, HALO:HALO + ny]
        own = fk.select_owner_reference(cyl, cfg, slab)
        got, e = fk.fused_rk4_step_tiled_reference(u_k, shape_k, prof, own, T0, TI, TF, cfg,
                                                   tile, slab=slab)
        assert rel(got[:, :, HALO:HALO + ny].numpy(), uj) <= STATE_TOL
        assert rel(e.numpy(), np.asarray(ej)[0]) <= ENERGY_TOL


@pytest.mark.parametrize("groups", [[1, 1, 1, 1], [2, 2], [1, 3], [4]])
def test_stacked_exchange_equals_slab_by_slab(groups):
    n, shards = 48, 4
    rng = np.random.default_rng(4)
    slabs = shard_slabs(n, shards)
    us = [t(rng.standard_normal((12, n, s.w))) for s in slabs]
    want = [u.clone() for u in us]
    exchange_halos([u[None] for u in want], n // shards)
    bounds = np.cumsum([0, *groups])
    stacked = [torch.stack(us[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    exchange_halos(stacked, n // shards)
    got = [x for g in stacked for x in g]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(want[1], us[1])  # the halos moved


@pytest.mark.parametrize("radii_only", [True, False])
def test_stacked_slab_step_equals_each_slab(radii_only):
    n, shards = 48, 4
    cfg, slabs, _, us, shapes, _, prof, cyl = _slab_inputs(n, shards, not radii_only)
    owner = (torch.stack([fk.select_owner_reference(cyl, cfg, s) for s in slabs])
             if radii_only else None)
    got = fk.fused_rk4_step_slabs(torch.stack(us), torch.stack(shapes), prof, cyl, owner, T0, TI,
                                  TF, cfg, slabs, True)
    assert got[0].shape == (shards, 12, n, slabs[0].w) and got[1].shape == (shards, 3)
    for k, slab in enumerate(slabs):
        want = fk.fused_rk4_step_reference(us[k], shapes[k], prof, cyl,
                                           None if owner is None else owner[k], T0, TI, TF, cfg,
                                           slab, True)
        assert torch.equal(got[0][k], want[0]) and torch.equal(got[1][k], want[1])


@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
def test_stacked_rollout_equals_slab_by_slab_rollout(radii_only, x_matmul):
    n, shards, steps = 48, 4, 3
    cfg, _, u, _, _, shape, prof, cyl = _slab_inputs(n, shards, not radii_only)
    tspan = np.float32(T0) + np.arange(steps + 1, dtype=np.float32) * np.float32(cfg.dt)
    mesh = make_mesh(devices=["cpu"] * shards)
    got = build_stacked_rollout(mesh, cfg, cyl.shape[1], radii_only, x_matmul)(
        u, tspan, cyl, shape, prof)
    want = build_rollout(mesh, cfg, cyl.shape[1], radii_only, fk.fused_rk4_step_reference,
                         fk.select_owner_reference, x_matmul)(u, tspan, cyl, shape, prof)
    assert got[0].shape == (12, n, n) and got[1].shape == (steps + 1, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], u)
