"""The one-launch step's general mode, tile by tile, checked on the CPU.

`rk4_step_tiled<XM, GENERAL=true>` (csrc/fused_rk4.cu) takes K1, K3
general, K5 general and batched K5 general in one launch a step: each
block rasterises the cylinders, lerped to each stage's time, on its own
region, and skips those whose box at that time misses the region (the
cull). `fused_rk4_step_tiled_reference(..., cyl=...)` decomposes the step
and culls the cylinders the same way in plain PyTorch; here, with the
split d/dx of K5 (`x_matmul=True`), it is held:

* against the whole-grid plain general step `fused_rk4_step_reference(...,
  owner=None, x_matmul=True)`, bit for bit on the state over two chained
  steps, at n = 45 and 48 with the kernel's 16 x 24 tiles and with tiles
  that leave partial and one-cell tiles on the domain's edges, for moving
  cylinders (one centred on a tile corner, one crossing tile edges within
  the window), no cylinder, and 80 cylinders (more than one chunk of the
  kernel's 64); energies within 1e-6 (the tiles' partial sums add in
  another order);
* for each of K = 3 candidates with cylinders of their own, against the
  batched plain step, bit for bit;
* against the Pallas kernel in interpret mode with `x_matmul=True,
  radii_only=False` and moving cylinders, two steps a call, within 2e-7 on
  the state and 1e-6 on the energies (tests/test_torch_xmatmul.py);
* and the cull itself: on every tile region and stage weight, the kept
  cylinders rasterise to exactly the field of all of them, while most
  regions keep fewer than all.

A cull that drops a covering cylinder, or a rasterisation on the wrong
coordinates, shows here as differing cells. The CUDA kernel runs only on a
card: tests/test_torch_gpu.py holds it against the plain version there, bit
for bit. tests/test_torch_tiled_step_general_exact.py holds the exact d/dx
(K1, K3 general).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import _cyl, rel
from test_torch_tiled_step import CASES, T0, TF, TI, _inputs

from chip_smoke import cylinder_grid
import waves_jl_tpu as w
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch.designs import lerp_weight
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
STATE_TOL, ENERGY_TOL = 2e-7, 1e-6  # against Pallas interpret (tests/test_torch_xmatmul.py)
CYLINDERS = ["moving", "none", "eighty"]


def general_cyl(cfg: fk.StepConfig, which: str, k=None) -> torch.Tensor:
    """(8, n_cyl) cylinders, or (k, 8, n_cyl) with radii and positions of
    each candidate's own: "moving" the ring cylinders and core of
    `_cyl(moving=True)`, one centred on the corner of the kernel's tiles at
    row 16 and column 24, and one crossing rows 26-35 and columns 10-14 (tile
    edges of every case) within the window; "none" no cylinder; "eighty"
    `chip_smoke.cylinder_grid(moving=True)`."""
    def at(i, j):
        return cfg.x_min + i * cfg.spacing, cfg.x_min + j * cfg.spacing

    if which == "none":
        cyl = np.zeros((8, 0), np.float32)
    elif which == "eighty":
        cyl = cylinder_grid(True).astype(np.float32)
    else:
        corner, (ax, ay), (bx, by) = at(16, 24), at(24, 8), at(36, 14)
        extra = np.array([[*corner, 0.8, 1032.0, *corner, 1.1, 1032.0],
                          [ax, ay, 1.0, 1032.0, bx, by, 1.3, 1032.0]], np.float32).T
        cyl = np.concatenate([_cyl(moving=True), extra], axis=1)
    if k is not None:
        rng = np.random.default_rng(cfg.n + k)
        cyl = np.repeat(cyl[None], k, axis=0)
        cyl[:, [2, 6]] *= rng.uniform(0.7, 1.0, (k, 1, cyl.shape[-1])).astype(np.float32)
        cyl[:, [0, 1, 4, 5]] += rng.uniform(-0.5, 0.5, (k, 4, 1)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(cyl))


def check_against_plain(n, tile, which, x_matmul):
    cfg, u, shape, prof, _, _ = _inputs(n)
    cyl = general_cyl(cfg, which)
    got, want = (u, None), (u, None)
    for t0 in (T0, T0 + cfg.dt):  # two chained steps
        got = fk.fused_rk4_step_tiled_reference(got[0], shape, prof, None, t0, TI, TF, cfg, tile,
                                                x_matmul, cyl=cyl)
        want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, None, t0, TI, TF, cfg,
                                           x_matmul=x_matmul)
    assert got[0].shape == (12, n, n) and got[1].shape == (3,)
    assert torch.equal(got[0], want[0])
    assert rel(got[1].numpy(), want[1].numpy()) <= 1e-6


def check_candidates(n, tile, x_matmul):
    k = 3
    cfg, u, shape, prof, _, _ = _inputs(n, k)
    cyl = general_cyl(cfg, "moving", k)
    want = fk.fused_rk4_step_batched_reference(u, shape, prof, cyl, None, T0, TI, TF, cfg,
                                               x_matmul=x_matmul)
    assert not torch.equal(want[0][0], want[0][1])  # the candidates differ
    for b in range(k):
        got = fk.fused_rk4_step_tiled_reference(u[b], shape, prof, None, T0, TI, TF, cfg, tile,
                                                x_matmul, cyl=cyl[b])
        assert torch.equal(got[0], want[0][b])
        assert rel(got[1].numpy(), want[1][b].numpy()) <= 1e-6


def check_against_pallas(x_matmul, state_tol, energy_tol):
    n, tile, steps = 48, (13, 10), 2
    cfg, u, shape, prof, _, _ = _inputs(n)
    cyl = general_cyl(cfg, "moving")
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    scalars = np.array([T0, TI, TF, 0.0], np.float32)
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=steps, radii_only=False,
        x_matmul=x_matmul)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u.numpy()), 48),
                  shape_pad=pad_state(jnp.asarray(shape.numpy())[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars),
                  cyl=jnp.asarray(cyl.numpy()))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)

    got, es = u, []
    for k in range(steps):  # the Pallas kernel's sub-step times, float32 t0 + k dt
        t_k = float(np.float32(T0) + np.float32(k * cfg.dt))
        got, e = fk.fused_rk4_step_tiled_reference(got, shape, prof, None, t_k, TI, TF, cfg, tile,
                                                   x_matmul, cyl=cyl)
        es.append(e)
    assert rel(got.numpy(), uj) <= state_tol
    assert rel(torch.stack(es).numpy(), ej) <= energy_tol


@pytest.mark.parametrize("which", CYLINDERS)
@pytest.mark.parametrize("n,tile", CASES)
def test_general_tiled_step_equals_whole_grid_plain_step(n, tile, which):
    check_against_plain(n, tile, which, x_matmul=True)


@pytest.mark.parametrize("n,tile", [(45, fk.TILE), (48, (13, 10))])
def test_general_tiled_step_of_each_candidate_equals_batched_plain_step(n, tile):
    check_candidates(n, tile, x_matmul=True)


def test_general_tiled_step_matches_pallas_default_mode():
    check_against_pallas(True, STATE_TOL, ENERGY_TOL)


@pytest.mark.parametrize("which", ["moving", "eighty"])
def test_cull_keeps_every_covering_cylinder(which):
    n = 48
    cfg = _inputs(n)[0]
    cyl = general_cyl(cfg, which)
    coord = cfg.x_min + torch.arange(n, dtype=torch.float32) * cfg.spacing
    kept = []
    for ts in (TI, T0, 0.5 * (TI + TF), TF):  # weights 0 to 1
        wt = lerp_weight(ts, TI, TF)
        for i0 in range(0, n, fk.TILE[0]):
            _, rlo, rhi = fk._tile_region(i0, fk.TILE[0], n)
            for j0 in range(0, n, fk.TILE[1]):
                _, clo, chi = fk._tile_region(j0, fk.TILE[1], n)
                xs, ys = coord[rlo:rhi + 1], coord[clo:chi + 1]
                keep = fk.cull_cylinders(cyl, wt, xs, ys, cfg.spacing)
                full = fk._rasterize(cyl, xs[:, None], ys[None, :], wt, cfg.c0)
                culled = fk._rasterize(cyl[:, keep], xs[:, None], ys[None, :], wt, cfg.c0)
                assert torch.equal(culled, full)
                kept.append(int(keep.sum()))
    assert min(kept) < cyl.shape[1] and max(kept) > 0  # the cull drops some, keeps some
