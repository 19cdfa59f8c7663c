"""Fused RK4 step of the 12-channel split-field PML acoustic system.

The CUDA kernel (`csrc/fused_rk4.cu`) takes the place of the Pallas kernel
`make_fused_acoustic_step` of the JAX package (`waves_jl_tpu/ops/pallas_fd.py`):
K1, the general rasterisation, K2, the radii-only owner rasterisation, K3,
either of them for K candidate states in one launch (`batch=K`, the hybrid
controller's re-rank), and K4, either of them on column slabs of a
y-sharded grid (`slab=`, or all of a card's slabs stacked in one launch,
the domain-decomposed rollout of `parallel/fused_domain.py`). K5,
`x_matmul=True`, takes d/dx as the JAX kernel's default mode does, a bf16
hi/lo split summed in float32 (`ops/fd.py::dx_split_bf16`), in K1's, K2's
or K3's launch, or on slabs (K4-XM); the JAX package's fused paths but the
sharded one default to it. This module builds the kernel with plain `nvcc`
into a shared library with a C interface at first use, binds it with
`ctypes`, and keeps the plain PyTorch version of the same function beside
it.

Every mode, in either d/dx form and either rasterisation, runs a whole RK4
step in one launch (`rk4_step_tiled`: each block keeps its tile and a
4-cell halo in shared memory through the four stages, and the general
mode rasterises only the cylinders that reach its tile). On the whole grid
a launch may also take two or four steps (`steps_per_call`, the JAX
kernel's temporal blocking: `rk4_steps_tiled` in csrc/fused_rk4_multi.cu
keeps a band of 4 cells a step through them), sub-step st at the JAX
kernel's time float32(t + float32(st dt)) (`substep_times`), with one row
of energies a sub-step; so may a card's slabs, each with a halo of 4 cells
a step of a launch (`Slab.halo`). `fused_rk4_window`
drives a window's steps as the env window and the re-rank do, and
`SlabWindow` a card's slabs through a sharded rollout: each makes its two
state buffers and its energy partials once a window and marshals the
window's fixed inputs once. The radii-only mode's owner pass takes one
launch a window in each form (`select_owner`, `select_owner_batched`,
`select_owner_slabs`: `select_owner_kernel`, each block testing only the
cylinders whose box reaches its tile).

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. `launch_counts` counts the
kernel launches per kernel.

The state is a contiguous (12, n, n) float32 tensor: channels U, Vx, Vy,
Psix, Psiy, Omega of the total field, then the same six of the incident
field. `cyl` is (8, n_cyl) float32 with rows [p1x, p1y, r1, c1, p2x, p2y, r2,
c2], the cylinders at the two ends of the design lerp. Energies are
[sum u_tot^2, sum u_inc^2, sum (u_tot - u_inc)^2] after each step, not yet
multiplied by the cell area. The batched functions take the same tensors
with a leading candidate axis K on the state, cylinders and owner fields;
the PML profile is shared, and so is the source shape unless it comes
with the candidate axis too, (K, n, n). On a `Slab` the state,
source shape and owner fields are (.., n, slab.w) column slabs of the
global grid, the profile stays the global (n,) one, the energies cover
the slab's owned columns, and the new state's halo columns are 0; a slab
taking spc steps a launch has 4 spc halo columns a side. Stacked
slabs take a leading slab axis S on the state, source shape and owner
fields, and share the cylinders and the profile.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..designs import lerp_weight
from .fd import dx_edge_aware, dx_split_bf16, dy_edge_aware

_PKG = Path(__file__).resolve().parent.parent
# the two libraries, built in parallel, and the header both include
SOURCES = {"fused_rk4": _PKG / "csrc" / "fused_rk4.cu",
           "fused_rk4_multi": _PKG / "csrc" / "fused_rk4_multi.cu"}
HEADER = _PKG / "csrc" / "fused_rk4_common.cuh"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # every a*b+c rounds twice, as in the plain version
    "-fmad=false",
    "-Xptxas", "-v",
)
HALO = 4  # halo cells one RK4 step consumes on each side (pallas_fd.py:31)
TILE = (16, 24)  # rows and columns of a block's tile in `rk4_step_tiled` (TX, TY)
OWNER_TILE = (16, 64)  # rows and columns of a block's tile in `select_owner_kernel`

STEPS_PER_CALL = (1, 2, 4)  # RK4 steps a launch takes

launch_counts = {"fused_rk4_general": 0, "fused_rk4_radii_only": 0, "select_owner": 0,
                 "fused_rk4_batched_general": 0, "fused_rk4_batched_radii_only": 0,
                 "select_owner_batched": 0, "fused_rk4_sharded_general": 0,
                 "fused_rk4_sharded_radii_only": 0, "select_owner_sharded": 0,
                 "fused_rk4_xmatmul_general": 0, "fused_rk4_xmatmul_radii_only": 0,
                 "fused_rk4_batched_xmatmul_general": 0,
                 "fused_rk4_batched_xmatmul_radii_only": 0,
                 "fused_rk4_sharded_xmatmul_general": 0,
                 "fused_rk4_sharded_xmatmul_radii_only": 0}
# the multi-step launches, by the one-step counter's name and "_spc2" or "_spc4"
launch_counts.update({f"{k}_spc{spc}": 0 for k in list(launch_counts)
                      if k.startswith("fused_rk4") for spc in (2, 4)})


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclass(frozen=True)
class StepConfig:
    """Static parameters of the step: an n x n grid with coordinates
    x_min + i * spacing on both axes, time step dt, ambient speed c0 and
    source frequency freq."""

    n: int
    spacing: float
    x_min: float
    dt: float
    c0: float
    freq: float

    @property
    def inv2d(self) -> float:
        return 1.0 / (2.0 * self.spacing)


@dataclass(frozen=True)
class Slab:
    """One column slab of the global n x n grid (K4): `w` local columns,
    local column j at global column col0 + j, `halo` halo columns on each
    side of the owned ones: HALO for one step a launch, 4 spc for spc steps
    (the JAX kernel's `y_ghost`). A shard of ny_local columns from global
    column `start` is Slab(w=ny_local + 2 halo, col0=start - halo, halo)."""

    w: int
    col0: int
    halo: int = HALO

    @property
    def ny(self) -> int:
        """Owned columns."""
        return self.w - 2 * self.halo

    def columns(self, device) -> torch.Tensor:
        """(w,) global column index of each local column."""
        return torch.arange(self.col0, self.col0 + self.w, device=device)


def _extent(cfg: StepConfig, slab: Slab | None) -> tuple[int, int]:
    """(w, col0) of the whole grid or of a slab."""
    return (cfg.n, 0) if slab is None else (slab.w, slab.col0)


def _check_halo(slabs, steps_per_call: int) -> None:
    """Raise unless each slab's halo is 4 cells a step of a launch of
    `steps_per_call` steps: what the steps consume, and the band the kernel
    carries (slabs None or empty: the whole grid)."""
    for s in slabs or ():
        if s.halo != HALO * steps_per_call:
            raise ValueError(f"a slab with a {s.halo}-column halo takes steps_per_call "
                             f"{s.halo / HALO:g}, not {steps_per_call}")


def stage_times(t: float, dt: float):
    """float32 times of the k1, k2/k3 and k4 stages of a step from t, in the
    JAX kernel's arithmetic."""
    f = np.float32
    t0 = f(t)
    return t0, t0 + f(0.5 * dt), t0 + f(dt)


def substep_times(t: float, spc: int, dt: float) -> list[np.float32]:
    """float32 start times of the `spc` RK4 steps of one kernel call from
    time t, as the JAX kernel forms them (pallas_fd.py:362): sub-step st
    at float32(t + float32(st * dt))."""
    f = np.float32
    return [f(f(t) + f(st * dt)) for st in range(spc)]


def call_step_times(call_times, spc: int, dt: float) -> list[float]:
    """The start time of every step of a window whose kernel calls start at
    `call_times`, `spc` steps a call (`substep_times`)."""
    return [float(ts) for t in call_times for ts in substep_times(t, spc, dt)]


def step_flops(n: int, n_cyl: float, radii_only: bool, w: int | None = None,
               x_matmul: bool = False, steps_per_call: int = 1) -> float:
    """Float32 operations of `steps_per_call` RK4 steps (one unless given)
    on an n x w grid (w = n unless given), the steps' own work without the
    cells a multi-step launch recomputes in its band: per cell and
    stage, 12 stage inputs u + a k (2 each) and per stack 4 edge derivatives
    (3 each), U + f at the 4 stencil points (2 each) and the right-hand side
    (19), plus the rasterisation (5 for the owner test, 14 per cylinder in
    the general mode, `n_cyl` the cylinders a cell tests: `tile_cylinders`
    for what a run's data needs, where the kernel skips the cylinders that
    cannot reach a tile); per cell and step, the combine (12 x 6) and the
    energies (6). With `x_matmul` each stack's 2 x-derivatives split their
    2 taps (4 conversions and a subtract each) and take the stencil twice
    and a sum: 14 operations each in place of 3."""
    raster = 5 if radii_only else 14 * n_cyl
    split = 2 * 2 * (14 - 3) if x_matmul else 0
    per_stage = 12 * 2 + 2 * (4 * 3 + 4 * 2 + 19) + split + raster
    return steps_per_call * n * (w or n) * (4 * per_stage + 12 * 6 + 6)


def call_bytes(n: int, n_cyl: int, steps_per_call: int = 1, batch: int = 1) -> int:
    """Bytes a launch of `steps_per_call` steps of `batch` states on the
    whole n x n grid must move at least: each state read and written once,
    the shared source shape, the profile and the (8, n_cyl) cylinders of
    each state read once, and one row of three energy partials a tile and
    step written. The radii-only owner fields are a layout of the design
    made once a window, and stay out."""
    tiles = -(-n // TILE[0]) * -(-n // TILE[1])
    floats = (2 * batch * 12 * n * n + n * n + n + batch * 8 * n_cyl
              + steps_per_call * batch * tiles * 3)
    return 4 * floats


def band_work_share(n: int, steps_per_call: int) -> float:
    """The share of the cells a launch of `steps_per_call` steps on the whole
    n x n grid computes, summed over its stages, that are computed more than
    once: the halo and band cells each block recomputes (the regions of
    `fused_rk4_step_tiled_reference`) over all the cells its stages compute.
    The rest, n^2 a stage, is the steps' own work."""
    done = 0
    for i0 in range(0, n, TILE[0]):
        i1, rlo, rhi = _tile_region(i0, TILE[0], n, halo=HALO * steps_per_call)
        for j0 in range(0, n, TILE[1]):
            j1, clo, chi = _tile_region(j0, TILE[1], n, halo=HALO * steps_per_call)
            span = (rlo, rhi, clo, chi)
            for s in range(4 * steps_per_call):
                span = (*_shrink(span[0], span[1], n), *_shrink(span[2], span[3], n))
                if s == 4 * steps_per_call - 1:
                    span = (i0, i1, j0, j1)
                done += (span[1] - span[0] + 1) * (span[3] - span[2] + 1)
    return 1.0 - 4 * steps_per_call * n * n / done


def tile_cylinders(cyl: torch.Tensor, cfg: StepConfig, w: float = 0.5) -> float:
    """The mean number of cylinders the general rasterisation must test a
    cell of the whole grid when each tile of `TILE` tests only those that
    `cull_cylinders` keeps for the tile's box at lerp weight w (the kernel
    culls against its region's box, the tile and its halo, at each stage's
    weight, so it tests at least these). cyl (8, n_cyl), or (K, 8, n_cyl)
    for the mean over K: the `n_cyl` of `step_flops` for this data."""
    cyl = cyl.detach().to("cpu", torch.float32)
    cyl = cyl if cyl.dim() == 3 else cyl[None]
    n = cfg.n
    coord = _coords(cfg, "cpu")[0]
    reach_of = {}
    for axis, size in ((0, TILE[0]), (1, TILE[1])):
        start = torch.arange(0, n, size)
        stop = torch.clamp(start + size, max=n)
        lo, hi = coord[start], coord[stop - 1]
        p = cyl[:, axis] + w * (cyl[:, 4 + axis] - cyl[:, axis])  # (K, n_cyl)
        reach = torch.abs(cyl[:, 2] + w * (cyl[:, 6] - cyl[:, 2])) + cfg.spacing
        meets = ((p - reach)[..., None] <= hi) & ((p + reach)[..., None] >= lo)
        reach_of[axis] = (meets.to(torch.float64) * (stop - start).to(torch.float64)).sum(-1)
    return float((reach_of[0] * reach_of[1]).sum()) / (cyl.shape[0] * n * n)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _coords(cfg: StepConfig, device, slab: Slab | None = None):
    """(x of each row, y of each local column): x_min + index * spacing at
    the global index."""
    idx = torch.arange(cfg.n, dtype=torch.float32, device=device)
    x = cfg.x_min + idx * cfg.spacing
    if slab is None:
        return x, x
    return x, cfg.x_min + slab.columns(device).to(torch.float32) * cfg.spacing


def owner_boxes(cyl: torch.Tensor, spacing: float) -> torch.Tensor:
    """(4, n_cyl) [x_lo, x_hi, y_lo, y_hi] of each cylinder's box
    [p - rmax, p + rmax], rmax = max(r1, r2), widened by `spacing` on both
    axes, in the float32 arithmetic of `select_owner_kernel`."""
    reach = torch.maximum(cyl[2], cyl[6]) + spacing
    return torch.stack([cyl[0] - reach, cyl[0] + reach, cyl[1] - reach, cyl[1] + reach])


def _owner_fields(cyl, box, x, y) -> torch.Tensor:
    """(5, rows, cols) owner fields at row coordinates x (rows, 1) and
    column coordinates y (1, cols), over the cylinders `cyl` (8, m) with
    their boxes `box` (4, m), in order."""
    shape = (x.shape[0], y.shape[1])
    best = torch.full(shape, 1e30, dtype=torch.float32, device=cyl.device)
    d2o = best.clone()
    r1, dr, c1, dc = (torch.zeros(shape, dtype=torch.float32, device=cyl.device) for _ in range(4))
    for q in range(cyl.shape[1]):
        inside = (box[0, q] <= x) & (x <= box[1, q]) & (box[2, q] <= y) & (y <= box[3, q])
        ddx = x - cyl[0, q]
        ddy = y - cyl[1, q]
        d2 = ddx * ddx + ddy * ddy
        rmax = torch.maximum(cyl[2, q], cyl[6, q])
        gap = d2 - rmax * rmax
        upd = inside & (gap < best)
        best = torch.where(upd, gap, best)
        d2o = torch.where(upd, d2, d2o)
        r1 = torch.where(upd, cyl[2, q], r1)
        dr = torch.where(upd, cyl[6, q] - cyl[2, q], dr)
        c1 = torch.where(upd, cyl[3, q], c1)
        dc = torch.where(upd, cyl[7, q] - cyl[3, q], dc)
    return torch.stack([d2o, r1, dr, c1, dc])


def select_owner_reference(cyl: torch.Tensor, cfg: StepConfig,
                           slab: Slab | None = None) -> torch.Tensor:
    """(5, n, w) owner fields [d2, r1, r2 - r1, c1, c2 - c1] over the whole
    grid (w = n) or a slab: each cell's owner is, of the cylinders whose
    `owner_boxes` box holds the cell, the one with the smallest gap
    d2 - rmax^2 (first in order on ties); a cell that no box holds gets
    [1e30, 0, 0, 0, 0], which no stage's test d2 < r^2 passes. Where a
    cylinder covers a cell at any lerp weight (gap < 0) it is the owner,
    as it is over all cylinders; elsewhere a cylinder outside the box is
    far enough that the stage test fails for it too, so the step's state
    is that of the nearest-gap owner over all cylinders."""
    xs, ys = _coords(cfg, cyl.device, slab)
    return _owner_fields(cyl, owner_boxes(cyl, cfg.spacing), xs[:, None], ys[None, :])


def select_owner_tiled_reference(cyl: torch.Tensor, cfg: StepConfig, slab: Slab | None = None,
                                 tile: tuple[int, int] = OWNER_TILE) -> torch.Tensor:
    """The owner fields computed tile by tile as `select_owner_kernel`
    decomposes the pass: tiles of `tile` rows and local columns from the
    grid's first, each over the cylinders whose box meets the tile's box
    (its first and last row's x, first and last column's y) alone, in
    order. For the tests alone, which hold it equal to
    `select_owner_reference` without a card."""
    xs, ys = _coords(cfg, cyl.device, slab)
    box = owner_boxes(cyl, cfg.spacing)
    out = torch.empty((5, xs.shape[0], ys.shape[0]), dtype=torch.float32, device=cyl.device)
    for i0 in range(0, xs.shape[0], tile[0]):
        tx = xs[i0:i0 + tile[0]]
        for j0 in range(0, ys.shape[0], tile[1]):
            ty = ys[j0:j0 + tile[1]]
            keep = ((box[0] <= tx[-1]) & (box[1] >= tx[0]) & (box[2] <= ty[-1])
                    & (box[3] >= ty[0]))
            out[:, i0:i0 + tile[0], j0:j0 + tile[1]] = _owner_fields(
                cyl[:, keep], box[:, keep], tx[:, None], ty[None, :])
    return out


def _rasterize(cyl, x, y, w: float, c0: float) -> torch.Tensor:
    """Wavespeed of the cylinders lerped to weight w: the sum of the speeds
    of the cylinders that cover a cell, c0 where none does."""
    csum = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32, device=cyl.device)
    inside = torch.zeros_like(csum)
    for q in range(cyl.shape[1]):
        px = cyl[0, q] + w * (cyl[4, q] - cyl[0, q])
        py = cyl[1, q] + w * (cyl[5, q] - cyl[1, q])
        r = cyl[2, q] + w * (cyl[6, q] - cyl[2, q])
        c = cyl[3, q] + w * (cyl[7, q] - cyl[3, q])
        ddx = x - px
        ddy = y - py
        m = ((ddx * ddx + ddy * ddy) < r * r).to(torch.float32)
        csum = csum + m * c
        inside = inside + m
    return torch.where(inside == 0.0, torch.full_like(csum, c0), csum)


def _dy(u, inv2d: float, lo: int, hi: int):
    """d/dy along axis -1 as `dy_edge_aware`, and one-sided also at local
    columns lo and hi, where a slab holds the domain's first and last
    columns away from its own edges."""
    d = dy_edge_aware(u, inv2d)
    w = u.shape[-1]
    if 0 < lo < w - 2:
        d[..., lo] = (-3.0 * u[..., lo] + 4.0 * u[..., lo + 1] - u[..., lo + 2]) * inv2d
    if 1 < hi < w - 1:
        d[..., hi] = (3.0 * u[..., hi] - 4.0 * u[..., hi - 1] + u[..., hi - 2]) * inv2d
    return d


def _stack_rhs(v, b, f, sx, sy, bc, inv2d, lo, hi, dx):
    U, Vx, Vy, Px, Py, Om = v
    Vxx = dx(Vx, inv2d)
    Vyy = _dy(Vy, inv2d, lo, hi)
    Uf = U + f
    Ux = dx(Uf, inv2d)
    Uy = _dy(Uf, inv2d, lo, hi)
    dU = b * (Vxx + Vyy) + Px + Py - (sx + sy) * U - Om
    dVx = Ux - sx * Vx
    dVy = Uy - sy * Vy
    dPx = b * sx * Vyy
    dPy = b * sy * Vxx
    dOm = sx * sy * U
    return [bc * dU, dVx, dVy, dPx, dPy, dOm]


def fused_rk4_step_reference(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig,
                             slab: Slab | None = None, x_matmul: bool = False,
                             steps_per_call: int | None = None):
    """Plain PyTorch version of `fused_rk4_step`: the same equations, op
    order, rasterisation, closed-form RK4 combine and energies, on the whole
    grid or on a slab (its halo columns come out 0, energies cover the owned
    columns); d/dx split in bf16 with `x_matmul`. Returns
    (u_next (12, n, w), energies (3,)). With `steps_per_call` spc, the
    state takes spc chained steps from t at the JAX kernel's sub-step times
    (`substep_times`), and the energies after each are (spc, 3). A slab's
    halo (4 spc columns) is zeroed after the last step alone: each step
    leaves 4 fewer columns a side valid, the owned ones after the last, as
    in the JAX kernel's ghost columns."""
    spc = steps_per_call or 1
    _check_halo([slab] if slab is not None else None, spc)
    es = []
    for ts in substep_times(t, spc, cfg.dt):
        u, e = _plain_step(u, shape, prof, cyl, owner, float(ts), ti, tf, cfg, slab, x_matmul)
        es.append(e)
    if slab is not None:
        u[:, :, :slab.halo] = 0.0
        u[:, :, slab.w - slab.halo:] = 0.0
    return u, (torch.stack(es) if steps_per_call is not None else es[0])


def _plain_step(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig, slab: Slab | None,
                x_matmul: bool):
    """One plain step of `fused_rk4_step_reference` on the whole grid or a
    slab, the slab's halo columns left as computed: (u_next, energies of
    the owned columns (3,))."""
    n = cfg.n
    dev = u.device
    xs, ys = _coords(cfg, dev, slab)
    x, y = xs[:, None], ys[None, :]
    rows = torch.arange(n, device=dev)
    cols = rows if slab is None else slab.columns(dev)
    w, col0 = _extent(cfg, slab)
    halo = 0 if slab is None else slab.halo
    sx, sy = prof[:, None], prof[cols.clamp(0, n - 1)][None, :]
    bc = (((rows > 0) & (rows < n - 1))[:, None]
          & ((cols > 0) & (cols < n - 1))[None, :]).to(torch.float32)
    lo, hi = -col0, n - 1 - col0  # local columns of the domain's edges
    c0 = float(np.float32(cfg.c0))
    b_inc = float(np.float32(cfg.c0) * np.float32(cfg.c0))
    two_pi_f = np.float32(2.0 * math.pi)
    dx = dx_split_bf16 if x_matmul else dx_edge_aware

    def rhs(v, ts):
        w = lerp_weight(ts, ti, tf)
        if owner is not None:
            r = owner[1] + w * owner[2]
            c = torch.where(owner[0] < r * r, owner[3] + w * owner[4], torch.full_like(r, c0))
        else:
            c = _rasterize(cyl, x, y, w, c0)
        sn = torch.sin(torch.tensor(two_pi_f * np.float32(ts) * np.float32(cfg.freq), device=dev))
        f = shape * sn
        d_tot = _stack_rhs(v[0:6], c * c, f, sx, sy, bc, cfg.inv2d, lo, hi, dx)
        d_inc = _stack_rhs(v[6:12], b_inc, f, sx, sy, bc, cfg.inv2d, lo, hi, dx)
        return torch.stack(d_tot + d_inc)

    half, full, sixth = 0.5 * cfg.dt, cfg.dt, cfg.dt / 6.0
    t0, th, t1 = stage_times(t, cfg.dt)
    k1 = rhs(u, t0)
    k2 = rhs(u + half * k1, th)
    k3 = rhs(u + half * k2, th)
    k4 = rhs(u + full * k3, t1)
    u = u + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    own = u[:, :, halo:w - halo]
    sc = own[0] - own[6]
    return u, torch.stack([torch.sum(own[0] * own[0]), torch.sum(own[6] * own[6]),
                           torch.sum(sc * sc)])


def select_owner_batched_reference(cyl: torch.Tensor, cfg: StepConfig) -> torch.Tensor:
    """(K, 5, n, n) owner fields of K candidates' cylinders (K, 8, n_cyl),
    each as `select_owner_reference` gives them."""
    return torch.stack([select_owner_reference(c, cfg) for c in cyl])


def select_owner_slabs_reference(cyl: torch.Tensor, cfg: StepConfig, slabs: list) -> torch.Tensor:
    """(S, 5, n, w) owner fields of the cylinders (8, n_cyl) on each of S
    slabs, as `select_owner_reference` gives them."""
    return torch.stack([select_owner_reference(cyl, cfg, s) for s in slabs])


def fused_rk4_step_batched_reference(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig,
                                     x_matmul: bool = False, steps_per_call: int | None = None):
    """Plain PyTorch version of `fused_rk4_step_batched`: the plain step of
    each candidate in turn. Returns (u_next (K, 12, n, n), energies (K, 3),
    or (K, spc, 3) with `steps_per_call` spc)."""
    shapes = shape.expand(u.shape[0], *shape.shape[-2:])  # shared, or one a candidate
    steps = [fused_rk4_step_reference(u[b], shapes[b], prof, cyl[b],
                                      None if owner is None else owner[b], t, ti, tf, cfg,
                                      x_matmul=x_matmul, steps_per_call=steps_per_call)
             for b in range(u.shape[0])]
    return torch.stack([s[0] for s in steps]), torch.stack([s[1] for s in steps])


def fused_rk4_step_slabs_reference(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig,
                                   slabs: list, x_matmul: bool = False,
                                   steps_per_call: int | None = None):
    """Plain PyTorch version of `fused_rk4_step_slabs`: the plain step of
    each slab in turn. Returns (u_next (S, 12, n, w), energies (S, 3), or
    (S, spc, 3) with `steps_per_call` spc)."""
    steps = [fused_rk4_step_reference(u[k], shape[k], prof, cyl,
                                      None if owner is None else owner[k], t, ti, tf, cfg, s,
                                      x_matmul, steps_per_call)
             for k, s in enumerate(slabs)]
    return torch.stack([s[0] for s in steps]), torch.stack([s[1] for s in steps])


def _tile_region(start: int, size: int, n: int, stop: int | None = None, halo: int = HALO
                 ) -> tuple[int, int, int]:
    """(tile's last index, region's first, region's last) along one axis for
    the tile of `size` from `start`, cut at `stop` (the end of a slab's
    owned columns; n by default), as `rk4_step_tiled` takes them: `halo`
    cells a side (HALO, or the band of 4 spc cells of `rk4_steps_tiled`),
    one more before a one-cell tile on the last index (its one-sided
    stencil reaches five cells inward), cut at the domain."""
    end = min(start + size, n if stop is None else stop) - 1
    return end, max(start - halo - (start == n - 1), 0), min(end + halo, n - 1)


def _shrink(lo: int, hi: int, n: int) -> tuple[int, int]:
    """Where a stage's outputs are valid, given where its input is: one cell
    in from each side but a side on the domain's edge."""
    return (lo if lo == 0 else lo + 1), (hi if hi == n - 1 else hi - 1)


def cull_cylinders(cyl, w: float, xs, ys, spacing: float) -> torch.Tensor:
    """(n_cyl,) bool: the cylinders, lerped to weight w, whose box
    [p - |r|, p + |r|] widened by `spacing` meets the box of the region
    with row coordinates xs and column coordinates ys on both axes, in the
    float32 arithmetic of `rk4_step_tiled`'s cull. A cylinder that covers a
    cell of the region is never dropped."""
    px = cyl[0] + w * (cyl[4] - cyl[0])
    py = cyl[1] + w * (cyl[5] - cyl[1])
    reach = torch.abs(cyl[2] + w * (cyl[6] - cyl[2])) + spacing
    return ((px - reach <= xs[-1]) & (px + reach >= xs[0])
            & (py - reach <= ys[-1]) & (py + reach >= ys[0]))


def _crop(x, have: tuple, want: tuple):
    """x over the global rows and columns `have` (r0, r1, c0, c1), cut to
    `want`, which lies inside."""
    return x[..., want[0] - have[0]:want[1] - have[0] + 1, want[2] - have[2]:want[3] - have[2] + 1]


def fused_rk4_step_tiled_reference(u, shape, prof, owner, t, ti, tf, cfg: StepConfig,
                                   tile: tuple[int, int] = TILE, x_matmul: bool = True,
                                   cyl=None, slab: Slab | None = None,
                                   steps_per_call: int | None = None):
    """The step computed tile by tile as the one-launch kernel
    `rk4_step_tiled` decomposes it, in plain PyTorch with the whole-grid
    plain version's own `_stack_rhs`, d/dx and rasterisation: split in bf16
    (K5) with `x_matmul`, else exact (K1, K2); radii-only on `owner`, or
    general on `cyl` where owner is None, each stage rasterising the region
    with the cylinders that `cull_cylinders` keeps for the tile's region at
    the stage's weight; on the whole grid, or on a slab (K4) whose tiles
    cover its owned columns alone. Each tile's region (the
    tile and its halo, `_tile_region`, in global rows and columns) runs the
    four stages on regions that shrink by one cell a side a stage
    (`_shrink`): the stencils run on the stage input's whole region, and
    its cells on a side inside the domain, one-sided there, are dropped.
    The tile keeps the closed-form combine; no cell outside the domain is
    held or read, and a slab's halo columns come out 0.

    With `steps_per_call` spc, the decomposition of `rk4_steps_tiled` on
    the whole grid or on a slab with a 4 spc-column halo: each region
    carries a band of 4 spc cells a side
    and runs spc steps at the JAX kernel's sub-step times
    (`substep_times`), the closed-form combine on the whole region where a
    step's new state is valid (the tile after the last), and the energies
    of the tile after each step. For the tests alone, which hold it equal
    to `fused_rk4_step_reference(..., x_matmul=x_matmul,
    steps_per_call=steps_per_call)` without a card. Returns (u_next
    (12, n, w), energies (3,), or (spc, 3) with `steps_per_call`)."""
    n = cfg.n
    dev = u.device
    spc = steps_per_call or 1
    _check_halo([slab] if slab is not None else None, spc)
    w, col0 = _extent(cfg, slab)
    own0, own1 = (0, n) if slab is None else (col0 + slab.halo, col0 + slab.halo + slab.ny)
    dx = dx_split_bf16 if x_matmul else dx_edge_aware
    c0 = float(np.float32(cfg.c0))
    b_inc = float(np.float32(cfg.c0) * np.float32(cfg.c0))
    two_pi_f = np.float32(2.0 * math.pi)
    half, full, sixth = 0.5 * cfg.dt, cfg.dt, cfg.dt / 6.0
    idx = torch.arange(n, device=dev)
    interior = (idx > 0) & (idx < n - 1)
    coord = _coords(cfg, dev)[0]
    out = torch.zeros_like(u)
    parts = []

    def rhs(v, ts, span, region):
        rows, cols = slice(span[0], span[1] + 1), slice(span[2], span[3] + 1)
        local = slice(cols.start - col0, cols.stop - col0)
        w = lerp_weight(ts, ti, tf)
        if owner is None:
            xs, ys = coord[region[0]:region[1] + 1], coord[region[2]:region[3] + 1]
            keep = cull_cylinders(cyl, w, xs, ys, cfg.spacing)
            c = _rasterize(cyl[:, keep], coord[rows][:, None], coord[cols][None, :], w, c0)
        else:
            own = owner[:, rows, local]
            r = own[1] + w * own[2]
            c = torch.where(own[0] < r * r, own[3] + w * own[4], torch.full_like(r, c0))
        sn = torch.sin(torch.tensor(two_pi_f * np.float32(ts) * np.float32(cfg.freq), device=dev))
        f = shape[rows, local] * sn
        sx, sy = prof[rows][:, None], prof[cols][None, :]
        bc = (interior[rows][:, None] & interior[cols][None, :]).to(torch.float32)
        lo, hi = -cols.start, n - 1 - cols.start  # local columns of the domain's edges
        d_tot = _stack_rhs(v[0:6], c * c, f, sx, sy, bc, cfg.inv2d, lo, hi, dx)
        d_inc = _stack_rhs(v[6:12], b_inc, f, sx, sy, bc, cfg.inv2d, lo, hi, dx)
        return torch.stack(d_tot + d_inc)

    for i0 in range(0, n, tile[0]):
        i1, rlo, rhi = _tile_region(i0, tile[0], n, halo=HALO * spc)
        for j0 in range(own0, own1, tile[1]):
            j1, clo, chi = _tile_region(j0, tile[1], n, own1, halo=HALO * spc)
            region = span = (rlo, rhi, clo, chi)
            tile_span = (i0, i1, j0, j1)
            us = u[:, rlo:rhi + 1, clo - col0:chi + 1 - col0]  # the state on `span`
            tile_parts = []
            for st, ts0 in enumerate(substep_times(t, spc, cfg.dt)):
                t0, th, t1 = stage_times(ts0, cfg.dt)
                start, v, ks = span, us, []
                for ts, a in ((t0, half), (th, half), (th, full), (t1, None)):
                    k = rhs(v, ts, span, region)
                    new = (*_shrink(span[0], span[1], n), *_shrink(span[2], span[3], n))
                    k = _crop(k, span, new)
                    span = new
                    ks.append((k, span))
                    if a is not None:
                        v = _crop(us, start, span) + a * k
                # the combine where the new state is valid, the tile after the last step
                fin = tile_span if st == spc - 1 else span
                k1, k2, k3, k4 = (_crop(k, s, fin) for k, s in ks)
                us = _crop(us, start, fin) + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
                span = fin
                own = _crop(us, fin, tile_span)
                sc = own[0] - own[6]
                tile_parts.append(torch.stack([torch.sum(own[0] * own[0]),
                                               torch.sum(own[6] * own[6]), torch.sum(sc * sc)]))
            out[:, i0:i1 + 1, j0 - col0:j1 + 1 - col0] = us
            parts.append(torch.stack(tile_parts))
    energies = torch.stack(parts).sum(dim=0)
    return out, (energies if steps_per_call is not None else energies[0])


# ---------------------------------------------------------------------------
# the kernel: build, bind, launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> tuple[dict, str]:
    """Compile the kernel libraries (`SOURCES`) that are not built yet for
    these sources, the header and these flags, one nvcc each, all started
    together. Returns their paths by name and nvcc's ptxas reports (empty
    when every library was already there)."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in (*SOURCES.values(), HEADER))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    libs = {name: BUILD_DIR / f"lib{name}_{digest}.so" for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmps = {name: libs[name].with_name(f"{libs[name].name}.{os.getpid()}.tmp") for name in todo}
    procs = {name: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmps[name]),
                                     str(SOURCES[name])],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in todo}
    outs = {name: p.communicate() for name, p in procs.items()}
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name].name} ({p.returncode}):\n"
                               f"{outs[name][0]}\n{outs[name][1]}")
    for name in todo:  # atomic: a concurrent build finds a whole library or none
        os.replace(tmps[name], libs[name])
    return libs, "".join(outs[name][1] for name in todo)


class _Library:
    """The loaded kernel libraries with their C signatures declared."""

    def __init__(self, paths: dict):
        self.cdlls = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the candidate count first, 1 for a single state
        self.owner = self._bind("fused_rk4", "select_owner", [I, P, I, P, I, I, I, I, F, F, P])
        # the one-launch step: the window's struct, u, out, partials, t
        self.step_tiled = self._bind("fused_rk4", "fused_rk4_step_tiled", [P, P, P, P, F])
        self.step_blocks = self._bind("fused_rk4", "fused_rk4_step_blocks", [I, I])
        self.step_smem = self._bind("fused_rk4", "fused_rk4_step_smem", [])
        self.step_occupancy = self._bind("fused_rk4", "fused_rk4_step_occupancy", [I, I, I])
        # two or four steps a launch: the same arguments as the one-step launch
        self.steps_tiled = self._bind("fused_rk4_multi", "fused_rk4_steps_tiled", [P, P, P, P, F])
        self.steps_smem = self._bind("fused_rk4_multi", "fused_rk4_steps_smem", [I])
        self.steps_occupancy = self._bind("fused_rk4_multi", "fused_rk4_steps_occupancy",
                                          [I, I, I, I])

    def _bind(self, lib: str, name: str, argtypes: list):
        fn = getattr(self.cdlls[lib], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


_library: _Library | None = None


def _lib() -> _Library:
    global _library
    if _library is None:
        paths, _ = build()
        _library = _Library(paths)
    return _library


def step_partial_rows(n: int, ny: int | None = None) -> int:
    """Rows of energy partials (one per tile) a one-launch step writes on n
    rows and ny owned columns (n unless given), per candidate or slab."""
    return _lib().step_blocks(n, ny or n)


# the one-launch step's instances, `rk4_step_tiled<XM, GENERAL, SLAB>`, by name
TILED_INSTANCES = {"split": (True, False, False), "exact": (False, False, False),
                   "split_general": (True, True, False), "exact_general": (False, True, False),
                   "split_slab": (True, False, True), "exact_slab": (False, False, True),
                   "split_general_slab": (True, True, True),
                   "exact_general_slab": (False, True, True)}
# the multi-step instances, `rk4_steps_tiled<XM, GENERAL, SPC, SLAB>`, by name
STEPS_INSTANCES = {f"{name}_spc{spc}": (xm, general, spc, slab)
                   for spc in (2, 4) for name, (xm, general, slab) in TILED_INSTANCES.items()}


def tiled_kernel_report() -> dict:
    """The one-launch kernel's dynamic shared memory a block, in bytes
    ("smem_bytes"), and the resident blocks an SM of each of its instances
    on the current device (the CUDA occupancy calculator, from the
    instance's registers and shared memory), by the names of
    `TILED_INSTANCES`: on the whole grid "split" (K5), "exact" (K2, K3),
    "split_general" (K5 general) and "exact_general" (K1, K3 general), and
    the same four on slabs with "_slab" (K4-XM, K4); the multi-step
    instances by the names of `STEPS_INSTANCES` ("split_spc2",
    "split_slab_spc2" and so on), with their shared memory as
    "smem_bytes_spc2" and "smem_bytes_spc4"."""
    lib = _lib()
    return {"smem_bytes": lib.step_smem(),
            **{f"smem_bytes_spc{spc}": lib.steps_smem(spc) for spc in (2, 4)},
            **{name: lib.step_occupancy(int(xm), int(general), int(slab))
               for name, (xm, general, slab) in TILED_INSTANCES.items()},
            **{name: lib.steps_occupancy(int(xm), int(general), spc, int(slab))
               for name, (xm, general, spc, slab) in STEPS_INSTANCES.items()}}


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {code}")


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (take
    the plain version); raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _check_cyl(cyl: torch.Tensor, lead: tuple, device: torch.device) -> int:
    n_cyl = cyl.shape[-1]
    _check("cyl", cyl, (*lead, 8, n_cyl), device)
    return n_cyl


def _key(kernel: str, batch: int | None, slab, x_matmul: bool = False) -> str:
    """Launch counter of `kernel` ("fused_rk4" or "select_owner") for a
    single state, a candidate batch (K3) or slabs (K4, `slab` not None),
    with the split d/dx (K5) if `x_matmul`."""
    if slab is not None:
        key = kernel + "_sharded"
    else:
        key = kernel if batch is None else kernel + "_batched"
    return key + "_xmatmul" if x_matmul else key


def step_key(batch: bool, x_matmul: bool, radii_only: bool, steps_per_call: int = 1,
             sharded: bool = False) -> str:
    """Launch counter of the step: on the whole grid, single or
    candidate-batched, or on slabs (`sharded`); split or exact d/dx,
    radii-only or general, with "_spc2" or "_spc4" for the launches that
    take two or four steps."""
    key = (_key("fused_rk4", 1 if batch else None, True if sharded else None, x_matmul)
           + ("_radii_only" if radii_only else "_general"))
    return key if steps_per_call == 1 else f"{key}_spc{steps_per_call}"


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch_owner(cyl: torch.Tensor, cfg: StepConfig, batch: int | None,
                  slabs: list | None = None) -> torch.Tensor:
    """Check the cylinders and launch the owner pass once: on the whole
    grid, of one design for batch None, else of `batch` candidates'
    designs; or of one design on consecutive `slabs`, stacked (batch
    len(slabs), or None for one slab unstacked)."""
    lead = () if batch is None else (batch,)
    if slabs is None:
        n_cyl = _check_cyl(cyl, lead, cyl.device)
        w, col0 = cfg.n, 0
    else:
        n_cyl = _check_cyl(cyl, (), cyl.device)
        w, col0 = _slab_extent(slabs)
    halo = HALO if slabs is None else slabs[0].halo
    owner = torch.empty((*lead, 5, cfg.n, w), dtype=torch.float32, device=cyl.device)
    key = _key("select_owner", batch, slabs)
    with torch.cuda.device(cyl.device):  # the launch goes to the current device
        code = _lib().owner(batch or 1, _ptr(cyl), n_cyl, _ptr(owner), cfg.n, w, col0, halo,
                            cfg.spacing, cfg.x_min, _stream(cyl.device))
    _raise_on(code, key)
    launch_counts[key] += 1
    return owner


def select_owner(cyl: torch.Tensor, cfg: StepConfig, slab: Slab | None = None) -> torch.Tensor:
    """K2's owner fields (5, n, n) for the window's cylinders, or K4's
    (5, n, slab.w) on a slab (see `select_owner_reference`)."""
    if not _on_card(cyl):
        return select_owner_reference(cyl, cfg, slab)
    return _launch_owner(cyl, cfg, None, None if slab is None else [slab])


def select_owner_slabs(cyl: torch.Tensor, cfg: StepConfig, slabs: list) -> torch.Tensor:
    """K4's owner fields (S, 5, n, w) of the cylinders (8, n_cyl) on S
    consecutive slabs of equal width and halo, stacked as
    `fused_rk4_step_slabs` and `SlabWindow` take them, in one launch (see
    `select_owner_slabs_reference`)."""
    if not _on_card(cyl):
        return select_owner_slabs_reference(cyl, cfg, slabs)
    return _launch_owner(cyl, cfg, len(slabs), slabs)


def select_owner_batched(cyl: torch.Tensor, cfg: StepConfig) -> torch.Tensor:
    """K3's owner fields (K, 5, n, n) for K candidates' cylinders
    (K, 8, n_cyl), in one launch (see `select_owner_batched_reference`)."""
    if not _on_card(cyl):
        return select_owner_batched_reference(cyl, cfg)
    return _launch_owner(cyl, cfg, cyl.shape[0])


class _TiledWindow(ctypes.Structure):
    """`TiledWindow` of csrc/fused_rk4.cu: what the one-launch step takes
    that is fixed for a window."""

    _fields_ = [("shape", ctypes.c_void_p), ("prof", ctypes.c_void_p),
                ("owner", ctypes.c_void_p), ("cyl", ctypes.c_void_p), ("stream", ctypes.c_void_p),
                *((name, ctypes.c_int)
                  for name in ("batch", "n", "w", "col0", "xm", "n_cyl", "shape_stride", "spc")),
                *((name, ctypes.c_float)
                  for name in ("inv2d", "c0", "freq", "half", "full", "sixth", "ti", "tf",
                               "x_min", "spacing")),
                ("sub", ctypes.c_float * 4)]


def _slab_extent(slabs: list) -> tuple[int, int]:
    """(w, col0 of the first) of consecutive slabs of equal width and halo;
    raises on any others."""
    first = slabs[0]
    for k, s in enumerate(slabs):
        if s.w != first.w or s.halo != first.halo or s.col0 != first.col0 + k * first.ny:
            raise ValueError(f"slabs {slabs} are not consecutive slabs of one width")
    return first.w, first.col0


class _TiledStep:
    """One launch a RK4 step, over one window: on the whole grid, of one
    state (batch None: K1, K2, or K5 with `x_matmul`) or of `batch`
    candidates (K3, or batched K5); or, with `slabs`, on those consecutive
    slabs, stacked (S, .., n, w) (K4, K4-XM; batch None for one slab, else
    S). Radii-only with `owner`, general on `cyl` where owner is None. The
    inputs fixed for the window are checked and marshalled once, and
    `launch` runs one RK4 step in one launch on the current stream of
    `dev`, the state's device, or `steps_per_call` (2 or 4; slabs with a
    4 spc-column halo) steps in one launch of `rk4_steps_tiled`, whose
    energy partials are (steps_per_call, batch, rows, 3)."""

    def __init__(self, shape, prof, owner, cyl, ti: float, tf: float, cfg: StepConfig,
                 batch: int | None, dev: torch.device, x_matmul: bool, slabs: list | None = None,
                 steps_per_call: int = 1):
        if steps_per_call not in STEPS_PER_CALL:
            raise ValueError(f"steps_per_call {steps_per_call} is not one of {STEPS_PER_CALL}")
        _check_halo(slabs, steps_per_call)
        n = cfg.n
        lead = () if batch is None else (batch,)
        if slabs is None:
            self.w, col0, cyl_lead, ny = n, 0, lead, n
            # K3 and batched K5 take one shared source shape or one a candidate
            shape_lead = lead if batch is not None and shape.dim() == 3 else ()
        else:
            if len(slabs) != (batch or 1):
                raise ValueError(f"{len(slabs)} slabs for a batch of {batch or 1}")
            self.w, col0 = _slab_extent(slabs)
            shape_lead, cyl_lead, ny = lead, (), slabs[0].ny
        _check("shape", shape, (*shape_lead, n, self.w), dev)
        _check("prof", prof, (n,), dev)
        if owner is None:
            n_cyl, held = _check_cyl(cyl, cyl_lead, dev), cyl
        else:
            _check("owner", owner, (*lead, 5, n, self.w), dev)
            n_cyl, held = 0, owner
        f = np.float32
        sub = (ctypes.c_float * 4)(*(f(st * cfg.dt) for st in range(4)))
        self.args = _TiledWindow(shape.data_ptr(), prof.data_ptr(), _ptr(owner), _ptr(cyl),
                                 _stream(dev).value, batch or 1, n, self.w, col0, int(x_matmul),
                                 n_cyl, n * n if slabs is None and shape_lead else 0,
                                 steps_per_call, cfg.inv2d, cfg.c0, cfg.freq, f(0.5 * cfg.dt),
                                 f(cfg.dt), f(cfg.dt / 6.0), ti, tf, cfg.x_min, cfg.spacing, sub)
        self.ref = ctypes.addressof(self.args)
        self.inputs = (shape, prof, held)  # alive while the struct points at them
        self.spc = steps_per_call
        self.fn = _lib().step_tiled if steps_per_call == 1 else _lib().steps_tiled
        self.key = (_key("fused_rk4", batch, slabs, x_matmul)
                    + ("_general" if owner is None else "_radii_only"))
        if steps_per_call > 1:
            self.key += f"_spc{steps_per_call}"
        self.rows = step_partial_rows(n, ny)

    def launch(self, u_ptr: int, out_ptr: int, partials_ptr: int, t: float) -> None:
        _raise_on(self.fn(self.ref, u_ptr, out_ptr, partials_ptr, t), self.key)
        launch_counts[self.key] += 1


def _launch_step(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig, batch: int | None,
                 slabs: list | None = None, x_matmul: bool = False, steps_per_call: int = 1):
    """Check the inputs and launch one RK4 step in one launch: of one state
    (K1 or K2) for batch None, else of `batch` candidates (K3); on
    consecutive slabs (K4) if given; with the split d/dx (K5) if
    `x_matmul`; or `steps_per_call` steps in one launch.
    Returns (u_next, energy partials (steps_per_call, batch or 1, tiles,
    3))."""
    dev = u.device
    step = _TiledStep(shape, prof, owner, cyl, ti, tf, cfg, batch, dev, x_matmul, slabs,
                      steps_per_call)
    _check("u", u, (*(() if batch is None else (batch,)), 12, cfg.n, step.w), dev)
    out = torch.empty_like(u)
    partials = torch.empty((steps_per_call, batch or 1, step.rows, 3), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        step.launch(u.data_ptr(), out.data_ptr(), partials.data_ptr(), float(t))
    return out, partials


def fused_rk4_step(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig,
                   slab: Slab | None = None, x_matmul: bool = False,
                   steps_per_call: int | None = None):
    """Advance the state one RK4 step from time t, with the design lerped
    over [ti, tf], in one launch. `owner` (from `select_owner`) selects the
    radii-only kernel K2; None selects the general kernel K1. With a slab,
    u, shape and owner are its (.., n, slab.w) columns and the step is
    K4's. `x_matmul` takes d/dx in the JAX kernel's bf16 split form (K5, or
    K4-XM on a slab). Returns (u_next, energies (3,)). With
    `steps_per_call` spc (1, 2 or 4; a slab's halo 4 spc columns), spc
    steps in one launch from t, sub-step st at `substep_times`, and
    energies (spc, 3)."""
    if not _on_card(u):
        return fused_rk4_step_reference(u, shape, prof, cyl, owner, t, ti, tf, cfg, slab,
                                        x_matmul, steps_per_call)
    out, partials = _launch_step(u, shape, prof, cyl, owner, t, ti, tf, cfg, None,
                                 None if slab is None else [slab], x_matmul,
                                 steps_per_call or 1)
    energies = partials[:, 0].sum(dim=1)
    return out, (energies if steps_per_call is not None else energies[0])


def fused_rk4_step_slabs(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig, slabs: list,
                         x_matmul: bool = False, steps_per_call: int | None = None):
    """Advance S consecutive slabs of equal width, stacked (S, 12, n, w) on
    one card, one RK4 step from time t in one launch (K4, or K4-XM with
    `x_matmul`): shape (S, n, w), owner (S, 5, n, w) from `select_owner`
    on each slab or None (the general mode), the cylinders (8, n_cyl) and
    the profile shared. Returns (u_next (S, 12, n, w), energies (S, 3)).
    With `steps_per_call` spc (slabs with a 4 spc-column halo), spc steps
    in one launch at `substep_times`, and energies (S, spc, 3)."""
    if not _on_card(u):
        return fused_rk4_step_slabs_reference(u, shape, prof, cyl, owner, t, ti, tf, cfg, slabs,
                                              x_matmul, steps_per_call)
    out, partials = _launch_step(u, shape, prof, cyl, owner, t, ti, tf, cfg, len(slabs), slabs,
                                 x_matmul, steps_per_call or 1)
    energies = partials.sum(dim=2).transpose(0, 1)
    return out, (energies if steps_per_call is not None else energies[:, 0])


def fused_rk4_step_batched(u, shape, prof, cyl, owner, t, ti, tf, cfg: StepConfig,
                           x_matmul: bool = False, steps_per_call: int | None = None):
    """Advance K candidate states (K, 12, n, n) one RK4 step from the same
    time t in one launch (K3, or batched K5), each with its own cylinders
    (K, 8, n_cyl) lerped over [ti, tf] and the source shape (n, n) shared
    or its own, (K, n, n). `owner` (K, 5, n, n) from
    `select_owner_batched` selects the radii-only mode, None the general
    one; `x_matmul` the split d/dx (K5). Each candidate's energy partials
    are summed in a fixed order. Returns (u_next (K, 12, n, n), energies
    (K, 3)); with `steps_per_call` spc, spc steps in one launch and
    energies (K, spc, 3)."""
    if not _on_card(u):
        return fused_rk4_step_batched_reference(u, shape, prof, cyl, owner, t, ti, tf, cfg,
                                                x_matmul, steps_per_call)
    out, partials = _launch_step(u, shape, prof, cyl, owner, t, ti, tf, cfg, u.shape[0],
                                 x_matmul=x_matmul, steps_per_call=steps_per_call or 1)
    energies = partials.sum(dim=2).transpose(0, 1)
    return out, (energies if steps_per_call is not None else energies[:, 0])


def _fields_out(u, times, every: int):
    """The (1 + steps // every, 2, n, n) tensor a window's displacement
    channels go into, channels (0, 6) of u already in its first slot."""
    fields = torch.empty((1 + len(times) // every, 2, *u.shape[-2:]), dtype=u.dtype,
                         device=u.device)
    fields[0].copy_(u[0::6])
    return fields


def _check_calls(times, keep, steps_per_call: int, fields_every: int, dt: float) -> None:
    """Raise unless a window of these step times can run `steps_per_call`
    steps a launch: whole calls, each call's step times its first one's
    `substep_times`, every kept step and every fields_every-th step the
    last of a call."""
    spc = steps_per_call
    if spc not in STEPS_PER_CALL:
        raise ValueError(f"steps_per_call {spc} is not one of {STEPS_PER_CALL}")
    if spc == 1:
        return
    if len(times) % spc:
        raise ValueError(f"{len(times)} steps are not whole calls of {spc}")
    off = [s for s in keep if (s + 1) % spc]
    if off:
        raise ValueError(f"kept steps {off} are not the last of a call of {spc}")
    if fields_every % spc:
        raise ValueError(f"fields_every {fields_every} is not whole calls of {spc}")
    for c in range(0, len(times), spc):
        want = [float(ts) for ts in substep_times(times[c], spc, dt)]
        if [float(ts) for ts in times[c:c + spc]] != want:
            raise ValueError(f"the step times from {times[c]} are not the sub-step times {want}")


def fused_rk4_window_reference(u, shape, prof, cyl, owner, times, ti, tf, cfg: StepConfig,
                               keep, x_matmul: bool = False, fields_every: int = 0,
                               steps_per_call: int = 1):
    """Plain version of `fused_rk4_window`, on any device: the plain step
    (`fused_rk4_step_reference`, or its batched form), step by step, at
    the same step times, which `steps_per_call` checks as the kernel's
    route does."""
    _check_calls(times, keep, steps_per_call, fields_every, cfg.dt)
    batch = u.shape[0] if u.dim() == 4 else None
    step = fused_rk4_step_reference if batch is None else fused_rk4_step_batched_reference
    fields = _fields_out(u, times, fields_every) if fields_every else None
    kept, energies = [], []
    for s, t in enumerate(times):
        u, e = step(u, shape, prof, cyl, owner, t, ti, tf, cfg, x_matmul=x_matmul)
        energies.append(e)
        if s in keep:
            kept.append(u)
        if fields_every and (s + 1) % fields_every == 0:
            fields[(s + 1) // fields_every].copy_(u[0::6])
    energies = torch.stack(energies)
    return (kept, energies) if fields is None else (kept, energies, fields)


def fused_rk4_window(u, shape, prof, cyl, owner, times, ti, tf, cfg: StepConfig,
                     keep, x_matmul: bool = False, fields_every: int = 0,
                     steps_per_call: int = 1):
    """Advance one state (12, n, n), or K candidates (K, 12, n, n) with
    their own cylinders and owner fields (and source shapes, where `shape`
    is (K, n, n)), through a window's steps from the
    float32 start times `times`, with the design lerped over [ti, tf], as
    `fused_rk4_step` or `fused_rk4_step_batched` would step by step. The new
    state of each step whose index is in `keep` is kept, in a tensor of its
    own. With `fields_every` > 0 (one state), the displacement channels
    (0, 6), u_tot and u_inc, of u and of the state after every
    fields_every-th step are copied into one (1 + steps // fields_every,
    2, n, n) tensor, returned third: the full field at a time stride
    without whole states kept. On the card, either mode in either d/dx form
    takes one launch a step, its window's fixed inputs marshalled once, its
    steps alternating between two state buffers made once (the input u is
    never written), and its energy partials (steps, K, blocks, 3) made once
    and reduced once. With `steps_per_call` 2 or 4 (the JAX kernel's
    temporal blocking) a launch takes that many steps from its first step's
    time: `times` must be whole calls, each call's step times its first
    one's `substep_times` (`call_step_times` forms them), and every kept
    step and every fields_every-th step the last of a call; the plain
    route steps at the same times. The CPU takes the plain version,
    `fused_rk4_window_reference`. Returns (the kept states in order,
    energies (steps, 3) or (steps, K, 3)[, fields])."""
    batch = u.shape[0] if u.dim() == 4 else None
    if fields_every and batch is not None:
        raise ValueError("fields_every takes one state, not a candidate batch")
    if not _on_card(u):
        return fused_rk4_window_reference(u, shape, prof, cyl, owner, times, ti, tf, cfg, keep,
                                          x_matmul, fields_every, steps_per_call)
    _check_calls(times, keep, steps_per_call, fields_every, cfg.dt)
    n, dev, spc = cfg.n, u.device, steps_per_call
    lead = () if batch is None else (batch,)
    _check("u", u, (*lead, 12, n, n), dev)
    _check_cyl(cyl, lead, dev)
    launcher = _TiledStep(shape, prof, owner, cyl, ti, tf, cfg, batch, dev, x_matmul,
                          steps_per_call=spc)
    calls = len(times) // spc
    partials = torch.empty((calls, spc, batch or 1, launcher.rows, 3), dtype=torch.float32,
                           device=dev)
    base, row_bytes = partials.data_ptr(), partials.stride(0) * partials.element_size()
    buffers = (torch.empty_like(u), torch.empty_like(u))
    fields = _fields_out(u, times, fields_every) if fields_every else None
    keep, kept = set(keep), []
    with torch.cuda.device(dev):  # the launches go to the current device
        for c in range(calls):
            s = c * spc + spc - 1  # the call's last step
            if s in keep:
                dst = torch.empty_like(u)
                kept.append(dst)
            else:
                dst = buffers[1] if u is buffers[0] else buffers[0]
            launcher.launch(u.data_ptr(), dst.data_ptr(), base + c * row_bytes,
                            float(times[c * spc]))
            u = dst
            if fields_every and (s + 1) % fields_every == 0:
                fields[(s + 1) // fields_every].copy_(u[0::6])
    energies = partials.sum(dim=3).reshape(calls * spc, batch or 1, 3)
    energies = energies if batch is not None else energies[:, 0]
    return (kept, energies) if fields is None else (kept, energies, fields)


class SlabWindow:
    """S consecutive slabs of equal width on one device, stacked
    (S, 12, n, w), through a window of `steps` RK4 steps as a sharded
    rollout drives them (K4, or K4-XM with `x_matmul`): shape (S, n, w),
    owner (S, 5, n, w) or None, the cylinders (8, n_cyl) and the profile
    shared, as `fused_rk4_step_slabs` takes them. `steps_per_call` spc
    steps a launch (slabs with a 4 spc-column halo), so `steps` must be
    whole calls. `u` is the current state, whose halo columns the caller
    refreshes before each `step(t)`; the u given becomes the first of two
    state buffers and the other is made once. `energies()` gives each
    slab's energies after each step taken, (steps, S, 3). On the card a
    call is one launch into the other buffer, the window's fixed inputs
    marshalled once, and the energy partials (calls, spc, S, tiles, 3)
    made once and reduced once, each slab's in the same order whatever S;
    on the CPU each slab takes the plain version in turn."""

    def __init__(self, u, shape, prof, cyl, owner, ti: float, tf: float, cfg: StepConfig,
                 slabs: list, steps: int, x_matmul: bool = False, steps_per_call: int = 1):
        if steps % steps_per_call:
            raise ValueError(f"{steps} steps are not whole calls of {steps_per_call}")
        self.u, self.taken, self.steps, self.spc = u, 0, steps, steps_per_call
        self._launcher = None
        if not _on_card(u):
            self._plain = lambda v, t: fused_rk4_step_slabs_reference(
                v, shape, prof, cyl, owner, t, ti, tf, cfg, slabs, x_matmul, steps_per_call)
            self._energies = [torch.empty((0, len(slabs), 3))]
            return
        self._launcher = _TiledStep(shape, prof, owner, cyl, ti, tf, cfg, len(slabs), u.device,
                                    x_matmul, slabs, steps_per_call)
        _check("u", u, (len(slabs), 12, cfg.n, self._launcher.w), u.device)
        self._other = torch.empty_like(u)
        self._partials = torch.empty((steps // steps_per_call, steps_per_call, len(slabs),
                                      self._launcher.rows, 3), dtype=torch.float32,
                                     device=u.device)
        self._row_bytes = self._partials.stride(0) * self._partials.element_size()

    def step(self, t: float) -> None:
        """Advance every slab `steps_per_call` RK4 steps from time t, at
        `substep_times`."""
        if self.taken == self.steps:
            raise RuntimeError(f"the window has {self.steps} steps")
        if self._launcher is None:
            self.u, e = self._plain(self.u, t)
            self._energies.append(e.transpose(0, 1))
        else:
            with torch.cuda.device(self.u.device):  # the launch goes to the current device
                self._launcher.launch(
                    self.u.data_ptr(), self._other.data_ptr(),
                    self._partials.data_ptr() + self.taken // self.spc * self._row_bytes,
                    float(t))
            self.u, self._other = self._other, self.u
        self.taken += self.spc

    def energies(self) -> torch.Tensor:
        """(steps taken, S, 3): each slab's energies after each step."""
        if self._launcher is None:
            return torch.cat(self._energies)
        p = self._partials[:self.taken // self.spc]
        return torch.stack([p[:, :, k].contiguous().sum(dim=2).reshape(self.taken, 3)
                            for k in range(p.shape[2])], dim=1)
