"""The y-sharded fused rollout: the RK4 step kernel K4 on each shard's
column slab, with a halo-column exchange between steps (counterpart of
`waves_jl_tpu/parallel/fused_domain.py`).

Shard k owns global columns [k ny_local, (k+1) ny_local) and keeps them in a
(12, n, ny_local + 2 HALO) slab with HALO halo columns on each side. Before
every step each slab's halos take its neighbours' owned edge columns; the
kernel applies one-sided stencils only at the true domain edges and writes
the halo columns 0, so an owned cell is bit for bit the whole-grid
kernel's. One process drives every shard. The shards are grouped by
device and each device's slabs are stacked in one tensor (`SlabWindow`): a
step is the halo exchange, two strided copies a device and a neighbour
copy each way between devices, then one launch a card (on the CPU, each
slab's plain step in turn), and the signal is read from the energy
partials once, at the end. With `x_matmul=True` each slab steps through
K4-XM, K5's split d/dx: the split acts along x, which is not sharded, so
an owned cell is K5's.

`build_stacked_rollout(..., steps_per_call=spc)` takes spc steps a launch
(the JAX kernel's `steps_per_call` with `y_ghost = HALO * spc`): each slab
keeps 4 spc halo columns a side, the exchange copies them once a call, and
call c starts at tspan[c spc], its sub-steps at the JAX kernel's times
t + float32(st dt) (`substep_times`). `make_fused_sharded_rollout` keeps
JAX's one step a call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_rk4 import (HALO, STEPS_PER_CALL, Slab, SlabWindow, StepConfig,
                             select_owner_slabs)
from .domain import sum_in_order
from .mesh import Mesh


def shard_slabs(n: int, n_shards: int, halo: int = HALO) -> list:
    """The `Slab` of each of n_shards shards of an n x n grid: shard k owns
    global columns [k ny_local, (k+1) ny_local) with `halo` halo columns on
    each side (HALO for one step a launch, 4 spc for spc steps)."""
    if n % n_shards:
        raise ValueError(f"n = {n} does not split into {n_shards} shards")
    ny_local = n // n_shards
    if ny_local < 2 * halo:
        raise ValueError(f"shards of {ny_local} columns are too thin for the {halo}-column halo")
    return [Slab(w=ny_local + 2 * halo, col0=k * ny_local - halo, halo=halo)
            for k in range(n_shards)]


def cut_slabs(x: torch.Tensor, slabs: list, devices) -> list:
    """Each slab's columns of the global field x (..., n, n), contiguous on
    its device, 0 outside the domain."""
    h = max(s.halo for s in slabs)
    x_ext = F.pad(x, (h, h))
    return [x_ext[..., s.col0 + h:s.col0 + h + s.w].to(d).contiguous()
            for s, d in zip(slabs, devices)]


def card_groups(devices) -> list:
    """[(device, shard indices)]: the runs of consecutive shards on one
    device, in shard order."""
    groups = []
    for k, d in enumerate(devices):
        if groups and groups[-1][0] == d:
            groups[-1][1].append(k)
        else:
            groups.append((d, [k]))
    return groups


def exchange_halos(groups: list, ny_local: int, halo: int = HALO) -> None:
    """Refresh every slab's halo columns in place. `groups` holds the slabs
    in shard order, stacked (S, 12, n, ny_local + 2 halo) in a tensor a
    group: the left halo takes the left neighbour's last `halo` owned
    columns, the right halo the right neighbour's first `halo`, by two
    strided copies within a group and a copy each way between neighbouring
    groups. The outer halos of the first and last slab stay as they are
    (0). Reads only owned columns and writes only halos, so the copies are
    independent of one another."""
    ny, h = ny_local, halo
    for x in groups:
        if x.shape[0] > 1:
            x[1:, :, :, :h].copy_(x[:-1, :, :, ny:ny + h])
            x[:-1, :, :, h + ny:].copy_(x[1:, :, :, h:2 * h])
    for a, b in zip(groups, groups[1:]):
        b[0, :, :, :h].copy_(a[-1, :, :, ny:ny + h])
        a[-1, :, :, h + ny:].copy_(b[0, :, :, h:2 * h])


def _energies(u: torch.Tensor) -> torch.Tensor:
    sc = u[0] - u[6]
    return torch.stack([torch.sum(u[0] * u[0]), torch.sum(u[6] * u[6]), torch.sum(sc * sc)])


def _check_cyl(cyl: torch.Tensor, n_cyl: int) -> None:
    if tuple(cyl.shape) != (8, n_cyl):
        raise ValueError(f"cyl has shape {tuple(cyl.shape)}, expected (8, {n_cyl})")


def _band(steps_per_call: int) -> int:
    """The halo columns of a slab taking `steps_per_call` steps a launch."""
    if steps_per_call not in STEPS_PER_CALL:
        raise ValueError(f"steps_per_call {steps_per_call} is not one of {STEPS_PER_CALL}")
    return HALO * steps_per_call


def _calls(tspan, steps_per_call: int) -> list:
    """The start times of a window's calls of `steps_per_call` steps:
    tspan[0], tspan[spc], ...; raises unless the steps are whole calls."""
    steps = len(tspan) - 1
    if steps % steps_per_call:
        raise ValueError(f"{steps} steps are not whole calls of {steps_per_call}")
    return [float(t) for t in tspan[:-1:steps_per_call]]


def make_fused_sharded_rollout(mesh: Mesh, n: int, spacing: float, dt: float, c0: float,
                               freq: float, n_cyl: int, x_min: float, radii_only: bool = False,
                               x_matmul: bool = False):
    """Build a y-sharded fused rollout over the mesh's devices.

    rollout(u0, tspan, cyl, shape, prof) -> (u_final, signal) with
      u0     (12, n, n) global state
      tspan  (steps+1,) host times; step k starts at tspan[k], and the
             design lerps over [tspan[0], tspan[-1]]
      cyl    (8, n_cyl) design lerp endpoints (see physics.fused.cyl_params)
      shape  (n, n) source spatial shape
      prof   (n,) PML sigma profile
    u_final is the global (12, n, n) state on the mesh's first device and
    signal the (steps+1, 3) [tot, inc, sc] energies, not multiplied by the
    cell area. `radii_only` selects the owner rasterisation (one owner pass
    a card a rollout, for all of its slabs), valid where
    `physics.fused.radii_only_ok` holds.
    `x_matmul` takes d/dx in the bf16 split form (K4-XM); the default is
    the exact stencil, as JAX's sharded rollout defaults to. Each card's
    slabs step in one launch (`build_stacked_rollout`).
    """
    cfg = StepConfig(n=n, spacing=spacing, x_min=x_min, dt=dt, c0=c0, freq=freq)
    return build_stacked_rollout(mesh, cfg, n_cyl, radii_only, x_matmul)


def build_stacked_rollout(mesh: Mesh, cfg: StepConfig, n_cyl: int, radii_only: bool,
                          x_matmul: bool = False, steps_per_call: int = 1):
    """The rollout of `make_fused_sharded_rollout` with each device's run of
    consecutive shards (`card_groups`) stacked in one `SlabWindow`, with
    the slabs' owner fields from one owner pass a card: per call of
    `steps_per_call` steps (the counterpart of `make_fused_acoustic_step`'s
    `steps_per_call` with `ny_local` and `y_ghost = HALO * spc`), the halo
    exchange of 4 spc columns and one launch of each window (one a card),
    call c from tspan[c spc] with its sub-steps at `substep_times`; the
    signal (steps + 1, 3) summed once at the end, in shard order, then each
    shard's in tile order. A window of steps that spc does not divide
    raises a ValueError."""
    n = cfg.n
    halo = _band(steps_per_call)
    slabs = shard_slabs(n, mesh.size, halo)
    ny_local = n // mesh.size
    groups = card_groups(mesh.devices)
    dev0 = mesh.devices[0]
    owned = slice(halo, halo + ny_local)

    def rollout(u0, tspan, cyl, shape, prof):
        _check_cyl(cyl, n_cyl)
        calls = _calls(tspan, steps_per_call)
        ti, tf = float(tspan[0]), float(tspan[-1])
        windows = []
        for dev, shards in groups:
            mine = [slabs[k] for k in shards]
            c = cyl.to(dev).contiguous()
            owner = select_owner_slabs(c, cfg, mine) if radii_only else None
            windows.append(SlabWindow(torch.stack(cut_slabs(u0, mine, [dev] * len(mine))),
                                      torch.stack(cut_slabs(shape, mine, [dev] * len(mine))),
                                      prof.to(dev).contiguous(), c, owner, ti, tf, cfg, mine,
                                      len(tspan) - 1, x_matmul, steps_per_call))
        e0 = sum_in_order([_energies(x[:, :, owned]) for w in windows for x in w.u], dev0)
        for t in calls:
            exchange_halos([w.u for w in windows], ny_local, halo)
            for w in windows:
                w.step(t)
        per_shard = torch.cat([w.energies().to(dev0) for w in windows], dim=1)
        signal = sum_in_order(list(per_shard.unbind(1)), dev0)
        u_final = torch.cat([x[:, :, owned].to(dev0) for w in windows for x in w.u], dim=-1)
        return u_final, torch.cat([e0[None], signal])

    return rollout


def build_rollout(mesh: Mesh, cfg: StepConfig, n_cyl: int, radii_only: bool, step, owner,
                  x_matmul: bool = False, steps_per_call: int = 1):
    """The plain rollout that `make_fused_sharded_rollout`'s and
    `build_stacked_rollout`'s are held against: each slab steps in turn
    through `step` with owner fields from `owner`, `fused_rk4_step_reference`
    and `select_owner_reference` (K4's plain version, K4-XM's with
    `x_matmul`), `steps_per_call` steps a call as `build_stacked_rollout`
    takes them."""
    n = cfg.n
    spc = steps_per_call
    halo = _band(spc)
    slabs = shard_slabs(n, mesh.size, halo)
    ny_local = n // mesh.size
    devs = mesh.devices

    def rollout(u0, tspan, cyl, shape, prof):
        _check_cyl(cyl, n_cyl)
        calls = _calls(tspan, spc)
        shapes = cut_slabs(shape, slabs, devs)
        us = cut_slabs(u0, slabs, devs)  # the first exchange refreshes the halos
        profs = [prof.to(d).contiguous() for d in devs]
        cyls = [cyl.to(d).contiguous() for d in devs]
        owners = [owner(c, cfg, s) if radii_only else None for c, s in zip(cyls, slabs)]
        ti, tf = float(tspan[0]), float(tspan[-1])
        signal = [sum_in_order([_energies(u[:, :, halo:halo + ny_local]) for u in us], devs[0])]
        for t in calls:
            exchange_halos([u[None] for u in us], ny_local, halo)
            stepped = [step(u, sh, pr, c, ow, t, ti, tf, cfg, s, x_matmul, spc)
                       for u, sh, pr, c, ow, s in zip(us, shapes, profs, cyls, owners, slabs)]
            us = [u for u, _ in stepped]
            signal += [sum_in_order([e[st] for _, e in stepped], devs[0]) for st in range(spc)]
        u_final = torch.cat([u[:, :, halo:halo + ny_local].to(devs[0]) for u in us], dim=-1)
        return u_final, torch.stack(signal)

    return rollout
