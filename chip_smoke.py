#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`waves_jl_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

from the root of the repository. Phases, each printing a flushed line with
its elapsed seconds:

1. device: the card's name and power limit;
2. build: the CUDA kernels from `waves_jl_tpu_torch/csrc/` with nvcc, one
   nvcc a library (`fused_rk4.cu`, `fused_rk4_multi.cu`) started together,
   with ptxas's register and spill report, and for the eight instances of
   the one-launch step `rk4_step_tiled` (the split d/dx or the exact one,
   the owner test or the general rasterisation, the whole grid or slabs)
   and the sixteen of `rk4_steps_tiled` (two or four steps a launch, the
   JAX kernel's `steps_per_call`, on the whole grid or on slabs with a
   4 spc-column halo) their registers, spills, shared memory, resident
   blocks an SM and, for the latter, the share of cell-stages their band
   recomputes at 700^2;
3. kernels: each kernel against its plain PyTorch version at 700^2, K1,
   K2 and K5 (the split d/dx, `x_matmul=True`, in both rasterisation
   modes) with the count of cells that differ (none: one launch a step,
   bit for bit), and the candidate-batched kernels K3 and K5 (16
   candidates at 350^2, coarsened from the 700^2 state) against their
   plain versions (none differing for either in the radii-only mode) and
   against K2 or K5 run on each candidate alone; the owner passes of the
   radii-only mode (whole grid, and 16 candidates at 350^2) against their
   plain versions, bit for bit on all five planes; the time of a step of
   K1, K2 and K5 in both modes, K3 and batched K5 radii-only as one call,
   as device work, and inside a 100-step window with the host's issue
   time, and of each owner pass as one call and as device work; then the
   two- and four-step launches: each of the eight single-state instances
   at 700^2 (40 steps radii-only, 20 general, at the JAX kernel's
   sub-step times) and K3 and batched K5 at two steps a launch with 16
   candidates at 350^2, against their plain versions and against one-step
   launches at the same times, bit for bit (the differing cells counted),
   each timed a launch beside its plain version and its bound (the state
   read and written once a launch); K5 and K2 a step at one, two and four
   steps a launch in turns, as device work (the probe of temporal
   blocking);
4. main path: a warm 20-action x 100-step MPC control episode at 700^2
   (triple-ring cloak, 256-shot random shooting on the stride-4 flagship
   surrogate with the tracked weights; one launch a step at the JAX
   window's step times, the default),
   3 of its actions taken on the kernel route and on the plain route from
   the same state and draws (the same actions, the frames bit for bit),
   the simulator's steps/s over 20 windows with `x_matmul=True` (K5) and
   `False` (K2), each by default and at two steps a launch, in turns, and a
   random-policy episode over a position-adjustable design space, the path
   of the general kernels (K5 general, and K1 with `x_matmul=False`), with
   one K = 4 re-rank window there in each mode (K5 and K3 general), each
   by default and at two steps a launch,
   batched kernel held against its plain version on that window's own
   states, cylinders and step times (bit for bit) and against the
   single-state kernel on each candidate, and timed alone and inside the
   window;
5. hybrid: a 20-action episode of the hybrid controller at full width
   (256 shots pruned by the fine-tuned stride-4 flagship, the best 16
   re-ranked exactly at 350^2 through batched K5, the winner applied at
   700^2 through K5), three of its selections replayed through the
   sequential re-rank, one selection split into prune, re-rank and env
   window, the batched re-rank against the sequential one and against the
   exact-stencil re-rank (K3), the batched re-rank by default (one launch
   a step) against two steps a launch in turns, and two exact-CEM rounds
   against one;
6. sharded: from phase 3's state, cylinders and window times, the y-sharded
   rollout (`parallel/fused_domain.py`, 4 shards of 175 columns on one
   card, all four slabs stacked and stepped by K4 in one launch a step,
   their owner fields from one owner pass) against the slab-by-slab plain
   rollout in both modes, and that owner pass against its plain version,
   bit for bit; the fused sharded rollout at 1, 2 and 4 shards against the
   K2 window bit for bit on the state, the general one at 1, 2 and 4
   shards against the K1 window, and against the plain sharded rollout
   (`parallel/domain.py`); K1 and the
   owner pass with 80 cylinders against their plain versions; a
   free-field window through K1; the times of a sharded step, host-driven
   and as device work, against K2's, the host's issue time, and one step
   of K4 on the 4 stacked slabs (one launch), each slab bit for bit its
   plain version's, halo columns included; then K4-XM, the sharded step
   with K5's split d/dx (`x_matmul=True`): the rollout against its plain
   version in both modes, the split sharded rollout at 1, 2 and 4 shards
   against the K5 window and the split general one against the K5 general
   window, bit for bit, its step time against K4's in turns, and one
   step of the stacked slabs against the plain version; then two and four
   steps a launch on the slabs (K4 and K4-XM with a 4 spc-column halo, both
   rasterisations): the 4-shard rollout over 20 steps against its plain
   version and against one step a launch at the same times, bit for bit,
   one launch a call, the owner pass on the wider slabs bit for bit, each
   rollout's ms a step host-driven and as device work beside one step a
   launch in turns, and one launch of the stacked slabs against its plain
   version (halo columns included) with its time, plain time and bound;
7. datagen at `bench.py`'s operating point (700^2, triple ring, Gaussian
   source at x = -10, 20 actions x 100 steps, random policy, chunks of 10
   episodes): one warm chunk, then two timed chunks, seconds per episode
   with the host pull; every leaf finite, the observations' shape, the
   scattered energy 0 in the first window and positive by the last, K5's
   launches; one episode through `.wbin`, `.npz` and a shard and back, bit
   for bit; the datagen CLI once, in a subprocess;
8. the record controllers at 700^2: CEM + gradient polish on the pools3
   surrogate at the record's configuration (256 shots, horizon 5, 3 rounds
   of 32 elites, 10 polish steps on the top 16 at lr 0.02), one selection
   split into population and polish, then an episode of 20 actions (5 if 20
   selections would take more than 90 s), with its checks; a 3-action warm
   CEM episode whose round-0 candidate 0 is the shifted previous plan; a
   20-action episode of the behaviour-cloned one-shot policy; one hybrid
   selection with a CEM searcher, its batched re-rank against the
   sequential one; the MPC evaluation CLI once, in a subprocess;
9. train: the flagship at the tracked record's width (`ref500_h8s4`,
   latent stride 4) from its weights, on phase 7's 20 episodes (18 train,
   2 validation) by the mixed-horizon recipe cut to horizons 1/4/8 (batch
   4, accumulate 8, lr 1e-4, sc_weight 4, checkpoint "sqrt"): a micro-step's
   time, host issue time and memory in each checkpoint mode; one cycle of
   `train_windowed` (3 updates, 24 micro-steps), every loss finite and no
   kernel launched; the card's gradient against the CPU's on one window
   (1e-4 a leaf); 10 updates at lr 1e-5 on a fixed batch lower its loss
   (`--save-train-batch NPZ` writes that batch and the loss trajectories
   at lr 1e-5 and 1e-4 to NPZ); the checkpoint's
   parameter names and shapes are the tracked checkpoint's, it reloads bit
   for bit and resumes to the uninterrupted run's next update (cuDNN
   deterministic); the train CLI once, in a subprocess, on phase 7's CLI
   dataset. Training launches none of the kernels, so it adds no row to
   the kernels' JSON line;
10. exact search and distillation at 700^2: the 256-shot oracle selection
   (horizon 5, alpha 1) in 4 chunks of 64 candidates through batched K5
   and its owner pass, timed on the host, on the card and as the host's
   issue time, its launches counted (they join the batched rows of the
   JSON line), the chosen cost the least, three shots replayed through the
   sequential `OracleShooting` (1e-6); one 64-candidate step (the
   oracle's), one launch of two steps at that shape and the owner pass
   held against their plain versions (the owner fields and the state bit
   for bit) and each launch against K5 on four candidates alone (bit for
   bit), each timed with its plain version and bound, and K3 at that
   shape and two steps a launch against its plain
   version (bit for bit); a 64-shot oracle episode cut to 3 actions; a
   pool harvest episode (16 candidates scored at 350^2, 20 states, epsilon
   0.2) whose pools round-trip through their npz; one DAgger probe under
   the pools3 CEM + polish searcher; a recorded random-shooting episode
   (epsilon 0.25) cut to 5 actions, through `.wbin` and back; pool-ranking
   updates from `ref500_h8s4` with the pool metrics before and after and
   the card's gradient against the CPU's (1e-4 a leaf); behaviour-cloning
   updates whose checkpoint has `bc_pools3`'s names and shapes; one
   gradient and one ensemble selection; the five new CLIs and the MPC
   CLI's three new controllers once each, in subprocesses;
11. baselines at full width from the tracked `ref500_node_r4b` and
   `ref500_pinn_r4` weights, on phase 7's episodes: the NODE's forward at
   horizons 1 and 8, its loss's float32 gradient held leaf by leaf to the
   CPU's and to float64 (`grad_precision.LEAF_LIMITS`), one forward and
   backward in "sqrt" timed; the PINN's chunked
   `predict_energy` against its forward, the forward against the CPU's,
   the loss's float32 gradient held leaf by leaf the same way,
   horizon 8 on the card, one loss forward and backward at batch 4 timed
   with its peak memory; one random-shooting
   selection through the PINN's forward (the controllers' fallback for a
   model without `predict_shot_energy`); the train CLI's `--model node`
   and `--model pinn`, the prediction CLI and the PINN acceptance run once
   each, in subprocesses. None of the CUDA kernels launches;
12. data parallelism and the bf16 options at the flagship's tracked width,
   on phase 7's episodes: `make_dp_scan_train_steps_windowed` (horizon 8,
   global batch 4, 2 micro-steps) on a mesh of every card, and on two
   shards of the card where there is one, and `train(mesh=)` for one
   chunk of one update, each against the single-device trainer on the
   same windows (each update's loss and averaged gradient within
   DP_GRAD_TOL, 1e-4 of a leaf, of the single device's at the same
   parameters, where one shard's gradient left unaveraged must read 10
   times that; against the single device's own trajectory within 1e-4 plus
   how far its gradient and loss move from its own trajectory's parameters
   to those the shards reached, which part from it by at most Adam's
   2 lr an update; after each update the
   leaves rtol 5e-3 / atol 2e-5 but where a gradient is within NEAR_ZERO
   of its leaf's largest, replicas bit for bit), with
   a micro-step's seconds and host share on each side, and no kernel
   launched; one 256-shot selection through `fast_ranking()` against
   float32 (costs 5e-2, the bf16 choice among float32's best 5%); the
   bf16-conv encoder against float32 (rtol 0.1 / atol 0.05), its forward
   and backward timed; `train --dp` and `mpc --fast` once each, in
   subprocesses;
13. full field at 700^2 from phase 3's state: `env_step_full` through the
   exact one-launch kernel (K2 and its owner pass; K1 on the position
   design) against its plain route on the card (frames and fields bit for
   bit, signal 1e-6), the window's host, device and issue ms; the same
   window at render size 350 and time stride 10 (the signal the full
   one's); `env_step_flux` against its formula in float64 (FLUX_TOL) with
   the flux's time and bound; `rollout_fields` under the random policy (5
   actions) and under 256-shot random shooting on the flagship (3 actions,
   the device half of `mpc --render`), frames 350^2 every 10 steps, each
   episode's signals replayed through `env_step_full`; the adjoint demo's
   optimisation (300 steps, 3 Adam steps, the loss falling); the
   latent-space dashboard's rollout and MSE (5 actions); the PML demo's
   free-field rollout. The drawing itself needs matplotlib, which the
   card's machine lacks, so no phase draws;
14. the long tail: the one-call hybrid episode (`make_hybrid_episode_fused`)
   at phase 5's configuration, 3 actions from a state 12 windows in: its
   warm time an action beside phase 5's (the same loop, which it is), its
   launches, and the synchronising CUDA calls inside it by site
   (`torch.cuda.set_sync_debug_mode("warn")`); a `profile_trace` of one
   fused-hybrid action that names `rk4_step_tiled` and times it;
   `generate_episodes_batch` at `bench.py`'s datagen point, batch 10, 5 of
   its 20 actions, through K3 radii-only with the exact d/dx (a source
   shape a candidate) and one batched owner pass a window, each episode
   against its reset and actions alone through K2 (final frames bit for
   bit, signals and observations within 1e-6), s an episode, the batched
   step and owner pass at 10 x 700^2 against their plain versions with
   their times and bounds; `debug_nans` over a plain 700^2 window (finite
   work passes, an injected NaN raises naming the op); the JAX package's
   3-D smoke (n = 48, 120 steps) and an n = 128 window of 20 steps (its
   first 4 held to the CPU's), pandemic and wildfire at 256^2 for 10
   steps, each on the card against the CPU (1e-5), the 3-D scattered field exactly 0 and its Dirichlet
   faces 0; the MPC CLI's `--fused-episode` once, in a subprocess beside
   them. `--only-long-tail` runs phases 1, 2 and 14 alone;
15. the entry points (`waves_jl_tpu_torch/entry_points.py`, the
   counterparts of `__graft_entry__.py`'s): `entry()` on the card, the flagship's
   forward at the production configuration held to the CPU's within 1e-4
   and timed; `dryrun_multichip(4)` on 4 shards (every card where there
   are 4, else 4 shards of one card), every result finite, its K4-XM slab
   launches and owner passes counted into the slabs' rows.

The launch counts of each kernel are read from the main-path runs alone,
each in its default configuration: every path takes one launch a step
(`rk4_step_tiled`), the whole-grid ones at the JAX window's and re-rank's
step times (two-step calls), and so do the slabs of one card (K4, K4-XM).
The two- and four-step instances (`rk4_steps_tiled`, counters ending in
`_spc2` and `_spc4`, the slabs' among them) run only where
`steps_per_call` is asked for: their
rows give `launches` 0, `on_main_path` false and, as `probe_launches`,
the launches of the run that asked for them. Every row gives
`steps_per_call`, and its `ms`, plain version and bound are those of one
launch; a general row's operations count the cylinders each tile keeps
(`tile_cylinders`), not every cylinder at every cell. The last lines are one JSON object describing every
kernel (`ms` with CUDA events around calls as the host drives them; the
rows of the step and of the owner passes add `device_ms`, the same
launches queued behind a device sleep, without the host's issue cost;
the rows of batched K5, K3 radii-only and the batched owner pass, which
run 16 candidates at 350^2, 64 at 700^2 (the oracle) and 10 at 700^2
(batched datagen), give phase 3's 16 x 350^2 numbers and, under
`shapes`, each shape's launches, errors, times and bound), then
{"ok": true, "device": ...}. Any failed check raises and the script exits
non-zero; without a CUDA card it exits non-zero before printing a result.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 700
SIZE_RERANK = 350  # the hybrid's re-rank grid
STEPS = 100
WINDOWS = 20
CHECKPOINT = "models/ref500_h8s4/checkpoint_step=2600"
CHECKPOINT_HYBRID = "models/ref500_h8s4_ft/checkpoint_step=1320"
CHECKPOINT_POOLS3 = "models/ref500_h8s4_pools3/checkpoint_step=1450"  # the CEM + polish record
CHECKPOINT_POLICY = "models/bc_pools3/checkpoint_step=4500"  # the one-shot policy record
# the CEM + polish record's controller (mpc_results_pools3_cem_polish10.json; the
# result does not record the polish's top-k, BASELINE.md:43 gives 16)
SHOTS = 256  # candidate sequences a selection scores with the surrogate
CEM_RECORD = dict(horizon=5, shots=SHOTS, alpha=1.0, iters=3, elites=32, polish_steps=10,
                  polish_topk=16, polish_lr=0.02)
STRIDE = 4
TOPK = 16  # candidates the hybrid re-ranks exactly
HORIZON = 5
CHUNK = 10  # datagen episodes a chunk, as bench.py times them
ORACLE_SHOTS = 256  # the oracle record's shots (mpc_results_oracle256.json)
ORACLE_EPISODE_SHOTS = 64  # the oracle episode's (mpc_results_oracle64.json)
POOL_UPDATES = 2  # pool-ranking updates phase 10 takes
# the baselines of phase 11: tracked weights at the reference widths
BASELINE_CHECKPOINTS = {"node": "models/ref500_node_r4b/checkpoint_step=2040",
                        "pinn": "models/ref500_pinn_r4/checkpoint_step=2000"}
BASELINE_WIDTH = dict(elements=1024, h_size=256, nfreq=500)
# Phase 12's data-parallel sums and the single device's differ in order, so
# a gradient near zero may take either sign, and Adam's step then differs
# by about 2 lr: parameters whose gradient is within this share of its
# leaf's largest magnitude are held to that, the rest to JAX's bounds. On
# the H100 the signs differed only at 3.6e-7 of a leaf's largest and below.
NEAR_ZERO = 1e-6
# Phase 12's averaged gradient against the single device's at the same
# parameters and windows, relative to each leaf's largest magnitude: on the
# H100 the largest reading was 1.721e-05 (`train(mesh=)`, two shards of one
# card), and one shard's gradient left unaveraged reads far above this
# limit (checked each run at 10 times it). The losses are held to the same.
DP_GRAD_TOL = 1e-4
# Kernel against plain version, relative to the largest magnitude: both run
# the same float32 operations in the same order (FMA contraction is off in
# the kernel), so they differ only where sinf and torch.sin round apart and
# where sums are reduced in another order, ~1e-7 a step. A stencil, index
# or rasterisation fault shows at 1e-3 or more.
REL_TOL = 1e-5
# RK4 steps a call of the JAX package's window for STEPS (frame segments
# [80, 10, 10] all even) and of its re-rank for an even STEPS
# (`physics.fused.default_steps_per_call`, `rerank_steps_per_call`): the
# default paths step at those calls' sub-step times one launch a step, and
# take SPC steps a launch (`rk4_steps_tiled`) where asked to
SPC = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12  # H100 SXM, outside the tensor cores


def log(phase: str, msg: str) -> None:
    print(f"[{time.time() - T0:8.2f} s] {phase}: {msg}", flush=True)


def rel_err(a, b) -> float:
    import torch

    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)).clamp_min(1e-30))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one warm call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one warm call,
    with the host out of the way: the calls are queued behind a device sleep
    of about 50 ms, so the events time the queued kernels back to back
    rather than the host's issue rate. The calls must take the host less
    time than the sleep and queue fewer than about 1,000 operations."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def differing_cells(got, want) -> str:
    """How many cells of two states differ, and by how much relative to
    the cell's own magnitude: an ulp of sinf against torch.sin upstream
    shows as about 2^-17 of the cell after K5's bf16 split, a fault as
    much more."""
    import torch

    diff = got != want
    n = int(diff.sum())
    if n == 0:
        return f"0 of {got.numel()} cells differ (bit for bit)"
    cell = float((torch.abs(got - want)[diff] / torch.abs(want)[diff].clamp_min(1e-30)).max())
    return f"{n} of {got.numel()} cells differ, by at most {cell:.3e} of the cell"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def owner_ops(cyl, cfg, slab=None) -> int:
    """Float32 operations the owner pass does on these cylinders (8, n_cyl):
    9 for each cell and each cylinder whose box holds it (the box tests,
    d2, the gap and its compare), counted from the boxes."""
    from waves_jl_tpu_torch.ops import fused_rk4 as fk

    xs, ys = fk._coords(cfg, cyl.device, slab)
    box = fk.owner_boxes(cyl, cfg.spacing)
    rows = ((xs[:, None] >= box[0]) & (xs[:, None] <= box[1])).sum(dim=0)
    cols = ((ys[:, None] >= box[2]) & (ys[:, None] <= box[3])).sum(dim=0)
    return 9 * int((rows * cols).sum())


def owner_sentinel_share(owner) -> float:
    """The share of cells whose owner fields are the sentinel: no
    cylinder's box holds them."""
    d2 = owner[..., 0, :, :]
    return float((d2 == 1e30).sum()) / d2.numel()


def host_s(fn):
    """(seconds on the host clock, result) of fn(), synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return time.time() - t, out


def window_step_ms(u, shape, prof, cyl, owner, times, ti, tf, cfg,
                   x_matmul: bool) -> tuple[float, float, float]:
    """(ms a step as the host drives a window through `fused_rk4_window`,
    ms a step as device work, ms the host takes to issue a step), single or
    batched by u's shape, radii-only on `owner` or general where it is None,
    with the split d/dx (K5) if `x_matmul`, else the exact one (K1-K3)."""
    import torch

    from waves_jl_tpu_torch.ops import fused_rk4 as fk

    def run(steps):
        return fk.fused_rk4_window(u, shape, prof, cyl, owner, times[:steps], ti, tf, cfg,
                                   [steps - 1], x_matmul)

    ms = cuda_ms(lambda: run(len(times)), 3) / len(times)
    dev = device_ms(lambda: run(20), 1) / 20
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(len(times))
    issue = (time.perf_counter() - t) * 1e3 / len(times)
    torch.cuda.synchronize()
    return ms, dev, issue


def build_env(space, device, n=SIZE):
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.env import make_wave_env
    from waves_jl_tpu_torch.sources import GaussianSource

    dim = two_dim(15.0, n, device=device)
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                   [0.3], [1.0], 1000.0)
    return make_wave_env(dim, space, source, integration_steps=STEPS, actions=WINDOWS)


def position_space(ring_space):
    """The triple ring's cylinders at fixed radius 0.5, each free to move
    +-0.5 in x and y: cylinder positions change within a window, so the
    radii-only kernel does not apply."""
    import torch

    from waves_jl_tpu_torch.designs import (AdjustablePositionScatterers, Cylinders,
                                            DesignSpace, design_cylinders)

    cy = design_cylinders(ring_space.low)
    r = torch.full_like(cy.r, 0.5)
    return DesignSpace(AdjustablePositionScatterers(Cylinders(cy.pos - 0.5, r, cy.c)),
                       AdjustablePositionScatterers(Cylinders(cy.pos + 0.5, r, cy.c)))


def batched_kernels(env, state, dev):
    """Phase 3, K3 and batched K5: 16 candidates at 350^2 from the
    coarsened 700^2 state, each with its own radii. Returns the numbers of
    their kernel rows."""
    import torch

    from waves_jl_tpu_torch.control.mpc import coarsen_env_state
    from waves_jl_tpu_torch.env import env_tspan
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import cyl_params, step_config

    env_lo = build_env(env.design_space, dev, SIZE_RERANK)
    cfg = step_config(env_lo)
    prof = env_lo.integrator.dynamics.pml[:, 0].contiguous()
    st = coarsen_env_state(env_lo, state)
    shape = st.source.shape
    u0 = st.wave[-1].expand(TOPK, *st.wave.shape[1:]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(8)
    designs = env_lo.design_space.sample(gen, batch=(TOPK,))
    nxt = env_lo.design_space(designs, env_lo.action_space.sample(gen, batch=(TOPK,)))
    cyl = cyl_params(designs, nxt, dev).contiguous()
    tspan = env_tspan(env_lo, st)
    ti, tf = float(tspan[0]), float(tspan[-1])
    log("kernels", f"K3 input: {TOPK} candidates at {SIZE_RERANK}^2, max |u| "
                   f"{float(u0.abs().max()):.3e}, radii drawn per candidate")

    owner_k = fk.select_owner_batched(cyl, cfg)
    owner_p = fk.select_owner_batched_reference(cyl, cfg)
    torch.cuda.synchronize()
    owner_err = float(torch.max(torch.abs(owner_k - owner_p)))
    log("kernels", f"select_owner_batched vs plain: {differing_cells(owner_k, owner_p)} of the five "
                   f"planes; {owner_sentinel_share(owner_k):.3f} of the cells hold the sentinel")
    check(torch.equal(owner_k, owner_p),
          "select_owner_batched equals its plain version bit for bit on all five planes")

    def window_run(step_fn, owner, cyl_, n_steps, u=u0):
        es = []
        for k in range(n_steps):
            u, e = step_fn(u, shape, prof, cyl_, owner, float(tspan[k]), ti, tf, cfg)
            es.append(e)
        return u, torch.stack(es)

    u_k, e_k = window_run(fk.fused_rk4_step_batched, owner_k, cyl, STEPS)
    u_p, e_p = window_run(fk.fused_rk4_step_batched_reference, owner_p, cyl, STEPS)
    torch.cuda.synchronize()
    k3_state, k3_sig = rel_err(u_k, u_p), rel_err(e_k, e_p)
    k3_abs = float(torch.max(torch.abs(u_k - u_p)))
    log("kernels", f"K3 radii-only vs plain, {STEPS} steps: rel err state {k3_state:.3e}, "
                   f"signal {k3_sig:.3e} (tol {REL_TOL:g}); {differing_cells(u_k, u_p)}")
    check(k3_state <= REL_TOL and k3_sig <= REL_TOL, "K3 radii-only agrees with its plain version")
    check(torch.equal(u_k, u_p) and k3_sig <= 1e-6,
          "K3 radii-only (one launch a step) equals its plain version bit for bit, its signal "
          "within 1e-6")

    identical, sig_err = 0, 0.0
    for b in range(TOPK):
        u_b, e_b = window_run(fk.fused_rk4_step, owner_k[b], cyl[b], STEPS, u0[b])
        identical += int(torch.equal(u_b, u_k[b]))
        sig_err = max(sig_err, rel_err(e_k[:, b], e_b))
    log("kernels", f"K3 vs K2 on each candidate alone, {STEPS} steps: {identical} of {TOPK} "
                   f"states identical, signal rel err {sig_err:.3e} (tol {REL_TOL:g})")
    check(identical == TOPK, "each K3 candidate's state is K2's on that candidate, bit for bit")
    check(sig_err <= REL_TOL, "each K3 candidate's signal agrees with K2's")

    moved = cyl.clone()
    moved[:, 4] += 0.3  # p2x != p1x: the cylinders move within the window
    moved[:, 5] -= 0.2
    u_kg, e_kg = window_run(fk.fused_rk4_step_batched, None, moved, 10)
    u_pg, e_pg = window_run(fk.fused_rk4_step_batched_reference, None, moved, 10)
    torch.cuda.synchronize()
    k3g_state, k3g_sig = rel_err(u_kg, u_pg), rel_err(e_kg, e_pg)
    log("kernels", f"K3 general vs plain, 10 steps, moving cylinders: rel err state "
                   f"{k3g_state:.3e}, signal {k3g_sig:.3e} (tol {REL_TOL:g}); "
                   f"{differing_cells(u_kg, u_pg)}")
    check(k3g_state <= REL_TOL and k3g_sig <= REL_TOL, "K3 general agrees with its plain version")
    check(torch.equal(u_kg, u_pg) and k3g_sig <= 1e-6,
          "K3 general (one launch a step) equals its plain version bit for bit")

    # batched K5: against its plain version over 10 steps, and each
    # candidate against K5 alone over the window
    xm_batched = functools.partial(fk.fused_rk4_step_batched, x_matmul=True)
    xm_batched_plain = functools.partial(fk.fused_rk4_step_batched_reference, x_matmul=True)
    u_x, e_x = window_run(xm_batched, owner_k, cyl, 10)
    u_xp, e_xp = window_run(xm_batched_plain, owner_p, cyl, 10)
    torch.cuda.synchronize()
    k5b_state, k5b_sig = rel_err(u_x, u_xp), rel_err(e_x, e_xp)
    k5b_abs = float(torch.max(torch.abs(u_x - u_xp)))
    log("kernels", f"batched K5 radii-only vs plain, 10 steps: rel err state {k5b_state:.3e}, "
                   f"signal {k5b_sig:.3e} (tol {REL_TOL:g}); {differing_cells(u_x, u_xp)}")
    check(k5b_state <= REL_TOL and k5b_sig <= REL_TOL, "batched K5 agrees with its plain version")
    check(torch.equal(u_x, u_xp) and k5b_sig <= 1e-6,
          "batched K5 radii-only (one launch a step) equals its plain version bit for bit, its "
          "signal within 1e-6")
    u_x, e_x = window_run(xm_batched, owner_k, cyl, STEPS)
    identical, sig_err = 0, 0.0
    for b in range(TOPK):
        u_b, e_b = window_run(functools.partial(fk.fused_rk4_step, x_matmul=True), owner_k[b],
                              cyl[b], STEPS, u0[b])
        identical += int(torch.equal(u_b, u_x[b]))
        sig_err = max(sig_err, rel_err(e_x[:, b], e_b))
    log("kernels", f"batched K5 vs K5 on each candidate alone, {STEPS} steps: {identical} of "
                   f"{TOPK} states identical, signal rel err {sig_err:.3e} (tol {REL_TOL:g})")
    check(identical == TOPK, "each batched K5 candidate's state is K5's on it, bit for bit")
    check(sig_err <= REL_TOL, "each batched K5 candidate's signal agrees with K5's")

    t_arg = float(tspan[0])
    k5b_ms = cuda_ms(lambda: xm_batched(u0, shape, prof, cyl, owner_k, t_arg, ti, tf, cfg), 50)
    k5b_plain = cuda_ms(lambda: xm_batched_plain(u0, shape, prof, cyl, owner_p, t_arg, ti, tf,
                                                 cfg), 3)
    k5b_dev = device_ms(lambda: xm_batched(u0, shape, prof, cyl, owner_k, t_arg, ti, tf, cfg), 20)
    k5b_win = window_step_ms(u0, shape, prof, cyl, owner_k, [float(x) for x in tspan[:-1]], ti,
                             tf, cfg, True)
    k3_ms = cuda_ms(lambda: fk.fused_rk4_step_batched(u0, shape, prof, cyl, owner_k, t_arg, ti,
                                                      tf, cfg), 50)
    k3_dev = device_ms(lambda: fk.fused_rk4_step_batched(u0, shape, prof, cyl, owner_k, t_arg, ti,
                                                         tf, cfg), 20)
    k3_win = window_step_ms(u0, shape, prof, cyl, owner_k, [float(x) for x in tspan[:-1]], ti,
                            tf, cfg, False)
    k3_plain = cuda_ms(lambda: fk.fused_rk4_step_batched_reference(u0, shape, prof, cyl, owner_p,
                                                                   t_arg, ti, tf, cfg), 3)
    seq_ms = cuda_ms(lambda: [fk.fused_rk4_step(u0[b], shape, prof, cyl[b], owner_k[b], t_arg, ti,
                                                tf, cfg) for b in range(TOPK)], 20)
    own_ms = cuda_ms(lambda: fk.select_owner_batched(cyl, cfg), 50)
    own_dev = device_ms(lambda: fk.select_owner_batched(cyl, cfg), 20)
    own_plain = cuda_ms(lambda: fk.select_owner_batched_reference(cyl, cfg), 3)
    log("kernels", f"ms per batched RK4 step of {TOPK} candidates at {SIZE_RERANK}^2: K3 radii-only "
                   f"{k3_ms:.4f} (plain {k3_plain:.4f}; device work {k3_dev:.4f}; inside a "
                   f"{STEPS}-step window {k3_win[0]:.4f} a step, device work {k3_win[1]:.4f}, the "
                   f"host issues a step in {k3_win[2]:.4f}); {TOPK} x K2 steps, the sequential route, "
                   f"{seq_ms:.4f}; select_owner_batched {own_ms:.4f} (plain {own_plain:.4f}; device "
                   f"work {own_dev:.4f}); "
                   f"batched K5 radii-only {k5b_ms:.4f} (plain {k5b_plain:.4f}; device work "
                   f"{k5b_dev:.4f}; inside a {STEPS}-step window {k5b_win[0]:.4f} a step, device "
                   f"work {k5b_win[1]:.4f}, the host issues a step in {k5b_win[2]:.4f})")

    n_cyl = cyl.shape[-1]
    part_t = torch.empty((TOPK, fk.step_partial_rows(SIZE_RERANK), 3), dtype=torch.float32)
    # K times what an RK4 step needs: the states in and out, the shared
    # shape and profile, each candidate's cylinders and energy partials
    io_step = 2 * nbytes(u0) + nbytes(shape, prof, cyl)
    k3_bound = bound(io_step + nbytes(part_t), TOPK * fk.step_flops(SIZE_RERANK, n_cyl, True))
    k5b_bound = bound(io_step + nbytes(part_t),
                      TOPK * fk.step_flops(SIZE_RERANK, n_cyl, True, x_matmul=True))
    own_bound = bound(nbytes(cyl, owner_k), sum(owner_ops(c, cfg) for c in cyl))
    log("kernels", f"K3 bound per batched step {k3_bound[0]:.5f} ms ({k3_bound[1]}; states alone "
                   f"{2 * nbytes(u0) / 1e6:.1f} MB, {2 * nbytes(u0) / HBM_BYTES_PER_S * 1e3:.5f} "
                   f"ms); select_owner_batched {own_bound[0]:.5f} ms ({own_bound[1]})")

    # SPC steps a launch (`rk4_steps_tiled`), asked for: K3 and batched K5
    # over 10 steps at the JAX re-rank's sub-step times, against their plain
    # versions and against the one-step launches at those times
    times_spc = fk.call_step_times(tspan[:10:SPC], SPC, cfg.dt)
    spc_rows = {}
    for xm, name in ((False, "K3"), (True, "batched K5")):
        def window(route, own, spc):
            return route(u0, shape, prof, cyl, own, times_spc, ti, tf, cfg, [9], xm,
                         steps_per_call=spc)

        key = fk.step_key(True, xm, True, SPC)
        before = fk.launch_counts[key]
        (u_m,), e_m = window(fk.fused_rk4_window, owner_k, SPC)
        launched = fk.launch_counts[key] - before
        (u_p,), e_p = window(fk.fused_rk4_window_reference, owner_p, SPC)
        (u_1,), _ = window(fk.fused_rk4_window, owner_k, 1)
        torch.cuda.synchronize()
        sig = rel_err(e_m, e_p)
        log("kernels", f"{name} radii-only, {SPC} steps a launch, vs plain, 10 steps: signal "
                       f"{sig:.3e}; {differing_cells(u_m, u_p)}; against the one-step launches at "
                       f"those times: {differing_cells(u_m, u_1)}")
        check(torch.equal(u_m, u_p) and sig <= 1e-6,
              f"{name} radii-only ({SPC} steps a launch) equals its plain version bit for bit, "
              "its signal within 1e-6")
        check(torch.equal(u_m, u_1),
              f"{name} ({SPC} steps a launch) equals {SPC} one-step launches")

        def launch(route=fk.fused_rk4_step_batched, own=owner_k):
            return route(u0, shape, prof, cyl, own, times_spc[0], ti, tf, cfg, x_matmul=xm,
                         steps_per_call=SPC)

        ms, dev_ms = cuda_ms(launch, 20), device_ms(launch, 20)
        plain = cuda_ms(lambda: launch(fk.fused_rk4_step_batched_reference, owner_p), 2)
        bnd = bound(fk.call_bytes(SIZE_RERANK, n_cyl, SPC, TOPK),
                    TOPK * fk.step_flops(SIZE_RERANK, n_cyl, True, x_matmul=xm,
                                         steps_per_call=SPC))
        log("kernels", f"{name} radii-only, {SPC} steps a launch, {TOPK} x {SIZE_RERANK}^2: "
                       f"{ms:.4f} ms a launch (device work {dev_ms:.4f}, {dev_ms / SPC:.4f} a "
                       f"step; plain {plain:.4f}); bound {bnd[0]:.5f} ms ({bnd[1]}), "
                       f"{dev_ms / bnd[0]:.2f}x")
        spc_rows[key] = (float(torch.max(torch.abs(u_m - u_p))), ms, plain, bnd, dev_ms,
                         launched)
    return env_lo, {"k3": (k3_abs, k3_ms, k3_plain, k3_bound), "k3_dev": k3_dev,
                    "own": (owner_err, own_ms, own_plain, own_bound), "own_dev": own_dev,
                    "seq_ms": seq_ms,
                    "k5b": (k5b_abs, k5b_ms, k5b_plain, k5b_bound), "k5b_dev": k5b_dev,
                    "spc": spc_rows}


def multi_step_kernels(u0, shape, prof, cyl, moved, owner_k, owner_p, tspan, cfg):
    """Phase 3, the two- and four-step launches (`rk4_steps_tiled<XM,
    GENERAL, SPC>`) at 700^2 from phase 3's state: each of the eight
    single-state instances over a window at the JAX kernel's sub-step times
    (40 steps radii-only on the triple ring, 20 general on the moving
    cylinders) against its plain version and against one-step launches at
    those times, bit for bit, its signal within 1e-6; each timed a launch,
    with its plain version and its bound, which counts the state read and
    written once a launch (and, general, the cylinders each tile keeps);
    then K5 and K2 radii-only a step at one, two and four steps a launch in
    turns, as device work inside 20-step windows (the probe of temporal
    blocking). Returns {counter: (max abs err, ms, plain ms, bound, device
    ms, launches of the window held to its plain version)}."""
    import torch

    from waves_jl_tpu_torch.ops import fused_rk4 as fk

    ti, tf = float(tspan[0]), float(tspan[-1])
    n_cyl = cyl.shape[1]
    rows = {}
    for spc in (2, 4):
        for radii in (True, False):
            own_k, own_p, cyl_ = (owner_k, owner_p, cyl) if radii else (None, None, moved)
            times = fk.call_step_times(tspan[:(40 if radii else 20):spc], spc, cfg.dt)
            for xm in (True, False):
                def window(route, own, steps_per_call, xm=xm):
                    return route(u0, shape, prof, cyl_, own, times, ti, tf, cfg,
                                 [len(times) - 1], xm, steps_per_call=steps_per_call)

                key = fk.step_key(False, xm, radii, spc)
                before = fk.launch_counts[key]
                (u_m,), e_m = window(fk.fused_rk4_window, own_k, spc)
                launched = fk.launch_counts[key] - before
                (u_p,), e_p = window(fk.fused_rk4_window_reference, own_p, spc)
                (u_1,), _ = window(fk.fused_rk4_window, own_k, 1)
                torch.cuda.synchronize()
                sig = rel_err(e_m, e_p)
                log("kernels", f"{key} ({spc} steps a launch) vs plain, {len(times)} steps: "
                               f"signal {sig:.3e}; {differing_cells(u_m, u_p)}; against one-step "
                               f"launches at those times: {differing_cells(u_m, u_1)}")
                check(torch.equal(u_m, u_p) and sig <= 1e-6,
                      f"{key} equals its plain version bit for bit, its signal within 1e-6")
                check(torch.equal(u_m, u_1), f"{key} equals {spc} one-step launches")

                def launch(route=fk.fused_rk4_step, own=own_k, xm=xm):
                    return route(u0, shape, prof, cyl_, own, times[0], ti, tf, cfg, x_matmul=xm,
                                 steps_per_call=spc)

                ms, dev_ms = cuda_ms(launch, 20), device_ms(launch, 20)
                plain = cuda_ms(lambda: launch(fk.fused_rk4_step_reference, own_p), 2)
                tested = n_cyl if radii else fk.tile_cylinders(
                    cyl_, cfg, fk.lerp_weight(times[0], ti, tf))
                bnd = bound(fk.call_bytes(SIZE, cyl_.shape[1], spc),
                            fk.step_flops(SIZE, tested, radii, x_matmul=xm, steps_per_call=spc))
                log("kernels", f"{key}: {ms:.4f} ms a launch (device work {dev_ms:.4f}, "
                               f"{dev_ms / spc:.4f} a step; plain {plain:.4f}); bound "
                               f"{bnd[0]:.5f} ms ({bnd[1]}), {dev_ms / bnd[0]:.2f}x")
                rows[key] = (float(torch.max(torch.abs(u_m - u_p))), ms, plain, bnd, dev_ms,
                             launched)

    # the probe: device ms a step at 1, 2 and 4 steps a launch in turns,
    # against the bound of a step's share of a launch's bytes
    per_step = {}
    for xm in (True, False):
        for spc in (1, 2, 4, 4, 2, 1):
            times = fk.call_step_times(tspan[:20:spc], spc, cfg.dt)
            dev_ms = device_ms(lambda: fk.fused_rk4_window(u0, shape, prof, cyl, owner_k, times,
                                                           ti, tf, cfg, [19], xm,
                                                           steps_per_call=spc), 1) / 20
            per_step.setdefault((xm, spc), []).append(dev_ms)
    for (xm, spc), v in per_step.items():
        bnd = bound(fk.call_bytes(SIZE, n_cyl, spc) / spc,
                    fk.step_flops(SIZE, n_cyl, True, x_matmul=xm))
        log("kernels", f"{'K5' if xm else 'K2'} radii-only at {SIZE}^2, {spc} steps a launch, "
                       f"device work a step inside 20-step windows, in turns: "
                       f"{', '.join(f'{x:.5f}' for x in v)} ms; bound a step {bnd[0]:.5f} ms "
                       f"({bnd[1]}), {min(v) / bnd[0]:.2f}x")
    return rows



def batched_general_kernel(env, state, elite, t0, dev, x_matmul):
    """Phase 4, K3 general (batched K5 general with `x_matmul`) on the
    position-design re-rank window's own inputs: its K states, cylinders
    and float32 step times, as `make_rerank_rollout` forms them. The kernel
    (one launch a step) against its plain version over the window's first
    10 steps, bit for bit on the state, and each candidate against the
    single-state kernel on it; its time a step alone and inside the window.
    The same window's first 10 steps at SPC steps a launch (`rk4_steps_tiled`,
    asked for) against the plain version and the one-step launches, bit for
    bit, timed a launch. The bounds count the cylinders each tile keeps
    (`tile_cylinders`). Returns the numbers of its kernel row, its device ms
    a step and the SPC-step row's numbers."""
    import numpy as np
    import torch

    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import cyl_params, rerank_step_times, step_config
    from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map

    k = tree_leaves(elite)[0].shape[0]
    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    shape = state.source.shape
    u0 = state.wave[-1].expand(k, *state.wave.shape[1:]).contiguous()
    designs = tree_map(lambda x: x.expand(k, *x.shape), state.design)
    nxt = env.design_space(designs, tree_map(lambda x: x[:, 0], elite))
    cyl = cyl_params(designs, nxt, dev).contiguous()
    check(bool((cyl[:, 0:2] != cyl[:, 4:6]).any()), "the re-rank window's cylinders move")
    t_i = np.float32(t0)
    ti, tf = float(t_i), float(np.float32(t_i + np.float32(STEPS * cfg.dt)))
    all_times = [float(ts) for ts in rerank_step_times(t_i, STEPS, cfg.dt)]  # SPC a call
    times = all_times[:10]
    tested = fk.tile_cylinders(cyl, cfg, fk.lerp_weight(times[0], ti, tf))

    kernel = functools.partial(fk.fused_rk4_step_batched, x_matmul=x_matmul)
    reference = functools.partial(fk.fused_rk4_step_batched_reference, x_matmul=x_matmul)
    name = "batched K5 general" if x_matmul else "K3 general"

    def window_run(step_fn):
        u, es = u0, []
        for ts in times:
            u, e = step_fn(u, shape, prof, cyl, None, ts, ti, tf, cfg)
            es.append(e)
        return u, torch.stack(es)

    u_k, e_k = window_run(kernel)
    u_p, e_p = window_run(reference)
    torch.cuda.synchronize()
    state_err, sig_err = rel_err(u_k, u_p), rel_err(e_k, e_p)
    abs_err = float(torch.max(torch.abs(u_k - u_p)))
    log("main path", f"{name} vs plain on the re-rank window, K = {k} at {SIZE}^2, "
                     f"{len(times)} steps: rel err state {state_err:.3e}, signal {sig_err:.3e} "
                     f"(tol {REL_TOL:g}); {differing_cells(u_k, u_p)}")
    check(state_err <= REL_TOL and sig_err <= REL_TOL,
          f"{name} agrees with its plain version on the re-rank window")
    check(torch.equal(u_k, u_p) and sig_err <= 1e-6,
          f"{name} (one launch a step) equals its plain version bit for bit, its signal within "
          "1e-6")
    identical = 0
    for b in range(k):
        u_b = u0[b]
        for ts in times:
            u_b, _ = fk.fused_rk4_step(u_b, shape, prof, cyl[b], None, ts, ti, tf, cfg,
                                       x_matmul=x_matmul)
        identical += int(torch.equal(u_b, u_k[b]))
    log("main path", f"{name} vs the single-state kernel on each candidate alone, {len(times)} "
                     f"steps: {identical} of {k} states identical")
    check(identical == k, f"each {name} candidate's state is the single-state kernel's on it")
    ms = cuda_ms(lambda: kernel(u0, shape, prof, cyl, None, times[0], ti, tf, cfg), 20)
    dev_ms = device_ms(lambda: kernel(u0, shape, prof, cyl, None, times[0], ti, tf, cfg), 20)
    win = window_step_ms(u0, shape, prof, cyl, None, all_times, ti, tf, cfg, x_matmul)
    plain = cuda_ms(lambda: reference(u0, shape, prof, cyl, None, times[0], ti, tf, cfg), 2)
    part = torch.empty((k, fk.step_partial_rows(SIZE), 3), dtype=torch.float32)
    bnd = bound(2 * nbytes(u0) + nbytes(shape, prof, cyl, part),
                k * fk.step_flops(SIZE, tested, False, x_matmul=x_matmul))
    log("main path", f"ms per batched RK4 step of {k} candidates at {SIZE}^2: {name} {ms:.4f} "
                     f"(plain {plain:.4f}; device work {dev_ms:.4f}; inside a {STEPS}-step window "
                     f"{win[0]:.4f} a step, device work {win[1]:.4f}, the host issues a step in "
                     f"{win[2]:.4f}), bound {bnd[0]:.5f} ms ({bnd[1]}; {tested:.4f} of "
                     f"{cyl.shape[-1]} cylinders a cell, those each tile keeps)")

    # SPC steps a launch on the same 10 steps (their times are the re-rank's
    # sub-step times), against the plain version and the one-step launches
    def window(route):
        return route(u0, shape, prof, cyl, None, times, ti, tf, cfg, [9], x_matmul,
                     steps_per_call=SPC)

    (u_m,), e_m = window(fk.fused_rk4_window)
    (u_mp,), e_mp = window(fk.fused_rk4_window_reference)
    torch.cuda.synchronize()
    sig = rel_err(e_m, e_mp)
    log("main path", f"{name}, {SPC} steps a launch, vs plain on the re-rank window, 10 steps: "
                     f"signal {sig:.3e}; {differing_cells(u_m, u_mp)}; against the one-step "
                     f"launches: {differing_cells(u_m, u_k)}")
    check(torch.equal(u_m, u_mp) and sig <= 1e-6,
          f"{name} ({SPC} steps a launch) equals its plain version bit for bit, its signal within "
          "1e-6")
    check(torch.equal(u_m, u_k), f"{name} ({SPC} steps a launch) equals {SPC} one-step launches")

    def launch(route=fk.fused_rk4_step_batched):
        return route(u0, shape, prof, cyl, None, times[0], ti, tf, cfg, x_matmul=x_matmul,
                     steps_per_call=SPC)

    ms_m, dev_m = cuda_ms(launch, 20), device_ms(launch, 20)
    plain_m = cuda_ms(lambda: launch(fk.fused_rk4_step_batched_reference), 2)
    bnd_m = bound(fk.call_bytes(SIZE, cyl.shape[-1], SPC, k),
                  k * fk.step_flops(SIZE, tested, False, x_matmul=x_matmul, steps_per_call=SPC))
    log("main path", f"{name}, {SPC} steps a launch, {k} x {SIZE}^2: {ms_m:.4f} ms a launch "
                     f"(device work {dev_m:.4f}, {dev_m / SPC:.4f} a step; plain {plain_m:.4f}); "
                     f"bound {bnd_m[0]:.5f} ms ({bnd_m[1]}), {dev_m / bnd_m[0]:.2f}x")
    return ((abs_err, ms, plain, bnd), dev_ms,
            (float(torch.max(torch.abs(u_m - u_mp))), ms_m, plain_m, bnd_m, dev_m))


def hybrid_episode(env, env_lo, space, dev):
    """Phase 5: the hybrid controller at full width. Returns its launch
    counts, those of one re-rank with the exact stencil (K3) and of one
    asked for SPC steps a launch (batched K5), and its seconds an action."""
    import torch

    from waves_jl_tpu_torch.control.mpc import (HybridShooting, coarsen_env_state,
                                                make_hybrid_action_fused)
    from waves_jl_tpu_torch.env import env_reset, env_time
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import make_rerank_rollout
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
    from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map

    model = AcousticEnergyModel(space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE, device=dev)
    ck_step = load_model_checkpoint(model, os.path.join(ROOT, CHECKPOINT_HYBRID))
    log("hybrid", f"pruner loaded from {CHECKPOINT_HYBRID} (step {ck_step})")
    kw = dict(horizon=HORIZON, shots=256, topk=TOPK, alpha=1.0, rerank_env=env_lo)
    act, step = make_hybrid_action_fused(env, model, **kw)  # batched re-rank, through batched K5
    seq = HybridShooting(env, model, batched=False, **kw)  # K rollouts in turn, through K5
    gen = torch.Generator(device=dev).manual_seed(20)
    start = env_reset(env, torch.Generator(device=dev).manual_seed(21))
    warm_s, _ = host_s(lambda: step(start, act(start, gen)[0]))
    log("hybrid", f"warm-up selection and window {warm_s:.3f} s")

    replay_at = (0, WINDOWS // 2, WINDOWS - 1)
    fk.reset_launch_counts()

    def episode():
        st, signals, replays = start, [], []
        for i in range(WINDOWS):
            before = (st, gen.get_state())
            a, c = act(st, gen)
            st, _ = step(st, a)
            signals.append(st.signal)
            if i in replay_at:
                replays.append((*before, a, c))
        return st, torch.stack(signals), replays

    episode_s, (final, signals, replays) = host_s(episode)
    counts = dict(fk.launch_counts)
    log("hybrid", f"hybrid episode ({WINDOWS} actions, {TOPK} of 256 re-ranked at "
                  f"{SIZE_RERANK}^2 over {HORIZON} windows) {episode_s:.4f} s, launches {counts}")
    expect = dict.fromkeys(counts, 0)
    # batched K5 and K5 radii-only take one launch a step
    expect.update({"fused_rk4_batched_xmatmul_radii_only": WINDOWS * HORIZON * STEPS,
                   "select_owner_batched": WINDOWS * HORIZON,
                   "fused_rk4_xmatmul_radii_only": WINDOWS * STEPS,
                   "select_owner": WINDOWS})
    check(counts == expect, f"hybrid launch counts {counts} == {expect}")
    check(tuple(signals.shape) == (WINDOWS, STEPS + 1, 3), f"signal shape {tuple(signals.shape)}")
    check(bool(torch.isfinite(signals).all()), "every hybrid signal is finite")
    check(final.time_step == WINDOWS * STEPS, "the hybrid episode ran every window")
    log("hybrid", f"signals finite; sc energy max {float(signals[:, :, 2].max()):.4e}")

    # selections of the episode replayed from their state and draws through
    # the sequential re-rank: the same chosen cost and, where the best two
    # exact costs are apart, the same action
    for i, (st, gen_state, a, c) in zip(replay_at, replays):
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        s_actions, s_cost = seq.rerank(st, *seq.prune(st, g), g)
        j = int(torch.argmin(s_cost))
        err = rel_err(s_cost[j], c)
        best2 = torch.sort(s_cost).values[:2]
        decided = float(best2[1] - best2[0]) > 1e-5 * float(s_cost.abs().max())
        same = all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(tree_map(lambda v: v[j, 0], s_actions)), tree_leaves(a)))
        log("hybrid", f"selection {i} replayed through the sequential re-rank: chosen cost "
                      f"{float(c):.6e} vs {float(s_cost[j]):.6e}, rel err {err:.3e} (tol 1e-05); "
                      f"same action {same} (decided {decided})")
        check(err <= 1e-5, f"selection {i}'s chosen cost agrees with the sequential re-rank's")
        check(same or not decided, f"selection {i}'s action is the sequential re-rank's")

    prune_s, pruned = host_s(lambda: act.prune(final, gen))
    rerank_s, (ev_actions, ev_cost) = host_s(lambda: act.rerank(final, *pruned, gen))
    idx = torch.argmin(ev_cost)
    window_s, _ = host_s(lambda: step(final, tree_map(lambda v: v[idx, 0], ev_actions)))
    log("hybrid", f"one selection apart: surrogate prune {prune_s:.4f} s, re-rank (coarsen + "
                  f"{TOPK} x {HORIZON} windows through batched K5) {rerank_s:.4f} s, env window "
                  f"{window_s:.4f} s")

    seq_s, (_, seq_cost) = host_s(lambda: seq.rerank(final, *pruned, gen))
    seq_rel = rel_err(seq_cost, ev_cost)
    log("hybrid", f"re-rank, batched {rerank_s:.4f} s vs sequential ({TOPK} x {HORIZON} K5 "
                  f"windows) {seq_s:.4f} s; costs rel err {seq_rel:.3e} (tol 1e-05), chosen "
                  f"{int(idx)} vs {int(torch.argmin(seq_cost))}")
    check(int(torch.argmin(seq_cost)) == int(idx), "batched and sequential re-ranks choose alike")
    check(seq_rel <= 1e-5, "batched and sequential re-rank costs agree")

    # the same re-rank with the exact stencil (K3), the hybrid's path at
    # x_matmul=False: its launches, time and costs against batched K5's
    best = tree_map(lambda v: v[pruned[2]], pruned[0])
    st_lo, t0 = coarsen_env_state(env_lo, final), env_time(env, final)
    exact = make_rerank_rollout(env_lo, HORIZON, x_matmul=False)
    exact(st_lo, best, t0)  # warm
    fk.reset_launch_counts()
    exact_s, exact_cost = host_s(lambda: exact(st_lo, best, t0))
    exact_counts = dict(fk.launch_counts)
    split_s, split_cost = host_s(lambda: act.exact_eval(st_lo, best, t0))
    split_rel = rel_err(split_cost, exact_cost)
    same_choice = int(torch.argmin(split_cost)) == int(torch.argmin(exact_cost))
    log("hybrid", f"re-rank rollout of the {TOPK} pruned, exact stencil (K3) {exact_s:.4f} s vs "
                  f"split d/dx (batched K5) {split_s:.4f} s; costs rel err {split_rel:.3e} (tol "
                  f"1e-06), same choice {same_choice}; launches {exact_counts}")
    expect = dict.fromkeys(exact_counts, 0)
    # K3 radii-only takes one launch a step
    expect.update({"fused_rk4_batched_radii_only": HORIZON * STEPS,
                   "select_owner_batched": HORIZON})
    check(exact_counts == expect, f"exact re-rank launch counts {exact_counts} == {expect}")
    check(split_rel <= 1e-6 and same_choice,
          "the split and exact re-rank costs agree within 1e-6 and choose alike")

    # the batched K5 re-rank by default (one launch a step) against SPC steps
    # a launch at the same step times, in turns: its launches, time and costs
    multi = make_rerank_rollout(env_lo, HORIZON, steps_per_call=SPC)
    multi(st_lo, best, t0)  # warm
    turns = {1: [], SPC: []}
    for spc in (1, SPC, SPC, 1):
        fk.reset_launch_counts()
        s_, c_ = host_s(lambda: (act.exact_eval if spc == 1 else multi)(st_lo, best, t0))
        turns[spc].append(s_)
        if spc == SPC:
            spc_counts, spc_cost = dict(fk.launch_counts), c_
    spc_rel = rel_err(spc_cost, split_cost)
    log("hybrid", f"batched K5 re-rank of the {TOPK} pruned in turns: by default (one launch a "
                  f"step) {', '.join(f'{s:.4f}' for s in turns[1])} s, {SPC} steps a launch "
                  f"{', '.join(f'{s:.4f}' for s in turns[SPC])} s; costs rel err {spc_rel:.3e} "
                  f"(tol 1e-06), identical {bool(torch.equal(spc_cost, split_cost))}, same choice "
                  f"{int(torch.argmin(spc_cost)) == int(torch.argmin(split_cost))}; launches "
                  f"{spc_counts}")
    expect = dict.fromkeys(spc_counts, 0)
    expect.update({f"fused_rk4_batched_xmatmul_radii_only_spc{SPC}": HORIZON * STEPS // SPC,
                   "select_owner_batched": HORIZON})
    check(spc_counts == expect, f"{SPC}-step re-rank launch counts {spc_counts} == {expect}")
    check(spc_rel <= 1e-6, f"the default and {SPC}-step re-rank costs agree within 1e-6")

    rounds = HybridShooting(env, model, exact_rounds=2, **kw)
    rounds_s, (_, r2_cost) = host_s(lambda: rounds.rerank(final, *pruned, gen))
    log("hybrid", f"two exact rounds {rounds_s:.4f} s: chosen cost {float(r2_cost.min()):.6e} vs "
                  f"one round {float(ev_cost.min()):.6e}; round-1 costs identical: "
                  f"{bool(torch.equal(r2_cost[:TOPK], ev_cost))}")
    check(float(r2_cost.min()) <= float(ev_cost.min()),
          "two exact rounds choose no worse than one from the same draws")
    return counts, exact_counts, spc_counts, episode_s / WINDOWS


def cylinder_grid(moving: bool):
    """80 cylinders (8, 80) in numpy: a 9 x 9 grid at pitch 2.5 minus its
    last cell, radii 0.4-1.0 (disjoint at any radius), moving by
    (0.3, -0.2) in the window if `moving`."""
    import numpy as np

    rng = np.random.default_rng(80)
    xs = np.linspace(-10.0, 10.0, 9)
    pos = np.array([(x, y) for x in xs for y in xs])[:80]
    r1, r2 = rng.uniform(0.4, 1.0, 80), rng.uniform(0.4, 1.0, 80)
    c = np.full(80, 1032.0)
    pos2 = pos + (np.array([0.3, -0.2]) if moving else 0.0)
    return np.stack([pos[:, 0], pos[:, 1], r1, c, pos2[:, 0], pos2[:, 1], r2, c])


def stacked_slabs(u0, shape, cyl, cfg, slabs, dev):
    """Phase 6's inputs of one step of the slabs stacked on one card: the
    state and source shape (S, .., n, w) cut from the global ones, and the
    owner fields of the slabs from the kernel's pass (one launch) and from
    its plain version."""
    import torch

    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.parallel.fused_domain import cut_slabs

    devs = [dev] * len(slabs)
    return (torch.stack(cut_slabs(u0, slabs, devs)), torch.stack(cut_slabs(shape, slabs, devs)),
            fk.select_owner_slabs(cyl, cfg, slabs), fk.select_owner_slabs_reference(cyl, cfg, slabs))


def sharded_phase(env, state, nxt, cyl, moved, tspan, dev, k2_ms):
    """Phase 6: K4 and the `parallel/` rollouts at 700^2 from phase 3's
    state, cylinders and window times; the 80-cylinder K1 and a free-field
    K1 window. Returns the numbers of K4's kernel rows and its launches."""
    import torch

    from waves_jl_tpu_torch.designs import DesignInterpolator, DesignSpace, NoDesign
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.parallel import (make_fused_sharded_rollout, make_mesh,
                                             make_sharded_rollout)
    from waves_jl_tpu_torch.parallel.fused_domain import build_rollout, shard_slabs
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused, make_fused_window, step_config

    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    shape = state.source.shape
    u0 = state.wave[-1]
    ti, tf = float(tspan[0]), float(tspan[-1])
    times = [float(t) for t in tspan[:-1]]
    n_cyl = cyl.shape[1]
    shards = 4
    ny = SIZE // shards

    def rollout(k, radii):
        return make_fused_sharded_rollout(make_mesh(devices=[dev] * k), SIZE, cfg.spacing, cfg.dt,
                                          cfg.c0, cfg.freq, n_cyl, cfg.x_min, radii_only=radii)

    # K4 against its plain version: the rollout (the 4 slabs stacked, one
    # launch a step) against the slab-by-slab plain rollout, 10 steps
    mesh4 = make_mesh(devices=[dev] * shards)
    tspan10 = tspan[:11]
    errs = {}
    for radii, cyl_ in ((True, cyl), (False, moved)):
        u_k, e_k = rollout(shards, radii)(u0, tspan10, cyl_, shape, prof)
        u_p, e_p = build_rollout(mesh4, cfg, n_cyl, radii, fk.fused_rk4_step_reference,
                                 fk.select_owner_reference)(u0, tspan10, cyl_, shape, prof)
        torch.cuda.synchronize()
        errs[radii] = float(torch.max(torch.abs(u_k - u_p)))
        sig = rel_err(e_k, e_p)
        log("sharded", f"K4 {'radii-only' if radii else 'general'} vs plain, {shards} shards of "
                       f"{ny} columns at {SIZE}^2, 10 steps: owned state max abs err "
                       f"{errs[radii]}, signal rel err {sig:.3e} (tol {REL_TOL:g})")
        check(errs[radii] == 0.0, "K4's owned state equals its plain version's")
        check(sig <= REL_TOL, "K4's signal agrees with its plain version's")
    slabs = shard_slabs(SIZE, shards)
    before = fk.launch_counts["select_owner_sharded"]
    owner_k = fk.select_owner_slabs(cyl, cfg, slabs)
    launched = fk.launch_counts["select_owner_sharded"] - before
    owner_p = fk.select_owner_slabs_reference(cyl, cfg, slabs)
    torch.cuda.synchronize()
    own_err = float(torch.max(torch.abs(owner_k - owner_p)))
    log("sharded", f"select_owner_slabs on the {shards} slabs ({launched} launch) vs plain: "
                   f"{differing_cells(owner_k, owner_p)} of the five planes, halo columns included")
    check(launched == 1 and torch.equal(owner_k, owner_p),
          "the slabs' owner pass takes one launch and equals its plain version bit for bit")

    # the sharded rollout against the whole-grid kernel over the window (K2,
    # the exact d/dx that the sharded rollout takes, one step a launch at the
    # window's tspan times, as the sharded rollout steps in both packages)
    u_w, _, s_w = make_fused_window(env, x_matmul=False, steps_per_call=1)(u0, shape, tspan, cyl)
    owner_w = fk.select_owner(cyl, cfg)
    d_omega = cfg.spacing * cfg.spacing
    counts = {}
    for k in (1, 2, 4):
        roll = rollout(k, True)
        roll(u0, tspan, cyl, shape, prof)  # warm
        torch.cuda.synchronize()
        if k == shards:
            fk.reset_launch_counts()
        u_s, s_s = roll(u0, tspan, cyl, shape, prof)
        torch.cuda.synchronize()
        if k == shards:
            counts = dict(fk.launch_counts)
        err = float(torch.max(torch.abs(u_s - u_w)))
        sig = rel_err(s_s * d_omega, s_w)
        log("sharded", f"radii-only rollout, {k} shard(s), {STEPS} steps, vs the K2 window: state "
                       f"max abs err {err}, signal rel err {sig:.3e} (tol 1e-06)")
        check(err == 0.0, f"the {k}-shard state equals K2's bit for bit")
        check(sig <= 1e-6, f"the {k}-shard signal agrees with K2's")
    log("sharded", f"launches of the {shards}-shard radii-only rollout: {counts}")
    check(counts["fused_rk4_sharded_radii_only"] == STEPS
          and counts["select_owner_sharded"] == 1,
          f"{STEPS} K4 radii-only launches (one a step for the {shards} slabs) and one owner "
          "pass for the card's slabs")
    check(all(v == 0 for key, v in counts.items() if "sharded" not in key),
          "the sharded rollout launches no whole-grid kernel")

    # the general rollout's slabs against the whole-grid K1 window: one
    # kernel, its tiles cut apart differently
    ti10, tf10 = float(tspan10[0]), float(tspan10[-1])
    times10 = [float(t) for t in tspan10[:-1]]
    (u1,), e1 = fk.fused_rk4_window(u0, shape, prof, moved, None, times10, ti10, tf10, cfg, [9])
    counts_g = {}
    for k in (1, 2, 4):
        roll_g = rollout(k, False)
        if k == shards:
            fk.reset_launch_counts()
        u_g, s_g = roll_g(u0, tspan10, moved, shape, prof)
        torch.cuda.synchronize()
        if k == shards:
            counts_g = dict(fk.launch_counts)
        sig_g = rel_err(s_g[1:], e1)
        log("sharded", f"general rollout, {k} shard(s), 10 steps, moving cylinders, vs the K1 "
                       f"window: {differing_cells(u_g, u1)}, signal rel err {sig_g:.3e} "
                       f"(tol 1e-06)")
        check(torch.equal(u_g, u1) and sig_g <= 1e-6, f"the {k}-shard general rollout equals K1")
    check(counts_g["fused_rk4_sharded_general"] == 10,
          f"10 K4 general launches (one a step for the {shards} slabs)")

    # the plain sharded rollout (domain.py) against the fused one
    dyn = env.integrator.dynamics
    interp = DesignInterpolator(state.design, nxt, ti10, tf10)
    plain = make_sharded_rollout(make_mesh(devices=[dev] * shards), env.c0, dyn.dx, dyn.dy, 10,
                                 cfg.dt)
    t_p = time.time()
    u_pl, s_pl = plain(u0, tspan10, interp, env.grid, shape, cfg.freq, dyn.pml,
                       dyn.pml.T.contiguous(), dyn.bc, d_omega)
    u_fr, s_fr = rollout(shards, True)(u0, tspan10, cyl, shape, prof)
    torch.cuda.synchronize()
    t_p = time.time() - t_p
    pl_sig, pl_state = rel_err(s_fr * d_omega, s_pl), rel_err(u_fr, u_pl)
    log("sharded", f"plain sharded rollout (domain.py) vs fused, {shards} shards, 10 steps: "
                   f"signal rel err {pl_sig:.3e}, state rel err {pl_state:.3e} (tol {REL_TOL:g}); "
                   f"{t_p:.3f} s for both")
    check(pl_sig <= REL_TOL, "the plain and fused sharded rollouts agree")

    # no cylinder cap: 80 cylinders through K1 and the owner pass
    grid80 = torch.from_numpy(cylinder_grid(True).astype("float32")).to(dev)
    u_a, u_b = u0, u0
    for t in times[:2]:
        u_a, e_a = fk.fused_rk4_step(u_a, shape, prof, grid80, None, t, ti, tf, cfg)
        u_b, e_b = fk.fused_rk4_step_reference(u_b, shape, prof, grid80, None, t, ti, tf, cfg)
    o80 = torch.equal(fk.select_owner(grid80, cfg), fk.select_owner_reference(grid80, cfg))
    torch.cuda.synchronize()
    e80 = float(torch.max(torch.abs(u_a - u_b)))
    log("sharded", f"K1 with 80 cylinders, 2 steps at {SIZE}^2, vs plain: state max abs err {e80}, "
                   f"energies rel err {rel_err(e_a, e_b):.3e}; owner pass identical {o80}")
    check(e80 == 0.0 and rel_err(e_a, e_b) <= REL_TOL and o80, "80 cylinders run without a cap")

    # K1 with no cylinders: a free-field window with the exact d/dx
    free = build_env(DesignSpace(NoDesign(), NoDesign()), dev)
    gen = torch.Generator(device=dev).manual_seed(60)
    fst = env_reset(free, gen)
    fk.reset_launch_counts()
    fst, _ = make_env_step_fused(free, x_matmul=False)(fst,
                                                        RandomDesignPolicy(free.action_space)(gen))
    torch.cuda.synchronize()
    fs = fst.signal
    log("sharded", f"free-field window through K1: launches {fk.launch_counts['fused_rk4_general']}, "
                   f"tot max {float(fs[:, 0].max()):.4e}, tot == inc {torch.equal(fs[:, 0], fs[:, 1])}, "
                   f"sc max {float(fs[:, 2].max())}")
    check(fk.launch_counts["fused_rk4_general"] == STEPS,
          "the free field takes K1, one launch a step")
    check(bool(torch.isfinite(fs).all()) and float(fs[:, 0].max()) > 0.0
          and torch.equal(fs[:, 0], fs[:, 1]) and float(fs[:, 2].max()) == 0.0,
          "free field: tot == inc, sc == 0")

    # times: a sharded step at 1, 2 and 4 shards against K2's, as the host
    # drives it (events around the 100-step rollout) and as device work
    # (a 10-step rollout queued behind a device sleep)
    steps_ms, dev_ms = {}, {}
    for k in (1, 2, 4):
        roll = rollout(k, True)
        steps_ms[k] = cuda_ms(lambda: roll(u0, tspan, cyl, shape, prof), 3) / STEPS
        dev_ms[k] = device_ms(lambda: roll(u0, tspan10, cyl, shape, prof), 1) / 10
    window = make_fused_window(env, x_matmul=False, steps_per_call=1)
    win_ms = cuda_ms(lambda: window(u0, shape, tspan, cyl), 3) / STEPS
    win_dev = device_ms(lambda: window(u0, shape, tspan10, cyl), 1) / 10
    k2_dev = device_ms(lambda: fk.fused_rk4_step(u0, shape, prof, cyl, owner_w, times[0], ti, tf,
                                                 cfg), 20)
    log("sharded", f"ms per RK4 step, events around the {STEPS}-step rollout: K2 window "
                   f"{win_ms:.4f}; sharded " + ", ".join(
                       f"{k} shard(s) {v:.4f} ({v / win_ms:.3f}x; {v / dev_ms[k]:.3f}x its device "
                       "ms below)" for k, v in steps_ms.items()))
    log("sharded", f"device ms per RK4 step, 10-step rollout queued behind a device sleep: K2 "
                   f"window {win_dev:.4f} (K2 step alone {k2_dev:.4f}, {k2_ms:.4f} as the host "
                   f"drives it); sharded " + ", ".join(
                       f"{k} shard(s) {v:.4f} ({v / win_dev:.3f}x)" for k, v in dev_ms.items()))
    roll = rollout(shards, True)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_h = time.perf_counter()
        roll(u0, tspan[:21], cyl, shape, prof)
        host.append((time.perf_counter() - t_h) * 1e3 / 20)
    torch.cuda.synchronize()
    log("sharded", f"host time to issue one {shards}-shard step (one ctypes launch, 2 halo "
                   f"copies, no allocation), 20-step rollouts left unsynchronised, setup "
                   f"included: " + ", ".join(f"{h:.4f}" for h in host) + " ms")

    # K4 alone: one step of the 4 slabs stacked (one launch), no exchange,
    # each slab bit for bit its plain version's, halo columns included
    us, sh, owners_k, owners_p = stacked_slabs(u0, shape, cyl, cfg, slabs, dev)
    t0 = times[0]
    rows = {}
    part = torch.empty((shards, fk.step_partial_rows(SIZE, ny), 3), dtype=torch.float32)
    io = 2 * nbytes(us) + nbytes(sh, part, prof, cyl)
    # `ms` as for K1-K3 (events around host-driven calls); `device_ms` the
    # same launches queued behind a device sleep, without the host's issue cost
    for name, own_k, own_p, cyl_, radii in (("radii", owners_k, owners_p, cyl, True),
                                            ("general", None, None, moved, False)):
        def kernel():
            return fk.fused_rk4_step_slabs(us, sh, prof, cyl_, own_k, t0, ti, tf, cfg, slabs)

        got = kernel()
        want = fk.fused_rk4_step_slabs_reference(us, sh, prof, cyl_, own_p, t0, ti, tf, cfg,
                                                 slabs, False)
        torch.cuda.synchronize()
        e_rel = rel_err(got[1], want[1])
        log("sharded", f"K4 {'radii-only' if radii else 'general'}, one step of the {shards} "
                       f"stacked slabs (one launch) vs plain: {differing_cells(got[0], want[0])}, "
                       f"halo columns included; energies rel err {e_rel:.3e} (tol 1e-06)")
        check(torch.equal(got[0], want[0]) and e_rel <= 1e-6,
              "K4 on the stacked slabs equals its plain version bit for bit")
        ms = cuda_ms(kernel, 50)
        dev_only = device_ms(kernel, 20)
        plain_ms = cuda_ms(lambda: fk.fused_rk4_step_slabs_reference(
            us, sh, prof, cyl_, own_p, t0, ti, tf, cfg, slabs, False), 3)
        # general: the cylinders each tile keeps, counted on the whole grid's tiles
        tested = n_cyl if radii else fk.tile_cylinders(cyl_, cfg, fk.lerp_weight(t0, ti, tf))
        flops = shards * fk.step_flops(SIZE, tested, radii, ny)
        err = max(errs[radii], float(torch.max(torch.abs(got[0] - want[0]))))
        rows[name] = (err, ms, dev_only, plain_ms, bound(io, flops))
    own_ms = cuda_ms(lambda: fk.select_owner_slabs(cyl, cfg, slabs), 50)
    own_dev = device_ms(lambda: fk.select_owner_slabs(cyl, cfg, slabs), 20)
    own_plain = cuda_ms(lambda: fk.select_owner_slabs_reference(cyl, cfg, slabs), 3)
    own_bound = bound(nbytes(cyl, owners_k), sum(owner_ops(cyl, cfg, s) for s in slabs))
    rows["owner"] = (own_err, own_ms, own_dev, own_plain, own_bound)
    states_mb = 2 * nbytes(us) / 1e6
    log("sharded", f"K4, one step of {shards} stacked slabs (one launch), ms as the host drives it "
                   f"(device ms queued behind a sleep): radii-only {rows['radii'][1]:.4f} "
                   f"({rows['radii'][2]:.4f}; plain {rows['radii'][3]:.4f}), general "
                   f"{rows['general'][1]:.4f} ({rows['general'][2]:.4f}; plain "
                   f"{rows['general'][3]:.4f}); bound {rows['radii'][4][0]:.5f} ms "
                   f"({rows['radii'][4][1]}; states alone {states_mb:.1f} MB); the owner pass of the "
                   f"{shards} slabs (one launch) {own_ms:.4f} ({own_dev:.4f}; plain "
                   f"{own_plain:.4f}), bound {own_bound[0]:.5f} ms ({own_bound[1]})")
    return rows, {"radii": counts["fused_rk4_sharded_radii_only"],
                  "owner": counts["select_owner_sharded"],
                  "general": counts_g["fused_rk4_sharded_general"]}


def sharded_xmatmul_phase(env, state, cyl, moved, tspan, dev):
    """Phase 6, K4-XM: the y-sharded kernel with K5's split d/dx
    (`x_matmul=True`) from phase 3's state, cylinders and window times,
    against its plain version in both modes, the fused sharded rollout at
    1, 2 and 4 shards against the K5 window bit for bit, and its time per
    4-shard step against K4's, in turns. Returns the numbers of its kernel
    rows and its launches."""
    import torch

    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.parallel import make_fused_sharded_rollout, make_mesh
    from waves_jl_tpu_torch.parallel.fused_domain import build_rollout, shard_slabs
    from waves_jl_tpu_torch.physics.fused import make_fused_window, step_config

    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    shape = state.source.shape
    u0 = state.wave[-1]
    ti, tf = float(tspan[0]), float(tspan[-1])
    n_cyl = cyl.shape[1]
    shards = 4
    tspan10 = tspan[:11]
    mesh4 = make_mesh(devices=[dev] * shards)

    def rollout(k, radii, x_matmul=True):
        return make_fused_sharded_rollout(make_mesh(devices=[dev] * k), SIZE, cfg.spacing, cfg.dt,
                                          cfg.c0, cfg.freq, n_cyl, cfg.x_min, radii_only=radii,
                                          x_matmul=x_matmul)

    # K4-XM against its plain version: the rollout (the 4 slabs stacked, one
    # launch a step) against the slab-by-slab plain rollout, 10 steps
    errs = {}
    for radii, cyl_ in ((True, cyl), (False, moved)):
        u_k, e_k = rollout(shards, radii)(u0, tspan10, cyl_, shape, prof)
        u_p, e_p = build_rollout(mesh4, cfg, n_cyl, radii, fk.fused_rk4_step_reference,
                                 fk.select_owner_reference, x_matmul=True)(
            u0, tspan10, cyl_, shape, prof)
        torch.cuda.synchronize()
        errs[radii] = float(torch.max(torch.abs(u_k - u_p)))
        sig = rel_err(e_k, e_p)
        log("sharded", f"K4-XM {'radii-only' if radii else 'general'} vs plain, {shards} shards at "
                       f"{SIZE}^2, 10 steps: owned state {differing_cells(u_k, u_p)}, max abs err "
                       f"{errs[radii]}, signal rel err {sig:.3e} (tol {REL_TOL:g})")
        check(errs[radii] == 0.0, "K4-XM's owned state equals its plain version's")
        check(sig <= REL_TOL, "K4-XM's signal agrees with its plain version's")

    # the split sharded rollout against the whole-grid K5 window at one step a
    # launch (the rollout's tspan times)
    u_w, _, s_w = make_fused_window(env, x_matmul=True, steps_per_call=1)(u0, shape, tspan, cyl)
    d_omega = cfg.spacing * cfg.spacing
    counts = {}
    for k in (1, 2, 4):
        roll = rollout(k, True)
        roll(u0, tspan, cyl, shape, prof)  # warm
        torch.cuda.synchronize()
        if k == shards:
            fk.reset_launch_counts()
        u_s, s_s = roll(u0, tspan, cyl, shape, prof)
        torch.cuda.synchronize()
        if k == shards:
            counts = dict(fk.launch_counts)
        sig = rel_err(s_s * d_omega, s_w)
        log("sharded", f"split radii-only rollout, {k} shard(s), {STEPS} steps, vs the K5 window: "
                       f"{differing_cells(u_s, u_w)}, signal rel err {sig:.3e} (tol 1e-06)")
        check(torch.equal(u_s, u_w), f"the {k}-shard split state equals K5's bit for bit")
        check(sig <= 1e-6, f"the {k}-shard split signal agrees with K5's")
    log("sharded", f"launches of the {shards}-shard split radii-only rollout: {counts}")
    expect = dict.fromkeys(counts, 0)
    expect.update({"fused_rk4_sharded_xmatmul_radii_only": STEPS,  # one launch a step
                   "select_owner_sharded": 1})  # one for the card's slabs
    check(counts == expect, f"the split sharded rollout launches K4-XM alone: {counts} == {expect}")

    # the split general rollout's slabs against the whole-grid K5 general
    # window
    ti10, tf10 = float(tspan10[0]), float(tspan10[-1])
    times10 = [float(t) for t in tspan10[:-1]]
    (u1,), e1 = fk.fused_rk4_window(u0, shape, prof, moved, None, times10, ti10, tf10, cfg, [9],
                                    x_matmul=True)
    counts_g = {}
    for k in (1, 2, 4):
        roll_g = rollout(k, False)
        if k == shards:
            fk.reset_launch_counts()
        u_g, s_g = roll_g(u0, tspan10, moved, shape, prof)
        torch.cuda.synchronize()
        if k == shards:
            counts_g = dict(fk.launch_counts)
        sig_g = rel_err(s_g[1:], e1)
        log("sharded", f"split general rollout, {k} shard(s), 10 steps, moving cylinders, vs "
                       f"the K5 general window: {differing_cells(u_g, u1)}, signal rel err {sig_g:.3e} "
                       f"(tol 1e-06)")
        check(torch.equal(u_g, u1) and sig_g <= 1e-6,
              f"the {k}-shard split general rollout equals K5 general")
    check(counts_g["fused_rk4_sharded_xmatmul_general"] == 10,
          f"10 K4-XM general launches (one a step for the {shards} slabs)")

    # times per 4-shard step in turns, K4 then K4-XM then K4-XM then K4:
    # events around the 100-step rollout (host-driven), and a 10-step
    # rollout queued behind a device sleep (device work)
    step_ms, step_dev = {False: [], True: []}, {False: [], True: []}
    for xm in (False, True, True, False):
        roll = rollout(shards, True, xm)
        step_ms[xm].append(cuda_ms(lambda: roll(u0, tspan, cyl, shape, prof), 3) / STEPS)
        step_dev[xm].append(device_ms(lambda: roll(u0, tspan10, cyl, shape, prof), 1) / 10)
    log("sharded", f"ms per {shards}-shard step of the radii-only rollout, in turns, host-driven "
                   f"(device work): K4 " + ", ".join(
                       f"{a:.4f} ({b:.4f})" for a, b in zip(step_ms[False], step_dev[False]))
        + "; K4-XM " + ", ".join(
            f"{a:.4f} ({b:.4f})" for a, b in zip(step_ms[True], step_dev[True])))

    # K4-XM alone: one step of the 4 slabs stacked (one launch), no
    # exchange, as phase 6 times K4, against its plain version bit for bit
    slabs = shard_slabs(SIZE, shards)
    us, sh, owners_k, owners_p = stacked_slabs(u0, shape, cyl, cfg, slabs, dev)
    t0 = float(tspan[0])
    ny = SIZE // shards
    part = torch.empty((shards, fk.step_partial_rows(SIZE, ny), 3), dtype=torch.float32)
    io = 2 * nbytes(us) + nbytes(sh, part, prof, cyl)
    rows, turns = {}, {}
    for name, own_k, own_p, cyl_, radii in (("radii", owners_k, owners_p, cyl, True),
                                            ("general", None, None, moved, False)):
        def kernel(xm):
            return fk.fused_rk4_step_slabs(us, sh, prof, cyl_, own_k, t0, ti, tf, cfg, slabs, xm)

        got = kernel(True)
        want = fk.fused_rk4_step_slabs_reference(us, sh, prof, cyl_, own_p, t0, ti, tf, cfg,
                                                 slabs, True)
        torch.cuda.synchronize()
        e_rel = rel_err(got[1], want[1])
        log("sharded", f"K4-XM {'radii-only' if radii else 'general'}, one step of the {shards} "
                       f"stacked slabs (one launch) vs plain: {differing_cells(got[0], want[0])}, "
                       f"halo columns included; energies rel err {e_rel:.3e} (tol 1e-06)")
        check(torch.equal(got[0], want[0]) and e_rel <= 1e-6,
              "K4-XM on the stacked slabs equals its plain version bit for bit")
        for xm in (False, True, True, False):
            turns.setdefault((name, xm), []).append(
                (cuda_ms(lambda: kernel(xm), 50), device_ms(lambda: kernel(xm), 20)))
        ms, dev_only = turns[(name, True)][0]
        plain_ms = cuda_ms(lambda: fk.fused_rk4_step_slabs_reference(
            us, sh, prof, cyl_, own_p, t0, ti, tf, cfg, slabs, True), 3)
        tested = n_cyl if radii else fk.tile_cylinders(cyl_, cfg, fk.lerp_weight(t0, ti, tf))
        flops = shards * fk.step_flops(SIZE, tested, radii, ny, x_matmul=True)
        err = max(errs[radii], float(torch.max(torch.abs(got[0] - want[0]))))
        rows[name] = (err, ms, dev_only, plain_ms, bound(io, flops))
        log("sharded", f"one step of {shards} stacked slabs (one launch), {name}, in turns, ms "
                       f"host-driven (device ms): K4 " + ", ".join(
                           f"{a:.4f} ({b:.4f})" for a, b in turns[(name, False)])
            + "; K4-XM " + ", ".join(f"{a:.4f} ({b:.4f})" for a, b in turns[(name, True)])
            + f"; K4-XM plain {plain_ms:.4f}; bound {rows[name][4][0]:.5f} ms "
              f"({rows[name][4][1]})")
    return rows, {"radii": counts["fused_rk4_sharded_xmatmul_radii_only"],
                  "general": counts_g["fused_rk4_sharded_xmatmul_general"]}


# RK4 steps of the window phase 6's two- and four-step rollouts take (whole
# calls of both), shorter than phase 6's 100-step rollouts: the plain
# slab-by-slab rollout they are held to steps each slab in turn
SHARDED_SPC_STEPS = 20


def sharded_multi_step_phase(env, state, cyl, moved, tspan, dev):
    """Phase 6, two and four steps a launch on slabs
    (`rk4_steps_tiled<XM, GENERAL, SPC, true>`: K4 and K4-XM with a
    4 spc-column halo): from phase 3's state, the 4-shard rollout at 700^2
    (`build_stacked_rollout(..., steps_per_call=spc)`) over
    SHARDED_SPC_STEPS steps, calls from the window's times and their steps
    at the sub-step times, in both d/dx forms and both rasterisations,
    against its plain version (`build_rollout` over the plain slab steps)
    and the one-step rollout at the same times, bit for bit on the state,
    its launches counted, and the owner pass on those wider slabs against
    its plain version bit for bit; each rollout's ms a step host-driven and
    as device work beside one step a launch, in turns; one launch of the 4
    stacked slabs against its plain version bit for bit, halo columns
    included, timed with its plain version and its bound (the slabs'
    states read and written once a launch). Returns {counter: (max abs
    err, ms, plain ms, bound, device ms, launches of the rollout held to
    its plain version)}."""
    import numpy as np
    import torch

    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.parallel import make_mesh
    from waves_jl_tpu_torch.parallel.fused_domain import (build_rollout, build_stacked_rollout,
                                                          cut_slabs, shard_slabs)
    from waves_jl_tpu_torch.physics.fused import step_config

    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    shape = state.source.shape
    u0 = state.wave[-1]
    n_cyl = cyl.shape[1]
    shards, steps = 4, SHARDED_SPC_STEPS
    ny = SIZE // shards
    mesh4 = make_mesh(devices=[dev] * shards)
    rows = {}
    for spc in (2, 4):
        times = fk.call_step_times(tspan[:steps:spc], spc, cfg.dt)
        span = np.array(times + [float(tspan[steps])], np.float32)
        ti, tf = float(span[0]), float(span[-1])
        slabs = shard_slabs(SIZE, shards, fk.HALO * spc)
        us = torch.stack(cut_slabs(u0, slabs, [dev] * shards))
        sh = torch.stack(cut_slabs(shape, slabs, [dev] * shards))
        for radii, cyl_ in ((True, cyl), (False, moved)):
            owners_k = owners_p = None
            if radii:
                owners_k = fk.select_owner_slabs(cyl_, cfg, slabs)
                owners_p = fk.select_owner_slabs_reference(cyl_, cfg, slabs)
                torch.cuda.synchronize()
                log("sharded", f"select_owner_slabs on the {shards} slabs of {slabs[0].w} columns "
                               f"(a {slabs[0].halo}-column halo) vs plain: "
                               f"{differing_cells(owners_k, owners_p)} of the five planes")
                check(torch.equal(owners_k, owners_p),
                      "the owner pass on the wider slabs equals its plain version bit for bit")
            for xm in (False, True):
                key = fk.step_key(False, xm, radii, spc, sharded=True)
                what = (f"{'K4-XM' if xm else 'K4'} {'radii-only' if radii else 'general'}, "
                        f"{spc} steps a launch")

                def roll(steps_per_call, xm=xm, radii=radii, cyl_=cyl_):
                    return build_stacked_rollout(mesh4, cfg, n_cyl, radii, xm, steps_per_call)(
                        u0, span, cyl_, shape, prof)

                before = dict(fk.launch_counts)
                u_k, e_k = roll(spc)
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in fk.launch_counts.items() if v != before[k]}
                u_p, e_p = build_rollout(mesh4, cfg, n_cyl, radii, fk.fused_rk4_step_reference,
                                         fk.select_owner_reference, xm, spc)(
                    u0, span, cyl_, shape, prof)
                u_1, e_1 = roll(1)
                torch.cuda.synchronize()
                sig_p, sig_1 = rel_err(e_k, e_p), rel_err(e_k, e_1)
                log("sharded", f"{what}: the {shards}-shard rollout, {steps} steps at {SIZE}^2 "
                               f"(slabs of {slabs[0].w} columns), launches {launched}; vs its plain "
                               f"version: {differing_cells(u_k, u_p)}, signal rel err {sig_p:.3e}; "
                               f"vs one step a launch at those times: {differing_cells(u_k, u_1)}, "
                               f"signal rel err {sig_1:.3e} (tol 1e-06)")
                expect = {key: steps // spc, **({"select_owner_sharded": 1} if radii else {})}
                check(launched == expect, f"{what}: one launch a call for the card's slabs, "
                                          f"{launched} == {expect}")
                check(torch.equal(u_k, u_p) and sig_p <= 1e-6,
                      f"{what}: the rollout equals its plain version bit for bit")
                check(torch.equal(u_k, u_1) and sig_1 <= 1e-6,
                      f"{what}: the rollout equals one step a launch bit for bit")
                turns = {1: [], spc: []}
                for per in (1, spc, spc, 1):
                    turns[per].append((cuda_ms(lambda: roll(per), 2) / steps,
                                       device_ms(lambda: roll(per), 1) / steps))
                log("sharded", f"{what}: ms a step of the {shards}-shard rollout, host-driven "
                               f"(device work), in turns: one step a launch " + ", ".join(
                                   f"{a:.4f} ({b:.4f})" for a, b in turns[1])
                    + f"; {spc} steps a launch " + ", ".join(
                        f"{a:.4f} ({b:.4f})" for a, b in turns[spc]))

                def kernel(xm=xm, cyl_=cyl_, own=owners_k):
                    return fk.fused_rk4_step_slabs(us, sh, prof, cyl_, own, times[0], ti, tf, cfg,
                                                   slabs, xm, spc)

                def plain(xm=xm, cyl_=cyl_, own=owners_p):
                    return fk.fused_rk4_step_slabs_reference(us, sh, prof, cyl_, own, times[0],
                                                             ti, tf, cfg, slabs, xm, spc)

                got, want = kernel(), plain()
                torch.cuda.synchronize()
                e_rel = rel_err(got[1], want[1])
                log("sharded", f"{what}: one launch of the {shards} stacked slabs vs plain: "
                               f"{differing_cells(got[0], want[0])}, halo columns included; "
                               f"energies rel err {e_rel:.3e} (tol 1e-06)")
                check(torch.equal(got[0], want[0]) and e_rel <= 1e-6,
                      f"{what}: the stacked slabs equal their plain version bit for bit")
                ms, dev_only = cuda_ms(kernel, 20), device_ms(kernel, 20)
                plain_ms = cuda_ms(plain, 2)
                part = torch.empty((spc, shards, fk.step_partial_rows(SIZE, ny), 3))
                io = 2 * nbytes(us) + nbytes(sh, part, prof, cyl_)
                tested = n_cyl if radii else fk.tile_cylinders(
                    cyl_, cfg, fk.lerp_weight(times[0], ti, tf))
                bnd = bound(io, shards * fk.step_flops(SIZE, tested, radii, ny, x_matmul=xm,
                                                       steps_per_call=spc))
                log("sharded", f"{what}: one launch of the {shards} stacked slabs {ms:.4f} ms "
                               f"(device work {dev_only:.4f}, {dev_only / spc:.4f} a step; plain "
                               f"{plain_ms:.4f}); bound {bnd[0]:.5f} ms ({bnd[1]}; states "
                               f"{2 * nbytes(us) / 1e6:.1f} MB), {dev_only / bnd[0]:.2f}x")
                err = max(float(torch.max(torch.abs(u_k - u_p))),
                          float(torch.max(torch.abs(got[0] - want[0]))))
                rows[key] = (err, ms, plain_ms, bnd, dev_only, launched.get(key, 0))
    return rows


def datagen_phase(dev, k5_dev_ms: float, cli_out: str):
    """Phase 7: datagen at bench.py's operating point through the datagen
    CLI's env and `generate_episodes_chunked`, its checks, the storage
    round trips and one run of the CLI, which writes its dataset to
    `cli_out`. Returns the launch counts of the two timed chunks and their
    20 episodes (on the host)."""
    import tempfile

    import torch

    from waves_jl_tpu_torch.data import (generate_episodes_chunked, load_episode,
                                         load_episodes_shard, make_episode_chunk_fused,
                                         make_episode_fused, save_episode, save_episodes_shard)
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.scripts.datagen import build_env as datagen_env
    from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_stack

    env = datagen_env(SIZE, STEPS, WINDOWS, dev)
    policy = RandomDesignPolicy(env.action_space)
    gen = torch.Generator(device=dev).manual_seed(70)
    run_chunk = make_episode_chunk_fused(env)
    warm_s, _ = host_s(lambda: generate_episodes_chunked(env, policy, gen, CHUNK, CHUNK, run_chunk))
    log("datagen", f"warm chunk of {CHUNK} episodes {warm_s:.3f} s")

    eps = []
    fk.reset_launch_counts()
    t = time.time()
    generate_episodes_chunked(env, policy, gen, 2 * CHUNK, CHUNK, run_chunk,
                              on_episode=lambda i, ep: eps.append(ep))
    per_episode = (time.time() - t) / (2 * CHUNK)
    counts = dict(fk.launch_counts)
    per_ep = WINDOWS * STEPS  # K5 radii-only takes one launch a step
    log("datagen", f"{per_episode:.4f} s per episode (2 chunks of {CHUNK}, {WINDOWS} actions x "
                   f"{STEPS} steps at {SIZE}^2, host pull included); launches {counts}")
    expect = dict.fromkeys(counts, 0)
    expect.update({"fused_rk4_xmatmul_radii_only": 2 * CHUNK * per_ep,
                   "select_owner": 2 * CHUNK * WINDOWS})
    check(counts == expect, f"datagen launches K5 {per_ep} times an episode and no K1/K2: "
                            f"{counts} == {expect}")
    check(len(eps) == 2 * CHUNK, f"{2 * CHUNK} episodes handed over")
    check(all(bool(torch.isfinite(x).all()) for ep in eps for x in tree_leaves(ep)),
          "every leaf of every episode is finite")
    check(all(tuple(ep.s_wave.shape) == (WINDOWS, 128, 128, 4) for ep in eps),
          "observations are (20, 128, 128, 4)")
    first = max(float(ep.y[0, :, 2].abs().max()) for ep in eps)
    last = min(float(ep.y[-1, :, 2].max()) for ep in eps)
    log("datagen", f"scattered energy: at most {first} in the first window, at least {last:.4e} "
                   f"at its peak in the last")
    check(first == 0.0 and last > 0.0,
          "the scattered energy is 0 in the first window and positive by the last")

    # does the host stay ahead of the card? one episode issued, then waited for
    st = env_reset(env, gen)
    acts = tree_stack([policy(gen) for _ in range(WINDOWS)])
    one = make_episode_fused(env)
    torch.cuda.synchronize()
    t = time.perf_counter()
    one(st, acts)
    issue = time.perf_counter() - t
    torch.cuda.synchronize()
    total = time.perf_counter() - t
    log("datagen", f"one episode: the host issues it in {issue:.4f} s, the card finishes at "
                   f"{total:.4f} s; {WINDOWS * STEPS} K5 steps alone, as device work, "
                   f"{WINDOWS * STEPS * k5_dev_ms / 1e3:.4f} s")

    with tempfile.TemporaryDirectory() as tmp:
        ep = eps[0]
        for ext in ("wbin", "npz"):
            path = os.path.join(tmp, f"episode.{ext}")
            save_s, _ = host_s(lambda: save_episode(ep, path))
            back = load_episode(path, device=None)
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(ep), tree_leaves(back)))
            log("datagen", f".{ext}: saved in {save_s:.4f} s, read back bit for bit {same}")
            check(same, f"an episode round-trips through .{ext}")
        path = os.path.join(tmp, "data.wshard")
        save_episodes_shard(path, eps[:2])
        back = load_episodes_shard(path)
        same = len(back) == 2 and all(torch.equal(a, b) for e, r in zip(eps, back)
                                      for a, b in zip(tree_leaves(e), tree_leaves(r)))
        log("datagen", f"shard of 2 episodes read back bit for bit {same}")
        check(same, "episodes round-trip through a shard")

        out = cli_out
        t = time.time()
        proc = subprocess.run([sys.executable, "-m", "waves_jl_tpu_torch.scripts.datagen",
                               "--episodes", "2", "--format", "shard", "--out", out],
                              cwd=ROOT, capture_output=True, text=True, timeout=600, check=False)
        cli_s = time.time() - t
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-1:] or [""]
        log("datagen", f"CLI --episodes 2 --format shard: exit {proc.returncode} in {cli_s:.2f} s: "
                       f"{tail[0]}")
        check(proc.returncode == 0, f"the datagen CLI exits 0:\n{proc.stdout}\n{proc.stderr}")
        cli_eps = load_episodes_shard(os.path.join(out, "data.wshard"))
        check(len(cli_eps) == 2 and os.path.exists(os.path.join(out, "env.json"))
              and all(bool(torch.isfinite(x).all()) for e in cli_eps for x in tree_leaves(e)),
              "the CLI wrote 2 finite episodes and env.json")
    return counts, eps


def record_controllers_phase(env, env_lo, space, dev):
    """Phase 8: the controllers behind the README's records at 700^2 (triple
    ring, Gaussian source on x = -10): CEM + gradient polish on the pools3
    surrogate at the record's configuration, the warm start's carry, the
    behaviour-cloned one-shot policy, the hybrid with a CEM searcher, and
    the MPC evaluation CLI once. Each episode's launches are read from its
    own run. Returns nothing: its kernels are phase 3's."""
    import dataclasses
    import tempfile

    import torch

    from waves_jl_tpu_torch.control.mpc import (CEMShooting, HybridShooting,
                                                make_hybrid_action_fused, make_mpc_episode_fused,
                                                make_policy_episode_fused)
    from waves_jl_tpu_torch.env import env_reset
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.models.policy import AmortizedPolicy
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_policy_checkpoint

    def surrogate(path):
        model = AcousticEnergyModel(space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                    integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                    device=dev)
        log("records", f"surrogate loaded from {path} (step "
                       f"{load_model_checkpoint(model, os.path.join(ROOT, path))})")
        return model

    low, high = env.action_space.low.config.cylinders.r, env.action_space.high.config.cylinders.r

    def inside(r):
        return bool(((r >= low) & (r <= high)).all())

    def expect_window_launches(counts, windows, what):
        expect = dict.fromkeys(counts, 0)
        expect.update({"fused_rk4_xmatmul_radii_only": windows * STEPS,  # one launch a step
                       "select_owner": windows})
        check(counts == expect, f"{what} launches K5 radii-only alone: {counts} == {expect}")

    # CEM + polish at the record's configuration (mpc_results_pools3_cem_polish10.json;
    # the polish's top 16 from BASELINE.md:43)
    pools3 = surrogate(CHECKPOINT_POOLS3)
    polished = []

    class RecordCEM(CEMShooting):
        def polish(self, env_, state_, actions, cost):
            out = super().polish(env_, state_, actions, cost)
            polished.append(out[0].config.cylinders.r[self.shots:])
            return out

    cem = RecordCEM(model=pools3, **CEM_RECORD)
    shots, topk = CEM_RECORD["shots"], CEM_RECORD["polish_topk"]
    gen = torch.Generator(device=dev).manual_seed(80)
    start = env_reset(env, torch.Generator(device=dev).manual_seed(81))
    st = start
    step = make_env_step_fused(env)
    for a in [env.action_space.sample(gen) for _ in range(5)]:  # the wave reaches the cloak
        st, _ = step(st, a)
    first_s, _ = host_s(lambda: cem(env, st, gen))  # the first selection, cold
    actions_n = WINDOWS if WINDOWS * first_s <= 90.0 else 5
    log("records", f"first CEM + polish selection (cold) {first_s:.4f} s" + (
        f"; depth cut: {WINDOWS} selections would take about {WINDOWS * first_s:.0f} s (> 90 s), "
        f"so the episode runs {actions_n} actions, from the state after 5 random windows"
        if actions_n < WINDOWS else ""))
    env_n = dataclasses.replace(env, actions=actions_n)
    run = make_mpc_episode_fused(env_n, cem)
    polished.clear()
    fk.reset_launch_counts()
    ep_s, (final, signals, chosen, costs) = host_s(lambda: run(st, gen))
    counts = dict(fk.launch_counts)
    log("records", f"CEM + polish episode ({actions_n} actions x {STEPS} steps at {SIZE}^2) "
                   f"{ep_s:.4f} s, {ep_s / actions_n:.4f} s an action; launches {counts}")
    expect_window_launches(counts, actions_n, "the CEM episode")
    check(tuple(signals.shape) == (actions_n, STEPS + 1, 3) and bool(torch.isfinite(signals).all()),
          "every CEM episode signal is finite")
    check(float(signals[:, :, 2].max()) > 0.0, "the scattered field is non-zero")
    check(tuple(costs.shape) == (actions_n, shots + topk), f"costs shape {tuple(costs.shape)}")
    check(bool((chosen <= costs[:, :shots].min(dim=1).values).all()),
          "each chosen cost is at most the lowest unpolished population cost of its selection")
    check(len(polished) == actions_n and all(inside(r) for r in polished),
          "every selection's polished actions stay inside the box")
    log("records", f"signals finite, sc energy max {float(signals[:, :, 2].max()):.4e}; the "
                   f"polish chose the action in {int((costs.argmin(dim=1) >= shots).sum())} of "
                   f"{actions_n} selections")

    # one warm selection apart, from the episode's final state
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pop_s, (actions, cost) = host_s(lambda: cem.population(env, final, gen))
    pop_peak = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    pol_s, (all_actions, all_cost) = host_s(lambda: cem.polish(env, final, actions, cost))
    pol_peak = torch.cuda.max_memory_allocated(dev) - base
    gain = float(cost.min() - all_cost[shots:].min())
    log("records", f"one CEM + polish selection {pop_s + pol_s:.4f} s: population ({shots} shots "
                   f"x {CEM_RECORD['iters'] + 1} rounds of {HORIZON * STEPS // STRIDE} latent "
                   f"steps) {pop_s:.4f} s, polish ({CEM_RECORD['polish_steps']} gradient steps on "
                   f"the top {topk}) {pol_s:.4f} s; peak memory above the state "
                   f"{pop_peak / 1e6:.1f} MB and {pol_peak / 1e6:.1f} MB; best cost "
                   f"{float(cost.min()):.6e} -> {float(all_cost.min()):.6e} (the polish lowers it "
                   f"by {gain:.3e})")
    check(tuple(all_cost.shape) == (shots + topk,) and bool(torch.isfinite(all_cost).all()),
          "the polished set's costs are finite")
    check(inside(all_actions.config.cylinders.r), "polished actions stay inside the box")

    # the warm start's carry: 3 actions, no polish; candidate 0 of each
    # round-0 population is the previous plan shifted one window left
    evaluated, plans = [], []

    class WarmCEM(CEMShooting):
        def _cost(self, env_, state_, n, grad=False):
            cost_fn = super()._cost(env_, state_, n, grad)

            def recorded(acts):
                evaluated.append(acts.config.cylinders.r[0].clone())
                return cost_fn(acts)

            return recorded

        def __call__(self, *args, incumbent=None):
            out = super().__call__(*args, incumbent=incumbent)
            plans.append(out[1]["seq"].config.cylinders.r)
            return out

    warm_kw = {k: v for k, v in CEM_RECORD.items() if not k.startswith("polish")}
    warm = WarmCEM(model=pools3, warm=True, **warm_kw)
    fk.reset_launch_counts()
    warm_s, (_, w_signals, _, _) = host_s(
        lambda: make_mpc_episode_fused(dataclasses.replace(env, actions=3), warm)(start, gen))
    w_counts = dict(fk.launch_counts)
    rounds = CEM_RECORD["iters"] + 1
    firsts = evaluated[::rounds]
    carried = [torch.equal(firsts[0], torch.zeros_like(firsts[0]))] + [
        torch.equal(firsts[i], torch.cat([plans[i - 1][1:], plans[i - 1][-1:]]))
        for i in range(1, 3)]
    log("records", f"warm CEM episode, 3 actions, {warm_s:.4f} s; candidate 0 of round 0 is the "
                   f"box midpoint, then the shifted plan: {carried}; launches {w_counts}")
    check(len(evaluated) == 3 * rounds and all(carried), "the warm start carries the shifted plan")
    check(bool(torch.isfinite(w_signals).all()), "the warm CEM episode's signals are finite")
    expect_window_launches(w_counts, 3, "the warm CEM episode")

    # the behaviour-cloned one-shot policy, tracked weights at h 256
    policy = AmortizedPolicy.create(space, env.action_space, h_size=256, device=dev)
    ck = load_policy_checkpoint(policy.net, os.path.join(ROOT, CHECKPOINT_POLICY))
    log("records", f"policy loaded from {CHECKPOINT_POLICY} (step {ck})")
    acted = []
    action = policy.action
    object.__setattr__(policy, "action",
                       lambda obs, design: acted.append(action(obs, design)) or acted[-1])
    run_p = make_policy_episode_fused(env, policy)
    run_p(start)  # warm
    torch.cuda.synchronize()
    acted.clear()
    fk.reset_launch_counts()
    pol_ep_s, (_, p_signals, p_costs) = host_s(lambda: run_p(start))
    p_counts = dict(fk.launch_counts)
    log("records", f"policy episode ({WINDOWS} actions) {pol_ep_s:.4f} s; launches {p_counts}")
    expect_window_launches(p_counts, WINDOWS, "the policy episode")
    check(bool(torch.isfinite(p_signals).all()) and not bool(p_costs.any()),
          "the policy episode's signals are finite and its costs zero")
    check(len(acted) == WINDOWS and all(inside(a.config.cylinders.r) for a in acted),
          "the policy's actions stay inside the box")
    log("records", f"policy actions inside the box; sc energy max "
                   f"{float(p_signals[:, :, 2].max()):.4e}")

    # the hybrid with a CEM searcher (--hybrid-cem) at phase 5's configuration
    ft = surrogate(CHECKPOINT_HYBRID)
    searcher = CEMShooting(model=ft, horizon=HORIZON, shots=SHOTS, alpha=1.0,
                           iters=CEM_RECORD["iters"], elites=CEM_RECORD["elites"])
    kw = dict(horizon=HORIZON, shots=SHOTS, topk=TOPK, alpha=1.0, rerank_env=env_lo,
              searcher=searcher)
    act, hstep = make_hybrid_action_fused(env, ft, **kw)
    seq = HybridShooting(env, ft, batched=False, **kw)
    act(final, gen)  # warm
    fk.reset_launch_counts()
    prune_s, pruned = host_s(lambda: act.prune(final, gen))
    rerank_s, (ev_actions, ev_cost) = host_s(lambda: act.rerank(final, *pruned, gen))
    h_counts = dict(fk.launch_counts)
    seq_cost = seq.rerank(final, *pruned, gen)[1]
    err = rel_err(seq_cost, ev_cost)
    log("records", f"hybrid selection with a CEM searcher: prune (CEM population) {prune_s:.4f} s, "
                   f"re-rank ({TOPK} at {SIZE_RERANK}^2 through batched K5) {rerank_s:.4f} s; "
                   f"costs against the sequential re-rank rel err {err:.3e} (tol 1e-05), chosen "
                   f"{int(torch.argmin(ev_cost))} vs {int(torch.argmin(seq_cost))}; launches "
                   f"{h_counts}")
    expect = dict.fromkeys(h_counts, 0)
    expect.update({"fused_rk4_batched_xmatmul_radii_only": HORIZON * STEPS,  # one a step
                   "select_owner_batched": HORIZON})
    check(h_counts == expect, f"the searcher's re-rank launches batched K5: {h_counts} == {expect}")
    check(err <= 1e-5 and int(torch.argmin(seq_cost)) == int(torch.argmin(ev_cost)),
          "the batched and sequential re-ranks of the searcher's candidates agree")

    # the evaluation CLI once, in a subprocess
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        t = time.time()
        proc = subprocess.run([sys.executable, "-m", "waves_jl_tpu_torch.scripts.mpc",
                               "--controller", "policy", "--checkpoint",
                               os.path.join(ROOT, CHECKPOINT_POLICY), "--locations", "1",
                               "--episodes", "1", "--out", out],
                              cwd=ROOT, capture_output=True, text=True, timeout=600, check=False)
        cli_s = time.time() - t
        check(proc.returncode == 0, f"the MPC CLI exits 0:\n{proc.stdout}\n{proc.stderr}")
        with open(out) as f:
            result = json.load(f)
        log("records", f"MPC CLI --controller policy --locations 1 --episodes 1: exit 0 in "
                       f"{cli_s:.2f} s")
        print(json.dumps(result), flush=True)
        check(all(math.isfinite(d) for d in result["percentage_decrease"]),
              "the CLI's decrease is finite")


def train_phase(dev, episodes, cli_data: str, smi: str, save_batch: str | None = None):
    """Phase 9: training the flagship at the tracked record's width
    (`ref500_h8s4`: 1,024 elements, h_size 256, nfreq 500, latent stride 4)
    from its weights on phase 7's 20 episodes (18 train, 2 validation), by
    the mixed-horizon recipe cut to horizons (1, 4, 8): batch 4, accumulate
    8, lr 1e-4, sc_weight 4, checkpoint "sqrt", one cycle (3 updates). A
    micro-step's time, host issue time and memory in each checkpoint mode,
    then the seven checks. Training launches none of the CUDA kernels."""
    import tempfile

    import numpy as np
    import torch

    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel, energy_loss
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.train import (TrainConfig, gather_window_batch, load_checkpoint,
                                          make_optimizer, make_train_step, save_checkpoint,
                                          stack_episodes, train_windowed)
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_params
    from waves_jl_tpu_torch.utils.trees import tree_map

    def flagship(device=dev, checkpoint="sqrt"):
        model = AcousticEnergyModel(build_triple_ring_design_space(device=device), 1000.0,
                                    elements=1024, h_size=256, nfreq=500,
                                    integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                    checkpoint=checkpoint, device=device)
        load_model_checkpoint(model, os.path.join(ROOT, CHECKPOINT))
        return model

    def sc4(m):
        return lambda b: energy_loss(m, b, sc_weight=4.0)

    def params_of(m):
        return {k: v.detach().clone() for k, v in m.named_parameters()}

    horizons, B, acc = (1, 4, 8), 4, 8
    store = stack_episodes(episodes[:18], dev)
    rng = np.random.default_rng(9)
    idx8 = torch.as_tensor(np.stack([rng.integers(0, 18, B), rng.integers(0, WINDOWS - 7, B)], -1),
                           device=dev)
    batch8 = gather_window_batch(store, idx8, 8, STRIDE)
    batch1 = [gather_window_batch(store, torch.as_tensor(np.stack(
        [rng.integers(0, 18, B), rng.integers(0, WINDOWS, B)], -1), device=dev), 1, STRIDE)
        for _ in range(2 * acc)]
    log("train", f"flagship from {CHECKPOINT}; 18 + 2 episodes on the card; a batch of "
                 f"{B} horizon-8 windows has {batch8['t'].shape[1]} latent times")

    # forward and backward of 4 horizon-8 windows in each checkpoint mode: the
    # time, the host's issue time, the activations the forward keeps for the
    # backward, and the peak above the memory held before
    probe = {}
    for mode in ("none", "step", "sqrt"):
        m = flagship(checkpoint=mode)
        ps = list(m.parameters())
        for rep in range(2):  # the first warms the allocator, cuDNN and checkpoint's imports
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with full_float32():
                loss = sc4(m)(batch8)
                fwd_issue = time.perf_counter() - t
                torch.cuda.synchronize()
                fwd = time.perf_counter() - t
                kept = torch.cuda.memory_allocated() - base
                torch.autograd.grad(loss, ps)
            issue = time.perf_counter() - t
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        probe[mode] = dict(wall=wall, issue=issue, fwd=fwd, fwd_issue=fwd_issue,
                           kept=kept / 2**20, peak=peak / 2**20)
        log("train", f"checkpoint={mode!r}: forward and backward of {B} horizon-8 windows "
                     f"{wall * 1e3:.1f} ms (forward {fwd * 1e3:.1f}); the host issues them in "
                     f"{issue * 1e3:.1f} ms ({issue / wall:.3f} of the time); the forward keeps "
                     f"{kept / 2**20:.1f} MiB for the backward; peak {peak / 2**20:.1f} MiB "
                     f"above the {base / 2**20:.1f} MiB held before")
        del m, ps, loss
    check(probe["none"]["kept"] > probe["sqrt"]["kept"] > 0
          and probe["none"]["kept"] > probe["step"]["kept"] > 0,
          "checkpointing keeps less for the backward than 'none'")

    # 1. train_windowed, one cycle (the recipe's smallest: a chunk of 8
    # micro-steps a horizon): 3 updates, 24 micro-steps
    model = flagship()
    fk.reset_launch_counts()
    cfg = TrainConfig(lr=1e-4, batch_size=B, accumulate=acc, epochs=1, val_every=1,
                      val_batches=2, seed=0)
    t = time.time()
    model, opt_state, logger = train_windowed(sc4(model), model, episodes[:18], episodes[18:],
                                              cfg, horizons=horizons, stride=STRIDE,
                                              windows_per_horizon=32)
    train_s = time.time() - t
    hist = logger.history
    for rec in hist:
        log("train", "update {step}: train {train_loss:.6g} (h1 {train_loss_h1:.4g}, h4 "
                     "{train_loss_h4:.4g}, h8 {train_loss_h8:.4g}), val {val_loss:.6g} "
                     "(h1 {val_loss_h1:.4g}, h4 {val_loss_h4:.4g}, h8 {val_loss_h8:.4g})"
                     .format(**rec))
    launched = {k: v for k, v in fk.launch_counts.items() if v}
    log("train", f"train_windowed: {hist[-1]['step']} updates ({hist[-1]['step'] * acc} "
                 f"micro-steps of {B} windows, horizons 1/4/8 in turn) in {train_s:.2f} s with "
                 f"validation; {hist[-1]['step_time']:.4f} s an optimizer update; kernel "
                 f"launches {launched}")
    updates = hist[-1]["step"]
    check(updates == 3 and len(hist) == 1, "one cycle, 3 updates")
    check(all(math.isfinite(v) for r in hist for k, v in r.items() if "loss" in k),
          "every logged loss is finite")
    check(not launched, "training launches none of the CUDA kernels")

    # 2. the card's gradient against the CPU's on one window (batch 1, horizon 1)
    one = tree_map(lambda x: x[:1], batch1[0])
    cpu_model = flagship(torch.device("cpu"))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    grads = []
    for m, b in ((model, one), (cpu_model, tree_map(lambda x: x.cpu(), one))):
        ps = dict(m.named_parameters())
        with full_float32():
            grads.append(dict(zip(ps, torch.autograd.grad(sc4(m)(b), list(ps.values())))))
    worst = max((rel_err(grads[0][k].cpu(), grads[1][k]), k) for k in grads[1])
    log("train", f"gradient on the card against the CPU's, one horizon-1 window: worst leaf "
                 f"{worst[0]:.3e} of its largest magnitude ({worst[1]})")
    check(worst[0] <= 1e-4, "the card's gradient matches the CPU's to 1e-4 per leaf")
    del cpu_model, grads

    # 3. learning: 10 updates (accumulate 1) on one fixed batch of 4 horizon-8
    # windows; 'none' keeps every activation, which this check can afford.
    # From these converged weights Adam's first updates move every parameter
    # by about lr whatever its gradient: at the recipe's 1e-4 that raises the
    # batch's loss in the JAX package too (tests/test_torch_train_learning.py
    # holds both packages on this batch, saved by --save-train-batch), so the check runs at the 1e-5 of
    # a low-lr fine-tune from a converged step. With `save_batch`, the batch
    # and both trajectories, 1e-4's too, go to that file.
    def learn(lr):
        learner = flagship(checkpoint="none")
        opt1 = make_optimizer(TrainConfig(lr=lr, accumulate=1))
        step1 = make_train_step(sc4(learner), opt1)
        state1 = opt1.init(dict(learner.named_parameters()))
        losses = []
        for _ in range(10):
            _, state1, loss = step1(learner, state1, batch8)
            losses.append(loss.detach())
        with torch.no_grad(), full_float32():
            losses.append(sc4(learner)(batch8))
        traj = [float(v) for v in torch.stack(losses).cpu()]
        log("train", f"10 updates at lr {lr:g} on one batch of 4 horizon-8 windows: loss "
                     + " ".join(f"{v:.6g}" for v in traj))
        return traj

    traj = {1e-5: learn(1e-5)}
    check(traj[1e-5][-1] < traj[1e-5][0], "10 updates on a fixed batch lower its loss")
    if save_batch:
        from waves_jl_tpu_torch.utils.trees import encode_structure, tree_named_leaves

        traj[1e-4] = learn(1e-4)
        named = {k: v.detach().cpu().numpy() for k, v in tree_named_leaves(batch8).items()}
        os.makedirs(os.path.dirname(os.path.abspath(save_batch)), exist_ok=True)
        np.savez_compressed(save_batch, **named,
                            structure=np.array(json.dumps(encode_structure(batch8))),
                            traj_lr1e_5=np.array(traj[1e-5]), traj_lr1e_4=np.array(traj[1e-4]))
        log("train", f"the batch and its trajectories written to {save_batch}")

    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        # 4. the checkpoint's parameter names and shapes are JAX's
        path = os.path.join(tmp, f"checkpoint_step={updates}")
        save_checkpoint(path, model, opt_state, updates)
        ours = load_params(path)
        tracked = load_params(os.path.join(ROOT, CHECKPOINT))
        same = ({k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in tracked.items()})
        log("train", f"params.npz: {len(ours)} leaves, key set and shapes those of the tracked "
                     f"checkpoint {same}; opt_state.npz with "
                     f"{len(np.load(os.path.join(path, 'opt_state.npz')).files)} leaves")
        check(same, "the checkpoint has exactly the tracked params.npz's keys and shapes")

        # 5. reload: a fresh model predicts bit for bit what the trained one does
        fresh = flagship()
        opt = make_optimizer(cfg)
        fresh, fresh_state, step_no = load_checkpoint(
            path, fresh, opt_state_like=opt.init(dict(fresh.named_parameters())))
        with torch.no_grad():
            same = torch.equal(fresh(batch8), model(batch8))
        log("train", f"reloaded at step {step_no}: predictions bit for bit {same}")
        check(same and step_no == updates,
              "the reloaded model predicts bit for bit as the trained one")

        # 6. resume: one more update (8 micro-steps) from the checkpoint equals the
        # uninterrupted run's, cuDNN deterministic
        for m, s in ((model, opt_state), (fresh, fresh_state)):
            step = make_train_step(sc4(m), opt)
            for b in batch1[:acc]:
                _, s, _ = step(m, s, b)
            check(s.gradient_step == updates + 1 and s.mini_step == 0, "the next update applied")
        same = all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
        log("train", f"one more update resumed from the checkpoint against the uninterrupted "
                     f"run: parameters bit for bit {same}")
        check(same, "resuming gives the uninterrupted run's next update")
    torch.backends.cudnn.deterministic = False
    del fresh, model, store

    # 7. the train CLI on the dataset phase 7's datagen CLI wrote
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run")
        t = time.time()
        proc = subprocess.run([sys.executable, "-m", "waves_jl_tpu_torch.scripts.train",
                               "--data", cli_data, "--out", out, "--horizons", "1", "2",
                               "--latent-stride", str(STRIDE), "--epochs", "1", "--batch", "16",
                               "--accumulate", "2", "--val-every", "2", "--val-batches", "1",
                               "--sc-weight", "4", "--init-from", os.path.join(ROOT, CHECKPOINT)],
                              cwd=ROOT, capture_output=True, text=True, timeout=600, check=False)
        cli_s = time.time() - t
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-1:] or [""]
        log("train", f"train CLI --horizons 1 2 --latent-stride 4 --epochs 1 --batch 16 "
                     f"--accumulate 2: exit {proc.returncode} in {cli_s:.2f} s: {tail[0]}")
        check(proc.returncode == 0, f"the train CLI exits 0:\n{proc.stdout}\n{proc.stderr}")
        dirs = sorted(d for d in os.listdir(out) if d.startswith("checkpoint_step="))
        check(bool(dirs) and os.path.exists(os.path.join(out, "metrics.jsonl"))
              and os.path.exists(os.path.join(out, dirs[-1], "params.npz")),
              "the CLI wrote a checkpoint_step=N dir and metrics.jsonl")
    sq = probe["sqrt"]
    log("train", f"{smi}: {hist[-1]['step_time']:.4f} s an optimizer update; forward and "
                 f"backward of 4 horizon-8 windows {sq['wall'] * 1e3:.1f} ms ('sqrt'), the "
                 f"host's issue {sq['issue'] / sq['wall']:.3f} of it; kept for the backward, "
                 f"MiB none/step/sqrt " + "/".join(f"{probe[k]['kept']:.1f}" for k in probe)
        + "; peak " + "/".join(f"{probe[k]['peak']:.1f}" for k in probe))


def distillation_phase(env, env_lo, space, dev, phase7_eps, cli_data: str, smi: str):
    """Phase 10: exact search and the distillation pipeline at 700^2. The
    256-shot oracle selection (horizon 5, alpha 1: mpc_results_oracle256.json),
    its chunks of 64 candidates through batched K5 at 700^2, timed on the
    host, on the card and as the host's issue time, its launches counted,
    three of its shots replayed through the sequential `OracleShooting` and
    one 64-candidate step held against K5 on four candidates alone; a
    64-shot oracle episode cut to 3 actions; a pool harvest episode at
    `datagen_pools.py`'s defaults and one DAgger probe under the pools3 CEM
    + polish searcher; a recorded 256-shot random-shooting episode (epsilon
    0.25) cut to 5 actions; pool-ranking updates from `ref500_h8s4` on the
    harvest and phase 7's episodes, with the card's gradient against the
    CPU's; behaviour-cloning updates on the recorded episode; one gradient
    and one ensemble selection; and each new CLI once, in subprocesses.
    Returns the oracle selection's launch counts, and the errors, times
    and bounds of that shape's step and owner pass."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from waves_jl_tpu_torch.control.mpc import (EXACT_CHUNK, CEMShooting, EnsembleShooting,
                                                GradientShooting, OracleShooting, RandomShooting,
                                                compute_action_cost, make_mpc_episode_recorded,
                                                make_oracle_action_fused,
                                                make_oracle_episode_fused, make_pool_probe_fused)
    from waves_jl_tpu_torch.data import load_episode, prepare_dataset, save_episode
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.env import env_reset, env_terminated
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.models.policy import AmortizedPolicy, bc_loss
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import cyl_params, step_config
    from waves_jl_tpu_torch.scripts.datagen_pools import load_pools, save_pools
    from waves_jl_tpu_torch.scripts.train_bc import episodes_to_bc_dataset
    from waves_jl_tpu_torch.scripts.train_pools import (make_pool_update, pool_metrics,
                                                        pool_objective)
    from waves_jl_tpu_torch.train import TrainConfig, train
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_params
    from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map, tree_named_leaves

    def surrogate(path, device=dev):
        model = AcousticEnergyModel(build_triple_ring_design_space(device=device), 1000.0,
                                    elements=1024, h_size=256, nfreq=500,
                                    integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                    device=device)
        load_model_checkpoint(model, os.path.join(ROOT, path))
        return model

    def timed(fn):
        """(host s, card s between events around the call, host issue s,
        result) of fn(), synchronised at both ends."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = fn()
        issue = time.perf_counter() - t
        end.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t, start.elapsed_time(end) / 1e3, issue, out

    def only(counts, expect, what):
        full = dict.fromkeys(counts, 0)
        full.update(expect)
        check(counts == full, f"{what}: launches {counts} == {full}")

    gen = torch.Generator(device=dev).manual_seed(100)
    step = make_oracle_action_fused(env, horizon=HORIZON, shots=ORACLE_SHOTS)[1]
    start = env_reset(env, gen)
    for _ in range(WINDOWS // 2):  # 10 ms: the wavefront has reached the cloak
        start, _ = step(start, env.action_space.sample(gen))
    torch.cuda.synchronize()

    # 1. the 256-shot oracle selection through batched K5 at 700^2, chunks of 64
    act, _ = make_oracle_action_fused(env, horizon=HORIZON, shots=ORACLE_SHOTS, alpha=1.0)
    chunks = -(-ORACLE_SHOTS // EXACT_CHUNK)
    fk.reset_launch_counts()
    wall, card, issue, (actions, cost) = timed(lambda: act.select(start, gen))
    oracle_counts = dict(fk.launch_counts)
    a, chosen = act.choose(actions, cost)
    log("distill", f"oracle selection ({ORACLE_SHOTS} shots x {HORIZON} windows at {SIZE}^2, "
                   f"{chunks} chunks of {EXACT_CHUNK} through batched K5) {wall:.4f} s; the card "
                   f"{card:.4f} s between events; the host issues it in {issue:.4f} s; launches "
                   f"{oracle_counts}")
    k5b = "fused_rk4_batched_xmatmul_radii_only"
    only(oracle_counts, {k5b: HORIZON * STEPS * chunks,
                         "select_owner_batched": HORIZON * chunks}, "the oracle selection")
    energy = cost - compute_action_cost(actions)
    check(tuple(cost.shape) == (ORACLE_SHOTS,) and bool(torch.isfinite(cost).all())
          and float(energy.min()) > 0.0,
          "the oracle's costs are finite, their scattered energy positive")
    check(float(chosen) == float(cost.min()), "the chosen cost is the least of the costs")
    log("distill", f"oracle costs {float(cost.min()):.6e} to {float(cost.max()):.6e}, chosen "
                   f"{float(chosen):.6e}")

    sampled = [0, EXACT_CHUNK, ORACLE_SHOTS - 1]  # either side of a chunk boundary, the last
    seq = OracleShooting(step_fn=step, horizon=HORIZON, shots=len(sampled))
    picked = tree_map(lambda v: v[sampled], actions)
    object.__setattr__(seq, "candidates", lambda env_, generator: picked)
    seq_s, (_, info) = host_s(lambda: seq(env, start, gen))
    seq_err = rel_err(cost[sampled], info["cost"])
    log("distill", f"shots {sampled} replayed through the sequential OracleShooting "
                   f"({len(sampled)} x {HORIZON} K5 windows, {seq_s:.4f} s): costs rel err "
                   f"{seq_err:.3e} (tol 1e-06)")
    check(seq_err <= 1e-6, "the batched oracle's costs are the sequential route's")

    # one batched K5 step of 64 candidates at 700^2, the oracle's, and one
    # launch of SPC steps at that shape, and the owner pass, against their
    # plain versions, and each launch against K5 on four of the candidates
    # alone
    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    k, shape = EXACT_CHUNK, start.source.shape
    designs = tree_map(lambda x: x.expand(k, *x.shape), start.design)
    nxt = env.design_space(designs, tree_map(lambda v: v[:k, 0], actions))
    cyl = cyl_params(designs, nxt, dev).contiguous()
    u = start.wave[-1].expand(k, *start.wave.shape[1:]).contiguous()
    owner = fk.select_owner_batched(cyl, cfg)
    owner_p = fk.select_owner_batched_reference(cyl, cfg)
    own_abs = float(torch.max(torch.abs(owner - owner_p)))
    own_same = torch.equal(owner, owner_p)
    log("distill", f"the owner pass of {k} candidates at {SIZE}^2 vs plain: identical "
                   f"{own_same}, max abs diff {own_abs:.3e}")
    check(own_same, "the owner pass of 64 candidates at 700^2 equals its plain version bit for "
                    "bit")
    ti = float(start.time_step * 1e-5)
    times = (ti, ti, ti + 1e-3, cfg)
    picks = (0, k // 3, 2 * k // 3, k - 1)
    big = {}
    for spc in (1, SPC):
        what = "step" if spc == 1 else f"launch of {spc} steps"
        ub, eb = fk.fused_rk4_step_batched(u, shape, prof, cyl, owner, *times, x_matmul=True,
                                           steps_per_call=spc)
        up, ep = fk.fused_rk4_step_batched_reference(u, shape, prof, cyl, owner_p, *times,
                                                     x_matmul=True, steps_per_call=spc)
        torch.cuda.synchronize()
        big_state, big_sig = rel_err(ub, up), rel_err(eb, ep)
        big_abs = float(torch.max(torch.abs(ub - up)))
        log("distill", f"one batched K5 {what} of {k} candidates at {SIZE}^2 vs plain on the "
                       f"plain owner fields: rel err state {big_state:.3e}, signal {big_sig:.3e} "
                       f"(tol {REL_TOL:g}); {differing_cells(ub, up)}")
        check(big_state <= REL_TOL and big_sig <= REL_TOL,
              f"batched K5 ({what}) of 64 candidates at 700^2 agrees with its plain version")
        check(torch.equal(ub, up) and big_sig <= 1e-6,
              f"batched K5 ({what}) of 64 candidates at 700^2 equals its plain version bit for "
              "bit, its signal within 1e-6")
        del up
        same = []
        for b in picks:
            u1, e1 = fk.fused_rk4_step(u[b], shape, prof, cyl[b], owner[b], *times, x_matmul=True,
                                       steps_per_call=spc)
            same.append(torch.equal(ub[b], u1) and rel_err(eb[b], e1) <= 1e-6)
        log("distill", f"one batched K5 {what} of {k} candidates at {SIZE}^2 vs K5 on candidates "
                       f"{picks} alone: identical {same}")
        check(all(same), f"each of the 64 candidates is K5's state bit for bit ({what})")
        del ub, u1

        # that shape's launch timed alone, its plain version and its bound,
        # as phase 3 times 16 candidates at 350^2
        def big_step(route=fk.fused_rk4_step_batched, own=owner, spc=spc):
            return route(u, shape, prof, cyl, own, *times, x_matmul=True, steps_per_call=spc)

        big_ms, big_dev = cuda_ms(big_step, 10), device_ms(big_step, 10)
        big_plain = cuda_ms(lambda: big_step(fk.fused_rk4_step_batched_reference, owner_p), 1)
        step_bound = bound(fk.call_bytes(SIZE, cyl.shape[-1], spc, k),
                           k * fk.step_flops(SIZE, cyl.shape[-1], True, x_matmul=True,
                                             steps_per_call=spc))
        log("distill", f"batched K5 {what} of {k} candidates at {SIZE}^2: {big_ms:.4f} ms "
                       f"(device work {big_dev:.4f}; plain {big_plain:.4f}), "
                       f"{big_dev / k / spc:.5f} ms a candidate-step; bound "
                       f"{step_bound[0]:.5f} ms ({step_bound[1]}), {big_dev / step_bound[0]:.2f}x")
        big[spc] = (big_abs, big_ms, big_plain, step_bound, big_dev)
    # K3, the exact d/dx, at that shape and SPC steps a launch
    uk3, ek3 = fk.fused_rk4_step_batched(u, shape, prof, cyl, owner, *times, steps_per_call=SPC)
    up3, ep3 = fk.fused_rk4_step_batched_reference(u, shape, prof, cyl, owner_p, *times,
                                                   steps_per_call=SPC)
    torch.cuda.synchronize()
    k3_sig = rel_err(ek3, ep3)
    log("distill", f"one K3 launch of {SPC} steps of {k} candidates at {SIZE}^2 vs plain: signal "
                   f"{k3_sig:.3e}; {differing_cells(uk3, up3)}")
    check(torch.equal(uk3, up3) and k3_sig <= 1e-6,
          "K3 of 64 candidates at 700^2 equals its plain version bit for bit, its signal within "
          "1e-6")
    del uk3, up3

    own_ms = cuda_ms(lambda: fk.select_owner_batched(cyl, cfg), 10)
    own_dev = device_ms(lambda: fk.select_owner_batched(cyl, cfg), 10)
    own_plain = cuda_ms(lambda: fk.select_owner_batched_reference(cyl, cfg), 1)
    own_bound = bound(nbytes(cyl, owner), sum(owner_ops(c, cfg) for c in cyl))
    per_step = card / (HORIZON * STEPS * chunks) * 1e3  # the launches checked above
    log("distill", f"in the selection {per_step:.4f} ms a step, owner passes included; "
                   f"select_owner_batched {own_ms:.4f} ms (device work {own_dev:.4f}; plain "
                   f"{own_plain:.4f}), bound {own_bound[0]:.5f} ms ({own_bound[1]})")
    oracle_shape = {"shape": f"{k}x{SIZE}^2", "k5b": big[1], "k5b_spc": big[SPC],
                    "own": (own_abs, own_ms, own_plain, own_bound, own_dev)}
    del u, owner, owner_p

    # 2. a 64-shot oracle episode, cut to 3 actions
    env3 = dataclasses.replace(env, actions=3)
    run = make_oracle_episode_fused(env3, horizon=HORIZON, shots=ORACLE_EPISODE_SHOTS)
    fk.reset_launch_counts()
    ep_s, (final, signals, chosen3) = host_s(lambda: run(start, gen))
    only(dict(fk.launch_counts), {k5b: 3 * HORIZON * STEPS,
                                  "select_owner_batched": 3 * HORIZON,
                                  "fused_rk4_xmatmul_radii_only": 3 * STEPS,
                                  "select_owner": 3}, "the oracle episode")
    check(tuple(signals.shape) == (3, STEPS + 1, 3) and bool(torch.isfinite(signals).all())
          and bool(torch.isfinite(chosen3).all()), "the oracle episode's signals and costs")
    log("distill", f"{ORACLE_EPISODE_SHOTS}-shot oracle episode, 3 actions: {ep_s:.4f} s, {ep_s / 3:.4f} s an "
                   f"action; chosen costs {[round(float(c), 4) for c in chosen3]}")

    # 3. one pool harvest episode at datagen_pools.py's defaults
    probe, pstep = make_pool_probe_fused(env, K=16, horizon=HORIZON, alpha=1.0, rerank_env=env_lo)
    rng = np.random.default_rng(101)
    st, pools = env_reset(env, gen), []
    fk.reset_launch_counts()

    def harvest():
        nonlocal st
        while not env_terminated(env, st):
            pool, a_best = probe(st, gen)
            pools.append(tree_map(lambda v: v.cpu(), pool))
            st, _ = pstep(st, env.action_space.sample(gen) if rng.random() < 0.2 else a_best)

    harvest_s, _ = host_s(harvest)
    only(dict(fk.launch_counts),
         {k5b: WINDOWS * HORIZON * STEPS,
          "select_owner_batched": WINDOWS * HORIZON,
          "fused_rk4_xmatmul_radii_only": WINDOWS * STEPS, "select_owner": WINDOWS},
         "the harvest episode")
    y = torch.stack([p["y_true"] for p in pools])
    t0 = torch.stack([p["t0"] for p in pools])
    reached = t0 >= 0.01  # 10 ms: the wavefront has reached the cloak
    check(len(pools) == WINDOWS and tuple(y.shape) == (WINDOWS, 16)
          and bool(torch.isfinite(y).all()) and bool((y >= 0).all())
          and bool((y[reached] > 0).all()) and bool(reached.any()),
          "20 pools of 16, y_true finite, positive once the wavefront has reached the cloak")
    log("distill", f"pool harvest episode (16 candidates x {HORIZON} windows at "
                   f"{SIZE_RERANK}^2 a state, {WINDOWS} states, epsilon 0.2): {harvest_s:.4f} s, "
                   f"{harvest_s / WINDOWS:.4f} s a state; y_true up to {float(y.max()):.4e}")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "pools.npz")
    save_pools(path, pools)
    back = load_pools(path, env)
    harvested = tree_map(lambda *xs: torch.stack(xs), *pools)
    back = tree_named_leaves(back)
    same = all(torch.equal(v, back[k_]) for k_, v in tree_named_leaves(harvested).items())
    log("distill", f"the harvest's pools read back bit for bit {same}")
    check(same, "pools round-trip through save_pools/load_pools")

    # 4. one DAgger probe under the pools3 CEM + polish searcher
    pools3 = surrogate(CHECKPOINT_POOLS3)
    dagger, _ = make_pool_probe_fused(env, K=16, horizon=HORIZON, alpha=1.0, rerank_env=env_lo,
                                      searcher=CEMShooting(model=pools3, **CEM_RECORD),
                                      searcher_samples=8)
    fk.reset_launch_counts()
    dagger_s, (dpool, _) = host_s(lambda: dagger(start, gen))
    only(dict(fk.launch_counts), {k5b: HORIZON * STEPS,
                                  "select_owner_batched": HORIZON}, "the DAgger probe")
    check(tuple(dpool["y_true"].shape) == (16,) and float(dpool["y_true"].min()) > 0.0,
          "the DAgger pool's 16 exact costs are positive")
    log("distill", f"DAgger probe (CEM + polish of pools3: 256 shots, 3 x 32 elites, polish 10 "
                   f"on the top 16; 8 of its proposals and 8 uniform scored at "
                   f"{SIZE_RERANK}^2) {dagger_s:.4f} s")
    del pools3, dagger

    # 5. a recorded episode of 256-shot random shooting on ref500_h8s4, cut to 5 actions
    flagship = surrogate(CHECKPOINT)
    env5 = dataclasses.replace(env, actions=5)
    rec = make_mpc_episode_recorded(env5, RandomShooting(model=flagship, horizon=HORIZON,
                                                         shots=SHOTS), epsilon=0.25)
    rec_s, (_, ep) = host_s(lambda: rec(start, gen))
    shapes = (tuple(ep.s_wave.shape), tuple(ep.s_tspan.shape), tuple(ep.y.shape),
              tuple(ep.a.config.cylinders.r.shape), tuple(ep.s_design.config.cylinders.r.shape))
    check(shapes == ((5, 128, 128, 4), (5, STEPS + 1), (5, STEPS + 1, 3), (5, 18), (5, 18)),
          f"the recorded episode's fields {shapes}")
    os.makedirs(os.path.join(tmp.name, "recorded", "episodes"))
    path = os.path.join(tmp.name, "recorded", "episodes", "episode1.wbin")
    save_episode(ep, path)
    back = load_episode(path, device=None)
    same = all(torch.equal(a_.cpu(), b_) for a_, b_ in zip(tree_leaves(ep), tree_leaves(back)))
    log("distill", f"recorded episode (256-shot random shooting on {CHECKPOINT}, epsilon 0.25, "
                   f"5 actions) {rec_s:.4f} s; fields {shapes}; .wbin read back bit for bit {same}")
    check(same, "the recorded episode round-trips through .wbin")

    # 6. pool-ranking updates from ref500_h8s4 on the harvest and phase 7's episodes
    wdata = tree_map(lambda v: v.to(dev), prepare_dataset(phase7_eps[:18], 8, STRIDE))
    pdata = tree_map(lambda v: v.to(dev), harvested)
    before = pool_metrics(flagship, harvested)
    opt, update = make_pool_update(flagship, 3e-5)
    state = opt.init(dict(flagship.named_parameters()))
    wrng = np.random.default_rng(102)
    upd_s = []
    for _ in range(POOL_UPDATES):
        widx = torch.as_tensor(wrng.choice(wdata["s_wave"].shape[0], 8, replace=False),
                               device=dev)
        pidx = torch.as_tensor(wrng.choice(WINDOWS, 4, replace=False), device=dev)
        s_, (state, anchor, rank) = host_s(lambda: update(
            state, tree_map(lambda v: v[widx], wdata), tree_map(lambda v: v[pidx], pdata)))
        upd_s.append(s_)
        check(math.isfinite(float(anchor)) and math.isfinite(float(rank)),
              "the pool update's losses are finite")
    after = pool_metrics(flagship, harvested)
    log("distill", f"pool-ranking updates (8 horizon-8 windows and 4 pools of 16 each, lr "
                   f"3e-5): " + ", ".join(f"{s_:.4f} s" for s_ in upd_s)
        + f"; last anchor {float(anchor):.5g}, rank {float(rank):.5g}; pool metrics before "
          f"{before}, after {after}")
    check(before["live_pools"] > 0 and all(math.isfinite(after[k]) for k in
                                           ("pool_zmse", "spearman", "top1", "regret")),
          "pool metrics over live pools, finite after the updates")

    # the card's gradient on one update against the CPU's, from ref500_h8s4
    grads = []
    for device in (dev, torch.device("cpu")):
        model = surrogate(CHECKPOINT, device)
        to = lambda v: v.to(device)  # noqa: E731
        wb = tree_map(lambda v: to(v[:1]), wdata)
        pb = tree_map(lambda v: to(v[:1]), pdata)
        params = dict(model.named_parameters())
        with full_float32():
            total, _, _ = pool_objective(model, wb, pb)
            g = torch.autograd.grad(total, list(params.values()))
        grads.append({k_: v.detach().cpu() for k_, v in zip(params, g)})
        del model
    worst = max((rel_err(grads[0][k_], grads[1][k_]), k_) for k_ in grads[1])
    log("distill", f"pool update's gradient on the card against the CPU's (a horizon-8 window, "
                   f"a pool of 16): worst leaf {worst[0]:.3e} of its largest magnitude "
                   f"({worst[1]})")
    check(worst[0] <= 1e-4, "the card's pool gradient agrees with the CPU's within 1e-4 a leaf")

    # 7. behaviour cloning on the recorded episode
    policy = AmortizedPolicy.create(space, env.action_space, h_size=256, seed=0, device=dev)
    bc = episodes_to_bc_dataset([ep])
    bc_dir = os.path.join(tmp.name, "bc")
    bc_s, (_, _, bc_log) = host_s(lambda: train(
        lambda b: bc_loss(policy, b), policy.net, bc, bc,
        TrainConfig(lr=3e-4, batch_size=2, accumulate=1, epochs=2, val_every=2, val_batches=1,
                    checkpoint_dir=bc_dir, seed=0)))
    ck = sorted(d for d in os.listdir(bc_dir) if d.startswith("checkpoint_step="))
    mine = load_params(os.path.join(bc_dir, ck[-1]))
    record = load_params(os.path.join(ROOT, CHECKPOINT_POLICY))
    same = {k_: v.shape for k_, v in mine.items()} == {k_: v.shape for k_, v in record.items()}
    losses = [h["train_loss"] for h in bc_log.history]
    log("distill", f"behaviour cloning, 4 updates on the recorded episode's 5 windows: "
                   f"{bc_s:.4f} s, train losses {[round(x, 5) for x in losses]}; {ck[-1]} has "
                   f"{CHECKPOINT_POLICY}'s names and shapes: {same}")
    check(all(math.isfinite(x) for x in losses) and same,
          "BC losses finite, its checkpoint shaped as the tracked policy's")

    # 8. one gradient and one ensemble selection
    gs = GradientShooting(model=flagship, horizon=HORIZON, shots=32, steps=10)
    grad_s, (_, ginfo) = host_s(lambda: gs(env, start, gen))
    hist = ginfo["cost_history"]
    check(tuple(hist.shape) == (10, 32) and bool(torch.isfinite(hist).all())
          and bool(torch.isfinite(ginfo["cost"]).all()),
          "the gradient selection's cost history and costs are finite")
    log("distill", f"gradient selection (32 shots, 10 projected steps through the batch forward) "
                   f"{grad_s:.4f} s; best cost {float(hist[0].min()):.6e} -> "
                   f"{float(ginfo['cost'].min()):.6e}")
    ens = EnsembleShooting(models=(flagship, surrogate(CHECKPOINT_HYBRID)), horizon=HORIZON,
                           shots=SHOTS, beta=1.0)
    ens_s, (_, einfo) = host_s(lambda: ens(env, start, gen))
    check(bool(torch.isfinite(einfo["cost"]).all())
          and int(einfo["idx"]) == int(torch.argmin(einfo["cost"])),
          "the ensemble selection's costs are finite, its choice their argmin")
    log("distill", f"ensemble selection ({CHECKPOINT} and {CHECKPOINT_HYBRID}, 256 shots, beta "
                   f"1) {ens_s:.4f} s")
    del flagship, ens, gs

    # 9. each new CLI once, in subprocesses at their smallest settings, all
    # at once: the trainers on two files of two harvested pools and on the
    # recorded episode
    out = tmp.name
    pool_dir = os.path.join(out, "cli_pools_in")
    os.makedirs(pool_dir)
    for i in (1, 2):
        save_pools(os.path.join(pool_dir, f"pools{i}.npz"), pools[2 * i - 2:2 * i])
    ck4 = os.path.join(ROOT, CHECKPOINT)
    small = ["--actions", "2", "--locations", "1", "--episodes", "1", "--horizon", "2",
             "--force"]
    clis = {
        "datagen_pools": ["--episodes", "2", "--actions", "2", "--pool", "4", "--horizon", "2",
                          "--out", os.path.join(out, "cli_pools")],
        "datagen_onpolicy": ["--episodes", "2", "--actions", "2", "--shots", "16", "--horizon",
                             "2", "--checkpoint", ck4, "--latent-stride", str(STRIDE),
                             "--out", os.path.join(out, "cli_onpol")],
        "train_pools": ["--data", cli_data, "--pools", pool_dir, "--init-from", ck4,
                        "--horizon", "2", "--epochs", "1", "--batch", "2", "--batch-pools", "1",
                        "--val-every", "1", "--out", os.path.join(out, "cli_tp")],
        "train_bc": ["--data", os.path.join(out, "recorded"), "--epochs", "1", "--batch", "2",
                     "--val-every", "1", "--out", os.path.join(out, "cli_bc")],
        "mpc oracle": ["--controller", "oracle", "--shots", "16", *small,
                       "--out", os.path.join(out, "oracle.json")],
        "mpc gradient": ["--controller", "gradient", "--shots", "64", "--checkpoint", ck4,
                         "--latent-stride", str(STRIDE), *small,
                         "--out", os.path.join(out, "gradient.json")],
        "mpc ensemble": ["--controller", "ensemble", "--shots", "16", "--checkpoint", ck4,
                         os.path.join(ROOT, CHECKPOINT_HYBRID), "--latent-stride", str(STRIDE),
                         *small, "--out", os.path.join(out, "ensemble.json")],
    }
    procs, t = {}, time.time()
    for name, args in clis.items():
        module = "waves_jl_tpu_torch.scripts." + name.split()[0]
        procs[name] = subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        tail = text.strip().splitlines()[-1:] or [""]
        log("distill", f"CLI {name}: exit {proc.returncode} ({time.time() - t:.2f} s since "
                       f"the CLIs started): {tail[0][:200]}")
        check(proc.returncode == 0, f"the {name} CLI exits 0:\n{text}")
    for name in ("oracle", "gradient", "ensemble"):
        with open(os.path.join(out, f"{name}.json")) as f:
            result = json.load(f)
        check(math.isfinite(result["mean_decrease"]) and result["controller"] == name,
              f"the MPC CLI's {name} result")
    check(all(os.path.exists(os.path.join(out, d, "metrics.jsonl")) for d in ("cli_tp", "cli_bc"))
          and os.path.exists(os.path.join(out, "cli_pools", "pools2.npz"))
          and os.path.exists(os.path.join(out, "cli_onpol", "episodes", "episode2.wbin")),
          "the distillation CLIs wrote their pools, episodes, metrics and checkpoints")
    tmp.cleanup()
    log("distill", f"{smi}: oracle selection {wall:.4f} s ({card:.4f} s on the card), harvest "
                   f"episode {harvest_s:.4f} s, DAgger probe {dagger_s:.4f} s, recorded episode "
                   f"{rec_s:.4f} s, pool update {upd_s[-1]:.4f} s")
    return oracle_counts, oracle_shape


def baselines_phase(env, dev, episodes, cli_data: str, smi: str):
    """Phase 11: the NODE and PINN baselines at full width (1,024 elements,
    h_size 256, nfreq 500, l_size 64, 100 steps a window) from the tracked
    checkpoints, on windows of phase 7's episodes: every leaf loaded; the
    NODE's forward at horizons 1 and 8 (batch 4) on the card against the
    CPU, one `node_loss` forward and backward in "sqrt" timed, and its
    gradient on one window held leaf by leaf to the CPU's and to float64;
    the PINN's `predict_energy(time_chunk=16)` against its forward at
    horizon 1, the forward against the CPU's at batch 1, horizon 8 on the
    card alone, one `WaveControlPINNLoss` forward and backward at batch 4
    timed with its peak memory, and its gradient at batch 1 held leaf by
    leaf to the CPU's and to float64; one random-shooting selection through
    the PINN's fallback (16 shots, horizon 2) from a 700^2 state; the train
    CLI for each baseline, the prediction CLI and the PINN acceptance run
    once, in subprocesses. The phase launches none of the CUDA kernels."""
    import copy
    import re
    import tempfile

    import numpy as np
    import torch

    from waves_jl_tpu_torch.constants import WATER
    from waves_jl_tpu_torch.control.mpc import RandomShooting
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.env import env_reset
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.models.node import NODEEnergyModel, node_loss
    from waves_jl_tpu_torch.models.pinn import WaveControlPINN, WaveControlPINNLoss
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused
    from waves_jl_tpu_torch.scripts.grad_precision import leaf_limit, leaves_beyond
    from waves_jl_tpu_torch.train import gather_window_batch, stack_episodes
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_params
    from waves_jl_tpu_torch.utils.trees import tree_map

    def baseline(which, device=dev):
        space = build_triple_ring_design_space(device=device)
        model = (NODEEnergyModel(space, device=device, **BASELINE_WIDTH) if which == "node"
                 else WaveControlPINN(space, 1000.0, device=device, **BASELINE_WIDTH))
        load_model_checkpoint(model, os.path.join(ROOT, BASELINE_CHECKPOINTS[which]))
        return model

    def measure(fn):
        """(wall s, host issue s, peak MiB above the memory held before,
        result) of fn(), synchronised at both ends."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        issue = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return wall, issue, (torch.cuda.max_memory_allocated() - base) / 2**20, out

    def grads_of(model, loss_fn, batch):
        ps = dict(model.named_parameters())
        with full_float32():
            return dict(zip(ps, torch.autograd.grad(loss_fn(batch), list(ps.values()))))

    def to_cpu(batch):
        return tree_map(lambda v: v.cpu(), batch)

    def held_leaf_by_leaf(kind, name, model, cpu_model, loss_of):
        """The loss's float32 gradient on one horizon-1 window on the card,
        held leaf by leaf against the CPU's float32 gradient and, as a
        second witness, against float64 on the card, each leaf within its
        limit (`grad_precision.LEAF_LIMITS`: the NODE's 5e-4, the PINN's
        field net 2e-2 and its other leaves 1e-3 of the leaf's largest
        magnitude, set from readings with TF32 off and on)."""
        model64 = copy.deepcopy(model).double()
        g64 = grads_of(model64, loss_of(model64),
                       tree_map(lambda v: v.double() if v.is_floating_point() else v, one))
        g_card = grads_of(model, loss_of(model), one)
        g_cpu = grads_of(cpu_model, loss_of(cpu_model), to_cpu(one))
        cpu64, _ = leaves_beyond(kind, g_cpu, g64)
        worst = max(cpu64, key=cpu64.get)
        log("baselines", f"{name} gradient, one horizon-1 window: the CPU's float32 against "
                         f"float64 on the card, worst leaf {cpu64[worst]:.3e} ({worst})")
        for what, want in (("the CPU's float32", g_cpu), ("float64 on the card", g64)):
            dist, beyond = leaves_beyond(kind, g_card, want)
            worst = max(dist, key=lambda k: dist[k] / leaf_limit(kind, k))
            log("baselines", f"{name} gradient on the card against {what}, leaf by leaf: worst "
                             f"leaf {dist[worst]:.3e} of its {leaf_limit(kind, worst):.0e} "
                             f"({worst}); largest {max(dist.values()):.3e}")
            check(not beyond, f"every leaf of the {name} gradient on the card is within its "
                              f"limit of {what}: {beyond}")

    # a state 10 windows in, for the selection, before the counts are reset
    gen = torch.Generator(device=dev).manual_seed(110)
    step = make_env_step_fused(env)
    state = env_reset(env, gen)
    for _ in range(WINDOWS // 2):
        state, _ = step(state, env.action_space.sample(gen))
    torch.cuda.synchronize()
    fk.reset_launch_counts()

    store = stack_episodes(episodes[:4], dev)
    actions = store.s_wave.shape[1]
    rng = np.random.default_rng(11)

    def windows(B, horizon):
        idx = np.stack([rng.integers(0, 4, B), rng.integers(0, actions - horizon + 1, B)], -1)
        return gather_window_batch(store, torch.as_tensor(idx, device=dev), horizon)

    b1, b8 = windows(4, 1), windows(4, 8)
    one = tree_map(lambda v: v[:1], b1)
    for which, n in (("node", 38), ("pinn", 118)):
        named = load_params(os.path.join(ROOT, BASELINE_CHECKPOINTS[which]))
        check(len(named) == n, f"the tracked {which} checkpoint has {n} leaves")

    # the NODE
    node, node_cpu = baseline("node"), baseline("node", torch.device("cpu"))
    check(len(node.state_dict()) == 38, "every NODE parameter has its leaf")
    with torch.no_grad():
        for horizon, b in ((1, b1), (8, b8)):
            wall, issue, peak, pred = measure(lambda b=b: node(b))
            want = node_cpu(to_cpu(b))
            err = rel_err(pred.cpu(), want)
            log("baselines", f"NODE forward, batch 4, horizon {horizon} ({b['t'].shape[1]} "
                             f"times): {wall:.4f} s, host issue {issue / wall:.3f} of it, peak "
                             f"{peak:.1f} MiB; against the CPU {err:.3e}")
            check(tuple(pred.shape) == (4, b["t"].shape[1]) and err <= 1e-4,
                  f"the NODE's (B, L) forward at horizon {horizon} matches the CPU's to 1e-4")
    node_s = measure(lambda: grads_of(node, lambda b: node_loss(node, b), b8))
    log("baselines", f"node_loss forward and backward, batch 4, horizon 8, 'sqrt': "
                     f"{node_s[0]:.4f} s, host issue {node_s[1] / node_s[0]:.3f} of it, peak "
                     f"{node_s[2]:.1f} MiB")
    held_leaf_by_leaf("node", "node_loss", node, node_cpu, lambda m: (lambda b: node_loss(m, b)))
    del node, node_cpu

    # the PINN
    pinn, pinn_cpu = baseline("pinn"), baseline("pinn", torch.device("cpu"))
    check(len(pinn.state_dict()) == 118, "every PINN parameter has its leaf")
    with torch.no_grad():
        pinn.predict_energy(b1, time_chunk=16)  # warms cuBLAS and cuDNN
        fwd = measure(lambda: pinn(b1))
        chunked = measure(lambda: pinn.predict_energy(b1, time_chunk=16))
        err_chunk = float((chunked[3] - fwd[3]).abs().max())
        ok_chunk = bool(torch.allclose(chunked[3], fwd[3], rtol=2e-5, atol=2e-6))
        log("baselines", f"PINN, batch 4, horizon 1: forward {fwd[0]:.4f} s (host issue "
                         f"{fwd[1] / fwd[0]:.3f}, peak {fwd[2]:.1f} MiB), predict_energy(time_"
                         f"chunk=16) {chunked[0]:.4f} s (peak {chunked[2]:.1f} MiB), apart by "
                         f"{err_chunk:.3e}")
        check(ok_chunk, "predict_energy(time_chunk=16) matches the forward to 2e-5 / 2e-6")
        err = rel_err(pinn(one).cpu(), pinn_cpu(to_cpu(one)))
        log("baselines", f"PINN forward at batch 1, horizon 1, on the card against the CPU: "
                         f"{err:.3e}")
        check(err <= 1e-4, "the PINN's forward matches the CPU's to 1e-4")
        h8 = measure(lambda: pinn.predict_energy(b8, time_chunk=16))
        log("baselines", f"PINN predict_energy(time_chunk=16), batch 4, horizon 8: {h8[0]:.4f} "
                         f"s, host issue {h8[1] / h8[0]:.3f}, peak {h8[2]:.1f} MiB")
        check(tuple(h8[3].shape) == (4, b8["t"].shape[1], 3)
              and bool(torch.isfinite(h8[3]).all()), "the horizon-8 energies are finite")
    loss_fn = WaveControlPINNLoss(model=pinn, c0=WATER)
    pinn_s = measure(lambda: grads_of(pinn, loss_fn, b1))
    log("baselines", f"WaveControlPINNLoss forward and backward, batch 4, horizon 1: "
                     f"{pinn_s[0]:.4f} s, host issue {pinn_s[1] / pinn_s[0]:.3f} of it, peak "
                     f"{pinn_s[2]:.1f} MiB")
    held_leaf_by_leaf("pinn", "WaveControlPINNLoss", pinn, pinn_cpu,
                      lambda m: WaveControlPINNLoss(model=m, c0=WATER))
    del pinn_cpu

    # random shooting through the fallback: the PINN has no predict_shot_energy
    rs = RandomShooting(model=pinn, horizon=2, shots=16, alpha=1.0)
    check(not hasattr(pinn, "predict_shot_energy"), "the PINN takes the forward fallback")
    sel_s, sel_issue, sel_peak, (_, info) = measure(lambda: rs(env, state, gen))
    log("baselines", f"random shooting through the PINN's forward, 16 shots, horizon 2: "
                     f"{sel_s:.4f} s, host issue {sel_issue / sel_s:.3f}, peak {sel_peak:.1f} MiB")
    check(bool(torch.isfinite(info["cost"]).all()) and info["cost"].shape == (16,)
          and int(info["idx"]) == int(torch.argmin(info["cost"])),
          "the selection's 16 costs are finite, its choice their argmin")
    launched = {k: v for k, v in fk.launch_counts.items() if v}
    log("baselines", f"kernel launches in the phase: {launched}")
    check(not launched, "the baselines launch none of the CUDA kernels")
    del pinn, rs, store, b1, b8, one, info
    torch.cuda.empty_cache()

    # the CLIs once each, at their smallest, at once
    with tempfile.TemporaryDirectory() as out:
        ck = {k: os.path.join(ROOT, v) for k, v in BASELINE_CHECKPOINTS.items()}
        width = [f for k, v in BASELINE_WIDTH.items()
                 for f in (f"--{k.replace('_', '-')}", str(v))]
        small = ["--episodes", "1", "--horizon", "1", "--epochs", "1", "--batch", "4",
                 "--accumulate", "5", "--val-every", "1", "--val-batches", "1"]
        pred_json = os.path.join(out, "prediction.json")
        clis = {
            "train --model node": ("train", ["--data", cli_data, "--out", os.path.join(out, "node"),
                                             "--model", "node", "--init-from", ck["node"],
                                             *small, *width]),
            "train --model pinn": ("train", ["--data", cli_data, "--out", os.path.join(out, "pinn"),
                                             "--model", "pinn", "--init-from", ck["pinn"],
                                             *small, *width]),
            "prediction": ("prediction", [
                "--data", cli_data, "--acoustic", os.path.join(ROOT, CHECKPOINT),
                "--latent-stride", str(STRIDE), "--node", ck["node"], "--pinn", ck["pinn"],
                "--episodes", "1", "--horizons", "1", "2", "--batch", "2", "--batches", "1",
                "--json-out", pred_json, *width]),
            "pinn_acceptance": ("pinn_acceptance", ["--iters", "100", "--chunk", "50"]),
        }
        procs, t = {}, time.time()
        for name, (module, args) in clis.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"waves_jl_tpu_torch.scripts.{module}", *args], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        texts = {}
        try:
            for name, proc in procs.items():
                texts[name], _ = proc.communicate(timeout=600)
                tail = texts[name].strip().splitlines()[-1:] or [""]
                log("baselines", f"CLI {name}: exit {proc.returncode} ({time.time() - t:.2f} s "
                                 f"since the CLIs started): {tail[0][:200]}")
                check(proc.returncode == 0, f"the {name} CLI exits 0:\n{texts[name]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for which in ("node", "pinn"):
            check(os.path.exists(os.path.join(out, which, "checkpoint_step=1", "params.npz")),
                  f"train --model {which} took one update and wrote its checkpoint")
        with open(pred_json) as f:
            errors = json.load(f)
        check(sorted(errors) == ["acoustic", "node", "pinn"]
              and all(sorted(r) == ["1", "2"] and all(math.isfinite(v) for e in r.values()
                                                      for v in e) for r in errors.values()),
              "the prediction CLI's MSEs for the three surrogates at horizons 1 and 2")
        found = [float(v) for v in re.findall(r"mean relative energy error: (\S+)",
                                              texts["pinn_acceptance"])]
        check(len(found) == 1 and math.isfinite(found[0]),
              "the PINN acceptance run reports a finite energy error")
        log("baselines", "prediction MSEs " + ", ".join(
            f"{k} h{h} {np.mean(v):.4g}" for k, r in errors.items() for h, v in r.items())
            + f"; acceptance energy error {found[0]:.4g} after 100 iterations")
    log("baselines", f"{smi}: NODE fwd+bwd (batch 4, horizon 8) {node_s[0]:.4f} s, host issue "
                     f"{node_s[1] / node_s[0]:.3f}; PINN loss fwd+bwd (batch 4) {pinn_s[0]:.4f} "
                     f"s, host issue {pinn_s[1] / pinn_s[0]:.3f}, peak {pinn_s[2]:.1f} MiB; "
                     f"PINN forward (batch 4) {fwd[0]:.4f} s; selection {sel_s:.4f} s")


def dp_bf16_phase(env, dev, episodes, cli_data: str, smi: str):
    """Phase 12: data-parallel training and the bf16 options at the tracked
    full width (`ref500_h8s4`: 1,024 elements, h_size 256, nfreq 500, latent
    stride 4) on phase 7's episodes. Data parallelism on a mesh of every
    card, and where the machine has one card also on two shards of it:
    `make_dp_scan_train_steps_windowed` (horizon 8, global batch 4, K = 2
    micro-steps, accumulate 1) against the single-device trainer on the
    same global windows, and `train(mesh=)` for one chunk of one update
    against the single-device scan on JAX's schedule's rows: the losses
    and gradients as `held_leaves` and `held_last` hold them (with a
    control, one shard's gradient left unaveraged), after each update the
    leaves as `held_leaves` holds them (tests/test_windows_and_cem.py's rtol 5e-3 / atol 2e-5), the
    replicas bit for bit equal, a micro-step's seconds and host share on
    each side; training
    launches none of the CUDA kernels. Then the bf16 options: one 256-shot
    random-shooting selection through the float32 model and through
    `fast_ranking()` from one state and generator state (costs within 5e-2
    relative, tests/test_models.py's bound; the bf16 choice among the
    float32 model's best 5%), and `conv_dtype=torch.bfloat16` against
    float32 on phase 7's observations, `encode_wave` and the encoder's
    forward and backward at batch 4 (rtol 0.1 / atol 0.05). Last, `train
    --dp` (one update) and `mpc --fast` (two actions), in subprocesses at
    once."""
    import tempfile

    import numpy as np
    import torch

    from waves_jl_tpu_torch.control.mpc import RandomShooting
    from waves_jl_tpu_torch.data import prepare_dataset
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.env import env_reset
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel, energy_loss
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.parallel import Replicas, make_mesh
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused
    from waves_jl_tpu_torch.train import (TrainConfig, load_checkpoint, make_optimizer,
                                          stack_episodes, train)
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
    from waves_jl_tpu_torch.train.loop import make_scan_train_steps
    from waves_jl_tpu_torch.train.optim import B1
    from waves_jl_tpu_torch.train.windows import (make_dp_scan_train_steps_windowed,
                                                  make_scan_train_steps_windowed,
                                                  sample_window_indices_dp)
    from waves_jl_tpu_torch.utils.trees import tree_map

    def flagship(device=dev, conv_dtype=None, tracked=True):
        model = AcousticEnergyModel(build_triple_ring_design_space(device=device), 1000.0,
                                    elements=1024, h_size=256, nfreq=500,
                                    integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                    device=device, conv_dtype=conv_dtype)
        if tracked:
            load_model_checkpoint(model, os.path.join(ROOT, CHECKPOINT))
        return model

    def sc4(m):
        return lambda b: energy_loss(m, b, sc_weight=4.0)

    def replicate_into(built):
        def replicate(device):  # its weights come from the caller's model
            m = flagship(device, tracked=False)
            built.append(m)
            return m, sc4(m)

        return replicate

    def timed(fn):
        """(wall s, host issue s, result) of fn(), synchronised at both ends."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        issue = time.perf_counter() - t
        torch.cuda.synchronize()
        return time.perf_counter() - t, issue, out

    def params_of(m):
        return {k: v.detach().clone() for k, v in m.named_parameters()}

    def update_grads(states):
        """Each update's averaged gradient, a dict of leaves an update, from
        Adam's first moments after each: g_u = (mu_u - b1 mu_{u-1}) / (1 - b1)."""
        out, prev = [], None
        for st in states:
            out.append({k: (m if prev is None else m - B1 * prev[k]) / (1 - B1)
                        for k, m in st.mu.items()})
            prev = st.mu
        return out

    def held_leaves(name, params, params1, states, states1, ref_grads=None, path_bound=0.0):
        """After update u = len(states): each update's averaged gradient
        within DP_GRAD_TOL of each leaf's largest magnitude of the single
        device's gradient at the same parameters and on the same windows,
        `ref_grads` (its own trajectory's where not given: one update from
        the same parameters). The single device's own trajectory parts from
        the shards' by up to 2 lr an update where a gradient is near zero,
        below, so its later gradients are taken at other points: the last
        update's gradient is held to its own trajectory's within
        DP_GRAD_TOL plus `path_bound`, how far the single device's gradient
        moves from its own trajectory's parameters to the shards'.
        And every parameter within rtol 5e-3 /
        atol 2e-5 of the single device's (tests/test_windows_and_cem.py's
        bounds) but where the single device's gradient of some update, or
        Adam's first moment after the last, is within NEAR_ZERO of the
        leaf's largest magnitude: the two sums may give such a value either
        sign, and Adam steps a parameter by about lr whatever its gradient's
        size, so those are held within 2 lr an update."""
        u = len(states)
        g, g1 = update_grads(states), update_grads(states1)
        ref_grads = g1 if ref_grads is None else ref_grads
        beyond, unexplained, gap, reach = 0, 0, 0.0, 0.0
        with torch.no_grad():
            grad_err = max(rel_err(g[i][k], ref_grads[i][k]) for i in range(u) for k in g1[i])
            path_err = max(rel_err(g[-1][k], g1[-1][k]) for k in g1[-1])
            for k, b in params1.items():
                diff = (params[k] - b).abs()
                out = diff > 2e-5 + 5e-3 * b.abs()
                if not out.any():
                    continue
                # each parameter's smallest share of its leaf's largest magnitude
                share = torch.stack([x.abs() / x.abs().max().clamp_min(1e-30) for x in
                                     [g1[i][k] for i in range(u)] + [states1[-1].mu[k]]]).amin(0)
                beyond += int(out.sum())
                unexplained += int((out & (share > NEAR_ZERO)).sum())
                gap = max(gap, float(diff[out].max()))
                reach = max(reach, float(share[out].max()))
        log("dp", f"{name}, after update {u}: averaged gradients {grad_err:.3e} of a leaf from the "
                  f"single device's at the same parameters; the last {path_err:.3e} from its own "
                  f"trajectory's (bound {DP_GRAD_TOL:g} + {path_bound:.3e}); {beyond} of "
                  f"{sum(v.numel() for v in params1.values())} "
                  f"parameters beyond rtol 5e-3 / atol 2e-5, their gradients within {reach:.3e} of "
                  f"their leaf's largest magnitude ({unexplained} beyond {NEAR_ZERO:g}), apart "
                  f"by at most {gap:.3e} (lr {opt_lr:g})")
        check(grad_err <= DP_GRAD_TOL, f"{name}: the averaged gradients match the single "
                                       f"device's to {DP_GRAD_TOL:g} of each leaf")
        check(path_err <= DP_GRAD_TOL + path_bound,
              f"{name}: the last averaged gradient is within {DP_GRAD_TOL:g} + {path_bound:.3e} "
              "of the single device's own trajectory's")
        check(unexplained == 0, f"{name}: after update {u} every parameter is within rtol 5e-3 / "
                                f"atol 2e-5 of the single device's but where its gradient is "
                                f"within {NEAR_ZERO:g} of its leaf's largest magnitude")
        check(gap <= 2 * opt_lr * u, f"{name}: those within Adam's 2 lr an update")

    def held_last(name, losses, losses1, model, built, ref_losses=None, path_bounds=None):
        """After the last update: the losses within DP_GRAD_TOL relative of
        the single device's at the same parameters where `ref_losses` gives
        them, and of its own trajectory's within DP_GRAD_TOL plus each
        update's `path_bounds` (as `held_leaves` bounds the gradient), the
        replicas bit for bit equal."""
        ref = losses1 if ref_losses is None else ref_losses
        lrel = float(((losses - ref).abs() / ref.abs()).max())
        paths = (losses - losses1).abs() / losses1.abs()
        path = float(paths.max())
        bounds = torch.zeros_like(paths) if path_bounds is None else path_bounds
        with torch.no_grad():
            same = all(torch.equal(a.to(dev), b) for m in built
                       for a, b in zip(m.parameters(), model.parameters()))
        log("dp", f"{name}: losses {[round(float(v), 6) for v in losses]} against "
                  f"{[round(float(v), 6) for v in ref]}, largest relative difference "
                  f"{lrel:.3e} ({path:.3e} from the single device's own trajectory's "
                  f"{[round(float(v), 6) for v in losses1]}, bounds {DP_GRAD_TOL:g} + "
                  f"[{', '.join(f'{float(b):.3e}' for b in bounds)}]); {len(built)} built replicas bit "
                  f"for bit equal {same}")
        check(lrel <= DP_GRAD_TOL, f"{name}: the losses match the single device's to "
                                   f"{DP_GRAD_TOL:g}")
        check(bool((paths <= DP_GRAD_TOL + bounds).all()),
              f"{name}: the losses are within {DP_GRAD_TOL:g} and Adam's drift of the single "
              "device's own trajectory's")
        check(same, f"{name}: the replicas are equal bit for bit")

    opt_lr = 1e-4
    opt = make_optimizer(TrainConfig(lr=opt_lr, accumulate=1))
    meshes = [make_mesh()]
    if torch.cuda.device_count() == 1:
        meshes.append(make_mesh(devices=["cuda:0", "cuda:0"]))
    eps = episodes[:16]  # divides over 1, 2, 4 and 8 shards
    E, H, B, K = len(eps), 8, 4, 2
    store = stack_episodes(eps, dev)
    fk.reset_launch_counts()
    # cuDNN's backward sums in a run-dependent order, and Adam's first
    # updates carry a gradient's sign whatever its size (about lr each): the
    # comparisons run deterministic, as phase 9's resume does
    torch.backends.cudnn.deterministic = True
    # one draw of global windows serves every mesh: drawn for the most
    # shards, block d of a mesh of n shards holds only its own episodes
    n_max = max(m.size for m in meshes)
    glob = sample_window_indices_dp(np.random.default_rng(12), E, WINDOWS, H, K, n_max, B)
    for d in range(n_max):  # shard d of n_max holds episodes [d E / n_max, (d + 1) E / n_max)
        glob[:, d * (B // n_max):(d + 1) * (B // n_max), 0] += d * (E // n_max)

    # the K micro-steps one call each: the first warms cuDNN and the
    # allocator at its shape, the last is timed
    single = flagship()
    run1 = make_scan_train_steps_windowed(sc4(single), opt, H, STRIDE)
    state1, losses1, after1 = opt.init(dict(single.named_parameters())), [], []
    for i in range(K):
        wall1, issue1, (_, state1, loss) = timed(lambda: run1(
            single, state1, store, torch.as_tensor(glob[i:i + 1], device=dev)))
        losses1.append(loss)
        after1.append((params_of(single), state1))
    log("dp", f"the single device: {wall1:.4f} s a micro-step of {B} horizon-8 windows (the "
              f"second), host issue {issue1 / wall1:.3f} of it")
    ref = flagship()  # the single device at other parameters
    run_ref = make_scan_train_steps_windowed(sc4(ref), opt, H, STRIDE)
    grads1 = update_grads([st for _, st in after1])

    def single_at(params, before, windows):
        """The single device's loss and gradient at `params` on the global
        `windows`: one update of `ref` from Adam's state `before`."""
        with torch.no_grad():
            for k, p in ref.named_parameters():
                p.copy_(params[k])
        _, st, loss = run_ref(ref, before, store, torch.as_tensor(windows, device=dev))
        return loss, {k: (m - B1 * before.mu[k].to(dev)) / (1 - B1) for k, m in st.mu.items()}

    times = {}
    for mesh in meshes:
        n = mesh.size
        cards = len(set(mesh.devices))
        where = f"{n} shard{'s' if n > 1 else ''} on " + (
            f"{cards} cards" if cards > 1 else str(mesh.devices[0]))
        local = glob.copy()
        for d in range(n):  # shard d's local episode indices
            local[:, d * (B // n):(d + 1) * (B // n), 0] -= d * (E // n)
        model, built = flagship(), []
        replicas = Replicas(model, sc4(model), mesh, replicate_into(built))
        stores = stack_episodes(eps, mesh=mesh)
        run = make_dp_scan_train_steps_windowed(opt, H, STRIDE)
        states, losses, shard0, ref_grads, ref_losses = replicas.init(opt), [], [], [], []
        loss_bounds = []
        for i in range(K):
            # the single device's gradient at this run's parameters and Adam
            # state before the update, on the same windows
            own, before = params_of(model), states[0]
            ref_loss, ref_grad = single_at(own, before, glob[i:i + 1])
            ref_losses.append(ref_loss)
            ref_grads.append(ref_grad)
            if n > 1 and i == 0:
                # the control: shard 0's gradient alone, left unaveraged
                one_loss, one_grad = single_at(own, before, glob[i:i + 1, :B // n])
                control = max(rel_err(one_grad[k], ref_grad[k]) for k in ref_grad)
                log("dp", f"windowed, {where}: shard 0's gradient alone (its {B // n} windows, "
                          f"unaveraged) {control:.3e} of a leaf from the averaged one, its loss "
                          f"{float(one_loss):.6f} against {float(ref_loss):.6f}")
                check(control >= 10 * DP_GRAD_TOL,
                      f"the gradient check tells an unaveraged shard gradient apart (above "
                      f"{10 * DP_GRAD_TOL:g})")
            # Adam's drift: how far the single device's gradient and loss
            # move from its own trajectory's point to this run's, the
            # parameters the shards actually moved away from it
            drift, loss_drift = 0.0, 0.0
            if i > 0:
                base = after1[i - 1][0]
                moved = {k: own[k] != b for k, b in base.items()}
                n_moved = sum(int(m.sum()) for m in moved.values())
                reach = max((float((own[k] - b)[moved[k]].abs().max()) for k, b in base.items()
                             if moved[k].any()), default=0.0)
                drift = max(rel_err(ref_grad[k], grads1[i][k]) for k in ref_grad)
                loss_drift = float((ref_loss - losses1[i]).abs().max() / losses1[i].abs().max())
                log("dp", f"windowed, {where}, before update {i}: the shards' parameters part "
                          f"from the single device's own trajectory at {n_moved} of "
                          f"{sum(v.numel() for v in base.values())}, by at most {reach:.3e} (Adam's "
                          f"whole reach {2 * opt_lr * i:g}); the single device's gradient there "
                          f"moves {drift:.3e} of a leaf and its loss {loss_drift:.3e}: the drift "
                          f"bounds on top of {DP_GRAD_TOL:g}")
                check(reach <= 2 * opt_lr * i, f"windowed, {where}: the shards' parameters lie "
                                               f"within Adam's 2 lr an update of the single "
                                               f"device's")
            loss_bounds.append(loss_drift)
            wall, issue, (_, states, loss) = timed(lambda: run(
                replicas, states, stores, torch.as_tensor(local[i:i + 1])))
            losses.append(loss)
            shard0.append(states[0])
            held_leaves(f"windowed, {where}", params_of(model), after1[i][0], shard0,
                        [st for _, st in after1[:i + 1]], ref_grads, drift)
        times[where] = (wall, issue / wall, wall1, issue1 / wall1)
        log("dp", f"make_dp_scan_train_steps_windowed, {where}: {wall:.4f} s a micro-step of "
                  f"{B} horizon-8 windows (the second), host issue {issue / wall:.3f} of it; the "
                  f"single device {wall1:.4f} s")
        held_last(f"windowed, {where}", torch.cat(losses), torch.cat(losses1), model, built,
                  torch.cat(ref_losses), torch.tensor(loss_bounds, device=dev))
        del model, replicas, built, stores
    del single, after1

    # train(mesh=) for one chunk of one update: 4 horizon-1 windows, batch 4
    mesh = meshes[-1]
    n = mesh.size
    data = tree_map(lambda x: x[:4], prepare_dataset(eps[:1], 1, STRIDE))
    val = tree_map(lambda x: x[8:12], prepare_dataset(eps[:1], 1, STRIDE))
    cfg = TrainConfig(lr=opt_lr, batch_size=B, accumulate=1, epochs=1, val_every=1,
                      val_batches=1, seed=3)
    model, built = flagship(), []
    t = time.time()
    _, state, logger = train(sc4(model), model, data, val, cfg, mesh=mesh,
                             replicate=replicate_into(built))
    dense_s = time.time() - t
    rng, n_loc = np.random.default_rng(cfg.seed), 4 // n
    rows = np.concatenate([rng.permutation(n_loc)[:B // n].reshape(1, B // n)
                           + d * n_loc for d in range(n)], axis=1)  # JAX's rows, global
    single = flagship()
    _, state1, losses1 = make_scan_train_steps(sc4(single), opt)(
        single, opt.init(dict(single.named_parameters())), tree_map(lambda x: x.to(dev), data),
        torch.as_tensor(rows, device=dev))
    rec = logger.history
    check(len(rec) == 1 and rec[0]["step"] == 1 and state.count == 1,
          "train(mesh=): one chunk of one update")
    log("dp", f"train(mesh=), {n} shards: one chunk of one update with validation in "
              f"{dense_s:.2f} s, val loss {rec[0]['val_loss']:.6g}")
    held_leaves(f"train(mesh=), {n} shards", params_of(model), params_of(single), [state],
                [state1])
    held_last(f"train(mesh=), {n} shards", torch.tensor([rec[0]["train_loss"]]),
              losses1.cpu(), model, built)
    torch.backends.cudnn.deterministic = False
    launched = {k: v for k, v in fk.launch_counts.items() if v}
    log("dp", f"kernel launches in data-parallel training: {launched}")
    check(not launched, "data-parallel training launches none of the CUDA kernels")
    del model, single, built, store

    # fast_ranking: one 256-shot selection each way from one state and draws
    gen = torch.Generator(device=dev).manual_seed(120)
    step = make_env_step_fused(env)
    state = env_reset(env, gen)
    for _ in range(WINDOWS // 2):
        state, _ = step(state, env.action_space.sample(gen))
    f32 = flagship()
    fast = f32.fast_ranking()
    draws = gen.get_state()
    sel = {}
    for name, m in (("float32", f32), ("bf16", fast), ("float32", f32), ("bf16", fast)):
        gen.set_state(draws)  # the first of each warms cuBLAS
        rs = RandomShooting(model=m, horizon=HORIZON, shots=SHOTS, alpha=1.0)
        sel[name] = timed(lambda: rs(env, state, gen))
    c32, cbf = sel["float32"][2][1]["cost"], sel["bf16"][2][1]["cost"]
    choice = int(sel["bf16"][2][1]["idx"])
    rank = int((c32 < c32[choice]).sum())
    worst = float(((cbf - c32).abs() / c32.abs()).max())
    log("bf16", f"{SHOTS}-shot selection, horizon {HORIZON}: float32 {sel['float32'][0]:.4f} s "
                f"(host issue {sel['float32'][1] / sel['float32'][0]:.3f}), fast_ranking "
                f"{sel['bf16'][0]:.4f} s (host issue {sel['bf16'][1] / sel['bf16'][0]:.3f}); "
                f"costs apart by at most {worst:.3e} relative; the bf16 choice (shot {choice}) "
                f"ranks {rank} of {SHOTS} by the float32 costs (float32's choice shot "
                f"{int(sel['float32'][2][1]['idx'])})")
    check(bool(torch.allclose(cbf, c32, rtol=5e-2, atol=1e-4)),
          "the bf16 costs are within 5e-2 relative of the float32 costs")
    check(rank < 0.05 * SHOTS, "the bf16 choice is among the float32 model's best 5%")

    # conv_dtype=torch.bfloat16 against float32 on phase 7's observations
    bf = flagship(conv_dtype=torch.bfloat16)
    obs = episodes[0].s_wave[:4].to(dev)
    with torch.no_grad():
        enc = [torch.stack([m.encode_wave(o) for o in obs]) for m in (f32, bf)]
    enc_err = float((enc[1] - enc[0]).abs().max())
    check(enc[1].dtype == torch.float32 and bool(torch.allclose(enc[1], enc[0], rtol=0.1,
                                                                 atol=0.05)),
          "the bf16-conv encode_wave matches float32 within rtol 0.1 / atol 0.05")
    enc_s = {}
    for name, m in (("float32", f32), ("bf16", bf), ("float32", f32), ("bf16", bf)):
        ps = list(m.wave_encoder.parameters())

        def fwd_bwd(m=m, ps=ps):
            with full_float32():
                return torch.autograd.grad(m.wave_encoder(obs).square().mean(), ps)

        enc_s[name] = timed(fwd_bwd)  # the first of each warms cuDNN
    g32, gbf = enc_s["float32"][2], enc_s["bf16"][2]
    check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in gbf),
          "the bf16-conv encoder's gradient is float32 and finite")
    log("bf16", f"conv_dtype=bfloat16: encode_wave of 4 observations {enc_err:.3e} from "
                f"float32 at most; encoder forward and backward at batch 4: float32 "
                f"{enc_s['float32'][0] * 1e3:.2f} ms, bf16 {enc_s['bf16'][0] * 1e3:.2f} ms; "
                f"gradient of the first conv {rel_err(gbf[0], g32[0]):.3e} from float32's")
    del f32, fast, bf, g32, gbf, enc
    torch.cuda.empty_cache()

    # the CLIs once each, at their smallest, at once
    with tempfile.TemporaryDirectory() as out:
        ck = os.path.join(ROOT, CHECKPOINT)
        clis = {
            "train --dp": ("train", ["--data", cli_data, "--out", os.path.join(out, "dp"), "--dp",
                                     "--episodes", "1", "--horizon", "1", "--batch", "16",
                                     "--accumulate", "1", "--val-every", "1", "--val-batches",
                                     "1", "--epochs", "1", "--latent-stride", str(STRIDE),
                                     "--sc-weight", "4", "--init-from", ck]),
            "mpc --fast": ("mpc", ["--controller", "random_shooting", "--checkpoint", ck,
                                   "--latent-stride", str(STRIDE), "--actions", "2",
                                   "--locations", "1", "--episodes", "1", "--fast", "--out",
                                   os.path.join(out, "fast.json")]),
        }
        procs, texts, t = {}, {}, time.time()
        for name, (module, args) in clis.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"waves_jl_tpu_torch.scripts.{module}", *args], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            for name, proc in procs.items():
                texts[name], _ = proc.communicate(timeout=600)
                tail = texts[name].strip().splitlines()[-1:] or [""]
                log("dp", f"CLI {name}: exit {proc.returncode} ({time.time() - t:.2f} s since the "
                          f"CLIs started): {tail[0][:200]}")
                check(proc.returncode == 0, f"the {name} CLI exits 0:\n{texts[name]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        check(f"data-parallel over {torch.cuda.device_count()} devices" in texts["train --dp"],
              "train --dp trains over every card")
        path = os.path.join(out, "dp", "checkpoint_step=1")
        fresh = flagship(tracked=False)
        _, _, step_no = load_checkpoint(path, fresh, opt_state_like=opt.init(
            dict(fresh.named_parameters())))
        check(step_no == 1, "train --dp took one update and load_checkpoint reads its checkpoint")
        with open(os.path.join(out, "fast.json")) as f:
            result = json.load(f)
        check("fast-ranking mode: bf16 latent matmul" in texts["mpc --fast"]
              and math.isfinite(result["mean_decrease"]),
              "mpc --fast ranks in bf16 and reports a finite decrease")
    log("dp", f"{smi}: " + "; ".join(
        f"{where}: {dp_s:.4f} s a micro-step (host {dp_h:.3f}) against {one_s:.4f} s (host "
        f"{one_h:.3f}) on one device" for where, (dp_s, dp_h, one_s, one_h) in times.items())
        + f"; selection float32 {sel['float32'][0]:.4f} s, bf16 {sel['bf16'][0]:.4f} s; encoder "
          f"fwd+bwd float32 {enc_s['float32'][0] * 1e3:.2f} ms, bf16 {enc_s['bf16'][0] * 1e3:.2f} "
          "ms")


FLUX_TOL = 1e-5  # env_step_flux's float32 flux against float64, of the largest |flux|
RENDER_SIZE = 350  # the render episodes' frames after the on-card resize
RENDER_STRIDE = 10  # steps between their frames
RENDER_ACTIONS = 5  # the random-policy render episode's actions
RENDER_MPC_ACTIONS = 3  # the RandomShooting render episode's (`mpc --render`'s device half)
# windows that phase 13 first adds to phase 3's state: 10 ms in, the wave
# has reached the cloak and the scattered field is non-zero
REACH_WINDOWS = 9
# Adam steps of the adjoint demo (its CLI's default is 10): each takes about
# 3.8 s on the card, host-bound, so the phase cuts the depth to stay in its
# budget; the width (1,024 elements, 300 steps, 50 frequencies) is the demo's
ADJOINT_ITERS = 3


def full_field_phase(env, state, pos_env, model, dev):
    """Phase 13: the full-field window and what draws, at 700^2 from phase
    3's state advanced REACH_WINDOWS windows (K5, uncounted), where the
    scattered field is non-zero. `env_step_full` through the exact one-launch kernel (K2 and
    its owner pass on the triple ring, K1 on phase 4's position design)
    against its plain route on the card; at render size 350 and time
    stride 10; `env_step_flux` against the same formula in float64;
    `rollout_fields` under the random policy and under 256-shot random
    shooting on the flagship (the device half of `mpc --render`), each
    episode's signals replayed through `env_step_full`; the adjoint demo's
    optimisation; the latent-space dashboard's rollout and MSE; the PML
    demo's free-field rollout. Returns the phase's main-path launches: the
    render episodes and the `env_step_full`/`env_step_flux` calls, not the
    replays, the plain route or the timing repeats."""
    import collections
    import dataclasses

    import numpy as np
    import torch

    from waves_jl_tpu_torch.control.mpc import RandomShooting
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset, env_step_flux, resize_weights
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.ops.metrics import circle_mask, flux, laplacian_matrix
    from waves_jl_tpu_torch.physics.fused import make_env_step_full, make_env_step_fused
    from waves_jl_tpu_torch.scripts.adjoint_demo import AdjointProblem, optimise
    from waves_jl_tpu_torch.scripts.latent_space import latent_comparison
    from waves_jl_tpu_torch.scripts.pml_demo import pml_rollout
    from waves_jl_tpu_torch.viz.episode import rollout_fields

    t_phase = time.time()
    main_path = collections.Counter()

    def counted(fn):
        """fn() with its launches added to the phase's main-path counts;
        returns (result, its launches)."""
        fk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        main_path.update(fk.launch_counts)
        return out, {k: v for k, v in fk.launch_counts.items() if v}

    def warm_ms(fn, reps=3):
        """Median host milliseconds of fn(), synchronised, after the run
        already made."""
        times = []
        for _ in range(reps):
            dt, _ = host_s(fn)
            times.append(dt * 1e3)
        return float(np.median(times))

    gen = torch.Generator(device=dev).manual_seed(30)
    policy = RandomDesignPolicy(env.action_space)
    fused = make_env_step_fused(env)
    for _ in range(REACH_WINDOWS):
        state, _ = fused(state, policy(gen))
    action = policy(gen)
    kernel, plain = make_env_step_full(env), make_env_step_full(env, plain=True)

    # 1. env_step_full at stride 1: the kernel route against the plain route
    (got, info), launched = counted(lambda: kernel(state, action))
    check(launched == {"fused_rk4_radii_only": STEPS, "select_owner": 1},
          f"the full-field window launches K2 {STEPS} times and the owner pass once: {launched}")
    plain_s, (want, want_info) = host_s(lambda: plain(state, action))
    same = [torch.equal(a, b) for a, b in ((got.wave, want.wave), (info["u_tot"], want_info["u_tot"]),
                                           (info["u_inc"], want_info["u_inc"]))]
    sig_err = rel_err(got.signal, want.signal)
    log("full field", f"env_step_full {SIZE}^2 K2, kernel route against plain route: frames "
                      f"{differing_cells(got.wave, want.wave)}; u_tot "
                      f"{differing_cells(info['u_tot'], want_info['u_tot'])}; u_inc "
                      f"{differing_cells(info['u_inc'], want_info['u_inc'])}; signal rel err "
                      f"{sig_err:.3e}")
    check(all(same) and sig_err <= 1e-6,
          "the full-field window equals its plain route bit for bit (frames, fields), its signal "
          "within 1e-6")
    check(tuple(info["u_tot"].shape) == (STEPS + 1, SIZE, SIZE)
          and bool(torch.isfinite(info["u_tot"]).all()) and float(got.signal[:, 2].max()) > 0.0,
          "the full fields are finite, (steps + 1, n, n), the scattered energy positive")
    win_ms = warm_ms(lambda: kernel(state, action))
    win_dev = device_ms(lambda: kernel(state, action), 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    kernel(state, action)
    win_issue = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    log("full field", f"a full-field window (100 K2 steps, 101 two-channel copies): {win_ms:.4f} ms "
                      f"on the host, device work {win_dev:.4f} ms, host issue {win_issue:.4f} ms; "
                      f"plain route {plain_s * 1e3:.1f} ms")

    # the same window at render size 350, time stride 10
    (small, small_info), _ = counted(lambda: kernel(state, action, render_size=RENDER_SIZE,
                                                    time_stride=RENDER_STRIDE))
    weights = torch.from_numpy(resize_weights(SIZE, RENDER_SIZE)).to(dev)
    with full_float32():
        resized = weights @ info["u_tot"][::RENDER_STRIDE] @ weights.T
    small_err = rel_err(small_info["u_tot"], resized)
    check(torch.equal(small.signal, got.signal), "the strided window's signal is the full one's")
    check(tuple(small_info["u_tot"].shape) == (STEPS // RENDER_STRIDE + 1, RENDER_SIZE, RENDER_SIZE)
          and small_err <= 1e-6, f"the strided, resized fields are the full ones' ({small_err:.3e})")
    small_ms = warm_ms(lambda: kernel(state, action, render_size=RENDER_SIZE,
                                      time_stride=RENDER_STRIDE))
    small_dev = device_ms(lambda: kernel(state, action, render_size=RENDER_SIZE,
                                         time_stride=RENDER_STRIDE), 1)
    log("full field", f"render_size {RENDER_SIZE}, time_stride {RENDER_STRIDE}: {small_ms:.4f} ms on "
                      f"the host, device work {small_dev:.4f} ms; fields {small_err:.3e} from the "
                      f"resized full ones, signal bit for bit")

    # K1: the window on moving cylinders, one window from a reset
    pgen = torch.Generator(device=dev).manual_seed(31)
    pstate = env_reset(pos_env, pgen)
    paction = RandomDesignPolicy(pos_env.action_space)(pgen)
    (pgot, pinfo), launched = counted(lambda: make_env_step_full(pos_env)(pstate, paction))
    check(launched == {"fused_rk4_general": STEPS}, f"K1 takes the moving cylinders: {launched}")
    pwant, pwant_info = make_env_step_full(pos_env, plain=True)(pstate, paction)
    check(torch.equal(pgot.wave, pwant.wave) and torch.equal(pinfo["u_tot"], pwant_info["u_tot"])
          and torch.equal(pinfo["u_inc"], pwant_info["u_inc"])
          and rel_err(pgot.signal, pwant.signal) <= 1e-6,
          "the K1 full-field window equals its plain route")
    log("full field", f"env_step_full {SIZE}^2 K1 (moving cylinders) against its plain route: frames "
                      f"and fields bit for bit, signal {rel_err(pgot.signal, pwant.signal):.3e}")

    # 2. env_step_flux against its formula in float64
    (fstate, finfo), _ = counted(lambda: env_step_flux(env, state, action))
    check(torch.equal(fstate.signal, got.signal) and torch.equal(finfo["u_tot"], info["u_tot"]),
          "env_step_flux steps the same window")
    lap = laplacian_matrix(env.dim.x)
    mask = circle_mask(env.dim, 2.0).to(torch.float32)
    u_sc = info["u_tot"] - info["u_inc"]
    lap64, mask64, u64 = lap.double(), mask.double(), u_sc.double()
    want_flux = torch.sum((lap64 @ u64 + (lap64 @ u64.transpose(-1, -2)).transpose(-1, -2)) * mask64,
                          dim=(-2, -1))
    flux_err = float(torch.max(torch.abs(finfo["flux"].double() - want_flux))
                     / torch.max(torch.abs(want_flux)).clamp_min(1e-300))
    log("full field", f"env_step_flux: flux float32 against float64 {flux_err:.3e} of the largest "
                      f"|flux| {float(torch.max(torch.abs(want_flux))):.4e} (tol {FLUX_TOL:g})")
    check(flux_err <= FLUX_TOL and bool(torch.isfinite(finfo["flux"]).all()),
          "the flux agrees with float64")
    flux_ms = cuda_ms(lambda: flux(u_sc, lap, mask), 5)
    flux64_ms = cuda_ms(lambda: torch.sum((lap64 @ u64 + (lap64 @ u64.transpose(-1, -2))
                                           .transpose(-1, -2)) * mask64, dim=(-2, -1)), 2)
    flux_ops = 2 * 2 * u_sc.shape[0] * SIZE ** 3
    flux_bound = bound(nbytes(u_sc, lap, mask) + 4 * u_sc.shape[0], flux_ops)
    fw_ms = warm_ms(lambda: env_step_flux(env, state, action))
    log("full field", f"flux of {u_sc.shape[0]} frames (two {SIZE}^3 matmuls a frame, IEEE float32): "
                      f"{flux_ms:.4f} ms (float64 {flux64_ms:.4f} ms), bound {flux_bound[0]:.4f} ms "
                      f"({flux_bound[1]}); env_step_flux {fw_ms:.4f} ms a window")

    # 3. render episodes: the random policy, and random shooting on the flagship
    def replayed(start, acts, signals):
        st, same = start, True
        for a, sig in zip(acts, signals):
            st, _ = kernel(st, a)
            same = same and np.array_equal(st.signal.cpu().numpy(), sig)
        return same

    # each from the state the window started from, for its last n_act actions
    windows_in = state.time_step // STEPS
    renders = {}
    for name, n_act, state_aware in (("random policy", RENDER_ACTIONS, False),
                                     ("random shooting", RENDER_MPC_ACTIONS, True)):
        sub = dataclasses.replace(env, actions=windows_in + n_act)
        rgen = torch.Generator(device=dev).manual_seed(32 + n_act)
        start = state
        acts = []
        if state_aware:
            mpc = RandomShooting(model=model, horizon=HORIZON, shots=SHOTS, alpha=1.0)

            def pick(g, s, mpc=mpc, sub=sub, acts=acts):
                acts.append(mpc(sub, s, g)[0])
                return acts[-1]
        else:
            rpolicy = RandomDesignPolicy(sub.action_space)

            def pick(g, rpolicy=rpolicy, acts=acts):
                acts.append(rpolicy(g))
                return acts[-1]
        field = "sc" if state_aware else "tot"
        t = time.time()
        (times, frames, designs, signals), launched = counted(lambda: rollout_fields(
            sub, pick, rgen, field=field, stride=RENDER_STRIDE, state=start,
            render_size=RENDER_SIZE, state_aware=state_aware))
        render_s = time.time() - t
        n_frames = n_act * STEPS // RENDER_STRIDE + 1
        check(frames.shape == (n_frames, RENDER_SIZE, RENDER_SIZE) and np.isfinite(frames).all()
              and len(designs) == n_frames and signals.shape == (n_act, STEPS + 1, 3),
              f"the {name} render episode's frames, designs and signals")
        check(launched.get("fused_rk4_radii_only") == n_act * STEPS
              and launched.get("select_owner") == n_act,
              f"the {name} render episode takes K2 a step and an owner pass a window: {launched}")
        check(replayed(start, acts, signals),
              f"the {name} render episode's signals are env_step_full's")
        renders[name] = render_s
        log("full field", f"rollout_fields, {name}, {n_act} actions at {SIZE}^2, frames "
                          f"{RENDER_SIZE}^2 every {RENDER_STRIDE} steps: {render_s:.3f} s; signals "
                          f"equal to env_step_full's replay; launches {launched}")

    # 4. the adjoint demo's optimisation at its width, ADJOINT_ITERS Adam steps
    problem = AdjointProblem(steps=300, nfreq=50, elements=1024, device=dev)
    coefs0 = (torch.randn((1, 4, 50), generator=torch.Generator().manual_seed(0)) * 0.01).to(dev)
    adj_s, (_, losses) = host_s(lambda: optimise(problem, coefs0, ADJOINT_ITERS,
                                                 log=lambda m: None))
    log("full field", f"adjoint demo, {ADJOINT_ITERS} Adam steps through 300 latent steps: "
                      f"{adj_s:.3f} s, loss {losses[0]:.6g} -> {losses[-1]:.6g}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "the adjoint loss falls")

    # 5. the latent-space dashboard's rollout and MSE at full width
    lat_env = dataclasses.replace(env, actions=RENDER_ACTIONS)
    lat_s, lat = host_s(lambda: latent_comparison(lat_env, model,
                                                  torch.Generator(device=dev).manual_seed(35),
                                                  STRIDE))
    check(lat["y"].shape == (RENDER_ACTIONS * STEPS + 1, 3)
          and lat["y_hat"].shape == (RENDER_ACTIONS * STEPS // STRIDE + 1, 3)
          and np.isfinite(lat["mse"]) and np.isfinite(lat["z"]).all(),
          "the latent-space comparison is finite, of the expected shapes")
    log("full field", f"latent-space dashboard, {RENDER_ACTIONS} actions, {CHECKPOINT}: {lat_s:.3f} s, "
                      f"real-vs-latent MSE {lat['mse']:.5g}")

    # 6. the PML demo's free-field rollout (the plain integrator, 256^2, 500 steps)
    pml_s, (pframes, energy) = host_s(lambda: pml_rollout(256, 500, dev))
    check(np.isfinite(pframes).all() and energy.max() > 0.0, "the PML demo's field is finite")
    log("full field", f"PML demo, 256^2 x 500 plain steps: {pml_s:.3f} s, energy peak "
                      f"{energy.max():.4g}, final {energy[-1] / energy.max():.1%} of it")
    log("full field", f"phase {time.time() - t_phase:.1f} s; main-path launches {dict(main_path)}")
    return dict(main_path)


# the long tail (phase 14)
FUSED_ACTIONS = 3  # actions of the one-call hybrid episode
BATCH_ACTIONS = 5  # of the batched datagen episodes' 20
# windows of random actions before the fused hybrid episode: 12 ms in, the
# scattered field is non-zero and the exact costs tell the candidates apart
HYBRID_REACH = 12
SMOKE_3D = (48, 120)  # the JAX package's 3-D smoke: n, steps (tests/test_dynamics.py:233)
WINDOW_3D = (128, 20)
# of the n = 128 window's steps, those held to the CPU's run (the n = 48
# smoke holds the same arithmetic to the CPU over all its steps)
WINDOW_3D_HELD = 4
EXTRA_N, EXTRA_STEPS = 256, 10
# steps of the plain window under `debug_nans`: every op's output is read on
# the host there, about 0.1 s a step at 700^2
NAN_STEPS = 10


def sync_sites(fn):
    """(fn(), {site: count}) of the synchronising CUDA calls fn makes, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them: each by the
    innermost line of this checkout's code on the stack, then the line
    that made the call, where that lies outside the checkout."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    running = []  # non-empty while fn runs: switching the mode warns too

    def seen(message, category, filename, lineno, file=None, line=None):
        if not running or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(ROOT + os.sep)]
        site = f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}" if ours else "?"
        if not filename.startswith(ROOT + os.sep):
            site += f" via {os.path.basename(os.path.dirname(filename))}/{os.path.basename(filename)}:{lineno}"
        sites[site] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        running.append(True)
        try:
            out = fn()
        finally:
            running.clear()
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, dict(sites)


def long_tail_phase(env, env_lo, dev, loop_action_s=None):
    """Phase 14, the timed parts first: (a) the one-call hybrid episode at
    phase 5's configuration, its time an action beside phase 5's
    (`loop_action_s`, None where phase 5 did not run), its launches and
    its synchronising calls; (b) `generate_episodes_batch` at bench.py's
    datagen point through the batched exact kernel. Then, with the MPC
    CLI's `--fused-episode` in a subprocess and the CPU runs of (c) in a
    thread beside them: (b)'s episodes against the single exact kernel
    alone, the batched step's and owner pass's times and bounds at
    10 x 700^2; (d) a `profile_trace` of one fused-hybrid action; (e)
    `debug_nans` over a plain window; (c) the 3-D and extra dynamics on the
    card against the CPU. Returns (the fused episode's launches, the
    batched episodes' launches, the numbers of the K3 radii-only and
    batched owner rows at 10 x 700^2)."""
    import dataclasses
    import json as json_mod
    import tempfile
    import threading

    import torch

    import waves_jl_tpu_torch as tw
    from waves_jl_tpu_torch.control import make_hybrid_episode_fused
    from waves_jl_tpu_torch.data import _to_host, generate_episodes_batch
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_observe, env_reset, env_tspan
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.extra import make_pandemic_dynamics, make_wildfire_dynamics
    from waves_jl_tpu_torch.physics.fused import (cyl_params, make_env_step_fused,
                                                  make_fused_window, step_config)
    from waves_jl_tpu_torch.scripts.datagen import build_env as datagen_env
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
    from waves_jl_tpu_torch.utils.debug import debug_nans
    from waves_jl_tpu_torch.utils.logging import profile_trace
    from waves_jl_tpu_torch.utils.trees import tree_index, tree_stack

    t_phase = time.time()

    # (a) the one-call hybrid episode: its time, launches and synchronising calls
    model = AcousticEnergyModel(env.design_space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE, device=dev)
    load_model_checkpoint(model, os.path.join(ROOT, CHECKPOINT_HYBRID))
    env3 = dataclasses.replace(env, actions=FUSED_ACTIONS)
    run = make_hybrid_episode_fused(env3, model, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                    alpha=1.0, rerank_env=env_lo)
    gen = torch.Generator(device=dev).manual_seed(140)
    policy = RandomDesignPolicy(env.action_space)
    start = env_reset(env, gen)
    fused = make_env_step_fused(env)
    for _ in range(HYBRID_REACH):
        start, _ = fused(start, policy(gen))

    def episode(seed):
        return run(start, torch.Generator(device=dev).manual_seed(seed))

    episode(141)  # warm
    fk.reset_launch_counts()
    ep_s, (final, signals, costs) = host_s(lambda: episode(142))
    fused_counts = dict(fk.launch_counts)
    loop = "not run" if loop_action_s is None else f"{loop_action_s:.4f} s"
    log("long tail", f"one-call hybrid episode ({FUSED_ACTIONS} actions from {HYBRID_REACH} windows "
                     f"in, {SHOTS} shots, top {TOPK} at {SIZE_RERANK}^2, {CHECKPOINT_HYBRID}): "
                     f"{ep_s:.4f} s warm, {ep_s / FUSED_ACTIONS:.4f} s an action (phase 5's "
                     f"episode: {loop} an action); costs {costs.tolist()}")
    check(bool(torch.isfinite(signals).all()) and float(signals[:, :, 2].max()) > 0.0,
          "the fused episode's signals are finite and the scattered field non-zero")
    expect = dict.fromkeys(fused_counts, 0)
    expect.update({"fused_rk4_batched_xmatmul_radii_only": FUSED_ACTIONS * HORIZON * STEPS,
                   "select_owner_batched": FUSED_ACTIONS * HORIZON,
                   "fused_rk4_xmatmul_radii_only": FUSED_ACTIONS * STEPS,
                   "select_owner": FUSED_ACTIONS})
    check(fused_counts == expect, f"fused episode launch counts {fused_counts} == {expect}")
    _, sites = sync_sites(lambda: episode(142))
    n_sync = sum(sites.values())
    log("long tail", f"synchronising calls inside the {FUSED_ACTIONS}-action episode: {n_sync} "
                     f"({n_sync / FUSED_ACTIONS:.1f} an action), by site: "
                     + json_mod.dumps(dict(sorted(sites.items(), key=lambda kv: -kv[1]))))

    # (b) batched datagen at bench.py's point through the batched exact kernel
    dg = datagen_env(SIZE, STEPS, BATCH_ACTIONS, dev)
    dg_policy = RandomDesignPolicy(dg.action_space)

    def batch(seed):
        return generate_episodes_batch(dg, dg_policy, torch.Generator(device=dev).manual_seed(seed),
                                       CHUNK)

    batch(144)  # warm
    fk.reset_launch_counts()
    batch_s, (b_final, eps) = host_s(lambda: batch(145))
    batch_counts = dict(fk.launch_counts)
    pull_s, _ = host_s(lambda: _to_host(eps))
    expect = dict.fromkeys(batch_counts, 0)
    expect.update({"fused_rk4_batched_radii_only": BATCH_ACTIONS * STEPS,
                   "select_owner_batched": BATCH_ACTIONS})
    check(batch_counts == expect, f"batched datagen launches {batch_counts} == {expect}")
    per_ep = (batch_s + pull_s) / CHUNK
    log("long tail", f"generate_episodes_batch, {CHUNK} episodes x {BATCH_ACTIONS} actions x {STEPS} "
                     f"steps at {SIZE}^2 (exact d/dx): {batch_s:.4f} s, host pull {pull_s:.4f} s; "
                     f"{per_ep:.4f} s an episode of {BATCH_ACTIONS} actions, "
                     f"{per_ep * WINDOWS / BATCH_ACTIONS:.4f} s for {WINDOWS} (phase 7: K5 one "
                     f"episode at a time); launches {batch_counts}")
    check(all(bool(torch.isfinite(x).all()) for x in (eps.y, eps.s_wave, b_final.wave)),
          "the batched episodes are finite")
    check(float(eps.y[:, -1, :, 2].max()) > 0.0, "the scattered field is non-zero by the last window")

    # the untimed rest: the CLI in a subprocess and the CPU runs of (c) in a
    # thread (their operations release the interpreter lock) beside the card's
    tmp = tempfile.TemporaryDirectory()
    cli = subprocess.Popen(
        [sys.executable, "-m", "waves_jl_tpu_torch.scripts.mpc", "--controller", "hybrid",
         "--fused-episode", "--checkpoint", os.path.join(ROOT, CHECKPOINT_HYBRID),
         "--latent-stride", str(STRIDE), "--topk", "4", "--shots", "32", "--horizon", "2",
         "--rerank-n", str(SIZE_RERANK), "--actions", "2", "--locations", "1", "--episodes", "1",
         "--out", os.path.join(tmp.name, "r.json")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t_cli = time.time()

    def smoke_3d(device, n, steps, trajectory, held=None):
        """The 3-D smoke's run of `steps` steps, or of its first `held`."""
        dim = tw.three_dim(5.0, n, device=device)
        dyn = tw.make_acoustic_dynamics_3d(dim, tw.WATER, 1.0, 20000.0)
        shape3 = torch.exp(-(tw.build_grid(dim) ** 2).sum(-1) / (2.0 * 0.3**2))
        two_pi_f = torch.tensor(2.0 * math.pi * 1000.0, device=dim.x.device)
        theta = (lambda s: torch.tensor(tw.WATER, dtype=torch.float32, device=dim.x.device),
                 lambda s: shape3 * torch.sin(two_pi_f * s))
        it = tw.Integrator(dynamics=dyn, dt=1e-5)
        tspan3 = torch.from_numpy(tw.build_tspan(0.0, 1e-5, steps)[:(held or steps) + 1])
        tspan3 = tspan3.to(dim.x.device)
        u0 = tw.build_wave(dim, 16)
        return it(u0, tspan3, theta) if trajectory else it.rollout_final(u0, tspan3, theta)

    def extra(kind, device):
        if kind == "pandemic":
            dim = tw.two_dim(5.0, EXTRA_N, device=device)
            dyn = make_pandemic_dynamics(dim)
            shape2 = tw.build_normal(tw.build_grid(dim), torch.tensor([[0.0, 0.0]], device=device),
                                     torch.tensor([0.3], device=device),
                                     torch.tensor([1.0], device=device))
            theta = (tw.Source(shape=shape2, freq=torch.tensor(1000.0, device=device)),)
            u0 = tw.build_wave(dim, 3)
            dt = 1e-5
        else:
            dim = tw.two_dim(100.0, EXTRA_N, device=device)
            dyn = make_wildfire_dynamics(dim)
            x = dim.x
            hot = torch.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2.0 * 20.0**2))
            u0 = torch.stack([298.15 + 600.0 * hot, torch.ones_like(hot)])
            theta, dt = (), 1e-3
        it = tw.Integrator(dynamics=dyn, dt=dt)
        return it.rollout_final(u0, torch.from_numpy(tw.build_tspan(0.0, dt, EXTRA_STEPS))
                                .to(dim.x.device), theta)

    cpu = {}

    def cpu_runs():
        try:
            t = time.time()
            cpu["smoke"] = smoke_3d("cpu", *SMOKE_3D, True)
            cpu["window"] = smoke_3d("cpu", *WINDOW_3D, False, WINDOW_3D_HELD)
            for kind in ("pandemic", "wildfire"):
                cpu[kind] = extra(kind, "cpu")
            cpu["s"] = time.time() - t
        except BaseException as e:  # re-raised by the phase's thread
            cpu["error"] = e

    worker = threading.Thread(target=cpu_runs)
    worker.start()

    # (b) each batched episode against its reset and actions alone through
    # the exact single kernel
    g = torch.Generator(device=dev).manual_seed(145)
    states = [env_reset(dg, g) for _ in range(CHUNK)]
    actions = tree_stack([tree_stack([dg_policy(g) for _ in range(BATCH_ACTIONS)])
                          for _ in range(CHUNK)])
    # one step a call: the tspan times of JAX's vmapped env_step, as batched datagen
    single = make_env_step_fused(dg, x_matmul=False, steps_per_call=1)
    frames_same, sig_err, obs_err = 0, 0.0, 0.0
    for b, st in enumerate(states):
        for i in range(BATCH_ACTIONS):
            obs_err = max(obs_err, rel_err(eps.s_wave[b, i], env_observe(dg, st).wave))
            st, _ = single(st, tree_index(tree_index(actions, b), i))
            sig_err = max(sig_err, rel_err(eps.y[b, i], st.signal))
        frames_same += int(torch.equal(b_final.wave[b], st.wave))
    log("long tail", f"each batched episode alone through the exact single kernel (K2): final "
                     f"frames bit for bit in {frames_same} of {CHUNK}; signals rel err "
                     f"{sig_err:.3e} (tol 1e-6); observations {obs_err:.3e}")
    check(frames_same == CHUNK and sig_err <= 1e-6 and obs_err <= 1e-6,
          "each batched episode is its single-kernel episode's")

    # the batched step and owner pass at 10 x 700^2 against their plain versions
    cfg = step_config(dg)
    prof_x = dg.integrator.dynamics.pml[:, 0].contiguous()
    u = b_final.wave[:, -1].contiguous()
    shape = b_final.source.shape
    nxt = dg.design_space(b_final.design, dg.action_space.sample(g, batch=(CHUNK,)))
    cyl = cyl_params(b_final.design, nxt, dev).contiguous()
    tspan = env_tspan(dg, b_final)
    ti, tf, t_arg = float(tspan[0]), float(tspan[-1]), float(tspan[0])
    own_k = fk.select_owner_batched(cyl, cfg)
    own_p = fk.select_owner_batched_reference(cyl, cfg)
    u_k, e_k = fk.fused_rk4_step_batched(u, shape, prof_x, cyl, own_k, t_arg, ti, tf, cfg)
    u_p, e_p = fk.fused_rk4_step_batched_reference(u, shape, prof_x, cyl, own_p, t_arg, ti, tf,
                                                   cfg)
    torch.cuda.synchronize()
    k3_abs = float(torch.max(torch.abs(u_k - u_p)))
    own_abs = float(torch.max(torch.abs(own_k - own_p)))
    log("long tail", f"K3 radii-only step at {CHUNK} x {SIZE}^2, a source shape a candidate, vs "
                     f"plain: {differing_cells(u_k, u_p)}; energies {rel_err(e_k, e_p):.3e}; owner "
                     f"pass {differing_cells(own_k, own_p)}")
    check(torch.equal(u_k, u_p) and rel_err(e_k, e_p) <= 1e-6 and torch.equal(own_k, own_p),
          "the batched step and owner pass at 10 x 700^2 equal their plain versions")
    k3_ms = cuda_ms(lambda: fk.fused_rk4_step_batched(u, shape, prof_x, cyl, own_k, t_arg, ti, tf,
                                                      cfg), 20)
    k3_dev = device_ms(lambda: fk.fused_rk4_step_batched(u, shape, prof_x, cyl, own_k, t_arg, ti,
                                                         tf, cfg), 20)
    k3_plain = cuda_ms(lambda: fk.fused_rk4_step_batched_reference(u, shape, prof_x, cyl, own_p,
                                                                   t_arg, ti, tf, cfg), 2)
    own_ms = cuda_ms(lambda: fk.select_owner_batched(cyl, cfg), 20)
    own_dev = device_ms(lambda: fk.select_owner_batched(cyl, cfg), 20)
    own_plain = cuda_ms(lambda: fk.select_owner_batched_reference(cyl, cfg), 2)
    part_t = torch.empty((CHUNK, fk.step_partial_rows(SIZE), 3), dtype=torch.float32)
    k3_bound = bound(2 * nbytes(u) + nbytes(shape, prof_x, cyl, part_t),
                     CHUNK * fk.step_flops(SIZE, cyl.shape[-1], True))
    own_bound = bound(nbytes(cyl, own_k), sum(owner_ops(c, cfg) for c in cyl))
    log("long tail", f"K3 radii-only step at {CHUNK} x {SIZE}^2: {k3_ms:.4f} ms (device work "
                     f"{k3_dev:.4f}, {k3_dev / k3_bound[0]:.2f}x its bound {k3_bound[0]:.5f} ms, "
                     f"{k3_bound[1]}; plain {k3_plain:.4f}); batched owner pass {own_ms:.4f} ms "
                     f"(device work {own_dev:.4f}, bound {own_bound[0]:.5f} ms, {own_bound[1]}; "
                     f"plain {own_plain:.4f}); the CPU runs of (c) beside them")
    k3_row = {"shape": f"{CHUNK}x{SIZE}^2", "launches": batch_counts["fused_rk4_batched_radii_only"],
              "max_abs_err": k3_abs, "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound[0],
              "bound_by": k3_bound[1], "device_ms": k3_dev}
    own_row = {"shape": f"{CHUNK}x{SIZE}^2", "launches": batch_counts["select_owner_batched"],
               "max_abs_err": own_abs, "ms": own_ms, "plain_ms": own_plain,
               "bound_ms": own_bound[0], "bound_by": own_bound[1], "device_ms": own_dev}

    # (d) a profile trace of one fused-hybrid action
    with tempfile.TemporaryDirectory() as trace_dir:
        g = torch.Generator(device=dev).manual_seed(143)
        t = time.time()
        with profile_trace(trace_dir) as prof:
            a, _ = run.act(final, g)
            run.step(final, a)
            torch.cuda.synchronize()
        trace_s = time.time() - t
        files = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, files[0])) as f:
            names = {e.get("name", "") for e in json_mod.load(f)["traceEvents"]}
    tiled = sorted(n for n in names if "rk4_step_tiled" in n)
    dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages() if "rk4_step_tiled" in e.key)
    log("long tail", f"profile_trace of one fused-hybrid action ({trace_s:.2f} s with the trace "
                     f"written): {len(files)} trace file, {len(names)} event names, "
                     f"rk4_step_tiled kernels {tiled}, their device time {dev_us / 1e3:.3f} ms")
    check(len(files) == 1 and tiled and dev_us > 0,
          "the trace names rk4_step_tiled and times it on the card")

    # (e) debug_nans over a plain window: finite work passes, a NaN raises
    nan_env = datagen_env(SIZE, NAN_STEPS, 1, dev)
    st = env_reset(nan_env, g)
    st, _ = make_env_step_fused(nan_env)(st, dg_policy(g))  # a wave to step
    window = make_fused_window(nan_env, x_matmul=False, plain=True)
    tspan0 = env_tspan(nan_env, st)
    cyl0 = cyl_params(st.design, nan_env.design_space(st.design, dg_policy(g)), dev).contiguous()

    def trapped(u0):
        with debug_nans():
            return window(u0, st.source.shape, tspan0, cyl0)

    nan_s, (_, _, sig0) = host_s(lambda: trapped(st.wave[-1]))
    bad = st.wave[-1].clone()
    bad[0, SIZE // 2, SIZE // 2] = float("nan")
    try:
        trapped(bad)
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    log("long tail", f"debug_nans over a plain {NAN_STEPS}-step window at {SIZE}^2: finite, "
                     f"{nan_s:.2f} s with every op checked; with a NaN injected: {raised!r}")
    check(bool(torch.isfinite(sig0).all()) and "aten." in raised,
          "debug_nans passes a finite window and names the op that makes a NaN")

    # (c) the 3-D and extra dynamics on the card against the CPU's runs
    n, steps = SMOKE_3D
    s3_s, traj = host_s(lambda: smoke_3d(dev, n, steps, True))
    w3_s, traj3 = host_s(lambda: smoke_3d(dev, *WINDOW_3D, True))
    u3 = traj3[-1]
    card_extra = {kind: extra(kind, dev) for kind in ("pandemic", "wildfire")}
    worker.join()
    if "error" in cpu:
        raise cpu["error"]
    e = (traj[:, 0] ** 2).sum(dim=(1, 2, 3))
    err3 = rel_err(traj.cpu(), cpu["smoke"])
    faces = all(bool((traj[:, 0].select(ax, i) == 0).all()) for ax in (1, 2, 3) for i in (0, -1))
    log("long tail", f"3-D smoke n = {n}, {steps} steps on the card: {s3_s:.3f} s; against the CPU "
                     f"rel err {err3:.3e} (tol {REL_TOL:g}); scattered field exactly 0 "
                     f"{torch.equal(traj[:, 0], traj[:, 8])}; Dirichlet faces 0 {faces}; energy "
                     f"peak {float(e.max()):.4e}, final {float(e[-1] / e.max()):.3f} of it; the "
                     f"CPU runs took {cpu['s']:.1f} s")
    check(err3 <= REL_TOL and bool(torch.isfinite(traj).all()) and torch.equal(traj[:, 0], traj[:, 8])
          and faces and float(e[-1]) < 0.8 * float(e.max()),
          "the 3-D smoke holds on the card and agrees with the CPU")
    err3w = rel_err(traj3[WINDOW_3D_HELD].cpu(), cpu["window"])
    log("long tail", f"3-D window n = {WINDOW_3D[0]}, {WINDOW_3D[1]} steps: {w3_s:.3f} s on the card; "
                     f"its first {WINDOW_3D_HELD} against the CPU rel err {err3w:.3e}; scattered "
                     f"field exactly 0 {torch.equal(u3[0], u3[8])}")
    check(err3w <= REL_TOL and bool(torch.isfinite(u3).all()) and torch.equal(u3[0], u3[8])
          and float(u3[0].abs().max()) > 0.0, "the n = 128 window agrees with the CPU")
    for kind, got in card_extra.items():
        err = rel_err(got.cpu(), cpu[kind])
        log("long tail", f"{kind} at {EXTRA_N}^2, {EXTRA_STEPS} steps: card against CPU rel err "
                         f"{err:.3e} (tol {REL_TOL:g}); max |u0| {float(got[0].abs().max()):.4e}")
        check(err <= REL_TOL and bool(torch.isfinite(got).all()),
              f"the {kind} dynamics agree on the card and the CPU")
    del traj, traj3, u3, cpu

    out, err_text = cli.communicate(timeout=600)
    cli_s = time.time() - t_cli
    tail = (out + err_text).strip().splitlines()[-1:] or [""]
    log("long tail", f"MPC CLI --controller hybrid --fused-episode (2 actions, top 4 of 32 at "
                     f"{SIZE_RERANK}^2): exit {cli.returncode} after {cli_s:.2f} s (beside the "
                     f"above): {tail[0][:200]}")
    check(cli.returncode == 0, f"the MPC CLI's --fused-episode exits 0:\n{out}\n{err_text}")
    with open(os.path.join(tmp.name, "r.json")) as f:
        check(math.isfinite(json_mod.load(f)["mean_decrease"]), "the CLI's decrease is finite")
    tmp.cleanup()
    log("long tail", f"phase {time.time() - t_phase:.1f} s")
    return fused_counts, batch_counts, k3_row, own_row


def entry_points_phase(dev):
    """Phase 15: the port's counterparts of the entry points of `__graft_entry__.py`
    (`waves_jl_tpu_torch/entry_points.py`). `entry()` on the card: the
    flagship's forward at the production configuration, held within 1e-4 to
    the same forward on the CPU (the same seed's weights, the card's batch),
    timed; then `dryrun_multichip(4)`: its data-parallel step and windowed
    scan, the plain sharded window and the fused one through K4-XM on the
    slabs, on 4 shards (every card where there are 4, else 4 shards of one
    card), every result finite, its launches counted. Returns them."""
    import torch

    from waves_jl_tpu_torch.entry_points import STEPS, dryrun_multichip, entry
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.utils.trees import tree_map

    t = time.time()
    fn, (model, batch) = entry()
    with torch.no_grad():
        y = fn(model, batch)
        torch.cuda.synchronize()
        first_s = time.time() - t
        ms = cuda_ms(lambda: fn(model, batch), 5)
        fn_c, (model_c, _) = entry(device="cpu")
        y_c = fn_c(model_c, tree_map(lambda x: x.cpu(), batch))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(model.state_dict().values(),
                                                       model_c.state_dict().values()))
    err = rel_err(y.cpu(), y_c)
    log("entry points", f"entry() on {next(model.parameters()).device}: forward {tuple(y.shape)}, "
                        f"built and run in {first_s:.3f} s, {ms:.4f} ms a warm forward; against "
                        f"the CPU's forward with the same seed's weights (equal {same}) on the "
                        f"card's batch: rel err {err:.3e} (tol 1e-4)")
    check(next(model.parameters()).device.type == "cuda", "entry() builds its model on the card")
    check(tuple(y.shape) == (2, 26, 3) and bool(torch.isfinite(y).all()),
          "entry()'s forward gives finite (2, 26, 3) energies")
    check(same and err <= 1e-4, "entry()'s forward on the card agrees with the CPU's")

    fk.reset_launch_counts()
    t = time.time()
    loss, losses, signal, fsignal = dryrun_multichip(4)
    torch.cuda.synchronize()
    dry_s = time.time() - t
    counts = {k: v for k, v in fk.launch_counts.items() if v}
    groups = 4 if torch.cuda.device_count() >= 4 else 1  # the cards the 4 shards lie on
    log("entry points", f"dryrun_multichip(4) on {groups} card(s) in {dry_s:.3f} s: loss "
                        f"{float(loss):.6g}, the scan's {[round(float(v), 6) for v in losses]}, "
                        f"the plain window's last tot {float(signal[-1, 0]):.4e}, the fused "
                        f"window's {float(fsignal[-1, 0]):.4e}; launches {counts}")
    expect = {"fused_rk4_sharded_xmatmul_radii_only": STEPS * groups,
              "select_owner_sharded": groups}
    check(counts == expect, f"the dry run's fused window takes K4-XM, one launch a card a step, "
                            f"and one owner pass a card: {counts} == {expect}")
    return counts


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="smoke run of the port on one NVIDIA card")
    p.add_argument("--save-train-batch", default=None, metavar="NPZ",
                   help="write phase 9's fixed learning batch and its loss trajectories at "
                        "lr 1e-5 and 1e-4 (tests/test_torch_train_learning.py reads them)")
    p.add_argument("--only-long-tail", action="store_true",
                   help="run phases 1, 2 and 14 alone (no kernels line)")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from waves_jl_tpu_torch.control.mpc import RandomShooting, make_mpc_episode_fused
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset, env_time, env_tspan
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.physics.fused import (cyl_params, make_env_step_fused,
                                                  make_rerank_rollout, radii_only_ok, step_config)
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
    from waves_jl_tpu_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t = time.time()
    libs, report = fk.build()
    log("build", f"{time.time() - t:.2f} s, {', '.join(p.name for p in libs.values())} (one nvcc "
                 f"a library, started together)" + ("" if report else " (already built)"))
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip(), flush=True)
    lines = report.splitlines()
    occ = fk.tiled_kernel_report()
    # the eight instances of the one-launch step rk4_step_tiled<XM, GENERAL,
    # SLAB>: the split d/dx (K5) or the exact one (K1-K4), the owner test or
    # the general rasterisation, the whole grid or slabs
    names = {"split": "split d/dx, radii-only: K5 and batched K5",
             "exact": "exact d/dx, radii-only: K2 and K3",
             "split_general": "split d/dx, general: K5 general and batched K5 general",
             "exact_general": "exact d/dx, general: K1 and K3 general",
             "split_slab": "split d/dx, radii-only, slabs: K4-XM",
             "exact_slab": "exact d/dx, radii-only, slabs: K4",
             "split_general_slab": "split d/dx, general, slabs: K4-XM general",
             "exact_general_slab": "exact d/dx, general, slabs: K4 general"}
    for key, flags in fk.TILED_INSTANCES.items():
        mangled = "rk4_step_tiled" + "".join(f"ILb{int(f)}E" if i == 0 else f"Lb{int(f)}E"
                                             for i, f in enumerate(flags)) + "E"
        at = [i for i, line in enumerate(lines) if "Compiling entry" in line and mangled in line]
        ptxas = "; ".join(line.split(":", 1)[-1].strip() for line in lines[at[0] + 1:at[0] + 4]
                          if "registers" in line or "spill" in line) if at else "already built"
        log("build", f"rk4_step_tiled<{', '.join(str(f).lower() for f in flags)}> ({names[key]}, "
                     f"one launch a step): ptxas {ptxas}; dynamic shared memory "
                     f"{occ['smem_bytes']} B a block of 256 threads; {occ[key]} blocks an SM")
        check(occ[key] >= 1, f"the one-launch step ({names[key]}) fits an SM")
    # the sixteen instances of rk4_steps_tiled<XM, GENERAL, SPC, SLAB>: two
    # or four steps a launch on the whole grid, single or batched, or on slabs
    for key, (xm, general, spc, slab) in fk.STEPS_INSTANCES.items():
        mangled = f"rk4_steps_tiledILb{int(xm)}ELb{int(general)}ELi{spc}ELb{int(slab)}EE"
        at = [i for i, line in enumerate(lines) if "Compiling entry" in line and mangled in line]
        ptxas = "; ".join(line.split(":", 1)[-1].strip() for line in lines[at[0] + 1:at[0] + 4]
                          if "registers" in line or "spill" in line) if at else "already built"
        what = names[key.rsplit("_spc", 1)[0]]
        log("build", f"rk4_steps_tiled<{str(xm).lower()}, {str(general).lower()}, {spc}, "
                     f"{str(slab).lower()}> ({what}, "
                     f"{spc} steps a launch): ptxas {ptxas}; dynamic shared memory "
                     f"{occ[f'smem_bytes_spc{spc}']} B a block of 256 threads; {occ[key]} blocks "
                     f"an "
                     f"SM; {fk.band_work_share(SIZE, spc):.3f} of the cell-stages at {SIZE}^2 "
                     f"computed more than once (one step a launch: "
                     f"{fk.band_work_share(SIZE, 1):.3f})")
        check(occ[key] >= 1, f"the {spc}-step launch ({what}) fits an SM")

    if args.only_long_tail:
        space = build_triple_ring_design_space(device=dev)
        long_tail_phase(build_env(space, dev), build_env(space, dev, SIZE_RERANK), dev)
        log("done", f"phases 1, 2 and 14 {time.time() - T0:.1f} s")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernels against their plain versions, 700^2
    space = build_triple_ring_design_space(device=dev)
    check(radii_only_ok(space), "the triple ring takes the radii-only kernel")
    env = build_env(space, dev)
    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    step = make_env_step_fused(env)
    policy = RandomDesignPolicy(env.action_space)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = env_reset(env, gen)
    state, _ = step(state, policy(gen))  # one window, so the state holds a wave
    torch.cuda.synchronize()
    tspan = env_tspan(env, state)
    ti, tf = float(tspan[0]), float(tspan[-1])
    nxt = env.design_space(state.design, policy(gen))
    cyl = cyl_params(state.design, nxt, dev).contiguous()
    shape = state.source.shape
    u0 = state.wave[-1]
    log("kernels", f"state after one window: max |u| {float(u0.abs().max()):.3e}")

    owner_k = fk.select_owner(cyl, cfg)
    owner_p = fk.select_owner_reference(cyl, cfg)
    torch.cuda.synchronize()
    owner_err = float(torch.max(torch.abs(owner_k - owner_p)))
    log("kernels", f"select_owner vs plain: {differing_cells(owner_k, owner_p)} of the five planes; "
                   f"{owner_sentinel_share(owner_k):.3f} of the cells hold the sentinel")
    check(torch.equal(owner_k, owner_p),
          "select_owner equals its plain version bit for bit on all five planes")

    def window_run(step_fn, owner, cyl_, n_steps):
        u, es = u0, []
        for k in range(n_steps):
            u, e = step_fn(u, shape, prof, cyl_, owner, float(tspan[k]), ti, tf, cfg)
            es.append(e)
        return u, torch.stack(es)

    u_k2, e_k2 = window_run(fk.fused_rk4_step, owner_k, cyl, STEPS)
    u_p2, e_p2 = window_run(fk.fused_rk4_step_reference, owner_p, cyl, STEPS)
    torch.cuda.synchronize()
    k2_state, k2_sig = rel_err(u_k2, u_p2), rel_err(e_k2, e_p2)
    k2_abs = float(torch.max(torch.abs(u_k2 - u_p2)))
    log("kernels", f"K2 radii-only vs plain, {STEPS} steps: rel err state {k2_state:.3e}, "
                   f"signal {k2_sig:.3e} (tol {REL_TOL:g}); {differing_cells(u_k2, u_p2)}")
    check(k2_state <= REL_TOL and k2_sig <= REL_TOL, "K2 agrees with its plain version")
    check(torch.equal(u_k2, u_p2) and k2_sig <= 1e-6,
          "K2 radii-only (one launch a step) equals its plain version bit for bit, its signal "
          "within 1e-6")

    moved = cyl.clone()
    moved[4] += 0.3  # p2x != p1x: the cylinders move within the window
    moved[5] -= 0.2
    u_k1, e_k1 = window_run(fk.fused_rk4_step, None, moved, 10)
    u_p1, e_p1 = window_run(fk.fused_rk4_step_reference, None, moved, 10)
    torch.cuda.synchronize()
    k1_state, k1_sig = rel_err(u_k1, u_p1), rel_err(e_k1, e_p1)
    k1_abs = float(torch.max(torch.abs(u_k1 - u_p1)))
    log("kernels", f"K1 general vs plain, 10 steps, moving cylinders: rel err state "
                   f"{k1_state:.3e}, signal {k1_sig:.3e} (tol {REL_TOL:g}); "
                   f"{differing_cells(u_k1, u_p1)}")
    check(k1_state <= REL_TOL and k1_sig <= REL_TOL, "K1 agrees with its plain version")
    check(torch.equal(u_k1, u_p1) and k1_sig <= 1e-6,
          "K1 general (one launch a step) equals its plain version bit for bit, its signal "
          "within 1e-6")

    u_g, e_g = window_run(fk.fused_rk4_step, None, cyl, 10)
    u_r, e_r = window_run(fk.fused_rk4_step, owner_k, cyl, 10)
    torch.cuda.synchronize()
    kk_state, kk_sig = rel_err(u_g, u_r), rel_err(e_g, e_r)
    log("kernels", f"K1 vs K2 on the triple ring, 10 steps: rel err state {kk_state:.3e}, "
                   f"signal {kk_sig:.3e} (tol {REL_TOL:g})")
    check(kk_state <= REL_TOL and kk_sig <= REL_TOL, "K1 agrees with K2 on the triple ring")

    # K5: the split d/dx in both rasterisation modes, against its plain
    # version and against K2 (the exact stencil)
    xm_step = functools.partial(fk.fused_rk4_step, x_matmul=True)
    xm_plain = functools.partial(fk.fused_rk4_step_reference, x_matmul=True)
    xm_abs = {}
    for radii, own_k, own_p, cyl_, n_steps in ((True, owner_k, owner_p, cyl, STEPS),
                                               (False, None, None, moved, 10)):
        u_k5, e_k5 = window_run(xm_step, own_k, cyl_, n_steps)
        u_p5, e_p5 = window_run(xm_plain, own_p, cyl_, n_steps)
        torch.cuda.synchronize()
        k5_state, k5_sig = rel_err(u_k5, u_p5), rel_err(e_k5, e_p5)
        xm_abs[radii] = float(torch.max(torch.abs(u_k5 - u_p5)))
        mode = "radii-only" if radii else "general, moving cylinders"
        log("kernels", f"K5 {mode} vs plain, {n_steps} steps: rel err state {k5_state:.3e}, "
                       f"signal {k5_sig:.3e} (tol {REL_TOL:g}); {differing_cells(u_k5, u_p5)}")
        check(k5_state <= REL_TOL and k5_sig <= REL_TOL, f"K5 {mode} agrees with its plain version")
        check(torch.equal(u_k5, u_p5) and k5_sig <= 1e-6,
              f"K5 {mode} (one launch a step) equals its plain version bit for bit, its signal "
              "within 1e-6")
        if radii:
            # the split keeps 16 of 24 mantissa bits of each tap, an error of
            # about 2^-17 |u| / dx in each d/dx, which grows against the
            # derivative as the grid refines: at 700^2 a window moves the
            # state about 2e-5 of its largest value from the exact stencil's
            split_gap = rel_err(u_k5, u_k2)
            log("kernels", f"K5 against K2 after {STEPS} steps (split against exact d/dx): rel err "
                           f"state {split_gap:.3e} (a fault shows at 1e-3 or more)")
            check(0.0 < split_gap <= 1e-3, "K5 takes the split d/dx, near the exact one")

    # times per call at the main path's shapes: one RK4 step, one owner pass
    t_arg = float(tspan[0])
    k2_ms = cuda_ms(lambda: fk.fused_rk4_step(u0, shape, prof, cyl, owner_k, t_arg, ti, tf, cfg), 50)
    k2_plain = cuda_ms(lambda: fk.fused_rk4_step_reference(u0, shape, prof, cyl, owner_p, t_arg, ti,
                                                           tf, cfg), 5)
    k1_ms = cuda_ms(lambda: fk.fused_rk4_step(u0, shape, prof, moved, None, t_arg, ti, tf, cfg), 50)
    k1_plain = cuda_ms(lambda: fk.fused_rk4_step_reference(u0, shape, prof, moved, None, t_arg, ti,
                                                           tf, cfg), 3)
    own_ms = cuda_ms(lambda: fk.select_owner(cyl, cfg), 50)
    own_dev = device_ms(lambda: fk.select_owner(cyl, cfg), 20)
    own_plain = cuda_ms(lambda: fk.select_owner_reference(cyl, cfg), 5)
    k5_ms = cuda_ms(lambda: xm_step(u0, shape, prof, cyl, owner_k, t_arg, ti, tf, cfg), 50)
    k5_plain = cuda_ms(lambda: xm_plain(u0, shape, prof, cyl, owner_p, t_arg, ti, tf, cfg), 5)
    k5g_ms = cuda_ms(lambda: xm_step(u0, shape, prof, moved, None, t_arg, ti, tf, cfg), 50)
    k5g_plain = cuda_ms(lambda: xm_plain(u0, shape, prof, moved, None, t_arg, ti, tf, cfg), 3)
    k5_dev = device_ms(lambda: xm_step(u0, shape, prof, cyl, owner_k, t_arg, ti, tf, cfg), 20)
    k2_dev = device_ms(lambda: fk.fused_rk4_step(u0, shape, prof, cyl, owner_k, t_arg, ti, tf,
                                                 cfg), 20)
    k1_dev = device_ms(lambda: fk.fused_rk4_step(u0, shape, prof, moved, None, t_arg, ti, tf,
                                                 cfg), 20)
    k5g_dev = device_ms(lambda: xm_step(u0, shape, prof, moved, None, t_arg, ti, tf, cfg), 20)
    times = [float(x) for x in tspan[:-1]]
    for name, xm, own, cyl_ in (("K5 radii-only", True, owner_k, cyl),
                                ("K2 radii-only", False, owner_k, cyl),
                                ("K5 general", True, None, moved),
                                ("K1 general", False, None, moved)):
        win = window_step_ms(u0, shape, prof, cyl_, own, times, ti, tf, cfg, xm)
        log("kernels", f"{name} inside a {STEPS}-step window (`fused_rk4_window`, one "
                       f"launch a step): {win[0]:.4f} ms a step, device work {win[1]:.4f} ms, the "
                       f"host issues a step in {win[2]:.4f} ms")
    log("kernels", f"ms per RK4 step: K2 {k2_ms:.4f} (plain {k2_plain:.4f}; device work "
                   f"{k2_dev:.4f}), K1 {k1_ms:.4f} (plain {k1_plain:.4f}; device work "
                   f"{k1_dev:.4f}); select_owner {own_ms:.4f} (plain {own_plain:.4f}; device work "
                   f"{own_dev:.4f}); "
                   f"K5 radii-only {k5_ms:.4f} (plain {k5_plain:.4f}; device work {k5_dev:.4f}), "
                   f"K5 general {k5g_ms:.4f} (plain {k5g_plain:.4f}; device work {k5g_dev:.4f})")

    n_cyl = cyl.shape[1]
    # what an RK4 step needs: state, source shape, profile and cylinders in,
    # state and energy partials out (a row a tile of the one-launch step).
    # K2's owner fields are a layout of this design, made once a window,
    # and stay out of the bound.
    part_t = torch.empty((fk.step_partial_rows(SIZE), 3), dtype=torch.float32)
    io_step = nbytes(u0, shape, prof, cyl) + nbytes(u0, part_t)
    # the general mode tests only the cylinders that reach a tile
    tested = fk.tile_cylinders(moved, cfg, fk.lerp_weight(t_arg, ti, tf))
    k1_bound = bound(io_step, fk.step_flops(SIZE, tested, False))
    own_bound = bound(nbytes(cyl, owner_k), owner_ops(cyl, cfg))
    k2_bound = bound(io_step, fk.step_flops(SIZE, n_cyl, True))
    k5_bound = bound(io_step, fk.step_flops(SIZE, n_cyl, True, x_matmul=True))
    k5g_bound = bound(io_step, fk.step_flops(SIZE, tested, False, x_matmul=True))
    log("kernels", f"bound per RK4 step {k1_bound[0]:.5f} ms ({k1_bound[1]}; {tested:.4f} of "
                   f"{moved.shape[1]} cylinders a cell, those each tile keeps), K1, K2 and K5 "
                   f"({k5_bound[1]}); K2 reads "
                   f"its owner fields on top, {nbytes(owner_k) / HBM_BYTES_PER_S * 1e3:.5f} ms "
                   f"of bytes once read")
    env_lo, k3 = batched_kernels(env, state, dev)
    multi = multi_step_kernels(u0, shape, prof, cyl, moved, owner_k, owner_p, tspan, cfg)

    # 4. main path: the MPC control episode
    model = AcousticEnergyModel(space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE, device=dev)
    ck_step = load_model_checkpoint(model, os.path.join(ROOT, CHECKPOINT))
    log("main path", f"flagship loaded from {CHECKPOINT} (step {ck_step})")
    mpc = RandomShooting(model=model, horizon=5, shots=256, alpha=1.0)
    run = make_mpc_episode_fused(env, mpc)
    start = env_reset(env, torch.Generator(device=dev).manual_seed(2))
    t = time.time()
    run(start, torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    log("main path", f"warm-up episode {time.time() - t:.3f} s")

    fk.reset_launch_counts()
    t = time.time()
    final, signals, chosen, costs = run(start, torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    episode_s = time.time() - t
    mpc_counts = dict(fk.launch_counts)
    log("main path", f"MPC episode {episode_s:.4f} s, launches {mpc_counts}")
    expect_steps = WINDOWS * STEPS
    check(mpc_counts["fused_rk4_xmatmul_radii_only"] == expect_steps
          and sum(mpc_counts.values()) == expect_steps + WINDOWS,
          f"{expect_steps} K5 radii-only launches ({WINDOWS} windows x {STEPS} steps, one "
          f"launch a step), the owner passes and nothing else")
    check(mpc_counts["select_owner"] == WINDOWS, f"{WINDOWS} owner launches, one per window")
    check(tuple(signals.shape) == (WINDOWS, STEPS + 1, 3), f"signal shape {tuple(signals.shape)}")
    check(bool(torch.isfinite(signals).all()), "every signal is finite")
    check(final.time_step == WINDOWS * STEPS, "the episode ran every window")
    check(bool((chosen <= costs.mean(dim=1)).all()),
          "each chosen cost is at most the mean cost of its shots")
    check(float(signals[:, :, 2].max()) > 0.0, "the scattered field is non-zero")
    log("main path", f"signals finite; sc energy max {float(signals[:, :, 2].max()):.4e}; chosen "
                     f"cost <= shot mean for all {WINDOWS} actions")

    t = time.time()
    for k in range(3):
        mpc(env, final, torch.Generator(device=dev).manual_seed(10 + k))
    torch.cuda.synchronize()
    select_s = (time.time() - t) / 3
    log("main path", f"one selection (observe, encode, {mpc.shots} shots x "
                     f"{mpc.horizon * model.integration_steps} latent RK4 steps) {select_s:.4f} s; "
                     f"{WINDOWS} of them {WINDOWS * select_s:.3f} s of the {episode_s:.3f} s episode")

    # the episode's decisions on the kernel route are the plain route's: 3 actions from the same state and draws, each selection
    # made on each route's own state and its window taken on that route
    plain_step = make_env_step_fused(env, plain=True)
    st_k = st_p = start
    same_actions = same_states = 0
    for i in range(3):
        a_k, _ = mpc(env, st_k, torch.Generator(device=dev).manual_seed(40 + i))
        a_p, _ = mpc(env, st_p, torch.Generator(device=dev).manual_seed(40 + i))
        same_actions += all(torch.equal(x, y) for x, y in zip(tree_leaves(a_k), tree_leaves(a_p)))
        st_k, _ = step(st_k, a_k)
        st_p, _ = plain_step(st_p, a_p)
        same_states += int(torch.equal(st_k.wave, st_p.wave))
    log("main path", f"3 MPC actions on the kernel route and on the plain route: the same action in "
                     f"{same_actions} of 3, the same frames bit for bit after {same_states} of 3")
    check(same_actions == 3 and same_states == 3,
          "the MPC episode takes the plain route's actions and states on the kernel route")

    # the simulator alone, 20 windows, with the split d/dx (K5, the default)
    # and the exact one (K2), each by default (None: one launch a step at the
    # JAX window's step times) and at SPC steps a launch, in turns
    acts = [policy(gen) for _ in range(WINDOWS)]
    start_sim = env_reset(env, torch.Generator(device=dev).manual_seed(5))
    modes = [(True, None), (True, SPC), (False, None), (False, SPC)]
    steps_by_mode = {m: make_env_step_fused(env, x_matmul=m[0], steps_per_call=m[1])
                     for m in modes}
    steps_by_mode[(True, None)] = step  # the default
    finals = {}
    sim_s, sim_counts = {m: [] for m in modes}, {}
    for m in modes + modes[::-1]:
        st = start_sim
        fk.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.time()
        for a in acts:
            st, _ = steps_by_mode[m](st, a)
        torch.cuda.synchronize()
        sim_s[m].append(time.time() - t)
        sim_counts[m] = dict(fk.launch_counts)
        finals[m] = st.wave
        check(bool(torch.isfinite(st.signal).all()), "simulator-only run is finite")
    log("main path", f"simulator alone, {WINDOWS * STEPS} steps, in turns: "
        + "; ".join(f"{'split d/dx (K5)' if xm else 'exact (K2)'}, "
                    + (f"{spc} steps a launch " if spc else "by default (one step a launch) ")
                    + ", ".join(f"{s:.4f} s = {WINDOWS * STEPS / s:.1f} steps/s"
                                for s in sim_s[(xm, spc)])
                    for xm, spc in modes))
    for xm, spc in modes:
        key, per = fk.step_key(False, xm, True, spc or 1), spc or 1
        check(sim_counts[(xm, spc)] == {**dict.fromkeys(sim_counts[(xm, spc)], 0),
                                        key: expect_steps // per, "select_owner": WINDOWS},
              f"the simulator run launches {key} {expect_steps // per} times (a launch a call of "
              f"{per} steps) and the owner pass a window, nothing else")
    for xm in (True, False):
        check(torch.equal(finals[(xm, None)], finals[(xm, SPC)]),
              f"the simulator's frames at {SPC} steps a launch are the default's bit for bit "
              f"(x_matmul={xm})")

    # the general kernels: a position-design episode and one K = 4 re-rank
    # window there, each with the split d/dx (K5) and the exact one (K1, K3)
    pos_env = build_env(position_space(space), dev)
    check(not radii_only_ok(pos_env.design_space), "moving cylinders take the general kernel")
    pos_policy = RandomDesignPolicy(pos_env.action_space)
    pos_windows = 2
    rerank_k = 4
    pos_counts, roll_counts = {}, {}
    for xm in (True, False):
        for spc in (SPC, None):  # SPC steps a launch, and the default (one launch a step)
            per = spc or 1
            single, batched = fk.step_key(False, xm, False, per), fk.step_key(True, xm, False, per)
            pos_step = make_env_step_fused(pos_env, x_matmul=xm, steps_per_call=spc)
            pgen = torch.Generator(device=dev).manual_seed(6)
            pst = env_reset(pos_env, pgen)
            fk.reset_launch_counts()
            for _ in range(pos_windows):
                pst, _ = pos_step(pst, pos_policy(pgen))
            torch.cuda.synchronize()
            pos_counts[(xm, spc)] = dict(fk.launch_counts)
            check(pos_counts[(xm, spc)][single] == pos_windows * STEPS // per,
                  f"{pos_windows * STEPS // per} {single} launches (one a call of {per} steps)")
            check(bool(torch.isfinite(pst.signal).all()), "position-design signal is finite")
            log("main path", f"position-design episode, {pos_windows} windows, x_matmul={xm}, "
                             f"{per} steps a launch: launches {pos_counts[(xm, spc)]}")

            roll = make_rerank_rollout(pos_env, 1, x_matmul=xm, steps_per_call=spc)
            elite = pos_env.action_space.sample(pgen, batch=(rerank_k, 1))
            t_pos = env_time(pos_env, pst)
            fk.reset_launch_counts()
            pos_costs = roll(pst, elite, t_pos)
            torch.cuda.synchronize()
            roll_counts[(xm, spc)] = dict(fk.launch_counts)
            check(roll_counts[(xm, spc)][batched] == STEPS // per,
                  f"{STEPS // per} {batched} launches (one a call of {per} steps)")
            check(tuple(pos_costs.shape) == (rerank_k,) and bool(torch.isfinite(pos_costs).all()),
                  "position-design re-rank costs are finite")
            log("main path", f"position-design re-rank window, K = {rerank_k}, x_matmul={xm}, "
                             f"{per} steps a launch: launches {roll_counts[(xm, spc)]}")
        key = "k5bg" if xm else "k3g"
        k3[key], k3[key + "_dev"], multi[fk.step_key(True, xm, False, SPC)] = \
            batched_general_kernel(pos_env, pst, elite, t_pos, dev, xm)

    # 5. the hybrid controller
    hyb_counts, exact_rerank_counts, rerank_spc_counts, hyb_action_s = hybrid_episode(
        env, env_lo, space, dev)

    # 6. the y-sharded rollout through K4, at 700^2 from phase 3's state
    k4, k4_counts = sharded_phase(env, state, nxt, cyl, moved, tspan, dev, k2_ms)
    k4xm, k4xm_counts = sharded_xmatmul_phase(env, state, cyl, moved, tspan, dev)
    k4spc = sharded_multi_step_phase(env, state, cyl, moved, tspan, dev)

    # 7. datagen at bench.py's operating point, through K5
    import tempfile

    data_tmp = tempfile.TemporaryDirectory()
    dg_counts, dg_eps = datagen_phase(dev, k5_dev, os.path.join(data_tmp.name, "cli"))

    # 8. the record controllers: CEM + polish, the one-shot policy, the
    # hybrid with a CEM searcher, the MPC CLI
    record_controllers_phase(env, env_lo, space, dev)

    # 9. training the flagship at full width on phase 7's episodes
    train_phase(dev, dg_eps, os.path.join(data_tmp.name, "cli"), smi, args.save_train_batch)

    # 10. exact search and the distillation pipeline
    oracle_counts, oracle_shape = distillation_phase(env, env_lo, space, dev, dg_eps,
                                       os.path.join(data_tmp.name, "cli"), smi)

    # 11. the NODE and PINN baselines
    baselines_phase(env, dev, dg_eps, os.path.join(data_tmp.name, "cli"), smi)

    # 12. data-parallel training and the bf16 options
    dp_bf16_phase(env, dev, dg_eps, os.path.join(data_tmp.name, "cli"), smi)
    data_tmp.cleanup()

    # 13. full-field rollouts, flux and the device half of every drawing path
    ff_counts = full_field_phase(env, state, pos_env, model, dev)

    # 14. the long tail: the one-call hybrid episode, batched datagen on the
    # batched exact kernel, the 3-D and extra dynamics, the debug and
    # profiling scopes
    fe_counts, bd_counts, k3_row, bown_row = long_tail_phase(env, env_lo, dev, hyb_action_s)

    # 15. the port's counterparts of `__graft_entry__.py`'s entry points
    ep_counts = entry_points_phase(dev)

    src = "waves_jl_tpu_torch/csrc/fused_rk4.cu"
    src_multi = "waves_jl_tpu_torch/csrc/fused_rk4_multi.cu"
    # the TPU kernel's sub-step loop, which the multi-step rows port
    substeps = "waves_jl_tpu/ops/pallas_fd.py:359"

    def row(name, source, replaces, launches, numbers, device_only, spc=1, **extra):
        err, ms, plain, bnd = numbers[:4]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                "device_ms": device_only, "steps_per_call": spc, "on_main_path": True, **extra}

    def multi_row(key, probe_launches, numbers, replaces=substeps, **extra):
        """A row of `rk4_steps_tiled`, which no default path launches: its
        `launches` on the main paths are 0, and `probe_launches` are those
        of the run that asked for its steps a launch."""
        spc = int(key.rsplit("_spc", 1)[1])
        return {**row(key, src_multi, replaces, 0, numbers, numbers[4], spc, **extra),
                "on_main_path": False, "probe_launches": probe_launches}

    def shape_entry(shape, launches, numbers, device_only):
        err, ms, plain, bnd = numbers[:4]
        return {"shape": shape, "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1], "device_ms": device_only}

    # one step a launch (`rk4_step_tiled`), every default path's; launches
    # from the main-path runs: K2 from the exact simulator run and phase 13's
    # full-field runs, K1 and K3 general from the position-design runs at
    # x_matmul=False (K1 also from phase 13), K3 radii-only from the hybrid's
    # exact re-rank and batched datagen, K5 from datagen, the position-design
    # runs and the fused hybrid episode; `ms` and the bound are a step's
    rerank_shape = f"{TOPK}x{SIZE_RERANK}^2"
    k3b, k5b, ownb = ("fused_rk4_batched_radii_only", "fused_rk4_batched_xmatmul_radii_only",
                      "select_owner_batched")
    kernels = [
        row("fused_rk4_radii_only", src, "waves_jl_tpu/ops/pallas_fd.py:432",
            sim_counts[(False, None)]["fused_rk4_radii_only"]
            + ff_counts.get("fused_rk4_radii_only", 0), (k2_abs, k2_ms, k2_plain, k2_bound),
            k2_dev),
        row("select_owner", src, "waves_jl_tpu/ops/pallas_fd.py:247",
            mpc_counts["select_owner"] + ff_counts.get("select_owner", 0)
            + fe_counts["select_owner"],
            (owner_err, own_ms, own_plain, own_bound), own_dev),
        row("fused_rk4_general", src, "waves_jl_tpu/ops/pallas_fd.py:432",
            pos_counts[(False, None)]["fused_rk4_general"]
            + ff_counts.get("fused_rk4_general", 0), (k1_abs, k1_ms, k1_plain, k1_bound), k1_dev),
        row("fused_rk4_xmatmul_radii_only", src, "waves_jl_tpu/ops/pallas_fd.py:278",
            dg_counts["fused_rk4_xmatmul_radii_only"] + fe_counts["fused_rk4_xmatmul_radii_only"],
            (xm_abs[True], k5_ms, k5_plain, k5_bound), k5_dev),
        row("fused_rk4_xmatmul_general", src, "waves_jl_tpu/ops/pallas_fd.py:278",
            pos_counts[(True, None)]["fused_rk4_xmatmul_general"],
            (xm_abs[False], k5g_ms, k5g_plain, k5g_bound), k5g_dev),
        # the batched rows run several shapes on the main paths: the row's
        # own numbers are phase 3's 16 x 350^2 (the hybrid's), and `shapes`
        # splits its launches and gives each shape its numbers: batched K5
        # and its owner pass also run the oracle's 64 x 700^2, K3 radii-only
        # and the owner pass the batched datagen's 10 x 700^2
        row(k3b, src, "waves_jl_tpu/ops/pallas_fd.py:162",
            exact_rerank_counts[k3b] + bd_counts[k3b], k3["k3"], k3["k3_dev"], shape=rerank_shape,
            shapes=[shape_entry(rerank_shape, exact_rerank_counts[k3b], k3["k3"], k3["k3_dev"]),
                    k3_row]),
        row(ownb, src, "waves_jl_tpu/ops/pallas_fd.py:247",
            hyb_counts[ownb] + oracle_counts[ownb] + fe_counts[ownb] + bd_counts[ownb], k3["own"],
            k3["own_dev"], shape=rerank_shape,
            shapes=[shape_entry(rerank_shape, hyb_counts[ownb] + fe_counts[ownb], k3["own"],
                                k3["own_dev"]),
                    shape_entry(oracle_shape["shape"], oracle_counts[ownb], oracle_shape["own"],
                                oracle_shape["own"][4]),
                    bown_row]),
        row("fused_rk4_batched_general", src, "waves_jl_tpu/ops/pallas_fd.py:162",
            roll_counts[(False, None)]["fused_rk4_batched_general"], k3["k3g"], k3["k3g_dev"]),
        row(k5b, src, "waves_jl_tpu/ops/pallas_fd.py:278",
            hyb_counts[k5b] + oracle_counts[k5b] + fe_counts[k5b], k3["k5b"], k3["k5b_dev"],
            shape=rerank_shape,
            shapes=[shape_entry(rerank_shape, hyb_counts[k5b] + fe_counts[k5b], k3["k5b"],
                                k3["k5b_dev"]),
                    shape_entry(oracle_shape["shape"], oracle_counts[k5b], oracle_shape["k5b"],
                                oracle_shape["k5b"][4])]),
        row("fused_rk4_batched_xmatmul_general", src, "waves_jl_tpu/ops/pallas_fd.py:278",
            roll_counts[(True, None)]["fused_rk4_batched_xmatmul_general"], k3["k5bg"],
            k3["k5bg_dev"]),
    ]
    # SPC and four steps a launch (`rk4_steps_tiled`), asked for: `ms`, the
    # plain version and the bound are a launch's; `probe_launches` from the
    # simulator and position-design runs at SPC (phase 4), the hybrid's
    # re-rank in turns (phase 5), and phase 3's windows for K3 and the
    # four-step instance
    k5s, k2s, k1s, k5gs = (fk.step_key(False, xm, radii, SPC)
                           for xm, radii in ((True, True), (False, True), (False, False),
                                             (True, False)))
    k3s, k5bs, k3gs, k5bgs = (fk.step_key(True, xm, radii, SPC)
                              for xm, radii in ((False, True), (True, True), (False, False),
                                                (True, False)))
    k5_probe = fk.step_key(False, True, True, 4)
    kernels += [
        multi_row(k5s, sim_counts[(True, SPC)][k5s], multi[k5s]),
        multi_row(k2s, sim_counts[(False, SPC)][k2s], multi[k2s]),
        multi_row(k1s, pos_counts[(False, SPC)][k1s], multi[k1s]),
        multi_row(k5gs, pos_counts[(True, SPC)][k5gs], multi[k5gs]),
        multi_row(k3s, k3["spc"][k3s][5], k3["spc"][k3s], shape=rerank_shape),
        multi_row(k5bs, rerank_spc_counts[k5bs], k3["spc"][k5bs], shape=rerank_shape,
                  shapes=[shape_entry(rerank_shape, 0, k3["spc"][k5bs], k3["spc"][k5bs][4]),
                          shape_entry(oracle_shape["shape"], 0, oracle_shape["k5b_spc"],
                                      oracle_shape["k5b_spc"][4])]),
        multi_row(k3gs, roll_counts[(False, SPC)][k3gs], multi[k3gs], shape=f"4x{SIZE}^2"),
        multi_row(k5bgs, roll_counts[(True, SPC)][k5bgs], multi[k5bgs], shape=f"4x{SIZE}^2"),
        # four steps a launch: the probe of temporal blocking's instance, the
        # JAX package's steps_per_call=4 with ghost=16
        multi_row(k5_probe, multi[k5_probe][5], multi[k5_probe],
                  replaces="scripts_tpu/kernel_probe.py:98"),
    ]
    # the slabs at two and four steps a launch (`y_ghost >= HALO * spc`):
    # phase 6's 4-shard rollouts and one launch of the 4 stacked slabs
    kernels += [multi_row(key, numbers[5], numbers, replaces="waves_jl_tpu/ops/pallas_fd.py:157",
                          shape=f"{4}x{SIZE}^2")
                for key, numbers in k4spc.items()]
    sharded_rows = (
        ("fused_rk4_sharded_radii_only", "waves_jl_tpu/ops/pallas_fd.py:195", "radii"),
        ("select_owner_sharded", "waves_jl_tpu/ops/pallas_fd.py:247", "owner"),
        ("fused_rk4_sharded_general", "waves_jl_tpu/ops/pallas_fd.py:195", "general"),
    )
    # the dry run's owner passes (phase 15) join the slabs' owner row
    k4_counts["owner"] += ep_counts["select_owner_sharded"]
    for name, replaces, key in sharded_rows:
        err, ms, dev_only, plain, bnd = k4[key]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": k4_counts[key], "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                        "device_ms": dev_only, "steps_per_call": 1, "on_main_path": True})
    # and its K4-XM launches the split slabs' radii-only row
    k4xm_counts["radii"] += ep_counts["fused_rk4_sharded_xmatmul_radii_only"]
    for name, key in (("fused_rk4_sharded_xmatmul_radii_only", "radii"),
                      ("fused_rk4_sharded_xmatmul_general", "general")):
        err, ms, dev_only, plain, bnd = k4xm[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": "waves_jl_tpu/parallel/fused_domain.py:62",
                        "launches": k4xm_counts[key], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                        "library_ms": None, "device_ms": dev_only, "steps_per_call": 1,
                        "on_main_path": True})
    for k in kernels:
        if k["on_main_path"]:
            check(k["launches"] > 0, f"{k['name']} was launched on its path's run")
        else:
            check(k["launches"] == 0 and k["probe_launches"] > 0,
                  f"{k['name']} was launched where asked for, and by no default path")
        for entry in (k, *k.get("shapes", ())):
            check(all(isinstance(v, (int, float)) and math.isfinite(v)
                      for key, v in entry.items()
                      if key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "device_ms")),
                  f"{k['name']} {entry.get('shape', '')} has finite numbers")
    log("done", f"whole run {time.time() - T0:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
