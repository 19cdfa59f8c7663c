"""Time a step of each fused RK4 mode on the card, to compare two checkouts.

    python waves_jl_tpu_torch/scripts/kernel_times.py [--root DIR] [--out FILE]

imports `waves_jl_tpu_torch` from the checkout at DIR (by default the one
this file lies in), so that one copy of the script times an older
checkout's kernels and a newer one's in one call, in turns. At the main
paths' shapes, on the same seeded inputs in every checkout:

* one state at 700^2: K2 and K5 radii-only on the triple ring's
  cylinders, K1 and K5 general on the same cylinders moving by (0.3, -0.2)
  within the window;
* K3 and batched K5 radii-only with 16 candidates at 350^2, K3 general and
  batched K5 general with 4 candidates at 700^2 (the position-design
  re-rank window's size), each candidate's radii its own;
* one step of the 4 slabs of a 700^2 grid (K4, K4-XM), radii-only and
  general: stacked in one launch (`fused_rk4_step_slabs`) where the
  checkout has it, else slab by slab as its wrapper takes them;
* the 4-shard radii-only sharded rollout at 700^2 on one card
  (`make_fused_sharded_rollout`, exact and split d/dx), ms a step of a
  100-step rollout;
* the radii-only owner pass, ms a pass: on the whole grid at 700^2 on the
  triple ring's cylinders, batched for 16 candidates at 350^2 with
  radii of their own, and on the 4 slabs of a 700^2 grid: in one launch
  (`select_owner_slabs`) where the checkout has it, else slab by slab.

With --cards C it times the sharded rollouts alone, with C shards: on one
card, and one shard a card on C cards; with --steps-per-call S [S ...] as
well, the stacked rollout (`build_stacked_rollout(..., steps_per_call=S)`,
slabs with a 4 S-column halo exchanged once a call) at each S in the order
given, on the same call times (call c from step c S, its sub-steps at the
JAX kernel's times), for K4 and K4-XM radii-only.

With --steps-per-call S [S ...] alone (the counterpart of the JAX package's
`scripts_tpu/kernel_probe.py`, which times one, two and four steps a
Pallas call) it times the whole-grid modes alone at those steps a launch,
in the order given (`--steps-per-call 1 2 4 4 2 1` takes them in turns):
K5 and K2 radii-only and K5 general and K1 at 700^2, batched K5 and K3
radii-only with 16 candidates at 350^2, batched K5 general and K3 general
with 4 at 700^2, each through `fused_rk4_window(..., steps_per_call=S)` at
the sub-step times: ms a step of a host-driven 100-step window and its
steps/s ("ms", "steps_per_s"), and ms a step of device work in a 20-step
window queued behind a device sleep ("device_ms"). The checkout must have
`steps_per_call`.

For each row it gives ms a step with CUDA events around calls as the host
drives them ("ms"), the same calls queued behind a device sleep
("device_ms"; for a rollout, a 10-step one, 20 steps with --steps-per-call, its setup
included), both
with `chip_smoke.py`'s timers, and for the whole grid ms a step of device
work inside a 20-step window driven by `fused_rk4_window`
("window_device_ms"). It prints a line a row and, last, one JSON object with the card's name and
power limit, and writes that object to FILE if given. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # checkout
N, N_RERANK, K_GENERAL, K_RADII, SHARDS = 700, 350, 4, 16, 4
T0, TI, TF, DT = 2e-4, 0.0, 1e-3, 1e-5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose waves_jl_tpu_torch to time")
    parser.add_argument("--out", help="also write the JSON object here")
    parser.add_argument("--cards", type=int,
                        help="time the sharded rollouts alone, this many shards on one card "
                             "and one a card on this many cards")
    parser.add_argument("--steps-per-call", type=int, nargs="+", metavar="S",
                        help="time the whole-grid modes alone at these steps a launch, in turns")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, device_ms  # this checkout's timers, whichever port is timed

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.ops import fused_rk4 as fk
    from waves_jl_tpu_torch.parallel import make_fused_sharded_rollout, make_mesh
    from waves_jl_tpu_torch.parallel.fused_domain import cut_slabs, shard_slabs
    try:
        from waves_jl_tpu_torch.parallel.fused_domain import build_stacked_rollout
    except ImportError:  # a checkout from before the stacked rollout
        build_stacked_rollout = None
    from waves_jl_tpu_torch.physics.fused import cyl_params

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(11)

    def on_card(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    def config(n):
        return fk.StepConfig(n=n, spacing=30.0 / (n - 1), x_min=-15.0, dt=DT, c0=1531.0,
                             freq=1000.0)

    space = build_triple_ring_design_space(device=dev)
    ring = cyl_params(space.low, space.high, dev).cpu().numpy()  # radii low to high, fixed places
    moved = ring.copy()
    moved[4] += 0.3  # the cylinders move within the window
    moved[5] -= 0.2

    def candidates(cyl, k):
        c = np.repeat(cyl[None], k, axis=0)
        c[:, [2, 6]] *= rng.uniform(0.7, 1.0, (k, 1, cyl.shape[-1]))
        return on_card(c)

    times = [float(np.float32(T0) + np.float32(s * DT)) for s in range(20)]
    rows = {}

    def finish() -> int:
        result = {"root": root, "card": smi, "rows": rows}
        print(json.dumps(result), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f)
        return 0

    def window_times(spc, steps):
        calls = [float(np.float32(T0) + np.float32(c * spc * DT)) for c in range(steps // spc)]
        return fk.call_step_times(calls, spc, DT)

    def run_key(key):
        """key, or key with its run's number where an earlier run has it."""
        return key + (f" run {sum(r.startswith(key) for r in rows) + 1}" if key in rows else "")

    if args.steps_per_call and not args.cards:
        modes = (("K5 radii-only", "K2", N, None, ring), ("K5 general", "K1", N, None, moved),
                 ("batched K5", "K3", N_RERANK, K_RADII, ring),
                 ("batched K5 general", "K3 general", N, K_GENERAL, moved))
        for split_name, exact_name, n, k, cyl_np in modes:
            cfg = config(n)
            lead = () if k is None else (k,)
            u = on_card(rng.standard_normal((*lead, 12, n, n)) * 1e-3)
            shape, prof = on_card(rng.random((n, n))), on_card(rng.random(n) * 100.0)
            cyl = on_card(cyl_np) if k is None else candidates(cyl_np, k)
            owner = None
            if cyl_np is ring:
                owner = (fk.select_owner(cyl, cfg) if k is None
                         else fk.select_owner_batched(cyl, cfg))
            for xm, name in ((True, split_name), (False, exact_name)):
                for spc in args.steps_per_call:
                    def run(ts, spc=spc, xm=xm):
                        return fk.fused_rk4_window(u, shape, prof, cyl, owner, ts, TI, TF, cfg,
                                                   [len(ts) - 1], xm, steps_per_call=spc)

                    t100, t20 = window_times(spc, 100), window_times(spc, 20)
                    ms = cuda_ms(lambda: run(t100), 3) / 100
                    key = run_key(f"{name} spc{spc}")
                    rows[key] = {"steps_per_call": spc, "ms": ms, "steps_per_s": 1e3 / ms,
                                 "device_ms": device_ms(lambda: run(t20), 1) / 20}
                    print(key, json.dumps(rows[key]), flush=True)
        return finish()

    def row(name, step, window=None, reps=20):
        rows[name] = {"ms": cuda_ms(step, reps), "device_ms": device_ms(step, reps)}
        if window is not None:
            rows[name]["window_device_ms"] = device_ms(window, 1) / len(times)
        print(name, json.dumps(rows[name]), flush=True)

    for n, k_radii in () if args.cards else ((N, None), (N_RERANK, K_RADII)):
        cfg = config(n)
        lead = () if k_radii is None else (k_radii,)
        u = on_card(rng.standard_normal((*lead, 12, n, n)) * 1e-3)
        shape, prof = on_card(rng.random((n, n))), on_card(rng.random(n) * 100.0)
        if k_radii is None:
            cyl = on_card(ring)
            owner = fk.select_owner(cyl, cfg)
            step = fk.fused_rk4_step
            names = {False: "K2", True: "K5"}
            row("owner whole grid", lambda: fk.select_owner(cyl, cfg))
        else:
            cyl = candidates(ring, k_radii)
            owner = fk.select_owner_batched(cyl, cfg)
            step = fk.fused_rk4_step_batched
            names = {False: "K3", True: "batched K5"}
            row(f"owner batched {k_radii}", lambda: fk.select_owner_batched(cyl, cfg))
        for xm in (False, True):
            row(names[xm], lambda: step(u, shape, prof, cyl, owner, T0, TI, TF, cfg, x_matmul=xm),
                lambda: fk.fused_rk4_window(u, shape, prof, cyl, owner, times, TI, TF, cfg,
                                            [len(times) - 1], xm))

    cfg = config(N)
    shape, prof = on_card(rng.random((N, N))), on_card(rng.random(N) * 100.0)
    for k in () if args.cards else (None, K_GENERAL):
        lead = () if k is None else (k,)
        u = on_card(rng.standard_normal((*lead, 12, N, N)) * 1e-3)
        cyl = on_card(moved) if k is None else candidates(moved, k)
        step = fk.fused_rk4_step if k is None else fk.fused_rk4_step_batched
        names = ({False: "K1", True: "K5 general"} if k is None
                 else {False: "K3 general", True: "batched K5 general"})
        for xm in (False, True):
            row(names[xm], lambda: step(u, shape, prof, cyl, None, T0, TI, TF, cfg, x_matmul=xm),
                lambda: fk.fused_rk4_window(u, shape, prof, cyl, None, times, TI, TF, cfg,
                                            [len(times) - 1], xm))

    slabs = shard_slabs(N, SHARDS)
    u = on_card(rng.standard_normal((12, N, N)) * 1e-3)
    us, sh = cut_slabs(u, slabs, [dev] * SHARDS), cut_slabs(shape, slabs, [dev] * SHARDS)
    stacked = hasattr(fk, "fused_rk4_step_slabs")
    if not args.cards:
        cyl = on_card(ring)
        if hasattr(fk, "select_owner_slabs"):
            row(f"owner {SHARDS} slabs", lambda: fk.select_owner_slabs(cyl, cfg, slabs))
        else:
            row(f"owner {SHARDS} slabs", lambda: [fk.select_owner(cyl, cfg, s) for s in slabs])
    for radii, cyl_np in () if args.cards else ((True, ring), (False, moved)):
        cyl = on_card(cyl_np)
        owners = ([fk.select_owner(cyl, cfg, s) for s in slabs] if radii else [None] * SHARDS)
        for xm in (False, True):
            name = ("K4-XM" if xm else "K4") + (" radii-only" if radii else " general")
            if stacked:
                us_s, sh_s = torch.stack(us), torch.stack(sh)
                own_s = torch.stack(owners) if radii else None
                row(name, lambda: fk.fused_rk4_step_slabs(us_s, sh_s, prof, cyl, own_s, T0, TI,
                                                          TF, cfg, slabs, xm))
            else:
                row(name, lambda: [fk.fused_rk4_step(u_k, h, prof, cyl, o, T0, TI, TF, cfg, s, xm)
                                   for u_k, h, o, s in zip(us, sh, owners, slabs)])

    # the sharded rollout: 100 steps host-driven, 20 steps queued behind a
    # device sleep (10 where no steps a launch are asked for), on one card
    # and, if asked, one shard a card
    cyl = on_card(ring)
    meshes = [make_mesh(devices=[dev] * (args.cards or SHARDS))]
    if (args.cards or 1) > 1:
        meshes.append(make_mesh(args.cards))
    for mesh in meshes:
        where = f", {mesh.size} cards" if len(set(mesh.devices)) > 1 else ""
        for spc in (args.steps_per_call if args.cards and args.steps_per_call else [None]):
            short = 10 if spc is None else 20
            times = window_times(spc or 1, 100)
            tspan = np.array(times + [float(np.float32(times[-1]) + np.float32(DT))], np.float32)
            for xm in (False, True):
                if spc is None:
                    roll = make_fused_sharded_rollout(mesh, N, cfg.spacing, DT, cfg.c0, cfg.freq,
                                                      cyl.shape[1], cfg.x_min, radii_only=True,
                                                      x_matmul=xm)
                else:
                    roll = build_stacked_rollout(mesh, cfg, cyl.shape[1], True, xm, spc)
                name = run_key(f"rollout {mesh.size} shards {'K4-XM' if xm else 'K4'} radii-only"
                               + ("" if spc is None else f" spc{spc}") + where)
                rows[name] = {"ms": cuda_ms(lambda: roll(u, tspan, cyl, shape, prof), 3) / 100,
                              "device_ms": device_ms(
                                  lambda: roll(u, tspan[:short + 1], cyl, shape, prof), 1) / short}
                if spc is not None:
                    rows[name]["steps_per_call"] = spc
                print(name, json.dumps(rows[name]), flush=True)
    return finish()


if __name__ == "__main__":
    sys.exit(main())
