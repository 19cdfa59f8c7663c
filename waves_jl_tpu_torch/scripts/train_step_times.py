"""Time the flagship surrogate's latent rollout on the card, to compare two checkouts.

    python waves_jl_tpu_torch/scripts/train_step_times.py [--root DIR] [--out FILE]

imports `waves_jl_tpu_torch` from the checkout at DIR (by default the one
this file lies in), so that one copy of the script times an older
checkout and a newer one in one call, in turns. The model is the tracked
flagship (`models/ref500_h8s4/checkpoint_step=2600` of this file's
checkout: 1,024 elements, h_size 256, nfreq 500, latent stride 4), on the
same seeded inputs in every checkout:

* a training micro-step's forward and backward: 4 horizon-8 windows (201
  latent times, 200 steps), `energy_loss` with sc_weight 4, in each
  checkpoint mode ("none", "step", "sqrt");
* an MPC selection's surrogate pass: `predict_shot_energy` of 256 shots of
  5 actions (125 latent steps) from one observation;
* with `--cards N`, a whole training micro-step in "sqrt" (forward,
  backward and the Adam update) on one card, and data-parallel
  (`parallel.dp.make_dp_train_step`, the same 4 windows cut over the
  shards) on N shards of one card and, where the machine has N cards, on
  N cards, the shards issued in turn from one thread.

For each row: the median wall seconds of `--reps` calls after one warm
call, with the card synchronised around each, and the host's issue time
of the same calls. It prints a line a row and, last, one JSON object with
the card's name and power limit, and writes that object to FILE if given.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # checkout
CHECKPOINT = os.path.join(HERE, "models", "ref500_h8s4", "checkpoint_step=2600")
STEPS, STRIDE, B, H, SHOTS, SHOT_ACTIONS = 100, 4, 4, 8, 256, 5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose waves_jl_tpu_torch to time")
    parser.add_argument("--out", help="also write the JSON object here")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--cards", type=int, default=0,
                        help="also time a data-parallel micro-step on this many shards")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from waves_jl_tpu_torch.designs import build_action_space, build_triple_ring_design_space
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel, energy_loss
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    space = build_triple_ring_design_space(device=dev)
    actions = build_action_space(space.low, 0.2)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    L = H * STEPS // STRIDE + 1
    t = torch.as_tensor(np.arange(L)[None] * 1e-5 * STRIDE + 2e-3 * np.arange(B)[:, None],
                        dtype=torch.float32, device=dev)
    batch = {"s_wave": torch.as_tensor(rng.standard_normal((B, 128, 128, 4)) * 0.1,
                                       dtype=torch.float32, device=dev),
             "s_design": space.sample(gen, (B,)), "a": actions.sample(gen, (B, H)), "t": t,
             "y": torch.as_tensor(rng.uniform(0.0, 0.1, (B, L, 3)), dtype=torch.float32,
                                  device=dev)}
    Ls = SHOT_ACTIONS * STEPS // STRIDE + 1
    shot_t = torch.as_tensor(np.arange(Ls) * 1e-5 * STRIDE + 2e-3, dtype=torch.float32,
                             device=dev)[None].expand(SHOTS, -1)
    shot_a = actions.sample(gen, (SHOTS, SHOT_ACTIONS))

    def timed(fn) -> dict:
        fn()
        walls, issues = [], []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            issues.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return {"s": float(np.median(walls)), "issue_s": float(np.median(issues))}

    rows = {}
    for mode in ("none", "step", "sqrt"):
        model = AcousticEnergyModel(space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                    integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                    checkpoint=mode, device=dev)
        load_model_checkpoint(model, CHECKPOINT)
        params = list(model.parameters())

        def micro_step():
            with full_float32():
                torch.autograd.grad(energy_loss(model, batch, sc_weight=4.0), params)

        rows[f"micro-step {mode}"] = timed(micro_step)
    rows["shots 256 x 5 actions"] = timed(
        lambda: model.predict_shot_energy(batch["s_wave"][0], space.sample(gen), shot_a, shot_t))
    if args.cards:
        rows.update(dp_rows(args.cards, model, batch, timed))
    for name, row in rows.items():
        print(f"{name}: {row['s']:.4f} s (host issue {row['issue_s']:.4f} s)", flush=True)
    result = {"root": root, "card": smi, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


def dp_rows(n: int, model, batch, timed) -> dict:
    """A training micro-step ("sqrt", Adam at lr 1e-4) of `batch` on the
    model's card, and data-parallel on n shards of that card and on n
    cards where the machine has them, each side on its own replicas of
    `model`'s weights."""
    import torch

    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel, energy_loss
    from waves_jl_tpu_torch.parallel import Replicas, make_dp_train_step, make_mesh, shard_batch
    from waves_jl_tpu_torch.train.loop import make_train_step
    from waves_jl_tpu_torch.train.optim import Adam

    def replicate(device):
        m = AcousticEnergyModel(build_triple_ring_design_space(device=device), 1000.0,
                                elements=1024, h_size=256, nfreq=500,
                                integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                device=device)
        return m, lambda b: energy_loss(m, b, sc_weight=4.0)

    opt = Adam(1e-4)
    first, _ = replicate(next(model.parameters()).device)
    first.load_state_dict(model.state_dict())
    step1 = make_train_step(lambda b: energy_loss(first, b, sc_weight=4.0), opt)
    state1 = [opt.init(dict(first.named_parameters()))]

    def one():
        _, state1[0], _ = step1(first, state1[0], batch)

    rows = {"train step sqrt, 1 card": timed(one)}
    dev = str(next(model.parameters()).device)
    meshes = {f"dp train step sqrt, {n} shards on one card": make_mesh(devices=[dev] * n)}
    if n > 1 and torch.cuda.device_count() >= n:
        meshes[f"dp train step sqrt, {n} cards"] = make_mesh(n)
    for name, mesh in meshes.items():
        lead, loss0 = replicate(mesh.devices[0])
        lead.load_state_dict(model.state_dict())
        replicas = Replicas(lead, loss0, mesh, replicate)
        states = [replicas.init(opt)]
        step = make_dp_train_step(opt)
        blocks = shard_batch(batch, mesh)

        def dp_step(replicas=replicas, step=step, blocks=blocks, states=states):
            _, states[0], _ = step(replicas, states[0], blocks)

        rows[name] = timed(dp_step)
    return rows


if __name__ == "__main__":
    sys.exit(main())
