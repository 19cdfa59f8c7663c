"""Average the parameters of a run's newest checkpoints (the port of
`scripts_tpu/avg_checkpoints.py`).

Mixed-horizon training cycles the window horizon, so the validation trace
oscillates; the mean of the iterates over the run's tail sits near the
middle of that band (stochastic weight averaging):

    python -m waves_jl_tpu_torch.scripts.avg_checkpoints --run models/run1 \\
        --last 30 --out models/run1/checkpoint_avg30

CPU only, numpy only: each params.npz is read once into a float64 running
mean, and the result is a checkpoint directory either package loads.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np


def checkpoint_steps(run_dir: str) -> list[int]:
    steps = []
    for p in glob.glob(os.path.join(run_dir, "checkpoint_step=*")):
        m = re.search(r"checkpoint_step=(\d+)$", p)
        if m and os.path.exists(os.path.join(p, "params.npz")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def average_params(run_dir: str, steps: list[int]) -> dict[str, np.ndarray]:
    """Running float64 mean over each named leaf of params.npz."""
    if not steps:
        raise ValueError("no checkpoints selected")
    acc: dict[str, np.ndarray] = {}
    for i, s in enumerate(steps):
        with np.load(os.path.join(run_dir, f"checkpoint_step={s}", "params.npz")) as z:
            for k in z.files:
                v = z[k].astype(np.float64)
                if i == 0:
                    acc[k] = v
                else:
                    acc[k] += (v - acc[k]) / (i + 1)
    return acc


def save_average(run_dir: str, steps: list[int], out_dir: str) -> None:
    acc = average_params(run_dir, steps)
    # each leaf back in the dtype of the newest member checkpoint
    with np.load(os.path.join(run_dir, f"checkpoint_step={steps[-1]}", "params.npz")) as z:
        dtypes = {k: z[k].dtype for k in z.files}
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: v.astype(dtypes[k]) for k, v in acc.items()})
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"step": int(steps[-1]), "averaged_steps": [int(s) for s in steps]}, f)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True, help="run dir holding checkpoint_step=N dirs")
    p.add_argument("--last", type=int, default=30, help="average the newest N checkpoints")
    p.add_argument("--min-step", type=int, default=0, help="ignore checkpoints below this step")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    steps = [s for s in checkpoint_steps(args.run) if s >= args.min_step][-args.last:]
    if not steps:
        raise SystemExit(f"no checkpoints under {args.run} at step >= {args.min_step}")
    print(f"averaging {len(steps)} checkpoints: steps {steps[0]}..{steps[-1]}")
    save_average(args.run, steps, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
