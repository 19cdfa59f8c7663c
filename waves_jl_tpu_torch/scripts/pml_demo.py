"""Free-field PML demo (the port of `scripts_tpu/pml_demo.py`): a pulse at
the origin propagates with no design and the PML absorbs the outgoing wave:

    python -m waves_jl_tpu_torch.scripts.pml_demo --n 256 --steps 500 --out pml.mp4

The rollout is the plain `Integrator` over the 12-channel acoustic system
on the card, as the JAX script's XLA integrator runs it; the energy's peak
and its final share are printed. `--out` draws a video (needs matplotlib).
`--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

from waves_jl_tpu_torch.constants import WATER
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.dims import build_grid, build_wave, two_dim
from waves_jl_tpu_torch.physics.dynamics import (Integrator, build_tspan,
                                                 make_acoustic_dynamics_2d)
from waves_jl_tpu_torch.sources import Source
from waves_jl_tpu_torch.utils.gaussians import build_normal

FRAME_EVERY = 10  # steps between video frames


@torch.no_grad()
def pml_rollout(n: int = 256, steps: int = 500, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """(frames (steps // 10 + 1, n, n): the displacement every 10 steps,
    energies (steps + 1,): the sum of its square at every step) of a free
    field from rest under a 1 kHz Gaussian pulse at the origin, on the host."""
    dev = resolve_device(device)
    dim = two_dim(15.0, n, device=dev)
    it = Integrator(dynamics=make_acoustic_dynamics_2d(dim, WATER, 2.0, 20000.0), dt=1e-5)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    src = Source(shape=build_normal(build_grid(dim), f32([[0.0, 0.0]]), f32([0.3]), f32([1.0])),
                 freq=f32(1000.0))
    speed = f32(WATER)
    theta = (lambda t: speed, src)
    u = build_wave(dim, 12)
    frames, energies = [u[0].clone()], [torch.sum(u[0] ** 2)]
    for k, t in enumerate(build_tspan(0.0, 1e-5, steps)[:-1]):
        u = it.step(u, t, theta)
        energies.append(torch.sum(u[0] ** 2))
        if (k + 1) % FRAME_EVERY == 0:
            frames.append(u[0].clone())
    return torch.stack(frames).cpu().numpy(), torch.stack(energies).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--out", default=None, help="video path (none by default)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    frames, e = pml_rollout(args.n, args.steps, args.device)
    print(f"energy peak {e.max():.4g}, final {e[-1]:.4g} "
          f"({e[-1] / e.max():.1%} of peak — PML absorbs)", flush=True)
    if args.out:
        from waves_jl_tpu_torch.viz.plot import render_video

        render_video(frames, (-15.0, 15.0, -15.0, 15.0), args.out, bound=0.5)
        print(f"wrote {args.out}")
    return frames, e


if __name__ == "__main__":
    main()
