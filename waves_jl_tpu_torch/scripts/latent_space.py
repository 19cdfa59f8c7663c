"""Real-against-latent dashboard (the port of `scripts_tpu/latent_space.py`):
roll one random-policy episode of the env on the card through the fused
kernel, run the surrogate over the same initial observation, design and
actions, and draw the real and latent scattered energies together and the
latent scattered field as a line video:

    python -m waves_jl_tpu_torch.scripts.latent_space \\
        --checkpoint models/ref500_h8s4/checkpoint_step=2600 --latent-stride 4 --actions 20

The MSE between the two energy signals at the latent time steps is printed.
Drawing needs matplotlib. `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch

from waves_jl_tpu_torch.data import generate_episode_fused
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.device import resolve_device
from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.physics.fused import make_env_step_fused
from waves_jl_tpu_torch.scripts.datagen import build_env
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
from waves_jl_tpu_torch.utils.interp import flatten_repeated_last_dim
from waves_jl_tpu_torch.utils.trees import tree_map


@torch.no_grad()
def latent_comparison(env, model, generator: torch.Generator, stride: int = 1) -> dict:
    """One episode of env.actions random actions from a reset, through the
    fused step, and the surrogate's prediction over it. Returns, on the
    host: t (L,) and y (L, 3) the real joined times and energies, t_lat and
    y_hat (L', 3) the surrogate's at every stride-th time, z (L', 4, E) its
    latent trajectory, latent_x, and mse, the mean squared difference of the
    energies at the latent times."""
    state = env_reset(env, generator)
    _, ep = generate_episode_fused(env, RandomDesignPolicy(env.action_space), generator,
                                   make_env_step_fused(env), state=state)
    y = flatten_repeated_last_dim(torch.movedim(ep.y, -1, 0)).T  # (L, 3)
    t = flatten_repeated_last_dim(ep.s_tspan)  # (L,)
    batch = {"s_wave": ep.s_wave[:1], "s_design": tree_map(lambda x: x[:1], ep.s_design),
             "a": tree_map(lambda x: x[None], ep.a), "t": t[::stride][None]}
    y_hat = model(batch)[0]
    z = model.generate_latent_solution(batch)[:, 0]
    mse = float(torch.mean((y[::stride] - y_hat) ** 2))
    host = {k: v.cpu().numpy() for k, v in
            {"t": t, "y": y, "y_hat": y_hat, "z": z, "latent_x": model.latent_dim.x}.items()}
    return {**host, "t_lat": host["t"][::stride], "mse": mse}


def draw_dashboard(r: dict, out: str) -> None:
    """real_vs_latent_sc.png and the latent scattered-field video
    latent_sc.mp4 (at most about 240 frames) in `out`."""
    from waves_jl_tpu_torch.viz.plot import pyplot, render_line_video

    plt = pyplot()
    fig, ax = plt.subplots()
    ax.plot(r["t"], r["y"][:, 2], color="blue", label="Real")
    ax.plot(r["t_lat"], r["y_hat"][:, 2], color="green", alpha=0.7, label="Latent (surrogate)")
    ax.set_title("Real vs Latent Scattered Energy over Time")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Energy")
    ax.legend()
    fig.savefig(os.path.join(out, "real_vs_latent_sc.png"), dpi=120)
    plt.close(fig)
    sc = r["z"][:, 0] - r["z"][:, 2]
    render_line_video(r["latent_x"], sc[::max(1, len(sc) // 240)],
                      os.path.join(out, "latent_sc.mp4"))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", default=None,
                   help="unused (the dashboard rolls its own episode); kept for the JAX "
                        "CLI's launchers")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--actions", type=int, default=20)
    p.add_argument("--out", default="dashboard")
    p.add_argument("--n", type=int, default=700)
    p.add_argument("--h-size", type=int, default=256)
    p.add_argument("--nfreq", type=int, default=500)
    p.add_argument("--elements", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--latent-stride", type=int, default=1,
                   help="latent-dt coarsening of the checkpoint, as it was trained")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    stride = args.latent_stride
    env = build_env(args.n, 100, args.actions, dev)
    model = AcousticEnergyModel(build_triple_ring_design_space(device=dev), 1000.0,
                                elements=args.elements, h_size=args.h_size, nfreq=args.nfreq,
                                integration_steps=env.integration_steps // stride,
                                dt=1e-5 * stride, device=dev)
    load_model_checkpoint(model, args.checkpoint)
    r = latent_comparison(env, model, torch.Generator(device=dev).manual_seed(args.seed), stride)
    print(f"real-vs-latent energy mse over {args.actions} actions: {r['mse']:.5g}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    draw_dashboard(r, args.out)
    print(f"wrote {args.out}/")
    return r


if __name__ == "__main__":
    main()
