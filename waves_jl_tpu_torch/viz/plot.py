"""Drawing: episode videos, energy plots and the checkpoint dashboards
(counterpart of `waves_jl_tpu/viz/plot.py`).

What is drawn is computed on the model's device by the `*_data` functions
and pulled to the host once; the drawing is matplotlib's, imported inside
the drawing functions only, so this module imports without it. Videos go
through ffmpeg, else a GIF (Pillow), else a directory of PNG frames.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import FRAMES_PER_SECOND
from ..designs import design_to_circles

ENERGY_NAMES = ((0, "tot", "Total"), (1, "inc", "Incident"), (2, "sc", "Scattered"))


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_energy(tspan, signal, path: str, title: str = "Energy Signals in Real Dynamics"):
    """The [tot, inc, sc] energies of an episode against time."""
    plt = pyplot()
    signal = _host(signal)
    fig, ax = plt.subplots()
    for ch, color, label in ((0, "blue", "Total"), (1, "orange", "Incident"),
                             (2, "green", "Scattered")):
        ax.plot(_host(tspan), signal[:, ch], color=color, label=label)
    ax.set_title(title)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Energy")
    ax.legend(loc="lower right")
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_predicted_energy(tspan, true_energy, pred_energy, title: str, path: str):
    plt = pyplot()
    fig, ax = plt.subplots()
    ax.plot(_host(tspan), _host(true_energy), color="blue", label="True")
    ax.plot(_host(tspan), _host(pred_energy), color="orange", label="Predicted")
    ax.set_title(title)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Energy")
    ax.legend()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_field(field, extent, path: str, design=None, bound: float = 1.0, energy: bool = False):
    """One heatmap frame, the design's cylinders drawn over it."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_frame(ax, _host(field), extent, design, bound, energy)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _draw_frame(ax, field, extent, design, bound, energy):
    if energy:
        ax.imshow((field**2).T, origin="lower", extent=extent, cmap="cividis", vmin=0.0,
                  vmax=bound, aspect="equal")
    else:
        ax.imshow(field.T, origin="lower", extent=extent, cmap="RdBu", vmin=-bound, vmax=bound,
                  aspect="equal")
    if design is not None:
        from matplotlib.patches import Circle

        for (x, y, r) in design_to_circles(design):
            ax.add_patch(Circle((x, y), r, color="gray"))
    ax.set_xlabel("Space (m)")
    ax.set_ylabel("Space (m)")


def _save_animation(anim, fig, path, fps, draw, n_frames) -> str:
    """Save through ffmpeg, else as a GIF, else as up to 60 PNG frames in a
    directory; returns the path written."""
    try:
        anim.save(path, fps=fps, writer="ffmpeg")
        return path
    except Exception:
        pass
    try:
        gif = os.path.splitext(path)[0] + ".gif"
        anim.save(gif, fps=min(fps, 12), writer="pillow")
        return gif
    except Exception:
        pass
    base, _ = os.path.splitext(path)
    os.makedirs(base, exist_ok=True)
    for i in range(0, n_frames, max(1, n_frames // 60)):
        draw(i)
        fig.savefig(f"{base}/frame_{i:04d}.png", dpi=100)
    return base


def render_video(frames, extent, path: str, designs=None, fps: int = FRAMES_PER_SECOND,
                 bound: float = 1.0, energy: bool = False) -> str:
    """(T, nx, ny) frames to a video, each with its design drawn over it."""
    plt = pyplot()
    import matplotlib.animation as animation

    frames = _host(frames)
    fig, ax = plt.subplots(figsize=(6, 6))

    def draw(i):
        ax.clear()
        _draw_frame(ax, frames[i], extent, None if designs is None else designs[i], bound, energy)
        return []

    anim = animation.FuncAnimation(fig, draw, frames=len(frames), blit=False)
    out = _save_animation(anim, fig, path, fps, draw, len(frames))
    plt.close(fig)
    return out


def render_line_video(x, ys, path: str, ylim=(-2.0, 2.0), fps: int = FRAMES_PER_SECOND) -> str:
    """A line y(x) a frame, ys (T, E)."""
    plt = pyplot()
    import matplotlib.animation as animation

    x, ys = _host(x), _host(ys)
    fig, ax = plt.subplots()

    def draw(i):
        ax.clear()
        ax.set_xlim(x[0], x[-1])
        ax.set_ylim(*ylim)
        ax.plot(x, ys[i], color="blue")
        return []

    anim = animation.FuncAnimation(fig, draw, frames=len(ys), blit=False)
    out = _save_animation(anim, fig, path, fps, draw, len(ys))
    plt.close(fig)
    return out


def render_latent_solution(latent_x, z, path_dir: str) -> str:
    """The latent scattered field u_tot - u_inc of one sample's trajectory
    z (L, 4, E) as a line video `sc.mp4` in path_dir."""
    z = _host(z)
    return render_line_video(latent_x, z[:, 0] - z[:, 2], os.path.join(path_dir, "sc.mp4"))


@torch.no_grad()
def latent_source_period(model, batch: dict) -> dict:
    """Half a period of the latent force F(t) of the batch's first sample,
    at the model's time step: {"period" (P,), "force" (P, E), "latent_x"}."""
    _, (_, F, _) = model.get_parameters_and_initial_condition(batch)
    dt = model.integrator.dt
    period = np.arange(0.0, 0.5 / model.source_freq + dt, dt, dtype=np.float32)
    dev = F.shape.device
    f = torch.stack([F(torch.full((1,), float(t), device=dev))[0] for t in period])
    return {"period": period, "force": _host(f), "latent_x": _host(model.latent_dim.x)}


def plot_latent_source(model, batch: dict, path: str):
    """Heatmap of half a period of the latent force and its shape at the
    middle of it."""
    d = latent_source_period(model, batch)
    period, f, latent_x = d["period"], d["force"], d["latent_x"]
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7, 7))
    hm = ax1.imshow(f.T, aspect="auto", origin="lower", cmap="cividis",
                    extent=(period[0], period[-1], latent_x[0], latent_x[-1]))
    ax1.set_title("One Period of Force Function")
    ax1.set_xlabel("Time (s)")
    ax1.set_ylabel("Space (m)")
    fig.colorbar(hm, ax=ax1)
    ax2.plot(latent_x, f[len(f) // 2])
    ax2.set_title("Shape of Force Function")
    ax2.set_xlabel("Space (m)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _targets(batch: dict) -> dict:
    return {"y": _host(batch["y"]), "t": _host(batch["t"])}


@torch.no_grad()
def acoustic_plot_data(model, batch: dict, video: bool = False) -> dict:
    """What the flagship's dashboard draws, on the host: the latent axis,
    the first sample's learned PML and source shape (E,), the predicted
    energies y_hat (B, L, 3) beside the targets y and times t, and with
    `video` the first sample's latent trajectory (L, 4, E)."""
    _, (_, F, pml) = model.get_parameters_and_initial_condition(batch)
    out = {"latent_x": _host(model.latent_dim.x), "pml": _host(pml[0]),
           "force": _host(F.shape[0]), "y_hat": _host(model(batch)), **_targets(batch)}
    if video:
        out["latent"] = _host(model.generate_latent_solution(batch)[:, 0])
    return out


@torch.no_grad()
def node_plot_data(model, batch: dict) -> dict:
    """What the NODE's dashboard draws: y_hat (B, L) scattered energy, y, t."""
    return {"y_hat": _host(model(batch)), **_targets(batch)}


@torch.no_grad()
def pinn_plot_data(model, batch: dict, video: bool = False) -> dict:
    """What the PINN's dashboard draws, as `acoustic_plot_data` gives it."""
    _, f, pml, _ = model.encode(batch)
    out = {"latent_x": _host(model.latent_dim.x), "pml": _host(pml[0]), "force": _host(f[0]),
           "y_hat": _host(model(batch)), **_targets(batch)}
    if video:
        out["latent"] = _host(model.generate_latent_solution(batch)[0])
    return out


def _draw_dashboard(d: dict, path: str, samples: int) -> None:
    """pml.png and force.png over the latent axis, a video of the latent
    scattered field where there is a trajectory, and the predicted against
    the true energies of each channel of the first `samples` samples."""
    if "latent" in d:
        render_latent_solution(d["latent_x"], d["latent"], path)
    plt = pyplot()
    for name in ("pml", "force"):
        fig, ax = plt.subplots()
        ax.plot(d["latent_x"], d[name])
        fig.savefig(os.path.join(path, f"{name}.png"), dpi=120)
        plt.close(fig)
    for i in range(min(d["y"].shape[0], samples)):
        for ch, name, title in ENERGY_NAMES:
            plot_predicted_energy(d["t"][i], d["y"][i, :, ch], d["y_hat"][i, :, ch],
                                  title=f"{title} Energy",
                                  path=os.path.join(path, f"{name}{i + 1}.png"))


def make_plots_acoustic(model, batch: dict, path: str, samples: int = 1, video: bool = False):
    """The flagship's checkpoint dashboard in `path`: learned PML, latent
    source shape, predicted against true energies; the latent video with
    `video` (slow)."""
    os.makedirs(path, exist_ok=True)
    _draw_dashboard(acoustic_plot_data(model, batch, video), path, samples)


def make_plots_pinn(model, batch: dict, path: str, samples: int = 1, video: bool = False):
    """The PINN's checkpoint dashboard in `path`, as the flagship's."""
    os.makedirs(path, exist_ok=True)
    _draw_dashboard(pinn_plot_data(model, batch, video), path, samples)


def make_plots_node(model, batch: dict, path: str, samples: int = 1):
    """The NODE's checkpoint dashboard in `path`: predicted against true
    scattered energy of the first `samples` samples."""
    os.makedirs(path, exist_ok=True)
    d = node_plot_data(model, batch)
    for i in range(min(d["y"].shape[0], samples)):
        plot_predicted_energy(d["t"][i], d["y"][i, :, 2], d["y_hat"][i], title="Scattered Energy",
                              path=os.path.join(path, f"sc{i + 1}.png"))
