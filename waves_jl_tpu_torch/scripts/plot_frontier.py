"""Controller quality against latency (the port of
`scripts_tpu/plot_frontier.py`): reads the committed protocol results
(`mpc_results_*.json`: 20 actions, 5 source locations x 4 episodes, horizon
5, 256 shots, alpha 1) and plots each controller family's scattered-energy
decrease against its warm episode latency:

    python -m waves_jl_tpu_torch.scripts.plot_frontier [--out controller_frontier.png]

A point whose JSON is absent from the checkout's root, or whose protocol is
not the 20-action one, is skipped. Drawing runs on the host and needs
matplotlib.
"""
from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# file, family, short label, optional label offset (labels on key points only)
POINTS = [
    ("mpc_results_ft_hybrid16.json", "hybrid", "topk=16"),
    ("mpc_results_ft_hybrid32.json", "hybrid", "topk=32"),
    ("mpc_results_ft_hybrid64.json", "hybrid", "topk=64"),
    ("mpc_results_ft_hybrid128.json", "hybrid", "topk=128", (-62, 4)),
    ("mpc_results_ft_noprune256.json", "hybrid", "no-prune 256", (7, -13)),
    ("mpc_results_ft_hybrid64_r2.json", "hybrid", "64x2 rounds"),
    ("mpc_results_ft_hybrid16_fused.json", "hybrid", "fused 16"),
    ("mpc_results_ft_hybrid16_rr175.json", "hybrid", "16@175^2"),
    ("mpc_results_hybrid16_cem.json", "hybrid", "CEM pool"),
    ("mpc_results_oracle64.json", "oracle", "64 shots"),
    ("mpc_results_oracle256.json", "oracle", "256 shots", (-55, 8)),
    ("mpc_results_h8s4.json", "surrogate", "shooting"),
    ("mpc_results_h8s4_cem.json", "surrogate", "CEM"),
    ("mpc_results_ft_shoot.json", "surrogate", None),
    ("mpc_results_ens2.json", "surrogate", None),
    ("mpc_results_h8s4_hor8.json", "surrogate", None),
    ("mpc_results_rank400.json", "surrogate", None),
    ("mpc_results_pools_shoot.json", "distilled", "shooting"),
    ("mpc_results_pools_cem.json", "distilled", "CEM"),
    ("mpc_results_pools_hybrid32.json", "hybrid", "distilled topk=32"),
    ("mpc_results_pools2_cem.json", "distilled", "CEM pools2"),
    ("mpc_results_pools2_grad.json", "gradient", "pure gradient"),
    ("mpc_results_pools2_cem_polish.json", "gradient", "CEM+polish 5"),
    ("mpc_results_pools2_cem_polish10.json", "gradient", "CEM+polish 10", (-78, 6)),
    ("mpc_results_pools2_cem_polish20.json", "gradient", "CEM+polish 20"),
    ("mpc_results_pools3_cem.json", "distilled", "CEM pools3 (DAgger)", (-55, -14)),
    ("mpc_results_pools3_cem_polish10.json", "gradient", "pools3 CEM+polish 10 (record)",
     (-118, 7)),
    ("mpc_results_pools4_cem.json", "distilled", "CEM pools4"),
    ("mpc_results_pools4_cem_polish10.json", "gradient", "pools4 CEM+polish 10"),
    ("mpc_results_bc_policy.json", "policy", "one-shot policy (zero search)", (-40, 8)),
]

FAMILIES = {
    "hybrid": ("#2a78d6", "Hybrid prune + exact re-rank", "o"),
    "oracle": ("#eb6834", "True-simulator oracle", "s"),
    "surrogate": ("#1baf7a", "Pure surrogate", "^"),
    "distilled": ("#8a63d2", "Ranking-distilled surrogate", "D"),
    "gradient": ("#c2417e", "Gradient-polished (differentiable rollout)", "v"),
    "policy": ("#a87b00", "Amortized one-shot policy (no search)", "*"),
}
SURFACE, INK, INK2 = "#fcfcfb", "#0b0b0b", "#52514e"


def frontier_points() -> list[tuple]:
    """(latency s, decrease %, family, label, label offset) of every point
    whose JSON is in the checkout's root with a 20-action protocol, a warm
    latency and a mean decrease, in POINTS' order."""
    out = []
    for fname, family, label, *off in POINTS:
        path = os.path.join(ROOT, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            d = json.load(f)
        if d.get("actions") not in (None, 20):  # the 20-action protocol only
            continue
        lat = (d.get("mpc_episode_seconds") or {}).get("warm_mean")
        q = d.get("mean_decrease")
        if lat is None or q is None:
            continue
        out.append((lat, 100 * q, family, label, off[0] if off else (7, 5)))
    return out


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="controller_frontier.png",
                   help="the PNG to write (default: in the working directory)")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8.4, 5.2), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    ax.set_facecolor(SURFACE)
    seen = set()
    for lat, q, family, label, off in frontier_points():
        color, fam_label, marker = FAMILIES[family]
        ax.scatter(lat, q, s=130 if marker == "*" else 52, color=color, marker=marker, zorder=3,
                   edgecolors=SURFACE, linewidths=1.2,
                   label=fam_label if family not in seen else None)
        seen.add(family)
        if label:
            ax.annotate(label, (lat, q), textcoords="offset points", xytext=off, fontsize=8,
                        color=INK2)
    ax.set_xscale("log")
    ax.set_xlabel("episode latency, warm (s, log scale)", color=INK)
    ax.set_ylabel("scattered-energy decrease vs random (%)", color=INK)
    ax.set_title("Controller quality vs latency — 20-action reference protocol", color=INK,
                 fontsize=11, loc="left")
    ax.axhline(42.6, color=INK2, lw=0.8, ls=":", zorder=1)
    ax.annotate("raw-oracle ceiling (+42.6%)", (0.62, 42.9), fontsize=8, color=INK2)
    ax.axvline(1.0, color=INK2, lw=0.8, ls=":", zorder=1)
    ax.annotate("<1 s north star", (1.06, 25.6), fontsize=8, color=INK2)
    ax.grid(True, which="major", color="#e6e5e2", lw=0.6, zorder=0)
    ax.tick_params(colors=INK2)
    for spine in ax.spines.values():
        spine.set_color("#d8d7d3")
    ax.legend(loc="lower right", frameon=False, fontsize=9, labelcolor=INK)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fig.savefig(args.out, facecolor=SURFACE)
    plt.close(fig)
    print(f"wrote {args.out}", flush=True)
    return args.out


if __name__ == "__main__":
    main()
