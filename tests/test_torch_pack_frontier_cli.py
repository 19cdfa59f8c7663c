"""The last two CLIs of the port and the MPC CLI's `--fused-episode`, on the
CPU at the smallest sizes.

* `pack_dataset` packs three tiny port episodes (`.npz` and `.wbin` under
  `episodes/`, numbered 1, 2 and 10 so that the order is numeric) into one
  shard that reads back leaf for leaf equal, in order.
* `plot_frontier` draws the committed `mpc_results_*.json` into a PNG under
  `tmp_path`, from the points of the 20-action protocol only.
* `mpc --controller hybrid --fused-episode --device cpu` runs one action at
  130^2 and writes the JAX CLI's result keys.
"""
import json
import math
import os

import torch

from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.data import generate_episode, load_episodes_shard, save_episode
from waves_jl_tpu_torch.scripts import mpc, pack_dataset, plot_frontier
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_env():
    dim = tdims.two_dim(15.0, 24, device="cpu")
    src = tsrc.GaussianSource.create(tdims.build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                     [0.3], [1.0], 1000.0)
    return tenv.make_wave_env(dim, td.build_triple_ring_design_space(device="cpu"), src,
                              resolution=(8, 8), integration_steps=4, actions=2)


def test_pack_dataset_packs_episodes_in_order(tmp_path):
    env = tiny_env()
    gen = torch.Generator().manual_seed(0)
    policy = tenv.RandomDesignPolicy(env.action_space)
    eps = [generate_episode(env, policy, gen)[1] for _ in range(3)]
    os.makedirs(tmp_path / "episodes")
    for ep, name in zip(eps, ("episode1.npz", "episode2.wbin", "episode10.npz")):
        save_episode(ep, str(tmp_path / "episodes" / name))
    out = pack_dataset.main(["--data", str(tmp_path)])
    assert out == str(tmp_path / "data.wshard")
    back = load_episodes_shard(out)
    assert len(back) == 3
    for ep, got in zip(eps, back):
        for a, b in zip(tree_leaves(ep), tree_leaves(got)):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert pack_dataset.episode_paths(str(tmp_path))[-1].endswith("episode10.npz")


def test_plot_frontier_draws_the_committed_results(tmp_path):
    points = plot_frontier.frontier_points()
    assert len(points) >= 5
    for lat, q, family, _, _ in points:
        assert lat > 0 and math.isfinite(q) and family in plot_frontier.FAMILIES
    with open(os.path.join(ROOT, "mpc_results_bc_policy.json")) as f:
        policy = json.load(f)
    assert any(abs(q - 100 * policy["mean_decrease"]) < 1e-9 for _, q, *_ in points)
    out = tmp_path / "plots" / "frontier.png"
    assert plot_frontier.main(["--out", str(out)]) == str(out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_mpc_fused_episode_runs_on_the_cpu(tmp_path):
    out = tmp_path / "r.json"
    result = mpc.main(["--controller", "hybrid", "--fused-episode", "--checkpoint",
                       os.path.join(ROOT, "models/ref500_h8s4/checkpoint_step=2600"),
                       "--latent-stride", "4", "--n", "130", "--actions", "1", "--locations",
                       "1", "--episodes", "1", "--shots", "4", "--topk", "2", "--horizon", "1",
                       "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == result
    with open(os.path.join(ROOT, "mpc_results_bc_policy.json")) as f:
        assert set(result) == set(json.load(f))
    assert result["controller"] == "hybrid" and result["topk"] == 2
    assert all(math.isfinite(d) for d in result["percentage_decrease"])
    assert result["mpc_episode_seconds"]["first"] > 0.0
