"""The port's MPC evaluation CLI (`waves_jl_tpu_torch/scripts/mpc.py`) on the
CPU at a small grid (130^2, 2 actions, 1 location, 1 episode): the one-shot
policy with the tracked `models/bc_pools3` weights, and CEM + polish with
the tracked pools3 surrogate at full width and a small population. Each
writes a result JSON with the keys of the JAX CLI's
(`mpc_results_bc_policy.json`) and finite decreases. `--fast` (the bf16
ranking) runs CEM and random shooting and prints its mode line. Every
option of the JAX CLI is ported: `--fused-episode`, alone with the hybrid
or beside `--render` (tests/test_torch_viz_cli.py) or `--fast`, is no
longer refused and the run goes on to load its checkpoint (its episode
runs in tests/test_torch_pack_frontier_cli.py); the
gradient, ensemble and oracle controllers run in
tests/test_torch_control_cli.py.
"""
import json
import math
import os

import pytest
import torch

from waves_jl_tpu_torch.scripts.mpc import main

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n", "130", "--actions", "2", "--locations", "1", "--episodes", "1",
         "--device", "cpu"]
POLICY = os.path.join(ROOT, "models/bc_pools3/checkpoint_step=4500")
SURROGATE = os.path.join(ROOT, "models/ref500_h8s4_pools3/checkpoint_step=1450")
with open(os.path.join(ROOT, "mpc_results_bc_policy.json")) as f:
    KEYS = set(json.load(f))


def run(tmp_path, *args):
    out = tmp_path / "result.json"
    result = main([*args, *SMALL, "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == result
    assert set(result) == KEYS
    assert len(result["percentage_decrease"]) == 1
    assert all(math.isfinite(d) for d in result["percentage_decrease"])
    assert math.isfinite(result["mean_decrease"])
    assert result["mpc_episode_seconds"]["first"] > 0.0
    return result


def test_policy_controller(tmp_path):
    result = run(tmp_path, "--controller", "policy",
                 "--checkpoint", POLICY)
    assert result["controller"] == "policy" and result["cem_polish"] is None


def test_cem_polish_controller(tmp_path):
    result = run(tmp_path, "--controller", "cem",
                 "--checkpoint", SURROGATE,
                 "--latent-stride", "4", "--horizon", "1", "--shots", "4", "--cem-elites", "2",
                 "--cem-iters", "1", "--cem-polish", "1", "--cem-polish-topk", "1")
    assert result["controller"] == "cem" and result["cem_polish"] == 1
    assert result["cem_warm"] is False and result["latent_stride"] == 4


@pytest.mark.parametrize("controller", ["cem", "random_shooting"])
def test_fast_ranking_controllers(tmp_path, capsys, controller):
    result = run(tmp_path, "--controller", controller, "--fast", "--checkpoint", SURROGATE,
                 "--latent-stride", "4", "--horizon", "1", "--shots", "4", "--cem-elites", "2",
                 "--cem-iters", "1")
    assert result["controller"] == controller
    assert "fast-ranking mode: bf16 latent matmul" in capsys.readouterr().out.splitlines()


# --fused-episode, once refused as not yet ported, is accepted beside --render
# and --fast: the run gets past the options to the missing checkpoint "x"
@pytest.mark.parametrize("args", [["--render", "out.mp4", "--fused-episode"],
                                  ["--controller", "hybrid", "--fused-episode"],
                                  ["--fast", "--fused-episode"]])
def test_unported_options_exit_with_a_message(tmp_path, args):
    with pytest.raises(FileNotFoundError, match="x/params.npz"):
        main([*args, "--checkpoint", "x", "--out", str(tmp_path / "r.json"), "--n", "130",
              "--device", "cpu"])
    assert not (tmp_path / "r.json").exists()


def test_existing_result_is_kept(tmp_path):
    out = tmp_path / "r.json"
    out.write_text("{}")
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        main(["--controller", "policy", "--checkpoint", "x", "--out", str(out)])
    assert out.read_text() == "{}"
