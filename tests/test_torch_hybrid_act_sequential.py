"""The port's sequential hybrid controller (the re-rank's K rollouts in turn
through the env window) with one exact-CEM refinement round against the JAX
package's, with JAX's candidate draws and refinement noise (helpers and
tolerances in tests/test_torch_hybrid_act.py)."""
import torch
from test_torch_hybrid_act import check_act, setup  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def test_sequential_hybrid_act_with_exact_rounds_matches_jax(setup):  # noqa: F811
    check_act(setup, batched=False, exact_rounds=2)
