"""The port's y-sharded fused rollout with the split d/dx (`x_matmul=True`:
each slab steps through K4-XM's plain version on CPU tensors), radii-only,
as tests/test_torch_fused_domain.py holds the exact stencil (helpers
there):

* against the JAX package's `make_fused_sharded_rollout(..., interpret=True,
  radii_only=True, x_matmul=True)` on a 4-device virtual CPU mesh, N = 64,
  4 shards, 4 steps: state and signal to 1e-6 relative, the tolerance the
  exact pair holds (measured: 7.2e-8 on the state and 1.0e-7 on the
  signal, as for the exact pair; only sin and the energy sums round
  apart), where the exact stencil's rollout is 1.3e-6 away from it;
* at 1, 2 and 4 shards against the port's single-device
  `make_fused_window(x_matmul=True)` (K5's plain version): the split acts
  along x, which is not sharded, so the final state agrees to 1e-7
  relative (expected equal) and the signal to 1e-6.
"""
import pytest
import torch
from test_torch_fused_domain import (case, check_against_jax, check_against_window, port_rollout,
                                     rel)

torch.set_num_threads(1)


def test_split_sharded_rollout_matches_jax():
    state_err, _ = check_against_jax(radii_only=True, x_matmul=True)
    env, inputs = case(True)
    split = port_rollout(env, inputs, 4, True, x_matmul=True)[0]
    exact = port_rollout(env, inputs, 4, True, x_matmul=False)[0]
    assert rel(split, exact) > 10 * state_err  # the rollout took the split d/dx


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_split_sharded_rollout_matches_single_device_window(shards):
    check_against_window(radii_only=True, shards=shards, x_matmul=True)
