"""The port's y-sharded fused rollout in the radii-only mode (the triple
ring's fixed cylinders, one owner pass per shard) against the JAX package's
and against the port's single-device window, as
tests/test_torch_fused_domain.py holds the general mode (helpers and
tolerances there)."""
import pytest
import torch
from test_torch_fused_domain import check_against_jax, check_against_window

torch.set_num_threads(1)


def test_sharded_rollout_matches_jax():
    check_against_jax(radii_only=True)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_rollout_matches_single_device_window(shards):
    check_against_window(radii_only=True, shards=shards)
