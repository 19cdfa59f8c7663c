"""The baselines' tracked weights in the port, on the CPU and without a
full-width forward: `models/ref500_node_r4b/checkpoint_step=2040` (38
leaves) and `models/ref500_pinn_r4/checkpoint_step=2000` (118 leaves) load
into `NODEEnergyModel` and `WaveControlPINN` at the reference widths with
every leaf mapped and every parameter filled, each leaf's values in the
port's layout (1-D conv kernels (k, in, out) -> (out, in, k)); written back
by `to_jax_params` they are the npz bit for bit; a leaf of the wrong
shape, a leaf left over, a leaf missing and another model's leaf are
errors."""
import os

import numpy as np
import pytest
import torch

from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.models.convert import from_jax_params, model_kind, to_jax_params
from waves_jl_tpu_torch.models.node import NODEEnergyModel
from waves_jl_tpu_torch.models.pinn import WaveControlPINN
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = {
    "node": ("models/ref500_node_r4b/checkpoint_step=2040", 38, 2040,
             "['dynamics']['params']['Dense_0']['kernel']", "dynamics.layers.0.weight"),
    "pinn": ("models/ref500_pinn_r4/checkpoint_step=2000", 118, 2000,
             "['compressor']['params']['Conv_0']['kernel']", "compressor.convs.0.weight"),
}


def reference_model(which: str):
    space = build_triple_ring_design_space(device="cpu")
    if which == "node":
        return NODEEnergyModel(space, device="cpu")
    return WaveControlPINN(space, 1000.0, device="cpu")


@pytest.fixture(scope="module", params=["node", "pinn"])
def tracked(request):
    path, n_leaves, step, leaf, name = TRACKED[request.param]
    model = reference_model(request.param)
    return request.param, model, load_params(os.path.join(ROOT, path)), n_leaves, step, leaf, name


def test_tracked_checkpoint_loads_every_leaf(tracked):
    which, model, named, n_leaves, step, leaf, name = tracked
    path = os.path.join(ROOT, TRACKED[which][0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_model_checkpoint(model, path) == step
    state = model.state_dict()
    assert len(named) == len(state) == n_leaves
    assert all(not torch.equal(state[k], before[k]) for k in state)  # every parameter filled
    kernel = named[leaf]
    want = kernel.transpose(2, 1, 0) if kernel.ndim == 3 else kernel.T
    np.testing.assert_array_equal(state[name].numpy(), want)


def test_tracked_checkpoint_round_trips_bit_for_bit(tracked):
    which, model, named, *_ = tracked
    back = to_jax_params(from_jax_params(named, expected=model.state_dict(),
                                         kind=model_kind(model)), model_kind(model))
    assert set(back) == set(named)
    for k, v in named.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_mismatched_leaves_are_errors(tracked):
    which, model, named, _, _, leaf, _ = tracked
    expected, kind = model.state_dict(), model_kind(model)
    wrong = dict(named)
    wrong[leaf] = np.ascontiguousarray(named[leaf].T)  # the port's layout, not flax's
    with pytest.raises(ValueError, match="flax shape"):
        from_jax_params(wrong, expected=expected, kind=kind)
    missing = {k: v for k, v in named.items() if k != leaf}
    with pytest.raises(KeyError, match="without a flax leaf"):
        from_jax_params(missing, expected=expected, kind=kind)
    extra = dict(named)
    extra[leaf.replace("_0']", "_9']", 1)] = named[leaf]
    with pytest.raises(KeyError):
        from_jax_params(extra, expected=expected, kind=kind)
    other = TRACKED["pinn" if which == "node" else "node"][3]  # the other model's leaf
    with pytest.raises(KeyError, match=f"no port parameter .* in {kind}'s map"):
        from_jax_params({other: named[leaf]}, kind=kind)


def test_gradient_leaf_limits(tracked):
    """`grad_precision.LEAF_LIMITS`, which the card's gradient checks hold
    each leaf to: every leaf of the model has its limit (the NODE's 5e-4;
    the PINN's field net 2e-2, its other leaves 1e-3), and `leaves_beyond`
    names exactly the leaves moved past theirs."""
    from waves_jl_tpu_torch.scripts.grad_precision import leaf_limit, leaves_beyond

    which, model, *_ = tracked
    params = dict(model.named_parameters())
    want = {"node": lambda k: 5e-4,
            "pinn": lambda k: 2e-2 if k.startswith("field_net.") else 1e-3}[which]
    assert all(leaf_limit(which, k) == want(k) for k in params)
    base = {k: torch.ones(3) for k in params}
    first, last = list(params)[0], list(params)[-1]
    moved = dict(base)
    moved[first] = base[first] + 1.01 * want(first)  # just past its limit
    moved[last] = base[last] + 0.99 * want(last)  # just inside
    dist, beyond = leaves_beyond(which, moved, base)
    assert set(dist) == set(params) and list(beyond) == [first]
    assert beyond[first][1] == want(first) and dist[last] <= want(last)
