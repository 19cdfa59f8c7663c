"""The windowed store's gathers and the window sampler against the JAX
package's, exactly: `gather_window_batch` (on the store) and
`gather_window_batch_host` (on a host store) give JAX's batches leaf for
leaf for every window of horizons 1-4 at strides 1 and 2, equal to the
port's `prepare_data`; `sample_window_indices` draws JAX's windows from
the same numpy generator state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_model import ACTIONS, episodes

from waves_jl_tpu.train import gather_window_batch as jax_gather
from waves_jl_tpu.train import gather_window_batch_host as jax_gather_host
from waves_jl_tpu.train import sample_window_indices as jax_sample
from waves_jl_tpu.train import stack_episodes as jax_stack
from waves_jl_tpu_torch.data import prepare_data
from waves_jl_tpu_torch.train import (gather_window, gather_window_batch,
                                      gather_window_batch_host, sample_window_indices,
                                      stack_episodes)
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stores():
    je, pe = episodes(3, seed=4)
    return je, pe, jax_stack(je), jax_stack(je, device=False), stack_episodes(pe, device="cpu")


def _leaves(batch) -> list:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(batch)]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("horizon", [1, 2, 4])
def test_gathers_equal_jax_and_prepare_data(stores, horizon, stride):
    je, pe, jstore, jhost, store = stores
    idx = np.stack(np.meshgrid(np.arange(3), np.arange(ACTIONS - horizon + 1), indexing="ij"),
                   -1).reshape(-1, 2).astype(np.int32)
    want = jax.jit(lambda st, ix: jax_gather(st, ix, horizon, stride))(jstore, jnp.asarray(idx))
    want_host = jax_gather_host(jhost, idx, horizon, stride)
    got = gather_window_batch(store, torch.from_numpy(idx).long(), horizon, stride)
    got_host = gather_window_batch_host(store, idx, horizon, stride)
    keys = ("s_wave", "s_design", "a", "t", "y")
    for k in keys:
        w, wh = _leaves(want[k]), _leaves(want_host[k])
        g, gh = [x.numpy() for x in tree_leaves(got[k])], [x.numpy() for x in tree_leaves(
            got_host[k])]
        assert len(w) == len(g) == len(gh) == len(wh)
        for a, b, c, d in zip(g, w, gh, wh):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, d)
    # episode-major windows are what prepare_data gives, episode by episode
    S = ACTIONS - horizon + 1
    for e in range(3):
        ref = prepare_data(pe[e], horizon, stride)
        for k in keys:
            for a, b in zip(tree_leaves(ref[k]), tree_leaves(got[k])):
                assert torch.equal(a, b[e * S:(e + 1) * S])
    one = gather_window(store, 2, S - 1, horizon, stride)
    assert torch.equal(one["y"], got["y"][-1]) and torch.equal(one["t"], got["t"][-1])


@pytest.mark.parametrize("count", [5, 12, 31])
def test_window_sampler_draws_jax_windows(count):
    for horizon in (1, 3):
        a = sample_window_indices(np.random.default_rng(7), 3, ACTIONS, horizon, count)
        b = jax_sample(np.random.default_rng(7), 3, ACTIONS, horizon, count)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
