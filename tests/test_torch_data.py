"""The port's datagen slice as a whole: `make_episode_chunk_fused` against
the JAX package's (`interpret=True`, both at their default `x_matmul=True`)
on the same two reset states and actions, drawn in JAX, at 64^2 with 20
steps a window and 2 actions: signals `y` to 1e-5 relative, observations
`s_wave` to atol 2e-5 (the observation's bound in tests/test_torch_fused.py),
actions equal, window times to one ulp (XLA may contract the sum of the
window's start time and its linspace into an FMA) and observed designs to
1e-6.

Windowing, batching, the chunked generator and storage across the two
packages are in tests/test_torch_data_store.py.
"""
import jax
import numpy as np
import torch
from test_torch_fused import _envs, rel
from test_torch_hybrid import t, to_port

from waves_jl_tpu.data import make_episode_chunk_fused as jax_make_episode_chunk_fused
from waves_jl_tpu.env import RandomDesignPolicy as JaxPolicy
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.utils.trees import tree_index as jax_tree_index
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch.data import make_episode_chunk_fused
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
K = 2


def port_state(pe, js):
    """The port's EnvState for one JAX reset state."""
    src = pe.source
    src = type(src)(src.grid, src.mu_low, src.mu_high, src.sigma, src.a, t(js.source.shape),
                    src.freq)
    return tenv.EnvState(wave=t(js.wave), design=to_port(js.design), source=src,
                         signal=t(js.signal), time_step=int(js.time_step))


def test_episode_chunk_matches_jax():
    je, pe = _envs()
    k_reset, k_act = jax.random.split(jax.random.PRNGKey(3))
    jstates = jax.vmap(lambda k: jax_env_reset(je, k))(jax.random.split(k_reset, K))
    akeys = jax.random.split(k_act, K * je.actions).reshape(K, je.actions, 2)
    jactions = jax.vmap(jax.vmap(JaxPolicy(je.action_space)))(akeys)
    want = jax_make_episode_chunk_fused(je, interpret=True)(jstates, jactions)

    states = [port_state(pe, jax_tree_index(jstates, k)) for k in range(K)]
    got = make_episode_chunk_fused(pe)(states, to_port(jactions))
    assert got.s_wave.shape == (K, 2, 32, 32, 4) and got.y.shape == (K, 2, 21, 3)
    assert float(np.abs(np.asarray(want.y)[..., 2]).max()) > 0.0  # the wave met the cloak
    assert rel(got.y.numpy(), np.asarray(want.y)) <= 1e-5
    np.testing.assert_allclose(got.s_wave.numpy(), np.asarray(want.s_wave), rtol=0, atol=2e-5)
    # XLA fuses env_time + the window's linspace and may contract it into
    # an FMA, depending on its vector code, so a time may round one ulp apart
    np.testing.assert_array_max_ulp(got.s_tspan.numpy(), np.asarray(want.s_tspan), maxulp=1)
    for a, b in zip(tree_leaves(got.a), jax.tree_util.tree_leaves(want.a)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(got.s_design), jax.tree_util.tree_leaves(want.s_design)):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-6
