"""The default window, env step and episode at the step times of two-step
calls, against the JAX package's defaults.

At 64^2 with 20 steps a window the frame segments are [0, 10, 10], so both
packages step at the times of two-step kernel calls by default (the JAX
package's `make_fused_window` rule, waves_jl_tpu/physics/fused.py:101-104;
the port launches one step at a time at those times), with the split d/dx
(`x_matmul=True`), sub-step st of a call at float32(t + float32(st dt)). JAX's `make_episode_fused(interpret=True)` (one program)
runs an episode of 2 actions from a JAX reset; from the same state and
actions:

* the port's `make_episode_fused`: signals `y` to 1e-5 relative,
  observations to atol 2e-5, window times to one ulp, as
  tests/test_torch_data.py holds the chunked episodes;
* the port's `make_env_step_fused` chained over the actions: each signal to
  1e-6 and the final frames to 5e-7 relative, as
  tests/test_torch_xmatmul_env.py holds the env step; its states bit for
  bit the episode's;
* the port's `make_fused_window` on the first window: its signal and
  frames bit for bit the env step's, at the same step times.
"""
import jax
import numpy as np
import torch
from test_torch_data import port_state
from test_torch_fused import _envs, rel
from test_torch_hybrid import to_port

from waves_jl_tpu.data import make_episode_fused as jax_make_episode_fused
from waves_jl_tpu.env import RandomDesignPolicy as JaxPolicy
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch.data import make_episode_fused
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics import fused as pf
from waves_jl_tpu_torch.utils.trees import tree_index

torch.set_num_threads(1)


def test_default_window_step_and_episode_match_jax_defaults():
    je, pe = _envs()
    assert pf.default_steps_per_call(pe.integration_steps) == 2
    k_reset, k_act = jax.random.split(jax.random.PRNGKey(7))
    js = jax_env_reset(je, k_reset)
    jactions = jax.vmap(JaxPolicy(je.action_space))(jax.random.split(k_act, je.actions))
    jfinal, want = jax_make_episode_fused(je, interpret=True)(js, jactions)
    assert float(np.abs(np.asarray(want.y)[..., 2]).max()) > 0.0  # the wave met the cloak

    state, actions = port_state(pe, js), to_port(jactions)
    fk.reset_launch_counts()
    final, got = make_episode_fused(pe)(state, actions)
    assert all(v == 0 for v in fk.launch_counts.values())  # the plain version, on the CPU
    assert got.y.shape == (2, 21, 3)
    assert rel(got.y.numpy(), np.asarray(want.y)) <= 1e-5
    np.testing.assert_allclose(got.s_wave.numpy(), np.asarray(want.s_wave), rtol=0, atol=2e-5)
    np.testing.assert_array_max_ulp(got.s_tspan.numpy(), np.asarray(want.s_tspan), maxulp=1)

    step = pf.make_env_step_fused(pe)
    st = state
    for i in range(pe.actions):
        first = st
        st, _ = step(st, tree_index(actions, i))
        assert rel(st.signal.numpy(), np.asarray(want.y[i])) <= 1e-6
        torch.testing.assert_close(st.signal, got.y[i], rtol=0, atol=0)
        if i == 0:
            tspan = tenv.env_tspan(pe, first)
            cyl = pf.cyl_params(first.design, st.design, "cpu").contiguous()
            u, frames, signal = pf.make_fused_window(pe)(first.wave[-1], first.source.shape,
                                                         tspan, cyl)
            torch.testing.assert_close(signal, st.signal, rtol=0, atol=0)
            torch.testing.assert_close(torch.stack(frames), st.wave, rtol=0, atol=0)
    assert rel(st.wave.numpy(), np.asarray(jfinal.wave)) <= 5e-7
    torch.testing.assert_close(st.wave, final.wave, rtol=0, atol=0)
