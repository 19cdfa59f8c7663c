"""Batched episode generation in the port against the JAX package's, on the
CPU.

`make_episode_batch_fused` (K episodes advanced together through the
candidate-batched exact kernel, here its plain version) against
`jax.vmap` over JAX's `_episode_scan` (XLA's `env_step`, the exact
stencil) on JAX's resets and actions, 3 episodes x 2 actions at 32^2 with
20 steps a window: signals `y` and observations `s_wave` within 1e-5
relative, the bound the port's windows are held to against JAX's, the
final waves too; the triple ring (K3 radii-only with its batched owner
pass) and a design whose cylinders move (K3 general). Each batched episode
is its single-state exact window's, bit for bit on the CPU. Then the JAX
test's checks (`tests/test_batch_and_dp_train.py:32-44`) on
`generate_episodes_batch` and `split_episode_batch`: shapes, finite,
distinct episodes, `prepare_data` on a split episode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_data import port_state
from test_torch_hybrid import rel, to_port

import waves_jl_tpu as w
from waves_jl_tpu.data import _episode_scan
from waves_jl_tpu.env import RandomDesignPolicy as JaxPolicy
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.env import make_wave_env as jax_make_wave_env
from waves_jl_tpu.utils.trees import tree_index as jax_tree_index
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.data import (generate_episodes_batch, make_episode_batch_fused,
                                     prepare_data, split_episode_batch)
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import make_env_step_fused, radii_only_ok
from waves_jl_tpu_torch.utils.trees import tree_index, tree_leaves

torch.set_num_threads(1)
N, STEPS, RES, K = 32, 20, (16, 16), 3
TOL = 1e-5


def moving(space_pkg, d, v):
    """The triple ring's cylinders free to move, radius 0.6, shifted by v."""
    return space_pkg.Cloak(space_pkg.AdjustablePositionScatterers(space_pkg.Cylinders(
        d.config.cylinders.pos + v, d.config.cylinders.r * 0.0 + 0.6, d.config.cylinders.c)),
        d.core)


def envs(mode: str, n: int = N, steps: int = STEPS, res=RES):
    """The same environment in both packages: the triple ring, or (mode
    "general") its cylinders free to move by +-0.5."""
    jspace = w.build_triple_ring_design_space()
    if mode == "general":
        jspace = w.DesignSpace(moving(w, jspace.low, -0.5), moving(w, jspace.high, 0.5))
    jdim = w.two_dim(15.0, n)
    jsrc = w.GaussianSource.create(w.build_grid(jdim), jnp.array([[-10.0, -10.0]]),
                                   jnp.array([[-10.0, 10.0]]), jnp.array([0.3]),
                                   jnp.array([1.0]), 1000.0)
    je = jax_make_wave_env(jdim, jspace, jsrc, resolution=res, integration_steps=steps,
                           actions=2)
    pdim = tdims.two_dim(15.0, n, device="cpu")
    psrc = tsrc.GaussianSource.create(tdims.build_grid(pdim), [[-10.0, -10.0]],
                                      [[-10.0, 10.0]], [0.3], [1.0], 1000.0)
    pspace = td.DesignSpace(to_port(jspace.low), to_port(jspace.high))
    pe = tenv.make_wave_env(pdim, pspace, psrc, resolution=res, integration_steps=steps,
                            actions=2)
    return je, pe


@pytest.mark.parametrize("mode", ["radii_only", "general"])
def test_episode_batch_matches_jax_vmapped_episode_scan(mode):
    je, pe = envs(mode)
    assert radii_only_ok(pe.design_space) == (mode == "radii_only")
    k_reset, k_act = jax.random.split(jax.random.PRNGKey(11))
    jstates = jax.vmap(lambda k: jax_env_reset(je, k))(jax.random.split(k_reset, K))
    akeys = jax.random.split(k_act, K * je.actions).reshape(K, je.actions, 2)
    jactions = jax.vmap(jax.vmap(JaxPolicy(je.action_space)))(akeys)
    jfinal, want = jax.jit(jax.vmap(lambda s, a: _episode_scan(je, s, a)))(jstates, jactions)

    states = [port_state(pe, jax_tree_index(jstates, k)) for k in range(K)]
    actions = to_port(jactions)
    fk.reset_launch_counts()
    final, got = make_episode_batch_fused(pe)(states, actions)
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    assert got.s_wave.shape == (K, 2, *RES, 4) and got.y.shape == (K, 2, STEPS + 1, 3)
    assert got.s_tspan.shape == (K, 2, STEPS + 1) and final.wave.shape == (K, 3, 12, N, N)
    assert float(np.abs(np.asarray(want.y)[..., 2]).max()) > 0.0  # the wave met the cloak
    assert rel(got.y.numpy(), np.asarray(want.y)) <= TOL
    assert rel(got.s_wave.numpy(), np.asarray(want.s_wave)) <= TOL
    assert rel(final.wave.numpy(), np.asarray(jfinal.wave)) <= TOL
    np.testing.assert_array_max_ulp(got.s_tspan.numpy(), np.asarray(want.s_tspan), maxulp=1)
    for a, b in zip(tree_leaves(got.a), jax.tree_util.tree_leaves(want.a)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(got.s_design), jax.tree_util.tree_leaves(want.s_design)):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-6

    # each batched episode is its single-state exact window's at one step a
    # call (the tspan times JAX's vmapped env_step takes), bit for bit
    step = make_env_step_fused(pe, x_matmul=False, steps_per_call=1)
    for k, st in enumerate(states):
        for i in range(2):
            obs = tenv.env_observe(pe, st)
            st, _ = step(st, tree_index(tree_index(actions, k), i))
            torch.testing.assert_close(got.y[k, i], st.signal, rtol=0, atol=0)
            assert rel(got.s_wave[k, i].numpy(), obs.wave.numpy()) <= 1e-6
        torch.testing.assert_close(final.wave[k], st.wave, rtol=0, atol=0)
    assert final.time_step == 2 * STEPS


def test_generate_episodes_batch_and_split():
    _, pe = envs("radii_only", n=48, steps=10)
    policy = tenv.RandomDesignPolicy(pe.action_space)
    batched = generate_episodes_batch(pe, policy, torch.Generator().manual_seed(0), batch=3)
    final, eps = batched
    assert final.wave.shape == (3, 3, 12, 48, 48) and final.source.shape.shape == (3, 48, 48)
    episodes = split_episode_batch(batched)
    assert len(episodes) == 3
    assert episodes[0].s_wave.shape == (2, 16, 16, 4)
    assert all(bool(torch.isfinite(x).all()) for ep in episodes for x in tree_leaves(ep))
    assert not np.allclose(episodes[0].y.numpy(), episodes[1].y.numpy())  # distinct draws
    data = prepare_data(episodes[0], horizon=2)
    assert data["t"].shape == (1, 21)
    # the draws are the resets in turn, then each episode's actions
    gen = torch.Generator().manual_seed(0)
    resets = [tenv.env_reset(pe, gen) for _ in range(3)]
    for k, st in enumerate(resets):
        torch.testing.assert_close(eps.s_wave[k, 0], tenv.env_observe(pe, st).wave, rtol=0,
                                   atol=0)
        first = policy(gen)
        for a, b in zip(tree_leaves(first), tree_leaves(tree_index(tree_index(eps.a, k), 0))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        policy(gen)  # the episode's second action
