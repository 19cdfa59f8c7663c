"""The port's recorded MPC episode (`make_mpc_episode_recorded`) against the
JAX package's (`interpret=True`) on the CPU: env 32^2, 8 steps a window, 2
actions, 8-shot random shooting over horizon 2 with the narrow surrogate
of tests/test_torch_hybrid_act.py (the same weights in both packages), at
epsilon 0 (every action the controller's) and epsilon 1 (every action the
uniform one). JAX's draws from each window's keys (the controller's
candidates, the uniform action) are injected through
`RandomShooting.candidates` and the `random_policy` argument. The
recorded observations, signals and window times within 1e-5 relative,
the designs within 1e-6 (the two packages' triple rings differ in their
last bit), and the actions equal.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states
from test_torch_hybrid_act import HORIZON, models

from waves_jl_tpu.control import RandomShooting as JaxRandomShooting
from waves_jl_tpu.control import make_mpc_episode_recorded as jax_make_mpc_episode_recorded
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu_torch.control.mpc import RandomShooting, make_mpc_episode_recorded
from waves_jl_tpu_torch.data import Episode
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
SHOTS = 8
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    je, pe = envs(32, 8, (16, 16))
    jm, params, model = models(je, pe)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    return je, pe, jm, params, model, js, ps


@pytest.mark.parametrize("epsilon", [0.0, 1.0])
def test_recorded_episode_matches_jax(setup, epsilon):
    je, pe, jm, params, model, js, ps = setup
    key = jax.random.PRNGKey(17)
    run_j = jax_make_mpc_episode_recorded(
        je, JaxRandomShooting(model=jm, horizon=HORIZON, shots=SHOTS), epsilon=epsilon,
        interpret=True)
    jf, jep = run_j(params, js, key)

    @jax.jit
    def draws(k):  # each window's k_sel, k_rnd, k_mix = split(k, 3)
        k_sel, k_rnd, _ = jax.random.split(k, 3)
        return (jax_build_action_sequence(je.action_space, k_sel, HORIZON, SHOTS),
                je.action_space.sample(k_rnd))

    sets, rnd = zip(*[draws(k) for k in jax.random.split(key, je.actions)])
    sets, rnd = [to_port(x) for x in sets], [to_port(x) for x in rnd]
    mpc = RandomShooting(model=model, horizon=HORIZON, shots=SHOTS)
    object.__setattr__(mpc, "candidates", lambda env, generator: sets.pop(0))
    run = make_mpc_episode_recorded(pe, mpc, epsilon=epsilon,
                                    random_policy=lambda generator: rnd.pop(0))
    final, ep = run(ps, torch.Generator().manual_seed(0))
    assert not sets and not rnd
    assert isinstance(ep, Episode) and len(ep) == je.actions
    assert ep.s_wave.shape == (2, 16, 16, 4) and ep.y.shape == (2, 9, 3)
    assert ep.s_tspan.shape == (2, 9) and ep.s_tspan.dtype == torch.float32
    assert final.time_step == 40 + 2 * 8
    assert rel(ep.s_wave.numpy(), np.asarray(jep.s_wave)) <= TOL
    assert rel(ep.y.numpy(), np.asarray(jep.y)) <= TOL
    assert rel(ep.s_tspan.numpy(), np.asarray(jep.s_tspan)) <= TOL
    for got, want in zip(tree_leaves(ep.s_design), jax.tree_util.tree_leaves(jep.s_design)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    for got, want in zip(tree_leaves(ep.a), jax.tree_util.tree_leaves(jep.a)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
