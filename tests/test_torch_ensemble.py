"""The port's `EnsembleShooting` against the JAX package's on the CPU: env
32^2, 8 steps a window, two narrow surrogates of
tests/test_torch_hybrid_act.py (weights from two numpy seeds, the same in
both packages), 16 shots over horizon 2, beta 1, alpha 10 so the costs
spread, JAX's draws injected through `EnsembleShooting.candidates`. The
costs within 1e-5 relative and, the best two being apart by more than 10x
the two packages' difference, the same choice and first action. The episode loop
`make_mpc_episode_fused` takes the ensemble as it takes random shooting.
"""
import jax
import numpy as np
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states
from test_torch_hybrid_act import HORIZON, models

from waves_jl_tpu.control import EnsembleShooting as JaxEnsembleShooting
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu_torch.control.mpc import EnsembleShooting, make_mpc_episode_fused

torch.set_num_threads(1)
SHOTS, ALPHA, BETA = 16, 10.0, 1.0
TOL = 1e-5


def test_ensemble_shooting_matches_jax():
    je, pe = envs(32, 8, (16, 16))
    jm, p0, m0 = models(je, pe, seed=0)
    _, p1, m1 = models(je, pe, seed=1)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    key = jax.random.PRNGKey(23)
    jens = JaxEnsembleShooting(models=(jm, jm), horizon=HORIZON, shots=SHOTS, alpha=ALPHA,
                               beta=BETA)
    ja, jinfo = jax.jit(lambda p, s, k: jens(p, je, s, k))((p0, p1), js, key)
    cands = jax.jit(lambda k: jax_build_action_sequence(je.action_space, k, HORIZON, SHOTS))(key)

    ens = EnsembleShooting(models=(m0, m1), horizon=HORIZON, shots=SHOTS, alpha=ALPHA, beta=BETA)
    object.__setattr__(ens, "candidates", lambda env, generator: to_port(cands))
    pa, info = ens(pe, ps, torch.Generator().manual_seed(0))
    jc = np.asarray(jinfo["cost"])
    assert info["cost"].shape == (SHOTS,)
    assert rel(info["cost"].numpy(), jc) <= TOL
    c = np.sort(jc)
    # the choice is decided: the best two apart by 10x the packages' difference
    assert c[1] - c[0] > 10 * np.abs(info["cost"].numpy() - jc).max()
    assert int(info["idx"]) == int(jinfo["idx"])
    np.testing.assert_allclose(pa.config.cylinders.r.numpy(), np.asarray(ja.config.cylinders.r),
                               rtol=1e-6, atol=1e-7)

    # one action of an episode through the port's loop, with the ensemble's spread
    one = dataclass_replace_actions(pe, 1)
    final, signals, chosen, costs = make_mpc_episode_fused(one, ens)(
        ps, torch.Generator().manual_seed(0))
    assert signals.shape == (1, 9, 3) and costs.shape == (1, SHOTS)
    assert rel(costs[0].numpy(), jc) <= TOL and float(chosen[0]) == float(costs[0].min())


def dataclass_replace_actions(env, actions: int):
    import dataclasses

    return dataclasses.replace(env, actions=actions)
