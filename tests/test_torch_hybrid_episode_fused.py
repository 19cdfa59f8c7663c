"""The one-call hybrid episode (`make_hybrid_episode_fused`) on the CPU at
small size (env 32^2, re-rank 16^2, 8 steps a window, horizon 2, 8 shots,
top 3; the helpers of tests/test_torch_hybrid_act.py).

* Against the port's per-action loop through the sequential re-rank
  (`make_hybrid_action_fused(batched=False)`, act then step, K rollouts in
  turn: the JAX episode's re-rank route) from the same generator: the same
  choices, so signals and final state equal exactly, and the chosen costs
  within 1e-5 relative (the batched and sequential re-ranks' bound in
  tests/test_torch_hybrid_rerank.py), with one exact round, and with two
  rounds and a coarser re-rank grid.
* Against the JAX package's `make_hybrid_episode_fused(..., interpret=True)`
  (one program over the actions, sequential re-rank; one exact round on
  the env's grid, one Pallas program to compile), JAX's per-action
  candidate draws injected through `HybridShooting.candidates`: each
  chosen cost within 1e-4 relative with the choice decided (the best two
  of the port's exact costs apart by more than 10x that), the signals and
  the final wave within 1e-5 relative, the bounds of
  tests/test_torch_hybrid_episode.py. Two rounds on the coarse grid are
  held to JAX's selection in tests/test_torch_hybrid_act_rounds.py.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_hybrid import rel
from test_torch_hybrid_act import (COST_TOL, ELITES, HORIZON, SHOTS, TOPK, inject, jax_draws,
                                   record, setup)  # noqa: F401 (a fixture)

from waves_jl_tpu.control import make_hybrid_episode_fused as jax_make_hybrid_episode_fused
from waves_jl_tpu_torch.control import make_hybrid_action_fused, make_hybrid_episode_fused
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
SIG_TOL = 1e-5


@pytest.mark.parametrize("rounds,coarse", [(1, False), (2, True)])
def test_episode_equals_the_per_action_loop(setup, rounds, coarse):  # noqa: F811
    _, pe, _, pe_lo, _, _, model, _, ps = setup
    kw = dict(horizon=HORIZON, shots=SHOTS, topk=TOPK, alpha=1.0,
              rerank_env=pe_lo if coarse else None, exact_rounds=rounds, exact_elites=ELITES)
    run = make_hybrid_episode_fused(pe, model, **kw)
    fk.reset_launch_counts()
    final, signals, costs = run(ps, torch.Generator().manual_seed(4))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    assert signals.shape == (pe.actions, pe.integration_steps + 1, 3) and costs.shape == (2,)
    assert final.time_step == ps.time_step + pe.actions * pe.integration_steps

    act, step = make_hybrid_action_fused(pe, model, batched=False, **kw)
    gen, s, sigs, cs = torch.Generator().manual_seed(4), ps, [], []
    for _ in range(pe.actions):
        a, c = act(s, gen)
        s, _ = step(s, a)
        sigs.append(s.signal)
        cs.append(c)
    torch.testing.assert_close(signals, torch.stack(sigs), rtol=0, atol=0)
    assert rel(costs.numpy(), torch.stack(cs).numpy()) <= SIG_TOL
    torch.testing.assert_close(final.wave, s.wave, rtol=0, atol=0)
    assert bool(torch.isfinite(signals).all()) and float(signals[:, :, 2].max()) > 0.0


def test_episode_matches_jax_fused_episode(setup):  # noqa: F811
    je, pe, _, _, jm, params, model, js, ps = setup
    rounds, key = 1, jax.random.PRNGKey(13)
    run_j = jax_make_hybrid_episode_fused(je, jm, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                          alpha=1.0, interpret=True,
                                          exact_rounds=rounds, exact_elites=ELITES)
    jfinal, jsignals, jcosts = run_j(params, js, key)

    draws = [jax_draws(je, k, rounds) for k in jax.random.split(key, je.actions)]
    run = make_hybrid_episode_fused(pe, model, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                    alpha=1.0, exact_rounds=rounds, exact_elites=ELITES)
    inject(run.act, [c for c, _ in draws], [z for _, n in draws for z in n])
    seen = record(run.act)
    final, signals, costs = run(ps, torch.Generator().manual_seed(0))
    assert len(seen) == je.actions
    for i, (_, ev_cost) in enumerate(seen):
        assert ev_cost.shape == (rounds * TOPK,)
        assert rel(float(costs[i]), float(jcosts[i])) <= COST_TOL
        c = np.sort(ev_cost.numpy())
        assert c[1] - c[0] > 10 * COST_TOL * np.abs(c).max()  # the choice is decided
    assert float(np.asarray(jsignals)[..., 2].max()) > 0.0
    assert rel(signals.numpy(), np.asarray(jsignals)) <= SIG_TOL
    assert rel(final.wave.numpy(), np.asarray(jfinal.wave)) <= SIG_TOL
    assert final.time_step == int(jfinal.time_step)
