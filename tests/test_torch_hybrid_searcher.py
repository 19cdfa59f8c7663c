"""The hybrid controller with a CEM searcher (`make_hybrid_action_fused(
searcher=CEMShooting(...))`, as `--hybrid-cem` builds it) against the JAX
package's, on the CPU at the setup of tests/test_torch_hybrid_act.py (env
32^2, re-rank 16^2 through the batched route, horizon 2, top 3) with a
searcher of 8 shots, 3 elites and 2 rounds. JAX's searcher draws from its
key path are injected into the port's searcher (helpers in
tests/test_torch_cem.py); the prune takes the searcher's refined
population and costs in place of uniform candidates.

The chosen exact cost to 1e-4 relative, the same action wherever the two
lowest exact costs are decided (tests/test_torch_hybrid_act.py).
"""
import jax
import pytest
import torch
from test_torch_cem import cem_draws, inject
from test_torch_hybrid import to_port
from test_torch_hybrid_act import (HORIZON, SHOTS, TOPK, assert_same_choice, record,  # noqa: F401
                                   setup)

from waves_jl_tpu.control import CEMShooting as JaxCEM
from waves_jl_tpu.control import make_hybrid_action_fused as jax_make_hybrid_action_fused
from waves_jl_tpu_torch.control.mpc import CEMShooting, make_hybrid_action_fused
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
CEM = dict(horizon=HORIZON, shots=SHOTS, alpha=1.0, iters=2, elites=3)


def test_hybrid_with_cem_searcher_matches_jax(setup):  # noqa: F811
    je, pe, je_lo, pe_lo, jm, params, model, js, ps = setup
    key = jax.random.PRNGKey(17)
    jcem = JaxCEM(model=jm, **CEM)
    jact, _ = jax_make_hybrid_action_fused(
        je, jm, horizon=HORIZON, shots=SHOTS, topk=TOPK, alpha=1.0, interpret=True,
        searcher=jcem, rerank_env=je_lo, batched=True)
    ja, jc = jact(params, js, key)

    draws = cem_draws(je, key, HORIZON, SHOTS, CEM["elites"], CEM["iters"])
    searcher = CEMShooting(model=model, **CEM)
    inject(searcher, *draws)
    act, _ = make_hybrid_action_fused(pe, model, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                      alpha=1.0, rerank_env=pe_lo, searcher=searcher)
    pruned = []
    prune = act.prune

    def recorded_prune(state, generator):
        pruned.append(prune(state, generator))
        return pruned[-1]

    act.prune = recorded_prune
    seen = record(act)
    fk.reset_launch_counts()
    pa, pc = act(ps, torch.Generator().manual_seed(0))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    (actions, _, best), = pruned
    assert best.shape == (TOPK,)
    # the prune took the searcher's refined population, not round 0's draws
    assert not torch.equal(actions.config.cylinders.r, to_port(draws[0]).config.cylinders.r)
    (_, ev_cost), = seen
    assert ev_cost.shape == (TOPK,)
    assert_same_choice(pa, pc, ev_cost, ja, jc)


def test_searcher_must_share_horizon_and_alpha(setup):  # noqa: F811
    _, pe, _, _, _, _, model, _, _ = setup
    for bad in (dict(CEM, horizon=HORIZON + 1), dict(CEM, alpha=2.0)):
        with pytest.raises(ValueError, match="horizon and alpha"):
            make_hybrid_action_fused(pe, model, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                     alpha=1.0, searcher=CEMShooting(model=model, **bad))
