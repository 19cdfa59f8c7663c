"""The hybrid slice as a whole: a 2-action episode of the port's sequential
one-round hybrid controller (surrogate prune, 16^2 exact re-rank, fused
32^2 env window) against the JAX package's per-action loop as
`scripts_tpu/mpc.py` drives it (`k, kk = split(k)`; act; step), with JAX's
candidate draws injected into the port.

Chosen exact costs are held to 1e-4 relative and the chosen actions must
agree where decided (see tests/test_torch_hybrid_act.py). Both packages'
env windows take the two-pass bf16 split x-derivative (`x_matmul=True`,
the default of each), so the signals and the final wave are held to 1e-5
relative, the bound tests/test_torch_fused.py holds the port's window to
against JAX's XLA window.
"""
import jax
import numpy as np
import torch
from test_torch_hybrid import rel
from test_torch_hybrid_act import (HORIZON, SHOTS, TOPK, assert_same_choice, inject, record,
                                   setup)  # noqa: F401 (a fixture)

from waves_jl_tpu.control import make_hybrid_action_fused as jax_make_hybrid_action_fused
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu_torch.control.mpc import make_hybrid_action_fused

torch.set_num_threads(1)
ACTIONS = 2
SIG_TOL = 1e-5


def test_hybrid_episode_matches_jax_per_action_loop(setup):  # noqa: F811
    je, pe, je_lo, pe_lo, jm, params, model, js, ps = setup
    jact, jstep = jax_make_hybrid_action_fused(
        je, jm, horizon=HORIZON, shots=SHOTS, topk=TOPK, alpha=1.0, interpret=True,
        rerank_env=je_lo, batched=False)
    draw = jax.jit(lambda kk: jax_build_action_sequence(je.action_space, kk, HORIZON, SHOTS))
    k = jax.random.PRNGKey(9)
    s, jsignals, jchosen, jcosts, sets = js, [], [], [], []
    for _ in range(ACTIONS):
        k, kk = jax.random.split(k)
        a, c = jact(params, s, kk)
        s, _ = jstep(s, a)
        jsignals.append(np.asarray(s.signal))
        jchosen.append(a)
        jcosts.append(c)
        sets.append(draw(kk))

    act, step = make_hybrid_action_fused(pe, model, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                         alpha=1.0, rerank_env=pe_lo, batched=False)
    inject(act, sets, [])
    seen = record(act)
    p, gen = ps, torch.Generator().manual_seed(0)
    for i in range(ACTIONS):
        a, c = act(p, gen)
        p, _ = step(p, a)
        assert p.time_step == int(s.time_step) - (ACTIONS - 1 - i) * je.integration_steps
        assert rel(p.signal.numpy(), jsignals[i]) <= SIG_TOL
        assert_same_choice(a, c, seen[i][1], jchosen[i], jcosts[i])
    assert float(p.signal[:, 2].max()) > 0.0
    assert rel(p.wave.numpy(), np.asarray(s.wave)) <= SIG_TOL
