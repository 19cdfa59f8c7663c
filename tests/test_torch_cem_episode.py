"""The CEM slice as a whole: a 2-action warm CEM + polish episode of the
port (`make_mpc_episode_fused` with `CEMShooting(warm=True)`, fused 64^2
env windows) against the JAX package's pieces composed as its episode
composes them: `CEMShooting.__call__` with the incumbent (the box midpoint
first, then the previous plan shifted one window left), then XLA
`env_step`. JAX's draws for each selection are injected into the port
(helpers in tests/test_torch_cem.py).

The first incumbent, the box midpoint, is the zero action: JAX's polish
takes a NaN gradient of its norm there and then chooses the NaN sequence
(tests/test_torch_cem_zero_action.py), where the port takes the norm's
zero subgradient. The JAX side here runs with that subgradient patched
into its `compute_action_cost`, and the same values otherwise.

Signals and the final wave to 1e-5 relative (the port's fused window with
the split d/dx against the XLA window, as tests/test_torch_mpc.py holds
them), chosen costs to 1e-4 (float32 gradients through the polish), and
the same chosen sequence wherever the two lowest costs are decided.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_cem import (ELITES, ITERS, POLISH, SHOTS, assert_same_choice, cem_draws, inject,
                            jax_cem, jax_safe_action_cost, port_cem, tree_rel)
from test_torch_hybrid import envs, rel, wave_states
from test_torch_hybrid_act import HORIZON, models

from waves_jl_tpu.control import mpc as jax_mpc
from waves_jl_tpu.env import env_step as jax_env_step
from waves_jl_tpu_torch.control.mpc import CEMShooting, make_mpc_episode_fused
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
SIG_TOL, COST_TOL = 1e-5, 1e-4


def test_warm_cem_polish_episode_matches_jax_pieces(monkeypatch):
    monkeypatch.setattr(jax_mpc, "compute_action_cost", jax_safe_action_cost)
    je, pe = envs(64, 8, (16, 16))
    jm, params, model = models(je, pe)
    js, ps = wave_states(je, pe, seed=5, time_step=40, amplitude=1e-3)
    jcem = jax_cem(jm, warm=True, **POLISH)
    select = jax.jit(lambda p, s, k, i: jcem(p, je, s, k, incumbent=i))
    step = jax.jit(lambda s, a: jax_env_step(je, s, a))
    inc = jax.tree_util.tree_map(lambda lo, hi: jnp.broadcast_to((lo + hi) / 2.0,
                                                                 (HORIZON, *lo.shape)),
                                 je.action_space.low, je.action_space.high)
    keys = jax.random.split(jax.random.PRNGKey(21), je.actions)
    sets, noise, jsignals, jinfos = [], [], [], []
    for k in keys:
        cands, rounds = cem_draws(je, k, HORIZON, SHOTS, ELITES, ITERS)
        sets.append(cands)
        noise.extend(rounds)
        a, info = select(params, js, k, inc)
        js = step(js, a)[0]
        inc = jax.tree_util.tree_map(lambda v: jnp.concatenate([v[1:], v[-1:]]), info["seq"])
        jsignals.append(np.asarray(js.signal))
        jinfos.append(info)

    seen = []

    class Recorded(CEMShooting):
        def __call__(self, *args, incumbent=None):
            assert incumbent is not None  # the warm start reaches every selection
            seen.append(super().__call__(*args, incumbent=incumbent))
            return seen[-1]

    cem = Recorded(**dataclasses.asdict(port_cem(model, warm=True, **POLISH)))
    inject(cem, sets, noise)
    fk.reset_launch_counts()
    run = make_mpc_episode_fused(pe, cem)
    final, signals, chosen, costs = run(ps, torch.Generator().manual_seed(0))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    assert signals.shape == (2, 9, 3) and costs.shape == (2, SHOTS + POLISH["polish_topk"])
    assert final.time_step == 40 + 2 * 8
    assert float(signals[:, :, 2].max()) > 0.0
    assert rel(signals.numpy(), np.stack(jsignals)) <= SIG_TOL
    assert rel(final.wave.numpy(), np.asarray(js.wave)) <= SIG_TOL
    for (_, info), jinfo, c in zip(seen, jinfos, chosen):
        assert rel(info["cost"].numpy(), np.asarray(jinfo["cost"])) <= COST_TOL
        assert rel(float(c), float(jinfo["cost"][jinfo["idx"]])) <= COST_TOL
        assert_same_choice(info["cost"].numpy(), jinfo["cost"], info["idx"], jinfo["idx"])
        assert tree_rel(info["seq"], jinfo["seq"]) <= COST_TOL
