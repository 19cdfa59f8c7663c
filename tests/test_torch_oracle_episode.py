"""A 2-action oracle episode of the port (`make_oracle_episode_fused`, the
shots scored together in chunks of 3 (`EXACT_CHUNK` set to 3) through the batched kernel's plain
version here) against the JAX package's (one program, `interpret=True`) on
the CPU: env 32^2, 8 steps a window, horizon 2, 5 shots, JAX's draws for
each action injected through `BatchedOracle.candidates`. Signals (2, 9, 3)
and chosen costs within 1e-5 relative, and the final wave within 1e-5;
`env_reward` of the final state within 1e-5 and `env_terminated` as JAX's
before and after the episode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states

from waves_jl_tpu.control import make_oracle_episode_fused as jax_make_oracle_episode_fused
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu.env import env_reward as jax_env_reward
from waves_jl_tpu.env import env_terminated as jax_env_terminated
from waves_jl_tpu_torch.control import mpc
from waves_jl_tpu_torch.control.mpc import BatchedOracle, make_oracle_episode_fused
from waves_jl_tpu_torch.env import env_reward, env_terminated

torch.set_num_threads(1)
N, STEPS, RES = 32, 8, (16, 16)
HORIZON, SHOTS, CHUNK = 2, 5, 3
TOL = 1e-5


def test_oracle_episode_matches_jax(monkeypatch):
    je, pe = envs(N, STEPS, RES)
    js, ps = wave_states(je, pe, seed=5, time_step=40, amplitude=1e-3)
    key = jax.random.PRNGKey(11)
    run_j = jax_make_oracle_episode_fused(je, horizon=HORIZON, shots=SHOTS, alpha=1.0,
                                          interpret=True)
    jf, jsig, jcost = run_j(js, key)

    # JAX's run draws each action's candidates from one of env.actions keys
    draw = jax.jit(lambda k: jax_build_action_sequence(je.action_space, k, HORIZON, SHOTS))
    sets = [to_port(draw(k)) for k in jax.random.split(key, je.actions)]
    monkeypatch.setattr(BatchedOracle, "candidates", lambda self, generator: sets.pop(0))
    monkeypatch.setattr(mpc, "EXACT_CHUNK", CHUNK)
    run = make_oracle_episode_fused(pe, horizon=HORIZON, shots=SHOTS, alpha=1.0)
    final, sig, cost = run(ps, torch.Generator().manual_seed(0))
    assert not sets
    assert sig.shape == (2, STEPS + 1, 3) and cost.shape == (2,)
    assert final.time_step == 40 + 2 * STEPS
    assert float(sig[:, :, 2].max()) > 0.0
    assert rel(sig.numpy(), np.asarray(jsig)) <= TOL
    assert rel(cost.numpy(), np.asarray(jcost)) <= TOL
    assert rel(final.wave.numpy(), np.asarray(jf.wave)) <= TOL
    assert rel(float(env_reward(final)), float(jax_env_reward(jf))) <= TOL
    for steps in (8, 16):  # the episode has 2 windows of 8 steps: running, then done
        j = dataclasses.replace(js, time_step=jnp.int32(steps))
        p = dataclasses.replace(ps, time_step=steps)
        assert env_terminated(pe, p) == bool(jax_env_terminated(je, j)) == (steps == 16)
