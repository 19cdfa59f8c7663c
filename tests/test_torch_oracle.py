"""The port's oracle selection (`make_oracle_action_fused`, the shots scored
together through the batched kernel's plain version here) against the JAX
package's (`interpret=True`) on the CPU at small size: env 32^2, 8 steps a
window, horizon 2, 5 shots, JAX's candidate draws injected into the port
through `BatchedOracle.candidates`. The chosen cost within 1e-5 relative
and the same action. The port's chunked route (`EXACT_CHUNK` set to 3, so
the shots split 3 + 2) against its sequential `OracleShooting` (each shot's windows
in turn through the env step): every cost within 1e-5 relative.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states

from waves_jl_tpu.control import make_oracle_action_fused as jax_make_oracle_action_fused
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu_torch.control import mpc
from waves_jl_tpu_torch.control.mpc import OracleShooting, make_oracle_action_fused
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
N, STEPS, RES = 32, 8, (16, 16)
HORIZON, SHOTS, CHUNK = 2, 5, 3
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    je, pe = envs(N, STEPS, RES)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    return je, pe, js, ps


def test_oracle_action_matches_jax_and_the_sequential_route(setup, monkeypatch):
    je, pe, js, ps = setup
    monkeypatch.setattr(mpc, "EXACT_CHUNK", CHUNK)
    key = jax.random.PRNGKey(7)
    jact, _ = jax_make_oracle_action_fused(je, horizon=HORIZON, shots=SHOTS, alpha=1.0,
                                           interpret=True)
    ja, jc = jact(js, key)
    cands = jax.jit(lambda k: jax_build_action_sequence(je.action_space, k, HORIZON, SHOTS))(key)

    act, step = make_oracle_action_fused(pe, horizon=HORIZON, shots=SHOTS, alpha=1.0)
    act.candidates = lambda generator: to_port(cands)
    fk.reset_launch_counts()
    actions, cost = act.select(ps, torch.Generator().manual_seed(0))
    pa, pc = act(ps, torch.Generator().manual_seed(0))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    assert cost.shape == (SHOTS,) and bool(torch.isfinite(cost).all())
    assert float(pc) == float(cost.min())
    assert rel(float(pc), float(jc)) <= TOL
    c = np.sort(cost.numpy())
    assert c[1] - c[0] > 10 * TOL * np.abs(c).max()  # the choice is decided
    np.testing.assert_allclose(pa.config.cylinders.r.numpy(), np.asarray(ja.config.cylinders.r),
                               rtol=1e-6, atol=1e-7)

    seq = OracleShooting(step_fn=step, horizon=HORIZON, shots=SHOTS, alpha=1.0)
    object.__setattr__(seq, "candidates", lambda env, generator: to_port(cands))
    sa, info = seq(pe, ps, torch.Generator().manual_seed(0))
    assert rel(cost.numpy(), info["cost"].numpy()) <= TOL
    assert int(info["idx"]) == int(torch.argmin(cost))
    torch.testing.assert_close(sa.config.cylinders.r, pa.config.cylinders.r, rtol=0, atol=0)
