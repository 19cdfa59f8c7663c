"""The port's `GradientShooting` against the JAX package's on the CPU: env
32^2, 8 steps a window, the narrow surrogate of
tests/test_torch_hybrid_act.py with the same weights in both packages, 4
shots over horizon 2, 3 projected gradient steps at lr 0.05 through the
batch forward, JAX's starting draws injected through
`GradientShooting.candidates`. The cost history (3, 4) and the final costs
within 1e-4 relative (float32 gradients through the latent rollout), the
same choice and its first action within 1e-4. Without a latent integrator
the selection's time grid falls back to the env's, as JAX's does.
"""
import jax
import numpy as np
import torch
from test_torch_cem import tree_rel
from test_torch_hybrid import envs, rel, to_port, wave_states
from test_torch_hybrid_act import HORIZON, models

from waves_jl_tpu.control import GradientShooting as JaxGradientShooting
from waves_jl_tpu.control.mpc import _mpc_batch as jax_mpc_batch
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu.control.mpc import selection_tspan as jax_selection_tspan
from waves_jl_tpu_torch.control.mpc import GradientShooting, _mpc_batch, selection_tspan

torch.set_num_threads(1)
SHOTS, STEPS, LR = 4, 3, 0.05
TOL = 1e-4


def test_gradient_shooting_matches_jax():
    je, pe = envs(32, 8, (16, 16))
    jm, params, model = models(je, pe)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    key = jax.random.PRNGKey(19)
    jgs = JaxGradientShooting(model=jm, horizon=HORIZON, shots=SHOTS, lr=LR, steps=STEPS)
    ja, jinfo = jax.jit(lambda p, s, k: jgs(p, je, s, k))(params, js, key)
    cands = jax.jit(lambda k: jax_build_action_sequence(je.action_space, k, HORIZON, SHOTS))(key)

    gs = GradientShooting(model=model, horizon=HORIZON, shots=SHOTS, lr=LR, steps=STEPS)
    object.__setattr__(gs, "candidates", lambda env, generator: to_port(cands))
    pa, info = gs(pe, ps, torch.Generator().manual_seed(0))
    assert info["cost_history"].shape == (STEPS, SHOTS) and info["cost"].shape == (SHOTS,)
    assert rel(info["cost_history"].numpy(), np.asarray(jinfo["cost_history"])) <= TOL
    assert rel(info["cost"].numpy(), np.asarray(jinfo["cost"])) <= TOL
    # the descent moves the costs
    assert float(np.abs(np.diff(info["cost_history"].numpy(), axis=0)).max()) > 100 * TOL
    assert int(info["idx"]) == int(jinfo["idx"])
    assert tree_rel(pa, ja) <= TOL

    jb = jax_mpc_batch(je, js, cands, HORIZON, SHOTS, model=jm)
    pb = _mpc_batch(pe, ps, to_port(cands), HORIZON, SHOTS, model=model)
    assert set(pb) == set(jb) == {"s_wave", "s_design", "a", "t"}
    assert pb["s_wave"].shape == (SHOTS, 16, 16, 4) and pb["t"].shape == (SHOTS, 2 * 2 + 1)
    np.testing.assert_allclose(pb["s_wave"].numpy(), np.asarray(jb["s_wave"]), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(pb["t"].numpy(), np.asarray(jb["t"]))
    assert tree_rel(pb["s_design"], jb["s_design"]) <= 1e-6

    # no latent integrator: the env's time grid
    want = np.asarray(jax_selection_tspan(None, je, js, HORIZON, SHOTS))
    got = selection_tspan(None, pe, ps, HORIZON, SHOTS)
    assert got.shape == (SHOTS, HORIZON * 8 + 1)
    np.testing.assert_array_equal(got.numpy(), want)
