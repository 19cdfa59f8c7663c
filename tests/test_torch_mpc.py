"""The slice end to end at small size: a 2-action MPC episode at n = 64
with a narrow surrogate and 16 candidate sequences per action, injected
into both packages. The JAX side is put together from its public pieces
(observe, `predict_shot_energy`, `compute_action_cost`, argmin, XLA
`env_step`); the port runs `make_mpc_episode_fused`. Signals agree to 1e-5
relative (the fused window's bound) and costs to 1e-5 relative (the
surrogate's convolutions and matmuls sum in other orders; 6e-7 measured);
the chosen candidate is the same wherever the best two costs differ by more
than 10x that tolerance. The action penalty weighs 10 here so that the
candidates' costs spread far enough for that check to apply."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import waves_jl_tpu as w
from waves_jl_tpu.control.mpc import compute_action_cost as jax_action_cost
from waves_jl_tpu.control.mpc import selection_tspan as jax_selection_tspan
from waves_jl_tpu.env import env_observe as jax_env_observe
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.env import env_step as jax_env_step
from waves_jl_tpu.env import make_wave_env as jax_make_wave_env
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.control.mpc import RandomShooting, make_mpc_episode_fused
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
N, STEPS, ACTIONS, SHOTS, HORIZON = 64, 20, 2, 16, 2
SIG_TOL, COST_TOL = 1e-5, 1e-5
ALPHA = 10.0
MODEL = dict(elements=32, h_size=16, nfreq=12, integration_steps=5, dt=4e-5)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def radii_actions(a, jax_side: bool):
    S, H, m = a.shape
    if jax_side:
        z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
        return w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(z(S, H, m, 2), jnp.asarray(a),
                                                               z(S, H, m))),
                       w.Cylinders(z(S, H, 1, 2), z(S, H, 1), z(S, H, 1)))
    z = torch.zeros
    return td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(z(S, H, m, 2), torch.from_numpy(a),
                                                              z(S, H, m))),
                    td.Cylinders(z(S, H, 1, 2), z(S, H, 1), z(S, H, 1)))


class InjectedShooting(RandomShooting):
    """Random shooting whose candidates are given, one set per selection."""

    def __init__(self, model, sets):
        super().__init__(model=model, horizon=HORIZON, shots=SHOTS, alpha=ALPHA)
        object.__setattr__(self, "sets", list(sets))

    def candidates(self, env, generator):
        return radii_actions(self.sets.pop(0), jax_side=False)


def test_mpc_episode_matches_jax_pieces():
    jdim = w.two_dim(15.0, N)
    jsrc = w.GaussianSource.create(w.build_grid(jdim), jnp.array([[-10.0, -10.0]]),
                                   jnp.array([[-10.0, 10.0]]), jnp.array([0.3]),
                                   jnp.array([1.0]), 1000.0)
    jspace = w.build_triple_ring_design_space()
    je = jax_make_wave_env(jdim, jspace, jsrc, resolution=(32, 32), integration_steps=STEPS,
                           actions=ACTIONS)
    jm = JaxModel.create(design_space=jspace, source_freq=1000.0, **MODEL)
    js = jax_env_reset(je, jax.random.PRNGKey(0))
    L = HORIZON * MODEL["integration_steps"] + 1
    sample = {"s_wave": jnp.full((1, 32, 32, 4), 1e-3, jnp.float32),
              "s_design": jax.tree_util.tree_map(lambda v: v[None], js.design),
              "a": radii_actions(np.zeros((1, HORIZON, 18), np.float32), True),
              "t": jnp.zeros((1, L), jnp.float32)}
    params = jm.init(jax.random.PRNGKey(1), sample)

    pdim = tdims.two_dim(15.0, N, device="cpu")
    psrc = tsrc.GaussianSource.create(tdims.build_grid(pdim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                      [0.3], [1.0], 1000.0)
    pspace = td.build_triple_ring_design_space(device="cpu")
    pe = tenv.make_wave_env(pdim, pspace, psrc, resolution=(32, 32), integration_steps=STEPS,
                            actions=ACTIONS)
    model = AcousticEnergyModel(pspace, 1000.0, device="cpu", **MODEL)
    model.load_state_dict(from_jax_params(params, expected=model.state_dict()), strict=True)

    ps = tenv.env_reset(pe, torch.Generator().manual_seed(0))
    lo = pspace.low
    design = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        lo.config.cylinders.pos, torch.from_numpy(np.array(js.design.config.cylinders.r)),
        lo.config.cylinders.c)), lo.core)
    src = ps.source
    src = tsrc.GaussianSource(src.grid, src.mu_low, src.mu_high, src.sigma, src.a,
                              torch.from_numpy(np.array(js.source.shape)), src.freq)
    ps = tenv.EnvState(ps.wave, design, src, ps.signal, 0)

    scale = float(pe.action_space.high.config.cylinders.r[0])
    rng = np.random.default_rng(0)
    sets = [rng.uniform(-scale, scale, (SHOTS, HORIZON, 18)).astype(np.float32)
            for _ in range(ACTIONS)]

    jsignals, jcosts, jidx = [], [], []
    for cand in sets:
        ja = radii_actions(cand, True)
        obs = jax_env_observe(je, js)
        t = jax_selection_tspan(jm, je, js, HORIZON, SHOTS)
        energy = jm.predict_shot_energy(params, obs.wave, js.design, ja, t)
        cost = np.asarray(energy + ALPHA * jax_action_cost(ja))
        idx = int(np.argmin(cost))
        js, _ = jax_env_step(je, js, jax.tree_util.tree_map(lambda x: x[idx, 0], ja))
        jsignals.append(np.asarray(js.signal))
        jcosts.append(cost)
        jidx.append(idx)

    fk.reset_launch_counts()
    run = make_mpc_episode_fused(pe, InjectedShooting(model, sets))
    final, signals, chosen, costs = run(ps, torch.Generator().manual_seed(1))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain version
    assert signals.shape == (ACTIONS, STEPS + 1, 3) and costs.shape == (ACTIONS, SHOTS)
    assert final.time_step == ACTIONS * STEPS
    assert rel(signals.numpy(), np.stack(jsignals)) <= SIG_TOL
    assert rel(costs.numpy(), np.stack(jcosts)) <= COST_TOL
    decided = 0
    for k in range(ACTIONS):
        c = np.sort(jcosts[k])
        if c[1] - c[0] > 10 * COST_TOL * np.abs(c).max():
            assert int(torch.argmin(costs[k])) == jidx[k]
            decided += 1
        np.testing.assert_allclose(float(chosen[k]), float(costs[k].min()), rtol=0, atol=0)
    assert decided > 0
    assert rel(final.wave.numpy(), np.asarray(js.wave)) <= SIG_TOL
