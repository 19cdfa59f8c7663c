"""The port's hybrid controller (`make_hybrid_action_fused`) against the JAX
package's, on the CPU at small size: env 32^2, re-rank 16^2, 8 steps a
window, horizon 2, 8 shots, top 3, a narrow surrogate with the same weights
in both packages, and JAX's own candidate draws and refinement noise
injected into the port through `HybridShooting.candidates` and `.noise`.

Both packages' re-rank windows take the two-pass bf16 split x-derivative
(`x_matmul=True`, the default of each), so only sin and the sums round
apart; the chosen exact cost is held to 1e-4 relative, and the chosen
action must be the same wherever the best two exact costs differ by more
than 10x that tolerance.

This file holds the batched one-round controller; the other cases, one
JAX program each, are in tests/test_torch_hybrid_act_rounds.py (batched,
two rounds), tests/test_torch_hybrid_act_sequential.py (sequential, two
rounds) and tests/test_torch_hybrid_episode.py (sequential, one round, over
a 2-action episode), which import the helpers below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states

import waves_jl_tpu as w
from waves_jl_tpu.control import make_hybrid_action_fused as jax_make_hybrid_action_fused
from waves_jl_tpu.control.mpc import _tree_normal as jax_tree_normal
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu_torch.control.mpc import make_hybrid_action_fused
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
N, N_LO, STEPS, RES = 32, 16, 8, (16, 16)
HORIZON, SHOTS, TOPK, ELITES = 2, 8, 3, 2
COST_TOL = 1e-4
MODEL = dict(elements=32, h_size=16, nfreq=12, integration_steps=2, dt=4e-5)


def models(je, pe, seed: int = 0):
    """The narrow stride-4 surrogate in both packages with the same weights,
    drawn in numpy: kernels N(0, 1/fan_in), biases N(0, 0.01^2), scales 1.
    (`init` only gives the leaves' shapes: running flax's initialiser
    takes seconds.)"""
    jm = JaxModel.create(design_space=je.design_space, source_freq=1000.0, **MODEL)
    L = HORIZON * MODEL["integration_steps"] + 1
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    sample = {"s_wave": z(1, *RES, 4),
              "s_design": jax.tree_util.tree_map(lambda v: v[None], je.design_space.low),
              "a": w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(
                  z(1, HORIZON, 18, 2), z(1, HORIZON, 18), z(1, HORIZON, 18))),
                  w.Cylinders(z(1, HORIZON, 1, 2), z(1, HORIZON, 1), z(1, HORIZON, 1))),
              "t": z(1, L)}
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name.endswith("['scale']"):
            v = np.ones(leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * 0.01
        return jnp.asarray(v, jnp.float32)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), sample)
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = AcousticEnergyModel(pe.design_space, 1000.0, device="cpu", **MODEL)
    model.load_state_dict(from_jax_params(params, expected=model.state_dict()), strict=True)
    return jm, params, model


def jax_draws(je, key, exact_rounds: int):
    """The candidate sequences and refinement noise JAX's hybrid draws from
    `key` (`waves_jl_tpu/control/mpc.py`, `_hybrid_act`), in one jitted
    program (op by op they take seconds)."""
    @jax.jit
    def draws(key):
        if exact_rounds > 1:
            key, k_pool = jax.random.split(key)
        else:
            k_pool = key
        cands = jax_build_action_sequence(je.action_space, k_pool, HORIZON, SHOTS)
        low1 = jax.tree_util.tree_map(lambda v: jnp.broadcast_to(v, (TOPK, HORIZON, *v.shape)),
                                      je.action_space.low)
        noise = []
        for _ in range(exact_rounds - 1):
            key, kn = jax.random.split(key)
            noise.append(jax_tree_normal(kn, low1))
        return cands, noise

    return draws(key)


def inject(act, cands, noise):
    """Hand JAX's draws to the port's controller, in the order it asks:
    `cands` one candidate set, or a list of one per selection."""
    sets = list(cands) if isinstance(cands, list) else [cands]
    rounds = list(noise)
    act.candidates = lambda generator: to_port(sets.pop(0))
    act.noise = lambda generator, like: to_port(rounds.pop(0))


@pytest.fixture(scope="module")
def setup():
    je, pe = envs(N, STEPS, RES)
    je_lo, pe_lo = envs(N_LO, STEPS, (8, 8))
    jm, params, model = models(je, pe)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    return je, pe, je_lo, pe_lo, jm, params, model, js, ps


def first_vec(action) -> np.ndarray:
    return np.asarray(action.config.cylinders.r)


def record(act) -> list:
    """Keep every (evaluated actions, exact costs) that `act.rerank` gives,
    so a test can see how far apart the best exact costs are."""
    seen, rerank = [], act.rerank

    def recorded(*args):
        seen.append(rerank(*args))
        return seen[-1]

    act.rerank = recorded
    return seen


def assert_same_choice(pa, pc, ev_cost, ja, jc):
    """The chosen cost within COST_TOL of JAX's; the best two of the port's
    exact costs `ev_cost` apart by more than 10x COST_TOL, and so the same
    first action."""
    assert rel(float(pc), float(jc)) <= COST_TOL
    c = np.sort(ev_cost.numpy())
    assert c[1] - c[0] > 10 * COST_TOL * np.abs(c).max()  # the choice is decided
    np.testing.assert_allclose(first_vec(pa), first_vec(ja), rtol=1e-6, atol=1e-7)


def check_act(setup, batched: bool, exact_rounds: int):
    je, pe, je_lo, pe_lo, jm, params, model, js, ps = setup
    key = jax.random.PRNGKey(5)
    jact, _ = jax_make_hybrid_action_fused(
        je, jm, horizon=HORIZON, shots=SHOTS, topk=TOPK, alpha=1.0, interpret=True,
        rerank_env=je_lo, batched=batched, exact_rounds=exact_rounds, exact_elites=ELITES)
    ja, jc = jact(params, js, key)

    act, _ = make_hybrid_action_fused(pe, model, horizon=HORIZON, shots=SHOTS, topk=TOPK,
                                      alpha=1.0, rerank_env=pe_lo, batched=batched,
                                      exact_rounds=exact_rounds, exact_elites=ELITES)
    inject(act, *jax_draws(je, key, exact_rounds))
    seen = record(act)
    fk.reset_launch_counts()
    pa, pc = act(ps, torch.Generator().manual_seed(0))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    (ev_actions, ev_cost), = seen
    assert ev_cost.shape == (exact_rounds * TOPK,)
    assert_same_choice(pa, pc, ev_cost, ja, jc)


def test_batched_hybrid_act_matches_jax(setup):
    check_act(setup, batched=True, exact_rounds=1)
