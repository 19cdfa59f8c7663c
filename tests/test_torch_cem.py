"""The port's `CEMShooting` against the JAX package's, on the CPU at small
size: env 32^2, the narrow stride surrogate of tests/test_torch_hybrid_act.py
(32 elements, h 16, the same weights in both packages), horizon 2, 16
shots, 4 elites, 2 refinement rounds, alpha 10 so the costs spread. JAX's
draws from its key path (`split` -> `build_action_sequence(k0)`, then per
round `split` -> `_tree_normal(kn, low)`) are made in JAX and handed to the
port through `CEMShooting.candidates` and `.noise`.

* `population`: costs to 1e-5 relative (the surrogate's matmuls and
  convolutions sum in other orders; 9.4e-7 measured), the refined
  sequences to 1e-5 (1.9e-7), and the same elites wherever neighbouring
  costs differ by more than 10x that.
* `polish` (3 steps on the top 2 at lr 0.02) on JAX's population and
  costs: polished sequences and costs to 1e-4 relative, float32 gradients
  through the latent rollout (measured 4.2e-7 and 8.4e-7).
* `__call__` with an incumbent and the polish: the same chosen index,
  first action and sequence, to 1e-4.

tests/test_torch_cem_episode.py, tests/test_torch_cem_zero_action.py and
tests/test_torch_hybrid_searcher.py import the helpers below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states
from test_torch_hybrid_act import HORIZON, models

from waves_jl_tpu.control import CEMShooting as JaxCEM
from waves_jl_tpu.control.mpc import _tree_normal as jax_tree_normal
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu.designs import design_with_vec as jax_design_with_vec
from waves_jl_tpu_torch.control.mpc import CEMShooting
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
SHOTS, ELITES, ITERS, ALPHA = 16, 4, 2, 10.0
POLISH = dict(polish_steps=3, polish_topk=2, polish_lr=0.02)
COST_TOL, POLISH_TOL = 1e-5, 1e-4


def cem_draws(env, key, horizon: int, shots: int, elites: int, iters: int):
    """The round-0 candidates and per-round noise JAX's `CEMShooting`
    draws from `key`, in one jitted program."""
    @jax.jit
    def draws(key):
        key, k0 = jax.random.split(key)
        cands = jax_build_action_sequence(env.action_space, k0, horizon, shots)
        low = jax.tree_util.tree_map(
            lambda v: jnp.broadcast_to(v, (shots - elites, horizon, *v.shape)),
            env.action_space.low)
        noise = []
        for _ in range(iters):
            key, kn = jax.random.split(key)
            noise.append(jax_tree_normal(kn, low))
        return cands, noise

    return draws(key)


def jax_safe_action_cost(actions):
    """JAX's `compute_action_cost` with the zero subgradient of a zero
    action's norm that the port takes (the same values; JAX's own gradient
    there is NaN, tests/test_torch_cem_zero_action.py)."""
    vecs = jax.vmap(jax.vmap(lambda a: a.to_vec()))(actions)
    sq = jnp.sum(vecs ** 2, axis=-1)
    nonzero = sq > 0
    return jnp.sum(jnp.where(nonzero, jnp.sqrt(jnp.where(nonzero, sq, 1.0)), 0.0), axis=-1)


def inject(cem, cands, noise):
    """Hand JAX's draws to a port `CEMShooting` in the order it asks:
    `cands` one candidate set, or a list of one per selection; `noise` the
    rounds' draws in order, over all selections."""
    sets = list(cands) if isinstance(cands, list) else [cands]
    rounds = list(noise)
    object.__setattr__(cem, "candidates", lambda env, generator: to_port(sets.pop(0)))
    object.__setattr__(cem, "noise", lambda generator, like: to_port(rounds.pop(0)))


def tree_rel(port_tree, jax_tree) -> float:
    """The largest relative difference over the leaves of two trees (an
    all-zero leaf compares absolutely)."""
    return max(rel(a.detach().numpy(), b.numpy())
               for a, b in zip(tree_leaves(port_tree), tree_leaves(to_port(jax_tree))))


def assert_same_elites(port_cost, jax_cost, k: int):
    """The k lowest costs are the same candidates, unless two neighbours
    in the sorted order lie within 10x COST_TOL of each other there."""
    c = np.sort(jax_cost)
    gaps = np.diff(c[:k + 1]) > 10 * COST_TOL * np.abs(c).max()
    if gaps[-1]:  # the k-th and (k+1)-th are apart: the set is decided
        assert set(np.argsort(port_cost, kind="stable")[:k]) == set(np.argsort(jax_cost)[:k])
    return int(gaps.sum())


@pytest.fixture(scope="module")
def setup():
    je, pe = envs(32, 8, (16, 16))
    jm, params, model = models(je, pe)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    return je, pe, jm, params, model, js, ps


def port_cem(model, **kw):
    return CEMShooting(model=model, horizon=HORIZON, shots=SHOTS, alpha=ALPHA, iters=ITERS,
                       elites=ELITES, **kw)


def jax_cem(jm, **kw):
    return JaxCEM(model=jm, horizon=HORIZON, shots=SHOTS, alpha=ALPHA, iters=ITERS,
                  elites=ELITES, **kw)


@pytest.fixture(scope="module")
def population(setup):
    """JAX's population from key 11 with the polish settings, and the
    draws it made."""
    je, pe, jm, params, model, js, ps = setup
    key = jax.random.PRNGKey(11)
    jcem = jax_cem(jm, **POLISH)
    ja, jc = jax.jit(lambda p, s, k: jcem.population(p, je, s, k))(params, js, key)
    return jcem, ja, np.asarray(jc), cem_draws(je, key, HORIZON, SHOTS, ELITES, ITERS)


def test_population_matches_jax(setup, population):
    je, pe, jm, params, model, js, ps = setup
    _, ja, jc, draws = population
    cem = port_cem(model)
    inject(cem, *draws)
    pa, pc = cem.population(pe, ps, torch.Generator().manual_seed(0))
    assert pc.shape == (SHOTS,)
    assert rel(pc.numpy(), jc) <= COST_TOL
    assert tree_rel(pa, ja) <= COST_TOL
    assert assert_same_elites(pc.numpy(), jc, ELITES) > 0
    assert float(np.ptp(jc)) > 10 * COST_TOL * float(np.abs(jc).max())  # the costs spread


def test_polish_matches_jax(setup, population):
    je, pe, jm, params, model, js, ps = setup
    jcem, ja, jc, _ = population
    jpa, jpc = jax.jit(lambda p, s, a, c: jcem.polish(p, je, s, a, c))(params, js, ja, jc)
    pa, pc = port_cem(model, **POLISH).polish(pe, ps, to_port(ja), torch.from_numpy(jc.copy()))
    k = POLISH["polish_topk"]
    assert pc.shape == (SHOTS + k,)
    assert rel(pc.numpy(), np.asarray(jpc)) <= POLISH_TOL
    assert tree_rel(pa, jpa) <= POLISH_TOL
    # the polish moved the sequences, inside the box, and the set only grew
    moved = pa.config.cylinders.r[SHOTS:] - pa.config.cylinders.r[torch.argsort(pc[:SHOTS])[:k]]
    assert float(moved.abs().max()) > 0.0
    torch.testing.assert_close(pc[:SHOTS], torch.from_numpy(jc.copy()), rtol=0, atol=0)
    high = float(pe.action_space.high.config.cylinders.r.max())
    assert float(pa.config.cylinders.r.abs().max()) <= high


def assert_same_choice(cost, jax_cost, idx, jax_idx):
    """The chosen index is JAX's, and the choice is decided: the two
    lowest costs lie further apart than 10x the largest difference between
    the packages' costs."""
    jax_cost = np.asarray(jax_cost)
    gap = np.diff(np.sort(jax_cost)[:2])[0]
    assert gap > 10 * float(np.abs(cost - jax_cost).max())
    assert int(idx) == int(jax_idx)


def test_call_with_incumbent_matches_jax(setup):
    je, pe, jm, params, model, js, ps = setup
    key = jax.random.PRNGKey(13)
    rng = np.random.default_rng(13)
    scale = float(pe.action_space.high.config.cylinders.r[0])
    inc_r = rng.uniform(-scale, scale, (HORIZON, 18)).astype(np.float32)
    jinc = jax_design_with_vec(jax.tree_util.tree_map(
        lambda v: jnp.zeros((HORIZON, *v.shape), v.dtype), je.action_space.low),
        jnp.asarray(inc_r))
    jcem = jax_cem(jm, **POLISH)
    jfirst, jinfo = jax.jit(lambda p, s, k, i: jcem(p, je, s, k, incumbent=i))(
        params, js, key, jinc)
    cem = port_cem(model, **POLISH)
    inject(cem, *cem_draws(je, key, HORIZON, SHOTS, ELITES, ITERS))
    first, info = cem(pe, ps, torch.Generator().manual_seed(0), incumbent=to_port(jinc))
    assert set(info) == {"cost", "idx", "seq"}
    assert info["cost"].shape == (SHOTS + POLISH["polish_topk"],)
    assert rel(info["cost"].numpy(), np.asarray(jinfo["cost"])) <= POLISH_TOL
    assert_same_choice(info["cost"].numpy(), jinfo["cost"], info["idx"], jinfo["idx"])
    assert tree_rel(info["seq"], jinfo["seq"]) <= POLISH_TOL
    assert tree_rel(first, jfirst) <= POLISH_TOL
