"""The controllers' surrogate fallback: the port's `RandomShooting` and
`CEMShooting` scoring through a model without `predict_shot_energy` or
`encode_wave`, the PINN baseline, whose `forward` runs on the observation
broadcast into an S-shot batch, against the JAX package's on the CPU:
env 32^2 with 8 steps a window (tests/test_torch_cem.py's), a PINN of 32
elements, h_size 8, nfreq 8, l_size 8 with the same weights in both
packages (drawn in numpy), horizon 2, 16 shots, alpha 10 so the costs
spread. JAX's draws are handed to the port through `candidates` and
`noise`; one jitted JAX program gives every JAX value.

* random shooting: costs to 1e-5 relative, the same choice;
* CEM's population (4 elites, 1 round): costs and sequences to 1e-5,
  the same elites;
* the polish (3 steps on the top 2, the gradient through the PINN's
  forward) from JAX's population: costs and sequences to 1e-4;
* a model with neither route (the NODE's (B, L) output) fails, as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cem import (ELITES, POLISH, assert_same_choice, assert_same_elites, cem_draws,
                            inject, tree_rel)
from test_torch_hybrid import envs, rel, to_port, wave_states
from test_torch_node import port_space

from waves_jl_tpu.control import CEMShooting as JaxCEM
from waves_jl_tpu.control import RandomShooting as JaxRandomShooting
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu.models import WaveControlPINN as JaxPINN
from waves_jl_tpu_torch.control.mpc import CEMShooting, RandomShooting
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.models.node import NODEEnergyModel
from waves_jl_tpu_torch.models.pinn import WaveControlPINN

torch.set_num_threads(1)
HORIZON, SHOTS, ALPHA, STEPS, ITERS = 2, 16, 10.0, 8, 1
MODEL = dict(elements=32, h_size=8, nfreq=8, l_size=8, integration_steps=STEPS)
COST_TOL, POLISH_TOL = 1e-5, 1e-4


def pinns(je):
    """The PINN in both packages with the same weights, drawn in numpy:
    kernels N(0, 1/fan_in), biases N(0, 0.01^2). (`init` gives only the
    leaves' shapes.)"""
    jm = JaxPINN.create(design_space=je.design_space, source_freq=1000.0, **MODEL)
    z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
    zeros = jax.tree_util.tree_map(lambda v: jnp.zeros((1, HORIZON, *v.shape), v.dtype),
                                   je.action_space.low)
    sample = {"s_wave": z(1, 16, 16, 4),
              "s_design": jax.tree_util.tree_map(lambda v: v[None], je.design_space.low),
              "a": zeros, "t": z(1, HORIZON * STEPS + 1)}
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = rng.standard_normal(leaf.shape) * 0.01
        return jnp.asarray(v, jnp.float32)

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0), sample))
    pm = WaveControlPINN(port_space(), 1000.0, device="cpu", **MODEL)
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict(), kind="WaveControlPINN"))
    return jm, params, pm


@pytest.fixture(scope="module")
def setup():
    je, pe = envs(32, STEPS, (16, 16))
    jm, params, pm = pinns(je)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    key_rs, key_cem = jax.random.PRNGKey(5), jax.random.PRNGKey(11)
    jrs = JaxRandomShooting(model=jm, horizon=HORIZON, shots=SHOTS, alpha=ALPHA)
    jcem = JaxCEM(model=jm, horizon=HORIZON, shots=SHOTS, alpha=ALPHA, iters=ITERS,
                  elites=ELITES, **POLISH)

    @jax.jit
    def run(p, s):
        first, info = jrs(p, je, s, key_rs)
        ja, jc = jcem.population(p, je, s, key_cem)
        jpa, jpc = jcem.polish(p, je, s, ja, jc)
        return {"rs": (first, info), "pop": (ja, jc), "polish": (jpa, jpc),
                "rs_cands": jax_build_action_sequence(je.action_space, key_rs, HORIZON, SHOTS),
                "cem_draws": cem_draws(je, key_cem, HORIZON, SHOTS, ELITES, ITERS)}

    want = run(params, js)
    return pe, pm, ps, want, want["cem_draws"]


def port_cem(model):
    return CEMShooting(model=model, horizon=HORIZON, shots=SHOTS, alpha=ALPHA, iters=ITERS,
                       elites=ELITES, **POLISH)


def test_random_shooting_takes_the_fallback_as_jax(setup):
    pe, pm, ps, want, _ = setup
    assert not hasattr(pm, "predict_shot_energy") and not hasattr(pm, "encode_wave")
    rs = RandomShooting(model=pm, horizon=HORIZON, shots=SHOTS, alpha=ALPHA)
    object.__setattr__(rs, "candidates", lambda env, generator: to_port(want["rs_cands"]))
    first, info = rs(pe, ps, torch.Generator().manual_seed(0))
    jfirst, jinfo = want["rs"]
    cost, jcost = info["cost"].numpy(), np.asarray(jinfo["cost"])
    assert cost.shape == (SHOTS,)
    assert rel(cost, jcost) <= COST_TOL
    assert_same_choice(cost, jcost, info["idx"], jinfo["idx"])
    assert tree_rel(first, jfirst) <= COST_TOL


def test_cem_population_takes_the_fallback_as_jax(setup):
    pe, pm, ps, want, draws = setup
    cem = port_cem(pm)
    inject(cem, *draws)
    pa, pc = cem.population(pe, ps, torch.Generator().manual_seed(0))
    ja, jc = want["pop"]
    jc = np.asarray(jc)
    assert rel(pc.numpy(), jc) <= COST_TOL
    assert tree_rel(pa, ja) <= COST_TOL
    assert assert_same_elites(pc.numpy(), jc, ELITES) > 0


def test_cem_polish_takes_the_fallback_as_jax(setup):
    pe, pm, ps, want, _ = setup
    ja, jc = want["pop"]
    pa, pc = port_cem(pm).polish(pe, ps, to_port(ja), torch.from_numpy(np.array(jc)))
    jpa, jpc = want["polish"]
    assert pc.shape == (SHOTS + POLISH["polish_topk"],)
    assert rel(pc.numpy(), np.asarray(jpc)) <= POLISH_TOL
    assert tree_rel(pa, jpa) <= POLISH_TOL
    assert float((pa.config.cylinders.r[SHOTS:] - to_port(ja).config.cylinders.r[
        torch.argsort(torch.from_numpy(np.array(jc)))[:POLISH["polish_topk"]]]).abs().max()) > 0


def test_a_model_with_no_route_fails_as_in_jax(setup):
    pe, _, ps, want, _ = setup
    node = NODEEnergyModel(port_space(), elements=32, h_size=8, nfreq=8,
                           integration_steps=STEPS, device="cpu")
    rs = RandomShooting(model=node, horizon=HORIZON, shots=SHOTS, alpha=ALPHA)
    object.__setattr__(rs, "candidates", lambda env, generator: to_port(want["rs_cands"]))
    with pytest.raises(IndexError):
        rs(pe, ps, torch.Generator().manual_seed(0))
