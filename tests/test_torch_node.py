"""The neural-ODE baseline (`models/node.py`) against the JAX package's, on
the CPU at the sizes of tests/test_baseline_models.py (elements 64, h_size
8, nfreq 8, 10 steps a window, 16^2 observations), on windows of an
episode from the port's own datagen (48^2, 3 actions) and JAX's initial
parameters carried across by `from_jax_params`:

- the forward (B, L) at horizon 2: 1e-5 relative to its largest value;
- `node_loss`: 1e-5 relative; its gradient 1e-4 relative to each leaf's
  largest magnitude against `jax.grad`;
- the rollout's checkpoint modes "none", "step" and "sqrt" give the same
  values and gradients, bit for bit.

The helpers below (the episode in both packages, the tree converters)
serve the other baseline test files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.models import NODEEnergyModel as JaxNODE
from waves_jl_tpu.models import node_loss as jax_node_loss
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.data import generate_episode, prepare_data
from waves_jl_tpu_torch.env import RandomDesignPolicy, make_wave_env
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.models.node import NODEEnergyModel, node_loss

torch.set_num_threads(1)
E, H_SIZE, NFREQ, STEPS, L_SIZE = 64, 8, 8, 10, 8
RES = (16, 16)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_space():
    return td.build_triple_ring_design_space(device="cpu")


def to_jax(x):
    """A port tree (dict, design dataclass or tensor) as the JAX package's."""
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        cls = getattr(w, type(x).__name__)
        return cls(**{f.name: to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return jnp.asarray(x.detach().numpy())


def port_episode(seed: int = 0, actions: int = 3, steps: int = STEPS):
    """One random-policy episode of the port's datagen on the CPU: 48^2
    over [-15, 15]^2, the triple ring, `steps` steps a window, 16^2
    observations."""
    dim = tdims.two_dim(15.0, 48, device="cpu")
    src = tsrc.GaussianSource.create(tdims.build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                     [0.3], [1.0], 1000.0)
    env = make_wave_env(dim, port_space(), src, resolution=RES, integration_steps=steps,
                        actions=actions)
    gen = torch.Generator().manual_seed(seed)
    return generate_episode(env, RandomDesignPolicy(env.action_space), gen)[1]


def batches(horizon: int, seed: int = 0):
    """The episode's windows of `horizon` actions: (port batch, JAX batch)."""
    bp = prepare_data(port_episode(seed), horizon)
    return bp, to_jax(bp)


def assert_grads_close(port: dict, jax_tree, kind: str, tol: float = 1e-4):
    """Each port gradient against JAX's, relative to the leaf's largest
    magnitude; every parameter has its JAX leaf."""
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_tree), kind=kind)
    assert set(port) == set(want)
    for k, g in port.items():
        assert rel(g.numpy(), want[k].numpy()) <= tol, (k, rel(g.numpy(), want[k].numpy()))


def port_grads(model, fn):
    ps = dict(model.named_parameters())
    loss = fn()
    return loss, dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))


@pytest.fixture(scope="module")
def setup():
    bp, bj = batches(horizon=2)
    jm = JaxNODE.create(design_space=w.build_triple_ring_design_space(), elements=E,
                        h_size=H_SIZE, nfreq=NFREQ, integration_steps=STEPS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), bj)
    pm = NODEEnergyModel(port_space(), elements=E, h_size=H_SIZE, nfreq=NFREQ,
                         integration_steps=STEPS, device="cpu")
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict(),
                                       kind="NODEEnergyModel"))

    @jax.jit
    def run(p):
        def loss(p):
            return jax_node_loss(jm, p, bj), jm(p, bj)

        (lj, pred), g = jax.value_and_grad(loss, has_aux=True)(p)
        return pred, lj, g

    return pm, bp, run(params)


def test_forward_matches_jax(setup):
    pm, bp, (want, _, _) = setup
    with torch.no_grad():
        got = pm(bp).numpy()
    assert got.shape == np.asarray(want).shape == (2, 2 * STEPS + 1)
    assert np.isfinite(got).all()
    assert rel(got, want) <= 1e-5


def test_node_loss_and_gradient_match_jax(setup):
    pm, bp, (_, lj, gj) = setup
    lp, gp = port_grads(pm, lambda: node_loss(pm, bp))
    assert rel(float(lp.detach()), float(lj)) <= 1e-5
    assert_grads_close(gp, gj, "NODEEnergyModel")


def test_checkpoint_modes_are_identical(setup):
    pm, bp, _ = setup
    out = {}
    for mode in ("none", "step", "sqrt"):
        pm.integrator = dataclasses.replace(pm.integrator, checkpoint=mode)
        loss, g = port_grads(pm, lambda: node_loss(pm, bp))
        with torch.no_grad():
            out[mode] = (pm(bp), loss.detach(), g)
    pm.integrator = dataclasses.replace(pm.integrator, checkpoint="sqrt")
    for mode in ("step", "sqrt"):
        assert torch.equal(out[mode][0], out["none"][0])
        assert torch.equal(out[mode][1], out["none"][1])
        for k in out["none"][2]:
            assert torch.equal(out[mode][2][k], out["none"][2][k]), (mode, k)
