"""A deliberate difference of the port's CEM polish from the JAX package's:
the gradient of the action penalty at a zero action. The penalty sums
sqrt(|a|^2) over the horizon; at a = 0 sqrt's derivative is infinite, so
JAX's polish of a zero action (the warm start's first incumbent, the box
midpoint) gives a NaN sequence with a NaN cost, which `argmin` then
chooses. The port takes the norm's subgradient 0 there and the same value.

At the setup of tests/test_torch_cem.py, with the zero action as round 0's
candidate 0 (alpha 10 makes it the cheapest): JAX's polish gives NaN; the
port's is finite, inside the box, and agrees to 1e-4 relative with JAX's
polish run with the zero subgradient patched into its
`compute_action_cost`; the port's penalty values agree with JAX's to
1e-6 relative (sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_cem import (ELITES, ITERS, POLISH, POLISH_TOL, SHOTS, cem_draws, inject, jax_cem,
                            jax_safe_action_cost, port_cem, setup, tree_rel)  # noqa: F401
from test_torch_hybrid import rel, to_port
from test_torch_hybrid_act import HORIZON

from waves_jl_tpu.control import mpc as jax_mpc
from waves_jl_tpu_torch.control.mpc import compute_action_cost

torch.set_num_threads(1)


def test_polish_of_a_zero_action_is_finite(setup, monkeypatch):  # noqa: F811
    je, pe, jm, params, model, js, ps = setup
    key = jax.random.PRNGKey(14)
    zero = jax.tree_util.tree_map(lambda v: jnp.zeros((HORIZON, *v.shape), v.dtype),
                                  je.action_space.low)
    jcem = jax_cem(jm, **POLISH)
    ja, jc = jax.jit(lambda p, s, k, i: jcem.population(p, je, s, k, incumbent=i))(
        params, js, key, zero)
    assert int(jnp.argmin(jc)) == 0  # the zero action leads the population

    def polish(p, s, a, c):
        return jcem.polish(p, je, s, a, c)

    _, jpc = jax.jit(polish)(params, js, ja, jc)
    assert bool(jnp.isnan(jpc[SHOTS]))  # JAX: the polished zero action is NaN
    np.testing.assert_allclose(compute_action_cost(to_port(ja)).numpy(),
                               np.asarray(jax_mpc.compute_action_cost(ja)), rtol=1e-6)
    monkeypatch.setattr(jax_mpc, "compute_action_cost", jax_safe_action_cost)
    jpa, jpc = jax.jit(lambda *args: polish(*args))(params, js, ja, jc)  # traced anew

    cem = port_cem(model, **POLISH)
    inject(cem, *cem_draws(je, key, HORIZON, SHOTS, ELITES, ITERS))
    pa, pc = cem.polish(pe, ps, to_port(ja), torch.from_numpy(np.array(jc)))
    assert bool(torch.isfinite(pc).all())
    assert float(pa.config.cylinders.r.abs().max()) <= float(pe.action_space.high.config
                                                              .cylinders.r.max())
    assert rel(pc.numpy(), np.asarray(jpc)) <= POLISH_TOL
    assert tree_rel(pa, jpa) <= POLISH_TOL
