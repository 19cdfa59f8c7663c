"""The pool ranking loss and the behaviour-cloning loss against the JAX
package at the JAX tests' sizes, on the same numpy inputs and JAX's
initial parameters: values 1e-5 relative, gradients 1e-4 relative to each
leaf's largest magnitude against `jax.grad`."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_train_model import (H_SIZE, RES, STEPS, _index, _port_grads, actions,
                                    assert_grads_close, designs, jax_space, models, port_space,
                                    rel)

from waves_jl_tpu.designs import build_action_space as jax_action_space
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.models import policy as jpol
from waves_jl_tpu_torch.designs import build_action_space
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models import policy as tpol
from waves_jl_tpu_torch.models.convert import from_jax_params, policy_from_jax_params
from waves_jl_tpu_torch.physics.dynamics import build_tspan

torch.set_num_threads(1)


def test_pool_ranking_loss_matches_jax():
    """On pools whose candidates differ: a latent step of 7.3e-4 (not a
    multiple of the 1 kHz source's half period, so the latent source is not
    sampled at its zeros) lets the latent wave move, the design MLP's first
    kernel scaled by 300 on both sides makes the speed follow the actions,
    and radius deltas of up to 3 over 4 windows spread the candidates'
    energies by about 9% of their mean. The z-scores remove each pool's
    common mode, so the gradient of a leaf shared by the pool's candidates
    (the wave encoder's) is a difference of sums: the spread keeps it well
    conditioned, and every leaf is held at 1e-4."""
    jm, params, pm = models(dt=7.3e-4)
    params["design_encoder"]["params"]["MLP_0"]["Dense_0"]["kernel"] *= 300.0
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    rng = np.random.default_rng(5)
    P, K, H = 2, 4, 4
    s_wave = (rng.standard_normal((P, RES, RES, 4)) * 0.1).astype(np.float32)
    dj, dp = designs(rng, (P,))
    aj, ap = actions(rng, (P, K, H), scale=3.0)
    t0 = np.array([2.1e-3, 3.3e-3], np.float32)
    y_true = rng.uniform(0.0, 1.0, (P, K)).astype(np.float32)
    pj = {"s_wave": jnp.asarray(s_wave), "s_design": dj, "t0": jnp.asarray(t0), "a": aj,
          "y_true": jnp.asarray(y_true)}
    pp = {"s_wave": torch.from_numpy(s_wave), "s_design": dp, "t0": torch.from_numpy(t0),
          "a": ap, "y_true": torch.from_numpy(y_true)}
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jam.pool_ranking_loss(jm, p, pj)))(params)
    lp, gp = _port_grads(pm, lambda: tam.pool_ranking_loss(pm, pp))
    assert rel(float(lp.detach()), float(lj)) <= 1e-5
    tgrid = torch.from_numpy(build_tspan(0.0, 7.3e-4, STEPS * H))
    with torch.no_grad():
        e_hat = torch.stack([pm.shot_energy(pp["s_wave"][p], _index(dp, p), _index(ap, p),
                                            (pp["t0"][p] + tgrid)[None].expand(K, -1))
                             for p in range(P)])
    spread = float((e_hat.std(dim=1, unbiased=False) / e_hat.mean(dim=1)).min())
    assert spread > 0.05
    assert_grads_close(gp, gj)


def test_bc_loss_matches_jax():
    space_j, space_p = jax_space(), port_space()
    act_j, act_p = jax_action_space(space_j.low, 0.2), build_action_space(space_p.low, 0.2)
    pol_j = jpol.AmortizedPolicy.create(space_j, act_j, h_size=H_SIZE)
    pol_p = tpol.AmortizedPolicy.create(space_p, act_p, h_size=H_SIZE, device="cpu")
    rng = np.random.default_rng(3)
    B = 4
    obs = (rng.standard_normal((B, RES, RES, 4)) * 0.1).astype(np.float32)
    dj, dp = designs(rng, (B,))
    aj, ap = actions(rng, (B,), scale=0.2)
    params = jax.jit(pol_j.init)(jax.random.PRNGKey(1), jnp.asarray(obs[0]),
                        jax.tree_util.tree_map(lambda x: x[0], dj))
    pol_p.net.load_state_dict(policy_from_jax_params(params, expected=pol_p.net.state_dict()))
    bj = {"s_wave": jnp.asarray(obs), "s_design": dj, "a": aj}
    bp = {"s_wave": torch.from_numpy(obs), "s_design": dp, "a": ap}
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jpol.bc_loss(pol_j, p, bj)))(params)
    lp, gp = _port_grads(pol_p.net, lambda: tpol.bc_loss(pol_p, bp))
    assert rel(float(lp.detach()), float(lj)) <= 1e-5
    assert_grads_close(gp, gj, policy=True)
