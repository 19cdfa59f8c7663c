"""One update of the port's ranking fine-tune (`scripts.train_pools.
make_pool_update`: the window MSE plus lam x `pool_ranking_loss` under
plain Adam) against the JAX script's `update` (`scripts_tpu/train_pools.py`:
`energy_loss + lam * pool_ranking_loss`, `jax.value_and_grad`,
`optax.adam`), at the JAX tests' sizes on the same numpy inputs and JAX's
initial parameters. The pools are those of tests/test_torch_train_losses.py,
whose candidates differ enough (a latent step of 7.3e-4, the design MLP's
first kernel scaled by 300) for the ranking gradient to be well
conditioned. The anchor and ranking losses within 1e-5 relative, every
parameter after the update within 1e-5 of its leaf's largest magnitude,
and the checkpoint, written by the port, read by JAX's `load_checkpoint`
with its Adam state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from test_torch_train_model import (RES, actions, designs, episodes, models, rel,
                                    to_port_batch)

from waves_jl_tpu.data import prepare_data as jax_prepare_data
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.train import load_checkpoint as jax_load_checkpoint
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.scripts.train_pools import make_pool_update
from waves_jl_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)
LR, LAM, TAU, LW = 3e-5, 1.0, 1.0, 0.5
TOL = 1e-5


def pools(rng):
    """2 pools of 4 candidates over horizon 4: (jax dict, port dict)."""
    P, K, H = 2, 4, 4
    s_wave = (rng.standard_normal((P, RES, RES, 4)) * 0.1).astype(np.float32)
    dj, dp = designs(rng, (P,))
    aj, ap = actions(rng, (P, K, H), scale=3.0)
    t0 = np.array([2.1e-3, 3.3e-3], np.float32)
    y = rng.uniform(0.0, 1.0, (P, K)).astype(np.float32)
    return ({"s_wave": jnp.asarray(s_wave), "s_design": dj, "t0": jnp.asarray(t0), "a": aj,
             "y_true": jnp.asarray(y)},
            {"s_wave": torch.from_numpy(s_wave), "s_design": dp, "t0": torch.from_numpy(t0),
             "a": ap, "y_true": torch.from_numpy(y)})


def test_one_pool_update_matches_jax(tmp_path):
    jm, params, pm = models(dt=7.3e-4)
    params["design_encoder"]["params"]["MLP_0"]["Dense_0"]["kernel"] *= 300.0
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    rng = np.random.default_rng(5)
    pj, pp = pools(rng)
    je, _ = episodes(1, seed=7)
    wj = jax.tree_util.tree_map(lambda x: x[:2], jax_prepare_data(je[0], 1))

    opt = optax.adam(LR)

    @jax.jit
    def update(params, opt_state, wbatch, pbatch):  # scripts_tpu/train_pools.py's update
        def total(p):
            anchor = jam.energy_loss(jm, p, wbatch)
            rank = jam.pool_ranking_loss(jm, p, pbatch, tau=TAU, listwise_weight=LW)
            return anchor + LAM * rank, (anchor, rank)

        (_, (anchor, rank)), grads = jax.value_and_grad(total, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, anchor, rank

    jp, jstate, ja, jr = update(params, opt.init(params), wj, pj)

    popt, pupdate = make_pool_update(pm, LR, LAM, TAU, LW)
    state, pa, pr = pupdate(popt.init(dict(pm.named_parameters())), to_port_batch(wj), pp)
    assert state.count == 1
    assert rel(float(pa), float(ja)) <= TOL and rel(float(pr), float(jr)) <= TOL
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), expected=pm.state_dict())
    before = from_jax_params(params, expected=pm.state_dict())
    for k, v in pm.state_dict().items():
        assert rel(v.numpy(), want[k].numpy()) <= TOL, (k, rel(v.numpy(), want[k].numpy()))
        assert not torch.equal(v, before[k]), k  # every leaf took the step

    path = str(tmp_path / "checkpoint_step=1")
    save_checkpoint(path, pm, state, 1)
    lp, lstate, step = jax_load_checkpoint(path, params, opt.init(params))
    assert step == 1 and int(lstate[0].count) == 1
    for x, y in zip(jax.tree_util.tree_leaves(lp), jax.tree_util.tree_leaves(jp)):
        assert rel(np.asarray(x), np.asarray(y)) <= TOL
    for x, y in zip(jax.tree_util.tree_leaves(lstate[0].mu),
                    jax.tree_util.tree_leaves(jstate[0].mu)):
        assert rel(np.asarray(x), np.asarray(y)) <= 1e-4  # the gradients' bound
