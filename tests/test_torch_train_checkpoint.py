"""Checkpoints between the packages, both ways, at the JAX tests' sizes:

- a port checkpoint taken mid-run (3 micro-steps, accumulate 1 or 2) loads
  in JAX's `load_checkpoint` with `opt_state_like`, and one more JAX update
  equals one more port update within 1e-5;
- a JAX checkpoint taken the same way resumes in the port the same way;
- `to_jax_params(from_jax_params(npz))` gives the tracked `ref500_h8s4`
  (flagship) and `bc_pools3` (policy) params.npz bit for bit, key for key.
"""
import os

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_train_model import episodes, models, to_port_batch

from waves_jl_tpu.data import prepare_data as jax_prepare_data
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.train import load_checkpoint as jax_load
from waves_jl_tpu.train import make_optimizer as jax_make_optimizer
from waves_jl_tpu.train import save_checkpoint as jax_save
from waves_jl_tpu.train import TrainConfig as JaxConfig
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import (from_jax_params, policy_from_jax_params,
                                               policy_to_jax_params, to_jax_params)
from waves_jl_tpu_torch.train import (TrainConfig, load_checkpoint, make_optimizer,
                                      make_train_step, save_checkpoint)
from waves_jl_tpu_torch.train.checkpoint import load_params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jm, params, pm = models()
    je, _ = episodes(1, seed=8)
    data = jax_prepare_data(je[0], 1)
    batches = [jax.tree_util.tree_map(lambda x, i=i: x[i:i + 2], data) for i in range(3)]
    batches.append(jax.tree_util.tree_map(lambda x: x[1:3], data))
    grad = jax.jit(jax.grad(lambda p, b: jam.energy_loss(jm, p, b, sc_weight=4.0)))
    return jm, params, pm, batches, grad


def _jax_steps(opt, params, state, batches, grad):
    update = jax.jit(opt.update)
    for b in batches:
        u, state = update(grad(params, b), state, params)
        params = optax.apply_updates(params, u)
    return params, state


def _close(pm, jparams, tol=1e-5):
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), expected=pm.state_dict())
    for k, v in pm.state_dict().items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=tol, atol=tol * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_port_checkpoint_resumes_in_jax(setup, tmp_path, accumulate):
    jm, params, pm, batches, grad = setup
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    cfg = TrainConfig(lr=LR, accumulate=accumulate)
    opt = make_optimizer(cfg)
    step = make_train_step(lambda b: tam.energy_loss(pm, b, sc_weight=4.0), opt)
    state = opt.init(dict(pm.named_parameters()))
    for b in batches[:3]:
        _, state, _ = step(pm, state, to_port_batch(b))
    save_checkpoint(str(tmp_path), pm, state, step=3)
    _, state, _ = step(pm, state, to_port_batch(batches[3]))  # the port's next update

    jopt = jax_make_optimizer(JaxConfig(lr=LR, accumulate=accumulate))
    jp, js, jstep = jax_load(str(tmp_path), params, opt_state_like=jopt.init(params))
    assert jstep == 3
    jp, js = _jax_steps(jopt, jp, js, batches[3:], grad)
    _close(pm, jp)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_jax_checkpoint_resumes_in_port(setup, tmp_path, accumulate):
    jm, params, pm, batches, grad = setup
    jopt = jax_make_optimizer(JaxConfig(lr=LR, accumulate=accumulate))
    jp, js = _jax_steps(jopt, params, jopt.init(params), batches[:3], grad)
    jax_save(str(tmp_path), jp, js, step=3)
    jp, js = _jax_steps(jopt, jp, js, batches[3:], grad)  # JAX's next update

    opt = make_optimizer(TrainConfig(lr=LR, accumulate=accumulate))
    _, state, step_no = load_checkpoint(str(tmp_path), pm,
                                        opt_state_like=opt.init(dict(pm.named_parameters())))
    assert step_no == 3 and state is not None
    step = make_train_step(lambda b: tam.energy_loss(pm, b, sc_weight=4.0), opt)
    step(pm, state, to_port_batch(batches[3]))
    _close(pm, jp)


@pytest.mark.parametrize("which", ["ref500_h8s4/checkpoint_step=2600",
                                   "bc_pools3/checkpoint_step=4500"])
def test_tracked_params_round_trip_bit_for_bit(which):
    named = load_params(os.path.join(ROOT, "models", which))
    policy = which.startswith("bc_")
    state = (policy_from_jax_params if policy else from_jax_params)(named)
    back = (policy_to_jax_params if policy else to_jax_params)(state)
    assert set(back) == set(named)
    for k, v in named.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
