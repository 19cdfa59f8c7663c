"""Behaviour cloning in the port (`scripts.train_bc`) against the JAX
script's (`scripts_tpu/train_bc.py`) at the JAX tests' sizes: 4 synthetic
recorded episodes of 4 windows (16^2 observations, radius-delta actions of
up to 0.2 inside a 0.2 action box), drawn in numpy.

* `episodes_to_bc_dataset` stacks every window's observation, design and
  action as JAX's does, bit for bit;
* `train.loop.train` on `bc_loss` from JAX's initial policy parameters (h
  8) against JAX's `train` with the same `TrainConfig` (lr 1e-3, batch 2,
  accumulate 2, val_every 1, seed 5): the logged train and validation
  losses within 1e-4 relative, the parameters within 4 lr a leaf after its
  3 updates (Adam's near-zero-gradient steps), and the last checkpoint,
  written by the port, read by JAX's `load_checkpoint` equal to the port's
  parameters.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_train_model import H_SIZE, episodes, jax_space, port_space, rel

import waves_jl_tpu.utils.cache
from waves_jl_tpu.designs import build_action_space as jax_action_space
from waves_jl_tpu.models import policy as jpol
from waves_jl_tpu.train import TrainConfig as JaxConfig
from waves_jl_tpu.train import load_checkpoint as jax_load_checkpoint
from waves_jl_tpu.train import train as jax_train
from waves_jl_tpu_torch.designs import build_action_space
from waves_jl_tpu_torch.models import policy as tpol
from waves_jl_tpu_torch.models.convert import policy_from_jax_params
from waves_jl_tpu_torch.scripts.train_bc import episodes_to_bc_dataset
from waves_jl_tpu_torch.train import TrainConfig, train
from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def jax_train_bc():
    """scripts_tpu/train_bc.py as a module, with its compilation cache off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(waves_jl_tpu.utils.cache, "enable_persistent_cache", lambda *a, **k: False)
        mp.syspath_prepend(os.path.join(ROOT, "scripts_tpu"))
        spec = importlib.util.spec_from_file_location(
            "jax_train_bc", os.path.join(ROOT, "scripts_tpu", "train_bc.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module


def test_bc_dataset_and_training_match_jax(tmp_path):
    je, pe = episodes(4, seed=21)
    jdata = jax_train_bc().episodes_to_bc_dataset(je)
    pdata = episodes_to_bc_dataset(pe)
    assert pdata["s_wave"].shape == (16, 16, 16, 4)
    assert set(pdata) == set(jdata) == {"s_wave", "s_design", "a"}
    for name in pdata:
        got, want = tree_leaves(pdata[name]), jax.tree_util.tree_leaves(jdata[name])
        assert len(got) == len(want)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    pol_j = jpol.AmortizedPolicy.create(jax_space(), jax_action_space(jax_space().low, 0.2),
                                        h_size=H_SIZE)
    pol_p = tpol.AmortizedPolicy.create(port_space(), build_action_space(port_space().low, 0.2),
                                        h_size=H_SIZE, device="cpu")
    params = jax.jit(pol_j.init)(jax.random.PRNGKey(0), jdata["s_wave"][0],
                                 jax.tree_util.tree_map(lambda x: x[0], jdata["s_design"]))
    pol_p.net.load_state_dict(policy_from_jax_params(params, expected=pol_p.net.state_dict()))
    split = lambda d, s: jax.tree_util.tree_map(lambda x: x[s], d)  # noqa: E731
    psplit = lambda d, s: tree_map(lambda x: x[s], d)  # noqa: E731
    kw = dict(lr=LR, batch_size=2, accumulate=2, epochs=1, val_every=1, val_batches=1, seed=5)
    jp, _, jlog = jax_train(lambda p, b: jpol.bc_loss(pol_j, p, b), params,
                            split(jdata, slice(0, 12)), split(jdata, slice(12, 16)),
                            JaxConfig(**kw))
    out = str(tmp_path)
    _, state, log = train(lambda b: tpol.bc_loss(pol_p, b), pol_p.net,
                          psplit(pdata, slice(0, 12)), psplit(pdata, slice(12, 16)),
                          TrainConfig(**kw, checkpoint_dir=out))
    assert state.gradient_step == 3  # 12 pairs, 6 micro-steps of 2, 2 a update
    assert len(log.history) == len(jlog.history) == 3
    for got, want in zip(log.history, jlog.history):
        assert got["step"] == want["step"] and got["epoch"] == want["epoch"]
        for k in ("train_loss", "val_loss"):
            assert rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])
    want = policy_from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                  expected=pol_p.net.state_dict())
    for k, v in pol_p.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=4 * LR * 3,
                                   err_msg=k)

    lp, _, step = jax_load_checkpoint(os.path.join(out, "checkpoint_step=3"), params)
    assert step == 3
    got = policy_from_jax_params(jax.tree_util.tree_map(np.asarray, lp),
                                 expected=pol_p.net.state_dict())
    for k, v in pol_p.net.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
