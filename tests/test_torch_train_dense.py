"""The dense trainer (`train`, over a prepared dataset) and the streaming
trainer (`train_streaming`, over host episodes) against the JAX package's
from the same seed, weights and episodes: the logged train and validation
losses within 1e-4 relative, the final predictions within 1e-4, the
parameters within 4 lr updates (Adam's near-zero-gradient steps)."""
import jax
import numpy as np
import pytest
import torch
from test_torch_train_model import episodes, models, rel, to_port_batch

from waves_jl_tpu.data import prepare_data as jax_prepare_data
from waves_jl_tpu.data import prepare_dataset as jax_prepare_dataset
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.train import TrainConfig as JaxConfig
from waves_jl_tpu.train import train as jax_train
from waves_jl_tpu.train import train_streaming as jax_train_streaming
from waves_jl_tpu_torch.data import prepare_dataset
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.train import TrainConfig, train, train_streaming

torch.set_num_threads(1)
LR = 1e-3


def _compare(pm, jm, jp, log, jlog, je, updates):
    assert len(log.history) == len(jlog.history) >= 2
    for got, want in zip(log.history, jlog.history):
        assert set(got) == set(want)
        assert got["step"] == want["step"] and got["epoch"] == want["epoch"]
        for k in ("train_loss", "val_loss"):
            assert rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), expected=pm.state_dict())
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=4 * LR * updates,
                                   err_msg=k)
    batch = jax.tree_util.tree_map(lambda x: x[:2], jax_prepare_data(je[3], 2))
    with torch.no_grad():
        assert rel(pm(to_port_batch(batch)).numpy(), np.asarray(jm(jp, batch))) <= 1e-4


@pytest.fixture(scope="module")
def setup():
    return models(), episodes(4, seed=12)


def test_train_matches_jax(setup):
    (jm, params, pm), (je, pe) = setup
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    kw = dict(lr=LR, batch_size=2, accumulate=2, epochs=1, val_every=2, val_batches=2, seed=5)
    jp, _, jlog = jax_train(lambda p, b: jam.energy_loss(jm, p, b), params,
                            jax_prepare_dataset(je[:3], 1), jax_prepare_dataset(je[3:], 1),
                            JaxConfig(**kw))
    _, state, log = train(lambda b: tam.energy_loss(pm, b), pm, prepare_dataset(pe[:3], 1),
                          prepare_dataset(pe[3:], 1), TrainConfig(**kw))
    assert state.gradient_step == 3  # 12 windows, 6 micro-steps
    _compare(pm, jm, jp, log, jlog, je, 3)


def test_train_streaming_matches_jax(setup):
    (jm, params, pm), (je, pe) = setup
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    kw = dict(lr=LR, batch_size=2, accumulate=2, epochs=2, val_every=1, val_batches=2, seed=6)
    jp, _, jlog = jax_train_streaming(lambda p, b: jam.energy_loss_ranking(jm, p, b), params,
                                      je[:3], jax_prepare_dataset(je[3:], 2), JaxConfig(**kw),
                                      horizon=2)
    _, state, log = train_streaming(lambda b: tam.energy_loss_ranking(pm, b), pm, pe[:3],
                                    prepare_dataset(pe[3:], 2), TrainConfig(**kw), horizon=2)
    assert state.gradient_step == 4  # 2 epochs of 4 minibatches of 9 windows
    _compare(pm, jm, jp, log, jlog, je, 4)
