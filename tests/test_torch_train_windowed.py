"""The mixed-horizon windowed trainer against the JAX package's
`train_windowed` from the same seed, weights and episodes (horizons 1 and
2, batch 2, accumulate 2, two cycles: 8 micro-steps, 4 Adam updates): the
logged train and validation losses, per horizon too, within 1e-4
relative; the final predictions within 1e-4; the parameters within
4 lr updates (Adam moves a parameter whose gradient is near zero by about
lr a step whichever its sign); the checkpoints' steps and the JSONL log's
keys those of JAX's run."""
import json
import os

import jax
import numpy as np
import torch
from test_torch_train_model import episodes, models, rel, to_port_batch

from waves_jl_tpu.data import prepare_data as jax_prepare_data
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.train import TrainConfig as JaxConfig
from waves_jl_tpu.train import train_windowed as jax_train_windowed
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.train import TrainConfig, train_windowed

torch.set_num_threads(1)
LR = 1e-3
KW = dict(lr=LR, batch_size=2, accumulate=2, epochs=1, val_every=1, val_batches=2, seed=3)


def test_train_windowed_matches_jax(tmp_path):
    jm, params, pm = models()
    je, pe = episodes(4, seed=11)
    jcfg = JaxConfig(**KW)
    jp, _, jlog = jax_train_windowed(lambda p, b: jam.energy_loss(jm, p, b, sc_weight=4.0),
                                     params, je[:3], je[3:], jcfg, horizons=(1, 2),
                                     windows_per_horizon=8)
    cfg = TrainConfig(**KW, checkpoint_dir=str(tmp_path / "run"),
                      metrics_path=str(tmp_path / "run" / "metrics.jsonl"))
    _, state, log = train_windowed(lambda b: tam.energy_loss(pm, b, sc_weight=4.0), pm, pe[:3],
                                   pe[3:], cfg, horizons=(1, 2), windows_per_horizon=8)

    assert len(log.history) == len(jlog.history) == 2
    for got, want in zip(log.history, jlog.history):
        assert set(got) == set(want)
        assert got["step"] == want["step"] and got["epoch"] == want["epoch"]
        for k in ("train_loss", "val_loss", "train_loss_h1", "train_loss_h2", "val_loss_h1",
                  "val_loss_h2"):
            assert rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])
    assert state.gradient_step == 4 and state.inner_opt_state.count == 4
    updates = 4
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), expected=pm.state_dict())
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=4 * LR * updates,
                                   err_msg=k)
    batch = jax.tree_util.tree_map(lambda x: x[:2], jax_prepare_data(je[3], 2))
    with torch.no_grad():
        assert rel(pm(to_port_batch(batch)).numpy(), np.asarray(jm(jp, batch))) <= 1e-4
    assert sorted(os.listdir(tmp_path / "run")) == ["checkpoint_step=2", "checkpoint_step=4",
                                                    "metrics.jsonl"]
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [2, 4]
