"""The data-parallel windowed trainer and the trainers' `mesh=` on the CPU,
against the JAX package at the sizes of tests/test_torch_train_model.py
(16^2 observations, 64 elements, h_size 8, nfreq 8, 8 steps a window),
JAX's initial weights carried across:

- `sample_window_indices_dp` draws JAX's indices exactly from one seed;
- `make_dp_scan_train_steps_windowed` on 8 CPU shards against JAX's on
  the 8 virtual CPU devices, as tests/test_windows_and_cem.py holds JAX's
  against its single-device trainer (one episode a shard, local indices,
  K = 2, batch 8): the losses within 1e-4 relative, every leaf within
  rtol 5e-3 / atol 2e-5, the replicas equal bit for bit;
- `train_windowed(mesh=)` and `train(mesh=)` on 4 CPU shards for one
  chunk: finite logged losses, the index rows JAX's trainers hand their
  data-parallel step from the same seed and data (read by running JAX's
  trainers with their step and validation replaced by recorders), and
  every replica `replicate` built equal to the caller's model;
- `mesh=` without `replicate=`, and a store or batch that does not divide
  over the mesh, raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_model import E, H_SIZE, NFREQ, STEPS, episodes, models, port_space

import waves_jl_tpu.parallel as jax_parallel
import waves_jl_tpu.train.loop as jax_loop
import waves_jl_tpu.train.windows as jax_windows
from waves_jl_tpu.data import prepare_dataset as jax_prepare_dataset
from waves_jl_tpu.models import energy_loss as jax_energy_loss
from waves_jl_tpu.parallel import make_mesh as jax_make_mesh
from waves_jl_tpu.train import TrainConfig as JaxConfig
from waves_jl_tpu_torch.data import prepare_dataset
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.parallel import Replicas, make_mesh
from waves_jl_tpu_torch.parallel import dp as port_dp
from waves_jl_tpu_torch.train import TrainConfig, train, train_windowed
from waves_jl_tpu_torch.train import windows as port_windows
from waves_jl_tpu_torch.train.optim import Adam

torch.set_num_threads(1)
LR = 1e-3
KW = dict(elements=E, h_size=H_SIZE, nfreq=NFREQ, integration_steps=STEPS)


def loss_of(m):
    return lambda b: tam.energy_loss(m, b)


def replicate_into(built: list):
    """replicate(device) -> (model, loss) that records what it builds."""
    def replicate(device):
        m = tam.AcousticEnergyModel(port_space(), 1000.0, device=device, seed=1, **KW)
        built.append(m)
        return m, loss_of(m)

    return replicate


def port_model(params):
    pm = tam.AcousticEnergyModel(port_space(), 1000.0, device="cpu", **KW)
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    return pm


def assert_equal_to(models_, model):
    assert models_
    for m in models_:
        assert all(torch.equal(a, b) for a, b in zip(m.parameters(), model.parameters()))


@pytest.mark.parametrize("seed,n_eps,actions,horizon,count,shards,batch",
                         [(0, 8, 4, 2, 3, 4, 8), (7, 16, 20, 8, 5, 8, 8), (3, 4, 4, 1, 9, 2, 6)])
def test_sample_window_indices_dp_equals_jax(seed, n_eps, actions, horizon, count, shards,
                                             batch):
    args = (n_eps, actions, horizon, count, shards, batch)
    got = port_windows.sample_window_indices_dp(np.random.default_rng(seed), *args)
    want = jax_windows.sample_window_indices_dp(np.random.default_rng(seed), *args)
    assert got.shape == (count, batch, 2)
    np.testing.assert_array_equal(got, want)


def test_dp_windowed_matches_jax():
    jm, params, _ = models()
    je, pe = episodes(8, seed=21)
    horizon, K, B = 2, 2, 8
    starts = np.random.default_rng(1).integers(0, 4 - horizon + 1, size=(K, B))
    # shard d holds episode d: local episode 0 in block d
    l_idx = np.stack([np.zeros((K, B), int), starts], -1).astype(np.int32)

    mesh_j = jax_make_mesh(8, axis_name="data")
    store_j = jax_windows.stack_episodes(je, sharding=jax_windows.store_sharding(mesh_j))
    opt = optax.adam(LR)
    run_j = jax_windows.make_dp_scan_train_steps_windowed(
        lambda p, b: jax_energy_loss(jm, p, b), opt, mesh_j, horizon)
    jp, _, jlosses = run_j(params, opt.init(params), store_j, jnp.asarray(l_idx))

    model, built = port_model(params), []
    mesh = make_mesh(devices=["cpu"] * 8)
    replicas = Replicas(model, loss_of(model), mesh, replicate_into(built))
    run = port_windows.make_dp_scan_train_steps_windowed(Adam(LR), horizon)
    _, states, losses = run(replicas, replicas.init(Adam(LR)),
                            port_windows.stack_episodes(pe, mesh=mesh), torch.as_tensor(l_idx))

    assert len(built) == 7 and all(s.count == K for s in states)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), expected=model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=5e-3, atol=2e-5, err_msg=k)
    assert_equal_to(built, model)


def _recorder(calls: list, make_real=None):
    """A stand-in for a maker of data-parallel steps that records each
    chunk's index rows, running the real step where one is given."""
    def make(*args, **kwargs):
        real = make_real(*args, **kwargs) if make_real else None

        def run(params, opt_state, data, idxs):
            calls.append(np.asarray(idxs))
            if real is None:  # JAX's side: only the schedule is read
                return params, opt_state, jnp.zeros(len(idxs))
            return real(params, opt_state, data, idxs)

        return run

    return make


def test_trainers_with_mesh_follow_jax_schedule(monkeypatch, tmp_path):
    jm, params, _ = models()
    je, pe = episodes(6, seed=22)
    kw = dict(lr=LR, batch_size=4, accumulate=1, epochs=1, val_every=2, val_batches=1, seed=4)

    # JAX's rows, from its trainers with their step and validation replaced
    jax_rows = {"windowed": [], "dense": []}
    monkeypatch.setattr(jax_windows, "make_dp_scan_train_steps_windowed",
                        _recorder(jax_rows["windowed"]))
    monkeypatch.setattr(jax_windows, "make_scan_eval_windowed",
                        lambda *a, **k: lambda *b: jnp.float32(0.0))
    monkeypatch.setattr(jax_parallel, "make_dp_scan_train_steps", _recorder(jax_rows["dense"]))
    monkeypatch.setattr(jax_loop, "validate", lambda *a, **k: 0.0)
    mesh_j = jax_make_mesh(4, axis_name="data")
    no_loss = lambda p, b: 0.0  # noqa: E731
    jax_loop.train_windowed(no_loss, params, je[:4], je[4:], JaxConfig(**kw), horizons=(1, 2),
                            mesh=mesh_j, windows_per_horizon=4)
    jax_loop.train(no_loss, params, jax_prepare_dataset(je[:2], 1),
                   jax_prepare_dataset(je[4:], 1), JaxConfig(**kw), mesh=mesh_j)

    rows = {"windowed": [], "dense": []}
    monkeypatch.setattr(port_windows, "make_dp_scan_train_steps_windowed",
                        _recorder(rows["windowed"],
                                  port_windows.make_dp_scan_train_steps_windowed))
    monkeypatch.setattr(port_dp, "make_dp_scan_train_steps",
                        _recorder(rows["dense"], port_dp.make_dp_scan_train_steps))
    mesh = make_mesh(devices=["cpu"] * 4)
    for kind in ("windowed", "dense"):
        model, built = port_model(params), []
        cfg = TrainConfig(**kw, checkpoint_dir=str(tmp_path / kind))
        if kind == "windowed":
            _, state, log = train_windowed(loss_of(model), model, pe[:4], pe[4:], cfg,
                                           horizons=(1, 2), mesh=mesh, windows_per_horizon=4,
                                           replicate=replicate_into(built))
        else:
            _, state, log = train(loss_of(model), model, prepare_dataset(pe[:2], 1),
                                  prepare_dataset(pe[4:], 1), cfg, mesh=mesh,
                                  replicate=replicate_into(built))
        assert len(rows[kind]) == len(jax_rows[kind]) >= 1
        for got, want in zip(rows[kind], jax_rows[kind]):
            np.testing.assert_array_equal(got, want)
        assert len(log.history) == 1 and state.count == 2
        assert all(np.isfinite(v) for k, v in log.history[0].items() if "loss" in k)
        assert len(built) == 3
        assert_equal_to(built, model)
        assert (tmp_path / kind / "checkpoint_step=2" / "params.npz").exists()


def test_mesh_without_replicate_or_what_does_not_divide_raises():
    _, pe = episodes(3, seed=23)
    model = tam.AcousticEnergyModel(port_space(), 1000.0, device="cpu", **KW)
    cfg = TrainConfig(lr=LR, batch_size=4, accumulate=1, epochs=1, val_every=1)
    mesh = make_mesh(devices=["cpu"] * 2)
    data = prepare_dataset(pe[:2], 1)
    with pytest.raises(ValueError, match="needs replicate="):
        train(loss_of(model), model, data, data, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="needs replicate="):
        train_windowed(loss_of(model), model, pe[:2], pe[2:], cfg, mesh=mesh)
    with pytest.raises(ValueError, match="leading axis of 3 does not divide over 2 shards"):
        train_windowed(loss_of(model), model, pe, pe[2:], cfg, mesh=mesh,
                       replicate=replicate_into([]))
    with pytest.raises(ValueError, match="batch_size 4 must divide"):
        train(loss_of(model), model, data, data, cfg, mesh=make_mesh(devices=["cpu"] * 3),
              replicate=replicate_into([]))
