"""Data-parallel training (`parallel/dp.py`) and the mesh's placement
helpers (`parallel/mesh.py`) on the CPU: the flagship at 64 elements,
h_size 8, nfreq 8 as tests/test_parallel.py builds it, JAX's initial
weights carried across, on 8 horizon-1 samples of two synthetic episodes
(`test_torch_train_model.episodes`; a 48^2 env episode costs 40 s of JAX
compilation):

- `make_dp_train_step` on a mesh of 8 CPU shards against JAX's
  `make_dp_train_step` on the 8 virtual CPU devices of tests/conftest.py
  and against the port's single-device `make_train_step` on the same
  global batch: the loss within 1e-5 relative, every leaf within rtol 1e-4
  / atol 1e-6 (tests/test_parallel.py's bounds), the 8 replicas equal bit
  for bit, shard 0's replica the caller's model;
- `make_dp_scan_train_steps`, K = 2 micro-steps on 4 shards of the
  dataset with local indices, against JAX's and against the single-device
  scan on the same global rows, at the same bounds;
- `shard_batch` and `batch_sharded`: contiguous blocks on their devices,
  and the error for what does not divide; `Replicas`
  takes the caller's weights, `store` copies shard 0's back, and a
  replica built on another device than asked is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train_model import (E, H_SIZE, NFREQ, STEPS, episodes, models, port_space,
                                    to_port_batch)

from waves_jl_tpu.data import prepare_dataset as jax_prepare_dataset
from waves_jl_tpu.models import energy_loss as jax_energy_loss
from waves_jl_tpu.parallel import make_dp_scan_train_steps as jax_dp_scan
from waves_jl_tpu.parallel import make_dp_train_step as jax_dp_step
from waves_jl_tpu.parallel import make_mesh as jax_make_mesh
from waves_jl_tpu.parallel import shard_batch as jax_shard_batch
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.parallel import (Replicas, batch_sharded, make_dp_scan_train_steps,
                                         make_dp_train_step, make_mesh, shard_batch)
from waves_jl_tpu_torch.train.loop import make_scan_train_steps, make_train_step
from waves_jl_tpu_torch.train.optim import Adam
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
LR = 1e-3
KW = dict(elements=E, h_size=H_SIZE, nfreq=NFREQ, integration_steps=STEPS)


@pytest.fixture(scope="module")
def setup():
    """JAX's model and initial params, and 8 horizon-1 samples."""
    jm, params, _ = models()
    je, _ = episodes(2, seed=4)
    data = jax_prepare_dataset(je, 1)
    return jm, params, data, to_port_batch(data)


def port_model(params):
    pm = tam.AcousticEnergyModel(port_space(), 1000.0, device="cpu", **KW)
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    return pm


def replicate(device):
    m = tam.AcousticEnergyModel(port_space(), 1000.0, device=device, seed=1, **KW)
    return m, lambda b: tam.energy_loss(m, b)


def assert_leaves_close(model, jax_params):
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params),
                           expected=model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def assert_replicas_equal(replicas, model):
    assert replicas.models[0] is model
    for m in replicas.models[1:]:
        for a, b in zip(model.parameters(), m.parameters()):
            assert torch.equal(a, b)


def test_dp_train_step_matches_jax_and_single_device(setup):
    jm, params, data, batch = setup
    loss_fn = lambda p, b: jax_energy_loss(jm, p, b)  # noqa: E731
    opt = optax.adam(LR)
    mesh_j = jax_make_mesh(8, axis_name="data")
    jp, _, jloss = jax_dp_step(loss_fn, opt, mesh_j, axis_name="data")(
        params, opt.init(params), jax_shard_batch(data, mesh_j, "data"))

    single = port_model(params)
    step = make_train_step(lambda b: tam.energy_loss(single, b), Adam(LR))
    _, _, loss1 = step(single, Adam(LR).init(dict(single.named_parameters())), batch)

    model = port_model(params)
    mesh = make_mesh(devices=["cpu"] * 8)
    replicas = Replicas(model, lambda b: tam.energy_loss(model, b), mesh, replicate)
    assert_replicas_equal(replicas, model)  # every replica starts from model's weights
    replicas, _, loss = make_dp_train_step(Adam(LR))(replicas, replicas.init(Adam(LR)),
                                                     shard_batch(batch, mesh))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    assert_leaves_close(model, jp)
    for a, b in zip(model.parameters(), single.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)
    assert_replicas_equal(replicas, model)


def test_dp_scan_train_steps_match_jax_and_single_device(setup):
    jm, params, data, batch = setup
    n, K = 4, 2
    local = np.array([[0, 1, 1, 0], [1, 0, 0, 1]])  # (K, B): column d shard d's local index
    glob = local + 2 * np.arange(n)[None, :]  # shard d holds samples 2d and 2d + 1

    loss_fn = lambda p, b: jax_energy_loss(jm, p, b)  # noqa: E731
    opt = optax.adam(LR)
    mesh_j = jax_make_mesh(n, axis_name="data")
    jp, _, jlosses = jax_dp_scan(loss_fn, opt, mesh_j, axis_name="data")(
        params, opt.init(params), jax_shard_batch(data, mesh_j, "data"),
        jnp.asarray(local, jnp.int32))

    single = port_model(params)
    run1 = make_scan_train_steps(lambda b: tam.energy_loss(single, b), Adam(LR))
    _, _, losses1 = run1(single, Adam(LR).init(dict(single.named_parameters())), batch,
                         torch.as_tensor(glob))

    model = port_model(params)
    mesh = make_mesh(devices=["cpu"] * n)
    replicas = Replicas(model, lambda b: tam.energy_loss(model, b), mesh, replicate)
    replicas, states, losses = make_dp_scan_train_steps(Adam(LR))(
        replicas, replicas.init(Adam(LR)), batch_sharded(batch, mesh), torch.as_tensor(local))

    assert losses.shape == (K,) and all(s.count == K for s in states)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), losses1.numpy(), rtol=1e-5)
    assert_leaves_close(model, jp)
    for a, b in zip(model.parameters(), single.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)
    assert_replicas_equal(replicas, model)


def test_placement_helpers():
    tree = {"a": torch.arange(12.0).reshape(6, 2), "b": {"c": torch.arange(6)}}
    mesh = make_mesh(devices=["cpu"] * 3)
    blocks = batch_sharded(tree, mesh)
    assert len(blocks) == 3 and shard_batch(tree, mesh)[1]["b"]["c"].tolist() == [2, 3]
    for k, blk in enumerate(blocks):
        assert torch.equal(blk["a"], tree["a"][2 * k:2 * k + 2])
        assert all(x.device == mesh.devices[k] for x in tree_leaves(blk))
    with pytest.raises(ValueError, match="does not divide over 4 shards"):
        batch_sharded(tree, make_mesh(devices=["cpu"] * 4))


def test_replicas_take_the_model_weights_and_store_shard_zero():
    caller = tam.AcousticEnergyModel(port_space(), 1000.0, device="cpu", seed=3, **KW)
    replicas = Replicas(caller, None, make_mesh(devices=["cpu"] * 2), replicate)
    assert replicas.models[1] is not caller
    assert_replicas_equal(replicas, caller)
    other = tam.AcousticEnergyModel(port_space(), 1000.0, device="cpu", seed=4, **KW)
    replicas.store(other)
    assert all(torch.equal(a, b) for a, b in zip(other.parameters(), caller.parameters()))
    with pytest.raises(ValueError, match="built a model on meta"):
        Replicas(caller, None, make_mesh(devices=["cpu"] * 2),
                 lambda d: (torch.nn.Linear(1, 1, device="meta"), None))


@pytest.mark.parametrize("which", ["node", "pinn"])
def test_baselines_train_data_parallel_as_the_cli_builds_them(which):
    """`train(mesh=)` on 2 CPU shards for one chunk of one update, each
    replica built by the train CLI's `build_model` for `--model node|pinn`
    at narrow width, against the single-device scan on JAX's schedule's
    rows: the loss within 1e-5 relative, every leaf within rtol 1e-4 / atol
    1e-6, the built replica equal to the caller's model bit for bit."""
    from waves_jl_tpu_torch.data import prepare_dataset
    from waves_jl_tpu_torch.scripts import train as train_cli
    from waves_jl_tpu_torch.train import TrainConfig, train

    args = train_cli.parse_args(["--data", "unused", "--out", "unused", "--model", which,
                                 "--elements", str(E), "--h-size", str(H_SIZE), "--nfreq",
                                 str(NFREQ), "--steps", str(STEPS), "--device", "cpu"])
    _, pe = episodes(1, seed=6)
    data = prepare_dataset(pe, 1)  # 4 horizon-1 samples, 2 a shard
    cfg = TrainConfig(lr=LR, batch_size=4, accumulate=1, epochs=1, val_every=1, val_batches=1,
                      seed=5)
    built = []

    def replicate(device):
        m, f = train_cli.build_model(args, 4, device)
        built.append(m)
        return m, f

    model, loss_fn = train_cli.build_model(args, 4, "cpu")
    single, single_loss = train_cli.build_model(args, 4, "cpu")
    single.load_state_dict(model.state_dict())
    _, state, log = train(loss_fn, model, data, data, cfg, mesh=make_mesh(devices=["cpu"] * 2),
                          replicate=replicate)

    rng = np.random.default_rng(cfg.seed)
    rows = np.concatenate([rng.permutation(2)[None] + 2 * d for d in range(2)], axis=1)
    _, _, losses1 = make_scan_train_steps(single_loss, Adam(LR))(
        single, Adam(LR).init(dict(single.named_parameters())), data, torch.as_tensor(rows))

    assert len(log.history) == 1 and state.count == 1 and len(built) == 1
    np.testing.assert_allclose(log.history[0]["train_loss"], float(losses1[0]), rtol=1e-5)
    for (k, a), b in zip(model.named_parameters(), single.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(built[0].parameters(), model.parameters()))
