"""The port's episode windowing, batching, chunked generator and storage
against the JAX package (`waves_jl_tpu/data.py`), on the CPU.

* `prepare_data` (stride 1 and 2) and `prepare_dataset` equal JAX's on the
  same episodes, leaf for leaf.
* `dataloader` yields every sample once an epoch.
* `generate_episodes_chunked` with 5 episodes in chunks of 2 hands over
  five episodes in order, each the episode its draws give when run alone.
* Storage across the packages, npz, `.wbin` and shard: JAX saves and the
  port loads, and the reverse, every leaf bit for bit through the
  structure descriptor; a file without a descriptor loads as a Cloak
  episode.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import t, to_port

import waves_jl_tpu as w
from waves_jl_tpu import data as jdata
from waves_jl_tpu_torch import data as tdata
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.utils.trees import tree_index, tree_leaves, tree_named_leaves

torch.set_num_threads(1)
A, T, RES = 5, 8, 6


def numpy_episode(seed: int):
    """One Cloak episode of random float32 arrays in both packages: A
    windows of T steps, windows sharing their end times."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def cloak(jax_side):
        leaves = [f(A, 18, 2), f(A, 18), f(A, 18), f(A, 1, 2), f(A, 1), f(A, 1)]
        mod = w if jax_side else td
        conv = jnp.asarray if jax_side else t
        pos, r, c, cpos, cr, cc = map(conv, leaves)
        return mod.Cloak(mod.AdjustableRadiiScatterers(mod.Cylinders(pos, r, c)),
                         mod.Cylinders(cpos, cr, cc))

    tspan = (np.arange(A)[:, None] * T + np.arange(T + 1)[None, :]).astype(np.float32) * 1e-5
    y = f(A, T + 1, 3)
    y[1:, 0] = y[:-1, -1]  # a window starts where the last one ended
    s_wave = f(A, RES, RES, 4)
    jd, ja = cloak(True), cloak(True)
    je = jdata.Episode(s_wave=jnp.asarray(s_wave), s_design=jd, s_tspan=jnp.asarray(tspan), a=ja,
                       y=jnp.asarray(y))
    pe = tdata.Episode(s_wave=t(s_wave), s_design=to_port(jd), s_tspan=t(tspan), a=to_port(ja),
                       y=t(y))
    return je, pe


def assert_same(port_tree, jax_tree):
    got, want = tree_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("stride", [1, 2])
def test_prepare_data_matches_jax(stride):
    je, pe = numpy_episode(0)
    want = jdata.prepare_data(je, 3, stride)
    got = tdata.prepare_data(pe, 3, stride)
    assert got["t"].shape == (3, 3 * T // stride + 1) and got["y"].shape[-1] == 3
    for k in ("s_wave", "s_design", "a", "t", "y"):
        assert_same(got[k], want[k])


def test_prepare_dataset_matches_jax():
    eps = [numpy_episode(s) for s in (1, 2)]
    want = jdata.prepare_dataset([j for j, _ in eps], 2, 2)
    got = tdata.prepare_dataset([p for _, p in eps], 2, 2)
    assert tdata.num_samples(got) == 2 * (A - 1)
    for k in ("s_wave", "s_design", "a", "t", "y"):
        assert_same(got[k], want[k])


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_yields_every_sample_once_an_epoch(drop_last):
    _, pe = numpy_episode(3)
    data = tdata.prepare_data(pe, 1)
    data["s_wave"] = torch.arange(A, dtype=torch.float32)  # a sample's own index
    seen = []
    for batch in tdata.dataloader(data, 2, torch.Generator().manual_seed(0), drop_last):
        assert batch["s_wave"].shape[0] <= 2 and batch["y"].shape[0] == batch["s_wave"].shape[0]
        seen += [int(v) for v in batch["s_wave"]]
    assert len(seen) == len(set(seen)) == (A - A % 2 if drop_last else A)


def test_chunked_generation_hands_over_every_episode_in_order():
    n = 24
    dim = tdims.two_dim(15.0, n, device="cpu")
    src = tsrc.GaussianSource.create(tdims.build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                     [0.3], [1.0], 1000.0)
    env = tenv.make_wave_env(dim, td.build_triple_ring_design_space(device="cpu"), src,
                             resolution=(8, 8), integration_steps=4, actions=2)
    policy = tenv.RandomDesignPolicy(env.action_space)
    got = []
    tdata.generate_episodes_chunked(env, policy, torch.Generator().manual_seed(9), 5, chunk=2,
                                    on_episode=lambda i, ep: got.append((i, ep)))
    assert [i for i, _ in got] == [0, 1, 2, 3, 4]
    # the same draws, one episode at a time: resets, then actions, per chunk
    gen, run, want = torch.Generator().manual_seed(9), tdata.make_episode_fused(env), []
    for k in (2, 2, 1):
        states = [tenv.env_reset(env, gen) for _ in range(k)]
        acts = [tdata._draw_actions(env, policy, gen) for _ in range(k)]
        want += [run(s, a)[1] for s, a in zip(states, acts)]
    for (_, ep), ref in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ep), tree_leaves(ref)))
    assert float(got[4][1].y[..., 0].max()) > 0.0
    assert not torch.equal(got[0][1].s_design.config.cylinders.r,
                           got[1][1].s_design.config.cylinders.r)


@pytest.mark.parametrize("ext", ["npz", "wbin"])
def test_episode_files_load_in_the_other_package(tmp_path, ext):
    je, pe = numpy_episode(4)
    jpath, ppath = str(tmp_path / f"jax.{ext}"), str(tmp_path / f"port.{ext}")
    jdata.save_episode(je, jpath)
    tdata.save_episode(pe, ppath)
    assert os.path.exists(jpath) and os.path.exists(ppath)
    loaded = tdata.load_episode(jpath, device="cpu")
    assert isinstance(loaded.s_design, td.Cloak)
    assert_same(loaded, je)
    assert_same(tdata.load_episode(jpath, like=pe, device=None), je)
    back = jdata.load_episode(ppath, device=False)
    assert isinstance(back.s_design, w.Cloak)
    assert_same(pe, back)


def test_shards_load_in_the_other_package(tmp_path):
    eps = [numpy_episode(s) for s in (5, 6, 7)]
    jpath, ppath = str(tmp_path / "jax.wshard"), str(tmp_path / "port.wshard")
    jdata.save_episodes_shard(jpath, [j for j, _ in eps])
    shard = tdata.open_episodes_shard(ppath)
    for _, p in eps:
        shard.append(p)
    shard.finish()
    loaded = tdata.load_episodes_shard(jpath)
    assert len(loaded) == 3 and len(tdata.load_episodes_shard(jpath, limit=2)) == 2
    back = jdata.load_episodes_shard(ppath)
    for (j, p), got, ret in zip(eps, loaded, back):
        assert_same(got, j)
        assert_same(p, ret)


def test_file_without_descriptor_loads_as_a_cloak_episode(tmp_path):
    je, pe = numpy_episode(8)
    named = {k: v.numpy() for k, v in tree_named_leaves(pe).items()}
    path = str(tmp_path / "old.npz")
    np.savez(path, **named)
    assert_same(tdata.load_episode(path, device=None), je)
    with pytest.raises(ValueError, match="descriptor"):
        np.savez(path, **{".s_wave": named[".s_wave"]})
        tdata.load_episode(path, device=None)
    assert tree_index(pe, 0).s_wave.shape == (RES, RES, 4)
