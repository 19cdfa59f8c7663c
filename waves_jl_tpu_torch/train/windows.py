"""Windowed episode store: horizon windows gathered on the card inside the
training loop (counterpart of `waves_jl_tpu/train/windows.py`).

The episodes are stacked once into a store with leading axes (E, A) on the
card, and each minibatch of windows is gathered there from (episode,
start) index pairs, with the fields and joining of `data.prepare_data`.
One store serves every horizon, which the mixed-horizon trainer
(`loop.train_windowed`) round-robins. A chunk's indices go to the card in
one copy, and its losses come back in one. For data-parallel training the
store is cut over a mesh on its episode axis and each shard gathers its
windows from its own block (`make_dp_scan_train_steps_windowed`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data import Episode
from ..device import resolve_device
from ..parallel.mesh import batch_sharded
from ..utils.interp import flatten_repeated_last_dim
from ..utils.trees import tree_map, tree_stack
from .loop import _eval_mean, _micro_step


def stack_episodes(episodes: list[Episode], device="cuda", mesh=None):
    """One store with leading axis E on every leaf, on `device` (None keeps
    it where the episodes are). With `mesh`, the store cut over the mesh on
    its episode axis instead: one store a shard, episode block k on the
    mesh's device k (JAX's `store_sharding`)."""
    store = tree_stack(episodes)
    if mesh is not None:
        return batch_sharded(store, mesh)
    if device is None:
        return store
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), store)


def episode_axes(store: Episode) -> tuple[int, int]:
    """(n_episodes, n_actions) of a stacked store."""
    return store.s_wave.shape[0], store.s_wave.shape[1]


def gather_window_batch(store: Episode, idx: torch.Tensor, horizon: int,
                        stride: int = 1) -> dict:
    """idx (B, 2) [episode, start] on the store's device -> batch dict with
    leading axis B: s_wave, s_design, a (B, horizon, ...), and t (B, L) and
    y (B, L, 3) joined over the windows as `data.prepare_data` joins them
    (each later window drops its first row), then every stride-th row."""
    e, s = idx[:, 0], idx[:, 1]
    ee = e[:, None]
    win = s[:, None] + torch.arange(horizon, device=idx.device)[None, :]  # (B, H)
    t = flatten_repeated_last_dim(store.s_tspan[ee, win])  # (B, L)
    y = flatten_repeated_last_dim(torch.movedim(store.y[ee, win], -1, 1))  # (B, 3, L)
    y = torch.movedim(y, 1, -1)
    if stride > 1:
        t, y = t[:, ::stride], y[:, ::stride]
    return {"s_wave": store.s_wave[e, s], "s_design": tree_map(lambda x: x[e, s], store.s_design),
            "a": tree_map(lambda x: x[ee, win], store.a), "t": t, "y": y}


def gather_window(store: Episode, e: int, s: int, horizon: int, stride: int = 1) -> dict:
    """One sample: the `horizon`-window of episode `e` from action `s`."""
    idx = torch.tensor([[e, s]], device=store.s_wave.device)
    return tree_map(lambda x: x[0], gather_window_batch(store, idx, horizon, stride))


def sample_window_indices(rng: np.random.Generator, n_eps: int, n_actions: int,
                          horizon: int, count: int) -> np.ndarray:
    """(count, 2) int32 [episode, start] pairs: all valid windows shuffled,
    cycled when `count` exceeds their number. The same draws as the JAX
    package's from the same generator state."""
    starts = n_actions - horizon + 1
    assert starts >= 1, f"horizon {horizon} > episode length {n_actions}"
    all_idx = np.stack(
        np.meshgrid(np.arange(n_eps), np.arange(starts), indexing="ij"), -1
    ).reshape(-1, 2)
    reps = -(-count // len(all_idx))
    out = [all_idx[rng.permutation(len(all_idx))] for _ in range(reps)]
    return np.concatenate(out)[:count].astype(np.int32)


def make_scan_train_steps_windowed(loss_fn: Callable, opt, horizon: int,
                                   stride: int = 1) -> Callable:
    """K micro-steps over a windowed store. Returns run(model, opt_state,
    store, idxs (K, B, 2) on the card) -> (model, opt_state, losses (K,) on
    the card); each micro-step gathers its windows, runs forward and
    backward, and steps the optimizer, without waiting for the card."""

    def run(model, opt_state, store, idxs):
        params = dict(model.named_parameters())
        losses = []
        for idx in idxs:
            batch = gather_window_batch(store, idx, horizon, stride)
            opt_state, loss = _micro_step(loss_fn, opt, params, opt_state, batch)
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    return run


def make_scan_eval_windowed(loss_fn: Callable, horizon: int, stride: int = 1) -> Callable:
    """run(model, store, idxs (K, B, 2)) -> mean loss over the K minibatches
    of windows (a tensor on the card)."""

    def run(model, store, idxs):
        return _eval_mean(loss_fn, [gather_window_batch(store, idx, horizon, stride)
                                    for idx in idxs])

    return run


def make_dp_scan_train_steps_windowed(opt, horizon: int, stride: int = 1) -> Callable:
    """K data-parallel micro-steps over a store cut over the replicas' mesh
    on its episode axis (`stack_episodes(..., mesh=)`). Returns run(replicas,
    opt_states, stores, idxs (K, B, 2)) -> (replicas, opt_states, losses
    (K,) on the first device): the batch axis of idxs holds the shards'
    blocks in order, each of [episode, start] pairs in its shard's LOCAL
    episode space; each shard gathers its windows from its own store, then
    the gradients are averaged and every replica takes the same update
    (`parallel.dp`)."""
    from ..parallel.dp import dp_scan

    def run(replicas, opt_states, stores, idxs):
        return dp_scan(replicas, opt, opt_states, idxs,
                     lambda k, idx: gather_window_batch(stores[k], idx, horizon, stride))

    return run


def sample_window_indices_dp(rng: np.random.Generator, n_eps: int, n_actions: int,
                             horizon: int, count: int, n_devices: int,
                             batch: int) -> np.ndarray:
    """(count, batch, 2) indices for the data-parallel trainer: the batch
    axis laid out in `n_devices` contiguous blocks, block d drawn by
    `sample_window_indices` in shard d's local episode space [0, n_eps //
    n_devices). The same draws as the JAX package's."""
    if batch % n_devices or n_eps % n_devices:
        raise ValueError(f"batch {batch} and episodes {n_eps} must divide over "
                         f"{n_devices} shards")
    local_b, local_e = batch // n_devices, n_eps // n_devices
    blocks = [sample_window_indices(rng, local_e, n_actions, horizon, count * local_b)
              .reshape(count, local_b, 2) for _ in range(n_devices)]
    return np.concatenate(blocks, axis=1)
