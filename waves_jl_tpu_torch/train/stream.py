"""Streaming trainer: host-resident episodes, one batch upload per chunk
(counterpart of `waves_jl_tpu/train/stream.py`).

The device-resident trainers cap the dataset at the card's memory. Here the
episode store stays on the host, each chunk of K minibatches of horizon
windows is gathered there by vectorised indexing and copied to the card in
one transfer, and the card runs K micro-steps over it. The next chunk is
gathered and copied while the card still works on the current one, before
the current chunk's losses are read.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data import Episode
from ..utils.logging import MetricsLogger, Timer
from ..utils.trees import tree_map
from .loop import (TrainConfig, _device, _log_chunk, _micro_step, _save, make_optimizer,
                   make_scan_eval)
from .windows import gather_window_batch, sample_window_indices, stack_episodes


def gather_window_batch_host(store: Episode, idx: np.ndarray, horizon: int,
                             stride: int = 1) -> dict:
    """`windows.gather_window_batch` on a host store, idx (N, 2) a numpy
    array of [episode, start] pairs."""
    return gather_window_batch(store, torch.as_tensor(np.asarray(idx), dtype=torch.int64),
                               horizon, stride)


def make_scan_train_steps_batched(loss_fn: Callable, opt) -> Callable:
    """K micro-steps over an uploaded chunk. Returns run(model, opt_state,
    batches with leading (K, B)) -> (model, opt_state, losses (K,))."""

    def run(model, opt_state, batches):
        params = dict(model.named_parameters())
        losses = []
        for k in range(batches["s_wave"].shape[0]):
            opt_state, loss = _micro_step(loss_fn, opt, params, opt_state,
                                          tree_map(lambda x: x[k], batches))
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    return run


def _upload(batches: dict, dev: torch.device) -> dict:
    if dev.type != "cuda":
        return tree_map(lambda x: x.to(dev), batches)
    return tree_map(lambda x: x.pin_memory().to(dev, non_blocking=True), batches)


def train_streaming(loss_fn: Callable, model, train_eps, val_data: dict, config: TrainConfig,
                    horizon: int = 8, stride: int = 1, logger: MetricsLogger | None = None,
                    on_checkpoint: Callable | None = None):
    """Train over a host-resident episode list (or host store) of any size:
    the same schedule as `train` (epochs of shuffled distinct windows, K =
    val_every x accumulate micro-steps a chunk), `val_data` a small
    prepared dataset moved to the card. The same numpy draws as the JAX
    package's. Returns (model, opt_state, logger)."""
    dev = _device(model)
    logger = logger or MetricsLogger(config.metrics_path)
    timer = Timer()
    opt = make_optimizer(config)
    opt_state = opt.init(dict(model.named_parameters()))
    store = stack_episodes(train_eps, device=None) if isinstance(train_eps, list) else train_eps
    store = tree_map(lambda x: x.cpu(), store)
    E, A = store.s_wave.shape[0], store.s_wave.shape[1]
    B = config.batch_size
    K = config.val_every * config.accumulate
    nb = E * (A - horizon + 1) // B
    rng = np.random.default_rng(config.seed)

    run_k = make_scan_train_steps_batched(loss_fn, opt)
    eval_k = make_scan_eval(loss_fn)
    val_data = tree_map(lambda x: x.to(dev), val_data)
    n_val = val_data["s_wave"].shape[0]

    rows, epoch_of_row = [], []
    for epoch in range(config.epochs):
        rows.append(sample_window_indices(rng, E, A, horizon, nb * B).reshape(nb, B, 2))
        epoch_of_row.extend([epoch] * nb)
    rows = np.concatenate(rows, axis=0)

    def gather(start):
        chunk_idx = rows[start:start + K]
        with timer("gather"):
            batches = gather_window_batch_host(store, chunk_idx.reshape(-1, 2), horizon, stride)
            k = chunk_idx.shape[0]
            return _upload(tree_map(lambda x: x.reshape((k, B) + x.shape[1:]), batches), dev), k

    micro_step = 0
    starts = list(range(0, rows.shape[0], K))
    nxt = gather(starts[0]) if starts else None
    for i, start in enumerate(starts):
        batches, k_this = nxt
        with timer("train_chunk"):
            model, opt_state, losses = run_k(model, opt_state, batches)
        if i + 1 < len(starts):
            nxt = gather(starts[i + 1])  # on the host while the card works
        with timer("train_chunk"):
            train_loss = float(losses.mean())
        micro_step += k_this
        nvb = min(config.val_batches, max(1, n_val // B))
        val_idx = torch.as_tensor(rng.integers(0, n_val, size=(nvb, B)), device=dev)
        with timer("validate"):
            val_loss = float(eval_k(model, val_data, val_idx))
        epoch = epoch_of_row[min(micro_step - 1, len(epoch_of_row) - 1)]
        updates_done = _log_chunk(logger, timer, config, micro_step, epoch, train_loss, val_loss)
        _save(config, timer, model, opt_state, updates_done, on_checkpoint)
    return model, opt_state, logger
