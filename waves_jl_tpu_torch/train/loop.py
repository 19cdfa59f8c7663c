"""Training loop: Adam with gradient accumulation, validation and
checkpoints (counterpart of `waves_jl_tpu/train/loop.py`).

The model's parameters are trained in place; a loss is `loss_fn(batch) ->
scalar tensor` over a model the caller closes over. Each micro-step runs
forward and backward with plain autograd (the latent rollout keeps what
its `Integrator.checkpoint` mode says) and steps the optimizer of
`train.optim`. The trainers keep the JAX package's scan-of-K shape without
its compiled scan: the data stays on the card, a chunk's minibatch indices
go up in one copy and are gathered there, the losses stay tensors, and one
host copy of a chunk's losses is the only wait on the card per chunk.
With `mesh=` (and `replicate=`, which builds a shard's model and loss on
its device) `train` and `train_windowed` run the JAX package's
data-parallel schedule over replicas of the model (`parallel.dp`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from ..data import dataloader
from ..models.layers import full_float32
from ..utils.logging import MetricsLogger, Timer
from ..utils.trees import tree_map
from .checkpoint import save_checkpoint
from .optim import Adam, MultiSteps, apply_updates

@dataclass
class TrainConfig:
    """The reference hyperparameter block."""

    lr: float = 1e-4
    batch_size: int = 4
    accumulate: int = 8
    epochs: int = 10
    val_every: int = 20  # optimizer updates between validations
    val_batches: int = 20
    checkpoint_dir: str | None = None
    metrics_path: str | None = None
    seed: int = 0


def make_optimizer(config: TrainConfig):
    """`optax.adam(lr)`, inside `optax.MultiSteps` when accumulating."""
    opt = Adam(config.lr)
    return MultiSteps(opt, config.accumulate) if config.accumulate > 1 else opt


def _micro_step(loss_fn: Callable, opt, params: dict, opt_state, batch):
    """Forward, backward and optimizer step on one batch, in IEEE float32.
    Returns (opt_state, loss detached on the card)."""
    with full_float32():
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    updates, opt_state = opt.update(grads, opt_state)
    apply_updates(params, updates)
    return opt_state, loss.detach()


@torch.no_grad()
def _eval_mean(loss_fn: Callable, batches: Iterable) -> torch.Tensor:
    with full_float32():
        return torch.mean(torch.stack([loss_fn(b) for b in batches]))


def make_train_step(loss_fn: Callable, opt) -> Callable:
    """step(model, opt_state, batch) -> (model, opt_state, loss tensor)."""

    def step(model, opt_state, batch):
        opt_state, loss = _micro_step(loss_fn, opt, dict(model.named_parameters()), opt_state,
                                      batch)
        return model, opt_state, loss

    return step


def make_scan_train_steps(loss_fn: Callable, opt) -> Callable:
    """K micro-steps over a dataset on the card. Returns run(model,
    opt_state, data, idxs (K, B) on the card) -> (model, opt_state, losses
    (K,) on the card)."""

    def run(model, opt_state, data, idxs):
        params = dict(model.named_parameters())
        losses = []
        for idx in idxs:
            opt_state, loss = _micro_step(loss_fn, opt, params, opt_state,
                                          tree_map(lambda x: x[idx], data))
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    return run


def make_scan_eval(loss_fn: Callable) -> Callable:
    """run(model, data, idxs (K, B)) -> mean loss over the K minibatches."""

    def run(model, data, idxs):
        return _eval_mean(loss_fn, (tree_map(lambda x: x[idx], data) for idx in idxs))

    return run


def make_eval_step(loss_fn: Callable) -> Callable:
    """eval(model, batch) -> loss tensor, without gradients."""
    return lambda model, batch: _eval_mean(loss_fn, [batch])


def validate(eval_step, model, val_data: dict, batch_size: int, generator: torch.Generator,
             max_batches: int) -> float:
    """Mean loss over up to max_batches shuffled validation minibatches."""
    losses = []
    for i, batch in enumerate(dataloader(val_data, batch_size, generator)):
        losses.append(eval_step(model, batch))
        if i + 1 >= max_batches:
            break
    return float(torch.stack(losses).mean()) if losses else 0.0


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _replicas(model, loss_fn, mesh, replicate, batch_size: int):
    """The model's replicas over `mesh` for the data-parallel trainers,
    after their checks."""
    from ..parallel.dp import Replicas

    if replicate is None:
        raise ValueError("mesh= needs replicate=, a callable device -> (model, loss_fn) that "
                         "builds a shard's model and its loss on that device")
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} must divide over the mesh's {mesh.size} "
                         "shards")
    return Replicas(model, loss_fn, mesh, replicate)


def _save(config, timer, model, opt_state, updates_done, on_checkpoint):
    if config.checkpoint_dir:
        path = f"{config.checkpoint_dir}/checkpoint_step={updates_done}"
        with timer("checkpoint"):
            save_checkpoint(path, model, opt_state, updates_done)
        if on_checkpoint is not None:
            on_checkpoint(path, model)


def train_windowed(loss_fn: Callable, model, train_eps, val_eps, config: TrainConfig,
                   horizons: tuple = (8,), stride: int = 1, mesh=None,
                   logger: MetricsLogger | None = None, on_checkpoint: Callable | None = None,
                   windows_per_horizon: int | None = None, replicate: Callable | None = None):
    """Mixed-horizon training over the windowed episode store: each cycle
    runs a chunk of micro-steps per horizon in turn, so one checkpoint
    learns every window length, then validates every horizon and saves.
    `train_eps`/`val_eps` are episode lists or stacked stores; the stores go
    to the model's device. `windows_per_horizon` sets the windows each
    horizon contributes per epoch (default: the mean distinct-window count
    over the horizons). The same schedule and numpy draws as the JAX
    package's from `config.seed`.

    With `mesh`, data-parallel: the training store is cut over the mesh on
    its episode axis, each chunk's windows are drawn by
    `sample_window_indices_dp` and every micro-step averages the shards'
    gradients (`make_dp_scan_train_steps_windowed`); `replicate(device) ->
    (model, loss_fn)` builds the other shards' models, which take `model`'s
    weights; validation and checkpoints are shard 0's, and `model` holds
    the trained weights after each chunk. Returns (model, opt_state,
    logger)."""
    from ..parallel.mesh import batch_sharded
    from .windows import (episode_axes, make_dp_scan_train_steps_windowed,
                          make_scan_eval_windowed, make_scan_train_steps_windowed,
                          sample_window_indices, sample_window_indices_dp, stack_episodes)

    logger = logger or MetricsLogger(config.metrics_path)
    timer = Timer()
    opt = make_optimizer(config)
    B = config.batch_size
    horizons = tuple(horizons)
    if mesh is None:
        dev, learner, loss0 = _device(model), model, loss_fn
        opt_state = opt.init(dict(model.named_parameters()))
        store_t = stack_episodes(train_eps, dev) if isinstance(train_eps, list) else train_eps
        E, A = episode_axes(store_t)
        runs = {h: make_scan_train_steps_windowed(loss_fn, opt, h, stride) for h in horizons}
    else:
        replicas = _replicas(model, loss_fn, mesh, replicate, B)
        dev, learner, loss0 = mesh.devices[0], replicas, replicas.loss_fns[0]
        opt_state = replicas.init(opt)
        store = stack_episodes(train_eps, None) if isinstance(train_eps, list) else train_eps
        E, A = episode_axes(store)
        store_t = batch_sharded(store, mesh)  # the episodes must divide over the mesh
        runs = {h: make_dp_scan_train_steps_windowed(opt, h, stride) for h in horizons}
    store_v = stack_episodes(val_eps, dev) if isinstance(val_eps, list) else val_eps
    Ev, _ = episode_axes(store_v)
    evals = {h: make_scan_eval_windowed(loss0, h, stride) for h in horizons}

    counts = {h: E * (A - h + 1) for h in horizons}
    wph = windows_per_horizon or int(np.mean(list(counts.values())))
    micro_per_h_total = max(1, config.epochs * wph // B)
    # micro-steps per horizon per cycle: the validation budget split across
    # horizons, rounded to whole accumulation groups
    per_h = (config.val_every * config.accumulate) // len(horizons)
    per_h = max(config.accumulate, per_h - per_h % config.accumulate)
    cycles = -(-micro_per_h_total // per_h)
    rng = np.random.default_rng(config.seed)

    micro = 0
    for cycle in range(cycles):
        train_losses = {}
        for h in horizons:
            if mesh is None:
                idxs = torch.as_tensor(sample_window_indices(rng, E, A, h, per_h * B)
                                       .reshape(per_h, B, 2), device=dev)
            else:  # each shard's block goes to its device
                idxs = torch.as_tensor(sample_window_indices_dp(rng, E, A, h, per_h, mesh.size, B))
            with timer("train_chunk"):
                learner, opt_state, losses = runs[h](learner, opt_state, store_t, idxs)
                train_losses[h] = float(losses.mean())
            micro += per_h

        val_losses = {}
        nvb = min(config.val_batches, max(1, Ev))
        for h in horizons:
            vidx = torch.as_tensor(sample_window_indices(rng, Ev, A, h, nvb * B)
                                   .reshape(nvb, B, 2), device=dev)
            with timer("validate"):
                val_losses[h] = float(evals[h](model, store_v, vidx))
        if mesh is not None:
            replicas.store(model)

        updates_done = micro // config.accumulate
        rec = {"step": updates_done, "epoch": cycle * config.epochs // max(1, cycles),
               "train_loss": float(np.mean(list(train_losses.values()))),
               "val_loss": float(np.mean(list(val_losses.values()))),
               "step_time": timer.totals["train_chunk"] / max(1.0, micro / config.accumulate)}
        rec.update({f"train_loss_h{h}": v for h, v in train_losses.items()})
        rec.update({f"val_loss_h{h}": v for h, v in val_losses.items()})
        logger.log(**rec)
        print(f"Step: {updates_done}, Train: {rec['train_loss']:.6g}, Val: "
              + " ".join(f"h{h}={v:.4g}" for h, v in val_losses.items()), flush=True)
        state0 = opt_state if mesh is None else opt_state[0]
        _save(config, timer, model, state0, updates_done, on_checkpoint)
    return model, opt_state if mesh is None else opt_state[0], logger


def _log_chunk(logger, timer, config, micro_step, epoch, train_loss, val_loss):
    updates_done = micro_step // config.accumulate
    # seconds per optimizer update, from the total over the true micro-steps
    logger.log(step=updates_done, epoch=epoch, train_loss=train_loss, val_loss=val_loss,
               step_time=timer.totals["train_chunk"] / max(1.0, micro_step / config.accumulate))
    print(f"Step: {updates_done}, Train Loss: {train_loss:.6g}, Val Loss: {val_loss:.6g}",
          flush=True)
    return updates_done


def train(loss_fn: Callable, model, train_data: dict, val_data: dict, config: TrainConfig,
          logger: MetricsLogger | None = None, on_checkpoint: Callable | None = None, mesh=None,
          replicate: Callable | None = None):
    """Training over a prepared dataset on the model's device: epochs of
    shuffled minibatches consumed in chunks of K = val_every x accumulate
    micro-steps, a validation and a checkpoint after each chunk. The same
    numpy draws as the JAX package's from `config.seed`.

    With `mesh`, data-parallel, on the JAX package's schedule: the samples
    are cut over the mesh (the ragged rest dropped), each epoch draws one
    permutation a shard and lays the shards' blocks side by side along the
    batch axis, and every micro-step averages the shards' gradients
    (`make_dp_scan_train_steps`); `replicate(device) -> (model, loss_fn)`
    builds the other shards' models, which take `model`'s weights.
    Validation (shuffled minibatches from a generator seeded with
    `config.seed`) and checkpoints are shard 0's, and `model` holds the
    trained weights after each chunk. Returns (model, opt_state, logger)."""
    if mesh is not None:
        return _train_dp(loss_fn, model, train_data, val_data, config, logger, on_checkpoint,
                         mesh, replicate)
    dev = _device(model)
    logger = logger or MetricsLogger(config.metrics_path)
    timer = Timer()
    opt = make_optimizer(config)
    opt_state = opt.init(dict(model.named_parameters()))
    train_data = tree_map(lambda x: x.to(dev), train_data)
    val_data = tree_map(lambda x: x.to(dev), val_data)
    run_k = make_scan_train_steps(loss_fn, opt)
    eval_k = make_scan_eval(loss_fn)
    B = config.batch_size
    K = config.val_every * config.accumulate  # micro-steps between validations
    n_train = train_data["s_wave"].shape[0]
    n_val = val_data["s_wave"].shape[0]
    rng = np.random.default_rng(config.seed)

    rows, epoch_of_row = [], []
    for epoch in range(config.epochs):
        perm = rng.permutation(n_train)
        nb = n_train // B
        rows.append(perm[: nb * B].reshape(nb, B))
        epoch_of_row.extend([epoch] * nb)
    rows = np.concatenate(rows, axis=0)

    micro_step = 0
    for start in range(0, rows.shape[0], K):
        chunk = torch.as_tensor(rows[start:start + K], device=dev)
        with timer("train_chunk"):
            model, opt_state, losses = run_k(model, opt_state, train_data, chunk)
            train_loss = float(losses.mean())
        micro_step += int(chunk.shape[0])
        nvb = min(config.val_batches, max(1, n_val // B))
        val_idx = torch.as_tensor(rng.integers(0, n_val, size=(nvb, B)), device=dev)
        with timer("validate"):
            val_loss = float(eval_k(model, val_data, val_idx))
        epoch = epoch_of_row[min(start + chunk.shape[0] - 1, len(epoch_of_row) - 1)]
        updates_done = _log_chunk(logger, timer, config, micro_step, epoch, train_loss, val_loss)
        _save(config, timer, model, opt_state, updates_done, on_checkpoint)
    return model, opt_state, logger


def _train_dp(loss_fn, model, train_data, val_data, config, logger, on_checkpoint, mesh,
              replicate):
    """`train` over a mesh."""
    from ..parallel.dp import make_dp_scan_train_steps
    from ..parallel.mesh import batch_sharded

    B = config.batch_size
    replicas = _replicas(model, loss_fn, mesh, replicate, B)
    n_dev, local_b, dev0 = mesh.size, B // mesh.size, mesh.devices[0]
    logger = logger or MetricsLogger(config.metrics_path)
    timer = Timer()
    opt = make_optimizer(config)
    opt_states = replicas.init(opt)
    n_loc = train_data["s_wave"].shape[0] // n_dev
    blocks = batch_sharded(tree_map(lambda x: x[:n_loc * n_dev], train_data), mesh)
    val_data = tree_map(lambda x: x.to(dev0), val_data)
    run_k = make_dp_scan_train_steps(opt)
    eval_fn = make_eval_step(replicas.loss_fns[0])
    K = config.val_every * config.accumulate  # micro-steps between validations
    rng = np.random.default_rng(config.seed)
    val_gen = torch.Generator(device=dev0).manual_seed(config.seed)

    # one permutation of LOCAL sample indices a shard an epoch, the shards'
    # blocks side by side along the batch axis
    rows, epoch_of_row = [], []
    nb = n_loc * n_dev // B
    for epoch in range(config.epochs):
        rows.append(np.concatenate([rng.permutation(n_loc)[:nb * local_b].reshape(nb, local_b)
                                    for _ in range(n_dev)], axis=1))
        epoch_of_row.extend([epoch] * nb)
    rows = np.concatenate(rows, axis=0)

    micro_step = 0
    for start in range(0, rows.shape[0], K):
        chunk = torch.as_tensor(rows[start:start + K])
        with timer("train_chunk"):
            replicas, opt_states, losses = run_k(replicas, opt_states, blocks, chunk)
            train_loss = float(losses.mean())
        micro_step += int(chunk.shape[0])
        with timer("validate"):
            val_loss = validate(eval_fn, replicas.models[0], val_data, B, val_gen,
                                config.val_batches)
        replicas.store(model)
        epoch = epoch_of_row[min(start + chunk.shape[0] - 1, len(epoch_of_row) - 1)]
        updates_done = _log_chunk(logger, timer, config, micro_step, epoch, train_loss, val_loss)
        _save(config, timer, model, opt_states[0], updates_done, on_checkpoint)
    return model, opt_states[0], logger
