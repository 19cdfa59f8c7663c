"""Data-parallel surrogate training over a mesh of devices (counterpart of
`waves_jl_tpu/parallel/dp.py`).

JAX's `shard_map` runs one program a device over replicated parameters.
The port keeps one replica of the model on each of the mesh's devices
(`Replicas`), each built there by the caller's `replicate(device) ->
(model, loss_fn)`: a model keeps device tensors outside its parameters
(its design space, latent grid and dynamics), so moving a module is not
enough. A data-parallel micro-step is JAX's:

1. each shard takes the mean loss of its block of the batch and that
   loss's gradient, the shards issued in mesh order from one thread, each
   with its card current;
2. the gradients and losses are averaged over the shards (`pmean`), in
   mesh order: summed on the first device, divided by n, and the mean
   copied back to each device (`torch.cuda.comm.broadcast`, NCCL between
   distinct cards);
3. every shard applies the same optimizer update to its own replica, so
   the replicas stay equal bit for bit.

The step functions take the replicas, which carry their mesh, where JAX's
take the replicated params, and one optimizer state a shard
(`Replicas.init`) where JAX's take the replicated state. The mesh's
device type chooses the copies of step 2; the arithmetic is the same.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.cuda import comm

from ..models.layers import full_float32
from ..train.optim import apply_updates
from ..utils.trees import tree_map
from .mesh import Mesh, batch_sharded


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


class Replicas:
    """`model` replicated over `mesh`: shard k's model and loss on
    `mesh.devices[k]`, every replica holding `model`'s weights. Where
    `model` lies on the mesh's first device it is shard 0's replica, with
    `loss_fn`, and trains in place; the other shards' come from
    `replicate(device) -> (model, loss_fn)`."""

    def __init__(self, model, loss_fn: Callable, mesh: Mesh, replicate: Callable):
        self.mesh = mesh
        self.models, self.loss_fns = [], []
        for k, dev in enumerate(mesh.devices):
            if k == 0 and _device_of(model) == dev:
                m, f = model, loss_fn
            else:
                m, f = replicate(dev)
                if _device_of(m) != dev:
                    raise ValueError(f"replicate({dev}) built a model on {_device_of(m)}")
                m.load_state_dict(model.state_dict())
            self.models.append(m)
            self.loss_fns.append(f)
        self.params = [dict(m.named_parameters()) for m in self.models]

    def init(self, opt) -> list:
        """One state of optimizer `opt` a shard."""
        return [opt.init(p) for p in self.params]

    def store(self, model) -> None:
        """Copy shard 0's weights into `model` (nothing where it is shard 0)."""
        if model is not self.models[0]:
            model.load_state_dict(self.models[0].state_dict())


def _each_shard(fn: Callable, mesh: Mesh) -> list:
    """[fn(k) for each shard k], in mesh order from this thread, with shard
    k's card current. A card runs its shard's launches while the host
    issues the next shard's. A thread a shard (`parallel_apply`'s form)
    measured slower on the H100: the shards' threads take turns at the
    interpreter lock between every small op (PERF.md §6)."""
    out = []
    for k, dev in enumerate(mesh.devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            out.append(fn(k))
    return out


def _mean(tensors: list, mesh: Mesh) -> torch.Tensor:
    """The shards' mean on the first device: summed in mesh order, divided
    by n."""
    dev0 = mesh.devices[0]
    total = tensors[0]
    for x in tensors[1:]:
        total = total + x.to(dev0)
    return total / mesh.size


def _pmean(tensors: list, mesh: Mesh) -> list:
    """The shards' mean (`_mean`) copied back to each shard's device."""
    mean = _mean(tensors, mesh)
    if mesh.devices[0].type != "cuda":
        return [mean] * mesh.size
    cards = list(dict.fromkeys(d.index for d in mesh.devices))  # the first device's first
    copies = dict(zip(cards, comm.broadcast(mean, cards))) if len(cards) > 1 \
        else {cards[0]: mean}
    return [copies[d.index] for d in mesh.devices]


def _dp_micro_step(replicas: Replicas, opt, opt_states: list, batch_of: Callable):
    """One data-parallel micro-step: shard k's loss and gradient on
    batch_of(k), the pmean of both, the same update on every replica.
    Returns (opt_states, mean loss on the first device)."""
    mesh = replicas.mesh

    def grad(k):
        params = list(replicas.params[k].values())
        loss = replicas.loss_fns[k](batch_of(k))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for p, g in zip(params, grads)])
        return loss.detach(), flat

    with full_float32():  # the backward too, as `train.loop._micro_step`
        out = _each_shard(grad, mesh)
    losses, flats = zip(*out)
    loss = _mean(list(losses), mesh)
    means = _pmean(list(flats), mesh)

    def update(k):
        params = replicas.params[k]
        parts = torch.split(means[k], [p.numel() for p in params.values()])
        grads = {name: g.view(p.shape) for (name, p), g in zip(params.items(), parts)}
        updates, state = opt.update(grads, opt_states[k])
        apply_updates(params, updates)
        return state

    return _each_shard(update, mesh), loss


def make_dp_train_step(opt) -> Callable:
    """step(replicas, opt_states, blocks) -> (replicas, opt_states, loss):
    one micro-step on a batch cut over the mesh (`shard_batch`), block k
    shard k's; the loss is the shards' mean, on the first device."""

    def step(replicas, opt_states, blocks):
        opt_states, loss = _dp_micro_step(replicas, opt, opt_states, lambda k: blocks[k])
        return replicas, opt_states, loss

    return step


def dp_scan(replicas: Replicas, opt, opt_states: list, idxs: torch.Tensor, gather: Callable):
    """K micro-steps over idxs (K, B, ...) whose batch axis is laid out in
    mesh.size contiguous blocks, block k shard k's local indices; each
    shard's block goes to its device in one copy, and gather(k, idx)
    forms its minibatch there."""
    mesh = replicas.mesh
    b = idxs.shape[1] // mesh.size
    local = [idxs[:, k * b:(k + 1) * b].to(d) for k, d in enumerate(mesh.devices)]
    losses = []
    for i in range(idxs.shape[0]):
        opt_states, loss = _dp_micro_step(replicas, opt, opt_states,
                                          lambda k: gather(k, local[k][i]))
        losses.append(loss)
    return replicas, opt_states, torch.stack(losses)


def make_dp_scan_train_steps(opt) -> Callable:
    """K data-parallel micro-steps over a dataset cut over the mesh on its
    sample axis (`shard_batch`, block k on device k). Returns run(replicas,
    opt_states, data_blocks, idxs (K, B)) -> (replicas, opt_states, losses
    (K,) on the first device), where the batch axis of idxs holds the
    shards' blocks in order, each of LOCAL sample indices."""

    def run(replicas, opt_states, data_blocks, idxs):
        return dp_scan(replicas, opt, opt_states, idxs,
                     lambda k, idx: tree_map(lambda x: x[idx], data_blocks[k]))

    return run


def shard_batch(batch, mesh: Mesh) -> list:
    """A batch with its leading axis cut over the mesh, block k on device k."""
    return batch_sharded(batch, mesh)
