"""Device meshes for the domain-decomposed simulator and data-parallel
training (counterpart of `waves_jl_tpu/parallel/mesh.py`).

JAX's `shard_map` runs one program over a mesh from a single controller.
The port's counterpart is one process that drives a list of devices: a
`Mesh` names them, one per shard, in shard order. Several shards share a
card only when the caller names it several times (`devices=["cuda:0"] * 4`),
the counterpart of JAX's virtual CPU mesh in the tests; nothing repeats a
device quietly. Where JAX places an array by a sharding (`batch_sharded`),
the port places a tree: one tree a shard, shard k's on the mesh's device k.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.trees import tree_leaves, tree_map


@dataclass(frozen=True)
class Mesh:
    """One axis of devices, one per shard, all of one type."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in self.devices})
        if len(kinds) > 1:
            raise ValueError(f"a mesh takes devices of one type, got {kinds}")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh over the named `devices`, else over the first `n_devices`
    CUDA devices (all of them by default). Asking for more CUDA devices
    than exist raises."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices named")
        return Mesh(devs)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise RuntimeError(
            f"asked for {n} CUDA devices, {count} available; name devices= to put "
            "several shards on one device or to run on the CPU")
    return Mesh(tuple(torch.device("cuda", k) for k in range(n)))


def batch_sharded(tree, mesh: Mesh) -> list:
    """The tree's leading axis cut into `mesh.size` equal contiguous
    blocks, block k on the mesh's device k."""
    n = tree_leaves(tree)[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over {mesh.size} shards")
    b = n // mesh.size
    return [tree_map(lambda x, k=k, d=d: x[k * b:(k + 1) * b].to(d), tree)
            for k, d in enumerate(mesh.devices)]
