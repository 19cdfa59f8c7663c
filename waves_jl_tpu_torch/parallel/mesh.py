"""Device meshes for the domain-decomposed simulator and data-parallel
training (counterpart of `waves_jl_tpu/parallel/mesh.py`).

JAX's `shard_map` runs one program over a mesh from a single controller.
The port's counterpart is one process that drives a list of devices: a
`Mesh` names them, one per shard, in shard order. Several shards share a
card only when the caller names it several times (`devices=["cuda:0"] * 4`),
the counterpart of JAX's virtual CPU mesh in the tests; nothing repeats a
device quietly. Where JAX places an array by a sharding (`batch_sharded`),
the port places a tree: one tree a shard, shard k's on the mesh's device k,
or one copy on each device (`replicated`). A 2-D mesh (`make_mesh_2d`) keeps
its devices in row-major order beside its shape and axis names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.trees import tree_leaves, tree_map


@dataclass(frozen=True)
class Mesh:
    """Devices, one per shard, all of one type: one axis by default, or
    `shape` with `axis_names`, the devices in row-major order."""

    devices: tuple
    axis_names: tuple = ("data",)
    shape: tuple = ()

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in self.devices})
        if len(kinds) > 1:
            raise ValueError(f"a mesh takes devices of one type, got {kinds}")
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))
        if math.prod(self.shape) != len(self.devices) or len(self.shape) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.shape} and axes {self.axis_names} "
                             f"cannot hold {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)


def _cuda_devices(n: int) -> tuple:
    count = torch.cuda.device_count()
    if not 1 <= n <= count:
        raise RuntimeError(
            f"asked for {n} CUDA devices, {count} available; name devices= to put "
            "several shards on one device or to run on the CPU")
    return tuple(torch.device("cuda", k) for k in range(n))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1D mesh over the named `devices`, else over the first `n_devices`
    CUDA devices (all of them by default). Asking for more CUDA devices
    than exist raises."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices named")
        return Mesh(devs)
    return Mesh(_cuda_devices(torch.cuda.device_count() if n_devices is None else n_devices))


def make_mesh_2d(shape: tuple, axis_names: tuple = ("data", "space"), devices=None) -> Mesh:
    """2-D mesh of shape (rows, columns) over the named `devices` in
    row-major order, else over the first rows x columns CUDA devices
    (asking for more than exist raises)."""
    shape = tuple(int(s) for s in shape)
    if devices is None:
        return Mesh(_cuda_devices(math.prod(shape)), tuple(axis_names), shape)
    return Mesh(tuple(torch.device(d) for d in devices), tuple(axis_names), shape)


def replicated(tree, mesh: Mesh) -> list:
    """One copy of the tree on each of the mesh's devices, in mesh order
    (where JAX places an array with a replicated sharding)."""
    return [tree_map(lambda x, d=d: x.to(d), tree) for d in mesh.devices]


def batch_sharded(tree, mesh: Mesh) -> list:
    """The tree's leading axis cut into `mesh.size` equal contiguous
    blocks, block k on the mesh's device k."""
    n = tree_leaves(tree)[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not divide over {mesh.size} shards")
    b = n // mesh.size
    return [tree_map(lambda x, k=k, d=d: x[k * b:(k + 1) * b].to(d), tree)
            for k, d in enumerate(mesh.devices)]
