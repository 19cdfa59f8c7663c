"""Device meshes for the domain-decomposed simulator (counterpart of
`waves_jl_tpu/parallel/mesh.py`).

JAX's `shard_map` runs one program over a mesh from a single controller.
The port's counterpart is one process that drives a list of devices: a
`Mesh` names them, one per shard, in shard order. Several shards share a
card only when the caller names it several times (`devices=["cuda:0"] * 4`),
the counterpart of JAX's virtual CPU mesh in the tests; nothing repeats a
device quietly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


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
