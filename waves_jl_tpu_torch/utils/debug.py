"""Debug checks (counterpart of `waves_jl_tpu/utils/debug.py`): a NaN trap
over PyTorch's operations, and finite checks of trees and values."""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _out_leaves

_NAN_CHECKS = {"enabled": False}  # what the innermost `debug_nans` scope asks


class _NanTrap(TorchDispatchMode):
    """Runs each ATen operation and raises `FloatingPointError`, naming it,
    when one of its floating outputs holds a NaN while the checks are on."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _NAN_CHECKS["enabled"]:
            for t in _out_leaves(out):
                if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN produced by {func} (shape {tuple(t.shape)})")
        return out


@contextmanager
def debug_nans(enable: bool = True):
    """Scope in which a PyTorch operation that produces a NaN raises
    `FloatingPointError` naming the ATen op (the counterpart of JAX's
    `jax_debug_nans`); `enable=False` turns the checks off inside an
    enclosing scope. The previous setting comes back on exit. Each check
    reads its output on the host, so the card waits for every operation.
    The CUDA kernels write through `ctypes`, outside PyTorch's dispatch:
    a NaN they produce shows at the first PyTorch operation that reads
    it, such as the reduction of their energy partials."""
    prev = _NAN_CHECKS["enabled"]
    _NAN_CHECKS["enabled"] = bool(enable)
    try:
        if enable:
            with _NanTrap():
                yield
        else:
            yield
    finally:
        _NAN_CHECKS["enabled"] = prev


def _named(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dataclasses, dicts, lists and tuples,
    with `jax.tree_util.keystr`'s paths: `.field`, `['key']`, `[i]`."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _named(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def assert_finite(tree, name: str = "pytree") -> None:
    """Raise `FloatingPointError` naming the first leaf (by its path) that
    holds a non-finite value. Reads every leaf on the host."""
    for path, leaf in _named(tree):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def check_finite(x, label: str = "value"):
    """Print a warning if x holds a non-finite value; returns x unchanged."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        print(f"WARNING: non-finite {label}", flush=True)
    return x
