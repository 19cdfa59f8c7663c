"""Elementwise maps over the port's frozen dataclass trees (designs and
actions), the counterpart of `jax.tree_util.tree_map` for them."""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf by leaf over dataclass trees of tensors that share one
    structure; returns a tree of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)
        })
    raise TypeError(f"unsupported tree node {type(tree)}")


def tree_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    raise TypeError(f"unsupported tree node {type(tree)}")


def tree_clamp(x, low, high):
    """Leafwise clip of x into [low, high] (`jnp.clip`: max, then min)."""
    return tree_map(lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi), x, low, high)


def tree_normal(generator: torch.Generator, like):
    """Standard-normal tree with `like`'s leaf shapes, dtypes and devices,
    drawn leaf by leaf in field order (the counterpart of the JAX
    package's `_tree_normal`; the draws themselves differ)."""
    return tree_map(lambda v: torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                          device=v.device), like)
