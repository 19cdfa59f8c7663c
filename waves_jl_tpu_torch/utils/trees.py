"""Maps over the port's trees: frozen dataclasses (designs, actions,
episodes) and dicts of tensors, the counterpart of `jax.tree_util` for them
(`waves_jl_tpu/utils/trees.py`).

`encode_structure`/`decode_structure` describe a tree as JSON and rebuild
it from named leaves, with the registered classes under the JAX package's
class names and the same descriptor tags, so a descriptor written by
either package decodes in the other.
"""
from __future__ import annotations

import dataclasses

import torch

# class name -> (class, meta_fields): the classes a descriptor may name
TREE_REGISTRY: dict = {}


def register_tree_dataclass(cls=None, *, meta_fields: tuple = ()):
    """Register a frozen dataclass for `decode_structure`; `meta_fields`
    are static values stored in the descriptor, not leaves."""

    def wrap(c):
        TREE_REGISTRY[c.__name__] = (c, tuple(meta_fields))
        return c

    return wrap(cls) if cls is not None else wrap


def _children(tree):
    """(kind, children) of a tree node: a dataclass's fields or a dict's
    entries, in order; None for a leaf."""
    if dataclasses.is_dataclass(tree):
        meta = TREE_REGISTRY.get(type(tree).__name__, (None, ()))[1]
        return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
                if f.name not in meta}
    if isinstance(tree, dict):
        return tree
    return None


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf by leaf over trees of tensors that share one
    structure (dataclasses and dicts); returns a tree of the same
    structure. A registered class's meta fields are carried over from
    `tree`."""
    kids = _children(tree)
    if kids is None:
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"unsupported tree node {type(tree)}")
        return fn(tree, *rest)
    out = {k: tree_map(fn, v, *[_children(r)[k] for r in rest]) for k, v in kids.items()}
    if isinstance(tree, dict):
        return out
    return dataclasses.replace(tree, **out)


def tree_leaves(tree) -> list:
    """The tensors of a tree in `tree_map`'s order."""
    kids = _children(tree)
    if kids is None:
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"unsupported tree node {type(tree)}")
        return [tree]
    return [leaf for v in kids.values() for leaf in tree_leaves(v)]


def tree_named_leaves(tree, prefix: str = "") -> dict:
    """{path: tensor} with `jax.tree_util.keystr`'s paths: `.field` for a
    dataclass field, `['key']` for a dict entry."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    fmt = "{}['{}']" if isinstance(tree, dict) else "{}.{}"
    return {name: leaf for k, v in kids.items()
            for name, leaf in tree_named_leaves(v, fmt.format(prefix, k)).items()}


def tree_stack(trees, dim: int = 0):
    """Stack matching trees leaf by leaf along a new dimension."""
    return tree_map(lambda *xs: torch.stack(xs, dim=dim), *trees)


def tree_index(tree, idx):
    """Index the leading dimension of every leaf."""
    return tree_map(lambda x: x[idx], tree)


def tree_clamp(x, low, high):
    """Leafwise clip of x into [low, high] (`jnp.clip`: max, then min)."""
    return tree_map(lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi), x, low, high)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_mul(a, b):
    return tree_map(torch.mul, a, b)


def tree_scale(a, s):
    """Every leaf times the scalar (or broadcastable tensor) s."""
    return tree_map(lambda x: x * s, a)


def tree_lerp(a, b, w):
    """a + w * (b - a) leaf by leaf over matching trees; w a scalar."""
    return tree_map(lambda x, y: x + w * (y - x), a, b)


def tree_concat(trees, dim: int = 0):
    """Concatenate matching trees leaf by leaf along an existing dimension."""
    return tree_map(lambda *xs: torch.cat(xs, dim=dim), *trees)


def tree_zeros_like(tree):
    """A tree of zeros with `tree`'s structure, leaf shapes, dtypes and
    devices."""
    return tree_map(torch.zeros_like, tree)


def tree_normal(generator: torch.Generator, like):
    """Standard-normal tree with `like`'s leaf shapes, dtypes and devices,
    drawn leaf by leaf in field order (the counterpart of the JAX
    package's `_tree_normal`; the draws themselves differ)."""
    return tree_map(lambda v: torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                          device=v.device), like)


def encode_structure(obj) -> object:
    """JSON-able nesting descriptor of a tree of registered dataclasses,
    dicts, lists/tuples, None and array leaves, in the JAX package's format;
    meta fields are stored by value."""
    name = type(obj).__name__
    if dataclasses.is_dataclass(obj) and name in TREE_REGISTRY:
        meta = TREE_REGISTRY[name][1]
        return {
            "__dataclass__": name,
            "fields": {
                f.name: ({"__static__": _encode_static(getattr(obj, f.name))}
                         if f.name in meta else encode_structure(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, dict):
        return {"__dict__": {k: encode_structure(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [encode_structure(v) for v in obj], "tuple": isinstance(obj, tuple)}
    if obj is None:
        return {"__none__": True}
    return {"__leaf__": True}


def _encode_static(val):
    """A meta field's value with tuples and lists tagged, since JSON keeps
    only lists."""
    if isinstance(val, tuple):
        return {"__tuple__": [_encode_static(v) for v in val]}
    if isinstance(val, list):
        return {"__list__": [_encode_static(v) for v in val]}
    return val


def _decode_static(val):
    if isinstance(val, dict) and "__tuple__" in val:
        return tuple(_decode_static(v) for v in val["__tuple__"])
    if isinstance(val, dict) and "__list__" in val:
        return [_decode_static(v) for v in val["__list__"]]
    if isinstance(val, list):
        # descriptors written before the tags stored tuples as bare lists
        return tuple(_decode_static(v) for v in val)
    return val


def decode_structure(desc, get_leaf, prefix: str = ""):
    """Rebuild a tree from an `encode_structure` descriptor; `get_leaf` maps
    a leaf's keystr path (e.g. ``.s_design.config.cylinders.pos``) to its
    array."""
    if "__dataclass__" in desc:
        cls, _ = TREE_REGISTRY[desc["__dataclass__"]]
        kwargs = {}
        for fname, fdesc in desc["fields"].items():
            if isinstance(fdesc, dict) and "__static__" in fdesc:
                kwargs[fname] = _decode_static(fdesc["__static__"])
            else:
                kwargs[fname] = decode_structure(fdesc, get_leaf, f"{prefix}.{fname}")
        return cls(**kwargs)
    if "__dict__" in desc:
        return {k: decode_structure(v, get_leaf, f"{prefix}['{k}']")
                for k, v in desc["__dict__"].items()}
    if "__seq__" in desc:
        items = [decode_structure(v, get_leaf, f"{prefix}[{i}]")
                 for i, v in enumerate(desc["__seq__"])]
        return tuple(items) if desc["tuple"] else items
    if "__none__" in desc:
        return None
    return get_leaf(prefix)
