"""Flagship and policy weights from the JAX package's checkpoints.

`from_jax_params` maps the flax named-leaf npz (keys such as
"['wave_encoder']['params']['CNNBase_0']['ResidualBlock_0']['Conv_0']['kernel']")
onto the `state_dict` of `AcousticEnergyModel`, and `policy_from_jax_params`
the one-shot policy's ("['params']['MLP_0']['Dense_0']['kernel']") onto
`PolicyNet`'s: conv kernels HWIO -> OIHW,
Dense kernels (in, out) -> (out, in). The CNN ends in a global max pool, so
no flatten order needs permuting; images go channels-last -> NCHW at the
model's input. Any leaf it cannot map, and any parameter left without a
leaf, is an error.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")


def _flatten(tree, prefix: tuple = ()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _named_leaves(tree_or_npz) -> dict:
    """{path tuple: array} from an npz path, a dict of keystr-named leaves
    or a nested dict."""
    if isinstance(tree_or_npz, (str, os.PathLike)):
        with np.load(tree_or_npz) as z:
            return {tuple(_KEY.findall(k)): z[k] for k in z.files}
    if all(isinstance(k, str) and k.startswith("[") for k in tree_or_npz):
        return {tuple(_KEY.findall(k)): np.asarray(v) for k, v in tree_or_npz.items()}
    return _flatten(tree_or_npz)


def _index(name: str, prefix: str) -> int:
    if not name.startswith(prefix + "_"):
        raise KeyError(name)
    return int(name[len(prefix) + 1:])


def _target(path: tuple) -> str:
    """The port's parameter name for one flax leaf path."""
    top, params, *rest = path
    if params != "params":
        raise KeyError(path)
    leaf = {"kernel": "weight", "bias": "bias"}[rest[-1]]
    if top == "wave_encoder":
        if rest[0] == "CNNBase_0":
            block = _index(rest[1], "ResidualBlock")
            conv = _index(rest[2], "Conv")
            if len(rest) != 4:
                raise KeyError(path)
            return f"wave_encoder.cnn.blocks.{block}.conv{conv}.{leaf}"
        head = _index(rest[0], "MLP")
        layer = _index(rest[1], "Dense")
        if len(rest) != 3:
            raise KeyError(path)
        return f"wave_encoder.heads.{head}.layers.{layer}.{leaf}"
    if top == "design_encoder":
        _index(rest[0], "MLP")
        layer = _index(rest[1], "Dense")
        if len(rest) != 3:
            raise KeyError(path)
        return f"design_mlp.mlp.layers.{layer}.{leaf}"
    raise KeyError(path)


def _policy_target(path: tuple) -> str:
    """The port's `PolicyNet` parameter name for one flax leaf path."""
    params, top, *rest = path
    if params != "params":
        raise KeyError(path)
    leaf = {"kernel": "weight", "bias": "bias"}[rest[-1]]
    if top == "CNNBase_0" and len(rest) == 3:
        block = _index(rest[0], "ResidualBlock")
        conv = _index(rest[1], "Conv")
        return f"cnn.blocks.{block}.conv{conv}.{leaf}"
    if top == "MLP_0" and len(rest) == 2:
        return f"mlp.layers.{_index(rest[0], 'Dense')}.{leaf}"
    raise KeyError(path)


def from_jax_params(tree_or_npz, expected: dict | None = None) -> dict:
    """Port `state_dict` of `AcousticEnergyModel` from flax parameters.
    `expected` (a module's `state_dict()`) makes a leaf left over on either
    side, or a shape that does not match, an error."""
    return _convert(tree_or_npz, _target, expected)


def policy_from_jax_params(tree_or_npz, expected: dict | None = None) -> dict:
    """Port `state_dict` of `models.policy.PolicyNet` from the flax
    parameters of the JAX package's `PolicyNet`; `expected` as for
    `from_jax_params`."""
    return _convert(tree_or_npz, _policy_target, expected)


def _convert(tree_or_npz, target, expected: dict | None) -> dict:
    out = {}
    for path, arr in _named_leaves(tree_or_npz).items():
        try:
            name = target(path)
        except (KeyError, ValueError, IndexError) as e:
            raise KeyError(f"no port parameter for flax leaf {path}") from e
        if arr.ndim == 4:  # conv HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # Dense (in, out) -> (out, in)
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(f"parameters without a flax leaf: {missing}; leaves with no "
                           f"parameter: {extra}")
        for k, v in out.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"{k}: flax shape {tuple(v.shape)} vs port "
                                 f"{tuple(expected[k].shape)}")
    return out
