"""Flagship and policy weights from the JAX package's checkpoints.

`from_jax_params` maps the flax named-leaf npz (keys such as
"['wave_encoder']['params']['CNNBase_0']['ResidualBlock_0']['Conv_0']['kernel']")
onto the `state_dict` of `AcousticEnergyModel`, and `policy_from_jax_params`
the one-shot policy's ("['params']['MLP_0']['Dense_0']['kernel']") onto
`PolicyNet`'s: conv kernels HWIO -> OIHW,
Dense kernels (in, out) -> (out, in). The CNN ends in a global max pool, so
no flatten order needs permuting; images go channels-last -> NCHW at the
model's input. Any leaf it cannot map, and any parameter left without a
leaf, is an error. `to_jax_params` and `policy_to_jax_params` are the
inverses: a `state_dict` to keystr-named leaves under the flax paths, the
transposes undone, so the JAX package loads what the port saves.
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


def _keystr(path: tuple) -> str:
    return "".join(f"['{p}']" for p in path)


def _flax_leaf(leaf: str) -> str:
    return {"weight": "kernel", "bias": "bias"}[leaf]


def _source(name: str) -> tuple:
    """The flax leaf path of one parameter of `AcousticEnergyModel`."""
    parts = name.split(".")
    leaf = _flax_leaf(parts[-1])
    m = re.fullmatch(r"wave_encoder\.cnn\.blocks\.(\d+)\.conv(\d+)\.\w+", name)
    if m:
        return ("wave_encoder", "params", "CNNBase_0", f"ResidualBlock_{m[1]}", f"Conv_{m[2]}",
                leaf)
    m = re.fullmatch(r"wave_encoder\.heads\.(\d+)\.layers\.(\d+)\.\w+", name)
    if m:
        return ("wave_encoder", "params", f"MLP_{m[1]}", f"Dense_{m[2]}", leaf)
    m = re.fullmatch(r"design_mlp\.mlp\.layers\.(\d+)\.\w+", name)
    if m:
        return ("design_encoder", "params", "MLP_0", f"Dense_{m[1]}", leaf)
    raise KeyError(name)


def _policy_source(name: str) -> tuple:
    """The flax leaf path of one parameter of `PolicyNet`."""
    leaf = _flax_leaf(name.split(".")[-1])
    m = re.fullmatch(r"cnn\.blocks\.(\d+)\.conv(\d+)\.\w+", name)
    if m:
        return ("params", "CNNBase_0", f"ResidualBlock_{m[1]}", f"Conv_{m[2]}", leaf)
    m = re.fullmatch(r"mlp\.layers\.(\d+)\.\w+", name)
    if m:
        return ("params", "MLP_0", f"Dense_{m[1]}", leaf)
    raise KeyError(name)


def to_flax_layout(arr: np.ndarray) -> np.ndarray:
    """A port parameter's array in flax's layout: conv OIHW -> HWIO, dense
    (out, in) -> (in, out)."""
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 2:
        return arr.T
    return arr


def from_flax_layout(arr: np.ndarray) -> np.ndarray:
    """A flax leaf's array in the port's layout: conv HWIO -> OIHW, dense
    (in, out) -> (out, in)."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    return arr


def jax_names(named: dict, policy: bool = False) -> dict:
    """{port parameter name: flax keystr} for the names of a `state_dict`
    (or of `named_parameters`), of the flagship or, with `policy`, of
    `PolicyNet`."""
    source = _policy_source if policy else _source
    out = {}
    for name in named:
        try:
            out[name] = _keystr(source(name))
        except KeyError as e:
            raise KeyError(f"no flax leaf for port parameter {name}") from e
    return out


def to_jax_params(state: dict, policy: bool = False) -> dict:
    """{flax keystr: float32 array} of a port `state_dict` of
    `AcousticEnergyModel` (or, with `policy`, of `PolicyNet`): the leaves
    the JAX package's `params.npz` holds, in its layouts."""
    names = jax_names(state, policy)
    return {names[k]: np.ascontiguousarray(to_flax_layout(v.detach().cpu().numpy()))
            for k, v in state.items()}


def policy_to_jax_params(state: dict) -> dict:
    return to_jax_params(state, policy=True)


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
        out[name] = torch.from_numpy(np.array(from_flax_layout(arr), dtype=np.float32))
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
