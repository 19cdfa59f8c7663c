"""The port's weights from the JAX package's checkpoints, and back.

`from_jax_params` maps the flax named-leaf npz (keys such as
"['wave_encoder']['params']['CNNBase_0']['ResidualBlock_0']['Conv_0']['kernel']")
onto the `state_dict` of one of the port's models, by the leaf map of its
class (`LEAF_MAPS`: the flagship `AcousticEnergyModel`, the one-shot
`PolicyNet`, the `NODEEnergyModel` and the `WaveControlPINN`): 2-D conv
kernels HWIO -> OIHW, 1-D conv kernels (k, in, out) -> (out, in, k), Dense
kernels (in, out) -> (out, in). The CNNs end in a global max pool, so no
flatten order needs permuting; images go channels-last -> NCHW at the
model's input. Any leaf it cannot map, and any parameter left without a
leaf, is an error. `to_jax_params` is the inverse: a `state_dict` to
keystr-named leaves under the flax paths, the transposes undone, so the
JAX package loads what the port saves.
"""
from __future__ import annotations

import functools
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


# Leaf maps: (port module path, flax module path) pairs, "{}" standing
# for a layer's index; a parameter's ".weight"/".bias" is the flax leaf's
# "kernel"/"bias".
_WAVE_CNN = [("wave_encoder.cnn.blocks.{}.conv{}",
              "wave_encoder/params/CNNBase_0/ResidualBlock_{}/Conv_{}")]
_WAVE_ENCODER = _WAVE_CNN + [("wave_encoder.heads.{}.layers.{}",
                               "wave_encoder/params/MLP_{}/Dense_{}")]
_DESIGN_ENCODER = [("design_mlp.mlp.layers.{}", "design_encoder/params/MLP_0/Dense_{}")]
LEAF_MAPS = {
    "AcousticEnergyModel": _WAVE_ENCODER + _DESIGN_ENCODER,
    "PolicyNet": [("cnn.blocks.{}.conv{}", "params/CNNBase_0/ResidualBlock_{}/Conv_{}"),
                  ("mlp.layers.{}", "params/MLP_0/Dense_{}")],
    "NODEEnergyModel": _WAVE_CNN + _DESIGN_ENCODER + [
        ("wave_encoder.head", "wave_encoder/params/Dense_0"),
        ("dynamics.layers.{}", "dynamics/params/Dense_{}")],
    "WaveControlPINN": _WAVE_ENCODER + _DESIGN_ENCODER + [
        ("compressor.convs.{}", "compressor/params/Conv_{}"),
        ("field_net.dense.{}", "field_net/params/Dense_{}"),
        ("field_net.heads.{}.layers.{}", "field_net/params/MLP_{}/Dense_{}")],
}
_LEAVES = {"weight": "kernel", "bias": "bias"}


@functools.lru_cache(maxsize=None)
def _pattern(template: str) -> re.Pattern:
    return re.compile(r"(\d+)".join(re.escape(p) for p in template.split("{}")))


def _rename(kind: str, name: str, to_flax: bool) -> str:
    """One parameter's name in the other package by the leaf map of model
    class `kind`: a port name ("a.b.0.weight") to a flax path
    ("a/params/B_0/kernel"), or back."""
    src, dst, sep, out_sep = (0, 1, ".", "/") if to_flax else (1, 0, "/", ".")
    leaves = _LEAVES if to_flax else {v: k for k, v in _LEAVES.items()}
    module, _, leaf = name.rpartition(sep)
    for rule in LEAF_MAPS[kind]:
        m = _pattern(rule[src]).fullmatch(module)
        if m and leaf in leaves:
            return rule[dst].format(*m.groups()) + out_sep + leaves[leaf]
    raise KeyError(name)


def model_kind(model) -> str:
    """The leaf map's key of a port model: its class's name, or the
    nearest base class's that has a map."""
    for cls in type(model).__mro__:
        if cls.__name__ in LEAF_MAPS:
            return cls.__name__
    raise KeyError(f"no leaf map for model class {type(model).__name__!r}")


def _keystr(path: tuple) -> str:
    return "".join(f"['{p}']" for p in path)


def to_flax_layout(arr: np.ndarray) -> np.ndarray:
    """A port parameter's array in flax's layout: 2-D conv OIHW -> HWIO,
    1-D conv (out, in, k) -> (k, in, out), dense (out, in) -> (in, out)."""
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim in (2, 3):
        return arr.T
    return arr


def from_flax_layout(arr: np.ndarray) -> np.ndarray:
    """A flax leaf's array in the port's layout: 2-D conv HWIO -> OIHW,
    1-D conv (k, in, out) -> (out, in, k), dense (in, out) -> (out, in)."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim in (2, 3):
        return arr.T
    return arr


def jax_names(named: dict, kind: str = "AcousticEnergyModel") -> dict:
    """{port parameter name: flax keystr} for the names of a `state_dict`
    (or of `named_parameters`) of a model of class `kind`."""
    out = {}
    for name in named:
        try:
            out[name] = _keystr(tuple(_rename(kind, name, to_flax=True).split("/")))
        except KeyError as e:
            raise KeyError(f"no flax leaf for port parameter {name} in {kind}'s map") from e
    return out


def to_jax_params(state: dict, kind: str = "AcousticEnergyModel") -> dict:
    """{flax keystr: float32 array} of a port `state_dict` of a model of
    class `kind`: the leaves the JAX package's `params.npz` holds, in its
    layouts."""
    names = jax_names(state, kind)
    return {names[k]: np.ascontiguousarray(to_flax_layout(v.detach().cpu().numpy()))
            for k, v in state.items()}


def policy_to_jax_params(state: dict) -> dict:
    return to_jax_params(state, "PolicyNet")


def from_jax_params(tree_or_npz, expected: dict | None = None,
                    kind: str = "AcousticEnergyModel") -> dict:
    """Port `state_dict` of a model of class `kind` from flax parameters.
    `expected` (a module's `state_dict()`) makes a leaf left over on either
    side, or a shape that does not match, an error."""
    out = {}
    for path, arr in _named_leaves(tree_or_npz).items():
        try:
            name = _rename(kind, "/".join(path), to_flax=False)
        except KeyError as e:
            raise KeyError(f"no port parameter for flax leaf {path} in {kind}'s map") from e
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


def policy_from_jax_params(tree_or_npz, expected: dict | None = None) -> dict:
    """Port `state_dict` of `models.policy.PolicyNet` from the flax
    parameters of the JAX package's `PolicyNet`; `expected` as for
    `from_jax_params`."""
    return from_jax_params(tree_or_npz, expected, "PolicyNet")
