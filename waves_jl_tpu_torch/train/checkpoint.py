"""Checkpoints in the JAX package's npz format (counterpart of
`waves_jl_tpu/train/checkpoint.py`), so each package resumes from the
other's. A checkpoint directory holds

  params.npz     the parameters under their flax key paths
                 ("['wave_encoder']['params']['CNNBase_0']...['kernel']"),
                 in flax's layouts;
  opt_state.npz  the optimizer state under optax's leaf paths: with
                 accumulation (`optax.MultiSteps(optax.adam)`) ".mini_step",
                 ".gradient_step", ".inner_opt_state[0].count" (int32
                 scalars), ".inner_opt_state[0].mu<param>",
                 ".inner_opt_state[0].nu<param>", ".acc_grads<param>";
                 without, "[0].count", "[0].mu<param>", "[0].nu<param>";
  meta.json      the training step, and any extra keys.

`load_model_checkpoint` fills a model from the parameters alone: the
flagship, the one-shot `PolicyNet` or a baseline, each by its class's leaf
map (`models.convert.LEAF_MAPS`). The JAX package's orbax variants are
JAX-only.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.convert import (from_flax_layout, from_jax_params, jax_names, model_kind,
                              to_flax_layout, to_jax_params)
from .optim import AdamState, MultiStepsState


def load_params(path: str) -> dict:
    """{keystr name: array} of the checkpoint's parameter leaves."""
    with np.load(os.path.join(path, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def load_step(path: str) -> int:
    with open(os.path.join(path, "meta.json")) as f:
        return int(json.load(f)["step"])


def load_model_checkpoint(model: torch.nn.Module, path: str) -> int:
    """Load a checkpoint into `model` (any class with a leaf map), every
    leaf mapped and every parameter filled; returns the training step."""
    state = from_jax_params(load_params(path), expected=model.state_dict(),
                            kind=model_kind(model))
    model.load_state_dict(state, strict=True)
    return load_step(path)


def load_policy_checkpoint(net: torch.nn.Module, path: str) -> int:
    """`load_model_checkpoint` for a one-shot policy's `PolicyNet`."""
    return load_model_checkpoint(net, path)


def _opt_leaves(state, names: dict) -> dict:
    """{optax keystr: array} of an optimizer state; `names` maps parameter
    names to flax keystrs."""
    def moments(prefix, d):
        return {prefix + names[k]: np.ascontiguousarray(to_flax_layout(v.detach().cpu().numpy()))
                for k, v in d.items()}

    def adam(prefix, s: AdamState):
        return {prefix + ".count": np.array(s.count, np.int32), **moments(prefix + ".mu", s.mu),
                **moments(prefix + ".nu", s.nu)}

    if isinstance(state, MultiStepsState):
        return {".mini_step": np.array(state.mini_step, np.int32),
                ".gradient_step": np.array(state.gradient_step, np.int32),
                **adam(".inner_opt_state[0]", state.inner_opt_state),
                **moments(".acc_grads", state.acc_grads)}
    return adam("[0]", state)


def _opt_restore(npz, like, names: dict):
    """An optimizer state shaped as `like`, its leaves read from `npz`."""
    def moments(prefix, d):
        out = {}
        for k, v in d.items():
            arr = from_flax_layout(npz[prefix + names[k]])
            out[k] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(v.device)
        return out

    def adam(prefix, s: AdamState):
        return AdamState(count=int(npz[prefix + ".count"]), mu=moments(prefix + ".mu", s.mu),
                         nu=moments(prefix + ".nu", s.nu))

    if isinstance(like, MultiStepsState):
        return MultiStepsState(mini_step=int(npz[".mini_step"]),
                               gradient_step=int(npz[".gradient_step"]),
                               inner_opt_state=adam(".inner_opt_state[0]", like.inner_opt_state),
                               acc_grads=moments(".acc_grads", like.acc_grads))
    return adam("[0]", like)


def save_checkpoint(path: str, model: torch.nn.Module, opt_state=None, step: int = 0,
                    extra: dict | None = None) -> None:
    """Write `model`'s parameters (any class with a leaf map), the optimizer
    state if given, and meta.json under `path`."""
    os.makedirs(path, exist_ok=True)
    state = model.state_dict()
    kind = model_kind(model)
    np.savez(os.path.join(path, "params.npz"), **to_jax_params(state, kind))
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"),
                 **_opt_leaves(opt_state, jax_names(state, kind)))
    meta = {"step": int(step)}
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, model: torch.nn.Module, opt_state_like=None):
    """Fill `model` from the checkpoint at `path` and read the optimizer
    state shaped as `opt_state_like` (from `opt.init`), where given and
    saved. Returns (model, opt_state | None, step)."""
    load_model_checkpoint(model, path)
    opt_state = None
    opt_path = os.path.join(path, "opt_state.npz")
    if opt_state_like is not None and os.path.exists(opt_path):
        with np.load(opt_path) as z:
            opt_state = _opt_restore(z, opt_state_like,
                                     jax_names(model.state_dict(), model_kind(model)))
    return model, opt_state, load_step(path)
