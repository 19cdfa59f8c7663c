"""Read the JAX package's npz checkpoints (counterpart of the reading half
of `waves_jl_tpu/train/checkpoint.py`). A checkpoint directory holds
params.npz, the parameter pytree's leaves named by their key paths, and
meta.json with the training step. `load_model_checkpoint` fills the
flagship surrogate, `load_policy_checkpoint` the one-shot policy's net."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.convert import from_jax_params, policy_from_jax_params


def load_params(path: str) -> dict:
    """{keystr name: array} of the checkpoint's parameter leaves."""
    with np.load(os.path.join(path, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def load_step(path: str) -> int:
    with open(os.path.join(path, "meta.json")) as f:
        return int(json.load(f)["step"])


def load_model_checkpoint(model: torch.nn.Module, path: str) -> int:
    """Load a flagship checkpoint into `model`, every leaf mapped and every
    parameter filled; returns the training step."""
    state = from_jax_params(load_params(path), expected=model.state_dict())
    model.load_state_dict(state, strict=True)
    return load_step(path)


def load_policy_checkpoint(net: torch.nn.Module, path: str) -> int:
    """Load a one-shot policy checkpoint into `net` (a `PolicyNet`), every
    leaf mapped and every parameter filled; returns the training step."""
    state = policy_from_jax_params(load_params(path), expected=net.state_dict())
    net.load_state_dict(state, strict=True)
    return load_step(path)
