"""One-shot control policy (counterpart of `waves_jl_tpu/models/policy.py`):
a network trained by behaviour cloning of the CEM + gradient-polish
controller maps the observation and the current design straight to an
action, so a decision is one forward pass and no candidate rollout.

The net emits a tanh-bounded vector in [-1, 1]^D, mapped affinely onto the
action box and rebuilt into an action tree with `designs.design_with_vec`,
so the box clamp is built into the output. `bc_loss` is the
behaviour-cloning loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..designs import DesignSpace, design_with_vec, normalize_design
from ..device import resolve_device
from ..utils.trees import tree_zeros_like
from .layers import MLP, CNNBase, full_float32, init_flax_like_


class PolicyNet(nn.Module):
    """CNN over the observation image, joined with the normalised design
    vector, then an MLP to one tanh-bounded action vector."""

    def __init__(self, in_ch: int, design_dim: int, h_size: int, act_dim: int):
        super().__init__()
        self.cnn = CNNBase(in_ch, h_size)
        self.mlp = MLP(h_size + design_dim, [h_size, h_size, act_dim])

    @full_float32()
    def forward(self, obs: torch.Tensor, design_vec: torch.Tensor) -> torch.Tensor:
        """obs (B, res, res, C) channels last, design_vec (B, D) -> (B,
        act_dim) in [-1, 1]."""
        h = self.cnn(obs.permute(0, 3, 1, 2))
        return torch.tanh(self.mlp(torch.cat([h, design_vec], dim=-1)))


@dataclass(frozen=True)
class AmortizedPolicy:
    """The net with the design box (to normalise observations) and the
    action box (to scale its output)."""

    net: PolicyNet
    design_space: DesignSpace
    action_space: DesignSpace

    @classmethod
    def create(cls, design_space: DesignSpace, action_space: DesignSpace, h_size: int = 256,
               in_channels: int = 4, seed: int = 0, device="cuda") -> "AmortizedPolicy":
        """`in_channels` counts the observation's channels (3 frames and
        the source shape); the weights start as flax's initialisers draw
        them, from `seed`."""
        dev = resolve_device(device)
        act_dim = int(action_space.low.to_vec().shape[0])
        design_dim = int(design_space.low.to_vec().shape[-1])
        net = PolicyNet(in_channels, design_dim, h_size, act_dim)
        init_flax_like_(net, torch.Generator().manual_seed(seed))
        net = net.to(dev)
        return cls(net=net, design_space=design_space, action_space=action_space)

    def normalize_action(self, action) -> torch.Tensor:
        """Action tree -> [-1, 1]^D (the behaviour-cloning target)."""
        lo = self.action_space.low.to_vec()
        hi = self.action_space.high.to_vec()
        return 2.0 * (action.to_vec() - lo) / (hi - lo + 1e-8) - 1.0

    def action_from_unit(self, u: torch.Tensor):
        """[-1, 1]^D vector -> action tree inside the box."""
        lo = self.action_space.low.to_vec()
        hi = self.action_space.high.to_vec()
        vec = lo + (u * 0.5 + 0.5) * (hi - lo)
        return design_with_vec(tree_zeros_like(self.action_space.low), vec)

    def unit_batch(self, obs: torch.Tensor, designs) -> torch.Tensor:
        """(B, res, res, C) observations and designs with leading (B,) ->
        (B, D) in [-1, 1]."""
        return self.net(obs, normalize_design(designs, self.design_space))

    @torch.no_grad()
    def action(self, obs: torch.Tensor, design):
        """One observation (res, res, C) and its design -> one action."""
        vec = normalize_design(design, self.design_space)[None]
        return self.action_from_unit(self.net(obs[None], vec)[0])


def bc_loss(policy: AmortizedPolicy, batch: dict) -> torch.Tensor:
    """Behaviour-cloning MSE in normalised action units. batch: {"s_wave":
    (B, res, res, C), "s_design": designs with leading (B,), "a": actions
    with leading (B,)}, the episode's fields."""
    pred = policy.unit_batch(batch["s_wave"], batch["s_design"])
    return torch.mean((pred - policy.normalize_action(batch["a"])) ** 2)
