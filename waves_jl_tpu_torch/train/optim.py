"""Adam and gradient accumulation as optax computes them (`optax.adam` with
its defaults, wrapped in `optax.MultiSteps` when accumulating), over dicts
of tensors keyed by parameter name.

The states are plain objects whose fields carry optax's names, so
`train.checkpoint` writes them under optax's leaf paths and either package
resumes from the other's checkpoints. The counters are host integers: they
advance the same way on every call, so reading them never waits for the
card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AdamState:
    """`optax.ScaleByAdamState`: the number of applied updates and the
    first and second moments."""

    count: int
    mu: dict
    nu: dict


@dataclass
class MultiStepsState:
    """`optax.MultiStepsState`: micro-steps since the last update, updates
    applied, the inner Adam state and the running mean of the gradients."""

    mini_step: int
    gradient_step: int
    inner_opt_state: AdamState
    acc_grads: dict


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p, memory_format=torch.contiguous_format).detach()
            for k, p in params.items()}


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root 0)


class Adam:
    """`optax.adam(lr)` with its defaults. `update` returns the additive
    updates, -lr mu_hat / (sqrt(nu_hat) + eps), in optax's operation order."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: dict) -> AdamState:
        return AdamState(count=0, mu=_zeros(params), nu=_zeros(params))

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState):
        b1, b2 = B1, B2
        count = state.count + 1
        f = np.float32
        # optax's 1 - decay**count, in float32
        bc1 = float(f(1) - f(b1) ** f(count))
        bc2 = float(f(1) - f(b2) ** f(count))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
            m_hat = mu[k] / bc1
            v_hat = nu[k] / bc2
            updates[k] = (m_hat / (torch.sqrt(v_hat) + EPS)) * -self.lr
        return updates, AdamState(count=count, mu=mu, nu=nu)


class MultiSteps:
    """`optax.MultiSteps(opt, every_k_schedule=k)`: the gradients' running
    mean acc + (g - acc) / (mini_step + 1) is kept, and the inner optimizer
    runs on it every k-th micro-step; `update` returns None (no change to
    the parameters) on the others, and Adam's count advances only on
    applied updates."""

    def __init__(self, opt: Adam, every_k: int):
        self.opt, self.every_k = opt, int(every_k)

    def init(self, params: dict) -> MultiStepsState:
        return MultiStepsState(mini_step=0, gradient_step=0,
                               inner_opt_state=self.opt.init(params), acc_grads=_zeros(params))

    @torch.no_grad()
    def update(self, grads: dict, state: MultiStepsState):
        n = state.mini_step + 1
        acc = {k: a + (grads[k] - a) / n for k, a in state.acc_grads.items()}
        if state.mini_step < self.every_k - 1:
            return None, MultiStepsState(mini_step=n, gradient_step=state.gradient_step,
                                         inner_opt_state=state.inner_opt_state, acc_grads=acc)
        updates, inner = self.opt.update(acc, state.inner_opt_state)
        return updates, MultiStepsState(mini_step=0, gradient_step=state.gradient_step + 1,
                                        inner_opt_state=inner, acc_grads=_zeros(acc))


@torch.no_grad()
def apply_updates(params: dict, updates: dict | None) -> None:
    """p += u in place (`optax.apply_updates`); None leaves them as they are."""
    if updates is None:
        return
    for k, p in params.items():
        p.add_(updates[k])
