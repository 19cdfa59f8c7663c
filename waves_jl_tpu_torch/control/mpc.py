"""Model-predictive control through the learned surrogate (counterpart of
the random-shooting path of `waves_jl_tpu/control/mpc.py`).

`RandomShooting` draws `shots` action sequences, scores each by the
surrogate's cumulative scattered energy plus an L2 action penalty, and
takes the first action of the cheapest. `make_mpc_episode_fused` runs a
whole episode of observe -> select -> fused env window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..designs import DesignSpace
from ..env import EnvState, WaveEnv, env_observe, env_time
from ..physics.dynamics import build_tspan
from ..utils.trees import tree_map


def build_action_sequence(action_space: DesignSpace, generator: torch.Generator,
                          horizon: int, shots: int):
    """Actions with leading (shots, horizon), uniform in the action box."""
    return action_space.sample(generator, batch=(shots, horizon))


def compute_action_cost(actions) -> torch.Tensor:
    """Sum over the horizon of the actions' L2 norms: (S, H) actions -> (S,)."""
    vecs = actions.to_vec()
    return torch.sum(torch.sqrt(torch.sum(vecs**2, dim=-1)), dim=-1)


def selection_tspan(model, env: WaveEnv, state: EnvState, horizon: int,
                    shots: int) -> torch.Tensor:
    """(shots, L) time grid of one selection on the model's latent steps;
    the horizon spans horizon x env.integration_steps x env.dt either way."""
    dt, steps = model.integrator.dt, model.integration_steps
    t = env_time(env, state) + build_tspan(0.0, dt, steps * horizon)
    t = torch.from_numpy(t).to(env.device)
    return t[None].expand(shots, t.shape[0])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a 0-d index tensor on the device, without reading it on
    the host."""
    return torch.index_select(x, 0, idx.reshape(1))[0]


@dataclass(frozen=True)
class RandomShooting:
    model: Any  # surrogate with predict_shot_energy
    horizon: int = 5
    shots: int = 256
    alpha: float = 1.0

    def candidates(self, env: WaveEnv, generator: torch.Generator):
        """This selection's (shots, horizon) candidate sequences."""
        return build_action_sequence(env.action_space, generator, self.horizon, self.shots)

    def __call__(self, env: WaveEnv, state: EnvState, generator: torch.Generator):
        actions = self.candidates(env, generator)
        obs = env_observe(env, state)
        t = selection_tspan(self.model, env, state, self.horizon, self.shots)
        energy = self.model.predict_shot_energy(obs.wave, state.design, actions, t)
        cost = energy + self.alpha * compute_action_cost(actions)
        idx = torch.argmin(cost)
        first = tree_map(lambda x: _take(x, idx)[0], actions)
        return first, {"cost": cost, "idx": idx}


def make_mpc_episode_fused(env: WaveEnv, mpc: RandomShooting):
    """Whole MPC episode: for each of env.actions windows, observe, select
    through `mpc.model`, and advance the fused env window.

    Returns run(state, generator) -> (final_state, signals (A, T+1, 3),
    chosen costs (A,), all shot costs (A, shots)).
    """
    from ..physics.fused import make_env_step_fused

    step = make_env_step_fused(env)

    def run(state: EnvState, generator: torch.Generator):
        signals, chosen, costs = [], [], []
        for _ in range(env.actions):
            a, info = mpc(env, state, generator)
            state, _ = step(state, a)
            signals.append(state.signal)
            chosen.append(_take(info["cost"], info["idx"]))
            costs.append(info["cost"])
        return state, torch.stack(signals), torch.stack(chosen), torch.stack(costs)

    return run
