"""Model-predictive control through the learned surrogate (counterpart of
the random-shooting and hybrid paths of `waves_jl_tpu/control/mpc.py`).

`RandomShooting` draws `shots` action sequences, scores each by the
surrogate's cumulative scattered energy plus an L2 action penalty, and
takes the first action of the cheapest. `make_mpc_episode_fused` runs a
whole episode of observe -> select -> fused env window.

`HybridShooting` (from `make_hybrid_action_fused`) prunes the shots with the
surrogate and re-ranks the best `topk` exactly in the simulator, optionally
on a coarser grid, through the candidate-batched kernel K3 by default.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..designs import DesignSpace
from ..env import EnvState, WaveEnv, env_observe, env_time, resize_weights
from ..physics.dynamics import build_tspan
from ..utils.trees import tree_clamp, tree_leaves, tree_map, tree_normal


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


def coarsen_env_state(env_lo: WaveEnv, state: EnvState) -> EnvState:
    """Project a state onto `env_lo`'s coarser grid (counterpart of the JAX
    package's `coarsen_env_state`): the wave history and the source shape
    are resized with `jax.image.resize`'s linear, antialiased weights
    (`env.resize_weights`); design and time step carry over unchanged."""
    m_x, m_y = env_lo.dim.shape
    n_x, n_y = state.wave.shape[-2:]
    dev = state.wave.device
    wx = torch.from_numpy(resize_weights(n_x, m_x)).to(dev)
    wy = torch.from_numpy(resize_weights(n_y, m_y)).to(dev)

    def resize(img):
        return torch.matmul(torch.matmul(wx, img), wy.T)

    return dataclasses.replace(
        state, wave=resize(state.wave),
        source=dataclasses.replace(state.source, shape=resize(state.source.shape)))


NOISE_FLOOR = 0.05  # least standard deviation of an exact-CEM refit


class HybridShooting:
    """Surrogate-pruned exact MPC (the JAX package's `_hybrid_act`): the
    surrogate scores `shots` candidate sequences, the simulator re-evaluates
    the `topk` cheapest exactly, and the action is the first of the sequence
    with the lowest exact cost (cumulative scattered energy over the horizon
    plus alpha times the action penalty).

    `rerank_env`: a coarser grid over the same domain, dt and steps a window
    for the re-rank; the state is projected onto it (`coarsen_env_state`)
    while the chosen action is applied at full resolution. `batched` (the
    default): the re-rank runs the K candidates together through the batched
    kernel K3 (`make_rerank_rollout`); False runs K rollouts in turn through
    K2/K1, the same costs (each K3 candidate is K2's state bit for bit) more
    slowly on the card, kept as the reference route. The JAX package
    defaults to the sequential route for a loss of the TPU's DMA pipelining
    that the card does not have.
    `exact_rounds > 1`: exact-CEM refinement; each extra round fits a
    diagonal Gaussian (standard deviation at least NOISE_FLOOR) to the
    `exact_elites` best sequences by exact cost, evaluates `topk` fresh
    draws around it exactly, and the choice ranges over every evaluation,
    so the chosen exact cost never grows with the rounds.

    Random draws go through `candidates` and `noise`, which a caller may
    override to supply its own.
    """

    def __init__(self, env: WaveEnv, model, horizon: int = 5, shots: int = 256, topk: int = 8,
                 alpha: float = 1.0, rerank_env: WaveEnv | None = None, batched: bool = True,
                 exact_rounds: int = 1, exact_elites: int = 8):
        from ..physics.fused import make_env_step_fused, make_rerank_rollout

        if rerank_env is not None and (rerank_env.dt != env.dt or
                                       rerank_env.integration_steps != env.integration_steps):
            raise ValueError("rerank_env must share the env's dt and steps per action window")
        self.env, self.model, self.rerank_env = env, model, rerank_env
        self.horizon, self.shots, self.topk, self.alpha = horizon, shots, topk, alpha
        self.exact_rounds, self.exact_elites = exact_rounds, exact_elites
        sim_env = rerank_env if rerank_env is not None else env
        self.rollout = make_rerank_rollout(sim_env, topk, horizon) if batched else None
        self.sim_step = None if batched else make_env_step_fused(sim_env)

    def candidates(self, generator: torch.Generator):
        """This selection's (shots, horizon) candidate sequences."""
        return build_action_sequence(self.env.action_space, generator, self.horizon, self.shots)

    def noise(self, generator: torch.Generator, like):
        """A refinement round's standard-normal draw shaped like `like`."""
        return tree_normal(generator, like)

    def prune(self, state: EnvState, generator: torch.Generator):
        """Surrogate prune: the candidates (shots, horizon), their action
        penalties (shots,) and the indices (topk,) of the lowest surrogate
        costs, lowest first and lower index first on ties (as
        `jax.lax.top_k` of the negated cost orders them)."""
        actions = self.candidates(generator)
        penalty = compute_action_cost(actions)
        obs = env_observe(self.env, state)
        t = selection_tspan(self.model, self.env, state, self.horizon, self.shots)
        energy = self.model.predict_shot_energy(obs.wave, state.design, actions, t)
        cost = energy + self.alpha * penalty
        return actions, penalty, torch.argsort(cost, stable=True)[:self.topk]

    def exact_eval(self, state: EnvState, acts, t0):
        """(K,) cumulative scattered energy of K sequences (K, horizon) from
        `state` in the re-rank simulator."""
        if self.rollout is not None:
            return self.rollout(state, acts, t0)
        costs = []
        for s in range(tree_leaves(acts)[0].shape[0]):
            st, sc = state, []
            for h in range(self.horizon):
                st, _ = self.sim_step(st, tree_map(lambda v: v[s, h], acts))
                sc.append(torch.sum(st.signal[1:, 2]))
            costs.append(torch.sum(torch.stack(sc)))
        return torch.stack(costs)

    def rerank(self, state: EnvState, actions, penalty, best, generator: torch.Generator):
        """Exact re-rank of the pruned candidates `best` and the exact-CEM
        rounds: every evaluated sequence (E, horizon) and its exact cost
        (E,)."""
        ev_actions = tree_map(lambda v: v[best], actions)
        st = coarsen_env_state(self.rerank_env, state) if self.rerank_env is not None else state
        t0 = env_time(self.env, state)
        ev_cost = self.exact_eval(st, ev_actions, t0) + self.alpha * penalty[best]
        if self.exact_rounds > 1:
            lead = (self.topk, self.horizon)
            low = tree_map(lambda v: v.expand(*lead, *v.shape), self.env.action_space.low)
            high = tree_map(lambda v: v.expand(*lead, *v.shape), self.env.action_space.high)
        for _ in range(self.exact_rounds - 1):
            n_e = min(self.exact_elites, ev_cost.shape[0])
            eidx = torch.argsort(ev_cost, stable=True)[:n_e]
            elite = tree_map(lambda v: v[eidx], ev_actions)
            mu = tree_map(lambda v: v.mean(dim=0, keepdim=True), elite)
            sd = tree_map(lambda v: torch.clamp(v.std(dim=0, correction=0, keepdim=True),
                                                min=NOISE_FLOOR), elite)
            noise = self.noise(generator, low)
            fresh = tree_clamp(tree_map(lambda m, s, z: m + s * z, mu, sd, noise), low, high)
            f_cost = self.exact_eval(st, fresh, t0) + self.alpha * compute_action_cost(fresh)
            ev_actions = tree_map(lambda a, b: torch.cat([a, b]), ev_actions, fresh)
            ev_cost = torch.cat([ev_cost, f_cost])
        return ev_actions, ev_cost

    def __call__(self, state: EnvState, generator: torch.Generator):
        """One selection: (first action of the chosen sequence, its exact
        cost)."""
        actions, penalty, best = self.prune(state, generator)
        ev_actions, ev_cost = self.rerank(state, actions, penalty, best, generator)
        idx = torch.argmin(ev_cost)
        return tree_map(lambda v: _take(v, idx)[0], ev_actions), _take(ev_cost, idx)


def make_hybrid_action_fused(env: WaveEnv, model, horizon: int = 5, shots: int = 256,
                             topk: int = 8, alpha: float = 1.0,
                             rerank_env: WaveEnv | None = None, batched: bool = True,
                             exact_rounds: int = 1, exact_elites: int = 8):
    """The hybrid controller per action, as the JAX package's
    `make_hybrid_action_fused` gives it: returns (act, step) with
    act(state, generator) -> (action, chosen exact cost) a `HybridShooting`
    and step(state, action) -> (state', info) the full-resolution fused env
    window that applies it."""
    from ..physics.fused import make_env_step_fused

    act = HybridShooting(env, model, horizon=horizon, shots=shots, topk=topk, alpha=alpha,
                         rerank_env=rerank_env, batched=batched, exact_rounds=exact_rounds,
                         exact_elites=exact_elites)
    return act, make_env_step_fused(env)
