"""Model-predictive control through the learned surrogate (counterpart of
the random-shooting, CEM, one-shot policy and hybrid paths of
`waves_jl_tpu/control/mpc.py`).

`RandomShooting` draws `shots` action sequences, scores each by the
surrogate's cumulative scattered energy plus an L2 action penalty, and
takes the first action of the cheapest. `CEMShooting` refits a diagonal
Gaussian to the best sequences over `iters` rounds and may polish the best
few by gradient descent through the surrogate. `make_mpc_episode_fused`
runs a whole episode of observe -> select -> fused env window, with CEM's
receding-horizon warm start where it asks for one;
`make_policy_episode_fused` the same with a one-shot policy in place of
the search.

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
    """Sum over the horizon of the actions' L2 norms: (S, H) actions -> (S,).
    The gradient of a zero action's norm is taken as 0, its subgradient:
    sqrt's is infinite there, and the JAX package's polish turns a zero
    action (the warm start's first incumbent) into a NaN sequence."""
    sq = torch.sum(actions.to_vec() ** 2, dim=-1)
    nonzero = sq > 0
    norm = torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)
    return torch.sum(norm, dim=-1)


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


def _box(space: DesignSpace, lead: tuple):
    """The action box's (low, high) trees broadcast to leading `lead`."""
    return tuple(tree_map(lambda v: v.expand(*lead, *v.shape), b) for b in (space.low, space.high))


@dataclass(frozen=True)
class CEMShooting:
    """Cross-entropy-method MPC (the JAX package's `CEMShooting`). Round 0
    draws `shots` sequences uniformly in the action box, as random shooting
    does; each of `iters` rounds keeps the `elites` cheapest, refits a
    diagonal Gaussian to them (standard deviation at least `noise_floor`),
    and draws `shots - elites` fresh sequences from it, clamped to the box.
    `polish_steps > 0` then descends the gradient of the surrogate cost from
    the `polish_topk` cheapest sequences, projecting onto the box each step,
    and adds the polished sequences to the set: the chosen cost never grows
    with the polish. `warm` asks `make_mpc_episode_fused` for the
    receding-horizon warm start (`incumbent`).

    Random draws go through `candidates` and `noise`, which a caller may
    override to supply its own.
    """

    model: Any  # surrogate with encode_wave, predict_shot_energy and shot_energy
    horizon: int = 5
    shots: int = 256
    alpha: float = 1.0
    iters: int = 3
    elites: int = 32
    noise_floor: float = 0.0
    warm: bool = False
    polish_steps: int = 0
    polish_topk: int = 8
    polish_lr: float = 0.02

    def candidates(self, env: WaveEnv, generator: torch.Generator):
        """Round 0's (shots, horizon) sequences, uniform in the box."""
        return build_action_sequence(env.action_space, generator, self.horizon, self.shots)

    def noise(self, generator: torch.Generator, like):
        """A refinement round's standard-normal draw shaped like `like`."""
        return tree_normal(generator, like)

    def __call__(self, env: WaveEnv, state: EnvState, generator: torch.Generator,
                 incumbent=None):
        """One selection: (first action of the cheapest sequence, {"cost":
        every evaluated sequence's cost, "idx": the cheapest's index, "seq":
        the cheapest sequence (horizon,)})."""
        actions, cost = self.population(env, state, generator, incumbent)
        if self.polish_steps > 0:
            actions, cost = self.polish(env, state, actions, cost)
        idx = torch.argmin(cost)
        seq = tree_map(lambda v: _take(v, idx), actions)
        return tree_map(lambda v: v[0], seq), {"cost": cost, "idx": idx, "seq": seq}

    def _cost(self, env: WaveEnv, state: EnvState, shots: int, grad: bool = False):
        """cost(actions) -> (shots,) surrogate cost of `shots` sequences from
        `state`, the wave encoded once; through the gradient path if
        `grad`."""
        obs = env_observe(env, state)
        t = selection_tspan(self.model, env, state, self.horizon, shots)
        with torch.no_grad():
            x = self.model.encode_wave(obs.wave)
        energy = self.model.shot_energy if grad else self.model.predict_shot_energy

        def cost(actions):
            return (energy(obs.wave, state.design, actions, t, x=x)
                    + self.alpha * compute_action_cost(actions))

        return cost

    def population(self, env: WaveEnv, state: EnvState, generator: torch.Generator,
                   incumbent=None):
        """The refined (shots, horizon) sequences and their surrogate costs.
        `incumbent` (a (horizon,) sequence, such as the previous plan shifted
        one window) takes the place of round 0's candidate 0. Elites are the
        lowest costs, lower index first on ties (`lax.top_k`'s order)."""
        eval_cost = self._cost(env, state, self.shots)
        low, high = _box(env.action_space, (self.shots - self.elites, self.horizon))
        actions = self.candidates(env, generator)
        if incumbent is not None:
            actions = tree_map(lambda v, inc: torch.cat([inc[None], v[1:]]), actions, incumbent)
        cost = eval_cost(actions)
        for _ in range(self.iters):
            eidx = torch.argsort(cost, stable=True)[:self.elites]
            elite = tree_map(lambda v: v[eidx], actions)
            mu = tree_map(lambda v: v.mean(dim=0, keepdim=True), elite)
            sd = tree_map(lambda v: torch.clamp(v.std(dim=0, correction=0, keepdim=True),
                                                min=self.noise_floor), elite)
            noise = self.noise(generator, low)
            fresh = tree_clamp(tree_map(lambda m, s, z: m + s * z, mu, sd, noise), low, high)
            actions = tree_map(lambda e, f: torch.cat([e, f]), elite, fresh)
            cost = eval_cost(actions)
        return actions, cost

    def polish(self, env: WaveEnv, state: EnvState, actions, cost):
        """`polish_steps` steps of a <- clamp(a - polish_lr * d(sum cost)/da)
        from the `polish_topk` cheapest sequences, through the surrogate's
        gradient path; returns the set with the polished sequences and their
        costs appended."""
        cost_fn = self._cost(env, state, self.polish_topk, grad=True)
        low, high = _box(env.action_space, (self.polish_topk, self.horizon))
        top = torch.argsort(cost, stable=True)[:self.polish_topk]
        acts = tree_map(lambda v: v[top], actions)
        for _ in range(self.polish_steps):
            acts = tree_map(lambda v: v.detach().requires_grad_(True), acts)
            with torch.enable_grad():
                total = torch.sum(cost_fn(acts))
            grads = iter(torch.autograd.grad(total, tree_leaves(acts), allow_unused=True))

            def descend(v):
                g = next(grads)  # None for a leaf the cost does not read
                return v.detach() if g is None else v.detach() - self.polish_lr * g

            acts = tree_clamp(tree_map(descend, acts), low, high)
        with torch.no_grad():
            cost_p = cost_fn(acts)
        return (tree_map(lambda a, p: torch.cat([a, p]), actions, acts),
                torch.cat([cost, cost_p]))


def make_mpc_episode_fused(env: WaveEnv, mpc):
    """Whole MPC episode: for each of env.actions windows, observe, select
    through `mpc.model`, and advance the fused env window. A controller with
    `warm` set (`CEMShooting`) gets the receding-horizon warm start: the
    first incumbent is the box midpoint over the horizon, each next one the
    previous selection's sequence shifted one window left, its last window
    repeated.

    Returns run(state, generator) -> (final_state, signals (A, T+1, 3),
    chosen costs (A,), all evaluated costs (A, candidates)).
    """
    from ..physics.fused import make_env_step_fused

    step = make_env_step_fused(env)
    warm = bool(getattr(mpc, "warm", False))

    def run(state: EnvState, generator: torch.Generator):
        signals, chosen, costs = [], [], []
        space = env.action_space
        inc = (tree_map(lambda lo, hi: ((lo + hi) / 2.0).expand(mpc.horizon, *lo.shape),
                        space.low, space.high) if warm else None)
        for _ in range(env.actions):
            if warm:
                a, info = mpc(env, state, generator, incumbent=inc)
                inc = tree_map(lambda v: torch.cat([v[1:], v[-1:]]), info["seq"])
            else:
                a, info = mpc(env, state, generator)
            state, _ = step(state, a)
            signals.append(state.signal)
            chosen.append(_take(info["cost"], info["idx"]))
            costs.append(info["cost"])
        return state, torch.stack(signals), torch.stack(chosen), torch.stack(costs)

    return run


def make_policy_episode_fused(env: WaveEnv, policy):
    """Whole episode under a one-shot policy (`models.policy.AmortizedPolicy`):
    for each of env.actions windows, observe, one forward pass, and the
    fused env window.

    Returns run(state, generator=None) -> (final_state, signals (A, T+1, 3),
    costs (A,) of zeros: a policy evaluates no candidate costs).
    """
    from ..physics.fused import make_env_step_fused

    step = make_env_step_fused(env)

    def run(state: EnvState, generator: torch.Generator | None = None):
        signals = []
        for _ in range(env.actions):
            obs = env_observe(env, state)
            state, _ = step(state, policy.action(obs.wave, state.design))
            signals.append(state.signal)
        return state, torch.stack(signals), torch.zeros(env.actions, device=env.device)

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
    `searcher` (a `CEMShooting` with the hybrid's horizon and alpha): the
    prune takes its refined population and costs in place of uniform
    candidates scored by `model`.
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
                 exact_rounds: int = 1, exact_elites: int = 8, searcher=None):
        from ..physics.fused import make_env_step_fused, make_rerank_rollout

        if searcher is not None and (searcher.horizon != horizon or searcher.alpha != alpha):
            raise ValueError("searcher must share the hybrid's horizon and alpha")
        if rerank_env is not None and (rerank_env.dt != env.dt or
                                       rerank_env.integration_steps != env.integration_steps):
            raise ValueError("rerank_env must share the env's dt and steps per action window")
        self.env, self.model, self.rerank_env = env, model, rerank_env
        self.horizon, self.shots, self.topk, self.alpha = horizon, shots, topk, alpha
        self.exact_rounds, self.exact_elites = exact_rounds, exact_elites
        self.searcher = searcher
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
        `jax.lax.top_k` of the negated cost orders them). With a searcher,
        the candidates and costs are its population's."""
        if self.searcher is not None:
            actions, cost = self.searcher.population(self.env, state, generator)
            penalty = compute_action_cost(actions)
        else:
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
            low, high = _box(self.env.action_space, (self.topk, self.horizon))
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
                             exact_rounds: int = 1, exact_elites: int = 8, searcher=None):
    """The hybrid controller per action, as the JAX package's
    `make_hybrid_action_fused` gives it (`searcher`: see `HybridShooting`):
    returns (act, step) with
    act(state, generator) -> (action, chosen exact cost) a `HybridShooting`
    and step(state, action) -> (state', info) the full-resolution fused env
    window that applies it."""
    from ..physics.fused import make_env_step_fused

    act = HybridShooting(env, model, horizon=horizon, shots=shots, topk=topk, alpha=alpha,
                         rerank_env=rerank_env, batched=batched, exact_rounds=exact_rounds,
                         exact_elites=exact_elites, searcher=searcher)
    return act, make_env_step_fused(env)
