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
on a coarser grid, through the candidate-batched kernel K3 by default;
`make_hybrid_episode_fused` runs its whole episode in one call.

Exact search and distillation: `OracleShooting` scores every shot in the
simulator, one window at a time (the reference route); `BatchedOracle`
(from `make_oracle_action_fused`, `make_oracle_episode_fused`) scores them
together through the batched kernel. `PoolProbe` (from
`make_pool_probe_fused`) records exactly scored candidate pools for the
ranking fine-tune, and `make_mpc_episode_recorded` records a controller's
episodes for behaviour cloning. `GradientShooting` descends the
surrogate's gradient on the actions; `EnsembleShooting` ranks by several
surrogates' mean and spread.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any

import torch

from ..designs import DesignSpace
from ..env import (EnvState, RandomDesignPolicy, WaveEnv, env_observe, env_time,
                   resize_weights)
from ..models.layers import full_float32
from ..physics.dynamics import build_tspan
from ..utils.trees import tree_clamp, tree_leaves, tree_map, tree_normal, tree_stack


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


@functools.lru_cache(maxsize=64)
def _on_device(device: torch.device, make, *key) -> torch.Tensor:
    """make(*key) (a float32 numpy array) copied to `device` once: a copy
    from the host waits for the card, so the loops that select and step
    make none."""
    return torch.from_numpy(make(*key)).to(device)


def selection_tspan(model, env: WaveEnv, state: EnvState, horizon: int,
                    shots: int) -> torch.Tensor:
    """(shots, L) time grid of one selection on the model's latent steps,
    or the env's for a model without them; the horizon spans horizon x
    env.integration_steps x env.dt either way. The grid from 0 is on the
    device once; the window's start is added there, in float32 as on the
    host."""
    if hasattr(model, "integrator") and hasattr(model, "integration_steps"):
        dt, steps = model.integrator.dt, model.integration_steps
    else:
        dt, steps = env.dt, env.integration_steps
    t = _on_device(env.device, build_tspan, 0.0, dt, steps * horizon) + float(env_time(env, state))
    return t[None].expand(shots, t.shape[0])


def _mpc_batch(env: WaveEnv, state: EnvState, actions, horizon: int, shots: int,
               model=None) -> dict:
    """The current observation broadcast into an S-shot batch for
    `model.forward`: {"s_wave", "s_design", "a", "t"}."""
    obs = env_observe(env, state)
    return {"s_wave": obs.wave[None].expand(shots, *obs.wave.shape),
            "s_design": tree_map(lambda x: x[None].expand(shots, *x.shape), state.design),
            "a": actions, "t": selection_tspan(model, env, state, horizon, shots)}


def surrogate_energy(model, obs, design, actions, t: torch.Tensor, x=None,
                     grad: bool = False) -> torch.Tensor:
    """(S,) cumulative scattered energy of S candidate sequences from one
    observation `obs` and its design, over the time grid t (S, L), by the
    first route the model has, in the JAX controllers' order:
    `predict_shot_energy` (`shot_energy` where `grad`, x a precomputed
    `encode_wave`), then `predict_shots`, then `forward` on the
    observation broadcast into an S-shot batch, its scattered channel
    summed over the grid. Autograd runs through it only where `grad`."""
    if hasattr(model, "predict_shot_energy"):
        energy = model.shot_energy if grad else model.predict_shot_energy
        return energy(obs.wave, design, actions, t, x=x)
    with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
        if hasattr(model, "predict_shots"):
            y_hat = model.predict_shots(obs.wave, design, actions, t)
        else:
            S = t.shape[0]
            y_hat = model({"s_wave": obs.wave[None].expand(S, *obs.wave.shape),
                           "s_design": tree_map(lambda v: v[None].expand(S, *v.shape), design),
                           "a": actions, "t": t})
        return torch.sum(y_hat[:, :, 2], dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a 0-d index tensor on the device, without reading it on
    the host."""
    return torch.index_select(x, 0, idx.reshape(1))[0]


@dataclass(frozen=True)
class RandomShooting:
    model: Any  # surrogate, scored through `surrogate_energy`
    horizon: int = 5
    shots: int = 256
    alpha: float = 1.0

    def candidates(self, env: WaveEnv, generator: torch.Generator):
        """This selection's (shots, horizon) candidate sequences."""
        return build_action_sequence(env.action_space, generator, self.horizon, self.shots)

    def __call__(self, env: WaveEnv, state: EnvState, generator: torch.Generator):
        actions = self.candidates(env, generator)
        t = selection_tspan(self.model, env, state, self.horizon, self.shots)
        energy = surrogate_energy(self.model, env_observe(env, state), state.design, actions, t)
        cost = energy + self.alpha * compute_action_cost(actions)
        idx = torch.argmin(cost)
        first = tree_map(lambda x: _take(x, idx)[0], actions)
        return first, {"cost": cost, "idx": idx}


@dataclass(frozen=True)
class EnsembleShooting:
    """Random shooting ranked by an ensemble of surrogates (the JAX
    package's `EnsembleShooting`): a candidate's cost is the members' mean
    predicted scattered energy plus `beta` times their spread (standard
    deviation, correction 0) plus alpha times the action penalty. `models`
    holds each member with its weights."""

    models: tuple
    horizon: int = 5
    shots: int = 256
    alpha: float = 1.0
    beta: float = 1.0

    def candidates(self, env: WaveEnv, generator: torch.Generator):
        """This selection's (shots, horizon) candidate sequences."""
        return build_action_sequence(env.action_space, generator, self.horizon, self.shots)

    def __call__(self, env: WaveEnv, state: EnvState, generator: torch.Generator):
        actions = self.candidates(env, generator)
        obs = env_observe(env, state)
        e = torch.stack([
            m.predict_shot_energy(obs.wave, state.design, actions,
                                  selection_tspan(m, env, state, self.horizon, self.shots))
            for m in self.models])  # (members, shots)
        cost = (e.mean(dim=0) + self.beta * e.std(dim=0, correction=0)
                + self.alpha * compute_action_cost(actions))
        idx = torch.argmin(cost)
        return tree_map(lambda x: _take(x, idx)[0], actions), {"cost": cost, "idx": idx}


@dataclass(frozen=True)
class GradientShooting:
    """Gradient MPC (the JAX package's `GradientShooting`): `shots` uniform
    sequences descend the surrogate's cost, the batch forward's cumulative
    scattered energy plus alpha times the action penalty, by `steps`
    projected gradient steps of `lr` (autograd through `model.forward`, in
    IEEE float32), and the cheapest after the last step gives the action.
    Draws go through `candidates`."""

    model: Any  # surrogate whose forward(batch) gives (B, L, 3) energies
    horizon: int = 5
    shots: int = 32
    alpha: float = 1.0
    lr: float = 0.05
    steps: int = 10

    def candidates(self, env: WaveEnv, generator: torch.Generator):
        """The (shots, horizon) starting sequences."""
        return build_action_sequence(env.action_space, generator, self.horizon, self.shots)

    def __call__(self, env: WaveEnv, state: EnvState, generator: torch.Generator):
        """One selection: (first action of the cheapest sequence, {"cost":
        the final costs, "idx", "cost_history": (steps, shots) the costs
        before each step})."""
        actions = self.candidates(env, generator)
        low, high = _box(env.action_space, (self.shots, self.horizon))

        def cost_fn(acts):
            batch = _mpc_batch(env, state, acts, self.horizon, self.shots, model=self.model)
            energy = torch.sum(self.model(batch)[:, :, 2], dim=1)
            return energy + self.alpha * compute_action_cost(acts)

        history = []
        for _ in range(self.steps):
            actions = tree_map(lambda v: v.detach().requires_grad_(True), actions)
            with torch.enable_grad(), full_float32():
                cost = cost_fn(actions)
                history.append(cost.detach())
                actions = _projected_step(actions, torch.sum(cost), self.lr, low, high)
        with torch.no_grad():
            cost = cost_fn(actions)
        idx = torch.argmin(cost)
        return (tree_map(lambda x: _take(x, idx)[0], actions),
                {"cost": cost, "idx": idx, "cost_history": torch.stack(history)})


def _projected_step(acts, total: torch.Tensor, lr: float, low, high):
    """acts - lr d(total)/d(acts), clamped to [low, high] and detached; a
    leaf the total does not read stays where it is."""
    grads = iter(torch.autograd.grad(total, tree_leaves(acts), allow_unused=True))

    def descend(v):
        g = next(grads)  # None for a leaf the total does not read
        return v.detach() if g is None else v.detach() - lr * g

    return tree_clamp(tree_map(descend, acts), low, high)


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

    model: Any  # surrogate, scored through `surrogate_energy`
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
        `state` (`surrogate_energy`), the wave encoded once where the model
        has `encode_wave`; through the gradient path if `grad`."""
        obs = env_observe(env, state)
        t = selection_tspan(self.model, env, state, self.horizon, shots)
        x = None
        if hasattr(self.model, "encode_wave"):
            with torch.no_grad():
                x = self.model.encode_wave(obs.wave)

        def cost(actions):
            return (surrogate_energy(self.model, obs, state.design, actions, t, x=x, grad=grad)
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
            acts = _projected_step(acts, total, self.polish_lr, low, high)
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
    wx = _on_device(dev, resize_weights, n_x, m_x)
    wy = _on_device(dev, resize_weights, n_y, m_y)

    def resize(img):
        return torch.matmul(torch.matmul(wx, img), wy.T)

    return dataclasses.replace(
        state, wave=resize(state.wave),
        source=dataclasses.replace(state.source, shape=resize(state.source.shape)))


NOISE_FLOOR = 0.05  # least standard deviation of an exact-CEM refit

# Candidates the oracle and the pool probe advance together through the
# batched kernel. At 700^2 a state buffer of 64 candidates holds 64 x 12 x
# 700^2 float32, 1.5 GB, and a window keeps four (its input, two step
# buffers and the kept state): about 6 GB of the card's 80. JAX scans the
# shots one at a time to keep one grid state.
EXACT_CHUNK = 64


def sequential_energy(step, state: EnvState, acts, horizon: int) -> torch.Tensor:
    """(S,) cumulative scattered energy of S sequences (S, horizon) from
    `state`, one shot and one window at a time through `step` (an env
    window such as `make_env_step_fused`'s): sum_h sum(signal_h[1:, 2])."""
    costs = []
    for s in range(tree_leaves(acts)[0].shape[0]):
        st, sc = state, []
        for h in range(horizon):
            st, _ = step(st, tree_map(lambda v: v[s, h], acts))
            # signal[0] repeats the previous window's last row: count each step once
            sc.append(torch.sum(st.signal[1:, 2]))
        costs.append(torch.sum(torch.stack(sc)))
    return torch.stack(costs)


def make_exact_scorer(env: WaveEnv, horizon: int):
    """score(state, actions, t0) -> (S,) the cumulative scattered energy of
    S sequences (leading (S, horizon)) from `state` in `env`'s simulator,
    `sequential_energy`'s quantity, the candidates advanced together in
    chunks of at most EXACT_CHUNK through `make_rerank_rollout` (batched K5,
    one batched owner pass a window). Each batched candidate is the single
    kernel's state bit for bit; the window times are the re-rank's."""
    from ..physics.fused import make_rerank_rollout

    rollout = make_rerank_rollout(env, horizon)

    def score(state: EnvState, actions, t0) -> torch.Tensor:
        n = tree_leaves(actions)[0].shape[0]
        return torch.cat([rollout(state, tree_map(lambda v: v[s:s + EXACT_CHUNK], actions), t0)
                          for s in range(0, n, EXACT_CHUNK)])

    return score


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
    kernel K3 (`make_exact_scorer`, at most EXACT_CHUNK at a time); False
    runs K rollouts in turn through
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
        from ..physics.fused import make_env_step_fused

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
        self.rollout = make_exact_scorer(sim_env, horizon) if batched else None
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
        return sequential_energy(self.sim_step, state, acts, self.horizon)

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


def make_hybrid_episode_fused(env: WaveEnv, model, horizon: int = 5, shots: int = 256,
                              topk: int = 8, alpha: float = 1.0, searcher=None,
                              rerank_env: WaveEnv | None = None, exact_rounds: int = 1,
                              exact_elites: int = 8):
    """A whole hybrid episode in one call (the JAX package's
    `make_hybrid_episode_fused`, one device program over the actions): for
    each of env.actions windows, the surrogate prune, the exact re-rank and
    the full-resolution env window, queued with no read of the card
    between actions (`make_action_episode` over `make_hybrid_action_fused`).
    The re-rank is batched through the candidate-batched kernel, the port's
    default; JAX's episode re-ranks sequentially, to the same costs.

    Returns run(state, generator) -> (final_state, signals (A, T+1, 3),
    chosen exact costs (A,)); `run.act` is the `HybridShooting`, whose
    `candidates` and `noise` a caller may override."""
    return make_action_episode(env, *make_hybrid_action_fused(
        env, model, horizon=horizon, shots=shots, topk=topk, alpha=alpha, rerank_env=rerank_env,
        exact_rounds=exact_rounds, exact_elites=exact_elites, searcher=searcher))


@dataclass(frozen=True)
class OracleShooting:
    """Random shooting against the simulator itself (the JAX package's
    `OracleShooting`): the upper bound of shooting MPC. Each of `shots`
    uniform sequences rolls `horizon` windows through `step_fn` (state,
    action) -> (state', info), one shot and one window at a time, and costs
    its cumulative scattered energy plus alpha times the action penalty.
    The reference route of `BatchedOracle`, as `HybridShooting(batched=
    False)` is of the batched re-rank. Draws go through `candidates`."""

    step_fn: Any
    horizon: int = 5
    shots: int = 16
    alpha: float = 1.0

    def candidates(self, env: WaveEnv, generator: torch.Generator):
        """This selection's (shots, horizon) candidate sequences."""
        return build_action_sequence(env.action_space, generator, self.horizon, self.shots)

    def __call__(self, env: WaveEnv, state: EnvState, generator: torch.Generator):
        actions = self.candidates(env, generator)
        cost = (sequential_energy(self.step_fn, state, actions, self.horizon)
                + self.alpha * compute_action_cost(actions))
        idx = torch.argmin(cost)
        return tree_map(lambda x: _take(x, idx)[0], actions), {"cost": cost, "idx": idx}


class BatchedOracle:
    """The oracle's selection (the JAX package's `_oracle_act`) with the
    shots scored together: `shots` uniform sequences roll `horizon` windows
    through `env`'s simulator in chunks of at most EXACT_CHUNK
    (`make_exact_scorer`), each costs its cumulative scattered energy plus
    alpha times the action penalty, and the argmin stays on the device.
    JAX scans the shots one at a time to hold one grid state; the costs are
    `OracleShooting`'s. Draws go through `candidates`."""

    def __init__(self, env: WaveEnv, horizon: int = 5, shots: int = 16, alpha: float = 1.0):
        self.env, self.horizon, self.shots, self.alpha = env, horizon, shots, alpha
        self.score = make_exact_scorer(env, horizon)

    def candidates(self, generator: torch.Generator):
        """This selection's (shots, horizon) candidate sequences."""
        return build_action_sequence(self.env.action_space, generator, self.horizon, self.shots)

    def costs(self, state: EnvState, actions) -> torch.Tensor:
        """(S,) exact costs of S sequences (S, horizon) from `state`."""
        return (self.score(state, actions, env_time(self.env, state))
                + self.alpha * compute_action_cost(actions))

    def select(self, state: EnvState, generator: torch.Generator):
        """Every candidate (shots, horizon) and its exact cost (shots,)."""
        actions = self.candidates(generator)
        return actions, self.costs(state, actions)

    @staticmethod
    def choose(actions, cost):
        """(first action of the cheapest sequence, its cost), on the device."""
        idx = torch.argmin(cost)
        return tree_map(lambda v: _take(v, idx)[0], actions), _take(cost, idx)

    def __call__(self, state: EnvState, generator: torch.Generator):
        """One selection: (first action of the cheapest sequence, its cost)."""
        return self.choose(*self.select(state, generator))


def make_oracle_action_fused(env: WaveEnv, horizon: int = 5, shots: int = 16, alpha: float = 1.0):
    """The oracle per action, as the JAX package's `make_oracle_action_fused`
    gives it: (act, step) with act(state, generator) -> (action, chosen
    cost) a `BatchedOracle` and step(state, action) -> (state', info) the
    fused env window that applies it."""
    from ..physics.fused import make_env_step_fused

    return BatchedOracle(env, horizon, shots, alpha), make_env_step_fused(env)


def make_action_episode(env: WaveEnv, act, step):
    """A whole episode of a controller that selects and applies one action
    at a time (the oracle, the hybrid): for each of env.actions windows,
    act(state, generator) -> (action, chosen cost) and step(state, action)
    -> (state', info). Returns run(state, generator) -> (final_state,
    signals (A, T+1, 3), chosen costs (A,)), with `run.act` and `run.step`
    the two it drives (a caller may override the selection's draws there).
    Nothing in the loop reads the card from the host: each window's
    selection, signal and cost stay on the card and are stacked at the
    end."""
    def run(state: EnvState, generator: torch.Generator):
        signals, chosen = [], []
        for _ in range(env.actions):
            a, c = act(state, generator)
            state, _ = step(state, a)
            signals.append(state.signal)
            chosen.append(c)
        return state, torch.stack(signals), torch.stack(chosen)

    run.act, run.step = act, step
    return run


def make_oracle_episode_fused(env: WaveEnv, horizon: int = 5, shots: int = 16,
                              alpha: float = 1.0):
    """A whole oracle episode (the JAX package's `make_oracle_episode_fused`):
    for each of env.actions windows, a `BatchedOracle` selection and the
    fused env window, as `make_action_episode` runs them."""
    return make_action_episode(env, *make_oracle_action_fused(env, horizon, shots, alpha))


class PoolProbe:
    """Exactly scored candidate pools for the ranking fine-tune (the JAX
    package's `make_pool_probe_fused`): at one state, `K` candidate
    sequences are scored in the simulator (on `rerank_env`'s coarser grid
    if given, the state projected by `coarsen_env_state`), through the
    batched kernel in chunks of at most EXACT_CHUNK.

    `refine_samples > 0` adds that many candidates near the optimum: a
    diagonal Gaussian (standard deviation with correction 0, no floor) fit
    to the `refine_elites` exactly cheapest, drawn and clamped to the box,
    and scored by a second rollout. With `searcher` (a `CEMShooting` on the
    distilled surrogate) the probe is a DAgger step: `searcher_samples` of
    the K candidates are the cheapest of its population (polished where it
    polishes), uniform draws make up the rest, and the advance action is
    the searcher's choice; without, it is the exact argmin.

    probe(state, generator) -> (pool, action), pool = {"s_wave": the
    observation, "s_design": the design, "t0": the time (0-d), "a": the
    candidates (K', horizon), "y_true": (K',) their cumulative scattered
    energy, "penalty": (K',) their action penalty}. Draws go through
    `candidates` and `noise` (the searcher's through its own)."""

    def __init__(self, env: WaveEnv, K: int = 16, horizon: int = 5, alpha: float = 1.0,
                 rerank_env: WaveEnv | None = None, refine_samples: int = 0,
                 refine_elites: int = 4, searcher=None, searcher_samples: int = 0):
        if rerank_env is not None and (rerank_env.dt != env.dt or
                                       rerank_env.integration_steps != env.integration_steps):
            raise ValueError("rerank_env must share the env's dt and steps per action window")
        if searcher is not None:
            if not 0 < searcher_samples <= K:
                raise ValueError(f"searcher_samples {searcher_samples} must be in (0, {K}]")
            if searcher.horizon != horizon:
                raise ValueError("searcher must share the probe's horizon")
        self.env, self.K, self.horizon, self.alpha = env, K, horizon, alpha
        self.rerank_env = rerank_env
        self.refine_samples, self.refine_elites = refine_samples, refine_elites
        self.searcher, self.searcher_samples = searcher, searcher_samples
        self.score = make_exact_scorer(rerank_env if rerank_env is not None else env, horizon)

    def candidates(self, generator: torch.Generator, n: int):
        """n uniform (n, horizon) candidate sequences."""
        return build_action_sequence(self.env.action_space, generator, self.horizon, n)

    def noise(self, generator: torch.Generator, like):
        """The refinement's standard-normal draw shaped like `like`."""
        return tree_normal(generator, like)

    def __call__(self, state: EnvState, generator: torch.Generator):
        a_ctrl = None
        if self.searcher is None:
            actions = self.candidates(generator, self.K)
        else:
            pop, cost_s = self.searcher.population(self.env, state, generator)
            if self.searcher.polish_steps > 0:
                pop, cost_s = self.searcher.polish(self.env, state, pop, cost_s)
            idx_s = torch.argmin(cost_s)
            a_ctrl = tree_map(lambda v: _take(v, idx_s)[0], pop)
            top = torch.argsort(cost_s, stable=True)[:self.searcher_samples]
            actions = tree_map(lambda v: v[top], pop)
            if self.searcher_samples < self.K:
                unif = self.candidates(generator, self.K - self.searcher_samples)
                actions = tree_map(lambda c, u: torch.cat([c, u]), actions, unif)
        st = coarsen_env_state(self.rerank_env, state) if self.rerank_env is not None else state
        t0 = env_time(self.env, state)
        y_true = self.score(st, actions, t0)
        if self.refine_samples > 0:
            cost0 = y_true + self.alpha * compute_action_cost(actions)
            elite = tree_map(lambda v: v[torch.argsort(cost0, stable=True)[:self.refine_elites]],
                             actions)
            mu = tree_map(lambda v: v.mean(dim=0, keepdim=True), elite)
            sd = tree_map(lambda v: v.std(dim=0, correction=0, keepdim=True), elite)
            low, high = _box(self.env.action_space, (self.refine_samples, self.horizon))
            noise = self.noise(generator, low)
            fresh = tree_clamp(tree_map(lambda m, s, z: m + s * z, mu, sd, noise), low, high)
            actions = tree_map(lambda u, f: torch.cat([u, f]), actions, fresh)
            y_true = torch.cat([y_true, self.score(st, fresh, t0)])
        penalty = compute_action_cost(actions)
        pool = {"s_wave": env_observe(self.env, state).wave, "s_design": state.design,
                "t0": torch.tensor(t0, device=self.env.device), "a": actions,
                "y_true": y_true, "penalty": penalty}
        if a_ctrl is not None:
            return pool, a_ctrl  # advance under the deployed controller
        idx = torch.argmin(y_true + self.alpha * penalty)
        return pool, tree_map(lambda v: _take(v, idx)[0], actions)


def make_pool_probe_fused(env: WaveEnv, K: int = 16, horizon: int = 5, alpha: float = 1.0,
                          rerank_env: WaveEnv | None = None, refine_samples: int = 0,
                          refine_elites: int = 4, searcher=None, searcher_samples: int = 0):
    """(probe, step): a `PoolProbe` and the fused env window at full
    resolution that advances the episode."""
    from ..physics.fused import make_env_step_fused

    probe = PoolProbe(env, K, horizon, alpha, rerank_env, refine_samples, refine_elites,
                      searcher, searcher_samples)
    return probe, make_env_step_fused(env)


def make_mpc_episode_recorded(env: WaveEnv, mpc, epsilon: float = 0.0, random_policy=None):
    """A whole MPC episode recorded as an `Episode` (the JAX package's
    `make_mpc_episode_recorded`), for on-policy datasets and behaviour
    cloning: each window observes, selects with `mpc` (no warm carry),
    draws a uniform action from `random_policy` (by default
    `RandomDesignPolicy`) and a Bernoulli(epsilon) that picks it in place of
    the controller's, on the device, and advances the fused env window.

    Returns run(state, generator) -> (final_state, Episode(s_wave,
    s_design, s_tspan, a, y))."""
    from ..data import Episode
    from ..physics.fused import make_env_step_fused

    step = make_env_step_fused(env)
    random_policy = random_policy or RandomDesignPolicy(env.action_space)

    def run(state: EnvState, generator: torch.Generator):
        rec = []
        for _ in range(env.actions):
            obs = env_observe(env, state)
            a_mpc, _ = mpc(env, state, generator)
            a_rnd = random_policy(generator)
            use_rnd = torch.rand((), generator=generator, device=generator.device) < epsilon
            a = tree_map(lambda m, r: torch.where(use_rnd.to(m.device), r, m), a_mpc, a_rnd)
            nxt, info = step(state, a)
            rec.append((obs.wave, state.design, torch.from_numpy(info["tspan"]).to(env.device),
                        a, nxt.signal))
            state = nxt
        s_wave, s_design, s_tspan, a, y = (tree_stack(list(x)) for x in zip(*rec))
        return state, Episode(s_wave=s_wave, s_design=s_design, s_tspan=s_tspan, a=a, y=y)

    return run
