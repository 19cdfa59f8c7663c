"""Episode generation, horizon windowing, batching and storage (counterpart
of `waves_jl_tpu/data.py`).

An episode is a frozen dataclass of tensors with a leading action axis.
`generate_episode` runs the plain `env_step`; the fused generators run the
kernel path (`physics.fused.make_env_step_fused`, K5 by default), one
wrapper call a step, and `generate_episodes_chunked` is what the datagen
CLI drives. `generate_episodes_batch` advances a batch of episodes together
through the batched exact kernel. Random draws come from an explicit
`torch.Generator`. Episodes
are stored as npz or `.wbin` bundles of named leaves with the JAX
package's structure descriptor, or streamed into one shard, so either
package loads what the other saved.

Two deliberate differences from the JAX package: a ragged last chunk runs
only the episodes it has (JAX runs a full chunk and drops the surplus, to
avoid recompiling its whole-chunk program), and `.wbin` and shards raise
without `g++` instead of writing npz.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .env import EnvState, WaveEnv, env_observe, env_reset, env_step
from .utils.interp import flatten_repeated_last_dim
from .utils.trees import (decode_structure, encode_structure, register_tree_dataclass,
                          tree_index, tree_leaves, tree_map, tree_named_leaves, tree_stack)


@register_tree_dataclass
@dataclass(frozen=True)
class Episode:
    """One episode of A action windows.

    s_wave:   (A, res, res, 4) observation images
    s_design: design tree with leading axis A (the design observed at step i)
    s_tspan:  (A, T+1) float32 window times
    a:        action tree with leading axis A
    y:        (A, T+1, 3) energy signals
    """

    s_wave: torch.Tensor
    s_design: Any
    s_tspan: torch.Tensor
    a: Any
    y: torch.Tensor

    def __len__(self):
        return self.s_wave.shape[0]


def _draw_actions(env: WaveEnv, policy, generator: torch.Generator):
    """env.actions actions of `policy`, drawn up front and stacked (they
    do not depend on the state for RandomDesignPolicy)."""
    return tree_stack([policy(generator) for _ in range(env.actions)])


def _run_episode(env: WaveEnv, step, state, actions):
    """observe -> step for each action window. Returns (final state,
    Episode). The window times stay on the host until the episode ends, so
    the loop never waits for the card."""
    leaves = tree_leaves(actions)
    s_wave, s_design, s_tspan, ys = [], [], [], []
    for i in range(leaves[0].shape[0] if leaves else env.actions):
        obs = env_observe(env, state)
        state, info = step(state, tree_index(actions, i))
        s_wave.append(obs.wave)
        s_design.append(obs.design)
        s_tspan.append(info["tspan"])
        ys.append(state.signal)
    tspan = torch.from_numpy(np.stack(s_tspan)).to(env.device)
    return state, Episode(s_wave=torch.stack(s_wave), s_design=tree_stack(s_design),
                          s_tspan=tspan, a=actions, y=torch.stack(ys))


def generate_episode(env: WaveEnv, policy, generator: torch.Generator, reset: bool = True,
                     state=None):
    """One episode on the plain `env_step`: a reset (unless `state` is
    given and `reset` is False), then env.actions windows of actions drawn
    up front. Returns (final_state, Episode)."""
    if reset or state is None:
        state = env_reset(env, generator)
    actions = _draw_actions(env, policy, generator)
    return _run_episode(env, lambda s, a: env_step(env, s, a), state, actions)


def generate_episode_fused(env: WaveEnv, policy, generator: torch.Generator, fused_step,
                           state=None):
    """One episode on the kernel path; `fused_step` from
    `physics.fused.make_env_step_fused(env)`. Returns (final_state,
    Episode)."""
    if state is None:
        state = env_reset(env, generator)
    actions = _draw_actions(env, policy, generator)
    return _run_episode(env, fused_step, state, actions)


def make_episode_fused(env: WaveEnv):
    """Whole-episode generator on the kernel path (at the JAX package's
    default window's step times, `make_env_step_fused`): returns
    run(state, actions) -> (final_state, Episode) for actions with leading
    A."""
    from .physics.fused import make_env_step_fused

    step = make_env_step_fused(env)
    return lambda state, actions: _run_episode(env, step, state, actions)


def make_episode_chunk_fused(env: WaveEnv):
    """Chunk-of-episodes generator on the kernel path: returns
    run(states, actions) -> Episode with leading K on every leaf, for a
    sequence of K states and actions with leading (K, A). The episodes run
    in turn, so the card holds one episode's working set."""
    one_episode = make_episode_fused(env)

    def run(states, actions):
        return tree_stack([one_episode(st, tree_index(actions, k))[1]
                           for k, st in enumerate(states)])

    return run


def _stack_states(states) -> EnvState:
    """One state with a leading K on its wave, design, source and signal
    leaves from K states of one time step."""
    steps = {st.time_step for st in states}
    if len(steps) != 1:
        raise ValueError(f"the states are at different time steps {sorted(steps)}")
    return EnvState(wave=torch.stack([st.wave for st in states]),
                    design=tree_stack([st.design for st in states]),
                    source=tree_stack([st.source for st in states]),
                    signal=torch.stack([st.signal for st in states]), time_step=steps.pop())


def make_episode_batch_fused(env: WaveEnv):
    """Batch-of-episodes generator on the batched exact kernel (the
    counterpart of `jax.vmap` over the JAX package's `_episode_scan`, which
    steps XLA's `env_step` with the exact stencil, at the window's `tspan`
    times): the K episodes advance together, one step a launch of the
    candidate-batched kernel (K3
    radii-only with one batched owner pass a window where `radii_only_ok`
    holds, K3 general otherwise; `x_matmul=False`).

    Returns run(states, actions) -> (final states, Episode), states a
    sequence of K states of one time step and actions with leading (K, A);
    every leaf of the Episode and of the final states but `time_step`
    leads with K. Each episode is what the single-state exact window at one
    step a call (`make_env_step_fused(env, x_matmul=False,
    steps_per_call=1)`) gives it alone: frames and final state bit for bit,
    the signal within the energy partials' summation order."""
    from .physics.fused import make_env_step_fused

    step = make_env_step_fused(env, x_matmul=False, steps_per_call=1)

    def run(states, actions):
        state = _stack_states(states)
        s_wave, s_design, s_tspan, ys = [], [], [], []
        for i in range(tree_leaves(actions)[0].shape[1]):
            s_wave.append(env_observe(env, state).wave)
            s_design.append(state.design)
            state, info = step(state, tree_map(lambda v: v[:, i], actions))
            s_tspan.append(info["tspan"])
            ys.append(state.signal)
        k = state.wave.shape[0]
        tspan = torch.from_numpy(np.stack(s_tspan)).to(env.device)
        return state, Episode(s_wave=torch.stack(s_wave, dim=1),
                              s_design=tree_stack(s_design, dim=1),
                              s_tspan=tspan[None].expand(k, *tspan.shape).contiguous(),
                              a=actions, y=torch.stack(ys, dim=1))

    return run


def generate_episodes_batch(env: WaveEnv, policy, generator: torch.Generator, batch: int):
    """`batch` independent episodes (random designs, sources and actions)
    advanced together on the batched exact kernel
    (`make_episode_batch_fused`): the resets, then each episode's actions,
    drawn in turn from `generator` as `generate_episodes_chunked` draws a
    chunk's. Returns (final states, Episode), every leaf leading with
    `batch`."""
    states = [env_reset(env, generator) for _ in range(batch)]
    actions = tree_stack([_draw_actions(env, policy, generator) for _ in range(batch)])
    return make_episode_batch_fused(env)(states, actions)


def split_episode_batch(batched) -> list:
    """The Episodes of a batched (final states, Episode), in order."""
    _, eps = batched
    return [tree_index(eps, i) for i in range(eps.s_wave.shape[0])]


def _to_host(tree):
    """The tree's float32 leaves copied to the CPU in one transfer."""
    leaves = tree_leaves(tree)
    if not leaves or leaves[0].device.type == "cpu":
        return tree
    if any(x.dtype != torch.float32 for x in leaves):
        raise ValueError("episode leaves must be float32")
    host = iter(torch.cat([x.reshape(-1) for x in leaves]).cpu()
                .split([x.numel() for x in leaves]))
    return tree_map(lambda x: next(host).view(x.shape), tree)


def generate_episodes_chunked(env: WaveEnv, policy, generator: torch.Generator, episodes: int,
                              chunk: int = 8, run_chunk=None, on_episode=None):
    """Generate `episodes` episodes on the kernel path, `chunk` at a time:
    each chunk's resets and actions are drawn in turn from `generator`, its
    episodes run, and the chunk is copied to the CPU in one transfer.
    `on_episode(i, episode)` is called for each episode in order (e.g. to
    save it); without it the list of episodes is returned."""
    if run_chunk is None:
        run_chunk = make_episode_chunk_fused(env)
    out = []
    for start in range(0, episodes, chunk):
        k = min(chunk, episodes - start)
        states = [env_reset(env, generator) for _ in range(k)]
        actions = tree_stack([_draw_actions(env, policy, generator) for _ in range(k)])
        eps = _to_host(run_chunk(states, actions))
        for j in range(k):
            ep = tree_index(eps, j)
            if on_episode is not None:
                on_episode(start + j, ep)
            else:
                out.append(ep)
    return out


# ---------------------------------------------------------------------------
# Windowing and batching
# ---------------------------------------------------------------------------


def prepare_data(episode: Episode, horizon: int, stride: int = 1) -> dict:
    """Sliding windows of `horizon` actions over one episode (the JAX
    package's `prepare_data`): S = A - horizon + 1 samples of

      s_wave   (S, res, res, 4)
      s_design design tree (S, ...)
      a        action tree (S, horizon, ...)
      t        (S, horizon*T//stride + 1) joined window times
      y        (S, horizon*T//stride + 1, 3) joined signals

    `stride` keeps every stride-th point of the joined time grid."""
    A = len(episode)
    S = A - horizon + 1
    if S < 1:
        raise ValueError(f"horizon {horizon} > episode length {A}")
    T = episode.s_tspan.shape[-1] - 1
    if T % stride:
        raise ValueError(f"stride {stride} must divide window steps {T}")
    dev = episode.s_wave.device
    idx = torch.arange(S, device=dev)
    win = idx[:, None] + torch.arange(horizon, device=dev)[None, :]  # (S, horizon)
    t = flatten_repeated_last_dim(episode.s_tspan[win])
    y = flatten_repeated_last_dim(torch.movedim(episode.y[win], -1, 1))  # (S, 3, L)
    y = torch.movedim(y, 1, -1)
    if stride > 1:
        t, y = t[:, ::stride], y[:, ::stride]
    return {"s_wave": episode.s_wave[idx], "s_design": tree_index(episode.s_design, idx),
            "a": tree_map(lambda x: x[win], episode.a), "t": t, "y": y}


def concat_datasets(datasets: list[dict]) -> dict:
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *datasets)


def num_samples(data: dict) -> int:
    return data["s_wave"].shape[0]


def prepare_dataset(episodes: list[Episode], horizon: int, stride: int = 1) -> dict:
    """Window a list of episodes into one training dict: each episode's
    samples in turn, episode-major (what the JAX package's vmapped
    `prepare_data` flattened over (E, S) gives)."""
    return concat_datasets([prepare_data(ep, horizon, stride) for ep in episodes])


def dataloader(data: dict, batch_size: int, generator: torch.Generator, drop_last: bool = True):
    """Shuffled minibatches of a prepared dataset, each sample at most once
    an epoch (exactly once unless `drop_last` drops the ragged batch)."""
    n = num_samples(data)
    perm = torch.randperm(n, generator=generator, device=generator.device)
    perm = perm.to(data["s_wave"].device)
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(n_batches):
        idx = perm[b * batch_size:(b + 1) * batch_size]
        yield tree_map(lambda x: x[idx], data)


# ---------------------------------------------------------------------------
# Storage: bundles of named leaves with the JAX package's structure descriptor
# ---------------------------------------------------------------------------


_STRUCT_KEY = "__structure__"


def _named_with_structure(episode: Episode) -> dict:
    """{keystr path: float32 array} of the episode's leaves, plus the JSON
    structure descriptor as float32-encoded bytes (the native stores hold
    float32 only), as the JAX package writes them."""
    named = {k: v.detach().cpu().numpy() for k, v in tree_named_leaves(episode).items()}
    desc = json.dumps(encode_structure(episode)).encode()
    named[_STRUCT_KEY] = np.frombuffer(desc, dtype=np.uint8).astype(np.float32)
    return named


def _as_tensor(device):
    def convert(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t if device is None else t.to(device)

    return convert


def _decode(data, as_t) -> Episode:
    desc = json.loads(bytes(np.asarray(data[_STRUCT_KEY]).astype(np.uint8)).decode())
    return decode_structure(desc, lambda k: as_t(data[k]))


def _load_episode_cloak_fallback(data, as_t, path: str) -> Episode:
    """Files written before the structure descriptor held standard Cloak
    episodes; rebuild that structure."""
    from .designs import AdjustableRadiiScatterers, Cloak, Cylinders

    def cylinders(prefix):
        return Cylinders(pos=as_t(data[prefix + ".pos"]), r=as_t(data[prefix + ".r"]),
                         c=as_t(data[prefix + ".c"]))

    def cloak(prefix):
        return Cloak(config=AdjustableRadiiScatterers(cylinders(prefix + ".config.cylinders")),
                     core=cylinders(prefix + ".core"))

    try:
        return Episode(s_wave=as_t(data[".s_wave"]), s_design=cloak(".s_design"),
                       s_tspan=as_t(data[".s_tspan"]), a=cloak(".a"), y=as_t(data[".y"]))
    except KeyError as e:
        raise ValueError(f"{path} has no structure descriptor and is not a standard Cloak "
                         "episode; pass a `like=` template Episode") from e


def save_episode(episode: Episode, path: str) -> None:
    """Save an episode: `.wbin` through the native store
    (native/episode_store.cpp), any other name as compressed npz; both with
    the structure descriptor, as the JAX package saves them."""
    named = _named_with_structure(episode)
    if path.endswith(".wbin"):
        from .native import save_bundle

        save_bundle(path, named)
    else:
        np.savez_compressed(path, **named)


def load_episode(path: str, like: Episode | None = None, device="cuda") -> Episode:
    """Load an episode saved by either package. The structure descriptor
    rebuilds its design and action trees; `like` gives the structure
    instead (the only way for files with neither a descriptor nor the
    standard Cloak layout). Leaves go to `device`; None keeps them on the
    CPU."""
    if path.endswith(".wbin"):
        from .native import load_bundle

        data = load_bundle(path)
    else:
        data = np.load(path)
    as_t = _as_tensor(device)
    if like is not None:
        leaves = iter([as_t(data[k]) for k in tree_named_leaves(like)])
        return tree_map(lambda _: next(leaves), like)
    if _STRUCT_KEY not in data:
        return _load_episode_cloak_fallback(data, as_t, path)
    return _decode(data, as_t)


class EpisodeShard:
    """Incremental shard writer (native/dataset_shard.cpp): .append(episode)
    and .finish()."""

    def __init__(self, path: str):
        from .native import ShardWriter

        self._writer = ShardWriter(path)

    def append(self, episode: Episode) -> int:
        return self._writer.append(_named_with_structure(episode))

    def finish(self) -> None:
        self._writer.finish()


def open_episodes_shard(path: str) -> EpisodeShard:
    return EpisodeShard(path)


def save_episodes_shard(path: str, episodes: list[Episode]) -> None:
    """Stream a list of episodes into one shard file."""
    shard = open_episodes_shard(path)
    for ep in episodes:
        shard.append(ep)
    shard.finish()


def load_episodes_shard(path: str, device=None, limit: int | None = None) -> list[Episode]:
    """Episodes of a shard, in order; `limit` reads only the first ones.
    Leaves go to `device`; None (the default) keeps them on the CPU."""
    from .native import load_shard

    as_t = _as_tensor(device)
    return [_decode(data, as_t) for data in load_shard(path, limit=limit)]
