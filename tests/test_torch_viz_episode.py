"""`viz/episode.py` and the drawing functions against the JAX package's:

- `rollout_fields` against JAX's on a 2-action episode at 48^2 with
  10-step windows, stride 5 and `render_size` 24, from the same state and
  actions, the policy state-aware (its explicit form; JAX's tries the
  state and falls back on a `TypeError`): times equal, u_tot frames and
  signals 1e-5 relative, each frame's design 1e-6;
- `render_episode` on a stateless random policy, `render_video`,
  `render_line_video`, `plot_energy`, `plot_field` and
  `plot_predicted_energy` write their files (a GIF for a video here, where
  there is no ffmpeg).
"""
import os

import jax
import numpy as np
import torch
from test_torch_env_full import envs, rel, starts

from waves_jl_tpu.viz.episode import rollout_fields as jax_rollout_fields
from waves_jl_tpu_torch import viz
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)


def test_rollout_fields_matches_jax(tmp_path):
    je, pe = envs()
    js, ps, jacts, pacts = starts(je, pe, seed=7)
    jit_acts = iter(jacts)
    jt, jframes, jdesigns, jsig = jax_rollout_fields(
        je, lambda k: next(jit_acts), jax.random.PRNGKey(0), field="tot", stride=5, state=js,
        render_size=24)
    port_acts = iter(pacts)
    seen = []

    def policy(generator, state):
        seen.append(state)
        return next(port_acts)

    times, frames, designs, signals = viz.rollout_fields(
        pe, policy, torch.Generator().manual_seed(0), field="tot", stride=5, state=ps,
        render_size=24, state_aware=True)
    assert len(seen) == 2 and seen[0] is ps and seen[1] is not None
    np.testing.assert_array_equal(times, np.asarray(jt))
    assert frames.shape == jframes.shape == (5, 24, 24)
    assert rel(frames, jframes) <= 1e-5 and rel(signals, jsig) <= 1e-5
    assert len(designs) == len(jdesigns) == 5
    for d, jd in zip(designs, jdesigns):
        for a, b in zip(tree_leaves(d), jax.tree_util.tree_leaves(jd)):
            assert rel(a.numpy(), b) <= 1e-6
    # the drawings
    gs = float(pe.dim.x[-1])
    extent = (-gs, gs, -gs, gs)
    out = viz.render_video(frames, extent, str(tmp_path / "f.mp4"), designs=designs, bound=0.2,
                           energy=True)
    assert out == str(tmp_path / "f.gif") and os.path.getsize(out) > 0
    viz.plot_field(frames[-1], extent, str(tmp_path / "field.png"), design=designs[-1])
    viz.plot_energy(np.arange(signals.shape[1]), signals[-1], str(tmp_path / "energy.png"))
    viz.plot_predicted_energy(times, frames[:, 0, 0], frames[:, 1, 1], "t", str(tmp_path / "p.png"))
    viz.render_line_video(np.arange(24), frames[:, 0], str(tmp_path / "line.mp4"))
    assert {"field.png", "energy.png", "p.png", "line.gif"} <= set(os.listdir(tmp_path))


def test_render_episode_writes_its_video(tmp_path):
    _, pe = envs()
    sig = viz.render_episode(pe, lambda g: pe.action_space.sample(g),
                             torch.Generator().manual_seed(1), str(tmp_path / "ep.mp4"),
                             field="tot", stride=5, render_size=24)
    assert sig.shape == (2, 11, 3) and np.isfinite(sig).all()
    assert os.path.getsize(tmp_path / "ep.gif") > 0
