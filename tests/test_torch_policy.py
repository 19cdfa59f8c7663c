"""The one-shot policy path of the port against the JAX package's, on the
CPU:

* `design_with_vec` inverts `to_vec` for every design type, bit for bit,
  and gives JAX's trees on the same vectors; `tree_zeros_like`;
* `PolicyNet` at h 16 against flax's `PolicyNet` on the same random
  parameters (drawn in numpy), to 1e-5 relative: the convolutions and the
  MLP sum in other orders;
* the tracked behaviour-cloned weights (`models/bc_pools3`, h 256) through
  `policy_from_jax_params(expected=...)`, every leaf used once, and one
  128^2 observation's action against JAX's `AmortizedPolicy.action`, to
  1e-5 relative;
* a 2-action `make_policy_episode_fused` episode at n = 64 against JAX's
  pieces (`AmortizedPolicy.action`, XLA `env_step`): signals and final wave
  to 1e-5 relative, the bound the port's fused window is held to against
  the XLA window (tests/test_torch_fused.py), and the same actions to 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states

import waves_jl_tpu as w
from waves_jl_tpu.designs import design_with_vec as jax_design_with_vec
from waves_jl_tpu.env import env_observe as jax_env_observe
from waves_jl_tpu.env import env_step as jax_env_step
from waves_jl_tpu.models import AmortizedPolicy as JaxPolicy
from waves_jl_tpu.models import PolicyNet as JaxPolicyNet
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch.control.mpc import make_policy_episode_fused
from waves_jl_tpu_torch.models.convert import policy_from_jax_params
from waves_jl_tpu_torch.models.policy import AmortizedPolicy, PolicyNet
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.train.checkpoint import load_params, load_policy_checkpoint
from waves_jl_tpu_torch.utils.trees import tree_leaves, tree_map, tree_zeros_like

torch.set_num_threads(1)
TOL = 1e-5
BC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "models/bc_pools3/checkpoint_step=4500")


def designs():
    """One design of each type in both packages, from numpy draws."""
    rng = np.random.default_rng(1)
    pos, r, c = rng.normal(size=(5, 2)), rng.uniform(0.2, 1.0, 5), rng.uniform(300, 900, 5)
    core = (rng.normal(size=(1, 2)), np.array([2.0]), np.array([1032.0]))

    def build(mod, f):
        cyl = mod.Cylinders(f(pos), f(r), f(c))
        return [mod.NoDesign(), cyl, mod.AdjustableRadiiScatterers(cyl),
                mod.AdjustablePositionScatterers(cyl),
                mod.Cloak(mod.AdjustableRadiiScatterers(cyl), mod.Cylinders(*map(f, core)))]

    return (build(w, lambda x: jnp.asarray(x, jnp.float32)),
            build(td, lambda x: torch.from_numpy(np.asarray(x, np.float32))))


@pytest.mark.parametrize("kind", range(5))
def test_design_with_vec_inverts_to_vec_and_matches_jax(kind):
    jd, pd = (d[kind] for d in designs())
    if isinstance(pd, td.NoDesign):
        assert td.design_with_vec(pd, pd.to_vec()) is pd
        return
    back = td.design_with_vec(pd, pd.to_vec())
    assert type(back) is type(pd)
    for a, b in zip(tree_leaves(back), tree_leaves(pd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    v = np.random.default_rng(kind).normal(size=pd.to_vec().shape).astype(np.float32)
    got = td.design_with_vec(pd, torch.from_numpy(v))
    want = to_port(jax_design_with_vec(jd, jnp.asarray(v)))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got.to_vec(), torch.from_numpy(v), rtol=0, atol=0)


def test_tree_zeros_like():
    _, pd = designs()
    z = tree_zeros_like(pd[4])
    assert type(z) is td.Cloak
    for a, b in zip(tree_leaves(z), tree_leaves(pd[4])):
        assert a.shape == b.shape and a.dtype == b.dtype and not bool(a.any())


def numpy_params(net, obs, vec, seed: int):
    """Flax parameters of `net` drawn in numpy: kernels N(0, 1/fan_in),
    biases N(0, 0.01^2). (`init` gives only the shapes.)"""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = rng.standard_normal(leaf.shape) * 0.01
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                                                  obs, vec))


def observation(res: int, seed: int) -> np.ndarray:
    """(res, res, 4) smooth random observation, magnitudes as a window's."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    obs = np.zeros((res, res, 4), np.float32)
    for ch in range(4):
        cx, cy = rng.uniform(-0.5, 0.5, 2)
        obs[..., ch] = rng.uniform(0.2, 1.0) * np.exp(-((x[:, None] - cx) ** 2
                                                        + (x[None, :] - cy) ** 2) / 0.1)
    return obs


def test_policy_net_matches_flax():
    obs = np.stack([observation(16, s) for s in range(3)])
    vec = np.random.default_rng(5).uniform(-1, 1, (3, 18)).astype(np.float32)
    jnet = JaxPolicyNet(h_size=16, act_dim=18)
    params = numpy_params(jnet, jnp.asarray(obs), jnp.asarray(vec), seed=2)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(obs), jnp.asarray(vec)))
    net = PolicyNet(4, 18, 16, 18)
    net.load_state_dict(policy_from_jax_params(params, expected=net.state_dict()), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(obs), torch.from_numpy(vec)).numpy()
    assert got.shape == (3, 18) and float(np.abs(got).max()) < 1.0
    assert rel(got, want) <= TOL


def tracked_policies(je, pe):
    """The tracked behaviour-cloned policy in both packages."""
    flat = load_params(BC)
    params = {}
    for key, arr in flat.items():
        node = params
        *path, leaf = key.strip("[]'").split("']['")
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(arr)
    jpol = JaxPolicy.create(je.design_space, je.action_space, h_size=256)
    ppol = AmortizedPolicy.create(pe.design_space, pe.action_space, h_size=256, device="cpu")
    assert load_policy_checkpoint(ppol.net, BC) == 4500
    return jpol, params, ppol


def test_tracked_policy_action_matches_jax():
    je, pe = envs(140, 4, (128, 128))
    jpol, params, ppol = tracked_policies(je, pe)
    obs = observation(128, 7)
    js, ps = wave_states(je, pe, seed=4, time_step=0)
    ja = jax.jit(jpol.action)(params, jnp.asarray(obs), js.design)
    pa = ppol.action(torch.from_numpy(obs), ps.design)
    r_j, r_p = np.asarray(ja.config.cylinders.r), pa.config.cylinders.r.numpy()
    assert r_p.shape == (18,) and float(np.abs(r_p).max()) <= 0.25 + 1e-6
    assert float(np.abs(r_p).max()) > 0.0
    assert rel(r_p, r_j) <= TOL
    for a, b in zip(tree_leaves(pa), tree_leaves(to_port(ja))):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL * float(np.abs(r_j).max()))
    unit = ppol.unit_batch(torch.from_numpy(obs)[None], tree_map(lambda v: v[None], ps.design))
    torch.testing.assert_close(ppol.normalize_action(pa), unit[0].detach(), rtol=0, atol=2e-6)


def test_policy_episode_matches_jax_pieces():
    je, pe = envs(64, 8, (32, 32))
    jpol, params, ppol = tracked_policies(je, pe)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    act = jax.jit(jpol.action)
    jsignals, jactions = [], []
    for _ in range(je.actions):
        a = act(params, jax_env_observe(je, js).wave, js.design)
        js, _ = jax_env_step(je, js, a)
        jsignals.append(np.asarray(js.signal))
        jactions.append(np.asarray(a.config.cylinders.r))

    chosen = []
    action = ppol.action

    def recorded(obs, design):
        chosen.append(action(obs, design))
        return chosen[-1]

    object.__setattr__(ppol, "action", recorded)
    fk.reset_launch_counts()
    final, signals, costs = make_policy_episode_fused(pe, ppol)(ps)
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions
    assert signals.shape == (2, 9, 3) and final.time_step == 40 + 2 * 8
    assert costs.shape == (2,) and not bool(costs.any())
    assert float(signals[:, :, 2].max()) > 0.0
    assert rel(signals.numpy(), np.stack(jsignals)) <= TOL
    assert rel(np.stack([a.config.cylinders.r.numpy() for a in chosen]),
               np.stack(jactions)) <= TOL
    assert rel(final.wave.numpy(), np.asarray(js.wave)) <= TOL
