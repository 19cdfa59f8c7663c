"""The checkpoint dashboards of `viz/` against the JAX package's on the
same inputs, on the CPU: what each dashboard draws (`acoustic_plot_data`,
  `node_plot_data`, `pinn_plot_data`, `latent_source_period`) against the
  values JAX's `make_plots_*` and `plot_latent_source` draw, at the JAX
  tests' widths, the JAX model holding the port's weights
  (`to_jax_params`): 1e-5
relative; and each `make_plots_*` writes its files (the latent video as a
GIF here, where there is no ffmpeg). `rollout_fields` and the drawing
functions are in tests/test_torch_viz_episode.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_env_full import rel
from test_torch_node import E as NODE_E
from test_torch_node import H_SIZE as NODE_H
from test_torch_node import L_SIZE, batches
from test_torch_node import NFREQ as NODE_NFREQ
from test_torch_node import STEPS as NODE_STEPS
from test_torch_node import port_space as node_space
from test_torch_node import to_jax
from test_torch_train_model import E, H_SIZE, NFREQ, STEPS, episodes, port_space

import waves_jl_tpu as w
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu.models import NODEEnergyModel as JaxNODE
from waves_jl_tpu.models import WaveControlPINN as JaxPINN
from waves_jl_tpu_torch import viz
from waves_jl_tpu_torch.data import prepare_data
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.convert import model_kind, to_jax_params
from waves_jl_tpu_torch.models.node import NODEEnergyModel
from waves_jl_tpu_torch.models.pinn import WaveControlPINN
from waves_jl_tpu_torch.utils.trees import tree_map

torch.set_num_threads(1)


def jax_params_of(pm, jm, bj):
    """JAX's parameter tree holding the port model's weights
    (`to_jax_params`), in the structure `jm.init` gives, traced only."""
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), bj)
    named = to_jax_params(pm.state_dict(), model_kind(pm))
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(named[jax.tree_util.keystr(p)]) for p, _ in paths])


@pytest.fixture(scope="module")
def acoustic():
    jm = JaxModel.create(design_space=w.build_triple_ring_design_space(), source_freq=1000.0,
                         elements=E, h_size=H_SIZE, nfreq=NFREQ, integration_steps=STEPS)
    pm = AcousticEnergyModel(port_space(), 1000.0, elements=E, h_size=H_SIZE, nfreq=NFREQ,
                             integration_steps=STEPS, seed=3, device="cpu")
    _, (episode,) = episodes(1, seed=2)
    bp = tree_map(lambda x: x[:2], prepare_data(episode, 2))
    bj = to_jax(bp)
    params = jax_params_of(pm, jm, bj)

    @jax.jit
    def run(p):
        _, (C, F, PML) = jm.get_parameters_and_initial_condition(p, bj)
        dt = jm.integrator.dt
        period = np.arange(0.0, 0.5 / jm.source_freq + dt, dt, dtype=np.float32)
        f = jnp.stack([F(jnp.full((1,), s))[0] for s in period], axis=0)
        return {"pml": PML[0], "force": F.shape[0], "y_hat": jm(p, bj),
                "latent": jm.generate_latent_solution(p, bj)[:, 0], "period_force": f}

    return pm, bp, jax.tree_util.tree_map(np.asarray, run(params))


def test_acoustic_dashboard_data_matches_jax(acoustic, tmp_path):
    pm, batch, want = acoustic
    got = viz.acoustic_plot_data(pm, batch, video=True)
    for k in ("pml", "force", "y_hat", "latent"):
        assert got[k].shape == want[k].shape and rel(got[k], want[k]) <= 1e-5, k
    np.testing.assert_array_equal(got["y"], batch["y"].numpy())
    src = viz.latent_source_period(pm, batch)
    assert rel(src["force"], want["period_force"]) <= 1e-5
    viz.make_plots_acoustic(pm, batch, str(tmp_path), samples=1)
    viz.plot_latent_source(pm, batch, str(tmp_path / "source.png"))
    names = {"pml.png", "force.png", "source.png", "tot1.png", "inc1.png", "sc1.png"}
    assert names <= set(os.listdir(tmp_path)) and "sc.gif" not in os.listdir(tmp_path)


@pytest.fixture(scope="module")
def windows():
    """The baselines' batch: an episode's horizon-1 windows."""
    return batches(horizon=1)


@pytest.mark.parametrize("kind", ["node", "pinn"])
def test_baseline_dashboard_data_matches_jax(kind, windows, tmp_path):
    bp, bj = windows
    kw = dict(elements=NODE_E, h_size=NODE_H, nfreq=NODE_NFREQ, integration_steps=NODE_STEPS)
    if kind == "node":
        jm = JaxNODE.create(design_space=w.build_triple_ring_design_space(), **kw)
        pm = NODEEnergyModel(node_space(), device="cpu", **kw)
    else:
        jm = JaxPINN.create(design_space=w.build_triple_ring_design_space(), source_freq=1000.0,
                            l_size=L_SIZE, **kw)
        pm = WaveControlPINN(node_space(), 1000.0, l_size=L_SIZE, device="cpu", **kw)
    params = jax_params_of(pm, jm, bj)

    @jax.jit
    def run(p):
        out = {"y_hat": jm(p, bj)}
        if kind == "pinn":
            _, f, pml, _ = jm.encode(p, bj)
            out.update(pml=pml[0], force=f[0], latent=jm.generate_latent_solution(p, bj)[0])
        return out

    want = jax.tree_util.tree_map(np.asarray, run(params))
    got = (viz.node_plot_data(pm, bp) if kind == "node"
           else viz.pinn_plot_data(pm, bp, video=True))
    for k in want:
        assert got[k].shape == want[k].shape and rel(got[k], want[k]) <= 1e-5, k
    if kind == "node":
        viz.make_plots_node(pm, bp, str(tmp_path), samples=2)
        assert {"sc1.png", "sc2.png"} == set(os.listdir(tmp_path))
    else:
        viz.make_plots_pinn(pm, bp, str(tmp_path), samples=1, video=True)
        assert {"pml.png", "force.png", "sc.gif", "tot1.png", "inc1.png",
                "sc1.png"} <= set(os.listdir(tmp_path))
