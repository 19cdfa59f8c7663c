"""The port's default fused env step against the JAX package's default.

`make_env_step_fused` takes `x_matmul=True` by default in both packages,
the bf16 split d/dx (K5 in the port, the Pallas kernel's MXU form in JAX,
here in interpret mode). Over two chained 20-step windows at 64^2 from the
same state and actions, the signal agrees to 1e-6 and the frames to 5e-7
relative. The port's exact step (`x_matmul=False`) is held against JAX's
exact one in tests/test_torch_fused.py.
"""
import jax
import numpy as np
import torch
from test_torch_fused import _envs, _port_cloak, rel, t

from waves_jl_tpu.env import RandomDesignPolicy as JaxPolicy
from waves_jl_tpu.env import env_reset as jax_env_reset
from waves_jl_tpu.physics.fused import make_env_step_fused as jax_make_env_step_fused
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import make_env_step_fused

torch.set_num_threads(1)


def test_default_env_step_matches_jax_default():
    je, pe = _envs()
    js = jax_env_reset(je, jax.random.PRNGKey(0))
    policy = JaxPolicy(je.action_space)
    jacts = [policy(jax.random.PRNGKey(k)) for k in (1, 2)]
    design = pe.design_space.low
    design = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        design.config.cylinders.pos, t(js.design.config.cylinders.r),
        design.config.cylinders.c)), design.core)
    ps = tenv.env_reset(pe, torch.Generator().manual_seed(0))
    src = ps.source
    src = tsrc.GaussianSource(src.grid, src.mu_low, src.mu_high, src.sigma, src.a,
                              t(js.source.shape), src.freq)
    ps = tenv.EnvState(ps.wave, design, src, ps.signal, 0)
    jstep = jax_make_env_step_fused(je, interpret=True)
    step = make_env_step_fused(pe)
    fk.reset_launch_counts()
    for ja in jacts:
        js, _ = jstep(js, ja)
        ps, _ = step(ps, _port_cloak(pe.design_space, ja))
        assert ps.time_step == int(js.time_step)
        assert rel(ps.signal.numpy(), np.asarray(js.signal)) <= 1e-6
        assert rel(ps.wave.numpy(), np.asarray(js.wave)) <= 5e-7
    assert float(np.abs(np.asarray(js.signal)[:, 2]).max()) > 0.0  # the wave met the cloak
    assert all(v == 0 for v in fk.launch_counts.values())  # the plain version, on the CPU
