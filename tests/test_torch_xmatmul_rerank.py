"""The port's default re-rank rollout against the JAX package's default.

`make_rerank_rollout` takes `x_matmul=True` by default in both packages:
the port's candidate-batched step with the bf16 split d/dx (K5 batched,
through its plain version here) against JAX's batched Pallas kernel in
interpret mode, K = 4 candidates at 48^2, 8 steps a window over a horizon
of 2, from the same state and elite actions: the (K,) costs to 1e-5
relative.
"""
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_hybrid import envs, radii_actions, rel, wave_states

from waves_jl_tpu.physics.fused import make_rerank_rollout as jax_make_rerank_rollout
from waves_jl_tpu_torch.physics.fused import make_rerank_rollout

torch.set_num_threads(1)
K = 4


def test_default_rerank_rollout_matches_jax_default():
    n, steps, horizon = 48, 8, 2
    je, pe = envs(n, steps, (16, 16))
    js, ps = wave_states(je, pe, seed=3, time_step=40)
    scale = float(pe.action_space.high.config.cylinders.r[0])
    a = np.random.default_rng(5).uniform(-scale, scale, (K, horizon, 18)).astype(np.float32)
    t0 = np.float32(40) * np.float32(1e-5)
    want = np.asarray(jax_make_rerank_rollout(je, K, horizon, interpret=True)(
        js, radii_actions(a, True), jnp.float32(t0)))
    got = make_rerank_rollout(pe, horizon)(ps, radii_actions(a, False), t0)
    assert got.shape == (K,) and float(got.min()) > 0.0
    assert rel(got.numpy(), want) <= 1e-5
    exact = make_rerank_rollout(pe, horizon, x_matmul=False)(ps, radii_actions(a, False), t0)
    assert not torch.equal(exact, got)  # the default is the split form
