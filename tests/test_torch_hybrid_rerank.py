"""The port's candidate-batched re-rank rollout (`make_rerank_rollout`,
through K3's plain version here, `x_matmul=False`) against the JAX
package's (`interpret=True, x_matmul=False`) on the same state and elite
actions, at
16^2 with 8 steps a window over a horizon of 2: (K,) costs to 1e-5
relative, the bound tests/test_windows_and_cem.py holds the JAX package's
batched re-rank to against its sequential one. The port's sequential
re-rank (K rollouts in turn through the env window) gives the same costs
as its batched one to 1e-5, both at the default `x_matmul=True`. The
defaults against JAX's are in tests/test_torch_xmatmul_rerank.py.
"""
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_hybrid import K, envs, radii_actions, rel, wave_states

from waves_jl_tpu.physics.fused import make_rerank_rollout as jax_make_rerank_rollout
from waves_jl_tpu_torch.control.mpc import HybridShooting
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import make_rerank_rollout

torch.set_num_threads(1)


def test_rerank_rollout_matches_jax_and_the_sequential_rerank():
    n, steps, horizon = 16, 8, 2
    je, pe = envs(n, steps, (8, 8))
    js, ps = wave_states(je, pe, seed=1, time_step=40)
    scale = float(pe.action_space.high.config.cylinders.r[0])
    a = np.random.default_rng(2).uniform(-scale, scale, (K, horizon, 18)).astype(np.float32)
    t0 = np.float32(40) * np.float32(1e-5)

    jroll = jax_make_rerank_rollout(je, K, horizon, interpret=True, x_matmul=False)
    want = np.asarray(jroll(js, radii_actions(a, True), jnp.float32(t0)))
    fk.reset_launch_counts()
    got = make_rerank_rollout(pe, horizon, x_matmul=False)(ps, radii_actions(a, False), t0)
    assert all(v == 0 for v in fk.launch_counts.values())
    assert got.shape == (K,) and float(got.min()) > 0.0
    assert rel(got.numpy(), want) <= 1e-5

    got = make_rerank_rollout(pe, horizon)(ps, radii_actions(a, False), t0)

    class Sequential(HybridShooting):
        def __init__(self):
            super().__init__(pe, model=None, horizon=horizon, topk=K, batched=False)

    seq = Sequential().exact_eval(ps, radii_actions(a, False), t0)
    assert rel(seq.numpy(), got.numpy()) <= 1e-5
