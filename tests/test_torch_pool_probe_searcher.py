"""The port's pool probe with a searcher (the DAgger harvest under CEM +
polish) against the JAX package's (`interpret=True`) on the CPU: env 32^2,
8 steps a window, horizon 2, the narrow surrogate of
tests/test_torch_hybrid_act.py with the same weights in both packages, a
`CEMShooting` searcher (16 shots, 4 elites, 2 rounds, 3 polish steps on the
top 2), K = 4 with 2 of them the searcher's cheapest. JAX's draws (the
searcher's round 0 and noise, then the uniform rest) are injected through
`CEMShooting.candidates`/`.noise` and `PoolProbe.candidates`. The polish
runs float32 gradients through the latent rollout, so the candidates,
`y_true` and `penalty` are held to its 1e-4 relative, and the advance
action, the searcher's choice, to 1e-4.
"""
import jax
import numpy as np
import torch
from test_torch_cem import ALPHA, ELITES, ITERS, POLISH, SHOTS, cem_draws, inject, jax_cem
from test_torch_cem import port_cem, tree_rel
from test_torch_hybrid import envs, rel, to_port, wave_states
from test_torch_hybrid_act import HORIZON, models

from waves_jl_tpu.control import make_pool_probe_fused as jax_make_pool_probe_fused
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu_torch.control.mpc import make_pool_probe_fused

torch.set_num_threads(1)
K, SAMPLES = 4, 2
TOL = 1e-4


def test_pool_probe_with_a_searcher_matches_jax():
    je, pe = envs(32, 8, (16, 16))
    jm, params, model = models(je, pe)
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    key = jax.random.PRNGKey(13)
    kw = dict(K=K, horizon=HORIZON, alpha=ALPHA, searcher_samples=SAMPLES)
    jprobe, _ = jax_make_pool_probe_fused(je, searcher=jax_cem(jm, **POLISH), interpret=True,
                                          **kw)
    jpool, ja = jprobe(params, js, key)

    k_cem, k_unif, _ = jax.random.split(key, 3)  # JAX's probe with a searcher
    unif = jax.jit(lambda k: jax_build_action_sequence(je.action_space, k, HORIZON,
                                                       K - SAMPLES))(k_unif)
    searcher = port_cem(model, **POLISH)
    inject(searcher, *cem_draws(je, k_cem, HORIZON, SHOTS, ELITES, ITERS))
    probe, _ = make_pool_probe_fused(pe, searcher=searcher, **kw)
    probe.candidates = lambda generator, n: to_port(unif)
    pool, pa = probe(ps, torch.Generator().manual_seed(0))

    assert pool["y_true"].shape == pool["penalty"].shape == (K,)
    assert tree_rel(pool["a"], jpool["a"]) <= TOL
    assert rel(pool["y_true"].numpy(), np.asarray(jpool["y_true"])) <= TOL
    assert rel(pool["penalty"].numpy(), np.asarray(jpool["penalty"])) <= TOL
    assert tree_rel(pa, ja) <= TOL
