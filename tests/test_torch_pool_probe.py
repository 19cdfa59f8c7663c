"""The port's pool probe (`make_pool_probe_fused`) against the JAX
package's (`interpret=True`) on the CPU at small size, in one
configuration that takes every branch without a searcher: env 32^2 with
the exact scoring on a 16^2 `rerank_env` (the state projected by
`coarsen_env_state`), 8 steps a window, horizon 2, K = 4 uniform
candidates and 3 refined ones (a Gaussian fit to the 2 exactly cheapest),
JAX's draws injected through `PoolProbe.candidates` and `.noise`.
`y_true` and `penalty` within 1e-5 relative, the observation within 2e-5
absolute, the time and the uniform candidates equal to JAX's, and the same
advance action (positions: the two packages' triple rings differ in
their last bit). The searcher's branch is in
tests/test_torch_pool_probe_searcher.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_hybrid import envs, rel, to_port, wave_states

from waves_jl_tpu.control import make_pool_probe_fused as jax_make_pool_probe_fused
from waves_jl_tpu.control.mpc import _tree_normal as jax_tree_normal
from waves_jl_tpu.control.mpc import build_action_sequence as jax_build_action_sequence
from waves_jl_tpu_torch.control.mpc import make_pool_probe_fused
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
N, N_LO, STEPS, RES = 32, 16, 8, (16, 16)
HORIZON, K, REFINE, ELITES = 2, 4, 3, 2
TOL = 1e-5


def test_pool_probe_matches_jax():
    je, pe = envs(N, STEPS, RES)
    je_lo, pe_lo = envs(N_LO, STEPS, (8, 8))
    js, ps = wave_states(je, pe, seed=3, time_step=40, amplitude=1e-3)
    key = jax.random.PRNGKey(9)
    kw = dict(K=K, horizon=HORIZON, alpha=1.0, refine_samples=REFINE, refine_elites=ELITES)
    jprobe, _ = jax_make_pool_probe_fused(je, rerank_env=je_lo, interpret=True, **kw)
    jpool, ja = jprobe(js, key)

    @jax.jit
    def draws(k):  # JAX's probe without a searcher: split(k) -> (uniform, refine)
        k_unif, k_ref = jax.random.split(k)
        low = jax.tree_util.tree_map(lambda v: jnp.broadcast_to(v, (REFINE, HORIZON, *v.shape)),
                                     je.action_space.low)
        return (jax_build_action_sequence(je.action_space, k_unif, HORIZON, K),
                jax_tree_normal(k_ref, low))

    cands, noise = draws(key)
    probe, step = make_pool_probe_fused(pe, rerank_env=pe_lo, **kw)
    probe.candidates = lambda generator, n: to_port(cands)
    probe.noise = lambda generator, like: to_port(noise)
    fk.reset_launch_counts()
    pool, pa = probe(ps, torch.Generator().manual_seed(0))
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain versions

    assert set(pool) == set(jpool) == {"s_wave", "s_design", "t0", "a", "y_true", "penalty"}
    assert pool["y_true"].shape == pool["penalty"].shape == (K + REFINE,)
    assert float(pool["y_true"].min()) > 0.0
    assert rel(pool["y_true"].numpy(), np.asarray(jpool["y_true"])) <= TOL
    assert rel(pool["penalty"].numpy(), np.asarray(jpool["penalty"])) <= TOL
    np.testing.assert_allclose(pool["s_wave"].numpy(), np.asarray(jpool["s_wave"]), rtol=0,
                               atol=2e-5)
    assert float(pool["t0"]) == float(jpool["t0"]) and pool["t0"].dtype == torch.float32
    # the two packages' triple rings differ in the last bit of the positions
    for got, want in zip(tree_leaves(pool["s_design"]), jax.tree_util.tree_leaves(
            jpool["s_design"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # the candidates: the uniform draws as drawn, the refined ones to float32 rounding
    for got, want in zip(tree_leaves(pool["a"]), jax.tree_util.tree_leaves(jpool["a"])):
        assert got.shape == (K + REFINE, HORIZON, *want.shape[2:])
        np.testing.assert_array_equal(got[:K].numpy(), np.asarray(want)[:K])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    c = np.sort((pool["y_true"] + pool["penalty"]).numpy())
    assert c[1] - c[0] > 10 * TOL * np.abs(c).max()  # the advance action is decided
    np.testing.assert_allclose(pa.config.cylinders.r.numpy(), np.asarray(ja.config.cylinders.r),
                               rtol=1e-6, atol=1e-7)
