"""Candidate pools across the two packages, and the pool metrics, on the CPU:

* pools written by the JAX package's `scripts_tpu/datagen_pools.py::
  save_pools` are read by the port's `load_pools` bit for bit, and the
  port's `save_pools` writes the same arrays under the same names, which
  the JAX script's `load_pools` reads back bit for bit (16 synthetic pools
  of 5 candidates over horizon 2, drawn in numpy);
* `scripts.train_pools.predict_pools` (the surrogate's cumulative
  scattered energy of each pool's candidates) against JAX's
  `predict_shot_energy` on the narrow surrogate of
  tests/test_torch_hybrid_act.py with the same weights: within 1e-5
  relative;
* `scripts.train_pools.pool_metrics` (z-MSE, Spearman, top-1, regret over
  the live pools, whole batches of 8) against the JAX script's, both given
  a stand-in surrogate whose energies are a closed form of the actions and
  the design (so both packages' predictions agree to float32 rounding and
  spread across each pool): within 1e-5, the same live and total counts.
  A trained surrogate's predictions spread by about 1e-3 of their size
  across a pool, so z-scores would magnify the packages' 1e-7 difference
  in them past 1e-5; the predictions are held above instead.

The JAX scripts are loaded from their files with the persistent
compilation cache they enable switched off.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hybrid import envs, rel, to_port
from test_torch_hybrid_act import models

import waves_jl_tpu as w
import waves_jl_tpu.utils.cache
from waves_jl_tpu_torch.scripts.datagen_pools import load_pools, save_pools
from waves_jl_tpu_torch.scripts.train_pools import pool_metrics, predict_pools
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, K, H, M = 16, 5, 2, 18


def jax_script(name: str):
    """scripts_tpu/<name>.py as a module, with its compilation cache off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(waves_jl_tpu.utils.cache, "enable_persistent_cache", lambda *a, **k: False)
        mp.syspath_prepend(os.path.join(ROOT, "scripts_tpu"))
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(ROOT, "scripts_tpu", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module


def jax_pools(je, seed: int = 0) -> list:
    """P single-state pools as the JAX probe returns them, drawn in numpy:
    observations, radii inside the box, radius-delta actions, energies
    (every fourth pool without a signal: its candidates equal)."""
    rng = np.random.default_rng(seed)
    lo = je.design_space.low
    pools = []
    for p in range(P):
        r = rng.uniform(0.3, 0.9, M).astype(np.float32)
        da = rng.uniform(-0.2, 0.2, (K, H, M)).astype(np.float32)
        z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
        # near the stand-in surrogate's energies below, so its ranking is
        # right in some pools and wrong in others
        near = (da ** 2 * (1.0 + r)).sum((1, 2)) + rng.uniform(0.0, 0.1, K)
        y = (np.full(K, 3.0) if p % 4 == 3 else near).astype(np.float32)
        pools.append({
            "s_wave": jnp.asarray(rng.standard_normal((16, 16, 4)), jnp.float32) * 0.1,
            "s_design": w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(
                lo.config.cylinders.pos, jnp.asarray(r), lo.config.cylinders.c)), lo.core),
            "t0": jnp.float32(p * 8) * jnp.float32(1e-5),
            "a": w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(z(K, H, M, 2), jnp.asarray(da),
                                                                 z(K, H, M))),
                         w.Cylinders(z(K, H, 1, 2), z(K, H, 1), z(K, H, 1))),
            "y_true": jnp.asarray(y),
            "penalty": jnp.asarray(np.sqrt((da ** 2).sum(-1)).sum(-1), jnp.float32),
        })
    return [jax.device_get(pool) for pool in pools]


@pytest.fixture(scope="module")
def setup():
    je, pe = envs(32, 8, (16, 16))
    return je, pe, jax_pools(je)


def port_pool(pool: dict) -> dict:
    return {k: to_port(v) for k, v in pool.items()}


def test_pools_cross_the_packages_bit_for_bit(setup, tmp_path):
    je, pe, pools = setup
    jdp = jax_script("datagen_pools")
    jax_path, port_path = str(tmp_path / "pools_jax.npz"), str(tmp_path / "pools_port.npz")
    jdp.save_pools(jax_path, pools)
    save_pools(port_path, [port_pool(p) for p in pools])
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])

    got = load_pools(jax_path, pe)
    want = jdp.load_pools(port_path, je)
    assert got["y_true"].shape == (P, K) and got["a"].config.cylinders.r.shape == (P, K, H, M)
    for name in ("s_wave", "t0", "y_true", "penalty"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    for prefix in ("s_design", "a"):
        leaves = tree_leaves(got[prefix])
        assert len(leaves) == len(jax.tree_util.tree_leaves(want[prefix]))
        for x, y in zip(leaves, jax.tree_util.tree_leaves(want[prefix])):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


class JaxStandIn:
    """A surrogate for `pool_metrics` in the JAX package: energies sum
    a_r^2 (1 + design r) over the horizon and the ring, plus the
    observation's mean."""

    integrator = type("Integrator", (), {"dt": 4e-5})()
    integration_steps = 2

    def predict_shot_energy(self, params, s_wave, s_design, a, t):
        r = a.config.cylinders.r  # (K, H, M)
        return (jnp.sum(r * r * (1.0 + s_design.config.cylinders.r), axis=(1, 2))
                + jnp.mean(s_wave) + 0.0 * t[:, -1])


class PortStandIn(torch.nn.Module):
    """`JaxStandIn` in the port."""

    integrator = JaxStandIn.integrator
    integration_steps = 2

    def __init__(self):
        super().__init__()
        self.unused = torch.nn.Parameter(torch.zeros(1))

    def predict_shot_energy(self, s_wave, s_design, a, t):
        r = a.config.cylinders.r
        return (torch.sum(r * r * (1.0 + s_design.config.cylinders.r), dim=(1, 2))
                + torch.mean(s_wave) + 0.0 * t[:, -1])


def test_pool_predictions_and_metrics_match_jax(setup, tmp_path):
    je, pe, pools = setup
    jdp, jtp = jax_script("datagen_pools"), jax_script("train_pools")
    path = str(tmp_path / "pools1.npz")
    jdp.save_pools(path, pools)
    jp, pp = jdp.load_pools(path, je), load_pools(path, pe)

    jm, params, model = models(je, pe)
    L = H * jm.integration_steps + 1
    tgrid = jnp.arange(L, dtype=jnp.float32) * jnp.float32(jm.integrator.dt)

    @jax.jit
    def predict(pb):
        def one(s_wave, s_design, t0, a):
            t = jnp.broadcast_to((t0 + tgrid)[None], (K, L))
            return jm.predict_shot_energy(params, s_wave, s_design, a, t)

        return jax.vmap(one)(pb["s_wave"], pb["s_design"], pb["t0"], pb["a"])

    got = predict_pools(model, pp)
    assert got.shape == (P, K)
    assert rel(got, np.asarray(predict(jp))) <= 1e-5

    want = jtp.pool_metrics(JaxStandIn(), None, jp)
    got = pool_metrics(PortStandIn(), pp)
    assert set(got) == set(want)
    assert got["live_pools"] == want["live_pools"] == 12 and got["total_pools"] == 16
    assert 0.0 < got["top1"] < 1.0 and got["regret"] > 0.0  # the stand-in ranks imperfectly
    for k in ("pool_zmse", "spearman", "top1", "regret"):
        assert np.isfinite(got[k]) and rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])
