"""The hybrid controller's path in the port against the JAX package, on the
CPU at small size (the CUDA kernels take their plain versions here;
tests/test_torch_gpu.py holds them against those on the card).

* The plain candidate-batched step (K3's plain version) against the Pallas
  kernel built with `batch=3` in interpret mode with the exact f32 stencil
  (`x_matmul=False`), two port calls against one two-step Pallas call,
  radii-only and general, per-candidate cylinders: 1e-6 relative on state
  and energies (the same float32 operations in the same order; only sin and
  the energy sums round apart), as tests/test_torch_fused.py holds K1/K2.
* The plain batched step and owner pass equal K unbatched calls bit for bit.
* Batched `cyl_params` against `jax.vmap(cyl_params)` (radii exact, the
  rest to 1e-6 relative, as tests/test_torch_ops.py holds it unbatched),
  `DesignSpace` over a leading K, and the empty cylinder tensor's device.
* `coarsen_env_state` against JAX at 48 -> 24: 1e-6 relative on wave and
  source shape.

The re-rank rollout, the controller and the episode are held against JAX in
tests/test_torch_hybrid_{rerank,act,act_rounds,act_sequential,episode}.py,
one JAX program each (compiling a Pallas kernel in interpret mode takes
10-20 s), which import the helpers below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.control.mpc import coarsen_env_state as jax_coarsen_env_state
from waves_jl_tpu.env import EnvState as JaxEnvState
from waves_jl_tpu.env import make_wave_env as jax_make_wave_env
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import cyl_params as jax_cyl_params
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.control.mpc import coarsen_env_state
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.physics.fused import cyl_params

torch.set_num_threads(1)
K = 3


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def to_port(x):
    """The port's design tree for a JAX one (same classes, same fields)."""
    if dataclasses.is_dataclass(x):
        cls = getattr(td, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return t(x)


def batched_cyl(moving: bool) -> np.ndarray:
    """(K, 8, 4): three ring cylinders and the core, radii drawn in numpy
    per candidate; `moving` shifts each candidate's end positions."""
    rng = np.random.default_rng(7)
    pos = np.asarray(w.build_triple_ring_design_space().low.config.cylinders.pos)[[0, 6, 12]]
    pos = np.concatenate([pos, [[5.0, 0.0]]]).astype(np.float32)
    c = np.full(4, 3 * 344.0)
    out = []
    for b in range(K):
        r1 = np.r_[rng.uniform(0.6, 1.0, 3), 2.0]
        r2 = np.r_[rng.uniform(0.6, 1.0, 3), 2.0]
        pos2 = pos + (np.array([0.7 - 0.3 * b, -0.4 + 0.2 * b]) if moving else 0.0)
        out.append(np.stack([pos[:, 0], pos[:, 1], r1, c, pos2[:, 0], pos2[:, 1], r2, c]))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("radii_only", [True, False])
def test_plain_batched_step_matches_pallas_batched_kernel(radii_only):
    n = 40
    spacing = 2.0 * 15.0 / (n - 1)
    rng = np.random.default_rng(3)
    u = (rng.standard_normal((K, 12, n, n)) * 1e-3).astype(np.float32)
    grid = w.build_grid(w.two_dim(15.0, n))
    shape = np.asarray(w.build_normal(grid, jnp.array([[-3.0, 2.0]]), jnp.array([2.4]),
                                      jnp.array([1.0])))
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    cyl = batched_cyl(moving=not radii_only)
    scalars = np.array([2e-4, 0.0, 1e-3, 0.0], np.float32)

    step = make_fused_acoustic_step(
        n=n, spacing=spacing, dt=1e-5, c0=1531.0, freq=1000.0, n_cyl=cyl.shape[-1],
        x_min=-15.0, interpret=True, steps_per_call=2, radii_only=radii_only, x_matmul=False,
        batch=K)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    u_pad = jnp.stack([pad_state(jnp.asarray(x), 48) for x in u])
    uj, ej = step(u_pad=u_pad, shape_pad=pad_state(jnp.asarray(shape)[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars), cyl=jnp.asarray(cyl))
    uj = np.stack([np.asarray(unpad_state(x, n)) for x in uj])
    ej = np.asarray(ej)  # (K, 2, 3)

    cfg = fk.StepConfig(n=n, spacing=spacing, x_min=-15.0, dt=1e-5, c0=1531.0, freq=1000.0)
    owner = fk.select_owner_batched_reference(t(cyl), cfg) if radii_only else None
    if owner is not None:
        assert all(int((o[0] < o[1] ** 2).sum()) > 10 for o in owner)  # cylinders cover cells
    ut, es = t(u), []
    for k in range(2):  # the kernel's two sub-steps, at float32 t0 + k dt
        t_k = float(np.float32(scalars[0]) + np.float32(k * cfg.dt))
        ut, e = fk.fused_rk4_step_batched_reference(ut, t(shape), t(pml[:, 0]), t(cyl), owner,
                                                     t_k, float(scalars[1]), float(scalars[2]),
                                                     cfg)
        es.append(e)
    et = torch.stack(es, dim=1)
    assert ut.shape == (K, 12, n, n) and et.shape == (K, 2, 3)
    assert rel(ut.numpy(), uj) <= 1e-6
    assert rel(et.numpy(), ej) <= 1e-6


@pytest.mark.parametrize("radii_only", [True, False])
def test_plain_batched_step_equals_unbatched_steps(radii_only):
    n = 24
    cfg = fk.StepConfig(n=n, spacing=2.0 * 15.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                        freq=1000.0)
    rng = np.random.default_rng(4)
    u = t(rng.standard_normal((K, 12, n, n)) * 1e-3)
    shape, prof = t(rng.random((n, n))), t(rng.random(n) * 100.0)
    cyl = t(batched_cyl(moving=not radii_only))
    fk.reset_launch_counts()
    owner = fk.select_owner_batched(cyl, cfg) if radii_only else None
    if owner is not None:
        for b in range(K):
            torch.testing.assert_close(owner[b], fk.select_owner(cyl[b], cfg), rtol=0, atol=0)
    ub, eb = fk.fused_rk4_step_batched(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg)
    assert all(v == 0 for v in fk.launch_counts.values())  # the CPU takes the plain version
    for b in range(K):
        u1, e1 = fk.fused_rk4_step(u[b], shape, prof, cyl[b], None if owner is None else owner[b],
                                   2e-4, 0.0, 1e-3, cfg)
        torch.testing.assert_close(ub[b], u1, rtol=0, atol=0)
        torch.testing.assert_close(eb[b], e1, rtol=0, atol=0)


def test_batched_cyl_params_and_design_space_match_jax_vmap():
    jsp = w.build_triple_ring_design_space()
    psp = td.build_triple_ring_design_space(device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * K)
    jd = jax.vmap(jsp.sample)(keys[:K])
    ja = jax.vmap(w.build_action_space(jsp.low, 0.25).sample)(keys[K:])
    jnd = jax.vmap(jsp)(jd, ja)
    pnd = psp(to_port(jd), to_port(ja))  # broadcasts over the leading K
    assert pnd.config.cylinders.r.shape == (K, 18)
    np.testing.assert_array_equal(pnd.config.cylinders.r.numpy(),
                                  np.asarray(jnd.config.cylinders.r))
    want = np.asarray(jax.vmap(jax_cyl_params)(jd, jnd))
    got = cyl_params(to_port(jd), pnd, "cpu")
    assert got.shape == (K, 8, 19) == want.shape
    # positions: the two packages' triple rings differ in the last bit
    assert rel(got.numpy(), want) <= 1e-6
    np.testing.assert_array_equal(got[:, [2, 6]].numpy(), want[:, [2, 6]])
    # no design: an empty tensor on the device asked for
    empty = cyl_params(td.NoDesign(), td.NoDesign(), torch.device("meta"))
    assert empty.shape == (8, 0) and empty.device.type == "meta"


def envs(n, steps, res):
    """The same environment in both packages: triple ring, the Gaussian
    source's template shape, `steps` steps a window."""
    jdim = w.two_dim(15.0, n)
    jsrc = w.GaussianSource.create(w.build_grid(jdim), jnp.array([[-10.0, -10.0]]),
                                   jnp.array([[-10.0, 10.0]]), jnp.array([0.3]),
                                   jnp.array([1.0]), 1000.0)
    je = jax_make_wave_env(jdim, w.build_triple_ring_design_space(), jsrc, resolution=res,
                           integration_steps=steps, actions=2)
    pdim = tdims.two_dim(15.0, n, device="cpu")
    psrc = tsrc.GaussianSource.create(tdims.build_grid(pdim), [[-10.0, -10.0]],
                                      [[-10.0, 10.0]], [0.3], [1.0], 1000.0)
    pe = tenv.make_wave_env(pdim, td.build_triple_ring_design_space(device="cpu"), psrc,
                            resolution=res, integration_steps=steps, actions=2)
    return je, pe


def wave_states(je, pe, seed: int, time_step: int, amplitude: float = 1.0):
    """One state in both packages: a smooth wave whose total and incident
    fields differ around the cloak, ring radii drawn in numpy, the JAX
    template source's shape."""
    n = je.dim.shape[0]
    x = np.linspace(-15.0, 15.0, n, dtype=np.float32)
    rng = np.random.default_rng(seed)
    wave = np.zeros((3, 12, n, n), np.float32)
    for f in range(3):
        for ch, cx in ((0, 2.0), (6, -1.0), (1, 4.0), (7, 3.0)):
            cy = rng.uniform(-3.0, 3.0)
            wave[f, ch] = amplitude * (0.5 + 0.2 * f) * np.exp(-((x[:, None] - cx) ** 2
                                                    + (x[None, :] - cy) ** 2) / 8.0)
    r = rng.uniform(0.3, 0.9, 18).astype(np.float32)
    jlo = je.design_space.low
    jdesign = w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(
        jlo.config.cylinders.pos, jnp.asarray(r), jlo.config.cylinders.c)), jlo.core)
    js = JaxEnvState(wave=jnp.asarray(wave), design=jdesign, source=je.source,
                     signal=jnp.zeros((je.integration_steps + 1, 3), jnp.float32),
                     time_step=jnp.int32(time_step))
    plo = pe.design_space.low
    pdesign = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        plo.config.cylinders.pos, t(r), plo.config.cylinders.c)), plo.core)
    psource = dataclasses.replace(pe.source, shape=t(je.source.shape))
    ps = tenv.EnvState(wave=t(wave), design=pdesign, source=psource,
                       signal=torch.zeros((pe.integration_steps + 1, 3)), time_step=time_step)
    return js, ps


def radii_actions(a, jax_side: bool):
    """(S, H, 18) radius deltas as a Cloak action tree with zero elsewhere."""
    S, H, m = a.shape
    if jax_side:
        z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
        return w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(z(S, H, m, 2), jnp.asarray(a),
                                                               z(S, H, m))),
                       w.Cylinders(z(S, H, 1, 2), z(S, H, 1), z(S, H, 1)))
    z = torch.zeros
    return td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(z(S, H, m, 2), t(a), z(S, H, m))),
                    td.Cylinders(z(S, H, 1, 2), z(S, H, 1), z(S, H, 1)))


def test_coarsen_env_state_matches_jax():
    je, pe = envs(48, 8, (16, 16))
    je_lo, pe_lo = envs(24, 8, (16, 16))
    js, ps = wave_states(je, pe, seed=0, time_step=30)
    jl = jax_coarsen_env_state(je_lo, js)
    pl = coarsen_env_state(pe_lo, ps)
    assert pl.wave.shape == (3, 12, 24, 24) and pl.source.shape.shape == (24, 24)
    assert rel(pl.wave.numpy(), np.asarray(jl.wave)) <= 1e-6
    assert rel(pl.source.shape.numpy(), np.asarray(jl.source.shape)) <= 1e-6
    assert pl.time_step == 30 and pl.design is ps.design
