"""K5, the port's `x_matmul` step, against the JAX kernel's default mode.

The plain version of the kernel with `x_matmul=True`
(`fused_rk4_step_reference`, d/dx through `ops/fd.py::dx_split_bf16`)
against the Pallas kernel in interpret mode with `x_matmul=True`, the mode
every fused path of the JAX package takes by default, at 48^2, radii-only
and general, one and two steps a call. Tolerance 2e-7 relative on the state
and 1e-6 on the energies (measured 5.7e-8 and 3.4e-7: the split products
are exact, so only sin, the one-sided rows' tap order and the energy sums
round apart). The exact step misses the same state tolerance (measured
8.8e-7), so a port that ignored the flag would fail here.

The port's default env step and re-rank rollout against JAX's defaults are
in tests/test_torch_xmatmul_env.py and tests/test_torch_xmatmul_rerank.py,
one JAX program a file. The CUDA kernel runs only on a card:
tests/test_torch_gpu.py holds it against this plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import _cyl, rel, t

import waves_jl_tpu as w
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch.ops import fd as tfd
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
STATE_TOL, ENERGY_TOL = 2e-7, 1e-6


def plain_steps(u, shape, prof, cyl, owner, t0, ti, tf, cfg, steps, x_matmul):
    """`steps` plain calls from t0 at the Pallas kernel's sub-step times
    (float32 t0 + k dt). Returns (u, energies (steps, 3))."""
    es = []
    for k in range(steps):
        t_k = float(np.float32(t0) + np.float32(k * cfg.dt))
        u, e = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, t_k, ti, tf, cfg,
                                           x_matmul=x_matmul)
        es.append(e)
    return u, torch.stack(es)


@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_plain_xmatmul_step_matches_pallas_default_mode(radii_only, steps_per_call):
    n = 48
    spacing = 2.0 * 15.0 / (n - 1)
    rng = np.random.default_rng(steps_per_call)
    u = (rng.standard_normal((12, n, n)) * 1e-3).astype(np.float32)
    grid = w.build_grid(w.two_dim(15.0, n))
    shape = np.asarray(w.build_normal(grid, jnp.array([[-3.0, 2.0]]), jnp.array([2.4]),
                                      jnp.array([1.0])))
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    cyl = _cyl(moving=not radii_only)
    scalars = np.array([2e-4, 0.0, 1e-3, 0.0], np.float32)  # mid-window lerp weight

    step = make_fused_acoustic_step(
        n=n, spacing=spacing, dt=1e-5, c0=1531.0, freq=1000.0, n_cyl=cyl.shape[1],
        x_min=-15.0, interpret=True, steps_per_call=steps_per_call, radii_only=radii_only,
        x_matmul=True)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u), 48),
                  shape_pad=pad_state(jnp.asarray(shape)[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars), cyl=jnp.asarray(cyl))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)

    cfg = fk.StepConfig(n=n, spacing=spacing, x_min=-15.0, dt=1e-5, c0=1531.0, freq=1000.0)
    owner = fk.select_owner_reference(t(cyl), cfg) if radii_only else None
    args = (t(u), t(shape), t(pml[:, 0]), t(cyl), owner, *map(float, scalars[:3]), cfg,
            steps_per_call)
    ut, et = plain_steps(*args, x_matmul=True)
    assert ut.shape == (12, n, n) and et.shape == (steps_per_call, 3)
    assert rel(ut.numpy(), uj) <= STATE_TOL
    assert rel(et.numpy(), ej) <= ENERGY_TOL
    exact, _ = plain_steps(*args, x_matmul=False)
    assert rel(exact.numpy(), uj) > STATE_TOL  # the flag changes the function


def test_split_derivative_is_the_stencil_of_the_bf16_parts():
    rng = np.random.default_rng(4)
    u = t(rng.standard_normal((3, 20, 9)))
    hi, lo = tfd.split_bf16(u)
    assert torch.equal(hi, u.to(torch.bfloat16).float())
    assert torch.equal(hi + lo, (u - hi).to(torch.bfloat16).float() + hi)
    assert float((u - hi - lo).abs().max() / u.abs().max()) < 2.0 ** -15
    got = tfd.dx_split_bf16(u, 0.5)
    want = (tfd.dx_edge_aware(hi, 1.0) + tfd.dx_edge_aware(lo, 1.0)) * 0.5
    assert torch.equal(got, want)
    assert rel(got.numpy(), tfd.dx_edge_aware(u, 0.5).numpy()) < 1e-4
