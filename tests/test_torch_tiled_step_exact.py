"""The one-launch step's tile decomposition with the exact d/dx, on the CPU.

`rk4_step_tiled` (csrc/fused_rk4.cu) runs the radii-only step in one launch
in both d/dx forms: K5's bf16 split (tests/test_torch_tiled_step.py) and
the exact stencil of K2 and K3 (`x_matmul=False`), held here.
`fused_rk4_step_tiled_reference(..., x_matmul=False)` decomposes the step
as the kernel does, in plain PyTorch with the exact `dx_edge_aware`; it is
held:

* against the whole-grid plain step `fused_rk4_step_reference(...,
  x_matmul=False)`, bit for bit on the state over two chained steps, at
  n = 45 and 48 with the kernel's 16 x 24 tiles and with tiles that leave
  partial and one-cell tiles on the domain's edges; energies within 1e-6
  (the tiles' partial sums add in another order);
* for each of K = 3 candidates against the batched plain step
  `fused_rk4_step_batched_reference(..., x_matmul=False)`, bit for bit;
* against the Pallas kernel in interpret mode with `x_matmul=False,
  radii_only=True`, two steps a call, within 1e-6 relative on the state
  and the energies, the tolerance of tests/test_torch_fused.py for the
  exact mode.

The stencil's reach is the split form's (+-1 central, 2 inward at the
domain's edge), so the same halo serves both; a d/dx taken in the wrong
form shows here as differing cells. The CUDA kernel runs only on a card:
tests/test_torch_gpu.py holds it against the plain version there, bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import rel
from test_torch_tiled_step import CASES, T0, TF, TI, _inputs

import waves_jl_tpu as w
from waves_jl_tpu.ops.pallas_fd import make_fused_acoustic_step, pad_state, unpad_state
from waves_jl_tpu.physics.fused import pad_profiles
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
TOL = 1e-6  # against Pallas interpret, state and energies (tests/test_torch_fused.py)
ENERGY_TOL = 1e-6


def _tiled(u, shape, prof, owner, t0, cfg, tile):
    return fk.fused_rk4_step_tiled_reference(u, shape, prof, owner, t0, TI, TF, cfg, tile,
                                             x_matmul=False)


@pytest.mark.parametrize("n,tile", CASES)
def test_exact_tiled_step_equals_whole_grid_plain_step(n, tile):
    cfg, u, shape, prof, cyl, owner = _inputs(n)
    got, want = (u, None), (u, None)
    for t0 in (T0, T0 + cfg.dt):  # two chained steps
        got = _tiled(got[0], shape, prof, owner, t0, cfg, tile)
        want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, owner, t0, TI, TF, cfg,
                                           x_matmul=False)
    assert got[0].shape == (12, n, n) and got[1].shape == (3,)
    assert torch.equal(got[0], want[0])
    assert rel(got[1].numpy(), want[1].numpy()) <= ENERGY_TOL


@pytest.mark.parametrize("n,tile", [(45, fk.TILE), (48, (13, 10))])
def test_exact_tiled_step_of_each_candidate_equals_batched_plain_step(n, tile):
    k = 3
    cfg, u, shape, prof, cyl, owner = _inputs(n, k)
    want = fk.fused_rk4_step_batched_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                               x_matmul=False)
    got = [_tiled(u[b], shape, prof, owner[b], T0, cfg, tile) for b in range(k)]
    assert not torch.equal(want[0][0], want[0][1])  # the candidates differ
    for b in range(k):
        assert torch.equal(got[b][0], want[0][b])
        assert rel(got[b][1].numpy(), want[1][b].numpy()) <= ENERGY_TOL


def test_tiled_step_takes_the_d_dx_form_it_is_given():
    cfg, u, shape, prof, cyl, owner = _inputs(45)
    exact = _tiled(u, shape, prof, owner, T0, cfg, fk.TILE)[0]
    split = fk.fused_rk4_step_tiled_reference(u, shape, prof, owner, T0, TI, TF, cfg)[0]
    assert torch.equal(split, fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, T0, TI, TF,
                                                          cfg, x_matmul=True)[0])
    assert not torch.equal(exact, split)  # the default is the split form, not the exact one
    assert rel(exact.numpy(), split.numpy()) <= 1e-3  # near it, as the two stencils are


def test_exact_tiled_step_matches_pallas_exact_mode():
    n, tile, steps = 48, (13, 10), 2
    cfg, u, shape, prof, cyl, owner = _inputs(n)
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    scalars = np.array([T0, TI, TF, 0.0], np.float32)
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, interpret=True, steps_per_call=steps, radii_only=True, x_matmul=False)
    prof_x, prof_y = pad_profiles(jnp.asarray(pml), n, 48)
    uj, ej = step(u_pad=pad_state(jnp.asarray(u.numpy()), 48),
                  shape_pad=pad_state(jnp.asarray(shape.numpy())[None], 48)[0],
                  prof_x=prof_x, prof_y=prof_y, scalars=jnp.asarray(scalars),
                  cyl=jnp.asarray(cyl.numpy()))
    uj, ej = np.asarray(unpad_state(uj, n)), np.asarray(ej)

    got, es = u, []
    for k in range(steps):  # the Pallas kernel's sub-step times, float32 t0 + k dt
        t_k = float(np.float32(T0) + np.float32(k * cfg.dt))
        got, e = _tiled(got, shape, prof, owner, t_k, cfg, tile)
        es.append(e)
    assert rel(got.numpy(), uj) <= TOL
    assert rel(torch.stack(es).numpy(), ej) <= TOL
