"""Four RK4 steps a launch with the 16-cell band, against the Pallas kernel.

The JAX package's probe of temporal blocking (scripts_tpu/kernel_probe.py:
98-102, tests/test_fused.py:204-240) runs `make_fused_acoustic_step(
steps_per_call=4, ghost=16)` in the radii-only split mode. The port's plain
decomposition of `rk4_steps_tiled<.., SPC=4>` (`fused_rk4_step_tiled_reference(
..., steps_per_call=4)`, a band of 16 cells a side) is held against it in
interpret mode within 2e-7 on the state and 1e-6 on the energies (4, 3),
the tolerances of tests/test_torch_tiled_step.py, and bit for bit against
four chained plain steps at the kernel's sub-step times.
"""
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_fused import rel
from test_torch_steps_per_call import ENERGY_TOL, STATE_TOL, T0, TF, TI, _inputs

import waves_jl_tpu as w
from waves_jl_tpu.ops.pallas_fd import (make_fused_acoustic_step, pad_state, padded_dims,
                                        unpad_state)
from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)


def test_band_step_matches_pallas_four_steps_a_call_with_ghost16():
    n, spc, ghost, tile = 48, 4, 16, 48
    cfg, u, shape, prof, cyl, owner = _inputs(n)
    pml = np.asarray(w.build_pml(w.two_dim(15.0, n), 2.0, 20000.0))
    step = make_fused_acoustic_step(
        n=n, spacing=cfg.spacing, dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=cyl.shape[1],
        x_min=cfg.x_min, tile_interior=tile, interpret=True, steps_per_call=spc,
        radii_only=True, x_matmul=True, ghost=ghost)
    px, py, _ = padded_dims(n, tile, ghost)
    p = jnp.asarray(pml[:, 0])
    prof_x = jnp.pad(p, (ghost, px - ghost - n), mode="edge")[:, None]
    prof_y = jnp.pad(p, (0, py - n), mode="edge")[None, :]
    uj, ej = step(u_pad=pad_state(jnp.asarray(u.numpy()), tile, ghost),
                  shape_pad=pad_state(jnp.asarray(shape.numpy())[None], tile, ghost)[0],
                  prof_x=prof_x, prof_y=prof_y,
                  scalars=jnp.asarray(np.array([T0, TI, TF, 0.0], np.float32)),
                  cyl=jnp.asarray(cyl.numpy()))
    uj, ej = np.asarray(unpad_state(uj, n, ghost)), np.asarray(ej)
    got, e = fk.fused_rk4_step_tiled_reference(u, shape, prof, owner, T0, TI, TF, cfg,
                                               steps_per_call=spc)
    assert ej.shape == tuple(e.shape) == (spc, 3)
    assert rel(got.numpy(), uj) <= STATE_TOL
    assert rel(e.numpy(), ej) <= ENERGY_TOL
    want, _ = fk.fused_rk4_step_reference(u, shape, prof, cyl, owner, T0, TI, TF, cfg,
                                          x_matmul=True, steps_per_call=spc)
    assert torch.equal(got, want)
