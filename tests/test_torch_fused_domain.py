"""The port's y-sharded fused rollout (`parallel/fused_domain.py`; on CPU
tensors each shard steps through the kernel K4's plain version) in the
general mode, moving cylinders:

* against the JAX package's `make_fused_sharded_rollout(..., interpret=True,
  x_matmul=False)` on a 4-device virtual CPU mesh, N = 64, 4 shards, 4
  steps: signal and final state to 1e-6 relative (the same float32
  operations in the same order; only sin and the energy sums round apart);
* at 1, 2 and 4 shards, against the port's own single-device
  `make_fused_window(x_matmul=False)`, the exact d/dx the sharded rollout
  takes, on the same inputs: the final state to 1e-7 relative
  (expected equal: every owned cell takes the whole-grid arithmetic), the
  signal to 1e-6 (its sums run in another order).

The radii-only mode is in tests/test_torch_fused_domain_radii.py and the
split d/dx (`x_matmul=True`, K4-XM) in
tests/test_torch_fused_domain_xmatmul.py, which import the helpers below.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waves_jl_tpu.parallel import make_mesh as jax_make_mesh
from waves_jl_tpu.parallel.fused_domain import make_fused_sharded_rollout as jax_rollout
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch import dims as tdims
from waves_jl_tpu_torch import env as tenv
from waves_jl_tpu_torch import sources as tsrc
from waves_jl_tpu_torch.parallel import make_fused_sharded_rollout, make_mesh
from waves_jl_tpu_torch.physics.dynamics import build_tspan
from waves_jl_tpu_torch.physics.fused import make_fused_window, radii_only_ok, step_config

torch.set_num_threads(1)
N, SHARDS, STEPS = 64, 4, 4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def case(radii_only: bool):
    """A port env at N = 64 whose design space takes the requested mode
    (the triple ring, or its cylinders free to move), and numpy inputs: a
    random state, the env's source shape and profile, window times from
    2e-4 and cylinders (8, 19) at the ring's positions with drawn radii,
    moving by (0.3, -0.2) in the general mode."""
    dim = tdims.two_dim(15.0, N, device="cpu")
    src = tsrc.GaussianSource.create(tdims.build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]],
                                     [0.3], [1.0], 1000.0)
    ring = td.build_triple_ring_design_space(device="cpu")
    cy = td.design_cylinders(ring.low)
    space = ring
    if not radii_only:
        r = torch.full_like(cy.r, 0.5)
        space = td.DesignSpace(td.AdjustablePositionScatterers(td.Cylinders(cy.pos - 0.5, r, cy.c)),
                               td.AdjustablePositionScatterers(td.Cylinders(cy.pos + 0.5, r, cy.c)))
    env = tenv.make_wave_env(dim, space, src, resolution=(16, 16), integration_steps=STEPS,
                             actions=1)
    assert radii_only_ok(env.design_space) == radii_only
    rng = np.random.default_rng(6)
    pos = cy.pos.numpy()
    m = pos.shape[0]
    r1, r2 = rng.uniform(0.2, 1.0, m), rng.uniform(0.2, 1.0, m)
    r1[-1] = r2[-1] = 2.0  # the core
    c = cy.c.numpy()
    pos2 = pos + (0.0 if radii_only else np.array([0.3, -0.2]))
    cyl = np.stack([pos[:, 0], pos[:, 1], r1, c, pos2[:, 0], pos2[:, 1], r2, c]).astype(np.float32)
    u0 = (rng.standard_normal((12, N, N)) * 1e-3).astype(np.float32)
    tspan = np.float32(2e-4) + build_tspan(0.0, env.dt, STEPS)
    inputs = dict(u0=u0, tspan=tspan, cyl=cyl, shape=src.shape.numpy(),
                  prof=env.integrator.dynamics.pml[:, 0].contiguous().numpy())
    return env, inputs


def port_rollout(env, inputs, shards: int, radii_only: bool, x_matmul: bool = False):
    cfg = step_config(env)
    roll = make_fused_sharded_rollout(make_mesh(devices=["cpu"] * shards), N, cfg.spacing,
                                      cfg.dt, cfg.c0, cfg.freq, inputs["cyl"].shape[1],
                                      cfg.x_min, radii_only=radii_only, x_matmul=x_matmul)
    u, sig = roll(*(torch.from_numpy(inputs[k]) if k != "tspan" else inputs[k]
                    for k in ("u0", "tspan", "cyl", "shape", "prof")))
    return u.numpy(), sig.numpy()


def check_against_jax(radii_only: bool, x_matmul: bool = False) -> tuple[float, float]:
    """The port's rollout against JAX's; returns the (state, signal)
    relative errors."""
    env, inputs = case(radii_only)
    cfg = step_config(env)
    roll = jax_rollout(jax_make_mesh(SHARDS, axis_name="space"), n=N, spacing=cfg.spacing,
                       dt=cfg.dt, c0=cfg.c0, freq=cfg.freq, n_cyl=inputs["cyl"].shape[1],
                       x_min=cfg.x_min, axis_name="space", interpret=True,
                       radii_only=radii_only, x_matmul=x_matmul)
    uj, sj = roll(*(jnp.asarray(inputs[k]) for k in ("u0", "tspan", "cyl", "shape", "prof")))
    up, sp = port_rollout(env, inputs, SHARDS, radii_only, x_matmul)
    assert up.shape == (12, N, N) and sp.shape == (STEPS + 1, 3)
    assert float(np.abs(sp[:, 2]).max()) > 0.0
    errs = rel(up, np.asarray(uj)), rel(sp, np.asarray(sj))
    assert errs[1] <= 1e-6
    assert errs[0] <= 1e-6
    return errs


def check_against_window(radii_only: bool, shards: int, x_matmul: bool = False):
    env, inputs = case(radii_only)
    up, sp = port_rollout(env, inputs, shards, radii_only, x_matmul)
    t = {k: torch.from_numpy(v) for k, v in inputs.items() if k != "tspan"}
    uw, _, sw = make_fused_window(env, x_matmul=x_matmul)(t["u0"], t["shape"], inputs["tspan"],
                                                          t["cyl"])
    d_omega = step_config(env).spacing ** 2
    assert rel(up, uw.numpy()) <= 1e-7
    assert rel(sp * d_omega, sw.numpy()) <= 1e-6


def test_sharded_rollout_matches_jax():
    check_against_jax(radii_only=False)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_rollout_matches_single_device_window(shards):
    check_against_window(radii_only=False, shards=shards)
