"""The PINN baseline (`models/pinn.py`) against the JAX package's, on the
CPU at the sizes of tests/test_baseline_models.py (elements 64, h_size 8,
nfreq 8, l_size 8, 10 steps a window), on windows of an episode from the
port's own datagen and JAX's initial parameters carried across by
`from_jax_params`; one jitted JAX program gives every JAX value:

- `Compressor` alone on numpy inputs (its even-kernel "SAME" padding, 0
  on the left and 1 on the right, and its 1-D kernels' layout): 1e-5
  relative; `PINNFieldNet` alone: 1e-5;
- `build_pinn_grid`: the t axis exactly; the x axis to 1.2e-7 absolute
  (XLA's vectorised `jnp.linspace` rounds some points one FMA apart from
  its scalar form, and no single float32 formula reproduces both);
- `forward` (B, L, 3) and `generate_latent_solution` (B, L, 4, E) at
  horizon 2: 1e-5 relative;
- `predict_energy` at `time_chunk` None, 4 and 7 against JAX's forward, to
  the JAX test's own 2e-5 relative and 2e-6 absolute;
- `WaveControlPINNLoss` at horizon 1: 1e-5 relative; its gradient 1e-4
  relative to each leaf's largest magnitude against `jax.grad`; at horizon
  2 it fails with JAX's message.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_node import (E, H_SIZE, L_SIZE, NFREQ, STEPS, assert_grads_close, batches,
                             port_grads, port_space, rel)

import waves_jl_tpu as w
from waves_jl_tpu.models import WaveControlPINN as JaxPINN
from waves_jl_tpu.models import WaveControlPINNLoss as JaxPINNLoss
from waves_jl_tpu.models.pinn import build_pinn_grid as jax_build_pinn_grid
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.models.pinn import (WaveControlPINN, WaveControlPINNLoss,
                                            build_pinn_grid)

torch.set_num_threads(1)
KIND = "WaveControlPINN"


@pytest.fixture(scope="module")
def setup():
    bp1, bj1 = batches(horizon=1)
    bp2, bj2 = batches(horizon=2)
    jm = JaxPINN.create(design_space=w.build_triple_ring_design_space(), source_freq=1000.0,
                        elements=E, h_size=H_SIZE, nfreq=NFREQ, l_size=L_SIZE,
                        integration_steps=STEPS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), bj1)
    pm = WaveControlPINN(port_space(), 1000.0, elements=E, h_size=H_SIZE, nfreq=NFREQ,
                         l_size=L_SIZE, integration_steps=STEPS, device="cpu")
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict(), kind=KIND))
    rng = np.random.default_rng(0)
    x_comp = rng.standard_normal((2, E, 8)).astype(np.float32)
    x_field = rng.standard_normal((3, 5, L_SIZE + 2)).astype(np.float32)
    loss_fn = JaxPINNLoss(model=jm, c0=float(w.WATER))

    @jax.jit
    def run(p):
        lj, gj = jax.value_and_grad(lambda q: loss_fn(q, bj1))(p)
        return {"compressor": jm.compressor.apply(p["compressor"], x_comp),
                "field_net": jm.field_net.apply(p["field_net"], x_field),
                "forward": jm(p, bj2), "sol": jm.generate_latent_solution(p, bj2),
                "loss": lj, "grads": gj}

    want = run(params)
    return pm, bp1, bp2, x_comp, x_field, want


def test_compressor_and_field_net_alone_match_jax(setup):
    pm, _, _, x_comp, x_field, want = setup
    with torch.no_grad():
        comp = pm.compressor(torch.from_numpy(x_comp)).numpy()
        field = pm.field_net(torch.from_numpy(x_field)).numpy()
    assert comp.shape == (2, L_SIZE) and field.shape == (3, 5, 4)
    assert rel(comp, want["compressor"]) <= 1e-5
    assert rel(field, want["field_net"]) <= 1e-5


@pytest.mark.parametrize("args", [(E, 100.0, STEPS, 1e-5), (1024, 100.0, 100, 1e-5),
                                  (33, 15.0, 7, 4e-5)])
def test_build_pinn_grid_matches_jax(args):
    got = build_pinn_grid(*args).numpy()
    want = np.asarray(jax_build_pinn_grid(*args))
    assert got.shape == want.shape == (args[2] + 1, args[0], 2)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1.2e-7)


def test_forward_and_latent_solution_match_jax(setup):
    pm, _, bp2, _, _, want = setup
    with torch.no_grad():
        got = pm(bp2).numpy()
        sol = pm.generate_latent_solution(bp2).numpy()
    B, L = bp2["t"].shape
    assert got.shape == (B, L, 3) and sol.shape == (B, L, 4, E)
    assert rel(got, want["forward"]) <= 1e-5
    assert rel(sol, want["sol"]) <= 1e-5


@pytest.mark.parametrize("chunk", [None, 4, 7])
def test_predict_energy_matches_jax_forward(setup, chunk):
    pm, _, bp2, _, _, want = setup
    with torch.no_grad():
        got = pm.predict_energy(bp2, time_chunk=chunk).numpy()
    np.testing.assert_allclose(got, np.asarray(want["forward"]), rtol=2e-5, atol=2e-6)


def test_pinn_loss_and_gradient_match_jax(setup):
    pm, bp1, bp2, _, _, want = setup
    loss_fn = WaveControlPINNLoss(model=pm, c0=float(w.WATER))
    lp, gp = port_grads(pm, lambda: loss_fn(bp1))
    assert rel(float(lp.detach()), float(want["loss"])) <= 1e-5
    assert_grads_close(gp, want["grads"], KIND)
    with pytest.raises(AssertionError, match="trains on horizon-1 windows"):
        loss_fn(bp2)
