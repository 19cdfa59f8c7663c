"""The bf16 options of the flagship surrogate on the CPU, against the JAX
package at the sizes of tests/test_models.py (64 elements, h_size 8, nfreq
8, 10 steps a window, `__graft_entry__._tiny_batch`), JAX's initial
weights carried across:

- `AcousticDynamics1D` with `state_dtype` "float32" and "bfloat16"
  against JAX's on the same inputs: the right-hand side within 1e-6 of its
  largest magnitude in float32, within bf16's 1e-2 for bf16 state;
- `fast_ranking()` against JAX's `fast_ranking()` and against the port's
  float32 model, as tests/test_models.py holds JAX's: the candidates'
  cumulative scattered energies within rtol 5e-2 / atol 1e-4 and the same
  argmin, through the forward and through `predict_shot_energy`;
- the fast model shares the original's parameters and modules;
- `conv_dtype=torch.bfloat16` against JAX's `conv_dtype=jnp.bfloat16` and
  against float32 at rtol 0.1 / atol 0.05 (tests/test_models.py's bound),
  the parameters float32 and the same weights loading into both forms;
- the float32 defaults bit for bit what the port computed before the
  options: the latent right-hand side against its float32 formula, and
  the CNN base against `nn.Conv2d` modules called directly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_train_model import port_space, rel, to_port_batch

import waves_jl_tpu as w
from __graft_entry__ import _tiny_batch
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu.physics.dynamics import make_acoustic_dynamics_1d as jax_dynamics_1d
from waves_jl_tpu_torch.dims import one_dim
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.models.layers import leaky_relu
from waves_jl_tpu_torch.physics.dynamics import make_acoustic_dynamics_1d
from waves_jl_tpu_torch.utils.trees import tree_index

torch.set_num_threads(1)
KW = dict(elements=64, h_size=8, nfreq=8, integration_steps=10)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_latent_dynamics_modes_match_jax(state_dtype):
    rng = np.random.default_rng(5)
    B, En = 3, 64
    x = rng.standard_normal((B, 4, En)).astype(np.float32)
    c, f = rng.uniform(0.5, 1.5, (B, En)), rng.standard_normal((B, En)) * 0.1
    pml = rng.uniform(0.0, 1.0, (B, En))
    c, f, pml = (a.astype(np.float32) for a in (c, f, pml))
    jd = dataclasses.replace(
        jax_dynamics_1d(w.one_dim(100.0, En), 1531.0, 10.0, 10000.0),
        state_dtype=state_dtype)
    want = np.asarray(jd(jnp.asarray(x), 0.0, (lambda _: jnp.asarray(c), lambda _: jnp.asarray(f),
                                                 jnp.asarray(pml))), np.float32)
    pd = dataclasses.replace(make_acoustic_dynamics_1d(one_dim(100.0, En, device="cpu"), 1531.0,
                                                       10.0, 10000.0),
                             state_dtype=state_dtype)
    got = pd(t(x), 0.0, (lambda _: t(c), lambda _: t(f), t(pml)))
    assert got.dtype == (torch.bfloat16 if state_dtype == "bfloat16" else torch.float32)
    assert rel(got.float().numpy(), want) <= (1e-2 if state_dtype == "bfloat16" else 1e-6)


@pytest.fixture(scope="module")
def setup():
    """JAX's float32 and bf16-conv models, params and a tiny batch of 8
    candidates over horizon 2 (tests/test_models.py's)."""
    kw = dict(design_space=w.build_triple_ring_design_space(), source_freq=1000.0, **KW)
    jm = JaxModel.create(**kw)
    jbf = JaxModel.create(conv_dtype=jnp.bfloat16, **kw)
    batch = _tiny_batch(jm, B=8, horizon=2, steps=10, res=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), batch)
    return jm, jbf, params, batch


def port_model(params, **kw):
    pm = tam.AcousticEnergyModel(port_space(), 1000.0, device="cpu", **KW, **kw)
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    return pm


def test_fast_ranking_matches_jax_and_float32(setup):
    jm, _, params, batch = setup
    want = np.asarray(jm.fast_ranking()(params, batch))[:, :, 2].sum(axis=1)
    pm = port_model(params)
    fast = pm.fast_ranking()
    bp = to_port_batch(batch)
    with torch.no_grad():
        cost32 = pm(bp)[:, :, 2].sum(dim=1).numpy()
        cost = fast(bp)[:, :, 2].sum(dim=1).numpy()
    for other in (want, cost32):
        np.testing.assert_allclose(cost, other, rtol=5e-2, atol=1e-4)
        assert int(np.argmin(cost)) == int(np.argmin(other))

    # the selection's path: one observation, the 8 candidates' sequences
    obs = bp["s_wave"][0] + torch.linspace(0.0, 1e-2, 16)[:, None, None]
    design = tree_index(bp["s_design"], 0)
    shots = [m.predict_shot_energy(obs, design, bp["a"], bp["t"]).numpy() for m in (pm, fast)]
    np.testing.assert_allclose(shots[1], shots[0], rtol=5e-2, atol=1e-4)
    assert int(np.argmin(shots[1])) == int(np.argmin(shots[0]))


def test_fast_ranking_shares_the_parameters(setup):
    _, _, params, batch = setup
    pm = port_model(params)
    fast = pm.fast_ranking()
    assert fast.integrator.dynamics.state_dtype == "bfloat16"
    assert fast.integrator.checkpoint == "none" and pm.integrator.checkpoint == "sqrt"
    assert pm.integrator.dynamics.state_dtype == "float32"
    assert all(a is b for a, b in zip(pm.parameters(), fast.parameters()))
    assert fast.wave_encoder is pm.wave_encoder and fast.design_mlp is pm.design_mlp
    bp = to_port_batch(batch)
    with torch.no_grad():
        before = fast(bp)
        next(pm.wave_encoder.heads[0].parameters()).mul_(2.0)
        assert not torch.equal(fast(bp), before)


def test_bf16_convs_match_jax_and_float32(setup):
    jm, jbf, params, batch = setup
    want_bf, want32 = np.asarray(jbf(params, batch)), np.asarray(jm(params, batch))
    pbf = port_model(params, conv_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in pbf.parameters())
    assert pbf.wave_encoder.cnn.blocks[0].dtype == torch.bfloat16
    bp = to_port_batch(batch)
    with torch.no_grad():
        got = pbf(bp).numpy()
        got32 = port_model(params)(bp).numpy()
        enc = pbf.encode_wave(bp["s_wave"][0])
    assert enc.dtype == torch.float32 and got.dtype == np.float32
    for other in (want_bf, want32, got32):
        np.testing.assert_allclose(got, other, rtol=0.1, atol=0.05)

    # the gradient reaches the float32 parameters through the bf16 casts
    loss = tam.energy_loss(pbf, bp)
    grads = torch.autograd.grad(loss, list(pbf.wave_encoder.cnn.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_float32_defaults_unchanged_bit_for_bit(setup):
    _, _, params, batch = setup
    rng = np.random.default_rng(6)
    dyn = make_acoustic_dynamics_1d(one_dim(100.0, 64, device="cpu"), 1531.0, 10.0, 10000.0)
    x, c, f, pml = (t(rng.standard_normal(s)) for s in ((3, 4, 64), (3, 64), (3, 64), (3, 64)))
    got = dyn(x, 0.0, (lambda _: c, lambda _: f, pml))
    e_uf = torch.tensor([0.0, 1.0, 0.0, 1.0])[None, :, None]
    tot = torch.tensor([True, True, False, False])[None, :, None]
    bc_mask = torch.tensor([1.0, 0.0, 1.0, 0.0])[None, :, None] * (dyn.bc[None, None, :] - 1) + 1
    d = torch.matmul(x[:, [1, 0, 3, 2]] + f[:, None] * e_uf, dyn.grad.T)
    coef = 1531.0 * torch.where(tot, c[:, None], torch.ones_like(c[:, None]))
    want = (coef * d - (dyn.pml[0] * pml)[:, None] * x) * bc_mask
    assert torch.equal(got, want)

    cnn = port_model(params).wave_encoder.cnn
    img = to_port_batch(batch)["s_wave"].permute(0, 3, 1, 2) + t(rng.random((8, 4, 16, 16)))
    b, _, h, wd = img.shape
    coords = torch.stack([torch.linspace(-1, 1, h)[:, None].expand(h, wd),
                          torch.linspace(-1, 1, wd)[None, :].expand(h, wd)])[None]
    y = torch.cat([img + 1e-5, coords.expand(b, 2, h, wd)], dim=1)
    for blk in cnn.blocks:
        main = blk.conv1(leaky_relu(blk.conv0(y)))
        y = F.max_pool2d(leaky_relu(main + blk.conv2(y)), 2)
    with torch.no_grad():
        assert torch.equal(cnn(img), torch.amax(y, dim=(2, 3)))
