"""The port's optimizer against optax, and its flax-like initialisers.

- Adam with optax's defaults, alone (accumulate 1) and inside
  `optax.MultiSteps` (accumulate 4), fed the same numpy gradient sequence,
  tiny gradients included: parameters and every state leaf within 1e-6
  (relative, with 1e-6 of the leaf's largest magnitude as the absolute
  floor) after each micro-step; Adam's count advances on applied updates
  only and the parameters move only on every k-th micro-step.
- `init_flax_like_`: on a wide layer each kernel's std is within 5% of
  1/sqrt(fan_in), no value lies beyond 2 sigma, biases are 0; the
  flagship's layers all start so.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.layers import init_flax_like_
from waves_jl_tpu_torch.train import TrainConfig, make_optimizer
from waves_jl_tpu_torch.train.optim import MultiStepsState, apply_updates

torch.set_num_threads(1)
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
LR = 1e-3


def close(got: np.ndarray, want: np.ndarray, tol=1e-6):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("accumulate", [1, 4])
def test_adam_with_accumulation_matches_optax(accumulate):
    rng = np.random.default_rng(accumulate)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    steps = 3 * accumulate + 2
    grads = []
    for i in range(steps):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
             for k, s in SHAPES.items()}
        g["b"][0] = np.float32(1e-12 * (-1) ** i)  # a gradient near zero
        grads.append(g)

    jopt = optax.adam(LR)
    if accumulate > 1:
        jopt = optax.MultiSteps(jopt, every_k_schedule=accumulate)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    jupdate = jax.jit(jopt.update)

    opt = make_optimizer(TrainConfig(lr=LR, accumulate=accumulate))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    for i, g in enumerate(grads):
        u, js = jupdate({k: jax.numpy.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        before = {k: v.clone() for k, v in tp.items()}
        tu, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        apply_updates(tp, tu)
        applied = (i + 1) % accumulate == 0
        assert (tu is not None) == applied
        if not applied:
            assert all(torch.equal(before[k], tp[k]) for k in tp)
        for k in SHAPES:
            close(tp[k].numpy(), np.asarray(jp[k]))
        inner = ts.inner_opt_state if isinstance(ts, MultiStepsState) else ts
        jinner = js.inner_opt_state[0] if accumulate > 1 else js[0]
        assert inner.count == int(jinner.count) == (i + 1) // accumulate
        for k in SHAPES:
            close(inner.mu[k].numpy(), np.asarray(jinner.mu[k]))
            close(inner.nu[k].numpy(), np.asarray(jinner.nu[k]))
        if accumulate > 1:
            assert ts.mini_step == int(js.mini_step) and ts.gradient_step == int(js.gradient_step)
            for k in SHAPES:
                close(ts.acc_grads[k].numpy(), np.asarray(js.acc_grads[k]))


def test_flax_like_init_on_a_wide_layer():
    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(64, 256, 3)
    dense = torch.nn.Linear(512, 300)
    init_flax_like_(torch.nn.ModuleList([conv, dense]), g)
    for m, fan_in in ((conv, 64 * 9), (dense, 512)):
        sigma = 1.0 / np.sqrt(fan_in)
        wt = m.weight.detach().numpy()
        assert abs(wt.std() / sigma - 1.0) < 0.05
        assert np.abs(wt).max() <= 2.0 * sigma / 0.87962566103423978
        assert not m.bias.detach().any()


def test_flagship_starts_from_the_flax_distribution():
    space = td.build_triple_ring_design_space(device="cpu")
    a = AcousticEnergyModel(space, 1000.0, elements=64, h_size=64, nfreq=32, device="cpu", seed=1)
    b = AcousticEnergyModel(space, 1000.0, elements=64, h_size=64, nfreq=32, device="cpu", seed=1)
    c = AcousticEnergyModel(space, 1000.0, elements=64, h_size=64, nfreq=32, device="cpu", seed=2)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q), name  # the seed fixes the draw
        if name.endswith("bias"):
            assert not p.detach().any(), name
            continue
        assert not torch.equal(p, r), name
        fan_in = p[0].numel()
        assert float(p.detach().abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978
