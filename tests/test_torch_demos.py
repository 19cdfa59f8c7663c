"""The port's demos against the JAX scripts on the CPU:

- `scripts/pml_demo.py`'s rollout against `scripts_tpu/pml_demo.py`'s (the
  plain integrator over the free field, 48^2, 20 steps): frames and
  energies 1e-5 relative; the CLI writes its video (a GIF here, where
  there is no ffmpeg);
- `scripts/adjoint_demo.py`: the first loss and its gradient at JAX's
  initial coefficients (`PRNGKey(0)`) against `jax.value_and_grad` of
  `scripts_tpu/adjoint_demo.py`'s loss, 1e-5 and 1e-4 relative; the CLI's
  loss falls over 3 Adam steps and its figure is written.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_node import rel

import waves_jl_tpu as w
from waves_jl_tpu.models import embed_sin as jax_embed_sin
from waves_jl_tpu.models import sin_basis as jax_sin_basis
from waves_jl_tpu_torch.scripts import adjoint_demo, pml_demo

torch.set_num_threads(1)


def test_pml_demo_matches_jax(tmp_path):
    n, steps = 48, 20
    frames, e = pml_demo.main(["--n", str(n), "--steps", str(steps), "--device", "cpu",
                               "--out", str(tmp_path / "pml.mp4")])
    # the JAX script's rollout (scripts_tpu/pml_demo.py)
    dim = w.two_dim(15.0, n)
    it = w.Integrator(dynamics=w.make_acoustic_dynamics_2d(dim, float(w.WATER), 2.0, 20000.0),
                      dt=1e-5)
    shape = w.build_normal(w.build_grid(dim), jnp.array([[0.0, 0.0]]), jnp.array([0.3]),
                           jnp.array([1.0]))
    src = w.Source(shape=shape, freq=jnp.float32(1000.0))
    traj = jax.jit(lambda u: it(u, w.build_tspan(0.0, 1e-5, steps),
                                (lambda t: jnp.float32(w.WATER), src)))(w.build_wave(dim, 12))
    assert frames.shape == (steps // 10 + 1, n, n) and e.shape == (steps + 1,)
    assert rel(frames, np.asarray(traj[::10, 0])) <= 1e-5
    assert rel(e, np.sum(np.asarray(traj[:, 0]) ** 2, axis=(1, 2))) <= 1e-5
    assert e.max() > 0.0 and os.path.getsize(tmp_path / "pml.gif") > 0


def test_adjoint_demo_matches_jax(tmp_path):
    steps, nfreq, elements = 10, 8, 64
    # the JAX script's loss (scripts_tpu/adjoint_demo.py) at its initial coefficients
    latent_dim = w.one_dim(15.0, elements)
    dyn = w.make_acoustic_dynamics_1d(latent_dim, float(w.WATER), 5.0, 10000.0)
    it = w.Integrator(dynamics=dyn, dt=1e-5, checkpoint="sqrt")
    target = w.build_normal(latent_dim.x, jnp.array([0.0]), jnp.array([0.3]), jnp.array([1.0]))
    basis = jax_sin_basis(elements, 15.0, nfreq)
    coefs = jax.random.normal(jax.random.PRNGKey(0), (1, 4, nfreq)) * 0.01
    tspan = jnp.broadcast_to(w.build_tspan(0.0, 1e-5, steps), (1, steps + 1))
    C = w.LinearInterpolation(X=tspan[:, jnp.array([0, -1])],
                              Y=jnp.ones((1, 2, elements), jnp.float32))
    F = w.Source(shape=jnp.zeros((1, elements), jnp.float32), freq=jnp.float32(1.0))
    theta = (C, F, jnp.broadcast_to(dyn.pml / dyn.pml[0], (1, elements)))

    def loss_fn(c):
        z = it(jax_embed_sin(basis, c), tspan, theta)
        return jnp.mean((z[-1, 0, 0] - target) ** 2) + 0.005 * jnp.linalg.norm(c)

    want_loss, want_grad = jax.jit(jax.value_and_grad(loss_fn))(coefs)
    problem = adjoint_demo.AdjointProblem(steps, nfreq, elements, "cpu")
    c = torch.from_numpy(np.array(coefs)).requires_grad_(True)
    loss = problem.loss(c)
    (grad,) = torch.autograd.grad(loss, [c])
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert rel(grad.numpy(), np.asarray(want_grad)) <= 1e-4

    out = tmp_path / "adjoint.png"
    losses = adjoint_demo.main(["--steps", str(steps), "--iters", "3", "--nfreq", str(nfreq),
                                "--elements", str(elements), "--device", "cpu",
                                "--out", str(out)])
    assert len(losses) == 3 and losses[-1] < losses[0] and os.path.getsize(out) > 0
