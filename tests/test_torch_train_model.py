"""Training's model and losses against the JAX package at the JAX tests'
sizes (16^2 observations, elements 64, h_size 8, nfreq 8, 8 steps a
window), on the same numpy inputs and JAX's initial parameters carried
across by `from_jax_params`:

- `Integrator` with per-sample (B, T+1) times: the values and gradients of
  "none", "step" and "sqrt" are identical;
- the batch forward (B, L, 3) against JAX's `model(params, batch)`: 1e-5
  relative;
- `energy_loss` (sc_weight 1 and 4) and `energy_loss_ranking`: values
  1e-5 relative, gradients 1e-4 relative to each leaf's largest magnitude
  against `jax.grad`.

The helpers here (synthetic episodes, model pairs) serve the other
`test_torch_train_*` files; `pool_ranking_loss` and `bc_loss` are held in
`test_torch_train_losses.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.data import Episode as JaxEpisode
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.models import sin_basis as jax_sin_basis
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch.data import Episode
from waves_jl_tpu_torch.models import acoustic_energy_model as tam
from waves_jl_tpu_torch.models.convert import from_jax_params, policy_from_jax_params
from waves_jl_tpu_torch.utils.trees import tree_map

torch.set_num_threads(1)
E, H_SIZE, NFREQ, STEPS, RES, ACTIONS, M = 64, 8, 8, 8, 16, 4, 18
DT = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def jax_space():
    return w.build_triple_ring_design_space()


def port_space():
    return td.build_triple_ring_design_space(device="cpu")


def designs(rng, lead: tuple):
    """Triple-ring designs with leading `lead`, radii drawn inside the box:
    (jax tree, port tree)."""
    lo, hi = jax_space().low, jax_space().high
    r = rng.uniform(np.asarray(lo.config.cylinders.r), np.asarray(hi.config.cylinders.r),
                    lead + (M,)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(lo.config.cylinders.pos), lead + (M, 2)).astype(np.float32)
    c = np.broadcast_to(np.asarray(lo.config.cylinders.c), lead + (M,)).astype(np.float32)
    core = [np.broadcast_to(np.asarray(x), lead + np.shape(x)).astype(np.float32)
            for x in (lo.core.pos, lo.core.r, lo.core.c)]
    return to_trees(pos, r, c, core)


def actions(rng, lead: tuple, scale=0.2):
    """Radius-delta actions with leading `lead`, zero elsewhere."""
    a = rng.uniform(-scale, scale, lead + (M,)).astype(np.float32)
    z = np.zeros
    return to_trees(z(lead + (M, 2), np.float32), a, z(lead + (M,), np.float32),
                    [z(lead + (1, 2), np.float32), z(lead + (1,), np.float32),
                     z(lead + (1,), np.float32)])


def to_trees(pos, r, c, core):
    j = w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(*map(jnp.asarray, (pos, r, c)))),
                w.Cylinders(*map(jnp.asarray, core)))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    p = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(t(pos), t(r), t(c))),
                 td.Cylinders(*map(t, core)))
    return j, p


def episodes(n: int, seed: int = 0, actions_per: int = ACTIONS):
    """n synthetic episodes of `actions_per` windows of STEPS steps, made
    with numpy from `seed`: (jax list, port list)."""
    rng = np.random.default_rng(seed)
    jx, pt = [], []
    for i in range(n):
        A = actions_per
        s_wave = (rng.standard_normal((A, RES, RES, 4)) * 0.1).astype(np.float32)
        k = np.arange(A)[:, None] * STEPS + np.arange(STEPS + 1)[None, :]
        s_tspan = (np.float32(i * 1e-3) + k * np.float32(DT)).astype(np.float32)
        y = rng.uniform(0.0, 0.05, (A, STEPS + 1, 3)).astype(np.float32)
        dj, dp = designs(rng, (A,))
        aj, ap = actions(rng, (A,))
        jx.append(JaxEpisode(s_wave=jnp.asarray(s_wave), s_design=dj,
                             s_tspan=jnp.asarray(s_tspan), a=aj, y=jnp.asarray(y)))
        pt.append(Episode(s_wave=torch.from_numpy(s_wave), s_design=dp,
                          s_tspan=torch.from_numpy(s_tspan), a=ap, y=torch.from_numpy(y)))
    return jx, pt


def models(dt: float = DT):
    """The JAX model with params from PRNGKey(0), and the port's model
    holding the same weights."""
    jm = JaxModel.create(design_space=jax_space(), source_freq=1000.0, elements=E, h_size=H_SIZE,
                         nfreq=NFREQ, integration_steps=STEPS, dt=dt)
    je, _ = episodes(1, seed=99)
    from waves_jl_tpu.data import prepare_data

    params = jax.jit(jm.init)(jax.random.PRNGKey(0), prepare_data(je[0], 1))
    pm = tam.AcousticEnergyModel(port_space(), 1000.0, elements=E, h_size=H_SIZE, nfreq=NFREQ,
                                 integration_steps=STEPS, dt=dt, device="cpu")
    pm.load_state_dict(from_jax_params(params, expected=pm.state_dict()))
    return jm, params, pm


def assert_grads_close(port: dict, jax_tree, tol=1e-4, policy=False):
    """Each port gradient against JAX's, relative to the leaf's largest
    magnitude."""
    conv = policy_from_jax_params if policy else from_jax_params
    want = conv(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert policy or len(want) == len(port) or set(port) < set(want)
    for k, g in port.items():
        assert rel(g.numpy(), want[k].numpy()) <= tol, (k, rel(g.numpy(), want[k].numpy()))


def to_port_batch(batch_j):
    """A JAX batch dict as port tensors (trees mapped leaf by leaf)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            cls = getattr(td, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return torch.from_numpy(np.array(x))

    return conv(batch_j)


@pytest.fixture(scope="module")
def setup():
    from waves_jl_tpu.data import prepare_data

    jm, params, pm = models()
    je, _ = episodes(1, seed=1)
    bj = jax.tree_util.tree_map(lambda x: x[:3], prepare_data(je[0], 2))
    return jm, params, pm, bj, to_port_batch(bj)


def _index(tree, i):
    return tree_map(lambda x: x[i], tree)


def _port_grads(pm, fn):
    ps = dict(pm.named_parameters())
    loss = fn()
    return loss, dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))


def test_integrator_checkpoint_modes_are_identical(setup):
    _, _, pm, _, bp = setup
    out = {}
    for mode in ("none", "step", "sqrt"):
        pm.integrator = dataclasses.replace(pm.integrator, checkpoint=mode)
        loss, g = _port_grads(pm, lambda: tam.energy_loss(pm, bp, 4.0))
        out[mode] = (pm(bp).detach(), loss.detach(), g)
    pm.integrator = dataclasses.replace(pm.integrator, checkpoint="sqrt")
    assert out["none"][0].shape == (3, 2 * STEPS + 1, 3)
    for mode in ("step", "sqrt"):
        assert torch.equal(out[mode][0], out["none"][0])
        assert torch.equal(out[mode][1], out["none"][1])
        for k in out["none"][2]:
            assert torch.equal(out[mode][2][k], out["none"][2][k]), (mode, k)


def test_batched_times_step_each_sample_on_its_own_grid(setup):
    """Per-sample times: sample b of a batch equals the batch of b alone;
    `rollout_final` is the trajectory's last frame."""
    _, _, pm, _, bp = setup
    with torch.no_grad():
        full = pm(bp)
        for b in range(3):
            one = pm(_index(bp, slice(b, b + 1)))
            assert rel(one[0].numpy(), full[b].numpy()) <= 1e-6
        z0, theta = pm.get_parameters_and_initial_condition(bp)
        traj = pm.integrator(z0, bp["t"], theta)
        assert torch.equal(pm.integrator.rollout_final(z0, bp["t"], theta), traj[-1])


def test_forward_matches_jax(setup):
    jm, params, pm, bj, bp = setup
    want = np.asarray(jm(params, bj))
    with torch.no_grad():
        got = pm(bp).numpy()
    assert got.shape == want.shape == (3, 2 * STEPS + 1, 3)
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("which", ["mse_sc1", "mse_sc4", "ranking"])
def test_energy_losses_and_gradients_match_jax(setup, which):
    jm, params, pm, bj, bp = setup
    jfn, pfn = {
        "mse_sc1": (lambda p: jam.energy_loss(jm, p, bj), lambda: tam.energy_loss(pm, bp)),
        "mse_sc4": (lambda p: jam.energy_loss(jm, p, bj, sc_weight=4.0),
                    lambda: tam.energy_loss(pm, bp, sc_weight=4.0)),
        "ranking": (lambda p: jam.energy_loss_ranking(jm, p, bj),
                    lambda: tam.energy_loss_ranking(pm, bp)),
    }[which]
    lj, gj = jax.jit(jax.value_and_grad(jfn))(params)
    lp, gp = _port_grads(pm, pfn)
    assert rel(float(lp.detach()), float(lj)) <= 1e-5
    assert_grads_close(gp, gj)


def test_sinusoidal_source_matches_jax():
    """The latent source shape from the same basis and coefficients, as
    JAX's `SinusoidalSource.shape` (1e-6 relative), and
    the port's drawn coefficients of JAX's distribution: (nfreq,), normal
    over sqrt(nfreq)."""
    nfreq, grid = 500, 15.0
    basis = np.array(jax_sin_basis(1024, grid, nfreq))
    jsrc = jam.SinusoidalSource(basis=jnp.asarray(basis), freq=1000.0)
    tsrc = tam.SinusoidalSource(basis=torch.from_numpy(basis), freq=1000.0)
    coefs = np.random.default_rng(0).standard_normal(nfreq).astype(np.float32)
    want = np.asarray(jsrc.shape(jnp.asarray(coefs)))
    got = tsrc.shape(torch.from_numpy(coefs)).numpy()
    assert got.shape == want.shape == (1024,)
    assert rel(got, want) <= 1e-6
    drawn = tsrc.init_coefs(torch.Generator().manual_seed(0), nfreq).numpy() * np.sqrt(nfreq)
    assert drawn.shape == (nfreq,) and abs(drawn.std() - 1.0) < 0.1 and abs(drawn.mean()) < 0.1
