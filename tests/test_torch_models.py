"""The port's flagship surrogate against the JAX package with the same
weights: the converter maps every flax leaf of the tracked checkpoint; at
full width `encode_wave` on one 128^2 observation and
`predict_shot_energy` for 8 shots of horizon 1 agree to 1e-4 relative (the
convolutions and matmuls sum in other orders, and the sine basis rounds
its phases apart); at narrow widths the design encoder agrees to 1e-5."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waves_jl_tpu as w
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu.models.design_encoder import DesignMLP as JaxDesignMLP
from waves_jl_tpu.models.design_encoder import design_encoder_apply as jax_design_encoder_apply
from waves_jl_tpu_torch import designs as td
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.models.design_encoder import DesignMLP, design_encoder_apply
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint, load_params, load_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "models/ref500_h8s4/checkpoint_step=2600")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def nested(named: dict) -> dict:
    """The flax parameter tree from keystr-named leaves."""
    import re

    tree: dict = {}
    for k, v in named.items():
        path = re.findall(r"\['([^']*)'\]", k)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    return tree


def jax_ring(r):
    lo = w.build_triple_ring_design_space().low
    return w.Cloak(w.AdjustableRadiiScatterers(
        w.Cylinders(lo.config.cylinders.pos, jnp.asarray(r), lo.config.cylinders.c)), lo.core)


def port_ring(space, r):
    lo = space.low
    return td.Cloak(td.AdjustableRadiiScatterers(
        td.Cylinders(lo.config.cylinders.pos, torch.from_numpy(r), lo.config.cylinders.c)), lo.core)


def radii_actions(a, jax_side: bool):
    """(S, H, 18) radius deltas as a Cloak action pytree with zero elsewhere."""
    S, H, m = a.shape
    if jax_side:
        z = lambda *s: jnp.zeros(s, jnp.float32)  # noqa: E731
        return w.Cloak(w.AdjustableRadiiScatterers(w.Cylinders(z(S, H, m, 2), jnp.asarray(a),
                                                               z(S, H, m))),
                       w.Cylinders(z(S, H, 1, 2), z(S, H, 1), z(S, H, 1)))
    z = torch.zeros
    return td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(z(S, H, m, 2), torch.from_numpy(a),
                                                              z(S, H, m))),
                    td.Cylinders(z(S, H, 1, 2), z(S, H, 1), z(S, H, 1)))


def test_converter_maps_every_leaf_of_the_tracked_checkpoint():
    space = td.build_triple_ring_design_space(device="cpu")
    model = AcousticEnergyModel(space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                integration_steps=25, dt=4e-5, device="cpu")
    named = load_params(CHECKPOINT)
    state = from_jax_params(named, expected=model.state_dict())
    assert len(state) == len(named) == len(model.state_dict()) == 64
    k = "['wave_encoder']['params']['CNNBase_0']['ResidualBlock_0']['Conv_0']['kernel']"
    np.testing.assert_array_equal(state["wave_encoder.cnn.blocks.0.conv0.weight"].numpy(),
                                  named[k].transpose(3, 2, 0, 1))
    k = "['design_encoder']['params']['MLP_0']['Dense_4']['kernel']"
    np.testing.assert_array_equal(state["design_mlp.mlp.layers.4.weight"].numpy(), named[k].T)
    assert load_model_checkpoint(model, CHECKPOINT) == load_step(CHECKPOINT) == 2600
    # a leaf it does not know, and a parameter left without a leaf, both fail loudly
    with pytest.raises(KeyError, match="no port parameter"):
        from_jax_params({**named, "['wave_encoder']['params']['Extra_0']['kernel']": np.zeros(1)})
    short = dict(named)
    short.pop(k)
    with pytest.raises(KeyError, match="without a flax leaf"):
        from_jax_params(short, expected=model.state_dict())


def test_flagship_encode_and_predict_match_jax():
    jm = JaxModel.create(design_space=w.build_triple_ring_design_space(), source_freq=1000.0,
                         elements=1024, h_size=256, nfreq=500, integration_steps=25, dt=4e-5)
    params = nested(load_params(CHECKPOINT))
    space = td.build_triple_ring_design_space(device="cpu")
    model = AcousticEnergyModel(space, 1000.0, elements=1024, h_size=256, nfreq=500,
                                integration_steps=25, dt=4e-5, device="cpu")
    load_model_checkpoint(model, CHECKPOINT)

    rng = np.random.default_rng(0)
    obs = (rng.standard_normal((128, 128, 4)) * 0.1).astype(np.float32)
    xj = np.asarray(jm.encode_wave(params, jnp.asarray(obs)))
    with torch.no_grad():
        xt = model.encode_wave(torch.from_numpy(obs)).numpy()
    assert xt.shape == (6, 1024)
    assert rel(xt, xj) <= 1e-4

    S = 8
    r = rng.uniform(0.2, 1.0, 18).astype(np.float32)
    a = rng.uniform(-0.25, 0.25, (S, 1, 18)).astype(np.float32)
    t = np.broadcast_to(np.float32(3e-3) + np.asarray(w.build_tspan(0.0, 4e-5, 25))[None],
                        (S, 26)).astype(np.float32)
    ej = np.asarray(jm.predict_shot_energy(params, jnp.asarray(obs), jax_ring(r),
                                           radii_actions(a, True), jnp.asarray(t)))
    et = model.predict_shot_energy(torch.from_numpy(obs), port_ring(space, r),
                                   radii_actions(a, False), torch.from_numpy(t)).numpy()
    assert et.shape == (S,)
    assert rel(et, ej) <= 1e-4


def test_design_encoder_matches_jax_at_narrow_width():
    h, nfreq, E, S, H, steps = 16, 12, 32, 5, 3, 4
    jsp = w.build_triple_ring_design_space()
    psp = td.build_triple_ring_design_space(device="cpu")
    rng = np.random.default_rng(1)
    mlp_j = JaxDesignMLP(h_size=h, nfreq=nfreq, elements=E, latent_grid_size=100.0)
    params = mlp_j.init(jax.random.PRNGKey(0), jnp.zeros((S, H + 1, 18)))
    mlp_t = DesignMLP(18, h, nfreq, E, 100.0, device="cpu")
    state = from_jax_params({"design_encoder": params})
    mlp_t.load_state_dict({k.removeprefix("design_mlp."): v for k, v in state.items()}, strict=True)

    r = rng.uniform(0.2, 1.0, 18).astype(np.float32)
    a = rng.uniform(-0.5, 0.5, (S, H, 18)).astype(np.float32)  # clamps at the box edges
    t = np.broadcast_to(np.linspace(0.0, H * steps * 4e-5, H * steps + 1, dtype=np.float32)[None],
                        (S, H * steps + 1)).astype(np.float32)
    jd = jax.tree_util.tree_map(lambda v: jnp.broadcast_to(v[None], (S, *v.shape)), jax_ring(r))
    pdz = port_ring(psp, r)
    pd = td.Cloak(td.AdjustableRadiiScatterers(td.Cylinders(
        *[v[None].expand(S, *v.shape) for v in (pdz.config.cylinders.pos, pdz.config.cylinders.r,
                                                pdz.config.cylinders.c)])),
        td.Cylinders(*[v[None].expand(S, *v.shape) for v in (pdz.core.pos, pdz.core.r,
                                                              pdz.core.c)]))
    cj = jax_design_encoder_apply(mlp_j, params, jsp, jd, radii_actions(a, True), jnp.asarray(t),
                                  steps)
    with torch.no_grad():
        ct = design_encoder_apply(mlp_t, psp, pd, radii_actions(a, False), torch.from_numpy(t),
                                  steps)
    assert rel(ct.Y.numpy(), np.asarray(cj.Y)) <= 1e-5
    for k in (0, 3, 7, H * steps):
        tk = t[:, k] + np.float32(1e-6)
        assert rel(ct(torch.from_numpy(tk)).numpy(), np.asarray(cj(jnp.asarray(tk)))) <= 1e-5


def test_latent_energy_readout_matches_jax():
    from waves_jl_tpu.models.acoustic_energy_model import compute_latent_energy as jax_energy
    from waves_jl_tpu_torch.models.acoustic_energy_model import compute_latent_energy

    z = np.random.default_rng(2).standard_normal((7, 3, 4, 32)).astype(np.float32)
    want = np.asarray(jax_energy(jnp.asarray(z), 0.25))
    got = compute_latent_energy(torch.from_numpy(z), 0.25).numpy()
    assert got.shape == (3, 7, 3)
    assert rel(got, want) <= 1e-6


def test_surrogate_runs_its_matmuls_and_convolutions_in_float32():
    """The wave encoder turns TF32 off for its own convolutions and matmuls,
    whatever the caller set, and gives the caller's flags back."""
    from waves_jl_tpu_torch.models.wave_encoder import WaveEncoder

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    enc = WaveEncoder(4, 8, 4, 16, 10.0, device="cpu")
    seen = []
    enc.cnn.register_forward_hook(lambda *_: seen.append(flags()))
    saved = flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        out = enc(torch.zeros(1, 16, 16, 4))
        assert out.shape == (1, 6, 16)
        assert seen == [(False, False)]
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
