"""The learning check of `chip_smoke.py`'s phase 9, held against the JAX
package at the flagship's full width on the CPU.

The tracked weights (`models/ref500_h8s4/checkpoint_step=2600`: 1,024
elements, h_size 256, nfreq 500, latent stride 4) and the fixed batch of 4
horizon-8 windows that phase 9 draws from its card-generated episodes
(`tests/test_torch_train_learning.npz`, written on the card by
`python3 chip_smoke.py --save-train-batch tests/test_torch_train_learning.npz`
together with the card's loss trajectories) go to both packages, which
take 10 Adam updates (accumulate 1, sc_weight 4) at the recipe's lr 1e-4:

- in both, the first update raises the batch's loss more than tenfold
  (0.0738 to 3.16), and after the 10 updates it is still more than ten
  times the loss before: from these converged weights the recipe's lr
  raises it, which is why phase 9 checks learning at lr 1e-5;
- JAX's loss and the port's after the first update agree to 1e-2
  relative (measured 1.5e-3), and at every point of the trajectory to
  5e-2 (measured 3.3e-2): Adam moves every parameter by about lr whatever
  the size of its gradient, so a parameter whose gradient is near zero
  can move 2 lr apart in the two frameworks, and the gap grows with the
  updates;
- the port's trajectory on the CPU agrees with the card's to 1e-2
  relative at every point.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import waves_jl_tpu as w
from waves_jl_tpu.models import AcousticEnergyModel as JaxModel
from waves_jl_tpu.models import acoustic_energy_model as jam
from waves_jl_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from waves_jl_tpu.train.loop import TrainConfig as JaxTrainConfig
from waves_jl_tpu.train.loop import make_optimizer as jax_make_optimizer
from waves_jl_tpu.train.loop import make_train_step as jax_make_train_step
from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel, energy_loss
from waves_jl_tpu_torch.models.layers import full_float32
from waves_jl_tpu_torch.train import TrainConfig, make_optimizer, make_train_step
from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint
from waves_jl_tpu_torch.utils.trees import decode_structure

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "models", "ref500_h8s4", "checkpoint_step=2600")
BATCH = os.path.join(ROOT, "tests", "test_torch_train_learning.npz")
STEPS, STRIDE, LR, UPDATES = 100, 4, 1e-4, 10


def to_jax(x):
    """A port batch tree as the JAX package's (dataclasses by name)."""
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return getattr(w, type(x).__name__)(
            **{f.name: to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return jnp.asarray(x.numpy())


def jax_trajectory(batch) -> list:
    model = JaxModel.create(design_space=w.build_triple_ring_design_space(), source_freq=1000.0,
                            elements=1024, h_size=256, nfreq=500,
                            integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE)
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)
    params, _, _ = jax_load_checkpoint(CHECKPOINT, like)

    def loss_fn(p, b):
        return jam.energy_loss(model, p, b, sc_weight=4.0)

    opt = jax_make_optimizer(JaxTrainConfig(lr=LR, accumulate=1))
    step = jax_make_train_step(loss_fn, opt)
    state, losses = opt.init(params), []
    for _ in range(UPDATES):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    losses.append(jax.jit(loss_fn)(params, batch))
    return [float(v) for v in losses]


def port_trajectory(batch) -> list:
    model = AcousticEnergyModel(build_triple_ring_design_space(device="cpu"), 1000.0,
                                elements=1024, h_size=256, nfreq=500,
                                integration_steps=STEPS // STRIDE, dt=1e-5 * STRIDE,
                                checkpoint="none", device="cpu")
    load_model_checkpoint(model, CHECKPOINT)

    def loss_fn(b):
        return energy_loss(model, b, sc_weight=4.0)

    opt = make_optimizer(TrainConfig(lr=LR, accumulate=1))
    step = make_train_step(loss_fn, opt)
    state, losses = opt.init(dict(model.named_parameters())), []
    with full_float32():
        for _ in range(UPDATES):
            _, state, loss = step(model, state, batch)
            losses.append(loss.detach())
        with torch.no_grad():
            losses.append(loss_fn(batch))
    return [float(v) for v in losses]


def test_recipe_lr_raises_the_fixed_batch_loss_in_both_packages():
    with np.load(BATCH) as f:
        data = {k: f[k] for k in f.files}
    batch = decode_structure(json.loads(str(data["structure"])),
                             lambda k: torch.from_numpy(data[k]))
    assert batch["s_wave"].shape[0] == 4 and batch["t"].shape[1] == 8 * STEPS // STRIDE + 1
    want = np.array(jax_trajectory(to_jax(batch)))
    got = np.array(port_trajectory(batch))
    card = data["traj_lr1e_4"]
    print(f"loss trajectories at lr {LR:g}\nJAX  {want}\nport {got}\ncard {card}")
    for traj in (want, got):
        assert traj[1] > 10 * traj[0] and traj[-1] > 10 * traj[0], (got, want)
    rel = np.abs(got - want) / np.abs(want)
    assert rel[1] <= 1e-2 and rel.max() <= 5e-2, (rel, got, want)
    rel_card = np.abs(got - card) / np.abs(card)
    assert rel_card.max() <= 1e-2, (rel_card, got, card)
