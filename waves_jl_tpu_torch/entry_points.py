"""The port's counterparts of the JAX package's entry points
(`__graft_entry__.py` at the repository's root).

entry(device) -> (fn, args): the flagship `AcousticEnergyModel`'s forward
at the production configuration, `fn(*args)` the (2, 26, 3) predicted
energies of a tiny batch.

dryrun_multichip(n, device): one data-parallel training step, one
data-parallel scan over a windowed episode store, one domain-decomposed
FDTD window and one window of the y-sharded fused kernel (K4-XM on slabs),
on an n-shard mesh at tiny shapes.

Both run on the card unless the caller passes device="cpu", and raise
without one. The draws are the port's own, from explicit
`torch.Generator`s: the same shapes and distributions as the JAX ones,
not its numbers.
"""
from __future__ import annotations

import torch

from .constants import WATER
from .designs import DesignInterpolator, build_action_space, build_triple_ring_design_space
from .device import resolve_device
from .dims import build_grid, build_wave, get_dx, two_dim
from .models.acoustic_energy_model import AcousticEnergyModel, energy_loss
from .physics.dynamics import build_tspan, make_acoustic_dynamics_2d, xla_linspace
from .utils.gaussians import build_normal

STEPS = 10  # RK4 steps a window in the dry run, as in `__graft_entry__.py`


def _tiny_batch(model: AcousticEnergyModel, B: int = 2, horizon: int = 1, steps: int = 20,
                res: int = 16, generator: torch.Generator | None = None, device=None) -> dict:
    """A batch of B samples over `horizon` windows of `steps` steps for
    `model` (counterpart of `__graft_entry__._tiny_batch`): designs drawn
    from the model's design space and actions of +-0.25 from its action
    space with `generator` (seeded 0 on the device where not given), a
    constant 1e-3 observation (B, res, res, 4), times t (B, L) on the
    window at the model's dt, L = horizon steps + 1, and zero targets
    y (B, L, 3). On `device`, the model's by default."""
    dev = resolve_device(device if device is not None else next(model.parameters()).device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    space = model.design_space
    L = horizon * steps + 1
    dt = float(model.integrator.dt)
    t = torch.from_numpy(xla_linspace(0.0, horizon * steps * dt, L)).to(dev)
    return {
        "s_wave": torch.full((B, res, res, 4), 1e-3, dtype=torch.float32, device=dev),
        "s_design": space.sample(gen, batch=(B,)),
        "a": build_action_space(space.low, 0.25).sample(gen, batch=(B, horizon)),
        "t": t.expand(B, L).contiguous(),
        "y": torch.zeros((B, L, 3), dtype=torch.float32, device=dev),
    }


def entry(device="cuda"):
    """(fn, (model, batch)): the flagship surrogate's forward at the
    reference operating point (1,024-element latent, nfreq 500, h 256) in
    the production configuration, latent stride 4 (25 latent RK4 steps a
    100-step window at dt 4e-5), on a batch of 2 at res 128, horizon 1; the
    weights drawn from seed 0, the model on `device`. fn(model, batch) is
    the model's forward, (2, 26, 3) [tot, inc, sc] energies."""
    dev = resolve_device(device)
    model = AcousticEnergyModel(build_triple_ring_design_space(device=dev), 1000.0,
                                elements=1024, nfreq=500, h_size=256, integration_steps=25,
                                dt=4e-5, seed=0, device=dev)
    batch = _tiny_batch(model, B=2, horizon=1, steps=25, res=128,
                        generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def fn(model, batch):
        return model(batch)

    return fn, (model, batch)


def _mesh_devices(n: int, dev: torch.device) -> list:
    """n shards: one a card where the machine has n cards and `dev` is a
    card, else n shards on `dev` (a card by its index, as its tensors
    report it)."""
    if dev.type != "cuda":
        return [dev] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", k) for k in range(n)]
    return [torch.device("cuda", torch.cuda.current_device() if dev.index is None
                         else dev.index)] * n


def _finite(x: torch.Tensor, what: str) -> torch.Tensor:
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{what} is not finite")
    return x


def dryrun_multichip(n: int, device="cuda"):
    """One data-parallel training step and one domain-decomposed FDTD window
    of each kind on an n-shard mesh, at `__graft_entry__.py`'s tiny shapes
    (counterpart of `__graft_entry__.dryrun_multichip`): every card where
    the machine has n, else n shards on one device, the counterpart of
    JAX's virtual CPU mesh; on device="cpu" the plain paths on n CPU shards.
    In order:

    1. `make_dp_train_step`: one Adam update (lr 1e-4) of the flagship at
       elements 64, nfreq 8, h 8, 10 steps, on a batch of n at res 16;
    2. `make_dp_scan_train_steps_windowed`: K = 2 updates over a store of n
       episodes of `generate_episode` on a 32^2 env (the triple ring, one
       Gaussian source, observations 16^2, 10 steps, 2 actions), a window
       of horizon 2 a shard;
    3. `make_sharded_rollout`: a 10-step window at n_grid = max(8 n, 32);
    4. `make_fused_sharded_rollout` with radii_only and x_matmul (K4-XM on
       slabs): a 10-step window at max(16 n, 64).

    Raises where a result is not finite. Returns (the update's loss, the K
    losses, the plain window's signal, the fused window's signal)."""
    from .data import generate_episode
    from .env import RandomDesignPolicy, make_wave_env
    from .parallel import (Replicas, make_dp_train_step, make_fused_sharded_rollout, make_mesh,
                           make_sharded_rollout, shard_batch)
    from .physics.fused import cyl_params
    from .sources import GaussianSource
    from .train.optim import Adam
    from .train.windows import make_dp_scan_train_steps_windowed, stack_episodes

    dev = resolve_device(device)
    mesh = make_mesh(devices=_mesh_devices(n, dev))
    dev0 = mesh.devices[0]
    space = build_triple_ring_design_space(device=dev0)
    opt = Adam(1e-4)

    def flagship(device, seed):
        return AcousticEnergyModel(build_triple_ring_design_space(device=device), 1000.0,
                                   elements=64, nfreq=8, h_size=8, integration_steps=STEPS,
                                   seed=seed, device=device)

    def replicas_of(model, seed):
        def replicate(d):
            m = flagship(d, seed)
            return m, lambda b: energy_loss(m, b)

        return Replicas(model, lambda b: energy_loss(model, b), mesh, replicate)

    # 1. the data-parallel training step
    model = flagship(dev0, 0)
    batch = _tiny_batch(model, B=n, horizon=1, steps=STEPS, res=16,
                        generator=torch.Generator(device=dev0).manual_seed(0))
    replicas = replicas_of(model, 0)
    _, _, loss = make_dp_train_step(opt)(replicas, replicas.init(opt), shard_batch(batch, mesh))
    _finite(loss, "the data-parallel train step's loss")

    # 2. the data-parallel scan over the windowed episode store
    dim_e = two_dim(15.0, 32, device=dev0)
    src = GaussianSource.create(build_grid(dim_e), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                [1.0], 1000.0)
    env = make_wave_env(dim_e, space, src, resolution=(16, 16), integration_steps=STEPS,
                        actions=2)
    policy = RandomDesignPolicy(env.action_space)
    eps = [generate_episode(env, policy, torch.Generator(device=dev0).manual_seed(i))[1]
           for i in range(n)]
    wmodel = flagship(dev0, 1)
    wreplicas = replicas_of(wmodel, 1)
    run_k = make_dp_scan_train_steps_windowed(opt, horizon=2)
    idxs = torch.zeros((2, n, 2), dtype=torch.int64)  # K = 2, local episode 0, start 0
    _, _, losses = run_k(wreplicas, wreplicas.init(opt), stack_episodes(eps, mesh=mesh), idxs)
    _finite(losses, "the windowed data-parallel scan's losses")

    # 3. the domain-decomposed FDTD window (y-sharded grid, halo exchange)
    gen = torch.Generator(device=dev0).manual_seed(0)
    n_grid = max(8 * n, 32)
    dim = two_dim(5.0, n_grid, device=dev0)
    grid = build_grid(dim)
    dyn = make_acoustic_dynamics_2d(dim, WATER, 1.0, 20000.0)
    design = space.sample(gen)
    tspan = build_tspan(0.0, 1e-5, STEPS)
    interp = DesignInterpolator(design, design, float(tspan[0]), float(tspan[-1]))
    source_at = ([[0.0, 0.0]], [0.3], [1.0])

    def gaussian(g):
        mu, sigma, a = (torch.tensor(x, dtype=torch.float32, device=dev0) for x in source_at)
        return build_normal(g, mu, sigma, a)

    rollout = make_sharded_rollout(mesh, WATER, dyn.dx, dyn.dy, STEPS, 1e-5)
    _, signal = rollout(build_wave(dim, 12), tspan, interp, grid, gaussian(grid), 1000.0, dyn.pml,
                        dyn.pml.T.contiguous(), dyn.bc, float(get_dx(dim)) ** 2)
    _finite(signal, "the sharded FDTD window's signal")

    # 4. the y-sharded fused kernel on slabs, the production configuration
    n2 = max(16 * n, 64)
    dim2 = two_dim(5.0, n2, device=dev0)
    dyn2 = make_acoustic_dynamics_2d(dim2, WATER, 1.0, 20000.0)
    frollout = make_fused_sharded_rollout(mesh, n=n2, spacing=2.0 * 5.0 / (n2 - 1), dt=1e-5,
                                          c0=WATER, freq=1000.0, n_cyl=19, x_min=-5.0,
                                          radii_only=True, x_matmul=True)
    d2a = space.sample(gen)
    cyl = cyl_params(d2a, d2a, dev0).contiguous()
    _, fsignal = frollout(build_wave(dim2, 12), tspan, cyl, gaussian(build_grid(dim2)),
                          dyn2.pml[:, 0].contiguous())
    _finite(fsignal, "the fused sharded FDTD window's signal")
    return loss, losses, signal, fsignal
