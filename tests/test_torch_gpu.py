"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA card and nvcc; skips without them. It imports no JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

Tolerance 1e-5 relative: kernel and plain version run the same float32
operations in the same order (the kernel is built without FMA
contraction); only sin and the energy sums round apart. Each candidate of
the batched kernel K3 equals K1 or K2 run on it alone, bit for bit on the
state. K5, the split d/dx (`x_matmul=True`), is held to the same
tolerance against its plain version, single and batched, and each batched
K5 candidate equals K5 run on it alone, bit for bit. Every mode takes one
launch a step (`rk4_step_tiled`) in both d/dx forms, K5's split one and
K1's, K2's and K3's exact one, radii-only and general: on the whole grid
each equals its plain version bit for bit on the state, single and
batched, at sizes whose edge tiles are partial or one cell wide, the
general mode with no cylinder, 18 and 80 (more than one chunk); the
windows that drive it give the plain path's signal and re-rank costs
within 1e-6 (the energy partials are summed in another order), with
frames of their own. Two and four steps a launch (`rk4_steps_tiled`,
every whole-grid mode, single and batched, n = 33 to 700, K up to 16)
equal spc chained plain steps at the sub-step times and spc one-step
launches, bit for bit, and so do a card's slabs with a 4 spc-column halo
(K4 and K4-XM, stacked in one launch) on the whole slab, halo columns
included, each owned cell the whole grid's; the stacked rollout at two and
four steps a launch equals the one-step rollout and its plain version bit
for bit, on one card and across cards; the owner pass on those wider slabs
equals its plain version and the whole grid's columns; the wrapper
refuses a slab whose halo is not 4 columns a step of a launch and a kept
step inside a call; the default 700^2 window takes 100
one-step launches at the JAX window's sub-step times and one owner pass,
nothing else, and equals the same window at two steps a launch. On the slabs of a
y-sharded grid (K4, and K4-XM with the split d/dx) the step equals its
plain version bit for bit on the whole slab, halo columns (written 0) included, the slabs of a card stacked in
one launch equal each slab stepped alone, each owned cell equals the
whole-grid kernel's, and the sharded rollout takes one launch a card a
step; the step refuses slabs that are not consecutive, too thin or outside
the domain. The radii-only owner pass equals its plain version bit for bit
on all five planes in each form, one launch each: the whole grid and 16
candidates at sizes up to 700^2, with 0, 1, 19 and 80 cylinders and a box
that just reaches or just misses a tile's edge, and a card's 1, 2 or 4
slabs in one launch; its fields leave the 700^2 window (K5 and K2), the
16-candidate re-rank at 350^2 and the 1, 2 and 4-shard rollouts bit for
bit what the fields over all cylinders give. The
surrogate's gradient path (`shot_energy`, CEM's polish) on the card agrees
with the CPU's at narrow width to 1e-4 relative, and so does a training
step's gradient (each leaf) with the update within 2 lr; a checkpoint
taken mid-accumulation reloads on the card bit for bit and resumes to the
uninterrupted run's next update (cuDNN deterministic). Exact search: a
batched K5 step of 64 candidates at 700^2, the oracle's shape, and its
owner pass agree with their plain versions, and the step equals K5 on
each of four of them alone bit for bit; the oracle's chunked route
gives the sequential route's costs within 1e-6; the pool probe on the card
matches its CPU run. The NODE and PINN baselines from their tracked
weights at full width: the forward on the card against the CPU's, the
PINN's chunked `predict_energy` against its forward, and each loss's
float32 gradient held leaf by leaf to the CPU's and to float64 on the card
(`grad_precision.LEAF_LIMITS`). Data-parallel training (`parallel.dp`) on
two shards of one card, and across two or four cards, against one card:
two updates' losses within 1e-4 and leaves within rtol 5e-3 / atol 2e-5,
the replicas bit for bit equal; `fast_ranking()` on the card against the
float32 model and against the CPU (costs within 5e-2, the same choice),
and the bf16-conv model against float32 (rtol 0.1 / atol 0.05). The
full-field window of `env_step_full` (K2 with its owner pass, or K1) at
700^2 equals its plain route on the card bit for bit on the frames and
fields, its signal within 1e-6, its strided and resized form the
stride-1 run's. Batched episodes, each with its own reset and source shape,
through the batched exact kernel (K3 radii-only with its batched owner
pass, or K3 general) equal each episode alone through K2 or K1 bit for bit
on the frames and final states, their signals within 1e-6; the one-call
hybrid episode equals act then step a window at a time, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
TOL = 1e-5
K3 = 3  # candidates of the batched kernel


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, moving, device):
    rng = np.random.default_rng(n)
    cfg = fk.StepConfig(n=n, spacing=2.0 * 15.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                        freq=1000.0)
    ang = np.arange(6) * np.pi / 3
    pos = np.c_[5.0 + 3.5 * np.cos(ang), 3.5 * np.sin(ang)]
    pos = np.concatenate([pos, [[5.0, 0.0]]])
    r1, r2 = rng.uniform(0.4, 1.0, 7), rng.uniform(0.4, 1.0, 7)
    r1[-1] = r2[-1] = 2.0
    c = np.full(7, 1032.0)
    pos2 = pos + (np.array([0.6, -0.3]) if moving else 0.0)
    cyl = np.stack([pos[:, 0], pos[:, 1], r1, c, pos2[:, 0], pos2[:, 1], r2, c])

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    u = dev(rng.standard_normal((12, n, n)) * 1e-3)
    return cfg, dev(cyl), u, dev(rng.random((n, n))), dev(rng.random(n) * 100.0)


def rel(a, b) -> float:
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n", [37, 160])
def test_kernel_matches_plain_version(card, radii_only, n):
    cfg, cyl, u, shape, prof = _inputs(n, not radii_only, card)
    owner = None
    if radii_only:
        owner = fk.select_owner(cyl, cfg)
        assert torch.equal(owner, fk.select_owner_reference(cyl, cfg))
    before = dict(fk.launch_counts)
    got, want = (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):  # two chained steps
        got = fk.fused_rk4_step(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
        want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
    torch.cuda.synchronize()
    key = "fused_rk4_radii_only" if radii_only else "fused_rk4_general"
    # K2 and K1 take one launch a step (`rk4_step_tiled`)
    assert fk.launch_counts[key] - before[key] == 2
    for a, b in zip(got, want):
        assert rel(a, b) <= TOL


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    cfg, cyl, u, shape, prof = _inputs(32, False, card)
    with pytest.raises(ValueError, match="dtype"):
        fk.fused_rk4_step(u.double(), shape, prof, cyl, None, 0.0, 0.0, 1e-3, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_rk4_step(u.transpose(1, 2), shape, prof, cyl, None, 0.0, 0.0, 1e-3, cfg)
    with pytest.raises(ValueError, match="on cpu"):
        fk.fused_rk4_step(u, shape.cpu(), prof, cyl, None, 0.0, 0.0, 1e-3, cfg)


def _batched_inputs(n, moving, device):
    """K3 = 3 candidates, each with its own state and radii; the source
    shape and the profile are shared."""
    cfg, cyl, u, shape, prof = _inputs(n, moving, device)
    rng = np.random.default_rng(n + 1)
    scale = torch.from_numpy(rng.uniform(0.7, 1.0, (K3, 1, cyl.shape[-1])).astype(np.float32))
    cyls = cyl.expand(K3, -1, -1).clone()
    cyls[:, [2, 6]] *= scale.to(device)  # rows r1, r2
    us = torch.stack([u, u.flip(1), u.flip(2)])
    return cfg, cyls.contiguous(), us.contiguous(), shape, prof


@pytest.mark.gpu
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n", [37, 160])
def test_batched_kernel_matches_plain_version_and_single_kernel(card, radii_only, n):
    cfg, cyl, u, shape, prof = _batched_inputs(n, not radii_only, card)
    owner = None
    if radii_only:
        owner = fk.select_owner_batched(cyl, cfg)
        assert torch.equal(owner, fk.select_owner_batched_reference(cyl, cfg))
    before = dict(fk.launch_counts)
    got, want = (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):  # two chained steps
        got = fk.fused_rk4_step_batched(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
        want = fk.fused_rk4_step_batched_reference(want[0], shape, prof, cyl, owner, t0, 0.0,
                                                   1e-3, cfg)
    torch.cuda.synchronize()
    key = "fused_rk4_batched_radii_only" if radii_only else "fused_rk4_batched_general"
    # K3 takes one launch a step in both modes
    assert fk.launch_counts[key] - before[key] == 2
    assert got[0].shape == (K3, 12, n, n) and got[1].shape == (K3, 3)
    for a, b in zip(got, want):
        assert rel(a, b) <= TOL
    # each candidate's state is bit for bit what K1 or K2 gives it alone
    for b in range(K3):
        one = (u[b], None)
        for t0 in (2e-4, 2.1e-4):
            one = fk.fused_rk4_step(one[0], shape, prof, cyl[b],
                                    None if owner is None else owner[b], t0, 0.0, 1e-3, cfg)
        assert torch.equal(got[0][b], one[0])
        assert rel(got[1][b], one[1]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n", [37, 160])
def test_xmatmul_kernel_matches_plain_version(card, radii_only, n):
    cfg, cyl, u, shape, prof = _inputs(n, not radii_only, card)
    owner = fk.select_owner(cyl, cfg) if radii_only else None
    before = dict(fk.launch_counts)
    got, want, exact = (u, None), (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):  # two chained steps
        got = fk.fused_rk4_step(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg,
                                x_matmul=True)
        want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg,
                                           x_matmul=True)
        exact = fk.fused_rk4_step(exact[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
    torch.cuda.synchronize()
    key = "fused_rk4_xmatmul_" + ("radii_only" if radii_only else "general")
    # K5 takes one launch a step in both modes
    assert fk.launch_counts[key] - before[key] == 2
    for a, b in zip(got, want):
        assert rel(a, b) <= TOL
    assert not torch.equal(got[0], exact[0])  # the split form, not K1/K2


@pytest.mark.gpu
@pytest.mark.parametrize("radii_only", [True, False])
def test_batched_xmatmul_kernel_matches_plain_version_and_single_kernel(card, radii_only):
    n = 160
    cfg, cyl, u, shape, prof = _batched_inputs(n, not radii_only, card)
    owner = fk.select_owner_batched(cyl, cfg) if radii_only else None
    before = dict(fk.launch_counts)
    got, want = (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):
        got = fk.fused_rk4_step_batched(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg,
                                        x_matmul=True)
        want = fk.fused_rk4_step_batched_reference(want[0], shape, prof, cyl, owner, t0, 0.0,
                                                   1e-3, cfg, x_matmul=True)
    torch.cuda.synchronize()
    key = "fused_rk4_batched_xmatmul_" + ("radii_only" if radii_only else "general")
    assert fk.launch_counts[key] - before[key] == 2  # one launch a step
    for a, b in zip(got, want):
        assert rel(a, b) <= TOL
    for b in range(K3):  # each candidate is K5 run on it alone
        one = (u[b], None)
        for t0 in (2e-4, 2.1e-4):
            one = fk.fused_rk4_step(one[0], shape, prof, cyl[b],
                                    None if owner is None else owner[b], t0, 0.0, 1e-3, cfg,
                                    x_matmul=True)
        assert torch.equal(got[0][b], one[0])


@pytest.mark.gpu
def test_batched_owner_pass_matches_separate_owner_passes(card):
    cfg, cyl, *_ = _batched_inputs(64, False, card)
    before = dict(fk.launch_counts)
    owner = fk.select_owner_batched(cyl, cfg)
    torch.cuda.synchronize()
    assert fk.launch_counts["select_owner_batched"] - before["select_owner_batched"] == 1
    assert owner.shape == (K3, 5, 64, 64)
    for b in range(K3):
        assert torch.equal(owner[b], fk.select_owner(cyl[b], cfg))
    assert not torch.equal(owner[0], owner[1])  # each candidate has its own radii


@pytest.mark.gpu
def test_window_with_no_cylinders_runs_on_the_card(card):
    from waves_jl_tpu_torch.designs import NoDesign, build_triple_ring_design_space
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.env import env_reset, env_tspan, make_wave_env
    from waves_jl_tpu_torch.physics.fused import cyl_params, make_fused_window, step_config
    from waves_jl_tpu_torch.sources import GaussianSource

    n = 48
    dim = two_dim(15.0, n, device=card)
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                   [1.0], 1000.0)
    env = make_wave_env(dim, build_triple_ring_design_space(device=card), source,
                        resolution=(16, 16), integration_steps=10)
    cyl = cyl_params(NoDesign(), NoDesign(), env.device)
    assert cyl.shape == (8, 0) and cyl.device == env.device
    tspan = env_tspan(env, env_reset(env, torch.Generator(device=card).manual_seed(0)))
    u0 = torch.from_numpy((np.random.default_rng(5).standard_normal((12, n, n)) * 1e-3)
                          .astype(np.float32)).to(card)
    u, frames, signal = make_fused_window(env)(u0, source.shape, tspan, cyl)
    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    want, owner = u0, fk.select_owner_reference(cyl, cfg)
    for t0 in tspan[:-1]:  # the window's default, the split d/dx of K5
        want, _ = fk.fused_rk4_step_reference(want, source.shape, prof, cyl, owner, float(t0),
                                              float(tspan[0]), float(tspan[-1]), cfg,
                                              x_matmul=True)
    torch.cuda.synchronize()
    assert signal.shape == (11, 3) and bool(torch.isfinite(signal).all())
    assert rel(u, want) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
def test_sharded_kernel_matches_plain_version_and_whole_grid(card, radii_only, x_matmul):
    from waves_jl_tpu_torch.parallel import make_fused_sharded_rollout, make_mesh
    from waves_jl_tpu_torch.parallel.fused_domain import cut_slabs, shard_slabs

    n, shards, steps = 64, 4, 3
    ny = n // shards
    cfg, cyl, u, shape, prof = _inputs(n, not radii_only, card)
    tspan = np.float32(2e-4) + np.arange(steps + 1, dtype=np.float32) * np.float32(cfg.dt)
    ti, tf = float(tspan[0]), float(tspan[-1])
    owner = fk.select_owner(cyl, cfg) if radii_only else None
    whole, e_whole = fk.fused_rk4_step(u, shape, prof, cyl, owner, ti, ti, tf, cfg,
                                       x_matmul=x_matmul)
    # one K4 step on each slab, cut from the global state with its halos:
    # the whole slab bit for bit its plain version's, the halo columns 0
    slabs = shard_slabs(n, shards)
    us, shapes, owners, singles = [], [], [], []
    for k, (slab, u_k, shape_k) in enumerate(zip(slabs, cut_slabs(u, slabs, [card] * shards),
                                                 cut_slabs(shape, slabs, [card] * shards))):
        own = fk.select_owner(cyl, cfg, slab) if radii_only else None
        if radii_only:
            assert torch.equal(own, fk.select_owner_reference(cyl, cfg, slab))
        args = (u_k, shape_k, prof, cyl, own, ti, ti, tf, cfg, slab, x_matmul)
        got, want = fk.fused_rk4_step(*args), fk.fused_rk4_step_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and rel(got[1], want[1]) <= TOL
        owned = slice(fk.HALO, fk.HALO + ny)
        assert torch.equal(got[0][:, :, owned], whole[:, :, k * ny:(k + 1) * ny])
        halo = torch.ones(slab.w, dtype=torch.bool, device=card)
        halo[owned] = False
        assert bool((got[0][:, :, halo] == 0).all())
        us.append(u_k)
        shapes.append(shape_k)
        owners.append(own)
        singles.append(got)
    # the slabs stacked, one launch: each slab as stepped alone
    key = ("fused_rk4_sharded_" + ("xmatmul_" if x_matmul else "")
           + ("radii_only" if radii_only else "general"))
    before = dict(fk.launch_counts)
    stacked = fk.fused_rk4_step_slabs(torch.stack(us), torch.stack(shapes), prof, cyl,
                                      torch.stack(owners) if radii_only else None, ti, ti, tf,
                                      cfg, slabs, x_matmul)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before[key] == 1
    for k, (u_one, e_one) in enumerate(singles):
        assert torch.equal(stacked[0][k], u_one) and rel(stacked[1][k], e_one) <= 1e-6
    # the rollout over 4 shards on one card against the whole-grid kernel
    roll = make_fused_sharded_rollout(make_mesh(devices=[card] * shards), n, cfg.spacing, cfg.dt,
                                      cfg.c0, cfg.freq, cyl.shape[1], cfg.x_min, radii_only,
                                      x_matmul)
    before = dict(fk.launch_counts)
    u_sh, sig = roll(u, tspan, cyl, shape, prof)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before[key] == steps  # one launch a step for the card
    # one owner pass for the card's slabs
    assert (fk.launch_counts["select_owner_sharded"] - before["select_owner_sharded"]
            == (1 if radii_only else 0))
    want, es = u, []
    for t0 in tspan[:-1]:
        want, e = fk.fused_rk4_step(want, shape, prof, cyl, owner, float(t0), ti, tf, cfg,
                                    x_matmul=x_matmul)
        es.append(e)
    torch.cuda.synchronize()
    assert torch.equal(u_sh, want)
    assert rel(sig[1:], torch.stack(es)) <= 1e-6


@pytest.fixture
def cards():
    """2 or 4 distinct cards, as many as the machine has up to 4."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more NVIDIA cards")
    return 4 if count >= 4 else 2


@pytest.mark.gpu
@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
def test_sharded_rollouts_across_cards_equal_one_card(card, cards, radii_only, x_matmul):
    from waves_jl_tpu_torch.designs import Cylinders, DesignInterpolator
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.parallel import (make_fused_sharded_rollout, make_mesh,
                                             make_sharded_rollout)

    n, steps = 64, 3
    cfg, cyl, u, shape, prof = _inputs(n, not radii_only, card)
    tspan = np.float32(2e-4) + np.arange(steps + 1, dtype=np.float32) * np.float32(cfg.dt)
    many, one = make_mesh(cards), make_mesh(devices=[card] * cards)
    assert len(set(many.devices)) == cards

    def fused(mesh):
        return make_fused_sharded_rollout(mesh, n, cfg.spacing, cfg.dt, cfg.c0, cfg.freq,
                                          cyl.shape[1], cfg.x_min, radii_only, x_matmul)(
            u, tspan, cyl, shape, prof)

    key = ("fused_rk4_sharded_" + ("xmatmul_" if x_matmul else "")
           + ("radii_only" if radii_only else "general"))
    before = fk.launch_counts[key]
    got = fused(many)
    middle = fk.launch_counts[key]
    want = fused(one)
    torch.cuda.synchronize()
    # one launch a card a step
    assert middle - before == cards * steps and fk.launch_counts[key] - middle == steps
    assert got[0].device == want[0].device == many.devices[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def design(rows):
        return Cylinders(cyl[rows[:2]].T.contiguous(), cyl[rows[2]], cyl[rows[3]])

    interp = DesignInterpolator(design([0, 1, 2, 3]), design([4, 5, 6, 7]), float(tspan[0]),
                                float(tspan[-1]))
    grid = build_grid(two_dim(15.0, n, device=card))
    sx = prof[:, None].expand(n, n).contiguous()
    bc = torch.ones((n, n), device=card)
    bc[0], bc[-1], bc[:, 0], bc[:, -1] = 0.0, 0.0, 0.0, 0.0

    def plain(mesh):
        return make_sharded_rollout(mesh, cfg.c0, cfg.spacing, cfg.spacing, steps, cfg.dt)(
            u, tspan, interp, grid, shape, cfg.freq, sx, sx.T.contiguous(), bc,
            cfg.spacing ** 2)

    got, want = plain(many), plain(one)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_eighty_cylinders_match_plain_version(card):
    from chip_smoke import cylinder_grid

    cfg, _, u, shape, prof = _inputs(96, False, card)
    for moving in (True, False):
        cyl = torch.from_numpy(cylinder_grid(moving).astype(np.float32)).to(card)
        owner = None
        if not moving:
            owner = fk.select_owner(cyl, cfg)
            assert torch.equal(owner, fk.select_owner_reference(cyl, cfg))
            assert int((owner[0] < owner[1] ** 2).sum()) > 80  # cylinders cover cells
        got, want = (u, None), (u, None)
        for t0 in (2e-4, 2.1e-4):
            got = fk.fused_rk4_step(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
            want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, owner, t0, 0.0, 1e-3,
                                               cfg)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert rel(got[1], want[1]) <= TOL


@pytest.mark.gpu
def test_free_field_window_runs_the_general_kernel(card):
    from waves_jl_tpu_torch.designs import DesignSpace, NoDesign
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset, make_wave_env
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused
    from waves_jl_tpu_torch.sources import GaussianSource

    n, steps = 48, 10
    dim = two_dim(15.0, n, device=card)
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                   [1.0], 1000.0)
    env = make_wave_env(dim, DesignSpace(NoDesign(), NoDesign()), source, resolution=(16, 16),
                        integration_steps=steps, actions=2)
    gen = torch.Generator(device=card).manual_seed(0)
    state = env_reset(env, gen)
    step = make_env_step_fused(env)
    before = dict(fk.launch_counts)
    for _ in range(2):
        state, _ = step(state, RandomDesignPolicy(env.action_space)(gen))
    torch.cuda.synchronize()
    key = "fused_rk4_xmatmul_general"  # the env step's default: K5 with K1's rasterisation
    assert fk.launch_counts[key] - before[key] == 2 * steps  # one launch a step
    sig = state.signal
    assert bool(torch.isfinite(sig).all()) and float(sig[:, 0].max()) > 0.0
    assert torch.equal(sig[:, 0], sig[:, 1])  # tot == inc
    assert float(sig[:, 2].max()) == 0.0  # no scattered field


@pytest.mark.gpu
def test_shot_energy_gradient_matches_cpu(card):
    from waves_jl_tpu_torch.designs import build_action_space, build_triple_ring_design_space
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.utils.trees import tree_map

    rng = np.random.default_rng(9)
    shots, horizon, steps = 4, 2, 3
    obs = rng.random((16, 16, 4)).astype(np.float32)
    r = rng.uniform(-0.2, 0.2, (shots, horizon, 18)).astype(np.float32)
    t = np.broadcast_to(np.float32(1e-4) * np.arange(horizon * steps + 1, dtype=np.float32),
                        (shots, horizon * steps + 1)).copy()
    state, out = None, {}
    for dev in ("cpu", card):
        space = build_triple_ring_design_space(device=dev)
        model = AcousticEnergyModel(space, 1000.0, elements=32, h_size=16, nfreq=12,
                                    integration_steps=steps, dt=4e-5, device=dev)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        zero = build_action_space(space.low, 0.25).low
        acts = tree_map(lambda v: torch.zeros((shots, horizon, *v.shape), device=dev), zero)
        radii = torch.from_numpy(r).to(dev).requires_grad_(True)
        acts = dataclasses.replace(acts, config=dataclasses.replace(
            acts.config, cylinders=dataclasses.replace(acts.config.cylinders, r=radii)))
        e = model.shot_energy(torch.from_numpy(obs).to(dev), space.low, acts,
                              torch.from_numpy(t).to(dev))
        (g,) = torch.autograd.grad(e.sum(), radii)
        out[str(dev)] = (e.detach().cpu(), g.cpu())
    (e_cpu, g_cpu), (e_card, g_card) = out["cpu"], out[str(card)]
    assert float(g_cpu.abs().max()) > 0.0
    assert rel(e_card, e_cpu) <= 1e-4 and rel(g_card, g_cpu) <= 1e-4


def _one_launch_inputs(n, k, device):
    """Inputs of K5 radii-only: one state for k None, else k candidates,
    each with its own state and radii; owner fields from the kernel's pass."""
    cfg, cyl, u, shape, prof = _inputs(n, False, device)
    if k is None:
        return cfg, u, shape, prof, cyl, fk.select_owner(cyl, cfg)
    rng = np.random.default_rng(n + k)
    cyls = cyl.expand(k, -1, -1).clone()
    cyls[:, [2, 6]] *= torch.from_numpy(
        rng.uniform(0.7, 1.0, (k, 1, cyl.shape[-1])).astype(np.float32)).to(device)
    us = torch.from_numpy((rng.standard_normal((k, 12, n, n)) * 1e-3).astype(np.float32))
    return cfg, us.to(device), shape, prof, cyls, fk.select_owner_batched(cyls, cfg)


def _check_one_launch_step(card, n, k, x_matmul):
    """Two chained one-launch steps of the radii-only mode in the given
    d/dx form against the plain version, bit for bit on the state; each
    candidate against the single-state kernel on it."""
    cfg, u, shape, prof, cyl, owner = _one_launch_inputs(n, k, card)
    step = fk.fused_rk4_step if k is None else fk.fused_rk4_step_batched
    plain = fk.fused_rk4_step_reference if k is None else fk.fused_rk4_step_batched_reference
    key = fk._key("fused_rk4", k, None, x_matmul) + "_radii_only"
    before = dict(fk.launch_counts)
    got, want = (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):  # two chained steps
        got = step(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg, x_matmul=x_matmul)
        want = plain(want[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg, x_matmul=x_matmul)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before[key] == 2  # one launch a step
    assert fk.step_partial_rows(n) == -(-n // fk.TILE[0]) * -(-n // fk.TILE[1])
    assert torch.equal(got[0], want[0])
    assert rel(got[1], want[1]) <= 1e-6  # the energy partials sum in another order
    for b in range(k or 0):  # each candidate is the single-state kernel on it
        one = (u[b], None)
        for t0 in (2e-4, 2.1e-4):
            one = fk.fused_rk4_step(one[0], shape, prof, cyl[b], owner[b], t0, 0.0, 1e-3, cfg,
                                    x_matmul=x_matmul)
        assert torch.equal(got[0][b], one[0])


# 33 = 2 x 16 + 1 = 24 + 9: a one-row and a one-column edge tile; 45, 350 and
# 700 end in partial tiles; 48 is whole tiles
@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 1, 3, 16])
@pytest.mark.parametrize("n", [33, 45, 48, 350, 700])
def test_one_launch_step_equals_plain_version_bit_for_bit(card, n, k):
    _check_one_launch_step(card, n, k, x_matmul=True)  # K5, batched K5


@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 1, 3, 16])
@pytest.mark.parametrize("n", [33, 45, 48, 350, 700])
def test_exact_one_launch_step_equals_plain_version_bit_for_bit(card, n, k):
    _check_one_launch_step(card, n, k, x_matmul=False)  # K2, K3


def _general_inputs(n, k, n_cyl, device):
    """Inputs of the general mode: one state for k None, else k candidates,
    each with its own state and its own moving cylinders (radii scaled,
    positions shifted): none, 18 in three rings about (5, 0) that overlap
    and move in the window, or the 80 of `chip_smoke.cylinder_grid`."""
    from chip_smoke import cylinder_grid

    cfg, _, u, shape, prof = _inputs(n, True, device)
    rng = np.random.default_rng(n + n_cyl)
    if n_cyl == 0:
        cyl = np.zeros((8, 0))
    elif n_cyl == 80:
        cyl = cylinder_grid(True)
    else:
        ang = np.arange(6) * np.pi / 3
        pos = np.concatenate([np.c_[5.0 + rr * np.cos(ang + off), rr * np.sin(ang + off)]
                              for rr, off in ((1.5, 0.0), (3.0, np.pi / 6), (4.5, 0.0))])
        r1, r2 = rng.uniform(0.3, 0.9, 18), rng.uniform(0.3, 0.9, 18)
        c = np.full(18, 1032.0)
        pos2 = pos + np.array([0.6, -0.3])
        cyl = np.stack([pos[:, 0], pos[:, 1], r1, c, pos2[:, 0], pos2[:, 1], r2, c])
    if k is not None:
        cyl = np.repeat(cyl[None], k, axis=0)
        cyl[:, [2, 6]] *= rng.uniform(0.7, 1.0, (k, 1, n_cyl))
        cyl[:, [0, 1, 4, 5]] += rng.uniform(-0.5, 0.5, (k, 4, 1))
        u = torch.from_numpy((rng.standard_normal((k, 12, n, n)) * 1e-3).astype(np.float32))
    cyl = torch.from_numpy(np.ascontiguousarray(cyl, np.float32)).to(device)
    return cfg, u.to(device), shape, prof, cyl


# n as for the radii-only step; 18 cylinders fit one chunk of 64, 80 take two
@pytest.mark.gpu
@pytest.mark.parametrize("n_cyl", [0, 18, 80])
@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("k", [None, 1, 3, 16])
@pytest.mark.parametrize("n", [33, 45, 48, 350, 700])
def test_general_one_launch_step_equals_plain_version_bit_for_bit(card, n, k, x_matmul, n_cyl):
    # K1 and K3 general (exact d/dx), K5 and batched K5 general (split):
    # two chained one-launch steps against the plain version, bit for bit on
    # the state; each candidate against the single-state kernel on it
    cfg, u, shape, prof, cyl = _general_inputs(n, k, n_cyl, card)
    step = fk.fused_rk4_step if k is None else fk.fused_rk4_step_batched
    plain = fk.fused_rk4_step_reference if k is None else fk.fused_rk4_step_batched_reference
    key = fk._key("fused_rk4", k, None, x_matmul) + "_general"
    before = dict(fk.launch_counts)
    got, want = (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):  # two chained steps
        got = step(got[0], shape, prof, cyl, None, t0, 0.0, 1e-3, cfg, x_matmul=x_matmul)
        want = plain(want[0], shape, prof, cyl, None, t0, 0.0, 1e-3, cfg, x_matmul=x_matmul)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before[key] == 2  # one launch a step
    assert torch.equal(got[0], want[0])
    assert rel(got[1], want[1]) <= 1e-6  # the energy partials sum in another order
    for b in range(k or 0):
        one = (u[b], None)
        for t0 in (2e-4, 2.1e-4):
            one = fk.fused_rk4_step(one[0], shape, prof, cyl[b], None, t0, 0.0, 1e-3, cfg,
                                    x_matmul=x_matmul)
        assert torch.equal(got[0][b], one[0])


@pytest.mark.gpu
def test_slab_step_raises_on_slabs_it_does_not_take(card):
    from waves_jl_tpu_torch.parallel.fused_domain import cut_slabs, shard_slabs

    cfg, cyl, u, shape, prof = _inputs(48, True, card)
    slabs = shard_slabs(48, 4)
    us = torch.stack(cut_slabs(u, slabs, [card] * 4))
    shapes = torch.stack(cut_slabs(shape, slabs, [card] * 4))
    args = (prof, cyl, None, 2e-4, 0.0, 1e-3, cfg)
    with pytest.raises(ValueError, match="not consecutive"):
        fk.fused_rk4_step_slabs(us[[0, 2]].contiguous(), shapes[[0, 2]].contiguous(), *args,
                                [slabs[0], slabs[2]])
    # the kernel refuses what the wrapper passes on, and the refusal raises:
    # slabs of 4 owned columns, thinner than the two halos a tile reads, and
    # a slab whose owned columns pass the domain's last column
    thin = [fk.Slab(w=4 + 2 * fk.HALO, col0=k * 4 - fk.HALO) for k in range(2)]
    outside = [fk.Slab(w=slabs[0].w, col0=slabs[3].col0 + slabs[0].ny)]
    for bad in (thin, outside):
        w = bad[0].w
        with pytest.raises(RuntimeError, match="launch failed"):
            fk.fused_rk4_step_slabs(torch.zeros((len(bad), 12, 48, w), device=card),
                                    torch.zeros((len(bad), 48, w), device=card), *args, bad)


def _check_windows(card, x_matmul):
    """The env window and the re-rank rollout in the given d/dx form, one
    launch a step at the JAX package's default step times (two-step calls
    for 24 steps a window, frame segments [4, 10, 10]), against the plain
    path at the same step times: frames bit for bit, of their own, the
    input never written; signal and costs within 1e-6."""
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.env import env_reset, env_time, env_tspan, frame_segments, make_wave_env
    from waves_jl_tpu_torch.physics.fused import (cyl_params, default_steps_per_call,
                                                  make_fused_window, make_rerank_rollout,
                                                  rerank_step_times, step_config)
    from waves_jl_tpu_torch.sources import GaussianSource
    from waves_jl_tpu_torch.utils.trees import tree_map

    n, steps, k, horizon = 48, 24, 3, 2
    dim = two_dim(15.0, n, device=card)
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                   [1.0], 1000.0)
    env = make_wave_env(dim, build_triple_ring_design_space(device=card), source,
                        resolution=(16, 16), integration_steps=steps)
    cfg = step_config(env)
    prof = env.integrator.dynamics.pml[:, 0].contiguous()
    gen = torch.Generator(device=card).manual_seed(3)
    rng = np.random.default_rng(3)
    wave = torch.from_numpy((rng.standard_normal((3, 12, n, n)) * 1e-3).astype(np.float32))
    state = dataclasses.replace(env_reset(env, gen), wave=wave.to(card))
    u0, shape = state.wave[-1], state.source.shape
    untouched = u0.clone()

    # the env window: frames at the segment ends, the signal, the input kept
    tspan = env_tspan(env, state)
    nxt = env.design_space(state.design, env.action_space.sample(gen))
    cyl = cyl_params(state.design, nxt, env.device).contiguous()
    before = dict(fk.launch_counts)
    u, frames, signal = make_fused_window(env, x_matmul)(u0, shape, tspan, cyl)
    torch.cuda.synchronize()
    spc = default_steps_per_call(steps)
    assert spc == 2
    key = fk.step_key(False, x_matmul, True)
    assert fk.launch_counts[key] - before[key] == steps
    ti, tf = float(tspan[0]), float(tspan[-1])
    owner = fk.select_owner_reference(cyl, cfg)
    want, es, want_frames = u0, [], []
    for s, t0 in enumerate(fk.call_step_times(tspan[:steps:spc], spc, cfg.dt)):
        want, e = fk.fused_rk4_step_reference(want, shape, prof, cyl, owner, float(t0), ti, tf,
                                              cfg, x_matmul=x_matmul)
        es.append(e)
        if s + 1 in np.cumsum(frame_segments(steps)):
            want_frames.append(want)
    sc = u0[0] - u0[6]
    e0 = torch.stack([torch.sum(u0[0] ** 2), torch.sum(u0[6] ** 2), torch.sum(sc ** 2)])
    want_signal = torch.stack([e0, *es]) * cfg.spacing * cfg.spacing
    assert torch.equal(u0, untouched)  # the input is never written
    assert len({f.data_ptr() for f in frames} | {u0.data_ptr()}) == len(frames) + 1
    assert all(torch.equal(a, b) for a, b in zip(frames, want_frames))
    assert u is frames[-1] and len(frames) == len(want_frames)
    assert rel(signal, want_signal) <= 1e-6

    # the re-rank rollout: K candidates over `horizon` windows
    elite = env.action_space.sample(gen, batch=(k, horizon))
    t_start = env_time(env, state)
    before = dict(fk.launch_counts)
    cost = make_rerank_rollout(env, horizon, x_matmul)(state, elite, t_start)
    torch.cuda.synchronize()
    key = fk.step_key(True, x_matmul, True)  # a launch a step, at JAX's re-rank times
    assert fk.launch_counts[key] - before[key] == horizon * steps
    assert torch.equal(u0, untouched)
    f32 = np.float32
    ub = u0.expand(k, *u0.shape).contiguous()
    designs = tree_map(lambda x: x.expand(k, *x.shape), state.design)
    t_i, want_cost = f32(t_start), torch.zeros(k, device=card)
    for h in range(horizon):
        nxt = env.design_space(designs, tree_map(lambda x: x[:, h], elite))
        cyl_k = cyl_params(designs, nxt, env.device).contiguous()
        owner_k = fk.select_owner_batched_reference(cyl_k, cfg)
        tf_h = f32(t_i + f32(steps * cfg.dt))
        for ts in rerank_step_times(t_i, steps, cfg.dt):
            ub, e = fk.fused_rk4_step_batched_reference(ub, shape, prof, cyl_k, owner_k, float(ts),
                                                        float(t_i), float(tf_h), cfg, x_matmul)
            want_cost = want_cost + e[:, 2]
        designs, t_i = nxt, tf_h
    want_cost = want_cost * cfg.spacing * cfg.spacing
    assert rel(cost, want_cost) <= 1e-6
    assert int(torch.argmin(cost)) == int(torch.argmin(want_cost))


@pytest.mark.gpu
def test_windows_match_plain_path_with_frames_of_their_own(card):
    _check_windows(card, x_matmul=True)  # K5, batched K5


@pytest.mark.gpu
def test_exact_windows_match_plain_path_with_frames_of_their_own(card):
    _check_windows(card, x_matmul=False)  # K2, K3


@pytest.mark.gpu
def test_one_launch_step_raises_on_what_it_does_not_take(card):
    cfg, u, shape, prof, cyl, owner = _one_launch_inputs(32, None, card)
    args = (0.0, 0.0, 1e-3, cfg)
    with pytest.raises(ValueError, match="owner has shape"):
        fk.fused_rk4_step(u, shape, prof, cyl, owner[:4], *args, x_matmul=True)
    with pytest.raises(ValueError, match="contiguous"):
        fk.fused_rk4_step(u.transpose(1, 2), shape, prof, cyl, owner, *args, x_matmul=True)
    with pytest.raises(ValueError, match="on cpu"):
        fk.fused_rk4_step(u, shape, prof, cyl, owner.cpu(), *args, x_matmul=True)
    with pytest.raises(ValueError, match="dtype"):
        fk.fused_rk4_window(u.double(), shape, prof, cyl, owner, [0.0], 0.0, 1e-3, cfg, [0], True)
    # a launch the kernel refuses surfaces as a raise: two rows are fewer than
    # a one-sided stencil's three
    tiny = dataclasses.replace(cfg, n=2)
    for x_matmul in (True, False):
        with pytest.raises(RuntimeError, match="launch failed"):
            fk.fused_rk4_step(torch.zeros((12, 2, 2), device=card),
                              torch.zeros((2, 2), device=card), torch.zeros(2, device=card), cyl,
                              torch.zeros((5, 2, 2), device=card), 0.0, 0.0, 1e-3, tiny,
                              x_matmul=x_matmul)


@pytest.mark.gpu
def test_one_launch_step_runs_on_each_of_several_cards_across_cards(card, cards):
    # the kernel takes its shared memory by a per-device opt-in, and the
    # launches go to the state's card, not the current one
    # (each of the four instances, split and exact, radii-only and general,
    # its own, and so is each of the two- and four-step instances)
    n, k = 48, 3
    for d in range(cards):
        dev = torch.device("cuda", d)
        radii = _one_launch_inputs(n, k, dev)
        general = (*_general_inputs(n, k, 18, dev), None)
        for cfg, u, shape, prof, cyl, owner in (radii, general):
            for x_matmul in (True, False):
                for spc in (1, 2, 4):  # one step a launch, or rk4_steps_tiled's two or four
                    calls = [float(np.float32(2e-4 + c * spc * 1e-5)) for c in range(4 // spc)]
                    times = fk.call_step_times(calls, spc, cfg.dt)
                    kept, energies = fk.fused_rk4_window(u, shape, prof, cyl, owner, times, 0.0,
                                                         1e-3, cfg, [3], x_matmul,
                                                         steps_per_call=spc)
                    want, es = u, []
                    for t0 in times:
                        want, e = fk.fused_rk4_step_batched_reference(want, shape, prof, cyl,
                                                                      owner, t0, 0.0, 1e-3, cfg,
                                                                      x_matmul=x_matmul)
                        es.append(e)
                    torch.cuda.synchronize(dev)
                    assert kept[0].device == dev and torch.equal(kept[0], want)
                    assert rel(energies, torch.stack(es)) <= 1e-6


def _owner_inputs(case, n, k, device):
    """(cfg, cyl) of the owner pass: the triple ring's 19 cylinders with
    radii drawn in their boxes ("ring"), each of k candidates its own; the
    80 of `chip_smoke.cylinder_grid` ("eighty", two chunks of the kernel's
    table); none ("none"); or, on the grid of exact coordinates
    -10 + 0.25 i, one cylinder of reach 0.75 whose box starts at the last
    row and column of the first 16 x 64 tile ("edge") or just past them
    ("miss")."""
    from chip_smoke import cylinder_grid
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.physics.fused import cyl_params

    cfg = fk.StepConfig(n=n, spacing=30.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                        freq=1000.0)
    rng = np.random.default_rng(n)
    if case == "ring":
        space = build_triple_ring_design_space(device="cpu")
        cyl = cyl_params(space.low, space.high, "cpu").numpy()
        lo, hi = cyl[2].copy(), cyl[6].copy()
        cyl = np.repeat(cyl[None], k or 1, axis=0)
        cyl[:, 2] = rng.uniform(lo, hi, (k or 1, lo.shape[0]))
        cyl[:, 6] = rng.uniform(lo, hi, (k or 1, lo.shape[0]))
        cyl = cyl if k else cyl[0]
    elif case == "eighty":
        cyl = cylinder_grid(False)
    elif case == "none":
        cyl = np.zeros((8, 0))
    else:
        cfg = dataclasses.replace(cfg, spacing=0.25, x_min=-10.0)
        px = -10.0 + 15 * 0.25 + 0.75 + (0.0 if case == "edge" else 2.0 ** -8)
        py = -10.0 + 63 * 0.25 + 0.75 + (0.0 if case == "edge" else 2.0 ** -8)
        cyl = np.array([[px], [py], [0.5], [1032.0], [px], [py], [0.25], [1032.0]])
    if k and case != "ring":
        cyl = np.repeat(cyl[None], k, axis=0)
        cyl[:, [2, 6]] *= rng.uniform(0.7, 1.0, (k, 1, cyl.shape[-1]))
    return cfg, torch.from_numpy(np.ascontiguousarray(cyl, np.float32)).to(device)


OWNER_CASES = [("ring", 33), ("ring", 45), ("ring", 350), ("ring", 700), ("eighty", 96),
               ("none", 45), ("edge", 80), ("miss", 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 16])
@pytest.mark.parametrize("case,n", OWNER_CASES)
def test_owner_pass_equals_plain_version_bit_for_bit(card, case, n, k):
    # the whole grid, one design or 16 candidates: all five planes, the
    # sentinel included, in one launch
    cfg, cyl = _owner_inputs(case, n, k, card)
    key = "select_owner" if k is None else "select_owner_batched"
    before = fk.launch_counts[key]
    if k is None:
        got, want = fk.select_owner(cyl, cfg), fk.select_owner_reference(cyl, cfg)
    else:
        got, want = fk.select_owner_batched(cyl, cfg), fk.select_owner_batched_reference(cyl, cfg)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before == 1
    assert torch.equal(got, want)
    assert bool((got[..., 0, :, :] == 1e30).any())  # cells that no box holds
    if case in ("edge", "miss") and k is None:
        assert bool(got[0, 15, 63] < 1e30) == (case == "edge")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("case,n", [("ring", 48), ("ring", 700), ("eighty", 96), ("none", 48),
                                    ("edge", 80)])
def test_slab_owner_pass_takes_one_launch_for_all_slabs(card, case, n, shards):
    from waves_jl_tpu_torch.parallel.fused_domain import shard_slabs

    cfg, cyl = _owner_inputs(case, n, None, card)
    slabs = shard_slabs(n, shards)
    before = fk.launch_counts["select_owner_sharded"]
    got = fk.select_owner_slabs(cyl, cfg, slabs)
    torch.cuda.synchronize()
    assert fk.launch_counts["select_owner_sharded"] - before == 1
    assert torch.equal(got, fk.select_owner_slabs_reference(cyl, cfg, slabs))
    for slab, one in zip(slabs, got):  # each slab as its own pass gives it
        assert torch.equal(one, fk.select_owner(cyl, cfg, slab))


def _all_cylinders_fields(cyl, cfg):
    """The owner fields over all cylinders, as they were defined before the
    per-tile cull: `select_owner_reference`'s arithmetic with boxes that
    hold every cell."""
    xs, ys = fk._coords(cfg, cyl.device)
    box = torch.tensor([-np.inf, np.inf, -np.inf, np.inf], device=cyl.device)
    return fk._owner_fields(cyl, box[:, None].expand(4, cyl.shape[-1]), xs[:, None],
                            ys[None, :])


def _full_size_window(card, k, x_matmul):
    """((kept states, energies) of a 100-step window through
    `fused_rk4_window` with the kernel's owner fields, and with the fields
    over all cylinders), then the window's inputs and times: one design at
    700^2 (k None) or k candidates at 350^2, the triple ring's radii drawn
    in their boxes."""
    n = 700 if k is None else 350
    cfg, cyl = _owner_inputs("ring", n, k, card)
    _, _, u, shape, prof = _inputs(n, False, card)
    if k is not None:
        u = torch.stack([u, u.flip(1), u.flip(2), u.flip(1, 2)] * (k // 4)).contiguous()
    tspan = np.float32(2e-4) + np.arange(101, dtype=np.float32) * np.float32(cfg.dt)
    times, ti, tf = [float(x) for x in tspan[:-1]], float(tspan[0]), float(tspan[-1])
    if k is None:
        owners = (fk.select_owner(cyl, cfg), _all_cylinders_fields(cyl, cfg))
    else:
        owners = (fk.select_owner_batched(cyl, cfg),
                  torch.stack([_all_cylinders_fields(c, cfg) for c in cyl]))
    assert not torch.equal(*owners)  # they differ away from the cylinders
    runs = [fk.fused_rk4_window(u, shape, prof, cyl, own, times, ti, tf, cfg, [99], x_matmul)
            for own in owners]
    torch.cuda.synchronize()
    return runs, cfg, cyl, u, shape, prof, tspan


@pytest.mark.gpu
@pytest.mark.parametrize("x_matmul", [True, False])
def test_full_size_window_state_is_unchanged_by_the_owner_fields(card, x_matmul):
    # K5 and K2 at 700^2: bit for bit on the state and the energies
    (new, old), *_ = _full_size_window(card, None, x_matmul)
    assert torch.equal(new[0][0], old[0][0]) and torch.equal(new[1], old[1])


@pytest.mark.gpu
def test_full_size_rerank_state_is_unchanged_by_the_owner_fields(card):
    # batched K5, 16 candidates at 350^2, as the hybrid's re-rank
    (new, old), *_ = _full_size_window(card, 16, True)
    assert torch.equal(new[0][0], old[0][0]) and torch.equal(new[1], old[1])


@pytest.mark.gpu
def test_full_size_sharded_rollouts_equal_the_window_on_old_fields(card):
    # the 1, 2 and 4-shard rollouts at 700^2 (exact d/dx, one owner pass for
    # the card's slabs) against the K2 window on the fields over all cylinders
    from waves_jl_tpu_torch.parallel import make_fused_sharded_rollout, make_mesh

    (_, old), cfg, cyl, u, shape, prof, tspan = _full_size_window(card, None, False)
    for shards in (1, 2, 4):
        roll = make_fused_sharded_rollout(make_mesh(devices=[card] * shards), cfg.n, cfg.spacing,
                                          cfg.dt, cfg.c0, cfg.freq, cyl.shape[1], cfg.x_min,
                                          radii_only=True)
        before = fk.launch_counts["select_owner_sharded"]
        got, _ = roll(u, tspan, cyl, shape, prof)
        torch.cuda.synchronize()
        assert fk.launch_counts["select_owner_sharded"] - before == 1
        assert torch.equal(got, old[0][0])


def _train_setup(dev, seed=0):
    """A narrow flagship (its flax-like init from `seed`) and a batch of 3
    horizon-2 windows made with numpy, on `dev`."""
    from waves_jl_tpu_torch.designs import build_action_space, build_triple_ring_design_space
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel
    from waves_jl_tpu_torch.utils.trees import tree_map

    rng = np.random.default_rng(21)
    B, H, steps = 3, 2, 4
    space = build_triple_ring_design_space(device=dev)
    model = AcousticEnergyModel(space, 1000.0, elements=32, h_size=16, nfreq=12,
                                integration_steps=steps, dt=4e-5, seed=seed, device=dev)
    zero = build_action_space(space.low, 0.25).low
    acts = tree_map(lambda v: torch.zeros((B, H, *v.shape), device=dev), zero)
    r = torch.from_numpy(rng.uniform(-0.2, 0.2, (B, H, 18)).astype(np.float32)).to(dev)
    acts = dataclasses.replace(acts, config=dataclasses.replace(
        acts.config, cylinders=dataclasses.replace(acts.config.cylinders, r=r)))
    t = np.float32(1e-3) + np.float32(4e-5) * np.arange(H * steps + 1, dtype=np.float32)
    batch = {"s_wave": torch.from_numpy(rng.random((B, 16, 16, 4)).astype(np.float32)).to(dev),
             "s_design": tree_map(lambda v: v[None].expand(B, *v.shape).contiguous(), space.low),
             "a": acts, "t": torch.from_numpy(np.broadcast_to(t, (B, t.size)).copy()).to(dev),
             "y": torch.from_numpy(rng.uniform(0, 0.1, (B, t.size, 3)).astype(np.float32)).to(dev)}
    return model, batch


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(card):
    """The gradient of the sc-weighted loss and one Adam update: the card's
    against the CPU's, 1e-4 of each leaf's largest magnitude; the updated
    parameters within 2 lr (Adam's first step is about lr whatever the
    gradient's size)."""
    from waves_jl_tpu_torch.models.acoustic_energy_model import energy_loss
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.train import TrainConfig, make_optimizer, make_train_step

    out = {}
    for dev in ("cpu", card):
        model, batch = _train_setup(dev)
        ps = dict(model.named_parameters())
        with full_float32():
            loss = energy_loss(model, batch, sc_weight=4.0)
            grads = torch.autograd.grad(loss, list(ps.values()))
        opt = make_optimizer(TrainConfig(lr=1e-3, accumulate=1))
        step = make_train_step(lambda b, m=model: energy_loss(m, b, sc_weight=4.0), opt)
        step(model, opt.init(ps), batch)
        out[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads],
                         [p.detach().cpu() for p in model.parameters()])
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = out["cpu"], out[str(card)]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert rel(a, b) <= 1e-4
    for a, b in zip(p_card, p_cpu):
        assert float((a - b).abs().max()) <= 2e-3


@pytest.mark.gpu
def test_checkpoint_round_trip_and_resume_on_the_card(card, tmp_path):
    """3 micro-steps (accumulate 2), a checkpoint, a fresh model loaded from
    it predicting bit for bit, and one more micro-step from both equal bit
    for bit (cuDNN deterministic)."""
    from waves_jl_tpu_torch.models.acoustic_energy_model import energy_loss
    from waves_jl_tpu_torch.train import (TrainConfig, load_checkpoint, make_optimizer,
                                          make_train_step, save_checkpoint)

    torch.backends.cudnn.deterministic = True
    try:
        model, batch = _train_setup(card)
        opt = make_optimizer(TrainConfig(lr=1e-3, accumulate=2))
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(lambda b: energy_loss(model, b, sc_weight=4.0), opt)
        for _ in range(3):
            _, state, _ = step(model, state, batch)
        save_checkpoint(str(tmp_path), model, state, 1)
        fresh, _ = _train_setup(card, seed=1)
        _, fresh_state, step_no = load_checkpoint(
            str(tmp_path), fresh, opt_state_like=opt.init(dict(fresh.named_parameters())))
        assert step_no == 1 and fresh_state.mini_step == 1
        with torch.no_grad():
            assert torch.equal(fresh(batch), model(batch))
        step(model, state, batch)
        make_train_step(lambda b: energy_loss(fresh, b, sc_weight=4.0), opt)(fresh, fresh_state,
                                                                              batch)
        for a, b in zip(model.parameters(), fresh.parameters()):
            assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.gpu
def test_batched_xmatmul_step_of_64_candidates_at_700_equals_each_alone(card):
    """The oracle's shape: one batched K5 step of 64 candidates at 700^2
    (64 x 12 x 700^2 float32, 1.5 GB a state) in one launch. The owner
    pass of the 64 equals its plain version bit for bit; four of the
    candidates, first, last and two between, are held against the plain
    step on the plain owner fields within TOL, and each equals K5 run on it
    alone, bit for bit on the state."""
    n, k = 700, 64
    cfg = fk.StepConfig(n=n, spacing=2.0 * 15.0 / (n - 1), x_min=-15.0, dt=1e-5, c0=1531.0,
                        freq=1000.0)
    _, cyl1, u1, shape, prof = _inputs(n, False, card)
    gen = torch.Generator(device=card).manual_seed(3)
    scale = torch.rand((k, 1, cyl1.shape[1]), generator=gen, device=card) * 0.4 + 0.6
    cyl = cyl1[None].repeat(k, 1, 1)
    cyl[:, [2, 6], :-1] *= scale[:, :, :-1]  # each candidate's ring radii, the core kept
    u = u1[None] * (1.0 + 0.01 * torch.arange(k, device=card, dtype=torch.float32))[:, None,
                                                                                     None, None]
    owner = fk.select_owner_batched(cyl, cfg)
    owner_p = fk.select_owner_batched_reference(cyl, cfg)
    assert torch.equal(owner, owner_p)
    before = dict(fk.launch_counts)
    got, e = fk.fused_rk4_step_batched(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg,
                                       x_matmul=True)
    torch.cuda.synchronize()
    key = "fused_rk4_batched_xmatmul_radii_only"
    assert fk.launch_counts[key] - before[key] == 1
    assert got.shape == (k, 12, n, n) and e.shape == (k, 3)
    for b in (0, 21, 42, k - 1):
        want, ew = fk.fused_rk4_step_reference(u[b], shape, prof, cyl[b], owner_p[b], 2e-4, 0.0,
                                               1e-3, cfg, x_matmul=True)
        assert rel(got[b], want) <= TOL and rel(e[b], ew) <= TOL, b
        one, e1 = fk.fused_rk4_step(u[b], shape, prof, cyl[b], owner[b], 2e-4, 0.0, 1e-3, cfg,
                                    x_matmul=True)
        assert torch.equal(got[b], one), b
        assert rel(e[b], e1) <= 1e-6


def _oracle_env(card):
    """A 160^2 env on the card, and a state 10 windows (10 ms) in: the
    wavefront has reached the cloak."""
    from waves_jl_tpu_torch.env import env_reset
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused
    from waves_jl_tpu_torch.scripts.datagen import build_env

    env = build_env(160, 100, 2, card)
    gen = torch.Generator(device=card).manual_seed(1)
    state = env_reset(env, gen)
    step = make_env_step_fused(env)
    for _ in range(10):
        state, _ = step(state, env.action_space.sample(gen))
    return env, state, gen


@pytest.mark.gpu
def test_oracle_chunked_route_equals_sequential_route(card, monkeypatch):
    """`BatchedOracle` (5 shots in chunks of 3, `EXACT_CHUNK` set to 3,
    batched K5) against `OracleShooting` (each shot's windows in turn, K5)
    on the same candidates at 160^2: costs within 1e-6 relative (the window times are
    the re-rank's, within an ulp of the env step's), the same choice."""
    from waves_jl_tpu_torch.control import mpc
    from waves_jl_tpu_torch.control.mpc import (OracleShooting, compute_action_cost,
                                                make_oracle_action_fused)

    env, state, gen = _oracle_env(card)
    monkeypatch.setattr(mpc, "EXACT_CHUNK", 3)
    act, step = make_oracle_action_fused(env, horizon=2, shots=5)
    cands = act.candidates(gen)
    act.candidates = lambda generator: cands
    before = dict(fk.launch_counts)
    actions, cost = act.select(state, gen)
    torch.cuda.synchronize()
    key = "fused_rk4_batched_xmatmul_radii_only"
    assert fk.launch_counts[key] - before[key] == 2 * 2 * 100  # 2 chunks x 2 windows x 100 steps
    seq = OracleShooting(step_fn=step, horizon=2, shots=5)
    object.__setattr__(seq, "candidates", lambda env, generator: cands)
    _, info = seq(env, state, gen)
    assert float((cost - compute_action_cost(actions)).min()) > 0.0  # scattered energy
    assert rel(cost, info["cost"]) <= 1e-6
    assert int(torch.argmin(cost)) == int(info["idx"])


@pytest.mark.gpu
def test_pool_probe_on_the_card_matches_its_cpu_run(card):
    """One refined pool probe at 160^2 scored on a 130^2 grid, K = 4 and 2
    refined, on the card (batched K5) and on the CPU (its plain version)
    from the same state and draws: `y_true` within 1e-5 relative, the
    observation within 1e-5 absolute, the same advance action."""
    import dataclasses

    from waves_jl_tpu_torch.control.mpc import make_pool_probe_fused
    from waves_jl_tpu_torch.scripts.datagen import build_env
    from waves_jl_tpu_torch.utils.trees import tree_map

    env, state, gen = _oracle_env(card)
    cands = env.action_space.sample(gen, batch=(4, 2))
    noise = tree_map(lambda v: torch.randn((2, 2, *v.shape), generator=gen, device=card),
                     env.action_space.low)
    out = {}
    for dev in (card, torch.device("cpu")):
        e = build_env(160, 100, 2, dev)
        lo = build_env(130, 100, 2, dev)
        probe, _ = make_pool_probe_fused(e, K=4, horizon=2, rerank_env=lo, refine_samples=2,
                                         refine_elites=2)
        probe.candidates = lambda generator, n: tree_map(lambda v: v.to(dev), cands)
        probe.noise = lambda generator, like: tree_map(lambda v: v.to(dev), noise)
        to = lambda v: v.to(dev)  # noqa: E731
        st = dataclasses.replace(state, wave=to(state.wave), design=tree_map(to, state.design),
                                 source=tree_map(to, state.source), signal=to(state.signal))
        pool, a = probe(st, torch.Generator(device=dev))
        out[dev.type] = (tree_map(lambda v: v.cpu(), pool), a.config.cylinders.r.cpu())
    (pg, ag), (pc, ac) = out["cuda"], out["cpu"]
    assert pg["y_true"].shape == (6,) and float(pc["y_true"].min()) > 0.0
    assert rel(pg["y_true"], pc["y_true"]) <= 1e-5
    assert float((pg["s_wave"] - pc["s_wave"]).abs().max()) <= 1e-5
    assert torch.equal(ag, ac)


def _baseline_batch(dev, B: int, horizon: int, seed: int = 31):
    """B windows of `horizon` actions at the reference widths, made with
    numpy: 128^2 observations, designs and radius actions inside their
    boxes, 100 steps a window from t = 10 ms."""
    from waves_jl_tpu_torch.designs import build_action_space, build_triple_ring_design_space
    from waves_jl_tpu_torch.physics.dynamics import build_tspan
    from waves_jl_tpu_torch.utils.trees import tree_map

    rng = np.random.default_rng(seed)
    space = build_triple_ring_design_space(device=dev)
    zero = build_action_space(space.low, 0.25).low
    acts = tree_map(lambda v: torch.zeros((B, horizon, *v.shape), device=dev), zero)
    r = torch.from_numpy(rng.uniform(-0.2, 0.2, (B, horizon, 18)).astype(np.float32)).to(dev)
    acts = dataclasses.replace(acts, config=dataclasses.replace(
        acts.config, cylinders=dataclasses.replace(acts.config.cylinders, r=r)))
    t = build_tspan(1e-2, 1e-5, 100 * horizon)
    L = t.size
    return space, {
        "s_wave": torch.from_numpy((rng.standard_normal((B, 128, 128, 4)) * 0.05)
                                   .astype(np.float32)).to(dev),
        "s_design": tree_map(lambda v: v[None].expand(B, *v.shape).contiguous(), space.low),
        "a": acts, "t": torch.from_numpy(np.broadcast_to(t, (B, L)).copy()).to(dev),
        "y": torch.from_numpy(rng.uniform(0, 0.1, (B, L, 3)).astype(np.float32)).to(dev)}


def _tracked_baseline(which: str, dev):
    import os

    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.models.node import NODEEnergyModel
    from waves_jl_tpu_torch.models.pinn import WaveControlPINN
    from waves_jl_tpu_torch.train.checkpoint import load_model_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    space = build_triple_ring_design_space(device=dev)
    if which == "node":
        model = NODEEnergyModel(space, device=dev)
        path = "models/ref500_node_r4b/checkpoint_step=2040"
    else:
        model = WaveControlPINN(space, 1000.0, device=dev)
        path = "models/ref500_pinn_r4/checkpoint_step=2000"
    load_model_checkpoint(model, os.path.join(root, path))
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["node", "pinn"])
def test_tracked_baseline_on_the_card_matches_the_cpu(card, which):
    """The tracked NODE and PINN checkpoints at full width: the forward at
    horizon 1 (batch 2) on the card against the CPU's, 1e-4 of the largest
    magnitude; the loss's float32 gradient at batch 1 (`node_loss` in
    "sqrt", `WaveControlPINNLoss`) on the card against the CPU's float32
    gradient and, as a second witness, against float64 on the card, each
    leaf within its limit of its largest magnitude
    (`grad_precision.LEAF_LIMITS`: the NODE's 5e-4, the PINN's field net
    2e-2 and its other leaves 1e-3, set from readings on the card with TF32
    off and on); the PINN's `predict_energy` with time_chunk 16 against its
    forward on the card (2e-5 relative, 2e-6 absolute)."""
    from waves_jl_tpu_torch.constants import WATER
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.models.node import node_loss
    from waves_jl_tpu_torch.models.pinn import WaveControlPINNLoss
    from waves_jl_tpu_torch.scripts.grad_precision import leaves_beyond
    from waves_jl_tpu_torch.utils.trees import tree_map

    def loss_of(model):
        return ((lambda b: node_loss(model, b)) if which == "node"
                else WaveControlPINNLoss(model=model, c0=WATER))

    def grads(model, batch):
        ps = dict(model.named_parameters())
        with full_float32():
            g = torch.autograd.grad(loss_of(model)(batch), list(ps.values()))
        return {k: v.cpu().double() for k, v in zip(ps, g)}

    out = {}
    for dev in ("cpu", card):
        model = _tracked_baseline(which, dev)
        _, batch = _baseline_batch(dev, 2, 1)
        one = tree_map(lambda v: v[:1], batch)
        with torch.no_grad():
            pred = model(batch)
        out[str(dev)] = (pred.cpu(), grads(model, one))
        if dev == card:
            if which == "pinn":
                with torch.no_grad():
                    chunked = model.predict_energy(batch, time_chunk=16)
                torch.testing.assert_close(chunked, pred, rtol=2e-5, atol=2e-6)
            g64 = grads(model.double(), tree_map(
                lambda v: v.double() if v.is_floating_point() else v, one))
        del model
    (p_cpu, g_cpu), (p_card, g_card) = out["cpu"], out[str(card)]
    assert torch.isfinite(p_card).all()
    assert rel(p_card, p_cpu) <= 1e-4
    assert set(g_card) == set(g_cpu) == set(g64)
    for want in (g_cpu, g64):
        _, beyond = leaves_beyond(which, g_card, want)
        assert not beyond, beyond


def _dp_matches_one_device(devices):
    """Two micro-steps of `make_dp_train_step` over a mesh of `devices`
    against `make_train_step` on the first device, on 4 windows: the losses
    within 1e-4 relative and every leaf within rtol 5e-3 / atol 2e-5 (the
    bounds tests/test_windows_and_cem.py holds JAX's data-parallel trainer
    to), the replicas equal bit for bit."""
    from waves_jl_tpu_torch.models.acoustic_energy_model import energy_loss
    from waves_jl_tpu_torch.parallel import Replicas, make_dp_train_step, make_mesh, shard_batch
    from waves_jl_tpu_torch.train.loop import make_train_step
    from waves_jl_tpu_torch.train.optim import Adam
    from waves_jl_tpu_torch.utils.trees import tree_map

    built = []

    def replicate(dev):
        m, _ = _train_setup(dev, seed=1)
        built.append(m)
        return m, lambda b: energy_loss(m, b)

    single, batch = _train_setup(devices[0])
    batch = tree_map(lambda v: torch.cat([v, v[:1]]), batch)  # 4 windows
    model, _ = _train_setup(devices[0])
    mesh = make_mesh(devices=devices)
    replicas = Replicas(model, lambda b: energy_loss(model, b), mesh, replicate)
    step1 = make_train_step(lambda b: energy_loss(single, b), Adam(1e-3))
    step = make_dp_train_step(Adam(1e-3))
    state1, states = Adam(1e-3).init(dict(single.named_parameters())), replicas.init(Adam(1e-3))
    blocks = shard_batch(batch, mesh)
    for _ in range(2):
        _, state1, loss1 = step1(single, state1, batch)
        _, states, loss = step(replicas, states, blocks)
        assert loss.device == mesh.devices[0]
        assert abs(float(loss) - float(loss1)) <= 1e-4 * abs(float(loss1))
    for a, b in zip(model.parameters(), single.parameters()):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=2e-5)
    assert len(built) == mesh.size - 1
    for m in built:
        assert all(torch.equal(a.cpu(), b.cpu())
                   for a, b in zip(m.parameters(), model.parameters()))


@pytest.mark.gpu
def test_data_parallel_two_shards_on_one_card_match_one_device(card):
    _dp_matches_one_device(["cuda:0", "cuda:0"])


@pytest.mark.gpu
def test_data_parallel_across_cards_matches_one_card(card, cards):
    _dp_matches_one_device([f"cuda:{k}" for k in range(cards)])


@pytest.mark.gpu
def test_fast_ranking_and_bf16_convs_on_the_card(card):
    """`fast_ranking()` on the card: the windows' cumulative scattered
    energies within rtol 5e-2 / atol 1e-4 of the float32 model's and of the
    fast model's on the CPU, the same argmin; `conv_dtype=torch.bfloat16`
    within rtol 0.1 / atol 0.05 of float32; the caller's cuBLAS flags
    restored."""
    from waves_jl_tpu_torch.designs import build_triple_ring_design_space
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel

    model, batch = _train_setup(card)
    cpu_model, cpu_batch = _train_setup("cpu")
    flags = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    with torch.no_grad():
        cost32 = model(batch)[:, :, 2].sum(dim=1)
        cost = model.fast_ranking()(batch)[:, :, 2].sum(dim=1)
        cost_cpu = cpu_model.fast_ranking()(cpu_batch)[:, :, 2].sum(dim=1)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == flags
    for other in (cost32.cpu(), cost_cpu):
        torch.testing.assert_close(cost.cpu(), other, rtol=5e-2, atol=1e-4)
        assert int(torch.argmin(cost)) == int(torch.argmin(other))
    bf = AcousticEnergyModel(build_triple_ring_design_space(device=card), 1000.0, elements=32,
                             h_size=16, nfreq=12, integration_steps=4, dt=4e-5, device=card,
                             conv_dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, want = bf(batch), model(batch)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0.1, atol=0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("radii_only", [True, False])
def test_full_field_window_kernel_route_equals_plain_route(card, radii_only):
    """The full-field window (`make_env_step_full`) at 700^2 on the card, K2
    with its owner pass on the triple ring and K1 on moving cylinders,
    against its plain route on the same card: frames and the u_tot/u_inc
    fields at stride 1 bit for bit, the signal within 1e-6, one launch a
    step; and at render_size 350, time stride 10, the signal the stride-1
    run's bit for bit and the fields the resized stride-1 fields within
    1e-6. The K1 case runs 10 steps a window (its plain step is slow)."""
    from waves_jl_tpu_torch.designs import (AdjustablePositionScatterers, Cloak, Cylinders,
                                            DesignSpace, build_triple_ring_design_space)
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset, make_wave_env, resize_weights
    from waves_jl_tpu_torch.models.layers import full_float32
    from waves_jl_tpu_torch.physics.fused import make_env_step_full, radii_only_ok
    from waves_jl_tpu_torch.sources import GaussianSource

    n = 700
    steps = 100 if radii_only else 10
    dim = two_dim(15.0, n, device=card)
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                   [1.0], 1000.0)
    space = build_triple_ring_design_space(device=card)
    if not radii_only:
        def free(d, v):
            cy = d.config.cylinders
            return Cloak(AdjustablePositionScatterers(Cylinders(cy.pos + v, torch.full_like(
                cy.r, 0.6), cy.c)), d.core)

        space = DesignSpace(free(space.low, -0.5), free(space.high, 0.5))
    env = make_wave_env(dim, space, source, integration_steps=steps, actions=3)
    assert radii_only_ok(env.design_space) == radii_only
    gen = torch.Generator(device=card).manual_seed(0)
    policy = RandomDesignPolicy(env.action_space)
    kernel, plain = make_env_step_full(env), make_env_step_full(env, plain=True)
    state, _ = kernel(env_reset(env, gen), policy(gen))  # a wave to step
    action = policy(gen)
    fk.reset_launch_counts()
    got, info = kernel(state, action)
    torch.cuda.synchronize()
    key = "fused_rk4_radii_only" if radii_only else "fused_rk4_general"
    assert fk.launch_counts[key] == steps
    assert fk.launch_counts["select_owner"] == int(radii_only)
    want, want_info = plain(state, action)
    for a, b in ((got.wave, want.wave), (info["u_tot"], want_info["u_tot"]),
                 (info["u_inc"], want_info["u_inc"])):
        assert torch.equal(a, b)
    assert rel(got.signal, want.signal) <= 1e-6
    small, small_info = kernel(state, action, render_size=350, time_stride=10)
    assert torch.equal(small.signal, got.signal)
    assert small_info["u_tot"].shape == (steps // 10 + 1, 350, 350)
    w = torch.from_numpy(resize_weights(n, 350)).to(card)
    with full_float32():
        resized = w @ info["u_tot"][::10] @ w.T
    assert rel(small_info["u_tot"], resized) <= 1e-6


def _card_env(card, n, steps, radii_only=True, actions=2):
    """The triple-ring env on the card, or its cylinders free to move."""
    from waves_jl_tpu_torch.designs import (AdjustablePositionScatterers, Cloak, Cylinders,
                                            DesignSpace, build_triple_ring_design_space)
    from waves_jl_tpu_torch.dims import build_grid, two_dim
    from waves_jl_tpu_torch.env import make_wave_env
    from waves_jl_tpu_torch.sources import GaussianSource

    dim = two_dim(15.0, n, device=card)
    source = GaussianSource.create(build_grid(dim), [[-10.0, -10.0]], [[-10.0, 10.0]], [0.3],
                                   [1.0], 1000.0)
    space = build_triple_ring_design_space(device=card)
    if not radii_only:
        def free(d, v):
            cy = d.config.cylinders
            return Cloak(AdjustablePositionScatterers(Cylinders(cy.pos + v, torch.full_like(
                cy.r, 0.6), cy.c)), d.core)

        space = DesignSpace(free(space.low, -0.5), free(space.high, 0.5))
    return make_wave_env(dim, space, source, resolution=(16, 16), integration_steps=steps,
                         actions=actions)


@pytest.mark.gpu
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("n", [97, 350])
def test_batched_episodes_equal_each_episode_alone_through_the_single_kernel(card, n,
                                                                             radii_only):
    """K episodes, each with its own reset (source shape included), through
    the batched exact kernel (K3, one launch a step, a batched owner pass a
    window radii-only) against each alone through K2 or K1: frames and
    final states bit for bit, signals within 1e-6."""
    from waves_jl_tpu_torch.data import make_episode_batch_fused
    from waves_jl_tpu_torch.env import RandomDesignPolicy, env_reset
    from waves_jl_tpu_torch.physics.fused import make_env_step_fused
    from waves_jl_tpu_torch.utils.trees import tree_index, tree_stack

    k, steps = 3, 20
    env = _card_env(card, n, steps, radii_only)
    gen = torch.Generator(device=card).manual_seed(1)
    policy = RandomDesignPolicy(env.action_space)
    states = [env_reset(env, gen) for _ in range(k)]
    assert not torch.equal(states[0].source.shape, states[1].source.shape)
    actions = tree_stack([tree_stack([policy(gen) for _ in range(env.actions)])
                          for _ in range(k)])
    fk.reset_launch_counts()
    final, eps = make_episode_batch_fused(env)(states, actions)
    torch.cuda.synchronize()
    mode = "radii_only" if radii_only else "general"
    assert fk.launch_counts[f"fused_rk4_batched_{mode}"] == env.actions * steps
    assert fk.launch_counts["select_owner_batched"] == (env.actions if radii_only else 0)
    assert fk.launch_counts[f"fused_rk4_{mode}"] == 0
    # the single-state exact window at one step a call, the tspan times of
    # JAX's vmapped env_step, which batched datagen takes
    step = make_env_step_fused(env, x_matmul=False, steps_per_call=1)
    for b, st in enumerate(states):
        for i in range(env.actions):
            st, _ = step(st, tree_index(tree_index(actions, b), i))
            assert rel(eps.y[b, i], st.signal) <= 1e-6
        assert torch.equal(final.wave[b], st.wave)
    assert float(eps.y[..., 0].max()) > 0.0


@pytest.mark.gpu
def test_fused_hybrid_episode_equals_the_per_action_loop(card):
    """The one-call hybrid episode (batched re-rank, batched K5) against act
    then step a window at a time through the sequential re-rank (K
    rollouts in turn through K5) from the same generator: the same
    choices, so signals and final state bit for bit, and the chosen costs
    within 1e-5 relative, with two exact rounds on a coarser re-rank
    grid."""
    from waves_jl_tpu_torch.control import make_hybrid_action_fused, make_hybrid_episode_fused
    from waves_jl_tpu_torch.env import env_reset
    from waves_jl_tpu_torch.models.acoustic_energy_model import AcousticEnergyModel

    env, env_lo = _card_env(card, 64, 16), _card_env(card, 32, 16)
    torch.manual_seed(0)
    model = AcousticEnergyModel(env.design_space, 1000.0, elements=32, h_size=16, nfreq=12,
                                integration_steps=4, dt=4e-5, device=card)
    kw = dict(horizon=2, shots=16, topk=4, alpha=1.0, rerank_env=env_lo, exact_rounds=2,
              exact_elites=2)
    state = env_reset(env, torch.Generator(device=card).manual_seed(2))
    final, signals, costs = make_hybrid_episode_fused(env, model, **kw)(
        state, torch.Generator(device=card).manual_seed(3))
    act, step = make_hybrid_action_fused(env, model, batched=False, **kw)
    gen, s, sigs, cs = torch.Generator(device=card).manual_seed(3), state, [], []
    for _ in range(env.actions):
        a, c = act(s, gen)
        s, _ = step(s, a)
        sigs.append(s.signal)
        cs.append(c)
    assert torch.equal(signals, torch.stack(sigs))
    assert rel(costs, torch.stack(cs)) <= 1e-5
    assert torch.equal(final.wave, s.wave)
    assert bool(torch.isfinite(signals).all())


def _multi_inputs(n, k, general, device):
    """Inputs of the two- and four-step launches: the radii-only mode's
    (the triple ring's hexagon, owner fields from the kernel's pass), or the
    general mode's 18 moving cylinders; one state for k None, else k
    candidates."""
    if general:
        return (*_general_inputs(n, k, 18, device), None)
    return _one_launch_inputs(n, k, device)


# 33 = 2 x 16 + 1 = 24 + 9: a one-row and a one-column edge tile; 37 and 700
# end in partial tiles; 160 is whole tile rows; n = 33 and 37 are narrower
# than the 48 x 56 region of four steps
@pytest.mark.gpu
@pytest.mark.parametrize("general", [False, True], ids=["radii_only", "general"])
@pytest.mark.parametrize("x_matmul", [True, False], ids=["split", "exact"])
@pytest.mark.parametrize("spc", [2, 4])
@pytest.mark.parametrize("k", [None, 3, 16])
@pytest.mark.parametrize("n", [33, 37, 160, 700])
def test_multi_step_launch_equals_plain_steps_bit_for_bit(card, n, k, spc, x_matmul, general):
    """`rk4_steps_tiled<XM, GENERAL, SPC>`: spc steps in one launch against
    spc chained plain steps at the sub-step times (`substep_times`), bit
    for bit on the state, the energies (spc, 3) a state within 1e-6; and
    against spc one-step launches at those times, bit for bit."""
    cfg, u, shape, prof, cyl, owner = _multi_inputs(n, k, general, card)
    step = fk.fused_rk4_step if k is None else fk.fused_rk4_step_batched
    plain = fk.fused_rk4_step_reference if k is None else fk.fused_rk4_step_batched_reference
    key = fk.step_key(k is not None, x_matmul, not general, spc)
    before = dict(fk.launch_counts)
    got = step(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg, x_matmul=x_matmul,
               steps_per_call=spc)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before[key] == 1  # spc steps, one launch
    want = plain(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg, x_matmul=x_matmul,
                 steps_per_call=spc)
    assert tuple(got[1].shape) == tuple(want[1].shape) == ((spc, 3) if k is None
                                                             else (k, spc, 3))
    assert torch.equal(got[0], want[0])
    assert rel(got[1], want[1]) <= 1e-6  # the energy partials sum in another order
    one = u
    for ts in fk.substep_times(2e-4, spc, cfg.dt):
        one, _ = step(one, shape, prof, cyl, owner, float(ts), 0.0, 1e-3, cfg, x_matmul=x_matmul)
    assert torch.equal(got[0], one)


@pytest.mark.gpu
def test_multi_step_launch_raises_on_what_it_does_not_take(card):
    from waves_jl_tpu_torch.parallel.fused_domain import cut_slabs, shard_slabs

    cfg, u, shape, prof, cyl, owner = _one_launch_inputs(48, None, card)
    slabs = shard_slabs(48, 4)
    u_slab = cut_slabs(u, slabs, [card] * 4)[0]
    shape_slab = cut_slabs(shape, slabs, [card] * 4)[0]
    owner_slab = fk.select_owner(cyl, cfg, slabs[0])
    # a slab's halo is 4 columns a step of a launch: a 4-column one takes one
    with pytest.raises(ValueError, match="takes steps_per_call 1, not 2"):
        fk.fused_rk4_step(u_slab, shape_slab, prof, cyl, owner_slab, 2e-4, 0.0, 1e-3, cfg,
                          slab=slabs[0], steps_per_call=2)
    # the kernel refuses what the wrapper passes on: slabs of 12 owned
    # columns at two steps a launch, thinner than their two 8-column halos
    thin = [fk.Slab(w=12 + 16, col0=k * 12 - 8, halo=8) for k in range(4)]
    with pytest.raises(RuntimeError, match="launch failed"):
        fk.fused_rk4_step_slabs(torch.zeros((4, 12, 48, 28), device=card),
                                torch.zeros((4, 48, 28), device=card), prof, cyl, None, 2e-4,
                                0.0, 1e-3, cfg, thin, steps_per_call=2)
    with pytest.raises(ValueError, match="is not one of"):
        fk.fused_rk4_step(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg, steps_per_call=3)
    times = fk.call_step_times([2e-4, float(np.float32(2.2e-4))], 2, cfg.dt)
    with pytest.raises(ValueError, match="last of a call"):  # a kept step inside a call
        fk.fused_rk4_window(u, shape, prof, cyl, owner, times, 0.0, 1e-3, cfg, [2], True,
                            steps_per_call=2)
    with pytest.raises(ValueError, match="fields_every"):
        fk.fused_rk4_window(u, shape, prof, cyl, owner, times, 0.0, 1e-3, cfg, [3], True,
                            fields_every=1, steps_per_call=2)
    with pytest.raises(ValueError, match="sub-step times"):
        fk.fused_rk4_window(u, shape, prof, cyl, owner, [2e-4, 2.2e-4, 2.4e-4, 2.6e-4], 0.0,
                            1e-3, cfg, [3], True, steps_per_call=2)


@pytest.mark.gpu
def test_default_window_takes_one_step_a_launch_at_jax_times(card):
    """The default window at 700^2 (100 steps, frame segments [80, 10, 10])
    launches the one-step K5 radii-only instance 100 times, at the JAX
    window's sub-step times, and the owner pass once, and nothing else; its
    frames equal the plain route's and those of the same window at two
    steps a launch (50 launches of the two-step instance) bit for bit, its
    signal within 1e-6 of both."""
    from waves_jl_tpu_torch.env import env_reset, env_tspan
    from waves_jl_tpu_torch.physics.fused import cyl_params, make_fused_window
    from waves_jl_tpu_torch.scripts.datagen import build_env

    env = build_env(700, 100, 2, card)
    gen = torch.Generator(device=card).manual_seed(4)
    state = env_reset(env, gen)
    u0 = torch.from_numpy((np.random.default_rng(4).standard_normal((12, 700, 700)) * 1e-3)
                          .astype(np.float32)).to(card)
    nxt = env.design_space(state.design, env.action_space.sample(gen))
    cyl = cyl_params(state.design, nxt, env.device).contiguous()
    tspan = env_tspan(env, state)
    fk.reset_launch_counts()
    u, frames, signal = make_fused_window(env)(u0, state.source.shape, tspan, cyl)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fk.launch_counts.items() if v}
    assert counts == {"fused_rk4_xmatmul_radii_only": 100, "select_owner": 1}
    fk.reset_launch_counts()
    _, mframes, msignal = make_fused_window(env, steps_per_call=2)(u0, state.source.shape, tspan,
                                                                   cyl)
    torch.cuda.synchronize()
    counts = {k: v for k, v in fk.launch_counts.items() if v}
    assert counts == {"fused_rk4_xmatmul_radii_only_spc2": 50, "select_owner": 1}
    fk.reset_launch_counts()
    pu, pframes, psignal = make_fused_window(env, plain=True)(u0, state.source.shape, tspan, cyl)
    assert all(v == 0 for v in fk.launch_counts.values())
    assert all(torch.equal(a, b) for a, b in zip(frames, pframes)) and len(frames) == 3
    assert all(torch.equal(a, b) for a, b in zip(frames, mframes))
    assert rel(signal, psignal) <= 1e-6 and rel(msignal, psignal) <= 1e-6


# n, shards, spc: 48 in 3 of 16 columns, the thinnest at two steps; 50 in 2
# of 25, a one-cell tile on the domain's last column; 64 in 2 of 32, the
# thinnest at four steps; 700 in 4 of 175, the main path's
SLAB_SPC_CASES = [(48, 3, 2), (50, 2, 2), (700, 4, 2), (64, 2, 4), (700, 4, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("general", [False, True], ids=["radii_only", "general"])
@pytest.mark.parametrize("x_matmul", [True, False], ids=["split", "exact"])
@pytest.mark.parametrize("n,shards,spc", SLAB_SPC_CASES)
def test_slab_multi_step_launch_equals_plain_version_bit_for_bit(card, n, shards, spc, x_matmul,
                                                                 general):
    """`rk4_steps_tiled<XM, GENERAL, SPC, true>`: a card's slabs with a
    4 spc-column halo, stacked, spc steps in one launch, against the plain
    version bit for bit on the whole slabs (halo columns 0 included), the
    energies (S, spc, 3) within 1e-6; each owned cell the whole grid's
    multi-step launch's, bit for bit; the owner pass on those slabs its
    plain version's."""
    from waves_jl_tpu_torch.parallel.fused_domain import cut_slabs, shard_slabs

    cfg, u, shape, prof, cyl, owner = _multi_inputs(n, None, general, card)
    slabs = shard_slabs(n, shards, fk.HALO * spc)
    us = torch.stack(cut_slabs(u, slabs, [card] * shards))
    shapes = torch.stack(cut_slabs(shape, slabs, [card] * shards))
    owners = None if general else fk.select_owner_slabs(cyl, cfg, slabs)
    if owners is not None:
        assert torch.equal(owners, fk.select_owner_slabs_reference(cyl, cfg, slabs))
    key = fk.step_key(False, x_matmul, not general, spc, sharded=True)
    before = fk.launch_counts[key]
    args = (us, shapes, prof, cyl, owners, 2e-4, 0.0, 1e-3, cfg, slabs, x_matmul, spc)
    got = fk.fused_rk4_step_slabs(*args)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before == 1  # spc steps of every slab, one launch
    want = fk.fused_rk4_step_slabs_reference(*args)
    assert tuple(got[1].shape) == tuple(want[1].shape) == (shards, spc, 3)
    assert torch.equal(got[0], want[0])
    assert rel(got[1], want[1]) <= 1e-6
    whole = fk.fused_rk4_step(u, shape, prof, cyl, owner, 2e-4, 0.0, 1e-3, cfg,
                              x_matmul=x_matmul, steps_per_call=spc)
    h, ny = slabs[0].halo, slabs[0].ny
    for k in range(shards):
        assert torch.equal(got[0][k][:, :, h:h + ny], whole[0][:, :, k * ny:(k + 1) * ny])
        assert bool((got[0][k][:, :, :h] == 0).all() and (got[0][k][:, :, h + ny:] == 0).all())
    assert rel(got[1].sum(dim=0), whole[1]) <= 1e-6


def _call_tspan(spc, calls, dt):
    """(calls spc + 1,) float32 times whose steps are `calls` calls of spc
    steps at their sub-step times, from 2e-4."""
    starts = [float(np.float32(2e-4) + np.float32(c * spc * dt)) for c in range(calls)]
    times = fk.call_step_times(starts, spc, dt)
    return np.array(times + [float(np.float32(times[-1]) + np.float32(dt))], np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
@pytest.mark.parametrize("spc", [2, 4])
def test_stacked_rollout_at_steps_per_call_equals_one_step_a_launch(card, spc, radii_only,
                                                                    x_matmul):
    """`build_stacked_rollout(..., steps_per_call=spc)` on 4 shards of one
    card: one launch a call of spc steps and one owner pass, the state bit
    for bit the one-step rollout's at the same step times and its plain
    version's, the signal within 1e-6."""
    from waves_jl_tpu_torch.parallel import make_mesh
    from waves_jl_tpu_torch.parallel.fused_domain import build_rollout, build_stacked_rollout

    n, shards, calls = 128, 4, 3
    cfg, cyl, u, shape, prof = _inputs(n, not radii_only, card)
    tspan = _call_tspan(spc, calls, cfg.dt)
    mesh = make_mesh(devices=[card] * shards)
    key = fk.step_key(False, x_matmul, radii_only, spc, sharded=True)
    before = dict(fk.launch_counts)
    got = build_stacked_rollout(mesh, cfg, cyl.shape[1], radii_only, x_matmul, spc)(
        u, tspan, cyl, shape, prof)
    torch.cuda.synchronize()
    assert fk.launch_counts[key] - before[key] == calls
    assert (fk.launch_counts["select_owner_sharded"] - before["select_owner_sharded"]
            == int(radii_only))
    one = build_stacked_rollout(mesh, cfg, cyl.shape[1], radii_only, x_matmul)(
        u, tspan, cyl, shape, prof)
    plain = build_rollout(mesh, cfg, cyl.shape[1], radii_only, fk.fused_rk4_step_reference,
                          fk.select_owner_reference, x_matmul, spc)(u, tspan, cyl, shape, prof)
    assert got[1].shape == (calls * spc + 1, 3)
    assert torch.equal(got[0], one[0]) and torch.equal(got[0], plain[0])
    assert not torch.equal(got[0], u)
    assert rel(got[1], one[1]) <= 1e-6 and rel(got[1], plain[1]) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("x_matmul", [False, True])
@pytest.mark.parametrize("radii_only", [True, False])
def test_two_step_sharded_rollout_across_cards_equals_one_card(card, cards, radii_only,
                                                               x_matmul):
    """The stacked rollout at two steps a launch, one shard a card on 2 or
    4 cards, against the same shards on one card: one launch a card a call,
    the state and signal bit for bit."""
    from waves_jl_tpu_torch.parallel import make_mesh
    from waves_jl_tpu_torch.parallel.fused_domain import build_stacked_rollout

    n, calls = 64, 3
    cfg, cyl, u, shape, prof = _inputs(n, not radii_only, card)
    tspan = _call_tspan(2, calls, cfg.dt)
    many, one = make_mesh(cards), make_mesh(devices=[card] * cards)
    assert len(set(many.devices)) == cards
    key = fk.step_key(False, x_matmul, radii_only, 2, sharded=True)

    def roll(mesh):
        return build_stacked_rollout(mesh, cfg, cyl.shape[1], radii_only, x_matmul, 2)(
            u, tspan, cyl, shape, prof)

    before = fk.launch_counts[key]
    got = roll(many)
    middle = fk.launch_counts[key]
    want = roll(one)
    torch.cuda.synchronize()
    assert middle - before == cards * calls and fk.launch_counts[key] - middle == calls
    assert got[0].device == want[0].device == many.devices[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [8, 16])
@pytest.mark.parametrize("case,n,shards", [("ring", 64, 2), ("ring", 700, 4), ("eighty", 96, 3),
                                           ("edge", 80, 2)])
def test_wide_slab_owner_pass_equals_the_whole_grid_columns(card, case, n, shards, halo):
    """The owner pass on slabs with an 8- or 16-column halo, in one launch:
    its plain version bit for bit, and each slab's columns inside the domain
    the whole grid's fields there, halo columns included (slab z's first
    column lies at col0 + z (w - 2 halo))."""
    from waves_jl_tpu_torch.parallel.fused_domain import shard_slabs

    cfg, cyl = _owner_inputs(case, n, None, card)
    slabs = shard_slabs(n, shards, halo)
    got = fk.select_owner_slabs(cyl, cfg, slabs)
    whole = fk.select_owner(cyl, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.select_owner_slabs_reference(cyl, cfg, slabs))
    for slab, one in zip(slabs, got):
        lo, hi = max(slab.col0, 0), min(slab.col0 + slab.w, n)
        assert torch.equal(one[:, :, lo - slab.col0:hi - slab.col0], whole[:, :, lo:hi])
