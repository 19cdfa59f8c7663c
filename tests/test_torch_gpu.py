"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA card and nvcc; skips without them. It imports no JAX, so it
runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

Tolerance 1e-5 relative: kernel and plain version run the same float32
operations in the same order (the kernel is built without FMA
contraction); only sin and the energy sums round apart.
"""
import numpy as np
import pytest
import torch

from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
TOL = 1e-5


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
        assert rel(owner[1:], fk.select_owner_reference(cyl, cfg)[1:]) <= TOL
    before = dict(fk.launch_counts)
    got, want = (u, None), (u, None)
    for t0 in (2e-4, 2.1e-4):  # two chained steps
        got = fk.fused_rk4_step(got[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
        want = fk.fused_rk4_step_reference(want[0], shape, prof, cyl, owner, t0, 0.0, 1e-3, cfg)
    torch.cuda.synchronize()
    key = "fused_rk4_radii_only" if radii_only else "fused_rk4_general"
    assert fk.launch_counts[key] - before[key] == 2 * fk.STAGES
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
