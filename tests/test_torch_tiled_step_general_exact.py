"""The one-launch step's general mode with the exact d/dx, on the CPU.

`rk4_step_tiled<XM=false, GENERAL=true>` (csrc/fused_rk4.cu) takes K1 and
K3 general (`x_matmul=False`) in one launch a step, rasterising on each
block's region only the cylinders whose box at the stage's time meets it.
`fused_rk4_step_tiled_reference(..., x_matmul=False, cyl=...)` decomposes
and culls the step as the kernel does, in plain PyTorch with the exact
`dx_edge_aware`; it is held, with the cases of
tests/test_torch_tiled_step_general.py (moving cylinders, one on a tile
corner and one crossing tile edges, no cylinder, 80 cylinders):

* against the whole-grid plain general step `fused_rk4_step_reference(...,
  owner=None, x_matmul=False)`, bit for bit on the state over two chained
  steps, at n = 45 and 48 with the kernel's tiles and with tiles that leave
  partial and one-cell tiles on the edges; energies within 1e-6;
* for each of K = 3 candidates with cylinders of their own, against the
  batched plain step, bit for bit;
* against the Pallas kernel in interpret mode with `x_matmul=False,
  radii_only=False` and moving cylinders, two steps a call, within 1e-6
  relative on the state and the energies (tests/test_torch_fused.py's
  tolerance for the exact mode).

The CUDA kernel runs only on a card: tests/test_torch_gpu.py holds it
against the plain version there, bit for bit.
"""
import pytest
import torch
from test_torch_tiled_step import CASES
from test_torch_tiled_step_general import (CYLINDERS, check_against_pallas, check_against_plain,
                                           check_candidates)

from waves_jl_tpu_torch.ops import fused_rk4 as fk

torch.set_num_threads(1)
TOL = 1e-6  # against Pallas interpret, state and energies (tests/test_torch_fused.py)


@pytest.mark.parametrize("which", CYLINDERS)
@pytest.mark.parametrize("n,tile", CASES)
def test_exact_general_tiled_step_equals_whole_grid_plain_step(n, tile, which):
    check_against_plain(n, tile, which, x_matmul=False)


@pytest.mark.parametrize("n,tile", [(45, fk.TILE), (48, (13, 10))])
def test_exact_general_tiled_step_of_each_candidate_equals_batched_plain_step(n, tile):
    check_candidates(n, tile, x_matmul=False)


def test_exact_general_tiled_step_matches_pallas_exact_mode():
    check_against_pallas(False, TOL, TOL)
