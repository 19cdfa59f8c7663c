"""The port's counterparts of the JAX package's entry points
(`waves_jl_tpu_torch/entry_points.py` against `__graft_entry__.py`), on the
CPU:

- `entry()`: JAX's flagship forward at its own parameters and batch
  against the port's forward with those parameters carried across by
  `from_jax_params`, within 1e-4 relative (the flagship's tolerance); the
  port's own batch has JAX's keys, shapes and dtypes, its times JAX's, and
  its draws lie in the design and action boxes;
- `dryrun_multichip(2, device="cpu")` runs its four parts on two CPU
  shards, every result finite and of `__graft_entry__.py`'s shape, and launches
  no kernel;
- at the default device="cuda" without a card both raise, and neither
  falls back to the CPU.
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_train_model import rel, to_port_batch

import __graft_entry__ as graft
from waves_jl_tpu_torch import entry_points as ep
from waves_jl_tpu_torch.models.convert import from_jax_params
from waves_jl_tpu_torch.ops import fused_rk4 as fk
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)
TOL = 1e-4


def _shapes(tree) -> list:
    return [(tuple(np.shape(x)), str(np.asarray(x).dtype)) for x in tree]


def test_entry_forward_matches_jax_entry():
    fn_j, (params, batch_j) = graft.entry()
    want = np.asarray(fn_j(params, batch_j))
    fn, (model, batch) = ep.entry(device="cpu")
    assert set(batch) == set(batch_j)
    for k in batch:  # the port's own batch is JAX's in shape and dtype
        assert _shapes(tree_leaves(batch[k])) == _shapes(jax.tree_util.tree_leaves(batch_j[k])), k
    np.testing.assert_array_equal(batch["t"].numpy(), np.asarray(batch_j["t"]))
    space = model.design_space
    for x, lo, hi in zip(tree_leaves(batch["s_design"]), tree_leaves(space.low),
                         tree_leaves(space.high)):
        assert bool(((x >= lo) & (x <= hi)).all())
    assert float(max(x.abs().max() for x in tree_leaves(batch["a"]))) <= 0.25
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                          expected=model.state_dict()))
    with torch.no_grad():
        got = fn(model, to_port_batch(batch_j)).numpy()
    assert got.shape == want.shape == (2, 26, 3)
    assert rel(got, want) <= TOL


def test_dryrun_multichip_runs_on_cpu_shards():
    fk.reset_launch_counts()
    loss, losses, signal, fsignal = ep.dryrun_multichip(2, device="cpu")
    assert loss.shape == () and losses.shape == (2,)
    assert signal.shape == fsignal.shape == (ep.STEPS + 1, 3)
    for x in (loss, losses, signal, fsignal):
        assert x.device.type == "cpu" and bool(torch.isfinite(x).all())
    assert float(signal[-1, 0]) > 0.0 and float(fsignal[-1, 0]) > 0.0  # the sources drove both
    assert all(v == 0 for v in fk.launch_counts.values())  # the plain paths alone


@pytest.mark.parametrize("run", [ep.entry, lambda: ep.dryrun_multichip(2)],
                         ids=["entry", "dryrun_multichip"])
def test_entry_points_raise_without_a_card(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        run()
