"""The port's debug and profiling scopes and its 2-D mesh, on the CPU.

* `debug_nans` raises `FloatingPointError` naming the ATen op that produced
  a NaN, lets finite work through, can be switched off inside an enclosing
  scope, and restores the previous setting on exit (on an error too), as
  JAX's `jax_debug_nans` scope does.
* `assert_finite` names the leaf's path (`jax.tree_util.keystr`'s form);
  `check_finite` warns and hands its value back.
* `profile_trace(None)` does nothing; `profile_trace(dir)` writes a Chrome
  trace of the CPU ops run inside it.
* `make_mesh_2d` and `replicated` over named CPU devices.
"""
import json
import os

import pytest
import torch

from waves_jl_tpu_torch.designs import build_triple_ring_design_space
from waves_jl_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, replicated
from waves_jl_tpu_torch.utils.debug import assert_finite, check_finite, debug_nans
from waves_jl_tpu_torch.utils.logging import profile_trace
from waves_jl_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)


def test_debug_nans_raises_naming_the_op_and_restores_its_setting():
    x = torch.tensor([1.0, 0.0, -1.0])
    assert torch.isnan(torch.log(x)).any()  # no trap outside the scope
    with debug_nans():
        y = torch.sqrt(x + 1.0) * 2.0  # finite work passes
        assert torch.isfinite(y).all()
        with pytest.raises(FloatingPointError, match=r"aten\.div"):
            x / torch.zeros(3)  # 0 / 0
        with debug_nans(False):
            assert torch.isnan(torch.log(x)).any()  # switched off in here
            with debug_nans():
                with pytest.raises(FloatingPointError, match=r"aten\.log"):
                    torch.log(x)
            assert torch.isnan(torch.log(x)).any()  # the inner scope restored "off"
        with pytest.raises(FloatingPointError, match=r"aten\.log"):
            torch.log(x)  # and this one "on"
    assert torch.isnan(torch.log(x)).any()  # the trap is gone


def test_debug_nans_restores_its_setting_when_the_body_raises():
    with pytest.raises(FloatingPointError):
        with debug_nans():
            torch.log(torch.tensor([-1.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).any()


def test_assert_finite_names_the_leaf_and_check_finite_warns(capsys):
    space = build_triple_ring_design_space(device="cpu")
    design = space.low
    assert_finite({"design": design, "steps": [torch.ones(2)]}, "batch")
    bad = {"design": design, "steps": [torch.ones(2), torch.tensor([1.0, float("inf")])]}
    with pytest.raises(FloatingPointError, match=r"non-finite values in batch\['steps'\]\[1\]"):
        assert_finite(bad, "batch")
    r = design.config.cylinders.r.clone()
    r[3] = float("nan")
    nan_design = type(design)(config=type(design.config)(
        cylinders=type(design.config.cylinders)(pos=design.config.cylinders.pos, r=r,
                                                c=design.config.cylinders.c)), core=design.core)
    with pytest.raises(FloatingPointError, match=r"non-finite values in s\.config\.cylinders\.r"):
        assert_finite(nan_design, "s")
    v = torch.tensor([1.0, float("nan")])
    assert check_finite(v, "loss") is v
    assert "WARNING: non-finite loss" in capsys.readouterr().out
    assert check_finite(torch.ones(2), "loss") is not None
    assert capsys.readouterr().out == ""


def test_profile_trace_is_a_no_op_without_a_directory_and_writes_a_trace(tmp_path):
    with profile_trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_mesh_2d_and_replicated_on_named_cpu_devices():
    mesh = make_mesh_2d((2, 3), devices=["cpu"] * 6)
    assert mesh.shape == (2, 3) and mesh.axis_names == ("data", "space") and mesh.size == 6
    assert all(d.type == "cpu" for d in mesh.devices)
    mesh = make_mesh_2d((2, 2), axis_names=("a", "b"), devices=["cpu"] * 4)
    assert mesh.axis_names == ("a", "b")
    with pytest.raises(ValueError, match="cannot hold"):
        make_mesh_2d((2, 2), devices=["cpu"] * 3)
    assert make_mesh(devices=["cpu"] * 2).shape == (2,)  # 1-D meshes keep their form
    tree = {"w": torch.arange(6.0).reshape(2, 3), "design": build_triple_ring_design_space(
        device="cpu").low}
    copies = replicated(tree, mesh)
    assert len(copies) == mesh.size
    for c in copies:
        for a, b in zip(tree_leaves(c), tree_leaves(tree)):
            assert a.device.type == "cpu"
            torch.testing.assert_close(a, b, rtol=0, atol=0)
