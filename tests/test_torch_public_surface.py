"""The port's public surface against the JAX package's, on the CPU: every
public name of `waves_jl_tpu`'s top level and of `waves_jl_tpu.models`
exists in the port under the same name, of the same kind (class, function
or constant, the constants equal); the top level's submodules load on first
access, `viz` without importing matplotlib; `control` exports
`make_hybrid_episode_fused` as JAX's does; and `entry_points` holds every
function of the JAX entry points' `__graft_entry__.py`, its private
`_tiny_batch` included, with JAX's arguments (a generator for its PRNG key)
and a `device` last."""
import inspect
import subprocess
import sys
import types

import pytest

import waves_jl_tpu
import waves_jl_tpu.control
import waves_jl_tpu.models
import waves_jl_tpu_torch
import waves_jl_tpu_torch.control
import waves_jl_tpu_torch.models

SUBMODULES = ("models", "train", "control", "parallel", "viz", "data", "env", "native",
              "physics", "ops", "utils", "entry_points")


def public_names(mod) -> list:
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not isinstance(v, types.ModuleType))


def kind(v) -> str:
    return "class" if inspect.isclass(v) else "function" if callable(v) else "constant"


@pytest.mark.parametrize("jax_mod,port_mod", [
    (waves_jl_tpu, waves_jl_tpu_torch),
    (waves_jl_tpu.models, waves_jl_tpu_torch.models),
    (waves_jl_tpu.control, waves_jl_tpu_torch.control),
], ids=["top", "models", "control"])
def test_every_public_name_exists_in_the_port(jax_mod, port_mod):
    names = public_names(jax_mod)
    assert len(names) > 15
    missing = [n for n in names if not hasattr(port_mod, n)]
    assert not missing, f"{port_mod.__name__} lacks {missing}"
    for n in names:
        want, got = getattr(jax_mod, n), getattr(port_mod, n)
        if n == "__version__":
            continue
        assert kind(got) == kind(want), n
        if kind(want) == "constant":
            assert got == want, n


def test_submodules_load_on_first_access_without_matplotlib():
    code = ("import sys, waves_jl_tpu_torch as w\n"
            f"mods = {SUBMODULES!r}\n"
            "assert 'matplotlib' not in sys.modules\n"
            "for m in mods:\n"
            "    assert getattr(w, m).__name__ == 'waves_jl_tpu_torch.' + m\n"
            "assert 'matplotlib' not in sys.modules\n"
            "assert 'jax' not in sys.modules\n"
            "print(w.two_dim(15.0, 8, device='cpu').shape)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "(8, 8)"
    with pytest.raises(AttributeError):
        waves_jl_tpu_torch.not_a_module  # noqa: B018


def test_entry_points_cover_graft_entry():
    import __graft_entry__ as graft

    names = [n for n, v in vars(graft).items()
             if inspect.isfunction(v) and v.__module__ == graft.__name__
             and n != "_dryrun_multichip_impl"]  # its body, which the port's runs in place
    assert {"entry", "dryrun_multichip", "_tiny_batch"} <= set(names)
    for n in names:
        want = list(inspect.signature(getattr(graft, n)).parameters)
        got = list(inspect.signature(getattr(waves_jl_tpu_torch.entry_points, n)).parameters)
        want = {"dryrun_multichip": ["n"],  # JAX's n_devices: the shard count
                "_tiny_batch": want[:-1] + ["generator"]}.get(n, want)  # JAX's PRNG key
        assert got == want + ["device"], n
