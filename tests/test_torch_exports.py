"""The port's package roots export the reference's public names.

Every name of ``torchft_tpu.__all__`` resolves on ``torchft_tpu_torch``,
and every public name of the reference's ``comm`` and ``ops`` subpackages
on the port's, except the names written below: twins under another name
(resolved there instead) and names whose module is not ported yet. The
root and ``comm`` import no torch: a fresh interpreter that imports them
has no ``torch`` in ``sys.modules`` (the wire's child process,
``comm/subproc.py``, imports the root and must stay light).
"""

import subprocess
import sys

import pytest

import torchft_tpu
import torchft_tpu.comm
import torchft_tpu.ops
import torchft_tpu_torch
import torchft_tpu_torch.comm
import torchft_tpu_torch.ops

# reference name -> the port's twin under another name (a dotted path from
# the port's package); NOT_PORTED: names whose module has no twin yet
RENAMED = {
    "XlaCommContext": "comm.cuda_backend.CudaCommContext",
    "OrbaxCheckpointer": "checkpoint_io.DcpCheckpointer",
    "MeshManager": "comm.cuda_backend.DevicePool",
}
NOT_PORTED: set = set()
COMM_RENAMED = {
    "XlaCommContext": "comm.cuda_backend.CudaCommContext",
    "default_mesh_manager": "comm.cuda_backend.default_device_pool",
    "xla_backend": "comm.cuda_backend",
    "MeshManager": "comm.cuda_backend.DevicePool",
}
COMM_NOT_PORTED: set = set()


def _public(module):
    return sorted(n for n in vars(module) if not n.startswith("_"))


def _resolve(dotted: str):
    import importlib

    try:
        return importlib.import_module(f"torchft_tpu_torch.{dotted}")
    except ModuleNotFoundError:
        module, _, name = dotted.rpartition(".")
        return getattr(importlib.import_module(
            f"torchft_tpu_torch.{module}"), name)


@pytest.mark.parametrize("name", sorted(torchft_tpu.__all__))
def test_root_binds_every_reference_name(name) -> None:
    if name in NOT_PORTED:
        assert not hasattr(torchft_tpu_torch, name)
        return
    if name in RENAMED:
        twin = _resolve(RENAMED[name])
        assert getattr(torchft_tpu_torch, twin.__name__) is twin
        assert twin.__name__ in torchft_tpu_torch.__all__
        return
    assert name in torchft_tpu_torch.__all__
    value = getattr(torchft_tpu_torch, name)
    # the port binds its own twin, never the reference's object
    assert value is not getattr(torchft_tpu, name)
    assert value.__module__.startswith("torchft_tpu_torch.")


def test_root_all_resolves_and_optimizer_is_the_wrapper() -> None:
    for name in torchft_tpu_torch.__all__:
        assert getattr(torchft_tpu_torch, name) is not None, name
    assert torchft_tpu_torch.Optimizer is torchft_tpu_torch.OptimizerWrapper
    with pytest.raises(AttributeError):
        torchft_tpu_torch.NoSuchName  # noqa: B018


@pytest.mark.parametrize("name", _public(torchft_tpu.comm))
def test_comm_binds_every_reference_name(name) -> None:
    if name in COMM_NOT_PORTED:
        return
    if name in COMM_RENAMED:
        assert _resolve(COMM_RENAMED[name]) is not None
        return
    value = getattr(torchft_tpu_torch.comm, name)
    assert getattr(value, "__module__", value.__name__).startswith(
        "torchft_tpu_torch.")


@pytest.mark.parametrize("name", _public(torchft_tpu.ops))
def test_ops_binds_every_reference_name(name) -> None:
    if name in torchft_tpu.ops.__dict__ and isinstance(
            getattr(torchft_tpu.ops, name), type(sys)):
        # a submodule the reference's imports bound; the port's twin is a
        # module of the same name
        _resolve(f"ops.{name}")
        return
    assert name in torchft_tpu_torch.ops.__all__
    assert getattr(torchft_tpu_torch.ops, name).__module__ \
        == "torchft_tpu_torch.ops.attention"


def test_root_and_comm_import_no_torch() -> None:
    code = ("import sys, torchft_tpu_torch, torchft_tpu_torch.comm, "
            "torchft_tpu_torch.futures\n"
            "print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-1] == "False"
