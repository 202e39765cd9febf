"""The port's public surface is the reference's.

Every name of ``torchft_tpu.__all__`` resolves on ``torchft_tpu_torch``,
and every public name of the reference's ``comm`` and ``ops`` subpackages
on the port's, except the names written below: twins under another name
(resolved there instead) and names whose module is not ported yet. The
root and ``comm`` import no torch: a fresh interpreter that imports them
has no ``torch`` in ``sys.modules`` (the wire's child process,
``comm/subproc.py``, imports the root and must stay light).

Past the roots, module by module: every public module-level name that a
module of ``torchft_tpu/`` defines (read from its source), and every
public method of each such public class, resolves on the port's twin
module, or stands in ``SURFACE_TWINS`` (the port's twin under another
name, which must resolve) or ``SURFACE_JAX_ONLY`` (with the reason). A
listed name that the port gains, or that the reference does not define,
fails, so the tables stay true.
"""

import ast
import importlib
import os
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


# ------------------------------------------------ the whole public surface

_REF_ROOT = os.path.dirname(os.path.abspath(torchft_tpu.__file__))

# reference module -> the port's twin module of another name
MODULE_TWINS = {"comm.xla_backend": "comm.cuda_backend"}
# reference modules with no twin, and why
MODULE_JAX_ONLY = {
    "utils.jaxcompat": "jax version shims (where shard_map is imported "
                       "from); the port imports no jax",
}
# (reference module, name or Class.method) -> the port's twin under
# another name, a dotted path from the port's package
SURFACE_TWINS = {
    ("checkpoint_io", "OrbaxCheckpointer"): "checkpoint_io.DcpCheckpointer",
    ("comm.xla_backend", "MeshManager"): "comm.cuda_backend.DevicePool",
    ("comm.xla_backend", "XlaCommContext"):
        "comm.cuda_backend.CudaCommContext",
    ("comm.xla_backend", "default_mesh_manager"):
        "comm.cuda_backend.default_device_pool",
    ("comm.xla_backend", "pallas_block_quant"): "ops.quant.quant_int8",
    # the heal plane's numpy helpers: a tensor's byte view, and bfloat16
    # on the host as ml_dtypes' (the port's host view of a tensor)
    ("comm.wire", "tensor_wire_view"): "comm.wire.as_bytes_view",
    ("comm.wire", "bf16_wire_dtype"): "utils.serialization.host_view",
    # the functional model API is the modules' own in the port
    ("models.transformer", "init_params"): "models.transformer.GPT",
    ("models.transformer", "forward"): "models.transformer.GPT.forward",
    ("models.transformer", "forward_hidden"):
        "models.transformer.GPT.forward_hidden",
    ("models.moe_transformer", "moe_init_params"):
        "models.moe_transformer.MoETransformer",
    ("models.moe_transformer", "moe_forward_hidden"):
        "models.moe_transformer.MoETransformer.forward_hidden",
    ("models.moe_transformer", "moe_transformer_loss_fn"):
        "models.moe_transformer.MoETransformer.loss",
}
SURFACE_JAX_ONLY = {
    ("models.moe_transformer", "make_moe_train_step"):
        "a jitted optax step over the functional MoE; the port trains the "
        "module's loss under a torch optimizer (examples.train_moe)",
    ("optim", "OptimizerWrapper.init"):
        "optax's functional init of the optimizer state; the port's "
        "optimizers hold their state (optim.init_adam_state makes it)",
    ("comm.subproc", "logger"):
        "the module's logging.Logger, no behaviour; the port's wire child "
        "logs nothing of its own",
}


def _ref_modules():
    out = []
    for root, _, files in os.walk(_REF_ROOT):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), _REF_ROOT)
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            if any(p.startswith("_") for p in parts):
                continue  # a private module (control/_native.py)
            out.append(".".join(parts))
    return sorted(out)


def _public_surface(module: str):
    """(names, {class: methods}) that ``torchft_tpu.<module>`` defines at
    its top level, public ones only, read from its source."""
    rel = module.replace(".", os.sep)
    path = os.path.join(_REF_ROOT, rel, "__init__.py")
    if not os.path.exists(path):
        path = os.path.join(_REF_ROOT, rel + ".py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names, methods = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = {
                    m.name for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    names = {n for n in names if not n.startswith("_")}
    return names, {c: m for c, m in methods.items() if c in names}


def _port_module(module: str):
    twin = MODULE_TWINS.get(module, module)
    return importlib.import_module(
        "torchft_tpu_torch" + ("." + twin if twin else ""))


def _resolve_path(dotted: str):
    """A dotted path from the port's package: the longest importable
    module prefix, then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(
                "torchft_tpu_torch." + ".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for part in parts[i:]:
            obj = getattr(obj, part)
        return obj
    raise ModuleNotFoundError(dotted)


@pytest.mark.parametrize("module", [m for m in _ref_modules()
                                    if m not in MODULE_JAX_ONLY])
def test_module_surface_resolves_on_the_port(module) -> None:
    # a class's methods resolve on the class or on its twin
    port = _port_module(module)
    names, methods = _public_surface(module)
    missing = []
    for name in sorted(names):
        if (module, name) in SURFACE_JAX_ONLY:
            continue
        if (module, name) in SURFACE_TWINS:
            owner = _resolve_path(SURFACE_TWINS[(module, name)])
        else:
            owner = getattr(port, name, None)
            if owner is None:
                missing.append(name)
                continue
        for meth in sorted(methods.get(name, ())):
            key = f"{name}.{meth}"
            if (module, key) in SURFACE_JAX_ONLY:
                continue
            if (module, key) in SURFACE_TWINS:
                _resolve_path(SURFACE_TWINS[(module, key)])
            elif getattr(owner, meth, None) is None:
                missing.append(key)
    assert not missing, f"torchft_tpu.{module}: {missing}"


def test_surface_tables_stay_true() -> None:
    # every listed name is one the reference defines and the port lacks
    for module in MODULE_JAX_ONLY:
        assert module in _ref_modules()
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"torchft_tpu_torch.{module}")
    for module in MODULE_TWINS:
        assert module in _ref_modules()
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"torchft_tpu_torch.{module}")
    for module, key in list(SURFACE_TWINS) + list(SURFACE_JAX_ONLY):
        names, methods = _public_surface(module)
        cls, _, meth = key.partition(".")
        assert cls in names and (not meth or meth in methods[cls]), key
        obj = _port_module(module)
        for part in key.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                break
        assert obj is None, f"the port has {module}.{key}: drop its row"
    for reason in list(MODULE_JAX_ONLY.values()) + list(
            SURFACE_JAX_ONLY.values()):
        assert reason
