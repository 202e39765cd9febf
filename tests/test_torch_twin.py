"""The reference suites, run over the port.

``reference_twin(globals(), "test_store")`` compiles the JAX package's
tests/test_store.py into the calling test module with the package renamed
(``torchft_tpu`` -> ``torchft_tpu_torch``, whole words only), so each of
its cases runs under its own name, with the reference's own assertions,
against the port. ``renames`` maps further words of the source where the
port names a helper otherwise (a key that is not a name is replaced as
text: an import the port has no name for), applied after the package
rename;
``prelude`` is source run first (in it ``torchft_tpu`` stays the JAX
package, for an oracle the port has no copy of); ``drop`` maps each case
the twin does not run to where it is held instead, or why not. A dropped
name that the suite does not define fails the import, so the list stays
true to the suite. The twins are tests/test_torch_ref_*.py.
"""

import os
import re

import pytest

_TESTS = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = re.compile(r"\btorchft_tpu\b")


def renamed_source(suite: str, renames=None) -> str:
    """The reference suite's source with the package renamed, then each
    whole word of ``renames`` replaced."""
    with open(os.path.join(_TESTS, suite + ".py")) as f:
        src = _PACKAGE.sub("torchft_tpu_torch", f.read())
    for old, new in (renames or {}).items():
        if old.isidentifier():
            src = re.sub(rf"\b{re.escape(old)}\b", new, src)
        else:
            src = src.replace(old, new)
    return src


def reference_twin(namespace: dict, suite: str, renames=None, prelude="",
                   drop=None) -> None:
    """Define the cases of tests/<suite>.py, renamed, in ``namespace`` (a
    test module's globals), less those in ``drop``."""
    path = os.path.join(_TESTS, suite + ".py")
    if prelude:
        exec(compile(prelude, f"{path} (prelude)", "exec"), namespace)
    exec(compile(renamed_source(suite, renames), path, "exec"), namespace)
    for name in drop or {}:
        if name not in namespace:
            raise NameError(f"{suite} defines no {name}")
        del namespace[name]


def test_rename_touches_whole_words_only() -> None:
    src = renamed_source("test_store")
    assert "torchft_tpu_torch.comm" in src
    assert not _PACKAGE.search(src.replace("torchft_tpu_torch", ""))
    assert "torchft_tpu_torch_torch" not in src


def test_a_twin_runs_on_the_port_and_drops_by_name() -> None:
    ns = {"__name__": "twin_probe"}
    reference_twin(ns, "test_store", drop={"test_large_value": "probe"})
    assert "test_large_value" not in ns and "test_set_get" in ns
    assert ns["StoreServer"].__module__ == "torchft_tpu_torch.comm.store"
    with pytest.raises(NameError, match="no test_absent"):
        reference_twin({"__name__": "twin_probe"}, "test_store",
                       drop={"test_absent": "probe"})
