"""The port's ops: attention (``attention.py``: the flash kernels of
``flash.py`` on the card, the plain path on the CPU), the int8 codec
(``quant.py``) and the chunked cross entropy (``xent.py``).

The reference's two exports load on first use (PEP 562), so importing a
module of this package does not import the attention path."""

import importlib
from typing import Any

__all__ = ["causal_attention", "reference_attention"]


def __getattr__(name: str) -> Any:
    if name in __all__:
        value = getattr(importlib.import_module(f"{__name__}.attention"),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
