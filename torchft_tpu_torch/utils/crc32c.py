"""CRC32C (Castagnoli) for the heal wire's integrity frames.

Twin of ``torchft_tpu/utils/crc32c.py``: the same checksums, so frames
verify across packages. One implementation: ``csrc/host/crc32c.cc`` (the
SSE4.2 crc32 instruction where the CPU has it, a byte table elsewhere),
linked into the port's build of the native control plane
(``control/_native.py``) and called through ctypes, which releases the GIL
and reads the buffer in place. A heal moves gigabytes at the flagship
sizes, where a pure-Python or numpy CRC would dominate the heal.
"""

from __future__ import annotations

import numpy as np

from torchft_tpu_torch.control._native import get_lib

__all__ = ["crc32c"]


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` (bytes, memoryview or ndarray), continuing from a
    prior ``value`` (streaming accumulation)."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    if buf.size == 0:
        return value & 0xFFFFFFFF
    return int(get_lib().tft_crc32c(value & 0xFFFFFFFF, buf.ctypes.data,
                                    buf.size))
