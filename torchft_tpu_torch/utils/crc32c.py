"""CRC32C (Castagnoli) for the heal wire's integrity frames.

Twin of ``torchft_tpu/utils/crc32c.py``: the same checksums, so frames
verify across packages. One implementation: ``csrc/host/crc32c.cc`` (the
SSE4.2 crc32 instruction where the CPU has it, a byte table elsewhere),
linked into the port's build of the native control plane
(``control/_native.py``) and called through ctypes, which releases the GIL
and reads the buffer in place. A heal moves gigabytes at the flagship
sizes, where a pure-Python or numpy CRC would dominate the heal.
:func:`crc32c_combine` joins two parts' checksums on the host, in GF(2)
operator arithmetic (zlib's ``crc32_combine`` over the Castagnoli
polynomial).
"""

from __future__ import annotations

import numpy as np

from torchft_tpu_torch.control._native import get_lib

__all__ = ["crc32c", "crc32c_combine"]

_POLY = 0x82F63B78  # Castagnoli, reflected


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


def _gf2_times(mat: "list[int]", vec: int) -> int:
    """A 32x32 GF(2) operator (``mat[i]`` is the image of bit ``i``)
    applied to the 32-bit vector ``vec``."""
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: "list[int]") -> "list[int]":
    return [_gf2_times(mat, mat[i]) for i in range(32)]


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of a concatenation from the parts' CRCs: ``crc(A + B)`` given
    ``crc(A)``, ``crc(B)`` and ``len(B)`` (zlib's ``crc32_combine``)."""
    crc1 &= 0xFFFFFFFF
    if len2 <= 0:
        return crc1
    # the operator advancing a register over one zero bit, then two, four
    odd = [_POLY] + [1 << i for i in range(31)]
    even = _gf2_square(odd)
    odd = _gf2_square(even)
    # apply len2 zero bytes to crc1, one operator square per bit of len2
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF
