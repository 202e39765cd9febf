"""The int8 block codec of the on-device gradient plane: two hand-written
CUDA kernels for Hopper, plain PyTorch beside.

- ``quant_int8`` (csrc/quant_int8.cu) replaces ``_pallas_quant_kernel`` (K7,
  launched by ``pallas_block_quant``) of torchft_tpu/comm/xla_backend.py:
  each row of a 2-D f32 tensor is cut on the chunk grid ``step`` (the tail
  chunk is short) and every chunk becomes int8 values plus one f32 scale.
- ``dequant_acc_int8`` (same source) is the owner-side decode-accumulate
  that the reference leaves to XLA (``reduce_int8`` of
  ``_build_quantized_psum``): per output element, the sum over the sources
  in rank order of ``f32(q) * scale``, then an optional division.

The port computes the reference's default, bitwise quantizer
(``_dev_quant_int8``, which equals the host ``_Int8Codec._quantize``):
``scale = f32(f64(absmax) / 127)``, 1 for an all-zero chunk, NaN for a chunk
holding a value that is not finite (whose q are then 0); ``q = clip(rint(x /
scale), -127, 127)``. The Pallas kernel's f32 scale was the TPU's limit (no
f64 there) and bought only +-1 parity; the H100 divides in f64, so the port
keeps the bitwise semantics, and the host codec, the plain versions here and
the kernels agree bit for bit.

Each wrapper launches its kernel for CUDA tensors, on the current stream of
their own card whichever card is current (anything the kernel does not take
raises ValueError), runs its plain version for CPU tensors, and
counts its launches in ``LAUNCHES``. There is no fallback. Under a CUDA graph
capture (``recording_launches``) a wrapper records its kernel into the graph
and its count goes to the capture's tally, which the graph's owner adds to
``LAUNCHES`` at every replay (``add_launches``), as ``ops/flash.py`` does.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch

from torchft_tpu_torch.ops import _build

__all__ = [
    "LAUNCHES",
    "add_launches",
    "dequant_acc_int8",
    "dequant_acc_int8_plain",
    "div_exact",
    "n_chunks",
    "quant_int8",
    "quant_int8_plain",
    "recording_launches",
    "reset_launch_counts",
]

# Kernel launches per wrapper, counted where each kernel is launched.
LAUNCHES: Dict[str, int] = {"quant_int8": 0, "dequant_acc_int8": 0}
_LAUNCHES_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


# capture stream handle -> the tally of the graph being captured on it
_CAPTURES: Dict[int, Dict[str, int]] = {}


@contextmanager
def recording_launches(into: Dict[str, int],
                       stream: "torch.cuda.Stream") -> Iterator[Dict[str, int]]:
    """Tally the kernel calls made on ``stream`` into ``into`` instead of
    ``LAUNCHES`` for the span of a CUDA graph capture on that stream (the
    kernels are recorded into the graph, not launched)."""
    key = stream.cuda_stream
    with _LAUNCHES_LOCK:
        _CAPTURES[key] = into
    try:
        yield into
    finally:
        with _LAUNCHES_LOCK:
            _CAPTURES.pop(key, None)


def add_launches(counts: Dict[str, int]) -> None:
    """Count a graph replay's launches: this module's names of the tally of
    its capture."""
    with _LAUNCHES_LOCK:
        for name, n in counts.items():
            if name in LAUNCHES:
                LAUNCHES[name] += n


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        into = (_CAPTURES.get(torch.cuda.current_stream().cuda_stream)
                if _CAPTURES else None)
        if into is not None:
            into[name] = into.get(name, 0) + 1
        else:
            LAUNCHES[name] += 1


def div_exact(t: torch.Tensor, d: "int | float") -> torch.Tensor:
    """``t / d`` correctly rounded on every device. PyTorch's CUDA kernel
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which is one ulp off for some values; a divisor held in a
    0-dim tensor on ``t``'s device takes the true division. The divisor is
    filled on the device (no copy from the host), so a CUDA graph can
    capture the division."""
    dt = torch.float64 if t.dtype == torch.float64 else torch.float32
    return t / torch.full((), d, dtype=dt, device=t.device)


def n_chunks(n: int, step: int) -> int:
    """Chunks of at most ``step`` elements covering ``n`` (the last short)."""
    return -(-n // step) if n > 0 else 0


def _check_2d(name: str, t: torch.Tensor, dtype: torch.dtype,
              device: torch.device) -> None:
    if t.dim() != 2 or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: want a 2-D {dtype} tensor on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous (stride(1) == 1)")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------------- quant_int8


def quant_int8_plain(x: torch.Tensor, step: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 [rows, n], scales f32 [rows, n_chunks(n, step)])`` in
    vectorised torch: pad to whole chunks with zeros (a zero never raises an
    absmax), ``amax`` of ``abs`` (NaN propagates), the f64 scale divide,
    ``round`` (half to even, as ``rintf``), ``clamp``."""
    rows, n = x.shape
    cpr = n_chunks(n, step)
    xp = torch.zeros((rows, cpr * step), dtype=torch.float32, device=x.device)
    xp[:, :n] = x
    xb = xp.view(rows, cpr, step)
    absmax = xb.abs().amax(-1)
    finite = torch.isfinite(absmax)
    scale = torch.where(absmax > 0, div_exact(absmax.double(), 127.0).float(),
                        torch.ones_like(absmax))
    scale = torch.where(finite, scale, torch.full_like(scale, float("nan")))
    qf = torch.round(xb / scale[..., None]).clamp(-127.0, 127.0)
    qf = torch.where(finite[..., None], qf, torch.zeros_like(qf))
    q = qf.to(torch.int8).view(rows, cpr * step)[:, :n].contiguous()
    return q, scale


def quant_int8(x: torch.Tensor, step: int,
               out: "Optional[Tuple[torch.Tensor, torch.Tensor]]" = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize every row of the f32 ``x`` [rows, n] on the chunk grid
    ``step``: ``(q int8 [rows, n], scales f32 [rows, n_chunks(n, step)])``,
    written into ``out`` when given. Rows may be strided (a view of a wider
    buffer); elements within a row must be contiguous. One launch for all
    rows."""
    if step <= 0:
        raise ValueError(f"quant_int8: step must be positive, got {step}")
    rows, n = x.shape
    cpr = n_chunks(n, step)
    if out is None:
        q = torch.empty((rows, n), dtype=torch.int8, device=x.device)
        scales = torch.empty((rows, cpr), dtype=torch.float32,
                             device=x.device)
    else:
        q, scales = out
    if not x.is_cuda:
        pq, ps = quant_int8_plain(x, step)
        q.copy_(pq)
        scales.copy_(ps)
        return q, scales
    _check_2d("quant_int8 x", x, torch.float32, x.device)
    _check_2d("quant_int8 q", q, torch.int8, x.device)
    _check_2d("quant_int8 scales", scales, torch.float32, x.device)
    if tuple(q.shape) != (rows, n) or tuple(scales.shape) != (rows, cpr) \
            or (cpr > 1 and scales.stride(0) != cpr):
        raise ValueError(
            f"quant_int8: want q {(rows, n)} and contiguous scales "
            f"{(rows, cpr)}, got {tuple(q.shape)} and {tuple(scales.shape)}"
        )
    if rows == 0 or n == 0:
        return q, scales
    lib = _build.load_kernels()
    with torch.cuda.device(x.device):  # the launch rides x's card's stream
        rc = lib.tft_quant_int8(
            x.data_ptr(), x.stride(0), q.data_ptr(), q.stride(0),
            scales.data_ptr(), rows, n, step, _stream(),
        )
        _build.check(rc, "quant_int8")
        _count("quant_int8")
    return q, scales


# ----------------------------------------------------------- dequant_acc_int8


def _dequant_args(q: torch.Tensor, step: int, valid: Optional[int],
                  seg: Optional[int]) -> Tuple[int, int]:
    if step <= 0:
        raise ValueError(f"dequant_acc_int8: step must be positive, got {step}")
    n = q.shape[1]
    valid = n if valid is None else int(valid)
    seg = n if seg is None else int(seg)
    if not 0 <= valid <= n or seg <= 0:
        raise ValueError(f"dequant_acc_int8: bad valid={valid} / seg={seg} "
                         f"for {n} elements")
    return valid, seg


def dequant_acc_int8_plain(q: torch.Tensor, scales: torch.Tensor, step: int,
                           valid: Optional[int] = None,
                           seg: Optional[int] = None, cps: int = 0,
                           divisor: int = 0) -> torch.Tensor:
    """The decode-accumulate in torch: per source, in rank order, the f32
    product rounded and then added; elements at or past ``valid`` are 0."""
    valid, seg = _dequant_args(q, step, valid, seg)
    j = torch.arange(valid, device=q.device)
    chunk = (j // seg) * cps + (j % seg) // step
    acc = torch.zeros(valid, dtype=torch.float32, device=q.device)
    for r in range(q.shape[0]):
        acc = acc + q[r, :valid].float() * scales[r][chunk]
    if divisor > 0:
        acc = div_exact(acc, divisor)
    out = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
    out[:valid] = acc
    return out


def dequant_acc_int8(q: torch.Tensor, scales: torch.Tensor, step: int, *,
                     valid: Optional[int] = None, seg: Optional[int] = None,
                     cps: int = 0, divisor: int = 0,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[j] = (sum_r f32(q[r, j]) * scales[r, chunk(j)]) / divisor`` for
    ``j < valid`` (0 past it), sources ``r`` in order, every product and add
    rounded to f32; ``divisor`` 0 skips the division. ``chunk(j) = (j // seg)
    * cps + (j % seg) // step``: ``seg`` >= the length for one grid over the
    whole row (the default), or a shard / row length with ``cps`` chunks per
    segment. ``q`` is int8 [sources, N] and ``scales`` f32 [sources, S],
    rows contiguous; one launch."""
    valid, seg = _dequant_args(q, step, valid, seg)
    n_src, n = q.shape
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=q.device)
    if not q.is_cuda:
        out.copy_(dequant_acc_int8_plain(q, scales, step, valid, seg, cps,
                                         divisor))
        return out
    _check_2d("dequant_acc_int8 q", q, torch.int8, q.device)
    _check_2d("dequant_acc_int8 scales", scales, torch.float32, q.device)
    if out.dim() != 1 or out.numel() != n or out.dtype != torch.float32 \
            or out.device != q.device or not out.is_contiguous():
        raise ValueError(f"dequant_acc_int8: out must be a contiguous f32 "
                         f"[{n}] tensor on {q.device}")
    if scales.shape[0] != n_src:
        raise ValueError("dequant_acc_int8: one scale row per source")
    if n == 0:
        return out
    if n_src == 0:
        raise ValueError("dequant_acc_int8: no sources")
    lib = _build.load_kernels()
    with torch.cuda.device(q.device):
        rc = lib.tft_dequant_acc_int8(
            q.data_ptr(), q.stride(0), scales.data_ptr(), scales.stride(0),
            out.data_ptr(), n_src, n, valid, seg, int(cps), step,
            int(divisor), _stream(),
        )
        _build.check(rc, "dequant_acc_int8")
        _count("dequant_acc_int8")
    return out
