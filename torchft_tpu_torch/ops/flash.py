"""Flash attention: hand-written CUDA kernels for Hopper, plain PyTorch beside.

Twin of ``torchft_tpu/ops/flash.py``. The public surfaces keep the JAX
package's ``[B, S, H, D]`` layout, its lse/Delta shapes ``[B, H, S]`` f32 and
its ``ValueError`` for a sequence length that is not a multiple of the
block size:

- ``flash_attention``: an autograd Function over the forward kernel and the
  two backward kernels;
- ``flash_attention_with_lse``: forward only, returning ``(out, lse)``;
- ``flash_block_attention_bwd``: gradient contributions under EXTERNAL
  (global) lse and Delta, the ring-attention building block.

Three kernels (``csrc/``) do the work on the card, one per wrapper:

- ``flash_fwd`` (csrc/flash_fwd.cu) replaces ``_flash_kernel`` and
  ``_flash_streamed_kernel`` of torchft_tpu/ops/flash.py;
- ``flash_bwd_dq`` (csrc/flash_bwd_dq.cu) replaces ``_flash_bwd_dq_kernel``
  and its streamed twin;
- ``flash_bwd_dkv`` (csrc/flash_bwd_dkv.cu) replaces
  ``_flash_bwd_dkv_kernel`` and its streamed twin.

The three kernels are built for Hopper (csrc/hopper.cuh): TMA loads
through a ring of shared-memory slots, ``wgmma`` products, blocks of 192
query rows (forward and dQ; 128 at head_dim 128) and 128 keys (dK/dV).
Each is a template on the head size, instantiated at every head_dim the
models reach: 16 ("tiny"), 32, 64 ("125m", "350m") and 128 ("1b")
(``KERNEL_HEAD_DIMS``).

Each wrapper launches its kernel for a CUDA tensor (bf16, head_dim in
``KERNEL_HEAD_DIMS``, S a multiple of 64; anything else raises), runs its
plain PyTorch version for a CPU tensor, and counts its launches in
``LAUNCHES``. Under a CUDA graph capture (``recording_launches``) a wrapper
records its kernel into the graph and launches nothing: its count goes to
the capture's tally, which the graph's owner adds to ``LAUNCHES`` at every
replay (``add_launches``). The plain versions
repeat the reference's arithmetic block by block: the tiled online softmax
forward and the FlashAttention-2 recompute backward, f32 throughout, mask
-1e30, the ``l == 0`` guard. Delta = rowsum(dO * O) stays a plain torch
reduction, as the reference leaves it outside Pallas.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch

from torchft_tpu_torch.ops import _build

__all__ = [
    "KERNEL_HEAD_DIMS",
    "KERNEL_TOL",
    "LAUNCHES",
    "add_launches",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_block_attention_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "check_head_dim",
    "kernel_error",
    "recording_launches",
    "reset_launch_counts",
]

_NEG_INF = -1e30  # avoid nan from (-inf) - (-inf) in the running max

# Kernel launches per wrapper, counted where each kernel is launched.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
_LAUNCHES_LOCK = threading.Lock()  # replica groups may share a process

_KERNEL_TILE = 64  # rows of the kernels' q and k tiles
# the head sizes the kernels are instantiated at (csrc/hopper.cuh TileLayout)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


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
    ``LAUNCHES``, for the span of a CUDA graph capture on that stream: the
    kernels are recorded into the graph, not launched. Keyed by stream, so
    the autograd engine's thread (which runs the backward on the forward's
    stream) tallies too, and other streams keep counting."""
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
    its capture (a tally may hold the codec kernels' too)."""
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


# A kernel against its plain version on the same bf16 inputs. Both do the
# same f32 arithmetic in another order and round once to bf16, so an element
# differs by one bf16 ulp (at most 2**-7 of its size) where the two f32
# results straddle a rounding boundary, and near zero by f32 noise (atol).
# Few elements straddle, so the relative norm of the whole difference stays
# far below one ulp; rounding P or dS to bf16 for the products (instead of
# the hi + lo split) moves every result by about 2**-9 and the norm past the
# bound. lse is f32 and is held absolutely.
KERNEL_TOL = {
    torch.bfloat16: {"atol": 1e-4, "rtol": 2.0 ** -7, "rel_norm": 1e-3},
    torch.float32: {"atol": 1e-5, "rtol": 0.0, "rel_norm": 1e-6},
}


def kernel_error(got: torch.Tensor, want: torch.Tensor) -> Dict[str, object]:
    """How far a kernel's result ``got`` lies from its plain version's
    ``want`` under ``KERNEL_TOL[want.dtype]``: ``max_abs_err``; ``worst``,
    the largest ``|got - want| / (atol + rtol |want|)`` (at most 1 passes);
    ``rel_norm``, ``||got - want|| / ||want||``; and ``ok``."""
    tol = KERNEL_TOL[want.dtype]
    g, w = got.detach().double(), want.detach().double()
    diff = (g - w).abs()
    worst = float((diff / (tol["atol"] + tol["rtol"] * w.abs())).max())
    rel = float(diff.norm() / w.norm().clamp_min(1e-30))
    return {"max_abs_err": float(diff.max()), "worst": worst,
            "rel_norm": rel, "ok": worst <= 1.0 and rel <= tol["rel_norm"]}


# ----------------------------------------------------------- plain versions
# [B, S, H, D] in; the math runs on [B, H, S, D] f32 views block by block.


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.float().transpose(1, 2)


def _causal_mask(s: torch.Tensor, q_start: int, k_start: int) -> torch.Tensor:
    bq, bk = s.shape[-2], s.shape[-1]
    q_pos = q_start + torch.arange(bq, device=s.device)[:, None]
    k_pos = k_start + torch.arange(bk, device=s.device)[None, :]
    return torch.where(q_pos >= k_pos, s, torch.full_like(s, _NEG_INF))


def flash_fwd_plain(q, k, v, causal: bool, scale: float, block_q: int,
                    block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled online-softmax forward (the reference's ``_flash_kernel``):
    ``(out [B, S, H, D] in q's dtype, lse [B, H, S] f32)``."""
    seq = q.shape[1]
    qs, kf, vf = _bhsd(q) * scale, _bhsd(k), _bhsd(v)
    nk = seq // block_k
    outs, lses = [], []
    for qi in range(seq // block_q):
        qb = qs[:, :, qi * block_q:(qi + 1) * block_q]
        acc = torch.zeros_like(qb)
        m = torch.full(qb.shape[:-1] + (1,), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        upper = min(nk, ((qi + 1) * block_q + block_k - 1) // block_k) \
            if causal else nk
        for ki in range(upper):
            kb = kf[:, :, ki * block_k:(ki + 1) * block_k]
            vb = vf[:, :, ki * block_k:(ki + 1) * block_k]
            s = qb @ kb.transpose(-1, -2)
            if causal:
                s = _causal_mask(s, qi * block_q, ki * block_k)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vb
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(acc / l)
        lses.append((m + torch.log(l))[..., 0])
    out = torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)
    return out, torch.cat(lses, dim=2)


def _bwd_p_ds(qb, kb, vb, dob, lse_b, delta_b, q_start, k_start, causal):
    """P = exp(S - lse) with the causal mask, dS = P * (dO V^T - Delta):
    the reference's shared ``_bwd_p_ds`` score recompute."""
    s = qb @ kb.transpose(-1, -2)
    if causal:
        s = _causal_mask(s, q_start, k_start)
    p = torch.exp(s - lse_b[..., None])
    dp = dob @ vb.transpose(-1, -2)
    return p, p * (dp - delta_b[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                       block_q: int, block_k: int) -> torch.Tensor:
    """dQ, each q-block sweeping its k-blocks up to the diagonal
    (the reference's ``_flash_bwd_dq_kernel``)."""
    seq = q.shape[1]
    qs, kf, vf, dof = _bhsd(q) * scale, _bhsd(k), _bhsd(v), _bhsd(do)
    lse, delta = lse.float(), delta.float()
    nk = seq // block_k
    dqs = []
    for qi in range(seq // block_q):
        sl = slice(qi * block_q, (qi + 1) * block_q)
        dq = torch.zeros_like(qs[:, :, sl])
        upper = min(nk, ((qi + 1) * block_q + block_k - 1) // block_k) \
            if causal else nk
        for ki in range(upper):
            kb = kf[:, :, ki * block_k:(ki + 1) * block_k]
            vb = vf[:, :, ki * block_k:(ki + 1) * block_k]
            _, ds = _bwd_p_ds(qs[:, :, sl], kb, vb, dof[:, :, sl],
                              lse[:, :, sl], delta[:, :, sl],
                              qi * block_q, ki * block_k, causal)
            dq = dq + ds @ kb
        dqs.append(dq * scale)
    return torch.cat(dqs, dim=2).transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                        block_q: int, block_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each k-block sweeping the q-blocks from the causal lower
    bound (the reference's ``_flash_bwd_dkv_kernel``)."""
    seq = q.shape[1]
    qs, kf, vf, dof = _bhsd(q) * scale, _bhsd(k), _bhsd(v), _bhsd(do)
    lse, delta = lse.float(), delta.float()
    nq = seq // block_q
    dks, dvs = [], []
    for ki in range(seq // block_k):
        kb = kf[:, :, ki * block_k:(ki + 1) * block_k]
        vb = vf[:, :, ki * block_k:(ki + 1) * block_k]
        dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
        lower = (ki * block_k) // block_q if causal else 0
        for qi in range(lower, nq):
            sl = slice(qi * block_q, (qi + 1) * block_q)
            p, ds = _bwd_p_ds(qs[:, :, sl], kb, vb, dof[:, :, sl],
                              lse[:, :, sl], delta[:, :, sl],
                              qi * block_q, ki * block_k, causal)
            dv = dv + p.transpose(-1, -2) @ dof[:, :, sl]
            # q already carries `scale`, so dS^T q includes dL/dk's scale
            dk = dk + ds.transpose(-1, -2) @ qs[:, :, sl]
        dks.append(dk)
        dvs.append(dv)
    dk = torch.cat(dks, dim=2).transpose(1, 2).to(k.dtype)
    dv = torch.cat(dvs, dim=2).transpose(1, 2).to(v.dtype)
    return dk, dv


# ------------------------------------------------------------ CUDA wrappers


def check_head_dim(name: str, d: int) -> None:
    """Raise ValueError unless the kernels take head size ``d``."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name}: the kernels take head_dim "
            f"{', '.join(map(str, KERNEL_HEAD_DIMS))}; got head_dim {d}")


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: want [B, S, H, D] tensors, got {tuple(q.shape)}")
    b, s, h, d = q.shape
    for t in tensors[:4]:
        if t.shape != q.shape or t.dtype != torch.bfloat16:
            raise ValueError(
                f"{name}: the kernel takes bf16 [B, S, H, D] tensors of one "
                f"shape; got {t.dtype} {tuple(t.shape)}"
            )
    check_head_dim(name, d)
    if s % _KERNEL_TILE:
        raise ValueError(f"{name}: the kernel takes S a multiple of 64, got {s}")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: every tensor must be contiguous, 16-byte aligned "
                f"and on {q.device}"
            )


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _flash_fwd_cuda(q, k, v, causal, scale):
    _check_kernel_inputs("flash_fwd", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.load_kernels()
    rc = lib.tft_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, d, float(scale), int(causal), _stream(),
    )
    _build.check(rc, "flash_fwd")
    _count("flash_fwd")
    return out, lse


def _stats(lse, delta, q):
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [B, H, S] = {(b, h, s)}")


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale):
    _check_kernel_inputs("flash_bwd_dq", q, k, v, do, lse, delta)
    _stats(lse, delta, q)
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    lib = _build.load_kernels()
    rc = lib.tft_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, d,
        float(scale), int(causal), _stream(),
    )
    _build.check(rc, "flash_bwd_dq")
    _count("flash_bwd_dq")
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale):
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, do, lse, delta)
    _stats(lse, delta, q)
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_kernels()
    rc = lib.tft_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, h, d, float(scale), int(causal), _stream(),
    )
    _build.check(rc, "flash_bwd_dkv")
    _count("flash_bwd_dkv")
    return dk, dv


def _on_cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"flash attention runs on cuda or cpu, not {x.device}")


def flash_fwd(q, k, v, causal: bool, scale: float, block_q: int = 128,
              block_k: int = 128):
    """Forward: ``(out [B, S, H, D], lse [B, H, S] f32)``. CUDA tensors go
    through the kernel (which tiles by its own sizes whatever the block
    sizes), launched on their card's current stream, CPU tensors through
    :func:`flash_fwd_plain`."""
    if _on_cpu(q):
        return flash_fwd_plain(q, k, v, causal, scale, block_q, block_k)
    with torch.cuda.device(q.device):
        return _flash_fwd_cuda(q, k, v, causal, scale)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 block_q: int = 128, block_k: int = 128):
    if _on_cpu(q):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                  block_q, block_k)
    with torch.cuda.device(q.device):
        return _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  block_q: int = 128, block_k: int = 128):
    if _on_cpu(q):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                                   block_q, block_k)
    with torch.cuda.device(q.device):
        return _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)


# ---------------------------------------------------------------- surfaces


def _prologue(q, scale, block_q, block_k):
    """Scale default, block clamping and the divisibility check shared by
    every surface (the reference's ``_bshd_prologue``)."""
    s, d = q.shape[1], q.shape[3]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq len {s} must be a multiple of block sizes "
            f"({block_q}, {block_k})"
        )
    return float(scale), block_q, block_k


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32, [B, H, S]."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        out, lse = flash_fwd(q, k, v, causal, scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q, block_k = ctx.args
        g = g.contiguous()
        delta = _delta(out, g)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, causal, scale,
                          block_q, block_k)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale,
                               block_q, block_k)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """``[B, S, H, D]`` flash attention, differentiable."""
    scale, block_q, block_k = _prologue(q, scale, block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             block_q: int = 128, block_k: int = 128):
    """Forward only: ``(out [B, S, H, D], lse [B, H, S] f32)``; the lse
    makes results over disjoint key sets mergeable."""
    scale, block_q, block_k = _prologue(q, scale, block_q, block_k)
    return flash_fwd(q, k, v, causal, scale, block_q, block_k)


def flash_block_attention_bwd(q, k, v, do, lse, delta, causal: bool,
                              scale: Optional[float] = None,
                              block_q: int = 128, block_k: int = 128):
    """Gradient contributions ``(dq, dk, dv)`` of one (q-block, kv-block)
    pair under GLOBAL softmax statistics: ``lse`` and ``delta`` are
    ``[B, H, S]`` f32 over q's full attention row."""
    scale, block_q, block_k = _prologue(q, scale, block_q, block_k)
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, block_q, block_k)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                           block_q, block_k)
    return dq, dk, dv
