"""The port's flash attention against the JAX package's Pallas kernels.

Inputs come from numpy with a fixed seed and go through both packages: the
JAX kernels in interpret mode (in both regimes: resident K/V, and streamed
with ``_resident_kv_bytes=0``), the port's plain PyTorch versions on the
CPU; at head_dim 64 and at the other head sizes the kernels take (16, 32,
128). Tolerances: f32 <= 1e-5 in the forward and <= 1e-4 in the gradients
(summation order only); bf16 <= 2e-2 (bf16 rounding of the outputs).
The hand-written CUDA kernels are held against the same plain versions on
the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.ops import attention as jattn
from torchft_tpu.ops import flash as jflash
from torchft_tpu_torch.ops import attention, flash

SHAPE = (1, 256, 2, 64)
BLOCK = 64
F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2


def _inputs(seed, n=4, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _jax_attention_and_grads(q, k, v, do, causal, threshold, dtype):
    def run(a, b, c):
        return jflash.flash_attention(
            a, b, c, causal=causal, block_q=BLOCK, block_k=BLOCK,
            interpret=True, _resident_kv_bytes=threshold,
        )

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out = run(*args)
    grads = jax.grad(
        lambda a, b, c: jnp.sum(run(a, b, c).astype(jnp.float32)
                                * jnp.asarray(do)),
        argnums=(0, 1, 2),
    )(*args)
    return np.asarray(out.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in grads
    ]


def _torch_attention_and_grads(q, k, v, do, causal, dtype):
    ts = [torch.tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention(*ts, causal=causal, block_q=BLOCK,
                                block_k=BLOCK)
    (out.float() * torch.tensor(do)).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("threshold", [None, 0], ids=["resident", "streamed"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_matches_pallas(causal, threshold) -> None:
    q, k, v, do = _inputs(0)
    j_out, j_grads = _jax_attention_and_grads(q, k, v, do, causal, threshold,
                                              jnp.float32)
    t_out, t_grads = _torch_attention_and_grads(q, k, v, do, causal,
                                                torch.float32)
    assert _max_err(t_out, j_out) <= F32_FWD
    for tg, jg in zip(t_grads, j_grads):
        assert _max_err(tg, jg) <= F32_GRAD


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 128])
def test_flash_f32_matches_pallas_at_head_dim(d, causal) -> None:
    """The other head sizes the kernels take: 16 ("tiny"), 32 (the
    reference's own test shape) and 128 ("1b"), forward and gradients."""
    q, k, v, do = _inputs(10 + d, shape=(1, 256, 2, d))
    j_out, j_grads = _jax_attention_and_grads(q, k, v, do, causal, None,
                                              jnp.float32)
    t_out, t_grads = _torch_attention_and_grads(q, k, v, do, causal,
                                                torch.float32)
    assert t_out.shape == (1, 256, 2, d)
    assert _max_err(t_out, j_out) <= F32_FWD
    for tg, jg in zip(t_grads, j_grads):
        assert _max_err(tg, jg) <= F32_GRAD


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_pallas(causal) -> None:
    q, k, v, do = _inputs(1)
    j_out, j_grads = _jax_attention_and_grads(q, k, v, do, causal, None,
                                              jnp.bfloat16)
    t_out, t_grads = _torch_attention_and_grads(q, k, v, do, causal,
                                                torch.bfloat16)
    assert _max_err(t_out, j_out) <= BF16
    for tg, jg in zip(t_grads, j_grads):
        assert _max_err(tg, jg) <= BF16


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_matches_pallas(causal) -> None:
    q, k, v = _inputs(2, n=3)
    j_out, j_lse = jflash.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=BLOCK,
        block_k=BLOCK, interpret=True,
    )
    t_out, t_lse = flash.flash_attention_with_lse(
        *(torch.tensor(x) for x in (q, k, v)), causal=causal, block_q=BLOCK,
        block_k=BLOCK,
    )
    assert tuple(t_lse.shape) == (SHAPE[0], SHAPE[2], SHAPE[1])
    assert t_lse.dtype == torch.float32
    assert _max_err(t_out.numpy(), j_out) <= F32_FWD
    assert _max_err(t_lse.numpy(), j_lse) <= F32_FWD


@pytest.mark.parametrize("causal", [True, False])
def test_block_bwd_external_stats_matches_pallas(causal) -> None:
    q, k, v, do = _inputs(3)
    rng = np.random.default_rng(4)
    # external (global) statistics: lse from a wider row, arbitrary delta
    lse = (rng.standard_normal((SHAPE[0], SHAPE[2], SHAPE[1])) + 6.0
           ).astype(np.float32)
    delta = rng.standard_normal(lse.shape).astype(np.float32)
    jq, jk, jv = jflash.flash_block_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, do, lse, delta)), causal=causal,
        block_q=BLOCK, block_k=BLOCK, interpret=True,
    )
    tq, tk, tv = flash.flash_block_attention_bwd(
        *(torch.tensor(x) for x in (q, k, v, do, lse, delta)), causal=causal,
        block_q=BLOCK, block_k=BLOCK,
    )
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        assert _max_err(t.numpy(), j) <= F32_GRAD


def test_flash_rejects_ragged_seq() -> None:
    q = torch.zeros((1, 100, 2, 64))
    with pytest.raises(ValueError, match="multiple of block"):
        flash.flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="multiple of block"):
        flash.flash_block_attention_bwd(q, q, q, q, torch.zeros(1, 2, 100),
                                        torch.zeros(1, 2, 100), True,
                                        block_q=64, block_k=64)
    # the reference raises the same way
    jq = jnp.zeros((1, 100, 2, 64))
    with pytest.raises(ValueError, match="multiple of block"):
        jflash.flash_attention(jq, jq, jq, block_q=64, block_k=64,
                               interpret=True)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches(causal) -> None:
    q, k, v = _inputs(5, n=3, shape=(2, 64, 4, 32))
    j = jattn.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=causal)
    t = attention.reference_attention(*(torch.tensor(x) for x in (q, k, v)),
                                      causal=causal)
    assert _max_err(t.numpy(), j) <= F32_FWD


def test_causal_attention_cpu_is_reference_path() -> None:
    q, k, v = (torch.tensor(x) for x in _inputs(6, n=3, shape=(1, 128, 2, 64)))
    before = dict(flash.LAUNCHES)
    out = attention.causal_attention(q, k, v)
    assert torch.equal(out, attention.reference_attention(q, k, v))
    # CPU tensors never reach a kernel
    assert flash.LAUNCHES == before


def test_plain_flash_matches_reference_attention() -> None:
    q, k, v = (torch.tensor(x) for x in _inputs(7, n=3))
    out, lse = flash.flash_fwd_plain(q, k, v, True, 64 ** -0.5, 128, 64)
    ref = attention.reference_attention(q, k, v)
    assert float((out - ref).abs().max()) <= F32_FWD
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 64 ** -0.5
    s = s.masked_fill(~torch.tril(torch.ones(256, 256, dtype=torch.bool)),
                      float("-inf"))
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= F32_FWD
