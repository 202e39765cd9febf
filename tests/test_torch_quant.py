"""The int8 block codec of the port's device plane (ops/quant.py) on the CPU.

The wrappers run their plain PyTorch versions for CPU tensors; the kernels
(csrc/quant_int8.cu) are held bitwise to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. Here the plain versions meet the
reference:

- ``quant_int8`` against the host ``_Int8Codec._quantize`` chunk by chunk,
  bitwise (q and scales, NaN scales included), on 5000 elements at step 1024
  (a short tail chunk) with an all-zero chunk, a NaN chunk and an Inf chunk;
- against the reference's Pallas kernel ``pallas_block_quant`` (interpret
  mode on the CPU), whose f32 scale is the TPU's: scale within 1 ulp, q
  within +-1;
- ``dequant_acc_int8`` against the numpy composition of
  ``_Int8Codec.decode_into`` in rank order, bitwise, on one grid over the
  payload, on per-shard grids, with padding and with the AVG division.
"""

import jax
import numpy as np
import pytest
import torch

from torchft_tpu.comm.transport import _Int8Codec
from torchft_tpu.comm.wire import iov_join
from torchft_tpu.comm.xla_backend import pallas_block_quant
from torchft_tpu_torch.ops import quant

STEP = 1024
SIZE = 5000  # 4 full chunks and a 904-element tail


def _special_rows(seed: int) -> np.ndarray:
    """Two rows of SIZE f32: row 0 with an all-zero chunk (1), a NaN in
    chunk 2, an Inf in chunk 3 and a -Inf in the tail; row 1 plain with a
    per-chunk outlier."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, SIZE)) * 3).astype(np.float32)
    x[0, STEP:2 * STEP] = 0.0
    x[0, 2 * STEP + 5] = np.nan
    x[0, 3 * STEP + 17] = np.inf
    x[0, 4 * STEP + 3] = -np.inf
    x[1, 17] = 250.0
    return x


def test_quant_plain_matches_host_codec_bitwise() -> None:
    x = _special_rows(0)
    before = dict(quant.LAUNCHES)
    q, s = quant.quant_int8(torch.from_numpy(x), STEP)
    assert quant.LAUNCHES == before  # a CPU tensor never launches
    assert q.dtype == torch.int8 and tuple(q.shape) == (2, SIZE)
    assert tuple(s.shape) == (2, quant.n_chunks(SIZE, STEP)) == (2, 5)
    q, s = q.numpy(), s.numpy()
    for r in range(2):
        for c in range(5):
            blk = x[r, c * STEP:(c + 1) * STEP]
            sc_h, q_h = _Int8Codec._quantize(blk)
            assert np.float32(sc_h).tobytes() == s[r, c].tobytes(), (r, c)
            assert q_h.tobytes() == q[r, c * STEP:c * STEP + blk.size] \
                .tobytes(), (r, c)
    assert s[0, 1] == 1.0  # all-zero chunk: scale 1
    # non-finite poisons its own chunk only: NaN scale, q all 0
    assert np.isnan(s[0, 2:]).all() and np.isfinite(s[0, :2]).all()
    assert (q[0, 2 * STEP:] == 0).all()
    assert np.isfinite(s[1]).all()


def test_quant_writes_strided_rows_into_given_buffers() -> None:
    # the plane quantizes a (world, size) view of a wider padded buffer
    x = _special_rows(1)[1:]
    wide = torch.zeros((1, SIZE + 100), dtype=torch.int8)
    scales = torch.empty((1, 5))
    quant.quant_int8(torch.from_numpy(x), STEP, out=(wide[:, :SIZE], scales))
    q_ref, s_ref = quant.quant_int8_plain(torch.from_numpy(x), STEP)
    assert torch.equal(wide[:, :SIZE], q_ref) and torch.equal(scales, s_ref)
    assert not wide[:, SIZE:].any()


def test_quant_plain_vs_pallas_kernel_within_one_ulp() -> None:
    # the reference's Pallas kernel computes the scale in f32 (the TPU has
    # no f64): numeric parity, scale within 1 ulp and q within +-1
    rng = np.random.default_rng(4)
    x = rng.standard_normal(SIZE).astype(np.float32)
    qp, sp = jax.jit(lambda v: pallas_block_quant(v, STEP))(x)
    qp, sp = np.asarray(qp), np.asarray(sp)
    q, s = quant.quant_int8(torch.from_numpy(x)[None], STEP)
    q, s = q.numpy()[0], s.numpy()[0]
    assert sp.shape == s.shape == (5,)
    ulp = np.spacing(s)
    assert (np.abs(sp - s) <= ulp).all()
    assert np.abs(qp.astype(np.int32) - q.astype(np.int32)).max() <= 1
    # the same chunk poisoning on both
    bad = x.copy()
    bad[0] = np.nan
    _, sp2 = jax.jit(lambda v: pallas_block_quant(v, STEP))(bad)
    _, s2 = quant.quant_int8(torch.from_numpy(bad)[None], STEP)
    assert np.isnan(np.asarray(sp2)[0]) and np.isnan(s2.numpy()[0, 0])


def _host_encode(x: np.ndarray, step: int):
    """Per chunk: the host codec's wire bytes, and (q, scale) arrays."""
    codec = _Int8Codec()
    encs, qs, ss = [], [], []
    for c in range(0, x.size, step):
        enc = iov_join(codec.encode_iovecs([x[c:c + step]]))
        encs.append(enc)
        ss.append(np.frombuffer(enc[:4], np.float32)[0])
        qs.append(np.frombuffer(enc[4:], np.int8))
    return encs, np.concatenate(qs), np.array(ss, np.float32)


@pytest.mark.parametrize("n_src,divisor", [(1, 0), (2, 0), (3, 3)])
def test_dequant_acc_plain_matches_decode_into_bitwise(n_src,
                                                       divisor) -> None:
    rng = np.random.default_rng(n_src)
    xs = [(rng.standard_normal(SIZE) * (r + 1)).astype(np.float32)
          for r in range(n_src)]
    xs[0][2 * STEP + 1] = np.inf  # a poisoned chunk decodes to NaN
    codec = _Int8Codec()
    want = np.zeros(SIZE, np.float32)
    q_rows, s_rows = [], []
    for x in xs:
        encs, q, s = _host_encode(x, STEP)
        q_rows.append(q)
        s_rows.append(s)
        for c, enc in enumerate(encs):
            codec.decode_into(enc, [want[c * STEP:(c + 1) * STEP]],
                              lambda v, inc: np.add(v, inc, out=v))
    if divisor:
        np.divide(want, divisor, out=want)
    got = quant.dequant_acc_int8(torch.from_numpy(np.stack(q_rows)),
                                 torch.from_numpy(np.stack(s_rows)), STEP,
                                 divisor=divisor)
    assert got.numpy().tobytes() == want.tobytes()


def test_dequant_acc_shard_grid_and_padding_bitwise() -> None:
    # the final decode of the quantized psum: per-shard grids (seg = shard
    # length L, cps chunks each), one source, padding past `valid` is 0
    n, size = 3, 4001
    L = -(-size // n)
    rng = np.random.default_rng(9)
    acc = np.zeros(n * L, np.float32)
    acc[:size] = rng.standard_normal(size).astype(np.float32)
    cps = quant.n_chunks(L, STEP)
    q_rows, s_rows, want = [], [], np.zeros(n * L, np.float32)
    codec = _Int8Codec()
    for d in range(n):
        shard = acc[d * L:(d + 1) * L]
        encs, q, s = _host_encode(shard, STEP)
        q_rows.append(q)
        s_rows.append(s)
        for c, enc in enumerate(encs):
            codec.decode_into(enc, [want[d * L + c * STEP:
                                         d * L + min(L, (c + 1) * STEP)]],
                              lambda v, inc: np.copyto(v, inc))
    want[size:] = 0.0
    q = torch.from_numpy(np.concatenate(q_rows))[None]
    s = torch.from_numpy(np.concatenate(s_rows))[None]
    got = quant.dequant_acc_int8(q, s, STEP, valid=size, seg=L, cps=cps)
    assert got.numpy().tobytes() == want.tobytes()


def test_wrappers_refuse_bad_arguments() -> None:
    x = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="step"):
        quant.quant_int8(x, 0)
    q = torch.zeros((1, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="valid"):
        quant.dequant_acc_int8(q, torch.ones((1, 1)), 8, valid=9)
