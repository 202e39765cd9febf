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
  payload, on per-shard grids, with padding and with the AVG division;
- ``quant_int8`` against the host codec, bitwise, at the shapes the kernel
  must handle (chip_smoke.py's ``quant_cases``): rows of x and of q that
  start unaligned, n = 1, step - 1, step and step + 1, a NaN in the last
  slice of a chunk, and the int8 drill's five DDP bucket sizes at both
  phases' shapes, on a small grid;
- ``dequant_acc_int8`` against the host codec's ``decode_into`` in rank
  order, bitwise, where the kernel's 16-element runs meet a boundary
  (chip_smoke.py's ``dequant_cases``): chunk and shard boundaries and
  ``valid`` inside a run, rows of q off 16-byte alignment, fewer elements
  than a run.
"""

import importlib.util
import os

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
# the 125m drill's DDP bucket sizes (tests/test_torch_chip_smoke.py)
BUCKETS = (787968, 4718592, 7080960, 8262144, 25165824)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _assert_host_codec_bitwise(x: torch.Tensor, q: torch.Tensor,
                               s: torch.Tensor, step: int) -> None:
    """q and s equal the host codec's, chunk by chunk, bit for bit."""
    xn, qn, sn = x.numpy(), q.numpy(), s.numpy()
    rows, n = xn.shape
    assert sn.shape == (rows, quant.n_chunks(n, step))
    for r in range(rows):
        for c in range(sn.shape[1]):
            sc_h, q_h = _Int8Codec._quantize(xn[r, c * step:(c + 1) * step])
            assert np.float32(sc_h).tobytes() == sn[r, c].tobytes(), (r, c)
            assert q_h.tobytes() == qn[r, c * step:c * step + q_h.size] \
                .tobytes(), (r, c)


_ODD_CASES = ("unaligned rows of x and q", "n = 1", "n = 999", "n = 1000",
              "n = 1001", "NaN in a chunk's last slice")


@pytest.mark.parametrize("what", _ODD_CASES)
def test_quant_plain_matches_host_codec_at_odd_shapes(what) -> None:
    """On a grid of 1000 (chunks start off 16-byte alignment): strided rows
    of x (stride 1 mod 4) into a column slice of a wider q buffer (rows on
    odd bytes), n around the step, a NaN near the end of a chunk."""
    cases = {w: rest for w, *rest in _smoke().quant_cases(1000, 3, "cpu")}
    assert tuple(cases) == _ODD_CASES
    x, q, s = cases[what]
    if what.startswith("unaligned"):
        assert x.stride(0) % 4 == 1 and q.storage_offset() % 4 == 1
    quant.quant_int8(x, 1000, out=(q, s))
    _assert_host_codec_bitwise(x, q, s, 1000)
    if what.startswith("NaN"):
        assert np.isnan(s[1, 1].item()) and not (q[1, 1000:2000] != 0).any()
        assert torch.isfinite(s[0]).all() and torch.isfinite(s[1, ::2]).all()


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("size", BUCKETS)
def test_quant_plain_matches_host_codec_at_bucket_shapes(size, phase) -> None:
    """The quantized psum's two calls at each bucket size of the drill, two
    groups: phase 1 on [2, size] into q[:, :size] of a [2, 2 L] buffer,
    phase 2 on a [2, L] view of the reduced shards; on a grid of 16,384
    (the plane's is 262,144) to keep the host codec's loop short."""
    step = 1 << 14
    cases = {w: rest for w, *rest in
             _smoke().quant_cases(step, size, "cpu", [size])}
    x, q, s = cases[f"bucket {size} phase {phase}"]
    assert x.shape == (2, size if phase == 1 else -(-size // 2))
    quant.quant_int8(x, step, out=(q, s))
    _assert_host_codec_bitwise(x, q, s, step)


def test_reciprocal_shortcut_rounds_as_the_exact_division() -> None:
    """The arithmetic that csrc/quant_int8.cu's quant1 relies on, in numpy
    (f32 operations correctly rounded, as on the card): with rcp =
    f32(1 / scale), rint(f32(v * rcp)) equals rint(f32(v / scale)) unless
    f32(v * rcp) lies within 2^-14 of a half-integer, where the kernel
    takes the exact division; the band holds few values. Scales from
    absmax / 127 over magnitudes 1e-30 to 1e30, plus values on, and one
    ulp either side of, every half-integer quotient."""
    rng = np.random.default_rng(0)
    band = np.float32(0.5 - 2.0 ** -14)
    slow = total = 0
    for _ in range(20):
        x = (rng.standard_normal(2_000_000)
             * 10.0 ** rng.uniform(-30, 30)).astype(np.float32)
        scale = np.float32(np.float64(np.abs(x).max()) / 127.0)
        xs = [x]
        half = ((np.arange(-127, 128) + 0.5) * np.float64(scale)) \
            .astype(np.float32)
        xs += [half, np.nextafter(half, np.float32(np.inf)),
               np.nextafter(half, np.float32(-np.inf))]
        for i, v in enumerate(xs):
            y = v * (np.float32(1) / scale)
            fast = np.abs(y - np.rint(y)) < band
            exact = np.rint(v / scale)
            assert (np.rint(y)[fast] == exact[fast]).all()
            if i == 0:
                slow += int((~fast).sum())
                total += v.size
    share = slow / total
    print(f"exact division taken for {share:.6%} of {total} values")
    assert 0 < share < 1e-3


def _codec_dequant(q: torch.Tensor, s: torch.Tensor, step: int, valid: int,
                   seg=None, cps: int = 0, divisor: int = 0) -> np.ndarray:
    """The decode-accumulate through the host codec: every chunk of every
    source decoded by ``_Int8Codec.decode_into`` (its scale, then its int8
    values) and added in rank order, then the f32 division; 0 past
    ``valid``."""
    qn, sn = q.numpy(), s.numpy()
    n = qn.shape[1]
    seg = n if seg is None else seg
    cps = cps or quant.n_chunks(seg, step)
    codec = _Int8Codec()
    out = np.zeros(n, np.float32)
    for r in range(qn.shape[0]):
        for g in range(quant.n_chunks(valid, seg)):
            for c in range(cps):
                a = g * seg + c * step
                b = min(g * seg + min((c + 1) * step, seg), valid)
                if a >= b:
                    break
                enc = sn[r, g * cps + c].tobytes() + qn[r, a:b].tobytes()
                codec.decode_into(enc, [out[a:b]],
                                  lambda v, inc: np.add(v, inc, out=v))
    if divisor:
        out[:valid] = out[:valid] / np.float32(divisor)
    return out


_RUN_CASES = ("step inside runs, AVG",
              "rows off 16-byte alignment, valid inside a run",
              "shard grid, seg inside runs", "fewer elements than a run")


@pytest.mark.parametrize("what", _RUN_CASES)
def test_dequant_plain_matches_host_codec_at_run_boundaries(what) -> None:
    """On a grid of 1000 (no multiple of 16, so chunk starts fall inside
    the kernel's 16-element runs): the cases of chip_smoke.py's
    ``dequant_cases`` that the kernel handles apart from its plain runs."""
    cases = {w: rest for w, *rest in _smoke().dequant_cases(1000, 7, "cpu")}
    assert tuple(cases) == _RUN_CASES
    q, s, kw = cases[what]
    if what.startswith("rows off"):
        assert q.storage_offset() % 16 == 3 and q.stride(0) % 16 != 0
    if what.startswith("shard"):
        assert kw["seg"] % 16 and 1000 % 16
    got = quant.dequant_acc_int8(q, s, 1000, **kw)
    want = _codec_dequant(q, s, 1000, **kw)
    assert got.numpy().tobytes() == want.tobytes()
