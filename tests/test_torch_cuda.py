"""The port's CUDA kernels on the card (skipped without a GPU).

The kernels have no CPU mode, so these tests hold them against their plain
PyTorch versions on the card, small shapes in bf16, under
``flash.KERNEL_TOL``: each element within one bf16 ulp of the plain
version's (plus 1e-4), the relative norm of the difference at most 1e-3,
lse within 1e-5, at S = 64, 128, 192, 256 and 1024 (and 2048 at head_dim
128), at every head_dim the kernels take (16, 32, 64, 128). A build of the
kernels that rounds P and dS to plain bf16 for its products
(``-DTFT_SPLIT_LO=0``) must fail that check at every head_dim. The GPT
runs on the card through the kernels at "tiny" as configured (head_dim
16) and widened to head_dim 128, and the example's ``train_group`` trains
"tiny" there, and the DiLoCo example's drill (kill, poisoned restart,
heal at a round's fence) runs there bitwise. The int8 codec kernels
(``ops/quant.py``) are held to their plain versions bitwise (tolerance 0,
NaN bit patterns included), ``quant_int8`` also at the shapes of
chip_smoke.py's ``quant_cases`` (unaligned rows, n around the step, a NaN
in a chunk's last slice, the drill's bucket shapes of both phases),
``dequant_acc_int8`` at its ``dequant_cases`` (boundaries inside its
16-element runs, unaligned rows, the bucket shapes of both phases), and a
build of the dequantizer that leaves ``acc + q * scale`` to FMA
contraction must fail that. The fused train step
(``models.make_train_step``, one CUDA graph) equals the same step run
eagerly bitwise, over 3 steps, across a heal's in-place load and across a
load that replaces the optimizer's tensors (a re-capture), also while
another thread keeps launching; its replays count the flash launches the
capture recorded, and a capture holds while another thread runs eager
steps, the codec kernels and stream syncs. The hierarchical plane
(``CudaCommContext(topology="hier")``) runs through the codec kernels on
the card bitwise with the CPU plane and ``_host_hier_allreduce`` (star),
and within its bound (psum). DiLoCo's sharded outer update at "tiny"
with one group's wire in a ``SubprocessCommContext`` child commits its
round bitwise the replicated arm's, and the child holds no CUDA context.
This file imports no
JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import copy
import dataclasses
import importlib.util
import os
import shutil

import pytest
import torch

from torchft_tpu_torch.models import CONFIGS, GPT
from torchft_tpu_torch.ops import _build, attention, flash, quant

# the GPT's loss with the kernels against the same model on the CPU path,
# whose reference attention rounds P to bf16 before P V
LOSS_TOL = 2e-2
# the kernel's attention against reference attention on the same bf16
# values in f32 (P stays f32), per element (|got - want| <= atol + rtol
# |want|) and in relative norm. On the bf16 inputs themselves the
# reference rounds P to bf16 and, at head_dim 16, that alone moves
# elements past this bound (1.68x it against an f64 attention on an H100),
# where the kernels stay within 0.24x of it at every head_dim
REF_ATOL, REF_RTOL, REF_REL_NORM = 1e-3, 2.0 ** -6, 1e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _kernels_and_plain(causal, seed=0, shape=(2, 256, 4, 64)):
    """[(what, kernel result, plain result)] for all three kernels."""
    b, s, h, d = shape
    blk = 128 if s % 128 == 0 else 64  # the plain versions' block sizes
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = flash.flash_fwd(q, k, v, causal, scale)
    p_out, p_lse = flash.flash_fwd_plain(q, k, v, causal, scale, blk, blk)
    delta = (do.float() * p_out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = flash.flash_block_attention_bwd(q, k, v, do, p_lse, delta,
                                                 causal, block_q=blk,
                                                 block_k=blk)
    pq = flash.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, causal, scale,
                                  blk, blk)
    pk, pv = flash.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, causal,
                                       scale, blk, blk)
    torch.cuda.synchronize()
    return [("out", out, p_out), ("lse", lse, p_lse), ("dq", dq, pq),
            ("dk", dk, pk), ("dv", dv, pv)]


HEAD_DIMS = flash.KERNEL_HEAD_DIMS  # the kernels' instantiations


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_on_card(causal, d) -> None:
    _cuda()
    for what, got, want in _kernels_and_plain(causal, shape=(2, 256, 4, d)):
        err = flash.kernel_error(got, want)
        assert err["ok"], (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d, s", [(d, s) for d in HEAD_DIMS
                                  for s in (64, 128, 192, 1024)]
                         + [(128, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_at_tile_edges(causal, d, s) -> None:
    """The forward and dQ tile queries by 192 rows (three warpgroups of
    64; 128 rows, two, at head_dim 128), dK/dV keys by 128 (two): S = 64
    and 128 leave warpgroups idle (and, at 64, a dK/dV one), S = 192 is one
    full 192-row block (one and a half of 128) and one and a half dK/dV
    blocks, S = 1024 is the 125m length with a 64-row last 192-row block,
    and S = 2048 the 1b length (head_dim 128 only); B * H = 3 is odd."""
    _cuda()
    for what, got, want in _kernels_and_plain(causal, seed=s,
                                              shape=(1, s, 3, d)):
        err = flash.kernel_error(got, want)
        assert err["ok"], (s, d, what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_tolerance_rejects_plain_bf16_products(causal, d, tmp_path_factory,
                                               monkeypatch) -> None:
    """Drop the lo term of the hi + lo split from every kernel
    (``-DTFT_SPLIT_LO=0``: P and dS then enter the tensor cores as plain
    bf16): every bf16 result must fail the check, at every head_dim."""
    _cuda()
    mutant = _build.build_library(
        _build._CSRC, str(tmp_path_factory.getbasetemp() / "split_lo_0"),
        extra_flags=["-DTFT_SPLIT_LO=0"])
    monkeypatch.setattr(_build, "_lib", mutant)
    for what, got, want in _kernels_and_plain(causal, shape=(2, 256, 4, d)):
        err = flash.kernel_error(got, want)
        print(f"bf16 products, causal={causal}, head_dim {d}: {what} {err}")
        if what != "lse":  # the forward's lse takes no product with P
            assert not err["ok"], (what, err)


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take() -> None:
    _cuda()
    x = torch.zeros((1, 128, 2, 64), device="cuda")  # f32: not taken
    with pytest.raises(ValueError, match="bf16"):
        flash.flash_attention(x, x, x)
    y = torch.zeros((1, 128, 2, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="got head_dim 48"):
        flash.flash_attention(y, y, y)
    # the C entry points refuse any other head size themselves
    lib = _build.load_kernels()
    z = torch.zeros((1, 128, 2, 48), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 128), device="cuda")
    rc = lib.tft_flash_fwd(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                           z.data_ptr(), lse.data_ptr(), 1, 128, 2, 48, 1.0,
                           1, torch.cuda.current_stream().cuda_stream)
    assert rc == 1  # cudaErrorInvalidValue


@pytest.mark.cuda
@pytest.mark.parametrize("widen", [False, True], ids=["tiny", "head_dim128"])
def test_model_on_card_runs_the_kernels(widen) -> None:
    """"tiny" as configured (head_dim 16), and widened to two heads of
    128, through the kernels; its loss against the same model on the CPU
    path."""
    _cuda()
    cfg = CONFIGS["tiny"]
    if widen:
        cfg = dataclasses.replace(cfg, d_model=256, n_heads=2)
    model = GPT(cfg)  # the default device is cuda
    tok = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len),
                        device="cuda")
    flash.reset_launch_counts()
    loss = model.loss(tok, torch.roll(tok, -1, dims=1))
    loss.backward()
    assert all(n == cfg.n_layers for n in flash.LAUNCHES.values())
    # the same model on the CPU path (reference attention) agrees
    cpu = GPT(cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        ref = cpu.loss(tok.cpu(), torch.roll(tok.cpu(), -1, dims=1))
    assert abs(loss.item() - ref.item()) <= LOSS_TOL
    x = torch.randn((1, 128, 2, cfg.head_dim),
                    device="cuda").to(torch.bfloat16)
    got = attention.causal_attention(x, x, x).double()
    xf = x.float()
    want = attention.reference_attention(xf, xf, xf).double()
    diff = (got - want).abs()
    assert bool((diff <= REF_ATOL + REF_RTOL * want.abs()).all())
    assert float(diff.norm() / want.norm()) <= REF_REL_NORM


# ----------------------------------------------------- the int8 codec


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _quant_cases(step=1024, size=5000, n=3, seed=0):
    """[(what, kernel result, plain result)] of both codec kernels at the
    quantized psum's three call shapes: phase-1 quantize of n rows, owner
    decode-accumulate with AVG over the padded (n, n·L) rows, and the
    shard-grid quantize + decode of the reduced shards."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, size), generator=gen, device="cuda") * 3
    x[0, step:2 * step] = 0.0             # an all-zero chunk: scale 1
    x[0, 2 * step + 5] = float("nan")     # poisons its own chunk only
    x[1, 3 * step + 17] = float("inf")
    L = -(-size // n)
    q = torch.zeros((n, n * L), dtype=torch.int8, device="cuda")
    s = torch.empty((n, quant.n_chunks(size, step)), device="cuda")
    quant.quant_int8(x, step, out=(q[:, :size], s))
    pq, ps = quant.quant_int8_plain(x, step)
    acc = quant.dequant_acc_int8(q, s, step, valid=size, divisor=n)
    p_acc = quant.dequant_acc_int8_plain(q, s, step, valid=size, divisor=n)
    c2 = quant.n_chunks(L, step)
    q2, s2 = quant.quant_int8(acc.view(n, L), step)
    pq2, ps2 = quant.quant_int8_plain(acc.view(n, L), step)
    out = quant.dequant_acc_int8(q2.view(1, -1), s2.view(1, -1), step,
                                 valid=size, seg=L, cps=c2)
    p_out = quant.dequant_acc_int8_plain(q2.view(1, -1), s2.view(1, -1),
                                         step, valid=size, seg=L, cps=c2)
    torch.cuda.synchronize()
    return [("q", q[:, :size], pq), ("scales", s, ps), ("acc", acc, p_acc),
            ("q2", q2, pq2), ("scales2", s2, ps2), ("out", out, p_out)]


@pytest.mark.cuda
def test_quant_kernels_match_plain_bitwise_on_card() -> None:
    _cuda()
    quant.reset_launch_counts()
    for what, got, want in _quant_cases():
        assert torch.equal(_bits(got), _bits(want)), what
    assert quant.LAUNCHES == {"quant_int8": 2, "dequant_acc_int8": 2}
    with pytest.raises(ValueError, match="float32"):
        quant.quant_int8(torch.zeros((1, 8), device="cuda",
                                     dtype=torch.float16), 8)


@pytest.mark.cuda
def test_bitwise_check_rejects_fma_contraction(tmp_path, monkeypatch) -> None:
    """Leave acc + q * scale to nvcc's default FMA contraction in the
    dequantizer: the product's rounding is skipped and the owner sums must
    differ from the plain version's."""
    _cuda()
    src = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, src)
    cu = src / "quant_int8.cu"
    text = cu.read_text()
    exact = "return __fadd_rn(acc, __fmul_rn(v, s));"
    assert text.count(exact) == 1
    cu.write_text(text.replace(exact, "return acc + v * s;"))
    monkeypatch.setattr(_build, "_lib", _build.build_library(
        str(src), str(tmp_path / "build")))
    cases = {what: (got, want) for what, got, want in _quant_cases()}
    got, want = cases["acc"]
    diff = int((_bits(got) != _bits(want)).sum())
    print(f"FMA-contracted dequantizer: {diff} of {got.numel()} sums differ")
    assert diff > 0


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 3])
def test_device_plane_on_card_equals_cpu_plane(world) -> None:
    """The gradient plane through the kernels on the card against the same
    plane on the CPU (plain versions), bitwise: star/ring at every codec
    (their AVG divides included) and the quantized psum."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool

    _cuda()
    rng = np.random.default_rng(world)
    inputs = [[(rng.standard_normal(5000) * (r + 1)).astype(np.float32),
               rng.standard_normal(257).astype(np.float32)]
              for r in range(world)]
    pools = {"cuda": DevicePool("cuda"), "cpu": DevicePool("cpu")}

    def run(device, algo, codec, op, tag):
        ctxs = [CudaCommContext(timeout=30.0, algorithm=algo,
                                compression=codec, chunk_bytes=1 << 12,
                                device_pool=pools[device])
                for _ in range(world)]

        def worker(r):
            ctxs[r].configure(f"card://{tag}/{device}", r, world)
            w = ctxs[r].allreduce([a.copy() for a in inputs[r]], op)
            return [np.array(a) for a in w.future().result(timeout=30)]

        try:
            with ThreadPoolExecutor(world) as ex:
                return [f.result(60) for f in
                        [ex.submit(worker, r) for r in range(world)]]
        finally:
            for c in ctxs:
                c.shutdown()

    quant.reset_launch_counts()
    for algo in ("star", "ring", "psum"):
        for codec in ("none", "bf16", "fp16", "int8"):
            for op in (ReduceOp.SUM, ReduceOp.AVG):
                tag = f"{world}_{algo}_{codec}_{op}"
                card = run("cuda", algo, codec, op, tag)
                host = run("cpu", algo, codec, op, tag)
                if algo == "psum" and codec == "none":
                    continue  # the plain sum's order is the library's
                for c_r, h_r in zip(card, host):
                    for c, h in zip(c_r, h_r):
                        assert c.tobytes() == h.tobytes(), tag
    # psum int8: 2 launches of each kernel per array per allreduce (2 ops)
    assert quant.LAUNCHES["quant_int8"] >= 2 * 2 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["2x2", "uneven"])
def test_hier_plane_on_card(layout) -> None:
    """``CudaCommContext(topology="hier")`` through the kernels on the card:
    the star composition bitwise equal to the same plane on the CPU and to
    ``_host_hier_allreduce`` at every codec, with 2 launches of each codec
    kernel per f32 array per int8 op; the psum composition identical on
    every rank, within 3 * absmax / 100 of the f64 sum (int8), with 1
    launch of each per array."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import (
        CudaCommContext,
        DevicePool,
        _host_hier_allreduce,
    )
    from torchft_tpu_torch.comm.topology import DomainTopology

    _cuda()
    smap, groups = {
        "2x2": ({"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]},
                ((0, 1), (2, 3))),
        "uneven": ({"d0": ["rank0", "rank2"], "d1": ["rank1"],
                    "d2": ["rank3"]}, ((0, 2), (1,), (3,))),
    }[layout]
    rng = np.random.default_rng(7)
    inputs = [[(rng.standard_normal(5000) * (r + 1)).astype(np.float32),
               rng.standard_normal(257).astype(np.float32)]
              for r in range(4)]
    pools = {"cuda": DevicePool("cuda"), "cpu": DevicePool("cpu")}

    def run(device, algo, codec, op):
        ctxs = [CudaCommContext(timeout=30.0, algorithm=algo,
                                compression=codec, chunk_bytes=1 << 12,
                                device_pool=pools[device], topology="hier",
                                domain_resolver=DomainTopology(
                                    static_map=smap))
                for _ in range(4)]

        def worker(r):
            ctxs[r].configure(f"card://hier/{layout}/{device}/{algo}/"
                              f"{codec}/{op}", r, 4)
            w = ctxs[r].allreduce([a.copy() for a in inputs[r]], op)
            return [np.array(a) for a in w.future().result(timeout=30)]

        try:
            with ThreadPoolExecutor(4) as ex:
                return [f.result(60) for f in
                        [ex.submit(worker, r) for r in range(4)]]
        finally:
            for c in ctxs:
                c.shutdown()

    for codec in ("none", "bf16", "fp16", "int8"):
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            quant.reset_launch_counts()
            card = run("cuda", "star", codec, op)
            if codec == "int8":
                assert quant.LAUNCHES == {"quant_int8": 4,
                                          "dequant_acc_int8": 4}
            host = run("cpu", "star", codec, op)
            want = _host_hier_allreduce(
                [[a.copy() for a in per] for per in inputs], codec, 1 << 12,
                op, groups, 4)
            for c_r, h_r in zip(card, host):
                for c, h, w in zip(c_r, h_r, want):
                    assert c.tobytes() == h.tobytes() == w.tobytes(), (
                        codec, op)
    quant.reset_launch_counts()
    psum = run("cuda", "psum", "int8", ReduceOp.SUM)
    assert quant.LAUNCHES == {"quant_int8": 2, "dequant_acc_int8": 2}
    for j in range(2):
        assert len({r[j].tobytes() for r in psum}) == 1
        exact = np.sum([per[j] for per in inputs], axis=0, dtype=np.float64)
        absmax = max(float(np.abs(per[j]).max()) for per in inputs)
        assert float(np.abs(psum[0][j] - exact).max()) <= 3 * absmax / 100


# the 125m drill's DDP bucket sizes (tests/test_torch_chip_smoke.py)
BUCKETS = (787968, 4718592, 7080960, 8262144, 25165824)


def _smoke_cases(name, step, sizes):
    """chip_smoke.py's ``quant_cases`` or ``dequant_cases`` on the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return getattr(smoke, name)(step, step, "cuda", sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1000, 1 << 18, 1 << 20])
def test_quant_kernel_matches_plain_at_odd_shapes(step) -> None:
    """The cluster kernel against its plain version, bitwise, at rows of x
    and q that start unaligned, n = 1, step - 1, step and step + 1, a NaN
    in the last CTA's slice of a chunk and, on the plane's 1 MiB grid, the
    drill's five bucket sizes at both phases' shapes; a grid of 1000 puts
    chunk starts off 16-byte alignment, one of 4 MiB gives each CTA more
    than it holds."""
    _cuda()
    sizes = BUCKETS if step == 1 << 18 else ()
    for what, x, q, s in _smoke_cases("quant_cases", step, sizes):
        quant.quant_int8(x, step, out=(q, s))
        pq, ps = quant.quant_int8_plain(x, step)
        torch.cuda.synchronize()
        assert torch.equal(q, pq), what
        assert torch.equal(_bits(s), _bits(ps)), what


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1000, 1 << 18])
def test_dequant_kernel_matches_plain_at_run_boundaries(step) -> None:
    """The 16-element-run kernel against its plain version, bitwise, where
    chunk and shard boundaries and ``valid`` fall inside runs, rows start
    off 16-byte alignment, fewer elements than a run; and, on the plane's
    1 MiB grid, the quantized psum's two decodes at the drill's five
    bucket sizes, phase 1 also with its rows starting at byte 1."""
    _cuda()
    quant.reset_launch_counts()
    cases = _smoke_cases("dequant_cases", step,
                         BUCKETS if step == 1 << 18 else ())
    for what, q, s, kw in cases:
        got = quant.dequant_acc_int8(q, s, step, **kw)
        want = quant.dequant_acc_int8_plain(q, s, step, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), what
    assert quant.LAUNCHES["dequant_acc_int8"] == len(cases)


@pytest.mark.cuda
def test_example_trains_tiny_on_card() -> None:
    """The example's train_group at its default config ("tiny", head_dim
    16) on the card, one group: every step commits, the losses are finite,
    and each flash kernel launched once per layer per pass."""
    import math

    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.examples.train_ddp import train_group

    _cuda()
    cfg = CONFIGS["tiny"]
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=100)
    flash.reset_launch_counts()
    try:
        run = train_group(cfg, replica_group=0, num_groups=1, total_steps=3,
                          lighthouse_addr=lighthouse.address(),
                          batch_size=4, timeout=30.0)
    finally:
        lighthouse.shutdown()
    assert sorted(run.losses) == [1, 2, 3]
    assert all(math.isfinite(v) for v in run.losses.values())
    assert flash.LAUNCHES == {n: run.passes * cfg.n_layers
                              for n in flash.LAUNCHES}


@pytest.mark.cuda
def test_diloco_drill_tiny_on_card() -> None:
    """The DiLoCo example's drill at "tiny" on the card: two groups over
    TCP, each inner step one CUDA graph replay, group 1 killed at inner step
    4 of round 3, restarted poisoned, healed at round 4's fence; every round
    both commit is bitwise equal across the groups (the healed group equal
    to its donor), and each flash kernel launched once per layer per pass,
    the captures' warm-up passes included."""
    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill

    _cuda()
    cfg = CONFIGS["tiny"]
    flash.reset_launch_counts()
    result = run_diloco_drill(cfg, device="cuda", batch_size=4, timeout=60.0)
    assert result["checked_rounds"] == {1: 2, 2: 2, 4: 2, 5: 2}
    assert result["runs"][1][1].healed_at == [4]
    assert all(r.captures == 1 for g in result["runs"]
               for r in result["runs"][g])
    assert result["passes"] == 40 + 19 + 16 + 3  # + one warm-up a capture
    assert flash.LAUNCHES == {n: result["passes"] * cfg.n_layers
                              for n in flash.LAUNCHES}


def _fused_pair(cfg, seed=0):
    """Two copies of one model and AdamW (capturable), and a train step on
    the second: the eager and the graph arm of the same step."""
    from torchft_tpu_torch.models import make_train_step

    arms = []
    for _ in range(2):
        model = GPT(cfg, device="cuda", seed=seed)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4, capturable=True)
        arms.append((model, opt, make_train_step(model, opt)))
    return arms


def _tiny_batches(cfg, n, seed=0, batch=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        tok = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                            generator=gen, device="cuda")
        out.append((tok, torch.roll(tok, -1, dims=1)))
    return out


def _assert_arms_equal(a, b, what):
    (ma, oa, _), (mb, ob, _) = a, b
    for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(pa, pb), f"{what}: {name}"
        for k in oa.state[pa]:
            assert torch.equal(oa.state[pa][k], ob.state[pb][k]), \
                f"{what}: {name} {k}"


@pytest.mark.cuda
def test_fused_graph_step_equals_eager_across_a_heal() -> None:
    from torchft_tpu_torch.optim import load_optimizer_state_dict

    _cuda()
    cfg = CONFIGS["tiny"]
    eager, graph = _fused_pair(cfg)
    batches = _tiny_batches(cfg, 9)
    for tok, tgt in batches[:3]:
        le = eager[2]._eager(tok, tgt)
        lg = graph[2](tok, tgt)
        assert torch.equal(le, lg)
    assert graph[2].captures == 1
    _assert_arms_equal(eager, graph, "3 steps")
    # a heal: the donor's state loaded in place into both arms; the graph
    # keeps its capture
    donor_model, donor_opt, donor_step = _fused_pair(cfg, seed=7)[0]
    for tok, tgt in _tiny_batches(cfg, 2, seed=3):
        donor_step._eager(tok, tgt)
    for model, opt, _ in (eager, graph):
        model.load_state_dict(donor_model.state_dict())
        load_optimizer_state_dict(opt, donor_opt.state_dict())
    graph[2].sync_state()
    for tok, tgt in batches[3:6]:
        eager[2]._eager(tok, tgt)
        graph[2](tok, tgt)
    assert graph[2].captures == 1
    _assert_arms_equal(eager, graph, "after an in-place heal")
    # a load that replaces the optimizer's tensors: the next call
    # re-captures, and the arms stay equal (each arm loads its own copy:
    # load_state_dict keeps a tensor already of the right dtype and device,
    # so two arms loading one dict would share their moments)
    for model, opt, _ in (eager, graph):
        opt.load_state_dict(copy.deepcopy(donor_opt.state_dict()))
        model.load_state_dict(donor_model.state_dict())
    for tok, tgt in batches[6:]:
        eager[2]._eager(tok, tgt)
        graph[2](tok, tgt)
    assert graph[2].captures == 2
    _assert_arms_equal(eager, graph, "after a replacing load")


@pytest.mark.cuda
def test_graph_replays_count_the_captured_launches() -> None:
    _cuda()
    cfg = CONFIGS["tiny"]
    _, (_, _, step) = _fused_pair(cfg)
    flash.reset_launch_counts()
    for tok, tgt in _tiny_batches(cfg, 4):
        step(tok, tgt)
    passes = 4 + step.warmup_passes
    assert step.captures == 1 and step.warmup_passes == 1
    assert flash.LAUNCHES == {n: passes * cfg.n_layers
                              for n in flash.LAUNCHES}


@pytest.mark.cuda
def test_capture_while_another_thread_launches() -> None:
    # two replica groups share a process: one captures while the other
    # keeps running eager steps through the kernels and host syncs
    import threading

    _cuda()
    cfg = CONFIGS["tiny"]
    eager, graph = _fused_pair(cfg)
    other_model = GPT(cfg, device="cuda", seed=3)
    stop, errors, other_passes = threading.Event(), [], [0]

    def other():
        try:
            for tok, tgt in _tiny_batches(cfg, 50, seed=4):
                if stop.is_set():
                    return
                other_model.zero_grad(set_to_none=True)
                other_model.loss(tok, tgt).backward()
                # the int8 plane's codec kernels, as a wire step runs them
                grad = other_model.wte.embedding.grad.reshape(2, -1)
                q, scales = quant.quant_int8(grad, 1 << 12)
                quant.dequant_acc_int8(q, scales, 1 << 12)
                # a stream sync, as the example's step takes: a device-wide
                # sync during a capture would invalidate it
                torch.cuda.current_stream().synchronize()
                other_passes[0] += 1
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    flash.reset_launch_counts()
    quant.reset_launch_counts()
    thread = threading.Thread(target=other)
    thread.start()
    try:
        for tok, tgt in _tiny_batches(cfg, 3):
            eager[2]._eager(tok, tgt)
            graph[2](tok, tgt)
    finally:
        stop.set()
        thread.join()
    assert not errors, errors
    torch.cuda.synchronize()
    _assert_arms_equal(eager, graph, "beside another thread")
    passes = 3 + 3 + graph[2].warmup_passes + other_passes[0]
    assert flash.LAUNCHES == {n: passes * cfg.n_layers
                              for n in flash.LAUNCHES}
    assert quant.LAUNCHES == {n: other_passes[0] for n in quant.LAUNCHES}


@pytest.mark.cuda
def test_cuda_train_step_refuses_what_it_cannot_capture() -> None:
    from torchft_tpu_torch.models import make_train_step

    _cuda()
    model = GPT(CONFIGS["tiny"], device="cuda")
    with pytest.raises(ValueError, match="capturable"):
        make_train_step(model, torch.optim.AdamW(model.parameters()))
    with pytest.raises(TypeError, match="Adam"):
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))


@pytest.mark.cuda
def test_prefetch_iterator_lands_batches_on_the_card() -> None:
    import numpy as np

    from torchft_tpu_torch.data import PrefetchIterator

    _cuda()
    src = ({"x": np.full((1 << 16,), i, np.float32)} for i in range(6))
    it = PrefetchIterator(src, depth=2)
    for i, batch in enumerate(it):
        assert batch["x"].is_cuda
        # read on the consumer's stream: the copy has landed
        assert float(batch["x"].sum()) == float(i * (1 << 16))
    it.close()


@pytest.mark.cuda
def test_template_heal_lands_on_the_card() -> None:
    # a template on the card: each region lands in pinned memory and is
    # uploaded on the heal's side stream; the result has the template's
    # devices and dtypes and the donor's bits (a CPU step count stays on
    # the CPU, as the template's), striped over two donors
    _cuda()
    from torchft_tpu_torch import checkpointing as cp
    from torchft_tpu_torch.utils.metrics import Metrics

    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(4096, 64, generator=gen),
             "b": torch.randn(7, generator=gen).to(torch.bfloat16),
             "step": torch.tensor(3.0), "torchft": {"step": 2}}
    template = {"w": torch.empty(4096, 64, device="cuda"),
                "b": torch.empty(7, dtype=torch.bfloat16, device="cuda"),
                "step": torch.tensor(0.0), "torchft": {"step": 0}}
    donors = [cp.CheckpointServer(timeout=30.0) for _ in range(2)]
    metrics = Metrics()
    try:
        donors[0].set_peers([donors[1].metadata()])
        for d in donors:
            d.send_checkpoint([], 2, state, 30.0)
        got = cp.recv_checkpoint_sharded(donors[0].metadata(), 2, template,
                                         timeout=30.0, metrics=metrics,
                                         stripe_bytes=1 << 16)
    finally:
        for d in donors:
            d.shutdown()
    for k in ("w", "b", "step"):
        assert got[k].device == template[k].device
        assert got[k].dtype == state[k].dtype
        assert torch.equal(got[k].cpu(), state[k])
    assert got["torchft"] == {"step": 2}
    snap = metrics.snapshot()
    assert snap["heal_h2d_avg_ms"] >= 0.0 and snap["heal_wire_bytes"] > 0


@pytest.mark.cuda
def test_sharded_diloco_with_a_wire_child_on_card() -> None:
    """DiLoCo's sharded outer update at "tiny" on the card, three groups,
    group 2's wire in a ``SubprocessCommContext`` child: the child holds no
    CUDA context (the device's free memory does not move when it starts;
    it maps ``libcuda``, as any process that imports torch does, which
    alone makes no context), and the committed round is bitwise the
    replicated arm's (``sharded_outer=False``, the same seeds), each group
    holding exactly its own fragment's outer state."""
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.subproc import SubprocessCommContext
    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill

    _cuda()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    store = StoreServer()
    ctx = SubprocessCommContext(timeout=30.0)
    try:
        ctx.configure(f"{store.addr}/card_child", 0, 1)
        free1 = torch.cuda.mem_get_info()[0]
    finally:
        ctx.shutdown()
        store.shutdown()
    assert free0 - free1 < 64 * (1 << 20), (free0, free1)
    cfg = CONFIGS["tiny"]
    arms = {}
    for sharded in (False, True):
        arms[sharded] = run_diloco_drill(
            cfg, device="cuda", batch_size=4, timeout=60.0, groups=3,
            rounds=1, kill=None, num_fragments=3, subproc_groups=(2,),
            sharded_outer=sharded, keep_params=(1,))
    assert arms[True]["checked_rounds"] == {1: 3}
    assert all(torch.equal(a, b) for a, b in zip(arms[True]["params"][1],
                                                 arms[False]["params"][1]))
    assert arms[True]["held"][1] == {g: [g] for g in range(3)}
