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
The flash-block ring over virtual shards of the card matches the same
ring over CPU shards, and the llama ring example's drill heals bitwise
there. The serving cohort holds its shards on the card, its digests read
back from the card equal to the publication's, while answers race a
deploy. At "125m" each ``OptimizerWrapper`` arm's update allocates what
its memory plan says (decide first: under 8 bytes a parameter; the
overlapped arm: at least its 12-byte backup), the arms end 3 steps
bitwise equal, and a discarded overlapped step is undone bitwise in
place, as is an overlapped step whose update raises part way. This file
imports no
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


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ring_on_card_matches_the_cpu_ring(causal) -> None:
    """The flash-block ring over 4 virtual shards of the card (the flash
    kernels, bf16, shards of 128) against the same ring over 4 CPU shards
    (the kernels' plain versions) on the same bf16 inputs: the output and
    the gradients within the kernels' relative-norm bound, and each
    kernel launched as the ring's schedule says."""
    from torchft_tpu_torch.parallel import (
        ft_mesh,
        make_ring_attention,
        ring_launches,
    )

    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((2, 512, 4, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    results = {}
    for dev in ("cuda", "cpu"):
        ring = make_ring_attention(ft_mesh({"seq": 4}, devices=[dev] * 4),
                                   "seq", causal=causal, block_impl="flash")
        leaves = [x.detach().to(dev).requires_grad_(True) for x in (q, k, v)]
        flash.reset_launch_counts()
        out = ring(*leaves)
        out.backward(do.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert flash.LAUNCHES == ring_launches(4, causal)
        results[dev] = [out.detach().cpu()] + [x.grad.cpu() for x in leaves]
    for what, got, want in zip(("out", "dq", "dk", "dv"), results["cuda"],
                               results["cpu"]):
        err = flash.kernel_error(got, want)
        assert err["rel_norm"] <= 1e-3, (what, err)


@pytest.mark.cuda
def test_llama_ring_drill_tiny_on_card() -> None:
    """The llama ring example's drill at "llama_tiny" (head_dim 16) on the
    card, the flash ring over 2 shards of 64: kill, poisoned restart, heal
    at step 5, both groups bitwise at every step both commit (the drill's
    own checks), and the launches the schedule says."""
    from torchft_tpu_torch.examples.train_llama_ring import (
        run_llama_ring_drill,
    )
    from torchft_tpu_torch.models import LLAMA_CONFIGS
    from torchft_tpu_torch.parallel import ring_launches

    _cuda()
    cfg = LLAMA_CONFIGS["llama_tiny"]
    flash.reset_launch_counts()
    result = run_llama_ring_drill(cfg, ring_impl="flash", seq_shards=2,
                                  device="cuda", timeout=60.0)
    assert result["heal_step"] == 5 and result["passes"] == 13
    per_layer = ring_launches(2, True, cfg.remat)
    assert flash.LAUNCHES == {n: 13 * cfg.n_layers * c
                              for n, c in per_layer.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash", "einsum"])
def test_ring_over_the_cards_equals_the_virtual_ring(impl,
                                                     monkeypatch) -> None:
    """The llama example's ring where there are cards enough, one card a
    shard (``make_seq_ring`` over ``cuda:0`` .. ``cuda:n-1``, n the cards
    up to 4): the rotation crosses cards and the output gathers back to
    q's card. Against the same ring over n virtual shards of ``cuda:0`` on
    the same bf16 inputs, the output and the gradients bitwise, and the
    flash kernels launched as the schedule says."""
    import torchft_tpu_torch.examples.train_llama_ring as example
    from torchft_tpu_torch.parallel import (
        ft_mesh,
        make_ring_attention,
        ring_launches,
    )

    _cuda()
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two cards or more: one card a shard")
    meshes = []

    def spy(axes, devices=None):
        meshes.append(list(devices))
        return ft_mesh(axes, devices=devices)

    monkeypatch.setattr(example, "ft_mesh", spy)
    cfg = example.example_config(256 * n)
    card = torch.device("cuda", 0)
    rings = {"cards": example.make_seq_ring(cfg, card, n, impl),
             "virtual": make_ring_attention(
                 ft_mesh({"seq": n}, devices=[card] * n), "seq",
                 causal=True, block_impl=impl)}
    assert meshes == [[torch.device("cuda", i) for i in range(n)]]
    gen = torch.Generator(device=card).manual_seed(11)
    q, k, v, do = (torch.randn((2, 256 * n, 4, 64), generator=gen,
                               device=card).to(torch.bfloat16)
                   for _ in range(4))
    results = {}
    for arm, ring in rings.items():
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        flash.reset_launch_counts()
        out = ring(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        assert out.device == card
        want = ring_launches(n, True) if impl == "flash" else dict.fromkeys(
            ring_launches(n, True), 0)
        assert flash.LAUNCHES == want
        results[arm] = [out.detach()] + [x.grad for x in leaves]
    for what, got, want in zip(("out", "dq", "dk", "dv"), results["cards"],
                               results["virtual"]):
        assert torch.equal(got, want), what


@pytest.mark.cuda
def test_llama_ring_example_runs_over_the_cards() -> None:
    """``examples/train_llama_ring.py`` as a subprocess on CUDA at its
    defaults but 3 steps: the flash ring over ``SEQ_SHARDS`` = the visible
    cards, one card a shard."""
    import subprocess
    import sys

    from torchft_tpu_torch.control import Lighthouse

    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lh = Lighthouse(min_replicas=1, join_timeout_ms=200)
    env = dict(os.environ, TORCHFT_TPU_LIGHTHOUSE=lh.address(),
               REPLICA_GROUP_ID="0", LOGLEVEL="ERROR", TOTAL_STEPS="3",
               RING_IMPL="flash")
    env.pop("DEVICE", None)
    env.pop("SEQ_SHARDS", None)
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "torchft_tpu_torch.examples.train_llama_ring"], env=env,
            capture_output=True, text=True, timeout=300, cwd=root)
    finally:
        lh.shutdown()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 3" in proc.stdout, proc.stdout


@pytest.mark.cuda
def test_hsdp_drill_tiny_on_card() -> None:
    """The HSDP example's drill at "tiny" (head_dim 16) on a ``{"fsdp": 2,
    "tensor": 2}`` mesh (virtual on one card, a card a position on four):
    kill, poisoned restart,
    heal into the sharded template at 5, every piece bitwise at every step
    both commit (the drill's own checks), and one attention per layer per
    position per pass."""
    from torchft_tpu_torch.examples.train_hsdp import run_hsdp_drill
    from torchft_tpu_torch.models import CONFIGS

    _cuda()
    cfg = CONFIGS["tiny"]
    flash.reset_launch_counts()
    result = run_hsdp_drill(cfg, {"fsdp": 2, "tensor": 2}, steps=7,
                            kill_after=3, device="cuda", timeout=60.0)
    assert result["heal_step"] == 5 and result["passes"] == 13
    assert result["checked_steps"] == [1, 2, 3, 5, 6, 7]
    per = 13 * cfg.n_layers * 4
    assert flash.LAUNCHES == {"flash_fwd": per, "flash_bwd_dq": per,
                              "flash_bwd_dkv": per}


def ft_mesh_virtual(n: int):
    """``{"fsdp": 2, "tensor": n // 2}`` over n positions of ``cuda:0``."""
    from torchft_tpu_torch.parallel import ft_mesh

    return ft_mesh({"fsdp": 2, "tensor": n // 2},
                   devices=[torch.device("cuda", 0)] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_sharded_gpt_over_the_cards_equals_the_virtual_mesh(remat) -> None:
    """The sharded "tiny" over ``cuda:0`` .. ``cuda:3`` (``{"fsdp": 2,
    "tensor": 2}``, one card a position: the gathers, the row-parallel
    sums and the vocab-parallel combination cross cards) against the same
    model over 4 virtual positions of ``cuda:0``: the loss and every
    gradient piece bitwise, the parameter pieces on their cards, and the
    flash kernels launched once per layer per position (twice forward
    under remat)."""
    import dataclasses

    from torchft_tpu_torch.models import CONFIGS, ShardedGPT
    from torchft_tpu_torch.parallel import ft_mesh

    _cuda()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: one card a mesh position")
    cfg = dataclasses.replace(CONFIGS["tiny"], remat=remat, xent_chunks=2)
    axes = {"fsdp": 2, "tensor": 2}
    cards = [torch.device("cuda", i) for i in range(4)]
    meshes = {"cards": ft_mesh(axes, devices=cards),
              "virtual": ft_mesh_virtual(4)}
    gen = torch.Generator(device="cpu").manual_seed(12)
    tok = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len),
                        generator=gen)
    tgt = torch.roll(tok, -1, dims=1)
    results = {}
    for arm, mesh in meshes.items():
        model = ShardedGPT(cfg, mesh, seed=3)
        flash.reset_launch_counts()
        loss = model.loss(tok.to(cards[0]), tgt.to(cards[0]))
        loss.backward()
        for d in cards:
            torch.cuda.synchronize(d)
        per = cfg.n_layers * 4
        assert flash.LAUNCHES == {"flash_fwd": per * (2 if remat else 1),
                                  "flash_bwd_dq": per, "flash_bwd_dkv": per}
        grads = model.grad_tree()
        results[arm] = (loss.detach().cpu(), {
            path: _leaf(grads, path).full("cpu") for path in model.paths})
        if arm == "cards":
            layout = model.layouts["layers_0/attn/q_proj/kernel"]
            assert [p.device for p in layout.pieces] == cards
    assert torch.equal(results["cards"][0], results["virtual"][0])
    for path, g in results["cards"][1].items():
        assert torch.equal(g, results["virtual"][1][path]), path


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.cuda
def test_sharded_1b_cut_matches_the_unsharded_on_card() -> None:
    """"1b" at full width, 2 layers, batch 8, on a virtual ``{"fsdp": 2,
    "tensor": 2}`` mesh of the card (the flash kernels at (4, 2048, 8,
    128)) against the unsharded GPT on the same weights: chip_smoke.py's
    LOSS_TOL and GRAD_REL_NORM."""
    import dataclasses

    from torchft_tpu_torch.models import CONFIGS, GPT, ShardedGPT, \
        gpt_param_tree

    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(CONFIGS["1b"], n_layers=2)
    dense = GPT(cfg, device="cuda", seed=5)
    model = ShardedGPT(cfg, ft_mesh_virtual(4),
                       params=gpt_param_tree(dense))
    gen = torch.Generator(device="cuda").manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq_len),
                        generator=gen, device="cuda")
    tgt = torch.roll(tok, -1, dims=1)
    flash.reset_launch_counts()
    loss = model.loss(tok, tgt)
    loss.backward()
    assert flash.LAUNCHES == {"flash_fwd": 16, "flash_bwd_dq": 8,
                              "flash_bwd_dkv": 8}
    want = dense.loss(tok, tgt)
    want.backward()
    assert abs(loss.item() - want.item()) <= 2e-2
    grads = model.grad_tree()
    for name, p in dense.named_parameters():
        g = _leaf(grads, name.replace(".", "/")).full().double()
        r = p.grad.double()
        assert float((g - r).norm() / r.norm()) <= 5e-2, name


@pytest.mark.cuda
def test_hsdp_example_runs_over_the_cards() -> None:
    """``examples/train_hsdp.py`` as a subprocess on CUDA at its defaults
    ("tiny", the mesh over the visible cards, ``tensor = 2`` when their
    count is even) but 3 steps."""
    import subprocess
    import sys

    from torchft_tpu_torch.control import Lighthouse

    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lh = Lighthouse(min_replicas=1, join_timeout_ms=200)
    env = dict(os.environ, TORCHFT_TPU_LIGHTHOUSE=lh.address(),
               REPLICA_GROUP_ID="0", LOGLEVEL="ERROR", TOTAL_STEPS="3")
    for name in ("DEVICE", "MESH_DEVICES", "MODEL"):
        env.pop(name, None)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.examples.train_hsdp"],
            env=env, capture_output=True, text=True, timeout=300, cwd=root)
    finally:
        lh.shutdown()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 3" in proc.stdout and "done" in proc.stdout, proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_fused_step_fused_equals_staged_on_card(codec) -> None:
    """The fused HSDP step at "tiny" over a virtual 2x2 mesh of the card:
    one CUDA graph a fused step, four a staged one, the states bitwise
    equal after every step; each replay counts the launches its capture
    recorded (every flash kernel once per layer per position, int8: one
    ``quant_int8`` and two ``dequant_acc_int8``), the warm-up before each
    engine's first capture its own; the exchange on the card bitwise the
    CPU's."""
    from torchft_tpu_torch.comm.cuda_backend import DevicePool
    from torchft_tpu_torch.fused import (
        FusedStepEngine,
        module_loss_fn,
        module_params,
    )
    from torchft_tpu_torch.optim import adamw

    _cuda()
    smoke = _chip_smoke()
    cfg = CONFIGS["tiny"]
    model = GPT(cfg, device="cuda", seed=0)
    loss_fn = module_loss_fn(model, smoke.gpt_row_loss(cfg.max_seq_len))
    params = module_params(model)
    pool = DevicePool("cuda")
    kw = dict(codec=codec, chunk_bytes=1024, fn_key="tiny")
    a = FusedStepEngine(pool, 2, 2, params, 2 * cfg.max_seq_len, loss_fn,
                        adamw(3e-4, weight_decay=1e-4), **kw)
    b = FusedStepEngine(pool, 2, 2, params, 2 * cfg.max_seq_len, loss_fn,
                        adamw(3e-4, weight_decay=1e-4), **kw)
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    for step in range(3):
        batch = smoke.fused_batch(0, step, cfg, 4)
        assert a.step_fused(batch) == b.step_staged(batch)
        assert smoke.same_state(a, b), step
    assert (a.captures, b.captures) == (1, 4)
    assert pool.compile_count == 5
    a.verify_replicas()
    want = smoke.fused_launches(3 * 2 + 2, cfg.n_layers, 4, codec)
    assert {**flash.LAUNCHES, **quant.LAUNCHES} == want
    # the exchange program on the card against the CPU's, bitwise
    spec = a.spec
    gen = torch.Generator().manual_seed(5)
    gm = torch.randn((4, spec.p_len), generator=gen) * 3
    e = torch.randn((4, spec.p_len), generator=gen) * 1e-2
    prog = a._exe("exchange")
    cpu_e, card_e = e.clone(), e.cuda()
    ((cpu_h,),) = prog.run([gm], [cpu_e])
    ((card_h,),) = prog.run([gm.cuda()], [card_e])
    assert torch.equal(card_h.cpu().view(torch.int32), cpu_h.view(torch.int32))
    assert torch.equal(card_e.cpu().view(torch.int32), cpu_e.view(torch.int32))


@pytest.mark.cuda
def test_serve_cohort_holds_its_shards_on_the_card() -> None:
    """The train-to-serve plane with the cohort on the card (its default
    device): tensors on the card published, every live buffer on the card,
    its digest read back from the card equal to the publication's, an
    answer racing a concurrent deploy reading one whole version, and the
    card's f32 sum within the plane's bound of a float64 sum."""
    import threading

    import numpy as np

    from torchft_tpu_torch.serve import DeployPublisher, ServeCohort

    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    versions = {v: [torch.randn(4096 + 64 * i, device="cuda", generator=gen)
                    for i in range(10)] for v in (1, 2)}
    pub = DeployPublisher()
    cohort = ServeCohort(3, replication=2)
    stop, seen, errors = threading.Event(), [], []

    def hammer() -> None:
        u = 0
        while not stop.is_set():
            try:
                seen.append((u % 10, *cohort.answer(u % 10, 1.5)))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)
            u += 1

    try:
        cohort.deploy(1, [pub.publish(1, versions[1])], pub.unit_bytes)
        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        cohort.deploy(2, [pub.publish(2, versions[2])], pub.unit_bytes)
        stop.set()
        t.join(timeout=30)
        assert not errors and seen
        for m in cohort.members:
            assert m.version == 2
            assert all(b.device.type == "cuda"
                       for bufs in m._live.buffers.values() for b in bufs)
            want = pub.digests(2)
            assert m.live_digests() == {u: want[u] for u in m._live.buffers}
            assert not m.metrics.snapshot().get("serve_stale_reads")
        for u, v, got in seen:
            leaf = versions[v][u].double()
            bound = 1e-5 * float(leaf.abs().sum()) * 1.5
            assert abs(got - float(leaf.sum()) * 1.5) <= bound
    finally:
        stop.set()
        cohort.shutdown()
        pub.close()


class _HeldManager:
    """A manager stand-in for ``OptimizerWrapper.step``: each decision is
    held open until the wrapper asks for it (the barrier RPC still in
    flight when the update is dispatched), and is ``commit`` with the
    local vote True."""

    def __init__(self) -> None:
        self.commit = True
        self.step = 0

    def finish_staging(self) -> None:
        pass

    def current_step(self) -> int:
        return self.step

    def should_commit_async(self):
        from concurrent.futures import Future

        manager = self

        class Held(Future):
            def result(self, timeout=None):
                if not self.done():
                    manager.step += bool(manager.commit)
                    self.set_result(bool(manager.commit))
                return super().result(timeout)

        fut = Held()
        fut.local_should_commit = True
        return fut


@pytest.mark.cuda
def test_update_rise_per_arm_at_125m_on_card() -> None:
    # the memory-plan twin of tests/test_memory_plan.py's two claims (:59,
    # :81) at "125m" on the card, one OptimizerWrapper arm at a time in
    # this process, over AdamW (capturable, its state created up front):
    # each decide-first update allocates under 8 bytes a parameter beyond
    # what was allocated as it began (the foreach temporaries, no second
    # footprint), the overlapped arm's largest at least 12 (the backup of
    # the parameters and both moments); after 3 committed steps on the
    # same seeded gradients the two arms are bitwise equal, and a
    # discarded overlapped step leaves every parameter and state tensor
    # bitwise what it was, at its old address
    from contextlib import contextmanager

    from torchft_tpu_torch.models import count_params
    from torchft_tpu_torch.optim import OptimizerWrapper, init_adam_state

    _cuda()
    cfg = CONFIGS["125m"]
    n = count_params(GPT(cfg, device="meta"))
    arms = {}
    for donate in (True, False):
        name = "decide first" if donate else "overlapped"
        model = GPT(cfg, device="cuda", seed=0)
        params = list(model.parameters())
        adamw = torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4,
                                  capturable=True)
        init_adam_state(adamw)
        rises = []

        @contextmanager
        def window():
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            yield
            rises.append(torch.cuda.max_memory_allocated() - base)

        manager = _HeldManager()
        opt = OptimizerWrapper(manager, adamw, donate_update=donate,
                               update_window=window)
        gen = torch.Generator(device="cuda").manual_seed(1)
        for _ in range(3):
            for p in params:
                p.grad = 1e-2 * torch.randn(p.shape, generator=gen,
                                            device="cuda")
            assert opt.step()
        torch.cuda.synchronize()
        tensors = lambda: [p.detach() for p in params] + [  # noqa: E731
            v for p in params for _, v in sorted(adamw.state[p].items())]
        arms[donate] = [t.clone() for t in tensors()]
        print(f"update rise, {name}, 125m ({n} parameters), "
              f"{torch.cuda.get_device_name(0)}: "
              + ", ".join(f"{r} bytes ({r / n:.2f} a parameter)"
                          for r in rises))
        if donate:
            assert max(rises) < 8 * n, (name, rises)
        else:
            assert max(rises) >= 12 * n, (name, rises)
            # a discard: the update ran beside the barrier and is undone
            manager.commit = False
            before = [(t.clone(), t.data_ptr()) for t in tensors()]
            assert not opt.step()
            torch.cuda.synchronize()
            for t, (b, ptr) in zip(tensors(), before):
                assert torch.equal(t, b) and t.data_ptr() == ptr
            del before
        del model, params, adamw, opt, tensors
        torch.cuda.empty_cache()
    assert all(torch.equal(a, b) for a, b in zip(arms[True], arms[False]))


@pytest.mark.cuda
def test_overlapped_raise_rolls_back_on_card() -> None:
    # an overlapped step whose capturable AdamW updates its first parameter
    # group and then raises an out-of-memory error: every parameter and
    # state tensor bitwise what it was at its old address, the decision
    # read, the error re-raised, and the next step bitwise a clean history
    from torchft_tpu_torch.optim import OptimizerWrapper, init_adam_state

    _cuda()

    class Failing(torch.optim.AdamW):
        fail = None

        def step(self, closure=None):
            if self.fail is None:
                return super().step(closure)
            exc, self.fail = self.fail, None
            groups = self.param_groups
            self.param_groups = groups[:1]
            try:
                super().step(closure)
            finally:
                self.param_groups = groups
            raise exc

    def build():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = [torch.nn.Parameter(torch.randn(s, generator=gen,
                                                 device="cuda"))
                  for s in ((256, 128), (128,), (4096,))]
        adamw = Failing([{"params": params[:1]}, {"params": params[1:]}],
                        lr=1e-2, weight_decay=1e-2, capturable=True)
        init_adam_state(adamw)
        return params, adamw

    def tensors(params, adamw):
        return [p.detach() for p in params] + [
            v for p in params for _, v in sorted(adamw.state[p].items())]

    def set_grads(params, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")

    params, adamw = build()
    manager = _HeldManager()
    opt = OptimizerWrapper(manager, adamw)
    set_grads(params, 1)
    assert opt.step()
    set_grads(params, 2)
    torch.cuda.synchronize()
    before = [(t.clone(), t.data_ptr()) for t in tensors(params, adamw)]
    fault = torch.cuda.OutOfMemoryError("injected")
    adamw.fail = fault
    with pytest.raises(torch.cuda.OutOfMemoryError) as raised:
        opt.step()
    torch.cuda.synchronize()
    assert raised.value is fault
    assert manager.step == 2  # the decision was read
    for t, (b, ptr) in zip(tensors(params, adamw), before):
        assert torch.equal(t, b) and t.data_ptr() == ptr
    assert opt.step()
    ref, ref_adamw = build()
    for seed in (1, 2):
        set_grads(ref, seed)
        ref_adamw.step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tensors(params, adamw),
                                                tensors(ref, ref_adamw)))


# ------------------------------------------------ the plane over the cards


def _cards(least: int = 2):
    """The visible cards, or a skip below ``least`` of them."""
    _cuda()
    n = torch.cuda.device_count()
    if n < least:
        pytest.skip(f"needs {least} cards or more, sees {n}")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.cuda
def test_codec_kernels_launch_on_their_own_card() -> None:
    """Both codec kernels on the last visible card while ``cuda:0`` is
    current: each wrapper launches on its tensor's card (its stream, under
    its device guard), bitwise its plain version there."""
    dev = _cards()[-1]
    step = 1000
    with torch.cuda.device(0):
        gen = torch.Generator(device=dev).manual_seed(4)
        x = torch.randn((3, 4 * step + 17), generator=gen, device=dev)
        x[1, step + 3] = float("nan")
        quant.reset_launch_counts()
        q, s = quant.quant_int8(x, step)
        acc = quant.dequant_acc_int8(q, s, step, divisor=3)
        torch.cuda.synchronize(dev)
        assert q.device == s.device == acc.device == dev
        pq, ps = quant.quant_int8_plain(x, step)
        p_acc = quant.dequant_acc_int8_plain(q, s, step, divisor=3)
        assert torch.cuda.current_device() == 0
    assert torch.equal(q, pq) and torch.equal(_bits(s), _bits(ps))
    assert torch.equal(_bits(acc), _bits(p_acc))
    assert quant.LAUNCHES == {"quant_int8": 1, "dequant_acc_int8": 1}


def _plane_results(pool, tag, world, inputs, op, scatter=False, **kw):
    """Each rank's results of one op on ``pool``'s plane (chunk grid 4 KiB)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext

    ctxs = [CudaCommContext(timeout=60.0, chunk_bytes=1 << 12,
                            device_pool=pool, **kw) for _ in range(world)]

    def worker(r):
        ctxs[r].configure(f"cards://{tag}", r, world)
        arrays = [a.copy() for a in inputs[r]]
        if scatter:
            w = ctxs[r].reduce_scatter(arrays, op)
            return [np.array(w.future().result(timeout=60)[r])]
        w = ctxs[r].allreduce(arrays, op)
        return [np.array(a) for a in w.future().result(timeout=60)]

    try:
        with ThreadPoolExecutor(world) as ex:
            return [f.result(120) for f in
                    [ex.submit(worker, r) for r in range(world)]]
    finally:
        for c in ctxs:
            c.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["star", "ring", "psum", "scatter", "hier",
                                  "hier_psum"])
@pytest.mark.parametrize("layout", ["cards", "cycled"])
def test_plane_over_the_cards_equals_the_one_card_plane(kind,
                                                        layout) -> None:
    """The gradient plane with rank r on ``cuda:r`` (``cards``: up to four
    ranks, one a card) or on ``cuda:r % 2`` (``cycled``: three ranks, two
    sharing a card; the hier tier four) against ``DevicePool("cuda",
    positions=n)`` and the CPU plane, bitwise, at codecs none, bf16 and
    int8 under SUM and AVG; the raw psum (codec none) against the one-card
    plane alone, its sum being the library's."""
    import numpy as np

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import DevicePool
    from torchft_tpu_torch.comm.topology import DomainTopology

    cards = _cards()
    hier = kind.startswith("hier")
    if layout == "cards":
        world = 4 if hier else min(4, len(cards))
        if world > len(cards):
            pytest.skip("the hier tier's 2x2 layout needs four cards")
        positions = cards[:world]
    else:
        world = 4 if hier else 3
        positions = [cards[r % 2] for r in range(world)]
    pools = {"cards": DevicePool(devices=positions),
             "one": DevicePool("cuda", positions=world),
             "cpu": DevicePool("cpu", positions=world)}
    kw = {"algorithm": "psum" if kind in ("psum", "scatter", "hier_psum")
          else "star" if kind == "hier" else kind}
    if hier:
        kw.update(topology="hier", domain_resolver=DomainTopology(
            static_map={"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]}))
    rng = np.random.default_rng(world * 5 + len(kind))
    sizes = (4000, 2500, 4097, 3001)[:world] if kind == "scatter" \
        else (5000, 7, 257)
    inputs = [[(rng.standard_normal(s) * (r + 1)).astype(np.float32)
               for s in sizes] for r in range(world)]
    for codec in ("none", "bf16", "int8"):
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            tag = f"{kind}_{layout}_{codec}_{op}"
            got = {arm: _plane_results(pool, f"{tag}/{arm}", world, inputs,
                                       op, scatter=kind == "scatter",
                                       compression=codec, **kw)
                   for arm, pool in pools.items()}
            numeric = codec == "none" and kw["algorithm"] == "psum"
            for arm in ("one",) if numeric else ("one", "cpu"):
                for g_r, w_r in zip(got["cards"], got[arm]):
                    for g, w in zip(g_r, w_r):
                        assert g.tobytes() == w.tobytes(), (tag, arm)


@pytest.mark.cuda
def test_dryrun_over_the_cards_equals_the_virtual_mesh() -> None:
    """``dryrun_multichip(4)`` with position p on card p % cards against
    the same run on a virtual mesh of ``cuda:0``: every segment's figures
    equal, bitwise, and the same flash launches; the FT loop's threaded
    schedule varies from run to run, so it is held to its own checks
    (every rank healed on its sharding, the trajectories within the
    reference's tolerance) and a common step after the heal."""
    from torchft_tpu_torch.graft_entry import dryrun_multichip

    cards = _cards()
    flash.reset_launch_counts()
    over = dryrun_multichip(4, devices=cards)
    virtual = dryrun_multichip(4, device="cuda")
    for name, figures in virtual["segments"].items():
        if name == "ft":
            assert over["segments"]["ft"]["common_steps"] > 0
            continue
        assert over["segments"][name] == figures, name
    assert over["launches"] == virtual["launches"]
    print({name: (round(over["seconds"][name], 2),
                  round(virtual["seconds"][name], 2))
           for name in virtual["seconds"]})


@pytest.mark.cuda
def test_kill_and_heal_over_the_cards_on_the_int8_plane() -> None:
    """The example's drill at "tiny" with group g on card g % cards and
    one ``DevicePool`` over them, on the int8 quantized psum: the drill's
    own checks (every joint step's parameters bitwise equal across the
    groups, the healed group bitwise its donor from the heal on), and each
    codec kernel launched world + cards times per bucket op with a peer."""
    from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal

    cards = _cards()
    quant.reset_launch_counts()
    result = run_kill_and_heal(
        CONFIGS["tiny"], kill_step=2, steps_after=2, devices=cards,
        batch_size=4, timeout=60.0, comm_backend="cuda",
        comm_options={"algorithm": "psum", "compression": "int8"})
    assert result["heal_step"] == 4 and result["checked_steps"] == [4, 5, 6]
    assert result["compared"] == {1: 2, 2: 2, 3: 1, 4: 2, 5: 2, 6: 2}
    survivor = result["runs"][0]
    per_op = 2 + min(2, len(cards))
    want = per_op * len(survivor.buckets) * survivor.wire_steps
    assert quant.LAUNCHES == {"quant_int8": want, "dequant_acc_int8": want}


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("cards", [4, 2], ids=["one_a_card", "cycled"])
def test_fused_step_over_the_cards_equals_the_virtual_mesh(cards,
                                                           codec) -> None:
    """The fused HSDP step at "tiny" over ``cuda:0 .. cuda:3`` (one position
    a card) and over two cards cycled (``cuda:0, cuda:1, cuda:0, cuda:1``)
    against the virtual 2x2 of ``cuda:0``: a fused and a staged engine over
    the cards and a fused one on the virtual mesh, their digests equal after
    every step and after a churn to 4x1 and back; each position's rows on
    its card; one graph a fused program spanning the cards (1 + 4
    captures, none at a seen shape); the launches as ``fused_launches``
    says, each codec kernel once a card holding positions."""
    from torchft_tpu_torch.comm.cuda_backend import DevicePool
    from torchft_tpu_torch.fused import (
        FusedStepEngine,
        module_loss_fn,
        module_params,
    )
    from torchft_tpu_torch.optim import adamw

    visible = _cards(cards)
    positions = [visible[d % cards] for d in range(4)]
    smoke = _chip_smoke()
    cfg = CONFIGS["tiny"]
    model = GPT(cfg, device="cuda:0", seed=0)
    loss_fn = module_loss_fn(model, smoke.gpt_row_loss(cfg.max_seq_len))
    params = module_params(model)
    kw = dict(codec=codec, chunk_bytes=1024, fn_key="tiny")

    def engine(pool):
        return FusedStepEngine(pool, 2, 2, params, 2 * cfg.max_seq_len,
                               loss_fn, adamw(3e-4, weight_decay=1e-4), **kw)

    pool = DevicePool(devices=positions)
    a, b = engine(pool), engine(pool)
    v = engine(DevicePool("cuda:0"))
    for bufs in (a._state.p, a._state.e, *a._state.opt):
        for d in range(4):
            assert a._cards.row(bufs, d).device == positions[d]
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    for step, mesh in enumerate([(2, 2)] * 3 + [(4, 1), (2, 2)]):
        if (a.replicas, a.model_shards) != mesh:
            for eng in (a, b, v):
                eng.reshape_mesh(*mesh)
        batch = smoke.fused_batch(0, step, cfg, 4)
        la, lb, lv = a.step_fused(batch), b.step_staged(batch), \
            v.step_fused(batch)
        assert la == lb == lv, step
        assert a.digest() == b.digest() == v.digest(), (step, mesh)
    a.verify_replicas()
    assert (a.captures, b.captures, v.captures) == (2, 8, 2)
    assert pool.compile_count == 10
    # over the cards 5 runs of each arm and a warm-up before each of the
    # 2 + 8 captures (4 runs of the stages each shape); on cuda:0 5 runs
    # and 2 warm-ups
    want = smoke.fused_launches(5 * 2 + 2 * 2, cfg.n_layers, 4, codec,
                                cards=cards)
    for k, n in smoke.fused_launches(5 + 2, cfg.n_layers, 4, codec).items():
        want[k] += n
    assert {**flash.LAUNCHES, **quant.LAUNCHES} == want
