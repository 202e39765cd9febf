#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (torchft_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit, then the build of the CUDA
   kernels from torchft_tpu_torch/csrc, with ptxas's registers and spills
   per kernel and, for the flash kernels, per head_dim instantiation; a
   spill in any flash instantiation or in either codec kernel, or a ptxas
   note that it serialized ``wgmma`` instructions (C7515), fails the run.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card. The flash kernels at every head_dim they take, at the
   attention shape of the model that reaches it and at one with work
   enough to time (``FLASH_SHAPES``: "tiny" (8, 128, 4, 16) and (8, 1024,
   12, 16); (1, 128, 2, 32) and (8, 1024, 12, 32); "125m" (8, 1024, 12,
   64); "1b" (1, 2048, 16, 128)), in bf16, causal and non-causal, through
   ``flash_attention`` forward + backward and through
   ``flash_block_attention_bwd`` with external lse/Delta, within
   ``flash.KERNEL_TOL`` (each element within one bf16 ulp plus 1e-4, the
   difference's relative norm at most 1e-3, lse within 1e-5). The int8
   codec kernels (``quant_int8``, ``dequant_acc_int8``) at the 125m
   gradient size (2 rows of every parameter, f32, on the 1 MiB chunk grid,
   with a short tail chunk, an all-zero chunk and chunks holding NaN and
   Inf) bitwise: tolerance 0, NaN bit patterns included; ``quant_int8``
   also at every bucket shape of both phases of the int8 drill, and, on
   grids of 1 MiB, 4 MiB and 1000 f32, at rows of x and q that start
   unaligned, at n = 1, step - 1, step and step + 1, and with a NaN in the
   last CTA's slice of a chunk; ``dequant_acc_int8`` also at
   ``dequant_cases`` (chunk and shard boundaries and ``valid`` inside its
   16-element runs, rows off 16-byte alignment, the bucket shapes of both
   phases). Kernel, plain and
   library times (device time of a replayed CUDA graph), each wrapper's
   host time per call, and the least time the card could take (bound), at
   each timed flash shape (the ``per_head_dim`` rows); beside the two
   backward flash kernels, PyTorch's fused attention backward (dq, dk and
   dv in one call, ``library_pair_ms``); beside the codec kernels,
   their time summed over one wire step of the int8 drill at each DDP
   bucket's own size (``step_ms`` over ``step_launches`` launches) beside
   that step's bound (``step_bound_ms``).
3. train: the main path at the full width of the "125m" config over the
   TCP gradient wire: two replica groups under an in-process lighthouse, a
   few committed steps, a failure injected into group 1, its restart from a
   poisoned init, a heal from group 0, more commits, on a fixed schedule of
   steps. The healed parameters must equal the donor's bitwise, the losses
   must be finite, and every flash kernel must have launched once per layer
   per forward/backward pass.
4. train_multijob: the multi-tenant control plane at "125m", full width
   and depth, batch 8, over TCP at codec none, on one lighthouse granting 2
   s epoch leases with ``fleet_capacity`` 5 (``run_multijob_drill``). Job
   "a" (priority 5): DDP groups a0 and a1 and an observer
   (``data_plane=False``) running a forward-only probe; job "b" (priority
   0, group budget 1): DDP groups b0 and b1 on the lease's fast path, step
   for step with a0. a1 fails after step 3, a0 commits 4 alone, a1
   restarts from a poisoned init and heals at 5, both commit 6-7; then hi0
   joins job "hi" (priority 10) one group over capacity, the lighthouse
   evicts b1 in its quorum answer, b0 commits 8-9 alone and hi0 2 steps.
   The native lighthouse counts every heartbeating group toward the
   capacity, the observer included, so the capacity is the five groups
   before hi0. Checks: a0 and a1 bitwise equal at every step both commit;
   a0's participants and wire world 2, and 1 alone and at the heal, never
   3; the observer in every barrier, never participating, healed or on a
   wire of more than itself, its parameters unchanged; b0 and b1 bitwise
   equal, 0 control RPCs at steps 3-6 and job b's ``membership_epoch``,
   ``quorum_compute_count`` and ``lease_breaks`` flat across them; b1
   evicted within 5 s with a ``job_preempted`` event and its parameters
   as committed, ``jobs.b`` one preemption naming b1; every flash kernel
   launched 12 x (training passes + observer passes (forward only) +
   capture warm-up passes), none of the codec kernels. It first checks the
   device memory (``multijob_device_bytes``; hi0 runs at "tiny" if it
   does not fit) and the host's (``multijob_host_bytes``); it runs before
   the phases that keep the card plane's buffers, with six models to hold.
5. train_sharded: the reference example's two remaining arms at "125m",
   full width and depth, batch 8. (b) ``SHARDED=1``: three groups over TCP
   at codec none through ``ShardedOptimizerWrapper`` (reduce-scatter, a
   1/3 update with optax-order ``adamw(3e-4)``, weight decay 1e-4, a
   params allgather); g0 is killed after step 3, g1 and g2 commit 4 on a
   wire of 2 after a reshard (its ``reinit_leaves`` reported), g0 restarts
   from a poisoned init and heals at 5, its optimizer shard through
   ``fetch_opt_shard``, and the three reshard back and commit 5-7. Every
   committed step's parameters must be bitwise equal across the live
   groups, every reshard and the heal must move exactly their lower bound
   (``redist_moved_bytes == redist_lower_bound_bytes``), and steps 1-3
   must equal, bitwise, the same steps of the wrapper's replicated arm
   (``sharded=False``). (a) DDP's streamed pipeline against its lock-step
   arm: two groups on the card's int8 psum plane with error feedback, the
   same seeds and batches, 3 steps each; the averaged gradients and the
   residuals must be bitwise equal after every step. (c) the sharded arm on
   the same plane, two groups, 3 steps: the groups bitwise equal, and each
   codec kernel launched once per reduce_scatter (the native scatter of
   the two owned shard buckets). Every flash kernel launched 12 x the
   passes of all runs. It checks the device memory first
   (``sharded_device_bytes``) and runs before the phases that keep the
   card plane's buffers.
6. train_cuda_int8: the same drill, all 12 layers, with the gradient wire
   swapped for the on-device plane running the quantized psum
   (``comm_backend="cuda"``, ``{"algorithm": "psum", "compression":
   "int8"}``) with error feedback. Besides the checks of 3, each codec
   kernel must have launched exactly twice per gradient bucket per
   allreduce with a peer on the wire. Then the plane on the card is held
   bitwise against the plane on the CPU at each of the drill's bucket
   sizes.
7. train_tiny: the drill of 3 over TCP at "tiny" (head_dim 16), full width
   and depth, batch 8: the example's default config, on the card.
8. gpt_1b: one forward/backward of "1b" (24 layers, d_model 2048, 16 heads
   of 128, seq 2048, activation checkpointing on) at batch 1, at full width
   and depth. The checkpointing recomputes each block's forward in the
   backward: 48 forward, 24 dQ and 24 dK/dV launches. The loss must lie
   within ``LOSS_TOL`` and a sample of gradients within ``GRAD_REL_NORM``
   of the same model whose attention runs ``reference_attention`` on the
   card.

9. train_diloco: BASELINE config 4's shape, the DiLoCo example
   (``run_diloco_drill``) at "125m", full width and depth, batch 8: two
   groups over TCP at codec none, ``sync_every=8``, 2 streaming fragments,
   outer ``sgd(0.7, momentum=0.9, nesterov=True)``, inner AdamW (3e-4,
   weight decay 0.1, betas 0.9/0.95) as one CUDA graph a step. Both commit
   rounds 1-2; group 1 is killed at inner step 4 of round 3, which group 0
   commits alone; group 1 restarts from a poisoned init and heals at round
   4's fence; both commit rounds 4-5. After every round both commit, their
   parameters and outer states must be bitwise equal (the healed group
   equal to its donor), the losses finite, and every flash kernel launched
   12 x (inner steps + capture warm-up passes) times. It prints the outer
   sync's phase p50s and gauges, the round times and the heal.
10. train_localsgd_int8: BASELINE config 3's shape, LocalSGD at "125m",
   full width and depth, batch 8, four groups on the on-device plane
   (``comm_backend="cuda"``, psum, int8, error feedback on),
   ``sync_every=8``, 2 fragments. Every group commits round 1; in round 2
   group 3's second fragment op fails after its collective ran (its round
   aborts and every fragment returns bitwise to its backup; the others
   commit it); group 3 heals at round 3's quorum and all four commit it.
   After every round, the groups that commit it must be bitwise equal, and
   each codec kernel must have launched exactly twice per fragment op with
   a peer. Round 1's fragment averages on the card must equal the same
   plane on the CPU bitwise. It first checks the host's free memory
   (``localsgd_host_bytes``).
11. train_hier_int8: the hierarchical data plane at "125m", full width and
   depth, batch 8: four groups in two domains (``HIER_DOMAINS``: rack0 =
   {g0, g1}, rack1 = {g2, g3}) over ``TcpCommContext(algorithm="star",
   compression="int8", topology="hier")``, 4 lanes, 1 MiB chunks, DDP with
   error feedback, each group's domain resolved through a
   ``DomainTopology`` over the drill's domain tree. Steps 1-3 joint; group
   2, rack1's egress, is killed; steps 4-5 commit with rack1 = {g3} (its
   egress, no intra tier); g2 restarts from a poisoned init, heals at 6;
   7-8 joint. All live groups must be bitwise equal at every committed
   step; each life's ``comm_inter_bytes`` must be non-zero only on its
   egress steps and equal ``codec_wire_nbytes`` of its contribution,
   ``comm_intra_bytes`` zero in a singleton domain, ``comm_hops`` 4 per
   op in a two-member domain and 2 in a singleton; ``ddp_ef`` only on the
   compensable roles (rack1's egress); step 2's bucket ops of every group
   bitwise equal to the port's ``_host_hier_allreduce`` of the recorded
   contributions. Then, at each distinct bucket size, the card plane's
   hier arms in the same 2x2 layout: ``CudaCommContext(topology="hier",
   compression="int8")`` with "star" bitwise equal to the TCP hier path and
   to ``DevicePool("cpu")``, with "psum" identical on every rank and within
   ``HIER_PSUM_TOL`` x absmax of the f64 sum; the codec kernels must have
   launched 3 times each per distinct size (star 2, psum 1). It first
   checks the host's free memory (``hier_host_bytes``).
12. train_durable: the reference training loop whole, at "125m" full width
   and depth, batch 8, over TCP under a lighthouse granting 2 s epoch
   leases (``run_resume_drill``): group 0 commits 3 steps alone, each a
   fused step replaying one CUDA graph; group 1 starts from a poisoned
   init and heals; both commit 4 steps together, the steady ones on the
   lease's fast path (0 control RPCs; a GET /telemetry/metrics during one
   must show the lease live and 0 RPCs); every group writes an
   ``AsyncCheckpointWriter(keep=2)`` checkpoint every 2 steps; both are
   killed once the last write persisted, restart from a poisoned init and
   resume from their newest checkpoint, which the resumed step,
   parameters, AdamW state and sampler position must equal bitwise; both
   commit 2 more steps. The healed and resumed groups must be bitwise
   equal at every step both commit, the losses finite, and every flash
   kernel launched once per layer per pass, graph replays (the capture's
   tally) and the capture's warm-up passes included. It first checks the
   disk (``durable_disk_bytes``, 9.8 GB at 125m) and fails if short.
   Then the fused step against the same step run eagerly, bitwise after 3
   steps, and the device time of each.

13. train_moe (it runs after train_sharded, before the phases that keep
   the card plane's buffers): the reference's ``examples/train_moe.py`` at
   "moe-8x125m" (334,308,864 parameters; 12 layers of the 125m backbone,
   8 top-2 experts with capacity factor 1.25 on every other layer,
   activation checkpointing on), full width and depth, batch 8 x 1024,
   over TCP at codec none, AdamW (3e-4, weight decay 1e-4):
   ``run_moe_drill``, two replica groups of two ranks each, every rank
   holding the whole model (the reference's expert axis of width 1).
   Group 0 commits step 1 alone; group 1 joins and heals at 2; both commit
   2-3; group 1's two ranks fail, group 0 commits 4 alone; they restart
   from a poisoned init and each heals at 5 through
   ``recv_checkpoint_sharded`` from group 0's rank of its number, the
   stripes spread over both of group 0's ranks (peers from the group
   store); both commit 5-7. Every live rank's parameters and AdamW state
   must be bitwise equal at every committed step, both donor ranks must
   have served bytes of the second heal, the losses must be finite, and
   the flash kernels must have launched per layer per pass twice forward
   (the checkpointing's recompute) and once each backward. It prints each
   healer rank's ``heal_wall_ms``, ``heal_bytes_per_s``, wire bytes and
   upload p50, the bytes each donor rank served, the state's size and the
   step phases' p50s. It first checks the device memory
   (``moe_device_bytes``) and the host's (``moe_host_bytes``).

14. train_diloco_sharded (it runs after train_diloco): DiLoCo's outer
   update sharded by fragment (``sharded_outer=True``) at "125m", full
   width and depth, batch 8 x 1024: three groups as threads over loopback
   TCP at codec none, group 2's wire in a ``SubprocessCommContext`` child
   (``check_comm_child`` first shows such a child holds no CUDA context),
   ``sync_every=8``, 3 fragments, outer ``sgd(0.7, momentum=0.9,
   nesterov=True)``, a wire timeout of ``DILOCO_WIRE_TIMEOUT``. First the
   replicated arm (``sharded_outer=False``) for rounds 1-2 on the same
   seeds. Then the schedule: rounds 1-2 all three, each group holding
   exactly fragment ``f % 3 == rank``, bitwise equal to the replicated
   arm; group 2 killed at inner step 4 of round 3 (its child gone with
   it), groups 0 and 1 commit round 3 at world 2 after a reshard that
   reinitializes f2 on its new owner only; group 2 restarts from a
   poisoned init with a new child, heals at round 4's quorum, and the
   fence's exchange gives it f2's momentum bitwise as its holder
   committed it (every reshard moving exactly its lower bound, no
   reinit); at round 5's fence group 2's child is SIGSTOPped with a
   fragment op in flight, every group's round aborts and rolls back
   (parameters at the backup, outer states as the fence left them),
   every group reconfigures and the stopped child is SIGKILLed and
   replaced; all three commit the retried round and round 6. After every
   committed round the live groups hold each fragment's momentum exactly
   once; every flash kernel launched 12 x the passes of both arms. It
   prints the five checks, per group and life the p50s of ``outer_d2h``,
   ``outer_wire``, ``outer_land`` and ``reshard``, the ``reshard``
   events, round seconds, the heal's wall and GB/s, the drill's seconds
   and the device memory peak. It first checks the host's memory
   (``diloco_sharded_host_bytes``) and the device's
   (``diloco_sharded_device_bytes``).

It prints a ``kernels`` JSON line before the last line and ends with
``{"ok": true, "device": {...}}``. It needs one card and no network.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound column.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

_TPU_KERNELS = {
    "flash_fwd": "torchft_tpu/ops/flash.py:54 _flash_kernel, "
                 "torchft_tpu/ops/flash.py:104 _flash_streamed_kernel",
    "flash_bwd_dq": "torchft_tpu/ops/flash.py:277 _flash_bwd_dq_kernel, "
                    "torchft_tpu/ops/flash.py:352 _flash_bwd_dq_streamed_kernel",
    "flash_bwd_dkv": "torchft_tpu/ops/flash.py:311 _flash_bwd_dkv_kernel, "
                     "torchft_tpu/ops/flash.py:391 _flash_bwd_dkv_streamed_kernel",
    "quant_int8": "torchft_tpu/comm/xla_backend.py:592 _pallas_quant_kernel",
    # no TPU kernel: the reference leaves the owner-side decode to XLA
    "dequant_acc_int8": "none (XLA ops in torchft_tpu/comm/xla_backend.py:727 "
                        "reduce_int8)",
}
_SOURCES = {
    "flash_fwd": "torchft_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "torchft_tpu_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "torchft_tpu_torch/csrc/flash_bwd_dkv.cu",
    "quant_int8": "torchft_tpu_torch/csrc/quant_int8.cu",
    "dequant_acc_int8": "torchft_tpu_torch/csrc/quant_int8.cu",
}
CHUNK_BYTES = 1 << 20  # the gradient plane's chunk grid (1 MiB of f32)
INT8_OPTIONS = {"algorithm": "psum", "compression": "int8"}


def log(msg: str) -> None:
    print(msg, flush=True)


# How every time of the kernels line was taken; each row carries it.
TIMED_BY = ("ms, plain_ms, library_ms, library_pair_ms, step_ms: device time "
            "by CUDA events around the replay of a CUDA graph of the calls "
            "(host work per call left out); host_us: the host's clock per "
            "call issued back to back")


def cuda_ms(fn, iters: int = 100, warmup: int = 10, repeats: int = 3) -> float:
    """Device ms per call of ``fn``: after ``warmup`` calls, ``iters`` calls
    are captured once into a CUDA graph, and CUDA events around each of
    ``repeats`` replays give a mean; the median of those. The replay leaves
    out the host's work per call, so the shared host's speed does not enter
    (``host_us`` measures that part). A capture failure raises."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return sorted(means)[len(means) // 2]


def host_us(fn, iters: int = 100, repeats: int = 3) -> float:
    """Host microseconds per call of ``fn``: the host's clock around
    ``iters`` calls issued back to back (their launches queue on the card
    without a wait), the median of ``repeats`` such means."""
    import torch

    fn()
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        means.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return sorted(means)[len(means) // 2]


def attention_bound_ms(b: int, s: int, h: int, d: int, causal: bool,
                       products: int, n_bf16_io: int, n_f32_rows: int):
    """(bound ms, "bytes" or "operations") of an attention function with
    ``products`` S x S x D matrix products over the attended (q, k) pairs,
    ``n_bf16_io`` [B, S, H, D] bf16 tensors read or written once and
    ``n_f32_rows`` [B, H, S] f32 vectors."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2.0 * d * pairs * b * h
    nbytes = n_bf16_io * b * s * h * d * 2 + n_f32_rows * b * h * s * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# ptxas names the kernels by their mangled symbols
_KERNEL_SYMBOLS = {
    "flash_fwd": "flash_fwd_kernel",
    "flash_bwd_dq": "flash_bwd_dq_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
    "quant_int8": "quant_int8_kernel",
    "dequant_acc_int8": "dequant_acc_int8_kernel",
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
HEAD_DIMS = (16, 32, 64, 128)  # the flash kernels' instantiations
# every instantiation of the Hopper-redesigned kernels
_NO_SPILL = tuple(f"{n}/d{d}" for n in FLASH_KERNELS for d in HEAD_DIMS) + (
    "quant_int8", "dequant_acc_int8")


def _report_key(symbol: str):
    """The report's key for a mangled kernel symbol: the kernel's name,
    with ``/d<D>`` for an instantiation at head size D (``...ILi64E...``),
    or None for a symbol of no kernel here."""
    import re

    for name, sym in _KERNEL_SYMBOLS.items():
        i = symbol.find(sym)
        if i >= 0:
            m = re.match(r"ILi(\d+)E", symbol[i + len(sym):])
            return f"{name}/d{m.group(1)}" if m else name
    return None


def ptxas_report(build_log: str):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from the
    ptxas lines of the build, one entry per instantiation of a templated
    kernel (``flash_fwd/d64``), plus its warnings and performance notes (a
    wgmma serialized by the compiler is one)."""
    import re

    report, warnings, current = {}, [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _report_key(m.group(1))
            continue
        if "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report.setdefault(current, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(current, {})["registers"] = int(m.group(1))
    return report, warnings


def spill_failures(report):
    """The kernels (instantiations) of _NO_SPILL that spill, or that ptxas
    did not report."""
    return [n for n in _NO_SPILL
            if report.get(n, {}).get("spill_stores", 1)
            or report.get(n, {}).get("spill_loads", 1)]


def serialized_notes(notes):
    """The ptxas notes that it serialized wgmma instructions (C7515): a
    wgmma in a branch it cannot prove warpgroup-uniform, math drifting past
    ``wgmma.fence``, or a group in flight across a loop's back-edge."""
    return [n for n in notes if "C7515" in n]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def phase_device():
    import torch

    smi = card()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from torchft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    report, warnings = ptxas_report(_build.build_log)
    for name in sorted(report):
        log(f"  ptxas {name:18s} {report[name]}")
    for w in warnings:
        log(f"  ptxas {w}")
    spilled = spill_failures(report)
    if spilled:
        raise AssertionError(f"ptxas: {spilled} spill or were not reported: "
                             f"{report}")
    serialized = serialized_notes(warnings)
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    return smi, report


def _check(name: str, got, want, what: str, failed: list) -> float:
    """Hold a kernel's result against its plain version's under
    flash.KERNEL_TOL; note a failure and return the max abs error."""
    from torchft_tpu_torch.ops import flash

    e = flash.kernel_error(got, want)
    log(f"  {name:14s} {what:28s} max_abs_err {e['max_abs_err']:.3e} "
        f"worst/tol {e['worst']:.3f} rel_norm {e['rel_norm']:.3e} "
        f"{'ok' if e['ok'] else 'FAIL'}")
    if not e["ok"]:
        failed.append(f"{name} {what}")
    return e["max_abs_err"]


FLASH_SHAPE = (8, 1024, 12, 64)  # "125m": batch 8, seq 1024, 12 heads of 64
# (what, [B, S, H, D], timed): the flash kernels at each head_dim they
# take, at the attention shape of the model that reaches it and at one
# with work enough to time
FLASH_SHAPES = (
    ("tiny", (8, 128, 4, 16), False),
    ("head_dim 16", (8, 1024, 12, 16), True),
    ("head_dim 32", (1, 128, 2, 32), False),
    ("head_dim 32", (8, 1024, 12, 32), True),
    ("125m", FLASH_SHAPE, True),
    ("1b", (1, 2048, 16, 128), True),
)


def flash_inputs(seed: int, shape=FLASH_SHAPE):
    """q, k, v and dO: bf16 [B, S, H, D] on the card at ``shape``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.float32).to(torch.bfloat16)
                 for _ in range(4))


def check_flash(q, k, v, do) -> dict:
    """Hold the three flash kernels against their plain versions on q, k,
    v, dO, causal and non-causal: through ``flash_attention`` forward +
    backward, ``flash_attention_with_lse`` and ``flash_block_attention_bwd``
    with external lse/Delta, under ``flash.KERNEL_TOL``. Returns each
    kernel's max abs error; raises if any result disagrees."""
    import torch

    from torchft_tpu_torch.ops import flash

    scale = 1.0 / q.shape[-1] ** 0.5
    errs = {n: 0.0 for n in flash.LAUNCHES}
    failed = []

    def check(name, got, want, what):
        errs[name] = max(errs[name], _check(name, got, want, what, failed))

    log(f"  tolerance: {flash.KERNEL_TOL}")
    for causal in (True, False):
        tag = "causal" if causal else "full"
        # plain reference: forward, Delta, backward on the same inputs
        p_out, p_lse = flash.flash_fwd_plain(q, k, v, causal, scale, 128, 128)
        p_delta = (do.float() * p_out.float()).sum(-1).transpose(1, 2)
        p_delta = p_delta.contiguous()
        p_dq = flash.flash_bwd_dq_plain(q, k, v, do, p_lse, p_delta, causal,
                                        scale, 128, 128)
        p_dk, p_dv = flash.flash_bwd_dkv_plain(q, k, v, do, p_lse, p_delta,
                                               causal, scale, 128, 128)
        # the kernels through flash_attention forward + backward
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = flash.flash_attention(qg, kg, vg, causal=causal)
        out.backward(do)
        _, k_lse = flash.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check("flash_fwd", out, p_out, f"{tag} out")
        check("flash_fwd", k_lse, p_lse, f"{tag} lse")
        # autograd's backward kernels took the forward kernel's lse and its
        # out's Delta: the plain backward gets the same inputs
        a_delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        a_delta = a_delta.contiguous()
        a_dq = flash.flash_bwd_dq_plain(q, k, v, do, k_lse, a_delta, causal,
                                        scale, 128, 128)
        a_dk, a_dv = flash.flash_bwd_dkv_plain(q, k, v, do, k_lse, a_delta,
                                               causal, scale, 128, 128)
        check("flash_bwd_dq", qg.grad, a_dq, f"{tag} autograd dq")
        check("flash_bwd_dkv", kg.grad, a_dk, f"{tag} autograd dk")
        check("flash_bwd_dkv", vg.grad, a_dv, f"{tag} autograd dv")
        # the backward kernels with external lse / Delta
        dq, dk, dv = flash.flash_block_attention_bwd(
            q, k, v, do, p_lse, p_delta, causal)
        torch.cuda.synchronize()
        check("flash_bwd_dq", dq, p_dq, f"{tag} external-stats dq")
        check("flash_bwd_dkv", dk, p_dk, f"{tag} external-stats dk")
        check("flash_bwd_dkv", dv, p_dv, f"{tag} external-stats dv")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return errs


def flash_calls(q, k, v, do) -> dict:
    """{kernel: its wrapper's call as the main path makes it}: causal, the
    backward kernels with the forward kernel's lse and its out's Delta."""
    from torchft_tpu_torch.ops import flash

    scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = flash.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, True, scale),
        "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   True, scale),
        "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                     True, scale),
    }


def time_flash(q, k, v, do) -> dict:
    """{kernel: times} of the three flash kernels at q's shape, called as
    the main path calls them (causal; the backward kernels with the
    forward kernel's lse and its out's Delta): device ms, host µs per call,
    the plain version's ms, the bound, PyTorch's
    ``scaled_dot_product_attention`` forward beside the forward kernel
    (``library_ms``) and its fused backward (dq, dk and dv in one call)
    beside the two backward kernels (``library_pair_ms``)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash

    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    calls = flash_calls(q, k, v, do)
    out, lse = calls["flash_fwd"]()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    timing = {
        "flash_fwd": (
            lambda: flash.flash_fwd_plain(q, k, v, True, scale, 128, 128),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            attention_bound_ms(b, s, h, d, True, 2, 4, 1),
        ),
        "flash_bwd_dq": (
            lambda: flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                             scale, 128, 128),
            None,
            attention_bound_ms(b, s, h, d, True, 3, 5, 2),
        ),
        "flash_bwd_dkv": (
            lambda: flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True,
                                              scale, 128, 128),
            None,
            attention_bound_ms(b, s, h, d, True, 4, 6, 2),
        ),
    }
    rows = {}
    for name, (plain, lib, (bound, bound_by)) in timing.items():
        ms = cuda_ms(calls[name])
        us = host_us(calls[name])
        plain_ms = cuda_ms(plain, iters=3, warmup=1, repeats=1)
        lib_ms = cuda_ms(lib) if lib is not None else None
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": lib_ms,
                      "host_us": us}
        log(f"  {name:14s} kernel {ms:.4f} ms  host {us:.1f} us/call  "
            f"plain {plain_ms:.4f} ms  library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
            f"bound {bound:.4f} ms ({bound_by})")
    # yardstick beside the two backward kernels: the fused backward of
    # PyTorch's own flash attention (dq, dk and dv in one call), against
    # which the pair's sum compares. Autograd replays into a CUDA graph only
    # with its forward inside the capture, so the backward is timed as
    # forward + backward less the forward.
    qr, kr, vr = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    both_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), dot))
    bwd_ms = both_ms - rows["flash_fwd"]["library_ms"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["library_pair_ms"] = bwd_ms
    log(f"  yardstick: scaled_dot_product_attention backward (dq, dk, dv) "
        f"{bwd_ms:.4f} ms (forward + backward in one graph, less the "
        f"forward) against flash_bwd_dq + flash_bwd_dkv "
        f"{rows['flash_bwd_dq']['ms'] + rows['flash_bwd_dkv']['ms']:.4f} ms")
    return rows


def phase_kernels(seed: int, ptxas: dict):
    """The flash kernels checked at every shape of FLASH_SHAPES and timed
    at the timed ones: a row per kernel with the "125m" shape's times and
    a ``per_head_dim`` row per instantiation (its checked shapes, largest
    error, times at its timed shape, ptxas report and, filled in by the
    training phases, its launches on the main path)."""
    import torch

    per_d = {n: {} for n in FLASH_KERNELS}
    top = {}
    for what, shape, timed in FLASH_SHAPES:
        d = shape[3]
        log(f"  flash kernels at {what} {shape}")
        q, k, v, do = flash_inputs(seed, shape)
        errs = check_flash(q, k, v, do)
        for name in FLASH_KERNELS:
            row = per_d[name].setdefault(d, {
                "head_dim": d, "checked": [], "max_abs_err": 0.0,
                "launches": 0, "ptxas": ptxas.get(f"{name}/d{d}")})
            row["checked"].append(list(shape))
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])
        if timed:
            times = time_flash(q, k, v, do)
            for name in FLASH_KERNELS:
                per_d[name][d].update(shape=list(shape), **times[name])
            if shape == FLASH_SHAPE:
                top = times
        del q, k, v, do
        torch.cuda.empty_cache()
    return {name: {
        "name": name, "route": "cuda", "source": _SOURCES[name],
        "replaces": _TPU_KERNELS[name], "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in per_d[name].values()),
        "shape": list(FLASH_SHAPE), **top[name], "timed_by": TIMED_BY,
        "ptxas": ptxas.get(f"{name}/d{FLASH_SHAPE[3]}"),
        "per_head_dim": [per_d[name][d] for d in HEAD_DIMS],
    } for name in FLASH_KERNELS}


def _bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _max_abs_err(got, want) -> float:
    """Largest |got - want| over the elements finite in both (0 when the
    two agree bit for bit)."""
    import torch

    g, w = got.double(), want.double()
    ok = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w).abs()[ok].max()) if bool(ok.any()) else 0.0


CHUNK_STEP = CHUNK_BYTES // 4  # f32 elements of a chunk


class Bitwise:
    """Bitwise checks of codec results: logs each, keeps every kernel's
    largest finite difference, and raises from ``raise_failed`` if any
    check failed."""

    def __init__(self):
        self.errs = {"quant_int8": 0.0, "dequant_acc_int8": 0.0}
        self.failed = []

    def __call__(self, name, what, got, want) -> None:
        import torch

        same = torch.equal(_bits(got), _bits(want))
        self.errs[name] = max(self.errs[name], _max_abs_err(got, want))
        log(f"  {name:16s} {what:36s} bitwise {'ok' if same else 'FAIL'}")
        if not same:
            self.failed.append(f"{name} {what}")

    def raise_failed(self) -> None:
        if self.failed:
            raise AssertionError(f"codec kernels disagree with their plain "
                                 f"versions: {self.failed}")


def quant_cases(step: int, seed: int, device: str, sizes=()):
    """[(what, x, q, s)]: inputs of ``quant_int8`` at the shapes its kernel
    must handle, with the output views to quantize them into. Rows of x
    with a stride of 1 mod 4 elements (rows start off 16-byte alignment)
    and q a column slice of a wider int8 buffer (rows start on odd bytes);
    n = 1, step - 1, step and step + 1; a NaN in the last eighth of a chunk
    (the last CTA's slice) beside a clean chunk; and, per DDP bucket size
    in ``sizes``, the quantized psum's two calls over two groups: phase 1
    on [2, size] into q[:, :size] of a [2, 2 L] buffer, phase 2 on the
    reduced shards, a [2, L] view of a flat vector."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(rows, n):
        return torch.randn((rows, n), generator=gen, device=device) * 1e-3

    def outs(rows, n, q=None):
        if q is None:
            q = torch.zeros((rows, n), dtype=torch.int8, device=device)
        return q, torch.empty((rows, -(-n // step)), device=device)

    n = 4 * step + 37
    x = randn(3, n + (1 - n) % 4 + 4)[:, :n]  # row stride = 1 mod 4
    wide = torch.zeros((3, n + 3), dtype=torch.int8, device=device)
    cases = [("unaligned rows of x and q", x,
              *outs(3, n, wide[:, 1:1 + n]))]
    for n in sorted({1, max(1, step - 1), step, step + 1}):
        cases.append((f"n = {n}", randn(2, n), *outs(2, n)))
    x = randn(2, 2 * step + 5)
    x[1, 2 * step - 3] = float("nan")  # near chunk 1's end
    cases.append(("NaN in a chunk's last slice", x, *outs(2, 2 * step + 5)))
    for size in sorted(set(sizes)):
        L = -(-size // 2)
        q = torch.zeros((2, 2 * L), dtype=torch.int8, device=device)
        cases.append((f"bucket {size} phase 1", randn(2, size),
                      *outs(2, size, q[:, :size])))
        cases.append((f"bucket {size} phase 2", randn(1, 2 * L).view(2, L),
                      *outs(2, L)))
    return cases


def dequant_cases(step: int, seed: int, device: str, sizes=()):
    """[(what, q, scales, kwargs)]: inputs of ``dequant_acc_int8`` (and its
    keyword arguments) where its 16-element runs meet a boundary: a grid
    whose step is no multiple of 16 (chunk boundaries inside runs),
    per-shard grids whose shard length is no multiple of 16 (segment
    boundaries inside runs), ``valid`` inside a run, rows of q that start
    off 16-byte alignment (a view at byte 3 of a wider buffer, rows of
    another phase than row 0's), fewer elements than a run; and, per DDP
    bucket size in ``sizes``, the quantized psum's two decodes over two
    groups (phase 1: the [2, 2 L] padded rows, AVG; phase 2: the reduced
    shards as one row on per-shard grids) and phase 1 with its rows
    starting at byte 1."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def q_rows(rows, n, offset=0, pad=0):
        buf = torch.randint(-127, 128, (rows * (n + pad) + offset,),
                            generator=gen, device=device,
                            dtype=torch.int32).to(torch.int8)
        return buf[offset:].view(rows, n + pad)[:, :n]

    def scales(rows, chunks):
        return torch.rand((rows, chunks), generator=gen, device=device) * 1e-2

    n = 3 * step + 37
    L = step + 21  # a shard length no multiple of 16
    cps = -(-L // step)
    cases = [
        ("step inside runs, AVG", q_rows(2, n), scales(2, -(-n // step)),
         dict(valid=n, divisor=2)),
        ("rows off 16-byte alignment, valid inside a run",
         q_rows(3, n, offset=3, pad=5), scales(3, -(-n // step)),
         dict(valid=n - 7, divisor=3)),
        ("shard grid, seg inside runs", q_rows(1, 3 * L),
         scales(1, 3 * cps), dict(valid=3 * L - 10, seg=L, cps=cps)),
        ("fewer elements than a run", q_rows(1, 9, offset=5), scales(1, 1),
         dict(valid=9)),
    ]
    for size in sorted(set(sizes)):
        L = -(-size // 2)
        c1, c2 = -(-size // step), -(-L // step)
        cases += [
            (f"bucket {size} phase 1", q_rows(2, 2 * L), scales(2, c1),
             dict(valid=size, divisor=2)),
            (f"bucket {size} phase 2", q_rows(1, 2 * L), scales(1, 2 * c2),
             dict(valid=size, seg=L, cps=c2)),
            (f"bucket {size} phase 1, rows at byte 1",
             q_rows(2, 2 * L, offset=1), scales(2, c1),
             dict(valid=size, divisor=2)),
        ]
    return cases


def codec_inputs(seed: int):
    """The 125m gradient of two groups, x f32 [2, n_params] on the card,
    with an all-zero chunk, a NaN chunk and an Inf chunk on the 1 MiB
    grid; and the drill's DDP bucket sizes."""
    import torch

    from torchft_tpu_torch.models import CONFIGS, GPT
    from torchft_tpu_torch.ops import quant

    params = list(GPT(CONFIGS["125m"], device="meta").parameters())
    n_params = sum(p.numel() for p in params)
    sizes = bucket_sizes(params)
    rows, step = 2, CHUNK_STEP
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, n_params), generator=gen, device="cuda") * 1e-3
    x[0, step:2 * step] = 0.0             # an all-zero chunk: scale 1
    x[0, 2 * step + 5] = float("nan")     # poisons its own chunk only
    x[1, 3 * step + 17] = float("inf")
    chunks = quant.n_chunks(n_params, step)
    log(f"  codec input: {rows} x {n_params} f32 (the 125m gradient), "
        f"{chunks} chunks of {step} per row, tail "
        f"{n_params - (chunks - 1) * step}")
    return x, sizes


def codec_calls(x) -> dict:
    """{kernel: its wrapper's call at the 125m gradient x as the int8 plane
    makes it}: the phase-1 quantize of both rows into the first columns of
    a padded [2, 2 L] buffer, and the owner decode-accumulate of both
    sources."""
    import torch

    from torchft_tpu_torch.ops import quant

    rows, n = x.shape
    step = CHUNK_STEP
    L = -(-n // rows)
    q = torch.zeros((rows, rows * L), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, quant.n_chunks(n, step)), device="cuda")
    acc = torch.empty(rows * L, device="cuda")
    quant.quant_int8(x, step, out=(q[:, :n], s))
    return {
        "quant_int8": lambda: quant.quant_int8(x, step, out=(q[:, :n], s)),
        "dequant_acc_int8": lambda: quant.dequant_acc_int8(
            q, s, step, valid=n, out=acc),
    }


def check_codec(x, sizes, seed: int, check) -> None:
    """Both codec kernels against their plain versions at the 125m
    gradient x through the quantized psum's four calls, the special
    chunks' scales, then quant_int8 at every shape of quant_cases on the
    1 MiB grid, on a grid of 1000 (chunks starting off alignment) and on a
    4 MiB grid (chunks longer than a cluster holds), and dequant_acc_int8
    at every shape of dequant_cases on the 1 MiB grid and on a grid of
    1000."""
    import torch

    from torchft_tpu_torch.ops import quant

    rows, n = x.shape
    step = CHUNK_STEP
    L = -(-n // rows)
    q = torch.zeros((rows, rows * L), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, quant.n_chunks(n, step)), device="cuda")
    quant.quant_int8(x, step, out=(q[:, :n], s))
    pq, ps = quant.quant_int8_plain(x, step)
    torch.cuda.synchronize()
    check("quant_int8", "phase-1 q", q[:, :n], pq)
    check("quant_int8", "phase-1 scales", s, ps)
    if not (s[0, 1] == 1.0 and torch.isnan(s[0, 2]) and torch.isnan(s[1, 3])
            and bool(torch.isfinite(s[1, :3]).all())):
        check.failed.append("quant_int8 special chunks (zero, NaN, Inf)")
    del pq, ps
    acc = quant.dequant_acc_int8(q, s, step, valid=n)
    p_acc = quant.dequant_acc_int8_plain(q, s, step, valid=n)
    torch.cuda.synchronize()
    check("dequant_acc_int8", "owner sums (2 sources)", acc, p_acc)
    del p_acc
    c2 = quant.n_chunks(L, step)
    q2, s2 = quant.quant_int8(acc.view(rows, L), step)
    pq2, ps2 = quant.quant_int8_plain(acc.view(rows, L), step)
    out = quant.dequant_acc_int8(q2.view(1, -1), s2.view(1, -1), step,
                                 valid=n, seg=L, cps=c2)
    p_out = quant.dequant_acc_int8_plain(q2.view(1, -1), s2.view(1, -1),
                                         step, valid=n, seg=L, cps=c2)
    torch.cuda.synchronize()
    check("quant_int8", "phase-2 q (shard grid)", q2, pq2)
    check("quant_int8", "phase-2 scales", s2, ps2)
    check("dequant_acc_int8", "final decode (shard grid)", out, p_out)
    del q, s, acc, q2, s2, out, pq2, ps2, p_out
    for grid, sz in ((step, sizes), (1000, ()), (4 * step, ())):
        for what, xc, qc, sc in quant_cases(grid, seed, "cuda", sz):
            quant.quant_int8(xc, grid, out=(qc, sc))
            pq, ps = quant.quant_int8_plain(xc, grid)
            torch.cuda.synchronize()
            check("quant_int8", f"step {grid}, {what}: q", qc, pq)
            check("quant_int8", f"step {grid}, {what}: scales", sc, ps)
    for grid, sz in ((step, sizes), (1000, ())):
        for what, qc, sc, kw in dequant_cases(grid, seed, "cuda", sz):
            got = quant.dequant_acc_int8(qc, sc, grid, **kw)
            want = quant.dequant_acc_int8_plain(qc, sc, grid, **kw)
            torch.cuda.synchronize()
            check("dequant_acc_int8", f"step {grid}, {what}", got, want)
    torch.cuda.empty_cache()


def phase_quant_kernels(seed: int):
    """The int8 codec kernels bitwise against their plain versions (see
    check_codec), then timed at the 125m gradient and per wire step."""
    import torch

    from torchft_tpu_torch.ops import quant

    x, sizes = codec_inputs(seed)
    check = Bitwise()
    check_codec(x, sizes, seed, check)
    check.raise_failed()

    # times at the main path's shapes: the phase-1 quantize of both rows
    # and the owner decode-accumulate of both sources
    rows, n_params = x.shape
    step = CHUNK_STEP
    chunks = quant.n_chunks(n_params, step)
    L = -(-n_params // rows)
    n_el = rows * n_params
    q_bytes = n_el * 4 + n_el * 1 + rows * chunks * 4
    d_bytes = rows * rows * L * 1 + rows * chunks * 4 + rows * L * 4
    calls = codec_calls(x)
    q = torch.zeros((rows, rows * L), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, chunks), device="cuda")
    quant.quant_int8(x, step, out=(q[:, :n_params], s))
    timing = {  # yardsticks: PyTorch calls that move the same bytes
        "quant_int8": (
            lambda: quant.quant_int8_plain(x, step),
            lambda: q[:, :n_params].copy_(x),
            "q.copy_(x) (f32 -> int8)", q_bytes),
        "dequant_acc_int8": (
            lambda: quant.dequant_acc_int8_plain(q, s, step,
                                                 valid=n_params),
            lambda: torch.sum(q, 0, dtype=torch.float32),
            "torch.sum(q, 0, dtype=float32)", d_bytes),
    }
    out_rows = {}
    for name, (plain, yard, yard_what, nbytes) in timing.items():
        ms = cuda_ms(calls[name])
        us = host_us(calls[name], iters=20)
        plain_ms = cuda_ms(plain, iters=3, warmup=1, repeats=1)
        yard_ms = cuda_ms(yard)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        out_rows[name] = {
            "name": name, "route": "cuda", "source": _SOURCES[name],
            "replaces": _TPU_KERNELS[name], "launches": 0,
            "max_abs_err": check.errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "host_us": us, "timed_by": TIMED_BY,
        }
        log(f"  {name:16s} kernel {ms:.4f} ms  host {us:.1f} us/call  "
            f"plain {plain_ms:.4f} ms  "
            f"bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB)  "
            f"yardstick {yard_what} {yard_ms:.4f} ms")
    del x, q, s, calls
    torch.cuda.empty_cache()
    bounds = codec_step_bound_ms(sizes)
    for name, (ms, launches) in codec_step_ms(sizes, seed, check).items():
        out_rows[name].update(step_ms=ms, step_launches=launches,
                              step_bound_ms=bounds[name])
        log(f"  {name:16s} per wire step {ms:.4f} ms, bound "
            f"{bounds[name]:.4f} ms (bytes)")
    check.raise_failed()
    return out_rows


def bucket_sizes(params):
    """Element counts of the DDP buckets the drill's gradients fill."""
    from torchft_tpu_torch.ddp import _DEFAULT_BUCKET_BYTES, _BucketPlan

    plan = _BucketPlan(params, _DEFAULT_BUCKET_BYTES)
    return [sum(plan.sizes[i] for i in b) for b in plan.buckets]


def codec_step_bound_ms(sizes, n: int = 2):
    """{kernel: ms}: the least time the card could take for each codec
    kernel's launches in one wire step of the int8 drill (n groups): the
    bytes they must move over the card's memory rate, summed at each DDP
    bucket's own shapes. quant_int8 reads 4 B and writes 1 B an element in
    both phases (the n x size gradients, then the n x L reduced shards),
    plus 4 B a chunk; dequant_acc_int8 reads n B and writes 4 B an element
    of the n L padded sums in phase 1, reads 1 B and writes 4 B in phase
    2, plus the scales it reads."""
    step = CHUNK_STEP
    nbytes = {"quant_int8": 0, "dequant_acc_int8": 0}
    for size in sizes:
        L = -(-size // n)
        c1, c2 = -(-size // step), -(-L // step)
        nbytes["quant_int8"] += n * size * 5 + n * L * 5 + n * (c1 + c2) * 4
        nbytes["dequant_acc_int8"] += (n * L * (n + 4) + n * L * 5
                                       + n * (c1 + c2) * 4)
    return {k: b / PEAK_BYTES_PER_S * 1e3 for k, b in nbytes.items()}


def codec_step_ms(sizes, seed: int, check):
    """{kernel: (ms, launches)}: each codec kernel's time summed over one
    step of the int8 drill with a wire peer, two groups, at the shapes its
    launches have there: per DDP bucket (``sizes``) one phase-1 launch over
    both groups' rows and one phase-2 launch over the reduced shards (the
    quantized psum of comm/cuda_backend.py), at each bucket's own size.
    Each bucket's four calls are first held bitwise against the plain
    versions through ``check`` (a Bitwise)."""
    import torch

    from torchft_tpu_torch.ops import quant

    n, step = 2, CHUNK_STEP
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total = {"quant_int8": 0.0, "dequant_acc_int8": 0.0}
    for size in sorted(set(sizes)):
        count = sizes.count(size)
        L = -(-size // n)
        c1, c2 = quant.n_chunks(size, step), quant.n_chunks(L, step)
        x = torch.randn((n, size), generator=gen, device="cuda") * 1e-3
        q = torch.zeros((n, n * L), dtype=torch.int8, device="cuda")
        s = torch.empty((n, c1), device="cuda")
        acc = torch.empty(n * L, device="cuda")
        q2 = torch.empty((n, L), dtype=torch.int8, device="cuda")
        s2 = torch.empty((n, c2), device="cuda")
        out = torch.empty(n * L, device="cuda")
        calls = {  # phase 1, phase 2
            "quant_int8": (
                lambda: quant.quant_int8(x, step, out=(q[:, :size], s)),
                lambda: quant.quant_int8(acc.view(n, L), step, out=(q2, s2))),
            "dequant_acc_int8": (
                lambda: quant.dequant_acc_int8(q, s, step, valid=size,
                                               divisor=n, out=acc),
                lambda: quant.dequant_acc_int8(
                    q2.view(1, n * L), s2.view(1, n * c2), step, valid=size,
                    seg=L, cps=c2, out=out)),
        }
        tag = f"bucket {size}"
        calls["quant_int8"][0]()
        pq, ps = quant.quant_int8_plain(x, step)
        check("quant_int8", f"{tag} phase-1 q", q[:, :size], pq)
        check("quant_int8", f"{tag} phase-1 scales", s, ps)
        calls["dequant_acc_int8"][0]()
        check("dequant_acc_int8", f"{tag} phase-1 sums", acc,
              quant.dequant_acc_int8_plain(q, s, step, valid=size,
                                           divisor=n))
        calls["quant_int8"][1]()
        pq, ps = quant.quant_int8_plain(acc.view(n, L), step)
        check("quant_int8", f"{tag} phase-2 q", q2, pq)
        check("quant_int8", f"{tag} phase-2 scales", s2, ps)
        calls["dequant_acc_int8"][1]()
        check("dequant_acc_int8", f"{tag} phase-2 decode", out,
              quant.dequant_acc_int8_plain(
                  q2.view(1, n * L), s2.view(1, n * c2), step, valid=size,
                  seg=L, cps=c2))
        del pq, ps
        times = {name: cuda_ms(fns[0]) + cuda_ms(fns[1])
                 for name, fns in calls.items()}
        for name, ms in times.items():
            total[name] += count * ms
        log(f"  codec at a bucket of {size} f32 (x{count} per step): "
            f"quant_int8 {times['quant_int8']:.4f} ms, dequant_acc_int8 "
            f"{times['dequant_acc_int8']:.4f} ms (phase 1 + phase 2)")
        del x, q, s, acc, q2, s2, out, calls
    torch.cuda.empty_cache()
    log(f"  codec per wire step ({len(sizes)} buckets, 2 launches each): "
        f"quant_int8 {total['quant_int8']:.4f} ms, dequant_acc_int8 "
        f"{total['dequant_acc_int8']:.4f} ms")
    return {name: (ms, 2 * len(sizes)) for name, ms in total.items()}


def phase_train(config: str, steps: int, layers, seed: int, card: str,
                comm_backend: str = "host", comm_options=None):
    """Run the drill at CONFIGS[config]; return the flash kernels'
    launches (one per layer per forward/backward pass) and the result."""
    import dataclasses

    from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal
    from torchft_tpu_torch.models import CONFIGS

    cfg = CONFIGS[config]
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batch = 8
    log(f"  {config}: vocab {cfg.vocab_size} d_model {cfg.d_model} layers "
        f"{cfg.n_layers} heads {cfg.n_heads} (head_dim {cfg.head_dim}) d_ff "
        f"{cfg.d_ff} seq {cfg.max_seq_len} xent_chunks {cfg.xent_chunks}, "
        f"batch {batch}, gradient wire {comm_backend} {comm_options or ''}")
    t0 = time.perf_counter()
    result = run_kill_and_heal(cfg, kill_step=steps, steps_after=steps - 1,
                               device="cuda", batch_size=batch, seed=seed,
                               timeout=120.0, log=lambda m: log("  " + m),
                               comm_backend=comm_backend,
                               comm_options=comm_options)
    wall = time.perf_counter() - t0
    runs, heal = result["runs"], result["heal_step"]
    log(f"  group 1 healed at step {heal}; parameters bitwise equal to "
        f"group 0 at steps {result['checked_steps']}; {wall:.1f} s")
    for g, run in runs.items():
        times = ", ".join(f"{s}: {t * 1e3:.1f}"
                          for s, t in sorted(run.step_seconds.items()))
        log(f"  group {g} step ms {{{times}}}")
    phases = ("quorum", "forward_backward", "ddp_d2h", "ddp_ef",
              "ddp_wire", "ddp_h2d", "commit_barrier", "comm_wire_reduce")
    for g, run in runs.items():
        p50 = {p: round(run.metrics[f"{p}_p50_ms"], 1) for p in phases
               if f"{p}_p50_ms" in run.metrics}
        log(f"  group {g} phase p50 ms {p50}")
    heal_ms = runs[1].metrics.get("heal_wall_ms")
    heal_rate = runs[1].metrics.get("heal_bytes_per_s")
    log(f"  heal: wall {heal_ms:.1f} ms, wire {heal_rate / 1e9:.3f} GB/s")
    after = [s for s in result["checked_steps"] if s > heal]
    tokens = 2 * batch * cfg.max_seq_len
    rates = [tokens / max(runs[0].step_seconds[s], runs[1].step_seconds[s])
             for s in after]
    log(f"  tokens/s, two groups sharing the card, steps after the heal: "
        f"{[round(r) for r in rates]} ({card})")
    log(f"  forward/backward passes of both groups: {result['passes']}")
    return result["passes"] * cfg.n_layers, result


def check_plane_at_buckets(sizes, seed: int) -> None:
    """The int8 plane on the card against the same plane on the CPU (the
    codec kernels' plain versions), bitwise, at each distinct size of the
    drill's DDP buckets: two groups decode the same bytes, so the drill's
    own checks cannot see a kernel that is wrong but deterministic at the
    main path's shapes (phase-1 rows, phase-2 shards, their tail chunks)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool

    world = 2
    pools = {"cuda": DevicePool("cuda"), "cpu": DevicePool("cpu")}
    rng = np.random.default_rng(seed)
    for size in sorted(set(sizes)):
        grads = [(rng.standard_normal(size) * 1e-3).astype(np.float32)
                 for _ in range(world)]
        out = {}
        for device, pool in pools.items():
            ctxs = [CudaCommContext(timeout=120.0, **INT8_OPTIONS,
                                    chunk_bytes=CHUNK_BYTES, device_pool=pool)
                    for _ in range(world)]

            def worker(r):
                ctxs[r].configure(f"smoke://bucket{size}/{device}", r, world)
                w = ctxs[r].allreduce([grads[r].copy()], ReduceOp.SUM)
                return w.future().result(timeout=120)[0]

            try:
                with ThreadPoolExecutor(world) as ex:
                    out[device] = [f.result(180) for f in
                                   [ex.submit(worker, r) for r in range(world)]]
            finally:
                for c in ctxs:
                    c.shutdown()
        same = all(c.tobytes() == h.tobytes()
                   for c, h in zip(out["cuda"], out["cpu"]))
        log(f"  bucket of {size} f32: card plane vs CPU plane bitwise "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"int8 plane on the card differs from the "
                                 f"CPU plane at a bucket of {size}")


# the loss of the 1b GPT with the kernels against the same model with
# reference_attention on the card, whose P is rounded to bf16 before P V
# (tests/test_torch_cuda.py's LOSS_TOL)
LOSS_TOL = 2e-2
# a sample of its gradients, relative norm of the difference: the
# reference rounds P (and, in its backward, dP) to bf16 where the kernels
# keep f32; on the CPU the plain flash path against reference_attention
# differs by 0.5-1.4% at 4 and 8 layers of that shape, growing slowly with
# depth, and a wrong kernel moves a gradient by O(1)
GRAD_REL_NORM = 5e-2
GRAD_SAMPLE = ("wte.embedding", "layers_0.attn.q_proj.kernel",
               "layers_12.mlp.up_proj.kernel", "layers_23.attn.o_proj.kernel",
               "lm_head.kernel")


def phase_gpt_1b(seed: int):
    """One forward/backward of the 1b GPT at full width and depth, batch
    1, through the kernels; then the same model, its attention swapped for
    reference_attention, on the same tokens. Returns the flash launches
    and checks the loss and GRAD_SAMPLE against the reference."""
    import torch

    from torchft_tpu_torch.models import CONFIGS, GPT, transformer
    from torchft_tpu_torch.ops import attention, flash

    cfg = CONFIGS["1b"]
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len),
                        generator=gen, device="cuda")
    tgt = torch.roll(tok, -1, dims=1)
    log(f"  1b: {n_params} parameters, vocab {cfg.vocab_size} d_model "
        f"{cfg.d_model} layers {cfg.n_layers} heads {cfg.n_heads} (head_dim "
        f"{cfg.head_dim}) d_ff {cfg.d_ff} seq {cfg.max_seq_len} remat "
        f"{cfg.remat}, batch 1")

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        torch.cuda.synchronize()
        named = dict(model.named_parameters())
        return loss.item(), {n: named[n].grad.detach().clone()
                             for n in GRAD_SAMPLE}

    flash.reset_launch_counts()
    t1 = time.perf_counter()
    loss, grads = loss_and_grads()
    t2 = time.perf_counter()
    counts = dict(flash.LAUNCHES)
    kernel_attention = transformer.causal_attention
    transformer.causal_attention = attention.reference_attention
    try:
        ref_loss, ref_grads = loss_and_grads()
    finally:
        transformer.causal_attention = kernel_attention
    if dict(flash.LAUNCHES) != counts:
        raise AssertionError("the reference model launched a flash kernel")
    log(f"  loss {loss:.6f} with the kernels, {ref_loss:.6f} with "
        f"reference_attention (|diff| {abs(loss - ref_loss):.3e}, tolerance "
        f"{LOSS_TOL}); model built in {t1 - t0:.1f} s, forward/backward "
        f"{t2 - t1:.2f} s with the kernels ({torch.cuda.get_device_name(0)}, "
        f"first call)")
    failed = []
    if not (abs(loss - ref_loss) <= LOSS_TOL and loss == loss):
        failed.append(f"loss {loss} against {ref_loss}")
    for n in GRAD_SAMPLE:
        g, r = grads[n].double(), ref_grads[n].double()
        rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
        ok = bool(torch.isfinite(g).all()) and rel <= GRAD_REL_NORM
        log(f"  grad {n:32s} relative norm of the difference {rel:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"grad {n}: {rel}")
    del model, grads, ref_grads
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"1b with the kernels against the reference: "
                             f"{failed}")
    return counts, cfg.n_layers


# A checkpoint holds the f32 parameters and AdamW's two moments; a group
# keeps 2 (keep=2) with one more in flight as its .tmp.
CKPT_FILES_PER_GROUP = 3


def durable_disk_bytes(n_params: int, groups: int = 2) -> int:
    """Disk train_durable may fill at once: every group's kept checkpoints
    and the one it is writing, each 3 f32 copies of the parameters."""
    return groups * CKPT_FILES_PER_GROUP * 3 * 4 * n_params


def check_disk(directory: str, need: int) -> int:
    """Free bytes under ``directory``; fails with both figures if fewer
    than ``need``."""
    import shutil

    free = shutil.disk_usage(directory).free
    if free < need:
        raise AssertionError(
            f"train_durable needs {need / 1e9:.2f} GB free under "
            f"{directory} (2 groups x {CKPT_FILES_PER_GROUP} checkpoints of "
            f"{need / 6e9:.2f} GB), has {free / 1e9:.2f} GB")
    return free


def _p50s(metrics: dict, names) -> dict:
    return {n: round(metrics[f"{n}_p50_ms"], 3) for n in names
            if f"{n}_p50_ms" in metrics}


def durable_report(result: dict, batch: int, seq: int, card: str) -> list:
    """The lines train_durable prints about a ``run_resume_drill`` result:
    the fused path's phase p50s, quorum and commit p50s on full and on
    fast steps, every checkpoint write, the resumes, the heal, the
    committed step times and tokens/s."""
    runs = result["runs"]
    first = {g: runs[g][0] for g in (0, 1)}
    after = {g: runs[g][1] for g in (0, 1)}
    lines = [f"fused solo steps of group 0: {first[0].fused_steps} on "
             f"{first[0].captures} CUDA graph capture(s); phase p50 ms "
             f"{_p50s(first[0].fused_metrics, ('barrier', 'dispatch', 'fence'))}"
             f" ({card})"]
    for g in (0, 1):
        m = first[g].metrics
        fast = sorted(s for s, n in first[g].control_rpcs.items() if n == 0)
        lines.append(
            f"group {g}: full steps quorum p50 {m.get('quorum_p50_ms', 0):.3f}"
            f" ms commit_barrier p50 {m.get('commit_barrier_p50_ms', 0):.3f} "
            f"ms; fast steps {fast} (fastpath_steps "
            f"{m.get('fastpath_steps')}, 0 control RPCs) quorum_fast p50 "
            f"{m.get('quorum_fast_p50_ms', 0):.4f} ms commit_fast p50 "
            f"{m.get('commit_fast_p50_ms', 0):.4f} ms; lease grants "
            f"{m.get('lease_grants')} breaks {m.get('lease_breaks')}")
    for g in (0, 1):
        for life, run in enumerate(runs[g]):
            for c in run.checkpoints:
                lines.append(
                    f"group {g} life {life} checkpoint "
                    f"{os.path.basename(c['path'])}: stage "
                    f"{c['stage_s'] * 1e3:.1f} ms, persist "
                    f"{c['persist_s'] * 1e3:.1f} ms, {c['bytes']} bytes "
                    f"({c['bytes'] / max(c['persist_s'], 1e-9) / 1e9:.3f} "
                    "GB/s to disk)")
    for g in (0, 1):
        lines.append(f"group {g} resumed at step {after[g].resumed_step} in "
                     f"{after[g].resume_seconds * 1e3:.1f} ms (load + copy to "
                     "the card), bitwise equal to its checkpoint")
    heal = first[1].metrics
    lines.append(f"heal at step {result['heal_step']}: wall "
                 f"{heal.get('heal_wall_ms', 0):.1f} ms, wire "
                 f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s")
    tokens = 2 * batch * seq
    for life, runs_ in ((0, first), (1, after)):
        joint = sorted(set(runs_[0].step_seconds) & set(runs_[1].step_seconds))
        ms = {s: round(max(runs_[0].step_seconds[s],
                           runs_[1].step_seconds[s]) * 1e3, 1) for s in joint}
        rates = [round(tokens / (v / 1e3)) for v in ms.values()]
        lines.append(f"life {life} joint step ms {ms}, tokens/s of both "
                     f"groups {rates} ({card})")
    solo = {s: round(t * 1e3, 1) for s, t in first[0].step_seconds.items()
            if s <= result["heal_step"] - 1}
    lines.append(f"group 0 fused solo step host ms {solo} (dispatch; the "
                 "fence reads back 8 steps at a time)")
    lines.append(f"resumed step {result['resume_step'] + 1} repeated the "
                 f"first life's bitwise: {result['replay_equal']}")
    return lines


def phase_train_durable(seed: int, card: str, batch: int = 8):
    """run_resume_drill at "125m", full width and depth, over TCP under a
    lease_ms=2000 lighthouse, checkpoints in a temporary directory that is
    removed; returns the flash launches it must have made (one per layer
    per pass, graph replays and capture warm-ups included) and the
    result."""
    import shutil
    import tempfile

    from torchft_tpu_torch.examples.train_ddp import run_resume_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        need = durable_disk_bytes(n_params)
        free = check_disk(directory, need)
        log(f"  125m: {n_params} parameters; checkpoints under {directory}: "
            f"up to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB free")
        t0 = time.perf_counter()
        result = run_resume_drill(cfg, device="cuda", batch_size=batch,
                                  seed=seed, timeout=120.0,
                                  ckpt_dir=directory,
                                  log=lambda m: log("  " + m))
        log(f"  drill {time.perf_counter() - t0:.1f} s; both groups bitwise "
            f"equal at steps {result['checked_steps']}; telemetry during a "
            f"fast step: lease_live {result['telemetry']['lease_live']} "
            f"control_rpcs_per_step "
            f"{result['telemetry']['control_rpcs_per_step']}")
        for line in durable_report(result, batch, cfg.max_seq_len, card):
            log("  " + line)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if result["runs"][0][0].captures < 1 and result["runs"][0][0].fused_steps:
        raise AssertionError("group 0's fused steps ran without a CUDA graph")
    log(f"  forward/backward passes of all runs: {result['passes']}")
    return result["passes"] * cfg.n_layers, result


def fused_vs_classic(seed: int, card: str, batch: int = 8, steps: int = 3,
                     timed: int = 5) -> dict:
    """The fused step (one CUDA graph) against the same step run eagerly,
    on two "125m" models from one seed: bitwise equal parameters and AdamW
    state after ``steps`` steps, then the device time of each per step
    (CUDA events, median of ``timed``). Also reports whether AdamW's
    ``capturable=True`` (the step count on the card, which the graph
    needs) changes any bit of the eager step against ``capturable=False``."""
    import torch

    from torchft_tpu_torch.models import CONFIGS, GPT, make_train_step

    cfg = CONFIGS["125m"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(steps + timed):
        tok = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                            generator=gen, device="cuda")
        batches.append((tok, torch.roll(tok, -1, dims=1)))

    def build():
        model = GPT(cfg, device="cuda", seed=seed)
        optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                      weight_decay=1e-4, capturable=True)
        return model, optimizer, make_train_step(model, optimizer)

    (ma, oa, eager), (mb, ob, graph) = build(), build()
    for tok, tgt in batches[:steps]:
        eager._eager(tok, tgt)
        graph(tok, tgt)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(ma.parameters(),
                                                   mb.parameters()))
    equal = equal and all(
        torch.equal(oa.state[a][k], ob.state[b][k])
        for a, b in zip(ma.parameters(), mb.parameters())
        for k in oa.state[a])
    mc = GPT(cfg, device="cuda", seed=seed)
    oc = torch.optim.AdamW(mc.parameters(), lr=3e-4, weight_decay=1e-4)
    for tok, tgt in batches[:steps]:
        oc.zero_grad(set_to_none=True)
        mc.loss(tok, tgt).backward()
        oc.step()
    torch.cuda.synchronize()
    flag_equal = all(torch.equal(a, c) for a, c in zip(ma.parameters(),
                                                       mc.parameters()))
    del mc, oc

    def per_step(fn):
        times = []
        for tok, tgt in batches[steps:]:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(tok, tgt)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    out = {"bitwise_equal": equal, "classic_ms": per_step(eager._eager),
           "fused_ms": per_step(graph), "captures": graph.captures,
           "capturable_bits_equal": flag_equal}
    log(f"  fused step {out['fused_ms']:.2f} ms (one CUDA graph) against the "
        f"same step eager {out['classic_ms']:.2f} ms, 125m batch {batch}, "
        f"median of {timed}; bitwise equal after {steps} steps: {equal}; "
        f"eager steps with capturable=True equal to capturable=False: "
        f"{flag_equal} ({card})")
    del ma, mb, oa, ob, eager, graph
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("the fused step's CUDA graph differs from the "
                             "same step run eagerly")
    return out


def _outer_report(run, card: str) -> str:
    """One group's outer-sync p50s (ms) and last-round gauges."""
    m = run.metrics
    p50 = _p50s(m, ("outer_d2h", "outer_ef", "outer_wire", "outer_land",
                    "quorum", "commit_barrier"))
    gauges = {k: round(m[k], 3) for k in (
        "outer_wire_ms", "outer_wire_exposed_ms", "outer_overlap",
        "outer_wire_bytes", "outer_inflight_at_drain") if k in m}
    rounds = {s: round(t * 1e3, 1) for s, t in run.round_seconds.items()}
    return (f"phase p50 ms {p50}; last round {gauges}; committed round ms "
            f"{rounds} ({card})")


def phase_train_diloco(seed: int, card: str, batch: int = 8):
    """run_diloco_drill at "125m" (module docstring, phase 9); returns the
    flash launches it must have made and the result."""
    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    log(f"  125m: {n_params} parameters, batch {batch}, 2 groups over TCP, "
        f"sync_every 8, 2 fragments: {4 * n_params} bytes of f32 per round "
        "per group")
    t0 = time.perf_counter()
    result = run_diloco_drill(cfg, device="cuda", batch_size=batch,
                              seed=seed, timeout=120.0,
                              log=lambda m: log("  " + m))
    runs = result["runs"]
    survivor, restarted = runs[0][0], runs[1][1]
    if result["checked_rounds"] != {1: 2, 2: 2, 4: 2, 5: 2}:
        raise AssertionError(f"rounds both groups committed: "
                             f"{result['checked_rounds']}, the schedule has "
                             "1, 2, 4 and 5")
    log(f"  drill {time.perf_counter() - t0:.1f} s; rounds both groups "
        f"committed, bitwise equal (parameters and outer state): "
        f"{sorted(result['checked_rounds'])}; group 1 healed at round "
        f"{restarted.healed_at}")
    for g, life in ((0, survivor), (1, runs[1][0]), (1, restarted)):
        log(f"  group {g}: {_outer_report(life, card)}")
    heal = restarted.metrics
    log(f"  heal: wall {heal.get('heal_wall_ms', 0):.1f} ms, wire "
        f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    tokens = 2 * 8 * batch * cfg.max_seq_len  # both groups' inner steps
    g1 = {**runs[1][0].round_seconds, **restarted.round_seconds}
    rates = {s: round(tokens / max(t, g1[s]))
             for s, t in sorted(survivor.round_seconds.items()) if s in g1}
    log(f"  tokens/s of both groups by committed round {rates} ({card})")
    losses = survivor.losses
    log(f"  group 0 loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"forward/backward passes of all runs: {result['passes']}")
    return result["passes"] * cfg.n_layers, result


# train_diloco_sharded: the sharded outer update with exchange on heal, one
# group's wire in a child process
DILOCO_SHARDED = dict(groups=3, sync_every=8, num_fragments=3,
                      subproc_groups=(2,))
# the schedule: group 2 killed at inner step 4 of round 3, its restart
# heals at round 4, its child SIGSTOPped at round 5's fence, 6 rounds
DILOCO_SHARDED_SCHEDULE = dict(rounds=6, kill=(2, 2, 4), wedge=(2, 4))
# the wire's timeout (s): a wedge costs it on the peers, and 10 s more on
# the wedged group, whose pump gives its child up after timeout + 10
DILOCO_WIRE_TIMEOUT = 8.0
DILOCO_SHARDED_P50S = ("outer_d2h", "outer_wire", "outer_land", "reshard")


def diloco_sharded_host_bytes(n_params: int,
                              groups: int = DILOCO_SHARDED["groups"]) -> int:
    """Host memory train_diloco_sharded may hold at once, in f32 copies of
    the parameters: per group the backup, the fragment arenas, the outer
    momentum (all of it in the replicated arm), a fence's snapshot of it and
    a committed round's parameters (5); once, the heal's staged state on
    both ends (params, AdamW's moments, backup, momentum: 10), the kept
    rounds of both arms (4) and the wire child's copies of a fragment (2)."""
    return (groups * 5 + 16) * 4 * n_params


def diloco_sharded_device_bytes(n_params: int, act: int,
                                groups: int = DILOCO_SHARDED["groups"]
                                ) -> int:
    """Device memory train_diloco_sharded may hold at once: each group's
    f32 parameters, gradients and two AdamW moments (16 bytes a parameter),
    a restarted group's model beside its dead life's (4), and per group one
    pass's activations and its CUDA graph's private pool (one more)."""
    return (16 * groups + 4) * n_params + 2 * groups * act


def _reshards(run) -> list:
    keys = ("old_world", "new_world", "rank", "owned_fragments",
            "adopted_fragments", "wire_bytes", "lower_bound_bytes",
            "reinit_fragments", "dropped_fragments")
    return [{k: e.get(k) for k in keys} for e in run.events
            if e["kind"] == "reshard"]


def check_diloco_sharded(result: dict, replicated: dict) -> list:
    """The schedule's five checks on a ``run_diloco_drill`` result of
    train_diloco_sharded (module docstring, phase 14) against its
    replicated arm; raises on a miss, returns one line per check."""
    runs = result["runs"]
    survivors, restarted = (0, 1), runs[2][1]
    lines = []
    ranks = {g: next(r["rank"] for r in _reshards(runs[g][0])
                     if r["new_world"] == 3) for g in (0, 1, 2)}
    rounds = result["checked_rounds"]
    # 1. rounds 1-2: all three, each its own fragment, equal to replicated
    _require(rounds.get(1) == 3 and rounds.get(2) == 3
                   and replicated["checked_rounds"] == {1: 3, 2: 3},
                   f"rounds 1-2 not committed by all three groups in both "
                   f"arms: {rounds}, {replicated['checked_rounds']}")
    for step in (1, 2):
        want = {g: [f for f in range(3) if f % 3 == ranks[g]]
                for g in (0, 1, 2)}
        _require(result["held"][step] == want,
                       f"round {step}: held {result['held'][step]}, want "
                       f"{want}")
        same = all(a.equal(b) for a, b in zip(result["params"][step],
                                               replicated["params"][step]))
        _require(same, f"round {step}: sharded parameters differ from "
                             "the replicated arm's")
    lines.append("1. rounds 1-2: 3 groups bitwise equal, each holding "
                 f"fragment f % 3 == rank (ranks {ranks}), bitwise equal to "
                 "the replicated arm: passed")
    # 2. round 3: group 2 killed, its child gone; 0 and 1 commit at world 2
    shrink = {g: [r for r in _reshards(runs[g][0]) if r["new_world"] == 2]
              for g in survivors}
    # f2's owner at world 2: wire rank 2 % 2
    owner = next((g for g in survivors
                  if shrink[g] and shrink[g][0]["rank"] == 2 % 2), None)
    _require(rounds.get(3) == 2 and all(len(v) == 1
                                              for v in shrink.values()),
                   f"round 3: committed by {rounds.get(3)} groups, reshards "
                   f"at world 2 {shrink}")
    _require(all(shrink[g][0]["reinit_fragments"] == (g == owner)
                       for g in survivors),
                   f"round 3: reinit_fragments {shrink}, want 1 on f2's new "
                   f"owner (group {owner}) and 0 on the other")
    _require(result["killed_pid"] is not None,
                   "group 2's wire child was never seen")
    lines.append(f"2. round 3: group 2 killed at inner step 4 (its child "
                 f"{result['killed_pid']} gone), groups 0 and 1 committed at "
                 f"world 2 after a reshard {shrink}: passed")
    # 3. the restart heals, and the grow moves exactly the lower bound
    grow = {g: [r for r in _reshards(runs[g][-1]) if r["new_world"] == 3
                and r["old_world"] in (2, None)][-1] for g in (0, 1, 2)}
    holder = result["grow"]["holders"].get(2)
    donor_group = next((g for g in survivors
                        if ranks[g] == result["donor"]), None)
    moved = sum(g["wire_bytes"] for g in grow.values())
    _require(restarted.healed_at == [4]
                   and all(r["reinit_fragments"] == 0 for r in grow.values())
                   and result["grow"]["equal"]
                   and (donor_group == holder or moved > 0),
                   f"grow: healed at {restarted.healed_at}, reshards {grow}, "
                   f"{result['grow']}, donor group {donor_group}")
    new_pid = result["pids"][(2, 1)][0]
    _require(new_pid != result["killed_pid"],
                   "the restarted group reused its dead child's pid")
    lines.append(f"3. group 2 restarted (child {new_pid}), healed at 4 from "
                 f"group {donor_group} (f2's holder: group {holder}); grow "
                 f"reshards {grow}; its f2 state bitwise the holder's: passed")
    # 4. round 5: the wedge aborts every group's round, all reconfigure
    wedged = result["wedged"]
    aborted = {g: (4, False) in runs[g][-1].rounds for g in (0, 1, 2)}
    reform = {g: [r for r in _reshards(runs[g][-1])
                  if r["old_world"] == r["new_world"] == 3] for g in (0, 1, 2)}
    _require(all(aborted.values()) and all(reform.values()),
                   f"round 5: aborted {aborted}, reconfigure reshards "
                   f"{reform}")
    lines.append(f"4. round 5: group 2's child {wedged['pid']} SIGSTOPped "
                 f"mid-round, every group aborted and rolled back bitwise "
                 f"(parameters and outer states), every group reconfigured, "
                 f"the child SIGKILLed and replaced by {wedged['next_pid']}: "
                 "passed")
    # 5. round 6: all three commit
    _require(rounds.get(5) == 3 and rounds.get(6) == 3,
                   f"rounds 5-6 committed by {rounds.get(5)}, "
                   f"{rounds.get(6)} groups")
    lines.append("5. rounds 5-6 (the wedged round retried, then round 6): "
                 "all three groups bitwise equal: passed")
    lines.append(f"coverage: after every committed round the live groups "
                 f"held each fragment once {result['held']}")
    return lines


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_train_diloco_sharded(seed: int, card: str, batch: int = 8):
    """The sharded DiLoCo drill (module docstring, phase 14) after its
    replicated arm; returns the flash launches it must have made and the
    result."""
    import torch

    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    need_host = diloco_sharded_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_diloco_sharded")
    act = gpt_activation_bytes(cfg, batch)
    need = diloco_sharded_device_bytes(n_params, act)
    cuda = torch.cuda.is_available()
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        if free < need:
            raise AssertionError(
                f"train_diloco_sharded needs {need / 1e9:.2f} GB of device "
                f"memory free, has {free / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()
    log(f"  125m: {n_params} parameters, batch {batch}, 3 groups over TCP "
        f"at codec none (group 2's wire in a child), sync_every 8, 3 "
        f"fragments, wire timeout {DILOCO_WIRE_TIMEOUT} s; host memory: up "
        f"to {need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available; "
        f"device memory: up to {need / 1e9:.2f} GB")
    common = dict(DILOCO_SHARDED, device="cuda", batch_size=batch, seed=seed,
                  timeout=120.0, keep_params=(1, 2),
                  comm_options={"timeout": DILOCO_WIRE_TIMEOUT},
                  log=lambda m: log("  " + m))
    t1 = time.perf_counter()
    replicated = run_diloco_drill(cfg, rounds=2, kill=None,
                                  sharded_outer=False, **common)
    t_rep = time.perf_counter() - t1
    log(f"  replicated arm (sharded_outer=False, 2 rounds): {t_rep:.1f} s")
    t1 = time.perf_counter()
    result = run_diloco_drill(cfg, sharded_outer=True,
                              **DILOCO_SHARDED_SCHEDULE, **common)
    t_drill = time.perf_counter() - t1
    for line in check_diloco_sharded(result, replicated):
        log("  " + line)
    runs = result["runs"]
    for g in sorted(runs):
        for life, run in enumerate(runs[g]):
            rounds = {s: round(t, 3) for s, t in run.round_seconds.items()}
            log(f"  group {g} life {life}: p50 ms "
                f"{_p50s(run.metrics, DILOCO_SHARDED_P50S)}; committed "
                f"round s {rounds}; reshard events {_reshards(run)} ({card})")
    heal = runs[2][1].metrics
    log(f"  heal of group 2 at round 4: wall "
        f"{heal.get('heal_wall_ms', 0):.1f} ms, wire "
        f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated"
            if cuda else "not measured")
    log(f"  drill {t_drill:.1f} s, replicated arm {t_rep:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s; device memory peak {peak}; "
        f"forward/backward passes: {replicated['passes']} + "
        f"{result['passes']} ({card})")
    del replicated["params"], result["params"]
    passes = replicated["passes"] + result["passes"]
    return passes * cfg.n_layers, result


def _compute_pids() -> list:
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.split()


def check_comm_child(card: str, mb: int = 181) -> None:
    """A ``SubprocessCommContext`` child on the card's host holds no CUDA
    context: the device's free memory does not move when it starts (a
    context costs hundreds of MB) and ``nvidia-smi`` lists no new compute
    process. (The child maps ``libcuda``, as any process that imports torch
    does; that alone makes no context.) Then one allreduce of ``mb`` MB of
    f32 (a 125m fragment) through it at world 1, timed: the round trip
    through the process boundary."""
    import torch

    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.subproc import SubprocessCommContext

    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    apps0 = _compute_pids()
    store = StoreServer()
    ctx = SubprocessCommContext(timeout=60.0)
    try:
        t0 = time.perf_counter()
        ctx.configure(f"{store.addr}/smoke_child", 0, 1)
        spawn = time.perf_counter() - t0
        pid = ctx.child_pid()
        free1 = torch.cuda.mem_get_info()[0]
        apps1 = _compute_pids()
        with open(f"/proc/{pid}/maps") as f:
            libcuda = "libcuda.so" in f.read()
        x = torch.arange(mb * (1 << 20) // 4, dtype=torch.float32).numpy()
        trips = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = ctx.allreduce([x.copy()]).future().result(timeout=120)[0]
            trips.append(time.perf_counter() - t0)
        same = out.tobytes() == x.tobytes()
    finally:
        ctx.shutdown()
        store.shutdown()
    log(f"  comm child {pid}: spawned and configured in {spawn:.2f} s; "
        f"device free memory {free0 / 1e9:.3f} -> {free1 / 1e9:.3f} GB; "
        f"nvidia-smi compute pids {apps0} -> {apps1}; libcuda mapped "
        f"{libcuda}; {mb} MB allreduce at world 1 through the child "
        f"{[round(t * 1e3, 1) for t in trips]} ms, bitwise {same} ({card})")
    if (str(pid) in apps1 or len(apps1) > len(apps0)
            or free0 - free1 > 64 * (1 << 20) or not same):
        raise AssertionError(f"the comm child {pid} made a CUDA context "
                             f"(compute pids {apps0} -> {apps1}, free memory "
                             f"{free0} -> {free1}) or garbled its op")


LOCALSGD_GROUPS = 4


def localsgd_host_bytes(n_params: int, groups: int = LOCALSGD_GROUPS) -> int:
    """Host memory train_localsgd_int8 may hold at once, in f32 copies of
    the parameters: per group the backup, the fragment arenas, the
    error-feedback residuals and scratch, round 1's recorded fragment ops
    (inputs and outputs) and their CPU replay (8); once, the heal's staged
    state on both ends (parameters and AdamW's moments, 6)."""
    return (groups * 8 + 6) * 4 * n_params


def check_host_memory(need: int, meminfo: str = "/proc/meminfo",
                      what: str = "train_localsgd_int8") -> int:
    """The host's available memory (``MemAvailable``); fails with both
    figures if less than ``need``."""
    with open(meminfo) as f:
        fields = dict(line.split(":", 1) for line in f)
    free = int(fields["MemAvailable"].split()[0]) * 1024
    if free < need:
        raise AssertionError(
            f"{what} needs {need / 1e9:.2f} GB of host memory "
            f"available, has {free / 1e9:.2f} GB")
    return free


def check_plane_at_fragments(recorded, seed: int) -> None:
    """Round 1's fragment ops on the card against the same plane on the
    CPU, bitwise: each recorded op's inputs of every group, reduced by
    ``DevicePool("cpu")`` contexts, must give the bits each group got."""
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool

    groups = sorted(recorded)
    world = len(groups)
    pool = DevicePool("cpu")
    for op in sorted(recorded[groups[0]]):
        ctxs = [CudaCommContext(timeout=300.0, **INT8_OPTIONS,
                                chunk_bytes=CHUNK_BYTES, device_pool=pool)
                for _ in groups]

        def worker(r):
            ctxs[r].configure(f"smoke://fragment{op}", r, world)
            inputs = [a.copy() for a in recorded[groups[r]][op][0]]
            return ctxs[r].allreduce(inputs, ReduceOp.SUM).future().result(
                timeout=300)

        try:
            with ThreadPoolExecutor(world) as ex:
                cpu = [f.result(600) for f in
                       [ex.submit(worker, r) for r in range(world)]]
        finally:
            for c in ctxs:
                c.shutdown()
        same = all(a.tobytes() == b.tobytes()
                   for r, g in enumerate(groups)
                   for a, b in zip(cpu[r], recorded[g][op][1]))
        size = recorded[groups[0]][op][0][0].size
        log(f"  round 1 fragment op {op} ({size} f32, {world} groups): card "
            f"plane vs CPU plane bitwise {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"int8 plane on the card differs from the "
                                 f"CPU plane at fragment op {op}")


def phase_train_localsgd_int8(seed: int, card: str, batch: int = 8):
    """The LocalSGD drill on the int8 device plane (module docstring, phase
    10); returns the flash launches, the codec launches per kernel and the
    result."""
    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    need = localsgd_host_bytes(n_params)
    free = check_host_memory(need)
    log(f"  125m: {n_params} parameters, batch {batch}, {LOCALSGD_GROUPS} "
        f"groups on the cuda plane {INT8_OPTIONS}; host memory: up to "
        f"{need / 1e9:.2f} GB, {free / 1e9:.1f} GB available")
    t0 = time.perf_counter()
    result = run_diloco_drill(
        cfg, algo="local_sgd", groups=LOCALSGD_GROUPS, rounds=3, kill=None,
        fault=(3, 4), record_ops=(1, 2), device="cuda", batch_size=batch,
        seed=seed, timeout=300.0, log=lambda m: log("  " + m),
        comm_backend="cuda", comm_options=INT8_OPTIONS)
    runs = result["runs"]
    if result["checked_rounds"] != {1: 4, 2: 3, 3: 4}:
        raise AssertionError(f"groups committing each round: "
                             f"{result['checked_rounds']}, the schedule has "
                             "4, 3 and 4")
    log(f"  drill {time.perf_counter() - t0:.1f} s; groups committing each "
        f"round, bitwise equal: {result['checked_rounds']}; group 3's round "
        f"2 aborted and rolled back bitwise, healed at "
        f"{runs[3][0].healed_at}")
    for g in sorted(runs):
        m = runs[g][0].metrics
        ratio = m.get("comm_encoded_bytes", 0) / max(1, m.get("comm_raw_bytes",
                                                              1))
        log(f"  group {g}: {_outer_report(runs[g][0], card)}; "
            f"comm_encoded_bytes {m.get('comm_encoded_bytes')} "
            f"({ratio:.3f} of raw)")
    heal = runs[3][0].metrics
    log(f"  heal of group 3: wall {heal.get('heal_wall_ms', 0):.1f} ms, wire "
        f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    # every fragment op of the 3 rounds had 3 peers on the wire
    codec = 2 * 2 * 3
    log(f"  2 fragments x 3 rounds with a peer x 2 launches = {codec} of "
        f"each codec kernel; forward/backward passes: {result['passes']}")
    check_plane_at_fragments(result["recorded"], seed)
    return result["passes"] * cfg.n_layers, codec, result


# train_multijob: the multi-tenant control plane at 125m
MULTIJOB_TRAINERS = 5  # a0, a1, b0, b1, hi0 (the observer trains nothing)
MULTIJOB_CONCURRENT = 4  # a0, a1, b0 and b1 train at once
MULTIJOB_GRAPHS = 3  # solo steps capture CUDA graphs: a0 (alone), b0, hi0


def gpt_activation_bytes(cfg, batch: int) -> int:
    """A reckoning of one forward/backward's live activations in f32: per
    layer 18 tensors of batch x seq x d_model (the block's inputs, norms,
    q/k/v, attention output, residuals and the MLP's two d_ff-wide ones at
    4 each), and the logits with their gradient."""
    bsd = batch * cfg.max_seq_len * cfg.d_model
    return 4 * (18 * bsd * cfg.n_layers
                + 2 * batch * cfg.max_seq_len * cfg.vocab_size)


def multijob_device_bytes(n_params: int, act: int,
                          trainers: int = MULTIJOB_TRAINERS) -> int:
    """Device memory train_multijob may hold at once: each trainer's f32
    parameters, gradients and two AdamW moments (16 bytes a parameter),
    the observer's parameters, the activations of the groups training at
    once, and the private memory pools of the CUDA graphs the solo steps
    capture (one pass's activations each)."""
    return (16 * trainers + 4) * n_params + act * (MULTIJOB_CONCURRENT
                                                   + MULTIJOB_GRAPHS)


def multijob_host_bytes(n_params: int) -> int:
    """Host memory train_multijob may hold at once, in f32 copies of the
    parameters: per trainer the DDP staging arena, the wire's buffers and
    scratch (4); once, the heal's staged state on both ends (6)."""
    return (MULTIJOB_TRAINERS * 4 + 6) * 4 * n_params


MULTIJOB_PHASES = ("quorum", "quorum_fast", "forward_backward", "ddp_wire",
                   "commit_barrier", "commit_fast", "probe_forward")


def multijob_report(result: dict, card: str) -> list:
    """The lines train_multijob prints about a ``run_multijob_drill``
    result: per job and group the phase p50s, B's during A's kill and
    heal, its counters, the heal, the eviction and the drill's wall time."""
    runs = result["runs"]
    lines = []
    for job, names in (("a", ("a0", "a1", "a_obs")), ("b", ("b0", "b1")),
                       ("hi", ("hi0",))):
        for name in names:
            for life, run in enumerate(runs[name]):
                lines.append(f"job {job} {name} life {life} phase p50 ms "
                             f"{_p50s(run.metrics, MULTIJOB_PHASES)} "
                             f"({card})")
    k = result["heal_step"] - 2
    for name, m in sorted(result["b_window"].items()):
        lines.append(f"job b {name} during a's kill and heal (steps {k}-"
                     f"{result['heal_step'] + 1}): quorum_fast p50 "
                     f"{m.get('quorum_fast_p50_ms', 0):.4f} ms, commit_fast "
                     f"p50 {m.get('commit_fast_p50_ms', 0):.4f} ms, 0 control "
                     f"RPCs a step ({card})")
    keys = ("membership_epoch", "quorum_compute_count", "lease_breaks")
    lines.append("job b's counters before and after the window: "
                 + ", ".join(f"{key} {result['b_status']['before'][key]} -> "
                             f"{result['b_status']['after'][key]}"
                             for key in keys))
    heal = runs["a1"][-1].metrics
    lines.append(f"a1's heal at step {result['heal_step']}: wall "
                 f"{heal.get('heal_wall_ms', 0):.1f} ms, wire "
                 f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    ev = result["eviction"]
    lines.append(f"b1 evicted at step {result['total']}: answered in "
                 f"{ev['seconds'] * 1e3:.2f} ms; jobs.b preemptions "
                 f"{ev['status']['preemptions']}, evicted "
                 f"{ev['status']['evicted']}; job_preempted events "
                 f"{len(ev['events'])}; parameters unchanged "
                 f"{ev['unchanged']}")
    lines.append(f"a0 and b0 (same seeds and data) bitwise equal at steps "
                 f"{result['cross_job_equal']} of 1-{k}")
    lines.append(f"drill {result['seconds']:.1f} s; passes: {result['passes']}"
                 f" training, {result['probe_passes']} observer probe, "
                 f"{result['hi_passes']} hi0 ({card})")
    return lines


def phase_train_multijob(seed: int, card: str, batch: int = 8):
    """The multi-tenant drill (module docstring, phase 4): returns the flash
    kernels' launches by head_dim and the result."""
    import torch

    from torchft_tpu_torch.examples.train_ddp import run_multijob_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    need_host = multijob_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_multijob")
    act = gpt_activation_bytes(cfg, batch)
    need = multijob_device_bytes(n_params, act)
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[0]
    hi_name = "125m"
    if free < need:
        # the late job at "tiny": jobs a and b stay at full size
        hi_name = "tiny"
        need = multijob_device_bytes(n_params, act, MULTIJOB_TRAINERS - 1)
        if free < need:
            raise AssertionError(
                f"train_multijob needs {need / 1e9:.2f} GB of device memory "
                f"free, has {free / 1e9:.2f} GB")
    hi_cfg = CONFIGS[hi_name]
    log(f"  125m: {n_params} parameters, batch {batch}; jobs a (a0, a1, an "
        f"observer), b (b0, b1) and hi (hi0 at {hi_name}) over TCP at "
        "codec none; "
        f"device memory: up to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB free "
        f"({held / 1e9:.2f} GB held by earlier phases);"
        f" host memory: up to {need_host / 1e9:.2f} GB, "
        f"{free_host / 1e9:.1f} GB available")
    torch.cuda.reset_peak_memory_stats()
    result = run_multijob_drill(cfg, hi_cfg=hi_cfg, device="cuda",
                                batch_size=batch, seed=seed, timeout=300.0,
                                log=lambda m: log("  " + m))
    for line in multijob_report(result, card):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    trained = result["passes"] * cfg.n_layers
    per_d = {cfg.head_dim: {"flash_fwd": trained
                            + result["probe_passes"] * cfg.n_layers,
                            "flash_bwd_dq": trained,
                            "flash_bwd_dkv": trained}}
    hi = result["hi_passes"] * hi_cfg.n_layers
    row = per_d.setdefault(hi_cfg.head_dim, dict.fromkeys(per_d[cfg.head_dim],
                                                          0))
    for name in row:
        row[name] += hi
    return per_d, result


# train_moe: the template heal of examples/train_moe.py's twin at
# "moe-8x125m", two groups of MOE_RANKS ranks
MOE_RANKS = 2
MOE_SCHEDULE = dict(kill_step=3, steps_alone=1, steps_after=2)
MOE_PHASES = ("quorum", "forward_backward", "ddp_d2h", "ddp_wire", "ddp_h2d",
              "commit_barrier", "heal_stage", "heal_wire", "heal_h2d")


def moe_activation_bytes(cfg, batch: int) -> int:
    """A reckoning of one rank's live activations in a forward/backward of
    the MoE model with activation checkpointing: every block's bf16 input
    kept, one block recomputed at a time, whose routing holds about 8 f32
    tensors of tokens x experts x capacity (the dispatch and combine
    masks, their parts and gradients), and the chunked loss's logits with
    their gradient (one chunk of the vocabulary, f32)."""
    n = batch * cfg.max_seq_len
    cap = max(1, int(cfg.capacity_factor * n * 2 / cfg.num_experts))
    keep = 2 * n * cfg.d_model * cfg.n_layers
    routing = 4 * 8 * n * cfg.num_experts * cap
    block = 4 * 18 * n * max(cfg.d_model, cfg.d_ff)
    logits = 2 * 4 * n * cfg.vocab_size // max(1, cfg.xent_chunks)
    return keep + routing + block + logits


def moe_device_bytes(n_params: int, act: int, ranks: int = 2 * MOE_RANKS
                     ) -> int:
    """Device memory train_moe may hold at once: each rank's f32
    parameters, gradients and two AdamW moments (16 bytes a parameter),
    the drill's kept copy of one rank's parameters and moments (12), each
    healer rank's incoming state before it is copied in (12 each), and
    every rank's activations."""
    return (16 * ranks + 12 + 12 * MOE_RANKS) * n_params + act * ranks


def moe_host_bytes(n_params: int, ranks: int = 2 * MOE_RANKS) -> int:
    """Host memory train_moe may hold at once, in f32 copies of the
    parameters: per rank DDP's two staging arenas and the wire's buffers
    (4); per donor rank its staged state (3), per healer rank its pinned
    regions (3)."""
    return (ranks * 4 + 2 * MOE_RANKS * 3) * 4 * n_params


def moe_report(result: dict, n_params: int, state_bytes: int,
               card: str) -> list:
    lines = [f"every live rank bitwise equal (parameters and AdamW state) at "
             f"every committed step {result['compared']}; group 1 healed at "
             f"steps 2 and {result['heal_step']}"]
    for r, h in sorted(result["heals"].items()):
        lines.append(
            f"heal of group 1 rank {r} at step {result['heal_step']}: wall "
            f"{h['heal_wall_ms']:.1f} ms, wire {h['heal_bytes_per_s'] / 1e9:.3f}"
            f" GB/s, {int(h['heal_wire_bytes'])} wire bytes of a "
            f"{state_bytes} B state, upload p50 {h['heal_h2d_p50_ms']} ms "
            f"({card})")
    lines.append("bytes served in that heal by group 0's ranks: "
                 + ", ".join(f"rank {r} {int(b)}"
                             for r, b in sorted(result["served"].items())))
    for (g, r), run in sorted(result["runs"].items()):
        times = ", ".join(f"{s}: {t:.2f}"
                          for s, t in sorted(run.step_seconds.items()))
        lines.append(f"group {g} rank {r}: phase p50 ms "
                     f"{_p50s(run.metrics, MOE_PHASES)}; committed steps (s) "
                     f"{{{times}}} ({card})")
    lines.append(f"drill {result['seconds']:.1f} s, {result['passes']} "
                 f"forward/backward passes ({n_params} parameters; {card})")
    return lines


def phase_train_moe(seed: int, card: str, batch: int = 8):
    """The MoE drill (module docstring, phase 13): returns the passes and
    the layers."""
    import torch

    from torchft_tpu_torch.examples.train_moe import run_moe_drill
    from torchft_tpu_torch.models import (
        MOE_CONFIGS,
        MoETransformer,
        count_params,
    )

    t0 = time.perf_counter()
    cfg = MOE_CONFIGS["moe-8x125m"]
    n_params = count_params(MoETransformer(cfg, device="meta"))
    need_host = moe_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_moe")
    need = moe_device_bytes(n_params, moe_activation_bytes(cfg, batch))
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_moe needs {need / 1e9:.2f} GB of device "
                             f"memory free, has {free / 1e9:.2f} GB")
    log(f"  moe-8x125m: {n_params} parameters, {cfg.num_experts} experts "
        f"(capacity factor {cfg.capacity_factor}) on every "
        f"{cfg.moe_every}nd layer of {cfg.n_layers}, remat {cfg.remat}, "
        f"batch {batch} x {cfg.max_seq_len}; 2 groups x {MOE_RANKS} ranks "
        f"over TCP at codec none; device memory: up to {need / 1e9:.2f} GB, "
        f"{free / 1e9:.1f} GB free; host memory: up to "
        f"{need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available")
    torch.cuda.reset_peak_memory_stats()
    result = run_moe_drill(cfg, ranks=MOE_RANKS, device="cuda",
                           batch_size=batch, seed=seed, timeout=300.0,
                           log=lambda m: log("  " + m), **MOE_SCHEDULE)
    # the heal moves the parameters and AdamW's moments and step counts
    state_bytes = 12 * n_params + 4 * len(list(
        MoETransformer(cfg, device="meta").parameters()))
    for line in moe_report(result, n_params, state_bytes, card):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    passes = result["passes"]
    del result
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return passes, cfg.n_layers


# train_sharded: the reference example's two remaining arms, DDP's
# streamed pipeline against its lock-step arm and SHARDED=1
SHARDED_GROUPS = 3
# the drill: (kill_step, steps_alone, steps_after, kill_group)
SHARDED_SCHEDULE = (3, 1, 2, 0)
SHARDED_AB_STEPS = 3
SHARDED_PHASES = ("quorum", "forward_backward", "opt_update", "reshard",
                  "commit_barrier")
DDP_STAGES = ("ddp_d2h", "ddp_ef", "ddp_wire", "ddp_h2d", "ddp_wire_total",
              "ddp_wire_exposed")


def sharded_device_bytes(n_params: int, act: int,
                         groups: int = SHARDED_GROUPS) -> int:
    """Device memory the sharded drill may hold at once: per group the f32
    parameters and gradients (8 bytes a parameter) and, at the smallest
    wire (groups - 1), its optimizer shard (two moments) and the staged
    update of it (parameters and both moments): 20 bytes over the wire's
    size; and every group's activations."""
    return groups * ((8 + 20 // max(1, groups - 1)) * n_params + act)


def sharded_expected_launches(buckets: int, steps: int = SHARDED_AB_STEPS,
                              wire_steps: int = SHARDED_AB_STEPS) -> dict:
    """Each codec kernel's launches in train_sharded: the A/B arms (two
    runs of ``steps`` steps of two groups, each step an allreduce of every
    DDP bucket: 2 launches per kernel per bucket), then the card plane's
    sharded arm, whose reduce_scatter of the two owned shard buckets is the
    native scatter, one launch per kernel per step with a peer."""
    return {"ab": 2 * 2 * buckets * steps, "sharded": wire_steps}


def _digests_equal(runs, steps) -> bool:
    return all(len({r.param_digests.get(s) for r in runs}) == 1
               and runs[0].param_digests.get(s) is not None for s in steps)


def sharded_report(result: dict, replicated_bytes: int, card: str) -> list:
    """The lines train_sharded prints about the drill: per group and life
    the optimizer bytes held against the replicated bytes, the reshards
    (new world, moved and lower-bound bytes, reinitialized leaves, ms),
    the heal's optimizer bytes and its plan, and the phase p50s."""
    lines = []
    for g, lives in sorted(result["lives"].items()):
        for life, run in enumerate(lives):
            m = run.metrics
            resh = [(e["new_world"], e["wire_bytes"], e["lower_bound_bytes"],
                     e["reinit_leaves"]) for e in run.events
                    if e["kind"] == "reshard"]
            heal = [(e["moved_bytes"], e["lower_bound_bytes"])
                    for e in run.events if e["kind"] == "redist_plan"
                    and e["source"] == "opt_shard_heal"]
            lines.append(
                f"g{g} life {life}: optimizer state held "
                f"{int(m.get('opt_state_bytes', 0))} B of "
                f"{replicated_bytes} replicated; reshards (new world, moved, "
                f"lower bound, reinit leaves) {resh}; reshard p50 "
                f"{m.get('reshard_p50_ms', 0):.1f} ms; heal_opt_bytes "
                f"{int(m.get('heal_opt_bytes', 0))}, heal plan (moved, "
                f"lower bound) {heal}; phase p50 ms "
                f"{_p50s(m, SHARDED_PHASES)} ({card})")
    return lines


def check_sharded_drill(result: dict, replicated: dict) -> None:
    """The drill's own checks beyond bitwise equality of the live groups
    (``run_kill_and_heal``): every reshard and the heal moved exactly their
    lower bound, the shrink reinitialized the killed group's states, and
    steps 1-3 equal the replicated arm's bitwise."""
    for g, lives in result["lives"].items():
        for run in lives:
            for e in run.events:
                if e["kind"] == "reshard" and \
                        e["wire_bytes"] != e["lower_bound_bytes"]:
                    raise AssertionError(f"g{g}: a reshard moved "
                                         f"{e['wire_bytes']} bytes, lower "
                                         f"bound {e['lower_bound_bytes']}")
                if e["kind"] == "redist_plan" and \
                        e["moved_bytes"] != e["lower_bound_bytes"]:
                    raise AssertionError(f"g{g}: a {e['source']} plan moved "
                                         f"{e['moved_bytes']} bytes, lower "
                                         f"bound {e['lower_bound_bytes']}")
    kill_step, alone, _, kill_group = SHARDED_SCHEDULE
    healed = result["lives"][kill_group][-1]
    heals = [e for e in healed.events if e["kind"] == "redist_plan"
             and e["source"] == "opt_shard_heal"]
    if not heals or heals[0]["moved_bytes"] <= 0:
        raise AssertionError("the restarted group never fetched its "
                             "optimizer shard with fetch_opt_shard")
    survivor = result["lives"][(kill_group + 1) % SHARDED_GROUPS][0]
    shrink = [e for e in survivor.events if e["kind"] == "reshard"
              and e["new_world"] == SHARDED_GROUPS - 1]
    if not shrink:
        raise AssertionError("no reshard onto the shrunken wire")
    grow = [e for e in survivor.events if e["kind"] == "reshard"
            and e["new_world"] == SHARDED_GROUPS and e["old_world"]]
    if not grow:
        raise AssertionError("no reshard back onto the grown wire")
    reinit = sum(e["reinit_leaves"] for g, lives in result["lives"].items()
                 for run in lives for e in run.events
                 if e["kind"] == "reshard"
                 and e["new_world"] == SHARDED_GROUPS - 1)
    if reinit <= 0:
        raise AssertionError("the shrink reported no reinitialized leaves")
    steps = range(1, kill_step + 1)
    mine = survivor.param_digests
    theirs = replicated[0].param_digests
    same = [s for s in steps if mine.get(s) == theirs.get(s) is not None]
    if same != list(steps):
        raise AssertionError(f"the sharded arm equals the replicated arm "
                             f"bitwise at steps {same} of {list(steps)}")


def phase_train_sharded(seed: int, card: str, batch: int = 8):
    """The reference example's two remaining arms (module docstring, phase
    5): returns the flash launches, each codec kernel's launches, and the
    runs."""
    import torch

    from torchft_tpu_torch.examples.train_ddp import (
        run_joint,
        run_kill_and_heal,
    )
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    act = gpt_activation_bytes(cfg, batch)
    need = sharded_device_bytes(n_params, act)
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    held = torch.cuda.memory_allocated()
    log(f"  125m: {n_params} parameters, batch {batch}; device memory: up "
        f"to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB free ({held / 1e9:.2f}"
        f" GB held by earlier phases)")
    if free < need:
        raise AssertionError(f"train_sharded needs {need / 1e9:.2f} GB of "
                             f"device memory free, has {free / 1e9:.2f} GB")
    passes = 0
    # (b) SHARDED=1: three groups over TCP at codec none, g0 killed after
    # step 3, the survivors shrink, g0 heals at 5, the three grow back
    kill_step, alone, after, kill_group = SHARDED_SCHEDULE
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    drill = run_kill_and_heal(
        cfg, kill_step=kill_step, steps_alone=alone, steps_after=after,
        groups=SHARDED_GROUPS, kill_group=kill_group, device="cuda",
        batch_size=batch, seed=seed, timeout=300.0, sharded=True,
        digest_params=True, log=lambda m: log("  " + m))
    drill_s = time.perf_counter() - t1
    passes += drill["passes"]
    t1 = time.perf_counter()
    replicated = run_joint(cfg, groups=SHARDED_GROUPS, steps=kill_step,
                           device="cuda", batch_size=batch, seed=seed,
                           timeout=300.0, sharded=False, digest_params=True)
    replicated_s = time.perf_counter() - t1
    passes += sum(r.passes for r in replicated.values())
    rep_bytes = int(replicated[0].metrics.get("opt_state_bytes", 0))
    check_sharded_drill(drill, replicated)
    log(f"  (b) SHARDED=1 drill {drill_s:.1f} s: heal at step "
        f"{drill['heal_step']}, live groups bitwise equal at every committed "
        f"step, steps 1-{kill_step} bitwise equal to the replicated arm "
        f"(its run {replicated_s:.1f} s); device memory peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
        f"(reckoned {need / 1e9:.2f} GB) ({card})")
    for line in sharded_report(drill, rep_bytes, card):
        log("  " + line)
    for g, run in sorted(drill["runs"].items()):
        times = ", ".join(f"{s}: {t * 1e3:.1f}"
                          for s, t in sorted(run.step_seconds.items()))
        log(f"  g{g} step ms {{{times}}}")
    del drill, replicated
    gc.collect()
    torch.cuda.empty_cache()
    # (a) DDP's streamed pipeline against its lock-step arm on the card's
    # int8 plane with error feedback: the same seeds and batches
    arms = {}
    for streamed in (True, False):
        t1 = time.perf_counter()
        arms[streamed] = run_joint(
            cfg, groups=2, steps=SHARDED_AB_STEPS, device="cuda",
            batch_size=batch, seed=seed, timeout=300.0, streamed=streamed,
            comm_backend="cuda", comm_options=INT8_OPTIONS,
            digest_averages=True)
        passes += sum(r.passes for r in arms[streamed].values())
        for g, run in sorted(arms[streamed].items()):
            steps_ms = [round(t * 1e3, 1)
                        for _, t in sorted(run.step_seconds.items())]
            log(f"  (a) {'streamed' if streamed else 'lock-step'} g{g}: "
                f"{time.perf_counter() - t1:.1f} s, step ms {steps_ms} "
                f"(digests included); p50 ms "
                f"{_p50s(run.metrics, DDP_STAGES)} ({card})")
    for g in (0, 1):
        a, b = arms[True][g].average_digests, arms[False][g].average_digests
        steps = list(range(1, SHARDED_AB_STEPS + 1))
        if [s for s in steps if a.get(s) == b.get(s) is not None] != steps:
            raise AssertionError(f"g{g}: streamed and lock-step averages or "
                                 f"residuals differ ({a} vs {b})")
    buckets = len(arms[True][0].buckets)
    log(f"  (a) streamed == lock-step bitwise, averaged gradients and EF "
        f"residuals, after each of {SHARDED_AB_STEPS} steps, both groups "
        f"({buckets} buckets)")
    del arms
    gc.collect()
    # (c) the sharded arm on the card's int8 plane
    t1 = time.perf_counter()
    card_runs = run_joint(cfg, groups=2, steps=SHARDED_AB_STEPS,
                          device="cuda", batch_size=batch, seed=seed,
                          timeout=300.0, sharded=True, comm_backend="cuda",
                          comm_options=INT8_OPTIONS, digest_params=True)
    passes += sum(r.passes for r in card_runs.values())
    runs = list(card_runs.values())
    if not _digests_equal(runs, range(1, SHARDED_AB_STEPS + 1)):
        raise AssertionError("(c): the two groups' parameters differ")
    wire_steps = runs[0].wire_steps
    log(f"  (c) sharded on the int8 card plane {time.perf_counter() - t1:.1f}"
        f" s: both groups bitwise equal after each of {SHARDED_AB_STEPS} "
        f"steps; {len(runs[0].buckets)} shard buckets, {wire_steps} steps "
        f"with a peer; p50 ms {_p50s(runs[0].metrics, SHARDED_PHASES)} "
        f"({card})")
    del card_runs, runs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s; device memory held "
        f"after it {torch.cuda.memory_allocated() / 1e9:.2f} GB ({card})")
    codec = sharded_expected_launches(buckets, wire_steps=wire_steps)
    return passes * cfg.n_layers, codec["ab"] + codec["sharded"]


# train_hier_int8: four groups in two domains over the hierarchical TCP
# wire, int8 across domains, error feedback on the compensable egress
HIER_DOMAINS = {"rack0": [0, 1], "rack1": [2, 3]}
HIER_OPTIONS = {"algorithm": "star", "compression": "int8",
                "topology": "hier", "channels": 4, "chunk_bytes": CHUNK_BYTES}
# (kill_step, steps_alone, steps_after, kill_group, record_step): steps 1-3
# joint, group 2 (rack1's egress) killed, 4-5 with rack1 = {g3}, the heal
# at 6, 7-8 joint; step 2's bucket ops recorded
HIER_SCHEDULE = (3, 2, 2, 2, 2)
# the codec kernels a hier op launches per bucket on the card plane:
# star: the encode/decode of the non-root domain sums and the root's
# re-encode; psum: one encode of the egress rows, one decode-accumulate
HIER_LAUNCHES = {"star": 2, "psum": 1}
# the card plane's psum arm against the f64 sum: one quantization of each
# domain's sum (tests/test_hier_topology.py's envelope)
HIER_PSUM_TOL = 3 / 100
# the device train_hier_int8 trains on and runs the card plane's arms on
# (the CPU tests move it)
HIER_DEVICE = "cuda"


def hier_host_bytes(n_params: int, groups: int = 4) -> int:
    """Host memory train_hier_int8 may hold at once, in f32 copies of the
    parameters: per group the pinned staging, the error-feedback residual,
    the broadcast's landing and wire scratch (4); the recorded step's
    inputs and outputs of every group (8); the heal's staged state on both
    ends (6); the host oracle's domain sums and result (4)."""
    return (groups * 4 + 18) * 4 * n_params


def _hier_roles(step: int, group: int) -> "tuple[int, bool]":
    """(members of the group's domain, is its egress) at a step of the
    drill's schedule."""
    k, s_alone, _, killed, _ = HIER_SCHEDULE
    domain = next(d for d, gs in HIER_DOMAINS.items() if group in gs)
    alive = [g for g in HIER_DOMAINS[domain]
             if not (g == killed and k < step <= k + s_alone)]
    return len(alive), group == min(alive)


def check_hier_drill(result: dict, cfg, card: str) -> list:
    """The drill's checks, raising on any miss, and its report lines: the
    groups bitwise equal at every committed step, each life's tier
    counters against the schedule (``comm_inter_bytes`` only on egress
    steps, equal to ``codec_wire_nbytes`` of the contribution;
    ``comm_intra_bytes`` zero in a singleton domain; ``comm_hops`` 4 per op
    in a two-member domain and 2 in a singleton), error feedback on the
    compensable roles only, and the recorded step against the port's
    ``_host_hier_allreduce``."""
    import numpy as np

    from torchft_tpu_torch.comm.cuda_backend import _host_hier_allreduce
    from torchft_tpu_torch.comm.transport import (
        codec_wire_nbytes,
        make_wire_codec,
    )

    k, s_alone, after, killed, record_step = HIER_SCHEDULE
    total = k + s_alone + 1 + after
    want = {s: (3 if k < s <= k + s_alone else 4)
            for s in range(1, total + 1)}
    if result["compared"] != want:
        raise AssertionError(f"groups bitwise equal per step "
                             f"{result['compared']}, the schedule has {want}")
    lines = [f"  groups bitwise equal at every committed step "
             f"{result['compared']}; group {killed} healed at step "
             f"{result['heal_step']}, bitwise equal to its donor from then"]
    codec = make_wire_codec("int8")
    buckets = result["runs"][0].buckets
    raw_step = float(sum(4 * b for b in buckets))
    enc_step = float(sum(codec_wire_nbytes(codec, CHUNK_BYTES,
                                           np.zeros(b, np.float32))
                         for b in buckets))
    for g, lives in sorted(result["lives"].items()):
        for life, run in enumerate(lives):
            steps = sorted(run.participants)
            if run.wire_steps != len(steps):
                raise AssertionError(f"group {g} life {life}: "
                                     f"{run.wire_steps} wire steps of "
                                     f"{len(steps)} committed")
            roles = [_hier_roles(s, g) for s in steps]
            want_ctr = {
                "comm_intra_bytes": sum(raw_step for m, _ in roles if m > 1),
                "comm_inter_bytes": sum(enc_step for _, e in roles if e),
                "comm_hops": sum(len(buckets) * (2.0 * (m > 1) + 2.0)
                                 for m, _ in roles),
            }
            got = {c: run.metrics.get(c, 0.0) for c in want_ctr}
            if got != want_ctr:
                raise AssertionError(f"group {g} life {life} tier counters "
                                     f"{got}, the schedule gives {want_ctr}")
            # compensable: an egress outside domain 0 (the inter root),
            # in a step it contributes real gradients (not its heal step)
            healing = set(run.healed_at)
            ef = any(e and g not in HIER_DOMAINS["rack0"]
                     for s, (_, e) in zip(steps, roles) if s not in healing)
            if ("ddp_ef_p50_ms" in run.metrics) != ef:
                raise AssertionError(f"group {g} life {life}: ddp_ef "
                                     f"{'missing' if ef else 'present'}")
            lines.append(
                f"  group {g} life {life}: steps {steps[0]}-{steps[-1]}, "
                f"comm_intra_bytes {got['comm_intra_bytes']:.0f}, "
                f"comm_inter_bytes {got['comm_inter_bytes']:.0f} "
                f"({got['comm_inter_bytes'] / max(1.0, raw_step * len(steps)):.3f}"
                f" of raw), comm_hops {got['comm_hops']:.0f} "
                f"({got['comm_hops'] / (len(buckets) * len(steps)):.2f} per "
                f"op), error feedback {'on' if ef else 'off'} ({card})")
    recorded = {g: lives[0].recorded for g, lives in result["lives"].items()}
    groups = tuple(tuple(gs) for _, gs in sorted(HIER_DOMAINS.items()))
    ops = sorted(recorded[0])
    if len(ops) != len(buckets) or any(sorted(r) != ops
                                       for r in recorded.values()):
        raise AssertionError(f"recorded ops {[sorted(r) for r in recorded.values()]}"
                             f", want {len(buckets)} per group")
    for op in ops:
        want_out = _host_hier_allreduce(
            [[a.copy() for a in recorded[g][op][0]] for g in sorted(recorded)],
            "int8", CHUNK_BYTES, "sum", groups, len(recorded))
        for g in sorted(recorded):
            for got_a, w in zip(recorded[g][op][1], want_out):
                if got_a.tobytes() != w.tobytes():
                    raise AssertionError(
                        f"step {record_step} bucket op {op}: group {g} "
                        "differs from _host_hier_allreduce")
    lines.append(f"  step {record_step}: {len(ops)} bucket ops of every "
                 f"group bitwise equal to _host_hier_allreduce of the "
                 f"recorded contributions ({card})")
    return lines


def check_hier_planes(sizes, seed: int, card: str) -> "tuple[list, int]":
    """The card plane's hier arms against the TCP hier path at each
    distinct bucket size, in the drill's 2x2 layout: ``CudaCommContext(
    topology="hier", compression="int8")`` with algorithm "star" bitwise
    equal to four TCP hier contexts and to the same plane on
    ``DevicePool("cpu")``; with "psum", identical on every rank and within
    ``HIER_PSUM_TOL * absmax`` of the f64 sum. Returns the report lines and
    the launches of each codec kernel the card arms make."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.topology import DomainTopology
    from torchft_tpu_torch.comm.transport import TcpCommContext

    world = 4
    smap = {d: [f"rank{g}" for g in gs] for d, gs in HIER_DOMAINS.items()}
    opts = {k: v for k, v in HIER_OPTIONS.items()
            if k not in ("algorithm", "channels")}
    pools = {"card": DevicePool(HIER_DEVICE), "cpu": DevicePool("cpu")}
    rng = np.random.default_rng(seed)
    lines = []
    launches = 0

    def cohort(make, tag, grads):
        ctxs = [make() for _ in range(world)]

        def worker(r):
            ctxs[r].configure(tag, r, world)
            w = ctxs[r].allreduce([grads[r].copy()], ReduceOp.SUM)
            return w.future().result(timeout=300)[0]

        try:
            with ThreadPoolExecutor(world) as ex:
                return [f.result(600) for f in
                        [ex.submit(worker, r) for r in range(world)]]
        finally:
            for c in ctxs:
                c.shutdown()

    store = StoreServer()
    try:
        for size in sorted(set(sizes)):
            grads = [(rng.standard_normal(size) * 1e-3 * (r + 1))
                     .astype(np.float32) for r in range(world)]
            out = {"tcp": cohort(lambda: TcpCommContext(
                timeout=300.0, channels=HIER_OPTIONS["channels"],
                algorithm="star", domain_resolver=DomainTopology(
                    static_map=smap), **opts),
                f"{store.addr}/hier{size}", grads)}
            for name, pool in pools.items():
                for algo in ("star", "psum"):
                    out[f"{name}/{algo}"] = cohort(
                        lambda: CudaCommContext(
                            timeout=300.0, algorithm=algo, device_pool=pool,
                            domain_resolver=DomainTopology(static_map=smap),
                            **opts),
                        f"smoke://hier{size}/{name}/{algo}", grads)
            launches += sum(HIER_LAUNCHES.values())
            star = all(a.tobytes() == b.tobytes() == c.tobytes()
                       for a, b, c in zip(out["card/star"], out["tcp"],
                                          out["cpu/star"]))
            psum = out["card/psum"]
            exact = np.sum(grads, axis=0, dtype=np.float64)
            absmax = float(max(np.abs(g).max() for g in grads))
            err = float(np.abs(psum[0].astype(np.float64) - exact).max())
            same = len({p.tobytes() for p in psum}) == 1
            ok_psum = same and err <= HIER_PSUM_TOL * absmax
            lines.append(
                f"  bucket of {size} f32: card hier star vs TCP hier and "
                f"CPU plane bitwise {'ok' if star else 'FAIL'}; card hier "
                f"psum identical on every rank {same}, max |err| "
                f"{err:.3e} <= {HIER_PSUM_TOL} x absmax {absmax:.3e}: "
                f"{'ok' if ok_psum else 'FAIL'} ({card})")
            if not (star and ok_psum):
                raise AssertionError("\n".join(lines))
    finally:
        store.shutdown()
    return lines, launches


def phase_train_hier_int8(seed: int, card: str, batch: int = 8):
    """The hierarchical drill (module docstring, phase 11): returns the
    flash kernels' launches, the codec kernels' launches and the result."""
    from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    need = hier_host_bytes(n_params)
    free = check_host_memory(need, what="train_hier_int8")
    log(f"  125m: {n_params} parameters, batch {batch}, 4 groups in "
        f"domains {HIER_DOMAINS} over TCP {HIER_OPTIONS}; host memory: up "
        f"to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB available")
    k, s_alone, after, killed, record_step = HIER_SCHEDULE
    t0 = time.perf_counter()
    result = run_kill_and_heal(
        cfg, kill_step=k, steps_alone=s_alone, steps_after=after, groups=4,
        kill_group=killed, domains=HIER_DOMAINS, record_step=record_step,
        device=HIER_DEVICE, batch_size=batch, seed=seed, timeout=300.0,
        log=lambda m: log("  " + m), comm_backend="host",
        comm_options=HIER_OPTIONS)
    log(f"  drill {time.perf_counter() - t0:.1f} s ({card})")
    for line in check_hier_drill(result, cfg, card):
        log(line)
    lives = result["lives"]
    phases = ("quorum", "forward_backward", "ddp_d2h", "ddp_ef", "ddp_wire",
              "ddp_h2d", "commit_barrier", "comm_op_wire")
    for g, runs in sorted(lives.items()):
        for life, run in enumerate(runs):
            log(f"  group {g} life {life} phase p50 ms "
                f"{_p50s(run.metrics, phases)} ({card})")
    healed = lives[killed][-1].metrics
    log(f"  heal of group {killed}: wall {healed.get('heal_wall_ms', 0):.1f} "
        f"ms, wire {healed.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s "
        f"({card})")
    runs = result["runs"]
    tokens = batch * cfg.max_seq_len
    rates = {s: round(tokens * len(runs) / max(r.step_seconds[s]
                                               for r in runs.values()))
             for s in result["checked_steps"][1:]}
    log(f"  committed tokens/s, 4 groups sharing the card, joint steps "
        f"after the heal: {rates} ({card})")
    lines, per_kernel = check_hier_planes(runs[0].buckets, seed, card)
    for line in lines:
        log(line)
    log(f"  {len(set(runs[0].buckets))} distinct bucket sizes x (star "
        f"{HIER_LAUNCHES['star']} + psum {HIER_LAUNCHES['psum']}) = "
        f"{per_kernel} of each codec kernel; forward/backward passes: "
        f"{result['passes']}")
    return result["passes"] * cfg.n_layers, per_kernel, result


def _check_launches(counts, want, what: str) -> None:
    log(f"  kernel launches on the main path: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"kernel launches on the main path {counts}, "
                             f"want {want} ({what})")


PHASES = ("kernels", "train", "train_multijob", "train_sharded",
          "train_moe", "train_cuda_int8",
          "train_tiny", "gpt_1b", "train_diloco", "train_diloco_sharded",
          "train_localsgd_int8", "train_hier_int8", "train_durable")


def _add_launches(rows: dict, counts: dict, head_dim: int) -> None:
    """Add a main-path phase's launches to the kernels rows: a flash
    kernel's to its row and to its ``head_dim`` instantiation's."""
    for name, c in counts.items():
        if name not in rows:
            continue
        rows[name]["launches"] += c
        for row in rows[name].get("per_head_dim", ()):
            if row["head_dim"] == head_dim:
                row["launches"] += c


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma list of " + ",".join(PHASES) +
                             " (device always runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3,
                        help="committed steps before and after the heal")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the 125m depth of the TCP drill (train) "
                             "to this many layers")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torchft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    # f32 products stay f32 (the reference's f32 lm-head and loss)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    smi, ptxas = phase_device()
    from torchft_tpu_torch.models import CONFIGS, MOE_CONFIGS
    from torchft_tpu_torch.ops import flash, quant

    rows = {}
    if "kernels" in phases:
        log("phase kernels")
        rows = phase_kernels(args.seed, ptxas)
        rows.update(phase_quant_kernels(args.seed))
        for name in ("quant_int8", "dequant_acc_int8"):
            rows[name]["ptxas"] = ptxas.get(name)
    if "train" in phases:
        log("phase train")
        flash.reset_launch_counts()
        want, _ = phase_train("125m", args.steps, args.layers, args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per forward/backward pass")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_multijob" in phases:
        log("phase train_multijob")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        per_d, _ = phase_train_multijob(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        want = {n: sum(c[n] for c in per_d.values()) for n in flash.LAUNCHES}
        _check_launches(counts, {**want, **dict.fromkeys(quant.LAUNCHES, 0)},
                        "flash: one per layer per pass, the observer's "
                        "forward-only passes and the captures' warm-up "
                        "passes included; codec: none")
        for head_dim, c in per_d.items():
            _add_launches(rows, c, head_dim)
    if "train_sharded" in phases:
        log("phase train_sharded")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, codec = phase_train_sharded(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: codec for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: 2 per DDP "
                        "bucket per allreduce in the A/B arms, 1 per "
                        "sharded reduce_scatter")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_moe" in phases:
        log("phase train_moe")
        flash.reset_launch_counts()
        passes, layers = phase_train_moe(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {"flash_fwd": 2 * passes * layers,
                                 "flash_bwd_dq": passes * layers,
                                 "flash_bwd_dkv": passes * layers},
                        "remat: per layer per pass 2 forward (the "
                        "recompute), 1 dQ, 1 dK/dV")
        _add_launches(rows, counts, MOE_CONFIGS["moe-8x125m"].head_dim)
    if "train_cuda_int8" in phases:
        log("phase train_cuda_int8")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, result = phase_train("125m", args.steps, None, args.seed, smi,
                                   comm_backend="cuda",
                                   comm_options=INT8_OPTIONS)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        # the fixed schedule has a peer on the wire in k + 1 + a steps
        # (all but the survivor's solo step); each of those reduces every
        # frozen DDP bucket once, with 2 launches of each codec kernel
        survivor = result["runs"][0]
        wire_steps = args.steps + 1 + (args.steps - 1)
        if survivor.wire_steps != wire_steps:
            raise AssertionError(f"{survivor.wire_steps} steps with a wire "
                                 f"peer, the schedule has {wire_steps}")
        per_kernel = 2 * len(survivor.buckets) * wire_steps
        log(f"  {len(survivor.buckets)} gradient buckets x {wire_steps} steps "
            f"with a peer x 2 launches = {per_kernel} of each codec kernel")
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: per_kernel for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: 2 per bucket "
                        "per allreduce with a peer")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
        check_plane_at_buckets(survivor.buckets, args.seed)
    if "train_tiny" in phases:
        log("phase train_tiny")
        flash.reset_launch_counts()
        want, _ = phase_train("tiny", args.steps, None, args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per forward/backward pass")
        _add_launches(rows, counts, CONFIGS["tiny"].head_dim)
    if "gpt_1b" in phases:
        log("phase gpt_1b")
        flash.reset_launch_counts()
        counts, layers = phase_gpt_1b(args.seed)
        # activation checkpointing runs each block's forward again in the
        # backward: two forward launches per layer, one of each backward
        _check_launches(counts, {"flash_fwd": 2 * layers,
                                 "flash_bwd_dq": layers,
                                 "flash_bwd_dkv": layers},
                        "1b, remat: 2 forward, 1 dQ, 1 dK/dV per layer")
        _add_launches(rows, counts, CONFIGS["1b"].head_dim)
    if "train_diloco" in phases:
        log("phase train_diloco")
        flash.reset_launch_counts()
        want, _ = phase_train_diloco(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per pass, graph replays and capture "
                        "warm-ups included")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_diloco_sharded" in phases:
        log("phase train_diloco_sharded")
        check_comm_child(smi)
        flash.reset_launch_counts()
        want, _ = phase_train_diloco_sharded(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per pass of both arms, graph replays "
                        "and capture warm-ups included")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_localsgd_int8" in phases:
        log("phase train_localsgd_int8")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, codec, _ = phase_train_localsgd_int8(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: codec for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: 2 per "
                        "fragment op with a peer")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_hier_int8" in phases:
        log("phase train_hier_int8")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, codec, _ = phase_train_hier_int8(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: codec for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: the card "
                        "plane's hier arms at each distinct bucket size")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_durable" in phases:
        log("phase train_durable")
        flash.reset_launch_counts()
        want, _ = phase_train_durable(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per pass, graph replays included")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
        fused_vs_classic(args.seed, smi)
    if rows:
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
