"""The pure helpers of chip_smoke.py, the port's smoke test on the card.

The script itself needs a GPU: here it must refuse to run (exit 2, no
result line), and its helpers must read a ptxas report (registers and
spills per kernel and per head_dim instantiation, the spill gate on the
Hopper-redesigned kernels, the gate on wgmma serialization notes), size
the int8 drill's DDP buckets, reach every head_dim the flash kernels take,
add each phase's launches to the right rows, and price the flash kernels'
bounds and the codec kernels' per wire step. For ``train_durable``: the
disk it needs at 125m, the failure when the disk is short, and the report
it prints, read off a run of the same drill at "tiny" on the CPU. For
``train_diloco`` and ``train_localsgd_int8``: the host memory the second
needs at 125m, the failure when it is short, and both phases whole, run
at "tiny" on the CPU (their drills' schedules, reports and the CPU plane
check). For ``train_diloco_sharded``: its memory at 125m, and the phase
whole at "tiny" on the CPU (both drills, the five schedule checks, which
must also reject a broken coverage or grow). For ``train_hier_int8``:
the host memory it needs at 125m, the roles of its schedule, the phase
whole at "tiny" on the CPU (the card plane's arms on a CPU pool), and its
checks failing a drill whose counter or recorded step is wrong. For
``train_pp``: its memory and launches at 125m, the phase whole at "tiny"
(depth 8) on the CPU, and the schedule pass failing a wrong 1F1B runner;
for ``pipeline_plane``: every arm at the card's stage and replica counts
with narrow layers on the CPU. For ``serve_deploy``: the phase whole at
"tiny" on the CPU (every oracle of the drill, the report, the launches it
wants), and its oracles failing a cohort that moves a stale shard. For
``train_churn``: its memory and launches at 125m, and the phase whole at
"tiny" on the CPU (both arms, their oracles, the report, the launches it
wants).
"""

import dataclasses
import importlib.util
import math
import os
import subprocess
import sys
import types

import pytest
import torch

from torchft_tpu_torch.models import CONFIGS, GPT
from torchft_tpu_torch.ops import flash

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(symbol, regs, spill=0):
    return (f"ptxas info    : Compiling entry function '{symbol}' for "
            f"'sm_90a'\nptxas info    : Function properties for {symbol}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
            f"bytes spill loads\nptxas info    : Used {regs} registers, used "
            f"1 barriers\n")


_FLASH_SYMBOLS = {
    "flash_fwd": "_ZN3tft16flash_fwd_kernelILi{d}EEEv14CUtensorMap_stS1_S1_"
                 "P13__nv_bfloat16Pfiifi",
    "flash_bwd_dq": "_ZN3tft19flash_bwd_dq_kernelILi{d}EEEv14CUtensorMap_st"
                    "S1_S1_S1_PKfS3_P13__nv_bfloat16iiffi",
    "flash_bwd_dkv": "_ZN3tft20flash_bwd_dkv_kernelILi{d}EEEv14CUtensorMap_"
                     "stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiffi",
}
_REGS = {"flash_fwd": 128, "flash_bwd_dq": 154, "flash_bwd_dkv": 168}
_LOG = "\n".join(
    [f"== {name}.cu\n" + "".join(
        _entry(sym.format(d=d), _REGS[name] + (40 if d == 128 else 0))
        for d in (16, 32, 64, 128))
     for name, sym in _FLASH_SYMBOLS.items()] + [
        "ptxas info    : (C7515) Potential Performance Loss: "
        "wgmma.mma_async instructions are serialized",
        "== quant_int8.cu",
        _entry("_ZN3tft23dequant_acc_int8_kernelEPKaxPKfxPfixxxxxixx", 40,
               spill=8),
        _entry("_ZN3tft17quant_int8_kernelEPKfxPaxPfxxxx", 56),
    ])


def test_ptxas_report_reads_every_kernel() -> None:
    """One entry per instantiation of the templated flash kernels (key
    ``<kernel>/d<head_dim>``), one per codec kernel."""
    report, notes = _smoke().ptxas_report(_LOG)
    want = {f"{name}/d{d}": {"registers": _REGS[name] + (40 if d == 128
                                                         else 0),
                             "spill_stores": 0, "spill_loads": 0}
            for name in _FLASH_SYMBOLS for d in (16, 32, 64, 128)}
    want["dequant_acc_int8"] = {"registers": 40, "spill_stores": 8,
                                "spill_loads": 8}
    want["quant_int8"] = {"registers": 56, "spill_stores": 0,
                          "spill_loads": 0}
    assert report == want
    assert len(notes) == 1 and "serialized" in notes[0]
    # a kernel built without the template (an earlier tree) keeps its name
    old = _entry("_ZN3tft16flash_fwd_kernelE14CUtensorMap_stS0_S0_P13__nv_"
                 "bfloat16Pfiifi", 128)
    assert _smoke().ptxas_report(old)[0] == {
        "flash_fwd": {"registers": 128, "spill_stores": 0, "spill_loads": 0}}


@pytest.mark.parametrize("case, want", [
    ("clean", []),
    ("fwd_spills", ["flash_fwd/d16"]),
    ("dkv_missing", ["flash_bwd_dkv/d128"]),
    ("dq_spills", ["flash_bwd_dq/d32"]),
    ("quant_spills", ["quant_int8"]),
    ("codec_spills", ["dequant_acc_int8"]),  # redesigned: held too
])
def test_spill_gate(case, want) -> None:
    smoke = _smoke()
    report, _ = smoke.ptxas_report(_LOG)  # the dequantizer spills 8 bytes
    if case != "codec_spills":
        report["dequant_acc_int8"].update(spill_stores=0, spill_loads=0)
    if case == "fwd_spills":
        report["flash_fwd/d16"]["spill_loads"] = 4
    elif case == "dkv_missing":
        del report["flash_bwd_dkv/d128"]
    elif case == "dq_spills":
        report["flash_bwd_dq/d32"]["spill_stores"] = 16
    elif case == "quant_spills":
        report["quant_int8"].update(spill_stores=4, spill_loads=4)
    assert smoke.spill_failures(report) == want


def test_serialization_gate() -> None:
    smoke = _smoke()
    _, notes = smoke.ptxas_report(_LOG)
    assert smoke.serialized_notes(notes) == notes  # the C7515 note
    clean = _LOG.replace("(C7515) Potential Performance Loss: wgmma.mma_async "
                         "instructions are serialized", "")
    _, notes = smoke.ptxas_report(clean)
    assert notes == [] and smoke.serialized_notes(notes) == []
    assert smoke.serialized_notes(["ptxas warning : Registers are spilled"]) \
        == []


def test_bucket_sizes_of_the_125m_drill() -> None:
    params = list(GPT(CONFIGS["125m"], device="meta").parameters())
    sizes = _smoke().bucket_sizes(params)
    assert len(sizes) == 15
    assert sorted(set(sizes)) == [787968, 4718592, 7080960, 8262144,
                                  25165824]
    assert sum(sizes) == sum(p.numel() for p in params) == 136091136


def test_flash_shapes_reach_every_head_dim() -> None:
    """The kernels phase checks every instantiation at the attention shape
    of the model that reaches it and times each at one shape; the models'
    own shapes are among them."""
    smoke = _smoke()
    assert smoke.HEAD_DIMS == flash.KERNEL_HEAD_DIMS
    shapes = smoke.FLASH_SHAPES
    assert sorted({shape[3] for _, shape, _ in shapes}) == \
        list(smoke.HEAD_DIMS)
    for d in smoke.HEAD_DIMS:
        assert sum(1 for _, shape, t in shapes if t and shape[3] == d) >= 1
    # the pipelined 125m's microbatch (2 sequences) is timed beside 125m's
    assert ("125m pipeline microbatch", (2, 1024, 12, 64), True) in shapes
    assert smoke.pp_attention_shape(CONFIGS["125m"]) == (2, 1024, 12, 64)
    for name in ("tiny", "125m", "1b"):
        cfg = CONFIGS[name]
        assert (name, (8 if name != "1b" else 1, cfg.max_seq_len,
                       cfg.n_heads, cfg.head_dim)) in \
            {(w, shape) for w, shape, _ in shapes}
    assert smoke.PHASES == ("kernels", "train", "train_multijob",
                            "train_sharded", "train_moe", "train_cuda_int8",
                            "train_tiny", "gpt_1b", "train_llama_ring",
                            "train_hsdp", "train_moe_expert", "train_pp",
                            "pipeline_plane", "fused_step", "train_resnet",
                            "serve_deploy", "train_diloco",
                            "train_diloco_sharded",
                            "train_localsgd_int8", "train_churn",
                            "train_hier_int8", "train_proc",
                            "dryrun_multichip", "train_durable")
    assert all(n in {k for k, v in GPT(CONFIGS["1b"], device="meta")
                     .named_parameters()} for n in smoke.GRAD_SAMPLE)


def test_launches_add_to_the_head_dim_of_the_phase() -> None:
    smoke = _smoke()
    rows = {"flash_fwd": {"launches": 0, "per_head_dim": [
        {"head_dim": d, "launches": 0} for d in smoke.HEAD_DIMS]},
        "quant_int8": {"launches": 0}}
    smoke._add_launches(rows, {"flash_fwd": 156}, 64)
    smoke._add_launches(rows, {"flash_fwd": 26, "flash_bwd_dq": 26}, 16)
    smoke._add_launches(rows, {"quant_int8": 180}, 64)
    assert rows["flash_fwd"]["launches"] == 182
    assert [r["launches"] for r in rows["flash_fwd"]["per_head_dim"]] == \
        [26, 0, 156, 0]
    assert rows["quant_int8"]["launches"] == 180


def test_attention_bounds_at_125m() -> None:
    bound = _smoke().attention_bound_ms
    fwd, by = bound(8, 1024, 12, 64, True, 2, 4, 1)
    assert by == "bytes" and fwd == pytest.approx(0.015142, rel=1e-4)
    dkv, by = bound(8, 1024, 12, 64, True, 4, 6, 2)
    assert by == "operations" and dkv == pytest.approx(0.026082, rel=1e-4)
    # dq: three products over the 524,800 causal pairs of 96 heads
    dq, by = bound(8, 1024, 12, 64, True, 3, 5, 2)
    assert by == "operations" and dq == pytest.approx(0.019561, rel=1e-4)


def test_codec_step_bounds_at_the_drill_buckets() -> None:
    """The codec kernels' bytes in one wire step of the int8 drill over its
    15 buckets (two groups): quant_int8 moves 5 B an element of the 2 x
    136,091,136 gradients and of the 2 x 68,045,568 reduced shards;
    dequant_acc_int8 6 B an element of the padded sums in phase 1, 5 B in
    phase 2; the scales add 4 B a chunk (a few KB)."""
    smoke = _smoke()
    params = list(GPT(CONFIGS["125m"], device="meta").parameters())
    sizes = smoke.bucket_sizes(params)
    bounds = smoke.codec_step_bound_ms(sizes)
    n = 136091136
    assert bounds["quant_int8"] == pytest.approx(
        (2 * n * 5 + n * 5) / 3.35e12 * 1e3, rel=1e-4)  # 0.6094 ms
    assert bounds["dequant_acc_int8"] == pytest.approx(
        (n * 6 + n * 5) / 3.35e12 * 1e3, rel=1e-4)      # 0.4469 ms
    # per bucket it is the sum of its own shapes: two 787,968 buckets cost
    # twice one
    one = smoke.codec_step_bound_ms([787968])
    two = smoke.codec_step_bound_ms([787968, 787968])
    assert two["quant_int8"] == pytest.approx(2 * one["quant_int8"])


def test_refuses_without_a_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    r = subprocess.run([sys.executable, os.path.join(_ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=_ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_kernel_ab_refuses_without_a_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    r = subprocess.run([sys.executable, os.path.join(_ROOT, "kernel_ab.py"),
                        "--tree", "this=torchft_tpu_torch/csrc"],
                       capture_output=True, text=True, timeout=120, cwd=_ROOT)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and r.stdout == ""


def test_train_durable_is_the_last_phase() -> None:
    assert _smoke().PHASES[-1] == "train_durable"


def test_durable_disk_bytes_at_125m() -> None:
    smoke = _smoke()
    n = sum(p.numel() for p in GPT(CONFIGS["125m"], device="meta")
            .parameters())
    assert n == 136091136
    # 2 groups x (keep=2 + one in flight) x (parameters + 2 AdamW moments)
    assert smoke.durable_disk_bytes(n) == 2 * 3 * 3 * 4 * n == 9798561792


def test_check_disk_fails_with_the_figures(tmp_path, monkeypatch) -> None:
    import collections
    import shutil

    smoke = _smoke()
    usage = collections.namedtuple("usage", "total used free")
    monkeypatch.setattr(shutil, "disk_usage",
                        lambda path: usage(10**10, 9 * 10**9, 10**9))
    with pytest.raises(AssertionError, match=r"needs 9\.80 GB.*has 1\.00 GB"):
        smoke.check_disk(str(tmp_path), 9798561792)
    assert smoke.check_disk(str(tmp_path), 10**8) == 10**9


def test_durable_report_reads_the_drill(monkeypatch) -> None:
    from torchft_tpu_torch.examples.train_ddp import run_resume_drill

    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    result = run_resume_drill(CONFIGS["tiny"], device="cpu", batch_size=2,
                              timeout=30.0)
    lines = _smoke().durable_report(result, 2, 128, "card, 700 W")
    text = "\n".join(lines)
    assert "fused solo steps of group 0: 3" in lines[0]
    assert "'barrier'" in lines[0] and "'fence'" in lines[0]
    for g in (0, 1):
        assert f"group {g}: full steps quorum p50" in text
        assert f"group {g} resumed at step 6" in text
    assert "fast steps [6, 7]" in text
    # every write: group 0 at 2, 4, 6 then 8; group 1 at 4, 6 then 8
    assert sum("checkpoint ckpt." in line for line in lines) == 7
    assert "heal at step 4" in text
    assert "life 0 joint step ms" in text and "life 1 joint step ms" in text
    assert "repeated the first life's bitwise: True" in text


def test_localsgd_host_bytes_at_125m() -> None:
    smoke = _smoke()
    n = 136091136
    # 4 groups x 8 f32 copies, and the heal's 6 once
    assert smoke.localsgd_host_bytes(n) == (4 * 8 + 6) * 4 * n


def test_check_host_memory_fails_with_the_figures(tmp_path) -> None:
    smoke = _smoke()
    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal:       8000000 kB\n"
                       "MemAvailable:   1000000 kB\n")
    with pytest.raises(AssertionError, match=r"needs 20\.00 GB.*has 1\.02 GB"):
        smoke.check_host_memory(20 * 10**9, str(meminfo))
    assert smoke.check_host_memory(10**8, str(meminfo)) == 1024000000


@pytest.mark.parametrize("phase", ["train_diloco", "train_localsgd_int8"])
def test_outer_sync_phases_run_at_tiny_on_the_cpu(monkeypatch,
                                                  phase) -> None:
    # the phase as the card runs it, its drill moved to "tiny" on the CPU:
    # the schedule checks, the report lines and (int8) the plane check
    import torchft_tpu_torch.examples.train_diloco as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    drill = example.run_diloco_drill
    monkeypatch.setattr(example, "run_diloco_drill", lambda cfg, **kw: drill(
        cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    out = getattr(smoke, f"phase_{phase}")(0, "CPU")
    passes = out[-1]["passes"]
    assert out[0] == passes * CONFIGS["tiny"].n_layers
    text = "\n".join(lines)
    assert "outer_wire" in text and "heal" in text
    if phase == "train_localsgd_int8":
        assert out[1] == 12 and passes == 4 * 24
        assert text.count("card plane vs CPU plane bitwise ok") == 2
    else:
        assert passes == 40 + 19 + 16


def test_diloco_sharded_memory_at_125m() -> None:
    smoke = _smoke()
    n = 136091136
    act = smoke.gpt_activation_bytes(CONFIGS["125m"], 8)
    # 3 groups x 5 f32 copies and 16 once; 16 B a parameter a group, a
    # restarted model, two passes' activations a group
    assert smoke.diloco_sharded_host_bytes(n) == (3 * 5 + 16) * 4 * n
    assert smoke.diloco_sharded_device_bytes(n, act) == \
        (16 * 3 + 4) * n + 6 * act
    assert smoke.diloco_sharded_host_bytes(n) / 1e9 < 17.0
    assert smoke.diloco_sharded_device_bytes(n, act) / 1e9 < 60.0


def test_train_diloco_sharded_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, its drills at "tiny" on the CPU with a
    # 3 s wire timeout: the replicated arm, the kill, the shrink, the heal
    # and grow, the wedge, the five schedule checks and the report; then
    # the checks must reject a drill that broke coverage or the grow
    import torchft_tpu_torch.examples.train_diloco as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setattr(smoke, "DILOCO_WIRE_TIMEOUT", 3.0)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    drill = example.run_diloco_drill
    monkeypatch.setattr(example, "run_diloco_drill", lambda cfg, **kw: drill(
        cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    seen = {}
    check = smoke.check_diloco_sharded

    def spy(result, replicated):
        seen.update(result=dict(result), replicated=dict(replicated))
        return check(result, replicated)

    monkeypatch.setattr(smoke, "check_diloco_sharded", spy)
    want, result = smoke.phase_train_diloco_sharded(0, "CPU")
    text = "\n".join(lines)
    for n in range(1, 6):
        assert f"{n}. " in text and "passed" in text
    assert "reshard" in text and "heal of group 2" in text
    assert want % CONFIGS["tiny"].n_layers == 0 and want > 0
    assert result["wedged"]["next_pid"] != result["wedged"]["pid"]
    held = dict(seen["result"]["held"])
    held[1] = {0: [0, 1], 1: [1], 2: [2]}
    with pytest.raises(AssertionError, match="round 1"):
        check(dict(seen["result"], held=held), seen["replicated"])
    grow = dict(seen["result"]["grow"], equal=False)
    with pytest.raises(AssertionError, match="grow"):
        check(dict(seen["result"], grow=grow), seen["replicated"])


def test_hier_host_bytes_at_125m() -> None:
    smoke = _smoke()
    n = 136091136
    # 4 groups x 4 f32 copies, the recorded step (8), the heal (6) and the
    # host oracle (4)
    assert smoke.hier_host_bytes(n) == (4 * 4 + 18) * 4 * n
    # the last of the training planes, before the process drill, the dry
    # run and train_durable
    assert smoke.PHASES.index("train_hier_int8") == len(smoke.PHASES) - 4
    assert smoke.PHASES[-3:] == ("train_proc", "dryrun_multichip",
                                 "train_durable")


def test_hier_roles_follow_the_schedule() -> None:
    smoke = _smoke()
    k, s_alone, _, killed, _ = smoke.HIER_SCHEDULE
    assert killed in smoke.HIER_DOMAINS["rack1"]
    assert smoke._hier_roles(1, 0) == (2, True)
    assert smoke._hier_roles(1, 1) == (2, False)
    assert smoke._hier_roles(k, 2) == (2, True)
    assert smoke._hier_roles(k + 1, 3) == (1, True)  # rack1 = {g3}
    assert smoke._hier_roles(k + s_alone, 3) == (1, True)
    assert smoke._hier_roles(k + s_alone + 1, 3) == (2, False)
    assert smoke._hier_roles(k + s_alone + 1, 2) == (2, True)


def test_train_hier_int8_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" on the CPU: the drill's
    # schedule, bitwise steps, tier counters, error-feedback roles and the
    # recorded step against _host_hier_allreduce, then the plane arms (the
    # "card" pool on the CPU) against the TCP hier path
    import torchft_tpu_torch.examples.train_ddp as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setattr(smoke, "HIER_DEVICE", "cpu")
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    drill = example.run_kill_and_heal
    monkeypatch.setattr(example, "run_kill_and_heal", lambda cfg, **kw: drill(
        cfg, **dict(kw, batch_size=2, timeout=30.0)))
    flash_launches, codec, result = smoke.phase_train_hier_int8(0, "CPU")
    # 4 groups x 8 steps - 2 steps alone
    assert result["passes"] == 30
    assert flash_launches == 30 * CONFIGS["tiny"].n_layers
    buckets = result["runs"][0].buckets
    assert codec == 3 * len(set(buckets))
    text = "\n".join(lines)
    assert "bitwise equal to _host_hier_allreduce" in text
    assert text.count("card hier star vs TCP hier and CPU plane bitwise "
                      "ok") == len(set(buckets))
    assert "error feedback on" in text and "heal of group 2" in text
    for g in range(4):
        assert f"group {g} life 0 phase p50 ms" in text
    assert "group 2 life 1" in text and "committed tokens/s" in text


def test_check_hier_drill_catches_a_wrong_counter() -> None:
    # a drill whose egress counted its inter bytes twice must fail
    import copy

    import numpy as np

    from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal

    smoke = _smoke()
    k, s_alone, after, killed, record = smoke.HIER_SCHEDULE
    result = run_kill_and_heal(
        CONFIGS["tiny"], kill_step=k, steps_alone=s_alone, steps_after=after,
        groups=4, kill_group=killed, domains=smoke.HIER_DOMAINS,
        record_step=record, device="cpu", batch_size=2, timeout=30.0,
        comm_backend="host", comm_options=smoke.HIER_OPTIONS)
    assert smoke.check_hier_drill(result, CONFIGS["tiny"], "CPU")
    bad = copy.copy(result)
    bad["lives"] = copy.deepcopy(result["lives"])
    bad["lives"][0][0].metrics["comm_inter_bytes"] *= 2
    with pytest.raises(AssertionError, match="tier counters"):
        smoke.check_hier_drill(bad, CONFIGS["tiny"], "CPU")
    bad = copy.copy(result)
    bad["lives"] = copy.deepcopy(result["lives"])
    op = sorted(bad["lives"][1][0].recorded)[0]
    out = bad["lives"][1][0].recorded[op][1][0]
    out[0] = np.nextafter(out[0], np.float32(np.inf))
    with pytest.raises(AssertionError, match="_host_hier_allreduce"):
        smoke.check_hier_drill(bad, CONFIGS["tiny"], "CPU")


def test_multijob_memory_at_125m() -> None:
    smoke = _smoke()
    cfg = CONFIGS["125m"]
    n = 136091136
    # per layer 18 x (8 x 1024 x 768) f32, and the logits with their grad
    act = smoke.gpt_activation_bytes(cfg, 8)
    assert act == 4 * (18 * 8 * 1024 * 768 * 12 + 2 * 8 * 1024 * 32768)
    # five trainers' parameters, gradients and AdamW moments, the
    # observer's parameters, four groups' activations and three graphs'
    assert smoke.multijob_device_bytes(n, act) == (16 * 5 + 4) * n + 7 * act
    assert smoke.multijob_host_bytes(n) == (5 * 4 + 6) * 4 * n
    assert smoke.PHASES.index("train_multijob") < smoke.PHASES.index(
        "train_hier_int8")


def _tiny_multijob(monkeypatch, free):
    import torchft_tpu_torch.examples.train_ddp as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    # the card's memory queries, answered for a CPU-only torch
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (free, free))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated",
                 "max_memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    drill = example.run_multijob_drill
    monkeypatch.setattr(example, "run_multijob_drill", lambda cfg, **kw: drill(
        cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    return smoke, lines


def test_train_multijob_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" on the CPU, with the
    # device memory short of five trainers: hi0 runs at "tiny" (here the
    # same head_dim), every check of the drill, the report, the launches
    cfg = CONFIGS["tiny"]
    smoke = _smoke()
    n = sum(p.numel() for p in GPT(cfg, device="meta").parameters())
    act = smoke.gpt_activation_bytes(cfg, 8)
    smoke, lines = _tiny_multijob(
        monkeypatch, smoke.multijob_device_bytes(n, act) - 1)
    per_d, result = smoke.phase_train_multijob(0, "CPU")
    text = "\n".join(lines)
    assert "hi0 at tiny" in text
    trained = result["passes"] + result["hi_passes"]
    assert per_d == {16: {
        "flash_fwd": cfg.n_layers * (trained + result["probe_passes"]),
        "flash_bwd_dq": cfg.n_layers * trained,
        "flash_bwd_dkv": cfg.n_layers * trained}}
    assert result["probe_passes"] == 7
    for name in ("a0", "a1", "a_obs", "b0", "b1", "hi0"):
        assert f" {name} life 0 phase p50 ms" in text
    assert "a1 life 1" in text and "quorum_fast p50" in text
    assert "membership_epoch 8 -> 8" in text
    assert "b1 evicted at step 7" in text
    assert "parameters unchanged True" in text
    assert "bitwise equal at steps [1, 2, 3] of 1-3" in text
    assert "a1's heal at step 5" in text and "phase " in text
    assert "device memory peak" in text


def test_train_multijob_failures_are_not_swallowed(monkeypatch, capsys):
    # a failed drill fails the phase and chip_smoke.py's main (a non-zero
    # exit, no result line); so does memory short even for four trainers
    import sys

    smoke, _ = _tiny_multijob(monkeypatch, 1)
    with pytest.raises(AssertionError, match="device memory free"):
        smoke.phase_train_multijob(0, "CPU")
    import torchft_tpu_torch.examples.train_ddp as example

    def broken(cfg, **kw):
        raise AssertionError("b1's eviction: at None")

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e15, 1e15))
    monkeypatch.setattr(example, "run_multijob_drill", broken)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "phase_device", lambda: ("CPU", {}))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--phases",
                                      "train_multijob"])
    with pytest.raises(AssertionError, match="eviction"):
        smoke.main()
    assert '"ok"' not in capsys.readouterr().out


# ------------------------------------------------------------ train_sharded


def test_sharded_memory_and_launches_at_125m() -> None:
    smoke = _smoke()
    cfg = CONFIGS["125m"]
    n = 136091136
    act = smoke.gpt_activation_bytes(cfg, 8)
    # three groups' parameters and gradients, at a wire of 2 half the
    # moments and their staged update, and three groups' activations
    assert smoke.sharded_device_bytes(n, act) == 3 * (18 * n + act)
    # the A/B arms: 2 arms x 2 launches x 15 DDP buckets x 2 steps (cut
    # from 3); the card plane's sharded arm: one native scatter a step
    # with a peer
    assert smoke.SHARDED_AB_STEPS == 2
    assert smoke.sharded_expected_launches(15) == {"ab": 120, "sharded": 2}
    phases = smoke.PHASES
    assert phases.index("train_multijob") < phases.index("train_sharded") \
        < phases.index("train_cuda_int8")


def _tiny_sharded(monkeypatch, free=1e12):
    import torchft_tpu_torch.examples.train_ddp as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (free, free))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    for name in ("run_joint", "run_kill_and_heal"):
        fn = getattr(example, name)
        monkeypatch.setattr(example, name, lambda cfg, _fn=fn, **kw: _fn(
            cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    return smoke, lines


def test_train_sharded_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" on the CPU (the card
    # plane on a CPU pool): every check of (a), (b) and (c), the report
    # and the launch counts it expects
    smoke, lines = _tiny_sharded(monkeypatch)
    flash_launches, codec = smoke.phase_train_sharded(0, "CPU")
    text = "\n".join(lines)
    # (b) 3 x 7 - 1 drill passes, 3 x 3 replicated; (a) 2 x 2 x 2; (c) 2 x 2
    assert flash_launches == CONFIGS["tiny"].n_layers * (20 + 9 + 8 + 4)
    # "tiny" has one DDP bucket: 2 x 2 x 1 x 2, then 2 sharded scatters
    assert codec == 8 + 2
    assert "steps 1-3 bitwise equal to the replicated arm" in text
    assert "(a) streamed == lock-step bitwise" in text
    assert "(c) sharded on the int8 card plane" in text
    for g in (0, 1, 2):
        assert f"g{g} life 0: optimizer state held" in text
    assert "g0 life 1" in text and "heal plan (moved, lower bound) [(" \
        in text


def test_check_sharded_drill_catches_an_overship() -> None:
    # a reshard that moved more than its lower bound, a heal that never
    # fetched, and a sharded arm off the replicated one each fail
    from torchft_tpu_torch.examples.train_ddp import GroupRun

    smoke = _smoke()

    def result(moved=10, heal=5, digest="x"):
        reshards = [
            {"kind": "reshard", "new_world": 3, "old_world": None,
             "wire_bytes": 0, "lower_bound_bytes": 0, "reinit_leaves": 0},
            {"kind": "reshard", "new_world": 2, "old_world": 3,
             "wire_bytes": moved, "lower_bound_bytes": 10,
             "reinit_leaves": 2},
            {"kind": "reshard", "new_world": 3, "old_world": 2,
             "wire_bytes": 0, "lower_bound_bytes": 0, "reinit_leaves": 0}]
        digests = {s: digest for s in (1, 2, 3)}
        healed = GroupRun(events=[{"kind": "redist_plan",
                                   "source": "opt_shard_heal",
                                   "moved_bytes": heal,
                                   "lower_bound_bytes": heal}])
        return {"lives": {0: [GroupRun(), healed],
                          1: [GroupRun(events=reshards,
                                       param_digests=digests)],
                          2: [GroupRun()]}}

    replicated = {0: GroupRun(param_digests={s: "x" for s in (1, 2, 3)})}
    smoke.check_sharded_drill(result(), replicated)
    with pytest.raises(AssertionError, match="moved 11 bytes"):
        smoke.check_sharded_drill(result(moved=11), replicated)
    with pytest.raises(AssertionError, match="fetch_opt_shard"):
        smoke.check_sharded_drill(result(heal=0), replicated)
    with pytest.raises(AssertionError, match="replicated arm"):
        smoke.check_sharded_drill(result(digest="y"), replicated)


def test_moe_memory_at_8x125m() -> None:
    from torchft_tpu_torch.models import MOE_CONFIGS

    smoke = _smoke()
    cfg, n = MOE_CONFIGS["moe-8x125m"], 334308864
    act = smoke.moe_activation_bytes(cfg, 8)
    # N = 8192 tokens, capacity int(1.25 * 8192 * 2 / 8) = 2560
    assert act == (2 * 8192 * 768 * 12 + 4 * 8 * 8192 * 8 * 2560
                   + 4 * 18 * 8192 * 3072 + 2 * 4 * 8192 * 32768 // 8)
    # four ranks' parameters, gradients and moments, the kept copy, two
    # healers' incoming state and four ranks' activations: under 80 GB
    assert smoke.moe_device_bytes(n, act) == (4 * 16 + 12 + 24) * n + 4 * act
    assert smoke.moe_device_bytes(n, act) < 70e9
    assert smoke.moe_host_bytes(n) == (16 + 12) * 4 * n
    phases = smoke.PHASES
    assert phases.index("train_sharded") < phases.index("train_moe") \
        < phases.index("train_cuda_int8")


def test_train_moe_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "moe-tiny" on the CPU: the
    # drill's checks, the report and the passes it returns
    import torchft_tpu_torch.examples.train_moe as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.MOE_CONFIGS, "moe-8x125m",
                        models.MOE_CONFIGS["moe-tiny"])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e12, 1e12))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    fn = example.run_moe_drill
    monkeypatch.setattr(example, "run_moe_drill", lambda cfg, **kw: fn(
        cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    passes, layers = smoke.phase_train_moe(0, "CPU")
    # per rank: group 0 at 1-6, group 1 at 2-3 and 5-6
    assert (passes, layers) == (2 * (6 + 2 + 2), 2)
    text = "\n".join(lines)
    assert "every live rank bitwise equal" in text
    assert "heal of group 1 rank 0 at step 5" in text
    assert "heal of group 1 rank 1 at step 5" in text
    assert "bytes served in that heal by group 0's ranks: rank 0" in text
    assert "group 1 rank 1: phase p50 ms" in text


def test_llama_ring_memory_and_launches_at_120m() -> None:
    from torchft_tpu_torch.models import Llama

    smoke = _smoke()
    cfg = smoke.llama_ring_config()
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.max_seq_len, cfg.xent_chunks,
            cfg.remat) == (768, 12, 12, 4, 2048, 32768, 4096, 8, True)
    n = sum(p.numel() for p in Llama(cfg, device="meta").parameters())
    assert n == 125848320
    # 8192 tokens: layer inputs, one recomputed layer, one logits chunk
    flash_act = (2 * 8192 * 768 * 12 + 4 * 18 * 8192 * 2048
                 + 2 * 4 * 8192 * 32768 // 8)
    assert smoke.llama_activation_bytes(cfg, 2) == flash_act
    # the einsum ring keeps a layer's pair scores: 16 pairs of 1024 x 1024
    assert smoke.llama_activation_bytes(cfg, 2, "einsum") == \
        flash_act + 6 * 4 * 2 * 12 * 1024 * 1024 * 16
    need = smoke.llama_ring_device_bytes(n, cfg, 2)
    # the drill's part (two groups' state, stepped in place, and two kept
    # copies in flight: 10.3 GB) is below the parity pass's (the einsum
    # ring's scores: 12.3 GB)
    einsum = 8 * n + smoke.llama_activation_bytes(cfg, 2, "einsum")
    assert need == max(einsum, 56 * n + 2 * flash_act) == einsum
    assert need < 20e9
    assert smoke.llama_ring_host_bytes(n) == 14 * 4 * n
    # 13 passes x 12 layers x (10 pairs, the forward twice under remat)
    assert smoke.llama_ring_launches(13, 12) == {
        "flash_fwd": 3120, "flash_bwd_dq": 1560, "flash_bwd_dkv": 1560}
    assert smoke.llama_ring_launches(1, 1, remat=False) == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 10)
    phases = smoke.PHASES
    assert phases.index("gpt_1b") < phases.index("train_llama_ring") \
        < phases.index("train_durable")


def test_ring_pass_ms_follows_the_schedule() -> None:
    smoke = _smoke()
    times = {("flash_fwd", "causal"): 1.0, ("flash_fwd", "full"): 2.0,
             ("flash_bwd_dq", "causal"): 10.0, ("flash_bwd_dq", "full"): 20.0,
             ("flash_bwd_dkv", "causal"): 100.0,
             ("flash_bwd_dkv", "full"): 200.0}
    # 4 causal pairs and 6 full ones per layer, 12 layers
    got = smoke.ring_pass_ms(times, 12)
    assert got["flash_fwd"] == 12 * 2 * (4 * 1.0 + 6 * 2.0)
    assert got["flash_bwd_dq"] == 12 * (4 * 10.0 + 6 * 20.0)
    assert got["flash_bwd_dkv"] == 12 * (4 * 100.0 + 6 * 200.0)
    assert got["total"] == got["flash_fwd"] + got["flash_bwd_dq"] \
        + got["flash_bwd_dkv"]
    assert smoke.ring_pass_ms(times, 1, remat=False)["flash_fwd"] == 16.0


def test_train_llama_ring_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "llama_tiny" (with remat and
    # 8 vocab chunks) on the CPU: the parity pass, the drill's checks, the
    # report and the launches the schedule says; the kernels' timing needs
    # the card and is stubbed
    import dataclasses
    import functools

    import torchft_tpu_torch.examples.train_llama_ring as example
    from torchft_tpu_torch.models import LLAMA_CONFIGS

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    tiny = dataclasses.replace(LLAMA_CONFIGS["llama_tiny"], max_seq_len=256,
                               xent_chunks=8, remat=True)
    monkeypatch.setattr(smoke, "llama_ring_config", lambda: tiny)
    times = {(n, m): 0.01 for n in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")
             for m in ("causal", "full")}
    monkeypatch.setattr(smoke, "llama_ring_pair_times",
                        lambda *a, **k: times)
    monkeypatch.setattr(smoke, "llama_ring_parity", functools.partial(
        smoke.llama_ring_parity, device="cpu"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e12, 1e12))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    fn = example.run_llama_ring_drill
    monkeypatch.setattr(example, "run_llama_ring_drill", lambda cfg, **kw: fn(
        cfg, **dict(kw, device="cpu", timeout=30.0)))
    counts, want, head_dim = smoke.phase_train_llama_ring(0, "CPU")
    assert head_dim == 16
    # 13 passes x 2 layers; the CPU launches no kernel
    assert want == {"flash_fwd": 13 * 2 * 20, "flash_bwd_dq": 13 * 2 * 10,
                    "flash_bwd_dkv": 13 * 2 * 10, "quant_int8": 0,
                    "dequant_acc_int8": 0}
    assert set(counts) == set(want) and not any(counts.values())
    text = "\n".join(lines)
    assert "flash ring: loss" in text and "einsum ring: loss" in text
    # the warm passes, and the profiled ones (no device on the CPU)
    assert text.count(" ms warm (CPU)") == 3
    assert "profiled flash ring pass, one thread: wall" in text
    assert "profiled unsharded pass" in text
    assert "device busy not measured" in text
    assert "FAIL" not in text
    assert "both groups bitwise equal" in text
    assert "group 1 healed at step 5" in text
    assert "heal: heal_wall_ms" in text
    assert "ring launches per forward/backward pass: {'flash_fwd': 40" in text
    assert "group 1: step p50 ms {'quorum'" in text
    assert "committed tokens/s" in text and "phase " in text


def test_hsdp_memory_and_launches_at_1b() -> None:
    smoke = _smoke()
    cfg = smoke.hsdp_config()
    # "1b"'s width, its depth cut to 6 to keep the script under 900 s
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.max_seq_len, cfg.xent_chunks, cfg.remat) == \
        (2048, 6, 16, 128, 8192, 32768, 2048, 8, True)
    assert smoke.CUT_LAYERS == 6
    from torchft_tpu_torch.models import gpt_param_shapes

    n = sum(math.prod(s) for s in gpt_param_shapes(cfg).values())
    assert n == 440455168
    # batch 8 over fsdp 2, 16 heads over tensor 2: what the kernels see
    assert smoke.hsdp_attention_shape(cfg) == (4, 2048, 8, 128)
    assert smoke.hsdp_positions() == 4
    # the shard's vocabulary splits into the loss's chunks
    assert (cfg.vocab_size // 2) % cfg.xent_chunks == 0
    # 13 passes x 24 layers x 4 positions, the forward twice (remat)
    assert smoke.hsdp_launches(13, 24) == {
        "flash_fwd": 2496, "flash_bwd_dq": 1248, "flash_bwd_dkv": 1248}
    assert smoke.hsdp_launches(1, 2, remat=False) == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 8)
    # the drill's part: two groups' parameters, gradients and moments,
    # the healer's healed copy, every group's activations; it must fit
    # the 80 GB card
    act = smoke.hsdp_activation_bytes(cfg, 8)
    need = smoke.hsdp_device_bytes(n, cfg)
    assert need == (16 * 2 + 12) * n + 2 * act
    assert 2e9 < act < 8e9 and need < 76e9
    assert smoke.hsdp_host_bytes(n) == 10 * 4 * n
    phases = smoke.PHASES
    assert phases.index("train_llama_ring") < phases.index("train_hsdp") \
        < phases.index("train_durable")


def test_hsdp_pass_ms_follows_the_schedule() -> None:
    smoke = _smoke()
    times = {"flash_fwd": {"ms": 1.0}, "flash_bwd_dq": {"ms": 10.0},
             "flash_bwd_dkv": {"ms": 100.0}}
    got = smoke.hsdp_pass_ms(times, 24)
    assert got["flash_fwd"] == 2 * 96 * 1.0
    assert got["flash_bwd_dq"] == 96 * 10.0
    assert got["flash_bwd_dkv"] == 96 * 100.0
    assert got["total"] == 192 + 960 + 9600


def test_train_hsdp_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" (with remat and 2
    # vocab chunks a shard) on the CPU: the parity pass, the drill's
    # checks, the report and the launches the schedule says; the kernels'
    # timing needs the card and is stubbed
    import dataclasses
    import functools

    import torchft_tpu_torch.examples.train_hsdp as example

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    tiny = dataclasses.replace(CONFIGS["tiny"], xent_chunks=2, remat=True)
    monkeypatch.setattr(smoke, "hsdp_config", lambda: tiny)
    times = {n: {"ms": 0.01} for n in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    monkeypatch.setattr(smoke, "hsdp_flash_times", lambda *a, **k: times)
    monkeypatch.setattr(smoke, "hsdp_parity", functools.partial(
        smoke.hsdp_parity, device="cpu"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e12, 1e12))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    fn = example.run_hsdp_drill
    monkeypatch.setattr(example, "run_hsdp_drill", lambda cfg, axes, **kw: fn(
        cfg, axes, **dict(kw, device="cpu", timeout=30.0)))
    counts, want, head_dim = smoke.phase_train_hsdp(0, "CPU")
    assert head_dim == 16
    # 9 passes (group 0: 5, group 1: steps 1-2 and 4-5) x 2 layers x 4
    # positions; the CPU launches no kernel
    assert want == {"flash_fwd": 9 * 2 * 4 * 2, "flash_bwd_dq": 9 * 2 * 4,
                    "flash_bwd_dkv": 9 * 2 * 4, "quant_int8": 0,
                    "dequant_acc_int8": 0}
    assert set(counts) == set(want) and not any(counts.values())
    text = "\n".join(lines)
    assert "sharded {'fsdp': 2, 'tensor': 2}: loss" in text
    assert " ms warm (CPU)" in text
    assert "FAIL" not in text
    assert "both groups bitwise equal" in text
    assert "group 1 healed at step 4 into its sharded template" in text
    assert "heal: heal_wall_ms" in text and "= the state's" in text
    assert "bytes of parameter pieces per mesh position" in text
    assert "flash launches per forward/backward pass: {'flash_fwd': 16" \
        in text
    assert "group 1: step p50 ms {'quorum'" in text
    assert "committed tokens/s" in text and "phase " in text


def test_hsdp_parity_fails_a_wrong_model(monkeypatch) -> None:
    # a sharded model whose loss is off fails the parity pass loudly
    import dataclasses

    from torchft_tpu_torch.models import ShardedGPT

    smoke = _smoke()
    monkeypatch.setattr(smoke, "log", lambda m: None)
    tiny = dataclasses.replace(CONFIGS["tiny"], xent_chunks=2)
    real = ShardedGPT.loss
    monkeypatch.setattr(ShardedGPT, "loss",
                        lambda self, *a: real(self, *a) * 1.1)
    with pytest.raises(AssertionError, match="against the unsharded"):
        smoke.hsdp_parity(tiny, 0, "CPU", device="cpu")


def test_moe_expert_memory_and_launches_at_8x125m() -> None:
    from torchft_tpu_torch.models import MOE_CONFIGS, moe_param_shapes

    smoke = _smoke()
    cfg = MOE_CONFIGS["moe-8x125m"]
    n = sum(math.prod(s) for s in moe_param_shapes(cfg).values())
    assert n == 334308864
    # one sequence a position: 8 positions of the batch of 8
    assert smoke.moe_expert_attention_shape(cfg, 8) == (1, 1024, 12, 64)
    act = smoke.moe_expert_activation_bytes(cfg, 8)
    # capacity int(1.25 * 8192 * 2 / 8) = 2560; 2 experts a position
    assert act == smoke.moe_activation_bytes(cfg, 8) \
        + 2 * 4 * 8 * 8 * 2560 * 768 + 2 * 2 * 8 * 2 * 2560 * 3072
    assert smoke.moe_expert_device_bytes(n, act) == 44 * n + 2 * act
    assert smoke.moe_expert_device_bytes(n, act) < 70e9
    # 13 passes of the drill: 12 layers x 8 positions, the forward twice
    assert smoke.hsdp_launches(13, 12, 8) == {
        "flash_fwd": 13 * 96 * 2, "flash_bwd_dq": 13 * 96,
        "flash_bwd_dkv": 13 * 96}
    phases = smoke.PHASES
    assert phases.index("train_hsdp") < phases.index("train_moe_expert") \
        < phases.index("train_resnet") < phases.index("train_diloco")


def test_train_moe_expert_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "moe-tiny" (remat on) on the
    # CPU: the parity pass, the drill over the virtual expert x data mesh,
    # the report and the launches the schedule says; the kernels' timing
    # needs the card and is stubbed
    import dataclasses
    import functools

    import torchft_tpu_torch.examples.train_moe as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.MOE_CONFIGS, "moe-8x125m", dataclasses.replace(
        models.MOE_CONFIGS["moe-tiny"], remat=True))
    times = {n: {"ms": 0.01} for n in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    monkeypatch.setattr(smoke, "hsdp_flash_times", lambda *a, **k: times)
    monkeypatch.setattr(smoke, "moe_expert_parity", functools.partial(
        smoke.moe_expert_parity, device="cpu"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e12, 1e12))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    fn = example.run_moe_drill
    monkeypatch.setattr(example, "run_moe_drill", lambda cfg, **kw: fn(
        cfg, **dict(kw, device="cpu", timeout=30.0)))
    counts, want, head_dim = smoke.phase_train_moe_expert(0, "CPU")
    assert head_dim == 16
    # 9 passes (group 0: 5, group 1: steps 1-2 and 4-5) x 2 layers x 8
    # positions; the CPU launches no kernel
    assert want == {"flash_fwd": 9 * 2 * 8 * 2, "flash_bwd_dq": 9 * 2 * 8,
                    "flash_bwd_dkv": 9 * 2 * 8, "quant_int8": 0,
                    "dequant_acc_int8": 0}
    assert set(counts) == set(want) and not any(counts.values())
    text = "\n".join(lines)
    assert "expert-sharded {'expert': 4, 'data': 2}: loss" in text
    assert "grad layers_1.moe.experts.up" in text
    assert "FAIL" not in text
    assert "both groups bitwise equal" in text
    assert "group 1 healed at step 4 into its sharded template" in text
    assert "heal: heal_wall_ms" in text and "= the state's" in text
    assert "(2 layers x 8 positions, remat)" in text
    assert "committed tokens/s" in text and "phase " in text


def test_train_resnet_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase's drill at 8x8 images, batch 2, on the CPU (the twin of the
    # reference's ResNet kill-and-heal test): both groups bitwise in
    # parameters, running statistics and momentum at every joint step,
    # the heal's wire bytes the state's
    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    fn = smoke.run_resnet_drill
    monkeypatch.setattr(smoke, "run_resnet_drill", lambda **kw: fn(
        **dict(kw, image=8, device="cpu", timeout=30.0)))
    smoke.phase_train_resnet(0, "CPU", batch=2)
    text = "\n".join(lines)
    assert "ResNet-18: 11173962 parameters" in text
    assert "cudnn.deterministic True, cudnn.benchmark False" in text
    assert "at every step both committed [1, 2, 4, 5, 6]; group 1 healed " \
        "at step 4" in text
    assert "= the state's 89430096 (CPU)" in text
    assert "group 1: step p50 ms {'quorum'" in text and "drill " in text


def test_resnet_drill_catches_a_heal_without_running_statistics(
        monkeypatch) -> None:
    # a heal that restores the parameters and momentum but leaves the
    # poisoned group's own running statistics diverges: the drill fails
    import torchft_tpu_torch.models.resnet as resnet

    smoke = _smoke()
    real = resnet.load_resnet_state_tree

    def params_only(model, tree, optimizer=None):
        keep = {k: v.clone() for k, v in model.state_dict().items()
                if "running" in k}
        real(model, tree, optimizer)
        model.load_state_dict(keep, strict=False)

    monkeypatch.setattr(resnet, "load_resnet_state_tree", params_only)
    with pytest.raises(AssertionError, match="group 1 differs at step"):
        smoke.run_resnet_drill(batch=2, image=8, device="cpu", timeout=30.0,
                               log=lambda m: None)


def test_pp_memory_and_launches_at_125m() -> None:
    smoke = _smoke()
    cfg = smoke.pp_config()
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.head_dim,
            cfg.max_seq_len, cfg.remat) == (768, 12, 12, 64, 1024, False)
    from torchft_tpu_torch.models import gpt_param_shapes

    n = sum(math.prod(s) for s in gpt_param_shapes(cfg).values())
    assert n == 136091136
    # 13 passes x 4 microbatches x 12 layers, no remat
    assert smoke.pp_launches(13, 12) == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 13 * 4 * 12)
    act = smoke.gpt_activation_bytes(cfg, 8) // 2 \
        + 4 * smoke.pp_replicated_bytes(cfg)
    need = smoke.pp_device_bytes(n, cfg)
    assert need == (16 * 2 + 12) * n + 2 * act
    assert need < 40e9
    phases = smoke.PHASES
    assert phases.index("train_moe_expert") < phases.index("train_pp") \
        < phases.index("pipeline_plane") < phases.index("train_durable")


def test_flash_times_at_reads_the_kernels_rows() -> None:
    smoke = _smoke()
    rows = {n: {"per_head_dim": [
        {"head_dim": 64, "shape": [8, 1024, 12, 64], "ms": 1.0,
         "also_timed": [{"shape": [2, 1024, 12, 64], "ms": 0.25}]}]}
        for n in smoke.FLASH_KERNELS}
    got = smoke.flash_times_at(rows, (2, 1024, 12, 64))
    assert {n: t["ms"] for n, t in got.items()} == dict.fromkeys(
        smoke.FLASH_KERNELS, 0.25)
    assert smoke.flash_times_at(rows, (1, 1024, 12, 64)) is None
    assert smoke.flash_times_at({}, (2, 1024, 12, 64)) is None


def test_train_pp_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" at depth 8 (two layers
    # a stage, V = 2 in the schedule pass) on the CPU: the parity pass, the
    # drill's checks, the report, the launches the schedule says and the
    # 1F1B schedules against GPipe; the kernels' timing needs the card
    import dataclasses
    import functools

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    tiny = dataclasses.replace(CONFIGS["tiny"], n_layers=8, xent_chunks=2)
    monkeypatch.setattr(smoke, "pp_config", lambda: tiny)
    times = {n: {"ms": 0.01} for n in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    for name in ("pp_parity", "pp_schedules"):
        monkeypatch.setattr(smoke, name, functools.partial(
            getattr(smoke, name), device="cpu"))
    fn = smoke.run_pp_drill
    monkeypatch.setattr(smoke, "run_pp_drill", lambda cfg, **kw: fn(
        cfg, **dict(kw, device="cpu", timeout=30.0)))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e12, 1e12))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 0)
    counts, want, head_dim = smoke.phase_train_pp(0, "CPU", times=times)
    assert head_dim == 16
    # 13 passes x 4 microbatches x 8 layers; the CPU launches no kernel
    assert want == {"flash_fwd": 13 * 4 * 8, "flash_bwd_dq": 13 * 4 * 8,
                    "flash_bwd_dkv": 13 * 4 * 8, "quant_int8": 0,
                    "dequant_acc_int8": 0}
    assert set(counts) == set(want) and not any(counts.values())
    text = "\n".join(lines)
    assert "pipelined {'stage': 4} x 4 microbatches: loss" in text
    assert " ms warm (CPU)" in text
    assert "FAIL" not in text
    assert "both groups bitwise equal" in text
    assert "group 1 healed at step 5 into its sharded template" in text
    assert "heal: heal_wall_ms" in text and "= the state's" in text
    assert "flash launches per forward/backward pass: {'flash_fwd': 32" \
        in text and "(4 microbatches x 8 layers, no remat)" in text
    assert "interleaved (V = 2)" in text
    assert "1F1B peak stored inputs 4, peak_inflight_activations 4" in text
    assert "committed tokens/s" in text and "phase " in text


def test_pp_schedules_fail_a_wrong_runner(monkeypatch) -> None:
    # a 1F1B runner whose gradients are off fails the schedule pass loudly
    import dataclasses

    from torchft_tpu_torch import parallel

    smoke = _smoke()
    monkeypatch.setattr(smoke, "log", lambda m: None)
    real = parallel.make_pipeline_1f1b

    def off(*a, **kw):
        run = real(*a, **kw)

        def wrapped(stacked, x, y):
            loss, grads = run(stacked, x, y)
            for leaf in grads["layers_0"]["mlp"]["up_proj"].values():
                leaf.mul_(1.01)
            return loss, grads
        wrapped.stats = run.stats
        return wrapped

    monkeypatch.setattr(parallel, "make_pipeline_1f1b", off)
    tiny = dataclasses.replace(CONFIGS["tiny"], n_layers=4)
    with pytest.raises(AssertionError, match="1f1b layer 0 mlp/up_proj"):
        smoke.pp_schedules(tiny, 0, "CPU", device="cpu")


def test_pipeline_plane_runs_small_on_the_cpu(monkeypatch) -> None:
    # the phase's arms at the card's stage and replica counts, narrow: the
    # bitwise oracle per codec, the schedule from events, the kill healed
    # and drained, the rebalance
    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    shape = dict(smoke.PLANE, layer_dims=(16,) * 13, batch=8)
    got = smoke.phase_pipeline_plane(0, "CPU", device="cpu", shape=shape,
                                     steps=2)
    text = "\n".join(got)
    for codec in ("none", "bf16", "int8"):
        assert f"{codec}: 1F1B sha256-equal to stage-serial" in text
    assert "equals its lane's projection" in text
    assert "heal arm: stage 1 replica 1 killed" in text
    assert "pipe_drained_steps 0" in text
    assert "drain arm" in text and "rebalance to" in text
    # a microbatch's f32 activation frame: rows x width
    assert "(f32 activation frame 512 bytes)" in text
    assert smoke.PLANE["layer_dims"] == (768,) * 13
    assert 1024 * 768 * 4 == 3 << 20  # the card's frame: 3 MiB


def test_fused_step_memory_and_launches_at_125m() -> None:
    smoke = _smoke()
    cfg = smoke.fused_config()
    from torchft_tpu_torch.models import gpt_param_shapes

    n = sum(math.prod(s) for s in gpt_param_shapes(cfg).values())
    assert n == 136091136
    assert smoke.fused_shape(n, (2, 2)) == {
        "positions": 4, "q_len": 34022784, "p_len": 68045568}
    # gm (4 x 68,045,568) and h, new_sub (4 x 34,022,784 each), f32, down
    # and up: 4.35 GB a staged step
    assert smoke.fused_host_hop_bytes(n) == 2 * 4 * (4 * 68045568
                                                    + 2 * 4 * 34022784)
    assert smoke.fused_host_hop_bytes(n) == 4354916352
    # the schedule of the card's run: per codec 3 steps of each arm and a
    # warm-up before each engine's captures; 2 + 2 profiled steps (none);
    # the int8 churn: 3 steps of each arm and the warm-ups at 4x1
    runs = {"none": 3 * 2 + 2 + 4, "bf16": 3 * 2 + 2,
            "int8": 3 * 2 + 2 + 3 * 2 + 2}
    assert sum(runs.values()) == 36
    want = smoke.fused_launches(runs["int8"], 12, 4, "int8")
    assert want == {"flash_fwd": 16 * 48, "flash_bwd_dq": 16 * 48,
                    "flash_bwd_dkv": 16 * 48, "quant_int8": 16,
                    "dequant_acc_int8": 32}
    assert smoke.fused_launches(8, 12, 4, "bf16")["quant_int8"] == 0
    need = smoke.fused_device_bytes(n, cfg)
    assert 30e9 < need < 60e9
    assert smoke.fused_host_bytes(n) < 16e9
    phases = smoke.PHASES
    assert phases.index("pipeline_plane") < phases.index("fused_step") \
        < phases.index("train_hier_int8")


def test_fused_step_launches_and_bytes_over_cards_at_125m() -> None:
    # over several cards each card holding positions quantizes its slots
    # and decodes its owners' sums (and its wire image) once a run; flash
    # stays one launch per layer per position per run
    smoke = _smoke()
    cfg = smoke.fused_config()
    from torchft_tpu_torch.models import gpt_param_shapes

    n = sum(math.prod(s) for s in gpt_param_shapes(cfg).values())
    for cards in (1, 2, 4):
        got = smoke.fused_launches(12, 12, 4, "int8", cards=cards)
        assert got == {"flash_fwd": 12 * 48, "flash_bwd_dq": 12 * 48,
                       "flash_bwd_dkv": 12 * 48, "quant_int8": 12 * cards,
                       "dequant_acc_int8": 24 * cards}
        assert smoke.fused_launches(12, 12, 4, "int8", ef=False,
                                    cards=cards)["dequant_acc_int8"] \
            == 12 * cards
        assert smoke.fused_launches(12, 12, 4, "none",
                                    cards=cards)["quant_int8"] == 0
    # the fullest card: one position of four cards holds a quarter of the
    # state, plus a row's gathered params and a kept gradient
    one = smoke.fused_device_bytes(n, cfg)
    two = smoke.fused_device_bytes(n, cfg, cards=2)
    four = smoke.fused_device_bytes(n, cfg, cards=4)
    assert four < two < one and 10e9 < four < 30e9
    # bytes between cards a step at 2x2, one position a card: each
    # position fetches its row's other shard and ships its gradient's
    # (4 x 272 MB each), each owner gets its other replica's slot and
    # each position its other replica's sub-shard (4 x 136 MB each)
    q, p = 34022784, 68045568
    cross = smoke.fused_cross_card_bytes(n, (2, 2), [0, 1, 2, 3], "none")
    assert cross["allgather"] == 4 * 4 * p
    assert cross["reduce_scatter"] == 4 * 4 * p + 3 * 4
    assert cross["exchange"] == cross["gather"] == 4 * 4 * q
    assert 3.2e9 < cross["total"] < 3.4e9
    bf16 = smoke.fused_cross_card_bytes(n, (2, 2), [0, 1, 2, 3], "bf16")
    assert bf16["exchange"] * 2 == cross["exchange"]
    int8 = smoke.fused_cross_card_bytes(n, (2, 2), [0, 1, 2, 3], "int8")
    assert 0.25 < int8["exchange"] / cross["exchange"] < 0.26
    # cycled over two cards: a row's two shards lie on cards 0 and 1, the
    # replicas of a shard on one card, so only the model axis crosses
    cyc = smoke.fused_cross_card_bytes(n, (2, 2), [0, 1, 0, 1], "none")
    assert cyc["allgather"] == cross["allgather"]
    assert cyc["exchange"] == cyc["gather"] == 0
    assert smoke.fused_cross_card_bytes(n, (2, 2), [0] * 4,
                                        "int8")["total"] == 0


def test_fused_step_runs_over_cards_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase's path over several cards at "tiny" on the CPU, positions
    # on cpu:0 .. cpu:3 (distinct cards to the engine): the same oracles,
    # then each codec's virtual run against the cards' digest
    import dataclasses

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    tiny = dataclasses.replace(CONFIGS["tiny"], max_seq_len=64)
    monkeypatch.setattr(smoke, "fused_config", lambda: tiny)
    counts, want, head_dim = smoke.phase_fused_step(
        0, "CPU", device="cpu", devices=[f"cpu:{i}" for i in range(4)])
    # 28 runs over the cards and 3 fused steps a codec on the virtual
    # mesh (no warm-ups on the CPU) x 4 positions x 2 layers; int8: 12
    # runs over 4 cards and 3 on one
    assert want == {"flash_fwd": 296, "flash_bwd_dq": 296,
                    "flash_bwd_dkv": 296, "quant_int8": 51,
                    "dequant_acc_int8": 102}
    text = "\n".join(lines)
    assert "FAIL" not in text
    assert "one position a card over 4 cards" in text
    assert text.count("states bitwise equal") == 9
    for codec in ("none", "bf16", "int8"):
        assert f"{codec}: bytes a step between cards" in text
        assert f"{codec}: 3 fused steps on the virtual 2x2 of cpu" in text
    assert text.count(": equal (") == 3
    assert "int8 churn to 2x2: seen before, programs 10" in text


def test_assemble_grad_reads_h_in_model_then_replica_order() -> None:
    import numpy as np

    smoke = _smoke()
    # position d = r * M + m holds elements [m * p_len + r * q_len, ...)
    R, M, q = 2, 3, 4
    full = np.arange(R * M * q, dtype=np.float32)
    h = np.stack([full[m * R * q + r * q:m * R * q + (r + 1) * q]
                  for r in range(R) for m in range(M)])
    np.testing.assert_array_equal(smoke.assemble_grad(h, R, M), full)


def test_fused_step_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" (sequences of 64) on
    # the CPU: both arms bitwise for every codec, the counters, the
    # gradient against the unsharded GPT, int8 against the host codec, the
    # churn, the StepProfiler window; no capture and no kernel on the CPU
    import dataclasses

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    tiny = dataclasses.replace(CONFIGS["tiny"], max_seq_len=64)
    monkeypatch.setattr(smoke, "fused_config", lambda: tiny)
    counts, want, head_dim = smoke.phase_fused_step(0, "CPU", device="cpu")
    assert head_dim == 16
    # 28 runs (no warm-ups without captures) x 4 positions x 2 layers;
    # int8: 12 runs of the exchange
    assert want == {"flash_fwd": 224, "flash_bwd_dq": 224,
                    "flash_bwd_dkv": 224, "quant_int8": 12,
                    "dequant_acc_int8": 24}
    assert set(counts) == set(want) and not any(counts.values())
    text = "\n".join(lines)
    assert "FAIL" not in text
    for codec in ("none", "bf16", "int8"):
        for step in (1, 2, 3):
            assert f"{codec} step {step}: loss" in text
        assert f"{codec}: programs built 5 (1 fused + 4 stages)" in text
    assert text.count("states bitwise equal") == 9
    assert "against the unsharded GPT's gradient of the same 8 sequences" \
        in text
    assert "against the host codec on the same gm and residual" in text \
        and "bitwise ok" in text
    assert "int8 churn to 4x1: first sight, programs 10" in text
    assert "int8 churn to 2x2: seen before, programs 10" in text
    assert "over 2 fused and 2 staged steps" in text
    assert "int8 after the churn: sha256 of the state" in text
    assert "phase " in text


def test_fused_step_oracles_catch_a_wrong_exchange() -> None:
    import numpy as np

    from torchft_tpu_torch.comm.cuda_backend import DevicePool
    from torchft_tpu_torch.fused import FusedStepEngine
    from torchft_tpu_torch.optim import sgd

    smoke = _smoke()
    eng = FusedStepEngine(DevicePool("cpu"), 2, 2,
                          np.linspace(-1, 1, 999, dtype=np.float32), 4,
                          lambda w, b: (w * b.mean()).square().sum(),
                          sgd(0.1), codec="int8", chunk_bytes=64)
    e0 = eng._host_rows(eng._state.e)
    eng.step_staged(np.ones((4, 4), np.float32))
    smoke.check_int8_exchange(eng, e0, "CPU")  # the true residual passes
    with pytest.raises(AssertionError, match="host codec"):
        smoke.check_int8_exchange(eng, e0 + 1e-3, "CPU")


def test_serve_deploy_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, at "tiny" on the CPU: the trainer's 6
    # steps, the three deploys, the kill, the rejoin and the growth, every
    # oracle; no kernel launches on the CPU
    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setattr(smoke, "serve_config", lambda: CONFIGS["tiny"])
    counts, want, head_dim = smoke.phase_serve_deploy(0, "CPU",
                                                      device="cpu")
    assert head_dim == 16
    # 6 committed steps, no capture on the CPU: 6 passes of 2 layers
    assert want == {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                    "quant_int8": 0, "dequant_acc_int8": 0}
    assert not any(counts.values())
    text = "\n".join(lines)
    for v in (2, 4, 6):
        assert f"deploy v{v}: wall" in text
    assert "0 dropped, 0 stale" in text
    assert "0 from the trainer" in text
    assert "the trainer committed steps [3, 4, 5, 6] after it" in text
    assert "phase " in text


def test_serve_oracles_catch_a_stale_shard(monkeypatch) -> None:
    # a member whose live bytes are not the publication's fails the drill
    import torchft_tpu_torch.serve as serve

    smoke = _smoke()
    monkeypatch.setattr(smoke, "log", lambda m: None)
    real = serve.ServingReplica._flip

    def stale_flip(self, version, host, buffers):
        if self.member_index == 2 and version == 2:
            buffers = {u: [b + 1 for b in bufs] for u, bufs in
                       buffers.items()}
        return real(self, version, host, buffers)

    monkeypatch.setattr(serve.ServingReplica, "_flip", stale_flip)
    with pytest.raises(AssertionError, match="member 2's live units"):
        smoke.run_serve_drill(CONFIGS["tiny"], device="cpu", seed=0,
                              timeout=30.0)


# --------------------------------------------------------------- train_proc


def test_train_proc_memory_at_125m() -> None:
    # the twin of tests/test_memory_plan.py's claim for the process drill:
    # a child's reckoning holds one parameters + gradients + AdamW
    # footprint (16 bytes a parameter), its activations and graph pools,
    # and no second parameters + AdamW footprint (12 bytes a parameter)
    smoke = _smoke()
    cfg = CONFIGS["125m"]
    n = 136091136
    act = smoke.gpt_activation_bytes(cfg, 8)
    assert smoke.proc_child_bytes(n, act) == 16 * n + act
    assert smoke.proc_child_bytes(n, act, graphs=1) == 16 * n + 2 * act
    assert 12 * n == 1633093632  # the 1.63 GB a second footprint would add
    assert smoke.train_proc_device_bytes(n, act) == (32 * n + 3 * act
                                                     + 2 * (1 << 30))
    assert smoke.proc_host_bytes(n) == (2 * 4 + 6) * 4 * n
    phases = smoke.PHASES
    assert (phases.index("train_hier_int8") < phases.index("train_proc")
            < phases.index("dryrun_multichip") < phases.index(
                "train_durable"))


def _proc_result(n, act, peak, rest, rises=None):
    # group 0 decides first (a rise of its AdamW temporaries), group 1
    # overlaps (its backup too); step 2 a fused commit, which reports none
    rises = rises or {0: 4 * n, 1: 16 * n}
    commits = {key: {1: {"allocated": rest, "update_rise": rises[key[0]]},
                     2: {"allocated": rest, "update_rise": None}}
               for key in ((0, 0), (1, 0), (0, 1))}
    return {"peaks": dict.fromkeys(commits, peak), "commits": commits,
            "donate_update": (True, False),
            "done": {(1, 0): (0.0, {"captures": 1}),
                     (0, 1): (0.0, {"captures": 0})}}


def test_check_proc_memory_rejects_a_second_footprint() -> None:
    smoke = _smoke()
    n, act = 136091136, smoke.gpt_activation_bytes(CONFIGS["125m"], 8)
    smoke.check_proc_memory(_proc_result(
        n, act, 16 * n + act, 16 * n + smoke.PROC_REST_SLACK), n, act)
    assert smoke.PROC_REST_SLACK < 12 * n // 6
    # a commit that allocates a second parameters + AdamW footprint
    with pytest.raises(AssertionError, match="peak"):
        smoke.check_proc_memory(
            _proc_result(n, act, 16 * n + act + 12 * n, 16 * n), n, act)
    # or leaves one behind
    with pytest.raises(AssertionError, match="more than one footprint"):
        smoke.check_proc_memory(_proc_result(n, act, 16 * n, 28 * n), n,
                                act)


def test_check_proc_memory_holds_each_arm_to_its_update_rise() -> None:
    # the other half of tests/test_memory_plan.py's claim: a decide-first
    # child's classic updates allocate no second parameters + AdamW
    # footprint even transiently (under 8 bytes a parameter), an
    # overlapped child's do (its 12-byte backup), and each child reports
    # a rise for some classic commit
    smoke = _smoke()
    n, act = 136091136, smoke.gpt_activation_bytes(CONFIGS["125m"], 8)
    peak, rest = 16 * n + act, 16 * n
    assert smoke.PROC_DONATE == (True, False)
    # the reckoning: the update window (16 + 12 + 4 bytes a parameter
    # overlapped, 16 + 4 decided) stays under the forward/backward's at
    # 125m, batch 8
    assert smoke.proc_child_bytes(n, act, overlapped=False) == 16 * n + act
    assert act > 16 * n
    assert smoke.proc_child_bytes(n, 8 * n, overlapped=True) == 32 * n
    assert smoke.proc_child_bytes(n, 8 * n, overlapped=False) == 24 * n
    smoke.check_proc_memory(_proc_result(n, act, peak, rest), n, act)
    with pytest.raises(AssertionError, match="decide first"):
        smoke.check_proc_memory(_proc_result(
            n, act, peak, rest, rises={0: 8 * n, 1: 16 * n}), n, act)
    with pytest.raises(AssertionError, match="overlapped"):
        smoke.check_proc_memory(_proc_result(
            n, act, peak, rest, rises={0: 4 * n, 1: 12 * n - 1}), n, act)
    result = _proc_result(n, act, peak, rest)
    for c in result["commits"][(0, 1)].values():
        c["update_rise"] = None
    with pytest.raises(AssertionError, match="no classic commit"):
        smoke.check_proc_memory(result, n, act)


def test_train_proc_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" on the CPU: real
    # processes, a real SIGKILL, every check of the drill, the report and
    # the launches it wants; the memory readings are the card's only
    import torchft_tpu_torch.examples.train_ddp as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e15, 1e15))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    checked = []
    monkeypatch.setattr(smoke, "check_proc_memory",
                        lambda *a: checked.append(a))
    drill = example.run_process_drill
    monkeypatch.setattr(example, "run_process_drill", lambda cfg, **kw: drill(
        cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    counts, want, head_dim = smoke.phase_train_proc(0, "CPU")
    text = "\n".join(lines)
    assert head_dim == 16 and len(checked) == 1
    result = checked[0][0]
    # 3 + 2 + (the survivor's latched step) ... each life's passes
    passes = result["passes"]
    assert passes[(0, 0)] == 3 and passes[(0, 1)] == 4
    assert want == dict.fromkeys(smoke.FLASH_KERNELS, 2 * sum(
        passes.values()))
    assert counts == dict.fromkeys(smoke.FLASH_KERNELS, 0)  # no card
    assert "SIGKILL of group 0 in its step 4" in text
    assert "heal at step 6" in text and "first joint commit" in text
    for name in ("killed", "survivor", "relaunch"):
        assert f"({name}): committed" in text
    assert "group 0 (relaunch): committed 6-9 (decide first)" in text
    assert "group 1 (survivor): committed 1-9 (overlapped)" in text
    # the lifecycle from the flight recordings the two lives fetched over
    # HTTP: the death one epoch above the last two-wire quorum, at step 3,
    # the relaunch's heal in the rejoin's epoch, commits again from step 5
    lc, tl = result["lifecycle"], result["timeline"]
    assert f"member_dead {tl['member_dead_s']:.3f}; solo commits" in text
    assert (f"member_dead of group 0's first life at epoch "
            f"{lc['death_epoch']} (step 3, ") in text
    assert (f"two-wire again at epoch {lc['rejoin_epoch']}; relaunch "
            "heal_start") in text
    assert "first resumed commit from step 5" in text
    assert "survivor steps_committed 9," in text
    assert "merged Chrome trace valid (" in text
    assert lc["death_epoch"] > lc["last_two_wire_epoch"]
    assert lc["rejoin_epoch"] == lc["heal_epoch"] >= lc["death_epoch"]
    # group 0's lives decide first, group 1 overlaps: the digests, equal at
    # 1-3 and 6-9, hold the two arms bitwise across the kill and the heal
    assert result["donate_update"] == (True, False)
    assert result["overlap"] == [1, 2, 3, 6, 7, 8, 9]
    # no rise without a card
    assert all(c["update_rise"] is None for life in result["commits"].values()
               for c in life.values())


def test_commit_raise_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # train's commit_raise sub-check as the card runs it, at "tiny" on the
    # CPU: real Managers and lighthouses, the held barrier, the raise part
    # way through the update, every check and the line it prints
    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    assert smoke.commit_raise(0, "CPU", config="tiny", batch=2,
                              device="cpu") == 5
    text = "\n".join(lines)
    assert "commit_raise: tiny (2 layers, d_model 64), batch 2: the " \
        "overlapped arm (order ['prologue', 'dispatch', 'barrier'])" in text
    assert "restored bitwise at the same addresses, decision read" in text
    assert "the retry bitwise equal to the twin's step" in text


# -------------------------------------------------------------- train_churn


def test_phase_seconds_span_each_phase_to_the_next() -> None:
    # the closing line's seconds: each phase from its header to the next
    # one's, the last to the end; the kernels' build under "device"
    smoke = _smoke()
    starts = [("device", 1.0), ("train", 3.5), ("train_churn", 10.0)]
    assert smoke.phase_seconds(starts, 12.25) == {
        "device": 2.5, "train": 6.5, "train_churn": 2.25}
    assert smoke.phase_seconds([], 5.0) == {}


def test_churn_memory_and_launches_at_125m() -> None:
    # five groups, each a train_proc child's reckoning, on one card or
    # spread; the codec kernels per bucket op of arm (b), the flash
    # kernels per pass of both arms
    smoke = _smoke()
    cfg = CONFIGS["125m"]
    n = 136091136
    act = smoke.gpt_activation_bytes(cfg, 8)
    child = smoke.proc_child_bytes(n, act)
    assert smoke.churn_device_bytes(n, act) == 5 * child
    assert smoke.churn_device_bytes(n, act, cards=4) == 2 * child
    lives = {g: [types.SimpleNamespace(wire_steps=6, buckets=[0] * 15)]
             for g in (0, 1)}
    want, steps, buckets = smoke.churn_launches(
        {"passes": 47}, {"passes": 14, "lives": lives}, 12,
        [torch.device("cpu")] * 2)
    assert (steps, buckets) == (6, 15)
    assert want == {**dict.fromkeys(smoke.FLASH_KERNELS, 12 * 61),
                    "quant_int8": 180, "dequant_acc_int8": 180}
    lives[1][0].wire_steps = 5
    with pytest.raises(AssertionError, match="steps with a peer"):
        smoke.churn_launches({"passes": 47}, {"passes": 14, "lives": lives},
                             12, [torch.device("cpu")] * 2)
    phases = smoke.PHASES
    assert (phases.index("train_localsgd_int8") < phases.index("train_churn")
            < phases.index("train_hier_int8"))


def test_train_churn_runs_at_tiny_on_the_cpu(monkeypatch) -> None:
    # the phase as the card runs it, moved to "tiny" on the CPU (arm (b)'s
    # card plane on a CPU pool): both drills, their oracles, the report
    # and the launches it wants; the memory readings are the card's only
    import torchft_tpu_torch.examples.train_ddp as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setattr(smoke, "CHURN_WIRE_TIMEOUT", 3.0)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1e15, 1e15))
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    drill = example.run_churn_drill
    monkeypatch.setattr(example, "run_churn_drill", lambda cfg, **kw: drill(
        cfg, **dict(kw, device="cpu", batch_size=2, timeout=30.0)))
    want, churn, latch = smoke.phase_train_churn(0, "CPU")
    text = "\n".join(lines)
    # 47 passes of arm (a), 14 of arm (b), 2 layers of "tiny"; each codec
    # kernel 2 launches per bucket op of the 6 committed steps with a peer
    assert churn["passes"] == 47 and latch["passes"] == 14
    buckets = len(latch["lives"][0][0].buckets)
    assert want == {**dict.fromkeys(smoke.FLASH_KERNELS, 2 * 61),
                    "quant_int8": 2 * buckets * 6,
                    "dequant_acc_int8": 2 * buckets * 6}
    assert [(k["group"], k["death_step"], k["heal_step"])
            for k in churn["kills"]] == [(1, 2, 4), (3, 4, 6), (1, 6, 8)]
    assert text.count("kill of group") == 3
    assert "kill of group 1 life 1 after step 6 (scheduled at 6)" in text
    assert "(step 8); first commit" in text and "GB/s (CPU)" in text
    assert "group 1: committed life 0 1-2, life 1 4-6, life 2 8-10" in text
    assert "group 3: committed life 0 1-4, life 1 6-10" in text
    assert "before the first kill" in text
    assert ("latch: group 0 latched its wire at the start of step 4" in text
            and "commits after the latch {0: 3, 1: 3}" in text)
    assert latch["latch"]["comm_epoch"] >= 1
    assert "steps committed by two lives or more: [1, 2, 3, 4, 5, 6, 7, " \
        "8, 9, 10]" in text
    # no device memory lines on the CPU
    assert "GB at the kill's last commit" not in text


# --------------------------------------------------------- dryrun_multichip


def test_dryrun_launches_at_8() -> None:
    # 2 layers of "tiny": the sharded step and the MoE transformer one
    # attention a layer per position (8) and their unsharded models one a
    # layer; the causal ring of 8 its 36 pairs a layer
    want = _smoke().dryrun_launches(8)
    per = {"step": 18, "ring": 74, "moe": 18, "vocab": 0, "pipeline": 0,
           "ft": 0}
    assert want == {k: dict.fromkeys(flash.LAUNCHES, v)
                    for k, v in per.items()}


def test_dryrun_multichip_phase_runs_on_the_cpu(monkeypatch) -> None:
    # the phase at 2 positions on the CPU with "125m" cut to "tiny": every
    # segment held against its counterpart, entry()'s logits against
    # reference_attention, the launches (none off the card); the FT loop
    # runs whole in tests/test_torch_graft_entry.py
    import torchft_tpu_torch.graft_entry as graft
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    monkeypatch.setattr(graft, "_dryrun_ft_loop", lambda n, dev: {
        "trace": "stub"})
    per_d = smoke.phase_dryrun_multichip(0, "CPU", n=2, device="cpu")
    text = "\n".join(lines)
    assert per_d == {16: dict.fromkeys(flash.LAUNCHES, 0)}
    for name in ("step", "vocab", "ring", "moe", "pipeline", "ft"):
        assert f"segment {name}:" in text
    assert "entry(): logits (4, 128, 512) torch.float32" in text


def test_the_depth_cuts_that_keep_the_script_under_900_s() -> None:
    # train_sharded, train_diloco_sharded, train_localsgd_int8,
    # train_hier_int8 and train_durable at "125m"'s width and 6 of its
    # layers, train_moe and train_moe_expert at "moe-8x125m"'s and 6 of
    # its, train_hsdp at "1b"'s and 6 of its 24; a config already that
    # shallow ("tiny", as the CPU runs of the phases use) is left
    from torchft_tpu_torch.models import MOE_CONFIGS, moe_param_shapes

    smoke = _smoke()
    assert smoke.CUT_LAYERS == 6
    cut = smoke.cut_depth(CONFIGS["125m"])
    assert cut == dataclasses.replace(CONFIGS["125m"], n_layers=6)
    n = sum(p.numel() for p in GPT(cut, device="meta").parameters())
    assert n == 93605376
    assert smoke.durable_disk_bytes(n) == 6739587072
    moe = smoke.cut_depth(MOE_CONFIGS["moe-8x125m"])
    assert moe.n_layers == 6 and moe.d_model == 768
    assert sum(math.prod(s) for s in moe_param_shapes(moe).values()) \
        == 192714240
    assert smoke.cut_depth(CONFIGS["tiny"], 6) == CONFIGS["tiny"]


TOPO = """\tGPU0\tGPU1\tGPU2\tGPU3\tCPU Affinity\tNUMA Affinity
GPU0\t X \tNV18\tNV18\tSYS\t0-31\t0
GPU1\tNV18\t X \tNV18\tNV18\t0-31\t0
GPU2\tNV18\tNV18\t X \tNV18\t32-63\t1
GPU3\tSYS\tNV18\tNV18\t X \t32-63\t1

Legend:
  X    = Self
  NV#  = Connection traversing a bonded set of # NVLinks
"""


def test_topo_links_read_the_matrix() -> None:
    links = _smoke().topo_links(TOPO)
    assert links[(0, 1)] == links[(2, 3)] == "NV18"
    assert links[(0, 3)] == links[(3, 0)] == "SYS"
    assert links[(1, 1)] == "X" and len(links) == 16
    assert _smoke().topo_links("Failed to run topology matrix\n") == {}


def test_layout_lines_name_cards_positions_and_links(monkeypatch) -> None:
    # the line each of train_cuda_int8, train_localsgd_int8 and
    # dryrun_multichip prints first: on one card its positions; over cards,
    # the cycled positions on each and topo -m's link (or what it said when
    # it could not read the matrix) beside CUDA's peer access
    smoke = _smoke()
    cards = [torch.device("cuda", i) for i in range(3)]
    assert smoke.cycled(cards, 8) == cards * 2 + cards[:2]
    one = smoke.layout_line(smoke.cycled(cards[:1], 8))
    assert one == ("layout: 8 positions over 1 card(s): cuda:0 x8; no link "
                   "crossed")
    said = {"out": TOPO, "rc": 0}
    monkeypatch.setattr(smoke.subprocess, "run", lambda *a, **k: (
        subprocess.CompletedProcess(a, said["rc"], said["out"], "")))
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (0, 2))
    line = smoke.layout_line(smoke.cycled(cards, 4))
    assert line == (
        "layout: 4 positions over 3 card(s): cuda:0 x2, cuda:1 x1, cuda:2 "
        "x1; links cuda:0-cuda:1 NV18 (peer access yes), cuda:0-cuda:2 NV18 "
        "(peer access no), cuda:1-cuda:2 NV18 (peer access yes)")
    said.update(out="Failed to run topology matrix\n", rc=255)
    line = smoke.layout_line(cards[:2])
    assert line.endswith("links cuda:0-cuda:1 unknown (peer access yes); "
                         "nvidia-smi topo -m: Failed to run topology matrix")


def test_codec_launches_per_op_on_one_card_and_over_cards() -> None:
    smoke = _smoke()
    cards = [torch.device("cuda", i) for i in range(4)]
    # one card: phase 1 over all rows, phase 2 over all shards
    assert smoke.codec_launches(2, [cards[0]] * 2) == 2
    assert smoke.codec_launches(4, [cards[0]] * 4) == 2
    # over cards: one a card and one a shard
    assert smoke.codec_launches(2, cards[:2]) == 4
    assert smoke.codec_launches(4, smoke.cycled(cards[:2], 4)) == 6
    assert smoke.codec_launches(4, cards) == 8


def test_localsgd_phase_runs_over_two_cpu_cards(monkeypatch) -> None:
    # the phase laid over two "cards" (cpu:0 and cpu:1: the plane's
    # cross-card path on the host), its drill at "tiny": the schedule
    # checks, the CPU plane check and the codec count over cards
    import torchft_tpu_torch.examples.train_diloco as example
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    drill = example.run_diloco_drill
    monkeypatch.setattr(example, "run_diloco_drill", lambda cfg, **kw: drill(
        cfg, **dict(kw, batch_size=2, timeout=30.0)))
    cards = [torch.device("cpu", 0), torch.device("cpu", 1)]
    want, codec, result = smoke.phase_train_localsgd_int8(0, "CPU",
                                                          devices=cards)
    assert codec == 2 * 3 * (4 + 2)
    assert result["checked_rounds"] == {1: 4, 2: 3, 3: 4}
    text = "\n".join(lines)
    assert "x 6 launches = 36 of each codec kernel" in text
    assert text.count("card plane vs CPU plane bitwise ok") == 2


def test_dryrun_phase_over_a_device_list_compares_the_virtual_mesh(
        monkeypatch) -> None:
    # laid over a device list the phase also runs the virtual mesh, logs
    # both runs' seconds per segment and whether the figures agree, and
    # leaves that comparison's launches out of the count
    import torchft_tpu_torch.graft_entry as graft
    import torchft_tpu_torch.models as models

    smoke = _smoke()
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setitem(models.CONFIGS, "125m", CONFIGS["tiny"])
    monkeypatch.setattr(graft, "_dryrun_ft_loop", lambda n, dev: {
        "trace": "stub"})
    before = dict(flash.LAUNCHES)
    smoke.phase_dryrun_multichip(0, "CPU", n=2, device="cpu",
                                 devices=["cpu"])
    text = "\n".join(lines)
    assert "over 1 cards / virtual on cpu, seconds: step " in text
    assert "figures but ft's equal: yes" in text
    assert flash.LAUNCHES == before
