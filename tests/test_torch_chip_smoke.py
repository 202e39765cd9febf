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
checks failing a drill whose counter or recorded step is wrong.
"""

import importlib.util
import os
import subprocess
import sys

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
        assert sum(1 for _, shape, t in shapes if t and shape[3] == d) == 1
    for name in ("tiny", "125m", "1b"):
        cfg = CONFIGS[name]
        assert (name, (8 if name != "1b" else 1, cfg.max_seq_len,
                       cfg.n_heads, cfg.head_dim)) in \
            {(w, shape) for w, shape, _ in shapes}
    assert smoke.PHASES == ("kernels", "train", "train_multijob",
                            "train_sharded", "train_moe", "train_cuda_int8",
                            "train_tiny", "gpt_1b",
                            "train_diloco", "train_diloco_sharded",
                            "train_localsgd_int8", "train_hier_int8",
                            "train_durable")
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
    assert smoke.PHASES.index("train_hier_int8") == len(smoke.PHASES) - 2


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
    # the A/B arms: 2 arms x 2 launches x 15 DDP buckets x 3 steps; the
    # card plane's sharded arm: one native scatter a step with a peer
    assert smoke.sharded_expected_launches(15) == {"ab": 180, "sharded": 3}
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
    # (b) 3 x 7 - 1 drill passes, 3 x 3 replicated; (a) 2 x 2 x 3; (c) 2 x 3
    assert flash_launches == CONFIGS["tiny"].n_layers * (20 + 9 + 12 + 6)
    # "tiny" has one DDP bucket: 2 x 2 x 1 x 3, then 3 sharded scatters
    assert codec == 12 + 3
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
    # per rank: group 0 at 1-7, group 1 at 2-3 and 5-7
    assert (passes, layers) == (2 * (7 + 2 + 3), 2)
    text = "\n".join(lines)
    assert "every live rank bitwise equal" in text
    assert "heal of group 1 rank 0 at step 5" in text
    assert "heal of group 1 rank 1 at step 5" in text
    assert "bytes served in that heal by group 0's ranks: rank 0" in text
    assert "group 1 rank 1: phase p50 ms" in text
