"""The port's invariant lint suite: every checker must (a) catch its
seeded violation fixture and (b) pass clean on the port's tree.

Twin of tests/test_analysis.py over ``torchft_tpu_torch.analysis``: the
same fixtures at the port's paths (a use-after-donate snippet, a
re-defined blessed function, an undocumented gauge, a forbidden import),
plus the port's own tables (the named layer edges, the names only the port
emits). The last tests run the whole suite over the shipped tree, and the
runner (``python -m torchft_tpu_torch.analysis``) in a fresh interpreter
where importing torch, JAX or the JAX package fails.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from torchft_tpu_torch.analysis import (
    donation,
    layering,
    name_registry,
    one_definition,
    run_all,
)
from torchft_tpu_torch.analysis.base import Source

pytestmark = pytest.mark.analysis

REPO = Path(__file__).resolve().parent.parent


def src(rel: str, text: str) -> Source:
    return Source(rel, text)


# ---------------------------------------------------------------- donation


def test_donation_catches_use_after_donate():
    bad = src("torchft_tpu_torch/fix.py", """
def step(mgr, bufs, extra):
    w = mgr.allreduce_arrays(bufs)
    total = bufs.sum()          # <- read while donated
    out = w.wait()
    return out, total
""")
    findings = donation.check([bad])
    assert len(findings) == 1
    assert findings[0].line == 4
    assert "use-after-donate" in findings[0].message
    assert "'bufs'" in findings[0].message


def test_donation_catches_reduce_scatter_and_list_args():
    bad = src("torchft_tpu_torch/fix.py", """
def step(mgr, a, b):
    w = mgr.reduce_scatter_arrays([a, b], owners=[0, 1])
    peek = a[0]                 # <- read while donated
    return w.wait(), peek
""")
    findings = donation.check([bad])
    assert len(findings) == 1
    assert "'a'" in findings[0].message


def test_donation_resolution_inside_lambda_does_not_count():
    # a w.wait() that exists only in a not-yet-run lambda/def body must
    # NOT lift the embargo for reads in the enclosing scope
    bad = src("torchft_tpu_torch/fix.py", """
def step(mgr, bufs):
    w = mgr.allreduce_arrays(bufs)
    cleanup = lambda: w.wait()
    total = bufs.sum()          # <- still donated: lambda has not run
    return w.wait(), total, cleanup
""")
    findings = donation.check([bad])
    assert len(findings) == 1
    assert findings[0].line == 5
    assert "'bufs'" in findings[0].message


def test_donation_clean_patterns():
    ok = src("torchft_tpu_torch/fix.py", """
def after_wait(mgr, bufs):
    w = mgr.allreduce_arrays(bufs)
    out = w.wait()
    return bufs[0] + out[0]     # resolved: legal

def rebind(mgr, bufs):
    w = mgr.allreduce_arrays(bufs)
    bufs = [x * 0 for x in range(3)]   # rebound: legal
    return w.wait(), bufs

def continuation(mgr, arena):
    w = mgr.allreduce_arrays([arena])
    def _land(f):
        return arena.copy()     # nested def: runs post-resolve
    w.add_done_callback(_land)

def result_path(mgr, bufs):
    w = mgr.allreduce_arrays(bufs)
    out = w.future().result()
    return bufs, out
""")
    assert donation.check([ok]) == []


def test_donation_branch_rebind_is_not_a_read():
    # a rebind inside a branch makes the read after it legal — both
    # within the branch and after the join (path-join intersection)
    ok = src("torchft_tpu_torch/fix.py", """
def step(mgr, buf, err, alloc):
    w = mgr.allreduce_arrays([buf])
    if err:
        buf = alloc()
        y = buf + 1
    z = buf
    return w.wait(), z
""")
    assert donation.check([ok]) == []


def test_donation_read_inside_branch_still_flagged():
    bad = src("torchft_tpu_torch/fix.py", """
def step(mgr, buf, cond):
    w = mgr.allreduce_arrays([buf])
    if cond:
        y = buf + 1             # <- donated on this path
    return w.wait(), y
""")
    findings = donation.check([bad])
    assert len(findings) == 1
    assert findings[0].line == 5


# ----------------------------------------------------------- one-definition


def test_one_definition_catches_redefinition():
    bad = src("torchft_tpu_torch/somewhere.py", """
def codec_roundtrip(codec, chunk_bytes, src, out):
    out[:] = src  # drifting copy

def _grid_step(size, chunk_bytes, itemsize=4):
    return chunk_bytes // itemsize  # the device grid, copied
""")
    findings = one_definition.check([bad])
    assert len(findings) == 2
    assert "codec_roundtrip" in findings[0].message
    assert "comm/transport.py" in findings[0].message
    assert "_grid_step" in findings[1].message
    assert "comm/cuda_backend.py" in findings[1].message


def test_one_definition_allows_blessed_module():
    ok = src("torchft_tpu_torch/comm/transport.py", """
def codec_roundtrip(codec, chunk_bytes, src, out):
    pass
""")
    assert one_definition.check([ok]) == []


def test_one_definition_catches_inline_ef_gate():
    bad = src("torchft_tpu_torch/local_sgd.py", """
def gate(mgr):
    lossy = getattr(mgr, "wire_is_lossy", None)
    return callable(lossy) and lossy()
""")
    findings = one_definition.check([bad])
    assert findings, "inline wire_is_lossy consultation must be flagged"
    assert all("_ef_gate" in f.message for f in findings)


def test_one_definition_provider_defs_are_exempt():
    ok = src("torchft_tpu_torch/fancy_backend.py", """
class Ctx:
    def wire_compensable(self):
        return self._inner.wire_compensable()
""")
    assert one_definition.check([ok]) == []


def test_one_definition_attribute_store_is_a_definition_not_a_use():
    ok = src("torchft_tpu_torch/fancy_backend.py", """
class Ctx:
    def __init__(self, impl):
        self.wire_compensable = impl   # providing, not consulting
""")
    assert one_definition.check([ok]) == []


# ------------------------------------------------------------ name-registry


DOCS = """
## 6. Metrics & events reference

**Counters**

| Name | Producer | Meaning |
|---|---|---|
| `good_counter` | x.py | fine |
| `ghost_counter` | x.py | documented but never emitted |

**Spans**

| Name | Producer | Meaning |
|---|---|---|
| `lane_l{i}_wire` | x.py | per-lane pattern |

**Gauges**

| Name | Producer | Meaning |
|---|---|---|

**Lifecycle events**

| Kind | Producer | Meaning |
|---|---|---|
| `thing_done` | x.py | fine |

## 7. Next section
"""

EVENTS_PY = src(
    "torchft_tpu_torch/utils/events.py",
    'EVENT_KINDS = ("thing_done",)\n',
)


def test_name_registry_catches_undocumented_and_ghost():
    code = src("torchft_tpu_torch/x.py", """
def f(metrics, tag):
    metrics.incr("good_counter")
    metrics.gauge("mystery_gauge", 1.0)   # <- undocumented
    metrics.observe(f"{tag}_wire", 0.1)   # matches lane_l{i}_wire
""")
    findings = name_registry.check([code, EVENTS_PY], docs_text=DOCS,
                                   port_only={}, reference_only={})
    msgs = "\n".join(f.message for f in findings)
    assert "mystery_gauge" in msgs
    assert "ghost_counter" in msgs
    assert "good_counter" not in msgs
    assert "_wire'" not in msgs  # pattern matched the doc placeholder


def test_name_registry_tables_apply_to_the_real_docs_only():
    # the port's own tables describe docs/operations.md: a check over a
    # fixture's docs text reports the fixture alone, as the reference's
    # check does (tests/test_analysis.py runs the same case), and a check
    # over a tree that lacks one of their names still reports it
    code = src("torchft_tpu_torch/x.py", """
def f(ev, metrics):
    metrics.incr("good_counter")
    metrics.observe("lane_l0_wire", 0.1)
    ev.emit("thing_done")
""")
    msgs = [f.message for f in name_registry.check([code, EVENTS_PY],
                                                   docs_text=DOCS)]
    assert msgs and all("ghost_counter" in m for m in msgs), msgs
    assert not any("serve_answer" in m or "comm_striped_ops" in m
                   for m in msgs)
    root = Path(__file__).resolve().parents[1]
    real = name_registry.check([code, EVENTS_PY], root=root)
    assert any("serve_answer" in f.message for f in real)


def test_name_registry_catches_unknown_event_kind():
    code = src("torchft_tpu_torch/x.py", """
def f(ev, metrics):
    metrics.incr("good_counter")
    metrics.observe("lane_l0_wire", 0.1)
    ev.emit("thing_done")
    ev.emit("thing_exploded")   # <- not in EVENT_KINDS nor docs
""")
    findings = name_registry.check([code, EVENTS_PY], docs_text=DOCS,
                                   port_only={}, reference_only={})
    msgs = "\n".join(f.message for f in findings)
    assert msgs.count("thing_exploded") == 2  # kinds + docs directions
    # remove ghost_counter noise from the assertion: it is expected
    assert all(
        "thing_exploded" in f.message or "ghost_counter" in f.message
        for f in findings
    )


def test_name_registry_control_counters_checked_against_native():
    docs = DOCS.replace(
        "**Lifecycle events**",
        """**Lighthouse control counters**

| Name | Meaning |
|---|---|
| `present_ctr` | exists in native |
| `absent_ctr` | missing from native |

**Lifecycle events**""",
    )
    code = src("torchft_tpu_torch/x.py", """
def f(metrics, ev):
    metrics.incr("good_counter")
    metrics.observe("lane_l0_wire", 0.1)
    ev.emit("thing_done")
""")
    findings = name_registry.check(
        [code, EVENTS_PY], docs_text=docs,
        native_text='ctl["present_ctr"] = 1;', port_only={},
        reference_only={},
    )
    msgs = "\n".join(f.message for f in findings)
    assert "absent_ctr" in msgs
    assert "present_ctr" not in msgs


# ---------------------------------------------------------------- layering


def test_layering_catches_utils_importing_comm():
    bad = src("torchft_tpu_torch/utils/helper.py",
              "from torchft_tpu_torch.comm.context import Work\n")
    findings = layering.check([bad])
    assert len(findings) == 1
    assert "'utils'" in findings[0].message


def test_layering_catches_comm_importing_manager():
    for stmt in (
        "from torchft_tpu_torch.manager import Manager\n",
        "import torchft_tpu_torch.manager\n",
        "from ..manager import Manager\n",  # relative form
    ):
        bad = src("torchft_tpu_torch/comm/newplane.py", stmt)
        findings = layering.check([bad])
        assert findings, f"must flag: {stmt!r}"
        assert "manager" in findings[0].message


def test_layering_allows_sanctioned_imports():
    ok = [
        src("torchft_tpu_torch/comm/newplane.py",
            "from .context import Work\n"
            "from torchft_tpu_torch.utils.metrics import Metrics\n"
            "from torchft_tpu_torch.futures import future_chain\n"),
        src("torchft_tpu_torch/utils/tidy.py", "import os\nimport threading\n"),
        src("torchft_tpu_torch/manager.py",  # orchestration: unconstrained
            "from torchft_tpu_torch.comm.transport import TcpCommContext\n"),
    ]
    assert layering.check(ok) == []


def test_layering_function_scoped_imports_count():
    bad = src("torchft_tpu_torch/utils/helper.py", """
def lazy():
    from torchft_tpu_torch.comm.context import Work
    return Work
""")
    assert layering.check([bad])


# ------------------------------------------------------------- the real tree


def test_layering_named_edges_are_single_modules():
    ok = [
        src("torchft_tpu_torch/utils/crc32c.py",
            "from torchft_tpu_torch.control._native import get_lib\n"),
        src("torchft_tpu_torch/comm/cuda_backend.py",
            "from torchft_tpu_torch.ops.quant import quant_int8\n"
            "def f():\n"
            "    from torchft_tpu_torch.parallel.mesh import Mesh\n"),
    ]
    assert layering.check(ok) == []
    bad = [
        src("torchft_tpu_torch/utils/crc32c.py",
            "from torchft_tpu_torch.control import Lighthouse\n"),
        src("torchft_tpu_torch/comm/cuda_backend.py",
            "from torchft_tpu_torch.parallel.sharding import ShardedTensor\n"),
        src("torchft_tpu_torch/comm/cuda_backend.py",
            "from torchft_tpu_torch.optim import apply_updates\n"),
        src("torchft_tpu_torch/ops/xent.py",
            "from torchft_tpu_torch.parallel.sharding import PartitionSpec\n"),
        src("torchft_tpu_torch/serve.py",
            "from torchft_tpu_torch.manager import Manager\n"),
        src("torchft_tpu_torch/analysis/base.py", "import torchft_tpu_torch\n"),
    ]
    findings = layering.check(bad)
    assert [f.path for f in findings] == [b.rel for b in bad]


def test_name_registry_port_only_table():
    # a port-only name counts as documented, must be emitted, and must not
    # also be in the docs
    code = src("torchft_tpu_torch/x.py", """
def f(metrics, ev):
    metrics.incr("good_counter")
    metrics.observe("lane_l0_wire", 0.1)
    metrics.observe("serve_answer", 0.1)
    ev.emit("thing_done")
""")
    docs = DOCS.replace("| `ghost_counter` | x.py | documented but never "
                        "emitted |\n", "")
    findings = name_registry.check(
        [code, EVENTS_PY], docs_text=docs,
        port_only={"serve_answer": "emitted", "stale_port_name": "gone"},
        reference_only={})
    msgs = [f.message for f in findings]
    assert len(msgs) == 1 and "stale_port_name" in msgs[0], msgs
    findings = name_registry.check(
        [code, EVENTS_PY], docs_text=docs,
        port_only={"serve_answer": "x", "good_counter": "dup"},
        reference_only={})
    msgs = [f.message for f in findings]
    assert len(msgs) == 1 and "good_counter" in msgs[0], msgs
    # without the table, the port's own name is undocumented
    msgs = [f.message for f in name_registry.check(
        [code, EVENTS_PY], docs_text=docs, port_only={}, reference_only={})]
    assert len(msgs) == 1 and "serve_answer" in msgs[0], msgs


def test_name_registry_reference_only_table():
    # a documented name the port does not emit is admitted by the table;
    # the table itself must name documented, unemitted names
    code = src("torchft_tpu_torch/x.py", """
def f(metrics, ev):
    metrics.incr("good_counter")
    metrics.observe("lane_l0_wire", 0.1)
    ev.emit("thing_done")
""")
    assert name_registry.check(
        [code, EVENTS_PY], docs_text=DOCS, port_only={},
        reference_only={"ghost_counter": "the port counts it elsewhere"},
    ) == []
    msgs = [f.message for f in name_registry.check(
        [code, EVENTS_PY], docs_text=DOCS, port_only={},
        reference_only={"ghost_counter": "x", "good_counter": "emitted",
                        "never_documented": "x"})]
    assert len(msgs) == 2, msgs
    assert any("'good_counter' is emitted" in m for m in msgs)
    assert any("'never_documented' is not documented" in m for m in msgs)
    # the port's table names the three documented wire series it leaves
    assert set(name_registry.REFERENCE_ONLY_METRICS) == {
        "comm_l{i}_wire_reduce", "comm_reduce_future", "comm_striped_ops"}

def test_port_event_kinds_are_the_reference_vocabulary():
    from torchft_tpu_torch.utils import events

    tree = run_all(REPO, only=["name-registry"])
    assert tree == [], [f.render() for f in tree]
    src_ = Source.from_file(REPO, REPO / "torchft_tpu_torch/utils/events.py")
    assert name_registry.extract_event_kinds(src_) == set(events.EVENT_KINDS)


def test_real_tree_is_clean():
    findings = run_all(REPO)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_runner_loads_without_torch_and_exits_clean():
    code = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "torchft_tpu"):
            raise ImportError("forbidden import: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["analysis"]
try:
    runpy.run_module("torchft_tpu_torch.analysis", run_name="__main__")
except SystemExit as e:
    print("exit", e.code, "torch" in sys.modules)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "clean (donation, layering, name-registry, one-definition)" \
        in r.stdout
    assert r.stdout.split()[-2:] == ["0", "False"], r.stdout


def test_runner_reports_findings_with_exit_1(tmp_path):
    pkg = tmp_path / "torchft_tpu_torch" / "utils"
    pkg.mkdir(parents=True)
    (pkg / "helper.py").write_text(
        "from torchft_tpu_torch.comm.context import Work\n")
    r = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.analysis", "layering",
         "--root", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "torchft_tpu_torch/utils/helper.py:1: [layering]" in r.stdout
