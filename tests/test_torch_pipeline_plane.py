"""The port's MPMD pipeline plane (``torchft_tpu_torch/pipeline.py``).

Twins of every test of ``tests/test_pipeline_plane.py`` at the
reference's sizes, on the CPU (``PipelineConfig(device="cpu")``):
schedule projection and bubble math; the bitwise oracle (pipelined 1F1B
sha256-equal to stage-serial GPipe at every step, for the codecs none,
bf16 and int8 with error feedback); 1F1B's bounded in-flight count; a
stage-replica kill healed without draining at the planner's lower bound
against the drain baseline's full tree; rebalancing, minimal and bitwise
invisible; the schedule and the kill -> heal -> resume lifecycle
reconstructed from the ``/telemetry/events`` endpoints alone; the stage
surface of ``Manager`` and ``WireStubManager``; the config's validation.

Then the contract with the reference: ``codec_encode_frame`` gives the
reference's bytes for the same arrays (none, bf16, fp16, int8), a port
frame parses with the reference's header and decodes with its
``codec_decode_frame`` and the reverse, and after 3 steps on the same seed
the port's plane holds the reference's parameters within f32 tolerance
(rtol 1e-5, atol 1e-6 at codec none; atol 1e-4 on a lossy wire, where a
value one ulp apart can round to the next bf16 or int8 step), for each
codec. Across packages torch's and numpy's BLAS may round products
differently, so the frames are compared byte for byte only for the same
arrays.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import torchft_tpu.pipeline as ref_plane
from torchft_tpu.comm import transport as ref_transport
from torchft_tpu_torch import pipeline as P
from torchft_tpu_torch.comm import transport
from torchft_tpu_torch.pipeline import (
    Pipeline,
    PipelineConfig,
    expected_stage_sequence,
    reconstruct_pipe_schedule,
    stage_bubble_slots,
)

CODECS = [("none", False), ("bf16", False), ("int8", True)]


def _cfg(**kw) -> PipelineConfig:
    kw.setdefault("step_timeout", 60.0)
    return PipelineConfig(device="cpu", **kw)


def _fetch(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


def _snap_sum(pipe: Pipeline, name: str) -> float:
    return sum(s.get(name, 0.0) for s in pipe.metrics_snapshots().values())


# ----------------------------------------------------------- pure schedule


def test_expected_stage_sequence_projects_the_global_schedule():
    assert expected_stage_sequence(2, 4, 0) == [
        ("F", 0), ("F", 1), ("B", 0), ("F", 2),
        ("B", 1), ("F", 3), ("B", 2), ("B", 3),
    ]
    assert expected_stage_sequence(2, 4, 1) == [
        ("F", 0), ("B", 0), ("F", 1), ("B", 1),
        ("F", 2), ("B", 2), ("F", 3), ("B", 3),
    ]
    phases = [p for p, _ in expected_stage_sequence(2, 4, 0,
                                                    streaming=False)]
    assert phases == ["F"] * 4 + ["B"] * 4
    for streaming in (True, False):
        for stage in range(3):
            seq = expected_stage_sequence(3, 5, stage, streaming=streaming)
            assert sorted(m for p, m in seq if p == "F") == list(range(5))
            assert sorted(m for p, m in seq if p == "B") == list(range(5))
            assert seq == ref_plane.expected_stage_sequence(
                3, 5, stage, streaming=streaming)


def test_stage_bubble_slots_match_the_analytic_count():
    for streaming in (True, False):
        for s_count, m in ((2, 4), (3, 6), (4, 4)):
            idle, ticks = stage_bubble_slots(s_count, m, streaming=streaming)
            assert ticks == 2 * (s_count - 1) + 2 * m
            assert idle == 2 * (s_count - 1)
            assert (idle, ticks) == ref_plane.stage_bubble_slots(
                s_count, m, streaming=streaming)


# --------------------------------------------------------- bitwise oracle


@pytest.mark.parametrize("codec,ef", CODECS)
def test_pipelined_bitwise_identical_to_stage_serial(codec, ef):
    """Both arms push their frames through the same codec (and EF
    residuals on the gradient hop), so the trajectories stay identical to
    each other. Codec none at the reference's 2 stages and 4 microbatches
    (1F1B holds S in flight, GPipe M); the lossy wires at 3 stages of
    (8,) * 7."""
    shape = (dict(num_stages=2) if codec == "none"
             else dict(num_stages=3, layer_dims=(8,) * 7))
    hashes = {}
    for streaming in (True, False):
        pipe = Pipeline(_cfg(replicas=1, microbatches=4, codec=codec,
                             error_feedback=ef, streaming=streaming,
                             **shape))
        try:
            traj = []
            for _ in range(3):
                r = pipe.run_step()
                assert not r["aborted"] and not r["killed"]
                traj.append(pipe.global_param_hash())
            hashes[streaming] = traj
            peak = r["inflight_peak"]
        finally:
            pipe.close()
        if codec == "none":
            assert peak == (2 if streaming else 4)
    assert hashes[True] == hashes[False]


def test_multi_replica_lanes_commit_one_stage_hash():
    trajs = []
    for _ in range(2):
        pipe = Pipeline(_cfg(num_stages=2, replicas=2, microbatches=4))
        try:
            traj = []
            for _ in range(2):
                r = pipe.run_step()
                assert not r["aborted"] and not r["killed"]
                for stage in range(2):
                    assert len({h for (s, _), h in r["hashes"].items()
                                if s == stage}) == 1
                traj.append(pipe.global_param_hash())
            trajs.append(traj)
        finally:
            pipe.close()
    assert trajs[0] == trajs[1]


# ------------------------------------------------------------ kill arms


def test_stage_kill_heals_without_draining():
    pipe = Pipeline(_cfg(num_stages=2, replicas=2, microbatches=4,
                         on_kill="heal"))
    try:
        pipe.run_step()
        pipe.schedule_kill(1, 1, after_actions=2)
        r = pipe.run_step()
        assert r["killed"] == [(1, 1)]
        assert not r["aborted"]
        assert _snap_sum(pipe, "pipe_drained_steps") == 0
        assert _snap_sum(pipe, "pipe_replay_microbatches") > 0
        info = pipe.heal(1, 1)
        assert info["moved_bytes"] == info["lower_bound_bytes"]
        assert info["moved_bytes"] == pipe.stage_param_bytes(1)
        assert info["moved_bytes"] < pipe.total_param_bytes()
        r2 = pipe.run_step()
        assert not r2["aborted"] and not r2["killed"]
        assert len({h for (s, _), h in r2["hashes"].items() if s == 1}) == 1
        assert _snap_sum(pipe, "pipe_drained_steps") == 0
    finally:
        pipe.close()


def test_stage_kill_drain_baseline_pays_full_tree():
    pipe = Pipeline(_cfg(num_stages=2, replicas=2, microbatches=4,
                         on_kill="drain"))
    try:
        pipe.run_step()
        pipe.schedule_kill(1, 1, after_actions=2)
        r = pipe.run_step()
        assert r["killed"] == [(1, 1)]
        assert not r["aborted"]
        assert _snap_sum(pipe, "pipe_drained_steps") >= 3
        moved = _snap_sum(pipe, "redist_moved_bytes")
        assert moved == pipe.total_param_bytes()
        assert moved > pipe.stage_param_bytes(1)
    finally:
        pipe.close()


# ------------------------------------------------------------- rebalance


def test_rebalance_is_minimal_and_bitwise_transparent():
    cfg = _cfg(num_stages=2, replicas=1, microbatches=4, layer_dims=(8,) * 5)
    control, moved = Pipeline(cfg), Pipeline(cfg)
    try:
        control.run_step()
        moved.run_step()
        before = moved.global_param_hash()
        info = moved.rebalance([[0, 1, 2], [3]])
        assert info["moved_bytes"] == info["lower_bound_bytes"] > 0
        assert moved.stage_layers == [[0, 1, 2], [3]]
        assert moved.global_param_hash() == before
        for _ in range(2):
            control.run_step()
            moved.run_step()
            assert moved.global_param_hash() == control.global_param_hash()
    finally:
        control.close()
        moved.close()


def test_rebalance_plan_cache_hits_on_reversal():
    pipe = Pipeline(_cfg(num_stages=2, replicas=1, microbatches=4,
                         layer_dims=(8,) * 5))
    try:
        a = pipe.rebalance([[0, 1, 2], [3]])
        assert a["cache_hit"] is False
        pipe.rebalance([[0, 1], [2, 3]])
        b = pipe.rebalance([[0, 1, 2], [3]])
        assert b["cache_hit"] is True
        assert b["moved_bytes"] == a["moved_bytes"]
    finally:
        pipe.close()


# ------------------------------------- flight recorder over real HTTP


def _server(rep):
    from torchft_tpu_torch.checkpointing import CheckpointServer

    srv = CheckpointServer(timeout=10.0)
    srv.set_metrics(rep.metrics)
    srv.set_events(rep.events)
    return srv


def test_schedule_reconstructed_from_telemetry_http_alone():
    pipe = Pipeline(_cfg(num_stages=2, replicas=1, microbatches=4))
    servers = []
    try:
        for _, rep in sorted(pipe.replicas.items()):
            servers.append(_server(rep))
        pipe.run_step()
        pipe.run_step()
        dumps = [_fetch(srv.metadata() + "/telemetry/events?since=0")
                 for srv in servers]
        rec = reconstruct_pipe_schedule(dumps)
        assert sorted(rec) == [0, 1]
        for step in (0, 1):
            for stage in range(2):
                assert rec[step][stage] == expected_stage_sequence(2, 4,
                                                                   stage)
        for srv in servers:
            m = _fetch(srv.metadata() + "/telemetry/metrics")["metrics"]
            for key in ("pipe_inflight", "pipe_stage_index",
                        "pipe_stage_count", "pipe_bubble_steps",
                        "pipe_sched_ticks"):
                assert np.isfinite(float(m[key]))
    finally:
        for srv in servers:
            srv.shutdown()
        pipe.close()


def test_stage_kill_lifecycle_reconstructed_from_telemetry_http():
    pipe = Pipeline(_cfg(num_stages=2, replicas=2, microbatches=4,
                         on_kill="heal"))
    servers = {}
    try:
        for key in sorted(pipe.replicas):
            servers[key] = _server(pipe.replicas[key])
        pipe.run_step()
        pipe.schedule_kill(1, 1, after_actions=2)
        r = pipe.run_step()
        assert r["killed"] == [(1, 1)] and not r["aborted"]
        info = pipe.heal(1, 1)
        # the healed replica is new: a new endpoint, the old one keeps
        # serving the pre-kill recorder
        servers[("healed", 1, 1)] = _server(pipe.replicas[(1, 1)])
        r2 = pipe.run_step()
        assert not r2["aborted"] and not r2["killed"]
        dumps = [_fetch(srv.metadata() + "/telemetry/events?since=0")
                 for srv in servers.values()]
        evs = [e for d in dumps for e in d["events"]]
        kinds = [e["kind"] for e in evs]
        assert any(e.get("stage") == 1 and e.get("replica") == 1
                   for e in evs if e["kind"] == "member_dead")
        assert "step_discard" not in kinds
        commits = {}
        for e in evs:
            if e["kind"] == "step_commit":
                commits[e["step"]] = commits.get(e["step"], 0) + 1
        assert commits[1] == 3 and commits[2] == 4
        assert any(e["kind"] == "microbatch_send" and e.get("replay")
                   for e in evs)
        done = [e for e in evs if e["kind"] == "heal_done"]
        assert len(done) == 1
        assert done[0]["moved_bytes"] == done[0]["lower_bound_bytes"] \
            == info["moved_bytes"]
        assert done[0]["full_tree"] is False
    finally:
        for srv in servers.values():
            srv.shutdown()
        pipe.close()


# ------------------------------------------------- manager surface parity


def test_manager_and_stub_share_the_stage_surface():
    from torchft_tpu_torch.comm.context import DummyCommContext
    from torchft_tpu_torch.comm.wire_stub import WireStubManager
    from torchft_tpu_torch.manager import Manager

    for cls in (Manager, WireStubManager):
        for name in ("bind_stage", "stage_index", "stage_count"):
            assert callable(getattr(cls, name)), (cls, name)
    stub = WireStubManager(DummyCommContext(), 1)
    assert stub.stage_index() == 0 and stub.stage_count() == 1
    stub.bind_stage(2, 4)
    assert stub.stage_index() == 2 and stub.stage_count() == 4
    snap = stub.metrics.snapshot()
    assert snap["pipe_stage_index"] == 2.0
    assert snap["pipe_stage_count"] == 4.0
    with pytest.raises(ValueError):
        stub.bind_stage(4, 4)


def test_pipeline_adopts_manager_factory_surface():
    from torchft_tpu_torch.comm.context import DummyCommContext
    from torchft_tpu_torch.comm.wire_stub import WireStubManager

    made = []

    def factory(stage, replica):
        mgr = WireStubManager(DummyCommContext(), 1)
        made.append((stage, replica, mgr))
        return mgr

    pipe = Pipeline(_cfg(num_stages=2, replicas=1, microbatches=4),
                    manager_factory=factory)
    try:
        assert not pipe.run_step()["aborted"]
        assert {(s, r) for s, r, _ in made} == {(0, 0), (1, 0)}
        for stage, _, mgr in made:
            assert mgr.stage_index() == stage
            assert mgr.stage_count() == 2
            snap = mgr.metrics.snapshot()
            assert snap["microbatch_send"] >= 0
            assert snap["pipe_sched_ticks"] > 0
            kinds = [e["kind"] for e in mgr.events.since(0)[0]]
            assert "microbatch_recv" in kinds and "step_commit" in kinds
    finally:
        pipe.close()


# --------------------------------------------------------------- config


def test_config_validation():
    with pytest.raises(ValueError):
        _cfg(num_stages=2, replicas=3, microbatches=4)
    with pytest.raises(ValueError):
        _cfg(codec="lz4")
    with pytest.raises(ValueError):
        _cfg(on_kill="retry")
    cfg = _cfg(num_stages=2, layer_dims=(8, 8, 8, 8, 8))
    assert cfg.stage_layers == [[0, 1], [2, 3]]
    assert cfg.device == torch.device("cpu")


def test_config_resolves_to_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelineConfig()


# ------------------------------------------- the contract with the reference


@pytest.mark.parametrize("codec", ["none", "bf16", "fp16", "int8"])
def test_codec_encode_frame_matches_the_reference(codec):
    rng = np.random.default_rng(0)
    port_codec = transport.make_wire_codec(codec)
    ref_codec = ref_transport.make_wire_codec(codec)
    for flat in (rng.standard_normal(96).astype(np.float32),
                 (rng.standard_normal((8, 6)) * 1e3).astype(np.float32),
                 np.zeros(5, np.float32),
                 np.array([1.5, -0.0, np.inf, 3.0], np.float32)):
        data = transport.codec_encode_frame(port_codec, flat)
        assert data == ref_transport.codec_encode_frame(ref_codec, flat)
        out, ref_out = (np.empty(flat.size, np.float32) for _ in range(2))
        transport.codec_decode_frame(port_codec, data, out)
        ref_transport.codec_decode_frame(ref_codec, data, ref_out)
        assert out.tobytes() == ref_out.tobytes()


def _frames(pipe) -> list:
    """Every encoded frame the replicas sent in the last step."""
    return [f for _, rep in sorted(pipe.replicas.items())
            for cache in (rep._act_cache, rep._grad_cache)
            for _, f in sorted(cache.items())]


def _parse(plane, wire, codec: str, frame: bytes) -> np.ndarray:
    """A frame read with ``plane``'s header and decoded with ``wire``'s
    ``codec_decode_frame``."""
    (magic, ver, kind, codec_id, _step, _mb, _lane, _stage, rows, cols,
     nbytes) = plane._HDR.unpack(frame[:plane._HDR.size])
    assert magic == b"TFPP" and ver == 1 and kind in (1, 2)
    assert codec_id == plane._CODEC_IDS[codec]
    payload = frame[plane._HDR.size:]
    assert len(payload) == nbytes
    out = np.empty(rows * cols, np.float32)
    wire.codec_decode_frame(wire.make_wire_codec(codec), payload, out)
    return out


@pytest.mark.parametrize("codec,ef", CODECS)
def test_frames_cross_parse_between_packages(codec, ef):
    assert (P._MAGIC, P._VERSION, P._HDR.format, P._CODEC_IDS) == (
        ref_plane._MAGIC, ref_plane._VERSION, ref_plane._HDR.format,
        ref_plane._CODEC_IDS)
    assert (P._KIND_ACT, P._KIND_GRAD, P._KIND_FETCH, P._KIND_PARAM) == (
        ref_plane._KIND_ACT, ref_plane._KIND_GRAD, ref_plane._KIND_FETCH,
        ref_plane._KIND_PARAM)
    kw = dict(num_stages=3, replicas=1, microbatches=4, layer_dims=(8,) * 7,
              codec=codec, error_feedback=ef, step_timeout=60.0)
    port, ref = Pipeline(_cfg(**kw)), ref_plane.Pipeline(
        ref_plane.PipelineConfig(**kw))
    try:
        port.run_step()
        ref.run_step()
        port_frames, ref_frames = _frames(port), _frames(ref)
    finally:
        port.close()
        ref.close()
    # 2 boundaries x (acts + grads) x 4 microbatches
    assert len(port_frames) == len(ref_frames) == 16
    for frame in port_frames + ref_frames:
        assert _parse(P, transport, codec, frame).tobytes() == \
            _parse(ref_plane, ref_transport, codec, frame).tobytes()
    # the same frames up to the products' rounding: equal headers
    for a, b in zip(port_frames, ref_frames):
        assert a[:P._HDR.size] == b[:P._HDR.size]


@pytest.mark.parametrize("codec,ef", CODECS)
def test_plane_matches_the_reference_after_three_steps(codec, ef):
    kw = dict(num_stages=3, replicas=1, microbatches=4, layer_dims=(8,) * 7,
              codec=codec, error_feedback=ef, step_timeout=60.0)
    port, ref = Pipeline(_cfg(**kw)), ref_plane.Pipeline(
        ref_plane.PipelineConfig(**kw))
    try:
        losses = []
        for _ in range(3):
            losses.append((port.run_step()["loss"], ref.run_step()["loss"]))
        atol = 1e-6 if codec == "none" else 1e-4
        for (s, r), rep in sorted(port.replicas.items()):
            theirs = ref.replicas[(s, r)].layers
            assert sorted(rep.layers) == sorted(theirs)
            for li, layer in rep.layers.items():
                for k in ("W", "b"):
                    np.testing.assert_allclose(
                        layer[k].numpy(), theirs[li][k], rtol=1e-5,
                        atol=atol, err_msg=f"stage {s} layer {li} {k}")
        np.testing.assert_allclose([a for a, _ in losses],
                                   [b for _, b in losses], rtol=1e-5,
                                   atol=atol)
        if codec == "none":
            # before the first update both planes hash the same init
            fresh = Pipeline(_cfg(**kw)), ref_plane.Pipeline(
                ref_plane.PipelineConfig(**kw))
            try:
                assert fresh[0].global_param_hash() == \
                    fresh[1].global_param_hash()
            finally:
                for p in fresh:
                    p.close()
    finally:
        port.close()
        ref.close()
