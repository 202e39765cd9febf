"""Pipeline schedules: GPipe, 1F1B, interleaved 1F1B, as data.

Twin of ``torchft_tpu/parallel/schedule.py`` (pure Python, kept as the
port's own copy): the same tables, entry by entry. A schedule is a list of
ticks; each tick is a list of per-stage actions (one slot per pipeline
stage): ``None`` (idle) or ``(phase, microbatch, chunk)`` with phase
"F"/"B". Unit-time F and B slots (the classic schedule-analysis model).
These drive both analysis (bubble fraction, peak in-flight activations)
and the executable runners (``parallel/pipeline.py``), which follow the
same tables slot by slot.

Schedule facts encoded here (and asserted by tests):
- GPipe and non-interleaved 1F1B have the SAME makespan / bubble
  (2(S-1) idle slots per stage); 1F1B's win is peak in-flight
  activations S vs GPipe's M.
- Interleaved 1F1B (V chunks per device, Megatron-style) cuts the
  warmup/cooldown bubble by ~1/V at the cost of V× more p2p hops.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = [
    "gpipe_schedule",
    "one_f_one_b_schedule",
    "interleaved_1f1b_schedule",
    "bubble_fraction",
    "peak_inflight_activations",
    "validate_schedule",
    "interleaved_tables",
]

Action = Optional[Tuple[str, int, int]]  # (phase, microbatch, chunk)


def _to_ticks(events, num_stages: int) -> List[List[Action]]:
    """events: dict[(tick, stage)] -> action; densify into tick rows."""
    if not events:
        return []
    horizon = max(t for t, _ in events) + 1
    ticks: List[List[Action]] = [
        [None] * num_stages for _ in range(horizon)
    ]
    for (t, s), action in events.items():
        assert ticks[t][s] is None, f"collision at tick {t} stage {s}"
        ticks[t][s] = action
    return ticks


def gpipe_schedule(num_stages: int, num_microbatches: int) -> List[List[Action]]:
    """All forwards, then all backwards (fill + drain twice)."""
    S, M = num_stages, num_microbatches
    events = {}
    for k in range(M):
        for s in range(S):
            events[(s + k, s)] = ("F", k, 0)
    fwd_end = S - 1 + M  # first tick after the last stage's last forward
    for k in range(M):
        for s in reversed(range(S)):
            events[(fwd_end + (S - 1 - s) + k, s)] = ("B", k, 0)
    return _to_ticks(events, S)


def one_f_one_b_schedule(
    num_stages: int, num_microbatches: int
) -> List[List[Action]]:
    """Non-interleaved 1F1B: stage s runs F(k) at tick s+2k and B(k) at
    tick 2S-1-s+2k — warmup of S-1-s forwards, then strict FB
    alternation, then drain. Same makespan as GPipe; peak in-flight
    activations bounded by the stage depth instead of M."""
    S, M = num_stages, num_microbatches
    events = {}
    for k in range(M):
        for s in range(S):
            events[(s + 2 * k, s)] = ("F", k, 0)
            events[(2 * S - 1 - s + 2 * k, s)] = ("B", k, 0)
    return _to_ticks(events, S)


def interleaved_1f1b_schedule(
    num_stages: int, num_microbatches: int, interleave: int
) -> List[List[Action]]:
    """Megatron-style interleaved schedule: each device owns ``interleave``
    model chunks (device s holds chunks c, i.e. virtual stages v = c*S+s);
    microbatches traverse all V*S virtual stages. Built by greedy
    list-scheduling against the true dependency DAG (correct by
    construction: no slot collisions, all dependencies respected), with
    the 1F1B discipline of preferring a ready backward once steady state
    is reached — shrinking the warmup/cooldown bubble toward (S-1)/V of
    GPipe's relative to useful work V*M."""
    S, M, V = num_stages, num_microbatches, interleave
    if V == 1:
        return one_f_one_b_schedule(S, M)
    total_v = V * S
    done_f: set = set()   # (v, k) forward completed (before this tick)
    done_b: set = set()
    schedule: List[List[Action]] = []
    remaining = 2 * total_v * M
    horizon = 8 * (total_v + V * M + 4)  # generous deadlock backstop
    while remaining and len(schedule) < horizon:
        row: List[Action] = [None] * S
        chosen = []
        for s in range(S):
            f_cands = []
            b_cands = []
            for c in range(V):
                v = c * S + s
                for k in range(M):
                    if (v, k) in done_f:
                        continue
                    if v == 0 or (v - 1, k) in done_f:
                        f_cands.append((k, c, v))
                    break  # per virtual stage, mbs go in order
                for k in range(M):
                    if (v, k) in done_b:
                        continue
                    if (v, k) in done_f and (
                        v == total_v - 1 or (v + 1, k) in done_b
                    ):
                        b_cands.append((k, c, v))
                    break
            if b_cands:  # 1F1B: drain a backward whenever one is ready
                k, c, v = min(b_cands)
                row[s] = ("B", k, c)
                chosen.append(("B", v, k))
            elif f_cands:
                k, c, v = min(f_cands)
                row[s] = ("F", k, c)
                chosen.append(("F", v, k))
        assert chosen, "interleaved schedule deadlocked"
        for phase, v, k in chosen:
            (done_f if phase == "F" else done_b).add((v, k))
            remaining -= 1
        schedule.append(row)
    assert remaining == 0, "interleaved schedule did not complete"
    return schedule


def bubble_fraction(schedule: List[List[Action]]) -> float:
    """Idle slots / total slots over the schedule's makespan."""
    total = sum(len(t) for t in schedule)
    idle = sum(1 for t in schedule for a in t if a is None)
    return idle / total


def peak_inflight_activations(schedule: List[List[Action]]) -> int:
    """Max, over stages, of simultaneously stored forward activations
    (stored at F, freed at the matching B)."""
    peak = 0
    num_stages = len(schedule[0]) if schedule else 0
    for s in range(num_stages):
        live = set()
        for t in range(len(schedule)):
            a = schedule[t][s]
            if a is None:
                continue
            phase, mb, chunk = a
            if phase == "F":
                live.add((mb, chunk))
                peak = max(peak, len(live))
            else:
                live.discard((mb, chunk))
    return peak


def validate_schedule(
    schedule: List[List[Action]], num_stages: int, num_microbatches: int,
    interleave: int = 1,
) -> None:
    """Structural checks: every (mb, chunk) F and B happens exactly once
    per stage, F(s) precedes F(s+1) (data dependency), B(s+1) precedes
    B(s), and all Bs follow the last virtual stage's F."""
    f_ticks = {}
    b_ticks = {}
    for t, row in enumerate(schedule):
        for s, a in enumerate(row):
            if a is None:
                continue
            phase, mb, chunk = a
            key = (s, mb, chunk)
            store = f_ticks if phase == "F" else b_ticks
            assert key not in store, f"duplicate {phase} {key}"
            store[key] = t
    expect = num_stages * num_microbatches * interleave
    assert len(f_ticks) == expect, (len(f_ticks), expect)
    assert len(b_ticks) == expect, (len(b_ticks), expect)
    for (s, mb, chunk), t in f_ticks.items():
        # forward data dependency along virtual stages
        v = chunk * num_stages + s
        if v + 1 < num_stages * interleave:
            s2, c2 = (v + 1) % num_stages, (v + 1) // num_stages
            assert f_ticks[(s2, mb, c2)] > t, (
                f"F dependency violated at mb={mb} v={v}"
            )
        assert b_ticks[(s, mb, chunk)] > t, f"B before F at {(s, mb, chunk)}"
    for (s, mb, chunk), t in b_ticks.items():
        v = chunk * num_stages + s
        if v - 1 >= 0:
            s2, c2 = (v - 1) % num_stages, (v - 1) // num_stages
            assert b_ticks[(s2, mb, c2)] > t, (
                f"B dependency violated at mb={mb} v={v}"
            )


def _alloc_slots(intervals):
    """First-fit interval slot allocation: intervals = {key: (start, end)}
    inclusive; returns ({key: slot}, num_slots). Keys whose intervals
    overlap get distinct slots."""
    order = sorted(intervals, key=lambda k: intervals[k][0])
    slot_free_at: List[int] = []  # slot -> first tick it is free again
    assignment = {}
    for key in order:
        start, end = intervals[key]
        for slot, free_at in enumerate(slot_free_at):
            if free_at <= start:
                assignment[key] = slot
                slot_free_at[slot] = end + 1
                break
        else:
            assignment[key] = len(slot_free_at)
            slot_free_at.append(end + 1)
    return assignment, len(slot_free_at)


def interleaved_tables(num_stages: int, num_microbatches: int,
                       interleave: int):
    """Lower an interleaved-1F1B schedule into static per-tick tables for
    the executable runner (pipeline.make_pipeline_interleaved_1f1b).

    The greedy schedule does not align a virtual stage's send with its
    consumer's fire tick, so inter-stage values park in per-device
    buffers; this computes a static slot assignment (interval first-fit)
    for the forward-value buffers, the backward-cotangent buffers, and
    the saved-activation buffers.

    Returns a dict of int arrays shaped [T, S] (value -1 = no-op):
      f_mb, f_chunk      microbatch/chunk of this tick's forward
      f_src              fwd-buffer slot holding the stage input
                         (-1 = virtual stage 0: embed from x)
      f_act              activation slot to SAVE the stage input into
      f_stash            fwd-buffer slot for the value ARRIVING this tick
      b_mb, b_chunk      microbatch/chunk of this tick's backward
      b_act              activation slot holding the saved stage input
      b_gsrc             bwd-buffer slot holding the cotangent
                         (-1 = last virtual stage: seed from the loss)
      b_stash            bwd-buffer slot for the cotangent arriving now
    plus scalars n_fwd_slots, n_bwd_slots, n_act_slots, ticks.
    """
    S, M, V = num_stages, num_microbatches, interleave
    total_v = V * S
    sched = interleaved_1f1b_schedule(S, M, V)
    T = len(sched)

    t_f: dict = {}
    t_b: dict = {}
    for t, row in enumerate(sched):
        for s, a in enumerate(row):
            if a is None:
                continue
            phase, mb, chunk = a
            v = chunk * S + s
            (t_f if phase == "F" else t_b)[(v, mb)] = t

    # Buffer intervals, per receiving device. fwd edge (v, k) -> (v+1, k):
    # value leaves device v%S at t_f[(v,k)], arrives at (v+1)%S one tick
    # later, is consumed at t_f[(v+1,k)].
    fwd_intervals: List[dict] = [dict() for _ in range(S)]
    bwd_intervals: List[dict] = [dict() for _ in range(S)]
    act_intervals: List[dict] = [dict() for _ in range(S)]
    for (v, k), tf in t_f.items():
        if v + 1 < total_v:
            dst = (v + 1) % S
            fwd_intervals[dst][(v + 1, k)] = (tf + 1, t_f[(v + 1, k)])
        act_intervals[v % S][(v, k)] = (tf, t_b[(v, k)])
    for (v, k), tb in t_b.items():
        if v - 1 >= 0:
            dst = (v - 1) % S
            bwd_intervals[dst][(v - 1, k)] = (tb + 1, t_b[(v - 1, k)])

    fwd_slots = [
        _alloc_slots(fwd_intervals[s]) for s in range(S)
    ]
    bwd_slots = [
        _alloc_slots(bwd_intervals[s]) for s in range(S)
    ]
    act_slots = [
        _alloc_slots(act_intervals[s]) for s in range(S)
    ]

    def table():
        return [[-1] * S for _ in range(T)]

    out = {name: table() for name in (
        "f_mb", "f_chunk", "f_src", "f_act", "f_stash",
        "b_mb", "b_chunk", "b_act", "b_gsrc", "b_stash",
    )}
    for t, row in enumerate(sched):
        for s, a in enumerate(row):
            if a is None:
                continue
            phase, mb, chunk = a
            v = chunk * S + s
            if phase == "F":
                out["f_mb"][t][s] = mb
                out["f_chunk"][t][s] = chunk
                out["f_src"][t][s] = (
                    -1 if v == 0 else fwd_slots[s][0][(v, mb)]
                )
                out["f_act"][t][s] = act_slots[s][0][(v, mb)]
            else:
                out["b_mb"][t][s] = mb
                out["b_chunk"][t][s] = chunk
                out["b_act"][t][s] = act_slots[s][0][(v, mb)]
                out["b_gsrc"][t][s] = (
                    -1 if v == total_v - 1 else bwd_slots[s][0][(v, mb)]
                )
    # Stash tables: a value arriving at tick t on device s was produced at
    # t-1 on the neighbor; park it in the slot its consumer will read.
    for (v, k), tf in t_f.items():
        if v + 1 < total_v:
            dst = (v + 1) % S
            out["f_stash"][tf + 1][dst] = fwd_slots[dst][0][(v + 1, k)]
    for (v, k), tb in t_b.items():
        if v - 1 >= 0:
            dst = (v - 1) % S
            out["b_stash"][tb + 1][dst] = bwd_slots[dst][0][(v - 1, k)]

    out["n_fwd_slots"] = max(1, max(n for _, n in fwd_slots))
    out["n_bwd_slots"] = max(1, max(n for _, n in bwd_slots))
    out["n_act_slots"] = max(1, max(n for _, n in act_slots))
    out["ticks"] = T
    return out
