"""The segmented advance and the state audit's verdict (the port's cut
copy of the reference package's device/supervise.py: `AUDIT_BIT_NAMES`,
`AuditFailure`, `decode_audit`, `check_audit`, `heartbeat_rates`,
`HeartbeatMonitor`, `AdvanceResult` and `advance`, with the reference's
message text).

`advance` is the loop the device runner (device/runner.py) and the
campaign (ensemble/campaign.py) run a simulation through: segments cut
at heartbeat multiples and every `dispatch_segment` of sim time, each an
`engine.run(state, stop=boundary, final_stop=stop)` whose windows stay
clamped to the simulation's stop, so that the trace equals one
unsegmented run's. At every boundary: the loud overflow counters (summed
over a mesh's ranks, so that every rank takes the same decision), the
health word under `state_audit`, the heartbeats. A planned run
(`capacity_plan` not static) keeps the last validated boundary's state
on the card; an overflow there widens the offending dimension, rebuilds
the engine and replays from it (the reference's serial loop, depth 1).
Dispatch retries, failover, the out-of-memory ladder, the pipelined
window and checkpoints are not ported (ROADMAP.md queue (a) items 7b and
13): their keys stay refused.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

log = logging.getLogger("shadow_tpu_torch.supervise")

AUDIT_BIT_NAMES = {
    1: "heap-order/head-bounds",
    2: "clock-monotonicity",
    4: "counter-negativity",
    8: "packet-conservation",
}


class AuditFailure(RuntimeError):
    """The on-device invariant audit found a corrupted state. The run
    stops rather than writing (or running past) a checkpoint that a
    restart would trust."""


def decode_audit(word: int) -> list[str]:
    """Health-word bitmask -> the named invariants it violates."""
    return [name for bit, name in sorted(AUDIT_BIT_NAMES.items())
            if word & bit]


def check_audit(state, where: str = "", last_good: str = "") -> None:
    """Validate the health word of a state (its [H] `aud` tensor). No-op
    when the engine was built without the audit. Raises
    :class:`AuditFailure` naming the violated invariants, and the last
    validated checkpoint, if any, on a nonzero word."""
    if "aud" not in state:
        return
    aud = state["aud"].cpu().numpy()
    if not aud.any():
        return
    names = decode_audit(int(np.bitwise_or.reduce(aud, axis=None)))
    hint = (f"; last validated checkpoint: {last_good}" if last_good
            else "; no validated checkpoint exists yet")
    raise AuditFailure(
        f"state audit failed{f' at {where}' if where else ''}: "
        f"violated invariant(s) {names} on "
        f"{int((aud != 0).sum())} host slot(s) — the state is "
        f"corrupted and will not be checkpointed or run further"
        f"{hint}")


def heartbeat_rates(mark, sent_totals):
    """The pkts/s since the last heartbeat of the `[supervise-heartbeat]`
    and `[ensemble-heartbeat]` lines (supervise.py:299): given the
    previous (wall, totals) mark or None and the cumulative sent totals
    (one per line), (new mark, rates as strings); "n/a" at the first
    boundary."""
    wall = time.perf_counter()
    rates = ["n/a"] * len(sent_totals)
    if mark is not None:
        dw = wall - mark[0]
        if dw > 0:
            rates = [f"{(float(s) - float(p)) / dw:.0f}"
                     for s, p in zip(sent_totals, mark[1])]
    return (wall, [float(s) for s in sent_totals]), rates


class HeartbeatMonitor:
    """Wall-clock staleness on the heartbeat cadence
    (`experimental.heartbeat_stale_after` = k; supervise.py:320): the
    runner beats at every heartbeat boundary; the expected gap is an
    average of the healthy gaps (each new one weighs a half), and a gap
    wider than k times it counts into `stale_events` with a warning
    (SimStats.stale_heartbeats) and is not averaged in. `stale()` is the
    live probe another thread may poll. The clock is injectable."""

    def __init__(self, k: int, clock=time.monotonic):
        # k < 2 would flag ordinary jitter: clamped, not refused
        self.k = max(2, int(k))
        self._clock = clock
        self._lock = threading.Lock()
        self._last = None
        self._expect = None
        self.stale_events = 0

    def beat(self) -> None:
        now = self._clock()
        with self._lock:
            if self._last is not None:
                gap = max(now - self._last, 1e-9)
                if self._expect is None:
                    self._expect = gap
                elif gap > self.k * self._expect:
                    self.stale_events += 1
                    log.warning(
                        "STALE HEARTBEAT: %.2fs since the previous "
                        "heartbeat — %.1fx the expected %.2fs cadence "
                        "(threshold %dx); the run stalled between "
                        "segment boundaries (%d stale gap(s) so far)",
                        gap, gap / self._expect, self._expect,
                        self.k, self.stale_events)
                else:
                    self._expect = 0.5 * self._expect + 0.5 * gap
            self._last = now

    def gap(self) -> float:
        """Seconds since the last beat (0.0 before the first)."""
        with self._lock:
            return (0.0 if self._last is None
                    else max(0.0, self._clock() - self._last))

    def stale(self) -> bool:
        """Whether the current gap is already past the threshold; False
        until two beats have set a cadence."""
        with self._lock:
            if self._last is None or self._expect is None:
                return False
            return (self._clock() - self._last) > \
                self.k * self._expect


@dataclass
class AdvanceResult:
    """What `advance` hands back beside the final state: the summed
    rounds (an [R] array in a campaign), where it ended, whether the
    round budget or an unplanned overflow ended it early, and the
    segment loop's record (`pipeline`: segments run, replayed after a
    re-plan, host syncs, graph captures, the kept segments' phases)."""

    rounds: np.ndarray = field(default_factory=lambda: np.int64(0))
    t_end: int = 0
    budget_hit: bool = False
    overflowed: bool = False
    pipeline: dict = field(default_factory=dict)


def _snapshot(state: dict, into: Optional[dict]) -> dict:
    """A copy of `state` on its device (into the tensors of `into` where
    given): the last validated boundary's state a replay starts from."""
    if into is None:
        return {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        into[k].copy_(v)
    return into


def advance(runner, state, t_start: int, pause: int, stop: int,
            ensemble: bool = False):
    """Advance [t_start, pause) in segments (supervise.py:754, cut to
    the serial loop): each ends at the next heartbeat multiple, or
    `dispatch_segment` after its start, or `pause`, and runs with its
    windows clamped to `stop`. At each boundary, in the reference's
    order: overflow (widen, rebuild and replay from the last validated
    boundary where the plan is not static and fewer than MAX_REPLANS
    re-plans ran, else end loudly; a replayed segment's rounds and
    phases do not count), the cumulative max_rounds budget,
    the health word under the state audit, the heartbeats (not at
    `stop`). `runner` is the device runner or the campaign: its
    `engine`, `cfg`, `replans`, `_capacity_overrides`, and
    `overflow_counts(state)` (a mesh's sums), `replan(host_state)` (the
    rebuilt engine's state) and `_emit_heartbeats(t, state)`.

    Returns (state, AdvanceResult)."""
    from shadow_tpu_torch.device import capacity

    xp = runner.cfg.experimental
    hb = runner.cfg.general.heartbeat_interval
    seg = xp.dispatch_segment
    audit_on = bool(xp.state_audit)
    retry_ok = xp.capacity_plan != "static"
    budget = runner.engine.config.max_rounds
    label = "ensemble " if ensemble else ""
    res = AdvanceResult()
    stats = {"segments": 0, "replayed": 0, "host_syncs": 0,
             "captures": 0}
    phases = np.int64(0)
    res.pipeline = stats
    good = _snapshot(state, None) if retry_ok else None
    good_t = t = t_start
    next_hb = (t // hb + 1) * hb if hb else None
    def next_boundary(ti):
        nxt = pause
        if hb:
            nxt = min(nxt, (ti // hb + 1) * hb)
        if seg:
            nxt = min(nxt, ti + seg)
        return nxt

    captures0 = runner.engine.captures
    while t < pause:
        nxt = next_boundary(t)
        state, seg_rounds = runner.engine.run(state, stop=nxt,
                                              final_stop=stop)
        dims = capacity.overflow_dims(state, runner.overflow_counts(state))
        seg_rounds = np.asarray(seg_rounds, np.int64)
        stats["segments"] += 1
        stats["host_syncs"] += int(runner.engine.loop_stats["host_syncs"])
        if dims:
            if not retry_ok or runner.replans >= capacity.MAX_REPLANS:
                res.rounds = res.rounds + seg_rounds
                phases = phases + np.asarray(
                    runner.engine.loop_stats["phases"], np.int64)
                t = nxt
                res.overflowed = True
                break
            runner.replans += 1
            runner._capacity_overrides = capacity.widen(
                runner._capacity_overrides, dims, runner.engine.effective)
            log.warning(
                "%scapacity overflow on %s in (%d, %d] ns; re-plan #%d "
                "with %s, re-running from t=%d ns", label, dims, t, nxt,
                runner.replans, runner._capacity_overrides, good_t)
            stats["captures"] += runner.engine.captures - captures0
            host = {k: v.cpu().numpy() for k, v in good.items()}
            # the overflowed engine's state and snapshot go before the
            # rebuilt engine allocates
            del state, good
            state = runner.replan(host)
            captures0 = runner.engine.captures
            good = _snapshot(state, None)
            stats["replayed"] += 1
            t = good_t
            next_hb = (t // hb + 1) * hb if hb else None
            continue
        res.rounds = res.rounds + seg_rounds
        phases = phases + np.asarray(runner.engine.loop_stats["phases"],
                                     np.int64)
        t = nxt
        if int(np.max(res.rounds)) >= budget:
            # cumulative: each segment's own cap restarts at 0
            if t < pause:
                log.warning("max_rounds (%d) exhausted during "
                            "%ssegmentation; stopping", budget, label)
            res.budget_hit = True
            break
        if audit_on:
            # validated before it becomes the state a replay starts from
            check_audit(state, where=f"t={t} ns")
        if next_hb is not None and t >= next_hb and t < stop:
            runner._emit_heartbeats(t, state)
            next_hb += hb
        if good is not None and t < pause:
            good = _snapshot(state, good)
            good_t = t
    stats["captures"] += runner.engine.captures - captures0
    stats["phases"] = phases.tolist()
    res.t_end = t
    return state, res
