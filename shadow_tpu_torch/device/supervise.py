"""Supervised device runs (the port of the reference package's
device/supervise.py: the segmented advance, validated rotating
checkpoints, the preemption drain, dispatch retry, the mesh shrink and
the hybrid failover, with the reference's message text).

`advance` is the loop the device runner (device/runner.py) and the
campaign (ensemble/campaign.py) run a simulation through: segments cut
at heartbeat multiples, every `dispatch_segment` of sim time and at the
`checkpoint_every` cadence, each an `engine.run(state, stop=boundary,
final_stop=stop)` whose windows stay clamped to the simulation's stop,
so that the trace equals one unsegmented run's. At every boundary, in
the reference's order: the loud overflow counters (summed over a mesh's
ranks, so that every rank takes the same decision), the max_rounds
budget, the health word under `state_audit`, the heartbeats, the copy
of the validated state and the rotation save.

The engine updates its state in place, so a run that may replay
(a planned one, or a supervised one: checkpoints, a drain guard,
retries or a failover) keeps the last validated boundary's state as a
second copy on the card (`_snapshot`); replays and saves start from
that copy, never from the live tensors a failed segment may have left
half-updated. A retry copies it back into the live tensors, which the
captured window loop's graph is keyed on, so it costs no capture.

* Rotating checkpoints (`Checkpointer`): `<checkpoint_save>.t<ns>`
  every `checkpoint_every`, the last `checkpoint_keep` kept, written
  only from a validated state; `checkpoint_load` of the base path
  resolves to the newest readable entry (`resolve_checkpoint`).
* The preemption drain (`PreemptionGuard`): SIGTERM or SIGINT sets a
  flag (the handler touches no tensor and launches nothing); the loop
  finishes the segment in flight, saves a resume checkpoint at its
  boundary and returns preempted; the CLI exits EXIT_PREEMPTED (75). On
  a mesh the flag is reduced over the ranks (MAX) at every boundary,
  so that every rank saves and stops at the same one.
* Dispatch retry: a transient error (TRANSIENT_MARKERS) replays from the
  validated copy after a capped backoff; past `dispatch_retries`
  consecutive failures `failover: shrink` probes the mesh's ranks
  (`surviving_ranks`) and, where some died and some live, re-shards the
  validated copy onto the survivors (`_shrink_recover`: device/mesh.py
  `Mesh.shrink`, the runner's `_shrink_to`, capacity.reshard_state) and
  goes on on the device with a fresh retry budget; otherwise, and under
  `failover: hybrid`, the copy is persisted and DeviceFailover raised,
  which core/controller.py answers with a hybrid rerun (a campaign
  re-raises). A second consecutive out-of-memory error at one boundary
  is a capacity fact, whose degradation ladder is not ported: it
  raises, naming ROADMAP.md queue (a) item 13, as do the pipelined
  window and the watchdog.
* Chaos (device/chaos.py): the dispatch seam before each segment's
  launch, the checkpoint seam after each rotation save.
"""

from __future__ import annotations

import glob
import logging
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

log = logging.getLogger("shadow_tpu_torch.supervise")

# a graceful preemption's exit code (EX_TEMPFAIL): "resume me", apart
# from success (0) and failure (1)
EXIT_PREEMPTED = 75

# the backoff cap between dispatch retries (wall seconds)
BACKOFF_CAP_S = 30.0

# substrings of a device error worth retrying from the last validated
# state, matched against str(exc). A sticky CUDA error (an illegal
# address, a launch failure) poisons the context and carries none of
# them: it is re-raised, never retried. The allocator's "CUDA out of
# memory" matches "out of memory".
TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "device unavailable",
    "failed to connect",
    "Socket closed",
    "out of memory",
)

# the subset of TRANSIENT_MARKERS that names memory exhaustion: retried
# once; a repeat at the same validated boundary is deterministic
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
)

ITEM_13 = ("ROADMAP.md queue (a) item 13 (the robustness layer: the "
           "out-of-memory degradation ladder)")

AUDIT_BIT_NAMES = {
    1: "heap-order/head-bounds",
    2: "clock-monotonicity",
    4: "counter-negativity",
    8: "packet-conservation",
}


class LeftMesh(Exception):
    """This rank's device failed the liveness probe of a mesh shrink:
    the survivors go on without it, and it leaves the run (the ranks'
    loop, device/runner.py `_mesh_runs_rank`, goes on to its next
    config)."""


class AuditFailure(RuntimeError):
    """The on-device invariant audit found a corrupted state. The run
    stops rather than writing (or running past) a checkpoint that a
    restart would trust."""


class DeviceFailover(RuntimeError):
    """Dispatch retries exhausted under `failover: hybrid`: carries the
    last validated checkpoint (for a later device-side resume) and the
    sim time it pins; core/controller.py catches it and reruns the
    config on the hybrid policy. `checkpoint_path` is None where no
    state could be persisted at all; `persist_error` then names the
    save's failure."""

    def __init__(self, message: str, checkpoint_path=None,
                 sim_time: int = 0, persist_error: str = ""):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path
        self.sim_time = int(sim_time)
        self.persist_error = persist_error

    def __reduce__(self):
        # a mesh rank hands it back to the parent (device/runner.py)
        return (DeviceFailover, (str(self), self.checkpoint_path,
                                 self.sim_time, self.persist_error))


def is_transient(exc: BaseException) -> bool:
    """Whether a dispatch error is worth retrying from the last
    validated state (against a programming error that would recur)."""
    text = str(exc)
    return any(m in text for m in TRANSIENT_MARKERS)


def is_oom(exc: BaseException) -> bool:
    """Whether a dispatch error names memory exhaustion."""
    text = str(exc)
    return any(m in text for m in OOM_MARKERS)


def decode_audit(word: int) -> list[str]:
    """Health-word bitmask -> the named invariants it violates."""
    return [name for bit, name in sorted(AUDIT_BIT_NAMES.items())
            if word & bit]


def check_audit(state, where: str = "", last_good: str = "",
                mesh=None) -> None:
    """Validate the health word of a state (its [H] `aud` tensor). No-op
    when the engine was built without the audit. Raises
    :class:`AuditFailure` naming the violated invariants, and the last
    validated checkpoint, if any, on a nonzero word. On a mesh
    (device/mesh.py) every rank calls: the words' bits and the host
    slots they mark are summed over the ranks, so that every rank
    raises the same failure, of every host, at the same boundary."""
    if "aud" not in state:
        return
    aud = state["aud"].cpu().numpy()
    bits = [int((aud & bit).any()) for bit in sorted(AUDIT_BIT_NAMES)]
    n_bad = int((aud != 0).sum())
    if mesh is not None:
        got = mesh.all_sum(torch.tensor(bits + [n_bad],
                                        dtype=torch.int64)).tolist()
        bits, n_bad = got[:-1], int(got[-1])
    if not n_bad:
        return
    names = decode_audit(sum(bit for bit, on in zip(
        sorted(AUDIT_BIT_NAMES), bits) if on))
    hint = (f"; last validated checkpoint: {last_good}" if last_good
            else "; no validated checkpoint exists yet")
    raise AuditFailure(
        f"state audit failed{f' at {where}' if where else ''}: "
        f"violated invariant(s) {names} on "
        f"{n_bad} host slot(s) — the state is "
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




class PreemptionGuard:
    """The SIGTERM/SIGINT drain handler of a supervised run (a context
    manager, supervise.py:240-297). The first signal sets `requested`:
    the advance finishes the segment in flight, saves a resume
    checkpoint at its boundary and returns preempted. A second signal
    restores the original handlers and raises KeyboardInterrupt (the
    hard abort). Outside the main thread no handler can be installed:
    the guard then stays inactive and the run behaves as before."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self.signum: int = 0
        self.active = False
        self._orig: dict = {}

    def request(self) -> None:
        """Programmatic preemption (tests, embedding harnesses)."""
        self.requested = True

    def _handle(self, signum, frame):
        # sets a flag, nothing more: no tensor is touched and nothing
        # launched here; the drain fires at the next boundary
        if self.requested:
            self._restore()
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during drain — "
                "aborting hard (state NOT saved)")
        self.requested = True
        self.signum = signum
        log.warning(
            "received %s: draining — finishing the in-flight dispatch "
            "segment, then saving a resume checkpoint and exiting "
            "with rc %d (send the signal again to abort hard)",
            signal.Signals(signum).name, EXIT_PREEMPTED)

    def _restore(self) -> None:
        for s, h in self._orig.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._orig.clear()
        self.active = False

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self.SIGNALS:
                self._orig[s] = signal.signal(s, self._handle)
            self.active = True
        except ValueError:
            # not the main thread: leave signal disposition alone
            self._restore()
        return self

    def __exit__(self, *exc) -> None:
        self._restore()


def drain_possible(cfg) -> bool:
    """Whether a run under this config ever reaches a segment boundary
    before its pause, the only points a drain can fire at (no
    checkpoint_every, no dispatch_segment, no heartbeat: one segment,
    and a guard would swallow the signal for nothing)."""
    xp = cfg.experimental
    return bool(xp.checkpoint_every or xp.dispatch_segment
                or cfg.general.heartbeat_interval)


def make_guard(cfg):
    """A PreemptionGuard where a drain can fire (checkpoint_save set
    and segment boundaries exist), else None (with a hint)."""
    if not cfg.experimental.checkpoint_save:
        return None
    if not drain_possible(cfg):
        log.info(
            "preemption drain inactive: the run has no segment "
            "boundaries (set experimental.checkpoint_every or "
            "dispatch_segment, or general.heartbeat_interval, to "
            "make SIGTERM drain to a resume checkpoint)")
        return None
    return PreemptionGuard()


def keeps_copy(cfg) -> bool:
    """Whether the advance keeps a validated copy of the state on the
    device (admission prices the state twice then): a planned run, or
    a supervised one (rotating checkpoints, a drain guard, retries, a
    failover)."""
    xp = cfg.experimental
    return bool(xp.capacity_plan != "static" or xp.checkpoint_every
                or (xp.checkpoint_save and drain_possible(cfg))
                or xp.dispatch_retries or xp.failover != "abort")


def rotation_entries(base: str) -> list[tuple[int, str]]:
    """The rotation files of a checkpoint base path, sorted by sim time
    ascending: `<base>.t<15-digit ns>`; other suffixes (in-flight .tmp
    files) are ignored."""
    out = []
    for p in glob.glob(glob.escape(base) + ".t*"):
        suffix = p[len(base) + 2:]
        if suffix.isdigit():
            out.append((int(suffix), p))
    return sorted(out)


def resolve_checkpoint(path: str) -> str:
    """`checkpoint_load` resolution: a concrete file wins; otherwise the
    newest readable rotation entry of the base path (a truncated npz,
    the file a kill outran, is skipped with a warning)."""
    if os.path.exists(path):
        return path
    entries = rotation_entries(path)
    if not entries:
        raise ValueError(
            f"checkpoint_load: {path!r} does not exist and has no "
            f"rotation entries ({path}.t*) — nothing to resume")
    from shadow_tpu_torch.device import checkpoint

    for t, p in reversed(entries):
        try:
            meta = checkpoint.peek_meta(p)
            if meta.get("format") != checkpoint.FORMAT:
                raise ValueError(f"format {meta.get('format')}")
        except Exception as e:      # noqa: BLE001 — any unreadable entry
            log.warning("skipping unreadable checkpoint %s (%s); "
                        "falling back to the previous rotation entry",
                        p, e)
            continue
        log.info("checkpoint_load: %s resolved to rotation entry %s "
                 "(t=%d ns)", path, p, t)
        return p
    raise ValueError(
        f"checkpoint_load: every rotation entry of {path!r} is "
        "unreadable — nothing to resume")


class Checkpointer:
    """The rotating last-K checkpoint writer of one supervised run.
    Every write is checkpoint.save_state's atomic tmp + rename; pruning
    follows a successful replace, so a complete checkpoint stays on disk
    once the first boundary passes. On a mesh every rank calls `save`
    (the state is gathered to rank 0, which writes, prunes and runs the
    chaos seam). `io` lists each save's {"path", "bytes", "wall_s"}."""

    def __init__(self, base: str, every: int, keep: int,
                 final_stop: int, extra_meta: Optional[dict] = None,
                 audit_enabled: bool = False):
        self.base = base
        self.every = int(every)
        self.keep = max(1, int(keep))
        self.final_stop = int(final_stop)
        self.extra_meta = extra_meta
        self.audit_enabled = bool(audit_enabled)
        self.last_path = ""
        self.last_t = -1
        self.io: list = []

    def next_after(self, t: int) -> int:
        return (t // self.every + 1) * self.every

    def save(self, engine, state, t: int) -> str:
        from shadow_tpu_torch.device import chaos as chaosmod
        from shadow_tpu_torch.device import checkpoint

        path = f"{self.base}.t{t:015d}"
        io = checkpoint.save_state(
            engine, state, path, t, final_stop=self.final_stop,
            extra_meta=self.extra_meta,
            audit_meta={"enabled": self.audit_enabled, "violations": 0})
        self.last_path, self.last_t = path, t
        inj = chaosmod.current()
        if inj is not None:
            # a scripted checkpoint_corrupt truncates the entry just
            # landed (every mesh rank counts, the writer truncates); the
            # run goes on, a resume falls back
            inj.on_checkpoint_saved(path, wrote=io is not None)
        if io is None:          # a mesh rank other than 0
            return path
        self.io.append(io)
        self._prune()
        log.info("rotating checkpoint at t=%d ns -> %s "
                 "(keep %d; resume with checkpoint_load: %s)",
                 t, path, self.keep, self.base)
        return path

    def _prune(self) -> None:
        for _, p in rotation_entries(self.base)[:-self.keep]:
            try:
                os.unlink(p)
            except OSError as e:
                log.warning("could not prune old checkpoint %s: %s",
                            p, e)


@dataclass
class AdvanceResult:
    """What `advance` hands back beside the final state: the summed
    rounds (an [R] array in a campaign), where it ended, every way it
    can end short of `pause` (the round budget, an unplanned overflow,
    a preemption and its resume checkpoint), the retries it absorbed and
    the mesh shrinks it made, and the segment loop's record
    (`pipeline`: segments run, replayed after a re-plan, a retry or a
    shrink, host syncs, graph captures, the kept segments' phases, the
    retries' recovery and replay walls, each shrink's walls:
    `_shrink_recover`)."""

    rounds: np.ndarray = field(default_factory=lambda: np.int64(0))
    t_end: int = 0
    budget_hit: bool = False
    overflowed: bool = False
    preempted: bool = False
    resume_path: str = ""
    retries: int = 0
    reshards: int = 0
    pipeline: dict = field(default_factory=dict)


def _snapshot(state: dict, into: Optional[dict]) -> dict:
    """A copy of `state` on its device (into the tensors of `into` where
    given): the last validated boundary's state a replay or a save
    starts from."""
    if into is None:
        return {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        into[k].copy_(v)
    return into


def _drain_requested(runner, guard) -> bool:
    """The guard's flag; on a mesh its maximum over the ranks, so that
    every rank drains at the same boundary (one all_reduce a
    boundary)."""
    flag = bool(guard.requested)
    mesh = getattr(runner, "mesh", None)
    if mesh is not None:
        flag = bool(mesh.all_max(torch.tensor([int(flag)])).item())
    return flag


def advance(runner, state, t_start: int, pause: int, stop: int,
            ensemble: bool = False):
    """Advance [t_start, pause) in segments (supervise.py:754, the
    serial loop): each ends at the next heartbeat multiple,
    `dispatch_segment` after its start, the next `checkpoint_every`
    multiple, or `pause`, and runs with its windows clamped to `stop`.
    Before each segment a drain request (the guard's flag) saves the
    resume checkpoint and returns preempted. A segment's dispatch error
    retries from the validated copy where it is transient (else, or
    with the retries spent, `_escalate`). At each boundary, in the
    reference's order: overflow (widen, rebuild and replay from the
    validated copy where the plan is not static and fewer than
    MAX_REPLANS re-plans ran, else end loudly; a replayed segment's
    rounds and phases do not count), the cumulative max_rounds budget,
    the health word under the state audit, the heartbeats (not at
    `stop`), the validated copy, the rotation save (not at `stop`).
    `runner` is the device runner or the campaign: its `engine`, `cfg`,
    `replans`, `retries`, `reshards`, `_capacity_overrides`,
    `checkpointer`, `guard`, `chaos`, `_ck_extra_meta`, `mesh` (or
    None), `overflow_counts(state)` (a mesh's sums), `replan(host_state)`
    (the rebuilt engine's state), `reload(path, stop)` (a rebuilt
    engine's state from a checkpoint), `_shrink_to(mesh, host_state)`
    and `_undo_shrink()` (the shrink's re-shard and its rollback) and
    `_emit_heartbeats(t, state)`.

    Returns (state, AdvanceResult)."""
    from shadow_tpu_torch.device import capacity, checkpoint

    xp = runner.cfg.experimental
    hb = runner.cfg.general.heartbeat_interval
    seg = xp.dispatch_segment
    ck: Optional[Checkpointer] = getattr(runner, "checkpointer", None)
    guard: Optional[PreemptionGuard] = getattr(runner, "guard", None)
    chaos_inj = getattr(runner, "chaos", None)
    audit_on = bool(xp.state_audit)
    retry_ok = xp.capacity_plan != "static"
    supervised = bool(ck is not None
                      or (guard is not None and guard.active)
                      or xp.dispatch_retries
                      or xp.failover != "abort")
    keep_good = retry_ok or supervised
    budget = runner.engine.config.max_rounds
    label = "ensemble " if ensemble else ""
    res = AdvanceResult()
    stats = {"segments": 0, "replayed": 0, "host_syncs": 0,
             "captures": 0, "recover_s": [], "replay_s": [],
             "reshards": []}
    phases = np.int64(0)
    res.pipeline = stats
    good = _snapshot(state, None) if keep_good else None
    good_t = t = t_start
    failures = 0
    oom_streak = 0
    replay_from = None
    next_hb = (t // hb + 1) * hb if hb else None
    next_ck = ck.next_after(t) if ck is not None else None

    def next_boundary(ti):
        nxt = pause
        if hb:
            nxt = min(nxt, (ti // hb + 1) * hb)
        if seg:
            nxt = min(nxt, ti + seg)
        if ck is not None:
            nxt = min(nxt, ck.next_after(ti))
        return nxt

    def drain_save(st, ti):
        """The preemption's resume checkpoint: the rotation entry just
        written at this boundary, else one written now."""
        if ck is not None:
            if ck.last_t == ti:
                return ck.last_path
            return ck.save(runner.engine, st, ti)
        path = xp.checkpoint_save
        checkpoint.save_state(
            runner.engine, st, path, ti, final_stop=stop,
            extra_meta=getattr(runner, "_ck_extra_meta", None),
            audit_meta={"enabled": audit_on, "violations": 0})
        return path

    def recover_transient(e, live):
        """A dispatch error: re-raised unless transient with a validated
        copy to replay from; a second consecutive out-of-memory error
        at one boundary raises (the ladder is item 13); past
        `dispatch_retries` consecutive failures the shrink under
        `failover: shrink` (the survivors earn a fresh retry budget),
        else `_escalate`; else back off and put the validated copy back.
        Returns the state to go on from; rewinds t to its boundary."""
        nonlocal failures, oom_streak, t, good, good_t, next_hb, next_ck
        nonlocal replay_from, captures0
        if not is_transient(e) or good is None:
            raise e
        oom_streak = oom_streak + 1 if is_oom(e) else 0
        if oom_streak >= 2 or (is_oom(e) and
                               failures + 1 > xp.dispatch_retries):
            raise RuntimeError(
                f"deterministic device memory exhaustion past t="
                f"{good_t} ns ({e}): the same out-of-memory error "
                "recurred at one validated boundary, and the "
                "degradation ladder that would shrink the footprint is "
                f"not ported to shadow_tpu_torch yet ({ITEM_13})") from e
        failures += 1
        res.retries += 1
        runner.retries = res.retries
        if failures > xp.dispatch_retries:
            if xp.failover == "shrink":
                old = runner.engine
                walls = {}
                shrunk = _shrink_recover(runner, e, good, good_t, ensemble,
                                         ck, walls)
                if shrunk is not None:
                    new_state, t_shrunk = shrunk
                    stats["reshards"].append(walls)
                    failures = 0
                    res.reshards += 1
                    runner.reshards = res.reshards
                    stats["captures"] += old.captures - captures0
                    captures0 = runner.engine.captures
                    del old, live
                    good = _snapshot(new_state, None)
                    good_t = t = int(t_shrunk)
                    next_hb = (t // hb + 1) * hb if hb else None
                    next_ck = ck.next_after(t) if ck is not None else None
                    stats["replayed"] += 1
                    replay_from = time.perf_counter()
                    return new_state
            _escalate(runner, e, good, good_t, stop, ensemble, ck)
        delay = min(xp.dispatch_retry_backoff * (2 ** (failures - 1)),
                    BACKOFF_CAP_S)
        log.warning(
            "transient %sdevice dispatch error past t=%d ns (%s); "
            "discarding %d speculative in-flight segment(s), retry "
            "%d/%d from the last validated state t=%d ns after "
            "%.1fs backoff", label, good_t, e, 0, failures,
            xp.dispatch_retries, good_t, delay)
        if delay:
            time.sleep(delay)
        t0 = time.perf_counter()
        old = runner.engine
        new_state, t_new = _recover_state(runner, live, good, ck, stop)
        if t_new is not None:
            # reloaded from the last rotation entry on a rebuilt engine
            stats["captures"] += old.captures - captures0
            captures0 = runner.engine.captures
            good = _snapshot(new_state, None)
            good_t = t_new
        stats["recover_s"].append(time.perf_counter() - t0)
        stats["replayed"] += 1
        replay_from = time.perf_counter()
        t = good_t
        next_hb = (t // hb + 1) * hb if hb else None
        next_ck = ck.next_after(t) if ck is not None else None
        return new_state

    captures0 = runner.engine.captures
    while t < pause:
        if guard is not None and _drain_requested(runner, guard):
            res.resume_path = drain_save(good if good is not None
                                         else state, t)
            res.preempted = True
            log.warning(
                "%srun preempted at t=%d ns: resume checkpoint -> %s "
                "(re-run with experimental.checkpoint_load: %s to "
                "continue; the resumed run is bit-identical to an "
                "uninterrupted one)", label, t, res.resume_path,
                ck.base if ck is not None else res.resume_path)
            break
        nxt = next_boundary(t)
        try:
            if chaos_inj is not None:
                # the deterministic chaos seam: raises on the host,
                # before the segment launches anything
                chaos_inj.on_dispatch_issue(getattr(runner, "mesh", None))
            state, seg_rounds = runner.engine.run(state, stop=nxt,
                                                  final_stop=stop)
            dims = capacity.overflow_dims(state,
                                          runner.overflow_counts(state))
        except AuditFailure:
            raise
        except Exception as e:  # noqa: BLE001 — classified in recovery
            state = recover_transient(e, state)
            continue
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
            # the overflowed engine's state and copy go before the
            # rebuilt engine allocates
            del state, good
            state = runner.replan(host)
            captures0 = runner.engine.captures
            good = _snapshot(state, None)
            stats["replayed"] += 1
            t = good_t
            next_hb = (t // hb + 1) * hb if hb else None
            next_ck = ck.next_after(t) if ck is not None else None
            continue
        res.rounds = res.rounds + seg_rounds
        phases = phases + np.asarray(runner.engine.loop_stats["phases"],
                                     np.int64)
        t = nxt
        failures = 0        # the segment ran clean: the budget is
        oom_streak = 0      # for consecutive failures only
        if replay_from is not None:
            stats["replay_s"].append(time.perf_counter() - replay_from)
            replay_from = None
        if int(np.max(res.rounds)) >= budget:
            # cumulative: each segment's own cap restarts at 0
            if t < pause:
                log.warning("max_rounds (%d) exhausted during "
                            "%ssegmentation; stopping", budget, label)
            res.budget_hit = True
            break
        if audit_on:
            # validated before it becomes the copy a replay or a
            # checkpoint starts from
            check_audit(state, where=f"t={t} ns",
                        last_good=ck.last_path if ck is not None else "",
                        mesh=getattr(runner, "mesh", None))
        if next_hb is not None and t >= next_hb and t < stop:
            runner._emit_heartbeats(t, state)
            next_hb += hb
        if good is not None and t < pause:
            good = _snapshot(state, good)
            good_t = t
        if next_ck is not None and t >= next_ck and t < stop:
            ck.save(runner.engine, good if good_t == t else state, t)
            next_ck = ck.next_after(t)
    stats["captures"] += runner.engine.captures - captures0
    stats["phases"] = phases.tolist()
    res.t_end = t
    return state, res


def surviving_ranks(mesh, device) -> list[int]:
    """The liveness probe of a shrink (supervise.py:417-442): each rank
    probes its own device (a one-element tensor placed on it, the
    device synchronised), after consulting the chaos injector, so that
    a scripted loss fails the probe as a real one would; the verdicts
    are summed over the mesh's ranks, so that every rank returns the
    same survivors: their positions (device/mesh.py `Mesh.pos`), in
    mesh order. On one device (`mesh` None) [0], or [] where it
    failed."""
    from shadow_tpu_torch.device import chaos as chaosmod

    inj = chaosmod.current()
    pos = 0 if mesh is None else mesh.pos
    dev = torch.device(device if mesh is None else mesh.device)
    ok = 1
    if inj is not None and inj.is_dead(pos):
        log.warning("device %s (mesh position %d) failed the liveness "
                    "probe (scripted device loss)", dev, pos)
        ok = 0
    else:
        try:
            torch.zeros(1, dtype=torch.int32, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception as e:      # noqa: BLE001 — any failure = dead
            log.warning("device %s (mesh position %d) failed the "
                        "liveness probe: %s", dev, pos, e)
            ok = 0
    if mesh is None:
        return [0] if ok else []
    flags = torch.zeros(mesh.size, dtype=torch.int64)
    flags[mesh.rank] = ok
    return [p for p, f in zip(mesh.members, mesh.all_sum(flags).tolist())
            if f]


def _host_copy(state: dict) -> dict:
    """A state's leaves read back to the host (the shrink's gather of
    the validated copy; a dead device's copy may not read)."""
    return {k: v.cpu().numpy() for k, v in state.items()}


def _shrink_recover(runner, exc, good, good_t, ensemble, ck,
                    walls: Optional[dict] = None):
    """`failover: shrink` with the retries spent (supervise.py:445-536):
    probe the mesh, and where some ranks died and some live, re-shard
    the last validated state onto the survivors and hand back the state
    the advance goes on from on the device. Returns (state, its sim
    time), or None where no shrink is possible (nothing dead, nothing
    alive, the state unrecoverable, the re-shard failed on any rank):
    every rank then escalates on the old mesh. A rank found dead raises
    LeftMesh once the survivors' re-shard has succeeded.

    On every rank of the old mesh, in one order: the probe; the
    validated copy, every rank's rows gathered on every rank (where any
    rank cannot read its copy, the newest readable rotation entry, and
    the replay rewinds to its time); the survivors' process group
    (`Mesh.shrink`); each survivor's re-shard and rebuild
    (`runner._shrink_to`: exchange re-planned for M ranks, the engine
    rebuilt, the state re-padded, capacity.reshard_state, and placed);
    the verdicts reduced, so that one failed survivor rolls every
    survivor back (`runner._undo_shrink`) and the failover checkpoint
    keeps the old geometry. Traces do not depend on the mesh's shape and
    the re-shard carries every per-host leaf verbatim, so the N-rank
    prefix and the M-rank rest equal an uninterrupted M-rank run.
    `walls` gets the host seconds of each step (probe_s, gather_s,
    group_s, rebuild_s: the re-plan, the engine and the placed state,
    total_s)."""
    from shadow_tpu_torch.device import checkpoint

    walls = {} if walls is None else walls
    t0 = time.perf_counter()
    mesh = getattr(runner, "mesh", None)
    old_n = 1 if mesh is None else mesh.size
    alive = surviving_ranks(mesh, runner.engine.device)
    walls["probe_s"] = time.perf_counter() - t0
    n_dead = old_n - len(alive)
    if n_dead == 0:
        log.error("shrink failover: every mesh device passed the "
                  "liveness probe — the dispatch failure (%s) cannot "
                  "be attributed to a dead device; escalating", exc)
        return None
    if not alive:
        log.error("shrink failover: no mesh device survived the "
                  "liveness probe; escalating")
        return None
    axis = 1 if ensemble else 0
    t_good = good_t
    try:
        mine = _host_copy(good)
        fetch_err = None
    except Exception as e:          # noqa: BLE001 — a dead device's copy
        mine, fetch_err = None, e
    if int(mesh.all_min(torch.tensor([int(fetch_err is None)])).item()):
        host_state = mesh.all_gather_leaves(mine, axis=axis)
    else:
        if ck is None or not ck.last_path:
            log.error("shrink failover: the last validated state is "
                      "unrecoverable (%s) and no rotating checkpoint "
                      "exists; escalating", fetch_err)
            return None
        log.warning("shrink failover: could not fetch the in-memory "
                    "state (%s); re-sharding the newest readable "
                    "rotating checkpoint instead", fetch_err)
        host_state = None
        for _, p in reversed(rotation_entries(ck.base)):
            try:
                host_state, meta = checkpoint.load_host_state(p)
                break
            except Exception as load_err:   # noqa: BLE001 — torn entry
                log.warning("shrink failover: rotation entry %s is "
                            "unreadable (%s); trying the previous one",
                            p, load_err)
        if host_state is None:
            log.error("shrink failover: no readable rotation entry "
                      "under %s; escalating", ck.base)
            return None
        t_good = int(meta["sim_time"])
    t1 = time.perf_counter()
    walls["gather_s"] = t1 - t0 - walls["probe_s"]
    survivor = mesh.shrink(alive)
    t2 = time.perf_counter()
    walls["group_s"] = t2 - t1
    state, ok = None, 1
    if survivor is not None:
        try:
            state = runner._shrink_to(survivor, host_state, ensemble)
            walls["rebuild_s"] = time.perf_counter() - t2
        except Exception as re_err:     # noqa: BLE001 — escalate, not crash
            log.error("shrink failover: re-sharding onto the %d "
                      "surviving device(s) failed (%s); escalating",
                      len(alive), re_err)
            ok = 0
    if not int(mesh.all_min(torch.tensor([ok])).item()):
        if state is not None:
            runner._undo_shrink()
        return None
    if survivor is None:
        raise LeftMesh(f"mesh position {mesh.pos} failed the liveness "
                       f"probe; the run goes on on positions {alive}")
    walls["total_s"] = time.perf_counter() - t0
    if survivor.rank == 0:
        log.warning(
            "MESH SHRINK: %d device(s) dead (%s) — re-sharded the last "
            "validated state (t=%d ns) onto the %d surviving device(s) "
            "and continuing on-device at %d/%d of mesh throughput; "
            "checkpoints from here stamp the shrunken geometry",
            n_dead, exc, t_good, len(alive), len(alive), old_n)
    return state, t_good


def _recover_state(runner, live: dict, good: dict, ck, stop: int):
    """The validated copy put back for a retry: copied into the live
    tensors (the captured loop's graph is keyed on them: no capture)
    and the engine armed, as for any state from outside. If even that
    fails, the last rotation entry on a rebuilt engine
    (`runner.reload`). Returns (state, its sim time)."""
    try:
        for k, v in good.items():
            live[k].copy_(v)
        runner.engine._arm()
        return live, None
    except Exception as fetch_err:      # noqa: BLE001
        if ck is None or not ck.last_path:
            raise
        log.warning("could not recover the in-memory state (%s); "
                    "reloading the last validated checkpoint %s",
                    fetch_err, ck.last_path)
        return runner.reload(ck.last_path, stop), ck.last_t


def _escalate(runner, exc, good, good_t, stop, ensemble, ck):
    """Retries exhausted: `abort` (and any campaign) re-raises; `hybrid`
    persists the validated copy (`<checkpoint_save>.failover`, else
    `<data_directory>/device_failover.npz`) and raises DeviceFailover
    for the controller's hybrid rerun; where the persist fails the
    last rotation entry pins the resume, and with none the failover
    still runs, `checkpoint_path` None and the persist error named."""
    from shadow_tpu_torch.device import checkpoint

    xp = runner.cfg.experimental
    if xp.failover == "abort" or ensemble:
        raise exc
    path, t_pin = "", good_t
    if ck is not None and ck.last_path:
        path, t_pin = ck.last_path, ck.last_t
    try:
        fo_path = ((xp.checkpoint_save + ".failover")
                   if xp.checkpoint_save else
                   os.path.join(runner.cfg.general.data_directory,
                                "device_failover.npz"))
        checkpoint.save_state(
            runner.engine, good, fo_path, good_t, final_stop=stop,
            audit_meta={"enabled": bool(xp.state_audit),
                        "violations": 0})
        path, t_pin = fo_path, good_t
    except Exception as save_err:       # noqa: BLE001
        if not path:
            raise DeviceFailover(
                f"device dispatch failed permanently after "
                f"{xp.dispatch_retries} retries ({exc}); the last "
                f"validated state at t={good_t} ns could NOT be "
                f"persisted ({save_err})",
                checkpoint_path=None, sim_time=good_t,
                persist_error=str(save_err)) from exc
        log.warning("failover: could not persist the in-memory state "
                    "(%s); the last rotating checkpoint %s (t=%d ns) "
                    "pins the device-side resume", save_err, path,
                    t_pin)
    raise DeviceFailover(
        f"device dispatch failed permanently after "
        f"{xp.dispatch_retries} retries ({exc}); last validated "
        f"state at t={t_pin} ns saved to {path or '<none>'}",
        checkpoint_path=path, sim_time=t_pin) from exc
