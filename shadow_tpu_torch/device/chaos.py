"""Deterministic chaos injection at the supervise seams (the port's
copy of the reference package's device/chaos.py, cut to the three kinds
the port runs: `device_loss`, `dispatch_error` and `checkpoint_corrupt`).

`experimental.chaos` declares a schedule of fault points, and the
injector fires each at a deterministic seam counter, never from a
timer, a signal or randomness, so that one schedule against one config
reproduces the identical run, failures included:

* `device_loss`: at the `segment`-th dispatch of the supervised advance
  (device/supervise.py `advance`), the mesh rank at position `shard` of
  the current mesh is marked dead. Every later dispatch on a mesh that
  holds a dead rank raises the event's `error` class (a real lost chip
  fails every dispatch that touches it, so the retries run out) until a
  mesh shrink rebuilds the run on the survivors; the liveness probe
  (supervise.surviving_ranks) consults `is_dead`, so that a scripted
  loss fails it as a real one would. Several ranks of one mesh share a
  card in the port's one-card meshes, so the dead set is keyed by the
  rank's position in the original mesh (device/mesh.py `Mesh.pos`),
  which a shrink's renumbering keeps;
* `dispatch_error`: a one-shot error at the `segment`-th dispatch,
  raised on the host before the segment launches anything. Its message
  leads with the event's `error` class (default UNAVAILABLE, transient),
  so a retry drill walks the real retry and failover ladder, and a
  non-transient class drills the abort;
* `checkpoint_corrupt`: after the `entry`-th rotation save lands
  (supervise.Checkpointer.save), the file is truncated mid-payload, the
  artifact a kill can leave, so that a resume must fall back to the
  newest readable entry (supervise.resolve_checkpoint).

The schedule is validated against every kind of the reference
(`events_from_config`, with its messages); the kinds the port does not
run (`oom`, `cache_store_fail`, `server_crash`) are refused by
core/build.py naming their ROADMAP items. Dispatch issues count every
segment of the advance, replays included (control flow is
deterministic, so the count sequence is too), on every rank of a mesh
alike, so that every rank raises at the same issue, before any launch,
and no peer is left waiting in a collective; rotation saves count
Checkpointer.save calls, on every rank too (the rank that writes
truncates). The injector is process-global per run
(`set_current`/`current`), installed by the runners from the config: a
run without a schedule installs None, so that nothing leaks between
runs.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass

log = logging.getLogger("shadow_tpu_torch.chaos")

KINDS = ("device_loss", "dispatch_error", "checkpoint_corrupt",
         "cache_store_fail", "oom", "server_crash")

# transient by default: UNAVAILABLE matches supervise.TRANSIENT_MARKERS
DEFAULT_ERROR = "UNAVAILABLE"
OOM_ERROR = "RESOURCE_EXHAUSTED"


class ChaosError(RuntimeError):
    """A scripted fault. The message leads with the event's error class
    so that supervise.is_transient classifies it as the real error it
    stands in for."""


@dataclass(frozen=True)
class ChaosEvent:
    """One validated `experimental.chaos` entry."""

    kind: str
    segment: int = -1      # device_loss/dispatch_error/oom: dispatch #
    shard: int = -1        # device_loss: mesh position of the dying chip
    error: str = DEFAULT_ERROR
    entry: int = -1        # checkpoint_corrupt: rotation save #
    store: int = -1        # cache_store_fail: cache store #
    compile: int = -1      # oom: program compile #
    tick: int = -1         # server_crash: campaign-server tick #


def event_from_dict(i: int, d: dict) -> ChaosEvent:
    """One `experimental.chaos[i]` mapping -> a validated ChaosEvent
    (chaos.py:79-150): a typo'd schedule fails at load, not as a run
    that silently never injects."""
    section = f"experimental.chaos[{i}]"
    if not isinstance(d, dict):
        raise ValueError(f"{section} must be a mapping")
    allowed = {"kind", "segment", "shard", "error", "entry", "store",
               "compile", "tick"}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown key(s) in {section}: "
                         f"{sorted(unknown)} (allowed: "
                         f"{sorted(allowed)})")
    kind = d.get("kind")
    if kind not in KINDS:
        raise ValueError(
            f"{section}.kind={kind!r} is not one of {list(KINDS)}")
    need = {"device_loss": ("segment", "shard"),
            "dispatch_error": ("segment",),
            "checkpoint_corrupt": ("entry",),
            "cache_store_fail": ("store",),
            "oom": (),
            "server_crash": ("tick",)}[kind]
    for key in need:
        if d.get(key) is None or int(d[key]) < 0:
            raise ValueError(
                f"{section}: {kind} needs {key!r} >= 0 (the "
                "deterministic seam counter the fault fires at)")
    if kind == "oom":
        has_seg = d.get("segment") is not None and int(d["segment"]) >= 0
        has_cmp = d.get("compile") is not None and int(d["compile"]) >= 0
        if has_seg == has_cmp:
            raise ValueError(
                f"{section}: oom needs exactly one of 'segment' "
                "(dispatch issue #) or 'compile' (program compile #) "
                ">= 0")
    scope = {"device_loss": ("segment", "shard", "error"),
             "dispatch_error": ("segment", "error"),
             "checkpoint_corrupt": ("entry",),
             "cache_store_fail": ("store",),
             "oom": ("segment", "compile", "error"),
             "server_crash": ("tick",)}[kind]
    for key in ("segment", "shard", "entry", "store", "compile",
                "tick", "error"):
        if key not in scope and d.get(key) is not None:
            raise ValueError(
                f"{section}: {key!r} is not valid for {kind}")
    return ChaosEvent(
        kind=kind,
        segment=int(d.get("segment", -1)),
        shard=int(d.get("shard", -1)),
        error=str(d.get("error",
                        OOM_ERROR if kind == "oom" else DEFAULT_ERROR)),
        entry=int(d.get("entry", -1)),
        store=int(d.get("store", -1)),
        compile=int(d.get("compile", -1)),
        tick=int(d.get("tick", -1)),
    )


def events_from_config(raw: list) -> list[ChaosEvent]:
    """Validate the whole `experimental.chaos` list (config/schema.py
    delegates here); validated ChaosEvent entries pass through."""
    if not isinstance(raw, list):
        raise ValueError("experimental.chaos must be a list of fault "
                         "events")
    return [d if isinstance(d, ChaosEvent) else event_from_dict(i, d)
            for i, d in enumerate(raw)]


class ChaosInjector:
    """Fires a validated schedule at the dispatch and checkpoint seams;
    `fired` is the ledger of what fired. Counter updates hold a lock, as
    the reference's do."""

    def __init__(self, events: list[ChaosEvent]):
        self._lock = threading.Lock()
        self._events = tuple(events)
        # original mesh positions -> the error class their loss raises
        self._dead: dict = {}
        self._issues = 0
        self._ck_saves = 0
        self.fired: list = []

    def on_dispatch_issue(self, mesh) -> None:
        """Count one dispatch issue; fire the events scheduled at this
        count (a `device_loss` marks its rank dead, a `dispatch_error`
        raises once), then raise where the run's mesh (device/mesh.py
        `Mesh`; None: one device, position 0) holds a dead rank
        (chaos.py:205-262). Raised on the host, before the segment
        launches."""
        members = [0] if mesh is None else list(mesh.members)
        with self._lock:
            k = self._issues
            self._issues += 1
            hit = None
            for ev in self._events:
                if ev.segment != k:
                    continue
                if ev.kind == "device_loss":
                    if ev.shard >= len(members):
                        raise ValueError(
                            f"chaos: device_loss shard {ev.shard} is "
                            f"out of range for the {len(members)}-"
                            "device mesh")
                    pos = members[ev.shard]
                    self._dead[pos] = ev.error
                    self.fired.append({"kind": "device_loss",
                                       "segment": k, "shard": ev.shard,
                                       "position": pos})
                    log.warning("chaos: mesh rank at position %d (shard "
                                "%d) marked DEAD at dispatch issue %d",
                                pos, ev.shard, k)
                elif ev.kind == "dispatch_error":
                    hit = ev
                    self.fired.append({"kind": "dispatch_error",
                                       "segment": k, "error": ev.error})
            down = sorted((p, self._dead[p]) for p in members
                          if p in self._dead)
        if hit is not None:
            raise ChaosError(f"{hit.error}: chaos: scripted dispatch "
                             f"error at issue {k}")
        if down:
            raise ChaosError(
                f"{down[0][1]}: chaos: mesh device(s) "
                f"{[p for p, _ in down]} are down (scripted device "
                "loss)")

    def is_dead(self, position: int) -> bool:
        """The liveness probe's hook: whether the rank at this original
        mesh position was scripted dead."""
        with self._lock:
            return position in self._dead

    def on_checkpoint_saved(self, path: str, wrote: bool = True) -> None:
        """Count one rotation save; truncate the file on disk where a
        `checkpoint_corrupt` is scheduled at this count and this process
        `wrote` it (on a mesh every rank counts, the writer truncates;
        the run itself is untouched)."""
        with self._lock:
            n = self._ck_saves
            self._ck_saves += 1
            hit = wrote and any(ev.kind == "checkpoint_corrupt"
                                and ev.entry == n for ev in self._events)
            if hit:
                self.fired.append({"kind": "checkpoint_corrupt",
                                   "entry": n, "path": path})
        if not hit:
            return
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 3))
        log.warning("chaos: rotation entry %d corrupted on disk "
                    "(truncated %s — the newest-readable fallback "
                    "must skip it on resume)", n, path)


# the run's injector, installed by the runners (None without a
# schedule); the checkpoint seam reads it here
_CURRENT = None


def current():
    return _CURRENT


def set_current(injector) -> None:
    global _CURRENT
    _CURRENT = injector


def from_config(xp):
    """The runners' injector from validated `experimental.chaos` (None
    without a schedule)."""
    events = getattr(xp, "chaos", None)
    if not events:
        return None
    return ChaosInjector(events_from_config(events))
