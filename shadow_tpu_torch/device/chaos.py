"""Deterministic chaos injection at the supervise seams (the port's
copy of the reference package's device/chaos.py, cut to the two kinds
the port runs: `dispatch_error` and `checkpoint_corrupt`).

`experimental.chaos` declares a schedule of fault points, and the
injector fires each at a deterministic seam counter, never from a
timer, a signal or randomness, so that one schedule against one config
reproduces the identical run, failures included:

* `dispatch_error`: a one-shot error at the `segment`-th dispatch of
  the supervised advance (device/supervise.py `advance`), raised on the
  host before the segment launches anything. Its message leads with
  the event's `error` class (default UNAVAILABLE, transient), so a
  retry drill walks the real retry and failover ladder, and a
  non-transient class drills the abort;
* `checkpoint_corrupt`: after the `entry`-th rotation save lands
  (supervise.Checkpointer.save), the file is truncated mid-payload, the
  artifact a kill can leave, so that a resume must fall back to the
  newest readable entry (supervise.resolve_checkpoint).

The schedule is validated against every kind of the reference
(`events_from_config`, with its messages); the kinds the port does not
run (`device_loss`, `oom`, `cache_store_fail`, `server_crash`) are
refused by core/build.py naming their ROADMAP items. Dispatch issues
count every segment of the advance, replays included (control flow is
deterministic, so the count sequence is too); rotation saves count
Checkpointer.save calls. The injector is process-global per run
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
        self._issues = 0
        self._ck_saves = 0
        self.fired: list = []

    def on_dispatch_issue(self, engine) -> None:
        """Count one dispatch issue; raise a `dispatch_error` scheduled
        at this count (once), before the segment launches."""
        with self._lock:
            k = self._issues
            self._issues += 1
            hit = None
            for ev in self._events:
                if ev.kind == "dispatch_error" and ev.segment == k:
                    hit = ev
                    self.fired.append({"kind": "dispatch_error",
                                       "segment": k, "error": ev.error})
        if hit is not None:
            raise ChaosError(f"{hit.error}: chaos: scripted dispatch "
                             f"error at issue {k}")

    def on_checkpoint_saved(self, path: str) -> None:
        """Count one rotation save; truncate the file on disk where a
        `checkpoint_corrupt` is scheduled at this count (the run itself
        is untouched)."""
        with self._lock:
            n = self._ck_saves
            self._ck_saves += 1
            hit = any(ev.kind == "checkpoint_corrupt" and ev.entry == n
                      for ev in self._events)
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
