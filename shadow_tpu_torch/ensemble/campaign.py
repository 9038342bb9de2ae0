"""EnsembleRunner: R-replica simulation campaigns in one window loop (the
port's copy of the reference package's ensemble/campaign.py, cut to one
GPU without segments, checkpoints, a capacity planner, heartbeats,
chaos or an out-of-memory ladder: ROADMAP.md queue (a) items 7 and 13).

It builds the config once, stacks the replicas' worlds (spec.py), runs
one campaign engine whose every kernel takes the replica as a grid
dimension (device/engine.py; on the card one captured CUDA graph drives
all R replicas) and writes an `ENSEMBLE_*.json` record with
per-replica checksums and aggregate statistics, the reference's record
field for field but for `wall_s` and the admission verdict (the port's
own byte model). Replica i is bit-identical to a standalone run with
replica i's parameters and `experimental.runahead` pinned to the
campaign's lookahead (spec.py's contract), so the aggregates are
statistics over real runs.

Why one loop: a seed, latency, loss or fault sweep run as R processes
pays every launch and every host read R times; as one campaign it pays
them once, and the small per-host shapes of each replica fill the card
together.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Optional

import numpy as np

from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.build import build
from shadow_tpu_torch.device import runner
from shadow_tpu_torch.device.engine import DeviceEngine, state_to_numpy
from shadow_tpu_torch.device.kernels import HEAP_FIELDS, Kernels
from shadow_tpu_torch.device.supervise import check_audit
from shadow_tpu_torch.ensemble.spec import (
    EnsembleWorlds,
    build_worlds,
    slice_worlds,
)

log = logging.getLogger("shadow_tpu_torch.ensemble")

RECORD_FORMAT = 1
# per-replica per-host checksum lists stay inline below this host
# count; larger campaigns keep the sha256 digest only
CHK_INLINE_HOSTS = 64

_AGG_OPS = {
    "mean": np.mean,
    "min": np.min,
    "max": np.max,
    "p5": lambda v: np.percentile(v, 5),
    "p95": lambda v: np.percentile(v, 95),
}


def write_json(obj, path: str) -> None:
    """Write `obj` as JSON to `path` through a temporary file and an
    atomic rename (the reference's atomic_write_json layout)."""
    text = json.dumps(obj, indent=1, sort_keys=True)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def aggregate(values, which) -> dict:
    """Aggregate one per-replica metric vector with the configured
    statistics (mean/p5/p95/min/max)."""
    v = np.asarray(values, np.float64)
    return {k: float(_AGG_OPS[k](v)) for k in which}


class EnsembleRunner:
    """Runs the `ensemble:` campaign of a config on `device` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: ConfigOptions, device="cuda",
                 kernels: Optional[Kernels] = None):
        if cfg.ensemble is None:
            raise ValueError("EnsembleRunner needs an ensemble: "
                             "config block")
        self.cfg = cfg
        self.device = device
        self.kernels = kernels
        self.sim = build(cfg)
        self.app = self.sim.app
        self.worlds: EnsembleWorlds = build_worlds(self.sim, cfg.ensemble)
        self.admission: Optional[dict] = None
        self.record: Optional[dict] = None
        self.final_state: Optional[dict] = None
        # the last campaign engine's loop_stats (one per batch)
        self.loop_stats: list = []

    @property
    def lookahead(self) -> int:
        """The campaign's shared lookahead window: the minimum over
        every replica's tables (each replica's standalone floor is >=
        it, so it is conservative for all). A standalone run that
        replica i must equal pins `experimental.runahead` to it."""
        xp = self.cfg.experimental
        if xp.runahead is not None:
            return max(1, xp.runahead)
        return max(1, min(self.worlds.lookahead, self.sim.lookahead))

    def engine(self, worlds: Optional[EnsembleWorlds] = None):
        """The campaign engine of `worlds` (default: the whole
        campaign), at the full campaign's lookahead."""
        return runner.engine_from(
            self.cfg, self.sim, self.device, self.kernels,
            ensemble=self.worlds if worlds is None else worlds,
            lookahead=self.lookahead)

    def replica_engine(self, r: int, kernels: Optional[Kernels] = None):
        """The standalone engine of replica r: its tables, epoch times
        and seed, the campaign's lookahead; what replica r of the
        campaign must equal, leaf for leaf."""
        w = self.worlds
        config = runner.engine_config(self.cfg, self.sim, self.lookahead)
        config.seed = int(w.seeds[r])
        lat, rel = (tuple(a[r] for a in t) if isinstance(t, tuple)
                    else t[r] for t in (w.latency, w.reliability))
        engine = DeviceEngine(config, self.app, self.sim.host_vertex, lat,
                              rel, device=self.device, kernels=kernels,
                              epoch_times=w.epoch_times[r],
                              bw_up_bits=self.sim.bw_up_bits,
                              bw_down_bits=self.sim.bw_down_bits)
        return engine

    # ------------------------------------------------------------------
    def record_path(self) -> str:
        """The campaign record's path: ensemble.record_path, else
        ENSEMBLE_<app>_<hosts>_<campaign>.json under $SHADOW_TPU_OCC_DIR
        (default `artifacts`)."""
        eopts = self.cfg.ensemble
        if eopts.record_path:
            return eopts.record_path
        directory = os.environ.get("SHADOW_TPU_OCC_DIR", "artifacts")
        return os.path.join(
            directory,
            f"ENSEMBLE_{type(self.app).__name__}"
            f"_{len(self.sim.host_vertex)}_{self.worlds.campaign_fp}.json")

    def _build_record(self, final: dict, rounds_r, wall: float,
                      ok: bool) -> dict:
        H = len(self.sim.host_vertex)
        w = self.worlds
        eopts = self.cfg.ensemble
        metrics = {
            "events_executed": final["n_exec"].sum(1),
            "packets_sent": final["n_sent"].sum(1),
            "packets_dropped": final["n_drop"].sum(1),
            "packets_delivered": final["n_deliv"].sum(1),
            "rounds": np.asarray(rounds_r),
        }
        replicas = []
        for r in range(w.R):
            chk = np.ascontiguousarray(final["chk"][r])
            entry = dict(w.descriptors[r])
            entry.update({
                "events_executed": int(metrics["events_executed"][r]),
                "packets_sent": int(metrics["packets_sent"][r]),
                "packets_dropped": int(metrics["packets_dropped"][r]),
                "packets_delivered": int(
                    metrics["packets_delivered"][r]),
                "host_checksums_sha256": hashlib.sha256(
                    chk.tobytes()).hexdigest()[:16],
            })
            if H <= CHK_INLINE_HOSTS:
                entry["host_checksums"] = [int(c) for c in chk]
            replicas.append(entry)
        return {
            "format": RECORD_FORMAT,
            "campaign": w.campaign_fp,
            "workload": {
                "app": type(self.app).__name__,
                "n_hosts": H,
                "stop_time": int(self.cfg.general.stop_time),
                "replicas": w.R,
                "lookahead": self.lookahead,
            },
            "vary": w.descriptors,
            "replicas": replicas,
            "aggregates": {
                name: aggregate(vals, eopts.aggregate)
                for name, vals in metrics.items()},
            "wall_s": round(wall, 3),
            "replans": 0,
            "ok": bool(ok),
        }

    # ------------------------------------------------------------------
    def _run_once(self, worlds: EnsembleWorlds, stop: int):
        """One campaign engine over `worlds`, run to `stop`: (its final
        leaves without the heaps, as numpy arrays, [R] rounds). Under
        the state audit, raises AuditFailure where a replica's word is
        not zero."""
        engine = self.engine(worlds)
        state = engine.init_ensemble_state(self.sim.start_times,
                                           self.sim.stop_times)
        state, rounds = engine.run(state, stop)
        self.loop_stats.append(engine.loop_stats)
        check_audit(state, where=f"t={stop} ns")
        final = state_to_numpy(state, [k for k in state
                                       if k not in HEAP_FIELDS])
        return final, np.asarray(rounds, np.int64)

    def _run_batched(self, stop: int, batch: int):
        """Sequential replica batches of <= `batch`, each a campaign
        engine over its slice of the worlds at the full campaign's
        lookahead, so batch boundaries cannot move round boundaries;
        the finals merged over the replica axis. Bit-identical to the
        full campaign: each replica's trace is a pure function of its
        own world (spec.py's contract)."""
        R = int(self.worlds.R)
        batch = max(1, min(int(batch), R))
        n_batches = -(-R // batch)
        log.warning(
            "replica batching: running %d replica(s) as %d sequential "
            "batch(es) of <= %d (one campaign engine per batch, finals "
            "merged — bit-identical to the full campaign)", R,
            n_batches, batch)
        finals, rounds = [], []
        for b in range(n_batches):
            lo, hi = b * batch, min(R, (b + 1) * batch)
            final, r = self._run_once(slice_worlds(self.worlds, lo, hi),
                                      stop)
            finals.append(final)
            rounds.append(r)
        merged = {k: np.concatenate([f[k] for f in finals], axis=0)
                  for k in finals[0]}
        return merged, np.concatenate(rounds)

    def run(self, stop: Optional[int] = None) -> runner.SimStats:
        """Admit, run and record the campaign to `stop` (default the
        config's stop time); returns SimStats with the totals over every
        replica, replica 0's per-host events and checksums, the maximum
        rounds and the record in `ensemble`."""
        stop = self.cfg.general.stop_time if stop is None else int(stop)
        w = self.worlds
        self.loop_stats = []
        knob_batch = int(self.cfg.ensemble.replica_batch or 0)
        # preflight admission of the whole campaign, before anything is
        # allocated on the device; `auto` may split it into batches
        self.admission = runner.admit(
            self.cfg, self.sim, runner.engine_config(
                self.cfg, self.sim, lookahead=self.lookahead),
            self.device, ensemble=w,
            batchable=w.R > 1 and not knob_batch)
        batch = knob_batch or int(
            self.admission["overrides"].get("replica_batch", 0))
        t0 = time.perf_counter()
        if batch:
            final, rounds_r = self._run_batched(stop, batch)
        else:
            final, rounds_r = self._run_once(w, stop)
        wall = time.perf_counter() - t0
        self.final_state = final
        overflow = int(final["overflow"].sum())
        x_overflow = int(final["x_overflow"].sum())
        ok = overflow == 0 and x_overflow == 0
        self.record = self._build_record(final, rounds_r, wall, ok)
        self.record["admission"] = self.admission
        if batch:
            self.record["replica_batch"] = int(batch)
        path = self.record_path()
        try:
            write_json(self.record, path)
            log.info("ensemble record -> %s", path)
        except OSError as e:
            log.warning("could not write ensemble record %s: %s", path, e)
        n_exec_total = int(final["n_exec"].sum())
        log.info("ensemble perf: %d replicas, %d rounds in %.2fs wall "
                 "(%.0f events/s aggregate)", w.R, int(rounds_r.max()),
                 wall, n_exec_total / wall if wall > 0 else 0.0)
        stats = runner.SimStats(
            end_time=stop, rounds=int(rounds_r.max()), wall_s=wall,
            events_executed=n_exec_total,
            packets_sent=int(final["n_sent"].sum()),
            packets_dropped=int(final["n_drop"].sum()),
            packets_delivered=int(final["n_deliv"].sum()),
            # replica 0's per-host results stand for the hosts, as the
            # reference surfaces them on its host objects
            host_events_executed=final["n_exec"][0].astype(np.int64),
            host_trace_checksum=final["chk"][0],
            overflow=overflow, x_overflow=x_overflow,
            admission=self.admission, ensemble=self.record)
        loops = self.loop_stats
        stats.loop = loops[0]["loop"]
        stats.phases = max(max(s["phases"]) for s in loops)
        stats.host_syncs = sum(s["host_syncs"] for s in loops)
        downloads = [self.app.downloads(a) for a in final["app"]]
        if downloads[0] is not None:
            stats.downloads_completed = int(sum(downloads))
        stats.ok = ok
        if overflow:
            log.error("ensemble engine overflow: %d events lost — raise "
                      "experimental.event_capacity/outbox_capacity",
                      overflow)
        return stats
