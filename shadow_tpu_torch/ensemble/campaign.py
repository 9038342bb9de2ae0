"""EnsembleRunner: R-replica simulation campaigns in one window loop (the
port's copy of the reference package's ensemble/campaign.py, on one GPU
or on the host mesh, without the out-of-memory ladder: ROADMAP.md queue
(a) item 13.2).

On a mesh (`mesh=`, device/mesh.py; `experimental.mesh_shards`) every
rank runs one EnsembleRunner whose engine holds its H_loc hosts of all R
replicas (the reference's `_run_ens_shard`: the replica axis composes
outside the mesh axis), and every flush moves every replica's packs in
the collectives of a standalone mesh run (device/engine.py `_exchange`).
Every decision that ends, widens or replays the campaign is taken from
values reduced over the ranks; rank 0 gathers the final leaves along
the host axis ([R, H_pad, ...]), prints the `[ensemble-heartbeat]`
lines, writes the record and returns the stats (the other ranks return
None). A campaign's failover is the shrink (campaign.py:182-215): a mesh
that lost ranks re-shards every replica onto the survivors (the replica
axis stays whole, `_Segments._shrink_to`) and goes on; on one device,
or where nothing died, the campaign re-raises with its checkpoints on
disk (the hybrid rung cannot run replicas).

Checkpoints (device/checkpoint.py) carry the campaign's stamp
(`ensemble`: its `campaign_fp` and R), so that a standalone run refuses
them and a campaign refuses a standalone checkpoint or another
campaign's. Under `replica_batch` each batch rotates its own series
`<checkpoint_save>.b<k>.t<ns>` (every batch restarts at t = 0), stamped
with its replica window; a drain saves the running batch's entry and
stops, and a resume runs the batches before it afresh (pure functions
of their worlds), loads the stamped batch and runs the rest, so that
the resumed campaign's record equals the uninterrupted one's.

A campaign runs through the segmented advance (device/supervise.py
`advance`, `ensemble=True`): segments at heartbeat multiples and
`dispatch_segment`, one `[ensemble-heartbeat]` line per replica at each
heartbeat. Under `capacity_plan` the warm-up slice runs the campaign
engine and the plan sizes every capacity from the worst-case replica
(`_worst_case_view`: high-water marks the maximum over the replicas,
overflow counters their sum), so that no replica overflows another's
tight plan; an overflow widens and replays every replica from the last
validated boundary.

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

import contextlib
import hashlib
import logging
import os
import time
from typing import Optional

import numpy as np

import torch

from shadow_tpu_torch import simtime
from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.build import build
from shadow_tpu_torch.device import capacity, checkpoint, runner, supervise
from shadow_tpu_torch.device import chaos as chaosmod
from shadow_tpu_torch.device.engine import DeviceEngine, mesh_stats, \
    state_to_numpy
from shadow_tpu_torch.device.kernels import HEAP_FIELDS, Kernels
from shadow_tpu_torch.device.supervise import AdvanceResult, \
    HeartbeatMonitor, advance, heartbeat_rates
from shadow_tpu_torch.ensemble.spec import (
    EnsembleWorlds,
    build_worlds,
    slice_worlds,
)
from shadow_tpu_torch.utils.artifacts import atomic_write_json

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


def aggregate(values, which) -> dict:
    """Aggregate one per-replica metric vector with the configured
    statistics (mean/p5/p95/min/max)."""
    v = np.asarray(values, np.float64)
    return {k: float(_AGG_OPS[k](v)) for k in which}


class EnsembleRunner:
    """Runs the `ensemble:` campaign of a config on `device` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: ConfigOptions, device="cuda",
                 kernels: Optional[Kernels] = None, mesh=None):
        if cfg.ensemble is None:
            raise ValueError("EnsembleRunner needs an ensemble: "
                             "config block")
        self.cfg = cfg
        self.device = device
        self.kernels = kernels
        # this rank's device/mesh.py Mesh, or None on one device
        self.mesh = mesh
        # the heaps too in `final_state` (a mesh run's kept leaves)
        self.keep_heaps = False
        # the schedule `exchange: auto` resolved to ("" before a plan)
        self._exchange_choice = ""
        # the last engine's exchange record on a mesh (mesh_stats)
        self.mesh_record: Optional[dict] = None
        self.sim = build(cfg)
        self.app = self.sim.app
        self.worlds: EnsembleWorlds = build_worlds(self.sim, cfg.ensemble)
        self.admission: Optional[dict] = None
        self.record: Optional[dict] = None
        self.final_state: Optional[dict] = None
        # each batch's loop record, summed over its segments: the loop,
        # the replicas' rounds and phases, the host syncs
        self.loop_stats: list = []
        # the planner's capacity knobs and re-plans (as DeviceRunner's)
        self._capacity_overrides: dict = {}
        self.replans = 0
        self.occ_record: Optional[dict] = None
        self.hb_monitor: Optional[HeartbeatMonitor] = None
        self._hb_mark = None
        # the segment record of each batch, and the graph captures and
        # engines of the whole campaign
        self.segments: list = []
        self.captures = 0
        self.engines_built = 0
        self.warmup_wall_s = 0.0
        self._last_engine: Optional[DeviceEngine] = None
        # supervision (device/supervise.py), set per run; campaign
        # checkpoints carry the campaign's stamp
        self.retries = 0
        self.reshards = 0
        self.guard: Optional[supervise.PreemptionGuard] = None
        self._ck_extra_meta = {"campaign": self.worlds.campaign_fp,
                               "replicas": int(self.worlds.R)}
        self.ck_io: dict = {}
        self.chaos = chaosmod.from_config(cfg.experimental)
        chaosmod.set_current(self.chaos)

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
        campaign), at the full campaign's lookahead, with the plan's
        capacities; admitted (the state twice where the advance keeps a
        validated copy: planned or supervised) before it allocates."""
        self.engines_built += 1
        exchange = self._exchange_choice or (
            "all_to_all" if self.cfg.experimental.exchange == "auto"
            else "")
        return runner.engine_from(
            self.cfg, self.sim, self.device, self.kernels,
            ensemble=self.worlds if worlds is None else worlds,
            lookahead=self.lookahead, mesh=self.mesh,
            overrides=self._capacity_overrides, exchange=exchange,
            copies=2 if supervise.keeps_copy(self.cfg) else 1)

    @property
    def lead(self) -> bool:
        """Whether this process writes, logs and returns (one device, or
        a mesh's rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _gather(self, final: dict) -> Optional[dict]:
        """A rank's final leaves [R, H_loc, ...] gathered along the host
        axis on rank 0 ([R, H_pad, ...]; None on the other ranks); one
        device's as they are."""
        if self.mesh is None:
            return final
        return self.mesh.gather_leaves(final, axis=1)

    @property
    def _planned(self) -> bool:
        return self.cfg.experimental.capacity_plan != "static"

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
        final = {k: v[:, :H] for k, v in final.items()}
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
            "replans": self.replans,
            "ok": bool(ok),
        }

    # ------------------------------------------------------------------
    def _worst_case_view(self, states, mesh=None) -> dict:
        """The [R, ...] occupancy and overflow leaves reduced to the
        standalone shapes capacity.measure reads (campaign.py:218): the
        maximum over the replicas for the high-water marks (the
        worst-case replica sizes the shared capacities), the sum for the
        loud overflow counters; with `mesh`, a rank's view then reduced
        over the ranks (runner.mesh_view: the same on every rank)."""
        view = {}
        for k in ("occ_heap", "occ_ob", "occ_in", "occ_x", "occ_trips",
                  "occ_phases"):
            view[k] = capacity.host_array(states[k]).max(0)
        for k in ("overflow", "x_overflow"):
            view[k] = capacity.host_array(states[k]).sum(0)
        return view if mesh is None else runner.mesh_view(mesh, view)

    def _plan_capacities(self, stop: int, load_path: str = "") -> None:
        """capacity_plan on the campaign (campaign.py:238): the warm-up
        slice runs the campaign engine, in `dispatch_segment` pieces,
        widened up to MAX_REPLANS times where it overflows; the plan
        sizes every capacity from the worst-case replica. A record path
        must be of this workload. A resume adopts the checkpoint's
        capacities instead (runner.checkpoint_caps)."""
        xp = self.cfg.experimental
        mode = xp.capacity_plan
        t0 = time.perf_counter()
        if load_path:
            self._capacity_overrides, exchange = runner.checkpoint_caps(
                load_path)
            if xp.exchange == "auto":
                self._exchange_choice = exchange
            self.warmup_wall_s = time.perf_counter() - t0
            log.warning("capacity_plan: %s skipped — checkpoint_load "
                        "resumes with the saved engine's capacities "
                        "%s", mode, self._capacity_overrides)
            return
        engine = self.engine()
        static_knobs = {k: getattr(engine.config, k)
                        for k in capacity.CAPACITY_KNOBS}
        per_iter = engine.effective["M_out"]
        if mode == "auto":
            warm = min(xp.capacity_warmup or max(1, stop // 8), stop)
            seg = xp.dispatch_segment
            states = engine.init_ensemble_state(self.sim.start_times,
                                                self.sim.stop_times)
            for attempt in range(capacity.MAX_REPLANS + 1):
                t, dims = 0, ()
                while t < warm:
                    nxt = min(warm, t + seg) if seg else warm
                    states, _ = engine.run(states, stop=nxt,
                                           final_stop=stop)
                    t = nxt
                    dims = capacity.overflow_dims(
                        states, runner.overflow_counts(states, self.mesh))
                    if dims:
                        break
                if not dims:
                    break
                if attempt == capacity.MAX_REPLANS:
                    raise RuntimeError(
                        f"ensemble capacity warm-up still overflows "
                        f"after {capacity.MAX_REPLANS} doublings on "
                        f"{dims}")
                self._capacity_overrides = capacity.widen(
                    self._capacity_overrides, dims, engine.effective)
                log.warning("ensemble capacity warm-up overflowed on %s; "
                            "retrying with %s", dims,
                            self._capacity_overrides)
                self.captures += engine.captures
                del states, engine
                _free(self.device)
                engine = self.engine()
                states = engine.init_ensemble_state(self.sim.start_times,
                                                    self.sim.stop_times)
            record = capacity.measure(
                engine, self._worst_case_view(states, self.mesh),
                source=f"ensemble-warmup:{warm}ns")
            self.captures += engine.captures
            del states
        else:
            record = capacity.load_record(mode)
            want = {"app": type(self.app).__name__,
                    "app_fp": capacity.app_fingerprint(self.app),
                    "n_hosts": len(self.sim.host_vertex)}
            got = {k: record["workload"].get(k) for k in want}
            if got != want:
                raise ValueError(
                    f"occupancy record {mode} was measured on {got}; "
                    f"this campaign is {want} — re-measure with "
                    "capacity_plan: auto")
        n_shards = engine.n_shards
        del engine
        _free(self.device)
        floor = 4 if max(1, self.app.burst_pops) > 1 else 8
        headroom = xp.capacity_headroom or capacity.HEADROOM
        # the worst-case view reduced occ_x over the replicas (and the
        # ranks): the auto choice and the per-phase caps cover every
        # replica (campaign.py:320-330)
        exchange = xp.exchange
        if exchange == "auto":
            exchange, info = capacity.choose_exchange(
                record, n_shards, per_iter=per_iter, floor_iters=floor,
                headroom=headroom)
            record["exchange_auto"] = info
            self._exchange_choice = exchange
            if n_shards > 1 and self.lead:
                log.info("exchange: auto -> %s (per-flush row estimates "
                         "%s)", exchange, info["estimates"])
        planned = capacity.plan(
            record, per_iter=per_iter, floor_iters=floor,
            n_shards=n_shards, headroom=headroom, exchange=exchange)
        record["planned"] = planned
        record["static"] = static_knobs
        self.occ_record = record
        self._capacity_overrides = dict(planned)
        self.warmup_wall_s = time.perf_counter() - t0
        if self.lead:
            log.info("ensemble capacity plan (%s, exchange %s): %s  "
                     "[measured %s]", mode, exchange, planned,
                     record["measured"])

    def _emit_heartbeats(self, now: int, states, offset: int = 0) -> None:
        """One `[ensemble-heartbeat]` line per replica at a segment
        boundary (campaign.py:331): its totals from the device counters
        ([R, H] vectors, never the heaps), the pkts/s since the last
        heartbeat (supervise.heartbeat_rates), the re-plans and the
        device memory. `offset`: the first replica of a batch."""
        cols = {k: capacity.host_array(states[k]).astype(np.int64)
                for k in ("n_exec", "n_sent", "n_drop", "n_deliv")}
        cols = self._gather(cols)
        if cols is None:
            return
        if self.hb_monitor is not None:
            self.hb_monitor.beat()
        self._hb_mark, rates = heartbeat_rates(self._hb_mark,
                                               cols["n_sent"].sum(1))
        mem = None
        if torch.device(self.device).type == "cuda":
            _, total = torch.cuda.mem_get_info()
            mem = (torch.cuda.memory_allocated(), total)
        mem_s = (f"{capacity.fmt_bytes(mem[0])}/"
                 f"{capacity.fmt_bytes(mem[1])}"
                 if mem is not None else "n/a")
        for r in range(cols["n_exec"].shape[0]):
            log.info("[ensemble-heartbeat] t=%s replica=%d events=%d "
                     "sent=%d dropped=%d delivered=%d pkts/s=%s "
                     "retries=%d replans=%d mem=%s",
                     simtime.format_time(now), r + offset,
                     int(cols["n_exec"][r].sum()),
                     int(cols["n_sent"][r].sum()),
                     int(cols["n_drop"][r].sum()),
                     int(cols["n_deliv"][r].sum()), rates[r],
                     self.retries, self.replans, mem_s)

    def _run_once(self, worlds: EnsembleWorlds, stop: int, offset: int = 0,
                  t_start: int = 0, pause: Optional[int] = None,
                  load: str = "", ck=None, final_save: bool = False):
        """One campaign engine over `worlds`, advanced from `t_start` (or
        the checkpoint `load`, whose time it takes) to `pause` (default
        `stop`) in segments (`_Segments`), rotating through `ck` where
        given; `final_save` writes checkpoint_save at its end (an
        unbatched campaign's). Returns (its final leaves without the
        heaps, as numpy arrays, [R] rounds, the AdvanceResult). Under
        the state audit, raises AuditFailure at the first boundary where
        a replica's word is not zero."""
        pause = stop if pause is None else pause
        segs = _Segments(self, worlds, offset, ck)
        if load:
            state, t_start, self.ck_io["load"] = checkpoint.load_state(
                segs.engine, segs.template(), load, final_stop=stop)
            log.info("resumed campaign checkpoint %s at t=%d ns", load,
                     t_start)
        else:
            state = segs.engine.init_ensemble_state(self.sim.start_times,
                                                    self.sim.stop_times)
        if pause <= t_start:
            raise ValueError(
                f"checkpoint_save_time {pause} ns is not after "
                f"the campaign's start time {t_start} ns")
        state, adv = advance(segs, state, t_start, pause, stop,
                             ensemble=True)
        engine = segs.engine
        rounds = np.broadcast_to(np.asarray(adv.rounds, np.int64),
                                 (worlds.R,))
        self.loop_stats.append({
            "loop": engine.loop_stats.get("loop", ""),
            "rounds": rounds.tolist(),
            "phases": np.broadcast_to(np.asarray(adv.pipeline["phases"]),
                                      (worlds.R,)).tolist(),
            "host_syncs": adv.pipeline["host_syncs"]})
        self.captures += adv.pipeline["captures"]
        self.segments.append(adv.pipeline)
        if ck is not None:
            self.ck_io.setdefault("rotation", []).extend(ck.io)
        xp = self.cfg.experimental
        if final_save and not adv.preempted:
            if adv.budget_hit or adv.overflowed:
                log.error("%s before the checkpoint boundary — NOT "
                          "saving %s", "max_rounds exhausted"
                          if adv.budget_hit else
                          "capacity overflow (events lost)",
                          xp.checkpoint_save)
            else:
                self.ck_io["save"] = checkpoint.save_state(
                    engine, state, xp.checkpoint_save, adv.t_end,
                    final_stop=stop, extra_meta=self._ck_extra_meta,
                    audit_meta=({"enabled": True, "violations": 0}
                                if xp.state_audit else None))
                log.info("campaign checkpoint saved at t=%d ns -> %s",
                         adv.t_end, xp.checkpoint_save)
        final = self._gather(state_to_numpy(
            state, [k for k in state
                    if self.keep_heaps or k not in HEAP_FIELDS]))
        if engine.mesh_params is not None:
            self.mesh_record = mesh_stats(engine)
        self._last_engine = engine
        return final, rounds, adv

    def _run_batched(self, stop: int, batch: int, resume=None):
        """Sequential replica batches of <= `batch`, each a campaign
        engine over its slice of the worlds at the full campaign's
        lookahead, so batch boundaries cannot move round boundaries;
        the finals merged over the replica axis. Bit-identical to the
        full campaign: each replica's trace is a pure function of its
        own world (spec.py's contract). With `checkpoint_every` each
        batch rotates its own series `<save>.b<k>.t<ns>`, stamped with
        its replica window; a drain stops the loop after saving the
        running batch's entry (merged final None). `resume` = (path,
        replica_lo) loads the stamped batch, the others run afresh.
        Returns (merged final, [R] rounds, the combined AdvanceResult)."""
        xp = self.cfg.experimental
        R = int(self.worlds.R)
        batch = max(1, min(int(batch), R))
        n_batches = -(-R // batch)
        log.warning(
            "replica batching: running %d replica(s) as %d sequential "
            "batch(es) of <= %d (one campaign engine per batch, finals "
            "merged — bit-identical to the full campaign)", R,
            n_batches, batch)
        b_resume = int(resume[1]) // batch if resume is not None else -1
        finals, rounds = [], []
        combined = AdvanceResult()
        for b in range(n_batches):
            lo, hi = b * batch, min(R, (b + 1) * batch)
            # per-replica rate vectors change length across batches
            self._hb_mark = None
            ck = None
            if xp.checkpoint_every:
                ck = supervise.Checkpointer(
                    f"{xp.checkpoint_save}.b{b}", xp.checkpoint_every,
                    xp.checkpoint_keep, final_stop=stop,
                    extra_meta={**self._ck_extra_meta, "replica_lo": lo,
                                "replica_hi": hi, "replica_batch": batch},
                    audit_enabled=xp.state_audit)
            final, r, adv = self._run_once(
                slice_worlds(self.worlds, lo, hi), stop, offset=lo,
                load=resume[0] if b == b_resume else "", ck=ck)
            combined.t_end = adv.t_end
            combined.retries += adv.retries
            combined.reshards += adv.reshards
            combined.budget_hit |= adv.budget_hit
            combined.overflowed |= adv.overflowed
            if adv.preempted:
                # the drain saved this batch's entry; later batches
                # never started, the earlier ones replay on resume
                combined.preempted = True
                combined.resume_path = adv.resume_path
                return None, np.concatenate(rounds) if rounds else \
                    np.zeros(0, np.int64), combined
            finals.append(final)
            rounds.append(r)
        merged = None if finals[0] is None else {
            k: np.concatenate([f[k] for f in finals], axis=0)
            for k in finals[0]}
        return merged, np.concatenate(rounds), combined

    def _resume_checks(self, stop: int, knob_batch: int):
        """checkpoint_load of a campaign (campaign.py:574-650): the
        resolved path and, for a replica-batch entry, (path, its first
        replica). Refuses a standalone checkpoint, another campaign's,
        and a batch entry under another `replica_batch` (or the full-R
        state under one)."""
        xp = self.cfg.experimental
        w = self.worlds
        load_path = supervise.resolve_checkpoint(xp.checkpoint_load)
        meta = checkpoint.peek_meta(load_path)
        ens_meta = meta.get("ensemble") or {}
        camp = ens_meta.get("campaign")
        if camp is None:
            raise ValueError(
                f"checkpoint {load_path} was saved by a "
                "standalone run — an ensemble campaign cannot "
                "resume it")
        if camp != w.campaign_fp:
            raise ValueError(
                f"checkpoint {load_path} belongs to "
                f"campaign {camp}; this config builds "
                f"{w.campaign_fp} — the vary block or schedules "
                "changed, so the saved replicas would diverge")
        resume_batch = None
        saved_lo = ens_meta.get("replica_lo")
        if saved_lo is not None:
            saved_batch = int(ens_meta.get("replica_batch") or 0)
            if knob_batch != saved_batch:
                have = (f"uses replica_batch: {knob_batch}"
                        if knob_batch else
                        "expects the full-R stacked state")
                raise ValueError(
                    f"checkpoint {load_path} was saved by "
                    f"replica batch [{saved_lo}, "
                    f"{ens_meta.get('replica_hi')}) of a "
                    f"replica_batch={saved_batch} campaign — "
                    f"set ensemble.replica_batch: {saved_batch} "
                    f"to resume it (this config {have})")
            resume_batch = (load_path, int(saved_lo))
        elif knob_batch:
            raise ValueError(
                f"checkpoint {load_path} stamps the full-R "
                "stacked state — a replica_batch campaign "
                "cannot resume it (drop ensemble.replica_batch "
                "or resume without the checkpoint)")
        checkpoint.prevalidate_resume(
            load_path, stop, save_path=xp.checkpoint_save,
            save_time=xp.checkpoint_save_time)
        return load_path, resume_batch

    def run(self, stop: Optional[int] = None) -> runner.SimStats:
        """Admit, run and record the campaign to `stop` (default the
        config's stop time); returns SimStats with the totals over every
        replica, replica 0's per-host events and checksums, the maximum
        rounds and the record in `ensemble`; a preempted campaign's
        marked preempted, with its resume checkpoint and no record."""
        stop = self.cfg.general.stop_time if stop is None else int(stop)
        w = self.worlds
        xp = self.cfg.experimental
        self.loop_stats = []
        self.segments = []
        self.replans = 0
        self.retries = 0
        self.reshards = 0
        self.captures = 0
        self.ck_io = {}
        self._hb_mark = None
        self.hb_monitor = (HeartbeatMonitor(xp.heartbeat_stale_after)
                           if xp.heartbeat_stale_after else None)
        if xp.checkpoint_save and self.lead:
            checkpoint.probe_writable(xp.checkpoint_save)
        knob_batch = int(self.cfg.ensemble.replica_batch or 0)
        load_path, resume_batch = "", None
        if xp.checkpoint_load:
            load_path, resume_batch = self._resume_checks(stop, knob_batch)
        ck_on = bool(xp.checkpoint_save or xp.checkpoint_load
                     or xp.checkpoint_every)
        # preflight admission of the whole campaign, before anything is
        # allocated on the device; `auto` may split it into batches (not
        # a checkpointed one: its checkpoints stamp the full-R state)
        self.admission = runner.admit(
            self.cfg, self.sim, runner.engine_config(
                self.cfg, self.sim, lookahead=self.lookahead),
            self.device, ensemble=w,
            batchable=w.R > 1 and not knob_batch and not ck_on,
            mesh=self.mesh)
        batch = knob_batch or int(
            self.admission["overrides"].get("replica_batch", 0))
        if self._planned:
            self._plan_capacities(stop, load_path)
        pause = stop
        if xp.checkpoint_save and xp.checkpoint_save_time:
            pause = min(stop, xp.checkpoint_save_time)
        self.guard = supervise.make_guard(self.cfg)
        if self.mesh is not None:
            self.mesh.barrier()
            self.mesh.reset_counters()
        t0 = time.perf_counter()
        with (self.guard if self.guard is not None
              else contextlib.nullcontext()):
            if batch:
                final, rounds_r, adv = self._run_batched(
                    stop, batch, resume=resume_batch)
            else:
                ck = None
                if xp.checkpoint_every:
                    ck = supervise.Checkpointer(
                        xp.checkpoint_save, xp.checkpoint_every,
                        xp.checkpoint_keep, final_stop=stop,
                        extra_meta=self._ck_extra_meta,
                        audit_enabled=xp.state_audit)
                final, rounds_r, adv = self._run_once(
                    w, stop, pause=pause, load=load_path, ck=ck,
                    final_save=bool(xp.checkpoint_save))
        self.retries, self.reshards = adv.retries, adv.reshards
        wall = time.perf_counter() - t0
        if not self.lead:
            self._last_engine = None
            return None
        if adv.preempted:
            # a preempted campaign's counters cover only its prefix: the
            # resumed run writes the record
            log.info("ensemble record not written (campaign preempted; "
                     "resume from %s)", adv.resume_path)
            self._last_engine = None
            return runner.SimStats(
                end_time=adv.t_end, rounds=int(np.max(adv.rounds)),
                wall_s=wall, preempted=True,
                resume_path=adv.resume_path, retries=adv.retries,
                admission=self.admission, replans=self.replans,
                reshards=adv.reshards,
                pipeline={"checkpoint_io": self.ck_io})
        self.final_state = final
        H = len(self.sim.host_vertex)
        overflow = int(final["overflow"].sum())
        x_overflow = int(final["x_overflow"].sum())
        ok = overflow == 0 and x_overflow == 0 and not adv.budget_hit
        occ = capacity.measure(self._last_engine,
                               self._worst_case_view(final),
                               source="ensemble-run")
        occ["workload"]["replicas"] = int(w.R)
        self._last_engine = None
        if self.occ_record is not None:
            self.occ_record["final_measured"] = occ["measured"]
            self.occ_record["effective"] = occ["effective"]
            self.occ_record["replans"] = self.replans
            self.occ_record["applied"] = dict(self._capacity_overrides)
        else:
            self.occ_record = occ
        self.record = self._build_record(final, rounds_r, wall, ok)
        self.record["admission"] = self.admission
        if batch:
            self.record["replica_batch"] = int(batch)
        path = self.record_path()
        try:
            atomic_write_json(self.record, path)
            log.info("ensemble record -> %s", path)
        except OSError as e:
            log.warning("could not write ensemble record %s: %s", path, e)
        n_exec_total = int(final["n_exec"].sum())
        log.info("ensemble perf: %d replicas, %d rounds in %.2fs wall "
                 "(%.0f events/s aggregate)", w.R, int(rounds_r.max()),
                 wall, n_exec_total / wall if wall > 0 else 0.0)
        stats = runner.SimStats(
            end_time=adv.t_end, rounds=int(rounds_r.max()), wall_s=wall,
            events_executed=n_exec_total,
            packets_sent=int(final["n_sent"].sum()),
            packets_dropped=int(final["n_drop"].sum()),
            packets_delivered=int(final["n_deliv"].sum()),
            # replica 0's per-host results stand for the hosts, as the
            # reference surfaces them on its host objects
            host_events_executed=final["n_exec"][0, :H].astype(np.int64),
            host_trace_checksum=final["chk"][0, :H],
            overflow=overflow, x_overflow=x_overflow,
            admission=self.admission, ensemble=self.record,
            occupancy=self.occ_record, replans=self.replans,
            pipeline={"segments": sum(p["segments"] for p in self.segments),
                      "replayed": sum(p["replayed"] for p in self.segments),
                      "host_syncs": sum(p["host_syncs"]
                                        for p in self.segments),
                      "reshards": [w for p in self.segments
                                   for w in p["reshards"]],
                      "graph_captures": self.captures,
                      "engines": self.engines_built,
                      "warmup_wall_s": self.warmup_wall_s,
                      "checkpoint_io": self.ck_io},
            retries=adv.retries, reshards=adv.reshards)
        if self.hb_monitor is not None:
            stats.stale_heartbeats = self.hb_monitor.stale_events
        stats.mesh = self.mesh_record
        loops = self.loop_stats
        stats.loop = loops[0]["loop"]
        stats.phases = max(max(s["phases"]) for s in loops)
        stats.host_syncs = sum(s["host_syncs"] for s in loops)
        downloads = [self.app.downloads(a[:H]) for a in final["app"]]
        if downloads[0] is not None:
            stats.downloads_completed = int(sum(downloads))
        stats.ok = ok
        if overflow:
            log.error("ensemble engine overflow: %d events lost — raise "
                      "experimental.event_capacity/outbox_capacity",
                      overflow)
        return stats


def _free(device) -> None:
    """Return the freed engine's cached blocks to the card before the
    next engine allocates."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class _Segments:
    """The campaign's side of the segmented advance (the runner
    `supervise.advance` asks for): the campaign engine of one batch of
    worlds, its rotating checkpointer, the campaign's mesh, guard,
    chaos, stamp, retries, shrinks, re-plans and capacity knobs, and
    its heartbeats with the batch's first replica."""

    def __init__(self, er: EnsembleRunner, worlds: EnsembleWorlds,
                 offset: int, checkpointer=None):
        self.er, self.worlds, self.offset = er, worlds, offset
        self.cfg = er.cfg
        self.checkpointer = checkpointer
        self.guard, self.chaos = er.guard, er.chaos
        stamp = None if checkpointer is None else checkpointer.extra_meta
        self._ck_extra_meta = stamp or er._ck_extra_meta
        self._before_shrink: Optional[tuple] = None
        self.engine = er.engine(worlds)

    @property
    def mesh(self):
        return self.er.mesh

    @property
    def replans(self) -> int:
        return self.er.replans

    @replans.setter
    def replans(self, n: int) -> None:
        self.er.replans = n

    @property
    def retries(self) -> int:
        return self.er.retries

    @retries.setter
    def retries(self, n: int) -> None:
        self.er.retries = n

    @property
    def reshards(self) -> int:
        return self.er.reshards

    @reshards.setter
    def reshards(self, n: int) -> None:
        self.er.reshards = n

    @property
    def _capacity_overrides(self) -> dict:
        return self.er._capacity_overrides

    @_capacity_overrides.setter
    def _capacity_overrides(self, knobs: dict) -> None:
        self.er._capacity_overrides = knobs

    def overflow_counts(self, state: dict) -> dict:
        return runner.overflow_counts(state, self.mesh)

    def template(self) -> dict:
        return self.engine.init_arrays(self.er.sim.start_times,
                                       self.er.sim.stop_times)

    def _rebuild(self) -> None:
        self.engine = None
        _free(self.er.device)
        self.engine = self.er.engine(self.worlds)

    def replan(self, host_state: dict) -> dict:
        self._rebuild()
        return capacity.transfer(self.engine, host_state, self.template())

    def reload(self, path: str, stop: int) -> dict:
        self._rebuild()
        state, _, _ = checkpoint.load_state(self.engine, self.template(),
                                            path, final_stop=stop)
        return state

    def _shrink_to(self, mesh, host_state: dict, ensemble: bool = True
                   ) -> dict:
        """The campaign's shrink (campaign.py:182-215): the campaign
        moved onto the survivors' `mesh`, its exchange re-planned for
        their count (runner.replan_for_shrink), the campaign engine of
        this batch rebuilt and the [R, H_pad, ...] validated state
        re-padded onto it, every replica whole
        (runner.place_resharded). Transactional, as the runner's."""
        er = self.er
        self._before_shrink = (er.mesh, self.engine,
                               dict(er._capacity_overrides),
                               er._exchange_choice)
        try:
            er.mesh = mesh
            runner.replan_for_shrink(
                er, mesh.size, er.occ_record if er._planned else None,
                self.engine.effective["M_out"],
                4 if max(1, er.app.burst_pops) > 1 else 8)
            self._rebuild()
            return runner.place_resharded(self.engine, self.template(),
                                          host_state,
                                          len(er.sim.host_vertex), axis=1)
        except Exception:
            self._undo_shrink()
            raise

    def _undo_shrink(self) -> None:
        er = self.er
        (er.mesh, self.engine, er._capacity_overrides,
         er._exchange_choice) = self._before_shrink
        self._before_shrink = None

    def _emit_heartbeats(self, now: int, state: dict) -> None:
        self.er._emit_heartbeats(now, state, self.offset)
