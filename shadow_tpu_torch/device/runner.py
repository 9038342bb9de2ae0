"""The device runner (the port of the reference package's
device/runner.py `DeviceRunner`, without the out-of-memory ladder or a
compile cache).

It builds the engine from a config with the reference's knobs (the
burst width of `experimental.burst_pops`, the outbox floored at 8 pop
iterations of lanes, 4 where bursts drain backlogs, the lookahead from
the runahead or the minimum path latency over every fault epoch, the
path tables in the topology's representation with the link-fault
epochs, the hosts' model-NIC bandwidths), admits it against the
device's memory (`experimental.admission`, device/capacity.py) before
anything is allocated on the device, and runs to the stop time through
`DeviceRunner`:

* under `capacity_plan: auto` a warm-up slice on the static engine (in
  `dispatch_segment` pieces, up to MAX_REPLANS doublings where it
  overflows), or under a record path the record, sizes the capacities
  (device/capacity.py `plan`; on a mesh `exchange: auto` resolved by
  `choose_exchange` from the ranks' [S, S] pair matrix), and the
  planned engine is built in the static one's place;
* the run goes through the segmented advance (device/supervise.py
  `advance`): segments at heartbeat multiples and `dispatch_segment`,
  each through the engine's own window loop (on the card the captured
  graph, kept across segments; in timing mode and on a mesh the Python
  loop), overflow widened and replayed under a plan, the health word
  checked at every boundary under `experimental.state_audit`
  (`AuditFailure`), `[shadow-heartbeat]` rows (host/tracker.py) and a
  `[supervise-heartbeat]` line at every `general.heartbeat_interval`;
* checkpoints (device/checkpoint.py, runner.py:864-941 of the
  reference): `checkpoint_load` resolved to its newest readable rotation
  entry and checked from its meta before anything runs (the stop, a
  save time), its shard geometry adopted (`adopted_devices`: a run
  loading a checkpoint saved on another shard count runs on that many
  ranks of its pool, refused where the pool is smaller), its capacities
  adopted under a plan,
  the state loaded and armed; `checkpoint_save` probed for writing
  first, the run paused at `checkpoint_save_time` (0 = the stop) and
  its state written there; `checkpoint_every` rotating entries and a
  preemption guard (device/supervise.py); on a mesh the saves gather to
  rank 0 and every rank loads its own rows of the global leaves;
* `failover: shrink` (device/supervise.py `_shrink_recover`): a mesh
  that lost ranks goes on on the survivors, its exchange re-planned for
  their count and its engine rebuilt (`_shrink_to`, runner.py:657-768
  of the reference, transactional: `_undo_shrink`), the ranks left out
  leaving the run, the result coming from the lowest survivor;
* it logs the reference's `device perf:` line, writes the OCC record of
  a planned run (`capacity.record_path`; not of a preempted one) and
  returns the SimStats totals
  plus the per-host `events_executed` and `trace_checksum` arrays, for
  tgen and Tor the downloads completed, under `count_paths` the sent
  packets per vertex pair, the loop's phases and host syncs, the
  occupancy record and the re-plans.

`engine_from` also builds an ensemble campaign's engine, whose R
replicas ensemble/campaign.py runs. `run` takes any config through the
policy dispatch of core/controller.py, which hands a `tpu` config with
a device twin to `run_device` and runs the others (host faults, mixed
model families, the `hybrid` and `serial` policies) on the CPU engine.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from shadow_tpu_torch import simtime
from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.build import (
    BuiltSimulation,
    NoDeviceTwin,
    build,
    pad_hosts,
)
from shadow_tpu_torch.core.stats import SimStats
from shadow_tpu_torch.device import capacity
from shadow_tpu_torch.device.engine import (
    DeviceEngine,
    EngineConfig,
    campaign_world_arrays,
    make_mesh_params,
    mesh_stats,
    phase_params,
    resolve_device,
    state_from_numpy,
    state_to_numpy,
    world_arrays,
)
from shadow_tpu_torch.device.kernels import Kernels, build_library, \
    control_block
from shadow_tpu_torch.device import chaos as chaosmod
from shadow_tpu_torch.device import checkpoint, supervise
from shadow_tpu_torch.device.mesh import DEFAULT_TIMEOUT, spawn
from shadow_tpu_torch.device.supervise import HeartbeatMonitor, \
    advance, heartbeat_rates
from shadow_tpu_torch.host.tracker import Tracker
from shadow_tpu_torch.topology.hierarchy import world_tables

log = logging.getLogger("shadow_tpu_torch")

STAT_KEYS = ("n_exec", "n_sent", "n_drop", "n_deliv", "chk", "overflow",
             "x_overflow", "app")


def engine_config(cfg: ConfigOptions, sim: BuiltSimulation,
                  lookahead: Optional[int] = None,
                  overrides: Optional[dict] = None,
                  exchange: str = "") -> EngineConfig:
    """The engine's shape from the config and the built simulation
    (`lookahead` overrides the simulation's: a campaign's is the
    minimum over its replicas; `overrides` the planner's or a re-plan's
    capacity knobs, capacity.CAPACITY_KNOBS; `exchange` the schedule
    `exchange: auto` resolved to); sets the app's burst width."""
    xp = cfg.experimental
    if xp.burst_pops:
        if xp.burst_pops > 1 and sim.app.burst_pops <= 1:
            raise ValueError(
                "experimental.burst_pops > 1 requires an app with burst "
                "support (stateless-responder contract); this app pops "
                "one event per iteration")
        sim.app.burst_pops = xp.burst_pops
    burst = max(1, sim.app.burst_pops)
    per_iter = sim.app.max_sends * burst + sim.app.max_timers
    outbox = max(xp.outbox_capacity, (4 if burst > 1 else 8) * per_iter)
    knobs = {"event_capacity": xp.event_capacity, "outbox_capacity": outbox,
             "exchange_in_capacity": xp.exchange_in_capacity,
             "outbox_compact": xp.outbox_compact,
             "exchange_capacity": xp.exchange_capacity,
             "exchange_capacity2": xp.exchange_capacity2,
             **(overrides or {})}
    return EngineConfig(
        n_hosts=len(sim.host_vertex),
        event_capacity=knobs["event_capacity"],
        outbox_capacity=knobs["outbox_capacity"],
        lookahead=max(1, sim.lookahead if lookahead is None
                      else lookahead),
        stop_time=cfg.general.stop_time,
        bootstrap_end=cfg.general.bootstrap_end_time,
        seed=cfg.general.seed,
        exchange_in_capacity=knobs["exchange_in_capacity"],
        model_bandwidth=xp.model_bandwidth, count_paths=xp.count_paths,
        audit=xp.state_audit, outbox_compact=knobs["outbox_compact"],
        merge_global=xp.merge_strategy == "global",
        exchange=exchange or xp.exchange,
        exchange_capacity=knobs["exchange_capacity"],
        exchange_capacity2=knobs["exchange_capacity2"])


def admit(cfg: ConfigOptions, sim: BuiltSimulation, config: EngineConfig,
          device, ensemble=None, batchable: bool = False,
          mesh=None, copies: int = 1) -> dict:
    """The preflight admission verdict of a built run, or of the
    campaign of `ensemble` worlds, or of one rank of `mesh`
    (device/mesh.py), on `device`, from shapes and host arrays alone
    (nothing is allocated on the device); raises ValueError where
    `admission: strict` refuses. Where a `batchable` campaign does not
    fit, `auto` offers a replica batch that does. `copies`: the state's
    copies (2 where the segmented advance keeps a validated one)."""
    params = phase_params(config, sim.app)
    mp, n_hosts = None, config.n_hosts
    hv, up, down = sim.host_vertex, sim.bw_up_bits, sim.bw_down_bits
    if mesh is not None:
        mp = make_mesh_params(config, params, mesh.size, mesh.rank)
        hv, up, down = pad_hosts(mp.H_pad, hv, up, down)
        n_hosts = mp.H_loc
    if ensemble is None:
        world = world_arrays(len(hv), sim.app, hv,
                             *world_tables(sim.topology, sim.fault_table),
                             up, down, config.model_bandwidth,
                             config.count_paths, params.seed)
    else:
        world = campaign_world_arrays(
            len(hv), sim.app, hv, ensemble, up, down,
            config.model_bandwidth, config.count_paths)

    def estimate(replicas=None):
        return capacity.footprint(n_hosts, params, world, replicas, mp,
                                  copies)

    return capacity.admission_verdict(
        estimate(), resolve_device(device), cfg.experimental,
        rescale=estimate if batchable else None)


def make_engine(cfg: ConfigOptions, device="cuda",
                kernels: Optional[Kernels] = None):
    """(engine, built simulation) for a config inside the slice."""
    sim = build(cfg)
    return engine_from(cfg, sim, device, kernels), sim


def engine_from(cfg: ConfigOptions, sim: BuiltSimulation, device="cuda",
                kernels: Optional[Kernels] = None, ensemble=None,
                lookahead: Optional[int] = None,
                mesh=None, overrides: Optional[dict] = None,
                exchange: str = "", copies: int = 1) -> DeviceEngine:
    """The engine of a built simulation, or with `ensemble` worlds
    (ensemble/spec.py) the campaign engine of their replicas, or with
    `mesh` (device/mesh.py) the engine of one mesh rank, at `lookahead`
    where given, with the capacity `overrides` and the resolved
    `exchange` of a plan; its `admission` holds the verdict (the state
    priced `copies` times), reached before the engine allocates
    anything. Raises NoDeviceTwin where the build
    found none (core/controller.py runs such a config on the hybrid
    policy)."""
    if sim.app is None:
        raise NoDeviceTwin(sim.no_twin or "the config's policy is not "
                           "tpu: the CPU engine runs it")
    if mesh is not None and mesh.size == 1:
        # a mesh of one rank (a shrink's last survivor, an adopted
        # one-shard checkpoint) runs the one-device engine
        mesh = None
    config = engine_config(cfg, sim, lookahead, overrides, exchange)
    if ensemble is not None:
        config.seed = int(ensemble.seeds[0])
    verdict = admit(cfg, sim, config, device, ensemble, mesh=mesh,
                    copies=copies)
    lat, rel, epoch_times = (world_tables(sim.topology, sim.fault_table)
                             if ensemble is None else (None, None, None))
    engine = DeviceEngine(config, sim.app, host_vertex=sim.host_vertex,
                          latency_ns=lat, reliability=rel, device=device,
                          kernels=kernels, epoch_times=epoch_times,
                          bw_up_bits=sim.bw_up_bits,
                          bw_down_bits=sim.bw_down_bits,
                          ensemble=ensemble, mesh=mesh)
    engine.admission = verdict
    return engine


def run(cfg: ConfigOptions, device="cuda",
        kernels: Optional[Kernels] = None) -> SimStats:
    """Run a config on its policy (core/controller.py): a `tpu` config
    the device engine runs through `run_device`; one with host faults
    or no single device twin, and the `hybrid` and `serial` policies,
    through the CPU engine."""
    from shadow_tpu_torch.core.controller import Controller

    return Controller(cfg, device=device, kernels=kernels).run()


def run_device(cfg: ConfigOptions, sim: BuiltSimulation, device="cuda",
               kernels: Optional[Kernels] = None) -> SimStats:
    """Admit, plan and run a built `tpu` config (`DeviceRunner`); a mesh
    config on its ranks (`run_mesh`), as is a config whose checkpoint
    was saved on more than one shard (`adopted_devices`). An `ensemble:`
    config runs through ensemble/campaign.py (on a mesh through
    `run_mesh`, whose ranks each run its EnsembleRunner)."""
    if cfg.ensemble is not None:
        raise ValueError("an ensemble: config is a campaign: run it with "
                         "shadow_tpu_torch.ensemble.campaign."
                         "EnsembleRunner (the CLI does)")
    devices = adopted_devices(cfg, device_pool(cfg, device))
    if len(devices) > 1:
        return run_mesh(cfg, devices)
    return DeviceRunner(cfg, sim, devices[0], kernels).run()


def host_names(sim: BuiltSimulation) -> list[str]:
    """Every host's name in id order: a group of one host is named after
    the group, a larger group's hosts name0..name{n-1}."""
    names = []
    for name, _, q in sim.names.groups_in_order():
        names += [name] if q == 1 else [f"{name}{i}" for i in range(q)]
    return names


class DeviceRunner:
    """One device run of a built `tpu` config (the reference's
    DeviceRunner, runner.py:468-583, 770-1112, cut to this port): the
    capacity plan, the segmented advance, heartbeats, the OCC record and
    the SimStats. On a mesh (`mesh`, device/mesh.py) every rank runs one,
    and every decision that ends or rebuilds a run (overflow, the plan,
    the exchange) is taken from values reduced over the ranks, so that
    all ranks take it at the same boundary."""

    def __init__(self, cfg: ConfigOptions, sim: BuiltSimulation,
                 device="cuda", kernels: Optional[Kernels] = None,
                 mesh=None):
        self.cfg, self.sim, self.mesh = cfg, sim, mesh
        self.device = device
        self.kernels = kernels if kernels is not None else Kernels()
        # the planner's capacity knobs, widened by a re-plan
        self._capacity_overrides: dict = {}
        # `exchange: auto` once a record resolved it ("" before)
        self._exchange_choice = ""
        self.replans = 0
        self.occ_record: Optional[dict] = None
        self.hb_monitor: Optional[HeartbeatMonitor] = None
        self._hb_mark = None
        self._trackers: Optional[list] = None
        # the engines built (the static or warm-up one, the planned
        # one, each re-planned one) and the captures of all of them
        self.engines_built = 0
        self._captures_before = 0
        self.warmup_wall_s = 0.0
        self.final_state: Optional[dict] = None
        # supervision (device/supervise.py), set per run: the rotating
        # checkpoint writer, the drain guard, the retries absorbed, the
        # checkpoints' saves and load ({"bytes", "wall_s"} each)
        self.retries = 0
        self.reshards = 0
        # a shrink's re-shard, kept until every survivor's succeeded
        self._before_shrink: Optional[tuple] = None
        self.checkpointer: Optional[supervise.Checkpointer] = None
        self.guard: Optional[supervise.PreemptionGuard] = None
        self._ck_extra_meta: Optional[dict] = None
        self.ck_io: dict = {}
        # the deterministic chaos injector of this runner's runs (None
        # without a schedule, so that none leaks from an earlier run)
        self.chaos = chaosmod.from_config(cfg.experimental)
        chaosmod.set_current(self.chaos)
        self.engine: Optional[DeviceEngine] = None
        self.engine = self._build_engine()
        self.admission = self.engine.admission

    @property
    def _planned(self) -> bool:
        return self.cfg.experimental.capacity_plan != "static"

    def _build_engine(self) -> DeviceEngine:
        """The engine of the config's knobs with the plan's overrides
        and exchange; the engine before it is freed first, so that the
        rebuilt one allocates into its memory. Admitted before it
        allocates, the state priced twice where the advance keeps a
        validated copy (a planned or a supervised run,
        supervise.keeps_copy)."""
        if self.engine is not None:
            self._captures_before += self.engine.captures
        self.engine = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        exchange = self._exchange_choice or (
            "all_to_all" if self.cfg.experimental.exchange == "auto"
            else "")
        engine = engine_from(self.cfg, self.sim, self.device,
                             self.kernels, mesh=self.mesh,
                             overrides=self._capacity_overrides,
                             exchange=exchange,
                             copies=2 if supervise.keeps_copy(self.cfg)
                             else 1)
        self.engines_built += 1
        return engine

    @property
    def captures(self) -> int:
        """CUDA graph captures of every engine this runner built."""
        return self._captures_before + (self.engine.captures
                                        if self.engine else 0)

    def _init_state(self) -> dict:
        return self.engine.init_state(self.sim.start_times,
                                      self.sim.stop_times)

    # ---- what the advance asks of its runner --------------------------
    def overflow_counts(self, state: dict) -> dict:
        return overflow_counts(state, self.mesh)

    def replan(self, host_state: dict) -> dict:
        """The state of a re-plan's rebuilt engine: `host_state` (the
        last validated boundary's, numpy) with its heaps grown to the
        new event_capacity, placed and armed (capacity.transfer)."""
        self.engine = self._build_engine()
        return capacity.transfer(
            self.engine, host_state,
            self.engine.init_arrays(self.sim.start_times,
                                    self.sim.stop_times))

    def template(self) -> dict:
        """This engine's initial leaves (numpy): what a state placed onto
        it must look like."""
        return self.engine.init_arrays(self.sim.start_times,
                                       self.sim.stop_times)

    def reload(self, path: str, stop: int) -> dict:
        """A retry's fallback: the engine rebuilt, the checkpoint at
        `path` loaded onto it."""
        self.engine = self._build_engine()
        state, _, _ = checkpoint.load_state(self.engine, self.template(),
                                            path, final_stop=stop)
        return state

    def _emit_heartbeats(self, now: int, state: dict) -> None:
        """The `[shadow-heartbeat] [node]` rows of every host at a
        segment boundary (host/tracker.py; the counters read back from
        the card, a mesh's gathered to rank 0), and one
        `[supervise-heartbeat]` line with the pkts/s since the last one,
        the re-plans and the device memory (runner.py:795-844).
        Interval attribution is window-granular: a segment pauses when
        the next event passes `now`, so the events of the last window
        count in this interval."""
        H = len(self.sim.host_vertex)
        cols = {k: state[k].cpu().numpy() for k in ("n_exec", "n_sent",
                                                    "n_drop")}
        if self.mesh is not None:
            cols = self.mesh.gather_leaves(cols)
            if self.mesh.rank != 0:
                return
        if self.hb_monitor is not None:
            self.hb_monitor.beat()
        if self._trackers is None:
            interval = self.cfg.general.heartbeat_interval
            self._trackers = [Tracker(n, interval)
                              for n in host_names(self.sim)]
        n_exec, n_sent, n_drop = (cols[k][:H].tolist() for k in (
            "n_exec", "n_sent", "n_drop"))
        for i, tr in enumerate(self._trackers):
            tr.heartbeat(now, n_exec[i], n_sent[i], n_drop[i])
        sent_total = int(sum(n_sent))
        self._hb_mark, (rate,) = heartbeat_rates(self._hb_mark,
                                                 [sent_total])
        mem = self.engine.device_memory_stats()
        mem_s = (f"{capacity.fmt_bytes(mem[0])}/"
                 f"{capacity.fmt_bytes(mem[1])}"
                 if mem is not None else "n/a")
        log.info("[supervise-heartbeat] t=%s events=%d sent=%d "
                 "pkts/s=%s retries=%d replans=%d reshards=%d mem=%s",
                 simtime.format_time(now), int(sum(n_exec)), sent_total,
                 rate, self.retries, self.replans, self.reshards, mem_s)

    # ---- the shrink ---------------------------------------------------
    def _shrink_to(self, mesh, host_state: dict, ensemble: bool = False
                   ) -> dict:
        """A survivor's side of the shrink (runner.py:657-748): the
        runner moved onto `mesh` (the survivors', device/mesh.py
        `Mesh.shrink`), its exchange re-planned for their count
        (`replan_for_shrink`), its engine rebuilt and the validated
        global state `host_state` re-padded onto the new geometry and
        placed (`place_resharded`). Transactional: where any step
        fails, the mesh, engine, overrides and exchange choice are put
        back before the error goes on, and `_undo_shrink` does the same
        where another survivor failed, so that the failover checkpoint
        keeps the old geometry."""
        self._before_shrink = (self.mesh, self.engine,
                               dict(self._capacity_overrides),
                               self._exchange_choice, self._captures_before)
        try:
            self.mesh = mesh
            replan_for_shrink(self, mesh.size, self.occ_record
                              if self._planned else None,
                              self.engine.effective["M_out"],
                              self._floor_iters())
            self.engine = self._build_engine()
            return place_resharded(self.engine, self.template(), host_state,
                                   len(self.sim.host_vertex), axis=0)
        except Exception:
            self._undo_shrink()
            raise

    def _undo_shrink(self) -> None:
        """The runner as it was before `_shrink_to`."""
        (self.mesh, self.engine, self._capacity_overrides,
         self._exchange_choice, self._captures_before) = self._before_shrink
        self._before_shrink = None

    # ---- the plan -----------------------------------------------------
    def _headroom(self) -> float:
        return self.cfg.experimental.capacity_headroom or capacity.HEADROOM

    def _floor_iters(self) -> int:
        return 4 if max(1, self.sim.app.burst_pops) > 1 else 8

    def measured_view(self, state: dict) -> dict:
        """The leaves `capacity.measure` reads: the state's own on one
        device; on a mesh the ranks' maxima and sums, and their occ_x
        rows stacked into the [S, S] pair matrix, the same on every
        rank."""
        if self.mesh is None:
            return state
        return mesh_view(self.mesh, state)

    def _resolve_exchange(self, record: dict) -> str:
        """The schedule the planned engine runs: the config's, or under
        `exchange: auto` capacity.choose_exchange over the record's pair
        matrix, stamped into the record (runner.py:770)."""
        xp = self.cfg.experimental
        if xp.exchange != "auto":
            return xp.exchange
        n_shards = self.engine.effective["n_shards"]
        choice, info = capacity.choose_exchange(
            record, n_shards, per_iter=self.engine.effective["M_out"],
            floor_iters=self._floor_iters(), headroom=self._headroom())
        record["exchange_auto"] = info
        self._exchange_choice = choice
        if n_shards > 1:
            log.info("exchange: auto -> %s (per-flush row estimates %s)",
                     choice, info["estimates"])
        return choice

    def _plan_capacities(self, stop: int, load_path: str = "") -> None:
        """capacity_plan: auto | <record> (runner.py:468-583): `auto`
        runs a warm-up slice of `capacity_warmup` (default stop / 8) on
        the static engine, its windows clamped to the global stop, in
        `dispatch_segment` pieces, overflow checked at each piece's end
        and the slice rerun widened up to MAX_REPLANS times; a path
        loads the record, which must be of this workload. Then the plan,
        and the planned engine in the static one's place."""
        xp = self.cfg.experimental
        mode = xp.capacity_plan
        t0 = time.perf_counter()
        if load_path:
            # the checkpoint pins the saved engine's capacities: adopt
            # them, and under `exchange: auto` its schedule; an overflow
            # past the resume point re-plans as usual
            self._capacity_overrides, exchange = checkpoint_caps(load_path)
            if xp.exchange == "auto":
                self._exchange_choice = exchange
            self.engine = self._build_engine()
            self.admission = self.engine.admission
            self.warmup_wall_s = time.perf_counter() - t0
            log.warning("capacity_plan: %s skipped — checkpoint_load "
                        "resumes with the saved engine's capacities "
                        "%s", mode, self._capacity_overrides)
            return
        static_knobs = {k: getattr(self.engine.config, k)
                        for k in capacity.CAPACITY_KNOBS}
        if mode == "auto":
            warm = min(xp.capacity_warmup or max(1, stop // 8), stop)
            seg = xp.dispatch_segment
            state = self._init_state()
            for attempt in range(capacity.MAX_REPLANS + 1):
                t, dims = 0, ()
                while t < warm:
                    nxt = min(warm, t + seg) if seg else warm
                    state, _ = self.engine.run(state, stop=nxt,
                                               final_stop=stop)
                    t = nxt
                    dims = capacity.overflow_dims(
                        state, self.overflow_counts(state))
                    if dims:
                        break
                if not dims:
                    break
                if attempt == capacity.MAX_REPLANS:
                    raise RuntimeError(
                        f"capacity warm-up still overflows after "
                        f"{capacity.MAX_REPLANS} doublings on {dims}")
                self._capacity_overrides = capacity.widen(
                    self._capacity_overrides, dims, self.engine.effective)
                log.warning("capacity warm-up overflowed on %s; retrying "
                            "with %s", dims, self._capacity_overrides)
                del state
                self.engine = self._build_engine()
                state = self._init_state()
            record = capacity.measure(self.engine,
                                      self.measured_view(state),
                                      source=f"warmup:{warm}ns")
            del state
        else:
            record = capacity.load_record(mode)
            want = {"app": type(self.sim.app).__name__,
                    "app_fp": capacity.app_fingerprint(self.sim.app),
                    "n_hosts": len(self.sim.host_vertex)}
            got = {k: record["workload"].get(k) for k in want}
            if got != want:
                raise ValueError(
                    f"occupancy record {mode} was measured on {got}; "
                    f"this simulation is {want} — re-measure with "
                    "capacity_plan: auto")
        exchange = self._resolve_exchange(record)
        planned = capacity.plan(
            record, per_iter=self.engine.effective["M_out"],
            floor_iters=self._floor_iters(),
            n_shards=self.engine.effective["n_shards"],
            headroom=self._headroom(), exchange=exchange)
        record["planned"] = planned
        record["static"] = static_knobs
        self.occ_record = record
        self._capacity_overrides = dict(planned)
        self.engine = self._build_engine()
        self.admission = self.engine.admission
        self.warmup_wall_s = time.perf_counter() - t0
        log.info("capacity plan (%s, exchange %s, headroom %g): %s  "
                 "[measured %s]", mode, exchange, self._headroom(),
                 planned, record["measured"])

    # ---- the run ------------------------------------------------------
    def run(self) -> Optional[SimStats]:
        """Plan, advance to the stop time and summarise: the SimStats
        (on a mesh rank 0's, of every host; None on the other ranks),
        the final state in `final_state` (this rank's tensors)."""
        cfg, xp = self.cfg, self.cfg.experimental
        stop = cfg.general.stop_time
        self.replans = 0
        self.retries = 0
        self.reshards = 0
        self._hb_mark = None
        self.ck_io = {}
        lead = self.mesh is None or self.mesh.rank == 0
        if xp.checkpoint_save and lead:
            checkpoint.probe_writable(xp.checkpoint_save)
        load_path = ""
        if xp.checkpoint_load:
            # the newest readable rotation entry of a base path; the
            # resume's parameters checked from the meta alone, before
            # a warm-up spends anything
            load_path = supervise.resolve_checkpoint(xp.checkpoint_load)
            checkpoint.prevalidate_resume(
                load_path, stop, save_path=xp.checkpoint_save,
                save_time=xp.checkpoint_save_time)
            # the callers adopt the saved shard count (`adopted_devices`,
            # `_mesh_runs_rank`); a runner built on another is refused
            # with the reference's message
            checkpoint.validate_geometry(
                load_path, checkpoint.peek_meta(load_path), self.engine)
        if self._planned:
            self._plan_capacities(stop, load_path)
        self.hb_monitor = (HeartbeatMonitor(xp.heartbeat_stale_after)
                           if xp.heartbeat_stale_after else None)
        if load_path:
            state, t_start, self.ck_io["load"] = checkpoint.load_state(
                self.engine, self.template(), load_path, final_stop=stop)
            log.info("resumed checkpoint %s at t=%d ns", load_path,
                     t_start)
        else:
            state, t_start = self._init_state(), 0
        # with checkpoint_save the run pauses at checkpoint_save_time
        # (0 = the stop) and writes its state there; windows stay
        # clamped on the stop, so that the pair equals one run
        pause = stop
        if xp.checkpoint_save:
            if xp.checkpoint_save_time:
                pause = min(stop, xp.checkpoint_save_time)
            if pause <= t_start:
                raise ValueError(
                    f"checkpoint_save_time {pause} ns is not after "
                    f"the run's start time {t_start} ns")
        self.checkpointer = None
        if xp.checkpoint_every:
            self.checkpointer = supervise.Checkpointer(
                xp.checkpoint_save, xp.checkpoint_every,
                xp.checkpoint_keep, final_stop=stop,
                extra_meta=self._ck_extra_meta,
                audit_enabled=xp.state_audit)
        self.guard = supervise.make_guard(cfg)
        if self.mesh is not None:
            self.mesh.barrier()
            self.mesh.reset_counters()
        t0 = time.perf_counter()
        with (self.guard if self.guard is not None
              else contextlib.nullcontext()):
            state, adv = advance(self, state, t_start, pause, stop)
        self.retries = adv.retries
        engine = self.engine
        if xp.checkpoint_save:
            self._final_save(state, adv, stop)
        final = state_to_numpy(state, STAT_KEYS + (
            ("path_cnt",) if "path_cnt" in state else ()))
        view = self.measured_view(state)
        self.final_state = state
        if self.mesh is not None:
            final = self.mesh.gather_leaves(final)
        wall = time.perf_counter() - t0
        rounds = int(np.max(adv.rounds))
        occ = capacity.measure(engine, view, source="run")
        if self.occ_record is not None:
            self.occ_record["final_measured"] = occ["measured"]
            self.occ_record["effective"] = occ["effective"]
            self.occ_record["replans"] = self.replans
            self.occ_record["applied"] = dict(self._capacity_overrides)
            if adv.preempted:
                # its marks cover only the executed prefix
                log.info("occupancy record not written (run preempted)")
            elif self.mesh is None or self.mesh.rank == 0:
                path = capacity.record_path(engine)
                try:
                    capacity.save_record(self.occ_record, path)
                    log.info("occupancy record -> %s", path)
                except OSError as e:
                    log.warning("could not write occupancy record %s: %s",
                                path, e)
        else:
            self.occ_record = occ
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        H = len(self.sim.host_vertex)
        loop = {**engine.loop_stats, "phases": adv.pipeline["phases"],
                "host_syncs": adv.pipeline["host_syncs"]}
        if engine.mesh_params is not None:
            loop["mesh"] = mesh_stats(engine)
        stats = stats_of(cfg, engine, {k: v[:H] for k, v in final.items()},
                         rounds, wall, loop)
        stats.end_time = adv.t_end
        stats.preempted, stats.resume_path = adv.preempted, adv.resume_path
        stats.retries = adv.retries
        stats.reshards = adv.reshards
        n_exec = stats.events_executed
        log.info("device perf: %d rounds in %.2fs wall (%.0f rounds/s, "
                 "%.0f events/s)", rounds, wall,
                 rounds / wall if wall > 0 else 0.0,
                 n_exec / wall if wall > 0 else 0.0)
        stats.admission = self.admission
        stats.occupancy = self.occ_record
        stats.replans = self.replans
        if self.hb_monitor is not None:
            stats.stale_heartbeats = self.hb_monitor.stale_events
        if self.checkpointer is not None:
            self.ck_io["rotation"] = self.checkpointer.io
        stats.pipeline = {**adv.pipeline, "engines": self.engines_built,
                          "graph_captures": self.captures,
                          "warmup_wall_s": self.warmup_wall_s,
                          "checkpoint_io": self.ck_io}
        if adv.budget_hit:
            stats.ok = False
        if stats.overflow:
            log.error("device engine overflow: %d events lost — raise "
                      "experimental.event_capacity/outbox_capacity, or "
                      "set capacity_plan: auto to size and retry "
                      "automatically", stats.overflow)
        if stats.x_overflow:
            log.error("exchange overflow: %d rows exceeded the per-"
                      "shard-pair capacity — raise experimental."
                      "exchange_capacity (or use exchange: all_gather "
                      "for hub-concentrated traffic, or capacity_plan: "
                      "auto)", stats.x_overflow)
        return stats


    def _final_save(self, state: dict, adv, stop: int) -> None:
        """checkpoint_save at the end of the advance (its pause): not
        after an exhausted budget (the pause time would be a lie) or an
        overflow (events already lost), and not after a drain, whose
        resume checkpoint is already written."""
        xp = self.cfg.experimental
        if adv.budget_hit or adv.overflowed:
            log.error("%s before the checkpoint boundary — NOT "
                      "saving %s", "max_rounds exhausted" if adv.budget_hit
                      else "capacity overflow (events lost)",
                      xp.checkpoint_save)
            return
        if adv.preempted:
            return
        io = checkpoint.save_state(
            self.engine, state, xp.checkpoint_save, adv.t_end,
            final_stop=stop,
            audit_meta=({"enabled": True, "violations": 0}
                        if xp.state_audit else None))
        if io is not None:
            self.ck_io["save"] = io
            log.info("checkpoint saved at t=%d ns -> %s (run %s)",
                     adv.t_end, xp.checkpoint_save,
                     "complete" if adv.t_end >= stop else
                     "paused early; resume with checkpoint_load")


def overflow_counts(state: dict, mesh=None) -> dict:
    """The loud overflow counters' sums (over a campaign's replicas too),
    over the mesh's ranks on a mesh (every rank then sees the same
    values)."""
    counts = capacity.overflow_counts(state)
    if mesh is None:
        return counts
    keys = sorted(counts)
    got = mesh.all_sum(torch.tensor([counts[k] for k in keys],
                                    dtype=torch.int64))
    return dict(zip(keys, (int(v) for v in got.tolist())))


def replan_for_shrink(owner, n_shards: int, record: Optional[dict],
                      per_iter: int, floor_iters: int) -> None:
    """The exchange capacities of `owner` (a DeviceRunner or an
    EnsembleRunner) re-planned for `n_shards` ranks (runner.py:657-704):
    fewer ranks hold more hosts a pair, so the old caps would only
    overflow. They go back to the engine's own sizing, `exchange: auto`
    is re-resolved by capacity.choose_exchange over the record (else
    all_to_all), and a planned run's record sizes them again
    (capacity.pair_matrix bounds a pair matrix of another shape by its
    largest pair). Per-host capacities stay."""
    xp = owner.cfg.experimental
    headroom = xp.capacity_headroom or capacity.HEADROOM
    for k in ("exchange_capacity", "exchange_capacity2"):
        owner._capacity_overrides[k] = 0
    exchange = xp.exchange
    if exchange == "auto":
        exchange = "all_to_all"
        if record is not None:
            exchange, info = capacity.choose_exchange(
                record, n_shards, per_iter=per_iter,
                floor_iters=floor_iters, headroom=headroom)
            record["exchange_auto"] = info
            log.info("shrink re-plan: exchange auto -> %s at %d shard(s)",
                     exchange, n_shards)
        owner._exchange_choice = exchange
    if record is not None:
        planned = capacity.plan(record, per_iter=per_iter,
                                floor_iters=floor_iters, n_shards=n_shards,
                                headroom=headroom, exchange=exchange)
        for k in ("exchange_capacity", "exchange_capacity2"):
            if planned[k]:
                owner._capacity_overrides[k] = planned[k]
        log.info("shrink re-plan at %d shard(s): %s", n_shards,
                 {k: v for k, v in owner._capacity_overrides.items()
                  if k.startswith("exchange")})


def place_resharded(engine: DeviceEngine, template: dict, host_state: dict,
                    n_hosts: int, axis: int) -> dict:
    """The shrink's tail (runner.py:750-768): the validated global state
    `host_state` re-padded onto `engine`'s geometry
    (capacity.reshard_state), this rank's rows taken and placed through
    the engine's own initial leaves `template` (`engine.init_arrays`;
    `axis` 1 for a campaign's [R, H, ...] leaves). The rows of the other
    ranks in the global template are copies of this rank's: only this
    rank's rows of the result are kept. A one-device engine takes them
    all."""
    mp = engine.mesh_params
    if mp is None:
        return capacity.transfer(engine, capacity.reshard_state(
            host_state, n_hosts, template), template)
    glob = {k: np.concatenate([np.asarray(v)] * mp.S, axis=axis)
            for k, v in template.items()}
    new = capacity.reshard_state(host_state, n_hosts, glob)
    return capacity.transfer(engine, shard_state(new, mp, axis=axis),
                             template)


def mesh_view(mesh, state: dict) -> dict:
    """The occupancy leaves `capacity.measure` reads, reduced over the
    ranks of `mesh` and the same on every rank: the high-water marks'
    maxima, the overflow counters' sums, and the ranks' occ_x rows
    stacked into the [S, S] pair matrix. `state` holds a rank's tensors
    or numpy leaves (a campaign's worst case over its replicas, occ_x
    [1, S])."""
    def t(k):
        return torch.as_tensor(capacity.host_array(state[k])).long()

    marks = ("occ_heap", "occ_ob", "occ_in", "occ_trips", "occ_phases")
    mx = mesh.all_max(torch.stack([t(k).max() for k in marks]))
    sums = mesh.all_sum(torch.stack([t(k).sum() for k in ("overflow",
                                                           "x_overflow")]))
    S = mesh.size
    pairs = torch.zeros((S, S), dtype=torch.int64)
    pairs[mesh.rank] = t("occ_x").view(S)
    view = {k: np.array([int(v)]) for k, v in zip(marks, mx.tolist())}
    view["occ_x"] = mesh.all_sum(pairs).numpy()
    view["overflow"], view["x_overflow"] = (
        np.array([int(v)]) for v in sums.tolist())
    return view


def checkpoint_caps(load_path: str) -> tuple[dict, str]:
    """(the capacity knobs, the exchange schedule) of the engine that
    saved a checkpoint, which a planned resume adopts: the fingerprint
    pins them, so a fresh plan would only be refused (runner.py:595-616;
    one adopt path for the runner and the campaign)."""
    meta = checkpoint.peek_meta(load_path)
    caps = meta.get("capacities")
    if caps is None:
        caps = {k: meta["fingerprint"][k]
                for k in ("event_capacity", "outbox_capacity")}
    return ({k: int(v) for k, v in caps.items()},
            meta.get("exchange", "all_to_all"))


def summarize(cfg: ConfigOptions, engine: DeviceEngine, state: dict,
              rounds: int, t0: float) -> SimStats:
    """The SimStats of a run of `engine` that started at
    `time.perf_counter()` `t0` and ended in `state` after `rounds`
    windows; the wall ends once the totals are read back (a sync)."""
    final = state_to_numpy(state, STAT_KEYS + (
        ("path_cnt",) if "path_cnt" in state else ()))   # synchronises
    return stats_of(cfg, engine, final, rounds, time.perf_counter() - t0)


def stats_of(cfg: ConfigOptions, engine: DeviceEngine, final: dict,
             rounds: int, wall: float, loop: Optional[dict] = None
             ) -> SimStats:
    """The SimStats of a run's final leaves `final` (numpy, the hosts
    of the config in id order: a mesh's gathered leaves without its
    padded hosts); `loop` the loop's record where not the engine's last
    run's (a segmented run's sums)."""
    loop = engine.loop_stats if loop is None else loop
    stats = SimStats(
        end_time=cfg.general.stop_time, rounds=rounds, wall_s=wall,
        loop=loop["loop"], phases=loop["phases"],
        host_syncs=loop["host_syncs"],
        events_executed=int(final["n_exec"].sum()),
        packets_sent=int(final["n_sent"].sum()),
        packets_dropped=int(final["n_drop"].sum()),
        packets_delivered=int(final["n_deliv"].sum()),
        host_events_executed=final["n_exec"].astype(np.int64),
        host_trace_checksum=final["chk"],
        overflow=int(final["overflow"].sum()),
        x_overflow=int(final["x_overflow"].sum()))
    stats.downloads_completed = engine.app.downloads(final["app"])
    stats.admission = engine.admission
    if "path_cnt" in final:
        V = engine.n_vertices
        cnt = final["path_cnt"].sum(0).reshape(V, V)
        stats.path_packets = {(int(i), int(j)): int(cnt[i, j])
                              for i, j in zip(*np.nonzero(cnt))}
    stats.ok = stats.overflow == 0 and stats.x_overflow == 0
    stats.mesh = loop.get("mesh")
    return stats


# ----------------------------------------------------------------------
# the host mesh: S ranks, one process each (device/mesh.py)
# ----------------------------------------------------------------------
def mesh_devices(n_shards: int, device="cuda") -> list:
    """The devices of `experimental.mesh_shards` ranks: cuda:0..S-1, or
    S CPU ranks where `device` is the CPU; raises the reference's
    message (runner.py:271-275) where the machine has fewer cards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n_shards
    n = torch.cuda.device_count()
    if n_shards > n:
        raise ValueError(f"experimental.mesh_shards={n_shards} but only "
                         f"{n} device(s) are available")
    return [f"cuda:{i}" for i in range(n_shards)]


def saved_shards(cfg: ConfigOptions) -> tuple[str, Optional[int]]:
    """(the resolved checkpoint, the shard count its geometry stamp
    names) of a config's `checkpoint_load`; ("", None) without one or
    before its file exists, the count None on an unstamped file."""
    load = cfg.experimental.checkpoint_load
    if not load or not (os.path.exists(load)
                        or supervise.rotation_entries(load)):
        return "", None
    path = supervise.resolve_checkpoint(load)
    n = checkpoint.peek_geometry(checkpoint.peek_meta(path)).get("n_shards")
    return path, None if n is None else int(n)


def device_pool(cfg: ConfigOptions, device="cuda") -> list:
    """The devices a run of `cfg` may take: its `mesh_shards` ranks
    (`mesh_devices`), else its one device; where it loads a checkpoint
    saved on more shards, every card there is (on the CPU, as many CPU
    ranks as the checkpoint names), for `adopted_devices` to cut."""
    if cfg.experimental.mesh_shards > 1:
        return mesh_devices(cfg.experimental.mesh_shards, device)
    _, n = saved_shards(cfg)
    if n is None or n <= 1:
        return [device]
    if resolve_device(device).type == "cpu":
        return ["cpu"] * n
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def adopted_devices(cfg: ConfigOptions, devices: list) -> list:
    """The devices a run of `cfg` takes of the pool `devices`: all of
    them, or, where it loads a checkpoint stamped with another shard
    count (a shrunken run's, device/supervise.py), the first that many,
    so that the resume lands on the saved geometry (runner.py:618-655;
    traces do not depend on which devices); refused with the reference's
    message where the pool is smaller. A checkpoint not written yet
    leaves the pool as it is (its mesh's ranks adopt it,
    `_mesh_runs_rank`)."""
    path, n = saved_shards(cfg)
    if n is None or n == len(devices):
        return list(devices)
    if n > len(devices):
        raise ValueError(
            f"checkpoint {path} was saved on {n} shard(s) but only "
            f"{len(devices)} device(s) are available — resume on a pool "
            "of at least the saved shard count")
    log.warning("checkpoint %s was saved on %d shard(s) (this pool has "
                "%d) — rebuilding the mesh to the saved geometry for the "
                "resume", path, n, len(devices))
    return list(devices)[:n]


def run_mesh(cfg: ConfigOptions, devices, timeout: float = DEFAULT_TIMEOUT
             ) -> SimStats:
    """Run a config on a mesh of one rank per entry of `devices` (the
    counterpart of the reference runner's `mesh=`; S distinct cards run
    NCCL, a card named more than once or the CPU gloo, mesh_backend);
    the SimStats of its hosts, assembled by the lead rank in the
    one-device layout, with `mesh` the exchange's record. A hybrid
    failover of the ranks raises here, in the caller's process, as
    DeviceFailover (core/controller.py reruns the config on the hybrid
    policy)."""
    stats = mesh_runs(devices, [cfg], timeout=timeout)[0][0]
    if isinstance(stats, supervise.DeviceFailover):
        raise stats
    m = stats.mesh
    log.info("mesh: %d ranks (%s), exchange %s (config: %s), CAP %d, "
             "CAP2 %d; rank 0 sent %d B, staging %.3f s, collectives "
             "%.3f s", m["shards"], m["backend"], m["exchange"],
             cfg.experimental.exchange, m["cap"], m["cap2"],
             m["moved_bytes"], m["stage_s"], m["collective_s"])
    return stats


def mesh_runs(devices, cfgs: list, keep_state=False, timing=False,
              timeout: float = DEFAULT_TIMEOUT) -> list:
    """Each config run in turn on one spawned mesh: [(SimStats, the
    final leaves gathered into the H_pad layout where `keep_state`,
    else None), ...]; a campaign config (`ensemble:`) runs its
    EnsembleRunner on every rank and gives its [R, H_pad, ...] leaves
    always, the heaps where `keep_state`; a config whose retries ran
    out under `failover: hybrid` gives (DeviceFailover, None). A run
    that shrank (`failover: shrink`) gives the lowest survivor's stats
    and leaves (the shrunken layout). `stats.mesh["ranks"]` holds each
    rank's record:
    its exchange (mesh_stats), kernel launches, peak device memory (on
    a card) and, with `timing` (Kernels(timing=True): an event pair
    around each launch), its device ms per kernel; a rank that left at
    a shrink or sat out an adopted geometry records `left`;
    `stats.mesh["launches"]` sums the launches over the ranks.
    `keep_state` and `timing` are each one flag for every config or a
    list of one flag per config. The CUDA kernels are built here, before
    the ranks start, so that the ranks only load them. A config whose
    `mesh_shards` names fewer ranks than `devices` runs on the first
    that many, the others sitting it out (`config_ranks`). A config that
    loads a checkpoint saved on more shards than `devices` is refused
    here where the file exists, and by its ranks otherwise (an earlier
    config of the same call may write it); on fewer, its first ranks
    adopt the saved count and the others sit it out."""
    keep_state, timing = (_per_config(f, len(cfgs))
                          for f in (keep_state, timing))
    for cfg in cfgs:
        adopted_devices(cfg, devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        build_library()
    return spawn(devices, _mesh_runs_rank, (cfgs, keep_state, timing),
                 timeout)


def _per_config(flag, n: int) -> list:
    if isinstance(flag, bool):
        return [flag] * n
    if len(flag) != n:
        raise ValueError(f"{len(flag)} flags for {n} configs")
    return [bool(f) for f in flag]


def config_ranks(cfg: ConfigOptions, devices: list) -> int:
    """How many of a spawned mesh's `devices` a config runs on: the
    shard count of the checkpoint it loads (`adopted_devices`), else its
    `mesh_shards` where that names fewer, else all of them."""
    n = len(adopted_devices(cfg, devices))
    S = cfg.experimental.mesh_shards
    if n == len(devices) and 1 < S < n:
        return S
    return n


def _leads(mesh) -> bool:
    """Whether this rank leads the mesh a run ended on."""
    return mesh.rank == 0


def _run_config(mesh, cfg: ConfigOptions, kernels: Kernels,
                keep_state: bool) -> tuple:
    """One config on this rank of `mesh`: its DeviceRunner, or its
    campaign's EnsembleRunner (ensemble/campaign.py). Returns ((stats,
    leaves), or (DeviceFailover, None), where this rank leads the mesh
    the run ended on, else None; the rank's exchange record
    ({"shards": 1} where the run ended on one rank); its admission).
    Raises supervise.LeftMesh where a shrink left this rank out."""
    if cfg.ensemble is not None:
        from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

        # a campaign: its lead gathers its [R, H_pad, ...] leaves, the
        # heaps where `keep_state`
        er = EnsembleRunner(cfg, mesh.device, kernels, mesh=mesh)
        er.keep_heaps = keep_state
        stats = er.run()
        return ((stats, er.final_state) if _leads(er.mesh) else None,
                er.mesh_record or {"shards": 1}, er.admission)
    dr = DeviceRunner(cfg, build(cfg), mesh.device, kernels, mesh)
    try:
        stats = dr.run()
    except supervise.DeviceFailover as e:
        # every rank escalated on the mesh that failed; its lead hands
        # the failover back to the parent
        return ((e, None) if _leads(dr.mesh) else None,
                dr.engine.loop_stats.get("mesh", {}), dr.engine.admission)
    leaves = dr.mesh.gather_leaves(state_to_numpy(dr.final_state)) \
        if keep_state else None
    return ((stats, leaves) if _leads(dr.mesh) else None,
            dr.engine.loop_stats.get("mesh") or {"shards": 1},
            dr.engine.admission)


def _mesh_runs_rank(mesh, cfgs: list, keep_states: list,
                    timings: list) -> list:
    """mesh_runs on one rank: each config on this rank's device, on the
    whole mesh or on the first ranks of an adopted checkpoint geometry;
    world rank 0 returns [(stats, leaves), ...], taken from the lowest
    survivor where a shrink left rank 0 out."""
    from shadow_tpu_torch.device.mesh import sync_groups

    out = []
    cuda = mesh.device.type == "cuda"
    for cfg, keep_state, timing in zip(cfgs, keep_states, timings):
        if cuda:
            # the previous config's engine and state are gone (a run's
            # peak is its own)
            gc.collect()
            torch.cuda.reset_peak_memory_stats(mesh.device)
        kernels = Kernels(timing=timing)
        n = config_ranks(cfg, mesh.members)
        own = mesh if n == mesh.size else mesh.shrink(list(range(n)))
        result, record, admission = None, {"left": True}, None
        if own is not None:
            try:
                result, record, admission = _run_config(own, cfg, kernels,
                                                        keep_state)
            except supervise.LeftMesh as e:
                log.warning("%s", e)
        # the process groups of this config's shrinks, counted alike on
        # every rank before the next config
        sync_groups(mesh)
        ranks = mesh.gather({
            **record,
            "launches": {k: c for k, c in kernels.launches.items() if c},
            "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if cuda else None),
            "estimate_bytes": (admission["estimate"]["per_device"]
                               if admission else None),
            "kernel_ms": ({k: v for k, v in kernels.kernel_ms().items()
                           if v} if timing else None),
            "result": None if mesh.rank == 0 else result})
        if mesh.rank == 0:
            for r in ranks:
                got = r.pop("result")
                if result is None:
                    result = got
            stats, leaves = result
            if isinstance(stats, supervise.DeviceFailover):
                out.append((stats, None))
                continue
            launches = {}
            for r in ranks:
                for k, c in r["launches"].items():
                    launches[k] = launches.get(k, 0) + c
            stats.mesh = {**(stats.mesh or {"shards": 1}),
                          "ranks": ranks, "launches": launches}
            out.append((stats, leaves))
        result = None
    return out


def flush_phases(mesh, jobs: list) -> Optional[list]:
    """One flush each on a mesh rank (the reference's `_flush_phase`):
    a job is (config, global leaves, global [H_pad, OB] outbox, window
    end), numpy, after a pop whose iteration count the leaves already
    hold; this rank takes its rows (`shard_state`), flushes them with
    the pop counts at 0, and rank 0 returns each flush's gathered
    leaves."""
    out = []
    for cfg, state, ob, win_end in jobs:
        engine = engine_from(cfg, build(cfg), device=mesh.device, mesh=mesh)
        mp = engine.mesh_params
        mine = state_from_numpy(shard_state(state, mp), mesh.device)
        buf, pops, _ = engine._buffers()
        for f, v in shard_state(ob, mp).items():
            buf[f].copy_(torch.from_numpy(v))
        pops.zero_()
        # `flush` arms the engine: its outbox words say these rows came
        # from outside the pop, so K2 judges every host, pop counts 0
        engine.flush(mine, control_block(mesh.device, run=1,
                                         win_end=win_end))
        out.append(mesh.gather_leaves(state_to_numpy(mine)))
    return out if mesh.rank == 0 else None


def shard_state(leaves: dict, mp, axis: int = 0) -> dict:
    """Rank mp.shard's rows of global leaves (numpy, shard-major as the
    reference's arrays are: per-host leaves [H_pad, ...], occ_x [S, S],
    occ_trips and occ_phases [S]; a campaign's with a leading [R] axis,
    cut along `axis` 1)."""
    out = {}
    for k, v in leaves.items():
        v = np.asarray(v)
        n = v.shape[axis] // mp.S
        out[k] = np.ascontiguousarray(np.take(
            v, np.arange(mp.shard * n, (mp.shard + 1) * n), axis=axis))
    return out


def gather_state(parts: list) -> dict:
    """The global leaves of the ranks' leaves `parts`, in rank order:
    `shard_state`'s inverse."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
