"""The run's lifecycle and policy dispatch (the port's copy of the
reference package's core/controller.py `Controller`, cut to model
hosts).

A config runs on one of three policies:

* `tpu`: the device engine (device/runner.py); where the build finds
  host faults or no single device twin (core/build.py `no_twin`), the
  hybrid policy instead, with the reference's log line (and, on a
  mesh config, its warning that `mesh_shards` is ignored: the CPU
  engine runs the hosts, the judge runs on `device`); where its
  dispatch retries are spent under `failover: hybrid`
  (device/supervise.py DeviceFailover), a hybrid rerun from t = 0;
* `hybrid`: the CPU engine (core/manager.py on the serial policy) with
  the batched network judgment on the card (device/judge.py, K10);
* `serial`: the CPU engine alone, which touches no device.

The CPU engine's hosts are built from the port's columnar build with
the reference's names, ids, vertices and bandwidths, a virtual CPU, a
model NIC under `model_bandwidth`, and one respawn factory per process
for host restarts. The run then boots the hosts, schedules the host
faults and advances in lookahead windows [start, start + lookahead)
until the stop time, asking the manager for the next event between
windows.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from shadow_tpu_torch import simtime
from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.build import (
    BuiltSimulation,
    build,
    check_cpu_engine,
)
from shadow_tpu_torch.core.manager import Manager
from shadow_tpu_torch.core.netmodel import NetworkModel
from shadow_tpu_torch.core.scheduler import make_policy
from shadow_tpu_torch.core.stats import SimStats
from shadow_tpu_torch.host.cpu import Cpu
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.host.model_nic import ModelNic
from shadow_tpu_torch.models import make_app
from shadow_tpu_torch.utils.rng import SeededRandom

log = logging.getLogger("shadow_tpu_torch.controller")


def make_hosts(sim: BuiltSimulation) -> list[Host]:
    """The CPU engine's host objects, as the reference's object build
    and its columnar plane materialize them: group order, the group's
    name for a group of one and name0..name{n-1} otherwise, the host
    RNG derived from the seed by name, a fresh virtual CPU, a model NIC
    under `model_bandwidth`, the app and its respawn factory."""
    cfg = sim.cfg
    root = SeededRandom(cfg.general.seed)
    n_total = len(sim.host_vertex)
    hosts = []
    for g, (_, base, q) in zip(cfg.hosts, sim.names.groups_in_order()):
        proc = g.processes[0]
        stop = -1 if proc.stop_time is None else proc.stop_time
        for hid in range(base, base + q):
            name = g.name if q == 1 else f"{g.name}{hid - base}"
            host = Host(host_id=hid, name=name,
                        vertex=int(sim.host_vertex[hid]),
                        bw_down_bits=int(sim.bw_down_bits[hid]),
                        bw_up_bits=int(sim.bw_up_bits[hid]),
                        rng=root.child(f"host:{name}"))
            host.cpu = Cpu()
            if cfg.experimental.model_bandwidth:
                host.model_nic = ModelNic(host.bw_up_bits,
                                          host.bw_down_bits)
            app = make_app(proc.path, proc.args, hid, n_total)
            host.apps.append(app)
            host.app = app
            host.respawn = [((lambda p=proc.path, a=proc.args, h=hid:
                              make_app(p, a, h, n_total)),
                             proc.start_time, stop, True)]
            hosts.append(host)
    return hosts


class Controller:
    """Build a config and run it on its policy. `trace`, a list, records
    the CPU engine's (time, dst, src, kind) per executed event (the
    device engine records none, as in the reference). `device` is where
    the device engine, or the hybrid policy's judge, runs: the card
    unless the caller passes "cpu"; the serial policy touches none."""

    def __init__(self, cfg: ConfigOptions, trace: Optional[list] = None,
                 device="cuda", kernels=None):
        if cfg.ensemble is not None:
            raise ValueError("an ensemble: config is a campaign: run it "
                             "with shadow_tpu_torch.ensemble.campaign."
                             "EnsembleRunner (the CLI does)")
        self.cfg = cfg
        self.device = device
        self.kernels = kernels
        self.sim = build(cfg)
        self.manager: Optional[Manager] = None
        self.judge = None
        policy = cfg.experimental.scheduler_policy
        if policy == "tpu":
            if self.sim.no_twin is None:
                if trace is not None:
                    raise ValueError(
                        "the tpu policy does not record python event "
                        "traces; use per-host trace checksums for "
                        "equivalence testing")
                self.policy = "tpu"
                return
            log.info("tpu policy -> hybrid: %s", self.sim.no_twin)
            if cfg.experimental.mesh_shards:
                log.warning(
                    "experimental.mesh_shards=%d ignored — the hybrid "
                    "fallback's CPU host emulation has no device mesh "
                    "to pin", cfg.experimental.mesh_shards)
            policy = "hybrid"
        check_cpu_engine(cfg)
        self.policy = policy
        sim = self.sim
        if policy == "hybrid":
            from shadow_tpu_torch.device.judge import DeviceJudge

            self.judge = DeviceJudge(
                sim.topology, sim.host_vertex, cfg.general.seed,
                bootstrap_end=cfg.general.bootstrap_end_time,
                min_batch=cfg.experimental.hybrid_judge_min_batch,
                fault_table=sim.fault_table, device=device,
                kernels=kernels)
            policy = cfg.experimental.hybrid_cpu_policy
        netmodel = NetworkModel(
            topology=sim.topology,
            host_vertex=sim.host_vertex.astype(np.int64),
            seed=cfg.general.seed,
            bootstrap_end=cfg.general.bootstrap_end_time,
            faults=sim.fault_table)
        self.manager = Manager(
            hosts=make_hosts(sim), policy=make_policy(policy),
            netmodel=netmodel, seed=cfg.general.seed, trace=trace,
            groups={name: range(base, base + q) for name, base, q in
                    sim.names.groups_in_order()},
            net_judge=self.judge)

    def _failover_run(self, exc) -> SimStats:
        """The failover ladder's hybrid rung (controller.py:581-640): the
        device run's retries are spent, so the config reruns on the
        hybrid policy (the CPU engine, the judge on `device`) from t = 0
        with the device-only keys cleared: CPU hosts cannot be built
        from device arrays, and determinism makes the replay equal to
        what the device run would have produced. The validated device
        checkpoint stays on disk for a device-side resume
        (`failover_checkpoint`)."""
        import copy

        if exc.checkpoint_path is None:
            log.error(
                "DEVICE FAILOVER: %s — no device checkpoint could be "
                "persisted (%s); re-running on the hybrid backend "
                "from t=0 with NO device-side resume point.", exc,
                exc.persist_error or "unknown persist error")
        else:
            log.error(
                "DEVICE FAILOVER: %s — re-running on the hybrid "
                "backend from t=0 (device state is not importable "
                "into CPU hosts; the prefix up to t=%d ns is "
                "replayed). The validated device checkpoint %s "
                "remains for a device-side resume.", exc,
                exc.sim_time, exc.checkpoint_path or "<none>")
        cfg2 = copy.deepcopy(self.cfg)
        xp = cfg2.experimental
        xp.scheduler_policy = "hybrid"
        xp.checkpoint_save = ""
        xp.checkpoint_save_time = 0
        xp.checkpoint_load = ""
        xp.checkpoint_every = 0
        xp.capacity_plan = "static"
        xp.capacity_warmup = 0
        xp.state_audit = False
        xp.dispatch_retries = 0
        xp.failover = "abort"
        xp.chaos = []
        xp.mesh_shards = 0
        inner = Controller(cfg2, device=self.device, kernels=self.kernels)
        stats = inner.run()
        stats.failover_checkpoint = exc.checkpoint_path or ""
        return stats

    def run(self) -> SimStats:
        """Run to the stop time; the SimStats of the policy that ran (a
        `tpu` run whose retries are spent under `failover: hybrid`:
        the hybrid rerun's)."""
        cfg = self.cfg
        if self.manager is None:
            from shadow_tpu_torch.device import runner
            from shadow_tpu_torch.device.supervise import DeviceFailover

            try:
                stats = runner.run_device(cfg, self.sim, device=self.device,
                                          kernels=self.kernels)
            except DeviceFailover as e:
                return self._failover_run(e)
            if stats.preempted:
                log.warning(
                    "run preempted at %s: resume checkpoint %s "
                    "(set experimental.checkpoint_load to continue)",
                    simtime.format_time(stats.end_time),
                    stats.resume_path)
            if stats.retries:
                log.warning("run absorbed %d transient device "
                            "dispatch retr%s", stats.retries,
                            "y" if stats.retries == 1 else "ies")
            return stats
        stop = cfg.general.stop_time
        m = self.manager
        t0 = time.perf_counter()
        m.boot_hosts([(h, int(self.sim.start_times[h]),
                       int(self.sim.stop_times[h]), 0)
                      for h in range(len(m.hosts))])
        if self.sim.host_faults:
            m.schedule_host_faults(self.sim.host_faults)
        lookahead = max(1, self.sim.lookahead)
        log.info("starting: %d hosts, stop=%s, lookahead=%s",
                 len(m.hosts), simtime.format_time(stop),
                 simtime.format_time(lookahead))
        next_time = m.policy.next_event_time()
        while next_time < stop:
            window_end = min(next_time + lookahead, stop)
            next_time = m.run_window(next_time, window_end)
        stats = m.finalize()
        stats.end_time = stop
        stats.wall_s = time.perf_counter() - t0
        stats.policy = self.policy
        stats.loop = "cpu"
        stats.path_packets = dict(m.netmodel.path_packets)
        if self.judge is not None:
            j = self.judge
            stats.judge = j.counters()
            log.info("hybrid perf: %d packets judged on device in %d "
                     "batches (%.1f pkts/batch); %d packets in %d "
                     "sub-threshold rounds stayed on the CPU "
                     "(min_batch=%d)", j.packets, j.batches,
                     j.packets / j.batches if j.batches else 0.0,
                     j.cpu_packets, j.cpu_batches, j.min_batch)
        return stats
