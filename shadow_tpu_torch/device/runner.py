"""A lean runner for the port's device engine (the counterpart of the
reference package's device/runner.py `DeviceRunner`, without segments,
supervision, capacity planning or a compile cache).

It builds the engine from a config with the reference's knobs (the
burst width of `experimental.burst_pops`, the outbox floored at 8 pop
iterations of lanes, 4 where bursts drain backlogs, the lookahead from
the runahead or the minimum path latency over every fault epoch, the
path tables in the topology's representation with the link-fault
epochs, the hosts' model-NIC bandwidths), admits it against the
device's memory (`experimental.admission`, device/capacity.py) before
anything is allocated on the device, runs to the stop time (on the
card through the captured window loop, in timing mode through the
Python loop; device/engine.py) and returns the SimStats totals plus the
per-host `events_executed` and `trace_checksum` arrays, for tgen and
Tor the downloads completed, under `count_paths` the sent packets per
vertex pair, and the loop's phases and host syncs. Under
`experimental.state_audit` it checks the health word at the run's end
and raises `AuditFailure` (device/supervise.py) where it is not zero.
`engine_from` also builds an ensemble campaign's engine, whose R
replicas ensemble/campaign.py runs. `run` takes any config through the
policy dispatch of core/controller.py, which hands a `tpu` config with
a device twin to `run_device` and runs the others (host faults, mixed
model families, the `hybrid` and `serial` policies) on the CPU engine.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from shadow_tpu_torch.config.schema import ConfigOptions
from shadow_tpu_torch.core.build import BuiltSimulation, NoDeviceTwin, build
from shadow_tpu_torch.core.stats import SimStats
from shadow_tpu_torch.device import capacity
from shadow_tpu_torch.device.engine import (
    DeviceEngine,
    EngineConfig,
    campaign_world_arrays,
    phase_params,
    resolve_device,
    state_to_numpy,
    world_arrays,
)
from shadow_tpu_torch.device.kernels import Kernels
from shadow_tpu_torch.device.supervise import check_audit
from shadow_tpu_torch.topology.hierarchy import world_tables

STAT_KEYS = ("n_exec", "n_sent", "n_drop", "n_deliv", "chk", "overflow",
             "x_overflow", "app")


def engine_config(cfg: ConfigOptions, sim: BuiltSimulation,
                  lookahead: Optional[int] = None) -> EngineConfig:
    """The engine's shape from the config and the built simulation
    (`lookahead` overrides the simulation's: a campaign's is the
    minimum over its replicas); sets the app's burst width."""
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
    return EngineConfig(
        n_hosts=len(sim.host_vertex),
        event_capacity=xp.event_capacity,
        outbox_capacity=outbox,
        lookahead=max(1, sim.lookahead if lookahead is None
                      else lookahead),
        stop_time=cfg.general.stop_time,
        bootstrap_end=cfg.general.bootstrap_end_time,
        seed=cfg.general.seed,
        exchange_in_capacity=xp.exchange_in_capacity,
        model_bandwidth=xp.model_bandwidth, count_paths=xp.count_paths,
        audit=xp.state_audit, outbox_compact=xp.outbox_compact,
        merge_global=xp.merge_strategy == "global")


def admit(cfg: ConfigOptions, sim: BuiltSimulation, config: EngineConfig,
          device, ensemble=None, batchable: bool = False) -> dict:
    """The preflight admission verdict of a built run, or of the
    campaign of `ensemble` worlds, on `device`, from shapes and host
    arrays alone (nothing is allocated on the device); raises
    ValueError where `admission: strict` refuses. Where a `batchable`
    campaign does not fit, `auto` offers a replica batch that does."""
    params = phase_params(config, sim.app)
    if ensemble is None:
        world = world_arrays(config.n_hosts, sim.app, sim.host_vertex,
                             *world_tables(sim.topology, sim.fault_table),
                             sim.bw_up_bits, sim.bw_down_bits,
                             config.model_bandwidth, config.count_paths,
                             params.seed)
    else:
        world = campaign_world_arrays(
            config.n_hosts, sim.app, sim.host_vertex, ensemble,
            sim.bw_up_bits, sim.bw_down_bits, config.model_bandwidth,
            config.count_paths)

    def estimate(replicas=None):
        return capacity.footprint(config.n_hosts, params, world, replicas)

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
                lookahead: Optional[int] = None) -> DeviceEngine:
    """The engine of a built simulation, or with `ensemble` worlds
    (ensemble/spec.py) the campaign engine of their replicas, at
    `lookahead` where given; its `admission` holds the verdict, reached
    before the engine allocates anything. Raises NoDeviceTwin where the
    build found none (core/controller.py runs such a config on the
    hybrid policy)."""
    if sim.app is None:
        raise NoDeviceTwin(sim.no_twin or "the config's policy is not "
                           "tpu: the CPU engine runs it")
    config = engine_config(cfg, sim, lookahead)
    if ensemble is not None:
        config.seed = int(ensemble.seeds[0])
    verdict = admit(cfg, sim, config, device, ensemble)
    lat, rel, epoch_times = (world_tables(sim.topology, sim.fault_table)
                             if ensemble is None else (None, None, None))
    engine = DeviceEngine(config, sim.app, host_vertex=sim.host_vertex,
                          latency_ns=lat, reliability=rel, device=device,
                          kernels=kernels, epoch_times=epoch_times,
                          bw_up_bits=sim.bw_up_bits,
                          bw_down_bits=sim.bw_down_bits,
                          ensemble=ensemble)
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
    """Admit and run a built `tpu` config through the engine's own
    window loop (DeviceEngine.run); under the state audit, raise
    AuditFailure where the health word is not zero at the end. An
    `ensemble:` config runs through ensemble/campaign.py."""
    if cfg.ensemble is not None:
        raise ValueError("an ensemble: config is a campaign: run it with "
                         "shadow_tpu_torch.ensemble.campaign."
                         "EnsembleRunner (the CLI does)")
    engine = engine_from(cfg, sim, device=device, kernels=kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    t0 = time.perf_counter()
    state, rounds = engine.run(state)
    stats = summarize(cfg, engine, state, rounds, t0)
    # until segments are ported the word is checked once, at the end
    check_audit(state, where=f"t={cfg.general.stop_time} ns")
    return stats


def summarize(cfg: ConfigOptions, engine: DeviceEngine, state: dict,
              rounds: int, t0: float) -> SimStats:
    """The SimStats of a run of `engine` that started at
    `time.perf_counter()` `t0` and ended in `state` after `rounds`
    windows; the wall ends once the totals are read back (a sync)."""
    final = state_to_numpy(state, STAT_KEYS + (
        ("path_cnt",) if "path_cnt" in state else ()))   # synchronises
    wall = time.perf_counter() - t0
    loop = engine.loop_stats
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
    return stats
