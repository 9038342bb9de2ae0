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

import logging
import time
from typing import Optional

import numpy as np
import torch

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
    phase_params,
    resolve_device,
    state_from_numpy,
    state_to_numpy,
    world_arrays,
)
from shadow_tpu_torch.device.kernels import Kernels, build_library, \
    control_block
from shadow_tpu_torch.device.mesh import DEFAULT_TIMEOUT, spawn
from shadow_tpu_torch.device.supervise import check_audit
from shadow_tpu_torch.topology.hierarchy import world_tables

log = logging.getLogger("shadow_tpu_torch")

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
        merge_global=xp.merge_strategy == "global", exchange=xp.exchange,
        exchange_capacity=xp.exchange_capacity,
        exchange_capacity2=xp.exchange_capacity2)


def admit(cfg: ConfigOptions, sim: BuiltSimulation, config: EngineConfig,
          device, ensemble=None, batchable: bool = False,
          mesh=None) -> dict:
    """The preflight admission verdict of a built run, or of the
    campaign of `ensemble` worlds, or of one rank of `mesh`
    (device/mesh.py), on `device`, from shapes and host arrays alone
    (nothing is allocated on the device); raises ValueError where
    `admission: strict` refuses. Where a `batchable` campaign does not
    fit, `auto` offers a replica batch that does."""
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
            config.n_hosts, sim.app, sim.host_vertex, ensemble,
            sim.bw_up_bits, sim.bw_down_bits, config.model_bandwidth,
            config.count_paths)

    def estimate(replicas=None):
        return capacity.footprint(n_hosts, params, world, replicas, mp)

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
                mesh=None) -> DeviceEngine:
    """The engine of a built simulation, or with `ensemble` worlds
    (ensemble/spec.py) the campaign engine of their replicas, or with
    `mesh` (device/mesh.py) the engine of one mesh rank, at `lookahead`
    where given; its `admission` holds the verdict, reached before the
    engine allocates anything. Raises NoDeviceTwin where the build
    found none (core/controller.py runs such a config on the hybrid
    policy)."""
    if sim.app is None:
        raise NoDeviceTwin(sim.no_twin or "the config's policy is not "
                           "tpu: the CPU engine runs it")
    config = engine_config(cfg, sim, lookahead)
    if ensemble is not None:
        config.seed = int(ensemble.seeds[0])
    verdict = admit(cfg, sim, config, device, ensemble, mesh=mesh)
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
    """Admit and run a built `tpu` config through the engine's own
    window loop (DeviceEngine.run); under the state audit, raise
    AuditFailure where the health word is not zero at the end. An
    `ensemble:` config runs through ensemble/campaign.py."""
    if cfg.ensemble is not None:
        raise ValueError("an ensemble: config is a campaign: run it with "
                         "shadow_tpu_torch.ensemble.campaign."
                         "EnsembleRunner (the CLI does)")
    if cfg.experimental.mesh_shards > 1:
        return run_mesh(cfg, mesh_devices(cfg.experimental.mesh_shards,
                                          device))
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
    return stats_of(cfg, engine, final, rounds, time.perf_counter() - t0)


def stats_of(cfg: ConfigOptions, engine: DeviceEngine, final: dict,
             rounds: int, wall: float) -> SimStats:
    """The SimStats of a run's final leaves `final` (numpy, the hosts
    of the config in id order: a mesh's gathered leaves without its
    padded hosts)."""
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


def run_mesh(cfg: ConfigOptions, devices, timeout: float = DEFAULT_TIMEOUT
             ) -> SimStats:
    """Run a config on a mesh of one rank per entry of `devices` (the
    counterpart of the reference runner's `mesh=`; S distinct cards run
    NCCL, a card named more than once or the CPU gloo, mesh_backend);
    the SimStats of its hosts, assembled by rank 0 in the one-device
    layout, with `mesh` the exchange's record."""
    stats = mesh_runs(devices, [cfg], timeout=timeout)[0][0]
    m = stats.mesh
    log.info("mesh: %d ranks (%s), exchange %s (config: %s), CAP %d, "
             "CAP2 %d; rank 0 sent %d B, staging %.3f s, collectives "
             "%.3f s", m["shards"], m["backend"], m["exchange"],
             cfg.experimental.exchange, m["cap"], m["cap2"],
             m["moved_bytes"], m["stage_s"], m["collective_s"])
    return stats


def mesh_runs(devices, cfgs: list, keep_state: bool = False,
              timing: bool = False,
              timeout: float = DEFAULT_TIMEOUT) -> list:
    """Each config run in turn on one spawned mesh: [(SimStats, the
    final leaves gathered into the H_pad layout where `keep_state`,
    else None), ...]. `stats.mesh["ranks"]` holds each rank's record:
    its exchange (mesh_stats), kernel launches, peak device memory (on
    a card) and, with `timing` (Kernels(timing=True): an event pair
    around each launch), its device ms per kernel;
    `stats.mesh["launches"]` sums the launches over the ranks. The CUDA
    kernels are built here, before the ranks start, so that the ranks
    only load them."""
    if any(torch.device(d).type == "cuda" for d in devices):
        build_library()
    return spawn(devices, _mesh_runs_rank, (cfgs, keep_state, timing),
                 timeout)


def _mesh_runs_rank(mesh, cfgs: list, keep_state: bool,
                    timing: bool) -> list:
    out = []
    cuda = mesh.device.type == "cuda"
    for cfg in cfgs:
        sim = build(cfg)
        if cuda:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        kernels = Kernels(timing=timing)
        engine = engine_from(cfg, sim, device=mesh.device, kernels=kernels,
                             mesh=mesh)
        state = engine.init_state(sim.start_times, sim.stop_times)
        mesh.barrier()
        t0 = time.perf_counter()
        state, rounds = engine.run(state)
        leaves = mesh.gather_leaves(state_to_numpy(state))
        wall = time.perf_counter() - t0
        ranks = mesh.gather({
            **engine.loop_stats["mesh"],
            "launches": {k: n for k, n in kernels.launches.items() if n},
            "peak_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if cuda else None),
            "estimate_bytes": engine.admission["estimate"]["per_device"],
            "kernel_ms": ({k: v for k, v in kernels.kernel_ms().items()
                           if v} if timing else None)})
        if mesh.rank == 0:
            H = len(sim.host_vertex)
            stats = stats_of(cfg, engine, {k: leaves[k][:H]
                                           for k in STAT_KEYS}, rounds,
                             wall)
            stats.admission = engine.admission
            launches = {}
            for r in ranks:
                for k, n in r["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            stats.mesh = {**stats.mesh, "ranks": ranks,
                          "launches": launches}
            out.append((stats, leaves if keep_state else None))
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


def shard_state(leaves: dict, mp) -> dict:
    """Rank mp.shard's rows of global leaves (numpy, shard-major as the
    reference's arrays are: per-host leaves [H_pad, ...], occ_x [S, S],
    occ_trips and occ_phases [S])."""
    out = {}
    for k, v in leaves.items():
        v = np.asarray(v)
        n = v.shape[0] // mp.S
        out[k] = np.ascontiguousarray(v[mp.shard * n:(mp.shard + 1) * n])
    return out


def gather_state(parts: list) -> dict:
    """The global leaves of the ranks' leaves `parts`, in rank order:
    `shard_state`'s inverse."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
