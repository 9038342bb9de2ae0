"""Instantiate a config for the port's device engine.

The port of the reference package's columnar build
(core/controller.py `build`/`_build_columnar`, `_lookahead`) and of the
PHOLD branch of device/runner.py `_plane_twin`: every per-host quantity
is an array fill over host groups, and the app is one PholdDevice whose
args must match across groups.

The port runs one slice of the reference so far: PHOLD on the `tpu`
policy, one GPU, dense topology, no faults, no ensemble. `check_slice`
refuses any config outside it with an error naming the ROADMAP.md item
that will port it; nothing outside the slice runs silently.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass

import numpy as np

from shadow_tpu_torch.config.schema import (
    LATER_EXPERIMENTAL,
    ConfigOptions,
)
from shadow_tpu_torch.device.apps import PholdDevice
from shadow_tpu_torch.topology.graph import Topology


class OutsideSlice(ValueError):
    """The config needs a part of the reference the port has not
    ported yet."""


def _refuse(what: str, item: str) -> None:
    raise OutsideSlice(f"{what} is not ported to shadow_tpu_torch yet "
                       f"(ROADMAP.md {item})")


def check_slice(cfg: ConfigOptions) -> None:
    xp = cfg.experimental
    if xp.scheduler_policy != "tpu":
        _refuse(f"experimental.scheduler_policy: {xp.scheduler_policy} "
                "(the port runs the device engine, policy tpu)",
                "queue (a) item 10 (CPU and hybrid policies)")
    if xp.interpose_method != "model":
        _refuse(f"experimental.interpose_method: {xp.interpose_method}",
                "queue (a) item 10 (real processes)")
    for key in xp.later:
        _refuse(f"experimental.{key}", LATER_EXPERIMENTAL[key])
    if cfg.ensemble:
        _refuse("ensemble", "queue (a) item 12 (ensemble campaigns)")
    if cfg.network.faults:
        _refuse("network.faults", "queue (a) item 8 (fault epochs)")
    if cfg.network.representation != "dense":
        _refuse("network.topology.representation: "
                f"{cfg.network.representation}",
                "queue (a) item 8 (hierarchical tables)")
    if cfg.network.graph_type not in ("gml", "1_gbit_switch"):
        _refuse(f"network.graph.type: {cfg.network.graph_type}",
                "queue (a) item 8 (generated topologies)")
    if not cfg.hosts:
        raise ValueError("config has no host groups")
    for g in cfg.hosts:
        procs = g.processes
        if len(procs) != 1 or procs[0].quantity != 1:
            _refuse(f"hosts.{g.name}: {sum(p.quantity for p in procs)} "
                    "processes per host", "queue (a) item 10 (hybrid "
                    "policy for multi-process hosts)")
        path = procs[0].path
        if path != "model:phold":
            _refuse(f"hosts.{g.name}: process {path!r} (the port runs "
                    "model:phold)", "queue (a) item 6 (TgenDevice), "
                    "item 11 (TorDevice) and item 10 (real processes)")
        if g.ip_address_hint or g.city_code_hint or g.country_code_hint:
            _refuse(f"hosts.{g.name}: attachment hints",
                    "queue (a) item 7 (the object build)")


def load_topology(cfg: ConfigOptions) -> Topology:
    net = cfg.network
    if net.graph_type == "1_gbit_switch":
        return Topology.builtin_1_gbit_switch()
    if net.graph_inline:
        return Topology.from_gml(net.graph_inline, net.use_shortest_path)
    if net.graph_file:
        with open(net.graph_file) as f:
            return Topology.from_gml(f.read(), net.use_shortest_path)
    raise ValueError("network.graph.type=gml needs file.path or inline")


def _parse_kv_args(args) -> dict[str, str]:
    """Process args as "k=v k=v" strings, lists or mappings."""
    if isinstance(args, dict):
        return {str(k): str(v) for k, v in args.items()}
    parts = ([str(p) for p in args] if isinstance(args, (list, tuple))
             else shlex.split(str(args or "")))
    out = {}
    for p in parts:
        k, eq, v = p.partition("=")
        if eq:
            out[k.strip("-")] = v
    return out


@dataclass
class BuiltSimulation:
    cfg: ConfigOptions
    topology: Topology
    host_vertex: np.ndarray     # [H] int32 vertex index per host
    start_times: np.ndarray     # [H] int64 boot time
    stop_times: np.ndarray      # [H] int64 stop time, -1 = none
    lookahead: int              # conservative window, ns
    app: PholdDevice


def build(cfg: ConfigOptions) -> BuiltSimulation:
    check_slice(cfg)
    topology = load_topology(cfg)
    n_total = cfg.total_hosts()
    v_parts, t0_parts, t1_parts, args = [], [], [], []
    for g in cfg.hosts:
        q = g.quantity
        if g.network_node_stride > 0:
            base = topology.vertex_index_for_id(g.network_node_id)
            last = base + (q - 1) * g.network_node_stride
            if last >= topology.n_vertices:
                raise ValueError(
                    f"hosts.{g.name}: network_node_stride walks past "
                    f"the topology (host {q - 1} would attach at vertex "
                    f"{last}, the graph has {topology.n_vertices})")
            v = base + np.arange(q, dtype=np.int64) * g.network_node_stride
        elif g.network_node_id is not None:
            v = np.full(q, topology.vertex_index_for_id(g.network_node_id),
                        dtype=np.int64)
        elif topology.n_vertices == 1:
            v = np.zeros(q, dtype=np.int64)
        else:
            _refuse(f"hosts.{g.name}: no network_node_id on a "
                    f"{topology.n_vertices}-vertex graph (random "
                    "attachment)", "queue (a) item 7 (the object build)")
        proc = g.processes[0]
        v_parts.append(v)
        t0_parts.append(np.full(q, proc.start_time, dtype=np.int64))
        t1_parts.append(np.full(q, -1 if proc.stop_time is None
                                else proc.stop_time, dtype=np.int64))
        a = _parse_kv_args(proc.args)
        args.append((int(a.get("msgload", 1)), int(a.get("size", 64)),
                     int(a.get("selfloop", 0))))
    if len(set(args)) != 1:
        raise ValueError("tpu policy: phold args must match across hosts")
    msgload, size, selfloop = args[0]
    t0 = np.concatenate(t0_parts)
    t1 = np.concatenate(t1_parts)
    bad = np.flatnonzero((t1 >= 0) & (t1 < t0))
    if bad.size:
        h = int(bad[0])
        raise ValueError(f"host {h}: stop_time {int(t1[h])} precedes "
                         f"start_time {int(t0[h])}")
    lookahead = (cfg.experimental.runahead
                 if cfg.experimental.runahead is not None
                 else topology.min_latency_ns)
    return BuiltSimulation(
        cfg=cfg, topology=topology,
        host_vertex=np.concatenate(v_parts).astype(np.int32),
        start_times=t0, stop_times=t1, lookahead=int(lookahead),
        app=PholdDevice(n_hosts_total=n_total, msgload=msgload,
                        size=size, selfloop=selfloop))
