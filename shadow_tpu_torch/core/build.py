"""Instantiate a config for the port's engines.

The port of the reference package's columnar build
(core/controller.py `build`/`_build_columnar`, `_lookahead`), of its
host naming (host/plane.py `name_of`, `PlaneNameMap`) and of
device/runner.py `_plane_twin`/`device_twin`: every per-host quantity is
an array fill over host groups. For the device engine (the `tpu`
policy) the app is one device twin for the whole config: a PholdDevice
whose args match across groups, a TgenDevice that gives each host its
role, its server and its client args, or a TorDevice that gives each
host its role and client args and holds the relays' ids. (The
reference builds the Tor twin from host objects, not from its columnar
plane; both number hosts in group order, so the columns here equal
that object build.) Where a `tpu` config has host faults or no single
twin (a mix of model families), `no_twin` says why, in the reference's
words, and core/controller.py runs it on the hybrid policy, as the
reference does; the CPU engine (the `serial` and `hybrid` policies)
builds its host objects from these columns.

The port runs these slices of the reference so far: PHOLD, tgen and Tor
model hosts on the `tpu`, `hybrid` and `serial` policies, one GPU, GML,
builtin or `star_clusters` graphs with dense or hierarchical tables,
link faults (compiled here into the epoch tables of faults.py) and host
faults, the model NIC, the path counters, the state audit, the outbox
compaction and ensemble campaigns (ensemble/). `check_slice` refuses
any config outside them with an error naming the ROADMAP.md item that
will port it; nothing outside runs silently.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from shadow_tpu_torch.config.schema import (
    LATER_EXPERIMENTAL,
    ConfigOptions,
)
from shadow_tpu_torch.core.scheduler import THREADED_POLICIES
from shadow_tpu_torch.core.tgen_args import TgenClientArgs
from shadow_tpu_torch.core.tor_args import TorClientArgs
from shadow_tpu_torch.device.apps import PholdDevice, TgenDevice, TorDevice
from shadow_tpu_torch.faults import (
    compile_link_faults,
    resolve_host_faults,
    split_events,
)
from shadow_tpu_torch.models.base import parse_kv_args
from shadow_tpu_torch.topology.generate import generate_star_clusters
from shadow_tpu_torch.topology.graph import Topology


class OutsideSlice(ValueError):
    """The config needs a part of the reference the port has not
    ported yet."""


class NoDeviceTwin(Exception):
    """The device engine cannot run the config as one vectorized
    program (host faults, or no single device twin of its apps); the
    `tpu` policy then runs it on the hybrid policy."""


def _refuse(what: str, item: str) -> None:
    raise OutsideSlice(f"{what} is not ported to shadow_tpu_torch yet "
                       f"(ROADMAP.md {item})")


# model process path -> the device twin that runs it
MODELS = {"model:phold": "phold", "model:tgen_server": "tgen",
          "model:tgen_client": "tgen", "model:tor_relay": "tor",
          "model:tor_client": "tor"}
# model process path -> the reference's CPU app class (its messages
# name those)
APP_CLASSES = {"model:phold": "PholdApp",
               "model:tgen_server": "TgenServerApp",
               "model:tgen_client": "TgenClientApp",
               "model:tor_relay": "TorRelayApp",
               "model:tor_client": "TorClientApp"}
HYBRID = "running hybrid (CPU hosts + device net model)"
HOST_FAULTS_HYBRID = ("host_crash/host_restart faults are manager-side "
                      "events; running hybrid")
ITEM_10 = "queue (a) item 10"
ITEM_13 = "queue (a) item 13"
ITEM_14 = "queue (a) item 14"


def check_slice(cfg: ConfigOptions) -> None:
    xp = cfg.experimental
    if xp.scheduler_policy in THREADED_POLICIES:
        _refuse(f"experimental.scheduler_policy: {xp.scheduler_policy}",
                f"{ITEM_10} (the threaded CPU policies)")
    if xp.scheduler_policy in ("tpu", "hybrid") and \
            xp.hybrid_cpu_policy != "serial":
        _refuse(f"experimental.hybrid_cpu_policy: {xp.hybrid_cpu_policy}",
                f"{ITEM_10} (the threaded CPU policies)")
    if xp.interpose_method != "model":
        _refuse(f"experimental.interpose_method: {xp.interpose_method}",
                f"{ITEM_10} (real processes)")
    for key in xp.later:
        _refuse(f"experimental.{key}", LATER_EXPERIMENTAL[key])
    check_supervision(cfg)
    _, host_faults = split_events(cfg.network.faults)
    if cfg.ensemble is not None:
        check_campaign(cfg, host_faults)
    if not cfg.hosts:
        raise ValueError("config has no host groups")
    for g in cfg.hosts:
        procs = g.processes
        if len(procs) != 1 or procs[0].quantity != 1:
            _refuse(f"hosts.{g.name}: {sum(p.quantity for p in procs)} "
                    "processes per host", f"{ITEM_10} (multi-process "
                    "hosts)")
        path = procs[0].path
        if path not in MODELS:
            _refuse(f"hosts.{g.name}: process {path!r} (the port runs "
                    f"{', '.join(sorted(MODELS))}; `model:tgen_tcp_*` "
                    "needs the socket stack)", f"{ITEM_10} (real "
                    "processes, the socket stack)")
        if g.ip_address_hint or g.city_code_hint or g.country_code_hint:
            _refuse(f"hosts.{g.name}: attachment hints",
                    "queue (a) item 7c (the object build)")


def check_supervision(cfg: ConfigOptions) -> None:
    """What of the robustness layer the port does not run yet: the
    chaos kinds of its other seams (a scripted out-of-memory error:
    item 13, its degradation ladder; the compile cache's store and the
    campaign server: item 14). Retries, the failovers (`shrink` and
    `hybrid`) and the chaos kinds `device_loss`, `dispatch_error` and
    `checkpoint_corrupt` run on one device and on a mesh, for
    standalone runs and campaigns alike."""
    for ev in cfg.experimental.chaos:
        if ev.kind == "oom":
            _refuse(f"experimental.chaos kind {ev.kind}",
                    f"{ITEM_13}.2 (the out-of-memory ladder)")
        if ev.kind == "cache_store_fail":
            _refuse(f"experimental.chaos kind {ev.kind}",
                    f"{ITEM_14} (the compile cache)")
        if ev.kind == "server_crash":
            _refuse(f"experimental.chaos kind {ev.kind}",
                    f"{ITEM_14} (the campaign server, serve/)")


def check_cpu_engine(cfg: ConfigOptions) -> None:
    """What the CPU engine (the serial and hybrid policies) refuses:
    the tracker's heartbeats and packet captures."""
    if cfg.general.heartbeat_interval:
        _refuse("general.heartbeat_interval on the serial and hybrid "
                "policies (the tracker's heartbeat)",
                f"{ITEM_10} (the tracker)")
    for g in cfg.hosts:
        if g.pcap_directory:
            _refuse(f"hosts.{g.name}: pcap_directory", f"{ITEM_10} "
                    "(packet captures)")


def _no_twin(paths: set) -> NoDeviceTwin:
    """The reference's message for a mix of model families: its
    columnar plane names models (phold, tgen), its object build, which
    Tor takes, app classes."""
    twins = {MODELS[p] for p in paths}
    if "tor" not in twins:
        models = sorted(p[len("model:"):] for p in paths)
        return NoDeviceTwin(
            f"no device twin registered for {models}; available: "
            f"phold, tgen (server+client) — {HYBRID}")
    names = sorted(APP_CLASSES[p] for p in paths)
    return NoDeviceTwin(
        f"no device twin registered for {names}; available: phold, "
        f"tgen (server+client), tor (relay+client) — {HYBRID}")


def check_campaign(cfg: ConfigOptions, host_faults: list) -> None:
    """What an `ensemble:` campaign cannot run: host faults and a Tor
    seed sweep (each with the reference's own message)."""
    if host_faults:
        raise ValueError(
            "ensemble: host_crash/host_restart faults are manager-side "
            "events — the campaign engine cannot run them (vary link "
            "faults via ensemble.fault_schedules instead)")
    seeds = set(cfg.ensemble.vary.get("seed", ()))
    if len(seeds) > 1 and any(MODELS.get(g.processes[0].path) == "tor"
                              for g in cfg.hosts if g.processes):
        # the Tor twin derives its route key from the seed at build
        # time: a seed sweep would give every replica the same routes
        raise ValueError(
            "ensemble: vary.seed is not supported for TorDevice (it "
            "derives app-internal RNG from the seed at build time); "
            "sweep latency/loss/faults instead")


def load_topology(cfg: ConfigOptions) -> Topology:
    net = cfg.network
    rep = net.representation
    if net.graph_type == "1_gbit_switch":
        return Topology.builtin_1_gbit_switch(representation=rep)
    if net.graph_type == "gml":
        if net.graph_inline:
            return Topology.from_gml(net.graph_inline,
                                     net.use_shortest_path,
                                     representation=rep)
        if net.graph_file:
            with open(net.graph_file) as f:
                return Topology.from_gml(f.read(), net.use_shortest_path,
                                         representation=rep)
        raise ValueError("network.graph.type=gml needs file.path or inline")
    if net.graph_type == "star_clusters":
        return generate_star_clusters(net.graph_params,
                                      net.use_shortest_path,
                                      representation=rep)
    raise ValueError(f"unknown graph type {net.graph_type!r}")


@dataclass
class BuiltSimulation:
    cfg: ConfigOptions
    topology: Topology
    host_vertex: np.ndarray     # [H] int32 vertex index per host
    start_times: np.ndarray     # [H] int64 boot time
    stop_times: np.ndarray      # [H] int64 stop time, -1 = none
    lookahead: int              # conservative window, ns
    # the device twin (the `tpu` policy and campaigns), else None
    app: Optional[Union[PholdDevice, TgenDevice, TorDevice]]
    bw_down_bits: np.ndarray    # [H] int64 model-NIC bandwidths, bits/s
    bw_up_bits: np.ndarray
    # the compiled link-fault schedule (faults.FaultTable or
    # HierFaultTable), None without link faults
    fault_table: object = None
    # host names <-> ids, and the groups as (name, first id, size)
    names: "HostNames" = None
    # the host faults, [(time, host id, kind)] in time order
    host_faults: list = None
    # why the device engine cannot run a `tpu` config (host faults, no
    # single twin): the reference's words; None where it can
    no_twin: Optional[str] = None


class HostNames:
    """Host name -> id over the group layout, without a per-host
    table: a group of one host is named after the group, a larger
    group's hosts are name0..name{n-1} (no leading zeros). Group sets
    whose generated names could collide are refused: the reference
    resolves those through its object build."""

    def __init__(self, groups: list[tuple[str, int, int]]):
        self.groups = {name: (base, q) for name, base, q in groups}
        for a in self.groups:
            for b in self.groups:
                if a != b and b.startswith(a) and b[len(a):].isdigit():
                    _refuse(f"host groups {a!r} and {b!r}, whose "
                            "generated host names can collide",
                            "queue (a) item 7c (the object build)")

    def name_of(self, host_id: int) -> str:
        for name, (base, q) in self.groups.items():
            if base <= host_id < base + q:
                return name if q == 1 else f"{name}{host_id - base}"
        raise KeyError(host_id)

    def get(self, name: str):
        g = self.groups.get(name)
        if g is not None and g[1] == 1:
            return g[0]
        for prefix, (base, q) in self.groups.items():
            if q > 1 and name.startswith(prefix):
                suf = name[len(prefix):]
                if suf.isdigit() and str(int(suf)) == suf and int(suf) < q:
                    return base + int(suf)
        return None

    def members(self, name: str):
        """A group's (first id, size), or None."""
        return self.groups.get(name)

    def groups_in_order(self) -> list[tuple[str, int, int]]:
        """(name, first id, size) of each group, in config order."""
        return [(n, b, q) for n, (b, q) in self.groups.items()]


def _phold_app(n_total: int, arg_list) -> PholdDevice:
    args = {(int(a.get("msgload", 1)), int(a.get("size", 64)),
             int(a.get("selfloop", 0))) for _, a in arg_list}
    if len(args) != 1:
        raise ValueError("tpu policy: phold args must match across hosts")
    msgload, size, selfloop = args.pop()
    return PholdDevice(n_hosts_total=n_total, msgload=msgload, size=size,
                       selfloop=selfloop)


def _tgen_app(n_total: int, names: HostNames, arg_list) -> TgenDevice:
    """The tgen twin: per host its role (0 server, 1 client), its
    server's id and its client args. `server=` is an exact host name
    first; else it names a group, and client `id` gets
    members[0] + id % len(members)."""
    roles = np.zeros(n_total, np.int32)
    server_gid = np.zeros(n_total, np.int32)
    count = np.zeros(n_total, np.int32)
    pause = np.zeros(n_total, np.int64)
    retry = np.zeros(n_total, np.int64)
    clients = [(g, TgenClientArgs.parse(a)) for g, a in arg_list
               if g.processes[0].path == "model:tgen_client"]
    if not clients:
        raise ValueError("tpu policy: tgen config has no clients")
    size = clients[0][1].size
    for g, c in clients:
        if c.size != size:
            raise ValueError(
                "tpu policy: tgen client `size` must match across "
                "hosts (it shapes the shared servers' responses); "
                "count/pause/retry may vary")
    for g, c in clients:
        base, q = names.members(g.name)
        sl = slice(base, base + q)
        roles[sl] = 1
        count[sl] = c.count
        pause[sl] = c.pause_ns
        retry[sl] = c.retry_ns
        sid = names.get(c.server_name)
        if sid is not None:
            server_gid[sl] = sid
            continue
        members = names.members(c.server_name)
        if not members:
            raise ValueError(f"tgen client on {names.name_of(base)}: "
                             f"unknown server {c.server_name!r}")
        ids = np.arange(base, base + q, dtype=np.int64)
        server_gid[sl] = (members[0] + ids % members[1]).astype(np.int32)
    return TgenDevice(roles=roles, server_gid=server_gid, size=size,
                      count=count, pause_ns=pause, retry_ns=retry)


def _tor_app(n_total: int, layout, arg_list, seed: int) -> TorDevice:
    """The Tor twin: per host its role (0 relay, 1 client) and client
    args, and the relays' ids in id order. `cells` shapes the exits'
    answers and must match across clients."""
    roles = np.zeros(n_total, np.int32)
    count = np.zeros(n_total, np.int32)
    pause = np.zeros(n_total, np.int64)
    retry = np.zeros(n_total, np.int64)
    relay_gids = []
    clients = []
    for (g, a), (_, base, q) in zip(arg_list, layout):
        if g.processes[0].path == "model:tor_client":
            clients.append((slice(base, base + q), TorClientArgs.parse(a)))
        else:
            relay_gids.extend(range(base, base + q))
    if not clients:
        raise ValueError("tpu policy: tor config has no clients")
    cells = clients[0][1].cells
    for sl, c in clients:
        if c.cells != cells:
            raise ValueError(
                "tpu policy: tor client `cells` must match across hosts "
                "(it shapes the exit relays' responses); "
                "count/pause/retry may vary")
        roles[sl] = 1
        count[sl] = c.count
        pause[sl] = c.pause_ns
        retry[sl] = c.retry_ns
    # TorDevice refuses fewer than 3 relays
    return TorDevice(roles=roles, relay_gids=np.array(relay_gids, np.int64),
                     seed=seed, cells=cells, count=count, pause_ns=pause,
                     retry_ns=retry)


def build(cfg: ConfigOptions) -> BuiltSimulation:
    check_slice(cfg)
    topology = load_topology(cfg)
    link_events, host_events = split_events(cfg.network.faults)
    fault_table = compile_link_faults(topology, link_events)
    n_total = cfg.total_hosts()
    v_parts, t0_parts, t1_parts, arg_list, layout = [], [], [], [], []
    d_parts, u_parts = [], []
    base = 0
    for g in cfg.hosts:
        q = g.quantity
        if g.network_node_stride > 0:
            vbase = topology.vertex_index_for_id(g.network_node_id)
            last = vbase + (q - 1) * g.network_node_stride
            if last >= topology.n_vertices:
                raise ValueError(
                    f"hosts.{g.name}: network_node_stride walks past "
                    f"the topology (host {q - 1} would attach at vertex "
                    f"{last}, the graph has {topology.n_vertices})")
            v = vbase + np.arange(q, dtype=np.int64) * g.network_node_stride
        elif g.network_node_id is not None:
            v = np.full(q, topology.vertex_index_for_id(g.network_node_id),
                        dtype=np.int64)
        elif topology.n_vertices == 1:
            v = np.zeros(q, dtype=np.int64)
        else:
            _refuse(f"hosts.{g.name}: no network_node_id on a "
                    f"{topology.n_vertices}-vertex graph (random "
                    "attachment)", "queue (a) item 7c (the object build)")
        # a group's bandwidth, else its vertices' (the reference's
        # columnar build)
        d_parts.append(np.full(q, g.bandwidth_down, dtype=np.int64)
                       if g.bandwidth_down is not None
                       else topology.bw_down_bits[v].astype(np.int64))
        u_parts.append(np.full(q, g.bandwidth_up, dtype=np.int64)
                       if g.bandwidth_up is not None
                       else topology.bw_up_bits[v].astype(np.int64))
        proc = g.processes[0]
        v_parts.append(v)
        t0_parts.append(np.full(q, proc.start_time, dtype=np.int64))
        t1_parts.append(np.full(q, -1 if proc.stop_time is None
                                else proc.stop_time, dtype=np.int64))
        arg_list.append((g, parse_kv_args(proc.args)))
        layout.append((g.name, base, q))
        base += q
    names = HostNames(layout)
    host_faults = resolve_host_faults(host_events, names)
    app, no_twin = None, None
    if cfg.ensemble is not None or \
            cfg.experimental.scheduler_policy == "tpu":
        try:
            if host_faults:
                # manager-side events: the reference's device runner
                # sends such configs to its hybrid policy
                raise NoDeviceTwin(HOST_FAULTS_HYBRID)
            app = _twin(cfg, n_total, names, arg_list, layout)
        except NoDeviceTwin as e:
            if cfg.ensemble is not None:
                raise ValueError(
                    "ensemble: the config's apps have no fully-"
                    f"vectorized device twin ({e}) — campaigns cannot "
                    "fall back to hybrid CPU emulation; run the "
                    "replicas as separate processes instead") from e
            no_twin = str(e)
    t0 = np.concatenate(t0_parts)
    t1 = np.concatenate(t1_parts)
    bad = np.flatnonzero((t1 >= 0) & (t1 < t0))
    if bad.size:
        h = int(bad[0])
        raise ValueError(f"host {h}: stop_time {int(t1[h])} precedes "
                         f"start_time {int(t0[h])}")
    # the lookahead is a floor over every fault epoch, so that each
    # backend runs the same window sequence
    min_lat = topology.min_latency_ns
    if fault_table is not None:
        min_lat = min(min_lat, fault_table.min_latency_ns)
    lookahead = (cfg.experimental.runahead
                 if cfg.experimental.runahead is not None else min_lat)
    return BuiltSimulation(
        cfg=cfg, topology=topology,
        host_vertex=np.concatenate(v_parts).astype(np.int32),
        start_times=t0, stop_times=t1, lookahead=int(lookahead), app=app,
        bw_down_bits=np.concatenate(d_parts),
        bw_up_bits=np.concatenate(u_parts), fault_table=fault_table,
        names=names, host_faults=host_faults, no_twin=no_twin)


def mesh_layout(n_hosts: int, n_shards: int) -> tuple[int, int]:
    """(H_pad, H_loc) of a mesh of n_shards ranks (the reference
    engine's engine.py:255-257): H_loc = ceil(H / S) hosts a rank."""
    h_loc = -(-n_hosts // n_shards)
    return h_loc * n_shards, h_loc


def pad_hosts(n_pad: int, host_vertex: np.ndarray, bw_up_bits=None,
              bw_down_bits=None):
    """The host columns padded to a mesh's n_pad hosts, as the reference
    engine pads them (engine.py:309-334): a padded host sits at vertex
    0 with 1 Gbit/s up and down (it holds no events); None stays
    None."""
    def pad(a, fill, dtype):
        a = np.asarray(a, dtype)
        return np.concatenate([a, np.full(n_pad - a.shape[0], fill, dtype)])

    return (pad(host_vertex, 0, np.int32),
            None if bw_up_bits is None else pad(bw_up_bits, 10**9,
                                                np.int64),
            None if bw_down_bits is None else pad(bw_down_bits, 10**9,
                                                  np.int64))


def _twin(cfg: ConfigOptions, n_total: int, names: "HostNames",
          arg_list, layout):
    """The config's device twin; NoDeviceTwin for a mix of families."""
    paths = {g.processes[0].path for g in cfg.hosts}
    twins = {MODELS[p] for p in paths}
    if len(twins) > 1:
        raise _no_twin(paths)
    twin = twins.pop()
    if twin == "phold":
        return _phold_app(n_total, arg_list)
    if twin == "tgen":
        return _tgen_app(n_total, names, arg_list)
    return _tor_app(n_total, layout, arg_list, cfg.general.seed)
