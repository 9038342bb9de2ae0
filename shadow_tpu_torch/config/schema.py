"""Configuration schema (the port's copy of the reference package's
config/schema.py, cut to the port's slices).

YAML-compatible with the reference: sections `general`, `network`,
`experimental` and `hosts.<name>` with nested `processes`. Every key
the reference accepts is accepted here too, and a typo'd key fails as
it does there. Keys whose behaviour the port does not have yet are
kept raw in `ExperimentalOptions.later` (and `ensemble` likewise), so
that the slice check (core/build.py) refuses them by name instead of
silently running without them; `network.faults` entries are validated
as the reference validates them, and the slice check refuses the host
faults among them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from shadow_tpu_torch.config.units import (
    parse_bandwidth_bits,
    parse_size_bytes,
    parse_time_ns,
)

# network.graph keys of the star_clusters generator
STAR_CLUSTERS_KEYS = ("clusters", "spokes_per_cluster", "hub_latency",
                      "access_latency", "hub_packet_loss",
                      "access_packet_loss", "bandwidth_down",
                      "bandwidth_up")

SCHEDULER_POLICIES = ("host", "steal", "thread", "threadXthread",
                      "threadXhost", "serial", "tpu", "hybrid")

# experimental keys of the reference that the port does not run yet,
# each with the ROADMAP.md item that ports it
LATER_EXPERIMENTAL = {
    **dict.fromkeys(
        ("use_cpu_pinning", "workers", "use_memory_manager",
         "use_seccomp", "use_shim_syscall_handler", "preload_spin_max",
         "interface_qdisc", "interface_buffer", "socket_recv_buffer",
         "socket_send_buffer", "socket_recv_autotune",
         "socket_send_autotune", "tcp_congestion", "router_queue",
         "router_static_capacity", "hybrid_cpu_policy",
         "hybrid_judge_min_batch"),
        "queue (a) item 10 (the hybrid policy; CPU-engine options)"),
    **dict.fromkeys(
        ("capacity_plan", "capacity_warmup", "capacity_headroom",
         "strategy_plan", "dispatch_segment", "pipeline_depth",
         "checkpoint_save", "checkpoint_save_time", "checkpoint_load",
         "checkpoint_every", "checkpoint_keep", "device_batch_rounds",
         "heartbeat_stale_after", "telemetry", "telemetry_path",
         "artifacts_dir"),
        "queue (a) item 7 (runner, supervise, checkpoint)"),
    **dict.fromkeys(("exchange", "exchange_capacity",
                     "exchange_capacity2", "mesh_shards", "mesh_axis"),
                    "queue (a) item 9 (multi-GPU)"),
    **dict.fromkeys(("outbox_compact",),
                    "queue (b) item 7 (the outbox compaction)"),
    **dict.fromkeys(
        ("dispatch_retries", "dispatch_retry_backoff", "failover",
         "chaos", "round_watchdog", "round_watchdog_dump"),
        "queue (a) item 13 (the robustness layer)"),
    **dict.fromkeys(("compile_cache", "compile_cache_cap_mb"),
                    "queue (a) item 14 (compile cache, tune, serve)"),
}

# the reference's layout variants (in-step vs flush judge, window vs
# global merge, gather vs one-hot reads) and their choices: every
# variant gives the same trace and the port has one kernel per phase,
# so the keys are validated and then ignored
LAYOUT_VARIANTS = {
    "judge_placement": ("auto", "flush", "step"),
    "merge_strategy": ("auto", "global", "window"),
    "pop_strategy": ("auto", "onehot", "gather"),
    "table_strategy": ("auto", "onehot", "gather"),
}


def _check_keys(section: str, d: dict, allowed: set[str]) -> None:
    """Reject unknown keys: a typo'd option must fail loudly, not
    silently keep its default."""
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(
            f"unknown key(s) in {section}: {sorted(unknown)} "
            f"(allowed: {sorted(allowed)})"
        )


def _check_choice(section: str, name: str, value: str, choices) -> None:
    if value not in choices:
        raise ValueError(
            f"{section}.{name}={value!r} is not one of {list(choices)}"
        )


@dataclass
class ProcessOptions:
    path: str
    args: Any = ""
    quantity: int = 1
    start_time: int = 0            # sim ns
    stop_time: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessOptions":
        _check_keys("process", d, {"path", "args", "environment", "quantity",
                                   "start_time", "stop_time"})
        return cls(
            path=d["path"],
            args=d.get("args", ""),
            quantity=int(d.get("quantity", 1)),
            start_time=parse_time_ns(d.get("start_time", 0)),
            stop_time=(parse_time_ns(d["stop_time"])
                       if d.get("stop_time") is not None else None),
        )


@dataclass
class HostOptions:
    name: str = ""
    quantity: int = 1
    network_node_id: Optional[int] = None  # pin to a topology vertex id
    # host i of the group attaches at vertex network_node_id + i*stride
    network_node_stride: int = 0
    # bits/s; None = the topology vertex's bandwidth (model NIC)
    bandwidth_down: Optional[int] = None
    bandwidth_up: Optional[int] = None
    ip_address_hint: Optional[str] = None
    country_code_hint: Optional[str] = None
    city_code_hint: Optional[str] = None
    processes: list[ProcessOptions] = field(default_factory=list)

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "HostOptions":
        _check_keys(f"hosts.{name}", d, {
            "quantity", "bandwidth_down", "bandwidth_up", "network_node_id",
            "network_node_stride",
            "ip_address_hint", "ip_addr", "country_code_hint",
            "city_code_hint", "log_level", "pcap_directory", "options",
            "processes",
        })
        stride = int(d.get("network_node_stride", 0))
        if stride < 0:
            raise ValueError(
                f"hosts.{name}: network_node_stride must be >= 0")
        if stride > 0 and d.get("network_node_id") is None:
            raise ValueError(
                f"hosts.{name}: network_node_stride needs "
                "network_node_id (the stride's base vertex)")
        return cls(
            name=name,
            quantity=int(d.get("quantity", 1)),
            network_node_id=(int(d["network_node_id"])
                             if d.get("network_node_id") is not None
                             else None),
            network_node_stride=stride,
            bandwidth_down=(parse_bandwidth_bits(d["bandwidth_down"])
                            if d.get("bandwidth_down") is not None
                            else None),
            bandwidth_up=(parse_bandwidth_bits(d["bandwidth_up"])
                          if d.get("bandwidth_up") is not None else None),
            ip_address_hint=d.get("ip_address_hint") or d.get("ip_addr"),
            country_code_hint=d.get("country_code_hint"),
            city_code_hint=d.get("city_code_hint"),
            processes=[ProcessOptions.from_dict(p)
                       for p in d.get("processes", [])],
        )


@dataclass
class GeneralOptions:
    stop_time: int = 0                      # sim ns
    seed: int = 1
    bootstrap_end_time: int = 0             # no drops until here

    @classmethod
    def from_dict(cls, d: dict) -> "GeneralOptions":
        # the reference's other general keys (parallelism, logging,
        # heartbeat, data directories, progress) do not change the
        # simulated schedule; they are accepted and have no effect here
        _check_keys("general", d, {
            "stop_time", "seed", "parallelism", "bootstrap_end_time",
            "log_level", "heartbeat_interval", "data_directory",
            "template_directory", "progress",
            "model_unblocked_syscall_latency",
        })
        return cls(
            stop_time=parse_time_ns(d.get("stop_time", 0)),
            seed=int(d.get("seed", 1)),
            bootstrap_end_time=parse_time_ns(d.get("bootstrap_end_time", 0)),
        )


def _fault_from_dict(i: int, d: dict):
    """One `network.faults` entry -> a validated FaultEvent, checked as
    the reference checks it at load; what needs the graph (the edge
    exists, down/up pairing) is checked when the schedule compiles
    (faults.compile_link_faults). faults.py imports the topology,
    which imports this package: hence the import here."""
    from shadow_tpu_torch.faults import (
        FAULT_KINDS,
        HOST_KINDS,
        LINK_KINDS,
        FaultEvent,
    )

    section = f"network.faults[{i}]"
    if not isinstance(d, dict):
        raise ValueError(f"{section} must be a mapping")
    _check_keys(section, d, {"kind", "time", "source", "target",
                             "duration", "latency_multiplier",
                             "extra_packet_loss", "host"})
    kind = d.get("kind")
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"{section}.kind={kind!r} is not one of {list(FAULT_KINDS)}")
    if "time" not in d:
        raise ValueError(f"{section}: missing required key 'time'")
    if kind in LINK_KINDS:
        if d.get("source") is None or d.get("target") is None:
            raise ValueError(
                f"{section}: {kind} needs 'source' and 'target' "
                "topology vertex ids")
        if d.get("host") is not None:
            raise ValueError(
                f"{section}: 'host' is only valid for "
                f"{list(HOST_KINDS)}")
    else:
        if not d.get("host"):
            raise ValueError(
                f"{section}: {kind} needs 'host' (a configured host "
                "name, group-expanded like client0)")
        for bad in ("source", "target", "duration",
                    "latency_multiplier", "extra_packet_loss"):
            if d.get(bad) is not None:
                raise ValueError(
                    f"{section}: {bad!r} is only valid for link "
                    "faults")
    if kind != "degrade":
        for bad in ("duration", "latency_multiplier",
                    "extra_packet_loss"):
            if d.get(bad) is not None:
                raise ValueError(
                    f"{section}: {bad!r} is only valid for degrade")
    return FaultEvent(
        kind=kind,
        time=parse_time_ns(d["time"]),
        source=int(d["source"]) if d.get("source") is not None else -1,
        target=int(d["target"]) if d.get("target") is not None else -1,
        duration=(parse_time_ns(d["duration"])
                  if d.get("duration") is not None else 0),
        latency_multiplier=float(d.get("latency_multiplier", 1.0)),
        extra_packet_loss=float(d.get("extra_packet_loss", 0.0)),
        host=str(d.get("host", "")),
    )


@dataclass
class NetworkOptions:
    graph_type: str = "1_gbit_switch"
    graph_file: Optional[str] = None
    graph_inline: Optional[str] = None
    # generator keys (graph.type: star_clusters, topology/generate.py)
    graph_params: dict = field(default_factory=dict)
    use_shortest_path: bool = True
    representation: str = "dense"
    faults: list = field(default_factory=list)   # [FaultEvent]

    @classmethod
    def from_dict(cls, d: dict) -> "NetworkOptions":
        _check_keys("network", d, {"graph", "use_shortest_path",
                                   "topology", "faults"})
        graph = d.get("graph", {}) or {}
        _check_keys("network.graph", graph,
                    {"type", "file", "inline", *STAR_CLUSTERS_KEYS})
        gtype = graph.get("type", "1_gbit_switch")
        gfile = None
        if isinstance(graph.get("file"), dict):
            gfile = graph["file"].get("path")
        elif isinstance(graph.get("file"), str):
            gfile = graph["file"]
        params = {k: graph[k] for k in STAR_CLUSTERS_KEYS if k in graph}
        if params and gtype != "star_clusters":
            raise ValueError(
                "network.graph: generator keys "
                f"{sorted(params)} are only valid with "
                "type: star_clusters")
        topo = d.get("topology", {}) or {}
        _check_keys("network.topology", topo, {"representation"})
        rep = str(topo.get("representation", "dense"))
        if rep not in ("dense", "hierarchical", "auto"):
            raise ValueError(
                "network.topology.representation must be dense, "
                f"hierarchical or auto (got {rep!r})")
        raw_faults = d.get("faults") or []
        if not isinstance(raw_faults, list):
            raise ValueError("network.faults must be a list of fault "
                             "events")
        return cls(
            graph_type=gtype,
            graph_file=gfile,
            graph_inline=graph.get("inline"),
            graph_params=params,
            use_shortest_path=bool(d.get("use_shortest_path", True)),
            representation=rep,
            faults=[_fault_from_dict(i, f)
                    for i, f in enumerate(raw_faults)],
        )


@dataclass
class ExperimentalOptions:
    interpose_method: str = "model"
    scheduler_policy: str = "serial"
    runahead: Optional[int] = None          # lookahead override, ns
    event_capacity: int = 64                # heap slots per host
    outbox_capacity: int = 32               # outbox lanes per host/phase
    exchange_in_capacity: int = 0           # arrivals per host/flush
    # events a burst host pops per iteration (0 = the app's default,
    # 1 = no bursts); traces are the same at any width
    burst_pops: int = 0
    # preflight admission (device/capacity.py): "auto" admits, loudly
    # when over budget; "strict" refuses an over-budget run; "off"
    # skips the check
    admission: str = "auto"
    # per-device memory budget in bytes ("8 GiB" accepted), used where
    # the backend reports no limit; 0 = none
    device_memory_budget: int = 0
    # bandwidth + CoDel for raw model sends (host/model_nic.py)
    model_bandwidth: bool = False
    # the [V,V] histogram of sent packets (V*V <= 65536)
    count_paths: bool = False
    # the per-host health word, checked at the run's end
    state_audit: bool = False
    # reference keys set in the config that the port does not run yet
    later: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentalOptions":
        own = {"interpose_method", "scheduler_policy", "runahead",
               "event_capacity", "outbox_capacity",
               "exchange_in_capacity", "burst_pops", "admission",
               "device_memory_budget", "model_bandwidth", "count_paths",
               "state_audit"}
        _check_keys("experimental", d,
                    own | set(LAYOUT_VARIANTS) | set(LATER_EXPERIMENTAL))
        out = cls(later={k: v for k, v in d.items()
                         if k in LATER_EXPERIMENTAL})
        for name in own & set(d):
            v = d[name]
            if name == "runahead":
                v = parse_time_ns(v) if v is not None else None
            elif name in ("event_capacity", "outbox_capacity",
                          "exchange_in_capacity", "burst_pops"):
                v = int(v)
            elif name == "device_memory_budget":
                v = parse_size_bytes(v)
            elif name in ("model_bandwidth", "count_paths",
                          "state_audit"):
                v = bool(v)
            setattr(out, name, v)
        if not 0 <= out.burst_pops <= 32:
            raise ValueError("experimental.burst_pops must be in 0..32")
        if out.model_bandwidth and d.get("judge_placement") == "flush":
            raise ValueError(
                "experimental.judge_placement: flush cannot combine "
                "with model_bandwidth (the fluid NIC's tx/rx state "
                "is sequential per event; judgment stays in-step)")
        if out.burst_pops > 1 and out.model_bandwidth:
            raise ValueError(
                "experimental.burst_pops > 1 cannot combine with "
                "model_bandwidth (the fluid NIC's tx/rx state is "
                "sequential per event — the engine would silently "
                "degrade the requested width to 1)")
        _check_choice("experimental", "scheduler_policy",
                      out.scheduler_policy, SCHEDULER_POLICIES)
        _check_choice("experimental", "interpose_method",
                      out.interpose_method, ("preload", "ptrace", "model"))
        for name in LAYOUT_VARIANTS.keys() & d.keys():
            _check_choice("experimental", name, d[name],
                          LAYOUT_VARIANTS[name])
        if isinstance(out.admission, bool):
            # YAML 1.1 reads bare `off`/`on` as booleans; `on` is the
            # default mode, auto
            out.admission = "auto" if out.admission else "off"
        _check_choice("experimental", "admission", out.admission,
                      ("auto", "off", "strict"))
        if out.admission == "strict" and out.scheduler_policy != "tpu":
            raise ValueError(
                "experimental.admission: strict gates DEVICE engine "
                "footprints and requires scheduler_policy: tpu (CPU "
                "policies have no device budget to admit against)")
        if out.device_memory_budget and out.scheduler_policy != "tpu":
            raise ValueError(
                "experimental.device_memory_budget bounds the DEVICE "
                "engine's footprint and requires scheduler_policy: "
                "tpu")
        return out


@dataclass
class ConfigOptions:
    general: GeneralOptions = field(default_factory=GeneralOptions)
    network: NetworkOptions = field(default_factory=NetworkOptions)
    experimental: ExperimentalOptions = field(
        default_factory=ExperimentalOptions)
    hosts: list[HostOptions] = field(default_factory=list)
    ensemble: Optional[dict] = None          # raw; refused by slice

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigOptions":
        _check_keys("config", d, {"general", "network", "experimental",
                                  "hosts", "host_option_defaults",
                                  "host_defaults", "ensemble"})
        hosts = [HostOptions.from_dict(name, hd or {})
                 for name, hd in (d.get("hosts", {}) or {}).items()]
        return cls(
            general=GeneralOptions.from_dict(d.get("general", {}) or {}),
            network=NetworkOptions.from_dict(d.get("network", {}) or {}),
            experimental=ExperimentalOptions.from_dict(
                d.get("experimental", {}) or {}),
            hosts=hosts,
            ensemble=d.get("ensemble") or None,
        )

    def total_hosts(self) -> int:
        return sum(h.quantity for h in self.hosts)
