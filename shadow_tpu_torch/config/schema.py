"""Configuration schema (the port's copy of the reference package's
config/schema.py, cut to the port's slices).

YAML-compatible with the reference: sections `general`, `network`,
`experimental` and `hosts.<name>` with nested `processes`. Every key
the reference accepts is accepted here too, and a typo'd key fails as
it does there. Keys whose behaviour the port does not have yet are
kept raw in `ExperimentalOptions.later`, so that the slice check
(core/build.py) refuses them by name instead of silently running
without them; `network.faults` entries are validated as the reference
validates them. The `ensemble` section is validated as the reference
validates it (`EnsembleOptions`).
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
         "router_static_capacity"),
        "queue (a) item 10 (the socket stack and the threaded CPU "
        "policies)"),
    **dict.fromkeys(("telemetry", "telemetry_path", "artifacts_dir"),
                    "queue (a) item 7c (the object build, telemetry and "
                    "artifacts keys)"),
    **dict.fromkeys(
        ("round_watchdog", "round_watchdog_dump"),
        "queue (a) item 13.4 (the robustness layer: the round "
        "watchdog)"),
    "pipeline_depth": "queue (a) item 13.3 (the robustness layer: "
                      "pipelined segment dispatch)",
    **dict.fromkeys(("compile_cache", "compile_cache_cap_mb"),
                    "queue (a) item 14 (compile cache, tune, serve)"),
    "strategy_plan": "queue (a) item 14 (compile cache, tune, serve: "
                     "strategy plans)",
}

# the reference's layout variants (in-step vs flush judge, window vs
# global merge, gather vs one-hot reads) and their choices: every
# variant gives the same trace and the port has one kernel per phase,
# so the keys are validated and then ignored, but for one case:
# `merge_strategy` picks the rule of the outbox compaction
# (`outbox_compact`), whose two rules keep different rows where a row
# overflows: `global` the reference's global merge's (the earliest
# times), `auto` and `window` its window merge's (the smallest
# destinations), as the reference resolves `auto` off the TPU
LAYOUT_VARIANTS = {
    "judge_placement": ("auto", "flush", "step"),
    "merge_strategy": ("auto", "global", "window"),
    "pop_strategy": ("auto", "onehot", "gather"),
    "table_strategy": ("auto", "onehot", "gather"),
}


def _keyword_or_path(name: str, value, keywords: tuple,
                     path_hint: str) -> str:
    """The reference's keyword-or-record-path check (schema.py:62-98,
    cut to `.json` record paths): a keyword passes, anything else must
    be a string ending in `.json`, so that a typo'd keyword fails at
    load and not deep inside the run."""
    kws = " / ".join(repr(k) for k in keywords)
    if not isinstance(value, str):
        raise ValueError(
            f"experimental.{name}: {value!r} is neither {kws} nor "
            f"{path_hint}")
    if value in keywords:
        return value
    if not value.endswith(".json"):
        raise ValueError(
            f"experimental.{name}: {value!r} is neither {kws} nor "
            f"{path_hint}")
    return value


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
    # packet captures: the CPU policies refuse it (core/build.py), the
    # device engine keeps no packets to capture
    pcap_directory: Optional[str] = None
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
            pcap_directory=d.get("pcap_directory"),
            processes=[ProcessOptions.from_dict(p)
                       for p in d.get("processes", [])],
        )


@dataclass
class GeneralOptions:
    stop_time: int = 0                      # sim ns
    seed: int = 1
    bootstrap_end_time: int = 0             # no drops until here
    # the runner's heartbeat cadence (sim ns; 0 = none): the device
    # runner and a campaign cut a segment at every multiple of it and
    # log the heartbeat lines there (device/supervise.py `advance`)
    heartbeat_interval: int = 0
    # where a hybrid failover without checkpoint_save leaves the last
    # validated device state (device/supervise.py `_escalate`)
    data_directory: str = "shadow.data"

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
            heartbeat_interval=parse_time_ns(
                d.get("heartbeat_interval", 0) or 0),
            data_directory=d.get("data_directory", "shadow.data"),
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
    # live rows a host's outbox row keeps for the flush (0 = all): the
    # rest count into x_overflow against the sender; which rows stay
    # follows merge_strategy (K11 compact_outbox)
    outbox_compact: int = 0
    merge_strategy: str = "auto"
    # the hybrid policy: the CPU policy of the host emulation, and the
    # smallest round judged on the card (smaller ones roll on the CPU,
    # with the same verdicts; 0 = every round on the card)
    hybrid_cpu_policy: str = "serial"
    hybrid_judge_min_batch: int = 192
    # the host mesh (device/mesh.py): S ranks, one process each, every
    # rank H_loc = ceil(H/S) hosts; the cross-shard exchange schedule
    # and its per-pair capacities (0 = the reference's auto sizes,
    # device/capacity.py); mesh_axis is only a name
    mesh_shards: int = 0
    mesh_axis: str = "hosts"
    exchange: str = "all_to_all"
    exchange_capacity: int = 0
    exchange_capacity2: int = 0
    # occupancy-driven capacities (device/capacity.py): "static" runs
    # the knobs above; "auto" sizes them from a warm-up slice of
    # `capacity_warmup` (0 = stop_time / 8) on the static engine;
    # any other value is the path of an OCC_*.json record. A planned
    # run that overflows widens the dimension and replays from the last
    # validated segment boundary; traces equal the static run's
    capacity_plan: str = "static"
    capacity_warmup: int = 0
    # the planner's pad factor (0 = capacity.HEADROOM)
    capacity_headroom: float = 0.0
    # the most simulated time a device dispatch covers (0 = the run
    # in one): segment boundaries never change the trace
    dispatch_segment: int = 0
    # warn when a heartbeat gap passes this many times the learned
    # cadence (device/supervise.py HeartbeatMonitor; 0 = off)
    heartbeat_stale_after: int = 0
    # the reference's rounds per device while_loop; read by none of its
    # runners, accepted without effect
    device_batch_rounds: int = 64
    # device-state checkpoints (device/checkpoint.py): checkpoint_save
    # writes the state at checkpoint_save_time (0 = at stop_time) and
    # pauses the run there; checkpoint_load resumes one (a rotation
    # base path resolves to its newest readable entry); every
    # `checkpoint_every` sim ns a supervised run writes the rotation
    # entry <checkpoint_save>.t<ns>, the last `checkpoint_keep` kept
    # (device/supervise.py)
    checkpoint_save: str = ""
    checkpoint_save_time: int = 0
    checkpoint_load: str = ""
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    # transient dispatch errors retried from the last validated state,
    # at most this many CONSECUTIVE times, after a backoff doubling from
    # `dispatch_retry_backoff` seconds (30 s cap); then `failover`:
    # "abort" fails the run, "hybrid" saves the validated state to
    # <checkpoint_save>.failover and reruns on the hybrid policy,
    # "shrink" re-shards it onto a mesh's surviving ranks and goes on
    # (the hybrid rung where nothing died or nothing survives)
    dispatch_retries: int = 0
    dispatch_retry_backoff: float = 0.5
    failover: str = "abort"
    # deterministic fault injection (device/chaos.py): validated
    # ChaosEvents
    chaos: list = field(default_factory=list)
    # reference keys set in the config that the port does not run yet
    later: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentalOptions":
        own = {"interpose_method", "scheduler_policy", "runahead",
               "event_capacity", "outbox_capacity",
               "exchange_in_capacity", "burst_pops", "admission",
               "device_memory_budget", "model_bandwidth", "count_paths",
               "state_audit", "outbox_compact", "hybrid_cpu_policy",
               "hybrid_judge_min_batch", "mesh_shards", "mesh_axis",
               "exchange", "exchange_capacity", "exchange_capacity2",
               "capacity_plan", "capacity_warmup", "capacity_headroom",
               "dispatch_segment", "heartbeat_stale_after",
               "device_batch_rounds", "checkpoint_save",
               "checkpoint_save_time", "checkpoint_load",
               "checkpoint_every", "checkpoint_keep",
               "dispatch_retries", "dispatch_retry_backoff",
               "failover", "chaos"}
        _check_keys("experimental", d,
                    own | set(LAYOUT_VARIANTS) | set(LATER_EXPERIMENTAL))
        out = cls(later={k: v for k, v in d.items()
                         if k in LATER_EXPERIMENTAL})
        for name in own & set(d):
            v = d[name]
            if name == "runahead":
                v = parse_time_ns(v) if v is not None else None
            elif name in ("dispatch_segment", "capacity_warmup",
                          "checkpoint_save_time", "checkpoint_every"):
                v = parse_time_ns(v)
            elif name in ("capacity_headroom", "dispatch_retry_backoff"):
                v = float(v)
            elif name in ("event_capacity", "outbox_capacity",
                          "exchange_in_capacity", "burst_pops",
                          "outbox_compact", "hybrid_judge_min_batch",
                          "mesh_shards", "exchange_capacity",
                          "exchange_capacity2", "heartbeat_stale_after",
                          "device_batch_rounds", "checkpoint_keep",
                          "dispatch_retries"):
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
        out.merge_strategy = d.get("merge_strategy", "auto")
        _check_choice("experimental", "exchange",
                      out.exchange, ("all_gather", "all_to_all",
                                     "two_phase", "auto"))
        if out.mesh_shards and out.scheduler_policy != "tpu":
            raise ValueError(
                "experimental.mesh_shards pins the DEVICE mesh and "
                "requires scheduler_policy: tpu (CPU policies have "
                "no mesh to pin)")
        for name in ("outbox_compact", "hybrid_judge_min_batch",
                     "mesh_shards", "exchange_capacity",
                     "exchange_capacity2", "dispatch_segment"):
            if getattr(out, name) < 0:
                raise ValueError(f"experimental.{name} must be >= 0")
        if out.device_batch_rounds < 1:
            raise ValueError("experimental.device_batch_rounds must be "
                             ">= 1")
        if out.heartbeat_stale_after < 0:
            raise ValueError(
                "experimental.heartbeat_stale_after must be >= 0 "
                "(0 = staleness detection off; k = warn when a "
                "heartbeat gap exceeds k x the expected cadence)")
        if out.capacity_plan != "static" and \
                out.scheduler_policy != "tpu":
            raise ValueError(
                "experimental.capacity_plan: occupancy-driven "
                "capacity planning sizes the DEVICE engine's buffers "
                "and requires scheduler_policy: tpu (CPU policies "
                "have no static capacities to plan)")
        if out.capacity_warmup < 0:
            raise ValueError(
                "experimental.capacity_warmup must be >= 0")
        out.capacity_plan = _keyword_or_path(
            "capacity_plan", out.capacity_plan, ("static", "auto"),
            "a path to a saved OCC_*.json occupancy record")
        if out.capacity_warmup and out.capacity_plan != "auto":
            raise ValueError(
                "experimental.capacity_warmup is set but "
                f"capacity_plan is {out.capacity_plan!r} — the "
                "warm-up slice only runs under capacity_plan: auto, "
                "so the knob would be silently ignored")
        if out.capacity_headroom and out.capacity_headroom < 1.0:
            raise ValueError(
                "experimental.capacity_headroom must be 0 (planner "
                "default) or >= 1.0 — padding below the measured "
                "high-water mark would guarantee overflow re-plans")
        if out.capacity_headroom and out.capacity_plan == "static":
            raise ValueError(
                "experimental.capacity_headroom is set but "
                "capacity_plan is 'static' — the headroom factor "
                "only shapes planned capacities, so the knob would "
                "be silently ignored")
        _check_choice("experimental", "hybrid_cpu_policy",
                      out.hybrid_cpu_policy,
                      [p for p in SCHEDULER_POLICIES
                       if p not in ("tpu", "hybrid")])
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
        _check_supervision(out)
        return out


def _check_supervision(out: "ExperimentalOptions") -> None:
    """The checkpoint, retry, failover and chaos keys, validated as the
    reference validates them (schema.py:748-886), with its messages."""
    if out.checkpoint_save_time and not out.checkpoint_save:
        raise ValueError(
            "experimental.checkpoint_save_time is set but "
            "checkpoint_save (the output path) is not — the "
            "pause time would be silently ignored")
    if (out.checkpoint_save or out.checkpoint_load) and \
            out.scheduler_policy != "tpu":
        raise ValueError(
            "experimental.checkpoint_save/load: device-state "
            "checkpointing requires scheduler_policy: tpu (CPU "
            "policies execute managed OS processes, whose state "
            "is not checkpointable — the reference has the same "
            "limitation, i.e. no checkpoint at all)")
    _check_choice("experimental", "failover", out.failover,
                  ("abort", "shrink", "hybrid"))
    if out.chaos:
        from shadow_tpu_torch.device.chaos import events_from_config

        out.chaos = events_from_config(out.chaos)
        if out.scheduler_policy != "tpu":
            raise ValueError(
                "experimental.chaos injects faults at the DEVICE "
                "supervise/engine seams and requires "
                "scheduler_policy: tpu")
    if out.checkpoint_every:
        if not out.checkpoint_save:
            raise ValueError(
                "experimental.checkpoint_every is set but "
                "checkpoint_save (the rotation base path) is not "
                "— periodic checkpoints would have nowhere to go")
        if out.checkpoint_save_time:
            raise ValueError(
                "experimental.checkpoint_every cannot combine "
                "with checkpoint_save_time: periodic supervision "
                "runs to stop_time writing rotating checkpoints, "
                "while checkpoint_save_time pauses the run at one "
                "boundary — pick one")
    if out.state_audit and out.scheduler_policy != "tpu":
        raise ValueError(
            "experimental.state_audit compiles the invariant "
            "audit into the DEVICE round program and requires "
            "scheduler_policy: tpu")
    if (out.dispatch_retries or out.failover != "abort") and \
            out.scheduler_policy != "tpu":
        raise ValueError(
            "experimental.dispatch_retries/failover supervise "
            "DEVICE dispatches and require scheduler_policy: tpu")
    if out.dispatch_retry_backoff < 0:
        raise ValueError(
            "experimental.dispatch_retry_backoff must be >= 0")
    for name, minimum in (("checkpoint_save_time", 0),
                          ("checkpoint_every", 0),
                          ("checkpoint_keep", 1),
                          ("dispatch_retries", 0)):
        if getattr(out, name) < minimum:
            raise ValueError(
                f"experimental.{name} must be >= {minimum}")


# ensemble vary axes: per-replica values that change array VALUES on
# device (seeds, topology tables, epoch times) — never shapes. Axes
# that would change shapes (host counts, capacities, stop_time) are
# deliberately not offered.
ENSEMBLE_VARY_AXES = ("seed", "latency_scale", "packet_loss_delta",
                      "fault_schedule")
ENSEMBLE_AGGREGATES = ("mean", "p5", "p95", "min", "max")


@dataclass
class EnsembleOptions:
    """`ensemble` section: R independent replicas of the device-twin
    workload in one program (shadow_tpu_torch/ensemble/), varying only
    array values per replica. Replica i is bit-identical to a
    standalone run with replica i's parameters (ensemble/spec.py)."""

    replicas: int = 1
    vary: dict = field(default_factory=dict)
    # named alternative link-fault schedules for vary.fault_schedule
    # (each a list of validated FaultEvents; "base" = the config's
    # network.faults schedule, "none" = fault-free)
    fault_schedules: dict = field(default_factory=dict)
    aggregate: tuple = ENSEMBLE_AGGREGATES
    record_path: str = ""        # "" = artifacts/ENSEMBLE_*.json
    # 0 = all R replicas in one program; k = ceil(R/k) sequential
    # batches of <= k replicas, merged (bit-identical to the full
    # campaign)
    replica_batch: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "EnsembleOptions":
        from shadow_tpu_torch.faults import LINK_KINDS

        _check_keys("ensemble", d, {"replicas", "vary",
                                    "fault_schedules", "aggregate",
                                    "record_path", "replica_batch"})
        if "replicas" not in d:
            raise ValueError("ensemble: missing required key "
                             "'replicas'")
        replicas = int(d["replicas"])
        if replicas < 1:
            raise ValueError("ensemble.replicas must be >= 1")
        raw_vary = d.get("vary") or {}
        if not isinstance(raw_vary, dict):
            raise ValueError("ensemble.vary must be a mapping of "
                             "axis -> per-replica value list")
        _check_keys("ensemble.vary", raw_vary, set(ENSEMBLE_VARY_AXES))
        if replicas > 1 and not raw_vary:
            raise ValueError(
                "ensemble: replicas > 1 with an empty vary block "
                "would run identical replicas — declare at least one "
                f"vary axis ({list(ENSEMBLE_VARY_AXES)})")
        vary: dict = {}
        for axis, vals in raw_vary.items():
            if not isinstance(vals, list) or len(vals) != replicas:
                raise ValueError(
                    f"ensemble.vary.{axis} must list exactly one "
                    f"value per replica ({replicas})")
            if axis == "seed":
                vary[axis] = [int(v) for v in vals]
            elif axis == "latency_scale":
                vary[axis] = [float(v) for v in vals]
                if any(v <= 0 for v in vary[axis]):
                    raise ValueError(
                        "ensemble.vary.latency_scale values must be "
                        "> 0")
            elif axis == "packet_loss_delta":
                vary[axis] = [float(v) for v in vals]
                if any(not (0.0 <= v <= 1.0) for v in vary[axis]):
                    raise ValueError(
                        "ensemble.vary.packet_loss_delta values must "
                        "be in [0, 1]")
            else:                        # fault_schedule
                vary[axis] = [str(v) for v in vals]
        raw_scheds = d.get("fault_schedules") or {}
        if not isinstance(raw_scheds, dict):
            raise ValueError("ensemble.fault_schedules must be a "
                             "mapping of name -> fault event list")
        schedules: dict = {}
        for name, evs in raw_scheds.items():
            if name in ("base", "none"):
                raise ValueError(
                    f"ensemble.fault_schedules: {name!r} is reserved "
                    "('base' = network.faults, 'none' = fault-free)")
            if not isinstance(evs, list):
                raise ValueError(
                    f"ensemble.fault_schedules.{name} must be a list "
                    "of fault events")
            events = [_fault_from_dict(i, e) for i, e in enumerate(evs)]
            bad = [e.kind for e in events if e.kind not in LINK_KINDS]
            if bad:
                raise ValueError(
                    f"ensemble.fault_schedules.{name}: {bad} are "
                    "manager-side host faults — ensemble campaigns "
                    "run on the device engine and only vary link "
                    f"faults ({list(LINK_KINDS)})")
            schedules[name] = events
        for name in vary.get("fault_schedule", ()):
            if name not in ("base", "none") and name not in schedules:
                raise ValueError(
                    f"ensemble.vary.fault_schedule names unknown "
                    f"schedule {name!r} (declare it under "
                    "ensemble.fault_schedules, or use 'base'/'none')")
        agg = d.get("aggregate")
        if agg is None:
            aggregate = ENSEMBLE_AGGREGATES
        else:
            if not isinstance(agg, list) or not agg:
                raise ValueError("ensemble.aggregate must be a "
                                 "non-empty list")
            for a in agg:
                _check_choice("ensemble", "aggregate", a,
                              ENSEMBLE_AGGREGATES)
            aggregate = tuple(agg)
        replica_batch = int(d.get("replica_batch", 0) or 0)
        if replica_batch < 0 or replica_batch > replicas:
            raise ValueError(
                f"ensemble.replica_batch must be in [0, replicas="
                f"{replicas}] (0 = full vmap; k = sequential batches "
                "of <= k replicas)")
        return cls(replicas=replicas, vary=vary,
                   fault_schedules=schedules, aggregate=aggregate,
                   record_path=str(d.get("record_path", "") or ""),
                   replica_batch=replica_batch)


@dataclass
class ConfigOptions:
    general: GeneralOptions = field(default_factory=GeneralOptions)
    network: NetworkOptions = field(default_factory=NetworkOptions)
    experimental: ExperimentalOptions = field(
        default_factory=ExperimentalOptions)
    hosts: list[HostOptions] = field(default_factory=list)
    ensemble: Optional[EnsembleOptions] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigOptions":
        _check_keys("config", d, {"general", "network", "experimental",
                                  "hosts", "host_option_defaults",
                                  "host_defaults", "ensemble"})
        hosts = [HostOptions.from_dict(name, hd or {})
                 for name, hd in (d.get("hosts", {}) or {}).items()]
        ensemble = (EnsembleOptions.from_dict(d["ensemble"])
                    if d.get("ensemble") else None)
        out = cls(
            general=GeneralOptions.from_dict(d.get("general", {}) or {}),
            network=NetworkOptions.from_dict(d.get("network", {}) or {}),
            experimental=ExperimentalOptions.from_dict(
                d.get("experimental", {}) or {}),
            hosts=hosts,
            ensemble=ensemble,
        )
        # the reference's campaign rules
        xp = out.experimental
        if ensemble is not None and \
                out.experimental.scheduler_policy != "tpu":
            raise ValueError(
                "ensemble: multi-replica campaigns run as one vmapped "
                "device program and require "
                "experimental.scheduler_policy: tpu (run replicas as "
                "separate processes on CPU policies)")
        if ensemble is not None and xp.failover == "hybrid":
            raise ValueError(
                "ensemble: experimental.failover: hybrid is not "
                "available for campaigns (CPU host emulation cannot "
                "vmap replicas) — use failover: shrink (campaigns "
                "survive device loss on-device; the replica axis "
                "vmaps outside the mesh axis), or let exhausted "
                "retries fail loudly with the last validated "
                "checkpoint on disk")
        if ensemble is not None and ensemble.replica_batch and \
                xp.checkpoint_save_time:
            raise ValueError(
                "ensemble.replica_batch cannot combine with "
                "checkpoint_save_time: every sequential batch replays "
                "the full time range, so there is no single campaign "
                "pause point to save at — use checkpoint_every for "
                "supervised/preemptible batched campaigns")
        if ensemble is not None and ensemble.replica_batch and \
                xp.checkpoint_save and not xp.checkpoint_every:
            raise ValueError(
                "ensemble.replica_batch with checkpoint_save needs "
                "checkpoint_every: a batched campaign never "
                "materializes the full-R stacked state, so the only "
                "checkpoints it can write are the per-batch rotation "
                "entries (<save>.b<k>.t<ns>) the supervised drain "
                "produces — without checkpoint_every the end-of-run "
                "save would be silently skipped")
        if out.experimental.heartbeat_stale_after and \
                not out.general.heartbeat_interval:
            raise ValueError(
                "experimental.heartbeat_stale_after is set but "
                "general.heartbeat_interval is 0 — staleness is "
                "measured on the [supervise-heartbeat] boundaries, "
                "so without a heartbeat cadence the knob would be "
                "silently ignored")
        return out

    def total_hosts(self) -> int:
        return sum(h.quantity for h in self.hosts)
