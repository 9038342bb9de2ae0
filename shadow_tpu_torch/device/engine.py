"""The device simulation engine (the port of the reference package's
device/engine.py, one GPU, PHOLD, tgen and Tor).

The reference runs the whole simulation as one jitted program. Here
each phase of a window is a chain of CUDA kernels (device/kernels.py),
in the order of the reference's `_exchange`:

  pop (K1 pop_phase for PHOLD, K4 pop_tgen for tgen, K6 pop_tor for
    Tor) -> K2 judge_outbox -> [K7 count_paths] -> phase_tally
    -> [K11 compact_outbox] -> K5 route -> K3 merge_heaps

Under the model NIC (`model_bandwidth`) the pop judges its own sends,
as the reference's in-step path does, and K2 does not run; K7 runs
under `count_paths`. Under a link-fault schedule every table carries a
leading [T] epoch axis and `epoch_times` [T]; each lookup takes the
epoch of its time. Under `outbox_compact` (0 < CX < OB) K11 keeps at
most CX exchangeable rows of each sender's row before the route, by the
rule `merge_global` picks, and counts the rest into x_overflow.

A window [nxt, win_end) with win_end = min(nxt + lookahead, final_stop)
runs phases while some host's head event lies below win_end; the
window's next start is the minimum head time across hosts (after a
merge every host's head is slot 0, so the two reads of the reference,
`more()` on ht[:,0] and `next_time` on the head element, are one
value). The run pauses once that minimum reaches `stop` (final_stop
defaults to it; a run paused at stop with final_stop past it has the
windows of an unpaused one), or after max_rounds windows. Under the
state audit (`audit`) K8 audit_round ORs each host's health word at
every window's end (on a mesh its balance summed over the ranks,
`_audit`).

Two loops drive the phases, with the same windows and rounds:

* the Python loop (`run_python`), the plain path: the host reads the
  minimum once per phase, takes K9's decisions itself
  (kernels.control_step) and writes them into the control block with a
  stream-ordered copy. It runs on the CPU, and on the card in timing
  mode (`Kernels(timing=True)`), where each launch is timed;
* the slot schedule (`run_slots`): a slot is a phase, then K9
  loop_control (the minimum and the window decisions, on the device,
  on the control block of kernels.CTL_FIELDS; the phase's tallies
  folded in, `loop_control_tally`, unless under `outbox_compact`), then
  K8 under the audit.
  On the card LOOP_SLOTS slots are captured once into a CUDA graph and
  replayed until the block says done, one host read per replay; every
  kernel of a slot after done returns at once. On the CPU the same
  slots run eagerly on the plain versions. It is the card's loop
  (`run`), and it never falls back to the Python loop: a failed
  capture or replay raises.

An ensemble campaign (`ensemble=`, ensemble/spec.py `EnsembleWorlds`;
the reference's `_run_ens_shard`, `init_ensemble_state`,
`ensemble_worlds_device` and `run_ensemble`) runs R replicas in lockstep
through the same loops: the state is the standalone state broadcast over
a leading [R] axis, the world stacks the replicas' tables, epoch times
and seed keys, each replica has its own control block, and every kernel
takes the replica as a grid dimension. A replica whose loop is done
changes no byte while the others run on, as the reference's vmapped
while_loop freezes a finished replica's carry; the loop ends when every
replica is done, and `run` returns the rounds of each.

State is a dict of tensors under the reference's leaf names, so a
state moves between the two engines as numpy arrays
(state_from_numpy / state_to_numpy):

  ht hk hm hv hw [H,E] int64   sorted event heap rows: time,
                               src<<32|seq, kind<<32|size, d0<<32|d1, d2
  head [H] int32               consumed slots < head
  event_seq packet_seq app_seq n_exec n_sent n_drop n_deliv
  overflow x_overflow occ_heap occ_ob occ_in   [H] int32
  app [H,W] int32              the app's state words (PHOLD 1, tgen 7,
                               Tor 6)
  chk [H] int64                trace checksum
  occ_x [1,1], occ_trips [1], occ_phases [1] int32
  tx_free rx_free cd_fa cd_next cd_cnt cd_last cd_drop [H] int64
                               the model NIC (model_bandwidth only)
  path_cnt [1,V*V] int64       sent packets per vertex pair
                               (count_paths only)
  aud [H] int32, aud_t aud_tx [H] int64
                               the health word, the last popped time
                               and the rows each host produced (audit
                               only; aud_tx seeded with the boot and
                               stop rows)

(each with a leading [R] axis in a campaign).

On a mesh of S ranks (`mesh=`, device/mesh.py; the reference's
`mesh=`/`mesh_shards`) an engine holds its rank's H_loc = ceil(H/S)
hosts, global ids from g0 = rank*H_loc on (padded hosts past H hold no
events), its occ_x is [1, S] and occ_trips and occ_phases its own; the
world holds every host's vertex and columns. Each phase's flush
exchanges rows with the other ranks (`_exchange`), every rank runs
every phase (a rank with nothing to pop still joins the exchange, the
reference's collective `go`), and the Python loop's minimum head time
is the mesh's all_reduce MIN (`_axis_min`; a campaign's [R] minima in
one collective); `run` takes the Python loop and `run_slots` refuses. A
campaign runs on a mesh as on one device, each rank holding its H_loc
hosts of every replica (the reference's `_run_ens_shard`), every flush's
collectives carrying all R replicas (`_exchange`).

Entry points run on the card unless the caller passes device="cpu";
without a CUDA device they raise rather than fall back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from shadow_tpu_torch import simtime
from shadow_tpu_torch.core.event import KIND_BOOT, KIND_STOP
from shadow_tpu_torch.device import prng
from shadow_tpu_torch.device.apps import PholdDevice, TgenDevice, TorDevice
from shadow_tpu_torch.device.kernels import (
    CTL,
    HOST_COLUMNS,
    IMAX,
    INF,
    NIC_KEYS,
    OB_FIELDS,
    XCH_FIELDS,
    Kernels,
    MeshParams,
    PhaseParams,
    Rows,
    control_block,
    control_step,
    fill_words,
    head_min_plain,
    merge_flags,
    n_vertices,
    outbox_word,
)
from shadow_tpu_torch.host.model_nic import LAW
from shadow_tpu_torch.topology import hierarchy

STATE_DTYPES = {
    "ht": np.int64, "hk": np.int64, "hm": np.int64, "hv": np.int64,
    "hw": np.int64, "chk": np.int64,
    **dict.fromkeys(
        ("head", "event_seq", "packet_seq", "app_seq", "app", "n_exec",
         "n_sent", "n_drop", "n_deliv", "overflow", "x_overflow",
         "occ_heap", "occ_ob", "occ_in", "occ_x", "occ_trips",
         "occ_phases"), np.int32),
}
# leaves of the optional features, present when the feature is on
OPTIONAL_DTYPES = {**dict.fromkeys((*NIC_KEYS, "path_cnt", "aud_t",
                                    "aud_tx"), np.int64), "aud": np.int32}
# phase slots a captured window loop replays at once
LOOP_SLOTS = 32
# an empty heap slot's fields: the rows init_state leaves empty, and the
# padding of a heap grown for a re-planned engine (capacity.grow_heaps)
HEAP_FILLS = {"ht": INF, "hk": IMAX, "hm": 0, "hv": 0, "hw": 0}


class NoCudaDevice(RuntimeError):
    """A GPU entry point was called where torch finds no CUDA
    device."""


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; no quiet
    fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device: shadow_tpu_torch runs on the GPU by "
            "default; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass
class EngineConfig:
    n_hosts: int
    event_capacity: int = 64
    outbox_capacity: int = 32
    lookahead: int = simtime.SIMTIME_ONE_MILLISECOND
    stop_time: int = simtime.SIMTIME_ONE_SECOND
    bootstrap_end: int = 0
    seed: int = 1
    # arrivals accepted per host per flush; 0 = event_capacity.
    # Overflow is counted and fails the run.
    exchange_in_capacity: int = 0
    # bandwidth + CoDel for raw sends (host/model_nic.py): TX
    # serialization at send, RX serialization and CoDel at delivery
    # through a KIND_PACKET -> KIND_PACKET_READY two-stage pop
    model_bandwidth: bool = False
    # the [V,V] histogram of sent packets, drop-rolled ones included;
    # needs V*V <= 65536
    count_paths: bool = False
    # the state audit's health word (kernels.AUD_*): the pops' clock
    # lane, the aud_tx ledger, K8 at every window's end
    audit: bool = False
    # exchangeable rows a sender's outbox row keeps (0 = all; K11), and
    # which: the earliest times (the reference's global merge) or the
    # smallest destinations (its window merge)
    outbox_compact: int = 0
    merge_global: bool = False
    # the host mesh's exchange schedule (all_to_all, two_phase,
    # all_gather; auto = all_to_all, as the reference builds an engine
    # before a record resolves it: the runner's planner passes the
    # schedule it chose) and its per-pair capacities (0 = auto,
    # device/capacity.py exchange_caps)
    exchange: str = "all_to_all"
    exchange_capacity: int = 0
    exchange_capacity2: int = 0
    max_rounds: int = 1 << 62    # safety valve


def state_from_numpy(arrays: dict, device) -> dict:
    """A state dict of numpy arrays (e.g. the reference engine's
    init_state output) -> tensors on `device`, with the port's
    dtypes: every leaf of STATE_DTYPES, and the NIC, path_cnt and
    audit leaves where `arrays` has them."""
    dev = torch.device(device)
    dtypes = {**STATE_DTYPES, **{k: v for k, v in OPTIONAL_DTYPES.items()
                                 if k in arrays}}
    return {k: torch.from_numpy(np.ascontiguousarray(
                np.asarray(arrays[k]).astype(dt))).to(dev)
            for k, dt in dtypes.items()}


def state_to_numpy(state: dict, keys=None) -> dict:
    return {k: state[k].cpu().numpy() for k in (keys or state)}


def phase_params(config: EngineConfig,
                 app: Union[PholdDevice, TgenDevice, TorDevice]
                 ) -> PhaseParams:
    """The static shape of a phase: the outbox layout gives an
    iteration M_out = K_eff + T columns (+ 1 READY column under the
    model NIC), a burst host answering event j on lane j. The model
    NIC pops one event at a time (its buckets are sequential per
    event): P = 1 there, whatever the app's burst width."""
    if config.event_capacity < 2:
        raise ValueError("event_capacity must be >= 2 (boot+stop)")
    MB = bool(config.model_bandwidth)
    P = 1 if MB else max(1, app.burst_pops)
    if P > 1 and app.max_sends != 1:
        raise ValueError("burst_pops requires max_sends == 1")
    K = P if P > 1 else app.max_sends
    T = app.max_timers
    B = max(1, config.outbox_capacity // (K + T + (1 if MB else 0)))
    OB = B * (K + T + (1 if MB else 0))
    return PhaseParams(
        E=config.event_capacity, K=K, T=T, P=P, B=B,
        CX=min(config.outbox_compact or OB, OB),
        CXG=bool(config.merge_global),
        IN=config.exchange_in_capacity or config.event_capacity,
        C=max(1, app.max_train), boot_end=int(config.bootstrap_end),
        seed=prng.seed_key(config.seed), app=app, MB=MB,
        CP=bool(config.count_paths), AUD=bool(config.audit))


def world_arrays(n_hosts: int,
                 app: Union[PholdDevice, TgenDevice, TorDevice, None],
                 host_vertex: np.ndarray, latency_ns, reliability,
                 epoch_times=None, bw_up_bits=None, bw_down_bits=None,
                 model_bandwidth: bool = False,
                 count_paths: bool = False, seed_key=None) -> dict:
    """The world's arrays as the card holds them:

    * the [H] host vertices;
    * the path tables: dense [V,V], or the factored (cluster, cl,
      access, self) leaves of hierarchy.world_tables; under a fault
      schedule [T,V,V], or every leaf but cl with a leading [T] axis
      (every epoch has the same cl, which is uploaded once, [V], and
      shared by both tables);
    * `epoch_times` [T] int64 (one epoch: [0]);
    * under the model NIC the [H] int64 bandwidths (at least 1 bit/s;
      1 Gbit/s where not given) and the CoDel law table [1024] int64;
    * the app's columns (none for app None: the hybrid policy's judge);
    * where given, the run's seed key pair as [1, 2] int64.

    Latency leaves and cl are int32, reliability leaves float32, as the
    reference casts them; every composed latency must fit int32."""
    H = n_hosts
    hier = isinstance(latency_ns, tuple)
    if hier:
        lat = tuple(np.asarray(a) for a in latency_ns)
        rel = tuple(np.asarray(a) for a in reliability)
        T = lat[0].shape[0] if lat[0].ndim == 3 else 1
    else:
        lat = np.asarray(latency_ns)
        rel = np.asarray(reliability)
        T = lat.shape[0] if lat.ndim == 3 else 1
    ept = (np.zeros(T, np.int64) if epoch_times is None
           else np.asarray(epoch_times, np.int64))
    if ept.shape != (T,):
        raise ValueError(f"epoch_times has {ept.size} entries but the "
                         f"latency table has {T} epochs")
    stacked = (lat[0].ndim == 3) if hier else (lat.ndim == 3)
    if stacked and T == 1:
        # one epoch: the tables without their epoch axis
        lat = tuple(a[0] for a in lat) if hier else lat[0]
        rel = tuple(a[0] for a in rel) if hier else rel[0]
    epochs = T > 1
    if hier:
        per_epoch = ([tuple(a[e] for a in lat) for e in range(T)]
                     if epochs else [lat])
        over = max(hierarchy.max_composed_latency(parts)
                   for parts in per_epoch)
    else:
        over = int(lat.max())
    if over > np.iinfo(np.int32).max:
        raise ValueError("path latencies above ~2.1 s don't fit the "
                         "i32 device latency matrix")
    if hier:
        cl = lat[1]
        if epochs:
            if not ((cl == cl[0]).all() and (rel[1] == cl[0]).all()):
                raise ValueError("factored epochs must share one cl "
                                 "vector")
            cl = cl[0]
        cl = np.ascontiguousarray(cl, np.int32)
        lat = tuple(cl if i == 1 else np.asarray(a).astype(np.int32)
                    for i, a in enumerate(lat))
        rel = tuple(cl if i == 1 else np.asarray(a).astype(np.float32)
                    for i, a in enumerate(rel))
        V = cl.shape[0]
    else:
        lat = lat.astype(np.int32)
        rel = rel.astype(np.float32)
        V = lat.shape[-1]
    if count_paths and V * V > 65536:
        raise ValueError(
            "count_paths needs V*V <= 65536 (histogram boundaries "
            f"scale with V^2; this graph has V={V})")
    out = {"host_vertex": np.asarray(host_vertex)[:H].astype(np.int32),
           "lat": lat, "rel": rel, "epoch_times": ept}
    if model_bandwidth:
        for key, bw in (("bw_up", bw_up_bits), ("bw_down", bw_down_bits)):
            out[key] = (np.full(H, 10**9, np.int64) if bw is None else
                        np.maximum(1, np.asarray(bw, np.int64)[:H]))
        out["law"] = LAW
    # the app's columns: [H] client args (zeros for a mesh's padded
    # hosts), Tor's [R] relay ids
    if app is not None:
        for k, v in app.world_columns().items():
            if k in HOST_COLUMNS and v.shape[0] < H:
                v = np.concatenate([v, np.zeros(H - v.shape[0], v.dtype)])
            out[k] = v
    if seed_key is not None:
        out["seed_key"] = np.asarray([seed_key], np.int64)
    return out


def campaign_world_arrays(n_hosts: int, app, host_vertex: np.ndarray,
                          ensemble, bw_up_bits=None, bw_down_bits=None,
                          model_bandwidth: bool = False,
                          count_paths: bool = False) -> dict:
    """The world of an ensemble campaign (ensemble/spec.py
    `EnsembleWorlds`): each replica's world as `world_arrays` builds a
    standalone run's, its tables and epoch times stacked on a leading
    [R] axis (the factored tables' cl, the same in every replica, kept
    once), with the replicas' [R, 2] seed keys; the other leaves are
    the standalone ones, shared. On a mesh `n_hosts` is H_pad and the
    host columns come padded (core/build.py `pad_hosts`), as a
    standalone rank's."""
    ens = ensemble
    per = []
    for r in range(ens.R):
        part = ((lambda t: tuple(a[r] for a in t))
                if isinstance(ens.latency, tuple) else (lambda t: t[r]))
        per.append(world_arrays(
            n_hosts, app, host_vertex, part(ens.latency),
            part(ens.reliability), ens.epoch_times[r], bw_up_bits,
            bw_down_bits, model_bandwidth, count_paths,
            (int(ens.seed_k1[r]), int(ens.seed_k2[r]))))
    out = dict(per[0])
    if isinstance(out["lat"], tuple):
        cl = out["lat"][1]
        if any(not np.array_equal(w["lat"][1], cl) for w in per):
            raise ValueError("a campaign's factored tables must share "
                             "one cl vector")
        for key in ("lat", "rel"):
            out[key] = tuple(cl if i == 1 else
                             np.stack([w[key][i] for w in per])
                             for i in range(4))
    else:
        for key in ("lat", "rel"):
            out[key] = np.stack([w[key] for w in per])
    out["epoch_times"] = np.stack([w["epoch_times"] for w in per])
    out["seed_key"] = np.concatenate([w["seed_key"] for w in per])
    return out


def upload_world(arrays: dict, device) -> dict:
    """`world_arrays`' leaves as tensors on `device`; a leaf shared by
    both tables (cl) is uploaded once."""
    uploaded = {}

    def put(a):
        if id(a) not in uploaded:
            uploaded[id(a)] = torch.tensor(a, device=device)
        return uploaded[id(a)]

    return {k: tuple(put(a) for a in v) if isinstance(v, tuple)
            else put(v) for k, v in arrays.items()}


def make_mesh_params(config: EngineConfig, params: PhaseParams, S: int,
                     shard: int) -> MeshParams:
    """Rank `shard`'s MeshParams on a mesh of S ranks: H_loc =
    ceil(H/S), the schedule (`auto` is all_to_all, as the reference's
    runner builds it before a record exists: the warm-up slice, static
    plans; device/runner.py resolves `auto` from a record through
    capacity.choose_exchange) and its capacities."""
    from shadow_tpu_torch.core.build import mesh_layout
    from shadow_tpu_torch.device.capacity import exchange_caps

    _, h_loc = mesh_layout(config.n_hosts, S)
    exchange = "all_to_all" if config.exchange == "auto" else \
        config.exchange
    cap, cap2, g, ng = exchange_caps(
        exchange, S, h_loc, params.OB, params.E, config.exchange_capacity,
        config.exchange_capacity2)
    return MeshParams(S, shard, h_loc, exchange, cap, cap2, g, ng,
                      bool(config.merge_global))


class DeviceEngine:
    """`latency_ns`/`reliability`/`epoch_times` are what
    hierarchy.world_tables gives: dense arrays or the factored part
    tuples, with a leading [T] epoch axis under a fault schedule;
    `bw_up_bits`/`bw_down_bits` are the hosts' model-NIC bandwidths.
    With `ensemble` (ensemble/spec.py `EnsembleWorlds`) the engine runs
    the campaign's R replicas, whose tables, epoch times and seeds it
    takes from there (the three table arguments are then unused)."""

    def __init__(self, config: EngineConfig,
                 app: Union[PholdDevice, TgenDevice, TorDevice],
                 host_vertex: np.ndarray, latency_ns, reliability,
                 device="cuda", kernels: Optional[Kernels] = None,
                 epoch_times=None, bw_up_bits=None, bw_down_bits=None,
                 ensemble=None, mesh=None):
        self.config = config
        self.app = app
        self.device = resolve_device(device)
        self.kernels = kernels if kernels is not None else Kernels()
        self.params = phase_params(config, app)
        # R of a campaign; None for a standalone run
        self.replicas: Optional[int] = (None if ensemble is None
                                        else int(ensemble.R))
        # this rank's device/mesh.py Mesh and place on it (MeshParams);
        # None on one device
        self.mesh = mesh
        self.mesh_params: Optional[MeshParams] = None
        # the world as the reference engine is given it, which a
        # checkpoint's fingerprint hashes (device/checkpoint.py): the
        # hosts' vertices and bandwidths before a mesh pads them, the
        # tables as given (a campaign's replica 0)
        if ensemble is None:
            tables = (latency_ns, reliability, epoch_times)
        else:
            def first(t):
                return (tuple(np.asarray(p[0]) for p in t)
                        if isinstance(t, tuple) else np.asarray(t[0]))
            tables = (first(ensemble.latency), first(ensemble.reliability),
                      np.asarray(ensemble.epoch_times[0]))
        self.reference_world = (host_vertex, *tables, bw_up_bits,
                                bw_down_bits)
        n_world = config.n_hosts
        if mesh is not None:
            from shadow_tpu_torch.core.build import pad_hosts

            mp = make_mesh_params(config, self.params, mesh.size, mesh.rank)
            self.mesh_params, n_world = mp, mp.H_pad
            # the global merge compacts by its own rule where it merges
            # one block of rows (one shard, all_gather), and by the
            # window rule after the pack (engine.py:1880-1930)
            self.params = dataclasses.replace(
                self.params, g0=mp.g0, CXG=self.params.CXG and (
                    mp.S == 1 or mp.exchange == "all_gather"))
            host_vertex, bw_up_bits, bw_down_bits = pad_hosts(
                n_world, host_vertex, bw_up_bits, bw_down_bits)
        if ensemble is None:
            arrays = world_arrays(n_world, app, host_vertex,
                                  latency_ns, reliability, epoch_times,
                                  bw_up_bits, bw_down_bits,
                                  config.model_bandwidth,
                                  config.count_paths, self.params.seed)
        else:
            arrays = campaign_world_arrays(
                n_world, app, host_vertex, ensemble, bw_up_bits,
                bw_down_bits, config.model_bandwidth, config.count_paths)
        self.n_vertices = n_vertices(arrays)
        self.world = upload_world(arrays, self.device)
        self._buf = None
        # the preflight admission verdict, where a runner made one
        self.admission: Optional[dict] = None
        # the last run's loop: which, its phases, rounds (each a list
        # over the replicas in a campaign) and host syncs
        self.loop_stats: dict = {}
        self._window_ctl: Optional[torch.Tensor] = None
        # the captured window loop, kept across runs (`run_slots`): its
        # control block, graph, the launches it records and the state
        # and slots it was captured on; `captures` counts the captures
        self._loop: Optional[dict] = None
        self.captures = 0
        self._staging: Optional[torch.Tensor] = None
        self._xbuf: Optional[dict] = None
        # a mesh audit's sums of the ranks' balances (`_audit`): how
        # many, and their share of the mesh's `collective_s`
        self.audit_sums = 0
        self.audit_sum_s = 0.0
        # the flushes this rank exchanged (`_exchange`), which the
        # mesh's collectives a flush are counted against
        self.mesh_flushes = 0
        # K3's fresh words (kernels.merge_flags), on the card
        self._fresh: Optional[torch.Tensor] = None
        # the outbox words (kernels.outbox_word): set here and by `_arm`,
        # cleared by the pop. The pop clears only the rows of hosts that
        # popped in the last phase, which rests on the buffer's writers:
        # the pop itself, K2 and K11 (live rows of hosts that popped),
        # and rows copied in from outside, which `_arm` marks
        self._outside = outbox_word(self.device, self.replicas or 1)

    @property
    def effective(self) -> dict:
        """The capacities this engine runs, under the reference's keys
        (engine.py:1236), for the occupancy record and the planner's
        widening: E, B, OB, IN, CX, M_out; on a mesh CAP and CAP2, the
        schedule, its groups and the rows and bytes a rank sends a
        flush (buffers at capacity); one device sends none."""
        p, mp = self.params, self.mesh_params
        if mp is None or mp.S <= 1:
            S, cap, cap2, rows, width = 1, 0, 0, 0, 0
            exchange = ("all_to_all" if self.config.exchange == "auto"
                        else self.config.exchange)
            groups = [1, 1]
        else:
            S, cap, cap2, exchange = mp.S, mp.CAP, mp.CAP2, mp.exchange
            groups = [mp.G, mp.NG]
            if exchange == "all_to_all":
                rows, width = (S - 1) * cap, mp.channels
            elif exchange == "two_phase":
                rows = (mp.G - 1) * cap + (mp.NG - 1) * cap2
                width = len(XCH_FIELDS)
            else:
                rows, width = (S - 1) * mp.H_loc * p.OB, len(OB_FIELDS)
        return {"E": p.E, "B": p.B, "OB": p.OB, "IN": p.IN,
                "CAP": int(cap), "CAP2": int(cap2), "CX": p.CX,
                "M_out": p.M_out, "n_shards": S, "exchange": exchange,
                "tp_groups": groups, "ICI_rows_per_flush": int(rows),
                "ICI_bytes_per_flush": int(rows) * width * 8}

    def device_memory_stats(self) -> Optional[tuple[int, int]]:
        """(bytes in use, bytes the card holds) on the card, from the
        caching allocator and `torch.cuda.mem_get_info`; None on the CPU
        (the heartbeat lines print `n/a` then)."""
        if self.device.type != "cuda":
            return None
        _, total = torch.cuda.mem_get_info(self.device)
        return int(torch.cuda.memory_allocated(self.device)), int(total)

    @property
    def n_shards(self) -> int:
        """The mesh's ranks (1 on one device)."""
        return 1 if self.mesh_params is None else self.mesh_params.S

    @property
    def H_pad(self) -> int:
        """The hosts padded to a multiple of the ranks."""
        return (self.config.n_hosts if self.mesh_params is None
                else self.mesh_params.H_pad)

    @property
    def H_loc(self) -> int:
        """The hosts a rank holds."""
        return self.n_local

    @property
    def n_local(self) -> int:
        """The hosts this engine holds: all, or a mesh rank's H_loc."""
        return (self.config.n_hosts if self.mesh_params is None
                else self.mesh_params.H_loc)

    # ------------------------------------------------------------------
    def init_state(self, start_times: np.ndarray,
                   stop_times: np.ndarray) -> dict:
        """Per host: a boot event at start_times[h] and, where
        stop_times[h] >= 0, a stop event; heaps sorted by
        construction (boot seq 0 precedes stop seq 1). A standalone
        state; a campaign starts from `init_ensemble_state`."""
        return state_from_numpy(self._init_arrays(start_times,
                                                  stop_times), self.device)

    def init_ensemble_state(self, start_times: np.ndarray,
                            stop_times: np.ndarray) -> dict:
        """The [R, ...] state of a campaign: every replica starts from
        the standalone state (the vary axes change values, never the
        start layout)."""
        if self.replicas is None:
            raise ValueError("engine was built without ensemble worlds")
        return state_from_numpy(self.init_arrays(start_times, stop_times),
                                self.device)

    def init_arrays(self, start_times: np.ndarray,
                    stop_times: np.ndarray) -> dict:
        """The engine's initial state as numpy arrays (a campaign's with
        its [R] axis): the leaves, shapes and dtypes a state placed
        onto this engine must have (capacity.transfer)."""
        arrays = self._init_arrays(start_times, stop_times)
        if self.replicas is None:
            return arrays
        R = self.replicas
        return {k: np.broadcast_to(v, (R, *v.shape))
                for k, v in arrays.items()}

    def _init_arrays(self, start_times, stop_times) -> dict:
        """`init_state`'s leaves as numpy arrays; on a mesh this rank's
        rows of the H_pad hosts, whose padded hosts have no boot."""
        H, E = self.config.n_hosts, self.params.E
        t0 = np.asarray(start_times, dtype=np.int64)
        t1 = np.asarray(stop_times, dtype=np.int64)
        if t0.shape != (H,) or t1.shape != (H,):
            raise ValueError(f"need {H} start and stop times")
        has_stop = t1 >= 0
        if (has_stop & (t1 < t0)).any():
            h = int(np.flatnonzero(has_stop & (t1 < t0))[0])
            raise ValueError(f"host {h}: stop_time {int(t1[h])} precedes "
                             f"start_time {int(t0[h])}")
        mp = self.mesh_params
        S = 1 if mp is None else mp.S
        if mp is not None:
            pad = mp.H_pad - H
            t0 = np.concatenate([t0, np.full(pad, INF, np.int64)])
            has_stop = np.concatenate([has_stop, np.zeros(pad, bool)])
            t1 = np.concatenate([t1, np.full(pad, -1, np.int64)])
        # the global ids of this engine's hosts
        hid = np.arange(self.params.g0, self.params.g0 + self.n_local,
                        dtype=np.int64)
        rows = slice(int(hid[0]), int(hid[0]) + len(hid)) if len(hid) \
            else slice(0, 0)
        t0, t1, has_stop = t0[rows], t1[rows], has_stop[rows]
        H = len(hid)
        boots = t0 < INF
        ht, hk, hm, hv, hw = (np.full((H, E), HEAP_FILLS[k], np.int64)
                              for k in ("ht", "hk", "hm", "hv", "hw"))
        ht[:, 0] = t0
        hk[:, 0] = np.where(boots, hid << 32, IMAX)
        hm[:, 0] = np.where(boots, np.int64(KIND_BOOT) << 32, 0)
        ht[:, 1] = np.where(has_stop, t1, INF)
        hk[:, 1] = np.where(has_stop, (hid << 32) | 1, IMAX)
        hm[:, 1] = np.where(has_stop, np.int64(KIND_STOP) << 32, 0)
        zeros = np.zeros(H, dtype=np.int32)
        app = self.app.init_state(self.params.g0 + H)[self.params.g0:]
        arrays = {
            "ht": ht, "hk": hk, "hm": hm, "hv": hv, "hw": hw,
            "event_seq": np.where(has_stop, 2, boots.astype(np.int32))
            .astype(np.int32),
            "app": np.ascontiguousarray(app),
            "chk": np.zeros(H, np.int64),
            "occ_x": np.zeros((1, S), np.int32),
            "occ_trips": np.zeros(1, np.int32),
            "occ_phases": np.zeros(1, np.int32),
        }
        for k in STATE_DTYPES:
            arrays.setdefault(k, zeros)
        if self.config.model_bandwidth:
            for k in NIC_KEYS:
                arrays[k] = np.zeros(H, np.int64)
        if self.config.count_paths:
            arrays["path_cnt"] = np.zeros((1, self.n_vertices ** 2),
                                          np.int64)
        if self.config.audit:
            # the ledger starts with the rows init wrote: a boot per
            # host, a stop where stop_times >= 0 (the reference's
            # t0s != INF and t1s != INF)
            arrays["aud"] = zeros
            arrays["aud_t"] = np.zeros(H, np.int64)
            arrays["aud_tx"] = ((t0 < INF).astype(np.int64)
                                + has_stop.astype(np.int64))
        return arrays

    # ------------------------------------------------------------------
    def _outbox(self) -> tuple[dict, torch.Tensor]:
        """The phase's outbox [H,OB] x 5 and pop counts [H]: allocated
        once per engine (a captured window loop holds their addresses);
        the pop rewrites the rows that may hold something (its outbox
        words, `_arm`)."""
        return self._buffers()[:2]

    def _buffers(self) -> tuple[dict, torch.Tensor, tuple]:
        """The outbox, the pop counts and the route's outputs (perm
        [H*OB], starts [H], counts [H]; each with the leading [R] axis
        in a campaign), allocated once per engine."""
        if self._buf is None:
            H, OB = self.n_local, self.params.OB
            # the route's destinations: a mesh's H_pad hosts
            D = H if self.mesh_params is None else self.mesh_params.H_pad
            lead = () if self.replicas is None else (self.replicas,)
            dev = self.device
            # the five fields as views of one [5, (R,) H, OB] block,
            # which all_gather ships whole
            block = torch.empty((len(OB_FIELDS), *lead, H, OB),
                                dtype=torch.int64, device=dev)
            ob = dict(zip(OB_FIELDS, block.unbind(0)))
            pops = torch.empty((*lead, H), dtype=torch.int32, device=dev)
            route = tuple(torch.empty((*lead, n), dtype=torch.int64,
                                      device=dev) for n in (H * OB, D, D))
            self._buf = (ob, pops, route, block)
        return self._buf[:3]

    def _arm(self) -> None:
        """A state enters the engine from outside (a run, a resume, an
        edited state, a flush of rows copied into the outbox): the next
        pop clears every outbox row and the judge before it judges every
        host (the outbox words, kernels.outbox_word: the pop counts in
        the buffer need not be this state's), and the next merge on the
        card checks every heap's order before it trusts the merges' own
        (csrc/merge_heaps.cu). Stream-ordered fills: no host sync."""
        self._outside[0].fill_(1)
        if self.device.type != "cuda":
            return
        if self._fresh is None:
            self._fresh = merge_flags(self.device, self.replicas or 1)
        self._fresh[0].fill_(1)

    def phase(self, state: dict, win_end) -> None:
        """One phase of a state from outside the engine: `_arm`, then
        `_phase`."""
        self._arm()
        self._phase(state, win_end)

    def _phase(self, state: dict, win_end, tally: bool = True) -> None:
        """One phase: pops (K1, K4 or K6), then the flush: judge (K2,
        not under the model NIC, whose pops judge), path counters (K7,
        under count_paths), the tallies, the compaction (K11, under
        outbox_compact), route (K5), merge (K3). Updates
        `state` in place. `win_end` is an int, or the loop's control
        block, whose window end every kernel reads and whose `run` word
        makes the phase a no-op where it is 0. The loops run a phase
        only when some host's head time lies below the window end, so
        every phase pops and flushes (the reference skips the flush of
        a phase that popped nothing, which cannot happen here). Without
        `tally` the flush leaves the tallies to the K9 step after it
        (`_fold`)."""
        ob, pops, _ = self._buffers()
        self.kernels.pop(state, ob, pops, self.world, win_end, self.params,
                         self._outside)
        self._flush(state, win_end, tally)

    def flush(self, state: dict, win_end) -> None:
        """The flush of the outbox the last pop wrote (the engine's own
        buffers; `phase` without the pop, the reference's
        `_flush_phase`), of a state from outside the engine."""
        self._arm()
        self._flush(state, win_end)

    def _flush(self, state: dict, win_end, tally: bool = True) -> None:
        p, k = self.params, self.kernels
        ctl = win_end if isinstance(win_end, torch.Tensor) else None
        ob, pops, route = self._buffers()
        if not p.MB:
            k.judge_outbox(state, ob, self.world, win_end, p, pops,
                           self._outside)
        if p.CP:
            k.count_paths(state, ob, self.world, ctl, pops, self._outside)
        if tally:
            k.phase_tally(state, ob, pops, p, ctl, self._outside)
        if p.compacts:
            k.compact_outbox(state, ob, p, ctl, pops, self._outside)
        if self.mesh_params is None:
            perm, starts, counts = k.route(ob, route, ctl)
            k.merge_heaps(state, ob, perm, starts, counts, p, ctl,
                          fresh=self._fresh)
        else:
            self._exchange(state, ob, route, ctl)

    def _wire(self, name: str, shape: tuple,
              dtype=torch.int64) -> torch.Tensor:
        """An exchange buffer of this engine, allocated once."""
        if self._xbuf is None:
            self._xbuf = {}
        if name not in self._xbuf:
            self._xbuf[name] = torch.empty(shape, dtype=dtype,
                                           device=self.device)
        return self._xbuf[name]

    def _fills(self, name: str, send: torch.Tensor) -> torch.Tensor:
        """The fill words of the kept send buffer `name` (K13 its only
        writer), allocated with it (kernels.fill_words)."""
        key = name + "_filled"
        if key not in self._xbuf:
            self._xbuf[key] = fill_words(send)
        return self._xbuf[key]

    def _exchange(self, state: dict, ob: dict, route: tuple,
                  ctl) -> None:
        """The flush of a mesh rank after the judge and the compaction
        (the reference's `_exchange`/`_exchange_global` with S > 1,
        engine.py:1880-2061): K5 routes the outbox over the H_pad
        destinations; this rank's own segment of that route is the
        self-shard arrival block, which never moves. all_to_all: K12
        packs every other shard's first CAP rows into [S, C, CAP], one
        all_to_all moves them. two_phase: K13 packs the phase-1 buffers
        [g, 6, CAP] by destination rank, one exchange within the group,
        a keyed K5 route of the arrivals over H_pad, K13 packs the
        phase-2 buffers [ng-1, 6, CAP2] by destination group (and
        histograms the rows lost there by global source, which the mesh
        sums into each sender's x_overflow), one exchange across groups;
        K13's send buffers are kept from phase to phase with their fill
        words (`_fills`: K13 is their only writer and rewrites only the
        slots that change). K5 then windows the received rows to this
        rank's hosts, by key after two_phase (its arrivals come in peer
        order; after all_to_all a row's buffer position already is the
        order of its key), and K3 merges [heap | received | self].
        all_gather: the
        outbox of every rank, gathered, K5 windows it to this rank's
        hosts in position order, which is the reference's (key, index)
        order, and K3 merges one block.

        A campaign (the reference's `_run_ens_shard`, which vmaps this
        program over the replicas inside the shard_map) ships every
        replica in the same collectives: the buffers carry the replica
        inside each peer's block ([S, R, C, CAP], [g, R, 6, CAP], [ng-1,
        R, 6, CAP2]; all_gather's [S, 5, R, H, OB] outboxes), so a flush
        makes the collectives of a standalone rank whatever R; every
        kernel reads replica r's rows through its strides, a replica
        whose control block does not run the phase packs, routes and
        merges nothing (its slots go along unread), and the phase-2
        loss is summed per replica ([R, H_pad])."""
        mp, k, p, mesh = self.mesh_params, self.kernels, self.params, \
            self.mesh
        H, OB, lo = mp.H_loc, p.OB, mp.g0
        self.mesh_flushes += 1
        lead = () if self.replicas is None else (self.replicas,)
        if mp.exchange == "all_gather":
            block = self._buf[3]    # the outbox's [5, (R,) H, OB] block
            got = self._wire("gathered", (mp.S, *block.shape))
            mesh.all_gather(got, block)
            flat = got.view(mp.S, len(OB_FIELDS), *lead, H * OB)
            rows = Rows(flat.transpose(1, 2) if lead else flat)
            arr = k.route_rows(rows, lo, H, False, ctl=ctl)
            k.merge_heaps(state, rows, *arr, p, ctl, fresh=self._fresh)
            return
        perm, starts, counts = k.route_rows(Rows(ob), 0, mp.H_pad, False,
                                            out=route, ctl=ctl)
        own = (ob, perm, starts[..., lo:lo + H], counts[..., lo:lo + H])
        if mp.exchange == "all_to_all":
            send = self._wire("send", (mp.S, *lead, mp.channels, mp.CAP))
            recv = self._wire("recv", send.shape)
            k.pack_remote(state, ob, perm, starts, counts, mp, send, ctl)
            mesh.all_to_all(send, recv)
            rows, keyed = Rows(recv), False
        else:
            g, ng = mp.G, mp.NG
            my_g, my_b = divmod(mp.shard, g)
            send1 = self._wire("send1", (g, *lead, len(XCH_FIELDS), mp.CAP))
            recv1 = self._wire("recv1", send1.shape)
            k.pack_two_phase(state, ob, perm, starts, counts, mp, send1,
                             ctl, self._fills("send1", send1))
            group = [my_g * g + b for b in range(g)]
            mesh.all_to_all(send1, recv1, group, group)
            rows1 = Rows(recv1)
            arr1 = k.route_rows(rows1, 0, mp.H_pad, True, ctl=ctl)
            send2 = self._wire("send2", (ng - 1, *lead, len(XCH_FIELDS),
                                         mp.CAP2))
            recv2 = self._wire("recv2", send2.shape)
            hist = self._wire("lost2", (*lead, mp.H_pad), torch.int32)
            k.pack_two_phase2(rows1, *arr1, mp, OB, send2, hist, ctl,
                              self._fills("send2", send2))
            # phase-2 loss lands on its sender's shard (engine.py:
            # 1820-1838), in its own replica: the mesh's summed
            # histogram, this rank's slice
            if int(mesh.all_sum(hist.sum().view(1))[0]) > 0:
                lost = mesh.all_sum(hist)[..., lo:lo + H]
                state["x_overflow"] += lost.to(self.device,
                                               torch.int32)
            peers = [a * g + my_b for a in range(ng) if a != my_g]
            mesh.all_to_all(send2, recv2, peers, peers)
            rows, keyed = Rows(recv1, recv2), True
        arr = k.route_rows(rows, lo, H, keyed, ctl=ctl)
        k.merge_heaps(state, rows, *arr, p, ctl, second=own,
                      occ_sum=mp.merge_global, fresh=self._fresh)

    def next_time(self, state: dict) -> int:
        """Minimum head-event time across hosts (one host sync), across
        the mesh's ranks on a mesh."""
        return int(self._head_min(state))

    def _head_min(self, state: dict) -> torch.Tensor:
        """head_min_plain, reduced over the mesh where there is one."""
        nt = head_min_plain(state)
        return nt if self.mesh is None else self.mesh.all_min(nt.view(-1))

    def window(self, state: dict, win_end: int, nxt: Optional[int] = None
               ) -> int:
        """Run one conservative window of a standalone state to
        `win_end` from head time `nxt` (computed when not given);
        returns the next window's start."""
        nt = self.next_time(state) if nxt is None else nxt
        self._arm()
        if nt < win_end:
            if self._window_ctl is None:
                self._window_ctl = control_block(self.device, run=1)
            # a stream-ordered fill: no host sync
            self._window_ctl[CTL["win_end"]].fill_(win_end)
        while nt < win_end:
            self._phase(state, self._window_ctl)
            nt = self.next_time(state)
        return nt

    def _stops(self, stop, final_stop) -> tuple[int, int]:
        stop = self.config.stop_time if stop is None else int(stop)
        final = stop if final_stop is None else int(final_stop)
        if final < stop:
            raise ValueError(f"final_stop {final} precedes stop {stop}")
        return stop, final

    def _loop_block(self, stop: int, final: int) -> torch.Tensor:
        """The window loop's control block(s) for a run to `stop` with
        windows clamped to `final`: [CTL_N], or [R, CTL_N] in a
        campaign."""
        return control_block(
            self.device, self.replicas, stop=stop, final_stop=final,
            lookahead=max(1, int(self.config.lookahead)),
            max_rounds=min(int(self.config.max_rounds), (1 << 63) - 1))

    def _loop_result(self, words, loop: str, syncs: int):
        """(rounds, and `loop_stats` set) from the final control words
        [(R,) CTL_N]: ints for a standalone run, the replicas' for a
        campaign (rounds as an [R] int64 array)."""
        words = np.asarray(words, np.int64)
        rounds, phases = words[..., CTL["rounds"]], words[..., CTL["phases"]]
        self.loop_stats = {"loop": loop, "rounds": rounds.tolist(),
                           "phases": phases.tolist(), "host_syncs": syncs}
        return rounds if self.replicas is not None else int(rounds)

    def run(self, state: dict, stop: Optional[int] = None,
            final_stop: Optional[int] = None):
        """Advance to `stop` (default config.stop_time), every window
        end clamped to `final_stop` (default `stop`): pass the
        simulation's end there when pausing earlier, so that the window
        sequence, and the trace, equal an unpaused run's. Returns
        (state, rounds), rounds an [R] array in a campaign, and sets
        `loop_stats`. On the card the captured slot schedule runs, or
        the Python loop in timing mode; on the CPU, and on a mesh of
        ranks (whose minimum is a collective between phases), the
        Python loop."""
        if self.device.type == "cuda" and not self.kernels.timing and \
                self.mesh is None:
            return self.run_slots(state, stop, final_stop)
        return self.run_python(state, stop, final_stop)

    def run_python(self, state: dict, stop: Optional[int] = None,
                   final_stop: Optional[int] = None):
        """The window loop in Python (the plain path): one host read of
        the minimum head time (of every replica) per phase; the host
        takes K9's decisions (kernels.control_step) and writes the
        control block before each phase and each round-end audit."""
        stop, final = self._stops(stop, final_stop)
        ctl = self._loop_block(stop, final)
        words = ctl.cpu().view(-1, len(CTL)).tolist()
        self._arm()

        def step(start):
            mins = self._head_min(state).view(-1).tolist()  # a host sync
            return [control_step(w, None if w[CTL["done"]] else m, start)
                    for w, m in zip(words, mins)]

        words, syncs = step(True), 1
        while True:
            self._write_block(ctl, words)
            if self.config.audit and any(w[CTL["round_end"]]
                                         for w in words):
                self._audit(state, ctl)
            if all(w[CTL["done"]] for w in words):
                break
            self._phase(state, ctl)
            words, syncs = step(False), syncs + 1
        rounds = self._loop_result(words if self.replicas else words[0],
                                   "python", syncs)
        if self.mesh is not None:
            self.loop_stats["mesh"] = mesh_stats(self)
        return state, rounds

    def _audit(self, state: dict, ctl: torch.Tensor) -> None:
        """K8 at a round's end. On one device one launch; on a mesh the
        balance is global (the reference's `_axis_sum64`): the launch
        writes the rank's balance to a word, the mesh sums the word
        (every rank reaches each round end together) and the conserve
        pass ORs AUD_CONSERVE into every host of the rank where the sum
        is not 0."""
        k = self.kernels
        if self.mesh is None:
            k.audit_round(state, ctl)
            return
        balance = self._wire("aud_balance", (self.replicas or 1,))
        k.audit_round(state, ctl, balance=balance)
        c0 = self.mesh.collective_s
        total = self.mesh.all_sum(balance).to(self.device)
        self.audit_sum_s += self.mesh.collective_s - c0
        self.audit_sums += 1
        k.audit_conserve(state, total, ctl)

    def _write_block(self, ctl: torch.Tensor, words: list) -> None:
        """Copy the host's control words into `ctl`, ordered on the
        stream (on the card from a pinned buffer, which the next write
        reuses only after the host has read the phase's minimum)."""
        host = torch.tensor(words, dtype=torch.int64).view(ctl.shape)
        if ctl.is_cuda:
            if self._staging is None:
                self._staging = torch.empty(ctl.shape, dtype=torch.int64,
                                            pin_memory=True)
            self._staging.copy_(host)
            ctl.copy_(self._staging, non_blocking=True)
        else:
            ctl.copy_(host)

    def _fold(self) -> Optional[tuple]:
        """The tallies' inputs (outbox, pop counts, params, outbox words)
        where the slots' K9 takes the phase's tallies
        (`loop_control_tally`, csrc/loop_control.cu), else None: where
        nothing rewrites the outbox between the judge and K9, so not
        under `outbox_compact`, and where the kernels fold
        (`fold_tally`, not `designs_before`). The run's start step takes
        them too (and tallies nothing), so that a run launches one K9."""
        k = self.kernels
        if not k.fold_tally or k.designs_before or self.params.compacts:
            return None
        ob, pops, _ = self._buffers()
        return ob, pops, self.params, self._outside

    def _slots(self, state: dict, ctl: torch.Tensor, n: int) -> None:
        """`n` slots: each a phase under `ctl`, K9 (with the phase's
        tallies where `_fold`) and, under the audit, K8 (which runs
        where K9 ended a round)."""
        k, tally = self.kernels, self._fold()
        for _ in range(n):
            self._phase(state, ctl, tally=tally is None)
            k.loop_control(state, ctl, tally=tally)
            if self.config.audit:
                k.audit_round(state, ctl)

    def run_slots(self, state: dict, stop: Optional[int] = None,
                  final_stop: Optional[int] = None,
                  slots: int = LOOP_SLOTS):
        """The window loop as slots of `slots` phases (see the module
        notes): the first batch runs eagerly (on the card it also loads
        every kernel before the capture), then on the card the batch is
        captured into a CUDA graph and replayed, on the CPU run again,
        until the control block (every replica's) says done; the host
        reads the block once per batch. The engine keeps the graph and
        its control block: a later run on the same state tensors (the
        next segment of a segmented run) rewrites the block's words in
        place, takes the start step and replays the graph from its first
        batch, with no capture. Raises in timing mode: event pairs mean
        nothing inside a graph (the Python loop times)."""
        stop, final = self._stops(stop, final_stop)
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if self.mesh is not None:
            raise RuntimeError(
                "the captured window loop runs on one device: a mesh's "
                "minimum is a collective between phases (gloo cannot be "
                "captured into a CUDA graph; NCCL's capture waits for "
                "ROADMAP.md queue (a) item 9b), so a mesh runs run_python")
        k, cuda = self.kernels, self.device.type == "cuda"
        if cuda and k.timing:
            raise RuntimeError(
                "the captured window loop cannot run in timing mode: "
                "run_python times each launch")
        block = self._loop_block(stop, final)
        key = (slots, tuple(t.data_ptr() for t in state.values()))
        loop = self._loop if cuda else None
        if loop is not None and loop["key"] == key:
            # the graph of an earlier run on this state: its control
            # block takes this run's words, stream-ordered
            ctl = loop["ctl"]
            ctl.copy_(block)
        else:
            ctl, loop = block, None
        self._arm()
        k.loop_control(state, ctl, start=True, tally=self._fold())
        if loop is None:
            # eagerly: on the card this also loads every kernel and
            # allocates their scratch before a capture
            self._slots(state, ctl, slots)
            words = ctl.cpu()
            syncs = 1
        else:
            words, syncs = torch.zeros(1), 0
        # on until every replica is done
        while syncs == 0 or not bool(words[..., CTL["done"]].all()):
            if not cuda:
                self._slots(state, ctl, slots)
            else:
                if loop is None:
                    graph, captured = self._capture(state, ctl, slots)
                    loop = self._loop = {"key": key, "ctl": ctl,
                                         "graph": graph,
                                         "captured": captured}
                loop["graph"].replay()
                k.replayed(loop["captured"])
            words = ctl.cpu()
            syncs += 1
        rounds = self._loop_result(words.numpy(),
                                   "graph" if cuda else "slots", syncs)
        return state, rounds

    def _capture(self, state: dict, ctl: torch.Tensor, slots: int):
        """(graph, launches it records) of `slots` slots captured on the
        card; raises where the capture fails."""
        k = self.kernels
        self._loop = None       # the graph of another state, freed
        graph = torch.cuda.CUDAGraph()
        self.captures += 1
        k.begin_capture()
        try:
            with torch.cuda.graph(graph):
                self._slots(state, ctl, slots)
        finally:
            captured = k.end_capture()
        return graph, captured


def mesh_stats(engine: DeviceEngine) -> dict:
    """A mesh rank's exchange: its place and schedule, the backend, the
    bytes it sent, the host seconds of its staging copies and
    collectives, its flushes and its collectives by kind (`calls`, since
    the mesh's counters were last reset: a run's), and under the audit
    its sums of the ranks' balances and their seconds (a part of
    `collective_s`)."""
    mp, mesh = engine.mesh_params, engine.mesh
    return {"shards": mp.S, "rank": mp.shard, "backend": mesh.backend,
            "exchange": mp.exchange, "cap": mp.CAP, "cap2": mp.CAP2,
            "groups": [mp.G, mp.NG], "moved_bytes": mesh.moved_bytes,
            "stage_s": mesh.stage_s, "collective_s": mesh.collective_s,
            "flushes": engine.mesh_flushes, "calls": dict(mesh.calls),
            "audit_sums": engine.audit_sums,
            "audit_sum_s": engine.audit_sum_s}
