"""The hot-path kernels of the device engine: CUDA kernels written by
hand for Hopper (csrc/), their build and ctypes binding, and beside each
one its plain PyTorch version.

Four steps carry one phase of a conservative window:

* the pop loop (the reference engine's `_step` with the app's
  `handle`), one thread per host, up to B iterations per launch, in
  one templated source (csrc/pop_phase.cu) with the app fused in:
  K1 `pop_phase` for PHOLD (with its app draws), K4 `pop_tgen` for
  tgen (with the servers' burst pops, trains and timers) and K6
  `pop_tor` for Tor (the relays' burst pops and onion routes, trains
  that carry the previous hop's survivors as their live mask). The
  outbox outlives a phase: a warp clears, coalesced, only the rows of
  its hosts that popped in the last phase (every row where the
  engine's outbox word, `outbox_word`, says they came from outside the
  pop), and a host with nothing in the window reads its head time and
  leaves;
* K2 `judge_outbox` (csrc/judge_outbox.cu): `_judge_outbox` with the
  table lookup and `packet_drop_mask`, a warp a host row (a warp
  suffix sum gives each row its packet-seq base), only for the hosts
  that popped unless the outbox word is set;
* K5 `route` (csrc/route.cu): `_flat_sorted`/`_host_windows`, the
  exchangeable rows grouped by destination in (src, column) order, by
  an order-keeping compaction and a stable LSD radix sort over the
  destination's bytes, then the segment bounds;
* K3 `merge_heaps` (csrc/merge_heaps.cu): `_merge_rows` on the window
  path, a scan listing the hosts that change (head != 0 or arrivals)
  and a warp a listed host merging its sorted tail with its ranked
  arrivals.

Under `count_paths` K7 (csrc/count_paths.cu) adds the judged packet
rows to the path counters, summed by pair a warp: on a large outbox
only the rows of the hosts that popped (every row under the word), a
warp's popped hosts' rows as flat items; on one that sits in L2, a
thread a row.

Between the judge and the route `phase_tally` (csrc/phase_tally.cu)
takes the phase's occupancy marks and, under the state audit, the
conservation ledger `aud_tx`, reading the rows of the hosts that
popped (every host's under the outbox word, as K2 does); under
`outbox_compact` K11 `compact_outbox` (csrc/compact_outbox.cu) then
keeps at most CX exchangeable rows of each sender's row, by the window
rule or, under `merge_strategy: global`, the global rule
(`compact_outbox_global`), reading the rows of the hosts that popped
(every row under the word) and ranking an overflowing row from its
lanes' registers.
The window loop on the card adds two: K9 `loop_control`
(csrc/loop_control.cu), the control step after each phase (the minimum
head time, the window and round decisions, in one launch whose last
block decides; `loop_control_tally` where it also takes the phase's
tallies, which the phase then leaves to it), and K8 `audit_round`
(csrc/audit_round.cu), the audit's health word at each round's end, in
one launch: tiles of consecutive hosts, their counters a thread a host
and their heap rows streamed as one span, every host read, the balance
summed by the last block to take its ticket.
The pops carry the audit's clock lane as a template flag: an audited
launch counts under the pop's name with `_aud` appended. Outside the
window loop, the hybrid policy's batched judgment of deferred packets
is K10 `judge_batch` (csrc/judge_batch.cu), on the views of the path
tables the judge uses (device/judge.py).

On the host mesh (device/mesh.py) a rank's flush adds the exchange:
K5 routes the rank's outbox over every host of the mesh (a rank's
H_loc senders into H_pad destinations), K12 `pack_remote`
(csrc/pack_remote.cu) packs each other shard's segment into the
all_to_all's [S, C, CAP] buffer, K13 `pack_two_phase`
(csrc/pack_two_phase.cu) the two_phase schedule's buffers of both hops
(`pack_two_phase2` the second), in one launch a hop, into send buffers
the engine keeps between phases: a buffer's fill word (`fill_words`)
says which slots its last pack filled, so a pack writes its rows and
the fills of the slots the last one filled alone; K5 then windows the
received rows to the rank's own hosts (`route_window`, or by each row's
key after two_phase, `route_keyed`) and K3 merges them with the rank's
own rows as a second arrival block (`merge_heaps2`). The kernels read
rows through `Rows` views: an outbox, or the exchange's wire buffers;
`MeshParams` holds a rank's place and schedule, `PhaseParams.g0` the
global id of its first host, which the pops and the judge add to a
host's row.

The window loop drives a phase through its control block (`CTL_FIELDS`,
a [len(CTL_FIELDS)] int64 tensor on the state's device), which a
captured CUDA graph reads at every replay: the pop and the judge take
their window end from it, and every kernel of a phase returns at once
where its `run` word is 0, so the slots after the loop is done change
no byte of state. The pop's and the judge's `win_end` argument is the
block itself, or an int, for which the wrapper makes a block; the other
kernels of a phase take the block as an optional guard.

The pops and the judge read the path tables through one of two views
(csrc/topo.cuh), as the world holds them: dense [V,V] tables, or the
factored leaves of `representation: hierarchical`, looked up in two
levels (the reference's `gather_parts`); the kernels are templates over
the view, and a launch on factored tables counts under the kernel's
name with `_hier` appended (`judge_outbox_hier`, ...). The plain
versions look up through `table_lookup`.

An ensemble campaign (ensemble/) runs R replicas in one loop: the state
is [R, H, ...], the outbox [R, H, OB], the control block [R, CTL_N],
and the world stacks the replicas' path tables and epoch times on a
leading axis (`world_replicas`) beside their [R, 2] seed keys
(`seed_key`). Every kernel takes the replica as a grid dimension and R
as an argument; a standalone run is R = 1, its state [H, ...], its
block [CTL_N]. The plain version of each kernel runs a campaign as the
standalone plain function on each replica's slice in turn, which is
exact, and is the tests' yardstick.

Every wrapper takes the plain version for tensors on the CPU and, for
CUDA tensors, launches its kernel on the current stream or raises:
there is no fallback. A wrapper adds one to `Kernels.launches[name]`
where it launches its kernel, and nowhere else; a launch recorded into a
CUDA graph counts once for each replay of the graph (`Kernels.replayed`).
The pop, judge and merge update their state tensors in place, like the
kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from shadow_tpu_torch.core.event import (
    KIND_PACKET,
    KIND_PACKET_READY,
    KIND_TIMER,
)
from shadow_tpu_torch.core.tgen_args import MSS
from shadow_tpu_torch.device import prng
from shadow_tpu_torch.device.apps import (
    PholdDevice,
    TgenDevice,
    TorDevice,
    popcount32,
)
from shadow_tpu_torch.device.netsem import packet_drop_mask
from shadow_tpu_torch.host.model_nic import (
    CODEL_INTERVAL_NS,
    CODEL_TARGET_NS,
    LAW_SIZE,
    MAX_SER_BYTES,
)
from shadow_tpu_torch.topology.hierarchy import gather_parts_plain
from shadow_tpu_torch.utils import nprng
from shadow_tpu_torch.utils.checksum import (
    CHK_KIND,
    CHK_MUL,
    CHK_SEQ,
    CHK_SRC,
    MASK63,
)
from shadow_tpu_torch.utils.rng import PURPOSE_APP, PURPOSE_PACKET_DROP

INF = 1 << 62
DROP_T = INF - 1
IMAX = (1 << 63) - 1
U32 = 0xFFFFFFFF
NS_X8 = 8 * 1_000_000_000      # bits per byte x ns per second

# the kernels that read the path tables, each launched on dense or on
# factored tables, with one epoch or a fault schedule's T > 1; a pop
# also with or without the model NIC and the audit's clock lane. Each
# combination is its own instantiation and counts under its own name:
# f"{name}{NIC}{EP}{HIER}{AUD}" with the parts that apply
# (`launch_name`)
POP_KERNELS = ("pop_phase", "pop_tgen", "pop_tor")
TOPO_KERNELS = (*POP_KERNELS, "judge_outbox")
NIC = "_nic"
EP = "_ep"
HIER = "_hier"
AUD = "_aud"
NIC_KEYS = ("tx_free", "rx_free", "cd_fa", "cd_next", "cd_cnt",
            "cd_last", "cd_drop")
# the state audit (experimental.state_audit): the bits of the per-host
# health word `aud`, its leaves, and the counters that must not go
# negative (the reference engine's AUD_*)
AUD_HEAP = 1        # heap rows out of (t, key) order, or head outside [0, E]
AUD_CLOCK = 2       # a host popped an event earlier than one it executed
AUD_COUNTER = 4     # a cumulative counter went negative
AUD_CONSERVE = 8    # rows produced != rows executed + live + counted lost
AUD_KEYS = ("aud", "aud_t", "aud_tx")
# the heap rows the tiled K8 takes (csrc/audit_round.cu MAX_E: a word's
# row by a reciprocal, exact over a tile's span up to this E)
AUDIT_MAX_E = 65535
# K7 reads by the pop counts on outboxes of this many rows or more
# (Kernels.paths_gated_rows): below it the rows sit in L2 and a pop
# count's load costs more than the rows it saves (PERF.md)
PATHS_GATED_ROWS = 1 << 20
AUD_COUNTERS = ("n_exec", "n_sent", "n_drop", "n_deliv", "event_seq",
                "packet_seq", "app_seq")
# the window loop's control block, one int64 word each, in the order of
# csrc/common.cuh `Ctl`
CTL_FIELDS = ("win_end", "stop", "final_stop", "lookahead", "max_rounds",
              "nxt", "rounds", "phases", "done", "run", "round_end")
CTL = {name: i for i, name in enumerate(CTL_FIELDS)}


def launch_name(name: str, nic: bool = False, epochs: bool = False,
                hier: bool = False, aud: bool = False) -> str:
    return name + (NIC if nic else "") + (EP if epochs else "") + \
        (HIER if hier else "") + (AUD if aud else "")


KERNEL_NAMES = tuple(
    launch_name(n, nic, ep, hr, au) for n in TOPO_KERNELS
    for au in ((False, True) if n in POP_KERNELS else (False,))
    for nic in ((False, True) if n in POP_KERNELS else (False,))
    for ep in (False, True) for hr in (False, True)) + \
    ("route", "merge_heaps", "count_paths", "phase_tally", "audit_round",
     "audit_round_rank", "audit_conserve", "loop_control",
     "loop_control_tally") + \
    tuple(launch_name("judge_batch", False, ep, hr)
          for ep in (False, True) for hr in (False, True)) + \
    ("compact_outbox", "compact_outbox_global") + \
    ("route_window", "route_keyed", "merge_heaps2", "pack_remote",
     "pack_two_phase", "pack_two_phase2")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
OB_FIELDS = ("t", "k", "m", "s", "v")
HEAP_FIELDS = ("ht", "hk", "hm", "hv", "hw")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


@dataclass(frozen=True)
class PhaseParams:
    """The static shape of one phase (EngineConfig plus the app).

    An iteration of the pop loop owns M_out = K + T (+ 1 under the
    model NIC) outbox columns: K send lanes, then T timer lanes, then
    the NIC's READY column. A burst host pops up to P events in one
    iteration and answers event j on lane j (K = P); under the model
    NIC P is 1."""
    E: int                  # heap slots per host
    K: int                  # send lanes per iteration
    T: int                  # timer lanes per iteration
    P: int                  # events per iteration at most (burst)
    B: int                  # iterations per phase at most
    IN: int                 # arrivals per host per flush at most
    C: int                  # packets per send row at most (trains)
    boot_end: int           # no drops before this time
    seed: tuple             # (k1, k2) u32 seed key
    app: Union[PholdDevice, TgenDevice, TorDevice]
    MB: bool = False        # model NIC: judge in the pop, READY column
    CP: bool = False        # path counters: dead rows kept as DROP_T
    AUD: bool = False       # state audit: the pops' clock lane, aud_tx
    CX: int = 0             # exchangeable rows a sender keeps (K11);
                            # 0 or >= OB: all, K11 does not run
    CXG: bool = False       # K11's rule: global (earliest t), else
                            # window (smallest destination)
    g0: int = 0             # the global id of the first host (a mesh
                            # rank's shard * H_loc; 0 on one device)

    @property
    def M_out(self) -> int:
        return self.K + self.T + (1 if self.MB else 0)

    @property
    def OB(self) -> int:
        return self.B * self.M_out

    @property
    def compacts(self) -> bool:
        """Whether K11 runs: 0 < CX < OB."""
        return 0 < self.CX < self.OB


# the channels of a row on the exchange's wire, in this order: the
# outbox fields, then the row's 64-bit key dst*SPAN + src*OB + column
# (SPAN = H_pad*OB), which two_phase routes by at its intermediate and
# the window merge orders two_phase's arrivals by
XCH_FIELDS = (*OB_FIELDS, "key")


@dataclass(frozen=True)
class MeshParams:
    """One rank's place on the host mesh (device/mesh.py) and its
    exchange schedule: S ranks of H_loc = H_pad/S hosts each, this
    rank's hosts are the global ids [shard*H_loc, (shard+1)*H_loc).
    `exchange` is all_to_all, two_phase or all_gather (`auto` resolved),
    with the per-pair CAP, two_phase's phase-2 CAP2 and its g x ng
    groups (device/capacity.py exchange_caps); `merge_global` the
    reference's `merge_strategy: global`."""
    S: int
    shard: int
    H_loc: int
    exchange: str = "all_to_all"
    CAP: int = 0
    CAP2: int = 0
    G: int = 1
    NG: int = 1
    merge_global: bool = False

    @property
    def H_pad(self) -> int:
        return self.S * self.H_loc

    @property
    def g0(self) -> int:
        return self.shard * self.H_loc

    @property
    def channels(self) -> int:
        """Channels a packed row ships: the global merge's all_to_all
        needs no key (the reference's ship_keys=False)."""
        if self.exchange == "all_to_all" and self.merge_global:
            return len(OB_FIELDS)
        return len(XCH_FIELDS)


# ----------------------------------------------------------------------
# integer helpers shared by the plain versions
# ----------------------------------------------------------------------
def pack2(hi, lo):
    return ((hi.to(torch.int64) & U32) << 32) | (lo.to(torch.int64) & U32)


def hi32(x):
    return (x >> 32).to(torch.int32)


def lo32(x):
    return (x & U32).to(torch.int32)


def epoch_of(t: torch.Tensor, epoch_times: torch.Tensor):
    """The epoch of each time in `t`: the count of epoch starts <= t,
    minus 1 (the reference engine's `_ep_of`); None for a single
    epoch, whose tables have no epoch axis."""
    if epoch_times.shape[0] == 1:
        return None
    return (t[..., None] >= epoch_times).sum(-1) - 1


def table_lookup(tab, sv: torch.Tensor, dv: torch.Tensor,
                 e=None) -> torch.Tensor:
    """One path table at (sv, dv), broadcast, in epoch `e` (None: the
    tables have no epoch axis): a dense [V,V] or [T,V,V] gather, or
    the two-level lookup of a factored (cluster, cl, access, self)
    tuple (the reference engine's `_tbl`)."""
    if isinstance(tab, tuple):
        return gather_parts_plain(tab, sv, dv, e)
    return tab[sv, dv] if e is None else tab[e, sv, dv]


def control_block(device, replicas: Optional[int] = None,
                  **words) -> torch.Tensor:
    """A window-loop control block on `device`: the named words of
    CTL_FIELDS set, the others 0; with `replicas` one such block per
    replica, [R, CTL_N], else [CTL_N]."""
    unknown = set(words) - set(CTL)
    if unknown:
        raise ValueError(f"no control word(s) {sorted(unknown)}")
    row = [int(words.get(n, 0)) for n in CTL_FIELDS]
    return torch.tensor(row if replicas is None else [row] * replicas,
                        dtype=torch.int64, device=device)


def merge_flags(device, replicas: int = 1) -> torch.Tensor:
    """K3's words of an engine, [2, R] int32: a replica's fresh word (a
    state entered from outside: the next merge checks every heap's
    order and clears it), and a word the merge keeps zero between
    launches (a heap past INF seen)."""
    flags = torch.zeros((2, replicas), dtype=torch.int32, device=device)
    flags[0] = 1
    return flags


def outbox_word(device, replicas: int = 1) -> torch.Tensor:
    """The engine's outbox words, [2, R] int32: a replica's word says
    that its outbox rows came from outside the pop (a state entering the
    engine, rows copied into the buffer), so the next pop clears every
    row and the judge judges every host until a pop has run; and a count
    the pop keeps zero between launches (csrc/pop_phase.cu)."""
    return merge_flags(device, replicas)


def fill_words(send: torch.Tensor) -> torch.Tensor:
    """The fill words of K13's kept send buffers `send` [n, 6, cap] (a
    campaign's [n, R, 6, cap]): [n] (or [n, R]) int32, each the slots
    its buffer's last pack filled with rows; the capacity when allocated
    (every slot unknown: the first pack writes every slot)."""
    return torch.full(tuple(send.shape[:-2]), send.shape[-1],
                      dtype=torch.int32, device=send.device)


def _pop_ran(outside: Optional[torch.Tensor], win_end, R: Optional[int]):
    """Clear the outbox word of each replica whose phase ran, as the pop
    kernel's last block of the replica does."""
    if outside is None:
        return
    for r in range(R or 1):
        if phase_window(_ctl_at(win_end, r) if R else win_end) is not None:
            outside[0, r] = 0


# ----------------------------------------------------------------------
# the replica axis of an ensemble campaign
# ----------------------------------------------------------------------
def n_replicas(state: dict) -> Optional[int]:
    """R for a campaign's state [R, H, ...], None for a standalone
    state [H, ...]."""
    head = state["head"]
    return int(head.shape[0]) if head.dim() == 2 else None


def world_replicas(world: dict) -> Optional[int]:
    """R for a campaign's world, whose epoch times are [R, T] and whose
    path tables carry the same leading axis (every leaf but the
    factored tables' shared cl); None for a standalone world."""
    ept = world["epoch_times"]
    return int(ept.shape[0]) if ept.dim() == 2 else None


def ob_replicas(ob: dict) -> Optional[int]:
    """R for a campaign's outbox [R, H, OB], None for a standalone
    one."""
    t = ob["t"]
    return int(t.shape[0]) if t.dim() == 3 else None


def at_replica(d: dict, r: int) -> dict:
    """Replica r's views of a campaign's state or outbox leaves: the
    standalone layout, written through in place."""
    return {k: v[r] for k, v in d.items()}


def replica_world(world: dict, r: int) -> dict:
    """Replica r's world in the standalone layout: its tables, epoch
    times and [1, 2] seed key; the other leaves are shared."""
    def part(v):
        if isinstance(v, tuple):        # factored: cl is shared
            return tuple(a if i == 1 else a[r] for i, a in enumerate(v))
        return v[r]

    return {**world, "lat": part(world["lat"]), "rel": part(world["rel"]),
            "epoch_times": world["epoch_times"][r],
            "seed_key": world["seed_key"][r:r + 1]}


def replica_params(world: dict, p: PhaseParams) -> PhaseParams:
    """`p` with the seed key of a world of one replica, where the world
    names one: a world's key wins over `p.seed`, in the plain versions
    as in the kernels (`Kernels._seed_args`)."""
    key = world.get("seed_key")
    if key is None:
        return p
    return dataclasses.replace(p, seed=(int(key[0, 0]), int(key[0, 1])))


def _each_replica(R: int, world: dict, p: PhaseParams):
    """(r, replica r's world, its params) for each of a campaign's R
    replicas; the world must be a campaign world of as many."""
    if world_replicas(world) != R:
        raise ValueError(f"a state of {R} replicas needs a world of as "
                         "many")
    for r in range(R):
        w = replica_world(world, r)
        yield r, w, replica_params(w, p)


def _ctl_at(ctl, r: int):
    """Replica r's control block (an int window end passes through)."""
    return ctl[r] if isinstance(ctl, torch.Tensor) else ctl


def phase_window(win_end) -> Optional[int]:
    """The window end a phase's plain version works to: `win_end`
    itself, or the `win_end` word of a control block; None where the
    block's `run` word is 0 (the phase does not run)."""
    if isinstance(win_end, torch.Tensor):
        if not int(win_end[CTL["run"]]):
            return None
        return int(win_end[CTL["win_end"]])
    return int(win_end)


def _phase_off(ctl: Optional[torch.Tensor]) -> bool:
    return ctl is not None and not int(ctl[CTL["run"]])


def head_min_plain(state: dict) -> torch.Tensor:
    """The minimum over hosts of each host's head event time (INF where
    head >= E), as a 0-dim int64 tensor (the reference's `next_time`:
    `_take_head` then `_axis_min`); [R] for a campaign's state."""
    head = state["head"].long()
    E = state["ht"].shape[-1]
    nt = state["ht"].gather(-1, head.clamp(0, E - 1)[..., None])[..., 0]
    nt = torch.where(head < E, nt, INF)
    if not nt.shape[-1]:
        return torch.full(nt.shape[:-1], INF, dtype=torch.int64)
    return nt.amin(-1)


# the world's per-host columns, [H] on one device and [H_pad] on a mesh
# rank (every rank holds them all, as it holds host_vertex, which the
# judge reads at any destination)
HOST_COLUMNS = ("client_count", "client_pause", "client_retry", "bw_up",
                "bw_down")


def host_columns(world: dict, g0: int, H: int) -> dict:
    """`world` with its per-host columns cut to the H hosts from global
    id g0 on, as the plain versions index them (by local row); the
    kernels index the whole columns by global id."""
    return {**world, **{k: world[k][g0:g0 + H] for k in HOST_COLUMNS
                        if k in world}}


def _wbits(cnt: torch.Tensor) -> torch.Tensor:
    """The low `cnt` bits of a u32 (all 32 from 32 up)."""
    return torch.where(cnt >= 32, U32, (1 << cnt.clamp(0, 31).long()) - 1)


# ----------------------------------------------------------------------
# K1 / K4: one phase of pops (reference: engine._step, judge at flush)
# ----------------------------------------------------------------------
def pop_plain(state: dict, ob: dict, pops: torch.Tensor, world: dict,
              win_end, p: PhaseParams,
              outside: Optional[torch.Tensor] = None) -> None:
    """Pop events below `win_end`, in lockstep over hosts, exactly as
    the reference's pop loop: a host stops at the window end, at
    `dirty` (an in-window self-send, timer or READY row it must not
    pass) or after B iterations, and stays stopped for the rest of the
    phase. Each iteration pops one event per runnable host; with P > 1
    a burst host (`app.burst_mask`) whose head is an in-window packet
    pops the run of consecutive in-window packets from its head, up to
    P. Iteration j of a host writes outbox columns [j*M_out,
    (j+1)*M_out): sends on lanes 0..K-1 (each departing at its own
    event's time), then timers; unused columns hold t = INF and zeros.
    A send row's v hi word is its live-lane mask (the app's
    `send_mask`, all ones when it gives none). `pops[h]` receives the
    host's iteration count.

    Under the model NIC (p.MB, P = 1) the pop also judges its sends
    (the reference's in-step path): TX serialization from `tx_free`,
    latency and drop rolls keyed on the pop time, the causality bump;
    n_sent/n_drop count here, and a dead send is written only under
    p.CP, as DROP_T. A popped KIND_PACKET is the RX stage: the app
    does not see it; the download bucket and CoDel drop it or write a
    KIND_PACKET_READY row in the READY column, which the app sees as a
    packet when it pops.

    Under the state audit (p.AUD) each iteration ORs AUD_CLOCK into
    `aud` where a host's first popped time lies below `aud_t`, then
    sets `aud_t` to the largest time it popped (engine.py:800-813).
    `win_end` is an int or a control block (`phase_window`); a
    campaign's state runs each replica in turn. It rewrites every row of
    the outbox, and clears the outbox word `outside` (`outbox_word`) of
    each replica whose phase ran, as the kernel does."""
    R = n_replicas(state)
    _pop_ran(outside, win_end, R)
    if R is not None:
        for r, w, q in _each_replica(R, world, p):
            pop_plain(at_replica(state, r), at_replica(ob, r), pops[r], w,
                      _ctl_at(win_end, r), q)
        return
    p = replica_params(world, p)
    win_end = phase_window(win_end)
    if win_end is None:
        return
    E, K, T, P, B, C, app = p.E, p.K, p.T, p.P, p.B, p.C, p.app
    M, MB = p.M_out, p.MB
    dev = state["head"].device
    H = state["head"].shape[0]
    gid = torch.arange(p.g0, p.g0 + H, dtype=torch.int32, device=dev)
    hv = world["host_vertex"].long()[p.g0:p.g0 + H]
    world = host_columns(world, p.g0, H)
    ept = world["epoch_times"]
    # one epoch: the self latency read once
    selflat1 = (table_lookup(world["lat"], hv, hv).long()[:, None]
                if ept.shape[0] == 1 else None)
    for f in OB_FIELDS:
        ob[f].fill_(INF if f == "t" else 0)
    names = ["head", "chk", "n_exec", "n_deliv", "event_seq", "packet_seq",
             "app_seq", "app"] + (["n_sent", "n_drop", *NIC_KEYS]
                                  if MB else []) + (["aud", "aud_t"]
                                                    if p.AUD else [])
    st = {k: state[k].clone() for k in names}
    dirty = torch.zeros(H, dtype=torch.bool, device=dev)
    npop = torch.zeros(H, dtype=torch.int32, device=dev)
    offs = torch.arange(P, dtype=torch.int32, device=dev)
    draw_off = torch.arange(app.max_draws, dtype=torch.int64, device=dev)
    app_key = prng.purpose_id_key(p.seed, PURPOSE_APP, gid)
    drop_key = (prng.purpose_id_key(p.seed, PURPOSE_PACKET_DROP, gid)
                if MB else None)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    deliv_kind = KIND_PACKET_READY if MB else KIND_PACKET

    def take(arr, fill):
        idx = st["head"][:, None] + offs
        v = arr.gather(1, idx.clamp(max=E - 1).long())
        return torch.where(idx < E, v, fill)

    for blk in range(B):
        ptP = take(state["ht"], INF)
        pt = ptP[:, 0]
        runnable = (pt < win_end) & ~dirty
        if not bool(runnable.any()):
            break
        pk2P, pmP = take(state["hk"], IMAX), take(state["hm"], 0)
        pvP, pwP = take(state["hv"], 0), take(state["hw"], 0)
        srcP, seqP = hi32(pk2P), lo32(pk2P)
        kindP, sizeP = hi32(pmP), lo32(pmP)
        d0P, d1P, d2P = hi32(pvP), lo32(pvP), lo32(pwP)
        if P > 1:
            elig = ((ptP < win_end) & (kindP == KIND_PACKET)).to(torch.int32)
            run = elig.cumprod(1).sum(-1, dtype=torch.int32)
            burst = app.burst_mask(st["app"]) & (elig[:, 0] == 1)
            popcnt = torch.where(runnable, torch.where(burst, run, 1), 0)
        else:
            popcnt = runnable.to(torch.int32)
        active = offs[None, :] < popcnt[:, None]              # [H,P]
        if p.AUD:
            prev = st["aud_t"]
            st["aud"] = st["aud"] | torch.where(
                runnable & (pt < prev), AUD_CLOCK, 0).to(torch.int32)
            last = (torch.where(active, ptP, 0).amax(-1) if P > 1
                    else pt)
            st["aud_t"] = torch.where(runnable, torch.maximum(prev, last),
                                      prev)
        st["head"] = st["head"] + popcnt
        st["n_exec"] = st["n_exec"] + popcnt
        npop = npop + runnable.to(torch.int32)
        st["n_deliv"] = st["n_deliv"] + torch.where(
            active & (kindP == deliv_kind),
            popcount32(pwP).to(torch.int32), 0).sum(-1, dtype=torch.int32)
        # fold each popped event in order (the 63-bit truncation
        # between steps makes a closed form wrong)
        chk = st["chk"]
        for j in range(P):
            mix = (ptP[:, j] ^ (srcP[:, j].long() * CHK_SRC)
                   ^ (kindP[:, j].long() * CHK_KIND)
                   ^ (seqP[:, j].long() * CHK_SEQ)) & MASK63
            chk = torch.where(active[:, j], (chk * CHK_MUL + mix) & MASK63,
                              chk)
        st["chk"] = chk

        seqs = (st["app_seq"].long()[:, None] + draw_off) & U32
        draws = prng.random_bits32(prng.fold_seq(
            (app_key[0][:, None], app_key[1][:, None]), seqs))
        kind_app = torch.where(active, kindP, -1)
        if MB:
            # the RX stage is the engine's; READY pops reach the app as
            # packets
            is_rx = runnable & (kindP[:, 0] == KIND_PACKET)
            kind_app = torch.where(kindP == KIND_PACKET_READY,
                                   KIND_PACKET, kind_app)
            kind_app = torch.where(is_rx[:, None], -1, kind_app)
            app_on = runnable & ~is_rx
        else:
            app_on = runnable
        if P > 1:
            out = app.handle_burst(gid, ptP, kind_app, srcP, sizeP, d0P,
                                   d1P, d2P, st["app"], draws, world)
            lane_t = ptP
        else:
            out = app.handle(gid, pt, kind_app[:, 0], srcP[:, 0],
                             sizeP[:, 0], d0P[:, 0], d1P[:, 0], d2P[:, 0],
                             st["app"], draws, world)
            lane_t = pt[:, None].expand(H, K)
        st["app"] = torch.where(app_on[:, None], out.app_state, st["app"])
        st["app_seq"] = st["app_seq"] + torch.where(app_on, out.n_draws, 0)

        valid = out.send_valid & app_on[:, None]               # [H,K]
        v32 = valid.to(torch.int32)
        counts = (torch.ones_like(v32) if out.send_count is None
                  else out.send_count.clamp(1, C))
        smask = (torch.full_like(v32, -1) if out.send_mask is None
                 else out.send_mask)
        vcnt = (counts * v32).long()
        pkt_base = st["packet_seq"].long()[:, None] + vcnt.cumsum(-1) - vcnt
        st["packet_seq"] = st["packet_seq"] + vcnt.sum(-1).to(torch.int32)
        vrank = v32.cumsum(-1, dtype=torch.int32) - v32
        nvalid = v32.sum(-1, dtype=torch.int32)
        ev_seq = st["event_seq"][:, None] + vrank
        tvalid = out.timer_valid & app_on[:, None]             # [H,T]
        t32 = tvalid.to(torch.int32)
        tseq = st["event_seq"][:, None] + nvalid[:, None] + \
            t32.cumsum(-1, dtype=torch.int32) - t32
        st["event_seq"] = st["event_seq"] + nvalid + \
            t32.sum(-1, dtype=torch.int32)
        timer_t = pt[:, None] + out.timer_delay

        dst = out.send_dst
        g2 = gid[:, None].expand(H, K)
        gT = gid[:, None].expand(H, T)
        hv2 = hv[:, None].expand(H, K)
        e = epoch_of(lane_t, ept)
        if MB:
            sends, dirty_now, ready = _nic_step(
                st, world, p, win_end, runnable, is_rx, valid, pt, e, gid,
                dst, counts, smask, pkt_base, ev_seq, out, drop_key,
                (sizeP[:, 0], pk2P[:, 0], d0P[:, 0], d1P[:, 0],
                 d2P[:, 0]), zero)
        else:
            sends = {
                "t": torch.where(valid, lane_t, INF),
                "k": torch.where(valid, pack2(g2, ev_seq), zero),
                "m": torch.where(valid, pack2(
                    dst, KIND_PACKET | (counts << 8)), zero),
                "s": torch.where(valid, pack2(out.send_size, out.send_d0),
                                 zero),
                "v": torch.where(valid, pack2(smask, out.send_d1), zero)}
            # an in-window self-send must land before the host pops
            # again, judged on the self-latency at its departure (self
            # rows never take the causality bump)
            selflat = (selflat1 if e is None else
                       table_lookup(world["lat"], hv2, hv2, e).long())
            dirty_now = (valid & (dst == g2)
                         & (lane_t + selflat < win_end)).any(-1)
        timers = {
            "t": torch.where(tvalid, timer_t, INF),
            "k": torch.where(tvalid, pack2(gT, tseq), zero),
            "m": torch.where(tvalid, pack2(gT, torch.full_like(
                gT, KIND_TIMER)), zero),
            "s": torch.where(tvalid, pack2(torch.zeros_like(gT),
                                           out.timer_d0), zero),
            "v": torch.zeros((H, T), dtype=torch.int64, device=dev)}
        c0 = blk * M
        for f in OB_FIELDS:
            ob[f][:, c0:c0 + K] = sends[f]
            ob[f][:, c0 + K:c0 + K + T] = timers[f]
            if MB:
                ob[f][:, c0 + K + T] = ready[f]
        tim_in = (tvalid & (timer_t < win_end)).any(-1)
        dirty = dirty | (runnable & (dirty_now | tim_in))

    for name in names:
        state[name].copy_(st[name])
    pops.copy_(npop)


def _nic_step(st, world, p, win_end, runnable, is_rx, valid, pt, e, gid,
              dst, counts, smask, pkt_base, ev_seq, out, drop_key,
              popped, zero):
    """One pop iteration's model-NIC work (P = 1), the reference's
    in-step path (engine.py `_step` under model_bandwidth): judge the
    sends at the pop time behind the TX bucket, then pass a popped
    KIND_PACKET through the RX bucket and CoDel. Updates the NIC leaves
    and n_sent/n_drop in `st`. Returns the send rows, each host's
    in-window self mark (a delivered self-send or READY row inside the
    window) and the READY row."""
    H, K = valid.shape
    dev = valid.device
    hv = world["host_vertex"].long()
    g2 = gid[:, None].expand(H, K)
    srcv = hv[gid.long()][:, None].expand(H, K)
    dstv = hv[dst.long().clamp(0, hv.shape[0] - 1)]
    latv = table_lookup(world["lat"], srcv, dstv, e).long()
    relv = table_lookup(world["rel"], srcv, dstv, e)
    # one roll per live lane, keyed (src, packet seq), at the pop time
    livemask = torch.where(valid, (smask.long() & U32) & _wbits(counts), 0)
    js = torch.arange(p.C, dtype=torch.int64, device=dev)
    h, c, j = ((livemask[..., None] >> js) & 1).nonzero(as_tuple=True)
    drop = packet_drop_mask(
        p.seed, p.boot_end, pt[h], None, pkt_base[h, c] + j, relv[h, c],
        src_key=(drop_key[0][h], drop_key[1][h]))
    surv = torch.zeros_like(livemask).index_put_(
        (h, c), torch.where(drop, 0, 1 << j), accumulate=True)
    livecnt = popcount32(livemask)
    st["n_sent"] = st["n_sent"] + livecnt.sum(-1).to(torch.int32)
    st["n_drop"] = st["n_drop"] + (livecnt - popcount32(surv)).sum(
        -1).to(torch.int32)
    # TX bucket: the sends serialize in lane order from max(pt,
    # tx_free), dropped ones included
    ser_up = torch.where(valid, (out.send_size.clamp(1, MAX_SER_BYTES)
                                 .long() * NS_X8)
                         // world["bw_up"][:, None], 0)
    tx_base = torch.maximum(pt, st["tx_free"])
    cum = ser_up.cumsum(-1)
    depart = tx_base[:, None] + cum - ser_up
    st["tx_free"] = torch.where(runnable, tx_base + cum[:, -1],
                                st["tx_free"])
    deliver_t = depart + latv
    deliver_t = torch.where(dst != g2, deliver_t.clamp(min=win_end),
                            deliver_t)
    delivered = valid & (surv != 0)
    written = valid if p.CP else delivered
    sends = {
        "t": torch.where(written, torch.where(delivered, deliver_t,
                                              DROP_T), INF),
        "k": torch.where(written, pack2(g2, ev_seq), zero),
        "m": torch.where(written, pack2(dst, KIND_PACKET | (livecnt << 8)),
                         zero),
        "s": torch.where(written, pack2(out.send_size, out.send_d0), zero),
        "v": torch.where(written, pack2(surv, out.send_d1), zero)}
    self_in = (delivered & (dst == g2) & (deliver_t < win_end)).any(-1)

    # RX stage: download bucket and event-driven CoDel, every `where`
    # in the reference's order
    psize, pk2, pd0, pd1, pd2 = popped
    rxf = st["rx_free"]
    dq = torch.maximum(pt, rxf)
    below = dq - pt < CODEL_TARGET_NS
    fa = st["cd_fa"]
    fa0 = fa == 0
    above = ~below & ~fa0 & (dq >= fa)
    in_drop = st["cd_drop"] != 0
    drop_now = above & in_drop & (dq >= st["cd_next"])
    drop_first = above & ~in_drop
    rx_drop = is_rx & (drop_now | drop_first)
    rx_keep = is_rx & ~(drop_now | drop_first)
    cnt, nxt, last = st["cd_cnt"], st["cd_next"], st["cd_last"]
    delta = cnt - last
    first_cnt = torch.where((dq - nxt < CODEL_INTERVAL_NS) & (delta > 1),
                            delta, 1)
    new_cnt = torch.where(drop_now, cnt + 1,
                          torch.where(drop_first, first_cnt, cnt))
    law = world["law"][new_cnt.clamp(0, LAW_SIZE - 1)]
    new = {
        "cd_cnt": new_cnt,
        "cd_next": torch.where(drop_now, nxt + law,
                               torch.where(drop_first, dq + law, nxt)),
        "cd_last": torch.where(drop_first, first_cnt, last),
        "cd_fa": torch.where(below, 0, torch.where(
            fa0, dq + CODEL_INTERVAL_NS, fa)),
        "cd_drop": torch.where(below, 0, torch.where(
            fa0, st["cd_drop"], torch.where(above, torch.where(
                in_drop, st["cd_drop"], 1), 0)))}
    ser_down = (psize.clamp(1, MAX_SER_BYTES).long() * NS_X8) \
        // world["bw_down"]
    rx_deliver = dq + ser_down
    for k, v in new.items():
        st[k] = torch.where(is_rx, v, st[k])
    st["rx_free"] = torch.where(rx_keep, rx_deliver, rxf)
    st["n_drop"] = st["n_drop"] + rx_drop.to(torch.int32)
    ready = {
        "t": torch.where(rx_keep, rx_deliver, INF),
        "k": torch.where(rx_keep, pk2, zero),
        "m": torch.where(rx_keep, pack2(gid, torch.full_like(
            gid, KIND_PACKET_READY)), zero),
        "s": torch.where(rx_keep, pack2(psize, pd0), zero),
        "v": torch.where(rx_keep, pack2(pd2, pd1), zero)}
    ready_in = rx_keep & (rx_deliver < win_end)
    return sends, self_in | ready_in, ready


# ----------------------------------------------------------------------
# K2: per-phase network judgment (reference: engine._judge_outbox)
# ----------------------------------------------------------------------
def judge_outbox_plain(state: dict, ob: dict, world: dict, win_end,
                       p: PhaseParams) -> None:
    """Judge every send row of the outbox: path latency and
    reliability in the epoch of the row's departure, one drop roll per
    packet keyed by (src, packet seq), the causality bump to `win_end`
    for cross-host rows, and the sent/dropped counters. A row whose
    packets all drop gets t = INF, or DROP_T under the path counters
    (p.CP), which count it. Rewrites ob t/m/v in place. `win_end` is
    an int or a control block (`phase_window`); a campaign's state runs
    each replica in turn."""
    if ob_replicas(ob) is not None:
        for r, w, q in _each_replica(ob_replicas(ob), world, p):
            judge_outbox_plain(at_replica(state, r), at_replica(ob, r), w,
                               _ctl_at(win_end, r), q)
        return
    p = replica_params(world, p)
    win_end = phase_window(win_end)
    if win_end is None:
        return
    ft, fm, fv = ob["t"], ob["m"], ob["v"]
    H, OB = ft.shape
    dev = ft.device
    gid = torch.arange(p.g0, p.g0 + H, dtype=torch.int32, device=dev)
    hv = world["host_vertex"].long()
    kindrow = lo32(fm)
    is_send = (ft < INF) & ((kindrow & 0xFF) == KIND_PACKET)
    cnt = torch.where(is_send, kindrow >> 8, 0)
    dst = hi32(fm)
    srcv = hv[gid.long()][:, None]
    dstv = hv[dst.long().clamp(0, hv.shape[0] - 1)]
    # an empty row (t = INF) reads the last epoch, harmlessly
    e = epoch_of(ft, world["epoch_times"])
    latv = table_lookup(world["lat"], srcv, dstv, e).to(torch.int64)
    relv = table_lookup(world["rel"], srcv, dstv, e)
    # each row's first packet seq: packet_seq is the END of the phase,
    # rows sit in consumption order
    c64 = cnt.long()
    base = (state["packet_seq"].long() - c64.sum(-1))[:, None] + \
        (c64.cumsum(-1) - c64)
    livemask = (fv >> 32) & U32 & _wbits(cnt)
    livecnt = popcount32(livemask)
    # roll the live lanes only: (host, column, lane) of each packet
    js = torch.arange(p.C, dtype=torch.int64, device=dev)
    h, c, j = ((livemask[..., None] >> js) & 1).nonzero(as_tuple=True)
    hk = prng.purpose_id_key(p.seed, PURPOSE_PACKET_DROP, gid)
    drop = packet_drop_mask(
        p.seed, p.boot_end, ft[h, c], None, base[h, c] + j, relv[h, c],
        src_key=(hk[0][h], hk[1][h]))
    surv = torch.zeros_like(livemask).index_put_(
        (h, c), torch.where(drop, 0, 1 << j), accumulate=True)
    lost = livecnt - popcount32(surv)
    state["n_sent"] += livecnt.sum(-1).to(torch.int32)
    state["n_drop"] += lost.sum(-1).to(torch.int32)
    deliver_t = ft + latv
    deliver_t = torch.where(dst != gid[:, None],
                            deliver_t.clamp(min=win_end), deliver_t)
    dead = is_send & (surv == 0)
    new_t = torch.where(is_send, torch.where(dead, DROP_T if p.CP else INF,
                                             deliver_t), ft)
    new_m = torch.where(is_send, pack2(dst, KIND_PACKET | (livecnt << 8)),
                        fm)
    new_v = torch.where(is_send, pack2(surv, lo32(fv)), fv)
    ft.copy_(new_t)
    fm.copy_(new_m)
    fv.copy_(new_v)


# ----------------------------------------------------------------------
# K11: the outbox compaction (reference: engine._flat_sorted CX < OB,
# engine._compact_flat)
# ----------------------------------------------------------------------
def compact_plain(state: dict, ob: dict, cx: int, global_rule: bool,
                  ctl: Optional[torch.Tensor] = None) -> None:
    """Keep at most `cx` exchangeable rows (t < DROP_T) of each sender's
    outbox row: those of smallest (dst, column), the window rule, or
    with `global_rule` of smallest (t, column); write t = INF into the
    others and add their count, max(0, live - cx), to the sender's
    x_overflow. In place; nothing where the control block `ctl` says the
    phase does not run. A campaign's outbox compacts each replica in
    turn."""
    if ob_replicas(ob) is not None:
        for r in range(ob_replicas(ob)):
            compact_plain(at_replica(state, r), at_replica(ob, r), cx,
                          global_rule, _ctl_at(ctl, r))
        return
    if _phase_off(ctl):
        return
    ft = ob["t"]
    H, OB = ft.shape
    valid = ft < DROP_T
    key = ft if global_rule else hi32(ob["m"]).long()
    key = torch.where(valid, key, IMAX)
    # a column's rank in its row by (key, column): a stable sort
    order = torch.sort(key, dim=1, stable=True).indices
    col = torch.arange(OB, device=ft.device).expand(H, OB)
    rank = torch.empty_like(order).scatter_(1, order, col)
    ft.masked_fill_(valid & (rank >= cx), INF)
    state["x_overflow"] += (valid.sum(-1) - cx).clamp(min=0).to(
        torch.int32)


# ----------------------------------------------------------------------
# K10: the hybrid policy's batched judge (reference: DeviceJudge._judge)
# ----------------------------------------------------------------------
def host_index(ids: torch.Tensor, H: int) -> torch.Tensor:
    """The host row a judged id reads, as the reference's numpy and jax
    indexing read it: an id in [-H, -1] reads host id + H, every other
    id outside [0, H) the nearest end."""
    i = ids.long()
    return torch.where(i < 0, i + H, i).clamp(0, H - 1)


def judge_batch_plain(world: dict, boot_end: int, now: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor,
                      pkt_seq: torch.Tensor):
    """(delivered bool [N], deliver_time int64 [N]) of N deferred
    packets: now int64, src/dst/pkt_seq int32 (the seq read as u32);
    the path between the hosts' vertices in the epoch of `now`, the
    drop roll of packet_drop_mask keyed (src, pkt_seq) under the
    world's [1, 2] seed key, and now + latency. The hosts' rows are
    read through `host_index`; the roll keys on the raw id."""
    key = world["seed_key"]
    seed = (int(key[0, 0]), int(key[0, 1]))
    hv = world["host_vertex"].long()
    H = hv.shape[0]
    sv = hv[host_index(src, H)]
    dv = hv[host_index(dst, H)]
    e = epoch_of(now, world["epoch_times"])
    latv = table_lookup(world["lat"], sv, dv, e).to(torch.int64)
    relv = table_lookup(world["rel"], sv, dv, e)
    dropped = packet_drop_mask(seed, boot_end, now, src, pkt_seq, relv)
    return ~dropped, now + latv


# ----------------------------------------------------------------------
# K7: the path counters (reference: engine._count_paths)
# ----------------------------------------------------------------------
def count_paths_plain(state: dict, ob: dict, world: dict,
                      ctl: Optional[torch.Tensor] = None) -> None:
    """Add every judged packet row of the outbox (t < INF, DROP_T
    included, kind KIND_PACKET) to the [V*V] histogram of sent packets
    at (vertex of src) * V + (vertex of dst), weighted by its live
    count (kind >> 8). In place on state["path_cnt"] [1, V*V] ([R, 1,
    V*V] for a campaign); nothing where the control block `ctl` says the
    phase does not run. On a mesh rank the outbox holds the rank's
    hosts and the sources and destinations are global ids: the rank
    counts into its own row, and the run sums the ranks' rows."""
    if ob_replicas(ob) is not None:
        for r in range(ob_replicas(ob)):
            count_paths_plain(at_replica(state, r), at_replica(ob, r),
                              world, _ctl_at(ctl, r))
        return
    if _phase_off(ctl):
        return
    ft, fk, fm = ob["t"], ob["k"], ob["m"]
    # ids are global: clipped to the world's hosts (a mesh's H_pad)
    hv = world["host_vertex"].long()
    Hv = hv.shape[0]
    V = n_vertices(world)
    kind = lo32(fm)
    is_pkt = (ft < INF) & ((kind & 0xFF) == KIND_PACKET)
    sv = hv[hi32(fk).long().clamp(0, Hv - 1)]
    dv = hv[hi32(fm).long().clamp(0, Hv - 1)]
    state["path_cnt"][0].index_add_(0, (sv * V + dv)[is_pkt],
                                    (kind >> 8).long()[is_pkt])


def n_vertices(world: dict) -> int:
    """The vertex count of the world's path tables."""
    lat = world["lat"]
    return int(lat[1].shape[-1] if isinstance(lat, tuple)
               else lat.shape[-1])


# ----------------------------------------------------------------------
# K5: route (reference: _flat_sorted/_host_windows)
# ----------------------------------------------------------------------
def route_plain(ob: dict):
    """Order the judged outbox rows by (dst, src, column): a flat sort
    of dst*SPAN + src*OB + column over exchangeable rows (t < DROP_T),
    then per-destination segment bounds by searchsorted. Returns
    (perm [H*OB], starts [H], counts [H]), int64; perm's first
    counts.sum() entries are the live rows' flat indices in that
    order. A campaign's outbox [R, H, OB] gives each replica's, stacked
    ([R, H*OB], [R, H], [R, H])."""
    if ob_replicas(ob) is not None:
        return tuple(torch.stack(x) for x in zip(*(
            route_plain(at_replica(ob, r)) for r in range(ob_replicas(ob)))))
    ft, fm = ob["t"], ob["m"]
    H, OB = ft.shape
    dev = ft.device
    span = H * OB
    okey = torch.arange(H * OB, dtype=torch.int64, device=dev).view(H, OB)
    skey = torch.where(ft < DROP_T, hi32(fm).long() * span + okey, IMAX)
    skey_s, perm = torch.sort(skey.view(-1))
    edges = torch.searchsorted(
        skey_s, torch.arange(H + 1, dtype=torch.int64, device=dev) * span)
    return perm, edges[:-1].contiguous(), (edges[1:] - edges[:-1])


# the radix sort's tile and passes (csrc/route.cu TILE, BINS,
# MAX_PASSES, CTR_N)
ROUTE_TILE, ROUTE_BINS, ROUTE_MAX_PASSES, ROUTE_CTRS = 2048, 256, 8, 19


def route_work_words(F: int, keyed: bool) -> int:
    """int64 words of K5's scratch a replica at F rows (csrc/route.cu
    `work_words`, which checks it): two buffers of the rows in flight
    (destination and index int32, keyed their int64 key too), look-back
    status (int32 a compaction tile of 4 * ROUTE_TILE rows, and two
    arrays of BINS a pass tile), the passes' histograms and the
    counters."""
    nt = -(-F // ROUTE_TILE)
    u32 = 4 * F + -(-F // (4 * ROUTE_TILE)) + 2 * nt * ROUTE_BINS + \
        ROUTE_MAX_PASSES * ROUTE_BINS + ROUTE_CTRS
    return (2 * F if keyed else 0) + (u32 + 1) // 2


# ----------------------------------------------------------------------
# K3: merge arrivals into the heaps (reference: the window-path merge)
# ----------------------------------------------------------------------
def merge_heaps_plain(state: dict, ob: dict, perm: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      p: PhaseParams,
                      ctl: Optional[torch.Tensor] = None,
                      second: Optional[tuple] = None,
                      occ_sum: bool = False) -> None:
    """Per host: the live heap rows (slots >= head) and the first IN
    arrivals of its segment, sorted by (time, key, column) — column
    breaks ties, so the order is the stable lexicographic one — and
    the first E rows kept. Rows past E with t < INF, and arrivals past
    IN, count into `overflow`; `occ_in`/`occ_heap` take their
    high-water marks; head resets to 0. Nothing where the control block
    `ctl` says the phase does not run. A campaign's state merges each
    replica in turn, from its row of the route's outputs.

    `ob` is the outbox or any dict of field tensors the route's perm
    indexes flat. `second` = (ob2, perm2, starts2, counts2) is a second
    arrival block (a mesh rank's self-shard rows, engine.py:1955-2061),
    windowed to IN on its own and sorted after the first: the sort is
    [heap | first | second]; occ_in takes the larger of the two blocks'
    counts, or with `occ_sum` their sum (the global merge's). Either
    block's rows may be a `Rows` (wire buffers; a campaign's [nb, R, C,
    bw]); a campaign's second block takes replica r's row of its
    route's outputs, as the first."""
    def replica(x, r):
        return x.at(r) if isinstance(x, Rows) else at_replica(x, r)

    if n_replicas(state) is not None:
        for r in range(n_replicas(state)):
            merge_heaps_plain(
                at_replica(state, r), replica(ob, r), perm[r], starts[r],
                counts[r], p, _ctl_at(ctl, r),
                None if second is None else (
                    replica(second[0], r), *(x[r] for x in second[1:])),
                occ_sum)
        return
    if _phase_off(ctl):
        return
    if isinstance(ob, Rows):
        ob = ob.fields(OB_FIELDS)
    if second is not None and isinstance(second[0], Rows):
        second = (second[0].fields(OB_FIELDS), *second[1:])
    E, IN = p.E, p.IN
    dev = perm.device
    live = torch.arange(E, device=dev)[None, :] >= state["head"][:, None]
    cols = {"t": [torch.where(live, state["ht"], INF)],
            "k": [torch.where(live, state["hk"], IMAX)],
            "m": [state["hm"]], "v": [state["hv"]], "w": [state["hw"]]}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    over_in, cnts = 0, []
    for rows, pm, st, cnt in [(ob, perm, starts, counts)] + \
            ([second] if second is not None else []):
        # arrival windows: sorted rows starts[h] .. starts[h]+min(count, IN)
        F = pm.shape[0]
        idx = st[:, None] + torch.arange(IN, device=dev)
        ok = torch.arange(IN, device=dev)[None, :] < \
            cnt.clamp(max=IN)[:, None]
        pidx = pm[idx.clamp(0, F - 1)]
        flat = {f: rows[f].reshape(-1)[pidx] for f in OB_FIELDS}
        fm, fs, fv = (torch.where(ok, flat[f], zero) for f in ("m", "s", "v"))
        cols["t"].append(torch.where(ok, flat["t"], INF))
        cols["k"].append(torch.where(ok, flat["k"], IMAX))
        cols["m"].append(pack2(lo32(fm) & 0xFF, hi32(fs)))
        cols["v"].append(pack2(lo32(fs), lo32(fv)))
        cols["w"].append((fv >> 32) & U32)
        over_in = over_in + (cnt - IN).clamp(min=0)
        cnts.append(cnt)
    ct, ck = torch.cat(cols["t"], 1), torch.cat(cols["k"], 1)
    # lexicographic (t, k) with column order among ties: stable sort by
    # the secondary key, then stable sort by the primary
    _, o1 = torch.sort(ck, dim=1, stable=True)
    _, o2 = torch.sort(ct.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)
    st = ct.gather(1, order)
    keep = order[:, :E]
    over_e = (st[:, E:] < INF).sum(-1)
    state["overflow"] += (over_in + over_e).to(torch.int32)
    occ = cnts[0] if len(cnts) == 1 else (
        cnts[0] + cnts[1] if occ_sum else torch.maximum(*cnts))
    state["occ_in"].copy_(torch.maximum(state["occ_in"],
                                        occ.to(torch.int32)))
    new = {"ht": st[:, :E], "hk": ck.gather(1, keep),
           "hm": torch.cat(cols["m"], 1).gather(1, keep),
           "hv": torch.cat(cols["v"], 1).gather(1, keep),
           "hw": torch.cat(cols["w"], 1).gather(1, keep)}
    for f in HEAP_FIELDS:
        state[f].copy_(new[f])
    state["head"].zero_()
    state["occ_heap"].copy_(torch.maximum(
        state["occ_heap"], (state["ht"] < INF).sum(-1).to(torch.int32)))


# ----------------------------------------------------------------------
# the cross-shard exchange (reference: engine.py:1635-1931)
# ----------------------------------------------------------------------
class Rows:
    """The rows a route, a pack or the merge reads: one or two regions,
    each either an outbox (a dict of [(R,)H,OB] field tensors, its rows
    the flat index h*OB + column) or a wire buffer [nb, C, bw] int64 of
    nb blocks of bw rows, channel c of block b at [b, c] (XCH_FIELDS
    order, C = 5 without keys); a campaign's wire buffer is [nb, R, C,
    bw], replica r's rows at [:, r] (any strides but a unit last one: the
    gathered outboxes of all_gather are a permuted view). Row i of the
    second region is row n_a + i of the whole."""

    def __init__(self, *regions):
        if not 1 <= len(regions) <= 2:
            raise ValueError("Rows: one or two regions")
        self.regions = regions

    @staticmethod
    def _n(region) -> int:
        if isinstance(region, dict):
            return int(region["t"].shape[-2] * region["t"].shape[-1])
        return int(region.shape[0] * region.shape[-1])

    @staticmethod
    def _replicas(region) -> Optional[int]:
        if isinstance(region, dict):
            return ob_replicas(region)
        return int(region.shape[1]) if region.dim() == 4 else None

    @property
    def replicas(self) -> Optional[int]:
        """R of a campaign's rows, None for a standalone run's."""
        reps = {self._replicas(r) for r in self.regions}
        if len(reps) != 1:
            raise ValueError("Rows: regions of different replica counts")
        return reps.pop()

    def at(self, r: int) -> "Rows":
        """Replica r's rows, in the standalone layout (views)."""
        return Rows(*(at_replica(x, r) if isinstance(x, dict) else x[:, r]
                      for x in self.regions))

    @property
    def n(self) -> int:
        """Rows of one replica."""
        return sum(self._n(r) for r in self.regions)

    @property
    def device(self) -> torch.device:
        r = self.regions[0]
        return (r["t"] if isinstance(r, dict) else r).device

    def fields(self, names=XCH_FIELDS) -> dict:
        """Flat [n] tensors of the named channels over both regions (a
        copy where a region is a wire buffer); None for a channel a
        region lacks."""
        out = {}
        for f in names:
            parts = []
            for r in self.regions:
                if isinstance(r, dict):
                    parts.append(r[f].reshape(-1) if f in r else None)
                else:
                    c = XCH_FIELDS.index(f)
                    parts.append(r[:, c].reshape(-1) if c < r.shape[1]
                                 else None)
            out[f] = (None if any(x is None for x in parts)
                      else parts[0] if len(parts) == 1
                      else torch.cat(parts))
        return out


def route_rows_plain(rows: Rows, lo: int, nd: int, keyed: bool = False):
    """Group the exchangeable rows (t < DROP_T) whose destination lies
    in [lo, lo + nd) by destination, (perm [n], starts [nd], counts
    [nd]) int64 as route_plain gives them: within a destination by row
    position or, `keyed`, by the row's key channel. perm's first
    counts.sum() entries are the grouped rows' indices; the rest are
    0. A campaign's rows give each replica's, stacked ([R, n], [R, nd],
    [R, nd])."""
    if rows.replicas is not None:
        return tuple(torch.stack(x) for x in zip(*(
            route_rows_plain(rows.at(r), lo, nd, keyed)
            for r in range(rows.replicas))))
    f = rows.fields(("t", "m", "key") if keyed else ("t", "m"))
    t, m = f["t"], f["m"]
    dev = t.device
    n = t.shape[0]
    d = hi32(m).long() - lo
    live = (t < DROP_T) & (d >= 0) & (d < nd)
    idx = torch.nonzero(live).view(-1)
    if keyed:
        idx = idx[torch.sort(f["key"][idx], stable=True).indices]
    idx = idx[torch.sort(d[idx], stable=True).indices]
    perm = torch.zeros(n, dtype=torch.int64, device=dev)
    perm[:idx.shape[0]] = idx
    counts = torch.bincount(d[live], minlength=nd)[:nd]
    return perm, counts.cumsum(0) - counts, counts


def _segments(starts: torch.Tensor, counts: torch.Tensor, S: int):
    """(start, count) of each destination shard's segment of a route
    over S*H_loc destinations."""
    st = starts.view(S, -1)[:, 0]
    return st, counts.view(S, -1).sum(1)


def _wire(rows: dict, pidx: torch.Tensor, ok: torch.Tensor,
          C: int) -> torch.Tensor:
    """[..., C, w] int64 of the rows at `pidx` where `ok`, the
    reference's fills elsewhere (t INF, k and key IMAX, the rest 0)."""
    chans = []
    for f in XCH_FIELDS[:C]:
        fill = INF if f == "t" else IMAX if f in ("k", "key") else 0
        chans.append(torch.where(ok, rows[f][pidx], fill))
    return torch.stack(chans, dim=-2)


def _flat_keys(ob_rows: dict, mesh: "MeshParams", OB: int) -> dict:
    """The outbox rows' channels with the key of each: dst*SPAN +
    (g0*OB + flat index), SPAN = H_pad*OB (engine.py:573, 1292-1297)."""
    n = ob_rows["t"].shape[0]
    flat = torch.arange(n, dtype=torch.int64, device=ob_rows["t"].device)
    key = hi32(ob_rows["m"]).long() * (mesh.H_pad * OB) + \
        mesh.g0 * OB + flat
    return {**ob_rows, "key": key}


def _replica_packs(state: dict, ob: dict, ctl, run) -> bool:
    """A campaign's pack (its outbox [R, H, OB]), each replica that runs
    in turn: run(r, replica r's state) where the control block `ctl`
    ([R, CTL_N] or None) runs replica r; False for a standalone outbox
    (the caller packs it)."""
    R = ob_replicas(ob)
    if R is None:
        return False
    for r in range(R):
        if not _phase_off(_ctl_at(ctl, r)):
            run(r, at_replica(state, r))
    return True


def pack_remote_plain(state: dict, ob: dict, perm: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      mesh: MeshParams, send: torch.Tensor,
                      ctl: Optional[torch.Tensor] = None) -> None:
    """K12 (`_shard_segments`, `_within_shard_rank`, `_lost_to_local`,
    `_seg_take`, `_pack_remote`): from the outbox's route over the H_pad
    destinations, write shard s's first CAP rows into send[s] ([S, C,
    CAP], XCH_FIELDS order), the fills past them; the self shard ships
    nothing. Raise occ_x [1, S] to each remote segment's count and add
    every remote row ranked CAP or later to its sender's x_overflow.
    A campaign's replica r packs into send[:, r] of [S, R, C, CAP] from
    its own outbox and route, where its control block runs."""
    if _replica_packs(state, ob, ctl, lambda r, st: pack_remote_plain(
            st, at_replica(ob, r), perm[r], starts[r], counts[r], mesh,
            send[:, r])):
        return
    S, C, CAP = send.shape
    OB = ob["t"].shape[-1]
    rows = _flat_keys({f: ob[f].reshape(-1) for f in OB_FIELDS}, mesh, OB)
    st, cnt = _segments(starts, counts, S)
    cnt = torch.where(torch.arange(S, device=cnt.device) == mesh.shard,
                      0, cnt)
    state["occ_x"].copy_(torch.maximum(state["occ_x"],
                                       cnt.to(torch.int32)[None, :]))
    j = torch.arange(CAP, device=st.device)
    pidx = perm[(st[:, None] + j).clamp(0, perm.shape[0] - 1)]
    send.copy_(_wire(rows, pidx, j < cnt.clamp(max=CAP)[:, None], C))
    for d in range(S):
        n = int(cnt[d])
        if n > CAP:
            lost = perm[int(st[d]) + CAP:int(st[d]) + n] // OB
            state["x_overflow"].index_add_(
                0, lost, torch.ones_like(lost, dtype=torch.int32))


def _rank_lists(mesh: MeshParams, cnt: torch.Tensor):
    """two_phase's phase-1 offsets: (off2 [ng, g], tot [g]): the
    exclusive per-group offsets of each destination rank's rows in a
    peer buffer, and each rank's total (engine.py:1758-1762)."""
    c2 = cnt.view(mesh.NG, mesh.G)
    ends = c2.cumsum(0)
    return ends - c2, ends[-1]


def pack_two_phase_plain(state: dict, ob: dict, perm: torch.Tensor,
                         starts: torch.Tensor, counts: torch.Tensor,
                         mesh: MeshParams, send: torch.Tensor,
                         ctl: Optional[torch.Tensor] = None) -> None:
    """K13's first half (`_pack_two_phase` to the phase-1 ppermutes,
    `_tp_mask`): send[b] ([g, 6, CAP]) holds the rows destined the
    in-group peer of rank b, (a, b) for this rank's group a (the
    reference's buffer of peer offset (b - my_b) % g): the rows of each
    destination shard (a', b), a' = 0..ng-1 in turn, cut at CAP. Rows
    whose place in their buffer is CAP or later count into their
    sender's x_overflow; occ_x as K12's. A campaign's replica r packs
    into send[:, r] of [g, R, 6, CAP], as K12's."""
    if _replica_packs(state, ob, ctl, lambda r, st: pack_two_phase_plain(
            st, at_replica(ob, r), perm[r], starts[r], counts[r], mesh,
            send[:, r])):
        return
    g, ng = mesh.G, mesh.NG
    OB = ob["t"].shape[-1]
    S, CAP = mesh.S, send.shape[-1]
    rows = _flat_keys({f: ob[f].reshape(-1) for f in OB_FIELDS}, mesh, OB)
    st, cnt = _segments(starts, counts, S)
    cnt = torch.where(torch.arange(S, device=cnt.device) == mesh.shard,
                      0, cnt)
    state["occ_x"].copy_(torch.maximum(state["occ_x"],
                                       cnt.to(torch.int32)[None, :]))
    off2, tot = _rank_lists(mesh, cnt)
    my_b = mesh.shard % g
    for d in range(S):
        n = int(cnt[d])
        first = max(0, CAP - int(off2[d // g, d % g]))
        if n > first:
            lost = perm[int(st[d]) + first:int(st[d]) + n] // OB
            state["x_overflow"].index_add_(
                0, lost, torch.ones_like(lost, dtype=torch.int32))
    j = torch.arange(CAP, device=st.device)
    for b in range(g):
        ends = off2[:, b] + cnt.view(ng, g)[:, b]
        a = (ends[None, :] <= j[:, None]).sum(-1).clamp(max=ng - 1)
        src = st.view(ng, g)[a, b] + (j - off2[a, b])
        pidx = perm[src.clamp(0, perm.shape[0] - 1)]
        send[b].copy_(_wire(rows, pidx, j < tot[b], 6))


def pack_two_phase2_plain(rows: Rows, perm: torch.Tensor,
                          starts: torch.Tensor, counts: torch.Tensor,
                          mesh: MeshParams, OB: int, send: torch.Tensor,
                          hist: torch.Tensor,
                          ctl: Optional[torch.Tensor] = None) -> None:
    """K13's second half (`_pack_two_phase` from the phase-1 arrivals'
    key sort to the phase-2 ppermutes): from the keyed route of the
    phase-1 arrivals over the H_pad destinations, send ([ng-1, 6, CAP2])
    holds for each other group a', in ascending order, the first CAP2
    rows destined shard (a', b), b this rank's rank (the reference's
    buffer of group offset (a' - my_g) % ng); every row of another
    shard ranked CAP2 or later adds 1 at its global source, (key %
    SPAN) // OB, to hist [H_pad] int32 (the mesh sums it and each rank
    adds its own hosts' counts to x_overflow). A campaign's replica r
    packs its arrivals into send[:, r] of [ng-1, R, 6, CAP2] and counts
    into hist[r] of [R, H_pad], where its control block runs."""
    if rows.replicas is not None:
        for r in range(rows.replicas):
            if not _phase_off(_ctl_at(ctl, r)):
                pack_two_phase2_plain(rows.at(r), perm[r], starts[r],
                                      counts[r], mesh, OB, send[:, r],
                                      hist[r])
        return
    g, ng, S = mesh.G, mesh.NG, mesh.S
    CAP2 = send.shape[-1]
    f = rows.fields()
    st, cnt = _segments(starts, counts, S)
    j = torch.arange(CAP2, device=st.device)
    my_g, my_b = divmod(mesh.shard, g)
    for i, a in enumerate(x for x in range(ng) if x != my_g):
        dq = a * g + my_b
        pidx = perm[(st[dq] + j).clamp(0, perm.shape[0] - 1)]
        send[i].copy_(_wire(f, pidx, j < cnt[dq].clamp(max=CAP2), 6))
    span = mesh.H_pad * OB
    for d in range(S):
        n = int(cnt[d])
        if d != mesh.shard and n > CAP2:
            lost = (f["key"][perm[int(st[d]) + CAP2:int(st[d]) + n]]
                    % span) // OB
            hist.index_add_(0, lost, torch.ones_like(lost,
                                                     dtype=torch.int32))


# ----------------------------------------------------------------------
# the phase's tallies (reference: engine.py:1941-1951, 2135-2136)
# ----------------------------------------------------------------------
def phase_tally_plain(state: dict, ob: dict, pops: torch.Tensor,
                      p: PhaseParams,
                      ctl: Optional[torch.Tensor] = None) -> None:
    """After the judge: `occ_trips` takes the largest pop count,
    `occ_ob` each host's count of exchangeable rows (t < DROP_T),
    `occ_phases` one more phase and, under the audit, `aud_tx` those
    rows. Nothing where the control block says the phase does not
    run. A campaign's state tallies each replica in turn."""
    if pops.dim() == 2:
        for r in range(pops.shape[0]):
            phase_tally_plain(at_replica(state, r), at_replica(ob, r),
                              pops[r], p, _ctl_at(ctl, r))
        return
    if _phase_off(ctl):
        return
    n = (ob["t"] < DROP_T).sum(-1).to(torch.int32)
    state["occ_trips"].copy_(torch.maximum(state["occ_trips"],
                                           pops.max().view(1)))
    state["occ_ob"].copy_(torch.maximum(state["occ_ob"], n))
    state["occ_phases"] += 1
    if p.AUD:
        state["aud_tx"] += n.long()


# ----------------------------------------------------------------------
# K8: the audit's health word (reference: engine._audit_round)
# ----------------------------------------------------------------------
def audit_round_plain(state: dict,
                      ctl: Optional[torch.Tensor] = None,
                      balance: Optional[torch.Tensor] = None) -> None:
    """OR into each host's `aud`: AUD_HEAP where its heap rows are out
    of (t, key) order or head lies outside [0, E], AUD_COUNTER where one
    of AUD_COUNTERS is negative, and on every host AUD_CONSERVE where
    the int64 balance sum(aud_tx) - (sum(n_exec) + live rows +
    sum(overflow) + sum(x_overflow)) is not 0. Under the window loop
    only where the control block's `round_end` word is set. A campaign's
    state audits each replica in turn, its balance its own.

    On a mesh rank (`balance`, an [R or 1] int64 tensor) the balance is
    the mesh's: the rank's own is written into `balance` and decides
    nothing; the mesh sums the word and `audit_conserve_plain` takes
    the decision on the sum."""
    if n_replicas(state) is not None:
        for r in range(n_replicas(state)):
            audit_round_plain(at_replica(state, r), _ctl_at(ctl, r),
                              None if balance is None else balance[r:r + 1])
        return
    if ctl is not None and not int(ctl[CTL["round_end"]]):
        return
    head, ht, hk = state["head"], state["ht"], state["hk"]
    E = ht.shape[1]
    ok = ((ht[:, :-1] < ht[:, 1:])
          | ((ht[:, :-1] == ht[:, 1:]) & (hk[:, :-1] <= hk[:, 1:]))).all(-1)
    ok = ok & (head >= 0) & (head <= E)
    neg = torch.zeros_like(ok)
    for key in AUD_COUNTERS:
        neg = neg | (state[key] < 0)
    slot = torch.arange(E, device=ht.device)[None, :]
    live = ((slot >= head[:, None]) & (ht < INF)).sum()
    diff = state["aud_tx"].sum() - (
        state["n_exec"].long().sum() + live
        + state["overflow"].long().sum() + state["x_overflow"].long().sum())
    aud = state["aud"] | torch.where(ok, 0, AUD_HEAP).to(torch.int32)
    aud = aud | torch.where(neg, AUD_COUNTER, 0).to(torch.int32)
    if balance is not None:
        balance.fill_(diff)
    elif int(diff) != 0:
        aud = aud | AUD_CONSERVE
    state["aud"].copy_(aud)


def audit_conserve_plain(state: dict, total: torch.Tensor,
                         ctl: Optional[torch.Tensor] = None) -> None:
    """A mesh rank's conserve pass: AUD_CONSERVE into every host of a
    replica whose balance summed over the ranks, `total` [R or 1], is
    not 0 (under the window loop only where `round_end` is set)."""
    if n_replicas(state) is not None:
        for r in range(n_replicas(state)):
            audit_conserve_plain(at_replica(state, r), total[r:r + 1],
                                 _ctl_at(ctl, r))
        return
    if ctl is not None and not int(ctl[CTL["round_end"]]):
        return
    if int(total.view(-1)[0]) != 0:
        state["aud"] |= AUD_CONSERVE


# ----------------------------------------------------------------------
# K9: the window loop's control step (reference: _run_shard, _round)
# ----------------------------------------------------------------------
def loop_control_plain(state: dict, ctl: torch.Tensor,
                       start: bool = False) -> None:
    """One control step on the block `ctl` after a phase (or, with
    `start`, before the first): with nxt the minimum head time, the
    window goes on where nxt < win_end; else the round ends (rounds +1,
    round_end set), and the loop is done where nxt >= stop or rounds
    reached max_rounds, else the next window ends at min(nxt +
    lookahead, final_stop). `run` says whether the next phase runs;
    once done the step only clears `run` and `round_end`. A campaign's
    blocks [R, CTL_N] step each replica on its own block."""
    if ctl.dim() == 2:
        for r in range(ctl.shape[0]):
            loop_control_plain(at_replica(state, r), ctl[r], start)
        return
    words = [int(w) for w in ctl.tolist()]
    nxt = None if words[CTL["done"]] else int(head_min_plain(state))
    ctl.copy_(torch.tensor(control_step(words, nxt, start),
                           dtype=torch.int64))


def control_step(words: list, nxt: Optional[int],
                 start: bool = False) -> list:
    """K9's decisions on one control block's words (a list in
    CTL_FIELDS order) given the minimum head time `nxt` (None once the
    block is done, which only clears `run` and `round_end`); returns
    the new words. The Python window loop takes them on the host."""
    c = dict(zip(CTL_FIELDS, words))
    if c["done"]:
        c.update(run=0, round_end=0)
        return [c[n] for n in CTL_FIELDS]
    c.update(nxt=nxt, round_end=0)
    if not start:
        c["phases"] += 1
        if nxt < c["win_end"]:
            c["run"] = 1
            nxt = None
        else:
            c.update(rounds=c["rounds"] + 1, round_end=1)
    if nxt is not None:
        if nxt >= c["stop"] or c["rounds"] >= c["max_rounds"]:
            c.update(done=1, run=0)
        else:
            c.update(win_end=min(nxt + c["lookahead"], c["final_stop"]),
                     run=1)
    return [c[n] for n in CTL_FIELDS]


# ----------------------------------------------------------------------
# build and binding
# ----------------------------------------------------------------------
def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return str(path)


def toolkit_version() -> str:
    """The CUDA toolkit's release line, as `nvcc --version` gives it."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return next((line.strip() for line in out.splitlines()
                 if "release" in line), out.strip())


def build_library(ptxas_verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/*.cu into one shared library with a plain C
    interface under BUILD_DIR: one nvcc per source, all started
    together, then one link. The file name carries a hash of the
    sources and flags, so an existing library is reused only when it
    matches. Returns (path, compiler output)."""
    build_dir = BUILD_DIR
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + src.read_bytes())
    lib = build_dir / f"libshadow_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists() and not ptxas_verbose:
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = build_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for o, pr in jobs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
                o.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {obj.stem}:\n{out}")
    tmp = build_dir / f"{lib.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for o, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib, "".join(log)


class TopoArgs(ctypes.Structure):
    """csrc/topo.cuh `TopoArgs`: which view of the path tables a kernel
    reads, its epoch count and start times, its tables (the other
    view's pointers null) and each table's replica stride in elements
    (0 for a leaf every replica shares)."""
    _fields_ = [("hier", ctypes.c_int), ("V", ctypes.c_int),
                ("C", ctypes.c_int), ("T", ctypes.c_int)] + [
        (name, ctypes.c_void_p) for name in (
            "epoch_times", "lat", "rel", "core_lat", "core_rel", "cl",
            "acc_lat", "acc_rel", "self_lat", "self_rel")] + [
        (name, ctypes.c_longlong) for name in (
            "rs_ept", "rs_tab", "rs_core", "rs_acc", "rs_self")]


def topo_args(world: dict, R: int = 1):
    """(hier, epochs, TopoArgs, [(tensor, dtype)] to check) for the
    world's path tables, read by a launch over R replicas: a standalone
    world's tables serve one replica, a campaign world's stack R (one
    cl per campaign); raises on tables of the wrong shape."""
    lat, rel, ept = world["lat"], world["rel"], world["epoch_times"]
    i32, f32 = torch.int32, torch.float32
    Rw = world_replicas(world)
    if (Rw or 1) != R:
        raise ValueError(f"a launch over {R} replica(s) needs a world of "
                         f"as many, not {Rw or 1}")
    rlead = (R,) if Rw else ()
    T = ept.shape[-1]
    lead = (*rlead, T) if T > 1 else rlead
    checks = [(ept, torch.int64)]

    def stride(t):
        # elements of one replica's leaf; 0 where all share it
        return t.numel() // R if Rw else 0

    if isinstance(lat, tuple):
        cc, cl, acc, slf = lat
        ccr, cl_r, accr, slfr = rel
        V, C = cl.shape[0], cc.shape[-1]
        if (cl_r is not cl or cl.shape != (V,)
                or cc.shape != (*lead, C, C) or ccr.shape != cc.shape
                or any(t.shape != (*lead, V)
                       for t in (acc, slf, accr, slfr))):
            raise ValueError("factored tables: need [C,C] cluster pairs, "
                             "[V] access/self vectors (each with the "
                             "[T] epoch axis under faults, and the [R] "
                             "replica axis in a campaign) and one "
                             "shared [V] cl")
        args = TopoArgs(1, V, C, T, _ptr(ept), None, None,
                        *map(_ptr, (cc, ccr, cl, acc, accr, slf, slfr)),
                        stride(ept), 0, stride(cc), stride(acc),
                        stride(slf))
        return True, T > 1, args, checks + \
            [(t, i32) for t in (cc, cl, acc, slf)] + \
            [(t, f32) for t in (ccr, accr, slfr)]
    V = lat.shape[-1]
    if lat.shape != (*lead, V, V) or rel.shape != lat.shape:
        raise ValueError("dense tables: need [V,V] latency and "
                         "reliability ([T,V,V] under faults, with the "
                         "[R] replica axis in a campaign)")
    args = TopoArgs(0, V, 0, T, _ptr(ept), _ptr(lat), _ptr(rel),
                    None, None, None, None, None, None, None,
                    stride(ept), stride(lat), 0, 0, 0)
    return False, T > 1, args, checks + [(lat, i32), (rel, f32)]


class JudgeArgs(ctypes.Structure):
    """csrc/judge_batch.cu `JudgeArgs`: K10's tables on the card, as
    `judge_tables` builds them (the other view's pointers null)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "H", "hier", "V", "C", "T")] + [
        (name, ctypes.c_void_p) for name in (
            "epoch_times", "seed_key", "keys", "host_vertex", "lat",
            "rel", "records", "access", "core", "self_lat", "self_rel")]


@dataclass
class JudgeTables:
    """K10's tables for one standalone world, built once
    (`judge_tables`): the world itself (the plain version and the
    design before read it); the drop keys, [H, 2] int32 (`drop_keys`);
    on factored tables the int32 host records, [H, 4] {vertex, cluster,
    acc_lat, acc_rel bits} on one epoch, [H, 2] {vertex, cluster} under
    epochs, with the access pair packed [T, V, 2] under epochs and the
    core pair packed [(T,) C, C, 2] (float words as their int32 bits);
    the launch name; on the card the `JudgeArgs` pointing at them,
    checked once."""
    world: dict
    keys: torch.Tensor
    records: Optional[torch.Tensor]
    access: Optional[torch.Tensor]
    core: Optional[torch.Tensor]
    name: str
    args: Optional[JudgeArgs]


def drop_keys(seed_key: torch.Tensor, H: int) -> torch.Tensor:
    """[H, 2] int32 (u32 words as their bits): purpose_id_key(seed,
    PURPOSE_PACKET_DROP, h) of every host h < H under the [1, 2] seed
    key, by the numpy chain of utils/nprng.py."""
    k = [int(x) for x in seed_key.reshape(-1)[:2].tolist()]
    key = nprng.fold_in(nprng.fold_in(
        (np.uint32(k[0]), np.uint32(k[1])), PURPOSE_PACKET_DROP),
        np.arange(H, dtype=np.uint32))
    return torch.from_numpy(np.stack(key, 1).view(np.int32).copy())


def judge_tables(world: dict) -> JudgeTables:
    """K10's `JudgeTables` for a standalone world (host_vertex, the
    path tables, epoch_times, the [1, 2] seed_key), on the world's
    device; raises on tables of the wrong shape or type."""
    hier, epochs, _, checks = topo_args(world, 1)
    hv = world["host_vertex"]
    dev = hv.device
    H = hv.shape[0]
    keys = drop_keys(world["seed_key"], H).to(dev)
    records = access = core = None
    lat, rel = world["lat"], world["rel"]
    if hier:
        cc, cl, acc, _ = lat
        ccr, _, accr, _ = rel
        v = hv.long()
        if epochs:
            records = torch.stack([hv, cl[v]], 1)
            access = torch.stack([acc, accr.view(torch.int32)],
                                 -1).contiguous()
        else:
            records = torch.stack(
                [hv, cl[v], acc[v], accr.view(torch.int32)[v]], 1)
        core = torch.stack([cc, ccr.view(torch.int32)], -1).contiguous()
        V, C = cl.shape[0], cc.shape[-1]
    else:
        V, C = lat.shape[-1], 0
    name = launch_name("judge_batch", False, epochs, hier)
    args = None
    if dev.type == "cuda":
        seed = world["seed_key"]
        if seed.shape != (1, 2):
            raise ValueError("judge_tables: the seed key is [1, 2]")
        built = [t for t in (keys, records, access, core)
                 if t is not None]
        _check_tensors(name, checks + [(hv, torch.int32),
                                       (seed, torch.int64)]
                       + [(t, torch.int32) for t in built])
        ptr = (lambda t: None if t is None else _ptr(t))
        args = JudgeArgs(
            H, int(hier), V, C, int(world["epoch_times"].shape[0]),
            _ptr(world["epoch_times"]), _ptr(seed), _ptr(keys), _ptr(hv),
            None if hier else _ptr(lat), None if hier else _ptr(rel),
            ptr(records), ptr(access), ptr(core),
            _ptr(lat[3]) if hier else None,
            _ptr(rel[3]) if hier else None)
    return JudgeTables(world, keys, records, access, core, name, args)


class NicArgs(ctypes.Structure):
    """csrc/pop_phase.cu `NicArgs`: the model NIC's leaves, bandwidths
    and law table, the counters the in-step judge adds to and the
    path-counter flag; all null with mb = 0."""
    _fields_ = [("mb", ctypes.c_int), ("cp", ctypes.c_int),
                ("boot_end", ctypes.c_longlong)] + [
        (name, ctypes.c_void_p) for name in (
            *NIC_KEYS, "bw_up", "bw_down", "law", "n_sent", "n_drop")]


def nic_args(state: dict, world: dict, p: PhaseParams):
    """(NicArgs, [(tensor, dtype)] to check) of a pop launch. The
    bandwidth columns are the world's, one entry a host of host_vertex
    (on a mesh rank the H_pad hosts: the kernel reads a host's at its
    global id)."""
    if not p.MB:
        return NicArgs(0), []
    leaves = [state[k] for k in NIC_KEYS]
    tables = [world["bw_up"], world["bw_down"], world["law"]]
    counts = [state["n_sent"], state["n_drop"]]
    rows = tuple(state["head"].shape)
    Hg = world["host_vertex"].shape[-1]
    if any(t.shape != rows for t in leaves + counts) or \
            any(t.shape != (Hg,) for t in tables[:2]) or \
            tables[2].shape != (LAW_SIZE,) or p.g0 + rows[-1] > Hg:
        raise ValueError("model NIC: need [(R,)H] leaves and counters, "
                         "the world's [H] (a mesh's [H_pad]) bandwidths "
                         "and the [1024] law table")
    args = NicArgs(1, int(p.CP), int(p.boot_end),
                   *map(_ptr, leaves + tables + counts))
    return args, [(t, torch.int64) for t in leaves + tables] + \
        [(t, torch.int32) for t in counts]


class RowsArgs(ctypes.Structure):
    """csrc/common.cuh `Rows`: the channels of one or two regions of
    rows, each a base per channel (XCH_FIELDS order; null where a region
    lacks one), its block width and the stride between its blocks (0:
    one block, an outbox), the first region's row count, and each
    region's replica stride (0: one replica)."""
    _fields_ = [("a", ctypes.c_void_p * 6), ("n_a", ctypes.c_longlong),
                ("bw_a", ctypes.c_longlong), ("bs_a", ctypes.c_longlong),
                ("b", ctypes.c_void_p * 6), ("bw_b", ctypes.c_longlong),
                ("bs_b", ctypes.c_longlong), ("rs", ctypes.c_longlong),
                ("rs_b", ctypes.c_longlong)]


def rows_args(rows: Rows, need=XCH_FIELDS[:5]):
    """(RowsArgs, [(tensor, dtype)] to check) of a kernel launch over
    `rows`; raises where a region lacks a channel in `need`. A wire
    region's strides are its tensor's own ([nb, (R,) C, bw], unit
    stride along a block)."""
    ptrs, dims, checks = [], [], []
    for r in rows.regions:
        if isinstance(r, dict):
            t = r["t"]
            base = [_ptr(r[f]) if f in r else None for f in XCH_FIELDS]
            n = int(t.shape[-2] * t.shape[-1])
            dims.append((n, n, 0, n if t.dim() == 3 else 0))
            checks += [(r[f], torch.int64) for f in XCH_FIELDS if f in r]
        else:
            w = r if r.dim() == 4 else r.unsqueeze(1)
            nb, R, C, bw = w.shape
            if w.stride(-1) != 1:
                raise ValueError("rows: a wire region needs a unit stride "
                                 "along its blocks")
            step = w.stride(2) * w.element_size()
            base = [w.data_ptr() + c * step if c < C else None
                    for c in range(len(XCH_FIELDS))]
            dims.append((nb * bw, bw, w.stride(0),
                         w.stride(1) if r.dim() == 4 else 0))
            # dtype and device of the buffer (a view of it may not be
            # contiguous: all_gather's permuted outboxes)
            checks.append((r if r.is_contiguous() else w[0, 0, 0],
                           torch.int64))
        missing = [f for f, b in zip(XCH_FIELDS, base)
                   if b is None and f in need]
        if missing:
            raise ValueError(f"rows lack channel(s) {missing}")
        ptrs.append(base)
    vp = ctypes.c_void_p * 6
    b = ptrs[1] if len(ptrs) > 1 else [None] * 6
    bdim = dims[1] if len(dims) > 1 else (0, 1, 0, 0)
    return RowsArgs(vp(*ptrs[0]), dims[0][0], dims[0][1], dims[0][2],
                    vp(*b), bdim[1], bdim[2], dims[0][3], bdim[3]), checks


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_T = ctypes.POINTER(TopoArgs)
_N = ctypes.POINTER(NicArgs)
_RW = ctypes.POINTER(RowsArgs)
_J = ctypes.POINTER(JudgeArgs)

_POP_TAIL = [_P] * 5 + [_P] * 5 + [_P]     # ob t k m s v, pops
#                                          ob_word aud aud_t ctl, stream
# Every kernel's first argument is R, the replica count (1 standalone).
_SIGNATURES = {
    # R, H, E, K, B, ht hk hm hv hw, head event_seq packet_seq app_seq
    # app n_exec n_deliv chk, host_vertex topo nic, seed keys, n_total
    # msgload size selfloop, ob t k m s v, pops, ob_word, aud aud_t,
    # ctl, stream
    "shadow_pop_phase": [_I] * 5 + [_P] * 5 + [_P] * 8 +
                        [_P, _T, _N, _P, _I, _I, _I, _I] + _POP_TAIL,
    # the entries of POP_KERNELS take the gid offset g0 and the global
    # host count (host_vertex's length) after R
    # R, H, E, K, T, P, B, C, ht hk hm hv hw, head event_seq packet_seq
    # app n_exec n_deliv chk, host_vertex topo nic, seed keys, count
    # pause retry, npkts last_sz chunk mss, ob t k m s v, pops, ob_word,
    # aud aud_t, ctl, stream
    "shadow_pop_tgen": [_I] * 8 + [_P] * 5 + [_P] * 7 +
                       [_P, _T, _N, _P] + [_P] * 3 + [_I] * 4 + _POP_TAIL,
    # R, H, E, K, T, P, B, C, ht hk hm hv hw, head event_seq packet_seq
    # app n_exec n_deliv chk, host_vertex topo nic, seed keys, count
    # pause retry, relay_gids n_relays, route key k1 k2, cells, ob t k
    # m s v, pops, ob_word, aud aud_t, ctl, stream
    "shadow_pop_tor": [_I] * 8 + [_P] * 5 + [_P] * 7 +
                      [_P, _T, _N, _P] + [_P] * 3 +
                      [_P, _I, _U, _U, _I] + _POP_TAIL,
    # R, H, OB, C, boot_end, ob t m v, packet_seq n_sent n_drop,
    # host_vertex topo, seed keys, cp, g0, Hg, pops, ob_word, work,
    # listed, ctl, stream
    "shadow_judge_outbox": [_I, _I, _I, _I, _L] + [_P] * 3 + [_P] * 3 +
                           [_P, _T, _P, _I, _I, _I, _P, _P, _P, _I, _P,
                            _P],
    # R, H, Hv (host_vertex's hosts), OB, V, ob t k m, host_vertex,
    # path_cnt, ctl, pops, ob_word, gated_rows, every_row, stream
    "shadow_count_paths": [_I] * 5 + [_P] * 3 + [_P] * 5 + [_I, _I, _P],
    # R, F, ND, lo, keyed, rows, perm starts counts, work, words, ctl,
    # stream
    "shadow_route": [_I, _L, _I, _I, _I, _RW] + [_P] * 3 + [_P, _L] +
                    [_P] * 2,
    # R, H, E, IN, ht hk hm hv hw head, rows perm starts counts (F),
    # second rows perm starts counts (F2; null rows: one block) and
    # their replica stride, occ_sum, overflow occ_in occ_heap, ctl,
    # flags, work, stream
    "shadow_merge_heaps": [_I] * 4 + [_P] * 6 + [_RW] + [_P] * 3 + [_L] +
                          [_RW] + [_P] * 3 + [_L, _L] + [_I] + [_P] * 3 +
                          [_P] * 4,
    # R, F, S, shard, H_loc, OB, CAP, C, rows, perm starts counts, send,
    # x_overflow occ_x, ctl, stream
    "shadow_pack_remote": [_I, _L] + [_I] * 6 + [_RW] + [_P] * 3 +
                          [_P] * 3 + [_P, _P],
    # R, F, S, shard, H_loc, OB, G, NG, CAP, rows, perm starts counts,
    # send, x_overflow occ_x, filled tickets, before, ctl, stream
    "shadow_pack_two_phase": [_I, _L] + [_I] * 7 + [_RW] + [_P] * 3 +
                             [_P] * 3 + [_P] * 2 + [_I, _P, _P],
    # R, F, S, shard, H_loc, OB, G, NG, CAP2, rows, perm starts counts,
    # send, hist, filled tickets, before, ctl, stream
    "shadow_pack_two_phase2": [_I, _L] + [_I] * 7 + [_RW] + [_P] * 3 +
                              [_P] * 2 + [_P] * 2 + [_I, _P, _P],
    # R, H, OB, ob t, pops, occ_ob occ_trips occ_phases, aud_tx, ctl,
    # ob_word, partial tickets, every_row, stream
    "shadow_phase_tally": [_I] * 3 + [_P] * 7 + [_P] * 3 + [_I, _P],
    # R, H, E, ht hk head, n_exec n_sent n_drop n_deliv event_seq
    # packet_seq app_seq overflow x_overflow, aud_tx aud, sum (the
    # design before), partial tickets, ctl, warp_per_host, balance (a
    # mesh rank's, else null), stream
    "shadow_audit_round": [_I] * 3 + [_P] * 3 + [_P] * 9 + [_P] * 6 +
                          [_I, _P, _P],
    # R, H, aud, total (the balance summed over the mesh), ctl, stream
    "shadow_audit_conserve": [_I, _I] + [_P] * 3 + [_P],
    # R, H, E, ht head, partial tickets ctl, start, split, OB, ob t (or
    # null: no tally folded in), pops, occ_ob occ_trips occ_phases,
    # aud_tx, ob_word, tally partial, stream
    "shadow_loop_control": [_I] * 3 + [_P] * 5 + [_I] * 3 + [_P] * 8 +
                           [_P],
    # the design before: N, H, boot_end, now src dst seq, host_vertex
    # topo, seed keys, deliver_time delivered, stream
    "shadow_judge_batch": [_L, _I, _L] + [_P] * 4 + [_P, _T, _P] +
                          [_P] * 2 + [_P],
    # tables, N, boot_end, now src dst seq, deliver_time delivered,
    # stream
    "shadow_judge_launch": [_J, _L, _L] + [_P] * 4 + [_P] * 2 + [_P],
    # tables, host_in dev_in dev_out host_out, events[4], the graph out
    "shadow_judge_graph": [_J] + [_P] * 4 + [_P, _P],
    # the graph (returns nothing)
    "shadow_judge_graph_free": [_P],
    # tables, graph, N, boot_end, host_in dev_in dev_out host_out,
    # ms[2], stream
    "shadow_judge_flush": [_J, _P, _L, _L] + [_P] * 4 + [_P, _P],
    # R, H, OB, CX, global, ob t m, x_overflow, pops ob_word, ctl,
    # every_row, stream
    "shadow_compact_outbox": [_I] * 5 + [_P] * 2 + [_P] * 4 + [_I, _P],
    # the scratch words of a launch at H hosts (K9: and split, folded)
    "shadow_loop_control_blocks": [_I] * 3,
    "shadow_loop_control_tickets": [_I] * 3,
    "shadow_phase_tally_blocks": [_I],
    "shadow_phase_tally_tickets": [_I],
    "shadow_audit_round_blocks": [_I],
    "shadow_audit_round_tickets": [_I],
    "shadow_pack_two_phase_tickets": [_I, _I],
}
for _name in POP_KERNELS:
    _SIGNATURES[f"shadow_{_name}"][1:1] = [_I, _I]
    _SIGNATURES[f"shadow_{_name}{AUD}"] = _SIGNATURES[f"shadow_{_name}"]


def _word_ptr(outside: Optional[torch.Tensor]):
    return None if outside is None else _ptr(outside)


def _word_checks(outside: Optional[torch.Tensor]) -> list:
    return [] if outside is None else [(outside, torch.int32)]


def _ctl_args(ctl: Optional[torch.Tensor], R: Optional[int] = None):
    """(pointer, tensors to check) of a launch's control block, or
    (None, []) without one: [R, CTL_N] for a campaign's R replicas,
    [CTL_N] for a standalone state (R None)."""
    if ctl is None:
        return None, []
    want = (len(CTL_FIELDS),) if R is None else (R, len(CTL_FIELDS))
    if ctl.shape != want:
        raise ValueError(f"a control block for {R or 1} replica(s) has "
                         f"shape {want}, not {tuple(ctl.shape)}")
    return _ptr(ctl), [(ctl, torch.int64)]


def _window_args(win_end, device, R: Optional[int] = None):
    """(pointer, tensors to check, the block) of a pop or judge launch's
    control block: `win_end` itself, or for an int a new block on
    `device` with `run` set (for each of a campaign's R replicas; the
    block lives until the call returns; the launch is ordered before
    any reuse of its memory)."""
    if not isinstance(win_end, torch.Tensor):
        win_end = control_block(device, R, run=1, win_end=win_end)
    return (*_ctl_args(win_end, R), win_end)


def _check_tensors(name: str, tensors) -> None:
    """Raise unless every (tensor, dtype) is of its dtype, contiguous
    and on one CUDA device."""
    dev = tensors[0][0].device
    for t, dtype in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             "device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype} "
                             f"(shape {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


class Kernels:
    """The kernels of one engine: the loaded library (built on first
    CUDA use), the wrappers and their launch counters.

    `timing=True` records a CUDA event pair around every launch, so
    `kernel_ms()` can sum the device time each kernel took on the main
    path; it adds no synchronisation. Event pairs mean nothing inside a
    CUDA graph: a launch recorded into one in timing mode raises, and
    the engine keeps its Python window loop there."""

    def __init__(self, timing: bool = False):
        self.timing = timing
        # K2 above 32,768 hosts lists the hosts that popped and spreads
        # them over its warps; False: a warp a host, exiting where it
        # popped nothing (csrc/judge_outbox.cu; kept to measure the two)
        self.judge_listed = True
        # K7 reads by the pop counts on outboxes of this many rows or
        # more, every row below (csrc/count_paths.cu); another value
        # moves the crossover, to measure the two readings on one outbox
        self.paths_gated_rows = PATHS_GATED_ROWS
        # the designs before the one-launch K9, the tally that reads
        # only the popped hosts' rows (csrc/loop_control.cu,
        # phase_tally.cu), the tiled K8 (csrc/audit_round.cu), the K11
        # and the K7 that read only the popped hosts' rows
        # (csrc/compact_outbox.cu, count_paths.cu) and the K13 that
        # keeps its buffers (csrc/pack_two_phase.cu), kept to measure
        # against them: K9 as two launches (the minimum, then a block a
        # replica deciding), the tally reading every host's row with one
        # atomicMax a block, K8 a warp a host with a memset and a second
        # launch, K11 a warp a row over every row, ranking from L1, K7 an
        # atomic a packet row over every row, K13 writing every slot in
        # two launches a hop; K9 then folds no tally
        self.designs_before = False
        # K9 takes the phase's tallies in the captured window loop
        # (`loop_control_tally`; DeviceEngine folds where nothing
        # rewrites the outbox after the judge); False: the phase launches
        # phase_tally and K9 steps alone, to measure the two
        self.fold_tally = True
        self.reset_counts()
        self._lib = None
        self._judge_flush = None
        self._scratch = {}
        self._captured = None

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)
        self._events = {n: [] for n in KERNEL_NAMES}

    def kernel_ms(self) -> dict:
        """Summed device ms per kernel over the recorded launches
        (timing mode); synchronises."""
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in ev)
                for n, ev in self._events.items()}

    def begin_capture(self) -> None:
        """Launches from here to `end_capture` are being recorded into
        a CUDA graph: they count at its replays, not now."""
        self._captured = dict.fromkeys(KERNEL_NAMES, 0)

    def end_capture(self) -> dict:
        """The launches the graph recorded, per kernel."""
        captured, self._captured = self._captured, None
        return captured

    def replayed(self, captured: dict) -> None:
        """Count one replay of a graph that recorded `captured`."""
        for name, n in captured.items():
            self.launches[name] += n

    def library(self):
        if self._lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _seed_args(self, world: dict, p: PhaseParams, R: int, dev):
        """(pointer, [(tensor, dtype)] to check) of a launch's [R, 2]
        int64 seed keys: the world's, or for a world that names none
        (one replica) a tensor of `p.seed`, made once."""
        key = world.get("seed_key")
        if key is None:
            if R != 1:
                raise ValueError("a campaign's world carries its [R, 2] "
                                 "seed keys")
            if (p.seed, dev) not in self._scratch:
                self._scratch[p.seed, dev] = torch.tensor(
                    [list(p.seed)], dtype=torch.int64, device=dev)
            key = self._scratch[p.seed, dev]
        if key.shape != (R, 2):
            raise ValueError(f"seed keys: need [{R}, 2], not "
                             f"{tuple(key.shape)}")
        return _ptr(key), [(key, torch.int64)]

    def _scratch_of(self, key: str, n: int, dev, zero: bool = False,
                    dtype=torch.int64) -> torch.Tensor:
        """A scratch vector of `n` words on `dev`, allocated once (a
        captured graph holds its address); `zero`: zeroed when
        allocated."""
        k = (key, n, dev)
        if k not in self._scratch:
            self._scratch[k] = (torch.zeros if zero else torch.empty)(
                n, dtype=dtype, device=dev)
        return self._scratch[k]

    def _launch(self, name: str, c_name: str, tensors, *args) -> None:
        """Check every (tensor, dtype) the kernel reads or writes, launch
        it on the current stream, and count the launch (with an event
        pair around it in timing mode)."""
        _check_tensors(name, tensors)
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing and (self.timing or self._captured is None):
            raise RuntimeError(
                f"{name}: a launch recorded into a CUDA graph must come "
                "between begin_capture and end_capture, and not in "
                "timing mode (event pairs mean nothing in a graph)")
        fn = getattr(self.library(), c_name)
        stream = torch.cuda.current_stream().cuda_stream
        ev = None
        if self.timing:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error "
                               f"{err}")
        if ev is not None:
            ev[1].record()
            self._events[name].append(ev)
        (self._captured if capturing else self.launches)[name] += 1

    def pop(self, state: dict, ob: dict, pops: torch.Tensor, world: dict,
            win_end, p: PhaseParams,
            outside: Optional[torch.Tensor] = None) -> None:
        """The phase's pops: K1 for PHOLD, K4 for tgen, K6 for Tor (the
        plain pop for each on the CPU), on the world's tables; `win_end`
        is an int or the loop's control block. `pops` holds the last
        phase's counts on entry and this phase's on return. `outside`:
        the engine's outbox words (`outbox_word`); the kernel then
        clears only the rows of hosts that popped in the last phase,
        every row where the word is set, and clears the word. Without
        it every row is cleared."""
        if outside is not None and outside.shape != (2, n_replicas(state)
                                                     or 1):
            raise ValueError(f"pop: outbox words [2, "
                             f"{n_replicas(state) or 1}], not "
                             f"{tuple(outside.shape)}")
        if not state["head"].is_cuda:
            return pop_plain(state, ob, pops, world, win_end, p, outside)
        if isinstance(p.app, TgenDevice):
            return self._pop_tgen(state, ob, pops, world, win_end, p,
                                  outside)
        if isinstance(p.app, TorDevice):
            return self._pop_tor(state, ob, pops, world, win_end, p,
                                 outside)
        return self._pop_phase(state, ob, pops, world, win_end, p, outside)

    def _pop_common(self, state: dict, world: dict, win_end,
                    p: PhaseParams):
        """(R, H, the launch name's flags (nic, epochs, hier, aud), the
        C entry's suffix, TopoArgs, NicArgs, the seed keys' pointer, the
        trailing aud aud_t ctl pointers, the checks of all these, the
        block to keep alive) of a pop launch."""
        R = n_replicas(state)
        H = state["head"].shape[-1]
        dev = state["head"].device
        hier, epochs, topo, topo_checks = topo_args(world, R or 1)
        nic, nic_checks = nic_args(state, world, p)
        key, key_checks = self._seed_args(world, p, R or 1, dev)
        ctl, ctl_checks, block = _window_args(win_end, dev, R)
        checks = topo_checks + nic_checks + key_checks + ctl_checks
        if p.AUD:
            aud, aud_t = state["aud"], state["aud_t"]
            checks += [(aud, torch.int32), (aud_t, torch.int64)]
            tail = (_ptr(aud), _ptr(aud_t), ctl)
        else:
            tail = (None, None, ctl)
        return (R or 1, H, (p.MB, epochs, hier, p.AUD),
                AUD if p.AUD else "", topo, nic, key, tail, checks, block)

    def _pop_phase(self, state: dict, ob: dict, pops: torch.Tensor,
                   world: dict, win_end, p: PhaseParams,
                   outside: Optional[torch.Tensor]) -> None:
        a = p.app
        if not isinstance(a, PholdDevice) or p.T or p.P != 1:
            raise ValueError("pop_phase runs PHOLD (no timers, no "
                             "bursts)")
        heap = [state[f] for f in HEAP_FIELDS]
        small = [state[f] for f in ("head", "event_seq", "packet_seq",
                                    "app_seq", "app", "n_exec",
                                    "n_deliv", "chk")]
        hv = world["host_vertex"]
        R, H, flags, suffix, topo, nic, key, tail, checks, _keep = \
            self._pop_common(state, world, win_end, p)
        obs = [ob[f] for f in OB_FIELDS]
        i32, i64 = torch.int32, torch.int64
        self._launch(
            launch_name("pop_phase", *flags), "shadow_pop_phase" + suffix,
            [(t, i64) for t in heap + obs] + [(t, i32) for t in small[:7]]
            + [(small[7], i64), (pops, i32), (hv, i32)] + checks
            + _word_checks(outside),
            R, p.g0, hv.shape[0], H, p.E, p.K, p.B, *map(_ptr, heap),
            *map(_ptr, small), _ptr(hv), ctypes.byref(topo),
            ctypes.byref(nic), key, a.n_hosts_total, a.msgload, a.size,
            a.selfloop, *map(_ptr, obs), _ptr(pops), _word_ptr(outside),
            *tail)

    def _pop_tgen(self, state: dict, ob: dict, pops: torch.Tensor,
                  world: dict, win_end, p: PhaseParams,
                  outside: Optional[torch.Tensor]) -> None:
        a = p.app
        if not isinstance(a, TgenDevice):
            raise ValueError("pop_tgen runs tgen")
        self._pop_trains("pop_tgen", state, ob, pops, world, win_end, p,
                         outside, [], (a.npkts, a.last_sz, a.chunk, MSS))

    def _pop_tor(self, state: dict, ob: dict, pops: torch.Tensor,
                 world: dict, win_end, p: PhaseParams,
                 outside: Optional[torch.Tensor]) -> None:
        a = p.app
        if not isinstance(a, TorDevice):
            raise ValueError("pop_tor runs Tor")
        relays = world["relay_gids"]
        self._pop_trains("pop_tor", state, ob, pops, world, win_end, p,
                         outside, [relays],
                         (relays.shape[0], *a.route_key, a.cells))

    def _pop_trains(self, name: str, state: dict, ob: dict,
                    pops: torch.Tensor, world: dict, win_end,
                    p: PhaseParams, outside: Optional[torch.Tensor],
                    app_tensors: list, app_scalars) -> None:
        """K4 or K6: the pops of an app with trains, one timer lane and
        per-host client args; `app_tensors` (int32) and `app_scalars`
        are the app's own arguments, after the client args."""
        if p.T != 1 or p.K != max(1, p.P) or p.C > 32:
            raise ValueError(f"{name}: one timer lane, one send lane per "
                             "burst column, trains of at most 32")
        heap = [state[f] for f in HEAP_FIELDS]
        small = [state[f] for f in ("head", "event_seq", "packet_seq",
                                    "app", "n_exec", "n_deliv")]
        hv = world["host_vertex"]
        R, H, flags, suffix, topo, nic, key, tail, checks, _keep = \
            self._pop_common(state, world, win_end, p)
        args = [world["client_count"], world["client_pause"],
                world["client_retry"]]
        obs = [ob[f] for f in OB_FIELDS]
        i32, i64 = torch.int32, torch.int64
        self._launch(
            launch_name(name, *flags), f"shadow_{name}{suffix}",
            [(t, i64) for t in heap + obs] + [(t, i32) for t in small]
            + [(state["chk"], i64), (pops, i32), (hv, i32)] + checks
            + [(args[0], i32)] + [(t, i64) for t in args[1:]]
            + [(t, i32) for t in app_tensors] + _word_checks(outside),
            R, p.g0, hv.shape[0], H, p.E, p.K, p.T, p.P, p.B, p.C,
            *map(_ptr, heap),
            *map(_ptr, small), _ptr(state["chk"]), _ptr(hv),
            ctypes.byref(topo), ctypes.byref(nic), key, *map(_ptr, args),
            *map(_ptr, app_tensors), *app_scalars, *map(_ptr, obs),
            _ptr(pops), _word_ptr(outside), *tail)

    def judge_outbox(self, state: dict, ob: dict, world: dict,
                     win_end, p: PhaseParams,
                     pops: Optional[torch.Tensor] = None,
                     outside: Optional[torch.Tensor] = None) -> None:
        """K2 (the plain judge on the CPU). Given the phase's pop counts
        and the engine's outbox words (`outbox_word`), both or neither,
        the kernel skips the hosts that popped nothing, unless a word
        says the rows came from outside the pop; without them it judges
        every host. The plain judge judges every row: a skipped host's
        row holds no send row, so both give the same bytes."""
        if (pops is None) != (outside is None):
            raise ValueError("judge_outbox: the pop counts and the outbox "
                             "words come together")
        if not ob["t"].is_cuda:
            return judge_outbox_plain(state, ob, world, win_end, p)
        R = ob_replicas(ob)
        H, OB = ob["t"].shape[-2:]
        dev = ob["t"].device
        obs = [ob["t"], ob["m"], ob["v"]]
        cnt = [state["packet_seq"], state["n_sent"], state["n_drop"]]
        hv = world["host_vertex"]
        hier, epochs, topo, topo_checks = topo_args(world, R or 1)
        key, key_checks = self._seed_args(world, p, R or 1, dev)
        ctl, ctl_checks, _block = _window_args(win_end, dev, R)
        work = self._scratch_of("judge_list", (R or 1) * (2 + H), dev,
                                zero=True, dtype=torch.int32)
        skip = [(work, torch.int32)]
        if pops is not None:
            if pops.shape != ob["t"].shape[:-1] or \
                    outside.shape != (2, R or 1):
                raise ValueError("judge_outbox: pop counts [(R,) H] and "
                                 "outbox words [2, R]")
            skip += [(pops, torch.int32), (outside, torch.int32)]
        self._launch(
            launch_name("judge_outbox", False, epochs, hier),
            "shadow_judge_outbox",
            [(t, torch.int64) for t in obs]
            + [(t, torch.int32) for t in cnt + [hv]] + topo_checks
            + key_checks + ctl_checks + skip,
            R or 1, H, OB, p.C, int(p.boot_end), *map(_ptr, obs),
            *map(_ptr, cnt), _ptr(hv), ctypes.byref(topo), key, int(p.CP),
            p.g0, hv.shape[0], None if pops is None else _ptr(pops),
            _word_ptr(outside), _ptr(work), int(self.judge_listed), ctl)

    def count_paths(self, state: dict, ob: dict, world: dict,
                    ctl: Optional[torch.Tensor] = None,
                    pops: Optional[torch.Tensor] = None,
                    outside: Optional[torch.Tensor] = None) -> None:
        """K7: add the judged outbox's packet rows to
        state["path_cnt"] (count_paths_plain on the CPU). Given the
        phase's pop counts and the engine's outbox words
        (`outbox_word`), both or neither, the kernel reads, on an outbox
        of `paths_gated_rows` rows or more, only the rows of the hosts
        that popped, unless a word says the rows came from outside the
        pop; a smaller outbox, or a launch without them, has every row
        read (there the pop count's load costs more than the rows it
        saves). The plain version reads every row: a skipped
        host's row holds no row below INF, so both give the same
        counts."""
        if (pops is None) != (outside is None):
            raise ValueError("count_paths: the pop counts and the outbox "
                             "words come together")
        if not ob["t"].is_cuda:
            return count_paths_plain(state, ob, world, ctl)
        R = ob_replicas(ob)
        H, OB = ob["t"].shape[-2:]
        V = n_vertices(world)
        cnt = state["path_cnt"]
        want = (1, V * V) if R is None else (R, 1, V * V)
        if cnt.shape != want:
            raise ValueError(f"count_paths: path_cnt must be {list(want)}")
        obs = [ob["t"], ob["k"], ob["m"]]
        hv = world["host_vertex"]
        c, ctl_checks = _ctl_args(ctl, R)
        skip = []
        if pops is not None:
            if pops.shape != ob["t"].shape[:-1] or \
                    outside.shape != (2, R or 1):
                raise ValueError("count_paths: pop counts [(R,) H] and "
                                 "outbox words [2, R]")
            skip = [(pops, torch.int32), (outside, torch.int32)]
        self._launch(
            "count_paths", "shadow_count_paths",
            [(t, torch.int64) for t in obs + [cnt]] + [(hv, torch.int32)]
            + ctl_checks + skip,
            R or 1, H, hv.shape[0], OB, V, *map(_ptr, obs), _ptr(hv),
            _ptr(cnt), c,
            None if pops is None else _ptr(pops), _word_ptr(outside),
            int(self.paths_gated_rows), int(self.designs_before))

    def route(self, ob: dict, out=None, ctl: Optional[torch.Tensor] = None):
        """K5: (perm, starts, counts) as `route_plain` gives them, for
        destinations in [0, H), written into `out` where given (perm
        [H*OB], starts and counts [H], int64; each with the leading [R]
        axis for a campaign's outbox [R, H, OB]), else into new tensors.
        Only perm's first counts.sum() entries are written; the rest are
        unspecified."""
        if not ob["t"].is_cuda:
            if ctl is not None and ctl.dim() == 2:
                # a campaign: each replica that runs, in turn
                for r in range(ctl.shape[0]):
                    self.route(at_replica(ob, r),
                               tuple(o[r] for o in out), ctl[r])
                return out
            if _phase_off(ctl):
                return out
            res = route_plain(ob)
            if out is None:
                return res
            for o, r in zip(out, res):
                o.copy_(r)
            return out
        H = ob["t"].shape[-2]
        return self._route_launch("route", Rows(ob), 0, H, False, out, ctl)

    def route_rows(self, rows: Rows, lo: int, nd: int, keyed: bool = False,
                   out=None, ctl: Optional[torch.Tensor] = None):
        """K5 over any rows (route_rows_plain on the CPU): (perm [n],
        starts [nd], counts [nd]) of the exchangeable rows destined [lo,
        lo + nd), by position or, `keyed`, by key within a destination.
        Counts as `route` over an outbox from destination 0 (a mesh
        rank's H_loc senders into the H_pad destinations), else as
        `route_window`, or `route_keyed` where keyed."""
        name = ("route_keyed" if keyed else "route"
                if isinstance(rows.regions[0], dict) and lo == 0
                else "route_window")
        if rows.device.type != "cuda":
            R = rows.replicas
            if R is not None:
                # a campaign: each replica that runs, in turn
                if out is None:
                    out = tuple(torch.zeros((R, m), dtype=torch.int64,
                                            device=rows.device)
                                for m in (rows.n, nd, nd))
                for r in range(R):
                    self.route_rows(rows.at(r), lo, nd, keyed,
                                    tuple(o[r] for o in out),
                                    _ctl_at(ctl, r))
                return out
            if _phase_off(ctl):
                return out
            res = route_rows_plain(rows, lo, nd, keyed)
            if out is None:
                return res
            for o, r in zip(out, res):
                o.copy_(r)
            return out
        return self._route_launch(name, rows, lo, nd, keyed, out, ctl)

    def _route_launch(self, name: str, rows: Rows, lo: int, nd: int,
                      keyed: bool, out, ctl):
        """One K5 launch over `rows` (a campaign's rows: each
        replica's)."""
        R = rows.replicas
        dev = rows.device
        lead = () if R is None else (R,)
        F = rows.n
        if F >= 1 << 30:
            raise ValueError(f"{name}: {F} rows; the route takes fewer "
                             "than 2^30")
        # the radix sort's buffers, look-back status, histograms and
        # counters, per replica (every call leaves all but the buffers
        # zero)
        n = R or 1
        words = route_work_words(F, keyed)
        work = self._scratch_of("route_work_keyed" if keyed else
                                "route_work", n * words, dev, zero=True)
        if out is None:
            out = tuple(torch.empty((*lead, m), dtype=torch.int64,
                                    device=dev) for m in (F, nd, nd))
        if [tuple(o.shape) for o in out] != [(*lead, F), (*lead, nd),
                                             (*lead, nd)]:
            raise ValueError(f"{name}: out must be perm [(R,){F}], starts "
                             f"and counts [(R,){nd}]")
        args, checks = rows_args(rows, ("t", "m", "key") if keyed
                                 else ("t", "m"))
        c, ctl_checks = _ctl_args(ctl, R)
        self._launch(
            name, "shadow_route",
            checks + [(t, torch.int64) for t in list(out) + [work]]
            + ctl_checks,
            n, F, nd, lo, int(keyed), ctypes.byref(args), *map(_ptr, out),
            _ptr(work), words, c)
        return tuple(out)

    def merge_heaps(self, state: dict, ob, perm: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    p: PhaseParams,
                    ctl: Optional[torch.Tensor] = None,
                    second: Optional[tuple] = None,
                    occ_sum: bool = False,
                    fresh: Optional[torch.Tensor] = None) -> None:
        """K3 (merge_heaps_plain on the CPU): the arrivals of `ob` (an
        outbox or a Rows) through the route's (perm, starts, counts);
        with `second` = (rows, perm, starts, counts) a second block,
        counted as `merge_heaps2`. `fresh`: the engine's [2, R] int32
        words (`merge_flags`), whose first row says whether the heaps
        may have been edited since the last merge; without them every
        host's heap is checked for order."""
        def as_rows(x):
            return x if isinstance(x, Rows) else Rows(x)

        if not perm.is_cuda:
            return merge_heaps_plain(state, ob, perm, starts, counts, p,
                                     ctl, second, occ_sum)
        R = n_replicas(state)
        H = state["head"].shape[-1]
        heap = [state[f] for f in HEAP_FIELDS] + [state["head"]]
        occ = [state["overflow"], state["occ_in"], state["occ_heap"]]
        blocks, args, checks = [], [], []
        a, chk = rows_args(as_rows(ob))
        args.append(a)
        checks += chk + [(t, torch.int64) for t in (perm, starts, counts)]
        blocks.append((ctypes.byref(a), *map(_ptr, (perm, starts, counts)),
                       perm.shape[-1]))
        if second is None:
            blocks.append((None, None, None, None, 0, 0))
        else:
            # a mesh rank's own rows: a campaign's starts and counts are
            # each replica's [H] slice of its outbox route's [R, H_pad]
            # rows, a row's stride apart
            a, chk = rows_args(as_rows(second[0]))
            args.append(a)
            seg = second[1:]
            if any(t.stride(-1) != 1 for t in seg):
                raise ValueError("merge_heaps: the second block's route "
                                 "needs a unit stride along a row")
            checks += chk + [(t[0] if t.dim() == 2 else t, torch.int64)
                             for t in seg]
            blocks.append((ctypes.byref(a), *map(_ptr, seg),
                           seg[0].shape[-1], seg[1].stride(0)
                           if seg[1].dim() == 2 else H))
        c, ctl_checks = _ctl_args(ctl, R)
        if fresh is not None and fresh.shape != (2, R or 1):
            raise ValueError(f"merge_heaps: fresh words [2, {R or 1}], "
                             f"not {tuple(fresh.shape)}")
        # the listed hosts' count, the blocks done and the list, per
        # replica (zero between launches but the list)
        work = self._scratch_of("merge_list", (R or 1) * (2 + H),
                                heap[0].device, zero=True,
                                dtype=torch.int32)
        self._launch(
            "merge_heaps2" if second is not None else "merge_heaps",
            "shadow_merge_heaps",
            [(t, torch.int64) for t in heap[:5]] + checks
            + [(t, torch.int32) for t in heap[5:] + occ + [work]]
            + ctl_checks + ([] if fresh is None
                            else [(fresh, torch.int32)]),
            R or 1, H, p.E, p.IN, *map(_ptr, heap), *blocks[0],
            *blocks[1], int(occ_sum), *map(_ptr, occ), c,
            None if fresh is None else _ptr(fresh), _ptr(work))

    def pack_remote(self, state: dict, ob: dict, perm: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    mesh: MeshParams, send: torch.Tensor,
                    ctl: Optional[torch.Tensor] = None) -> None:
        """K12 (pack_remote_plain on the CPU): the [S, C, CAP] send
        buffer of the all_to_all (a campaign's [S, R, C, CAP]: each
        peer's block holds every replica's packs), x_overflow and
        occ_x."""
        if not send.is_cuda:
            if ob_replicas(ob) is not None or not _phase_off(ctl):
                pack_remote_plain(state, ob, perm, starts, counts, mesh,
                                  send, ctl)
            return
        C, CAP = send.shape[-2:]
        self._pack_launch("pack_remote", "shadow_pack_remote", state, ob,
                          perm, starts, counts, mesh, send, (), CAP, C,
                          ctl=ctl)

    def pack_two_phase(self, state: dict, ob: dict, perm: torch.Tensor,
                       starts: torch.Tensor, counts: torch.Tensor,
                       mesh: MeshParams, send: torch.Tensor,
                       ctl: Optional[torch.Tensor] = None,
                       filled: Optional[torch.Tensor] = None) -> None:
        """K13's phase 1 (pack_two_phase_plain on the CPU): the [g, 6,
        CAP] buffers by destination rank (a campaign's [g, R, 6, CAP]),
        x_overflow and occ_x. `filled` ([g] int32, a campaign's [g, R],
        `fill_words`): the buffers are kept between phases and each word
        holds the slots the buffer's last pack filled with rows; the
        kernel writes this pack's rows and the fills of the slots the
        last one filled and this one does not, and keeps the words.
        Without it every slot is written. The plain version writes every
        slot: both leave the same bytes."""
        if not send.is_cuda:
            if ob_replicas(ob) is not None or not _phase_off(ctl):
                pack_two_phase_plain(state, ob, perm, starts, counts, mesh,
                                     send, ctl)
            return
        self._pack_launch("pack_two_phase", "shadow_pack_two_phase",
                          state, ob, perm, starts, counts, mesh, send,
                          (mesh.G, mesh.NG), send.shape[-1], ctl=ctl,
                          post=self._fill_args("pack_two_phase", send,
                                               filled))

    def _fill_args(self, name: str, send: torch.Tensor,
                   filled: Optional[torch.Tensor]) -> tuple:
        """(trailing arguments, tensors to check) of a K13 half's launch
        over the kept buffers `send` [n, (R,) 6, cap] with their fill
        words (or none). The design before writes every slot and leaves
        the words at the capacity, which every later pack may trust; it
        packs one replica, and refuses a campaign's buffers."""
        lead, cap = tuple(send.shape[:-2]), send.shape[-1]
        if self.designs_before and len(lead) > 1:
            raise ValueError(f"{name}: the design before "
                             "(Kernels.designs_before) packs one replica; "
                             f"a campaign's buffers {tuple(send.shape)} "
                             "need the kept-buffer design")
        if filled is None:
            return (None, None, int(self.designs_before)), []
        if tuple(filled.shape) != lead:
            raise ValueError(f"{name}: fill words {list(lead)}, not "
                             f"{tuple(filled.shape)}")
        if self.designs_before:
            filled.fill_(cap)
            return (None, None, 1), []
        nbuf = int(np.prod(lead))
        tickets = self._scratch_of(
            "pack_tickets",
            self.library().shadow_pack_two_phase_tickets(nbuf, cap),
            send.device, zero=True, dtype=torch.int32)
        return ((_ptr(filled), _ptr(tickets), 0),
                [(filled, torch.int32), (tickets, torch.int32)])

    def _pack_launch(self, name, c_name, state, ob, perm, starts, counts,
                     mesh, send, groups, cap, *tail, ctl=None,
                     post=((), [])) -> None:
        """K12 or K13's phase 1 over this rank's outbox (a campaign's
        every replica); `post`: K13's trailing arguments and their
        tensors to check (K12 takes none)."""
        rows = Rows(ob)
        R = rows.replicas
        args, checks = rows_args(rows)
        seg = [perm, starts, counts]
        out = [state["x_overflow"], state["occ_x"]]
        if starts.shape[-1] != mesh.H_pad or perm.shape[-1] != rows.n:
            raise ValueError(f"{name}: need the route over the H_pad "
                             "destinations")
        if (R is not None and send.shape[1] != R) or \
                out[0].dim() != (1 if R is None else 2):
            raise ValueError(f"{name}: outbox, state and send buffer of "
                             f"{R or 1} replica(s)")
        c, ctl_checks = _ctl_args(ctl, R)
        self._launch(
            name, c_name,
            checks + [(t, torch.int64) for t in seg + [send]]
            + [(t, torch.int32) for t in out] + post[1] + ctl_checks,
            R or 1, rows.n, mesh.S, mesh.shard, mesh.H_loc,
            ob["t"].shape[-1], *groups, cap, *tail, ctypes.byref(args),
            *map(_ptr, seg), _ptr(send), *map(_ptr, out), *post[0], c)

    def pack_two_phase2(self, rows: Rows, perm: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        mesh: MeshParams, OB: int, send: torch.Tensor,
                        hist: torch.Tensor,
                        ctl: Optional[torch.Tensor] = None,
                        filled: Optional[torch.Tensor] = None) -> None:
        """K13's phase 2 (pack_two_phase2_plain on the CPU): the [ng-1,
        6, CAP2] buffers by destination group (a campaign's [ng-1, R, 6,
        CAP2]) from the keyed route of the phase-1 arrivals, and `hist`
        [H_pad] int32 (a campaign's [R, H_pad]), zeroed first, of the
        rows lost there by global source. `filled` ([ng-1] int32, a
        campaign's [ng-1, R]): the kept buffers' fill words, as
        `pack_two_phase`'s."""
        hist.zero_()
        R = rows.replicas
        if not send.is_cuda:
            if R is not None or not _phase_off(ctl):
                pack_two_phase2_plain(rows, perm, starts, counts, mesh, OB,
                                      send, hist, ctl)
            return
        args, checks = rows_args(rows, XCH_FIELDS)
        seg = [perm, starts, counts]
        post, post_checks = self._fill_args("pack_two_phase2", send,
                                            filled)
        c, ctl_checks = _ctl_args(ctl, R)
        self._launch(
            "pack_two_phase2", "shadow_pack_two_phase2",
            checks + [(t, torch.int64) for t in seg + [send]]
            + [(hist, torch.int32)] + post_checks + ctl_checks,
            R or 1, rows.n, mesh.S, mesh.shard, mesh.H_loc, OB, mesh.G,
            mesh.NG, send.shape[-1], ctypes.byref(args), *map(_ptr, seg),
            _ptr(send), _ptr(hist), *post, c)

    def phase_tally(self, state: dict, ob: dict, pops: torch.Tensor,
                    p: PhaseParams, ctl: Optional[torch.Tensor] = None,
                    outside: Optional[torch.Tensor] = None) -> None:
        """The phase's occupancy marks and, under the audit, `aud_tx`
        (phase_tally_plain on the CPU). Given the engine's outbox words
        (`outbox_word`) as the judge read them, the kernel reads only
        the rows of hosts whose pop count is nonzero, unless a word
        says the rows came from outside the pop; without them it reads
        every host's row. The plain version reads every row: a skipped
        host holds no exchangeable row, so both give the same bytes."""
        if not pops.is_cuda:
            return phase_tally_plain(state, ob, pops, p, ctl)
        R = ob_replicas(ob)
        H, OB = ob["t"].shape[-2:]
        dev = ob["t"].device
        occ = [state["occ_ob"], state["occ_trips"], state["occ_phases"]]
        aud_tx = state["aud_tx"] if p.AUD else None
        c, ctl_checks = _ctl_args(ctl, R)
        if outside is not None and outside.shape != (2, R or 1):
            raise ValueError("phase_tally: outbox words [2, R]")
        lib = self.library()
        partial = self._scratch_of(
            "tally_partial", (R or 1) * lib.shadow_phase_tally_blocks(H),
            dev, dtype=torch.int32)
        tickets = self._scratch_of(
            "tally_tickets", (R or 1) * lib.shadow_phase_tally_tickets(H),
            dev, zero=True, dtype=torch.int32)
        self._launch(
            "phase_tally", "shadow_phase_tally",
            [(ob["t"], torch.int64)]
            + [(t, torch.int32) for t in [pops] + occ + [partial, tickets]]
            + ([(aud_tx, torch.int64)] if p.AUD else []) + ctl_checks
            + _word_checks(outside),
            R or 1, H, OB, _ptr(ob["t"]), _ptr(pops), *map(_ptr, occ),
            None if aud_tx is None else _ptr(aud_tx), c,
            _word_ptr(outside), _ptr(partial), _ptr(tickets),
            int(self.designs_before))

    def audit_round(self, state: dict,
                    ctl: Optional[torch.Tensor] = None,
                    balance: Optional[torch.Tensor] = None) -> None:
        """K8: the audit's health word (audit_round_plain on the CPU);
        given the control block, only where its `round_end` word is
        set. With `balance` ([R or 1] int64, a mesh rank's) the launch
        writes the rank's balance there and decides no AUD_CONSERVE
        (counted as `audit_round_rank`): `audit_conserve` does, on the
        balance summed over the mesh."""
        if not state["head"].is_cuda:
            return audit_round_plain(state, ctl, balance)
        R = n_replicas(state)
        H, E = state["ht"].shape[-2:]
        heap = [state["ht"], state["hk"]]
        small = [state["head"]] + [state[k] for k in AUD_COUNTERS] + \
            [state["overflow"], state["x_overflow"]]
        dev = state["ht"].device
        lib = self.library()
        if self.designs_before:
            if balance is not None:
                raise ValueError("audit_round: a mesh rank's balance is "
                                 "the tiled design's alone")
            total = self._scratch_of("audit_sum", R or 1, dev)
            scratch, ptrs = [total], [_ptr(total), None, None]
        else:
            if E > AUDIT_MAX_E:
                raise ValueError(f"audit_round: E = {E} past the tiled "
                                 f"audit's {AUDIT_MAX_E}")
            partial = self._scratch_of(
                "audit_partial", (R or 1) * lib.shadow_audit_round_blocks(H),
                dev)
            tickets = self._scratch_of(
                "audit_tickets", (R or 1) * lib.shadow_audit_round_tickets(H),
                dev, zero=True, dtype=torch.int32)
            scratch, ptrs = [partial, tickets], [None, _ptr(partial),
                                                 _ptr(tickets)]
        if balance is not None:
            if balance.shape != (R or 1,):
                raise ValueError(f"audit_round: balance must be "
                                 f"[{R or 1}]")
            scratch = scratch + [balance]
        c, ctl_checks = _ctl_args(ctl, R)
        self._launch(
            "audit_round" if balance is None else "audit_round_rank",
            "shadow_audit_round",
            [(t, torch.int64) for t in heap + [state["aud_tx"]]]
            + [(t, torch.int32) for t in small + [state["aud"]]]
            + [(t, t.dtype) for t in scratch] + ctl_checks,
            R or 1, H, E, *map(_ptr, heap), *map(_ptr, small),
            _ptr(state["aud_tx"]), _ptr(state["aud"]), *ptrs, c,
            int(self.designs_before),
            None if balance is None else _ptr(balance))

    def audit_conserve(self, state: dict, total: torch.Tensor,
                       ctl: Optional[torch.Tensor] = None) -> None:
        """K8's conserve pass on a mesh rank (audit_conserve_plain on
        the CPU): AUD_CONSERVE into every host where `total` ([R or 1]
        int64, the rank balances summed over the mesh) is not 0."""
        if not state["head"].is_cuda:
            return audit_conserve_plain(state, total, ctl)
        R = n_replicas(state)
        H = state["aud"].shape[-1]
        if total.shape != (R or 1,):
            raise ValueError(f"audit_conserve: total must be [{R or 1}]")
        c, ctl_checks = _ctl_args(ctl, R)
        self._launch(
            "audit_conserve", "shadow_audit_conserve",
            [(state["aud"], torch.int32), (total, torch.int64)]
            + ctl_checks, R or 1, H, _ptr(state["aud"]), _ptr(total), c)

    def loop_control(self, state: dict, ctl: torch.Tensor,
                     start: bool = False, tally=None) -> None:
        """K9: one control step of the window loop on the block `ctl`
        (loop_control_plain on the CPU); a campaign's blocks [R, CTL_N]
        each step their own replica. `tally` (outbox, pop counts,
        params, outbox words) folds the phase's tallies into the step
        (`loop_control_tally`: phase_tally's work where the phase ran,
        before the decisions; on the CPU phase_tally_plain, then
        loop_control_plain)."""
        if not ctl.is_cuda:
            if tally is not None and not start:
                ob, pops, p, _ = tally
                phase_tally_plain(state, ob, pops, p, ctl)
            return loop_control_plain(state, ctl, start)
        R = n_replicas(state)
        H, E = state["ht"].shape[-2:]
        lib = self.library()
        split = int(self.designs_before)
        if split and tally is not None:
            raise ValueError("loop_control: the split design folds no "
                             "tally")
        folded = int(tally is not None)
        nb = lib.shadow_loop_control_blocks(H, split, folded)
        partial = self._scratch_of("loop_partial", (R or 1) * nb,
                                   ctl.device)
        words = lib.shadow_loop_control_tickets(H, split, folded)
        tickets = self._scratch_of("loop_tickets",
                                   max(1, (R or 1) * words), ctl.device,
                                   zero=True, dtype=torch.int32)
        c, ctl_checks = _ctl_args(ctl, R)
        checks = [(state["ht"], torch.int64), (state["head"], torch.int32),
                  (partial, torch.int64), (tickets, torch.int32)] + \
            ctl_checks
        name, OB, fold_args = "loop_control", 0, [None] * 8
        if tally is not None:
            ob, pops, p, outside = tally
            OB = ob["t"].shape[-1]
            if pops.shape != ob["t"].shape[:-1] or (
                    outside is not None and outside.shape != (2, R or 1)):
                raise ValueError("loop_control: pop counts [(R,) H] and "
                                 "outbox words [2, R]")
            occ = [state["occ_ob"], state["occ_trips"],
                   state["occ_phases"]]
            tp = self._scratch_of("loop_tally_partial", (R or 1) * nb,
                                  ctl.device, dtype=torch.int32)
            aud_tx = state["aud_tx"] if p.AUD else None
            checks += ([(ob["t"], torch.int64)]
                       + [(t, torch.int32) for t in [pops] + occ + [tp]]
                       + ([(aud_tx, torch.int64)] if p.AUD else [])
                       + _word_checks(outside))
            name = "loop_control_tally"
            fold_args = [_ptr(ob["t"]), _ptr(pops), *map(_ptr, occ),
                         None if aud_tx is None else _ptr(aud_tx),
                         _word_ptr(outside), _ptr(tp)]
        self._launch(
            name, "shadow_loop_control", checks,
            R or 1, H, E, _ptr(state["ht"]), _ptr(state["head"]),
            _ptr(partial), _ptr(tickets), c, int(start), split, OB,
            *fold_args)

    def compact_outbox(self, state: dict, ob: dict, p: PhaseParams,
                       ctl: Optional[torch.Tensor] = None,
                       pops: Optional[torch.Tensor] = None,
                       outside: Optional[torch.Tensor] = None) -> None:
        """K11: keep at most p.CX exchangeable rows per sender by the
        rule p.CXG selects (compact_plain on the CPU). Given the phase's
        pop counts and the engine's outbox words (`outbox_word`), both
        or neither, the kernel reads only the rows of the hosts that
        popped, unless a word says the rows came from outside the pop;
        without them it reads every row. The plain version reads every
        row: a skipped host's row holds no exchangeable row, so both give
        the same bytes."""
        if (pops is None) != (outside is None):
            raise ValueError("compact_outbox: the pop counts and the "
                             "outbox words come together")
        if not ob["t"].is_cuda:
            return compact_plain(state, ob, p.CX, p.CXG, ctl)
        R = ob_replicas(ob)
        H, OB = ob["t"].shape[-2:]
        if not 0 < p.CX <= OB or OB > 2048:
            raise ValueError("compact_outbox: need 0 < CX <= OB <= 2048")
        c, ctl_checks = _ctl_args(ctl, R)
        skip = []
        if pops is not None:
            if pops.shape != ob["t"].shape[:-1] or \
                    outside.shape != (2, R or 1):
                raise ValueError("compact_outbox: pop counts [(R,) H] and "
                                 "outbox words [2, R]")
            skip = [(pops, torch.int32), (outside, torch.int32)]
        self._launch(
            "compact_outbox_global" if p.CXG else "compact_outbox",
            "shadow_compact_outbox",
            [(ob["t"], torch.int64), (ob["m"], torch.int64),
             (state["x_overflow"], torch.int32)] + skip + ctl_checks,
            R or 1, H, OB, p.CX, int(p.CXG), _ptr(ob["t"]), _ptr(ob["m"]),
            _ptr(state["x_overflow"]),
            None if pops is None else _ptr(pops), _word_ptr(outside), c,
            int(self.designs_before))

    def judge_batch(self, tables: JudgeTables, boot_end: int,
                    now: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    pkt_seq: torch.Tensor, out=None):
        """K10: (delivered, deliver_time) of a batch of N deferred
        packets on `tables` (`judge_tables`), as judge_batch_plain gives
        them (which it is on the CPU). On the card `delivered` is uint8
        (0/1); both are written into `out` = (deliver_time int64 [N],
        delivered uint8 [N]) where given. `designs_before`: the design
        before, over the world's tables through topo_args."""
        if not now.is_cuda:
            return judge_batch_plain(tables.world, boot_end, now, src, dst,
                                     pkt_seq)
        N = now.shape[0]
        if any(t.shape != (N,) for t in (src, dst, pkt_seq)):
            raise ValueError("judge_batch: now, src, dst and pkt_seq "
                             "must be [N]")
        if out is None:
            out = (torch.empty(N, dtype=torch.int64, device=now.device),
                   torch.empty(N, dtype=torch.uint8, device=now.device))
        t_out, d_out = out
        if t_out.shape != (N,) or d_out.shape != (N,):
            raise ValueError("judge_batch: out must be two [N] tensors")
        columns = [(now, torch.int64)] + [
            (t, torch.int32) for t in (src, dst, pkt_seq)] + [
            (t_out, torch.int64), (d_out, torch.uint8)]
        ptrs = [_ptr(t) for t, _ in columns]
        if self.designs_before:
            world = tables.world
            hv = world["host_vertex"]
            hier, epochs, topo, topo_checks = topo_args(world, 1)
            key, key_checks = self._seed_args(world, None, 1, now.device)
            self._launch(
                tables.name, "shadow_judge_batch",
                columns + [(hv, torch.int32)] + topo_checks + key_checks,
                N, hv.shape[0], int(boot_end), *ptrs[:4], _ptr(hv),
                ctypes.byref(topo), key, *ptrs[4:])
        else:
            if tables.args is None:
                raise ValueError("judge_batch: the tables are not on the "
                                 "card")
            self._launch(tables.name, "shadow_judge_launch",
                         columns + [(tables.keys, torch.int32)],
                         ctypes.byref(tables.args), N, int(boot_end),
                         *ptrs)
        return d_out, t_out

    def judge_graph(self, tables: JudgeTables, buffers, events):
        """K10's flush graph for `tables` (on the card) over the four
        buffers' addresses (host in, device in, device out, host out:
        20 and 9 bytes a packet) and four CUDA event handles
        (csrc/judge_batch.cu `shadow_judge_graph`): a handle for
        judge_flush, freed by judge_graph_free."""
        state = ctypes.c_void_p()
        err = self.library().shadow_judge_graph(
            tables.args, *buffers, events, ctypes.byref(state))
        if err != 0:
            raise RuntimeError(f"{tables.name}: building the flush graph "
                               f"failed with error {err}")
        return state

    def judge_graph_free(self, state) -> None:
        self.library().shadow_judge_graph_free(state)

    def judge_flush(self, tables: JudgeTables, graph, n: int,
                    boot_end: int, buffers, ms) -> None:
        """K10 on one flush of n packets in one C call
        (csrc/judge_batch.cu `shadow_judge_flush`): the flush graph
        (`judge_graph`) set to n packets of `buffers` (the four
        addresses, grown by the caller) and launched on the current
        stream, then a wait for it; `ms` (two floats) takes the
        kernel's and the copies' device ms. Nothing is checked here.
        Counts one launch."""
        fn = self._judge_flush
        if fn is None:
            fn = self._judge_flush = self.library().shadow_judge_flush
        err = fn(tables.args, graph, n, boot_end, *buffers, ms,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{tables.name}: CUDA flush failed with "
                               f"error {err}")
        self.launches[tables.name] += 1
