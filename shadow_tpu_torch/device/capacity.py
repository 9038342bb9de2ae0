"""Occupancy-driven capacity planning and preflight admission (the
port's copy of the reference package's device/capacity.py, cut to the
port: no pipeline, no runtime degradation ladder).

The planner (capacity.py:42-441 and 550-632 of the reference, in
numpy): the engine keeps per-host and per-shard high-water marks in its
state (the `occ_*` leaves, written by the phase tally, K9's folded tally
and K3; csrc/phase_tally.cu, loop_control.cu, merge_heaps.cu), and

* `measure(engine, state)` turns a run's marks into an occupancy
  record (a JSON-able dict, the reference's format and fields, so that
  either package loads the other's: `app_fingerprint` is computed over
  the reference's view of the app);
* `plan(record, ...)` sizes the capacity knobs from it with headroom,
  and on a mesh `choose_exchange` resolves `exchange: auto` from the
  [S, S] pair matrix of the ranks' occ_x rows;
* `widen(knobs, dims, effective)` doubles the dimensions an overflow
  implicates (`overflow_dims`), for the runner's re-plan and replay;
* `grow_heaps` and `transfer` carry a state, as host arrays, into a
  rebuilt engine with a larger event_capacity;
* `reshard_state` carries one across a change of shard count (the mesh
  shrink, device/supervise.py): every per-host leaf re-padded row for
  row to the new padded width.

A plan that undershoots trips the engine's loud overflow counters; the
segmented advance (device/supervise.py) widens, rebuilds and replays
from the last validated boundary. Traces are the same at any capacity
while nothing overflows, so planning moves only the time and memory a
run takes.

Admission: the runner calls `admission_verdict` after the build and before the
engine allocates anything on the device. The byte model prices the
tensors the port's engine really holds:

* the state dict, one copy (the engine updates it in place), two where
  the segmented advance keeps the last validated boundary's state on
  the card to replay from (a planned run, device/supervise.py), with the seven [H]
  int64 model-NIC leaves under `model_bandwidth`, the [1,V*V] int64
  path counters under `count_paths` and the audit's [H] leaves (aud
  int32, aud_t and aud_tx int64) under `state_audit`;
* the per-phase scratch, allocated once per engine: the five [H,OB]
  int64 outbox fields (OB counts the READY column under the model
  NIC) and the [H] pop counts, and the route's outputs and scratch
  (K5: perm [H*OB] int64, starts and counts [H] int64, and its radix
  sort's work, kernels.route_work_words; K3's [2 + H] int32 list of
  the hosts it merges, and K2's of the hosts it judges, which the
  model NIC's pops replace); the judge, the path counters, the
  compaction (K11, under `outbox_compact`: it rewrites the outbox's
  times and x_overflow and needs no scratch) and the merge work in
  place;
* the window loop's control block (kernels.CTL_FIELDS), K9's block
  minima (at most 1,024) and K8's sum, a few KiB;
* the world: the host vertices, the path tables (dense [V,V], or the
  factored leaves with one shared cl vector; under a fault schedule
  each with its [T] epoch axis, cl still uploaded once), the epoch
  start times, the seed keys, under the model NIC the [H] bandwidths
  and the CoDel law table, and the app's columns.

An ensemble campaign of R replicas (ensemble/) holds R of the state,
the scratch and the loop's blocks, and its world stacks R of the
tables, epoch times and seed keys; `footprint(..., replicas=k)` prices
a batch of k of its replicas, which `admission_verdict` offers as
`replica_batch` where the whole campaign does not fit.

A captured window loop allocates nothing on the device (its graph's
own memory lies outside PyTorch's allocator). Transient allocations of
the Python window loop (a few [H] vectors a phase) are not modelled:
the estimate is a floor on the live bytes,
and chip_smoke.py holds the measured peak within FOOTPRINT_TOLERANCE of
it, as the reference's tests hold its own.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from typing import Optional

import numpy as np
import torch

from shadow_tpu_torch.core.tgen_args import CHUNK_PKTS, MSS
from shadow_tpu_torch.core.tor_args import (
    CELL_BYTES,
    CHUNK_CELLS,
    SEQ_BITS,
    SEQ_MASK,
)
from shadow_tpu_torch.device.apps import PholdDevice, TgenDevice, TorDevice
from shadow_tpu_torch.device.engine import (
    HEAP_FILLS,
    STATE_DTYPES,
    state_from_numpy,
)
from shadow_tpu_torch.device.kernels import (
    CTL_FIELDS,
    NIC_KEYS,
    XCH_FIELDS,
    MeshParams,
    PhaseParams,
    n_vertices,
    route_work_words,
)
from shadow_tpu_torch.utils.artifacts import atomic_write_json

log = logging.getLogger("shadow_tpu_torch.admission")
plan_log = logging.getLogger("shadow_tpu_torch.capacity")

FOOTPRINT_TOLERANCE = 4.0

# the record format both packages read and write
FORMAT = 1
# planned = ceil(measured * HEADROOM) + SLACK: the warm-up slice is a
# lower bound on steady-state occupancy, and the replay makes an
# undershoot cost one re-run, never the run
HEADROOM = 1.5
SLACK = 2
# re-plans before a run may fail loudly (each doubles the offending
# dimension, so 6 covers a 64x miss)
MAX_REPLANS = 6
# the engine's capacity knobs: planned, recorded as the static
# baseline, widened
CAPACITY_KNOBS = ("event_capacity", "outbox_capacity",
                  "exchange_capacity", "exchange_capacity2",
                  "exchange_in_capacity", "outbox_compact")
# overflow counter -> the capacity dimensions it implicates: the merge's
# `overflow` cannot tell a short heap from a short arrival window, so
# both grow; `x_overflow` covers the shard-pair caps (both phases of
# two_phase) and the compaction width
OVERFLOW_DIMS = {
    "overflow": ("event_capacity", "exchange_in_capacity"),
    "x_overflow": ("exchange_capacity", "exchange_capacity2",
                   "outbox_compact"),
}
# two_phase must beat the direct all_to_all's estimated rows by this
# factor before `exchange: auto` picks it
TWO_PHASE_MARGIN = 0.9


def dense_auto_cap(h_loc: int, outbox: int, event_capacity: int,
                   n_shards: int) -> int:
    """The reference's blind per-pair CAP when exchange_capacity is 0
    (capacity.py:80): 4x the balanced share of a shard's whole
    outbox."""
    r = h_loc * outbox
    return min(r, max(64, event_capacity,
                      (4 * r + n_shards - 1) // n_shards))


def group_split(n_shards: int) -> tuple[int, int]:
    """The two-phase groups (capacity.py:96): n_shards = g * ng with g
    the largest divisor not above sqrt(n_shards); a prime count gives
    (1, n_shards)."""
    g = 1
    for d in range(2, int(math.isqrt(n_shards)) + 1):
        if n_shards % d == 0:
            g = d
    return g, n_shards // g


def exchange_caps(exchange: str, n_shards: int, h_loc: int, outbox: int,
                  event_capacity: int, cap: int = 0,
                  cap2: int = 0) -> tuple[int, int, int, int]:
    """(CAP, CAP2, g, ng) of an exchange schedule, the reference
    engine's sizes (engine.py:577-599): `cap`/`cap2` where given (the
    config's exchange_capacity/exchange_capacity2), else the auto
    formulas; all_gather has no CAP, and one shard no exchange."""
    g, ng = group_split(n_shards) if exchange == "two_phase" else \
        (1, n_shards)
    if n_shards == 1 or exchange == "all_gather":
        return 0, 0, g, ng
    r = h_loc * outbox
    if exchange == "all_to_all":
        return (cap or dense_auto_cap(h_loc, outbox, event_capacity,
                                      n_shards)), 0, g, ng
    CAP = cap or min(r, max(64, event_capacity, (4 * r + g - 1) // g))
    CAP2 = cap2 or min(g * CAP, max(64, event_capacity,
                                    (4 * r * g + n_shards - 1)
                                    // n_shards))
    return CAP, CAP2, g, ng


# ----------------------------------------------------------------------
# the planner
# ----------------------------------------------------------------------
def _reference_surface(app) -> tuple[dict, list]:
    """(scalars, [(name, array)]) of an app as the reference package's
    device app of the same class holds them in its instance dict
    (`vars(app)`; shadow_tpu/device/apps.py): the scalars it sets, and
    its per-host arrays with their dtypes (tgen and Tor keep the client
    args twice there, as fields and as `_count`/`_pause`/`_retry`).
    The fingerprint is computed over this view, so that the two
    packages fingerprint one workload alike."""
    if isinstance(app, PholdDevice):
        return ({"max_draws": app.max_draws, "max_sends": app.max_sends,
                 "max_timers": app.max_timers, "msgload": app.msgload,
                 "n_hosts_total": app.n_hosts_total,
                 "n_state_words": app.n_state_words,
                 "selfloop": app.selfloop, "size": app.size}, [])
    args = [("_count", app.count, np.int32), ("_pause", app.pause_ns,
                                               np.int64),
            ("_retry", app.retry_ns, np.int64), ("count", app.count,
                                                  np.int32)]
    if isinstance(app, TgenDevice):
        scalars = {"MSS": MSS, "chunk": CHUNK_PKTS,
                   "last_sz": app.last_sz, "max_draws": 1,
                   "max_sends": app.max_sends,
                   "max_timers": app.max_timers,
                   "max_train": app.max_train,
                   "n_state_words": app.n_state_words,
                   "npkts": app.npkts, "size": app.size}
        arrays = args + [("pause_ns", app.pause_ns, np.int64),
                         ("retry_ns", app.retry_ns, np.int64),
                         ("roles", app.roles, np.int32),
                         ("server_gid", app.server_gid, np.int32)]
    elif isinstance(app, TorDevice):
        scalars = {"CELL": CELL_BYTES, "SEQ_BITS": SEQ_BITS,
                   "SEQ_MASK": SEQ_MASK, "cells": app.cells,
                   "chunk": CHUNK_CELLS, "max_draws": 1,
                   "max_sends": app.max_sends,
                   "max_timers": app.max_timers,
                   "max_train": app.max_train,
                   "n_state_words": app.n_state_words, "seed": app.seed}
        arrays = args + [("pause_ns", app.pause_ns, np.int64),
                         ("relay_gids", app.relay_gids, np.int64),
                         ("retry_ns", app.retry_ns, np.int64),
                         ("roles", app.roles, np.int32)]
    else:
        raise TypeError(f"no reference view of {type(app).__name__}")
    return ({k: int(v) for k, v in scalars.items()},
            [(k, np.ascontiguousarray(np.asarray(v).astype(dt)))
             for k, v, dt in arrays])


def app_scalars(app) -> dict:
    """The app's scalar configuration surface, as the reference lists it
    (capacity.py:109; burst_pops, a lane width that never changes the
    trace, left out)."""
    return dict(sorted(_reference_surface(app)[0].items()))


def app_fingerprint(app) -> str:
    """The workload fingerprint of a device app (capacity.py:124): its
    scalars, then each per-host array's name, shape and bytes in name
    order; two apps of one class and host count whose traffic differs
    do not share an occupancy record."""
    scalars, arrays = _reference_surface(app)
    h = hashlib.sha256(json.dumps(app_scalars(app),
                                  sort_keys=True).encode())
    for k, v in sorted(arrays, key=lambda kv: kv[0]):
        h.update(k.encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()[:12]


def host_array(x) -> np.ndarray:
    """A tensor's values on the host (a numpy array passes through)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def measure(engine, state, source: str = "run") -> dict:
    """The occupancy record of a run's state (capacity.py:142): the
    measured maxima and the effective capacities that held them. `state`
    holds tensors or numpy arrays (a campaign's worst-case view, a
    mesh's gathered marks); only the occ_* leaves and the overflow
    counters are read, never the heaps."""
    H = engine.config.n_hosts
    occ = {k: host_array(state[k]) for k in (
        "occ_heap", "occ_ob", "occ_in", "occ_x", "occ_trips",
        "occ_phases", "overflow", "x_overflow")}
    pairs = np.asarray(occ["occ_x"], dtype=np.int64)
    if pairs.ndim > 2:          # a campaign's stack: its worst case
        pairs = pairs.max(axis=tuple(range(pairs.ndim - 2)))
    measured = {
        "heap_rows_max": int(occ["occ_heap"][:H].max(initial=0)),
        "outbox_rows_max": int(occ["occ_ob"][:H].max(initial=0)),
        "arrivals_per_flush_max": int(occ["occ_in"][:H].max(initial=0)),
        "exchange_rows_max": int(occ["occ_x"].max(initial=0)),
        "exchange_pairs": [[int(v) for v in row] for row in pairs],
        "pop_trips_max": int(occ["occ_trips"].max(initial=0)),
        "phases": int(occ["occ_phases"].max(initial=0)),
        "overflow": int(occ["overflow"][:H].sum()),
        "x_overflow": int(occ["x_overflow"][:H].sum()),
    }
    return {
        "format": FORMAT,
        "source": source,
        "workload": {
            "app": type(engine.app).__name__,
            "app_fp": app_fingerprint(engine.app),
            "n_hosts": H,
            "seed": int(engine.config.seed),
            "stop_time": int(engine.config.stop_time),
        },
        "measured": measured,
        "effective": dict(engine.effective),
    }


def merged_measured(record: dict) -> dict:
    """The record's `measured` maxima merged with its `final_measured`
    (elementwise for the pair matrix): a replayed record sizes for the
    whole run, not the warm-up alone (capacity.py:188)."""
    m = dict(record["measured"])
    for k, v in record.get("final_measured", {}).items():
        if k not in m:
            continue
        if k == "exchange_pairs":
            a = np.asarray(m[k], dtype=np.int64)
            b = np.asarray(v, dtype=np.int64)
            if a.shape == b.shape:
                m[k] = np.maximum(a, b).tolist()
        else:
            m[k] = max(m[k], v)
    return m


def pair_matrix(m: dict, n_shards: int) -> np.ndarray:
    """The [S, S] per-(source shard, destination shard) high-water
    matrix of a merged `measured` dict; a record measured on another
    shard count gives the scalar maximum off the diagonal, a bound that
    never undershoots (capacity.py:206)."""
    pairs = np.asarray(m.get("exchange_pairs", []), dtype=np.int64)
    if pairs.shape != (n_shards, n_shards):
        pairs = np.full((n_shards, n_shards),
                        int(m.get("exchange_rows_max", 0)),
                        dtype=np.int64)
        np.fill_diagonal(pairs, 0)
    return pairs


def two_phase_caps(pairs: np.ndarray, headroom: float = HEADROOM
                   ) -> tuple[int, int]:
    """(CAP, CAP2) of the two_phase schedule from the pair matrix
    (capacity.py:221): phase 1 ships one buffer per rank of the group
    with every row bound for that rank in any group; phase 2 forwards a
    group's rows bound for one rank of another group. Sums of high-water
    marks bound the high-water mark of the sum, so the caps only
    overshoot."""
    S = pairs.shape[0]
    g, ng = group_split(S)

    def pad(x: int) -> int:
        return int(math.ceil(int(x) * headroom)) + SLACK

    by_dst = pairs.reshape(S, ng, g)
    cap1 = int(by_dst.sum(axis=1).max(initial=0))
    by_both = pairs.reshape(ng, g, ng, g)
    fwd = by_both.sum(axis=1)            # [a, a', b]
    eye = np.eye(ng, dtype=bool)[:, :, None]
    cap2 = int(np.where(eye, 0, fwd).max(initial=0))
    return max(8, pad(cap1)), max(8, pad(cap2))


def plan(record: dict, per_iter: int, floor_iters: int = 4,
         n_shards: int = 1, headroom: float = HEADROOM,
         exchange: str = "all_to_all") -> dict:
    """Measured occupancies -> the capacity knobs (capacity.py:256).
    `per_iter` is an iteration's outbox columns (K_eff + T [+ READY]),
    so that the engine's B = outbox // per_iter lands exactly;
    `exchange` is the resolved schedule: all_to_all sizes one per-pair
    CAP, two_phase its two caps (`two_phase_caps`), all_gather none."""
    m = merged_measured(record)

    def pad(x: int) -> int:
        return int(math.ceil(x * headroom)) + SLACK

    event_capacity = max(2, pad(m["heap_rows_max"]))
    exchange_in = max(1, pad(m["arrivals_per_flush_max"]))
    iters = max(floor_iters, pad(m["pop_trips_max"]))
    outbox_capacity = iters * max(1, per_iter)
    cx = pad(m["outbox_rows_max"])
    outbox_compact = cx if cx < (3 * outbox_capacity) // 4 else 0
    exchange_capacity = 0
    exchange_capacity2 = 0
    if n_shards > 1 and m["exchange_rows_max"] > 0:
        if exchange == "two_phase":
            exchange_capacity, exchange_capacity2 = two_phase_caps(
                pair_matrix(m, n_shards), headroom)
        elif exchange != "all_gather":
            exchange_capacity = max(8, pad(m["exchange_rows_max"]))
    return {
        "event_capacity": event_capacity,
        "outbox_capacity": outbox_capacity,
        "exchange_capacity": exchange_capacity,
        "exchange_capacity2": exchange_capacity2,
        "exchange_in_capacity": exchange_in,
        "outbox_compact": outbox_compact,
    }


def estimate_ici_rows(record: dict, n_shards: int, per_iter: int,
                      floor_iters: int = 4,
                      headroom: float = HEADROOM) -> dict:
    """The rows a shard would send a flush under each schedule planned
    from this record, buffers at capacity (capacity.py:310)."""
    m = merged_measured(record)
    S = n_shards
    if S <= 1:
        return {"all_to_all": 0, "two_phase": 0, "all_gather": 0}

    def pad(x: int) -> int:
        return int(math.ceil(x * headroom)) + SLACK

    pairs = pair_matrix(m, S)
    cap = max(8, pad(int(pairs.max(initial=0))))
    g, ng = group_split(S)
    cap1, cap2 = two_phase_caps(pairs, headroom)
    p = plan(record, per_iter, floor_iters, n_shards=S,
             headroom=headroom, exchange="all_gather")
    w = p["outbox_compact"] or p["outbox_capacity"]
    h_loc = -(-record["workload"]["n_hosts"] // S)
    return {
        "all_to_all": (S - 1) * cap,
        "two_phase": (g - 1) * cap1 + (ng - 1) * cap2,
        "all_gather": (S - 1) * h_loc * w,
    }


def choose_exchange(record: dict, n_shards: int, per_iter: int,
                    floor_iters: int = 4,
                    headroom: float = HEADROOM) -> tuple[str, dict]:
    """`exchange: auto` from a record (capacity.py:341): the schedule of
    the fewest estimated rows; two_phase only where it beats the direct
    all_to_all by TWO_PHASE_MARGIN and its groups are not degenerate.
    Returns (schedule, info)."""
    est = estimate_ici_rows(record, n_shards, per_iter, floor_iters,
                            headroom)
    info = {"estimates": est, "n_shards": n_shards,
            "group_split": list(group_split(n_shards))}
    if n_shards <= 1:
        return "all_to_all", info
    choice = "all_to_all"
    if est["all_gather"] < est["all_to_all"]:
        choice = "all_gather"
    g, _ = group_split(n_shards)
    if g > 1 and est["two_phase"] < \
            TWO_PHASE_MARGIN * est["all_to_all"] and \
            est["two_phase"] < est[choice]:
        choice = "two_phase"
    info["chosen"] = choice
    return choice, info


def widen(knobs: dict, dims: tuple, effective: dict) -> dict:
    """Double the capacity dimensions `dims` after a loud overflow
    (capacity.py:370), from what ran (`effective`) where the knob is 0
    (auto); a compaction width doubles, then turns off once it reaches
    the outbox."""
    out = dict(knobs)
    for dim in dims:
        if dim == "event_capacity":
            out[dim] = 2 * max(out.get(dim) or 0, effective["E"])
        elif dim == "exchange_in_capacity":
            out[dim] = 2 * max(out.get(dim) or 0, effective["IN"])
        elif dim == "exchange_capacity":
            if effective["CAP"] > 0:
                out[dim] = 2 * max(out.get(dim) or 0, effective["CAP"])
        elif dim == "exchange_capacity2":
            if effective.get("CAP2", 0) > 0:
                out[dim] = 2 * max(out.get(dim) or 0,
                                   effective["CAP2"])
        elif dim == "outbox_compact":
            cx, ob = effective["CX"], effective["OB"]
            if cx < ob:
                ncx = 2 * cx
                out[dim] = ncx if ncx < ob else 0
    return out


def overflow_counts(state) -> dict:
    """{counter: its sum} of the loud overflow counters of a state (two
    host reads)."""
    return {c: int(host_array(state[c]).sum()) for c in OVERFLOW_DIMS}


def overflow_dims(state, counts: Optional[dict] = None) -> tuple:
    """The capacity dimensions a state's loud counters implicate (an
    empty tuple where clean; capacity.py:401); `counts` where the
    caller has reduced them already (a mesh's sums over its ranks)."""
    counts = overflow_counts(state) if counts is None else counts
    dims = ()
    for counter, d in OVERFLOW_DIMS.items():
        if counts[counter]:
            dims += d
    return dims


def grow_heaps(host_state: dict, new_e: int) -> dict:
    """Pad the five [..., H, E] heap arrays of a host-side state to
    `new_e` slots with the engine's empty-slot values
    (engine.HEAP_FILLS, init_state's): rows are sorted and empty slots
    sort last, so tail padding keeps every heap in order
    (capacity.py:413). Standalone [H, E] and campaign [R, H, E] alike."""
    out = dict(host_state)
    *lead, e = np.asarray(host_state["ht"]).shape
    if new_e < e:
        raise ValueError(f"cannot shrink event_capacity {e} -> {new_e} "
                         "on a live state")
    if new_e == e:
        return out
    for k, fill in HEAP_FILLS.items():
        pad = np.full(tuple(lead) + (new_e - e,), fill, dtype=np.int64)
        out[k] = np.concatenate([np.asarray(host_state[k]), pad], -1)
    return out


# reshard_state's leaf classes (capacity.py:442-446): every key the
# engine may put in its state falls in exactly one, so that a new leaf
# cannot be re-sharded wrongly without a loud refusal. Per-host vector
# leaves (counters, seq/chk, occ_heap/ob/in, aud*, the NIC's) are the
# residual class, shape-checked against the padded width.
RESHARD_HOST_ROWS = ("ht", "hk", "hm", "hv", "hw", "app")
RESHARD_SHARD_ZERO = ("occ_x", "occ_trips", "occ_phases")
RESHARD_SHARD_SUM = ("path_cnt",)


def reshard_state(host_state: dict, n_hosts: int,
                  template_host: dict) -> dict:
    """A host-side state carried across a change of shard count
    (capacity.py:447-531): H_pad = ceil(H / S) * S, so every per-host
    leaf is re-padded row for row. `template_host` is the target
    engine's initial state in the same global layout (a mesh's ranks'
    leaves concatenated along the host axis, shard-major): its shapes
    define the new layout and its values fill the padded rows (app init
    rows, empty heap slots, zero counters), as an uninterrupted run on
    the target mesh holds them. The first `n_hosts` rows carry over
    verbatim, so counters, heaps and trace checksums are untouched; the
    per-shard marks reset (they describe buffers that no longer exist)
    and the path counters' rows (a row a rank) sum onto row 0.
    Standalone [H, ...] states and campaign [R, H, ...] stacks alike."""
    extra = set(host_state) - set(template_host)
    if any(not _aux_leaf(k) for k in extra):
        raise ValueError(
            "reshard_state: snapshot carries leaves the target "
            f"engine lacks: {sorted(extra)}")
    old_pad = np.asarray(host_state["ht"]).shape[-2]
    new_pad = np.asarray(template_host["ht"]).shape[-2]
    H = int(n_hosts)
    if not (0 < H <= old_pad and H <= new_pad):
        raise ValueError(
            f"reshard_state: n_hosts {H} does not fit the padded "
            f"widths (old {old_pad}, new {new_pad})")
    out = {}
    for k, tmpl in template_host.items():
        new = np.array(tmpl)
        if k not in host_state:
            if k == "aud_tx":
                # a snapshot without the audit: the ledger reseeded from
                # the saved counters, per host (checkpoint.load_state's
                # rule), so that the balance holds at the resume point
                ht = np.asarray(host_state["ht"])
                head = np.asarray(host_state["head"])
                E = ht.shape[-1]
                live = ((np.arange(E) >= head[..., None])
                        & (ht < HEAP_FILLS["ht"])).sum(-1)
                recon = (np.asarray(host_state["n_exec"]).astype(np.int64)
                         + live
                         + np.asarray(host_state["overflow"])
                         .astype(np.int64)
                         + np.asarray(host_state["x_overflow"])
                         .astype(np.int64))
                new[..., :H] = recon[..., :H]
            elif not _aux_leaf(k):
                raise ValueError(
                    f"reshard_state: snapshot is missing leaf {k!r}")
            out[k] = new
            continue
        old = np.asarray(host_state[k])
        if k in RESHARD_HOST_ROWS:
            if old.shape[-1] != new.shape[-1] or \
                    old.shape[:-2] != new.shape[:-2] or \
                    old.shape[-2] != old_pad or new.shape[-2] != new_pad:
                raise ValueError(
                    f"reshard_state: leaf {k} is {old.shape}, target "
                    f"expects {new.shape} — reshard carries geometry "
                    "only, never capacity or replica changes")
            new[..., :H, :] = old[..., :H, :]
        elif k in RESHARD_SHARD_ZERO:
            new[...] = 0
        elif k in RESHARD_SHARD_SUM:
            new[...] = 0
            new[..., 0, :] = old.sum(axis=-2)
        elif old.shape[:-1] == new.shape[:-1] and \
                old.shape[-1] == old_pad and new.shape[-1] == new_pad:
            new[..., :H] = old[..., :H]
        else:
            raise ValueError(
                f"reshard_state: leaf {k!r} ({old.shape} -> "
                f"{new.shape}) is not registered in any reshard "
                "class — classify it in capacity.RESHARD_* before "
                "adding state leaves")
        out[k] = new
    return out


def _aux_leaf(k: str) -> bool:
    """Leaves that may differ between the saving and the resuming
    engine without touching the trace (checkpoint.load_state's rule):
    the occupancy marks and the audit's leaves."""
    return k.startswith("occ_") or k.startswith("aud")


def transfer(engine, host_state: dict, template: dict) -> dict:
    """A host-side state placed onto a (rebuilt) engine: the heaps
    padded to its event_capacity (`grow_heaps`), every leaf checked
    against `template` (numpy leaves of the engine's own init state: its
    keys, shapes and dtypes), uploaded, and the engine armed, as for
    any state that enters from outside (DeviceEngine._arm: the next pop
    clears every outbox row, the next merge checks every heap's
    order)."""
    host_state = grow_heaps(host_state, engine.params.E)
    if set(template) != set(host_state):
        raise ValueError(
            "state keys changed across re-plan: "
            f"{sorted(set(template) ^ set(host_state))}")
    for k, tmpl in template.items():
        arr = np.asarray(host_state[k])
        if arr.shape != tmpl.shape or arr.dtype != tmpl.dtype:
            raise ValueError(
                f"state leaf {k} is {arr.shape}/{arr.dtype}, the "
                f"re-planned engine expects {tmpl.shape}/{tmpl.dtype}")
    state = state_from_numpy(host_state, engine.device)
    engine._arm()
    return state


def record_path(engine, directory: str = "") -> str:
    """The OCC record's path of a workload (capacity.py:577): app class,
    host count and fingerprint, under `directory`, else
    $SHADOW_TPU_OCC_DIR, else `artifacts`."""
    directory = directory or os.environ.get("SHADOW_TPU_OCC_DIR",
                                            "artifacts")
    return os.path.join(
        directory,
        f"OCC_{type(engine.app).__name__}_{engine.config.n_hosts}"
        f"_{app_fingerprint(engine.app)}.json")


def save_record(record: dict, path: str) -> None:
    """Write a record as JSON through a temporary file and an atomic
    rename (utils/artifacts.py)."""
    atomic_write_json(record, path)


def load_record(path: str) -> dict:
    """A saved record, its format and required keys checked
    (capacity.py:602)."""
    with open(path) as f:
        record = json.load(f)
    if record.get("format") != FORMAT:
        raise ValueError(
            f"occupancy record {path}: format {record.get('format')} "
            f"(this build reads format {FORMAT})")
    for key in ("measured", "workload"):
        if key not in record:
            raise ValueError(f"occupancy record {path}: missing {key!r}")
    return record


# ----------------------------------------------------------------------
# preflight admission
# ----------------------------------------------------------------------
def mesh_nbytes(mesh: MeshParams, OB: int) -> int:
    """Device bytes a rank adds for the exchange: the send and receive
    buffers of its schedule ([S, C, CAP] int64 each; two_phase its
    [g, 6, CAP] phase-1 and [ng-1, 6, CAP2] phase-2 pairs and the
    [H_pad] int32 loss histogram; all_gather the gathered [S, 5,
    H_loc*OB] outbox), the route over H_pad destinations (its starts
    and counts) and the route of the received rows (perm and the radix
    sort's work over them, keyed after two_phase, whose phase-1
    arrivals take a keyed route of their own)."""
    S, C = mesh.S, mesh.channels
    if S == 1:
        return 0
    keyed = mesh.exchange == "two_phase"
    if mesh.exchange == "all_gather":
        rows = S * mesh.H_loc * OB
        bufs = 5 * rows * 8
    elif keyed:
        rows1 = mesh.G * mesh.CAP
        rows = rows1 + (mesh.NG - 1) * mesh.CAP2
        bufs = 2 * len(XCH_FIELDS) * rows * 8 + mesh.H_pad * 4 + \
            (rows1 + route_work_words(rows1, True)) * 8
    else:
        rows = S * mesh.CAP
        bufs = 2 * C * rows * 8
    return bufs + 2 * mesh.H_pad * 8 + \
        (rows + route_work_words(rows, keyed)) * 8


def state_nbytes(n_hosts: int, params: PhaseParams, V: int = 0) -> int:
    """Bytes of one state dict (device/engine.py STATE_DTYPES): the
    [H,E] heap fields and chk int64, app [H,W] and the [H] counters
    int32, the three occupancy scalars; the NIC leaves [H] int64 under
    params.MB, the path counters [1,V*V] int64 under params.CP, the
    audit's aud [H] int32 and aud_t, aud_tx [H] int64 under
    params.AUD."""
    H, E = n_hosts, params.E
    n = 0
    for k, dt in STATE_DTYPES.items():
        size = np.dtype(dt).itemsize
        if k in ("ht", "hk", "hm", "hv", "hw"):
            n += H * E * size
        elif k == "app":
            n += H * params.app.n_state_words * size
        elif k in ("occ_x", "occ_trips", "occ_phases"):
            n += size
        else:
            n += H * size
    if params.MB:
        n += len(NIC_KEYS) * H * 8
    if params.CP:
        n += V * V * 8
    if params.AUD:
        n += H * (4 + 8 + 8)
    return n


# the world leaves an ensemble campaign stacks per replica
REPLICA_LEAVES = ("lat", "rel", "epoch_times", "seed_key")


def footprint(n_hosts: int, params: PhaseParams, world: dict,
              replicas=None, mesh: Optional[MeshParams] = None,
              copies: int = 1) -> dict:
    """The byte model of a run on one device. `world` holds the
    arrays the engine uploads (device/engine.py `world_arrays`, or
    `campaign_world_arrays` for a campaign, whose R the model counts);
    `replicas` prices a batch of that many of a campaign's replicas.
    On a mesh `n_hosts` is a rank's H_loc, the world holds the H_pad
    host columns, and the exchange's buffers (`mesh_nbytes`) count, a
    campaign's R times (every replica's packs ride each buffer, and
    each replica has its own routes).
    `copies` counts the state's copies (2 where a validated snapshot is
    kept)."""
    ept = np.asarray(world["epoch_times"])
    R_world = ept.shape[0] if ept.ndim == 2 else 1
    R = R_world if replicas is None else int(replicas)
    H, OB = n_hosts, params.OB
    state = state_nbytes(H, params, n_vertices(world))
    outbox = 5 * H * OB * 8 + H * 4
    # K5's outputs and work; K3's list of the hosts it merges and K2's
    # of the hosts it judges (no K2 under the model NIC)
    route = (H * OB + 2 * H + route_work_words(H * OB, False)) * 8 + \
        (2 + H) * 4 * (1 if params.MB else 2)
    # the control block, K9's block minima and K8's sum
    loop = (len(CTL_FIELDS) + 1024 + 1) * 8
    seen, shared, stacked = set(), 0, 0
    for k, v in world.items():
        for a in (v if isinstance(v, tuple) else (v,)):
            if id(a) not in seen:
                seen.add(id(a))
                n = int(np.asarray(a).nbytes)
                # cl, the one factored leaf a campaign shares, is the
                # same object in both tables and counted once
                if k in REPLICA_LEAVES and R_world > 1 and \
                        np.asarray(a).ndim > 1:
                    stacked += n
                else:
                    shared += n
    world_bytes = shared + stacked * R // R_world
    hier = isinstance(world["lat"], tuple)
    exchange = 0 if mesh is None else R * mesh_nbytes(mesh, OB)
    per_device = R * (state * copies + outbox + route + loop) + \
        world_bytes + exchange
    return {
        "representation": "hierarchical" if hier else "dense",
        "per_device": int(per_device),
        "state_bytes": int(state),
        "scratch_bytes": int(R * (outbox + route)),
        "exchange_bytes": int(exchange),
        "loop_bytes": int(R * loop),
        "world_bytes": int(world_bytes),
        "copies": int(copies),
        "replicas": int(R),
        "n_devices": 1,
    }


def fmt_bytes(n) -> str:
    """A byte count for admission diagnostics."""
    n = float(int(n))
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0:
            return (f"{int(n)} B" if unit == "B"
                    else f"{n:.1f} {unit}")
        n /= 1024.0
    return f"{n:.1f} TiB"


def device_budget(device: torch.device, xp) -> tuple:
    """(budget bytes, source): the card's own memory
    (`torch.cuda.mem_get_info` total) when the run is on a card, else
    `experimental.device_memory_budget`, else (0, "")."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        if int(total) > 0:
            return int(total), "backend"
    b = int(getattr(xp, "device_memory_budget", 0) or 0)
    if b > 0:
        return b, "config"
    return 0, ""


def admission_diagnostic(est: dict, budget: int, source: str) -> str:
    return (
        f"admission: needs {fmt_bytes(est['per_device'])} per device, "
        f"budget {fmt_bytes(budget)} ({source}) on "
        f"{est['n_devices']} device(s) — state "
        f"{fmt_bytes(est['state_bytes'])} x {est['copies']} copies x "
        f"R={est['replicas']}, scratch "
        f"{fmt_bytes(est['scratch_bytes'])}, world "
        f"{fmt_bytes(est['world_bytes'])} "
        f"({est.get('representation', 'dense')} tables); raise the "
        "budget or lower pipeline_depth / ensemble.replicas / "
        "capacities")


def admission_verdict(est: dict, device: torch.device, xp,
                      rescale=None) -> dict:
    """The preflight gate on a footprint estimate:

    * `strict` refuses an over-budget estimate (ValueError with the
      diagnostic), and a run with no budget at all;
    * `auto` admits; over budget, for a campaign that can run in
      sequential replica batches (`rescale(k)` estimates a batch of k
      replicas), it halves the batch until one fits and offers it as
      `overrides["replica_batch"]` (action "degrade"); otherwise, or
      where no batch fits, it admits loudly (action "over");
    * `off` skips the check.

    Returns the verdict dict SimStats.admission carries."""
    mode = str(getattr(xp, "admission", "auto"))
    budget, source = device_budget(device, xp)
    out = {"mode": mode, "budget": int(budget), "budget_source": source,
           "estimate": est, "action": "admit", "fits": True,
           "overrides": {}}
    if mode == "off":
        out["action"] = "off"
        return out
    if budget <= 0:
        if mode == "strict":
            raise ValueError(
                "experimental.admission: strict needs a per-device "
                "budget, but the backend reports none and "
                "experimental.device_memory_budget is unset")
        out["action"] = "no-budget"
        return out
    if est["per_device"] <= budget:
        log.info("admission: fits — %s per device of %s (%s)",
                 fmt_bytes(est["per_device"]), fmt_bytes(budget), source)
        return out
    diag = admission_diagnostic(est, budget, source)
    if mode == "strict":
        raise ValueError(diag)
    batch = est["replicas"]
    while est["per_device"] > budget and rescale is not None and \
            batch > 1:
        batch = (batch + 1) // 2
        out["overrides"]["replica_batch"] = batch
        est = rescale(batch)
    out["estimate"] = est
    out["fits"] = est["per_device"] <= budget
    if out["fits"]:
        out["action"] = "degrade"
        log.warning("%s — degraded preflight to %s (now %s per device)",
                    diag, out["overrides"], fmt_bytes(est["per_device"]))
    else:
        out["action"] = "over"
        log.warning("%s — admitting anyway (admission: auto); no rung "
                    "left to degrade to", diag)
    return out


def verdict_line(v: dict) -> str:
    """One line for a log: the action, the estimate and the budget."""
    est = v["estimate"]
    budget = (f"{fmt_bytes(v['budget'])} ({v['budget_source']})"
              if v["budget"] else "none")
    return (f"admission {v['mode']}: {v['action']} — estimate "
            f"{fmt_bytes(est['per_device'])} ({est['per_device']} B, "
            f"{est['representation']} tables "
            f"{fmt_bytes(est['world_bytes'])}), budget {budget}")
