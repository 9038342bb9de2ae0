"""Preflight admission: the device footprint of a run against the
card's memory budget (the port's copy of the reference package's
device/capacity.py `footprint`, `fmt_bytes`, `device_budget`,
`admission_diagnostic` and `admission_verdict`, cut to one GPU with
no pipeline or runtime degradation ladder).

The runner calls `admission_verdict` after the build and before the
engine allocates anything on the device. The byte model prices the
tensors the port's engine really holds:

* the state dict, one copy (the engine updates it in place; there is
  no segment pipeline and no rewind snapshot), with the seven [H]
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

import logging
import math
from typing import Optional

import numpy as np
import torch

from shadow_tpu_torch.device.engine import STATE_DTYPES
from shadow_tpu_torch.device.kernels import (
    CTL_FIELDS,
    NIC_KEYS,
    XCH_FIELDS,
    MeshParams,
    PhaseParams,
    n_vertices,
    route_work_words,
)

log = logging.getLogger("shadow_tpu_torch.admission")

FOOTPRINT_TOLERANCE = 4.0


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
              replicas=None, mesh: Optional[MeshParams] = None) -> dict:
    """The byte model of a run on one device. `world` holds the
    arrays the engine uploads (device/engine.py `world_arrays`, or
    `campaign_world_arrays` for a campaign, whose R the model counts);
    `replicas` prices a batch of that many of a campaign's replicas.
    On a mesh `n_hosts` is a rank's H_loc, the world holds the H_pad
    host columns, and the exchange's buffers (`mesh_nbytes`) count."""
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
    exchange = 0 if mesh is None else mesh_nbytes(mesh, OB)
    per_device = R * (state + outbox + route + loop) + world_bytes + \
        exchange
    return {
        "representation": "hierarchical" if hier else "dense",
        "per_device": int(per_device),
        "state_bytes": int(state),
        "scratch_bytes": int(R * (outbox + route)),
        "exchange_bytes": int(exchange),
        "loop_bytes": int(R * loop),
        "world_bytes": int(world_bytes),
        "copies": 1,
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
