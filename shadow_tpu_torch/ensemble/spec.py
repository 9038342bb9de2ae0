"""Replica worlds: the value-only parameter stacks an ensemble varies
(the port's copy of the reference package's ensemble/spec.py).

An ensemble campaign runs R replicas of one device-twin workload in one
program: every kernel of the port's device engine takes the replica as a
grid dimension (device/engine.py, csrc/). The only things a replica may
vary are array values: the seed key pair, the path latency/reliability
tables and the fault-epoch start times. Shapes are shared: every
replica sees the same hosts, capacities, stop time and epoch count
(shorter fault schedules pad with never-reached epochs that repeat their
last real tables).

This module turns the validated `ensemble:` config block
(config/schema.py EnsembleOptions) into an `EnsembleWorlds`, the
stacked numpy arrays the engine takes, plus the campaign fingerprint
that names the campaign's record.

Determinism contract: replica i's slice of the stacked world is
value-identical to the world a standalone run with replica i's
parameters builds, so replica i's trace is bit-identical to that run's.
The one shared scalar is the lookahead window: the campaign uses the
minimum over every replica's tables (conservative for each); a
standalone comparison run pins `experimental.runahead` to it where its
own floor differs.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from shadow_tpu_torch.topology import hierarchy

# pad value for never-reached fault epochs: the engine's INF sentinel,
# far above any reachable sim time, so the epoch select can never pick
# a padded epoch for a real send (empty outbox rows gather it
# harmlessly — they are masked downstream)
FAR_EPOCH = np.int64(1) << np.int64(62)


@dataclass
class EnsembleWorlds:
    """Stacked per-replica world arrays (engine constructor input).

    latency/reliability are ``[R, V, V]`` when no replica has a fault
    schedule, else ``[R, T, V, V]`` with the shared padded epoch count
    T; epoch_times is ``[R, T]``; the seed key halves are ``[R]``
    uint32 (prng.seed_key split per replica).

    Under ``network.topology.representation: hierarchical``,
    latency/reliability are instead TUPLES of factored leaves
    (topology/hierarchy.py parts order), each stacked ``[R, ...]``
    (with the shared ``[T]`` epoch axis after R when any replica has
    a fault schedule).
    """

    R: int
    latency: np.ndarray
    reliability: np.ndarray
    epoch_times: np.ndarray
    seed_k1: np.ndarray
    seed_k2: np.ndarray
    seeds: np.ndarray              # [R] engine seeds
    lookahead: int                 # min latency over every replica
    descriptors: list = field(default_factory=list)
    campaign_fp: str = ""


def slice_worlds(w: EnsembleWorlds, lo: int, hi: int) -> EnsembleWorlds:
    """A replica-contiguous slice ``[lo, hi)`` of a stacked world, for
    sequential replica batches (``ensemble.replica_batch`` in
    campaign.py). Every ``[R, ...]``-leading array is sliced; the
    shared scalars are kept verbatim: the full campaign's lookahead
    (the minimum over all replicas: a batch-local minimum could differ
    and move round boundaries, breaking the batch == full campaign
    bit-identity) and the full campaign fingerprint (records name the
    campaign, not the batch)."""
    lo, hi = int(lo), int(hi)
    if not (0 <= lo < hi <= w.R):
        raise ValueError(
            f"slice_worlds: replica window [{lo}, {hi}) is outside "
            f"[0, {w.R})")
    def _sl(x):
        # hierarchical worlds are tuples of [R, ...] leaves
        if isinstance(x, tuple):
            return tuple(a[lo:hi] for a in x)
        return x[lo:hi]

    return EnsembleWorlds(
        R=hi - lo,
        latency=_sl(w.latency),
        reliability=_sl(w.reliability),
        epoch_times=w.epoch_times[lo:hi],
        seed_k1=w.seed_k1[lo:hi],
        seed_k2=w.seed_k2[lo:hi],
        seeds=w.seeds[lo:hi],
        lookahead=w.lookahead,
        descriptors=list(w.descriptors[lo:hi]),
        campaign_fp=w.campaign_fp,
    )


def seed_key_np(seed: int) -> tuple[np.uint32, np.uint32]:
    """numpy twin of device/prng.seed_key: the same 64-bit mask and
    split, so the per-replica keys are bit-identical to the key a
    standalone engine takes."""
    s = int(seed) & 0xFFFF_FFFF_FFFF_FFFF
    return np.uint32(s >> 32), np.uint32(s & 0xFFFF_FFFF)


def campaign_fingerprint(R: int, seeds, descriptors,
                         latency: np.ndarray, reliability: np.ndarray,
                         epoch_times: np.ndarray) -> str:
    """Digest of everything that defines the campaign's replica set;
    the ENSEMBLE record carries it and its file name holds it."""
    h = hashlib.sha256()
    h.update(f"R={R}".encode())
    h.update(np.asarray(seeds, np.int64).tobytes())
    for d in descriptors:
        h.update(repr(sorted(d.items())).encode())
    for t in (latency, reliability, epoch_times):
        # hierarchical worlds are leaf tuples; the dense byte
        # sequence is unchanged (one leaf per table)
        for a in (t if isinstance(t, tuple) else (t,)):
            a = np.ascontiguousarray(a)
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()[:12]


def build_worlds(sim, eopts) -> EnsembleWorlds:
    """Compile the ``ensemble:`` block against a built simulation into
    the stacked world arrays. `sim` is a BuiltSimulation (topology +
    base fault table already compiled); `eopts` the validated
    EnsembleOptions."""
    from shadow_tpu_torch import faults as faultmod

    cfg = sim.cfg
    R = int(eopts.replicas)
    vary = eopts.vary
    seeds = [int(s) for s in vary.get("seed",
                                      [cfg.general.seed] * R)]
    scales = [float(x) for x in vary.get("latency_scale", [1.0] * R)]
    deltas = [float(x) for x in vary.get("packet_loss_delta",
                                         [0.0] * R)]
    names = [str(n) for n in vary.get("fault_schedule", ["base"] * R)]

    # compile each distinct named schedule once against the topology
    # (the same dense_adjacency + shortest-path pipeline the base
    # network.faults schedule went through at build time)
    tables: dict = {}

    def table_for(name: str):
        if name not in tables:
            if name == "base":
                tables[name] = sim.fault_table
            elif name == "none":
                tables[name] = None
            else:
                tables[name] = faultmod.compile_link_faults(
                    sim.topology, eopts.fault_schedules[name])
        return tables[name]

    if sim.topology.hier is not None:
        return _build_worlds_hier(sim, R, seeds, scales, deltas,
                                  names, table_for)

    base_lat = np.asarray(sim.topology.latency_ns, np.int64)
    base_rel = np.asarray(sim.topology.reliability, np.float32)
    per = []
    T_max = 1
    for r in range(R):
        tab = table_for(names[r])
        if tab is None:
            times = np.zeros(1, np.int64)
            lat = base_lat[None]
            rel = base_rel[None].astype(np.float64)
        else:
            times = np.asarray(tab.times, np.int64)
            lat = np.asarray(tab.latency_ns, np.int64)
            rel = np.asarray(tab.reliability,
                             np.float32).astype(np.float64)
        if scales[r] != 1.0:
            lat = np.maximum(1, np.rint(
                lat.astype(np.float64) * scales[r])).astype(np.int64)
        if deltas[r] != 0.0:
            rel = np.clip(rel - deltas[r], 0.0, 1.0)
        per.append((times, lat, rel.astype(np.float32)))
        T_max = max(T_max, len(times))

    lats, rels, eps = [], [], []
    for times, lat, rel in per:
        pad = T_max - len(times)
        if pad:
            # never-reached epochs repeating the last real matrices:
            # value-identical lookups for every reachable send time
            times = np.concatenate(
                [times, np.full(pad, FAR_EPOCH, np.int64)])
            lat = np.concatenate([lat, np.repeat(lat[-1:], pad, 0)])
            rel = np.concatenate([rel, np.repeat(rel[-1:], pad, 0)])
        eps.append(times)
        lats.append(lat)
        rels.append(rel)
    latency = np.stack(lats)               # [R, T, V, V]
    reliability = np.stack(rels)
    epoch_times = np.stack(eps)            # [R, T]
    if T_max == 1:
        # fault-free campaigns keep the plain [R, V, V] matrices: the
        # same squeeze the standalone engine does
        latency = latency[:, 0]
        reliability = reliability[:, 0]

    if (latency > np.iinfo(np.int32).max).any():
        bad = [r for r in range(R)
               if (latency[r] > np.iinfo(np.int32).max).any()]
        raise ValueError(
            f"ensemble: replica(s) {bad} have scaled path latencies "
            "above ~2.1 s — they do not fit the i32 device latency "
            "matrix (lower vary.latency_scale)")

    k1 = np.empty(R, np.uint32)
    k2 = np.empty(R, np.uint32)
    for r, s in enumerate(seeds):
        k1[r], k2[r] = seed_key_np(s)

    descriptors = [
        {"replica": r, "seed": seeds[r], "latency_scale": scales[r],
         "packet_loss_delta": deltas[r], "fault_schedule": names[r]}
        for r in range(R)]
    return EnsembleWorlds(
        R=R,
        latency=latency.astype(np.int32),
        reliability=reliability.astype(np.float32),
        epoch_times=epoch_times,
        seed_k1=k1, seed_k2=k2,
        seeds=np.asarray(seeds, np.int64),
        lookahead=int(latency.min()),
        descriptors=descriptors,
        campaign_fp=campaign_fingerprint(
            R, seeds, descriptors, latency, reliability, epoch_times),
    )


def _build_worlds_hier(sim, R, seeds, scales, deltas, names,
                       table_for) -> EnsembleWorlds:
    """Hierarchical twin of the build_worlds table stacking: each
    replica varies the FACTORED leaves, so the stacked world stays
    O(R * (T*C^2 + T*V)) instead of O(R*T*V^2).

    Exactness vs the dense stacking: latency_scale multiplies every
    positive latency factor (composition then distributes —
    bit-identical to scaling the dense matrix for integer scale
    factors, where rint is exact per factor); packet_loss_delta
    subtracts from the cluster (diagonal included — intra-cluster
    pairs compose through it) and self reliabilities, which equals
    the dense clip exactly when every access link is lossless, and
    is refused loudly otherwise."""
    ht = sim.topology.hier
    if any(d != 0.0 for d in deltas) and \
            not bool((np.asarray(ht.acc_rel) >= 1.0).all()):
        raise ValueError(
            "ensemble: vary.packet_loss_delta under the hierarchical "
            "representation requires lossless access links (the "
            "dense clip does not factor through lossy access terms) "
            "— use network.topology.representation: dense")

    def scale_int(x, s):
        if s == 1.0:
            return np.asarray(x, np.int64)
        x = np.asarray(x, np.int64)
        # zero factors are structural (hub access terms, the cluster
        # transit diagonal), never latencies — they must stay zero
        return np.where(
            x > 0,
            np.maximum(1, np.rint(x.astype(np.float64) * s))
            .astype(np.int64), np.int64(0))

    def delta_rel(x, d):
        x = np.asarray(x, np.float32)
        if d == 0.0:
            return x
        return np.clip(x.astype(np.float64) - d,
                       0.0, 1.0).astype(np.float32)

    def parts_for(tab):
        if tab is None:
            lat = tuple(np.asarray(p)[None] for p in ht.lat_parts())
            rel = tuple(np.asarray(p)[None] for p in ht.rel_parts())
            return np.zeros(1, np.int64), lat, rel
        return (np.asarray(tab.times, np.int64),
                tuple(np.asarray(p) for p in tab.lat_parts_stacked()),
                tuple(np.asarray(p) for p in tab.rel_parts_stacked()))

    per = []
    T_max = 1
    for r in range(R):
        times, lat, rel = parts_for(table_for(names[r]))
        cc, cl, acc, slf = lat
        ccr, _, accr, slfr = rel
        lat = (scale_int(cc, scales[r]), cl,
               scale_int(acc, scales[r]), scale_int(slf, scales[r]))
        rel = (delta_rel(ccr, deltas[r]), cl,
               np.asarray(accr, np.float32),
               delta_rel(slfr, deltas[r]))
        per.append((times, lat, rel))
        T_max = max(T_max, len(times))

    lats, rels, eps = [], [], []
    for times, lat, rel in per:
        pad = T_max - len(times)
        if pad:
            times = np.concatenate(
                [times, np.full(pad, FAR_EPOCH, np.int64)])
            lat = tuple(np.concatenate([p, np.repeat(p[-1:], pad, 0)])
                        for p in lat)
            rel = tuple(np.concatenate([p, np.repeat(p[-1:], pad, 0)])
                        for p in rel)
        eps.append(times)
        lats.append(lat)
        rels.append(rel)
    latency = tuple(np.stack([l[i] for l in lats]) for i in range(4))
    reliability = tuple(np.stack([x[i] for x in rels])
                        for i in range(4))
    epoch_times = np.stack(eps)
    if T_max == 1:
        latency = tuple(p[:, 0] for p in latency)
        reliability = tuple(p[:, 0] for p in reliability)

    def replica_epochs(r):
        parts = tuple(p[r] for p in latency)
        if parts[0].ndim == 3:
            return [tuple(p[e] for p in parts)
                    for e in range(parts[0].shape[0])]
        return [parts]

    bad = [r for r in range(R)
           if max(hierarchy.max_composed_latency(ep)
                  for ep in replica_epochs(r))
           > np.iinfo(np.int32).max]
    if bad:
        raise ValueError(
            f"ensemble: replica(s) {bad} have scaled path latencies "
            "above ~2.1 s — they do not fit the i32 device latency "
            "matrix (lower vary.latency_scale)")
    lookahead = min(hierarchy.min_latency_from_parts(ep)
                    for r in range(R) for ep in replica_epochs(r))

    k1 = np.empty(R, np.uint32)
    k2 = np.empty(R, np.uint32)
    for r, s in enumerate(seeds):
        k1[r], k2[r] = seed_key_np(s)

    descriptors = [
        {"replica": r, "seed": seeds[r], "latency_scale": scales[r],
         "packet_loss_delta": deltas[r], "fault_schedule": names[r]}
        for r in range(R)]
    latency = tuple(p.astype(np.int32) for p in latency)
    reliability = tuple(
        p.astype(np.int32) if i == 1 else p.astype(np.float32)
        for i, p in enumerate(reliability))
    return EnsembleWorlds(
        R=R,
        latency=latency,
        reliability=reliability,
        epoch_times=epoch_times,
        seed_k1=k1, seed_k2=k2,
        seeds=np.asarray(seeds, np.int64),
        lookahead=lookahead,
        descriptors=descriptors,
        campaign_fp=campaign_fingerprint(
            R, seeds, descriptors, latency, reliability, epoch_times),
    )
