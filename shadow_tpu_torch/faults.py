"""Link faults: the epoch tables (the port's copy of the link-fault
half of the reference package's faults.py).

`network.faults` entries of kind `link_down`, `link_up` and `degrade`
change the network only at a finite set of times, so the schedule
compiles at load time into [T] epoch start times plus one latency /
reliability table pair per epoch:

* dense: [T,V,V] matrices (`FaultTable`), unchanged epochs held by
  reference to the topology's own matrices and stacked lazily;
* hierarchical: one factored table set per epoch (`HierFaultTable`),
  stacked leaf by leaf with a leading [T] axis; every epoch shares the
  base `cl` vector.

A downed link re-routes over the surviving edges; a pair left without a
path gets reliability 0 at its healthy base latency, so the lookahead
and the int32 device tables keep their shapes. A degrade multiplies an
edge's latency and composes extra loss over [time, time+duration).

Every lookup selects the epoch of the packet's send time: the largest
i with times[i] <= t. The host faults (`host_crash`, `host_restart`)
are parsed here too and resolved against the host names
(`resolve_host_faults`); they are manager-side events, which the CPU
engine runs (core/manager.py), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from shadow_tpu_torch.topology import hierarchy
from shadow_tpu_torch.topology.graph import (
    _MIN_PATH_LATENCY_NS,
    _all_pairs_shortest,
    Topology,
    compute_path_matrices,
    dense_adjacency,
    sparse_min_adjacency,
)

LINK_KINDS = ("link_down", "link_up", "degrade")
HOST_KINDS = ("host_crash", "host_restart")
FAULT_KINDS = LINK_KINDS + HOST_KINDS


@dataclass(frozen=True)
class FaultEvent:
    """One validated ``network.faults`` entry (config/schema.py)."""

    kind: str
    time: int                      # sim ns (degrade: window start)
    source: int = -1               # topology GML vertex ids (link kinds)
    target: int = -1
    duration: int = 0              # degrade window length, ns
    latency_multiplier: float = 1.0
    extra_packet_loss: float = 0.0
    host: str = ""                 # host kinds: configured host name


class FaultTable:
    """The compiled link-fault schedule: epoch start times plus one
    [V,V] latency/reliability override pair per epoch. ``times[0]`` is
    always 0 (the healthy base matrices), so every send time maps to
    exactly one epoch.

    Epochs are held as a LIST of per-epoch [V,V] views; unchanged
    epochs (including the epoch-0 healthy base) are *references to the
    topology's own matrices*, never copies, so a schedule with k
    changed epochs allocates k extra [V,V] pairs instead of T. The
    stacked ``latency_ns`` / ``reliability`` [T,V,V] arrays the device
    uploads materialize lazily on first access."""

    is_hierarchical = False

    def __init__(self, times, lat_epochs, rel_epochs):
        self.times = np.asarray(times, np.int64)
        self._lat_stack = None
        self._rel_stack = None
        self._lat_epochs = [np.asarray(a, np.int64) for a in lat_epochs]
        self._rel_epochs = [np.asarray(a, np.float32)
                            for a in rel_epochs]

    @property
    def n_epochs(self) -> int:
        return len(self.times)

    @property
    def latency_ns(self) -> np.ndarray:
        """Stacked [T,V,V] int64 (lazy; device upload path only)."""
        if self._lat_stack is None:
            self._lat_stack = np.stack(self._lat_epochs)
        return self._lat_stack

    @property
    def reliability(self) -> np.ndarray:
        """Stacked [T,V,V] float32 (lazy; device upload path only)."""
        if self._rel_stack is None:
            self._rel_stack = np.stack(self._rel_epochs)
        return self._rel_stack

    @property
    def min_latency_ns(self) -> int:
        """Conservative lookahead floor across every epoch — a degrade
        can only keep or raise the window, never shrink it under a
        backend's feet (all backends consume the same value)."""
        return min(int(a.min()) for a in self._lat_epochs)

    def epoch_of(self, now: int) -> int:
        """Active epoch at send time `now`: the largest i with
        times[i] <= now (binary search; the device engines compute the
        identical index with a vectorized comparison count)."""
        return int(np.searchsorted(self.times, now, side="right") - 1)

    def lookup(self, now: int, src_vertex: int,
               dst_vertex: int) -> tuple[int, float]:
        e = self.epoch_of(now)
        return (int(self._lat_epochs[e][src_vertex, dst_vertex]),
                float(self._rel_epochs[e][src_vertex, dst_vertex]))


class HierFaultTable:
    """The hierarchical twin of FaultTable: one factored table set
    (hierarchy.HierTables) per epoch instead of [V,V] matrices, built
    by _compile_hier in O(affected links + C^2 + V) per changed epoch.
    Unchanged epochs share the topology's base table LEAVES by
    reference; within a changed epoch, only the leaves a fault
    actually touches are new arrays. The device backends consume
    lat_parts_stacked()/rel_parts_stacked() — each factored leaf with
    a leading [T] epoch axis — resolved through
    hierarchy.world_tables."""

    is_hierarchical = True

    def __init__(self, times, epochs):
        self.times = np.asarray(times, np.int64)
        self.epochs = list(epochs)      # [T] of hierarchy.HierTables
        self._lat_stacked = None
        self._rel_stacked = None

    @property
    def n_epochs(self) -> int:
        return len(self.times)

    @property
    def min_latency_ns(self) -> int:
        return min(ht.min_latency_ns() for ht in self.epochs)

    def epoch_of(self, now: int) -> int:
        return int(np.searchsorted(self.times, now, side="right") - 1)

    def lookup(self, now: int, src_vertex: int,
               dst_vertex: int) -> tuple[int, float]:
        return self.epochs[self.epoch_of(now)].lookup(src_vertex,
                                                      dst_vertex)

    def lat_parts_stacked(self) -> tuple:
        """(cluster_lat [T,C,C], cl [T,V], acc_lat [T,V],
        self_lat [T,V]) (lazy, cached). Every epoch has the same cl;
        the device world uploads it once (device/engine.py
        `world_arrays`)."""
        if self._lat_stacked is None:
            T = self.n_epochs
            self._lat_stacked = (
                np.stack([h.cluster_lat for h in self.epochs]),
                np.repeat(self.epochs[0].cl[None], T, axis=0),
                np.stack([h.acc_lat for h in self.epochs]),
                np.stack([h.self_lat for h in self.epochs]))
        return self._lat_stacked

    def rel_parts_stacked(self) -> tuple:
        if self._rel_stacked is None:
            T = self.n_epochs
            self._rel_stacked = (
                np.stack([h.cluster_rel for h in self.epochs]),
                np.repeat(self.epochs[0].cl[None], T, axis=0),
                np.stack([h.acc_rel for h in self.epochs]),
                np.stack([h.self_rel for h in self.epochs]))
        return self._rel_stacked


def split_events(events) -> tuple[list, list]:
    """(link_events, host_events), each in schedule order."""
    link = [e for e in events or () if e.kind in LINK_KINDS]
    host = [e for e in events or () if e.kind in HOST_KINDS]
    return link, host


def _edge_indices(top: Topology, ev: FaultEvent) -> list[int]:
    """Indices of every (parallel) edge between the event's endpoints.
    GML ids resolve through the topology; a fault on a nonexistent
    edge is a config error, caught at load time."""
    try:
        s = top.vertex_index_for_id(ev.source)
        d = top.vertex_index_for_id(ev.target)
    except Exception as e:
        raise ValueError(
            f"network.faults: {ev.kind} at {ev.time} ns references "
            f"unknown vertex id(s) {ev.source}->{ev.target}") from e
    hit = [k for k in range(len(top.edge_src))
           if (top.edge_src[k] == s and top.edge_dst[k] == d)
           or (not top.directed
               and top.edge_src[k] == d and top.edge_dst[k] == s)]
    if not hit:
        raise ValueError(
            f"network.faults: {ev.kind} at {ev.time} ns names edge "
            f"{ev.source}->{ev.target}, but the graph has no such "
            "edge")
    return hit


def _epoch_edge_state(events: list, ordered: list,
                      keyed: list, t: int) -> tuple[set, list]:
    """(down_edges, active_degrades) at epoch start time `t` — the
    edge state both the dense and hierarchical compilers replay."""
    down_edges: set[int] = set()
    for i in ordered:
        ev = events[i]
        if ev.time > t:
            break
        _, eids = keyed[i]
        if ev.kind == "link_down":
            down_edges.update(eids)
        elif ev.kind == "link_up":
            down_edges.difference_update(eids)
    degrades = [(events[i], keyed[i][1]) for i in ordered
                if events[i].kind == "degrade"
                and events[i].time <= t
                < events[i].time + events[i].duration]
    return down_edges, degrades


def compile_link_faults(top: Topology,
                        events: list) -> Optional[FaultTable]:
    """Compile the link-fault schedule into a FaultTable (None when no
    link events are configured — the fault-free fast paths stay
    byte-identical to before). Validates pairing (link_up must undo an
    earlier link_down; no double-down), then rebuilds the all-pairs
    matrices per epoch from the modified edge set using the same
    dense_adjacency + compute_path_matrices pipeline as the base
    topology."""
    if not events:
        return None

    for ev in events:
        if ev.time < 0:
            raise ValueError(
                f"network.faults: {ev.kind} has negative time")
        if ev.kind == "degrade":
            if ev.duration <= 0:
                raise ValueError(
                    f"network.faults: degrade at {ev.time} ns needs "
                    "duration > 0")
            if ev.latency_multiplier <= 0:
                raise ValueError(
                    f"network.faults: degrade at {ev.time} ns needs "
                    "latency_multiplier > 0")
            if not (0.0 <= ev.extra_packet_loss <= 1.0):
                raise ValueError(
                    f"network.faults: degrade at {ev.time} ns "
                    "extra_packet_loss must be in [0,1]")
            if ev.latency_multiplier == 1.0 and \
                    ev.extra_packet_loss == 0.0:
                raise ValueError(
                    f"network.faults: degrade at {ev.time} ns changes "
                    "nothing (latency_multiplier 1 and "
                    "extra_packet_loss 0)")

    # resolve endpoints once; pair-key = frozenset-ish sorted vertex
    # tuple for undirected graphs so down/up pairing matches an event
    # written in either direction
    def pair_key(ev):
        ids = _edge_indices(top, ev)
        s = top.vertex_index_for_id(ev.source)
        d = top.vertex_index_for_id(ev.target)
        key = (s, d) if top.directed else tuple(sorted((s, d)))
        return key, ids

    # sweep in (time, config order) to validate down/up pairing
    down_at: dict = {}
    ordered = sorted(range(len(events)), key=lambda i: (events[i].time, i))
    keyed = [pair_key(e) for e in events]
    for i in ordered:
        ev = events[i]
        key, _ = keyed[i]
        if ev.kind == "link_down":
            if key in down_at:
                raise ValueError(
                    f"network.faults: link_down at {ev.time} ns on "
                    f"edge {ev.source}->{ev.target}, but the link is "
                    f"already down (since {down_at[key]} ns)")
            down_at[key] = ev.time
        elif ev.kind == "link_up":
            if key not in down_at:
                raise ValueError(
                    f"network.faults: link_up at {ev.time} ns on edge "
                    f"{ev.source}->{ev.target} without a preceding "
                    "link_down")
            if down_at[key] == ev.time:
                raise ValueError(
                    f"network.faults: link_down and link_up on edge "
                    f"{ev.source}->{ev.target} at the same instant "
                    f"({ev.time} ns) is ambiguous")
            del down_at[key]

    # epoch boundaries: 0 plus every instant the edge state changes
    bounds = {0}
    for ev in events:
        bounds.add(ev.time)
        if ev.kind == "degrade":
            bounds.add(ev.time + ev.duration)
    times = np.array(sorted(bounds), dtype=np.int64)

    if top.hier is not None:
        return _compile_hier(top, events, times, ordered, keyed)

    V = top.n_vertices
    base_lat, base_rel = top.latency_ns, top.reliability
    lat_epochs, rel_epochs = [], []
    for t in times:
        down_edges, degrades = _epoch_edge_state(events, ordered,
                                                 keyed, t)
        if not down_edges and not degrades:
            # share the healthy base matrices by reference — the
            # stacked arrays only materialize lazily for the device
            # backends, so unchanged epochs never copy a [V,V] pair
            lat_epochs.append(base_lat)
            rel_epochs.append(base_rel)
            continue
        elat = top.edge_latency_ns.copy()
        erel = top.edge_reliability.astype(np.float64)
        alive = np.ones(len(elat), dtype=bool)
        for k in down_edges:
            alive[k] = False
        for ev, eids in degrades:
            for k in eids:
                elat[k] = max(1, int(round(
                    int(elat[k]) * ev.latency_multiplier)))
                erel[k] = erel[k] * (1.0 - ev.extra_packet_loss)
        direct_lat, direct_rel = dense_adjacency(
            V, top.directed, top.edge_src, top.edge_dst, elat,
            erel.astype(np.float32), edge_alive=alive)
        lat, rel = compute_path_matrices(
            direct_lat, direct_rel, top.use_shortest_path,
            unreachable_lat=base_lat)
        lat_epochs.append(lat)
        rel_epochs.append(rel)

    return FaultTable(times=times, lat_epochs=lat_epochs,
                      rel_epochs=rel_epochs)


def _hub_connected(n_clusters: int, rv: np.ndarray,
                   ru: np.ndarray) -> bool:
    """Is the (alive) hub subgraph connected? Plain BFS over the
    reduced adjacency entries — C is small by construction."""
    if n_clusters <= 1:
        return True
    nbrs: dict[int, list[int]] = {}
    for a, b in zip(rv.tolist(), ru.tolist()):
        if a != b:
            nbrs.setdefault(a, []).append(b)
            nbrs.setdefault(b, []).append(a)
    seen = {0}
    stack = [0]
    while stack:
        for b in nbrs.get(stack.pop(), ()):
            if b not in seen:
                seen.add(b)
                stack.append(b)
    return len(seen) == n_clusters


def _compile_hier(top: Topology, events: list, times: np.ndarray,
                  ordered: list, keyed: list) -> HierFaultTable:
    """Hierarchical epoch compilation: instead of re-running the
    all-pairs pipeline over [V,V], rebuild only the factored pieces a
    fault touches — the [C,C] cluster pair when a hub-hub link
    changes, the access/self entries of the vertices incident to an
    affected edge otherwise. O(affected links + C^2 + V) per changed
    epoch; unchanged epochs share the base table leaves by reference.

    Exactness vs the dense oracle follows the same composition
    contract as the base builder (topology/hierarchy.py), with one
    extra corner: the dense pipeline gives an *unreachable* pair its
    healthy base latency, which the factored form can only reproduce
    while the latency factors it would compose still equal the base.
    An epoch that combines unreachability with latency-factor changes
    is therefore rejected loudly (the dense representation handles
    it). Every epoch is additionally verified elementwise against the
    dense pipeline when V <= HIER_VERIFY_MAX_V."""
    ht = top.hier
    V = top.n_vertices
    C = ht.n_clusters
    is_hub = np.zeros(V, dtype=bool)
    is_hub[ht.hub_vertex] = True
    hub_rank = np.full(V, -1, dtype=np.int64)
    hub_rank[ht.hub_vertex] = np.arange(C, dtype=np.int64)
    esrc = np.asarray(top.edge_src, np.int64)
    edst = np.asarray(top.edge_dst, np.int64)

    # vertices any event's edge touches, and the slice of edges
    # incident to them: a touched vertex's FULL candidate edge set
    # rides in the slice, so its access/self entries re-reduce with
    # dense_adjacency's exact tie rule (slice order preserves
    # original edge order)
    ev_edges = sorted({k for _, eids in keyed for k in eids})
    touched = np.zeros(V, dtype=bool)
    touched[esrc[ev_edges]] = True
    touched[edst[ev_edges]] = True
    inc = np.nonzero(touched[esrc] | touched[edst])[0]
    hub_pair = is_hub[esrc] & is_hub[edst] & (esrc != edst)
    hub_sel = np.nonzero(is_hub[esrc] & is_hub[edst])[0]
    aff_spokes = np.nonzero(touched & ~is_hub)[0]
    aff_vs = np.nonzero(touched)[0]

    base_dense = ht.dense() if V <= hierarchy.HIER_VERIFY_MAX_V \
        else None

    epochs = []
    for t in times:
        down_edges, degrades = _epoch_edge_state(events, ordered,
                                                 keyed, t)
        if not down_edges and not degrades:
            epochs.append(ht)
            continue
        elat = top.edge_latency_ns.copy()
        erel = top.edge_reliability.astype(np.float64)
        alive = np.ones(len(elat), dtype=bool)
        changed = set(down_edges)
        for k in down_edges:
            alive[k] = False
        for ev, eids in degrades:
            for k in eids:
                elat[k] = max(1, int(round(
                    int(elat[k]) * ev.latency_multiplier)))
                erel[k] = erel[k] * (1.0 - ev.extra_packet_loss)
                changed.add(k)
        changed_idx = np.fromiter(changed, dtype=np.int64)

        # [C,C] rebuild — only when a hub-hub link changed; the hub
        # subgraph re-reduces and re-runs shortest paths exactly like
        # the base builder, with unreachable hub pairs taking the
        # healthy base cluster latency (the dense unreachable rule)
        hub_unreach = False
        if changed_idx.size and hub_pair[changed_idx].any():
            rv, ru, rl, rr = sparse_min_adjacency(
                C, False, hub_rank[esrc[hub_sel]],
                hub_rank[edst[hub_sel]], elat[hub_sel],
                erel[hub_sel].astype(np.float32),
                edge_alive=alive[hub_sel])
            dlat = np.zeros((C, C), dtype=np.int64)
            drel = np.zeros((C, C), dtype=np.float32)
            dlat[rv, ru] = rl
            drel[rv, ru] = rr
            hub_unreach = not _hub_connected(C, rv, ru)
            cc_lat, cc_rel = _all_pairs_shortest(dlat, drel,
                                                 ht.cluster_lat)
            np.fill_diagonal(cc_lat, 0)
            np.fill_diagonal(cc_rel, 1.0)
            cc_lat = cc_lat.astype(np.int64)
            cc_rel = cc_rel.astype(np.float32)
        else:
            cc_lat, cc_rel = ht.cluster_lat, ht.cluster_rel

        # re-reduce the incident slice once; update access entries of
        # touched spokes and self entries of every touched vertex
        rv2, ru2, rl2, rr2 = sparse_min_adjacency(
            V, False, esrc[inc], edst[inc], elat[inc],
            erel[inc].astype(np.float32), edge_alive=alive[inc])
        acc_lat, acc_rel = ht.acc_lat, ht.acc_rel
        downed_spokes = []
        acc_lat_changed = False
        if aff_spokes.size:
            acc_lat = acc_lat.copy()
            acc_rel = acc_rel.copy()
            off2 = rv2 != ru2
            for v in aff_spokes.tolist():
                sel = np.nonzero(off2 & (rv2 == v))[0]
                if not sel.size:
                    # the spoke's only link is down: the pair is
                    # undeliverable (rel 0) at the healthy latency,
                    # exactly the dense unreachable rule
                    downed_spokes.append(v)
                    acc_rel[v] = 0.0
                else:
                    j = sel[0]   # a spoke has exactly one neighbor
                    if int(rl2[j]) != int(ht.acc_lat[v]):
                        acc_lat_changed = True
                    acc_lat[v] = rl2[j]
                    acc_rel[v] = rr2[j]

        self_lat = ht.self_lat.copy()
        self_rel = ht.self_rel.copy()
        cand_lat = np.where(rv2 == ru2, rl2, 2 * rl2)
        cand_rel = np.where(rv2 == ru2, rr2,
                            (rr2 * rr2).astype(np.float32))
        order2 = np.lexsort((cand_rel.astype(np.float64), cand_lat,
                             rv2))
        sv_ = rv2[order2]
        sl_, sr_ = cand_lat[order2], cand_rel[order2]
        firstv = np.ones(len(sv_), dtype=bool)
        firstv[1:] = sv_[1:] != sv_[:-1]
        got = set()
        for j in np.nonzero(firstv)[0]:
            v = int(sv_[j])
            # only touched vertices carry their full candidate set in
            # the slice; everyone else keeps the base self entry
            if touched[v]:
                self_lat[v] = sl_[j]
                self_rel[v] = sr_[j]
                got.add(v)
        for v in aff_vs.tolist():
            if v not in got:      # no alive incident edge: the dense
                self_lat[v] = _MIN_PATH_LATENCY_NS  # zero-lat clamp
                self_rel[v] = 1.0

        cc_lat_changed = cc_lat is not ht.cluster_lat and \
            not np.array_equal(cc_lat, ht.cluster_lat)
        if downed_spokes and (acc_lat_changed or cc_lat_changed):
            raise ValueError(
                f"network.faults: epoch at {int(t)} ns combines an "
                "unreachable pair (downed access link) with latency "
                "changes elsewhere; the dense pipeline pins "
                "unreachable pairs to their HEALTHY base latency, "
                "which the factored tables cannot reproduce while "
                "their latency factors change — use "
                "network.topology.representation: dense for this "
                "schedule")
        if hub_unreach and acc_lat_changed:
            raise ValueError(
                f"network.faults: epoch at {int(t)} ns combines an "
                "unreachable hub pair with access-latency changes; "
                "the dense pipeline pins unreachable pairs to their "
                "HEALTHY base latency, which the factored tables "
                "cannot reproduce while their latency factors change "
                "— use network.topology.representation: dense for "
                "this schedule")

        eht = hierarchy.HierTables(
            cluster_lat=cc_lat, cluster_rel=cc_rel,
            cl=ht.cl, hub_vertex=ht.hub_vertex,
            acc_lat=acc_lat, acc_rel=acc_rel,
            self_lat=self_lat, self_rel=self_rel)

        if base_dense is not None:
            direct_lat, direct_rel = dense_adjacency(
                V, top.directed, top.edge_src, top.edge_dst, elat,
                erel.astype(np.float32), edge_alive=alive)
            want_lat, want_rel = compute_path_matrices(
                direct_lat, direct_rel, top.use_shortest_path,
                unreachable_lat=base_dense[0])
            have_lat, have_rel = eht.dense()
            if not (np.array_equal(want_lat, have_lat)
                    and np.array_equal(want_rel, have_rel)):
                raise ValueError(
                    f"network.faults: epoch at {int(t)} ns is not "
                    "bit-exact against the dense fault pipeline "
                    "under the hierarchical representation — use "
                    "network.topology.representation: dense for "
                    "this schedule")
        epochs.append(eht)

    return HierFaultTable(times=times, epochs=epochs)


def resolve_host_faults(events: list,
                        name_to_id) -> list[tuple[int, int, str]]:
    """Validate host_crash/host_restart events against the hosts:
    names must resolve (group-expanded names like ``client0``; any
    mapping-like with ``.get``, such as core/build.py `HostNames`), and
    each host's schedule must alternate crash -> restart. Returns
    [(time, host_id, kind)] sorted by time."""
    out: list[tuple[int, int, str]] = []
    state: dict[int, str] = {}
    for ev in sorted(events, key=lambda e: e.time):
        if ev.time < 0:
            raise ValueError(
                f"network.faults: {ev.kind} has negative time")
        hid = name_to_id.get(ev.host)
        if hid is None:
            raise ValueError(
                f"network.faults: {ev.kind} at {ev.time} ns names "
                f"unknown host {ev.host!r}")
        prev = state.get(hid, "up")
        if ev.kind == "host_crash" and prev == "down":
            raise ValueError(
                f"network.faults: host_crash at {ev.time} ns, but "
                f"{ev.host!r} is already crashed")
        if ev.kind == "host_restart" and prev == "up":
            raise ValueError(
                f"network.faults: host_restart at {ev.time} ns "
                f"without a preceding host_crash of {ev.host!r}")
        state[hid] = "down" if ev.kind == "host_crash" else "up"
        out.append((ev.time, hid, ev.kind))
    return out
