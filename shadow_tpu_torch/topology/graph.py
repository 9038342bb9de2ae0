"""Network topology (the port's copy of the reference package's
topology/graph.py).

All-pairs latency and reliability tables are computed once at load
time, in one of two representations (`network.topology.representation`):
dense [V,V] matrices, so every per-packet lookup on the card is one
gather, or cluster-factored tables (topology/hierarchy.py) on
hub-and-spoke graphs, looked up in two levels.

Semantics kept from the reference:

* vertices require `bandwidth_down`/`bandwidth_up` unit strings;
* edges require `latency` (> 0) and `packet_loss` in [0,1];
* the graph must be connected (strongly, if directed);
* `use_shortest_path=false` requires a complete graph and uses direct
  edges only;
* self-paths: a self-loop edge is used as-is; otherwise the cheapest
  incident edge is used out-and-back (latency doubled, reliability
  squared);
* computed zero-latency paths are clamped to 1 ms;
* reliability of a multi-edge path is the product of per-edge
  (1 - packet_loss).

The factored form is built by `build_hier_tables` and chosen by
`Topology._compute_paths`: `hierarchical` is a hard error on a graph
that does not factor or (V <= HIER_VERIFY_MAX_V) whose factored tables
differ from the dense ones by one bit; `auto` falls back to dense with
a log line there, and where factoring would not shrink the tables.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

from shadow_tpu_torch import simtime
from shadow_tpu_torch.config.units import parse_bandwidth_bits, parse_time_ns
from shadow_tpu_torch.topology.gml import GmlError, GmlGraph, parse_gml
from shadow_tpu_torch.topology.hierarchy import (
    HIER_VERIFY_MAX_V,
    HierTables,
)

log = logging.getLogger("shadow_tpu_torch.topology")

REPRESENTATIONS = ("dense", "hierarchical", "auto")

ONE_GBIT_SWITCH_GML = """graph [
  directed 0
  node [
    id 0
    ip_address "0.0.0.0"
    bandwidth_up "1 Gbit"
    bandwidth_down "1 Gbit"
  ]
  edge [
    source 0
    target 0
    latency "1 ms"
    packet_loss 0.0
  ]
]"""

_MIN_PATH_LATENCY_NS = simtime.SIMTIME_ONE_MILLISECOND  # 0-latency clamp


def dense_adjacency(n_vertices: int, directed: bool,
                    edge_src: np.ndarray, edge_dst: np.ndarray,
                    edge_latency_ns: np.ndarray,
                    edge_reliability: np.ndarray,
                    edge_alive: Optional[np.ndarray] = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Dense [V,V] direct-edge latency (ns; 0 = no edge) and
    reliability matrices, keeping the cheapest parallel edge.
    `edge_alive` (bool [E], default all alive) masks edges out: the
    fault compiler (faults.py) builds an epoch's adjacency through this
    same code with its downed links masked."""
    V = n_vertices
    lat = np.zeros((V, V), dtype=np.int64)
    rel = np.zeros((V, V), dtype=np.float32)

    def _store(s, d, l, r):
        if lat[s, d] == 0 or l < lat[s, d]:
            lat[s, d] = l
            rel[s, d] = r

    for k, (s, d, l, r) in enumerate(zip(edge_src, edge_dst,
                                         edge_latency_ns,
                                         edge_reliability)):
        if edge_alive is not None and not edge_alive[k]:
            continue
        _store(s, d, l, r)
        if not directed:
            _store(d, s, l, r)
    return lat, rel


def sparse_min_adjacency(n_vertices: int, directed: bool,
                         edge_src: np.ndarray, edge_dst: np.ndarray,
                         edge_latency_ns: np.ndarray,
                         edge_reliability: np.ndarray,
                         edge_alive: Optional[np.ndarray] = None
                         ) -> tuple[np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
    """Sparse twin of dense_adjacency: (v, u, lat, rel) with one row per
    ordered vertex pair that has an (alive) edge, under
    dense_adjacency's parallel-edge rule (the first edge reaching the
    least latency, in its store order, wins). O(E log E); never
    materializes [V,V]."""
    esrc = np.asarray(edge_src, np.int64)
    edst = np.asarray(edge_dst, np.int64)
    elat = np.asarray(edge_latency_ns, np.int64)
    erel = np.asarray(edge_reliability, np.float32)
    if edge_alive is not None:
        keep = np.asarray(edge_alive, bool)
        # the original edge index keeps the tie rule under a mask
        order = np.nonzero(keep)[0].astype(np.int64)
        esrc, edst = esrc[keep], edst[keep]
        elat, erel = elat[keep], erel[keep]
    else:
        order = np.arange(len(esrc), dtype=np.int64)
    if directed:
        v, u, l, r, o = esrc, edst, elat, erel, 2 * order
    else:
        # the store of (s, d) precedes that of (d, s) within an edge
        v = np.concatenate([esrc, edst])
        u = np.concatenate([edst, esrc])
        l = np.concatenate([elat, elat])
        r = np.concatenate([erel, erel])
        o = np.concatenate([2 * order, 2 * order + 1])
    key = v * np.int64(n_vertices) + u
    idx = np.lexsort((o, l, key))
    key_s = key[idx]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    sel = idx[first]
    return v[sel], u[sel], l[sel], r[sel]


def build_hier_tables(top: "Topology") -> HierTables:
    """Factor a topology into cluster tables.

    Spokes are vertices with exactly one distinct non-self neighbour
    whose own degree exceeds one; every other vertex is a hub and its
    own cluster. Spokes are dead ends, so every shortest path is
    access + hub path + access, and hub-to-hub shortest paths never
    pass a spoke: the [C,C] tables are the dense pipeline on the hub
    subgraph alone. Raises GmlError when the graph cannot take the
    factored form (directed, or direct-edge-only routing)."""
    if top.directed:
        raise GmlError("hierarchical representation requires an "
                       "undirected graph")
    if not top.use_shortest_path:
        raise GmlError("hierarchical representation requires "
                       "use_shortest_path: true (direct-edge-only "
                       "routing does not factor)")
    V = top.n_vertices
    av, au, alat, arel = sparse_min_adjacency(
        V, False, top.edge_src, top.edge_dst,
        top.edge_latency_ns, top.edge_reliability)

    off = av != au
    ov, ou = av[off], au[off]
    olat, orel = alat[off], arel[off]
    deg = np.bincount(ov, minlength=V)        # distinct neighbours
    nbr_of = np.full(V, 0, dtype=np.int64)
    nbr_of[ov] = ou                           # exact where deg == 1
    spoke = (deg == 1) & (deg[nbr_of] > 1)

    hub_vertex = np.nonzero(~spoke)[0].astype(np.int64)
    C = len(hub_vertex)
    hub_rank = np.full(V, -1, dtype=np.int64)
    hub_rank[hub_vertex] = np.arange(C, dtype=np.int64)
    cl = hub_rank.copy()
    cl[spoke] = hub_rank[nbr_of[spoke]]

    # access terms: the spoke's reduced edge to its hub
    acc_lat = np.zeros(V, dtype=np.int64)
    acc_rel = np.ones(V, dtype=np.float32)
    m = spoke[ov]
    acc_lat[ov[m]] = olat[m]
    acc_rel[ov[m]] = orel[m]

    # cluster tables: dense shortest paths over the hubs alone
    if C == 1:
        cc_lat = np.zeros((1, 1), dtype=np.int64)
        cc_rel = np.ones((1, 1), dtype=np.float32)
    else:
        hub_edge = (~spoke)[top.edge_src] & (~spoke)[top.edge_dst]
        hsrc = hub_rank[np.asarray(top.edge_src)[hub_edge]]
        hdst = hub_rank[np.asarray(top.edge_dst)[hub_edge]]
        rv, ru, rl, rr = sparse_min_adjacency(
            C, False, hsrc, hdst,
            np.asarray(top.edge_latency_ns)[hub_edge],
            np.asarray(top.edge_reliability)[hub_edge])
        dlat = np.zeros((C, C), dtype=np.int64)
        drel = np.zeros((C, C), dtype=np.float32)
        dlat[rv, ru] = rl
        drel[rv, ru] = rr
        # a disconnected hub subgraph would contradict the full graph's
        # connectivity; _all_pairs_shortest raises if it ever happens
        cc_lat, cc_rel = _all_pairs_shortest(dlat, drel)
    np.fill_diagonal(cc_lat, 0)               # transit identity; true
    np.fill_diagonal(cc_rel, 1.0)             # self paths below

    # self vectors: the dense self-path rule (self-loop as-is, else the
    # cheapest incident edge out and back), least (lat, rel) first
    cand_v = av
    cand_lat = np.where(av == au, alat, 2 * alat)
    cand_rel = np.where(av == au, arel, (arel * arel).astype(np.float32))
    order = np.lexsort((cand_rel.astype(np.float64), cand_lat, cand_v))
    sv_, sl_, sr_ = cand_v[order], cand_lat[order], cand_rel[order]
    firstv = np.ones(len(sv_), dtype=bool)
    firstv[1:] = sv_[1:] != sv_[:-1]
    # no incident edge at all: the dense zero-latency clamp value
    self_lat = np.full(V, _MIN_PATH_LATENCY_NS, dtype=np.int64)
    self_rel = np.ones(V, dtype=np.float32)
    self_lat[sv_[firstv]] = sl_[firstv]
    self_rel[sv_[firstv]] = sr_[firstv]

    return HierTables(
        cluster_lat=cc_lat.astype(np.int64),
        cluster_rel=cc_rel.astype(np.float32),
        cl=cl.astype(np.int32), hub_vertex=hub_vertex,
        acc_lat=acc_lat, acc_rel=acc_rel,
        self_lat=self_lat, self_rel=self_rel)


def compute_path_matrices(direct_lat: np.ndarray, direct_rel: np.ndarray,
                          use_shortest_path: bool,
                          unreachable_lat: Optional[np.ndarray] = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (latency, reliability) path matrices from a dense
    direct-edge adjacency.

    `unreachable_lat`: None = a disconnected pair raises GmlError (the
    base topology's contract); otherwise a [V,V] latency matrix whose
    entries stand in for unreachable pairs, with reliability 0 (the
    fault compiler passes the healthy base matrix: the pair drops every
    packet, its latency stays finite)."""
    V = direct_lat.shape[0]
    if not use_shortest_path:
        path_lat = direct_lat.copy()
        path_rel = direct_rel.copy()
        # fault epochs only: a zero off-diagonal entry of a complete
        # graph is a downed link, unreachable rather than clamped to a
        # 1 ms lossless path below
        if unreachable_lat is not None:
            miss = (path_lat <= 0) & ~np.eye(V, dtype=bool)
            if miss.any():
                path_rel = np.where(miss, 0.0, path_rel)
                path_lat = np.where(miss, unreachable_lat, path_lat)
    else:
        path_lat, path_rel = _all_pairs_shortest(direct_lat, direct_rel,
                                                 unreachable_lat)

    # self paths: self-loop edge as-is, otherwise cheapest incident
    # edge doubled
    for v in range(V):
        options: list[tuple[int, float]] = []
        if direct_lat[v, v] > 0:
            options.append((int(direct_lat[v, v]),
                            float(direct_rel[v, v])))
        options.extend(
            (int(2 * direct_lat[v, u]), float(direct_rel[v, u] ** 2))
            for u in range(V) if u != v and direct_lat[v, u] > 0)
        if options:
            path_lat[v, v], path_rel[v, v] = min(options)
        else:
            path_lat[v, v], path_rel[v, v] = 0, 1.0

    # clamp only *zero*-latency paths to 1 ms
    zero = path_lat <= 0
    if zero.any():
        path_rel = np.where(zero, 1.0, path_rel)
        path_lat = np.where(zero, _MIN_PATH_LATENCY_NS, path_lat)
    return path_lat.astype(np.int64), path_rel.astype(np.float32)


def _all_pairs_shortest(direct_lat: np.ndarray, direct_rel: np.ndarray,
                        unreachable_lat: Optional[np.ndarray] = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs Dijkstra by latency; reliability accumulates along the
    chosen (latency-)shortest path via the predecessor tree."""
    V = direct_lat.shape[0]
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import dijkstra
    except ImportError:
        return _all_pairs_minplus(direct_lat, direct_rel,
                                  unreachable_lat)

    # self-loops are not transit edges; self paths are computed apart
    w = direct_lat.astype(np.float64)
    np.fill_diagonal(w, 0.0)
    dist, pred = dijkstra(csr_matrix(w), directed=True,
                          return_predecessors=True)
    unreachable = np.isinf(dist)
    if unreachable.any() and unreachable_lat is None:
        raise GmlError("graph is not connected (no path between some "
                       "vertex pair)")

    # hop level of every (s, d) by fixpoint, then rel[s,d] =
    # rel[s,pred[d]] * edge_rel[pred[d],d] level by level
    hops = np.full((V, V), -1, dtype=np.int64)
    np.fill_diagonal(hops, 0)
    for _ in range(V):
        pending = (pred >= 0) & (hops < 0)
        if not pending.any():
            break
        s_idx, d_idx = np.nonzero(pending)
        parent_hops = hops[s_idx, pred[s_idx, d_idx]]
        ready = parent_hops >= 0
        if not ready.any():
            break
        hops[s_idx[ready], d_idx[ready]] = parent_hops[ready] + 1

    rel = np.zeros((V, V), dtype=np.float64)
    np.fill_diagonal(rel, 1.0)
    for h in range(1, int(hops.max()) + 1):
        s_idx, d_idx = np.nonzero(hops == h)
        pr = pred[s_idx, d_idx]
        rel[s_idx, d_idx] = rel[s_idx, pr] * direct_rel[pr, d_idx]
    lat = np.rint(np.where(unreachable, 0.0, dist)).astype(np.int64)
    if unreachable.any():
        lat = np.where(unreachable, unreachable_lat, lat)
        rel = np.where(unreachable, 0.0, rel)
    return lat, rel.astype(np.float32)


def _all_pairs_minplus(direct_lat: np.ndarray, direct_rel: np.ndarray,
                       unreachable_lat: Optional[np.ndarray] = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Dense Floyd-Warshall carrying reliability, scipy-free."""
    V = direct_lat.shape[0]
    lat = np.where(direct_lat > 0, direct_lat.astype(np.float64), np.inf)
    np.fill_diagonal(lat, 0.0)
    rel = np.where(direct_lat > 0, direct_rel.astype(np.float64), 0.0)
    np.fill_diagonal(rel, 1.0)
    for k in range(V):
        via = lat[:, k, None] + lat[None, k, :]
        better = via < lat
        lat = np.where(better, via, lat)
        rel = np.where(better, rel[:, k, None] * rel[None, k, :], rel)
    unreachable = np.isinf(lat)
    if unreachable.any():
        if unreachable_lat is None:
            raise GmlError("graph is not connected (no path between "
                           "some vertex pair)")
        lat = np.where(unreachable, unreachable_lat.astype(np.float64),
                       lat)
        rel = np.where(unreachable, 0.0, rel)
    return np.rint(lat).astype(np.int64), rel.astype(np.float32)


def _parse_edge_latency_ns(value) -> int:
    """Edge latency: a unit string ("50 ms"); bare numbers are
    milliseconds."""
    if isinstance(value, (int, float)):
        return int(round(value * simtime.SIMTIME_ONE_MILLISECOND))
    return parse_time_ns(value)


@dataclass
class Topology:
    directed: bool
    complete: bool
    use_shortest_path: bool
    vertex_ids: np.ndarray          # [V] original GML ids
    edge_src: np.ndarray            # [E] vertex indices
    edge_dst: np.ndarray
    edge_latency_ns: np.ndarray     # [E] int64
    edge_reliability: np.ndarray    # [E] float32 (1 - packet_loss)
    bw_down_bits: np.ndarray        # [V] int64 bits/s
    bw_up_bits: np.ndarray          # [V] int64 bits/s
    # dense: [V,V] int64 path latency and float32 path reliability;
    # hierarchical: both None, the factored tables are in `hier`
    latency_ns: Optional[np.ndarray]
    reliability: Optional[np.ndarray]
    representation: str = "dense"
    hier: Optional[HierTables] = None

    @property
    def n_vertices(self) -> int:
        return len(self.vertex_ids)

    @property
    def min_latency_ns(self) -> int:
        """Minimum path latency: the conservative lookahead window."""
        if self.hier is not None:
            return self.hier.min_latency_ns()
        return int(self.latency_ns.min())

    def path(self, src_vertex: int, dst_vertex: int) -> tuple[int, float]:
        """(latency_ns, reliability) in either representation."""
        if self.hier is not None:
            return self.hier.lookup(src_vertex, dst_vertex)
        return (int(self.latency_ns[src_vertex, dst_vertex]),
                float(self.reliability[src_vertex, dst_vertex]))

    def table_nbytes(self) -> int:
        """Bytes of the path tables this representation holds."""
        if self.hier is not None:
            return self.hier.nbytes()
        return int(self.latency_ns.nbytes + self.reliability.nbytes)

    def vertex_index_for_id(self, gml_id: int) -> int:
        idx = np.nonzero(self.vertex_ids == gml_id)[0]
        if len(idx) == 0:
            raise GmlError(f"no vertex with GML id {gml_id}")
        return int(idx[0])

    @classmethod
    def from_gml(cls, text: str, use_shortest_path: bool = True,
                 representation: str = "dense") -> "Topology":
        return cls.from_parsed(parse_gml(text), use_shortest_path,
                               representation)

    @classmethod
    def builtin_1_gbit_switch(cls, representation: str = "dense"
                              ) -> "Topology":
        return cls.from_gml(ONE_GBIT_SWITCH_GML, use_shortest_path=True,
                            representation=representation)

    @classmethod
    def from_parsed(cls, g: GmlGraph, use_shortest_path: bool,
                    representation: str = "dense") -> "Topology":
        V = len(g.nodes)
        if V == 0:
            raise GmlError("graph has no vertices")
        ids = np.array([int(n.get("id")) for n in g.nodes], dtype=np.int64)
        if len(set(ids.tolist())) != V:
            raise GmlError("duplicate vertex ids")
        id_to_idx = {int(i): k for k, i in enumerate(ids)}

        def _bw(node, key):
            v = node.get(key)
            if v is None:
                raise GmlError(f"vertex {node.get('id')} missing "
                               f"required attribute {key!r}")
            return parse_bandwidth_bits(v)

        bw_down = np.array([_bw(n, "bandwidth_down") for n in g.nodes],
                           dtype=np.int64)
        bw_up = np.array([_bw(n, "bandwidth_up") for n in g.nodes],
                         dtype=np.int64)

        E = len(g.edges)
        esrc = np.empty(E, dtype=np.int64)
        edst = np.empty(E, dtype=np.int64)
        elat = np.empty(E, dtype=np.int64)
        erel = np.empty(E, dtype=np.float32)
        for k, e in enumerate(g.edges):
            try:
                esrc[k] = id_to_idx[int(e.get("source"))]
                edst[k] = id_to_idx[int(e.get("target"))]
            except KeyError as bad:
                raise GmlError(
                    f"edge references unknown vertex id "
                    f"{bad}") from bad
            lat = e.get("latency")
            if lat is None:
                raise GmlError("edge missing required attribute 'latency'")
            elat[k] = _parse_edge_latency_ns(lat)
            if elat[k] <= 0:
                raise GmlError(f"edge {k} has latency <= 0")
            loss = e.get("packet_loss")
            if loss is None:
                raise GmlError("edge missing required attribute "
                               "'packet_loss'")
            loss = float(loss)
            if not (0.0 <= loss <= 1.0):
                raise GmlError(f"edge {k} packet_loss {loss} not in [0,1]")
            erel[k] = 1.0 - loss

        top = cls(
            directed=g.directed, complete=False,
            use_shortest_path=use_shortest_path, vertex_ids=ids,
            edge_src=esrc, edge_dst=edst, edge_latency_ns=elat,
            edge_reliability=erel, bw_down_bits=bw_down, bw_up_bits=bw_up,
            latency_ns=np.zeros((V, V), dtype=np.int64),
            reliability=np.zeros((V, V), dtype=np.float32),
        )
        top._check_connected()
        top.complete = top._detect_complete()
        if not use_shortest_path and not top.complete:
            raise GmlError("use_shortest_path=false requires a complete "
                           "graph (every ordered vertex pair needs a "
                           "direct edge)")
        top._compute_paths(representation)
        return top

    def _adjacency(self) -> tuple[np.ndarray, np.ndarray]:
        return dense_adjacency(self.n_vertices, self.directed,
                               self.edge_src, self.edge_dst,
                               self.edge_latency_ns,
                               self.edge_reliability)

    def _check_connected(self) -> None:
        """Single (strongly-)connected component."""
        V = self.n_vertices
        adj = [[] for _ in range(V)]
        radj = [[] for _ in range(V)]
        for s, d in zip(self.edge_src, self.edge_dst):
            adj[s].append(int(d))
            radj[d].append(int(s))
            if not self.directed:
                adj[d].append(int(s))
                radj[s].append(int(d))

        def _bfs(start, neighbors):
            seen = np.zeros(V, dtype=bool)
            seen[start] = True
            stack = [start]
            while stack:
                u = stack.pop()
                for v in neighbors[u]:
                    if not seen[v]:
                        seen[v] = True
                        stack.append(v)
            return seen

        if not _bfs(0, adj).all():
            raise GmlError("graph is not connected")
        if self.directed and not _bfs(0, radj).all():
            raise GmlError("directed graph is not strongly connected")

    def _detect_complete(self) -> bool:
        """Every ordered pair of distinct vertices has a direct edge."""
        V = self.n_vertices
        if V == 1:
            return True
        lat, _ = self._adjacency()
        off_diag = ~np.eye(V, dtype=bool)
        return bool((lat[off_diag] > 0).all())

    def _compute_dense(self) -> None:
        direct_lat, direct_rel = self._adjacency()
        self.latency_ns, self.reliability = compute_path_matrices(
            direct_lat, direct_rel, self.use_shortest_path)
        self.representation = "dense"
        self.hier = None

    def _compute_paths(self, representation: str = "dense") -> None:
        """The path tables in the requested representation: `dense`
        [V,V] matrices; `hierarchical` factored tables, a GmlError on a
        graph that does not factor or (V <= HIER_VERIFY_MAX_V) whose
        factored tables differ from the dense ones; `auto` factored
        where that works and shrinks the tables, dense with a log line
        otherwise."""
        if representation not in REPRESENTATIONS:
            raise GmlError(
                f"network.topology.representation must be one of "
                f"{REPRESENTATIONS}, got {representation!r}")
        if representation == "dense":
            self._compute_dense()
            return
        try:
            ht = build_hier_tables(self)
        except GmlError as why:
            if representation == "hierarchical":
                raise GmlError(
                    "network.topology.representation: hierarchical, "
                    f"but this graph does not factor: {why}") from why
            log.info("topology representation auto: dense fallback "
                     "(%s)", why)
            self._compute_dense()
            return
        if representation == "auto" and ht.n_clusters >= self.n_vertices:
            log.info("topology representation auto: dense (no spokes "
                     "— factoring would not shrink the tables, "
                     "C=%d == V=%d)", ht.n_clusters, self.n_vertices)
            self._compute_dense()
            return
        if self.n_vertices <= HIER_VERIFY_MAX_V:
            # bit-exact verification against the dense pipeline
            direct_lat, direct_rel = self._adjacency()
            dlat, drel = compute_path_matrices(
                direct_lat, direct_rel, self.use_shortest_path)
            hlat, hrel = ht.dense()
            if not (np.array_equal(dlat, hlat)
                    and np.array_equal(drel, hrel)):
                if representation == "hierarchical":
                    raise GmlError(
                        "hierarchical tables do not reproduce the "
                        "dense path matrices bit for bit (equal-cost "
                        "multipath tie-break or a float32 "
                        "reliability product that does not factor) — "
                        "use representation: dense or auto")
                log.info("topology representation auto: dense "
                         "fallback (factored tables failed the "
                         "bit-exact verification)")
                self.latency_ns, self.reliability = dlat, drel
                self.representation = "dense"
                self.hier = None
                return
        self.hier = ht
        self.representation = "hierarchical"
        self.latency_ns = None
        self.reliability = None
        log.info("topology representation hierarchical: V=%d C=%d "
                 "table bytes %d (dense would be %d)",
                 self.n_vertices, ht.n_clusters, ht.nbytes(),
                 12 * self.n_vertices ** 2)
