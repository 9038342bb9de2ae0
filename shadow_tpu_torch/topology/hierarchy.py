"""Cluster-factored topology tables (the port's copy of the reference
package's topology/hierarchy.py).

On a hub-and-spoke graph every shortest path factors exactly:

    lat[s,d] = acc_lat[s] + cluster_lat[c(s), c(d)] + acc_lat[d]
    rel[s,d] = (acc_rel[s] * cluster_rel[c(s), c(d)]) * acc_rel[d]

with s == d taken from an explicit self vector (the dense self-path
rule). Memory drops from the dense [V,V] pair to a [C,C] pair over the
hubs plus [V] vectors: 28,485,600 bytes at V=1,000,200, C=200, where the
dense pair would be about 12 TB.

Every consumer composes in ONE fixed order, so float32
non-associativity cannot split them: the CPU scalar lookup
(`HierTables.lookup`), the [V,V] materialization (`dense_from_parts`),
the plain PyTorch lookup (`gather_parts_plain`) and the CUDA kernels'
`HierTopo` view (csrc/topo.cuh). Latency is exact on every factorable
graph; reliability is exact when access links are lossless, and
`Topology._compute_paths` (topology/graph.py) proves both against the
dense pipeline bit for bit at V <= HIER_VERIFY_MAX_V.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# below this vertex count the dense matrices are materialized at load
# time to prove the factored tables reproduce them bit for bit
HIER_VERIFY_MAX_V = 2048


def compose_lat(acc_s, core, acc_d):
    """Factored latency: plain integer addition (max_composed_latency
    bounds it for the int32 device tables)."""
    return acc_s + core + acc_d


def compose_rel(acc_s, core, acc_d):
    """Factored reliability in the fixed association (acc_s * core) *
    acc_d."""
    return (acc_s * core) * acc_d


@dataclass
class HierTables:
    """The factored tables. Hubs are their own cluster (access terms 0
    ns / 1.0); the cluster diagonals are the transit identity (0 ns /
    1.0), true self paths come from the self vectors."""

    cluster_lat: np.ndarray        # [C,C] int64, diag 0
    cluster_rel: np.ndarray        # [C,C] float32, diag 1.0
    cl: np.ndarray                 # [V] int32 cluster of each vertex
    hub_vertex: np.ndarray         # [C] int64 vertex index of each hub
    acc_lat: np.ndarray            # [V] int64 access latency (hubs 0)
    acc_rel: np.ndarray            # [V] float32 access rel (hubs 1.0)
    self_lat: np.ndarray           # [V] int64 dense self-path rule
    self_rel: np.ndarray           # [V] float32

    @property
    def n_vertices(self) -> int:
        return len(self.cl)

    @property
    def n_clusters(self) -> int:
        return len(self.hub_vertex)

    def lat_parts(self) -> tuple:
        """The additive leaves, in gather_parts order."""
        return (self.cluster_lat, self.cl, self.acc_lat, self.self_lat)

    def rel_parts(self) -> tuple:
        """The multiplicative leaves, in gather_parts order."""
        return (self.cluster_rel, self.cl, self.acc_rel, self.self_rel)

    def lookup(self, sv: int, dv: int) -> tuple[int, float]:
        """(latency_ns, reliability) of one pair, float32 ops in the
        shared order."""
        if sv == dv:
            return int(self.self_lat[sv]), float(self.self_rel[sv])
        cs, cd = int(self.cl[sv]), int(self.cl[dv])
        lat = compose_lat(int(self.acc_lat[sv]),
                          int(self.cluster_lat[cs, cd]),
                          int(self.acc_lat[dv]))
        rel = compose_rel(self.acc_rel[sv], self.cluster_rel[cs, cd],
                          self.acc_rel[dv])
        return lat, float(rel)

    def dense(self) -> tuple[np.ndarray, np.ndarray]:
        """The full [V,V] matrices (verification and tests only)."""
        return dense_from_parts(self.lat_parts(), self.rel_parts())

    def min_latency_ns(self) -> int:
        return min_latency_from_parts(self.lat_parts())

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in
                   (self.cluster_lat, self.cluster_rel, self.cl,
                    self.acc_lat, self.acc_rel,
                    self.self_lat, self.self_rel))


def dense_from_parts(lat_parts, rel_parts
                     ) -> tuple[np.ndarray, np.ndarray]:
    """[V,V] materialization of the factored parts, composed as every
    lookup composes them."""
    cc, cl, acc, slf = lat_parts
    ccr, _, accr, slfr = rel_parts
    cc = np.asarray(cc, np.int64)
    acc = np.asarray(acc, np.int64)
    cl = np.asarray(cl)
    core = cc[cl[:, None], cl[None, :]]
    lat = compose_lat(acc[:, None], core, acc[None, :])
    accr = np.asarray(accr, np.float32)
    corer = np.asarray(ccr, np.float32)[cl[:, None], cl[None, :]]
    rel = compose_rel(accr[:, None], corer, accr[None, :])
    np.fill_diagonal(lat, np.asarray(slf, np.int64))
    np.fill_diagonal(rel, np.asarray(slfr, np.float32))
    return lat.astype(np.int64), rel.astype(np.float32)


def min_latency_from_parts(lat_parts) -> int:
    """The exact minimum of the implied [V,V] latency in O(V + C^2):
    the least off-diagonal cluster entry (hubs have 0 access), the
    least spoke access latency (a spoke pairs with its own hub through
    the 0 diagonal), and the least self path."""
    cc, cl, acc, slf = lat_parts
    cc = np.asarray(cc, np.int64)
    acc = np.asarray(acc, np.int64)
    cands = [int(np.asarray(slf, np.int64).min())]
    C = cc.shape[0]
    if C > 1:
        cands.append(int(cc[~np.eye(C, dtype=bool)].min()))
    spoke = acc > 0
    if spoke.any():
        cands.append(int(acc[spoke].min()))
    return min(cands)


def max_composed_latency(lat_parts) -> int:
    """An upper bound of every composed latency: what must fit the
    int32 device tables."""
    cc, cl, acc, slf = lat_parts
    hi = 2 * int(np.asarray(acc, np.int64).max(initial=0)) + \
        int(np.asarray(cc, np.int64).max(initial=0))
    return max(hi, int(np.asarray(slf, np.int64).max(initial=0)))


def world_tables(topology, fault_table=None):
    """(latency, reliability, epoch_times) in the topology's
    representation: dense [V,V] arrays, or the factored part tuples;
    under a link-fault schedule (faults.py) the [T,V,V] stacks, or the
    part tuples with a leading [T] axis on every leaf, and the [T]
    epoch start times (None without faults)."""
    if fault_table is None:
        hier = topology.hier
        if hier is not None:
            return hier.lat_parts(), hier.rel_parts(), None
        return (np.asarray(topology.latency_ns, np.int64),
                np.asarray(topology.reliability, np.float32), None)
    times = np.asarray(fault_table.times, np.int64)
    if fault_table.is_hierarchical:
        return (fault_table.lat_parts_stacked(),
                fault_table.rel_parts_stacked(), times)
    return (np.asarray(fault_table.latency_ns, np.int64),
            np.asarray(fault_table.reliability, np.float32), times)


def gather_parts_plain(parts, sv: torch.Tensor, dv: torch.Tensor,
                       e=None) -> torch.Tensor:
    """The two-level lookup of the reference's `gather_parts`, in
    PyTorch: `parts` = (cc, cl, acc, slf) tensors; a floating cc
    composes reliability (two float32 multiplies), an integer cc
    latency (in cc's dtype, int32 on the device path); a pair with
    sv == dv takes the self vector. `e` (broadcast like sv/dv) indexes
    a leading epoch axis of cc, acc and slf; cl may carry that axis
    too, or be the one [V] vector every epoch shares."""
    cc, cl, acc, slf = parts
    sv, dv = sv.long(), dv.long()
    if e is None:
        cs, cd = cl[sv].long(), cl[dv].long()
        a_s, a_d, sf = acc[sv], acc[dv], slf[sv]
        core = cc[cs, cd]
    else:
        e = e.long()
        ce = (e,) if cl.dim() == 2 else ()
        cs, cd = cl[(*ce, sv)].long(), cl[(*ce, dv)].long()
        a_s, a_d, sf = acc[e, sv], acc[e, dv], slf[e, sv]
        core = cc[e, cs, cd]
    comp = (compose_rel(a_s, core, a_d) if cc.is_floating_point()
            else compose_lat(a_s, core, a_d))
    return torch.where(sv == dv, sf, comp)
