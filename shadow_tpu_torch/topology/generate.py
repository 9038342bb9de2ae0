"""Topology generators (the port's copy of the reference package's
topology/generate.py): `network.graph.type: star_clusters`.

A million-vertex topology cannot arrive as a GML file (parsing a
million node stanzas takes minutes, and `Topology.from_parsed` runs two
O(V^2) scans). The generator builds the edge arrays with numpy, skips
both scans (the structure is connected and, past one vertex, not
complete by construction) and hands off to `Topology._compute_paths`,
so the representation rules are those of a parsed graph.

`star_clusters`: `clusters` hub vertices forming a complete graph, each
with `spokes_per_cluster` spokes. Vertex ids are the indices: hubs
0..C-1, then the spokes of hub h at C + h*S .. C + (h+1)*S - 1, so a
host group with `network_node_id: C` and `network_node_stride: 1` tiles
hosts across the spokes.
"""

from __future__ import annotations

import logging

import numpy as np

from shadow_tpu_torch.config.units import parse_bandwidth_bits, parse_time_ns
from shadow_tpu_torch.topology.graph import GmlError, Topology

log = logging.getLogger("shadow_tpu_torch.topology")


def generate_star_clusters(params: dict, use_shortest_path: bool = True,
                           representation: str = "dense") -> Topology:
    """The hub-and-spoke topology from the `network.graph` generator
    keys (the schema checks the key set; this checks the values)."""
    C = int(params.get("clusters", 1))
    S = int(params.get("spokes_per_cluster", 0))
    if C < 1:
        raise GmlError("star_clusters: clusters must be >= 1")
    if S < 0:
        raise GmlError("star_clusters: spokes_per_cluster must "
                       "be >= 0")
    hub_lat = parse_time_ns(params.get("hub_latency", "10 ms"))
    acc_lat = parse_time_ns(params.get("access_latency", "1 ms"))
    if hub_lat <= 0 or acc_lat <= 0:
        raise GmlError("star_clusters: latencies must be > 0")
    hub_loss = float(params.get("hub_packet_loss", 0.0))
    acc_loss = float(params.get("access_packet_loss", 0.0))
    for name, loss in (("hub_packet_loss", hub_loss),
                       ("access_packet_loss", acc_loss)):
        if not (0.0 <= loss <= 1.0):
            raise GmlError(f"star_clusters: {name} {loss} not in "
                           "[0,1]")
    bw_down = parse_bandwidth_bits(params.get("bandwidth_down", "1 Gbit"))
    bw_up = parse_bandwidth_bits(params.get("bandwidth_up", "1 Gbit"))

    V = C + C * S
    # the complete hub graph: one undirected edge per hub pair
    hi, hj = np.triu_indices(C, k=1)
    # spoke k of hub h sits at vertex C + h*S + k
    sp = np.arange(C * S, dtype=np.int64) + C
    sp_hub = (np.arange(C * S, dtype=np.int64) // max(1, S)) \
        if S else np.empty(0, dtype=np.int64)
    esrc = np.concatenate([hi.astype(np.int64), sp_hub])
    edst = np.concatenate([hj.astype(np.int64), sp])
    E_hub = len(hi)
    elat = np.concatenate([
        np.full(E_hub, hub_lat, dtype=np.int64),
        np.full(C * S, acc_lat, dtype=np.int64)])
    erel = np.concatenate([
        np.full(E_hub, np.float32(1.0 - hub_loss), dtype=np.float32),
        np.full(C * S, np.float32(1.0 - acc_loss), dtype=np.float32)])

    top = Topology(
        directed=False,
        # complete only in the 1-vertex case: set, not detected
        complete=(V == 1),
        use_shortest_path=use_shortest_path,
        vertex_ids=np.arange(V, dtype=np.int64),
        edge_src=esrc, edge_dst=edst,
        edge_latency_ns=elat, edge_reliability=erel,
        bw_down_bits=np.full(V, bw_down, dtype=np.int64),
        bw_up_bits=np.full(V, bw_up, dtype=np.int64),
        latency_ns=None, reliability=None,
    )
    if not use_shortest_path and not top.complete:
        raise GmlError("use_shortest_path=false requires a complete "
                       "graph (every ordered vertex pair needs a "
                       "direct edge)")
    log.info("star_clusters: V=%d (C=%d hubs, %d spokes/hub), E=%d",
             V, C, S, len(esrc))
    top._compute_paths(representation)
    return top
