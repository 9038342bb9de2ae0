"""The inter-host network model on the CPU (the port's copy of the
reference package's core/netmodel.py).

A send is judged as the reference's worker_sendPacket judges it:
reliability lookup -> drop roll -> latency lookup, as a pure function
of the path tables and the counter RNG, so that the device kernels
(K2 judge_outbox in the window loop, K10 judge_batch under the hybrid
policy) compute the same verdicts bit for bit.

Drop rule: a packet from src with per-source sequence number `pkt_seq`
is dropped iff reliability < 1, the send time is past the bootstrap
end, and uniform01(fold(seed, DROP, src_host, pkt_seq)) >= reliability.
Under a link-fault schedule (faults.py) the tables are those of the
epoch of the send time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from shadow_tpu_torch.topology.graph import Topology
from shadow_tpu_torch.utils import nprng
from shadow_tpu_torch.utils.rng import PURPOSE_PACKET_DROP


@dataclass
class PacketVerdict:
    delivered: bool
    deliver_time: int      # sim ns (valid when delivered)
    latency_ns: int


@dataclass
class NetworkModel:
    topology: Topology
    host_vertex: np.ndarray        # [H] vertex index per host
    seed: int
    bootstrap_end: int = 0
    # the compiled link-fault schedule (faults.FaultTable or
    # HierFaultTable); None = the base tables
    faults: object = None
    # sent packets per (src vertex, dst vertex), drop-rolled ones
    # included (the reference's path counters)
    path_packets: dict = field(default_factory=dict)
    # each sender's (seed, DROP, src) key, folded once
    _drop_keys: dict = field(default_factory=dict, repr=False)

    def _drop_key(self, src_host: int) -> tuple[int, int]:
        k = self._drop_keys.get(src_host)
        if k is None:
            k = self._drop_keys[src_host] = nprng.fold_in_int(
                nprng.fold_in_int(nprng.key_int(self.seed),
                                  PURPOSE_PACKET_DROP), src_host)
        return k

    @property
    def min_latency_ns(self) -> int:
        """The lookahead floor: the minimum path latency over every
        fault epoch."""
        if self.faults is not None:
            return min(self.topology.min_latency_ns,
                       self.faults.min_latency_ns)
        return self.topology.min_latency_ns

    def _path(self, now: int, sv: int, dv: int) -> tuple[int, float]:
        """(latency_ns, reliability) of sv -> dv at send time `now`."""
        if self.faults is not None:
            return self.faults.lookup(now, sv, dv)
        if self.topology.hier is not None:
            return self.topology.hier.lookup(sv, dv)
        return (int(self.topology.latency_ns[sv, dv]),
                float(self.topology.reliability[sv, dv]))

    def record_paths(self, counts: dict) -> None:
        """Add a batch of per-(src vertex, dst vertex) packet counts
        (the hybrid flush)."""
        for key, n in counts.items():
            self.path_packets[key] = self.path_packets.get(key, 0) + n

    def judge_train(self, now: int, src_host: int, dst_host: int,
                    pkt_seq0: int, count: int,
                    live: int = -1) -> tuple[int, int, int]:
        """Judge a packet train (count packets on one path at one send
        instant): per-packet drop rolls keyed (src, pkt_seq0 + j), as
        single sends would be. Returns (survivor bitmask, deliver_time,
        latency_ns); bit j set = packet pkt_seq0 + j survived. `live`
        (< 0 = count) is the number of lanes that carry packets, which
        the path counters count."""
        assert count <= 64, \
            f"judge_train count={count} exceeds the 64-bit mask"
        sv = int(self.host_vertex[src_host])
        dv = int(self.host_vertex[dst_host])
        latency, reliability = self._path(now, sv, dv)

        surv = (1 << count) - 1
        if reliability < 1.0 and now >= self.bootstrap_end:
            rolls = nprng.packet_uniform(
                self.seed, PURPOSE_PACKET_DROP, src_host,
                np.arange(pkt_seq0, pkt_seq0 + count))
            bits = (rolls < reliability).astype(np.uint64)
            surv = int((bits << np.arange(count, dtype=np.uint64))
                       .sum())
        key = (sv, dv)
        self.path_packets[key] = self.path_packets.get(key, 0) \
            + (count if live < 0 else live)
        return surv, now + latency, latency

    def judge(self, now: int, src_host: int, dst_host: int,
              pkt_seq: int) -> PacketVerdict:
        sv = int(self.host_vertex[src_host])
        dv = int(self.host_vertex[dst_host])
        latency, reliability = self._path(now, sv, dv)

        delivered = True
        if reliability < 1.0 and now >= self.bootstrap_end:
            roll = nprng.uniform01_int(
                nprng.fold_in_int(self._drop_key(src_host), pkt_seq))
            delivered = roll < reliability

        key = (sv, dv)
        self.path_packets[key] = self.path_packets.get(key, 0) + 1
        return PacketVerdict(delivered=delivered,
                             deliver_time=now + latency,
                             latency_ns=latency)
