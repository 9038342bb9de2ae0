"""The model NIC's constants and arithmetic (the port's copy of the
reference package's host/model_nic.py): what the device engine reads,
and `ModelNic`, the per-host state of the CPU engine (core/).

Under `experimental.model_bandwidth` raw model sends pass a fluid
bandwidth model and an event-driven CoDel:

* TX at send time t of a packet of S bytes on host h:
    depart = max(t, tx_free);  tx_free = depart + S*8e9 // bw_up
  (the sends of one event serialize in lane order); latency and the
  drop roll apply on top, keyed on the send event's time t;
* RX when the packet event pops on the destination at time arr:
    dq = max(arr, rx_free);  sojourn = dq - arr
  CoDel may drop it; otherwise it is delivered at
    deliver = dq + S*8e9 // bw_down;  rx_free = deliver
  as a KIND_PACKET_READY event (same src/seq), which the app sees.

The CoDel control law reads the integer table LAW[count] =
interval/sqrt(count), built here on the host with Python's math.sqrt
and uploaded as is: the device never computes a square root, so no
device rounding can differ from the reference's.
"""

from __future__ import annotations

import math

import numpy as np

from shadow_tpu_torch import simtime

CODEL_TARGET_NS = 10 * simtime.SIMTIME_ONE_MILLISECOND
CODEL_INTERVAL_NS = 100 * simtime.SIMTIME_ONE_MILLISECOND
LAW_SIZE = 1024

_NS_PER_SEC = 1_000_000_000
# serialization sizes clamp to 1 GiB so that size * 8e9 fits int64
# (2**30 * 8e9 ~ 8.6e18 < 2**63)
MAX_SER_BYTES = 1 << 30


def codel_law_table(interval_ns: int = CODEL_INTERVAL_NS) -> np.ndarray:
    """LAW[c] = interval/sqrt(c) ns (c = 0 unused), int64 [LAW_SIZE]."""
    t = np.zeros(LAW_SIZE, dtype=np.int64)
    for c in range(1, LAW_SIZE):
        t[c] = int(interval_ns / math.sqrt(c))
    return t


LAW = codel_law_table()


def serialize_ns(size_bytes: int, bw_bits: int) -> int:
    """Serialization time of `size_bytes` at `bw_bits` bits/s, in
    integer nanoseconds."""
    return (min(max(1, size_bytes), MAX_SER_BYTES) * 8 * _NS_PER_SEC) \
        // max(1, bw_bits)


class ModelNic:
    """One host's model-NIC state on the CPU engine: the CPU twin of the
    device's seven leaves (tx_free, rx_free, cd_fa, cd_next, cd_cnt,
    cd_last, cd_drop)."""

    def __init__(self, bw_up_bits: int, bw_down_bits: int):
        self.bw_up = bw_up_bits
        self.bw_down = bw_down_bits
        self.tx_free = 0
        self.rx_free = 0
        self.cd_fa = 0          # first_above_time
        self.cd_next = 0        # drop_next
        self.cd_cnt = 0
        self.cd_last = 0        # lastcount
        self.cd_drop = 0        # in dropping state

    def tx_depart(self, now: int, size: int) -> int:
        depart = max(now, self.tx_free)
        self.tx_free = depart + serialize_ns(size, self.bw_up)
        return depart

    def rx_deliver(self, arr: int, size: int) -> int:
        """The delivery time, or -1 where CoDel drops the packet: one
        packet per call, the decision tree the device pops apply."""
        dq = max(arr, self.rx_free)
        sojourn = dq - arr
        drop = False
        if sojourn < CODEL_TARGET_NS:
            self.cd_fa = 0
            self.cd_drop = 0
        elif self.cd_fa == 0:
            self.cd_fa = dq + CODEL_INTERVAL_NS
        elif dq >= self.cd_fa:
            if self.cd_drop:
                if dq >= self.cd_next:
                    drop = True
                    self.cd_cnt += 1
                    self.cd_next = self.cd_next + int(
                        LAW[min(self.cd_cnt, LAW_SIZE - 1)])
            else:
                drop = True
                self.cd_drop = 1
                delta = self.cd_cnt - self.cd_last
                if dq - self.cd_next < CODEL_INTERVAL_NS and delta > 1:
                    self.cd_cnt = delta
                else:
                    self.cd_cnt = 1
                self.cd_last = self.cd_cnt
                self.cd_next = dq + int(
                    LAW[min(self.cd_cnt, LAW_SIZE - 1)])
        else:
            self.cd_drop = 0
        if drop:
            return -1
        deliver = dq + serialize_ns(size, self.bw_down)
        self.rx_free = deliver
        return deliver
