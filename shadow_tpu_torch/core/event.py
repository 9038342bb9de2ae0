"""Events and their deterministic total order (the port's copy of the
reference package's core/event.py, cut to model hosts: no socket-stack
kinds).

Events are ordered by (time, dst, src, per-src seq); on the device a
host's heap row is sorted by (time, src<<32|seq). The CPU engine
(core/manager.py) keeps `Event` objects in one priority queue under
that key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

KIND_BOOT = 0     # host/process start
KIND_TIMER = 1    # self-scheduled timer
KIND_PACKET = 2   # packet delivery from the network model
KIND_STOP = 3     # process/host stop
KIND_TASK = 4     # CPU engine only: run the attached task closure
# model NIC (experimental.model_bandwidth): a packet pops first as
# KIND_PACKET (the receive stage, host/model_nic.py) and re-fires as
# KIND_PACKET_READY at its post-serialization delivery time
KIND_PACKET_READY = 8
# host faults (faults.py, manager-side): kill a host's processes and
# quarantine its pending events / respawn the configured processes
KIND_HOST_CRASH = 9
KIND_HOST_RESTART = 10


class EventKey(NamedTuple):
    time: int          # sim ns
    dst_host: int
    src_host: int
    seq: int           # unique per src_host, so ties cannot happen


@dataclass(order=False)
class Event:
    time: int
    dst_host: int
    src_host: int
    seq: int
    # a closure to run (KIND_TASK)
    task: Callable[..., Any] | None = None
    kind: int = 0
    data: tuple = field(default_factory=tuple)
    # packets this delivery carries (a train's survivors; 1 for one
    # packet): statistics only, never part of the key
    npkts: int = 1

    @property
    def key(self) -> EventKey:
        return EventKey(self.time, self.dst_host, self.src_host, self.seq)

    def execute(self, ctx) -> None:
        if self.task is not None:
            self.task(ctx, self)
