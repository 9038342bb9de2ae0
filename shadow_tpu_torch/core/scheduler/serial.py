"""The single-threaded policy: one global priority queue (the port's
copy of the reference package's core/scheduler/serial.py). The (time,
dst, src, seq) total order makes its schedule the canonical one every
other engine reproduces."""

from __future__ import annotations

from typing import Optional

from shadow_tpu_torch import simtime
from shadow_tpu_torch.core.event import Event
from shadow_tpu_torch.core.scheduler.base import SchedulerPolicy
from shadow_tpu_torch.utils.pqueue import PriorityQueue


class SerialPolicy(SchedulerPolicy):
    def __init__(self):
        self._q = PriorityQueue()
        self._hosts: set[int] = set()

    def add_host(self, host_id: int) -> None:
        self._hosts.add(host_id)

    def push(self, event: Event, barrier: int) -> None:
        event = self.apply_barrier(event, barrier)
        self._q.push(event.key, event)

    def pop(self, barrier: int) -> Optional[Event]:
        head = self._q.peek()
        if head is None or head[0].time >= barrier:
            return None
        return self._q.pop()[1]

    def next_event_time(self) -> int:
        key = self._q.peek_key()
        return simtime.SIMTIME_MAX if key is None else key.time
