"""Scheduler policy interface (the port's copy of the reference
package's core/scheduler/base.py).

addHost / push / pop / getNextTime, plus the causality rule applied on
push: a cross-host event with a time below the current round's barrier
is bumped up to the barrier. Same-host events may land anywhere in the
future (a host's own timeline is sequential anyway).
"""

from __future__ import annotations

from typing import Optional

from shadow_tpu_torch import simtime
from shadow_tpu_torch.core.event import Event


class SchedulerPolicy:
    def add_host(self, host_id: int) -> None:
        raise NotImplementedError

    def push(self, event: Event, barrier: int) -> None:
        """Insert an event. `barrier` is the current round's end time;
        cross-host events earlier than it are delayed to it."""
        raise NotImplementedError

    def pop(self, barrier: int) -> Optional[Event]:
        """Remove and return the next event strictly before `barrier`,
        in (time, dst, src, seq) order, or None if none remain."""
        raise NotImplementedError

    def next_event_time(self) -> int:
        """Earliest pending event time, or SIMTIME_MAX if empty."""
        raise NotImplementedError

    @staticmethod
    def apply_barrier(event: Event, barrier: int) -> Event:
        if (event.src_host != event.dst_host
                and barrier != simtime.SIMTIME_INVALID
                and event.time < barrier):
            event.time = barrier
        return event
