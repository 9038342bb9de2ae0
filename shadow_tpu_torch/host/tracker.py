"""Per-host heartbeat lines (the port's copy of the reference package's
host/tracker.py `Tracker`, cut to what the device runner reports).

At every heartbeat boundary the device runner hands each host's
cumulative counters to its Tracker, which logs one
`[shadow-heartbeat] [node]` CSV line with the interval's deltas, after a
one-time `[node-header]` row, in the reference's format (Shadow's
tracker.c:418-560), so that tools that parse Shadow's logs read these
too. The columns of the reference's socket stack and its memory copier
(bytes sent and received, copy ops and bytes) are 0 for the model hosts
the device engine runs, as they are in the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from shadow_tpu_torch import simtime

log = logging.getLogger("shadow_tpu_torch.heartbeat")

HEADER = ("[shadow-heartbeat] [node-header] time,name,events,packets-sent,"
          "packets-dropped,bytes-sent,bytes-received,copy-ops,copy-bytes")


@dataclass
class Tracker:
    host_name: str
    interval_ns: int
    # this interval's values
    events: int = 0
    packets_sent: int = 0
    packets_dropped: int = 0
    # the cumulative counters at the previous heartbeat
    _last: dict = field(default_factory=dict)
    _header_logged: bool = False

    def heartbeat(self, now: int, events: int, packets_sent: int,
                  packets_dropped: int) -> None:
        """Log the host's line at sim time `now` from its cumulative
        counters: each column the difference from the last heartbeat."""
        cur = {"events": events, "packets_sent": packets_sent,
               "packets_dropped": packets_dropped}
        for k, v in cur.items():
            setattr(self, k, v - self._last.get(k, 0))
        self._last = cur
        if not self._header_logged:
            self._header_logged = True
            log.info(HEADER)
        log.info("[shadow-heartbeat] [node] %d,%s,%d,%d,%d,%d,%d,%d,%d",
                 now // simtime.SIMTIME_ONE_SECOND, self.host_name,
                 self.events, self.packets_sent, self.packets_dropped,
                 0, 0, 0, 0)
