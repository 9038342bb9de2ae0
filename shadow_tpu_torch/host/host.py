"""A simulated host of the CPU engine (the port's copy of the reference
package's host/host.py, cut to model hosts).

Identity, topology attachment, bandwidths, the per-host id counters
that make the event order reproducible (event seq, packet seq, app
draws), the crash state of host faults and the per-host statistics.
core/controller.py builds these from the port's columnar build with
the reference's names, ids, vertices and bandwidths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from shadow_tpu_torch.utils.rng import SeededRandom


@dataclass
class Host:
    host_id: int
    name: str
    vertex: int                 # topology vertex index
    bw_down_bits: int
    bw_up_bits: int
    rng: SeededRandom
    app: Any = None             # primary app (the dispatch target)
    apps: list = field(default_factory=list)   # every process, in
                                # config order (BOOT/STOP carry the index)
    cpu: Any = None             # host/cpu.py Cpu delay model
    model_nic: Any = None       # host/model_nic.py ModelNic (raw sends)

    # deterministic id streams
    _event_seq: int = 0
    _packet_seq: int = 0
    _app_seq: int = 0

    # host faults (core/manager.py KIND_HOST_CRASH/RESTART): a crashed
    # host executes nothing, its events are quarantined until the
    # restart respawns the configured processes from `respawn`
    # [(factory, start_time, stop_time, is_model)]
    crashed: bool = False
    events_quarantined: int = 0
    respawn: Optional[list] = None

    events_executed: int = 0
    packets_sent: int = 0
    packets_delivered: int = 0
    packets_dropped: int = 0
    # rolling hash of the executed schedule (utils/checksum.py)
    trace_checksum: int = 0

    def next_event_seq(self) -> int:
        s = self._event_seq
        self._event_seq += 1
        return s

    def next_packet_seq(self) -> int:
        s = self._packet_seq
        self._packet_seq += 1
        return s

    def next_app_seq(self) -> int:
        s = self._app_seq
        self._app_seq += 1
        return s
