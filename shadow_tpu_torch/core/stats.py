"""A run's statistics, whichever engine ran it: the device runner
(device/runner.py), an ensemble campaign (ensemble/campaign.py) or the
CPU engine of the serial and hybrid policies (core/manager.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SimStats:
    ok: bool = True
    end_time: int = 0
    events_executed: int = 0
    packets_sent: int = 0
    packets_delivered: int = 0
    packets_dropped: int = 0
    rounds: int = 0
    wall_s: float = 0.0
    # the policy that ran: "tpu" (the device engine), "hybrid" or
    # "serial" (the CPU engine)
    policy: str = "tpu"
    # per host, [H]
    host_events_executed: np.ndarray = field(default=None, repr=False)
    host_trace_checksum: np.ndarray = field(default=None, repr=False)
    # the CPU engine's per-host packet counters and quarantined events
    # (None on the device engine)
    host_packets_sent: Optional[np.ndarray] = field(default=None,
                                                    repr=False)
    host_packets_dropped: Optional[np.ndarray] = field(default=None,
                                                       repr=False)
    host_packets_delivered: Optional[np.ndarray] = field(default=None,
                                                         repr=False)
    host_events_quarantined: Optional[np.ndarray] = field(default=None,
                                                          repr=False)
    overflow: int = 0
    x_overflow: int = 0
    # tgen and Tor on the device engine: downloads completed
    downloads_completed: Optional[int] = None
    # the preflight admission verdict (capacity.admission_verdict)
    admission: Optional[dict] = field(default=None, repr=False)
    # sent packets per (src vertex, dst vertex), the nonzero entries
    # (the reference's NetworkModel.path_packets): under count_paths on
    # the device engine, always on the CPU engine
    path_packets: Optional[dict] = field(default=None, repr=False)
    # the window loop that ran ("graph", "python"; "cpu" for the CPU
    # engine) and its phases and host syncs (DeviceEngine.loop_stats)
    loop: str = ""
    phases: int = 0
    host_syncs: int = 0
    # an ensemble campaign's record (ensemble/campaign.py); the totals
    # above are then over every replica, the per-host arrays replica
    # 0's, rounds and phases the most of any replica
    ensemble: Optional[dict] = field(default=None, repr=False)
    # the hybrid policy's judge (device/judge.py DeviceJudge.counters):
    # batches and packets judged by K10, rounds and packets rolled on
    # the CPU below min_batch, the flushes' wall and, on the card, the
    # kernel and copy ms
    judge: Optional[dict] = field(default=None, repr=False)
    # a mesh run's exchange (device/engine.py mesh_stats, rank 0's):
    # shards, backend, the schedule after `auto`, CAP and CAP2, the
    # bytes rank 0 sent, its staging and collective seconds
    mesh: Optional[dict] = field(default=None, repr=False)
    # the occupancy record of a device run (device/capacity.py measure;
    # a planned run's with its plan, final marks and re-plans), the
    # re-plans an overflow forced, and the heartbeat gaps the
    # staleness monitor flagged (experimental.heartbeat_stale_after)
    occupancy: Optional[dict] = field(default=None, repr=False)
    replans: int = 0
    stale_heartbeats: int = 0
    # the segmented advance's record (device/supervise.py `advance`):
    # segments, replays, host syncs, graph captures, engines built, the
    # warm-up's wall
    pipeline: Optional[dict] = field(default=None, repr=False)
    # supervision (device/supervise.py): a run the preemption drain
    # stopped early and the checkpoint it resumes from, the transient
    # dispatch errors retried, the mesh shrinks (`failover: shrink`),
    # and after a hybrid failover the device checkpoint it left (""
    # where none could be persisted)
    preempted: bool = False
    resume_path: str = ""
    retries: int = 0
    reshards: int = 0
    failover_checkpoint: str = ""

    def summary(self) -> str:
        downloads = ("" if self.downloads_completed is None else
                     f"{self.downloads_completed} downloads completed, ")
        return (f"{self.events_executed} events, "
                f"{self.packets_sent} packets sent "
                f"({self.packets_delivered} delivered, "
                f"{self.packets_dropped} dropped), {downloads}"
                f"{self.rounds} rounds")
