"""The tgen models' constants and client arguments (the port's copy of
the reference package's models/tgen.py), which the device twin
(device/apps.py) and the CPU model (models/tgen.py) share.

A client pulls `size` bytes from its server in chunks of at most
CHUNK_PKTS MSS-sized packets, `count` times, pausing `pause` between
downloads and re-requesting a chunk after `retry` (0 = never). A
server takes no arguments.
"""

from __future__ import annotations

from dataclasses import dataclass

from shadow_tpu_torch import simtime
from shadow_tpu_torch.config.units import parse_size_bytes, parse_time_ns

TAG_REQ = 1
TAG_DATA = 2

MSS = simtime.CONFIG_TCP_MAX_SEGMENT_SIZE
CHUNK_PKTS = 32                  # window: packets per REQ round trip


def n_packets(total_bytes: int) -> int:
    return (total_bytes + MSS - 1) // MSS


@dataclass(frozen=True)
class TgenClientArgs:
    server_name: str
    size: int                    # bytes per download
    count: int                   # downloads
    pause_ns: int                # between downloads
    retry_ns: int                # chunk re-request timeout, 0 = off

    @classmethod
    def parse(cls, args: dict) -> "TgenClientArgs":
        """From the process's parsed "k=v" args, with the reference
        client's defaults."""
        return cls(server_name=args.get("server", "server"),
                   size=parse_size_bytes(args.get("size", "1 MiB")),
                   count=int(args.get("count", 1)),
                   pause_ns=parse_time_ns(args.get("pause", "1 s")),
                   retry_ns=parse_time_ns(args.get("retry", 0)))
