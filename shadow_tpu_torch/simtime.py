"""Simulation time: signed 64-bit nanoseconds since simulation start.

The port's copy of the reference package's simtime module, cut to what
the port's slices use. Times stay *signed* int64, as in the JAX
reference, so the two engines share one encoding (INF sentinels,
2**63 ns ~ 292 years of simulated time).
"""

from __future__ import annotations

SIMTIME_ONE_NANOSECOND: int = 1
SIMTIME_ONE_MICROSECOND: int = 1_000
SIMTIME_ONE_MILLISECOND: int = 1_000_000
SIMTIME_ONE_SECOND: int = 1_000_000_000
SIMTIME_ONE_MINUTE: int = 60 * SIMTIME_ONE_SECOND
SIMTIME_ONE_HOUR: int = 60 * SIMTIME_ONE_MINUTE
# no time (an unset clock or barrier), and the latest time there is
SIMTIME_INVALID: int = -1
SIMTIME_MAX: int = (1 << 63) - 2

# Network constants (the reference's definitions.h:173-195).
CONFIG_MTU: int = 1500
CONFIG_HEADER_SIZE_TCP: int = 20
CONFIG_HEADER_SIZE_IP: int = 20
CONFIG_HEADER_SIZE_UDP: int = 8
CONFIG_HEADER_SIZE_TCPIPETH: int = 54
CONFIG_HEADER_SIZE_UDPIPETH: int = 42
CONFIG_TCP_MAX_SEGMENT_SIZE: int = (CONFIG_MTU - CONFIG_HEADER_SIZE_TCP
                                    - CONFIG_HEADER_SIZE_IP)


def format_time(t: int) -> str:
    """Human-readable hh:mm:ss.nnnnnnnnn, for log stamps."""
    if t < 0:
        return "n/a"
    ns = t % SIMTIME_ONE_SECOND
    s = t // SIMTIME_ONE_SECOND
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.{ns:09d}"
