"""Typed unit parsing for config values: "10 Mbit", "50 ms", "16 MiB".

Mirrors the semantics of the reference's units module (reference
src/main/core/support/units.rs:51-580): values are an integer (or decimal)
followed by an optional SI/IEC prefix and a base unit, with whitespace
allowed between number and unit. Bandwidth normalizes to bits/second, sizes
to bytes, times to nanoseconds.
"""

from __future__ import annotations

import re
from typing import Union

from shadow_tpu_torch import simtime

_SI = {
    "": 1,
    "k": 10**3, "K": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
}
_IEC = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
}

_NS = simtime.SIMTIME_ONE_NANOSECOND
_US = simtime.SIMTIME_ONE_MICROSECOND
_MS = simtime.SIMTIME_ONE_MILLISECOND
_S = simtime.SIMTIME_ONE_SECOND
_MIN = simtime.SIMTIME_ONE_MINUTE
_H = simtime.SIMTIME_ONE_HOUR

_TIME_UNITS = {
    "ns": _NS,
    "nanosecond": _NS, "nanoseconds": _NS,
    "us": _US, "μs": _US,
    "microsecond": _US, "microseconds": _US,
    "ms": _MS,
    "millisecond": _MS, "milliseconds": _MS,
    "s": _S, "sec": _S, "secs": _S,
    "second": _S, "seconds": _S,
    "m": _MIN, "min": _MIN, "mins": _MIN,
    "minute": _MIN, "minutes": _MIN,
    "h": _H, "hr": _H, "hrs": _H,
    "hour": _H, "hours": _H,
}

_NUM_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([A-Za-zμ]*)\s*$")


def _split(value: str) -> tuple[float, str]:
    m = _NUM_RE.match(value)
    if not m:
        raise ValueError(f"cannot parse unit value: {value!r}")
    return float(m.group(1)), m.group(2)


def parse_time_ns(value: Union[str, int, float]) -> int:
    """Parse a time value to integer nanoseconds.

    Bare numbers are interpreted as seconds (matching the reference's
    config fields like stop_time, which default to seconds when unitless).
    """
    if isinstance(value, (int, float)):
        return int(round(value * _S))
    num, unit = _split(value)
    if unit == "":
        return int(round(num * _S))
    if unit not in _TIME_UNITS:
        raise ValueError(f"unknown time unit {unit!r} in {value!r}")
    return int(round(num * _TIME_UNITS[unit]))


def _parse_prefixed(value: str, bases: dict[str, int], kind: str) -> int:
    num, unit = _split(value)
    for base, scale in bases.items():
        if unit == base:
            return int(round(num * scale))
        for prefix, mult in _IEC.items():
            if unit == prefix + base:
                return int(round(num * mult * scale))
        for prefix, mult in _SI.items():
            if prefix and unit == prefix + base:
                return int(round(num * mult * scale))
    raise ValueError(f"cannot parse {kind} value: {value!r}")


def parse_size_bytes(value: Union[str, int, float]) -> int:
    """Parse a size value to bytes. Bare numbers are bytes."""
    if isinstance(value, (int, float)):
        return int(round(value))
    num, unit = _split(value)
    if unit == "":
        return int(num)
    return _parse_prefixed(value, {"B": 1, "byte": 1, "bytes": 1}, "size")


def parse_bandwidth_bits(value: Union[str, int, float]) -> int:
    """Parse a bandwidth value to bits/second. Bare numbers are bits/s.

    Accepts bit-based ("10 Mbit", "1 Gbit") and byte-based ("10 MB")
    spellings like the reference's units.rs (bandwidth is stored
    bit-normalized, units.rs:776-830).
    """
    if isinstance(value, (int, float)):
        return int(round(value))
    num, unit = _split(value)
    if unit == "":
        return int(num)
    try:
        return _parse_prefixed(
            value, {"bit": 1, "bits": 1, "bps": 1}, "bandwidth"
        )
    except ValueError:
        pass
    return 8 * _parse_prefixed(value, {"B": 1, "byte": 1, "bytes": 1}, "bandwidth")
