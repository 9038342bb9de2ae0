"""Virtual CPU delay model (the port's copy of the reference package's
host/cpu.py).

Native execution time scales by the ratio of the host's configured
frequency to the machine's, and an event is deferred while the virtual
CPU is busy past a threshold. Model apps report synthetic load through
SimContext.consume_cpu() (PHOLD's `cpuload`).
"""

from __future__ import annotations

from dataclasses import dataclass

from shadow_tpu_torch import simtime


@dataclass
class Cpu:
    freq_khz: int = 3_000_000          # host's configured frequency
    raw_freq_khz: int = 3_000_000      # native machine frequency
    threshold_ns: int = simtime.SIMTIME_ONE_MILLISECOND
    precision_ns: int = 200 * simtime.SIMTIME_ONE_MICROSECOND
    now: int = 0
    _busy_until: int = 0

    def scale(self, native_ns: int) -> int:
        return native_ns * self.raw_freq_khz // max(1, self.freq_khz)

    def update_time(self, now: int) -> None:
        self.now = max(self.now, now)

    def add_delay(self, native_ns: int) -> None:
        """Account virtual execution time."""
        base = max(self._busy_until, self.now)
        self._busy_until = base + self.scale(native_ns)

    def is_blocked(self, now: int) -> bool:
        """Whether delivery waits: the backlog exceeds the threshold."""
        if self.threshold_ns <= 0:
            return False
        return (self._busy_until - now) > self.threshold_ns

    def delay_until_ready(self, now: int) -> int:
        """How long to defer an event, rounded up to the precision."""
        raw = max(0, self._busy_until - now)
        if self.precision_ns > 0:
            steps = (raw + self.precision_ns - 1) // self.precision_ns
            return steps * self.precision_ns
        return raw
