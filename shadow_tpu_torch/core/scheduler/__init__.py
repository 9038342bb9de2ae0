"""Scheduler policies of the CPU engine (the port's copy of the
reference package's core/scheduler/, cut to the serial policy; the
threaded policies are refused by core/build.py)."""

from shadow_tpu_torch.core.scheduler.base import SchedulerPolicy
from shadow_tpu_torch.core.scheduler.serial import SerialPolicy

__all__ = ["SchedulerPolicy", "SerialPolicy", "make_policy"]

THREADED_POLICIES = ("host", "steal", "thread", "threadXthread",
                     "threadXhost")


def make_policy(name: str) -> SchedulerPolicy:
    """The CPU policy named `name`: `serial`, the single-threaded
    oracle (the device engine runs `tpu`, core/controller.py)."""
    if name == "serial":
        return SerialPolicy()
    if name in THREADED_POLICIES:
        raise ValueError(
            f"scheduler policy {name!r} is not ported to shadow_tpu_torch "
            "yet (ROADMAP.md queue (a) item 10 (the threaded CPU "
            "policies))")
    raise ValueError(f"unknown scheduler policy {name!r}")
