"""The model-app interface of the CPU engine (the port's copy of the
reference package's models/base.py).

A ModelApp is the scripted stand-in for a process. Its hooks receive a
SimContext (core/worker.py) with ``ctx.now``, ``ctx.host_id``,
``ctx.n_hosts``, ``ctx.send``, ``ctx.send_train``, ``ctx.schedule``
and ``ctx.app_bits()``, 32 bits from the counter RNG that the device
twin draws identically, so both make the same decisions.
"""

from __future__ import annotations

import shlex
from functools import lru_cache
from typing import Any


@lru_cache(maxsize=4096)
def _split_cached(args: str) -> tuple[str, ...]:
    # every host of a group carries the same args string
    return tuple(shlex.split(args))


def parse_kv_args(args: Any) -> dict[str, str]:
    """Process args as "k=v k=v" strings, lists or mappings."""
    if isinstance(args, dict):
        return {str(k): str(v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        parts = [str(p) for p in args]
    else:
        parts = _split_cached(str(args or ""))
    out = {}
    for p in parts:
        k, eq, v = p.partition("=")
        if eq:
            out[k.strip("-")] = v
    return out


class ModelApp:
    def __init__(self, args: dict[str, str], host_id: int, n_hosts: int):
        self.args = args
        self.host_id = host_id
        self.n_hosts = n_hosts

    def boot(self, ctx) -> None:
        """Process start."""

    def on_timer(self, ctx, data: tuple) -> None:
        """A ctx.schedule()'d timer fired."""

    def on_packet(self, ctx, src_host: int, size: int,
                  data: tuple) -> None:
        """A packet from src_host was delivered to this host."""

    def on_stop(self, ctx) -> None:
        """Process stop_time reached."""
