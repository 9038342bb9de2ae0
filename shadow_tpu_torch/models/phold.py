"""PHOLD on the CPU engine (the port's copy of the reference package's
models/phold.py): every received message triggers one new message to a
pseudo-random peer; `msgload` messages per host start at boot.

args: msgload=K (default 1), size=bytes (default 64), selfloop=0/1
(default 0), cpuload=ms of virtual CPU per received message (CPU
engines only; default 0).
"""

from __future__ import annotations

from shadow_tpu_torch.models.base import ModelApp


class PholdApp(ModelApp):
    def __init__(self, args, host_id, n_hosts):
        super().__init__(args, host_id, n_hosts)
        self.msgload = int(args.get("msgload", 1))
        self.size = int(args.get("size", 64))
        self.selfloop = int(args.get("selfloop", 0))
        self.cpuload_ms = int(args.get("cpuload", 0))
        self.received = 0

    def _pick_peer(self, ctx) -> int:
        bits = ctx.app_bits()
        if self.selfloop or self.n_hosts == 1:
            return bits % self.n_hosts
        # exclude self without biasing the draw
        return (self.host_id + 1 + bits % (self.n_hosts - 1)) % self.n_hosts

    def boot(self, ctx) -> None:
        for _ in range(self.msgload):
            ctx.send(self._pick_peer(ctx), self.size)

    def on_packet(self, ctx, src_host, size, data) -> None:
        self.received += 1
        if self.cpuload_ms:
            ctx.consume_cpu(self.cpuload_ms * 1_000_000)
        ctx.send(self._pick_peer(ctx), self.size)
