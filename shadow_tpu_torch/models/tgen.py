"""tgen-like bulk transfers on the CPU engine (the port's copy of the
reference package's models/tgen.py; core/tgen_args.py holds the
constants and client arguments the device twin shares).

A client asks a server for `size` bytes in chunks of at most CHUNK_PKTS
packets (REQ carries the chunk's first packet index); the server
answers each REQ statelessly with one packet train; the client counts
fresh arrivals, re-requests a chunk after `retry` and repeats `count`
downloads with `pause` between them.

Tags: 1=REQ(d0=start packet index, d1=total bytes), 2=DATA(d0=start).
Timer payload d0: -1 = pause expired; gen >= 0 = chunk retry, valid
only if gen is still current.
"""

from __future__ import annotations

from shadow_tpu_torch.core.tgen_args import (
    CHUNK_PKTS,
    MSS,
    TAG_DATA,
    TAG_REQ,
    TgenClientArgs,
    n_packets,
)
from shadow_tpu_torch.models.base import ModelApp


class TgenServerApp(ModelApp):
    """Stateless chunk server: REQ(start, total) -> one train of up to
    CHUNK_PKTS DATA packets [start, ...), each packet rolled by the
    network under the key a single send would have."""

    def on_packet(self, ctx, src_host, size, data) -> None:
        tag = data[0] if data else 0
        if tag != TAG_REQ:
            return
        start, total = data[1], data[2]
        npkts = n_packets(total)
        cnt = min(CHUNK_PKTS, npkts - start)
        if cnt <= 0:
            return
        last = total % MSS or MSS
        nbytes = cnt * MSS if start + cnt < npkts \
            else (cnt - 1) * MSS + last
        ctx.send_train(src_host, nbytes, (TAG_DATA, start), count=cnt)


class TgenClientApp(ModelApp):
    def __init__(self, args, host_id, n_hosts):
        super().__init__(args, host_id, n_hosts)
        a = TgenClientArgs.parse(args)
        self.server_name = a.server_name
        self.size = a.size
        self.count = a.count
        self.pause_ns = a.pause_ns
        self.retry_ns = a.retry_ns
        self.downloads_done = 0
        self.bytes_received = 0
        self._chunk_start = 0          # first packet index of the chunk
        self._got = 0                  # packets received in the chunk
        self._mask = 0                 # bitmask of chunk seqs received
        self._req_gen = 0              # stale-retry guard
        self._server: int | None = None

    @property
    def _npkts(self) -> int:
        return n_packets(self.size)

    def _request_chunk(self, ctx) -> None:
        if self._server is None:
            self._server = ctx.resolve(self.server_name)
        self._got = 0
        self._mask = 0
        self._req_gen += 1
        ctx.send(self._server, 64, (TAG_REQ, self._chunk_start,
                                    self.size))
        if self.retry_ns > 0:
            ctx.schedule(self.retry_ns, data=(self._req_gen,))

    def boot(self, ctx) -> None:
        if self.count > 0:
            self._request_chunk(ctx)

    def on_timer(self, ctx, data) -> None:
        d0 = data[0] if data else -1
        if d0 >= 0:
            if d0 == self._req_gen:            # chunk still outstanding
                self._request_chunk(ctx)       # re-request (lost DATA)
            return
        self._chunk_start = 0
        self._request_chunk(ctx)

    def on_packet(self, ctx, src_host, size, data) -> None:
        tag = data[0] if data else 0
        if tag != TAG_DATA:
            return
        # a train: (start, survivor bitmask); only fresh in-window bits
        # advance the window, so duplicates from a premature retry
        # cannot complete a chunk
        start = data[1] if len(data) > 1 else -1
        surv = data[2] if len(data) > 2 else 0
        chunk_len = min(CHUNK_PKTS, self._npkts - self._chunk_start)
        shift = start - self._chunk_start
        if shift > 0:
            window = (surv << shift) & ((1 << chunk_len) - 1)
        else:
            window = (surv >> -shift) & ((1 << chunk_len) - 1)
        fresh = window & ~self._mask
        if not fresh:
            return                     # stale chunk / all duplicates
        self._mask |= fresh
        for off in range(chunk_len):
            if fresh & (1 << off):
                seq = self._chunk_start + off
                self.bytes_received += MSS if seq < self._npkts - 1 \
                    else (self.size % MSS or MSS)
                self._got += 1
        if self._got < chunk_len:
            return
        self._chunk_start += chunk_len
        if self._chunk_start < self._npkts:
            self._request_chunk(ctx)
            return
        self.downloads_done += 1
        self._chunk_start = 0
        self._req_gen += 1                     # invalidate pending retry
        if self.downloads_done < self.count:
            ctx.schedule(self.pause_ns, data=(-1,))
