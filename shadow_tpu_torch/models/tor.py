"""The onion-routing workload on the CPU engine (the port's copy of the
reference package's models/tor.py; core/tor_args.py holds the
constants, the route rule and the client arguments the device twin
shares).

Relays are stateless: a circuit is a pure function of the client id
(three distinct relays drawn from the counter RNG keyed (TOR_ROUTE,
client, hop)), so any relay recomputes its position and next hop from
the cell's circuit id. REQ cells travel client -> guard -> middle ->
exit; the exit answers with a train of up to CHUNK_CELLS DATA cells
back through middle and guard, each hop forwarding the survivors as a
masked train.
"""

from __future__ import annotations

from shadow_tpu_torch.core.tor_args import (
    CELL_BYTES,
    CHUNK_CELLS,
    TAG_TOR_DATA,
    TAG_TOR_REQ,
    TorClientArgs,
    pick_route,
)
from shadow_tpu_torch.models.base import ModelApp
from shadow_tpu_torch.utils.rng import PURPOSE_TOR_ROUTE


class TorMixin:
    """The route over the config's relays."""

    def _relay_gids(self, ctx) -> list[int]:
        if getattr(self, "_relays", None) is None:
            # every host whose app is a relay, in id order (the device
            # twin derives the same list from the roles)
            self._relays = [h.host_id for h in ctx._m.hosts
                            if isinstance(h.app, TorRelayApp)]
            if len(self._relays) < 3:
                raise ValueError("tor model needs >= 3 relays")
        return self._relays

    def _route(self, ctx, circ: int) -> tuple[int, int, int]:
        relays = self._relay_gids(ctx)
        bits = tuple(ctx.pure_bits(PURPOSE_TOR_ROUTE, circ, j)
                     for j in range(3))
        g, m, e = pick_route(bits, len(relays))
        return relays[g], relays[m], relays[e]


class TorRelayApp(ModelApp, TorMixin):
    """Stateless relay: forwards one hop; the exit serves REQ chunks."""

    def __init__(self, args, host_id, n_hosts):
        super().__init__(args, host_id, n_hosts)
        self.cells_relayed = 0
        self.cells_served = 0

    def on_packet(self, ctx, src_host, size, data) -> None:
        tag = data[0] if data else 0
        if tag == TAG_TOR_REQ:
            circ, start = data[1], data[2]
            g, m, e = self._route(ctx, circ)
            me = ctx.host_id
            if me == g:
                self.cells_relayed += 1
                ctx.send(m, size, tuple(data))
            elif me == m:
                self.cells_relayed += 1
                ctx.send(e, size, tuple(data))
            elif me == e:
                n_cells = data[3]
                cnt = min(CHUNK_CELLS, n_cells - start)
                if cnt > 0:
                    self.cells_served += cnt
                    ctx.send_train(
                        m, CELL_BYTES * cnt,
                        (TAG_TOR_DATA, circ, start),
                        count=CHUNK_CELLS, mask=(1 << cnt) - 1)
        elif tag == TAG_TOR_DATA:
            # (circ, chunk start, survivor mask): the survivors go on as
            # a new masked train whose roll keys span all CHUNK_CELLS
            # lanes
            circ, start, surv = data[1], data[2], data[3]
            g, m, e = self._route(ctx, circ)
            me = ctx.host_id
            live = surv.bit_count()
            if live == 0:
                return
            if me == m:
                self.cells_relayed += live
                ctx.send_train(g, CELL_BYTES * live,
                               (TAG_TOR_DATA, circ, start),
                               count=CHUNK_CELLS, mask=surv)
            elif me == g:
                self.cells_relayed += live
                ctx.send_train(circ, CELL_BYTES * live,
                               (TAG_TOR_DATA, circ, start),
                               count=CHUNK_CELLS, mask=surv)


class TorClientApp(ModelApp, TorMixin):
    """Chunked cell puller through its circuit (the tgen client's
    window, mask and retry rules)."""

    def __init__(self, args, host_id, n_hosts):
        super().__init__(args, host_id, n_hosts)
        a = TorClientArgs.parse(args)
        self.cells = a.cells
        self.count = a.count
        self.pause_ns = a.pause_ns
        self.retry_ns = a.retry_ns
        self.downloads_done = 0
        self.cells_received = 0
        self._chunk_start = 0
        self._got = 0
        self._mask = 0
        self._gen = 0

    def _request_chunk(self, ctx) -> None:
        g, _m, _e = self._route(ctx, ctx.host_id)
        self._got = 0
        self._mask = 0
        self._gen += 1
        ctx.send(g, 64, (TAG_TOR_REQ, ctx.host_id, self._chunk_start,
                         self.cells))
        if self.retry_ns > 0:
            ctx.schedule(self.retry_ns, data=(self._gen,))

    def boot(self, ctx) -> None:
        if self.count > 0:
            self._request_chunk(ctx)

    def on_timer(self, ctx, data) -> None:
        d0 = data[0] if data else -1
        if d0 >= 0:
            if d0 == self._gen:           # chunk still outstanding
                self._request_chunk(ctx)
            return
        self._chunk_start = 0
        self._request_chunk(ctx)

    def on_packet(self, ctx, src_host, size, data) -> None:
        tag = data[0] if data else 0
        if tag != TAG_TOR_DATA:
            return
        start, surv = data[2], data[3]
        chunk_len = min(CHUNK_CELLS, self.cells - self._chunk_start)
        shift = start - self._chunk_start
        if shift > 0:
            window = (surv << shift) & ((1 << chunk_len) - 1)
        else:
            window = (surv >> -shift) & ((1 << chunk_len) - 1)
        fresh = window & ~self._mask
        if not fresh:
            return                        # stale chunk / duplicates
        self._mask |= fresh
        got_add = fresh.bit_count()
        self._got += got_add
        self.cells_received += got_add
        if self._got < chunk_len:
            return
        nxt = self._chunk_start + chunk_len
        if nxt < self.cells:
            self._chunk_start = nxt
            self._request_chunk(ctx)
            return
        self.downloads_done += 1
        self._chunk_start = 0
        self._got = 0
        self._mask = 0
        self._gen += 1                    # invalidate pending retries
        if self.downloads_done < self.count:
            ctx.schedule(self.pause_ns, data=(-1,))
