"""Vectorized application models (the port of the reference package's
device/apps.py, cut to PHOLD, tgen and Tor).

`handle` processes one popped event for every host at once; inputs and
outputs are batched over the host dimension [H]. Decisions come only
from the counter-RNG `draws`, consumed in order, and the app state, so
the trace equals the CPU models' (models/phold.py and models/tgen.py
in the reference package). Sends come out in the CPU model's send
order and timers after them: the engine numbers events sends first.

This plain form serves the CPU path; the CUDA pop kernel
(csrc/pop_phase.cu) carries the same decisions as device functions,
PHOLD in K1 `pop_phase`, tgen in K4 `pop_tgen` and Tor in K6
`pop_tor`.

torch on the CPU has no uint32 shifts, so u32 words (survivor and
received-seq masks) are computed in int64 masked to 32 bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from shadow_tpu_torch.core.event import KIND_BOOT, KIND_PACKET, KIND_TIMER
from shadow_tpu_torch.core.tgen_args import (
    CHUNK_PKTS,
    MSS,
    TAG_DATA,
    TAG_REQ,
    n_packets,
)
from shadow_tpu_torch.core.tor_args import (
    CELL_BYTES,
    CHUNK_CELLS,
    SEQ_BITS,
    SEQ_MASK,
    TAG_TOR_DATA,
    TAG_TOR_REQ,
)
from shadow_tpu_torch.device import prng
from shadow_tpu_torch.device.prng import M32
from shadow_tpu_torch.utils.rng import PURPOSE_TOR_ROUTE


class AppOut(NamedTuple):
    send_dst: torch.Tensor       # [H,K] destination host id (int32)
    send_size: torch.Tensor      # [H,K] bytes (int32)
    send_d0: torch.Tensor        # [H,K] payload word 0 (int32)
    send_d1: torch.Tensor        # [H,K] payload word 1 (int32)
    send_valid: torch.Tensor     # [H,K] bool
    timer_delay: torch.Tensor    # [H,T] ns (int64)
    timer_d0: torch.Tensor       # [H,T] timer payload (int32)
    timer_valid: torch.Tensor    # [H,T] bool
    n_draws: torch.Tensor        # [H] app RNG draws consumed (int32)
    app_state: torch.Tensor      # [H,W] updated state (int32)
    # packets per send row [H,K] (trains); None = one each
    send_count: Optional[torch.Tensor] = None
    # live lanes of each send row [H,K] (a forwarded train's
    # survivors); None = all lanes
    send_mask: Optional[torch.Tensor] = None


def _no_timers(H: int, dev) -> dict:
    return {"timer_delay": torch.zeros((H, 0), dtype=torch.int64,
                                       device=dev),
            "timer_d0": torch.zeros((H, 0), dtype=torch.int32, device=dev),
            "timer_valid": torch.zeros((H, 0), dtype=torch.bool,
                                       device=dev)}


def popcount32(x):
    """Bit count of u32 values held in int64."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def wrap32(x):
    """int64 values -> the int32 they wrap to (two's complement)."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def client_arg_columns(count, pause_ns, retry_ns) -> dict:
    """The per-host client args count/pause/retry as [H] world
    columns (tgen and Tor clients take the same three)."""
    return {"client_count": np.ascontiguousarray(count, np.int32),
            "client_pause": np.ascontiguousarray(pause_ns, np.int64),
            "client_retry": np.ascontiguousarray(retry_ns, np.int64)}


class ClientStep(NamedTuple):
    chunk_start: torch.Tensor    # [H] new state words (int32)
    got: torch.Tensor
    done: torch.Tensor
    gen: torch.Tensor
    mask: torch.Tensor
    send_req: torch.Tensor       # [H] bool: request chunk req_start
    req_start: torch.Tensor
    timer_valid: torch.Tensor    # [H] bool
    timer_delay: torch.Tensor    # [H] ns
    timer_d0: torch.Tensor       # [H] -1 = pause, else the request gen


def client_step(is_client, kind, d0, start, d2, chunk_start, got, done,
                gen, mask, world, data_tag: int, total: int,
                chunk: int) -> ClientStep:
    """The pull client's window rule, shared by tgen and Tor: a file
    of `total` units fetched in chunks of `chunk`, one REQ per chunk.

    A DATA train (d0 == data_tag, `start` its first unit, d2 its
    survivors) is aligned to the current window; shifts clip to
    0..31 and a train 32 or more away gives nothing. Only fresh
    in-window bits advance the window, so duplicates from a premature
    retry never complete a chunk. Boot, a pause timer (d0 < 0), a
    current retry timer (d0 == gen) or a completed chunk sends the
    next REQ; a timer follows: the pause after a download, else the
    retry of the REQ."""
    count_h = world["client_count"]
    pause_h, retry_h = world["client_pause"], world["client_retry"]
    is_data = is_client & (kind == KIND_PACKET) & (d0 == data_tag)
    is_boot = is_client & (kind == KIND_BOOT) & (count_h > 0)
    is_timer = is_client & (kind == KIND_TIMER)
    timer_pause = is_timer & (d0 < 0)
    timer_retry = is_timer & (d0 >= 0) & (d0 == gen)

    chunk_len = torch.clamp(total - chunk_start, max=chunk)
    shift = wrap32(start.long() - chunk_start.long()).long()
    surv = d2.long() & M32
    up = (surv << shift.clamp(0, 31)) & M32
    down = surv >> wrap32(-shift).long().clamp(0, 31)
    aligned = torch.where(shift >= 0, up, down)
    aligned = torch.where((shift >= 32) | (shift <= -32), 0, aligned)
    wmask = torch.where(chunk_len >= 32, M32,
                        (1 << chunk_len.long().clamp(0, 31)) - 1)
    window = aligned & wmask
    fresh_bits = window & ~(mask.long() & M32) & M32
    fresh = is_data & (fresh_bits != 0)
    new_mask = torch.where(fresh, wrap32(mask.long() | fresh_bits), mask)
    new_got = torch.where(
        fresh, got + popcount32(fresh_bits).to(torch.int32), got)
    complete = fresh & (new_got >= chunk_len)
    next_start = chunk_start + chunk_len
    dl_done = complete & (next_start >= total)
    cont = complete & ~dl_done

    send_req = is_boot | timer_pause | timer_retry | cont
    req_start = torch.where(cont, next_start,
                            torch.where(timer_retry, chunk_start, 0))
    new_chunk_start = torch.where(
        cont, next_start,
        torch.where(is_boot | timer_pause | dl_done, 0, chunk_start))
    reset = send_req | dl_done
    new_done = done + dl_done.to(torch.int32)
    new_gen = gen + reset.to(torch.int32)
    # the timer: pause and retry exclude each other
    pause_valid = dl_done & (new_done < count_h)
    retry_valid = send_req & (retry_h > 0)
    return ClientStep(
        chunk_start=new_chunk_start, got=torch.where(reset, 0, new_got),
        done=new_done, gen=new_gen, mask=torch.where(reset, 0, new_mask),
        send_req=send_req, req_start=req_start,
        timer_valid=pause_valid | retry_valid,
        timer_delay=torch.where(pause_valid, pause_h, retry_h).long(),
        timer_d0=torch.where(pause_valid, -1, new_gen).to(torch.int32))


@dataclass
class PholdDevice:
    """Boot sends `msgload` messages to peers picked as
    (self + 1 + bits % (n-1)) % n, one draw per message; each received
    packet triggers one more send the same way."""

    n_hosts_total: int
    msgload: int = 1
    size: int = 64
    selfloop: int = 0

    n_state_words = 1            # [received_count]
    max_timers = 0
    max_train = 1
    burst_pops = 1

    @property
    def max_sends(self) -> int:
        return max(1, self.msgload)

    @property
    def max_draws(self) -> int:
        return max(1, self.msgload)

    def init_state(self, n_hosts: int) -> np.ndarray:
        return np.zeros((n_hosts, self.n_state_words), np.int32)

    def world_columns(self) -> dict:
        return {}

    def downloads(self, app_state: np.ndarray) -> None:
        return None

    def pick_peer(self, gid: torch.Tensor, bits: torch.Tensor):
        """bits: u32 values held in int64 (prng.random_bits32)."""
        n = self.n_hosts_total
        if self.selfloop or n == 1:
            return (bits % n).to(torch.int32)
        g = gid.to(torch.int64) & M32
        return (((g + 1 + bits % (n - 1)) & M32) % n).to(torch.int32)

    def handle(self, gid, now, kind, src, size, d0, d1, d2, app_state,
               draws, world=None) -> AppOut:
        H, K = draws.shape[0], self.max_sends
        boot = kind == KIND_BOOT
        pkt = kind == KIND_PACKET
        ks = torch.arange(K, device=draws.device)[None, :]
        valid = torch.where(boot[:, None], ks < self.msgload,
                            pkt[:, None] & (ks == 0))
        peers = self.pick_peer(gid[:, None], draws[:, :K])
        sizes = torch.full((H, K), self.size, dtype=torch.int32,
                           device=draws.device)
        zeros = torch.zeros((H, K), dtype=torch.int32, device=draws.device)
        n_draws = torch.where(boot, self.msgload,
                              torch.where(pkt, 1, 0)).to(torch.int32)
        new_state = app_state.clone()
        new_state[:, 0] += pkt.to(torch.int32)
        return AppOut(send_dst=peers, send_size=sizes, send_d0=zeros,
                      send_d1=zeros, send_valid=valid, n_draws=n_draws,
                      app_state=new_state, **_no_timers(H, draws.device))


@dataclass
class TgenDevice:
    """Chunked pull-based bulk download with a stateless server. One
    app covers both roles (the per-host role word), so client/server
    mixes run as one program.

    State words: [role, server_gid, chunk_start, got, downloads_done,
    req_gen, seq_mask]. REQ is d0=TAG_REQ d1=start; DATA is one packet
    train row with d1=start and the network's survivor bitmask in d2;
    a timer's d0 is -1 for a pause and the request generation for a
    retry. seq_mask holds the received seqs of the current window:
    only fresh in-window bits advance it, so duplicates from a
    premature retry never complete a chunk.

    `size` shapes the servers' answers and is one value; the client
    args count/pause/retry are per host, [H] arrays that the engine
    carries in its world (`world_columns`)."""

    roles: np.ndarray = field(repr=False)        # [H] 0=server 1=client
    server_gid: np.ndarray = field(repr=False)   # [H] client's server
    size: int = 1 << 20
    count: np.ndarray = field(default=1, repr=False)
    pause_ns: np.ndarray = field(default=1_000_000_000, repr=False)
    retry_ns: np.ndarray = field(default=0, repr=False)
    # servers are stateless responders: one iteration answers a run
    # of up to burst_pops REQs (experimental.burst_pops overrides)
    burst_pops: int = 8

    n_state_words = 7
    max_sends = 1                # a whole chunk is ONE train row
    max_train = CHUNK_PKTS
    max_timers = 1
    max_draws = 0                # tgen draws nothing

    def __post_init__(self):
        self.npkts = n_packets(self.size)
        self.last_sz = self.size % MSS or MSS
        self.chunk = CHUNK_PKTS
        shape = np.shape(self.roles)
        self.count = np.broadcast_to(
            np.asarray(self.count, np.int32), shape)
        self.pause_ns = np.broadcast_to(
            np.asarray(self.pause_ns, np.int64), shape)
        self.retry_ns = np.broadcast_to(
            np.asarray(self.retry_ns, np.int64), shape)

    def init_state(self, n_hosts: int) -> np.ndarray:
        # past len(roles): a mesh's padded hosts, inert servers that
        # never receive a REQ (the reference's init_state)
        st = np.zeros((n_hosts, self.n_state_words), np.int32)
        n = min(n_hosts, len(self.roles))
        st[:n, 0] = self.roles[:n]
        st[:n, 1] = self.server_gid[:n]
        return st

    def world_columns(self) -> dict:
        """The per-host client args, [H] each."""
        return client_arg_columns(self.count, self.pause_ns, self.retry_ns)

    def downloads(self, app_state: np.ndarray) -> int:
        """Downloads completed: the sum of app word 4."""
        return int(app_state[:, 4].sum())

    def server_response(self, d1):
        """The stateless answer to a REQ for chunk start d1: (train
        packet count, bytes), the chunk [d1, d1+cnt) as one train of
        MSS packets, the last one short where the chunk ends the
        file. One source for the single and the burst path. int32
        arithmetic wraps as on the device."""
        d1 = d1.to(torch.int64)
        srv_cnt = wrap32(self.npkts - d1).clamp(0, self.chunk)
        ends_file = wrap32(d1 + srv_cnt) >= self.npkts
        srv_bytes = torch.where(
            ends_file, (srv_cnt - 1) * MSS + self.last_sz, srv_cnt * MSS)
        return srv_cnt, srv_bytes.to(torch.int32)

    def burst_mask(self, app_state):
        return app_state[:, 0] == 0          # servers: stateless

    def handle(self, gid, now, kind, src, size, d0, d1, d2, app_state,
               draws, world) -> AppOut:
        H = app_state.shape[0]
        dev = app_state.device
        role, server = app_state[:, 0], app_state[:, 1]
        is_server = role == 0
        c = client_step(role == 1, kind, d0, d1, d2, app_state[:, 2],
                        app_state[:, 3], app_state[:, 4], app_state[:, 5],
                        app_state[:, 6], world, TAG_DATA, self.npkts,
                        self.chunk)
        st = app_state.clone()
        for w, v in ((2, c.chunk_start), (3, c.got), (4, c.done),
                     (5, c.gen), (6, c.mask)):
            st[:, w] = v

        # one send: a server's DATA train or a client's REQ
        is_req = is_server & (kind == KIND_PACKET) & (d0 == TAG_REQ)
        srv_cnt, srv_bytes = self.server_response(d1)
        srv_valid = is_req & (srv_cnt > 0)
        sv = is_server
        i32 = torch.int32

        def col(a, b):
            return torch.where(sv, a, b).to(i32)[:, None]

        return AppOut(
            send_dst=col(src, server), send_size=col(srv_bytes, 64),
            send_d0=col(torch.full_like(d1, TAG_DATA), TAG_REQ),
            send_d1=col(d1, c.req_start),
            send_valid=torch.where(sv, srv_valid, c.send_req)[:, None],
            timer_delay=c.timer_delay[:, None],
            timer_d0=c.timer_d0[:, None],
            timer_valid=c.timer_valid[:, None],
            n_draws=torch.zeros(H, dtype=i32, device=dev),
            app_state=st, send_count=col(srv_cnt, 1))

    def handle_burst(self, gid, nowP, kindP, srcP, sizeP, d0P, d1P, d2P,
                     app_state, draws, world) -> AppOut:
        """Event args are [H,P] columns (inactive ones carry kind -1).
        Column 0 runs the full role logic; columns 1+ can only be
        burst-popped server REQs, answered by the same stateless
        response, lane j answering column j."""
        base = self.handle(gid, nowP[:, 0], kindP[:, 0], srcP[:, 0],
                           sizeP[:, 0], d0P[:, 0], d1P[:, 0], d2P[:, 0],
                           app_state, draws, world)
        is_req = (app_state[:, 0] == 0)[:, None] & \
            (kindP == KIND_PACKET) & (d0P == TAG_REQ)
        srv_cnt, srv_bytes = self.server_response(d1P)

        def lanes(l0, rest):
            return torch.cat([l0, rest[:, 1:].to(l0.dtype)], 1)

        return base._replace(
            send_dst=lanes(base.send_dst, srcP),
            send_size=lanes(base.send_size, srv_bytes),
            send_d0=lanes(base.send_d0, torch.full_like(d1P, TAG_DATA)),
            send_d1=lanes(base.send_d1, d1P),
            send_valid=lanes(base.send_valid, is_req & (srv_cnt > 0)),
            send_count=lanes(base.send_count, srv_cnt))


@dataclass
class TorDevice:
    """Onion circuits as pure functions of the client id: a circuit's
    relays are drawn from the counter RNG keyed (TOR_ROUTE, circ, hop)
    (`route`), so relays are stateless and every hop decision is one
    batched branch.

    State words (clients; relays only use word 0): [role, chunk_start,
    got, done, gen, mask]. d1 packs (circ << SEQ_BITS) | chunk start.
    A client's REQ goes to its guard; the guard forwards it to the
    middle, the middle to the exit, which answers with one DATA train
    of CHUNK_CELLS lanes (the low `cnt` bits live). The middle and the
    guard forward each train's survivors as a new masked train, the
    guard to the client, whose window rule is tgen's (`client_step`).

    `cells` shapes the exits' answers and is one value; the client
    args count/pause/retry are per host, [H] arrays that the engine
    carries in its world with the relay ids (`world_columns`)."""

    roles: np.ndarray = field(repr=False)        # [H] 0=relay 1=client
    relay_gids: np.ndarray = field(repr=False)   # [R] sorted
    seed: int = 1
    cells: int = 64
    count: np.ndarray = field(default=1, repr=False)
    pause_ns: np.ndarray = field(default=1_000_000_000, repr=False)
    retry_ns: np.ndarray = field(default=0, repr=False)
    # relays are stateless responders: one iteration answers a run of
    # up to burst_pops packets (experimental.burst_pops overrides)
    burst_pops: int = 8

    n_state_words = 6
    max_sends = 1                # a whole chunk is ONE train row
    max_train = CHUNK_CELLS
    max_timers = 1
    max_draws = 0                # routes are keyed draws, not the app's

    def __post_init__(self):
        if len(self.relay_gids) < 3:
            raise ValueError("tor model needs >= 3 relays")
        if self.cells > SEQ_MASK:
            raise ValueError(f"cells > {SEQ_MASK} not encodable")
        self.chunk = CHUNK_CELLS
        shape = np.shape(self.roles)
        self.count = np.broadcast_to(
            np.asarray(self.count, np.int32), shape)
        self.pause_ns = np.broadcast_to(
            np.asarray(self.pause_ns, np.int64), shape)
        self.retry_ns = np.broadcast_to(
            np.asarray(self.retry_ns, np.int64), shape)
        # the seed and purpose folds are the same for every circuit
        self.route_key = prng.fold_in(prng.seed_key(self.seed),
                                      PURPOSE_TOR_ROUTE)

    def init_state(self, n_hosts: int) -> np.ndarray:
        st = np.zeros((n_hosts, self.n_state_words), np.int32)
        n = min(n_hosts, len(self.roles))
        st[:n, 0] = self.roles[:n]
        return st

    def world_columns(self) -> dict:
        """The per-host client args, [H] each, and the relay ids [R]."""
        return {**client_arg_columns(self.count, self.pause_ns,
                                     self.retry_ns),
                "relay_gids": np.ascontiguousarray(self.relay_gids,
                                                   np.int32)}

    def downloads(self, app_state: np.ndarray) -> int:
        """Downloads completed: the clients' app word 3."""
        return int(app_state[app_state[:, 0] == 1, 3].sum())

    def _draws(self, circ, hops: int):
        """The first `hops` draws of circuits `circ`: hop j's is
        random_bits32(chain_key(seed, TOR_ROUTE, circ, j)); the folds up
        to the circuit are shared by the hops."""
        key = prng.fold_in(self.route_key, circ)
        return [prng.random_bits32(prng.fold_seq(key, j))
                for j in range(hops)]

    def guard(self, circ, world):
        """The circuits' guards: hop 0 of `route`, one draw."""
        bits, = self._draws(circ, 1)
        return world["relay_gids"][bits % world["relay_gids"].shape[0]]

    def route(self, circ, world):
        """(guard, middle, exit) host ids of the circuits `circ`:
        `pick_route` over three draws, vectorized."""
        gids = world["relay_gids"]
        R = gids.shape[0]
        b0, b1, b2 = self._draws(circ, 3)
        g = b0 % R
        m = b1 % (R - 1)
        m = torch.where(m >= g, m + 1, m)
        lo, hi = torch.minimum(g, m), torch.maximum(g, m)
        e = b2 % (R - 2)
        e = torch.where(e >= lo, e + 1, e)
        e = torch.where(e >= hi, e + 1, e)
        return gids[g], gids[m], gids[e]

    def relay_lane(self, me, kind, d0, d1, d2, world):
        """The stateless relay answer to one popped event, shared by
        column 0 and the burst columns; same-shape inputs, returns
        (valid, dst, size, d0, d1, count, mask). d1 is echoed on every
        hop. The exit answers a REQ with CHUNK_CELLS lanes, the low
        `cnt` live; a forwarded train keeps its survivors, and one
        with none left is not sent."""
        is_pkt = kind == KIND_PACKET
        circ = d1 >> SEQ_BITS
        start = d1 & SEQ_MASK
        G, M, E = self.route(circ, world)
        r_req = is_pkt & (d0 == TAG_TOR_REQ)
        r_data = is_pkt & (d0 == TAG_TOR_DATA)
        fwd_req_g = r_req & (me == G)        # -> M
        fwd_req_m = r_req & (me == M)        # -> E
        serve = r_req & (me == E)            # exit: DATA train
        fwd_data_m = r_data & (me == M)      # -> G
        fwd_data_g = r_data & (me == G)      # -> client (circ)
        fwd_data = fwd_data_m | fwd_data_g

        cnt = (self.cells - start).clamp(0, self.chunk)
        full = (1 << cnt.long()) - 1
        live = popcount32(d2.long()).to(torch.int32)
        valid = fwd_req_g | fwd_req_m | (serve & (cnt > 0)) | \
            (fwd_data & (d2 != 0))
        dst = torch.where(
            fwd_req_g, M, torch.where(
                fwd_req_m, E, torch.where(
                    serve, M, torch.where(fwd_data_m, G, circ))))
        size = torch.where(serve, CELL_BYTES * cnt,
                           torch.where(fwd_data, CELL_BYTES * live, 64))
        out_d0 = torch.where(serve, TAG_TOR_DATA, d0)
        count = torch.where(serve | fwd_data, self.chunk, 1)
        lmask = torch.where(serve, full, torch.where(fwd_data, d2.long(), 1))
        i32 = torch.int32
        return (valid, dst.to(i32), size.to(i32), out_d0.to(i32),
                d1.to(i32), count.to(i32), lmask.to(i32))

    def burst_mask(self, app_state):
        return app_state[:, 0] == 0          # relays: stateless

    def handle(self, gid, now, kind, src, size, d0, d1, d2, app_state,
               draws, world) -> AppOut:
        relay = self.relay_lane(gid, kind, d0, d1, d2, world)
        return self._handle(gid, kind, d0, d1, d2, app_state, world, relay)

    def _handle(self, gid, kind, d0, d1, d2, app_state, world,
                relay) -> AppOut:
        """`handle` given the relay lane of the same event."""
        H = app_state.shape[0]
        dev = app_state.device
        role = app_state[:, 0]
        is_relay, is_client = role == 0, role == 1
        r_valid, r_dst, r_size, r_d0, r_d1, r_count, r_mask = relay
        rv = r_valid & is_relay

        c = client_step(is_client, kind, d0, d1 & SEQ_MASK, d2,
                        app_state[:, 1], app_state[:, 2], app_state[:, 3],
                        app_state[:, 4], app_state[:, 5], world,
                        TAG_TOR_DATA, self.cells, self.chunk)
        st = app_state.clone()
        for w, v in ((1, c.chunk_start), (2, c.got), (3, c.done),
                     (4, c.gen), (5, c.mask)):
            st[:, w] = v

        # the single send lane: a relay's row or a client's REQ to its
        # guard
        req_d1 = wrap32((gid.long() << SEQ_BITS) | c.req_start.long())
        i32 = torch.int32

        def col(a, b):
            return torch.where(rv, a, b).to(i32)[:, None]

        return AppOut(
            send_dst=col(r_dst, self.guard(gid, world)),
            send_size=col(r_size, 64), send_d0=col(r_d0, TAG_TOR_REQ),
            send_d1=col(r_d1, req_d1),
            send_valid=(rv | c.send_req)[:, None],
            timer_delay=c.timer_delay[:, None],
            timer_d0=c.timer_d0[:, None],
            timer_valid=c.timer_valid[:, None],
            n_draws=torch.zeros(H, dtype=i32, device=dev),
            app_state=st, send_count=col(r_count, 1),
            send_mask=col(r_mask, 1))

    def handle_burst(self, gid, nowP, kindP, srcP, sizeP, d0P, d1P, d2P,
                     app_state, draws, world) -> AppOut:
        """Event args are [H,P] columns (inactive ones carry kind -1).
        Column 0 runs the full role logic; columns 1+ can only be
        burst-popped relay packets, answered by the same stateless
        lane, one train row each."""
        lane = self.relay_lane(gid[:, None], kindP, d0P, d1P, d2P, world)
        base = self._handle(gid, kindP[:, 0], d0P[:, 0], d1P[:, 0],
                            d2P[:, 0], app_state, world,
                            tuple(x[:, 0] for x in lane))
        valid, dst, size, d0o, d1o, count, lmask = lane
        valid = valid & self.burst_mask(app_state)[:, None]

        def lanes(l0, rest):
            return torch.cat([l0, rest[:, 1:].to(l0.dtype)], 1)

        return base._replace(
            send_dst=lanes(base.send_dst, dst),
            send_size=lanes(base.send_size, size),
            send_d0=lanes(base.send_d0, d0o),
            send_d1=lanes(base.send_d1, d1o),
            send_valid=lanes(base.send_valid, valid),
            send_count=lanes(base.send_count, count),
            send_mask=lanes(base.send_mask, lmask))
