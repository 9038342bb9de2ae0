"""The execution context model apps see (the port's copy of the
reference package's core/worker.py, without the socket API).

`send` is the reference's worker_sendPacket: the packet is judged by
the NetworkModel, or under the hybrid policy deferred to the round's
batched device judgment (core/manager.py, device/judge.py); `schedule`
sets a self timer. Trains and model-NIC sends are judged at once, under
every policy.
"""

from __future__ import annotations

from typing import Optional

from shadow_tpu_torch import simtime
from shadow_tpu_torch.core.event import Event, KIND_PACKET, KIND_TIMER
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.utils import nprng


class SimContext:
    """Passed to ModelApp hooks; valid only during one event."""

    def __init__(self, manager):
        self._m = manager
        self.now: int = simtime.SIMTIME_INVALID
        self.host: Optional[Host] = None

    @property
    def host_id(self) -> int:
        return self.host.host_id

    @property
    def n_hosts(self) -> int:
        return len(self._m.hosts)

    def resolve(self, name: str) -> int:
        """Host name or group reference -> host id; a group picks a
        member keyed by the asking host."""
        return self._m.resolve_ref(name, self.host.host_id)

    def app_bits(self) -> int:
        """32 random bits keyed by (APP, host, draw#), as the device
        twin draws them."""
        seq = self.host.next_app_seq()
        key = nprng.fold_in_int(self._m.app_key(self.host.host_id), seq)
        return nprng.random_bits32_int(key)

    def pure_bits(self, purpose: int, a: int, b: int) -> int:
        """32 bits from the stateless key (purpose, a, b): no draw
        counter is consumed, so any host recomputes the same value."""
        key = nprng.fold_in_int(
            nprng.fold_in_int(
                nprng.fold_in_int(self._m.key, purpose), a), b)
        return nprng.random_bits32_int(key)

    def send(self, dst_host: int, size: int, data: tuple = ()) -> bool:
        """Send a packet through the network model. Returns False where
        the drop roll discarded it; under the hybrid policy cross-host
        verdicts are deferred to the round's batch and True is returned,
        so apps must not branch on it."""
        host = self.host
        pkt_seq = host.next_packet_seq()
        # the event seq is consumed for every send, delivered or not, so
        # that deferring the judgment perturbs no later seq
        ev_seq = host.next_event_seq()
        if host.model_nic is not None:
            # bandwidth-modeled send: serialize on the TX bucket, roll at
            # the send time, arrive at depart + latency; judged at once
            # under every policy (the TX state is sequential per host)
            depart = host.model_nic.tx_depart(self.now, size)
            verdict = self._m.netmodel.judge(self.now, host.host_id,
                                             dst_host, pkt_seq)
            host.packets_sent += 1
            if not verdict.delivered:
                host.packets_dropped += 1
                return False
            ev = Event(time=depart + verdict.latency_ns,
                       dst_host=dst_host, src_host=host.host_id,
                       seq=ev_seq, kind=KIND_PACKET,
                       data=(size,) + tuple(data))
            self._m.push_event(ev)
            return True
        if self._m.net_judge is not None:
            self._m.defer_judgment(self.now, host, dst_host, pkt_seq,
                                   ev_seq, KIND_PACKET,
                                   (size,) + tuple(data))
            return True
        verdict = self._m.netmodel.judge(self.now, host.host_id, dst_host,
                                         pkt_seq)
        host.packets_sent += 1
        if not verdict.delivered:
            host.packets_dropped += 1
            return False
        ev = Event(time=verdict.deliver_time, dst_host=dst_host,
                   src_host=host.host_id, seq=ev_seq,
                   kind=KIND_PACKET, data=(size,) + tuple(data))
        self._m.push_event(ev)
        return True

    def send_train(self, dst_host: int, size: int, data: tuple = (),
                   count: int = 1, mask: Optional[int] = None) -> int:
        """Send `count` packets as one train event: one delivery, one
        drop roll per packet under the keys single sends would use. The
        delivery's data is (size, *data, survivor bitmask). `mask`
        forwards a previous hop's survivors: only its bits are packets,
        while seqs and roll keys span all `count` lanes. Judged at once
        under every policy. Returns the survivor mask."""
        count = max(1, count)
        live = (1 << count) - 1 if mask is None \
            else mask & ((1 << count) - 1)
        host = self.host
        pkt_seq0 = host._packet_seq
        host._packet_seq += count
        ev_seq = host.next_event_seq()
        surv, deliver, lat = self._m.netmodel.judge_train(
            self.now, host.host_id, dst_host, pkt_seq0, count,
            live=live.bit_count())
        surv &= live
        host.packets_sent += live.bit_count()
        host.packets_dropped += live.bit_count() - surv.bit_count()
        if host.model_nic is not None:
            # dropped trains still take the uplink's time
            depart = host.model_nic.tx_depart(self.now, size)
            deliver = depart + lat
        if surv == 0:
            return 0
        ev = Event(time=deliver, dst_host=dst_host,
                   src_host=host.host_id, seq=ev_seq,
                   kind=KIND_PACKET, data=(size,) + tuple(data)
                   + (surv,), npkts=surv.bit_count())
        self._m.push_event(ev)
        return surv

    def schedule(self, delay_ns: int, data: tuple = ()) -> None:
        """Self timer after delay_ns -> on_timer."""
        host = self.host
        ev = Event(time=self.now + max(0, delay_ns),
                   dst_host=host.host_id, src_host=host.host_id,
                   seq=host.next_event_seq(), kind=KIND_TIMER,
                   data=tuple(data))
        self._m.push_event(ev)

    def consume_cpu(self, native_ns: int) -> None:
        """Synthetic CPU load: later events on this host wait while the
        virtual CPU works off the backlog."""
        if self.host.cpu is not None:
            self.host.cpu.add_delay(native_ns)
