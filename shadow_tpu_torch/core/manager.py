"""The CPU engine's round loop (the port's copy of the reference
package's core/manager.py, cut to model hosts: no socket stacks, TCP
streams, managed processes, pcap, round watchdog or threaded
policies).

Given a window [start, end) from the Controller, the Manager executes
every pending event below the barrier through the serial policy, then
reports the earliest next event time. Under the hybrid policy the
round's cross-host packet judgments are deferred and judged in one
batch at the round's end (`flush_judgments`): on the card by K10
(device/judge.py) at or above the judge's `min_batch` packets, below it
on the CPU by NetworkModel.judge; the verdicts are the same either way.

Host faults (faults.py) are manager-side events: a crash quarantines
the host's events as they surface (counted, packet kinds also as
drops), a restart respawns its processes from the build's factories.
`trace`, where given, records (time, dst, src, kind) per executed
event, the reference's test trace.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from shadow_tpu_torch import simtime
from shadow_tpu_torch.core.event import (
    KIND_BOOT,
    KIND_HOST_CRASH,
    KIND_HOST_RESTART,
    KIND_PACKET,
    KIND_PACKET_READY,
    KIND_STOP,
    KIND_TIMER,
    Event,
)
from shadow_tpu_torch.core.netmodel import NetworkModel
from shadow_tpu_torch.core.scheduler.base import SchedulerPolicy
from shadow_tpu_torch.core.stats import SimStats
from shadow_tpu_torch.core.worker import SimContext
from shadow_tpu_torch.host.cpu import Cpu
from shadow_tpu_torch.host.host import Host
from shadow_tpu_torch.utils import nprng
from shadow_tpu_torch.utils.checksum import chk_mix
from shadow_tpu_torch.utils.rng import PURPOSE_APP

log = logging.getLogger("shadow_tpu_torch.manager")


def resolve_host_ref(name_to_id: dict, groups: dict, name: str,
                     asker_id: int) -> int:
    """Host name or group reference -> host id. A bare group name
    resolves to one member picked by the asking host (asker_id modulo
    the group size), as the device twins pick it."""
    hid = name_to_id.get(name)
    if hid is not None:
        return hid
    members = (groups or {}).get(name)
    if members:
        return members[asker_id % len(members)]
    raise KeyError(f"unknown host name {name!r}")


@dataclass
class Manager:
    hosts: list[Host]
    policy: SchedulerPolicy
    netmodel: NetworkModel
    seed: int
    stats: SimStats = field(default_factory=SimStats)
    trace: Optional[list] = None    # (time, dst, src, kind) if recording
    groups: Optional[dict] = None   # group name -> [host ids]
    # the hybrid policy's batched judge (device/judge.py DeviceJudge);
    # None = judge every send at once on the CPU
    net_judge: Optional[object] = None

    def __post_init__(self):
        self.key = nprng.key_int(self.seed)
        # each host's (seed, APP, host) key, folded once
        self._app_keys: dict[int, tuple[int, int]] = {}
        self._name_to_id = {h.name: h.host_id for h in self.hosts}
        self._barrier = simtime.SIMTIME_INVALID
        # egress packets awaiting the batched judgment:
        # (now, src_host, dst_host, pkt_seq, ev_seq, kind, data)
        self._pending: list[tuple] = []
        self._ctx = SimContext(self)
        for h in self.hosts:
            self.policy.add_host(h.host_id)

    def app_key(self, host_id: int) -> tuple[int, int]:
        k = self._app_keys.get(host_id)
        if k is None:
            k = self._app_keys[host_id] = nprng.fold_in_int(
                nprng.fold_in_int(self.key, PURPOSE_APP), host_id)
        return k

    def resolve_ref(self, name: str, asker_id: int) -> int:
        return resolve_host_ref(self._name_to_id, self.groups, name,
                                asker_id)

    def push_event(self, ev: Event) -> None:
        self.policy.push(ev, self._barrier)

    def schedule_host_faults(self, host_faults: list[tuple]) -> None:
        """host_faults: [(time, host_id, kind)] (faults.py
        resolve_host_faults); the events enter the queue before the
        first round, taking event seqs as boot and stop events do."""
        for t, host_id, kind in host_faults:
            h = self.hosts[host_id]
            self.push_event(Event(
                time=t, dst_host=host_id, src_host=host_id,
                seq=h.next_event_seq(),
                kind=(KIND_HOST_CRASH if kind == "host_crash"
                      else KIND_HOST_RESTART)))

    def _host_crash(self, ctx, host) -> None:
        """KIND_HOST_CRASH: the host's model apps stop executing (their
        objects are replaced at the restart); its pending events are
        quarantined as they surface (execute_event)."""
        log.info("host %s crashed (fault injection)", host.name)
        host.crashed = True

    def _host_restart(self, ctx, host) -> None:
        """KIND_HOST_RESTART: respawn the configured processes from the
        build's factories on a fresh CPU and model NIC. Boot events are
        pushed at the restart time (self-destined, no causality bump);
        a process whose stop_time passed while the host was down stays
        dead behind a None placeholder, and one whose start_time lies
        ahead keeps its original, never quarantined, boot event."""
        log.info("host %s restarting (fault injection; %d events "
                 "quarantined while down)", host.name,
                 host.events_quarantined)
        host.crashed = False
        if host.cpu is not None:
            host.cpu = Cpu()
        if host.model_nic is not None:
            host.model_nic = type(host.model_nic)(host.bw_up_bits,
                                                  host.bw_down_bits)
        if not host.respawn:
            log.warning("host %s restarted with no respawn factories "
                        "(nothing boots)", host.name)
            return
        host.apps = []
        host.app = None
        for proc_idx, (factory, start_time, stop_time, is_model) in \
                enumerate(host.respawn):
            if stop_time is not None and 0 <= stop_time <= ctx.now:
                host.apps.append(None)
                continue
            app = factory()
            host.apps.append(app)
            if is_model or host.app is None:
                host.app = app
            if start_time <= ctx.now:
                self.push_event(Event(
                    time=ctx.now, dst_host=host.host_id,
                    src_host=host.host_id,
                    seq=host.next_event_seq(),
                    kind=KIND_BOOT, data=(proc_idx,)))

    def boot_hosts(self, start_times: list[tuple]) -> None:
        """start_times: (host_id, start_time, stop_time|-1, proc_idx)
        per process: boot and stop events enter the queue before the
        first round."""
        for host_id, t_start, t_stop, idx in start_times:
            h = self.hosts[host_id]
            self.push_event(Event(time=t_start, dst_host=host_id,
                                  src_host=host_id,
                                  seq=h.next_event_seq(),
                                  kind=KIND_BOOT, data=(idx,)))
            if t_stop is not None and t_stop >= 0:
                self.push_event(Event(time=t_stop, dst_host=host_id,
                                      src_host=host_id,
                                      seq=h.next_event_seq(),
                                      kind=KIND_STOP, data=(idx,)))

    def _apply_verdict(self, rec: tuple, delivered: bool,
                       deliver_time: int) -> None:
        """Where a judged packet becomes statistics and an event (or a
        drop), for the CPU rounds and the device batches alike."""
        _, src_h, dst_h, _, ev_seq, kind, data = rec
        host = self.hosts[src_h]
        host.packets_sent += 1
        if not delivered:
            host.packets_dropped += 1
            return
        self.push_event(Event(time=int(deliver_time), dst_host=dst_h,
                              src_host=src_h, seq=ev_seq, kind=kind,
                              data=data))

    def defer_judgment(self, now: int, host, dst_host: int, pkt_seq: int,
                       ev_seq: int, kind: int, data: tuple) -> None:
        """Hybrid policy: queue one egress packet for the round's batch
        (the caller has consumed its event seq already). A self-destined
        packet is judged at once: it takes no causality bump, so one
        below the barrier must enter the queue now to run this round in
        the host's time order (a runahead above the self-path latency).
        The verdict is a pure function of (seed, src, pkt_seq) either
        way."""
        rec = (now, host.host_id, dst_host, pkt_seq, ev_seq, kind, data)
        if dst_host == host.host_id:
            v = self.netmodel.judge(now, host.host_id, dst_host, pkt_seq)
            self._apply_verdict(rec, v.delivered, v.deliver_time)
            return
        self._pending.append(rec)

    def flush_judgments(self) -> None:
        """Judge every pending cross-host packet and push the delivery
        events: one K10 batch at or above the judge's min_batch, else
        the CPU roll per packet. Both add the batch to the path
        counters; a CPU-rolled packet is counted by its roll as well,
        as in the reference (ROADMAP.md (c))."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        j = self.net_judge
        nm = self.netmodel
        t0 = time.perf_counter()
        if len(pending) < j.min_batch:
            for rec in pending:
                v = nm.judge(rec[0], rec[1], rec[2], rec[3])
                self._apply_verdict(rec, v.delivered, v.deliver_time)
            j.cpu_batches += 1
            j.cpu_packets += len(pending)
        else:
            n = len(pending)
            cols = list(zip(*(r[:4] for r in pending)))
            delivered, deliver_time = j.judge_batch(
                np.fromiter(cols[0], np.int64, n),
                np.fromiter(cols[1], np.int32, n),
                np.fromiter(cols[2], np.int32, n),
                np.array(cols[3], np.int64).astype(np.int32))
            for rec, d, t in zip(pending, delivered.tolist(),
                                 deliver_time.tolist()):
                self._apply_verdict(rec, d, t)
        nm.record_paths(Counter(
            (int(nm.host_vertex[r[1]]), int(nm.host_vertex[r[2]]))
            for r in pending))
        j.flush_s += time.perf_counter() - t0

    def run_window(self, window_start: int, window_end: int) -> int:
        """Execute every event in [window_start, window_end); return the
        earliest remaining event time. Under the hybrid policy the
        round's deferred judgments flush after the drain: every verdict
        lands at or after the barrier (cross-host events take the
        causality bump, self-sends were judged at once), so one flush
        per round suffices."""
        self._barrier = window_end
        ctx, stats = self._ctx, self.stats
        while (ev := self.policy.pop(window_end)) is not None:
            self.execute_event(ev, ctx, stats)
        if self.net_judge is not None:
            self.flush_judgments()
        self.stats.rounds += 1
        return self.policy.next_event_time()

    def finalize(self) -> SimStats:
        """The run's totals from the per-host counters, and the per-host
        arrays."""
        s = self.stats
        hosts = self.hosts

        def col(attr, dtype=np.int64):
            return np.array([getattr(h, attr) for h in hosts], dtype)

        s.host_events_executed = col("events_executed")
        s.host_trace_checksum = col("trace_checksum")
        s.host_packets_sent = col("packets_sent")
        s.host_packets_dropped = col("packets_dropped")
        s.host_packets_delivered = col("packets_delivered")
        s.host_events_quarantined = col("events_quarantined")
        s.packets_sent = int(s.host_packets_sent.sum())
        s.packets_dropped = int(s.host_packets_dropped.sum())
        s.packets_delivered = int(s.host_packets_delivered.sum())
        return s

    @staticmethod
    def _proc_of(host, ev: Event):
        """BOOT/STOP dispatch target: the process the event's index
        names, defaulting to the primary app."""
        if ev.data and host.apps:
            idx = ev.data[0]
            if 0 <= idx < len(host.apps):
                return host.apps[idx]
        return host.app

    def execute_event(self, ev: Event, ctx: SimContext,
                      stats: SimStats) -> None:
        """Set the clock and host, apply the CPU-delay model, dispatch
        by kind."""
        host = self.hosts[ev.dst_host]
        if host.crashed and ev.kind != KIND_HOST_RESTART:
            # quarantine: a crashed host executes nothing; packet kinds
            # also count as drops at the dead NIC
            host.events_quarantined += 1
            if ev.kind in (KIND_PACKET, KIND_PACKET_READY):
                host.packets_dropped += ev.npkts
            return
        if host.cpu is not None:
            host.cpu.update_time(ev.time)
            if host.cpu.is_blocked(ev.time):
                # defer while the virtual CPU is busy; deferral times
                # strictly increase per host, so two deferred events
                # keep the order their keys gave them
                new_time = ev.time + host.cpu.delay_until_ready(ev.time)
                floor = getattr(host, "_cpu_defer_floor", -1)
                new_time = max(new_time, floor + 1)
                host._cpu_defer_floor = new_time
                ev.time = new_time
                self.policy.push(ev, self._barrier)
                return
        ctx.now = ev.time
        ctx.host = host
        host.events_executed += 1
        host.trace_checksum = chk_mix(host.trace_checksum, ev.time,
                                      ev.src_host, ev.kind, ev.seq)
        stats.events_executed += 1
        if self.trace is not None:
            self.trace.append((ev.time, ev.dst_host, ev.src_host,
                               ev.kind))
        app = host.app
        if ev.task is not None:
            ev.execute(ctx)
        elif ev.kind == KIND_PACKET:
            nic = host.model_nic
            if nic is not None:
                # the model NIC's receive stage: CoDel may drop, else
                # the payload re-fires as KIND_PACKET_READY after the
                # download serialization, without the causality bump
                size = ev.data[0] if ev.data else 0
                deliver = nic.rx_deliver(ev.time, size)
                if deliver < 0:
                    host.packets_dropped += 1
                else:
                    self.policy.push(
                        Event(time=deliver, dst_host=ev.dst_host,
                              src_host=ev.src_host, seq=ev.seq,
                              kind=KIND_PACKET_READY, data=ev.data,
                              npkts=ev.npkts),
                        simtime.SIMTIME_INVALID)
            else:
                host.packets_delivered += ev.npkts
                if app is not None:
                    size = ev.data[0] if ev.data else 0
                    app.on_packet(ctx, ev.src_host, size, ev.data[1:])
        elif ev.kind == KIND_PACKET_READY:
            host.packets_delivered += ev.npkts
            if app is not None:
                size = ev.data[0] if ev.data else 0
                app.on_packet(ctx, ev.src_host, size, ev.data[1:])
        elif ev.kind == KIND_TIMER:
            if app is not None:
                app.on_timer(ctx, ev.data)
        elif ev.kind == KIND_BOOT:
            target = self._proc_of(host, ev)
            if target is not None:
                target.boot(ctx)
        elif ev.kind == KIND_STOP:
            target = self._proc_of(host, ev)
            if target is not None:
                target.on_stop(ctx)
        elif ev.kind == KIND_HOST_CRASH:
            self._host_crash(ctx, host)
        elif ev.kind == KIND_HOST_RESTART:
            self._host_restart(ctx, host)
