"""The hybrid policy's batched network judgment (the port of the
reference package's device/judge.py `DeviceJudge`).

Under the hybrid policy the CPU engine (core/manager.py) runs the hosts
and defers each round's cross-host packet judgments; at the round's end
the batch of N packets (send time, src, dst, packet seq) is judged on
the card by K10 judge_batch (csrc/judge_batch.cu): the path lookup in
the epoch of the send time and the threefry drop roll, the same chain
as the CPU NetworkModel and the device engine, so a hybrid run's trace
equals a serial one's. Rounds below `min_batch` packets roll on the CPU
instead (the manager decides; the reference's configured crossover,
`experimental.hybrid_judge_min_batch`).

At construction the judge builds what the world holds once: its tables
on the card and K10's view of them (kernels.judge_tables: the drop key
of every host, on factored tables a record a host and the packed access
and core pairs), the launch's argument block, checked once, and a CUDA
graph of a flush (the copy in, K10, the copy out, an event before and
after each). A flush then writes the four input columns into one pinned
host buffer and makes one C call (Kernels.judge_flush), which sets the
graph to its size, launches it on the current stream, waits for it and
returns the kernel's and the copies' device ms. The launch
takes N as it is (the reference pads to power-of-two buckets so that
XLA compiles few shapes). `judge_s` is the host wall of judge_batch. On
the CPU (device="cpu") the batch goes through judge_batch_plain. Under
`Kernels.designs_before` a flush takes the path before (the wrapper's
set-up and checks each flush, events around the whole wrapper), to
measure against. A failed build or launch raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import Optional

import numpy as np
import torch

from shadow_tpu_torch.device import prng
from shadow_tpu_torch.device.engine import (
    resolve_device,
    upload_world,
    world_arrays,
)
from shadow_tpu_torch.device.kernels import Kernels, judge_tables
from shadow_tpu_torch.topology import hierarchy

# bytes per packet of the input buffer (now int64, src, dst, seq int32)
# and of the output buffer (deliver_time int64, delivered uint8)
IN_BYTES = 8 + 3 * 4
OUT_BYTES = 8 + 1


def _free_graph(kernels: Kernels, graph, events) -> None:
    """Free a judge's flush graph (`events`, which it records, are
    kept alive until then)."""
    kernels.judge_graph_free(graph)


class DeviceJudge:
    """The path tables on the card (dense, or the factored leaves; with
    the [T] epoch axis under a fault schedule) and K10 over them."""

    def __init__(self, topology, host_vertex: np.ndarray, seed: int,
                 bootstrap_end: int = 0, min_batch: int = 192,
                 fault_table=None, device="cuda",
                 kernels: Optional[Kernels] = None):
        if topology.hier is not None:
            if hierarchy.max_composed_latency(topology.hier.lat_parts()) \
                    > np.iinfo(np.int64).max // 2:
                raise ValueError("latency overflow")
        elif (topology.latency_ns > np.iinfo(np.int64).max // 2).any():
            raise ValueError("latency overflow")
        self.device = resolve_device(device)
        self.kernels = kernels if kernels is not None else Kernels()
        lat, rel, ep_times = hierarchy.world_tables(topology, fault_table)
        hv = np.asarray(host_vertex)
        arrays = world_arrays(len(hv), None, hv, lat, rel, ep_times,
                              seed_key=prng.seed_key(seed))
        self.world = upload_world(arrays, self.device)
        self.tables = judge_tables(self.world)
        self.boot_end = int(bootstrap_end)
        self.min_batch = min_batch
        # batches and packets judged by K10, and rounds and packets
        # rolled on the CPU below min_batch (the manager counts those)
        self.batches = 0
        self.packets = 0
        self.cpu_batches = 0
        self.cpu_packets = 0
        # host wall in the manager's flushes and in judge_batch; device
        # ms of K10 and of the two copies, on the card
        self.flush_s = 0.0
        self.judge_s = 0.0
        self.kernel_ms = 0.0
        self.copy_ms = 0.0
        self._cap = 0
        self._bufs = None
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                # created by a first record; the flush graph records them
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(4)]
                for ev in events:
                    ev.record()
                handles = (ctypes.c_void_p * 4)(
                    *(ev.cuda_event for ev in events))
                self._graph = self.kernels.judge_graph(
                    self.tables, self._buffers(1)[3], handles)
            # the graph records the events: they live as long as it
            weakref.finalize(self, _free_graph, self.kernels, self._graph,
                             events)
            self._ms = (ctypes.c_float * 2)()

    def _buffers(self, n: int):
        """(pinned input, device input, device output, pinned output)
        byte buffers for at least n packets, grown by doubling, with
        numpy views of the pinned two and the four addresses."""
        if self._bufs is None or n > self._cap:
            cap = max(n, 2 * self._cap, 1024)
            dev = self.device
            bufs = (torch.empty(cap * IN_BYTES, dtype=torch.uint8,
                                pin_memory=True),
                    torch.empty(cap * IN_BYTES, dtype=torch.uint8,
                                device=dev),
                    torch.empty(cap * OUT_BYTES, dtype=torch.uint8,
                                device=dev),
                    torch.empty(cap * OUT_BYTES, dtype=torch.uint8,
                                pin_memory=True))
            self._bufs = (bufs, bufs[0].numpy(), bufs[3].numpy(),
                          tuple(b.data_ptr() for b in bufs))
            self._cap = cap
        return self._bufs

    @staticmethod
    def _columns(buf: torch.Tensor, n: int):
        """The input columns now, src, dst, seq of n packets in `buf`."""
        return (buf[:8 * n].view(torch.int64),
                buf[8 * n:12 * n].view(torch.int32),
                buf[12 * n:16 * n].view(torch.int32),
                buf[16 * n:20 * n].view(torch.int32))

    def judge_batch(self, now: np.ndarray, src: np.ndarray,
                    dst: np.ndarray, pkt_seq: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """[N] arrays -> (delivered bool [N], deliver_time int64 [N])."""
        t0 = time.perf_counter()
        n = len(now)
        if self.device.type == "cpu":
            cols = (np.asarray(now, np.int64), np.asarray(src, np.int32),
                    np.asarray(dst, np.int32),
                    np.asarray(pkt_seq, np.int32))
            delivered, deliver_time = self.kernels.judge_batch(
                self.tables, self.boot_end,
                *(torch.from_numpy(c) for c in cols))
            delivered, deliver_time = delivered.numpy(), deliver_time.numpy()
        elif self.kernels.designs_before:
            delivered, deliver_time = self._flush_before(now, src, dst,
                                                         pkt_seq)
        else:
            bufs, host_in, host_out, ptrs = self._buffers(n)
            host_in[:8 * n].view(np.int64)[:] = now
            host_in[8 * n:12 * n].view(np.int32)[:] = src
            host_in[12 * n:16 * n].view(np.int32)[:] = dst
            host_in[16 * n:20 * n].view(np.int32)[:] = pkt_seq
            with torch.cuda.device(self.device):
                self.kernels.judge_flush(self.tables, self._graph, n,
                                         self.boot_end, ptrs, self._ms)
            self.kernel_ms += self._ms[0]
            self.copy_ms += self._ms[1]
            deliver_time = host_out[:8 * n].view(np.int64).copy()
            delivered = host_out[8 * n:9 * n].astype(bool)
        self.batches += 1
        self.packets += n
        self.judge_s += time.perf_counter() - t0
        return delivered, deliver_time

    def _flush_before(self, now, src, dst, pkt_seq):
        """A flush as the design before made it: the columns through
        torch views of the pinned buffer, the wrapper's set-up and
        checks, event pairs around the copies and the whole wrapper."""
        n = len(now)
        bufs, _, _, _ = self._buffers(n)
        host_in, dev_in, dev_out, host_out = bufs
        cols = (np.asarray(now, np.int64), np.asarray(src, np.int32),
                np.asarray(dst, np.int32), np.asarray(pkt_seq, np.int32))
        for col, c in zip(self._columns(host_in, n), cols):
            col.numpy()[:] = c
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        dev_in[:IN_BYTES * n].copy_(host_in[:IN_BYTES * n],
                                    non_blocking=True)
        ev[1].record()
        out = (dev_out[:8 * n].view(torch.int64), dev_out[8 * n:9 * n])
        self.kernels.judge_batch(self.tables, self.boot_end,
                                 *self._columns(dev_in, n), out=out)
        ev[2].record()
        host_out[:OUT_BYTES * n].copy_(dev_out[:OUT_BYTES * n],
                                       non_blocking=True)
        ev[3].record()
        ev[3].synchronize()
        self.kernel_ms += ev[1].elapsed_time(ev[2])
        self.copy_ms += ev[0].elapsed_time(ev[1]) + \
            ev[2].elapsed_time(ev[3])
        deliver_time = host_out[:8 * n].view(torch.int64).numpy().copy()
        delivered = host_out[8 * n:9 * n].numpy().astype(bool)
        return delivered, deliver_time

    def counters(self) -> dict:
        """The judge's counters and times, as SimStats.judge holds
        them."""
        return {"batches": self.batches, "packets": self.packets,
                "cpu_batches": self.cpu_batches,
                "cpu_packets": self.cpu_packets,
                "min_batch": self.min_batch, "flush_s": self.flush_s,
                "judge_s": self.judge_s, "kernel_ms": self.kernel_ms,
                "copy_ms": self.copy_ms}
