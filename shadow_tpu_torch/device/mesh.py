"""The host mesh: S ranks of one simulation, one process each, joined
by one torch.distributed process group (the port of the reference
engine's `Mesh` over its device axis, engine.py:250-257, and of the
collectives of its exchange and window loop, engine.py:1635-2206).

Rank s owns the hosts [s*H_loc, (s+1)*H_loc), H_loc = ceil(H/S); the
padded hosts past H hold no events. Each rank runs its own engine
(device/engine.py) on its own device and meets the others at the
flush (the exchange of packed rows) and at every phase's minimum head
time.

The backend follows from the devices and is never a fallback: S
distinct CUDA devices take NCCL; a device named more than once, or the
CPU, takes gloo (NCCL refuses two ranks on one card). Under gloo the
collectives of CUDA tensors go through pinned host buffers, staged by
hand: each buffer is copied to the host once the stream is ready, the
collective runs on the host copies, and the result is copied back on
the stream. A mix of CPU and CUDA devices is refused.

`spawn` starts the ranks with the `spawn` start method (a forked
process cannot use CUDA once its parent has), runs one module-level
function on every rank with its `Mesh`, and returns rank 0's result.
Every rank's exit code is checked; a rank that raises or dies fails the
whole call, and the process group's timeout turns a hang into a
failure.

A mesh can shrink (`Mesh.shrink`, the `failover: shrink` of
device/supervise.py): its surviving ranks go on in a process group of
their own, renumbered 0..M-1 in their old order, each keeping its
position in the spawned mesh (`Mesh.pos`, `members`); the ranks left out
leave the run. Every rank of the mesh calls `shrink`, so that the
world's process groups are created in one order everywhere; a rank that
left an earlier shrink of the same run catches up with `sync_groups`
once the run is over.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait before the process group fails it
DEFAULT_TIMEOUT = 600

# the process groups this process has created (`_new_group`): a group's
# name is the count of groups before it, so every rank of the world must
# have created as many before the next one it is a member of
_GROUPS_MADE = 0


def _new_group(ranks: list):
    """`dist.new_group` over the world ranks `ranks`, counted; a rank
    outside them gets GroupMember.NON_GROUP_MEMBER, and no peer waits on
    its call (no barrier after a group's creation)."""
    global _GROUPS_MADE
    _GROUPS_MADE += 1
    return dist.new_group(ranks=list(ranks))


def sync_groups(world: "Mesh") -> None:
    """Every rank of the spawned world (all must call) brought to the
    same count of created groups, so that the next group that any of
    them shares is named alike on every member: a rank that left a run
    at a shrink did not create the groups of the shrinks after it."""
    most = int(world.all_max(torch.tensor([_GROUPS_MADE])).item())
    other = [r for r in range(world.size) if r != world.rank][:1]
    while _GROUPS_MADE < most:
        _new_group(other)


def mesh_backend(devices: Sequence) -> str:
    """"nccl" for S distinct CUDA devices, "gloo" for the CPU or a CUDA
    device named more than once; raises for a mix of the two or for a
    device type the port does not run on."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    types = {d.type for d in devs}
    if types - {"cpu", "cuda"}:
        raise ValueError(f"unsupported mesh devices {list(devices)}")
    if len(types) > 1:
        raise ValueError("a mesh runs on CPU ranks or on CUDA ranks, not "
                         f"a mix: {[str(d) for d in devs]}")
    if types == {"cpu"}:
        return "gloo"
    idx = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


class Mesh:
    """One rank's view of the mesh: its rank, the world size, its
    device and the backend, with the collectives the engine needs.
    `moved_bytes` counts the bytes this rank sent to other ranks;
    `stage_s` and `collective_s` the host-clock seconds of the staging
    copies (to the host, stream synchronised) and of the collectives;
    `calls` the collectives by kind (all_to_all, all_gather,
    all_reduce). `group` is the process group of a shrunken mesh (None:
    the world), `members` the world ranks of its ranks in rank order."""

    def __init__(self, rank: int, size: int, device, backend: str,
                 group=None, members: Optional[Sequence[int]] = None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.members = (list(range(self.size)) if members is None
                        else [int(m) for m in members])
        self.moved_bytes = 0
        self.stage_s = 0.0
        self.collective_s = 0.0
        self.calls = dict.fromkeys(("all_to_all", "all_gather",
                                    "all_reduce"), 0)
        self._pinned = {}

    @property
    def pos(self) -> int:
        """This rank's position in the spawned mesh (its world rank),
        which a shrink's renumbering keeps."""
        return self.members[self.rank]

    def shrink(self, alive: Sequence[int]) -> Optional["Mesh"]:
        """The mesh of the positions `alive` (ascending, a subset of
        `members`), in a process group of their own: every rank of this
        mesh calls, and the ranks outside `alive` get None. The
        collectives' counters carry over."""
        alive = [int(p) for p in alive]
        if alive != sorted(alive) or not set(alive) <= set(self.members):
            raise ValueError(f"shrink: {alive} is not an ascending subset "
                             f"of the mesh's positions {self.members}")
        group = _new_group(alive)
        if self.pos not in alive:
            return None
        m = Mesh(alive.index(self.pos), len(alive), self.device,
                 self.backend, group, alive)
        m.moved_bytes, m.stage_s = self.moved_bytes, self.stage_s
        m.collective_s, m.calls = self.collective_s, dict(self.calls)
        return m

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through pinned host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, tuple(like.shape), like.dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(like.shape, dtype=like.dtype,
                                            pin_memory=True)
        return self._pinned[key]

    def _to_host(self, name: str, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        h = self._host(name, t)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        self.stage_s += time.perf_counter() - t0
        return h

    def _from_host(self, out: torch.Tensor, h: torch.Tensor) -> None:
        t0 = time.perf_counter()
        # ordered on the stream; the pinned buffer is rewritten only
        # after the next staging copy has synchronised the stream
        out.copy_(h, non_blocking=True)
        self.stage_s += time.perf_counter() - t0

    def all_to_all(self, send: torch.Tensor, recv: torch.Tensor,
                   to: Optional[Sequence[int]] = None,
                   frm: Optional[Sequence[int]] = None) -> None:
        """Blocks along dim 0: with `to`/`frm` None, send[d] goes to
        rank d and recv[s] comes from rank s (the reference's
        all_to_all); else send[i] goes to rank to[i] and recv[i] comes
        from rank frm[i], each list in ascending rank order (the
        reference's ppermutes, as one call whose other splits are
        empty)."""
        S = self.size
        blk = int(send[0].numel()) if send.shape[0] else 0
        rblk = int(recv[0].numel()) if recv.shape[0] else 0
        to = list(range(S)) if to is None else list(to)
        frm = list(range(S)) if frm is None else list(frm)
        if len(to) != send.shape[0] or len(frm) != recv.shape[0] or \
                to != sorted(to) or frm != sorted(frm):
            raise ValueError("all_to_all: one block per peer, in rank "
                             "order")
        ins = [blk if r in to else 0 for r in range(S)]
        outs = [rblk if r in frm else 0 for r in range(S)]
        self.moved_bytes += blk * send.element_size() * \
            sum(1 for r in to if r != self.rank)
        src, dst = send, recv
        if self.staged:
            src = self._to_host("a2a_send", send)
            dst = self._host("a2a_recv", recv)
        t0 = time.perf_counter()
        dist.all_to_all_single(dst.view(-1), src.view(-1), outs, ins,
                               group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.calls["all_to_all"] += 1
        if self.staged:
            self._from_host(recv, dst)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """out [S, *inp.shape]: every rank's `inp`, in rank order."""
        self.moved_bytes += inp.numel() * inp.element_size() * \
            (self.size - 1)
        src, dst = inp, out
        if self.staged:
            src = self._to_host("ag_send", inp)
            dst = self._host("ag_recv", out)
        t0 = time.perf_counter()
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(dst.view(-1), src.reshape(-1), group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.calls["all_gather"] += 1
        if self.staged:
            self._from_host(out, dst)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """`t` reduced over the ranks, in place where it can be."""
        if self.backend == "nccl":
            x = t.to(self.device)
        else:
            x = t.cpu() if t.is_cuda else t
        t0 = time.perf_counter()
        dist.all_reduce(x, op=op, group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.calls["all_reduce"] += 1
        return x

    def all_min(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over the ranks (the reference's
        `_axis_min`, a gather then a min: the same value)."""
        return self._reduce(x.clone(), dist.ReduceOp.MIN)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks (`lax.psum`)."""
        return self._reduce(x.clone(), dist.ReduceOp.SUM)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks."""
        return self._reduce(x.clone(), dist.ReduceOp.MAX)

    def gather(self, obj) -> Optional[list]:
        """Rank 0: every rank's picklable `obj`, in rank order; None on
        the other ranks."""
        got = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, got, dst=self.members[0], group=self.group)
        return got

    def gather_leaves(self, leaves: dict, axis: int = 0) -> Optional[dict]:
        """Rank 0: each numpy leaf of every rank, concatenated along
        `axis` in rank order (1 for a campaign's [R, H_loc, ...] leaves,
        which gather into [R, H_pad, ...]); None on the other ranks."""
        got = self.gather(leaves)
        if got is None:
            return None
        return {k: np.concatenate([g[k] for g in got], axis=axis)
                for k in leaves}

    def all_gather_leaves(self, leaves: dict, axis: int = 0) -> dict:
        """Every rank: each numpy leaf of every rank, concatenated along
        `axis` in rank order (`gather_leaves` on every rank)."""
        got = [None] * self.size
        dist.all_gather_object(got, leaves, group=self.group)
        return {k: np.concatenate([g[k] for g in got], axis=axis)
                for k in leaves}

    def reset_counters(self) -> None:
        self.moved_bytes = 0
        self.stage_s = self.collective_s = 0.0
        self.calls = dict.fromkeys(self.calls, 0)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _rank_main(rank: int, devices: list, backend: str, fn: Callable,
               args: tuple, workdir: str, timeout: float) -> None:
    """One rank: join the group, run fn(mesh, *args), rank 0 pickles the
    result; any failure writes its traceback and exits 1. The rank leaves
    its parent's process group, so that a signal to the group (a
    terminal's ^C) reaches the parent alone, which forwards it once
    (`_forward_signals`); it exits when its parent dies."""
    try:
        os.setpgrp()
        _exit_with_parent(os.getppid())
        # a shrink's ranks create their group while the ranks that left
        # go on elsewhere (`Mesh.shrink`): no barrier after a creation
        os.environ["TORCH_DIST_INIT_BARRIER"] = "0"
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # at most the threads the process takes by default
            # (OMP_NUM_THREADS where it is set)
            torch.set_num_threads(max(1, min(4, torch.get_num_threads(),
                                             (os.cpu_count() or 1)
                                             // len(devices))))
        dist.init_process_group(
            backend, init_method=f"file://{workdir}/store", rank=rank,
            world_size=len(devices),
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(Mesh(rank, len(devices), dev, backend), *args)
            if rank == 0:
                with open(os.path.join(workdir, "result.pkl"), "wb") as f:
                    pickle.dump(out, f)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _exit_with_parent(parent: int) -> None:
    """Ends this process once `parent` is no longer its parent (a killed
    parent's ranks, outside its process group, would otherwise wait out
    the process group's timeout)."""
    import threading

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _forward_signals(procs) -> Callable:
    """While the ranks run, SIGTERM and SIGINT to this process are sent
    on to each live rank (whose preemption guard drains it,
    device/supervise.py); returns the function that restores the
    handlers. Outside the main thread nothing is installed."""
    import signal

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                try:
                    os.kill(p.pid, signum)
                except OSError:
                    pass

    orig = {}
    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            orig[s] = signal.signal(s, forward)
    except ValueError:
        pass

    def restore():
        for s, h in orig.items():
            signal.signal(s, h)

    return restore


class MeshFailure(RuntimeError):
    """A rank of a spawned mesh failed, died or timed out."""


def spawn(devices: Sequence, fn: Callable, args: tuple = (),
          timeout: float = DEFAULT_TIMEOUT):
    """Run `fn(mesh, *args)` on one rank per entry of `devices` (torch
    devices or names; `mesh_backend` picks the backend), each in a
    process of its own started with the `spawn` method, and return rank
    0's result. `fn` and `args` must pickle (`fn` a module-level
    function). Raises MeshFailure with the failing rank's traceback
    where a rank fails, and where the ranks outlive `timeout` seconds
    plus a start-up allowance (they are then killed)."""
    import multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = mesh_backend(devices)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="shadow_mesh_") as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, devices, backend, fn, args, workdir,
                                   timeout))
                 for r in range(len(devices))]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + 120
        restore = _forward_signals(procs)
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            restore()
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(workdir, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (" (killed at the timeout)"
                                 if p in hung else ""))
        if errors:
            # a rank's own error first, the peers it took down after it
            errors.sort(key=lambda e: "closed by peer" in e)
            raise MeshFailure(f"{len(errors)} of {len(procs)} mesh rank(s) "
                              f"failed ({backend}):\n" + "\n".join(errors))
        with open(os.path.join(workdir, "result.pkl"), "rb") as f:
            return pickle.load(f)
