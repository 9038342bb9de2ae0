"""The hot-path kernels of the device engine: CUDA kernels written by
hand for Hopper (csrc/), their build and ctypes binding, and beside each
one its plain PyTorch version.

Four steps carry one phase of a conservative window:

* the pop loop (the reference engine's `_step` with the app's
  `handle`), one thread per host, up to B iterations per launch, in
  one templated source (csrc/pop_phase.cu) with the app fused in:
  K1 `pop_phase` for PHOLD (with its app draws), K4 `pop_tgen` for
  tgen (with the servers' burst pops, trains and timers) and K6
  `pop_tor` for Tor (the relays' burst pops and onion routes, trains
  that carry the previous hop's survivors as their live mask);
* K2 `judge_outbox` (csrc/judge_outbox.cu): `_judge_outbox` with the
  table lookup and `packet_drop_mask`, one thread per host row;
* K5 `route` (csrc/route.cu): `_flat_sorted`/`_host_windows`, the
  exchangeable rows grouped by destination in (src, column) order, by
  a count, a scan, a scatter and a per-segment sort of flat indices;
* K3 `merge_heaps` (csrc/merge_heaps.cu): `_merge_rows` on the window
  path, one block per destination host, a bitonic sort in shared memory.

The pops and the judge read the path tables through one of two views
(csrc/topo.cuh), as the world holds them: dense [V,V] tables, or the
factored leaves of `representation: hierarchical`, looked up in two
levels (the reference's `gather_parts`); the kernels are templates over
the view, and a launch on factored tables counts under the kernel's
name with `_hier` appended (`judge_outbox_hier`, ...). The plain
versions look up through `table_lookup`.

Every wrapper takes the plain version for tensors on the CPU and, for
CUDA tensors, launches its kernel on the current stream or raises:
there is no fallback. A wrapper adds one to `Kernels.launches[name]`
where it launches its kernel, and nowhere else. The pop, judge and
merge update their state tensors in place, like the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Union

import torch

from shadow_tpu_torch.core.event import KIND_PACKET, KIND_TIMER
from shadow_tpu_torch.core.tgen_args import MSS
from shadow_tpu_torch.device import prng
from shadow_tpu_torch.device.apps import (
    PholdDevice,
    TgenDevice,
    TorDevice,
    popcount32,
)
from shadow_tpu_torch.device.netsem import packet_drop_mask
from shadow_tpu_torch.topology.hierarchy import gather_parts_plain
from shadow_tpu_torch.utils.checksum import (
    CHK_KIND,
    CHK_MUL,
    CHK_SEQ,
    CHK_SRC,
    MASK63,
)
from shadow_tpu_torch.utils.rng import PURPOSE_APP, PURPOSE_PACKET_DROP

INF = 1 << 62
DROP_T = INF - 1
IMAX = (1 << 63) - 1
U32 = 0xFFFFFFFF

# the kernels that read the path tables, each launched on dense or on
# factored tables; a factored launch counts as f"{name}{HIER}"
TOPO_KERNELS = ("pop_phase", "pop_tgen", "pop_tor", "judge_outbox")
HIER = "_hier"
KERNEL_NAMES = ("pop_phase", "pop_tgen", "pop_tor", "judge_outbox",
                "route", "merge_heaps",
                *(n + HIER for n in TOPO_KERNELS))
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
OB_FIELDS = ("t", "k", "m", "s", "v")
HEAP_FIELDS = ("ht", "hk", "hm", "hv", "hw")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


@dataclass(frozen=True)
class PhaseParams:
    """The static shape of one phase (EngineConfig plus the app).

    An iteration of the pop loop owns M_out = K + T outbox columns:
    K send lanes, then T timer lanes. A burst host pops up to P
    events in one iteration and answers event j on lane j (K = P)."""
    E: int                  # heap slots per host
    K: int                  # send lanes per iteration
    T: int                  # timer lanes per iteration
    P: int                  # events per iteration at most (burst)
    B: int                  # iterations per phase at most
    IN: int                 # arrivals per host per flush at most
    C: int                  # packets per send row at most (trains)
    boot_end: int           # no drops before this time
    seed: tuple             # (k1, k2) u32 seed key
    app: Union[PholdDevice, TgenDevice, TorDevice]

    @property
    def M_out(self) -> int:
        return self.K + self.T

    @property
    def OB(self) -> int:
        return self.B * self.M_out


# ----------------------------------------------------------------------
# integer helpers shared by the plain versions
# ----------------------------------------------------------------------
def pack2(hi, lo):
    return ((hi.to(torch.int64) & U32) << 32) | (lo.to(torch.int64) & U32)


def hi32(x):
    return (x >> 32).to(torch.int32)


def lo32(x):
    return (x & U32).to(torch.int32)


def table_lookup(tab, sv: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """One path table at (sv, dv), broadcast: a dense [V,V] gather, or
    the two-level lookup of a factored (cluster, cl, access, self)
    tuple (the reference engine's `_tbl`, single epoch)."""
    if isinstance(tab, tuple):
        return gather_parts_plain(tab, sv, dv)
    return tab[sv, dv]


# ----------------------------------------------------------------------
# K1 / K4: one phase of pops (reference: engine._step, judge at flush)
# ----------------------------------------------------------------------
def pop_plain(state: dict, ob: dict, pops: torch.Tensor, world: dict,
              win_end: int, p: PhaseParams) -> None:
    """Pop events below `win_end`, in lockstep over hosts, exactly as
    the reference's pop loop: a host stops at the window end, at
    `dirty` (an in-window self-send or timer it must not pass) or
    after B iterations, and stays stopped for the rest of the phase.
    Each iteration pops one event per runnable host; with P > 1 a
    burst host (`app.burst_mask`) whose head is an in-window packet
    pops the run of consecutive in-window packets from its head, up
    to P. Iteration j of a host writes outbox columns
    [j*M_out, (j+1)*M_out): sends on lanes 0..K-1 (each departing at
    its own event's time), then timers; unused columns hold t = INF
    and zeros. A send row's v hi word is its live-lane mask (the app's
    `send_mask`, all ones when it gives none). `pops[h]` receives the
    host's iteration count."""
    E, K, T, P, B, C, app = p.E, p.K, p.T, p.P, p.B, p.C, p.app
    M = p.M_out
    dev = state["head"].device
    H = state["head"].shape[0]
    gid = torch.arange(H, dtype=torch.int32, device=dev)
    hv = world["host_vertex"].long()
    selflat = table_lookup(world["lat"], hv, hv).to(torch.int64)
    for f in OB_FIELDS:
        ob[f].fill_(INF if f == "t" else 0)
    head = state["head"].clone()
    chk = state["chk"].clone()
    n_exec = state["n_exec"].clone()
    n_deliv = state["n_deliv"].clone()
    event_seq = state["event_seq"].clone()
    packet_seq = state["packet_seq"].clone()
    app_seq = state["app_seq"].clone()
    app_state = state["app"].clone()
    dirty = torch.zeros(H, dtype=torch.bool, device=dev)
    npop = torch.zeros(H, dtype=torch.int32, device=dev)
    offs = torch.arange(P, dtype=torch.int32, device=dev)
    draw_off = torch.arange(app.max_draws, dtype=torch.int64, device=dev)
    app_key = prng.purpose_id_key(p.seed, PURPOSE_APP, gid)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def take(arr, fill):
        idx = head[:, None] + offs
        v = arr.gather(1, idx.clamp(max=E - 1).long())
        return torch.where(idx < E, v, fill)

    for blk in range(B):
        ptP = take(state["ht"], INF)
        pt = ptP[:, 0]
        runnable = (pt < win_end) & ~dirty
        if not bool(runnable.any()):
            break
        pk2P, pmP = take(state["hk"], IMAX), take(state["hm"], 0)
        pvP, pwP = take(state["hv"], 0), take(state["hw"], 0)
        srcP, seqP = hi32(pk2P), lo32(pk2P)
        kindP, sizeP = hi32(pmP), lo32(pmP)
        d0P, d1P, d2P = hi32(pvP), lo32(pvP), lo32(pwP)
        if P > 1:
            elig = ((ptP < win_end) & (kindP == KIND_PACKET)).to(torch.int32)
            run = elig.cumprod(1).sum(-1, dtype=torch.int32)
            burst = app.burst_mask(app_state) & (elig[:, 0] == 1)
            popcnt = torch.where(runnable, torch.where(burst, run, 1), 0)
        else:
            popcnt = runnable.to(torch.int32)
        active = offs[None, :] < popcnt[:, None]              # [H,P]
        head = head + popcnt
        n_exec = n_exec + popcnt
        npop = npop + runnable.to(torch.int32)
        n_deliv = n_deliv + torch.where(
            active & (kindP == KIND_PACKET),
            popcount32(pwP).to(torch.int32), 0).sum(-1, dtype=torch.int32)
        # fold each popped event in order (the 63-bit truncation
        # between steps makes a closed form wrong)
        for j in range(P):
            mix = (ptP[:, j] ^ (srcP[:, j].long() * CHK_SRC)
                   ^ (kindP[:, j].long() * CHK_KIND)
                   ^ (seqP[:, j].long() * CHK_SEQ)) & MASK63
            chk = torch.where(active[:, j], (chk * CHK_MUL + mix) & MASK63,
                              chk)

        seqs = (app_seq.long()[:, None] + draw_off) & U32
        draws = prng.random_bits32(prng.fold_seq(
            (app_key[0][:, None], app_key[1][:, None]), seqs))
        kind_app = torch.where(active, kindP, -1)
        if P > 1:
            out = app.handle_burst(gid, ptP, kind_app, srcP, sizeP, d0P,
                                   d1P, d2P, app_state, draws, world)
            lane_t = ptP
        else:
            out = app.handle(gid, pt, kind_app[:, 0], srcP[:, 0],
                             sizeP[:, 0], d0P[:, 0], d1P[:, 0], d2P[:, 0],
                             app_state, draws, world)
            lane_t = pt[:, None].expand(H, K)
        app_state = torch.where(runnable[:, None], out.app_state,
                                app_state)
        app_seq = app_seq + torch.where(runnable, out.n_draws, 0)

        valid = out.send_valid & runnable[:, None]             # [H,K]
        v32 = valid.to(torch.int32)
        counts = (torch.ones_like(v32) if out.send_count is None
                  else out.send_count.clamp(1, C))
        smask = (torch.full_like(v32, -1) if out.send_mask is None
                 else out.send_mask)
        packet_seq = packet_seq + (counts * v32).sum(-1, dtype=torch.int32)
        vrank = v32.cumsum(-1, dtype=torch.int32) - v32
        nvalid = v32.sum(-1, dtype=torch.int32)
        ev_seq = event_seq[:, None] + vrank
        tvalid = out.timer_valid & runnable[:, None]           # [H,T]
        t32 = tvalid.to(torch.int32)
        tseq = event_seq[:, None] + nvalid[:, None] + \
            t32.cumsum(-1, dtype=torch.int32) - t32
        event_seq = event_seq + nvalid + t32.sum(-1, dtype=torch.int32)
        timer_t = pt[:, None] + out.timer_delay

        dst = out.send_dst
        g2 = gid[:, None].expand(H, K)
        gT = gid[:, None].expand(H, T)
        c0 = blk * M
        sends = {
            "t": torch.where(valid, lane_t, INF),
            "k": torch.where(valid, pack2(g2, ev_seq), zero),
            "m": torch.where(valid, pack2(dst, KIND_PACKET | (counts << 8)),
                             zero),
            "s": torch.where(valid, pack2(out.send_size, out.send_d0),
                             zero),
            "v": torch.where(valid, pack2(smask, out.send_d1), zero)}
        timers = {
            "t": torch.where(tvalid, timer_t, INF),
            "k": torch.where(tvalid, pack2(gT, tseq), zero),
            "m": torch.where(tvalid, pack2(gT, torch.full_like(
                gT, KIND_TIMER)), zero),
            "s": torch.where(tvalid, pack2(torch.zeros_like(gT),
                                           out.timer_d0), zero),
            "v": torch.zeros((H, T), dtype=torch.int64, device=dev)}
        for f in OB_FIELDS:
            ob[f][:, c0:c0 + K] = sends[f]
            ob[f][:, c0 + K:c0 + M] = timers[f]
        # an in-window self-send or timer must land before the host
        # pops again (judged on the self-latency: self rows never take
        # the causality bump)
        self_in = valid & (dst == gid[:, None]) & \
            (lane_t + selflat[:, None] < win_end)
        tim_in = tvalid & (timer_t < win_end)
        dirty = dirty | (runnable & (self_in.any(-1) | tim_in.any(-1)))

    for name, val in (("head", head), ("chk", chk), ("n_exec", n_exec),
                      ("n_deliv", n_deliv), ("event_seq", event_seq),
                      ("packet_seq", packet_seq), ("app_seq", app_seq),
                      ("app", app_state)):
        state[name].copy_(val)
    pops.copy_(npop)


# ----------------------------------------------------------------------
# K2: per-phase network judgment (reference: engine._judge_outbox)
# ----------------------------------------------------------------------
def judge_outbox_plain(state: dict, ob: dict, world: dict, win_end: int,
                       p: PhaseParams) -> None:
    """Judge every send row of the outbox: path latency and
    reliability, one drop roll per packet keyed by (src, packet seq),
    the causality bump to `win_end` for cross-host rows, and the
    sent/dropped counters. A row whose packets all drop gets t = INF.
    Rewrites ob t/m/v in place."""
    ft, fm, fv = ob["t"], ob["m"], ob["v"]
    H, OB = ft.shape
    dev = ft.device
    gid = torch.arange(H, dtype=torch.int32, device=dev)
    hv = world["host_vertex"].long()
    kindrow = lo32(fm)
    is_send = (ft < INF) & ((kindrow & 0xFF) == KIND_PACKET)
    cnt = torch.where(is_send, kindrow >> 8, 0)
    dst = hi32(fm)
    srcv = hv[:, None]
    dstv = hv[dst.long().clamp(0, H - 1)]
    latv = table_lookup(world["lat"], srcv, dstv).to(torch.int64)
    relv = table_lookup(world["rel"], srcv, dstv)
    # each row's first packet seq: packet_seq is the END of the phase,
    # rows sit in consumption order
    c64 = cnt.long()
    base = (state["packet_seq"].long() - c64.sum(-1))[:, None] + \
        (c64.cumsum(-1) - c64)
    wbits = torch.where(cnt >= 32, U32,
                        (1 << cnt.clamp(0, 31).long()) - 1)
    livemask = (fv >> 32) & U32 & wbits
    livecnt = popcount32(livemask)
    # roll the live lanes only: (host, column, lane) of each packet
    js = torch.arange(p.C, dtype=torch.int64, device=dev)
    h, c, j = ((livemask[..., None] >> js) & 1).nonzero(as_tuple=True)
    hk = prng.purpose_id_key(p.seed, PURPOSE_PACKET_DROP, gid)
    drop = packet_drop_mask(
        p.seed, p.boot_end, ft[h, c], None, base[h, c] + j, relv[h, c],
        src_key=(hk[0][h], hk[1][h]))
    surv = torch.zeros_like(livemask).index_put_(
        (h, c), torch.where(drop, 0, 1 << j), accumulate=True)
    lost = livecnt - popcount32(surv)
    state["n_sent"] += livecnt.sum(-1).to(torch.int32)
    state["n_drop"] += lost.sum(-1).to(torch.int32)
    deliver_t = ft + latv
    deliver_t = torch.where(dst != gid[:, None],
                            deliver_t.clamp(min=win_end), deliver_t)
    dead = is_send & (surv == 0)
    new_t = torch.where(is_send, torch.where(dead, INF, deliver_t), ft)
    new_m = torch.where(is_send, pack2(dst, KIND_PACKET | (livecnt << 8)),
                        fm)
    new_v = torch.where(is_send, pack2(surv, lo32(fv)), fv)
    ft.copy_(new_t)
    fm.copy_(new_m)
    fv.copy_(new_v)


# ----------------------------------------------------------------------
# K5: route (reference: _flat_sorted/_host_windows)
# ----------------------------------------------------------------------
def route_plain(ob: dict):
    """Order the judged outbox rows by (dst, src, column): a flat sort
    of dst*SPAN + src*OB + column over exchangeable rows (t < DROP_T),
    then per-destination segment bounds by searchsorted. Returns
    (perm [H*OB], starts [H], counts [H]), int64; perm's first
    counts.sum() entries are the live rows' flat indices in that
    order."""
    ft, fm = ob["t"], ob["m"]
    H, OB = ft.shape
    dev = ft.device
    span = H * OB
    okey = torch.arange(H * OB, dtype=torch.int64, device=dev).view(H, OB)
    skey = torch.where(ft < DROP_T, hi32(fm).long() * span + okey, IMAX)
    skey_s, perm = torch.sort(skey.view(-1))
    edges = torch.searchsorted(
        skey_s, torch.arange(H + 1, dtype=torch.int64, device=dev) * span)
    return perm, edges[:-1].contiguous(), (edges[1:] - edges[:-1])


# ----------------------------------------------------------------------
# K3: merge arrivals into the heaps (reference: the window-path merge)
# ----------------------------------------------------------------------
def merge_heaps_plain(state: dict, ob: dict, perm: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      p: PhaseParams) -> None:
    """Per host: the live heap rows (slots >= head) and the first IN
    arrivals of its segment, sorted by (time, key, column) — column
    breaks ties, so the order is the stable lexicographic one — and
    the first E rows kept. Rows past E with t < INF, and arrivals past
    IN, count into `overflow`; `occ_in`/`occ_heap` take their
    high-water marks; head resets to 0."""
    E, IN = p.E, p.IN
    H = state["head"].shape[0]
    dev = perm.device
    F = perm.shape[0]
    live = torch.arange(E, device=dev)[None, :] >= state["head"][:, None]
    mt = torch.where(live, state["ht"], INF)
    mk = torch.where(live, state["hk"], IMAX)
    # arrival windows: sorted rows starts[h] .. starts[h]+min(count, IN)
    idx = starts[:, None] + torch.arange(IN, device=dev)
    ok = torch.arange(IN, device=dev)[None, :] < counts.clamp(max=IN)[:, None]
    pidx = perm[idx.clamp(0, F - 1)]
    flat = {f: ob[f].reshape(-1)[pidx] for f in OB_FIELDS}
    it = torch.where(ok, flat["t"], INF)
    ik = torch.where(ok, flat["k"], IMAX)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fm, fs, fv = (torch.where(ok, flat[f], zero) for f in ("m", "s", "v"))
    im = pack2(lo32(fm) & 0xFF, hi32(fs))
    iv = pack2(lo32(fs), lo32(fv))
    iw = (fv >> 32) & U32

    ct = torch.cat([mt, it], 1)
    ck = torch.cat([mk, ik], 1)
    # lexicographic (t, k) with column order among ties: stable sort by
    # the secondary key, then stable sort by the primary
    _, o1 = torch.sort(ck, dim=1, stable=True)
    _, o2 = torch.sort(ct.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)
    st = ct.gather(1, order)
    keep = order[:, :E]
    over_in = (counts - IN).clamp(min=0)
    over_e = (st[:, E:] < INF).sum(-1)
    state["overflow"] += (over_in + over_e).to(torch.int32)
    state["occ_in"].copy_(torch.maximum(state["occ_in"],
                                        counts.to(torch.int32)))
    new = {"ht": st[:, :E], "hk": ck.gather(1, keep),
           "hm": torch.cat([state["hm"], im], 1).gather(1, keep),
           "hv": torch.cat([state["hv"], iv], 1).gather(1, keep),
           "hw": torch.cat([state["hw"], iw], 1).gather(1, keep)}
    for f in HEAP_FIELDS:
        state[f].copy_(new[f])
    state["head"].zero_()
    state["occ_heap"].copy_(torch.maximum(
        state["occ_heap"], (state["ht"] < INF).sum(-1).to(torch.int32)))


# ----------------------------------------------------------------------
# build and binding
# ----------------------------------------------------------------------
def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return str(path)


def build_library(ptxas_verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/*.cu into one shared library with a plain C
    interface under BUILD_DIR: one nvcc per source, all started
    together, then one link. The file name carries a hash of the
    sources and flags, so an existing library is reused only when it
    matches. Returns (path, compiler output)."""
    build_dir = BUILD_DIR
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + src.read_bytes())
    lib = build_dir / f"libshadow_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists() and not ptxas_verbose:
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = build_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for o, pr in jobs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
                o.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {obj.stem}:\n{out}")
    tmp = build_dir / f"{lib.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for o, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib, "".join(log)


class TopoArgs(ctypes.Structure):
    """csrc/topo.cuh `TopoArgs`: which view of the path tables a kernel
    reads, and its tables (the other view's pointers null)."""
    _fields_ = [("hier", ctypes.c_int), ("V", ctypes.c_int),
                ("C", ctypes.c_int)] + [
        (name, ctypes.c_void_p) for name in (
            "lat", "rel", "core_lat", "core_rel", "cl", "acc_lat",
            "acc_rel", "self_lat", "self_rel")]


def topo_args(world: dict):
    """(launch-name suffix, TopoArgs, [(tensor, dtype)] to check) for
    the world's path tables; raises on tables of the wrong shape."""
    lat, rel = world["lat"], world["rel"]
    i32, f32 = torch.int32, torch.float32
    if isinstance(lat, tuple):
        cc, cl, acc, slf = lat
        ccr, cl_r, accr, slfr = rel
        V, C = cl.shape[0], cc.shape[0]
        if (cl_r is not cl or cc.shape != (C, C) or ccr.shape != (C, C)
                or any(t.shape != (V,) for t in (acc, slf, accr, slfr))):
            raise ValueError("factored tables: need [C,C] cluster pairs, "
                             "[V] cl/access/self vectors and one shared cl")
        args = TopoArgs(1, V, C, None, None,
                        *map(_ptr, (cc, ccr, cl, acc, accr, slf, slfr)))
        return HIER, args, [(t, i32) for t in (cc, cl, acc, slf)] + \
            [(t, f32) for t in (ccr, accr, slfr)]
    V = lat.shape[0]
    if lat.shape != (V, V) or rel.shape != (V, V):
        raise ValueError("dense tables: need [V,V] latency and "
                         "reliability")
    args = TopoArgs(0, V, 0, _ptr(lat), _ptr(rel))
    return "", args, [(lat, i32), (rel, f32)]


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_T = ctypes.POINTER(TopoArgs)

_SIGNATURES = {
    # H, E, K, B, win_end, ht hk hm hv hw, head event_seq packet_seq
    # app_seq app n_exec n_deliv chk, host_vertex topo, seed k1 k2,
    # n_total msgload size selfloop, ob t k m s v, pops, stream
    "shadow_pop_phase": [_I, _I, _I, _I, _L] + [_P] * 5 + [_P] * 8 +
                        [_P, _T, _U, _U, _I, _I, _I, _I] + [_P] * 5 +
                        [_P, _P],
    # H, E, K, T, P, B, C, win_end, ht hk hm hv hw, head event_seq
    # packet_seq app n_exec n_deliv chk, host_vertex topo, count pause
    # retry, npkts last_sz chunk mss, ob t k m s v, pops, stream
    "shadow_pop_tgen": [_I] * 7 + [_L] + [_P] * 5 + [_P] * 7 +
                       [_P, _T] + [_P] * 3 + [_I] * 4 + [_P] * 5 +
                       [_P, _P],
    # H, E, K, T, P, B, C, win_end, ht hk hm hv hw, head event_seq
    # packet_seq app n_exec n_deliv chk, host_vertex topo, count pause
    # retry, relay_gids R, route key k1 k2, cells, ob t k m s v, pops,
    # stream
    "shadow_pop_tor": [_I] * 7 + [_L] + [_P] * 5 + [_P] * 7 +
                      [_P, _T] + [_P] * 3 + [_P, _I, _U, _U, _I] +
                      [_P] * 5 + [_P, _P],
    # H, OB, C, win_end, boot_end, ob t m v, packet_seq n_sent n_drop,
    # host_vertex topo, seed k1 k2, stream
    "shadow_judge_outbox": [_I, _I, _I, _L, _L] + [_P] * 3 + [_P] * 3 +
                           [_P, _T, _U, _U, _P],
    # H, OB, ob t m, perm starts counts, scratch cursor block_sums,
    # stream
    "shadow_route": [_I, _I] + [_P] * 2 + [_P] * 3 + [_P] * 3 + [_P],
    # H, E, IN, F, ht hk hm hv hw head, ob t k m s v, perm starts
    # counts, overflow occ_in occ_heap, stream
    "shadow_merge_heaps": [_I, _I, _I, _L] + [_P] * 6 + [_P] * 5 +
                          [_P] * 3 + [_P] * 3 + [_P],
}


class Kernels:
    """The kernels of one engine: the loaded library (built on first
    CUDA use), the wrappers and their launch counters.

    `timing=True` records a CUDA event pair around every launch, so
    `kernel_ms()` can sum the device time each kernel took on the main
    path; it adds no synchronisation."""

    def __init__(self, timing: bool = False):
        self.timing = timing
        self.reset_counts()
        self._lib = None
        self._route_scratch = {}

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)
        self._events = {n: [] for n in KERNEL_NAMES}

    def kernel_ms(self) -> dict:
        """Summed device ms per kernel over the recorded launches
        (timing mode); synchronises."""
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in ev)
                for n, ev in self._events.items()}

    def library(self):
        if self._lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _launch(self, name: str, c_name: str, tensors, *args) -> None:
        """Check every (tensor, dtype) the kernel reads or writes, launch
        it on the current stream, and count the launch (with an event
        pair around it in timing mode)."""
        dev = tensors[0][0].device
        for t, dtype in tensors:
            if t.device != dev or not t.is_cuda:
                raise ValueError(f"{name}: all tensors must be on one "
                                 "CUDA device")
            if t.dtype != dtype:
                raise ValueError(f"{name}: expected {dtype}, got "
                                 f"{t.dtype} (shape {tuple(t.shape)})")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous")
        fn = getattr(self.library(), c_name)
        stream = torch.cuda.current_stream().cuda_stream
        ev = None
        if self.timing:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error "
                               f"{err}")
        if ev is not None:
            ev[1].record()
            self._events[name].append(ev)
        self.launches[name] += 1

    def pop(self, state: dict, ob: dict, pops: torch.Tensor, world: dict,
            win_end: int, p: PhaseParams) -> None:
        """The phase's pops: K1 for PHOLD, K4 for tgen, K6 for Tor (the
        plain pop for each on the CPU), on the world's tables."""
        if not state["head"].is_cuda:
            return pop_plain(state, ob, pops, world, win_end, p)
        if isinstance(p.app, TgenDevice):
            return self._pop_tgen(state, ob, pops, world, win_end, p)
        if isinstance(p.app, TorDevice):
            return self._pop_tor(state, ob, pops, world, win_end, p)
        return self._pop_phase(state, ob, pops, world, win_end, p)

    def _pop_phase(self, state: dict, ob: dict, pops: torch.Tensor,
                   world: dict, win_end: int, p: PhaseParams) -> None:
        a = p.app
        if not isinstance(a, PholdDevice) or p.T or p.P != 1:
            raise ValueError("pop_phase runs PHOLD (no timers, no "
                             "bursts)")
        H = state["head"].shape[0]
        heap = [state[f] for f in HEAP_FIELDS]
        small = [state[f] for f in ("head", "event_seq", "packet_seq",
                                    "app_seq", "app", "n_exec",
                                    "n_deliv", "chk")]
        hv = world["host_vertex"]
        suffix, topo, topo_checks = topo_args(world)
        obs = [ob[f] for f in OB_FIELDS]
        i32, i64 = torch.int32, torch.int64
        self._launch(
            "pop_phase" + suffix, "shadow_pop_phase",
            [(t, i64) for t in heap + obs] + [(t, i32) for t in small[:7]]
            + [(small[7], i64), (pops, i32), (hv, i32)] + topo_checks,
            H, p.E, p.K, p.B, int(win_end), *map(_ptr, heap),
            *map(_ptr, small), _ptr(hv), ctypes.byref(topo),
            p.seed[0], p.seed[1], a.n_hosts_total, a.msgload, a.size,
            a.selfloop, *map(_ptr, obs), _ptr(pops))

    def _pop_tgen(self, state: dict, ob: dict, pops: torch.Tensor,
                  world: dict, win_end: int, p: PhaseParams) -> None:
        a = p.app
        if not isinstance(a, TgenDevice):
            raise ValueError("pop_tgen runs tgen")
        self._pop_trains("pop_tgen", state, ob, pops, world, win_end, p,
                         [], (a.npkts, a.last_sz, a.chunk, MSS))

    def _pop_tor(self, state: dict, ob: dict, pops: torch.Tensor,
                 world: dict, win_end: int, p: PhaseParams) -> None:
        a = p.app
        if not isinstance(a, TorDevice):
            raise ValueError("pop_tor runs Tor")
        relays = world["relay_gids"]
        self._pop_trains("pop_tor", state, ob, pops, world, win_end, p,
                         [relays], (relays.shape[0], *a.route_key, a.cells))

    def _pop_trains(self, name: str, state: dict, ob: dict,
                    pops: torch.Tensor, world: dict, win_end: int,
                    p: PhaseParams, app_tensors: list, app_scalars) -> None:
        """K4 or K6: the pops of an app with trains, one timer lane and
        per-host client args; `app_tensors` (int32) and `app_scalars`
        are the app's own arguments, after the client args."""
        if p.T != 1 or p.K != max(1, p.P) or p.C > 32:
            raise ValueError(f"{name}: one timer lane, one send lane per "
                             "burst column, trains of at most 32")
        H = state["head"].shape[0]
        heap = [state[f] for f in HEAP_FIELDS]
        small = [state[f] for f in ("head", "event_seq", "packet_seq",
                                    "app", "n_exec", "n_deliv")]
        hv = world["host_vertex"]
        suffix, topo, topo_checks = topo_args(world)
        args = [world["client_count"], world["client_pause"],
                world["client_retry"]]
        obs = [ob[f] for f in OB_FIELDS]
        i32, i64 = torch.int32, torch.int64
        self._launch(
            name + suffix, f"shadow_{name}",
            [(t, i64) for t in heap + obs] + [(t, i32) for t in small]
            + [(state["chk"], i64), (pops, i32), (hv, i32)] + topo_checks
            + [(args[0], i32)] + [(t, i64) for t in args[1:]]
            + [(t, i32) for t in app_tensors],
            H, p.E, p.K, p.T, p.P, p.B, p.C, int(win_end),
            *map(_ptr, heap), *map(_ptr, small), _ptr(state["chk"]),
            _ptr(hv), ctypes.byref(topo), *map(_ptr, args),
            *map(_ptr, app_tensors), *app_scalars, *map(_ptr, obs),
            _ptr(pops))

    def judge_outbox(self, state: dict, ob: dict, world: dict,
                     win_end: int, p: PhaseParams) -> None:
        if not ob["t"].is_cuda:
            return judge_outbox_plain(state, ob, world, win_end, p)
        H, OB = ob["t"].shape
        obs = [ob["t"], ob["m"], ob["v"]]
        cnt = [state["packet_seq"], state["n_sent"], state["n_drop"]]
        hv = world["host_vertex"]
        suffix, topo, topo_checks = topo_args(world)
        self._launch(
            "judge_outbox" + suffix, "shadow_judge_outbox",
            [(t, torch.int64) for t in obs]
            + [(t, torch.int32) for t in cnt + [hv]] + topo_checks,
            H, OB, p.C, int(win_end), int(p.boot_end), *map(_ptr, obs),
            *map(_ptr, cnt), _ptr(hv), ctypes.byref(topo),
            p.seed[0], p.seed[1])

    def route(self, ob: dict):
        """K5: (perm, starts, counts) as `route_plain` gives them, for
        destinations in [0, H). Only perm's first counts.sum() entries
        are written; the rest are unspecified."""
        if not ob["t"].is_cuda:
            return route_plain(ob)
        H, OB = ob["t"].shape
        dev = ob["t"].device
        key = (H, OB, dev)
        if key not in self._route_scratch:
            # scattered rows, cursors, and the scan's block totals (it
            # needs fewer than H)
            self._route_scratch = {key: tuple(
                torch.empty(n, dtype=torch.int64, device=dev)
                for n in (H * OB, H, H))}
        scratch = self._route_scratch[key]
        perm = torch.empty(H * OB, dtype=torch.int64, device=dev)
        starts = torch.empty(H, dtype=torch.int64, device=dev)
        counts = torch.empty(H, dtype=torch.int64, device=dev)
        out = [perm, starts, counts]
        self._launch(
            "route", "shadow_route",
            [(ob["t"], torch.int64), (ob["m"], torch.int64)]
            + [(t, torch.int64) for t in out + list(scratch)],
            H, OB, _ptr(ob["t"]), _ptr(ob["m"]), *map(_ptr, out),
            *map(_ptr, scratch))
        return perm, starts, counts

    def merge_heaps(self, state: dict, ob: dict, perm: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    p: PhaseParams) -> None:
        if not perm.is_cuda:
            return merge_heaps_plain(state, ob, perm, starts, counts, p)
        H = state["head"].shape[0]
        heap = [state[f] for f in HEAP_FIELDS] + [state["head"]]
        obs = [ob[f] for f in OB_FIELDS]
        seg = [perm, starts, counts]
        occ = [state["overflow"], state["occ_in"], state["occ_heap"]]
        self._launch(
            "merge_heaps", "shadow_merge_heaps",
            [(t, torch.int64) for t in heap[:5] + obs + seg]
            + [(t, torch.int32) for t in heap[5:] + occ],
            H, p.E, p.IN, perm.shape[0], *map(_ptr, heap),
            *map(_ptr, obs), *map(_ptr, seg), *map(_ptr, occ))
