#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shadow_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels   # a short first call

Phases, in order; any failure exits non-zero before the last line:

1. build: print the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, then build the CUDA kernels from
   shadow_tpu_torch/csrc/ into shadow_tpu_torch/_build/ (timed as
   set-up; ptxas register and shared-memory use is printed).
2. kernels: each kernel against its plain PyTorch version at the
   full-width shapes of the main path (100,000 hosts, E=64, OB=30,
   V=2) on seeded inputs with ids and seqs at 0 and 0xFFFFFFFF,
   overflowing rows and times past the merge's T_CAP. Exact equality
   on every output. Times by CUDA events, median of several runs.
3. parity: the PHOLD test shape at 2 x 1,000 hosts, loss 0.01, 1 s,
   on the card and on the CPU plain path: totals, rounds and per-host
   events_executed / trace_checksum must be identical.
4. full: examples/phold.yaml's graph and args at 2 x 50,000 hosts
   through the port's CLI entry function on the card, with the kernel
   launch counts set to 0 just before and read just after; fails on
   any overflow or on a kernel of the path that never launched.
5. the `kernels` JSON line, then the card line, then the result line.

It imports nothing of jax or of the shadow_tpu package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "parity", "full")
# H100 SXM (NVIDIA data sheet): HBM rate, and the integer ALU rate:
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost. (The 67 TFLOP/s
# float32 peak is 128 lanes with an FMA counted as two operations.)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
THREEFRY_OPS = 130          # add/xor/shift/or per threefry-2x32 block
FULL_HOSTS_PER_GROUP = 50_000
FULL_STOP = "10s"           # examples/phold.yaml's own stop_time

PARITY_YAML = """
general: {stop_time: 1s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.01 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.01 ] ]
experimental: {scheduler_policy: tpu, event_capacity: 64,
               outbox_capacity: 16}
hosts:
  left:
    quantity: 1000
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 100ms}]
  right:
    quantity: 1000
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=2, start_time: 150ms}]
"""

REPLACES = {
    "pop_phase": "shadow_tpu/device/engine.py:737",
    "judge_outbox": "shadow_tpu/device/engine.py:1388",
    "merge_heaps": "shadow_tpu/device/engine.py:1550",
}
SOURCES = {
    "pop_phase": "shadow_tpu_torch/csrc/pop_phase.cu",
    "judge_outbox": "shadow_tpu_torch/csrc/judge_outbox.cu",
    "merge_heaps": "shadow_tpu_torch/csrc/merge_heaps.cu",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# phase 2 inputs: seeded, full width
# ----------------------------------------------------------------------
def random_state(rng, H, E, dev):
    from shadow_tpu_torch.device.kernels import IMAX, INF

    n_live = rng.integers(0, E + 1, H)
    n_live[rng.random(H) < 0.05] = E          # full heaps
    slot = np.arange(E)[None, :]
    live = slot < n_live[:, None]
    ht = np.sort(rng.integers(0, 2 * 10**9, (H, E)), axis=1)
    ht = np.where(live, ht, INF).astype(np.int64)
    src = rng.integers(0, 2**32, (H, E), dtype=np.uint64)
    seq = rng.integers(0, 2**32, (H, E), dtype=np.uint64)
    src[:, 0], seq[:, 1] = 0xFFFFFFFF, 0xFFFFFFFF
    seq[:, 2] = 0
    hk = ((src << np.uint64(32)) | seq).view(np.int64)
    hk = np.where(live, hk, IMAX)
    kind = rng.choice(np.array([0, 1, 2, 2, 2, 3], np.int64), (H, E))
    hm = (kind << 32) | rng.integers(0, 2**31, (H, E))
    head = np.minimum(rng.integers(0, 4, H), n_live).astype(np.int32)
    i32 = np.iinfo(np.int32)

    def counters():
        c = rng.integers(i32.min, i32.max, H, dtype=np.int64)
        c[:3] = [-1, 0, i32.max]
        return c.astype(np.int32)

    arrays = {
        "ht": ht, "hk": hk, "hm": hm,
        "hv": rng.integers(-2**63, 2**63 - 1, (H, E), dtype=np.int64),
        "hw": rng.integers(0, 2**32, (H, E), dtype=np.int64),
        "head": head, "event_seq": counters(), "packet_seq": counters(),
        "app_seq": counters(), "app": counters()[:, None],
        "n_exec": counters(), "n_sent": counters(), "n_drop": counters(),
        "n_deliv": counters(), "overflow": rng.integers(0, 5, H),
        "x_overflow": np.zeros(H, np.int32),
        "chk": rng.integers(0, 2**63 - 1, H, dtype=np.int64),
        "occ_heap": rng.integers(0, E, H), "occ_ob": np.zeros(H),
        "occ_in": rng.integers(0, 8, H), "occ_x": np.zeros((1, 1)),
        "occ_trips": np.zeros(1), "occ_phases": np.zeros(1),
    }
    from shadow_tpu_torch.device.engine import state_from_numpy

    return state_from_numpy(arrays, dev)


def random_outbox(rng, H, OB, torch, dev):
    """A judged outbox: 15% live rows, a tenth of them aimed at 16 hot
    hosts (past IN), times past T_CAP among them, DROP_T markers."""
    from shadow_tpu_torch.device.kernels import DROP_T, INF

    shape = (H, OB)
    live = rng.random(shape) < 0.15
    t = rng.integers(10**9, 3 * 10**9, shape)
    big = rng.random(shape) < 0.02
    t = np.where(big, rng.integers(2**46, 2**61, shape), t)
    t = np.where(rng.random(shape) < 0.01, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    dst = rng.integers(0, H, shape)
    hot = rng.random(shape) < 0.1
    dst = np.where(hot, rng.integers(0, 16, shape), dst)
    row = np.arange(H * OB, dtype=np.int64).reshape(shape)
    k = ((row // OB) << 32) | rng.integers(0, 2**32, shape)
    m = (dst.astype(np.int64) << 32) | (2 | (1 << 8))
    s = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    v = (rng.integers(0, 2**32, shape).astype(np.int64) << 32) | \
        rng.integers(0, 2**32, shape)
    return {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for f, a in zip("tkmsv", (t, k, m, s, v))}


def clone(d):
    return {k: v.clone() for k, v in d.items()}


def max_abs_err(a: dict, b: dict, keys) -> float:
    err = 0.0
    for k in keys:
        x, y = a[k], b[k]
        if x.dtype == y.dtype and bool((x == y).all()):
            continue
        err = max(err, float((x.double() - y.double()).abs().max()))
        err = max(err, 1.0)       # any integer mismatch is >= 1
    return err


def time_median(torch, run, make, reps):
    """Median device ms of run(inputs) over `reps` fresh input
    copies, by CUDA events around the call alone."""
    times = []
    for _ in range(reps):
        args = make()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels_phase(torch, report, H=100_000, dev="cuda"):
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.engine import STATE_DTYPES
    from shadow_tpu_torch.device.prng import seed_key

    dev = torch.device(dev)
    rng = np.random.default_rng(20261017)
    E, IN, msgload = 64, 64, 3
    KS = max(1, msgload)
    B = 32 // KS
    OB = B * KS
    world = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, H).astype(np.int32)).to(dev),
        "lat": torch.tensor([[30_000_000, 50_000_000],
                             [50_000_000, 30_000_000]], dtype=torch.int32,
                            device=dev),
        "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                            dtype=torch.float32, device=dev),
    }
    scratch = K.Kernels()      # comparison launches: not the main path's
    win_end = 10**9
    state0 = random_state(rng, H, E, dev)
    state_keys = list(STATE_DTYPES)
    ob_keys = list(K.OB_FIELDS)

    def params(selfloop):
        app = PholdDevice(n_hosts_total=H, msgload=msgload, size=512,
                          selfloop=selfloop)
        return K.PhaseParams(E=E, K=KS, B=B, IN=IN, C=1,
                             boot_end=5 * 10**8, seed=seed_key(7),
                             app=app)

    def empty_ob():
        return {f: torch.empty((H, OB), dtype=torch.int64, device=dev)
                for f in ob_keys}

    out = {"pop_phase": {"err": 0.0}}
    # K1, with and without self-sends (the dirty stop)
    for selfloop in (0, 1):
        p = params(selfloop)
        sk, sp = clone(state0), clone(state0)
        obk, obp = empty_ob(), empty_ob()
        pk = torch.empty(H, dtype=torch.int32, device=dev)
        pp = torch.empty_like(pk)
        scratch.pop_phase(sk, obk, pk, world, win_end, p)
        K.pop_phase_plain(sp, obp, pp, world, win_end, p)
        torch.cuda.synchronize()
        err = max(max_abs_err(sk, sp, state_keys),
                  max_abs_err(obk, obp, ob_keys),
                  max_abs_err({"pops": pk}, {"pops": pp}, ["pops"]))
        check(err == 0.0, f"pop_phase (selfloop={selfloop}) differs "
              f"from its plain version (max abs err {err})")
        check(int(pk.sum()) > 0, "pop_phase popped nothing")
        out["pop_phase"]["err"] = max(out["pop_phase"]["err"], err)
        if selfloop == 0:
            pops0, ob_k1, state_k1 = pk, obk, sk
    p = params(0)

    def k1_args():
        return (clone(state0), empty_ob(),
                torch.empty(H, dtype=torch.int32, device=dev), world,
                win_end, p)

    out["pop_phase"]["ms"] = time_median(torch, scratch.pop_phase,
                                         k1_args, 7)
    out["pop_phase"]["plain_ms"] = time_median(
        torch, K.pop_phase_plain, k1_args, 3)
    total_pops = int(pops0.sum())
    sends = int((ob_k1["t"] < K.INF).sum())
    # bytes the function must move: downstream reads only t of an
    # unused outbox column, and all five fields of a send
    out["pop_phase"]["bytes"] = (
        H * OB * 8 + sends * 4 * 8     # outbox written
        + total_pops * 4 * 8           # popped rows: t, key, meta, d2
        + H * 8                        # the head time that stopped it
        + H * (7 * 4 + 8) * 2          # per-host counters read+written
        + H * 4 * 2)                   # host vertex, pop count
    out["pop_phase"]["ops"] = (2 * H + 2 * sends) * THREEFRY_OPS
    out["pop_phase"]["shape"] = f"H={H} E={E} OB={OB} pops={total_pops}"

    # K2 on K1's real outbox
    sk, sp = clone(state_k1), clone(state_k1)
    obk, obp = clone(ob_k1), clone(ob_k1)
    scratch.judge_outbox(sk, obk, world, win_end, p)
    K.judge_outbox_plain(sp, obp, world, win_end, p)
    torch.cuda.synchronize()
    err = max(max_abs_err(sk, sp, state_keys),
              max_abs_err(obk, obp, ob_keys))
    check(err == 0.0, f"judge_outbox differs from its plain version "
          f"(max abs err {err})")
    dropped = int((sk["n_drop"].long() - state_k1["n_drop"].long()).sum())
    check(dropped > 0, "judge_outbox dropped nothing: the roll went "
          "untested")

    def k2_args():
        return (clone(state_k1), clone(ob_k1), world, win_end, p)

    out["judge_outbox"] = {
        "err": err,
        "ms": time_median(torch, scratch.judge_outbox, k2_args, 7),
        "plain_ms": time_median(torch, K.judge_outbox_plain, k2_args, 3),
        # t of every row; m and v read, t/m/v written, for sends; the
        # destination's vertex per send; per-host counters and vertex
        "bytes": H * OB * 8 + sends * (2 * 8 + 3 * 8 + 4) + H * 4 * 6,
        "ops": (2 * H + 2 * sends) * THREEFRY_OPS,
        "shape": f"H={H} OB={OB} sends={sends} dropped={dropped}"}

    # K3 on a synthetic judged outbox with hot destinations
    ob3 = random_outbox(rng, H, OB, torch, dev)
    perm, starts, counts = K.route(ob3)
    sk, sp = clone(state0), clone(state0)
    scratch.merge_heaps(sk, ob3, perm, starts, counts, p)
    K.merge_heaps_plain(sp, ob3, perm, starts, counts, p)
    torch.cuda.synchronize()
    err = max_abs_err(sk, sp, state_keys)
    check(err == 0.0, f"merge_heaps differs from its plain version "
          f"(max abs err {err})")
    over = int((sk["overflow"].long() - state0["overflow"].long()).sum())
    check(over > 0, "merge_heaps overflowed nothing: the overflow "
          "path went untested")

    def k3_args():
        return (clone(state0), ob3, perm, starts, counts, p)

    accepted = int(counts.clamp(max=IN).sum())
    slot = torch.arange(E, device=dev)[None, :]
    live_rows = int(((slot >= state0["head"][:, None].long())
                     & (state0["ht"] < K.INF)).sum())
    ct = torch.cat([state0["ht"], torch.full((H, IN), K.INF,
                                              device=dev)], 1)
    out["merge_heaps"] = {
        "err": err,
        "ms": time_median(torch, scratch.merge_heaps, k3_args, 7),
        "plain_ms": time_median(torch, K.merge_heaps_plain, k3_args, 3),
        "torch_sort_ms": time_median(
            torch, lambda x: torch.sort(x, dim=1, stable=True),
            lambda: (ct,), 7),
        # t of every slot and the other four fields of live slots
        # read, all five written; accepted arrivals (five fields and
        # their perm entry); per-host segment bounds and counters
        "bytes": (H * E * 8 + live_rows * 4 * 8 + H * E * 5 * 8
                  + accepted * 6 * 8 + H * (8 + 8 + 4 * 2 + 3 * 4 * 2)),
        "ops": 0,
        "shape": f"H={H} E={E} IN={IN} arrivals={int(counts.sum())} "
                 f"accepted={accepted} overflow={over}"}
    for name, r in out.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / INT32_OPS_PER_S)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / INT32_OPS_PER_S else "operations")
        print(f"[kernels] {name}: equal to plain (max abs err "
              f"{r['err']}); {r['shape']}; kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}: {r['bytes']} B)"
              + (f", torch.sort of the [H,E+IN] times "
                 f"{r['torch_sort_ms']:.4f} ms"
                 if "torch_sort_ms" in r else ""), flush=True)
    report.update(out)


def parity_phase(torch):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    cfg = load_config_str(PARITY_YAML)
    gpu = runner.run(cfg, device="cuda")
    cpu = runner.run(cfg, device="cpu")
    for field in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "rounds", "ok"):
        check(getattr(gpu, field) == getattr(cpu, field),
              f"parity: {field} card {getattr(gpu, field)} != cpu "
              f"{getattr(cpu, field)}")
    check(np.array_equal(gpu.host_events_executed,
                         cpu.host_events_executed),
          "parity: per-host events_executed differ")
    check(np.array_equal(gpu.host_trace_checksum, cpu.host_trace_checksum),
          "parity: per-host trace_checksum differ")
    check(gpu.ok and gpu.events_executed > 0, "parity run failed")
    print(f"[parity] 2x1000 hosts, 1 s: card == cpu plain path: "
          f"{gpu.summary()}; card wall {gpu.wall_s:.3f} s, cpu wall "
          f"{cpu.wall_s:.3f} s", flush=True)


def full_phase(torch, card, report):
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.device.kernels import KERNEL_NAMES, Kernels

    overrides = [f"hosts.west.quantity={FULL_HOSTS_PER_GROUP}",
                 f"hosts.east.quantity={FULL_HOSTS_PER_GROUP}",
                 f"general.stop_time={FULL_STOP}"]
    print(f"[full] examples/phold.yaml with {overrides} (the example's "
          f"stop_time is 10s)", flush=True)
    kernels = Kernels(timing=True)
    kernels.library()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    stats = cli.simulate(os.path.join(REPO, "examples", "phold.yaml"),
                         overrides, device="cuda", kernels=kernels)
    launches = dict(kernels.launches)
    kernel_ms = kernels.kernel_ms()
    peak = torch.cuda.max_memory_allocated()
    check(stats.overflow == 0 and stats.x_overflow == 0,
          f"full: overflow {stats.overflow}, x_overflow "
          f"{stats.x_overflow}")
    check(stats.ok, "full run not ok")
    for name in KERNEL_NAMES:
        check(launches[name] > 0, f"full: {name} never launched")
    hosts = 2 * FULL_HOSTS_PER_GROUP
    print(f"[full] {hosts} hosts: {stats.summary()}; wall "
          f"{stats.wall_s:.3f} s (with a CUDA event pair recorded around "
          f"every kernel launch and route call); "
          f"{stats.events_executed / stats.wall_s:.0f} events/s; "
          f"{stats.packets_sent / stats.wall_s:.0f} packets/s; "
          f"peak device memory {peak} B; card {card}", flush=True)
    for name in KERNEL_NAMES:
        print(f"[full] {name}: {launches[name]} launches, "
              f"{kernel_ms[name]:.3f} ms in total; card {card}",
              flush=True)
    phases = launches["pop_phase"]
    print(f"[full] route (torch.sort + searchsorted, not a kernel of "
          f"this package): {phases} calls, {kernel_ms['route']:.3f} ms in "
          f"total; outside kernels and route: "
          f"{1e3 * stats.wall_s - sum(kernel_ms.values()):.3f} ms of the "
          f"wall; card {card}", flush=True)
    report["_full"] = {"launches": launches, "kernel_ms": kernel_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from shadow_tpu_torch.device.kernels import (
            KERNEL_NAMES,
            build_library,
        )
    except ImportError as e:
        print(f"chip_smoke: the shadow_tpu_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}", flush=True)
        t0 = time.perf_counter()
        lib, log = build_library(ptxas_verbose=True)
        print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}", flush=True)
        report: dict = {}
        if "kernels" in phases:
            kernels_phase(torch, report)
        if "parity" in phases:
            parity_phase(torch)
        if "full" in phases:
            full_phase(torch, card, report)
        if "kernels" in phases and "full" in phases:
            full = report.pop("_full")
            rows = [{
                "name": n, "route": "cuda", "source": SOURCES[n],
                "replaces": REPLACES[n],
                "launches": full["launches"][n],
                "max_abs_err": report[n]["err"],
                "ms": report[n]["ms"], "plain_ms": report[n]["plain_ms"],
                "bound_ms": report[n]["bound_ms"],
                "bound_by": report[n]["bound_by"],
                "library_ms": None,
                "main_path_ms": full["kernel_ms"][n],
                **({"torch_sort_ms": report[n]["torch_sort_ms"]}
                   if "torch_sort_ms" in report[n] else {}),
            } for n in KERNEL_NAMES]
            print(json.dumps({"kernels": rows}), flush=True)
        print(f"card: {card}", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
