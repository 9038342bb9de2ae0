"""The outbox between phases, as csrc/pop_phase.cu and
csrc/judge_outbox.cu rest on it, on the CPU.

The invariant: after every phase (its pop and its whole flush), every
row of a host that popped nothing in the phase is (INF, 0, 0, 0, 0) in
every column, unless the rows came from outside the pop (the engine's
outbox word, set at every entry and by a flush of rows copied in). So
the pop clears only the rows of hosts that popped in the last phase, or
every row under the word, and the judge skips the hosts that popped
nothing unless the word is set. Watched over every phase of runs of the
port's plain path: PHOLD, tgen, Tor, the model NIC, the path counters
(DROP_T rows), `outbox_compact` under both rules, a campaign of two
replicas of which one finishes first, and a 2-rank gloo mesh with one
flush of rows from outside (`runner.flush_phases`).

Numpy mirrors of the two kernels, used by nothing else: `pop_mirror`
(the rows the rule clears, then the cells a popping host writes) and
`judge_mirror` (the skip rule, the row's packet-seq bases by the warp's
chunked suffix sums, the rolls, the bump and the counters; `lane_rolls`
spreads a chunk's rolls over the lanes as the kernel does), held equal
to `pop_plain` and `judge_outbox_plain` at every phase of those runs,
on a flush of rows from outside (pop counts 0, where a skip by the pop
counts alone would lose rows), on a garbage outbox under the word, and
on a phase in which every host popped last time and none pops now.
The watched runs' final leaves and rounds equal the JAX engine's (a
child process, this file's __main__ branch, which applies the jax
batching patch the reference needs; never in the pytest process).
Tolerance: exact equality.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 1 << 62
DROP_T = INF - 1
U32 = 0xFFFFFFFF
FIELDS = "tkmsv"
CLEAR = dict(zip(FIELDS, (INF, 0, 0, 0, 0)))
KIND_PACKET = 2
WARP = 32

PHOLD = """
general: {stop_time: 2s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.1 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.1 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.1 ] ]
experimental:
  scheduler_policy: tpu
  event_capacity: 64
  outbox_capacity: 16
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 100ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=2, start_time: 150ms}]
"""

# trains of up to 32 packets and an outbox row of several warp chunks
TGEN = """
general: {stop_time: 3s, seed: 11}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.15 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.15 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.15 ] ]
experimental:
  scheduler_policy: tpu
  event_capacity: 192
  outbox_capacity: 256
  burst_pops: 8
hosts:
  server:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 6
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=200KiB count=40 pause=50ms retry=300ms}
"""

TOR = """
general: {stop_time: 4s, seed: 1}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "40 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "20 ms" packet_loss 0.05 ] ]
experimental:
  scheduler_policy: tpu
  event_capacity: 96
  outbox_capacity: 48
hosts:
  relay:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:tor_relay, start_time: 100ms}]
  client:
    quantity: 8
    network_node_id: 1
    processes:
    - {path: model:tor_client, start_time: 1s,
       args: cells=48 count=2 pause=500ms retry=2s}
"""

# two replicas whose windows differ: the faster one finishes first and
# its control block stops it while the other runs on
CAMPAIGN = PHOLD.replace("stop_time: 2s", "stop_time: 1s") + \
    "ensemble: {replicas: 2, vary: {latency_scale: [1.0, 3.0]}}\n"

CONFIGS = {"phold": PHOLD, "tgen": TGEN, "tor": TOR}
# key -> (config, overrides): the runs watched and held against JAX
RUNS = {
    "phold": ("phold", []),
    "tgen": ("tgen", []),
    "tor": ("tor", []),
    "phold_nic": ("phold", ["experimental.model_bandwidth=true"]),
    "phold_paths": ("phold", ["experimental.count_paths=true"]),
    "phold_compact_window": ("phold", [
        "experimental.outbox_compact=3",
        "experimental.merge_strategy=window"]),
    "phold_compact_global": ("phold", [
        "experimental.outbox_compact=3",
        "experimental.merge_strategy=global"]),
}
MESH = ("phold", ["experimental.mesh_shards=2"])
FLUSH_AT = 300_000_000


# ----------------------------------------------------------------------
# the mirrors
# ----------------------------------------------------------------------
def clear_cells(ob: dict) -> np.ndarray:
    """[H, OB] bool: the cells that hold (INF, 0, 0, 0, 0)."""
    out = np.ones(ob["t"].shape, bool)
    for f in FIELDS:
        out &= ob[f] == CLEAR[f]
    return out


def clear_rule(pops_last: np.ndarray, outside: bool) -> np.ndarray:
    """The rows the pop clears: every row under the outbox word, else
    the rows of the hosts that popped in the last phase."""
    return np.full(pops_last.shape, True) if outside else pops_last != 0


def pop_mirror(before: dict, pops_last, outside: bool, written: dict,
               pops_now) -> dict:
    """The outbox csrc/pop_phase.cu leaves: `before` with the rule's rows
    cleared, then a popping host's own cells (those of `written`, the
    plain pop's outbox, that are not clear: its send, timer and READY
    rows) stored over it; every other cell as the rule left it."""
    out = {f: before[f].copy() for f in FIELDS}
    rule = clear_rule(pops_last, outside)
    for f in FIELDS:
        out[f][rule] = CLEAR[f]
    own = (pops_now != 0)[:, None] & ~clear_cells(written)
    return {f: np.where(own, written[f], out[f]) for f in FIELDS}


def judge_rule(pops_now: np.ndarray, outside: bool) -> np.ndarray:
    """The hosts K2 judges: every host under the outbox word, else the
    hosts that popped."""
    return np.full(pops_now.shape, True) if outside else pops_now != 0


def _i64(x: int) -> np.int64:
    """A u64 word as the int64 the outbox holds."""
    return np.int64(x - (1 << 64) if x >= 1 << 63 else x)


def send_rows(t, m) -> np.ndarray:
    return (t < INF) & ((m & 0xFF) == KIND_PACKET)


def warp_seq_bases(t, m, packet_seq) -> np.ndarray:
    """[H, OB] u32: each row's first packet seq as a K2 warp finds it:
    the row's 32-column chunks from the last, a warp suffix sum of the
    send rows' counts (shuffles down by 1, 2, 4, 8, 16), base =
    packet_seq - the packets of the later chunks - the suffix."""
    H, OB = t.shape
    cnt = np.where(send_rows(t, m),
                   ((m & U32).astype(np.int64) << 32 >> 40) & U32, 0)
    base = np.zeros((H, OB), np.int64)
    later = np.zeros(H, np.int64)
    for c0 in reversed(range(0, OB, WARP)):
        lanes = np.zeros((H, WARP), np.int64)
        n = min(WARP, OB - c0)
        lanes[:, :n] = cnt[:, c0:c0 + n]
        suffix = lanes
        for o in (1, 2, 4, 8, 16):
            shifted = np.zeros_like(suffix)
            shifted[:, :WARP - o] = suffix[:, o:]
            suffix = (suffix + shifted) & U32
        base[:, c0:c0 + n] = (packet_seq.astype(np.int64)[:, None]
                              - later[:, None] - suffix[:, :n]) & U32
        later = (later + suffix[:, 0]) & U32
    return base


def nth_bit(mask: int, k: int) -> int:
    """The position of the k-th set bit (from 0), by halving as K2
    does."""
    pos = 0
    for w in (16, 8, 4, 2, 1):
        c = bin((mask >> pos) & ((1 << w) - 1)).count("1")
        if k >= c:
            k -= c
            pos += w
    return pos


def lane_rolls(masks) -> list:
    """K2's rolls of one 32-column chunk spread over the lanes: the
    lanes' rolled masks numbered by an exclusive prefix sum, lane i
    rolls packets i, i+32, ...; each packet's row is the last lane whose
    offset is at most the packet's number (a search by halving steps of
    16..1 over the lanes), its train lane the row's nth set bit. Returns
    the (row lane, train lane) of each roll in order."""
    n = [bin(x).count("1") for x in masks]
    off = list(np.cumsum([0] + n[:-1]))
    total = sum(n)
    out = []
    for pk in range(total):
        owner = 0
        for step in (16, 8, 4, 2, 1):
            if off[owner + step] <= pk:
                owner += step
        out.append((owner, nth_bit(masks[owner], pk - off[owner])))
    return out


def plain_seq_bases(t, m, packet_seq) -> np.ndarray:
    """The plain judge's bases: packet_seq minus the row's packets, plus
    the packets of the columns before (kernels.judge_outbox_plain)."""
    cnt = np.where(send_rows(t, m), (m & U32).astype(np.uint32).view(
        np.int32).astype(np.int64) >> 8, 0)
    return (packet_seq.astype(np.int64)[:, None] - cnt.sum(1)[:, None]
            + cnt.cumsum(1) - cnt) & U32


def judge_mirror(before: dict, packet_seq, world: dict, win_end: int, p,
                 judged: np.ndarray):
    """The outbox and the [H] sent/dropped additions csrc/
    judge_outbox.cu gives: the hosts of `judged` judged row by row from
    `warp_seq_bases`, the others left as they are."""
    from shadow_tpu_torch.device.kernels import (
        epoch_of,
        table_lookup,
    )
    from shadow_tpu_torch.device.netsem import packet_drop_mask
    from shadow_tpu_torch.device.prng import purpose_id_key
    from shadow_tpu_torch.utils.rng import PURPOSE_PACKET_DROP

    t, m, v = before["t"], before["m"], before["v"]
    H, OB = t.shape
    out = {f: before[f].copy() for f in FIELDS}
    sent = np.zeros(H, np.int64)
    lost = np.zeros(H, np.int64)
    base = warp_seq_bases(t, m, packet_seq)
    hv = world["host_vertex"].numpy().astype(np.int64)
    gid = np.arange(p.g0, p.g0 + H)
    key = purpose_id_key(p.seed, PURPOSE_PACKET_DROP,
                         torch.from_numpy(gid.astype(np.int32)))
    for h, c in zip(*np.nonzero(send_rows(t, m) & judged[:, None])):
        cnt = int(np.int32(np.uint32(m[h, c] & U32))) >> 8
        dst = int(m[h, c] >> 32)
        sv = torch.tensor(int(hv[gid[h]]))
        dv = torch.tensor(int(hv[min(max(dst, 0), len(hv) - 1)]))
        ft = torch.tensor(int(t[h, c]))
        e = epoch_of(ft, world["epoch_times"])
        lat = int(table_lookup(world["lat"], sv, dv, e))
        rel = table_lookup(world["rel"], sv, dv, e)
        wbits = U32 if cnt >= 32 else (1 << max(cnt, 0)) - 1
        live = (int(v[h, c]) >> 32) & U32 & wbits
        surv = 0
        for j in range(p.C):
            if not (live >> j) & 1:
                continue
            drop = packet_drop_mask(
                p.seed, p.boot_end, ft, None,
                torch.tensor((int(base[h, c]) + j) & U32), rel,
                src_key=(key[0][h], key[1][h]))
            surv |= (0 if bool(drop) else 1) << j
        n_live = bin(live).count("1")
        sent[h] += n_live
        lost[h] += n_live - bin(surv).count("1")
        deliver = int(t[h, c]) + lat
        if dst != gid[h]:
            deliver = max(deliver, win_end)
        out["t"][h, c] = deliver if surv else (DROP_T if p.CP else INF)
        out["m"][h, c] = _i64((dst & U32) << 32 | KIND_PACKET
                              | n_live << 8)
        out["v"][h, c] = _i64(surv << 32 | int(v[h, c]) & U32)
    return out, sent, lost


# ----------------------------------------------------------------------
# the engine's pops and judges, watched
# ----------------------------------------------------------------------
def _np(d: dict) -> dict:
    return {k: v.numpy().copy() for k, v in d.items()}


def _replicas(state: dict, ob: dict, pops, world: dict, win_end, p):
    """(r, state, outbox, pops, world, params, window end) of each
    replica whose phase runs (one for a standalone state)."""
    from shadow_tpu_torch.device import kernels as K

    R = K.n_replicas(state)
    for r in range(R or 1):
        if R is None:
            s, o, n, w, q, c = state, ob, pops, world, p, win_end
        else:
            w = K.replica_world(world, r)
            s, o, n, q = (K.at_replica(state, r), K.at_replica(ob, r),
                          pops[r], K.replica_params(w, p))
            c = K._ctl_at(win_end, r)
        end = K.phase_window(c)
        yield r, s, o, n, w, q, end


class Watch:
    """Kernels whose pop and judge check the invariant and the mirrors
    around the plain versions, and whose merge (the flush's last step)
    checks the invariant at the phase's end."""

    def __init__(self):
        from shadow_tpu_torch.device.kernels import Kernels

        class Watched(Kernels):
            def pop(k, state, ob, pops, world, win_end, p, outside=None):
                self.pop(k, state, ob, pops, world, win_end, p, outside)

            def judge_outbox(k, state, ob, world, win_end, p, pops=None,
                             outside=None):
                self.judge(k, state, ob, world, win_end, p, pops,
                           outside)

            def merge_heaps(k, *a, **kw):
                Kernels.merge_heaps(k, *a, **kw)
                self.phase_end()

        self.kernels = Watched()
        self.n = dict.fromkeys(
            ("phases", "cleared", "left", "popped", "judged", "skipped",
             "stopped", "outside_pops", "outside_judges", "from_outside",
             "send_rows", "ends"), 0)
        self.bufs = None

    @staticmethod
    def _word(outside, r) -> bool:
        return outside is None or bool(int(outside[0, r]))

    def pop(self, k, state, ob, pops, world, win_end, p, outside):
        from shadow_tpu_torch.device.kernels import Kernels

        before = [(r, _np(o), n.numpy().copy(), self._word(outside, r),
                   end) for r, _, o, n, _, _, end in
                  _replicas(state, ob, pops, world, win_end, p)]
        Kernels.pop(k, state, ob, pops, world, win_end, p, outside)
        for (r, b, last, word, end), (_, _, o, n, _, _, _) in zip(
                before, _replicas(state, ob, pops, world, win_end, p)):
            after, now = _np(o), n.numpy()
            if end is None:
                # a stopped replica: not a byte changes, the word stays
                for f in FIELDS:
                    np.testing.assert_array_equal(after[f], b[f])
                np.testing.assert_array_equal(now, last)
                assert outside is None or self._word(outside, r) == word
                self.n["stopped"] += 1
                continue
            # what the rule rests on: a row it leaves is already clear
            rule = clear_rule(last, word)
            assert clear_cells(b)[~rule].all(), np.flatnonzero(
                ~clear_cells(b).all(1) & ~rule)
            got = pop_mirror(b, last, word, after, now)
            for f in FIELDS:
                np.testing.assert_array_equal(got[f], after[f], err_msg=f)
            assert outside is None or not self._word(outside, r)
            self.n["phases"] += 1
            self.n["cleared"] += int(rule.sum())
            self.n["left"] += int((~rule).sum())
            self.n["popped"] += int((now != 0).sum())
            self.n["outside_pops"] += int(word)
        self.bufs = (ob, pops, outside)

    def judge(self, k, state, ob, world, win_end, p, pops, outside):
        from shadow_tpu_torch.device.kernels import Kernels

        assert (pops is None) == (outside is None)
        views = list(_replicas(state, ob, pops if pops is not None else
                               torch.zeros(ob["t"].shape[:-1],
                                           dtype=torch.int32),
                               world, win_end, p))
        before = [(_np(o), _np(s), n.numpy().copy()) for
                  _, s, o, n, _, _, _ in views]
        Kernels.judge_outbox(k, state, ob, world, win_end, p, pops,
                             outside)
        for (r, s, o, _, w, q, end), (b, sb, now) in zip(views, before):
            if end is None:
                continue
            word = self._word(outside, r)
            judged = judge_rule(now, word)
            sends = send_rows(b["t"], b["m"])
            # a skipped host holds no send row
            assert not sends[~judged].any()
            got, sent, lost = judge_mirror(b, sb["packet_seq"], w, end, q,
                                           judged)
            after, sa = _np(o), _np(s)
            for f in FIELDS:
                np.testing.assert_array_equal(got[f], after[f], err_msg=f)
            for key, add in (("n_sent", sent), ("n_drop", lost)):
                np.testing.assert_array_equal(
                    (sb[key].astype(np.int64) + add).astype(np.int32),
                    sa[key], err_msg=key)
            # the warp's bases are the plain judge's on every send row
            np.testing.assert_array_equal(
                warp_seq_bases(b["t"], b["m"], sb["packet_seq"])[sends],
                plain_seq_bases(b["t"], b["m"], sb["packet_seq"])[sends])
            self.n["judged"] += int(judged.sum())
            self.n["skipped"] += int((~judged).sum())
            self.n["send_rows"] += int(sends.sum())
            self.n["outside_judges"] += int(word)
            # rows from outside with pop counts 0: the pop counts alone
            # would skip hosts that sent
            self.n["from_outside"] += int(
                (sends.any(1) & (now == 0)).sum()) if word else 0

    def phase_end(self):
        """The invariant after a phase's flush: a host that popped
        nothing holds a clear row, unless the rows came from outside."""
        if self.bufs is None:
            return
        ob, pops, outside = self.bufs
        R = None if pops.dim() == 1 else pops.shape[0]
        for r in range(R or 1):
            if self._word(outside, r):
                continue
            o = ob if R is None else {f: ob[f][r] for f in FIELDS}
            n = (pops if R is None else pops[r]).numpy()
            assert clear_cells(_np(o))[n == 0].all()
        self.n["ends"] += 1


def _cfg(name, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(CONFIGS[name], list(overrides))


_RUNS = {}


def watched_run(key):
    """(Watch, final leaves, rounds) of a RUNS entry on the CPU plain
    path with the watched kernels, computed once."""
    if key not in _RUNS:
        from shadow_tpu_torch.device import runner
        from shadow_tpu_torch.device.engine import state_to_numpy

        watch = Watch()
        name, ovr = RUNS[key]
        engine, sim = runner.make_engine(_cfg(name, ovr), device="cpu",
                                         kernels=watch.kernels)
        state, rounds = engine.run(engine.init_state(sim.start_times,
                                                     sim.stop_times))
        _RUNS[key] = (watch, state_to_numpy(state), rounds)
    return _RUNS[key]


# ----------------------------------------------------------------------
# the JAX reference, in a child
# ----------------------------------------------------------------------
class ReferenceChild:
    """The child run in a fresh interpreter, started at once; `result()`
    waits for the arrays it saved."""

    def __init__(self, job: dict, workdir: str):
        self.out_path = os.path.join(workdir, "out.npz")
        self.log_path = os.path.join(workdir, "child.log")
        job_path = os.path.join(workdir, "job.json")
        with open(job_path, "w") as f:
            json.dump(job, f)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["SHADOW_TPU_AOT_DIR"] = os.path.join(workdir, "aot")
        env["SHADOW_TPU_OCC_DIR"] = os.path.join(workdir, "occ")
        env["XLA_FLAGS"] = " ".join(
            f for f in env.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f)
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job_path,
                 self.out_path], cwd=workdir, env=env,
                stdout=log, stderr=subprocess.STDOUT)
        self._out = None

    def result(self) -> dict:
        if self._out is None:
            rc = self.proc.wait(timeout=900)
            with open(self.log_path) as f:
                assert rc == 0, f.read()[-4000:]
            with np.load(self.out_path) as z:
                self._out = {k: z[k] for k in z.files}
        return self._out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module", autouse=True)
def reference_child():
    job = {k: (CONFIGS[n], o) for k, (n, o) in RUNS.items()}
    with tempfile.TemporaryDirectory(prefix="torch_outbox_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", list(RUNS))
def test_every_phase_keeps_the_invariant_and_equals_both_mirrors(
        key, reference):
    """Every phase: the rows the pop's rule leaves are clear, both
    mirrors equal the plain pop and judge, a host that popped nothing
    holds a clear row after the flush; the run equals JAX leaf by
    leaf. The rule leaves rows alone and the judge skips hosts."""
    watch, leaves, rounds = watched_run(key)
    n = watch.n
    assert n["phases"] > 20 and n["ends"] == n["phases"]
    # the first phase after the run's entry clears every row
    assert n["outside_pops"] == 1
    assert n["left"] > 0 and n["popped"] > 0
    if "nic" in key:
        # the NIC's pops judge their own sends: K2 does not run
        assert n["judged"] == 0
    else:
        assert n["skipped"] > 0 and n["send_rows"] > 0
        assert n["outside_judges"] == 0
    assert rounds == int(reference[f"{key}/rounds"])
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, reference[f"{key}/{k}"],
                                      err_msg=f"{key}: leaf {k}")
    if "paths" in key:
        assert (leaves["path_cnt"] > 0).any()


def test_a_campaign_replica_that_finishes_first_keeps_its_outbox(
        tmp_path, monkeypatch):
    """R = 2, one replica done before the other: its stopped phases
    change no byte of its outbox, pop counts or word; every running
    phase keeps the invariant and both mirrors."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    watch = Watch()
    er = EnsembleRunner(load_config_str(CAMPAIGN), device="cpu",
                        kernels=watch.kernels)
    er.run()
    n = watch.n
    assert n["stopped"] > 0 and n["phases"] > 20
    assert n["outside_pops"] == 2 and n["left"] > 0 and n["skipped"] > 0


def _paused(name="phold", overrides=()):
    """(engine, state, watch) of a config paused at FLUSH_AT on the CPU
    plain path with the watched kernels."""
    from shadow_tpu_torch.device import runner

    watch = Watch()
    cfg = _cfg(name, overrides)
    engine, sim = runner.make_engine(cfg, device="cpu",
                                     kernels=watch.kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    engine.run(state, stop=FLUSH_AT,
               final_stop=int(engine.config.stop_time))
    return engine, state, watch


def test_a_flush_of_rows_from_outside_judges_every_host():
    """flush_phases' path on one device: rows copied into the buffer,
    pop counts 0, `flush` arms the word; the judge judges every host
    (by pop counts alone it would skip hosts with send rows), and the
    next pop clears every row and the word."""
    from shadow_tpu_torch.device.kernels import control_block

    engine, state, watch = _paused()
    ob, pops, _ = engine._buffers()
    ctl = control_block("cpu", run=1, win_end=engine.next_time(state) + 1)
    # an outbox after a pop, its rows copied in from outside
    engine.kernels.pop(state, ob, pops, engine.world, ctl, engine.params)
    rows = {f: v.clone() for f, v in ob.items()}
    for f in FIELDS:
        ob[f].copy_(rows[f])
    pops.zero_()
    n0 = dict(watch.n)
    engine.flush(state, ctl)
    assert watch.n["outside_judges"] == n0["outside_judges"] + 1
    assert watch.n["from_outside"] > n0["from_outside"]
    assert watch.n["skipped"] == n0["skipped"]
    engine.phase(state, control_block(
        "cpu", run=1, win_end=engine.next_time(state) + 1))
    assert watch.n["outside_pops"] == n0["outside_pops"] + 1
    assert not bool(engine._outside[0, 0])


def test_a_garbage_outbox_under_the_word_is_cleared():
    """Random words in every cell and random pop counts under a set
    word: the mirror clears every row, equal to the plain pop; the word
    is cleared; the judge after it skips by the pop counts."""
    from shadow_tpu_torch.device.kernels import outbox_word

    engine, state, watch = _paused("tgen")
    ob, pops, _ = engine._buffers()
    rng = np.random.default_rng(3)
    for f in FIELDS:
        ob[f].copy_(torch.from_numpy(rng.integers(
            -2**63, 2**63 - 1, tuple(ob[f].shape), dtype=np.int64)))
    pops.copy_(torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, tuple(pops.shape), dtype=np.int64)
        .astype(np.int32)))
    word = outbox_word("cpu")
    engine._outside = word
    n0 = dict(watch.n)
    engine._phase(state, engine.next_time(state) + 1)
    assert watch.n["outside_pops"] == n0["outside_pops"] + 1
    assert watch.n["cleared"] - n0["cleared"] == pops.shape[0]
    assert not bool(word[0, 0])
    assert watch.n["skipped"] > n0["skipped"]


def test_a_phase_after_every_host_popped_where_none_pops():
    """Every host popped last phase (its row holds anything), none pops
    now (the window ends before every head): the rule clears every row,
    the pop counts fall to 0 and the judge skips every host."""
    from shadow_tpu_torch.device.kernels import control_block

    engine, state, watch = _paused("tor")
    ob, pops, _ = engine._buffers()
    rng = np.random.default_rng(4)
    for f in FIELDS:
        ob[f].copy_(torch.from_numpy(rng.integers(
            -2**63, 2**63 - 1, tuple(ob[f].shape), dtype=np.int64)))
    pops.fill_(1)
    engine._outside[0].zero_()
    n0 = dict(watch.n)
    ctl = control_block("cpu", run=1, win_end=0)
    engine.kernels.pop(state, ob, pops, engine.world, ctl, engine.params,
                       engine._outside)
    engine.kernels.judge_outbox(state, ob, engine.world, ctl,
                                engine.params, pops, engine._outside)
    H = pops.shape[0]
    assert watch.n["cleared"] - n0["cleared"] == H
    assert watch.n["popped"] == n0["popped"]
    assert watch.n["skipped"] - n0["skipped"] == H
    assert not bool(pops.any())
    assert clear_cells(_np(ob)).all()


@pytest.mark.parametrize("OB", [1, 31, 32, 33, 64, 100])
def test_warp_seq_bases_equal_the_plain_bases(OB):
    """The warp's chunked suffix sums against the plain judge's running
    bases: trains of every count, negative and huge counts in rows that
    are not sends, DROP_T rows, packet_seq wrapping past 2^32."""
    rng = np.random.default_rng(OB)
    H = 64
    t = np.where(rng.random((H, OB)) < 0.6, rng.integers(0, 10**9,
                                                         (H, OB)), INF)
    t = np.where(rng.random((H, OB)) < 0.05, DROP_T, t)
    kind = rng.choice([KIND_PACKET, 1, 8], (H, OB))
    cnt = rng.integers(0, 40, (H, OB))
    cnt = np.where(rng.random((H, OB)) < 0.05,
                   rng.integers(-2**23, 2**23, (H, OB)), cnt)
    lo = (cnt << 8 | kind) & U32
    m = (rng.integers(0, H, (H, OB)).astype(np.int64) << 32) | lo
    ps = rng.integers(-2**31, 2**31 - 1, H).astype(np.int32)
    sends = send_rows(t, m)
    assert sends.any()
    np.testing.assert_array_equal(warp_seq_bases(t, m, ps)[sends],
                                  plain_seq_bases(t, m, ps)[sends])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_rolls_roll_every_live_packet_once(seed):
    """The chunk's rolls spread over the lanes reach every (row, train
    lane) of the rolled masks exactly once: empty rows, full trains of
    32, single packets, holed masks, all 32 rows full."""
    rng = np.random.default_rng(seed)
    masks = [int(x) for x in rng.integers(0, 2**32, WARP)]
    masks = [x if rng.random() < 0.6 else 0 for x in masks]
    masks[3], masks[7], masks[31] = 0xFFFFFFFF, 1, 1 << 31
    for ms in (masks, [0xFFFFFFFF] * WARP, [0] * (WARP - 1) + [5]):
        got = lane_rolls(ms)
        want = [(r, j) for r, x in enumerate(ms) for j in range(32)
                if (x >> j) & 1]
        assert sorted(got) == want and len(got) == len(set(got))


def _mesh_rank(mesh, cfg, job):
    """A 2-rank mesh run and one flush of rows from outside, on this
    rank's engines with the watched kernels: the counters of both."""
    from shadow_tpu_torch.device import runner

    out = {}
    made = runner.engine_from
    for name in ("run", "flush"):
        watch = Watch()

        def engine_from(*a, **kw):
            return made(*a, **{**kw, "kernels": watch.kernels})

        runner.engine_from = engine_from
        try:
            if name == "run":
                engine = engine_from(cfg, runner.build(cfg),
                                     device=mesh.device, mesh=mesh)
                state = engine.init_state(*_starts(cfg))
                engine.run(state)
            else:
                runner.flush_phases(mesh, [job])
        finally:
            runner.engine_from = made
        out[name] = watch.n
    return mesh.gather(out)


def _starts(cfg):
    from shadow_tpu_torch.device import runner

    sim = runner.build(cfg)
    return sim.start_times, sim.stop_times


def test_a_two_rank_mesh_keeps_the_invariant():
    """Two gloo ranks: every phase of a run keeps the invariant and both
    mirrors on each rank's outbox; `flush_phases` (rows of a one-device
    pop copied in, pop counts 0) judges every host of each rank."""
    from shadow_tpu_torch.device import mesh, runner
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.device.kernels import control_block

    name, ovr = MESH
    cfg = _cfg(name, ovr)
    # the job: one device's state paused at FLUSH_AT, popped once
    one, sim = runner.make_engine(_cfg(name), device="cpu")
    state = one.init_state(sim.start_times, sim.stop_times)
    one.run(state, stop=FLUSH_AT, final_stop=int(one.config.stop_time))
    win_end = one.next_time(state) + 1
    ob, pops, _ = one._buffers()
    one.kernels.pop(state, ob, pops, one.world,
                    control_block("cpu", run=1, win_end=win_end),
                    one.params)
    leaves = state_to_numpy(state)
    # the mesh's global layout of the occupancy leaves: [S, S] and [S]
    for k in ("occ_x", "occ_trips", "occ_phases"):
        v = leaves[k]
        leaves[k] = np.zeros((2, 2) if v.ndim == 2 else (2,), v.dtype)
    job = (cfg, leaves, _np(ob), win_end)
    ranks = mesh.spawn(["cpu"] * 2, _mesh_rank, (cfg, job), timeout=300)
    for n in ranks:
        run, flush = n["run"], n["flush"]
        assert run["phases"] > 20 and run["ends"] == run["phases"]
        assert run["left"] > 0 and run["skipped"] > 0
        assert flush["outside_judges"] == 1 and flush["skipped"] == 0
    assert sum(n["flush"]["from_outside"] for n in ranks) > 0


def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    import jax

    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    for key, (yaml, ovr) in job.items():
        c = Controller(load_config_str(yaml, ovr))
        eng = c.runner.engine
        state, rounds = eng.run(eng.init_state(c.sim.starts))
        for k, v in state.items():
            out[f"{key}/{k}"] = np.asarray(jax.device_get(v))
        out[f"{key}/rounds"] = np.int64(rounds)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
