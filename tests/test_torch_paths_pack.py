"""K7 count_paths and K13 pack_two_phase as csrc/count_paths.cu and
csrc/pack_two_phase.cu compute them, on the CPU.

Numpy mirrors of the two kernels, used by nothing else:

* `paths_mirror`: K7's two readings. Every row (an outbox under
  kernels.PATHS_GATED_ROWS rows, or a launch given no pop counts): a
  thread a row, the packet rows of a warp (32 consecutive rows) summed
  by pair, one add a distinct pair a warp. By the pop counts (that many
  rows or more): a warp's WARP_HOSTS consecutive hosts, those with a
  nonzero pop count (every host under the outbox word) listed, their
  rows one flat list of (host, column) items, 32 items a step, one add
  a distinct pair a step; where V*V <= SHARED_BINS into the block's own
  histogram, one global add a nonzero bin a block.
* `pack1_mirror` and `pack2_mirror`: the kept send buffers. A buffer's
  groups and their offsets, a slot's group by a search over the
  offsets; this pack's rows into [0, n), the fills into [n, n_prev)
  alone, the rows past the capacity lost; each buffer's fill word.

K7's mirror is held equal to `count_paths_plain` at every launch of the
port's plain path on chip_smoke.py's NIC PHOLD (NIC_PHOLD_YAML) and
link-fault tgen (FAULT_YAML) configs, where the rule it rests on is
asserted (after the pop, every row of a host whose pop count is 0 has
t = INF), on a flush of rows copied in (the word set), on a campaign
of two replicas of which one stops first, and on synthetic outboxes
(both histograms, pop counts with the word clear and set, garbage under
the word). K13's mirror, on buffers kept from phase to phase (garbage
when allocated), is held equal after every pack to the plain versions'
fresh buffers on rank 0's rows of successive phases of a one-device
PHOLD run at S = 2 and S = 4, at the auto capacities and at capacities
the rows overflow, with a phase whose outbox is empty in between; with
x_overflow, occ_x and hist equal. The NIC run's path counters and
rounds equal the JAX engine's (a child process, this file's __main__
branch, which applies the jax batching patch the reference needs; never
in the pytest process). Tolerance: exact equality.
"""

import importlib.util
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
IMAX = (1 << 63) - 1
U32 = 0xFFFFFFFF
KIND_PACKET = 2
FIELDS = "tkmsv"

# csrc/count_paths.cu: a warp's hosts where it reads by the pop counts,
# a block's warps and the grid's blocks there, and the largest V*V whose
# histogram a block keeps in shared memory
WARP_HOSTS = 8
BLOCK_WARPS = 8
MAX_BLOCKS = 65535
SHARED_BINS = 1024


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


_SMOKE = _smoke()
CONFIGS = {"nic_phold": _SMOKE.NIC_PHOLD_YAML,
           "faults_dense": _SMOKE.FAULT_YAML}
CAMPAIGN = _SMOKE.NIC_PHOLD_YAML.replace("stop_time: 3s", "stop_time: 1s") \
    + "ensemble: {replicas: 2, vary: {latency_scale: [1.0, 3.0]}}\n"

# a one-device PHOLD whose hosts split into 2 or 4 ranks' rows
PHOLD = """
general: {stop_time: 2s, seed: 7}
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
  outbox_capacity: 12
hosts:
  left:
    quantity: 16
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=3, start_time: 100ms}]
  right:
    quantity: 16
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=3, start_time: 150ms}]
"""
PACK_PHASES = 24
EMPTY_AT = 10


def lo32(x: np.ndarray) -> np.ndarray:
    """The low word as int32 (the kernels' `lo32`), in int64."""
    return ((x & U32) ^ 0x80000000) - 0x80000000


def hi32(x: np.ndarray) -> np.ndarray:
    return x >> 32


# ----------------------------------------------------------------------
# the K7 mirror
# ----------------------------------------------------------------------
def _adds(out, kind, pkt, pair, V: int, steps, nonzero=False) -> int:
    """Add the packet items' weights into `out`, one add a distinct
    (step, pair) (`nonzero`: only where its sum is not 0); returns the
    adds."""
    idx = np.flatnonzero(pkt)
    key = steps[idx] * (V * V) + pair[idx]
    groups, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(groups), np.int64)
    np.add.at(sums, inv, kind[idx] >> 8)
    np.add.at(out, groups % (V * V), sums)
    return int((sums != 0).sum()) if nonzero else len(groups)


def paths_mirror(t, k, m, hv, pops, every: bool, V: int,
                 gated: bool = False):
    """K7 on one replica's outbox [H, OB] with the world's host vertices
    `hv`, reading every row or (`gated`) by the pop counts: (the
    histogram [V*V] it adds, [H] bool the hosts whose rows it read, the
    global adds it issued: by the pop counts with V*V <= SHARED_BINS, a
    block's nonzero bins)."""
    H, OB = t.shape
    out = np.zeros(V * V, np.int64)
    if not gated:
        read = np.ones(H, bool)
        # the items are the rows; a step is a warp of 32 rows
        h = np.repeat(np.arange(H), OB)
        col = np.tile(np.arange(OB), H)
        steps = np.arange(H * OB) // 32
    else:
        read = np.ones(H, bool) if every else pops != 0
        hs, cols, steps = [], [], []
        for w, h0 in enumerate(range(0, H, WARP_HOSTS)):
            listed = np.flatnonzero(read[h0:h0 + WARP_HOSTS]) + h0
            i = np.arange(len(listed) * OB)
            hs.append(listed[i // OB])
            cols.append(i % OB)
            # item i of the warp: step i // 32, lane i % 32
            steps.append(w * (1 << 20) + i // 32)
        h, col, steps = (np.concatenate(x) for x in (hs, cols, steps))
        if V * V <= SHARED_BINS:
            # warp w is warp w % BLOCK_WARPS of its block (the warps
            # grid-strided over the host groups)
            nb = min(-(-H // (WARP_HOSTS * BLOCK_WARPS)), MAX_BLOCKS)
            steps = (steps >> 20) % (nb * BLOCK_WARPS) // BLOCK_WARPS
    mm = m[h, col]
    kind = lo32(mm)
    pkt = (t[h, col] < INF) & ((kind & 0xFF) == KIND_PACKET)
    pair = hv[np.clip(hi32(k[h, col]), 0, H - 1)] * V + \
        hv[np.clip(hi32(mm), 0, H - 1)]
    adds = _adds(out, kind, pkt, pair, V, steps,
                 nonzero=gated and V * V <= SHARED_BINS)
    return out, read, adds


class Watch:
    """Kernels whose K7 checks the mirror around the plain version,
    replica by replica, and asserts the rule it rests on where the
    outbox word is clear."""

    def __init__(self):
        from shadow_tpu_torch.device import kernels as K

        watch = self

        class Watched(K.Kernels):
            def count_paths(k, state, ob, world, ctl=None, pops=None,
                            outside=None):
                watch.paths(k, state, ob, world, ctl, pops, outside)

        self.kernels = Watched()
        self.n = dict.fromkeys(
            ("launches", "stopped", "given_pops", "rule_held",
             "under_word", "from_outside", "hosts_read", "hosts_skipped",
             "adds", "packets"), 0)

    def paths(self, k, state, ob, world, ctl, pops, outside):
        from shadow_tpu_torch.device import kernels as K

        R = K.ob_replicas(ob)
        views = [state] if R is None else [K.at_replica(state, r)
                                           for r in range(R)]
        obs = [ob] if R is None else [K.at_replica(ob, r)
                                      for r in range(R)]
        ctls = [ctl] if R is None else [K._ctl_at(ctl, r)
                                        for r in range(R)]
        hv = world["host_vertex"].numpy().astype(np.int64)
        V = K.n_vertices(world)
        self.n["given_pops"] += int(pops is not None)
        want = []
        for r, (s, o, c) in enumerate(zip(views, obs, ctls)):
            cnt0 = s["path_cnt"].numpy().reshape(-1).copy()
            if K._phase_off(c):
                want.append((cnt0, None, None))
                continue
            t = o["t"].numpy()
            n = None if pops is None else (
                pops if R is None else pops[r]).numpy()
            every = pops is None or bool(int(outside[0, r]))
            if not every:
                # the rule: a host that popped nothing holds only clear
                # rows after the pop
                assert (t[n == 0] == INF).all()
                self.n["rule_held"] += 1
            elif n is not None and (t[n == 0] < INF).any():
                self.n["from_outside"] += 1
            kk, mm = o["k"].numpy(), o["m"].numpy()
            rows = paths_mirror(t, kk, mm, hv, n, every, V)
            got = paths_mirror(t, kk, mm, hv, n, every, V, gated=True)
            # both readings give the plain version's counts, whichever
            # the outbox's size picks
            np.testing.assert_array_equal(rows[0], got[0])
            want.append((cnt0 + got[0], got, every))
        K.Kernels.count_paths(k, state, ob, world, ctl, pops, outside)
        for s, (cnt, got, every) in zip(views, want):
            np.testing.assert_array_equal(
                s["path_cnt"].numpy().reshape(-1), cnt)
            if got is None:
                self.n["stopped"] += 1
                continue
            read = got[1]
            self.n["launches"] += 1
            self.n["under_word"] += int(every)
            self.n["hosts_read"] += int(read.sum())
            self.n["hosts_skipped"] += int((~read).sum())
            self.n["adds"] += got[2]
            self.n["packets"] += int(got[0].sum())


def _cfg(text, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(text, list(overrides))


_RUNS = {}


def watched_run(key):
    """(Watch, final leaves, rounds) of a CONFIGS entry on the CPU plain
    path with the watched kernels, computed once."""
    if key not in _RUNS:
        from shadow_tpu_torch.device import runner
        from shadow_tpu_torch.device.engine import state_to_numpy

        watch = Watch()
        engine, sim = runner.make_engine(_cfg(CONFIGS[key]), device="cpu",
                                         kernels=watch.kernels)
        state, rounds = engine.run(
            engine.init_state(sim.start_times, sim.stop_times))
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
    with tempfile.TemporaryDirectory(prefix="torch_paths_ref_") as d:
        child = ReferenceChild({"nic_phold": CONFIGS["nic_phold"]}, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


# ----------------------------------------------------------------------
# K7: runs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", list(CONFIGS))
def test_every_path_count_equals_the_mirror_and_the_rule_holds(key):
    """Every K7 launch of the run (NIC PHOLD under the model NIC, whose
    pop judges; the link-fault tgen after K2): the mirror, given the
    engine's pop counts and outbox word, equals `count_paths_plain`;
    where the word is clear every host that popped nothing holds only
    rows at t = INF, and the mirror skips those hosts."""
    watch, leaves, _ = watched_run(key)
    n = watch.n
    assert n["launches"] > 50
    assert n["given_pops"] == n["launches"]
    assert n["rule_held"] == n["launches"] - n["under_word"] > 0
    assert n["hosts_skipped"] > 0 and n["packets"] > 0
    assert int(leaves["path_cnt"].sum()) == n["packets"]


def test_a_flush_of_rows_from_outside_counts_every_row():
    """`flush` of rows copied into the buffer, pop counts 0, on the NIC
    PHOLD paused half way: K7 is given the word set, the mirror reads
    every host's row (a read by the pop counts alone would lose the
    popped hosts' packets) and equals `count_paths_plain`; the next
    phase's pop clears the word."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.kernels import control_block

    watch = Watch()
    engine, sim = runner.make_engine(_cfg(CONFIGS["nic_phold"]),
                                     device="cpu", kernels=watch.kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    stop = int(engine.config.stop_time)
    engine.run(state, stop=stop // 2, final_stop=stop)
    ob, pops, _ = engine._buffers()
    nt = engine.next_time(state)
    assert nt < INF
    ctl = control_block("cpu", run=1,
                        win_end=nt + int(engine.config.lookahead))
    engine.kernels.pop(state, ob, pops, engine.world, ctl, engine.params)
    assert int(pops.sum()) > 0
    pops.zero_()
    n0 = dict(watch.n)
    engine.flush(state, ctl)
    assert watch.n["under_word"] == n0["under_word"] + 1
    assert watch.n["from_outside"] == n0["from_outside"] + 1
    assert watch.n["hosts_skipped"] == n0["hosts_skipped"]
    assert watch.n["packets"] > n0["packets"]
    engine.phase(state, control_block(
        "cpu", run=1, win_end=engine.next_time(state) + 1))
    assert watch.n["under_word"] == n0["under_word"] + 1
    assert watch.n["rule_held"] == n0["rule_held"] + 1


def test_a_two_replica_campaign_with_a_stopped_replica(tmp_path,
                                                       monkeypatch):
    """R = 2 under the model NIC and the path counters, replicas whose
    latencies differ finishing at different rounds: every running
    replica's K7 equals the mirror by its own pop counts and word, a
    stopped replica keeps every count."""
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    watch = Watch()
    er = EnsembleRunner(_cfg(CAMPAIGN), device="cpu",
                        kernels=watch.kernels)
    engine = er.engine()
    state = engine.init_ensemble_state(er.sim.start_times,
                                       er.sim.stop_times)
    state, rounds = engine.run(state)
    n = watch.n
    assert len(set(rounds)) > 1
    assert n["stopped"] > 0 and n["launches"] > 20
    assert n["hosts_skipped"] > 0
    assert int(state["path_cnt"].sum()) == n["packets"]


# ----------------------------------------------------------------------
# K7: synthetic outboxes
# ----------------------------------------------------------------------
def judged_rows(rng, H: int, OB: int, V: int, pops, rule: bool):
    """A judged outbox (t, k, m) of H hosts x OB columns over V
    vertices: a fifth of the rows live (a twentieth of them DROP_T),
    kinds packet, timer and READY, trains of -4 to 32 packets (negative
    weights sum too), sources and destinations out of range at the
    edges; with `rule` only the hosts with a nonzero pop count hold rows
    below INF."""
    live = rng.random((H, OB)) < 0.2
    if rule:
        live &= (pops != 0)[:, None]
    t = rng.integers(10**9, 2 * 10**9, (H, OB))
    t = np.where(rng.random((H, OB)) < 0.05, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    kind = rng.choice(np.array([2, 2, 2, 1, 8]), (H, OB))
    cnt = rng.integers(-4, 33, (H, OB))
    k = (rng.integers(-2, H + 2, (H, OB)) << 32) | \
        rng.integers(0, 2**32, (H, OB))
    m = (rng.integers(-2, H + 2, (H, OB)) << 32) | \
        ((cnt << 8) & U32) | kind
    return t, k.astype(np.int64), m.astype(np.int64)


@pytest.mark.parametrize("V", [1, 2, 6, 64, 256])
@pytest.mark.parametrize("H,OB", [(37, 12), (700, 39), (300, 100)])
def test_the_count_of_popped_rows_equals_the_plain_count(V, H, OB):
    """`paths_mirror`, reading every row and by the pop counts, given no
    pop counts, pop counts with the word clear on an outbox as the rule
    leaves it, and the word set (rows live at hosts that popped nothing,
    garbage among them) equals `count_paths_plain`; by the pop counts
    with the word clear it reads the popped hosts' rows alone. (A launch
    of csrc/count_paths.cu given no pop counts reads by them, every host
    listed, where the outbox is large and V*V <= SHARED_BINS.)"""
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(V * 1000 + H + OB)
    pops = np.where(rng.random(H) < 0.4, rng.integers(1, 9, H), 0)
    hv = rng.integers(0, V, H)
    world = {"host_vertex": torch.from_numpy(hv.astype(np.int32)),
             "lat": torch.zeros((V, V), dtype=torch.int32)}
    garbage = rng.integers(-2**63, 2**63 - 1, (3, H, OB), dtype=np.int64)
    garbage[0][rng.random((H, OB)) < 0.5] = INF
    cases = {"no pops": (*judged_rows(rng, H, OB, V, pops, False), None,
                         True),
             "rule": (*judged_rows(rng, H, OB, V, pops, True), pops, False),
             "word": (*judged_rows(rng, H, OB, V, pops, False), pops, True),
             "garbage": (*garbage, pops, True)}
    for case, (t, k, m, p, every) in cases.items():
        state = {"path_cnt": torch.zeros((1, V * V), dtype=torch.int64)}
        K.count_paths_plain(state, {"t": torch.from_numpy(t),
                                    "k": torch.from_numpy(k),
                                    "m": torch.from_numpy(m)}, world)
        for gated in (False, True):
            got, read, adds = paths_mirror(t, k, m, hv, p, every, V, gated)
            np.testing.assert_array_equal(
                got, state["path_cnt"].numpy()[0], err_msg=case)
            assert read.all() if every or not gated else \
                (read == (pops != 0)).all(), case
            if case != "garbage":
                assert adds > 0 and got.any(), case


def test_a_warp_adds_once_a_distinct_pair():
    """Over one vertex every packet row lies on one pair: the mirror's
    adds are at most one a step of 32 rows or items, fewer than the
    packet rows (the design before's atomics), in both readings."""
    rng = np.random.default_rng(3)
    H, OB, V = 64, 64, 1
    pops = np.ones(H, np.int64)
    t, k, m = judged_rows(rng, H, OB, V, pops, False)
    hv = np.zeros(H, np.int64)
    pkt = (t < INF) & ((lo32(m) & 0xFF) == KIND_PACKET)
    for gated in (False, True):
        _, _, adds = paths_mirror(t, k, m, hv, pops, True, V, gated)
        assert adds <= H * OB // 32 < int(pkt.sum())


@pytest.mark.parametrize("V", [1, 2, 32, 33])
def test_a_block_adds_once_a_nonzero_bin_by_the_pop_counts(V, monkeypatch):
    """By the pop counts, where V*V <= SHARED_BINS, a block flushes its
    histogram with one add a nonzero bin: at most V*V adds a block of 64
    hosts, no more than the warps' adds a step would be (fewer over one
    or two vertices); above SHARED_BINS the warps' adds stand. Both equal
    `count_paths_plain`."""
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(V)
    H, OB = 640, 39
    pops = np.where(rng.random(H) < 0.5, 1, 0)
    t, k, m = judged_rows(rng, H, OB, V, pops, True)
    hv = rng.integers(0, V, H)
    world = {"host_vertex": torch.from_numpy(hv.astype(np.int32)),
             "lat": torch.zeros((V, V), dtype=torch.int32)}
    state = {"path_cnt": torch.zeros((1, V * V), dtype=torch.int64)}
    K.count_paths_plain(state, {"t": torch.from_numpy(t),
                                "k": torch.from_numpy(k),
                                "m": torch.from_numpy(m)}, world)
    want = state["path_cnt"].numpy()[0]
    got, read, adds = paths_mirror(t, k, m, hv, pops, False, V, True)
    np.testing.assert_array_equal(got, want)
    assert (read == (pops != 0)).all()
    # the same reading with every sum going to global memory
    monkeypatch.setitem(globals(), "SHARED_BINS", 0)
    warp, _, warp_adds = paths_mirror(t, k, m, hv, pops, False, V, True)
    np.testing.assert_array_equal(warp, want)
    blocks = -(-H // (WARP_HOSTS * BLOCK_WARPS))
    if V * V <= 1024:
        assert 0 < adds <= min(blocks * V * V, warp_adds)
        if V <= 2:
            assert adds < warp_adds
    else:
        assert adds == warp_adds


# ----------------------------------------------------------------------
# the K13 mirror: kept buffers
# ----------------------------------------------------------------------
def segment(starts, counts, S: int, H_loc: int, d: int):
    """(first perm entry, rows) of destination shard d, as the kernel
    reads them."""
    s = int(starts[d * H_loc])
    last = S * H_loc - 1
    e = int(starts[(d + 1) * H_loc]) if d + 1 < S else \
        int(starts[last] + counts[last])
    return s, e - s


FILLS = (INF, IMAX, 0, 0, 0, IMAX)


def _slots(send, filled, b, raw, cap, ch):
    """Write buffer b's slots [0, max(raw, prev)) below the capacity
    from the channel rows `ch` (row j of the pack where j < raw, the
    fills elsewhere); returns the slots past the capacity, and the new
    fill word. The slots past both the rows and the last pack's fill
    are not touched."""
    prev = min(int(filled[b]), cap)
    hi = max(raw, prev)
    j = np.arange(hi)
    w = j < cap
    ok = j < raw
    for c in range(6):
        send[b, c, j[w]] = np.where(ok[w], ch(c, j[w]), FILLS[c])
    filled[b] = min(raw, cap)
    return j[~w], hi


def pack1_mirror(send, filled, rows, perm, starts, counts, S, shard, H_loc,
                 OB, G, NG, xo, occ):
    """K13's phase 1 into the kept buffers `send` [G, 6, CAP] with their
    fill words; `rows` the rank's outbox channels, flat. Returns the
    slots written."""
    CAP = send.shape[-1]
    span, base = S * H_loc * OB, shard * H_loc * OB
    written = 0
    for b in range(G):
        st = np.zeros(NG, np.int64)
        n = np.zeros(NG, np.int64)
        for a in range(NG):
            d = a * G + b
            st[a], n[a] = segment(starts, counts, S, H_loc, d)
            if d == shard:
                n[a] = 0
            occ[d] = max(occ[d], n[a])
        off = np.r_[0, np.cumsum(n)]

        def x_of(j):
            a = np.minimum(np.searchsorted(off[1:], j, side="right"),
                           NG - 1)
            return perm[st[a] + j - off[a]]

        def ch(c, j, raw=int(off[-1])):
            ok = j < raw
            x = np.where(ok, x_of(np.where(ok, j, 0)), 0)
            if c < 5:
                return rows[FIELDS[c]][x]
            return hi32(rows["m"][x]) * span + base + x

        lost, hi = _slots(send, filled, b, int(off[-1]), CAP, ch)
        np.add.at(xo, x_of(lost) // OB, 1)
        written += min(hi, CAP)
    return written


def pack2_mirror(send, filled, rows, perm, starts, counts, S, shard, H_loc,
                 OB, G, NG, hist):
    """K13's phase 2 into the kept buffers `send` [NG-1, 6, CAP2] with
    their fill words; `rows` the phase-1 arrivals' channels with their
    keys, flat. Returns the slots written."""
    CAP2 = send.shape[-1]
    span = S * H_loc * OB
    my_g, my_b = divmod(shard, G)
    written = 0
    for i, a in enumerate(x for x in range(NG) if x != my_g):
        st, raw = segment(starts, counts, S, H_loc, a * G + my_b)

        def ch(c, j, st=st, raw=raw):
            ok = j < raw
            x = perm[np.where(ok, st + j, 0)]
            return rows[FIELDS[c] if c < 5 else "key"][x]

        lost, hi = _slots(send, filled, i, raw, CAP2, ch)
        np.add.at(hist, (rows["key"][perm[st + lost]] % span) // OB, 1)
        written += min(hi, CAP2)
    for d in range(S):
        if d == shard or d % G == my_b:
            continue
        st, n = segment(starts, counts, S, H_loc, d)
        j = np.arange(CAP2, max(CAP2, n))
        np.add.at(hist, (rows["key"][perm[st + j]] % span) // OB, 1)
    return written


_PHASES = []


def pack_phases():
    """PACK_PHASES judged outboxes of successive phases of a one-device
    PHOLD run (the port's plain path; each outbox as K5 routes it), an
    empty one (every t INF) at EMPTY_AT; computed once."""
    if not _PHASES:
        from shadow_tpu_torch.device import kernels as K
        from shadow_tpu_torch.device import runner

        class Capture(K.Kernels):
            def route(k, ob, out=None, ctl=None):
                if len(_PHASES) < PACK_PHASES:
                    if len(_PHASES) == EMPTY_AT:
                        _PHASES.append({f: torch.full_like(ob[f], INF)
                                        if f == "t" else
                                        torch.zeros_like(ob[f])
                                        for f in FIELDS})
                    _PHASES.append({f: ob[f].clone() for f in FIELDS})
                return K.Kernels.route(k, ob, out, ctl)

        stats = runner.run(_cfg(PHOLD), device="cpu", kernels=Capture())
        assert stats.ok and len(_PHASES) == PACK_PHASES
    return _PHASES


def _np(x: dict) -> dict:
    return {k: v.numpy() for k, v in x.items()}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("caps", ["auto", "overflowing"])
def test_kept_buffers_equal_fresh_plain_buffers_after_every_pack(S, caps):
    """Rank 0 of a mesh of S ranks (its rows: hosts [0, H/S) of a
    one-device PHOLD run) packs both halves of each successive phase
    into buffers kept from phase to phase (garbage when allocated, the
    fill words at the capacity), rank 1 of its group its phase-1 rows
    too, rank 0's arrivals its buffers and its own: after every pack
    each kept buffer equals the plain version's fresh one, and
    x_overflow, occ_x and hist equal; the fills grow, fall to 0 at the
    empty phase and come back; at the small capacities rows overflow
    both halves."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.capacity import exchange_caps, group_split

    phases = pack_phases()
    H, OB = phases[0]["t"].shape
    H_loc = H // S
    g, ng = group_split(S)
    cap, cap2, _, _ = exchange_caps(
        "two_phase", S, H_loc, OB, 64,
        *((0, 0) if caps == "auto" else (5, 3)))
    ranks = [K.MeshParams(S, r, H_loc, "two_phase", cap, cap2, g, ng)
             for r in range(g)]
    rng = np.random.default_rng(S)
    kept1 = [rng.integers(-2**63, 2**63 - 1, (g, 6, cap), dtype=np.int64)
             for _ in ranks]
    fill1 = [np.full(g, cap, np.int64) for _ in ranks]
    kept2 = rng.integers(-2**63, 2**63 - 1, (ng - 1, 6, cap2),
                         dtype=np.int64)
    fill2 = np.full(ng - 1, cap2, np.int64)
    seen = {"lost1": 0, "lost2": 0, "fills": []}
    for ob in phases:
        sends = []
        for r, mp in enumerate(ranks):
            ob_r = {f: ob[f][r * H_loc:(r + 1) * H_loc] for f in FIELDS}
            perm, starts, counts = K.route_rows_plain(K.Rows(ob_r), 0,
                                                      mp.H_pad)
            fresh = torch.empty((g, 6, cap), dtype=torch.int64)
            st = {"x_overflow": torch.zeros(H_loc, dtype=torch.int32),
                  "occ_x": torch.zeros((1, S), dtype=torch.int32)}
            K.pack_two_phase_plain(st, ob_r, perm, starts, counts, mp,
                                   fresh)
            xo = np.zeros(H_loc, np.int64)
            occ = np.zeros(S, np.int64)
            flat = {f: ob_r[f].reshape(-1).numpy() for f in FIELDS}
            pack1_mirror(kept1[r], fill1[r], flat, perm.numpy(),
                         starts.numpy(), counts.numpy(), S, r, H_loc, OB,
                         g, ng, xo, occ)
            np.testing.assert_array_equal(kept1[r], fresh.numpy())
            np.testing.assert_array_equal(xo, st["x_overflow"].numpy())
            np.testing.assert_array_equal(occ, st["occ_x"].numpy()[0])
            if r == 0:
                seen["lost1"] += int(xo.sum())
                seen["fills"].append(fill1[0].tolist())
            sends.append(fresh)
        recv1 = torch.stack([s[0] for s in sends])
        rows1 = K.Rows(recv1)
        perm, starts, counts = K.route_rows_plain(rows1, 0, S * H_loc, True)
        fresh2 = torch.empty((ng - 1, 6, cap2), dtype=torch.int64)
        hist = torch.zeros(S * H_loc, dtype=torch.int32)
        K.pack_two_phase2_plain(rows1, perm, starts, counts, ranks[0], OB,
                                fresh2, hist)
        hist_m = np.zeros(S * H_loc, np.int64)
        pack2_mirror(kept2, fill2, _np(rows1.fields()), perm.numpy(),
                     starts.numpy(), counts.numpy(), S, 0, H_loc, OB, g,
                     ng, hist_m)
        np.testing.assert_array_equal(kept2, fresh2.numpy())
        np.testing.assert_array_equal(hist_m, hist.numpy())
        seen["lost2"] += int(hist_m.sum())
    fills = [sum(f) for f in seen["fills"]]
    assert fills[EMPTY_AT] == 0 and fills[EMPTY_AT + 1] > 0
    if caps == "overflowing":
        assert max(fills) == g * cap
        assert seen["lost1"] > 0 and seen["lost2"] > 0
    else:
        assert len(set(fills)) > 3
        assert seen["lost1"] == 0 and seen["lost2"] == 0


def test_a_pack_over_more_rows_than_it_kept_writes_no_fill():
    """Where this pack's rows reach past the last pack's fill, the
    mirror writes rows alone: [0, n) and no fill slot; where they fall
    short, the fills of [n, n_prev) alone; slots past both stay as they
    were."""
    cap = 10
    send = np.full((1, 6, cap), 7, np.int64)
    filled = np.array([4])

    def ch(c, j):
        return np.full(len(j), 100 + c, np.int64)

    _slots(send, filled, 0, 6, cap, ch)
    assert (send[0, :, :6] == (100 + np.arange(6))[:, None]).all()
    assert (send[0, :, 6:] == 7).all() and filled[0] == 6
    _slots(send, filled, 0, 2, cap, ch)
    assert (send[0, :, 2:6] == np.array(FILLS)[:, None]).all()
    assert (send[0, :, 6:] == 7).all() and filled[0] == 2
    lost, _ = _slots(send, filled, 0, 13, cap, ch)
    assert lost.tolist() == [10, 11, 12] and filled[0] == cap


# ----------------------------------------------------------------------
# against JAX
# ----------------------------------------------------------------------
def test_the_nic_run_path_counters_equal_jax(reference):
    """The watched NIC PHOLD run's path counters and rounds equal the
    JAX engine's (last in the file, so that the tests above run while
    the child computes)."""
    _, leaves, rounds = watched_run("nic_phold")
    assert rounds == int(reference["nic_phold/rounds"])
    np.testing.assert_array_equal(
        leaves["path_cnt"].reshape(-1),
        reference["nic_phold/path_cnt"].reshape(-1))
    assert leaves["path_cnt"].sum() > 0


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
    for key, yaml in job.items():
        c = Controller(load_config_str(yaml))
        eng = c.runner.engine
        state, rounds = eng.run(eng.init_state(c.sim.starts))
        out[f"{key}/path_cnt"] = np.asarray(jax.device_get(
            state["path_cnt"]))
        out[f"{key}/rounds"] = np.int64(rounds)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
