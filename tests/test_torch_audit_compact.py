"""K8 audit_round and K11 compact_outbox as csrc/audit_round.cu and
csrc/compact_outbox.cu compute them, on the CPU.

Numpy mirrors of the two kernels, used by nothing else:

* `audit_mirror`: the tiled audit. Tiles of TILE consecutive hosts, a
  block's tiles grid-strided; a tile's counters a thread a host; its heap
  rows one flat span read W words a load (W = 2 where E is even), a
  word's row by the kernel's reciprocal, each word compared with its
  right neighbour inside its row only (the next load's first word: a
  shuffle, or the warp's last lane's own load), keys read only by loads
  with a tied word (and the next lane's first key a shuffle, which the
  mirror checks that lane loaded), the live count against the tile's
  heads; one balance partial a block, the last block of a shuffled order
  of tickets (`last_block`) broadcasting AUD_CONSERVE.
* `compact_mirror`: the compaction of the popped hosts' rows. A warp's
  WARP_HOSTS hosts, those with a nonzero pop count (every host under
  the outbox word) read HOSTS rows at a time, KPL columns a lane (a warp
  a host past 256 columns); a row with more than CX live rows ranked
  from its lanes' keys, the live keys broadcast two a step in column
  order,
  (hi32(m), column) under the window rule (m read once per live column)
  and (t, column) under the global rule.

Both are held equal to `audit_round_plain` and `compact_plain` at every
launch of audited and compacted runs of the port's plain path (PHOLD,
tgen with OB = 36, a cut Tor with OB = 45, both rules, and an R = 3
campaign of which replicas finish at different rounds), on five
corruptions of a paused state, a ledger off by one, synthetic heaps
(odd and even E, ties, swaps, heads out of range, negative counters)
and synthetic outboxes (OB 16 to 300, CX 4 and 16, the word set and
clear, garbage under the word), and a flush of rows from outside. The
runs' final leaves and rounds equal the JAX engine's (a child process,
this file's __main__ branch, which applies the jax batching patch the
reference needs; never in the pytest process). Tolerance: exact
equality.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_torch_audit import CORRUPTIONS, PAUSE, STOP, corrupt, text
from test_torch_outbox import PHOLD, TGEN, TOR
from test_torch_tally import last_block

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 1 << 62
DROP_T = INF - 1
IMAX = (1 << 63) - 1
AUD_HEAP, AUD_COUNTER, AUD_CONSERVE = 1, 4, 8
COUNTERS = ("n_exec", "n_sent", "n_drop", "n_deliv", "event_seq",
            "packet_seq", "app_seq")

# csrc/audit_round.cu: hosts a tile, the grid's cap, the reciprocal's
# shift; csrc/compact_outbox.cu: a warp's hosts, the loads a lane keeps
# in flight
TILE = 256
MAX_TILE_BLOCKS = 32768
RECIP_SHIFT = 40
WARP_HOSTS = 4
IN_FLIGHT = 4

AUDIT = ["experimental.state_audit=true"]
TGEN36 = TGEN.replace("outbox_capacity: 256", "outbox_capacity: 40")
CONFIGS = {"phold": PHOLD, "tgen": TGEN36, "tor": TOR}
CAMPAIGN = PHOLD.replace("stop_time: 2s", "stop_time: 1s") + (
    "ensemble: {replicas: 3, vary: {latency_scale: [1.0, 2.0, 3.0]}}\n")


def compact(cx, rule="window"):
    return [f"experimental.outbox_compact={cx}",
            f"experimental.merge_strategy={rule}"]


# key -> (config, overrides): audited runs whose rows overflow at the
# compaction (each config's largest occ_ob is 3 or more), watched and
# held against JAX
RUNS = {
    "phold_window": ("phold", AUDIT + compact(2)),
    "phold_global": ("phold", AUDIT + compact(2, "global")),
    "tgen_window": ("tgen", AUDIT + compact(2)),
    "tgen_global": ("tgen", AUDIT + compact(2, "global")),
    "tor_window": ("tor", AUDIT + compact(2)),
}


# ----------------------------------------------------------------------
# the K8 mirror
# ----------------------------------------------------------------------
def recip(E: int) -> int:
    return ((1 << RECIP_SHIFT) + E - 1) // E


def row_of(w: np.ndarray, E: int) -> np.ndarray:
    """A word's row in its tile's span, as the kernel computes it."""
    return ((w.astype(np.uint64) * np.uint64(recip(E)))
            >> np.uint64(RECIP_SHIFT)).astype(np.int64)


def span_mirror(t, k, hd, E: int, W: int):
    """One tile's heap span (t, k: nh * E words; hd: the tile's heads),
    W words a load: ([nh] bool, a row out of (t, key) order; the live
    words; the span positions whose keys were read)."""
    n = len(t)
    q = np.arange(n // W)
    w = q * W
    row = row_of(w, E)
    assert (row == w // E).all()
    slot = w - row * E
    lane = q % 32
    cols = w[:, None] + np.arange(W)
    v = t[cols]
    in_row = slot + W < E
    right = np.minimum(w + W, n - 1)
    nx = np.where(in_row, t[right], INF)
    # a lane's right neighbour is the next lane's first word
    inner = in_row & (lane < 31)
    assert (nx[:-1][inner[:-1]] == v[1:, 0][inner[:-1]]).all()
    tie = np.zeros((len(q), W), bool)
    tie[:, :W - 1] = v[:, :-1] == v[:, 1:]
    tie[:, W - 1] = in_row & (v[:, W - 1] == nx)
    prev = np.r_[INF, v[:-1, W - 1]]
    left = (lane > 0) & (slot > 0) & (prev == v[:, 0])
    loads = left | tie.any(1)
    # the next lane loaded its keys wherever this one ties out to it
    assert loads[1:][tie[:-1, W - 1] & (lane[:-1] < 31)].all()
    kv = np.where(loads[:, None], k[cols], 0)
    kn = np.where(tie[:, W - 1], k[right], 0)
    ok = np.ones(len(q), bool)
    for j in range(W):
        last = j == W - 1
        tr = nx if last else v[:, j + 1]
        kr = kn if last else kv[:, j + 1]
        okj = (v[:, j] < tr) | (tie[:, j] & (kv[:, j] <= kr))
        ok &= okj | (~in_row if last else False)
    bad = np.zeros(len(hd), bool)
    bad[row[~ok]] = True
    live = int(((slot[:, None] + np.arange(W) >= hd[row][:, None])
                & (v < INF)).sum())
    read = np.r_[cols[loads].ravel(), right[(lane == 31) & tie[:, W - 1]]]
    return bad, live, read


def tied_slots(t: np.ndarray, E: int) -> np.ndarray:
    """[n] bool: the words of a flat span of rows of E that tie with a
    neighbour in their row."""
    same = (t[:-1] == t[1:]) & ((np.arange(len(t) - 1) + 1) % E != 0)
    return np.r_[same, False] | np.r_[False, same]


def audit_mirror(leaves: dict, rng, W: int = 0):
    """One K8 launch on a replica's leaves (numpy, copied): the new
    `aud` and the launch's counts (tiles, blocks, keys read, balance).
    W: words a load (0: the kernel's choice, 2 where E is even)."""
    ht, hk, head = leaves["ht"], leaves["hk"], leaves["head"]
    H, E = ht.shape
    W = W or (2 if E % 2 == 0 else 1)
    assert W == 1 or E % 2 == 0
    tiles = -(-H // TILE)
    nb = max(1, min(tiles, MAX_TILE_BLOCKS))
    partial = np.zeros(nb, np.int64)
    aud = leaves["aud"].copy()
    tf, kf = ht.reshape(-1), hk.reshape(-1)
    keys = 0
    for tile in range(tiles):
        h0 = tile * TILE
        hs = slice(h0, min(H, h0 + TILE))
        hd = head[hs].astype(np.int64)
        word = np.where((hd < 0) | (hd > E), AUD_HEAP, 0)
        neg = np.zeros(len(hd), bool)
        for key in COUNTERS:
            neg |= leaves[key][hs] < 0
        word |= np.where(neg, AUD_COUNTER, 0)
        acc = (leaves["aud_tx"][hs].sum()
               - leaves["n_exec"][hs].astype(np.int64).sum()
               - leaves["overflow"][hs].astype(np.int64).sum()
               - leaves["x_overflow"][hs].astype(np.int64).sum())
        span = slice(h0 * E, hs.stop * E)
        bad, live, read = span_mirror(tf[span], kf[span], hd, E, W)
        # keys read only by loads with a tied word
        tied = tied_slots(tf[span], E)
        first = (read // W) * W
        assert (tied[read] | tied[first] | tied[first + W - 1]).all()
        keys += len(read)
        aud[hs] |= (word | np.where(bad, AUD_HEAP, 0)).astype(np.int32)
        partial[tile % nb] += acc - live
    last_block(nb, rng.permutation(nb))
    balance = int(partial.sum())
    if balance != 0:
        aud |= AUD_CONSERVE
    return aud, {"tiles": tiles, "blocks": nb, "keys": keys,
                 "balance": balance}


# ----------------------------------------------------------------------
# the K11 mirror
# ----------------------------------------------------------------------
def kpl_of(OB: int) -> int:
    """Columns a lane of the kernel instantiated for OB (0: the wide
    kernel, a row at a time from shared memory)."""
    need = -(-OB // 32)
    return next((k for k in (1, 2, 4, 8) if need <= k), 0)


def compact_mirror(t, m, x_overflow, pops, every: bool, cx: int,
                   global_rule: bool):
    """One K11 launch on a replica (numpy, copied): (new t, new
    x_overflow, [H] bool of the hosts whose rows were read, m words
    read, rows ranked). A warp's WARP_HOSTS hosts, their rows HOSTS at a
    time (a warp a host in the wide kernel)."""
    H, OB = t.shape
    kpl = kpl_of(OB)
    width = 32 * kpl if kpl else -(-OB // 32) * 32
    per_warp = WARP_HOSTS if kpl else 1
    hosts = max(1, IN_FLIGHT // kpl) if kpl else 1
    t, xo = t.copy(), x_overflow.copy()
    read = np.zeros(H, bool)
    m_reads = ranked = 0
    for h0 in range(0, H, per_warp):
        need = [j for j in range(per_warp) if h0 + j < H
                and (every or pops[h0 + j] != 0)]
        for s0 in range(0, len(need), hosts):
            for j in need[s0:s0 + hosts]:
                g = h0 + j
                read[g] = True
                row = np.full(width, INF, np.int64)
                row[:OB] = t[g]
                lv = row < DROP_T
                n = int(lv.sum())
                if n <= cx:
                    continue
                ranked += 1
                if global_rule:
                    key = np.where(lv, row, IMAX)
                else:
                    dst = np.zeros(width, np.int64)
                    dst[:OB] = (m[g] >> 32).astype(np.int32)
                    key = np.where(lv, dst, IMAX)
                    m_reads += n
                # lane l holds columns 32 i + l: keys[i, l]; the live
                # keys broadcast two a step, in column order
                keys = key.reshape(-1, 32)
                live = lv.reshape(-1, 32)
                i_of, l_of = np.indices(keys.shape)
                rank = np.zeros(keys.shape, np.int64)
                for i2 in range(keys.shape[0]):
                    lanes = np.flatnonzero(live[i2])
                    for step in range(0, len(lanes), 2):
                        for s in lanes[step:step + 2]:
                            k2 = keys[i2, s]
                            rank += (k2 < keys) | ((k2 == keys) & (
                                (i2 < i_of) | ((i2 == i_of) & (s < l_of))))
                drop = (live & (rank >= cx)).reshape(-1)[:OB]
                t[g, drop] = INF
                xo[g] += n - cx
    return t, xo, read, m_reads, ranked


# ----------------------------------------------------------------------
# the engine's audits and compactions, watched
# ----------------------------------------------------------------------
def _np(d: dict) -> dict:
    return {k: v.numpy().copy() for k, v in d.items()}


class Watch:
    """Kernels whose K8 and K11 check the mirrors around the plain
    versions, replica by replica."""

    def __init__(self, seed: int = 0):
        from shadow_tpu_torch.device import kernels as K

        watch = self

        class Watched(K.Kernels):
            def audit_round(k, state, ctl=None):
                watch.audit(k, state, ctl)

            def compact_outbox(k, state, ob, p, ctl=None, pops=None,
                               outside=None):
                watch.compact(k, state, ob, p, ctl, pops, outside)

        self.kernels = Watched()
        self.rng = np.random.default_rng(seed)
        self.n = dict.fromkeys(
            ("audits", "audits_stopped", "conserve", "heap_bits",
             "counter_bits", "keys", "compactions", "compact_stopped",
             "given_pops", "under_word", "hosts_read", "hosts_skipped",
             "ranked", "m_reads", "from_outside"), 0)

    @staticmethod
    def _views(d: dict, R):
        from shadow_tpu_torch.device import kernels as K

        return [d] if R is None else [K.at_replica(d, r) for r in range(R)]

    def audit(self, k, state, ctl):
        from shadow_tpu_torch.device import kernels as K

        R = K.n_replicas(state)
        views = self._views(state, R)
        ctls = [ctl] if R is None else [K._ctl_at(ctl, r)
                                        for r in range(R)]
        want = []
        for s, c in zip(views, ctls):
            leaves = _np(s)
            if c is not None and not int(c[K.CTL["round_end"]]):
                want.append((leaves["aud"], None))
                continue
            aud, n = audit_mirror(leaves, self.rng)
            if leaves["ht"].shape[1] % 2 == 0:
                # the one-word loads give the same words
                aud1, _ = audit_mirror(leaves, self.rng, W=1)
                np.testing.assert_array_equal(aud1, aud)
            want.append((aud, n))
        K.Kernels.audit_round(k, state, ctl)
        for s, (aud, n) in zip(views, want):
            np.testing.assert_array_equal(s["aud"].numpy(), aud)
            if n is None:
                self.n["audits_stopped"] += 1
                continue
            self.n["audits"] += 1
            self.n["keys"] += n["keys"]
            self.n["conserve"] += int(n["balance"] != 0)
            self.n["heap_bits"] += int((aud & AUD_HEAP).any())
            self.n["counter_bits"] += int((aud & AUD_COUNTER).any())

    def compact(self, k, state, ob, p, ctl, pops, outside):
        from shadow_tpu_torch.device import kernels as K

        R = K.ob_replicas(ob)
        views = self._views(state, R)
        obs = self._views(ob, R)
        ctls = [ctl] if R is None else [K._ctl_at(ctl, r)
                                        for r in range(R)]
        self.n["given_pops"] += int(pops is not None)
        want = []
        for r, (s, o, c) in enumerate(zip(views, obs, ctls)):
            t, xo = o["t"].numpy().copy(), s["x_overflow"].numpy().copy()
            if K._phase_off(c):
                want.append((t, xo, None))
                continue
            every = outside is None or bool(int(outside[0, r]))
            n = (pops if R is None else pops[r]).numpy()
            live = t < DROP_T
            if not every:
                # the rule: a host that popped nothing holds no
                # exchangeable row
                assert not live[n == 0].any()
            elif live[n == 0].any():
                self.n["from_outside"] += 1
            got = compact_mirror(t, o["m"].numpy(), xo, n, every, p.CX,
                                 p.CXG)
            want.append(got)
            self.n["under_word"] += int(every)
        K.Kernels.compact_outbox(k, state, ob, p, ctl, pops, outside)
        for s, o, got in zip(views, obs, want):
            np.testing.assert_array_equal(o["t"].numpy(), got[0])
            np.testing.assert_array_equal(s["x_overflow"].numpy(), got[1])
            if got[2] is None:
                self.n["compact_stopped"] += 1
                continue
            read = got[2]
            self.n["compactions"] += 1
            self.n["hosts_read"] += int(read.sum())
            self.n["hosts_skipped"] += int((~read).sum())
            self.n["m_reads"] += got[3]
            self.n["ranked"] += got[4]


def _cfg(name, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(CONFIGS[name], list(overrides))


_RUNS = {}


def watched_run(key):
    """(Watch, final leaves, rounds, phases) of a RUNS entry on the CPU
    plain path (the Python loop) with the watched kernels, computed
    once."""
    if key not in _RUNS:
        from shadow_tpu_torch.device import runner
        from shadow_tpu_torch.device.engine import state_to_numpy

        watch = Watch(len(_RUNS))
        name, ovr = RUNS[key]
        engine, sim = runner.make_engine(_cfg(name, ovr), device="cpu",
                                         kernels=watch.kernels)
        state, rounds = engine.run(
            engine.init_state(sim.start_times, sim.stop_times))
        _RUNS[key] = (watch, state_to_numpy(state), rounds,
                      engine.loop_stats["phases"], engine.params)
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
    with tempfile.TemporaryDirectory(prefix="torch_audcx_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


# ----------------------------------------------------------------------
# the tests: runs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", list(RUNS))
def test_every_round_end_audit_equals_the_mirror(key):
    """Every round-end K8 of an audited, compacted run: the tiled mirror
    (both load widths) equals `audit_round_plain` word for word; the
    health words stay 0 on the sound run."""
    watch, leaves, rounds, phases, p = watched_run(key)
    n = watch.n
    assert n["audits"] == rounds > 10
    assert n["keys"] > 0
    assert n["conserve"] == n["heap_bits"] == n["counter_bits"] == 0
    assert not leaves["aud"].any()


@pytest.mark.parametrize("key", list(RUNS))
def test_every_compaction_reads_the_popped_rows_and_equals_the_mirror(
        key):
    """Every K11 of the run is given the pop counts and the outbox word,
    which is clear (the pop clears it); no host that popped nothing
    holds an exchangeable row, the mirror reads only the popped hosts'
    rows, ranks the overflowing ones from their lanes' keys and equals
    `compact_plain` on t and x_overflow."""
    watch, leaves, rounds, phases, p = watched_run(key)
    n = watch.n
    assert p.CX == 2 and p.OB == {"phold": 16, "tgen": 36,
                                  "tor": 45}[RUNS[key][0]]
    assert n["compactions"] == n["given_pops"] == phases > 10
    assert n["under_word"] == 0
    assert n["hosts_skipped"] > 0 and n["hosts_read"] > 0
    assert n["ranked"] > 0 and leaves["x_overflow"].sum() > 0
    assert (n["m_reads"] > 0) == key.endswith("window")


def test_a_three_replica_campaign_keeps_both_mirrors(tmp_path, monkeypatch):
    """R = 3, audited and compacted (window rule, CX 2), replicas whose
    windows differ finishing at different rounds: every running
    replica's K8 and K11 equal the mirrors, a stopped replica keeps
    every byte."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    watch = Watch(9)
    er = EnsembleRunner(load_config_str(CAMPAIGN, AUDIT + compact(2)),
                        device="cpu", kernels=watch.kernels)
    engine = er.engine()
    state = engine.init_ensemble_state(er.sim.start_times,
                                       er.sim.stop_times)
    state, rounds = engine.run(state)
    n = watch.n
    assert len(set(rounds)) > 1
    assert n["audits"] == sum(rounds)
    assert n["compact_stopped"] > 0 and n["audits_stopped"] > 0
    assert n["compactions"] > 20 and n["ranked"] > 0
    assert n["hosts_skipped"] > 0
    assert not state["aud"].any()


def _busy_paused():
    """(engine, numpy leaves) of the audited busy PHOLD paused at
    PAUSE on the CPU plain path."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import state_to_numpy

    engine, sim = runner.make_engine(load_config_str(text("busy"), AUDIT),
                                     device="cpu")
    state = engine.init_state(sim.start_times, sim.stop_times)
    engine.run(state, stop=PAUSE, final_stop=STOP)
    return engine, state_to_numpy(state)


@pytest.fixture(scope="module")
def busy_paused():
    return _busy_paused()


# the bits K8 itself sets on each corruption of the paused state (the
# clock corruption trips the pops' clock lane, not K8)
K8_BITS = {"counter": AUD_COUNTER, "heap_swap": AUD_HEAP,
           "head": AUD_HEAP | AUD_CONSERVE, "clock": 0,
           "lost_row": AUD_CONSERVE}


@pytest.mark.parametrize("corruption", CORRUPTIONS)
def test_each_corruption_sets_the_mirror_words(corruption, busy_paused):
    """Each of the five corruptions of the paused audited state: K8's
    mirror (both load widths) on the corrupt state equals
    `audit_round_plain` and sets the bits that corruption trips in K8;
    run on to STOP with the watched kernels, every round-end audit of
    the corrupt run equals the mirror too, and the run ends with a
    health word set."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.engine import state_from_numpy

    engine, arrays = busy_paused
    bad = corrupt(corruption, arrays)
    rng = np.random.default_rng(len(corruption))
    state = state_from_numpy(bad, "cpu")
    K.audit_round_plain(state)
    for W in (1, 2):
        aud, _ = audit_mirror(bad, rng, W)
        np.testing.assert_array_equal(aud, state["aud"].numpy())
    word = int(np.bitwise_or.reduce(state["aud"].numpy()))
    assert word & (AUD_HEAP | AUD_COUNTER | AUD_CONSERVE) == \
        K8_BITS[corruption]
    watch = Watch(5)
    engine.kernels = watch.kernels
    try:
        final, _ = engine.run(state_from_numpy(bad, "cpu"), stop=STOP,
                              final_stop=STOP)
    finally:
        engine.kernels = K.Kernels()
    assert watch.n["audits"] > 10
    assert final["aud"].any()


def test_a_flush_of_rows_from_outside_compacts_every_row():
    """`flush` of rows copied into the buffer, pop counts 0, on a
    compacted engine paused half way: K11 is given the word set, the
    mirror reads every host's row (a read by the pop counts alone would
    skip rows that overflow) and equals `compact_plain`; the next
    phase's pop clears the word before its compaction."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.kernels import control_block

    watch = Watch(3)
    engine, sim = runner.make_engine(
        _cfg("phold", compact(2, "global")), device="cpu",
        kernels=watch.kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    engine.run(state, stop=500_000_000,
               final_stop=int(engine.config.stop_time))
    ob, pops, _ = engine._buffers()
    nt = engine.next_time(state)
    assert nt < INF
    ctl = control_block("cpu", run=1,
                        win_end=nt + int(engine.config.lookahead))
    engine.kernels.pop(state, ob, pops, engine.world, ctl, engine.params)
    pops.zero_()
    n0 = dict(watch.n)
    engine.flush(state, ctl)
    assert watch.n["under_word"] == n0["under_word"] + 1
    assert watch.n["from_outside"] == n0["from_outside"] + 1
    assert watch.n["hosts_skipped"] == n0["hosts_skipped"]
    engine.phase(state, control_block(
        "cpu", run=1, win_end=engine.next_time(state) + 1))
    assert watch.n["under_word"] == n0["under_word"] + 1
    assert watch.n["hosts_skipped"] > n0["hosts_skipped"]


# ----------------------------------------------------------------------
# the tests: synthetic launches
# ----------------------------------------------------------------------
def audit_leaves(rng, H: int, E: int) -> dict:
    """Sorted heaps with INF tails (keys IMAX), a twentieth of the hosts
    with their first two times tied (keys either way), a hundredth with
    two live rows swapped; heads past E and below 0; a counter negative
    at a thousandth of the hosts; aud_tx balancing the ledger."""
    slot = np.arange(E)[None, :]
    n_live = rng.integers(0, E + 1, H)
    ht = np.sort(rng.integers(0, 2 * 10**9, (H, E)), axis=1)
    if E > 1:
        tie = rng.random(H) < 0.05
        ht[tie, 1] = ht[tie, 0]
        swap = np.flatnonzero((rng.random(H) < 0.01) & (n_live >= 2))
        ht[swap, 0], ht[swap, 1] = ht[swap, 1], ht[swap, 0]
    live = slot < n_live[:, None]
    ht = np.where(live, ht, INF)
    hk = np.where(live, rng.integers(0, 2**62, (H, E)), IMAX)
    head = np.minimum(rng.integers(0, 4, H), n_live)
    head[rng.random(H) < 0.01] = E + 1
    head[rng.random(H) < 0.005] = -1
    leaves = {k: rng.integers(0, 2**20, H).astype(np.int32)
              for k in COUNTERS + ("overflow", "x_overflow")}
    for k in COUNTERS:
        leaves[k][rng.random(H) < 0.003] = -1
    after = ((slot >= head[:, None]) & (ht < INF)).sum(-1)
    aud_tx = (leaves["n_exec"].astype(np.int64) + after
              + leaves["overflow"] + leaves["x_overflow"])
    return {"ht": ht.astype(np.int64), "hk": hk.astype(np.int64),
            "head": head.astype(np.int32), "aud_tx": aud_tx,
            "aud": rng.choice(np.array([0, 0, 0, 2], np.int32), H),
            **leaves}


def _plain_audit(leaves: dict) -> np.ndarray:
    from shadow_tpu_torch.device import kernels as K

    state = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    K.audit_round_plain(state)
    return state["aud"].numpy()


@pytest.mark.parametrize("H,E", [(1, 1), (300, 7), (300, 64),
                                 (5_000, 33), (70_000, 16)])
def test_the_tiled_audit_equals_the_plain_audit(H, E):
    """`audit_mirror` on synthetic heaps (odd E: one word a load; even
    E: both widths), the ledger balanced and off by one (AUD_CONSERVE
    on every host, from the last block of a shuffled ticket order; at
    70,000 hosts 274 blocks, two-level tickets), equals
    `audit_round_plain`; the heap and counter bits are set."""
    rng = np.random.default_rng(H * 100 + E)
    leaves = audit_leaves(rng, H, E)
    off = dict(leaves, aud_tx=leaves["aud_tx"].copy())
    off["aud_tx"][H // 2] += 1
    for case in (leaves, off):
        want = _plain_audit(case)
        for W in ((1, 2) if E % 2 == 0 else (1,)):
            aud, n = audit_mirror(case, rng, W)
            np.testing.assert_array_equal(aud, want)
        assert (n["balance"] != 0) == (case is off)
        assert bool((want & AUD_CONSERVE).all()) == (case is off)
    assert n["blocks"] == -(-H // TILE)
    if H >= 300:
        assert (want & AUD_HEAP).any() and (want & AUD_COUNTER).any()


def test_the_row_reciprocal_is_exact_over_a_tile():
    """A word's row, (w * ceil(2^40 / E)) >> 40, is w // E for every
    word of a tile's span, up to E = 65,535."""
    for E in (1, 2, 3, 7, 48, 64, 96, 192, 1000, 4097, 65_521, 65_535):
        n = TILE * E
        w = np.unique(np.r_[np.arange(min(n, 5000)),
                            np.arange(max(0, n - 5000), n),
                            np.arange(0, n, E), np.arange(E - 1, n, E)])
        np.testing.assert_array_equal(row_of(w, E), w // E)


def judged_outbox(rng, H: int, OB: int, pops, rule_outbox: bool):
    """A judged outbox [H, OB]: each row 0 to OB live rows at random
    columns, times from 64 values (ties), every twentieth live row a
    DROP_T marker, destinations from 64 hosts (ties), the rest INF; with
    `rule_outbox` only the hosts with a nonzero pop count hold rows
    below INF. Returns (t, m)."""
    n_live = rng.integers(0, OB + 1, H)
    if rule_outbox:
        n_live = np.where(pops != 0, n_live, 0)
    live = np.argsort(rng.random((H, OB)), axis=1) < n_live[:, None]
    t = rng.integers(10**9, 10**9 + 64, (H, OB))
    t = np.where(rng.random((H, OB)) < 0.05, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    m = (rng.integers(-32, 32, (H, OB)).astype(np.int64) << 32) | \
        (2 | (1 << 8))
    return t, m


@pytest.mark.parametrize("OB", [16, 30, 36, 64, 100, 256, 300])
@pytest.mark.parametrize("global_rule", [False, True])
def test_the_compaction_of_popped_rows_equals_the_plain_compaction(
        OB, global_rule):
    """`compact_mirror` at CX 4 and 16 under the rule (only the popped
    hosts' rows hold live rows, the word clear: only they are read),
    under the word (every row read, rows live at hosts that popped
    nothing) and on garbage under the word, equals `compact_plain` on t
    and x_overflow; every instantiation of the kernel (1, 2, 4 and 8
    columns a lane, and the wide kernel past 256) ranks overflowing
    rows."""
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(OB * 2 + global_rule)
    H = 200
    pops = np.where(rng.random(H) < 0.5, rng.integers(1, 9, H), 0)
    pops = pops.astype(np.int32)
    xo0 = rng.integers(0, 1000, H).astype(np.int32)
    garbage = rng.integers(-2**63, 2**63 - 1, (H, OB), dtype=np.int64)
    garbage[rng.random((H, OB)) < 0.2] = DROP_T
    cases = {"rule": (*judged_outbox(rng, H, OB, pops, True), False),
             "word": (*judged_outbox(rng, H, OB, pops, False), True),
             "garbage": (garbage, rng.integers(-2**63, 2**63 - 1, (H, OB),
                                               dtype=np.int64), True)}
    for cx in (4, 16):
        for case, (t, m, every) in cases.items():
            ft = torch.from_numpy(t.copy())
            state = {"x_overflow": torch.from_numpy(xo0.copy())}
            K.compact_plain(state, {"t": ft, "m": torch.from_numpy(m)},
                            cx, global_rule)
            got = compact_mirror(t, m, xo0, pops, every, cx, global_rule)
            np.testing.assert_array_equal(got[0], ft.numpy(), err_msg=case)
            np.testing.assert_array_equal(got[1],
                                          state["x_overflow"].numpy(),
                                          err_msg=case)
            assert got[4] > 0 or cx == OB, case
            read = got[2]
            assert read.all() if every else \
                (read == (pops != 0)).all(), case


@pytest.mark.parametrize("key", list(RUNS))
def test_the_audited_compacted_run_equals_jax(key, reference):
    """The run's final leaves (aud, aud_tx, x_overflow and every other)
    and rounds equal the JAX engine's (last in the file, so that the
    tests above run while the child computes)."""
    _, leaves, rounds, _, _ = watched_run(key)
    assert rounds == int(reference[f"{key}/rounds"])
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, reference[f"{key}/{k}"],
                                      err_msg=f"{key}: leaf {k}")


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
