"""K9 loop_control and phase_tally as csrc/loop_control.cu and
csrc/phase_tally.cu compute them, on the CPU.

The tally's skip rule: at tally time, with the engine's outbox word
clear (the pop clears it; a flush of rows copied in leaves it set), a
host whose pop count is 0 holds no exchangeable row (t < DROP_T), so the
kernel reads the rows of the hosts that popped alone, or every host's
row under the word. Watched at every tally of runs of the port's plain
path, in both window loops: PHOLD, tgen with bursts, a cut Tor, the
model NIC, the path counters (DROP_T rows), `outbox_compact` under both
rules, audited PHOLD and tgen (`aud_tx`), a campaign of two replicas of
which one finishes first, a flush of rows from outside on one device,
and a 2-rank gloo mesh with `runner.flush_phases`.

Numpy mirrors of the two kernels, used by nothing else: `tally_mirror`
(pop counts of every host, rows of the hosts the rule reads, one
partial a block and the last block's reduction) and `loop_mirror` (the
minimum over each block's hosts, one partial a block, the last block's
decisions, `decide`), both on the kernels' grids and through
`last_block`, the two-level tickets of csrc/common.cuh, under a
shuffled order of blocks finishing; held
equal to `phase_tally_plain` and `loop_control_plain`/`control_step` at
every launch of those runs and on synthetic heads and outboxes of up to
1,100,000 hosts (two-level tickets, grid-strided blocks). `row_walk`
mirrors a warp's reads of its popped hosts' rows. The watched runs'
final leaves and rounds equal the JAX engine's (a child process, this
file's __main__ branch, which applies the jax batching patch the
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

from test_torch_outbox import CAMPAIGN, PHOLD, TGEN, TOR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 1 << 62
DROP_T = INF - 1
I32_MIN = -(1 << 31)

# the kernels' grids (csrc/loop_control.cu, phase_tally.cu) and tickets
# (csrc/common.cuh)
THREADS = 256
TICKET_GROUP = 128

CONFIGS = {"phold": PHOLD, "tgen": TGEN, "tor": TOR}
AUDIT = "experimental.state_audit=true"
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
    "phold_audit": ("phold", [AUDIT]),
    "tgen_audit": ("tgen", [AUDIT]),
}
SLOT_RUNS = ("phold", "tgen", "tor", "phold_audit", "phold_compact_window")
MESH = ("phold", ["experimental.mesh_shards=2"])
# the flushes of rows from outside pause PHOLD here: the next window's
# sends survive the loss (at 300 ms every one drops)
FLUSH_AT = 500_000_000
TALLY_LEAVES = ("occ_ob", "occ_trips", "occ_phases", "aud_tx")


# ----------------------------------------------------------------------
# the mirrors
# ----------------------------------------------------------------------
def tally_grid(H: int) -> tuple:
    """(blocks, hosts a block's pass) of csrc/phase_tally.cu at H hosts:
    a host a thread up to 1,024 blocks, else four."""
    per = THREADS * (4 if H > THREADS * 1024 else 1)
    return max(1, min(-(-H // per), 1024)), per


def loop_grid(H: int, folded: bool = False) -> tuple:
    """(blocks, hosts a block's pass) of csrc/loop_control.cu at H
    hosts: the least of 1, 2 and 4 hosts a thread that keeps the grid
    within one ticket group, else (and folded) one, up to 4,096
    blocks."""
    loads = 1
    if not folded:
        loads = next((n for n in (1, 2, 4)
                      if H <= THREADS * n * TICKET_GROUP), 1)
    per = THREADS * loads
    return max(1, min(-(-H // per), 4096)), per


def block_of(H: int, nb: int, per: int) -> np.ndarray:
    """[H]: the block whose threads take each host (a block strides over
    passes of nb * per hosts)."""
    return (np.arange(H) // per) % nb


def last_block(nb: int, order) -> int:
    """The block that reduces the partials, as common.cuh `ticket_take`
    and `ticket_last` find it when the blocks take their tickets in
    `order`: a block
    counts itself into its group's word (TICKET_GROUP blocks a group),
    the last of a group into the replica's word; a word's last taker
    sets it back to 0. Asserts one last block and every word 0."""
    ng = -(-nb // TICKET_GROUP)
    group, top, last = [0] * ng, 0, []
    for b in order:
        g = b // TICKET_GROUP
        in_g = min(TICKET_GROUP, nb - g * TICKET_GROUP)
        old, group[g] = group[g], group[g] + 1
        if old != in_g - 1:
            continue
        group[g] = 0
        if ng == 1:
            last.append(b)
            continue
        old, top = top, top + 1
        if old == ng - 1:
            top = 0
            last.append(b)
    assert len(last) == 1 and top == 0 and not any(group)
    return last[0]


def head_times(head: np.ndarray, ht: np.ndarray) -> np.ndarray:
    """[H]: each host's head time as a thread loads it (INF where the
    head lies past the heap)."""
    E = ht.shape[1]
    t = ht[np.arange(len(head)), np.clip(head, 0, E - 1)]
    return np.where(head < E, t, INF)


def decide(c: dict, m: int, start: bool) -> dict:
    """csrc/loop_control.cu `decide`: the last block's thread 0."""
    c = dict(c, nxt=m, round_end=0)
    if not start:
        c["phases"] += 1
        if m < c["win_end"]:
            c["run"] = 1
            return c
        c["rounds"] += 1
        c["round_end"] = 1
    if m >= c["stop"] or c["rounds"] >= c["max_rounds"]:
        c.update(done=1, run=0)
        return c
    c.update(win_end=min(m + c["lookahead"], c["final_stop"]), run=1)
    return c


def loop_mirror(head, ht, words: list, start: bool, rng,
                folded: bool = False) -> list:
    """One K9 launch on a replica's heads and control words: a DONE
    block's block 0 clears RUN and ROUND_END and nothing else runs;
    else each block's minimum over its hosts is its partial and the
    last block (`last_block` under a permutation of the blocks drawn
    from `rng`) decides on the minimum of the partials."""
    from shadow_tpu_torch.device.kernels import CTL_FIELDS

    c = dict(zip(CTL_FIELDS, words))
    if c["done"]:
        c.update(run=0, round_end=0)
        return [c[n] for n in CTL_FIELDS]
    H = len(head)
    nb, per = loop_grid(H, folded)
    partial = np.full(nb, INF, np.int64)
    np.minimum.at(partial, block_of(H, nb, per), head_times(head, ht))
    last_block(nb, rng.permutation(nb))
    c = decide(c, int(partial.min()), start)
    return [c[n] for n in CTL_FIELDS]


def tally_mirror(t, pops, leaves: dict, every: bool, rng,
                 folded: bool = False):
    """One phase_tally launch on a replica: the rows read are those of
    the hosts that popped, or of every host under the word; each read
    host's occ_ob takes its count of rows with t < DROP_T, its aud_tx
    adds it (where the leaf is given); each block's largest pop count
    is its partial (the blocks of phase_tally.cu's grid, or of K9's
    where `folded`), and the last block (`last_block` under a
    permutation drawn from `rng`) raises occ_trips to the largest
    partial and counts the phase.
    Returns (the new leaves, [H] bool of the hosts whose rows were
    read)."""
    H = len(pops)
    nb, per = loop_grid(H, True) if folded else tally_grid(H)
    read = np.full(H, True) if every else pops != 0
    n = np.zeros(H, np.int64)
    n[read] = (t[read] < DROP_T).sum(1)
    out = {k: v.copy() for k, v in leaves.items()}
    out["occ_ob"][read] = np.maximum(out["occ_ob"][read], n[read])
    if "aud_tx" in out:
        out["aud_tx"][read] += n[read]
    partial = np.full(nb, I32_MIN, np.int64)
    np.maximum.at(partial, block_of(H, nb, per), pops.astype(np.int64))
    last_block(nb, rng.permutation(nb))
    out["occ_trips"][0] = max(int(out["occ_trips"][0]), int(partial.max()))
    out["occ_phases"][0] += 1
    return out, read


TALLY_HOSTS, TALLY_CHUNKS = 8, 2     # csrc/tally.cuh


def row_walk(t: np.ndarray, need: int):
    """A warp's reads of its 32 hosts' rows `t` [32, OB] for the hosts of
    the bit mask `need` (csrc/tally.cuh `count_rows`): the hosts
    TALLY_HOSTS at a time in bit order, lane l loading columns c0 + 32k
    + l of each (TALLY_CHUNKS chunks a step), a ballot a chunk counting
    a host's live words for the host's own lane. Returns ([(lane, host,
    column)] of every load, [32] counts the lanes return)."""
    OB = t.shape[1]
    loads, mine = [], [0] * 32
    rest = need
    while rest:
        hosts = []
        for _ in range(TALLY_HOSTS):
            hosts.append((rest & -rest).bit_length() - 1 if rest else -1)
            rest &= rest - 1
        for c0 in range(0, OB, 32 * TALLY_CHUNKS):
            for j in hosts:
                n = 0
                for k in range(TALLY_CHUNKS):
                    ballot = 0
                    for lane in range(32):
                        col = c0 + 32 * k + lane
                        if j >= 0 and col < OB:
                            loads.append((lane, j, col))
                            ballot |= int(t[j, col] < DROP_T) << lane
                    n += bin(ballot).count("1")
                if j >= 0:
                    mine[j] += n
    return loads, mine


# ----------------------------------------------------------------------
# the engine's tallies and steps, watched
# ----------------------------------------------------------------------
def _np(d: dict, keys=None) -> dict:
    return {k: d[k].numpy().copy() for k in (keys or d) if k in d}


class Watch:
    """Kernels whose tally and K9 (alone, or with the tally folded in)
    check the rule and the mirrors around the plain versions."""

    def __init__(self, seed: int = 0):
        from shadow_tpu_torch.device.kernels import Kernels

        watch = self

        class Watched(Kernels):
            def phase_tally(k, state, ob, pops, p, ctl=None, outside=None):
                before = watch.tally_views(state, ob, pops, ctl, outside)
                Kernels.phase_tally(k, state, ob, pops, p, ctl, outside)
                watch.tally_check(before, p)

            def loop_control(k, state, ctl, start=False, tally=None):
                watch.loop(k, state, ctl, start, tally)

        self.kernels = Watched()
        self.rng = np.random.default_rng(seed)
        self.n = dict.fromkeys(
            ("tallies", "folded", "stopped", "under_word", "hosts_read",
             "hosts_skipped", "exchangeable", "from_outside", "steps",
             "starts", "done_steps", "round_ends"), 0)

    @staticmethod
    def _replicas(state, ob, pops, ctl, outside):
        """(r, state, outbox t, pops, control block, word) of each
        replica (one for a standalone state); the views write through."""
        from shadow_tpu_torch.device import kernels as K

        R = K.n_replicas(state)
        for r in range(R or 1):
            if R is None:
                s, t, n, c = state, ob["t"], pops, ctl
            else:
                s, t, n = K.at_replica(state, r), ob["t"][r], pops[r]
                c = None if ctl is None else ctl[r]
            word = outside is None or bool(int(outside[0, r]))
            yield r, s, t, n, c, word

    def tally_views(self, state, ob, pops, ctl, outside) -> list:
        """Each replica's views and, copied before the tally, its tally
        leaves, outbox t, pop counts and whether its phase ran."""
        from shadow_tpu_torch.device.kernels import _phase_off

        return [(s, word, _phase_off(c), _np(s, TALLY_LEAVES),
                 t.numpy().copy(), n.numpy().copy())
                for _, s, t, n, c, word in
                self._replicas(state, ob, pops, ctl, outside)]

    def tally_check(self, before: list, p, folded: bool = False) -> None:
        """After a tally (standalone, or folded into K9): a stopped
        replica kept every byte; a running one kept the rule (with the
        word clear) and equals the mirror."""
        for s, word, off, leaves, t, n in before:
            after = _np(s, TALLY_LEAVES)
            if off:
                for key in leaves:
                    np.testing.assert_array_equal(after[key], leaves[key])
                self.n["stopped"] += 1
                continue
            live = t < DROP_T
            if not word:
                # the rule: a host that popped nothing holds no
                # exchangeable row
                assert not live[n == 0].any(), np.flatnonzero(
                    live.any(1) & (n == 0))
            elif live[n == 0].any():
                self.n["from_outside"] += 1
            if not p.AUD:
                leaves.pop("aud_tx", None)
            got, read = tally_mirror(t, n, leaves, word, self.rng, folded)
            for key in got:
                np.testing.assert_array_equal(got[key], after[key],
                                              err_msg=key)
            self.n["tallies"] += 1
            self.n["under_word"] += int(word)
            self.n["hosts_read"] += int(read.sum())
            self.n["hosts_skipped"] += int((~read).sum())
            self.n["exchangeable"] += int(live.sum())

    def loop(self, k, state, ctl, start, tally):
        from shadow_tpu_torch.device import kernels as K

        R = K.n_replicas(state)
        views = [(state if R is None else K.at_replica(state, r),
                  ctl if R is None else ctl[r]) for r in range(R or 1)]
        want = [loop_mirror(s["head"].numpy(), s["ht"].numpy(),
                            c.tolist(), start, self.rng,
                            tally is not None) for s, c in views]
        words = [c.tolist() for _, c in views]
        folded = None
        if tally is not None and not start:
            ob, pops, p, outside = tally
            folded = (self.tally_views(state, ob, pops, ctl, outside), p)
        K.Kernels.loop_control(k, state, ctl, start, tally)
        if folded is not None:
            self.tally_check(*folded, folded=True)
            self.n["folded"] += 1
        for (s, c), w, before in zip(views, want, words):
            assert c.tolist() == w, (before, c.tolist(), w)
            nxt = None if before[K.CTL["done"]] else int(
                K.head_min_plain(s))
            assert K.control_step(before, nxt, start) == w
            self.n["steps"] += 1
            self.n["starts"] += int(start)
            self.n["done_steps"] += before[K.CTL["done"]]
            self.n["round_ends"] += w[K.CTL["round_end"]]


def _cfg(name, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(CONFIGS[name], list(overrides))


_RUNS = {}


def watched_run(key, loop="run"):
    """(Watch, final leaves, rounds, phases) of a RUNS entry on the CPU
    plain path with the watched kernels, through the Python loop (`run`)
    or the slot loop (`run_slots`), computed once."""
    if (key, loop) not in _RUNS:
        from shadow_tpu_torch.device import runner
        from shadow_tpu_torch.device.engine import state_to_numpy

        watch = Watch(len(_RUNS))
        name, ovr = RUNS[key]
        engine, sim = runner.make_engine(_cfg(name, ovr), device="cpu",
                                         kernels=watch.kernels)
        state, rounds = getattr(engine, loop)(
            engine.init_state(sim.start_times, sim.stop_times))
        _RUNS[key, loop] = (watch, state_to_numpy(state), rounds,
                            engine.loop_stats["phases"])
    return _RUNS[key, loop]


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
    with tempfile.TemporaryDirectory(prefix="torch_tally_ref_") as d:
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
def test_every_tally_keeps_the_rule_and_equals_the_mirror(key, reference):
    """Every tally of the Python loop: with the word clear no host that
    popped nothing holds an exchangeable row, and the mirror, reading
    only the popped hosts' rows, equals the plain tally leaf by leaf;
    the run's tally leaves, rounds and every other leaf equal JAX's."""
    watch, leaves, rounds, phases = watched_run(key)
    n = watch.n
    assert n["tallies"] == phases > 20
    # the pop clears the word before every tally of a run
    assert n["under_word"] == 0
    assert n["hosts_skipped"] > 0 and n["hosts_read"] > 0
    assert n["exchangeable"] > 0
    assert rounds == int(reference[f"{key}/rounds"])
    for k in TALLY_LEAVES:
        if k in leaves:
            np.testing.assert_array_equal(leaves[k],
                                          reference[f"{key}/{k}"],
                                          err_msg=f"{key}: {k}")
    if "audit" in key:
        assert leaves["aud_tx"].sum() > 0
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, reference[f"{key}/{k}"],
                                      err_msg=f"{key}: leaf {k}")


@pytest.mark.parametrize("key", SLOT_RUNS)
def test_the_slot_loop_keeps_both_mirrors_and_equals_the_python_loop(key):
    """The slot loop (K9 on the device's schedule, eagerly on the CPU):
    every K9 step equals `loop_mirror` under a shuffled order of blocks
    and `control_step`, every tally (folded into K9 but under
    `outbox_compact`) the rule and `tally_mirror`; its leaves, rounds
    and phases equal the Python loop's."""
    watch, leaves, rounds, phases = watched_run(key, "run_slots")
    _, py_leaves, py_rounds, py_phases = watched_run(key)
    n = watch.n
    assert (rounds, phases) == (py_rounds, py_phases)
    assert n["tallies"] == phases and n["under_word"] == 0
    # every slot's K9 took the tallies, no phase launching its own;
    # under outbox_compact (K11 rewrites the rows after the tally) none
    assert n["folded"] == (0 if "compact" in key else n["steps"] - 1)
    # one start step, a step a slot: the slots after DONE only clear
    assert n["starts"] == 1 and n["steps"] > phases
    assert n["done_steps"] == n["steps"] - phases - 1
    assert n["round_ends"] == rounds
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, py_leaves[k], err_msg=k)


@pytest.mark.parametrize("loop", ["run", "run_slots"])
def test_a_campaign_replica_that_finishes_first_keeps_its_tallies(
        loop, tmp_path, monkeypatch):
    """R = 2, one replica done before the other: its stopped tallies
    change no byte; every running tally keeps the rule and the mirror;
    under the slot loop every step of both blocks equals the mirrors,
    the done replica's steps only clearing RUN and ROUND_END."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    watch = Watch(7)
    er = EnsembleRunner(load_config_str(CAMPAIGN), device="cpu",
                        kernels=watch.kernels)
    engine = er.engine()
    state = engine.init_ensemble_state(er.sim.start_times,
                                       er.sim.stop_times)
    _, rounds = getattr(engine, loop)(state)
    n = watch.n
    assert rounds[0] != rounds[1]
    assert n["stopped"] > 0 and n["tallies"] > 20 and n["hosts_skipped"] > 0
    if loop == "run_slots":
        assert n["done_steps"] > 0 and n["starts"] == 2


def _paused(name="phold", overrides=()):
    """(engine, state, watch) of a config paused at FLUSH_AT on the CPU
    plain path with the watched kernels."""
    from shadow_tpu_torch.device import runner

    watch = Watch(3)
    engine, sim = runner.make_engine(_cfg(name, overrides), device="cpu",
                                     kernels=watch.kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    engine.run(state, stop=FLUSH_AT,
               final_stop=int(engine.config.stop_time))
    return engine, state, watch


@pytest.mark.parametrize("overrides", [
    [], ["experimental.model_bandwidth=true"]])
def test_a_flush_of_rows_from_outside_reads_every_host(overrides):
    """`flush` of rows copied into the buffer, pop counts 0: the word is
    set at tally time (K2, where it runs, saw it set too), the mirror
    reads every host and equals the plain tally, and a read by the pop
    counts alone would have skipped hosts with exchangeable rows; the
    next phase's pop clears the word before its tally."""
    from shadow_tpu_torch.device.kernels import control_block

    engine, state, watch = _paused("phold", overrides)
    ob, pops, _ = engine._buffers()
    # a whole window: enough sends that some survive the loss
    ctl = control_block("cpu", run=1, win_end=engine.next_time(state)
                        + int(engine.config.lookahead))
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


def _mesh_rank(mesh, cfg, job):
    """A 2-rank mesh run and one flush of rows from outside, on this
    rank's engines with the watched kernels: the counters of both."""
    from shadow_tpu_torch.device import runner

    out = {}
    made = runner.engine_from
    for name in ("run", "flush"):
        watch = Watch(11 + mesh.rank)

        def engine_from(*a, **kw):
            return made(*a, **{**kw, "kernels": watch.kernels})

        runner.engine_from = engine_from
        try:
            if name == "run":
                sim = runner.build(cfg)
                engine = engine_from(cfg, sim, device=mesh.device,
                                     mesh=mesh)
                engine.run(engine.init_state(sim.start_times,
                                             sim.stop_times))
            else:
                runner.flush_phases(mesh, [job])
        finally:
            runner.engine_from = made
        out[name] = watch.n
    return mesh.gather(out)


def test_a_two_rank_mesh_keeps_the_rule():
    """Two gloo ranks: every tally of a run keeps the rule and the
    mirror on each rank's outbox; `flush_phases` (rows of a one-device
    pop copied in, pop counts 0) reads every host of each rank under the
    word, equal to the plain tally."""
    from shadow_tpu_torch.device import mesh, runner
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.device.kernels import control_block

    name, ovr = MESH
    cfg = _cfg(name, ovr)
    one, sim = runner.make_engine(_cfg(name), device="cpu")
    state = one.init_state(sim.start_times, sim.stop_times)
    one.run(state, stop=FLUSH_AT, final_stop=int(one.config.stop_time))
    win_end = one.next_time(state) + int(one.config.lookahead)
    ob, pops, _ = one._buffers()
    one.kernels.pop(state, ob, pops, one.world,
                    control_block("cpu", run=1, win_end=win_end),
                    one.params)
    leaves = state_to_numpy(state)
    for k in ("occ_x", "occ_trips", "occ_phases"):
        v = leaves[k]
        leaves[k] = np.zeros((2, 2) if v.ndim == 2 else (2,), v.dtype)
    job = (cfg, leaves, {k: v.numpy().copy() for k, v in ob.items()},
           win_end)
    ranks = mesh.spawn(["cpu"] * 2, _mesh_rank, (cfg, job), timeout=300)
    for n in ranks:
        run, flush = n["run"], n["flush"]
        assert run["tallies"] > 20 and run["under_word"] == 0
        assert run["hosts_skipped"] > 0
        assert flush["tallies"] == 1 and flush["under_word"] == 1
        assert flush["hosts_skipped"] == 0
    assert sum(n["flush"]["from_outside"] for n in ranks) > 0


# ----------------------------------------------------------------------
# the tests: synthetic launches
# ----------------------------------------------------------------------
def _heads(rng, H, E):
    """Heads inside and past the heap (and below 0), and heap times;
    host 0's head time finite."""
    head = rng.integers(-1, E + 2, H).astype(np.int32)
    ht = rng.integers(0, 10**12, (H, E)).astype(np.int64)
    ht[rng.random((H, E)) < 0.1] = INF
    head[0], ht[0, 0] = 0, 10**12
    return head, ht


@pytest.mark.parametrize("H", [1, 300, 10_000, 70_000, 1_100_000])
def test_the_one_launch_step_equals_the_plain_step(H):
    """`loop_mirror` (partials a block, the last block of a shuffled
    order deciding) equals `loop_control_plain` and `control_step` in
    every branch: the start step, the window going on, the round ending
    into a new window (clamped to final_stop or not), stop reached,
    max_rounds reached, the loop already done; one block, one ticket
    group, two-level tickets and grid-strided blocks (past 1,048,576
    hosts)."""
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(H)
    head, ht = _heads(rng, H, 8 if H < 100_000 else 2)
    m = int(head_times(head, ht).min())
    big = {"stop": INF, "final_stop": INF, "lookahead": 10**6,
           "max_rounds": 1 << 40, "rounds": 5, "phases": 9, "run": 1}
    cases = {
        "start": ({**big, "run": 0}, True),
        "continue": ({**big, "win_end": m + 1}, False),
        "round_end": ({**big, "win_end": m}, False),
        "clamped": ({**big, "win_end": m, "final_stop": m + 10}, False),
        "stop": ({**big, "win_end": m, "stop": m}, False),
        "max_rounds": ({**big, "win_end": m, "max_rounds": 6}, False),
        "done": ({**big, "done": 1, "round_end": 1}, False)}
    state = {"head": torch.from_numpy(head), "ht": torch.from_numpy(ht)}
    seen = set()
    for case, (words, start) in cases.items():
        ctl = K.control_block("cpu", **words)
        before = ctl.tolist()
        K.loop_control_plain(state, ctl, start)
        nxt = None if words.get("done") else m
        assert K.control_step(before, nxt, start) == ctl.tolist(), case
        for folded in (False, True, False):
            assert loop_mirror(head, ht, before, start, rng,
                               folded) == ctl.tolist(), case
        after = dict(zip(K.CTL_FIELDS, ctl.tolist()))
        seen.add((after["done"], after["run"], after["round_end"]))
    # every outcome: done, the window going on, a new window
    assert {(1, 0, 0), (0, 1, 0), (0, 1, 1), (1, 0, 1)} <= seen


@pytest.mark.parametrize("H,every", [(300, False), (70_000, False),
                                     (70_000, True), (1_100_000, False)])
def test_the_tally_of_popped_hosts_equals_the_plain_tally(H, every):
    """`tally_mirror` on an outbox that keeps the rule (only hosts with
    a nonzero pop count hold rows below INF, DROP_T rows among them; a
    garbage outbox under the word) equals `phase_tally_plain` with and
    without the audit's ledger, under shuffled orders of blocks; it
    reads no row of a host that popped nothing unless the word is
    set."""
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(H + every)
    OB = 30 if H < 100_000 else 3
    pops = np.where(rng.random(H) < 0.05, rng.integers(1, 9, H), 0)
    pops = pops.astype(np.int32)
    if every:
        t = rng.integers(-2**63, 2**63 - 1, (H, OB), dtype=np.int64)
        t[rng.random((H, OB)) < 0.2] = DROP_T
    else:
        t = np.full((H, OB), INF, np.int64)
        live = (pops != 0)[:, None] & (rng.random((H, OB)) < 0.4)
        t[live] = rng.integers(0, 10**12, int(live.sum()))
        t[live & (rng.random((H, OB)) < 0.1)] = DROP_T
    leaves = {"occ_ob": rng.integers(0, 8, H).astype(np.int32),
              "occ_trips": np.array([3], np.int32),
              "occ_phases": np.array([7], np.int32),
              "aud_tx": rng.integers(0, 2**40, H).astype(np.int64)}
    for aud in (False, True):
        p = K.PhaseParams(E=64, K=3, T=0, P=1, B=OB // 3, IN=64, C=1,
                          boot_end=0, seed=(0, 0), app=None, AUD=aud)
        state = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
        K.phase_tally_plain(state, {"t": torch.from_numpy(t)},
                            torch.from_numpy(pops), p)
        want = {k: v.numpy() for k, v in state.items()}
        given = dict(leaves) if aud else {k: v for k, v in leaves.items()
                                          if k != "aud_tx"}
        got, read = tally_mirror(t, pops, given, every, rng)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert read.all() if every else not read[pops == 0].any()
    # past 1,048,576 hosts the blocks stride over more than one pass
    nb, per = tally_grid(H)
    assert nb <= 1024 and (nb * per < H) == (H > 1024 * 1024)


@pytest.mark.parametrize("OB", [1, 2, 3, 30, 31, 32, 33, 36, 39, 48, 64,
                                65, 100, 256])
def test_the_row_walk_reads_the_needed_rows_once_and_counts_them(OB):
    """A warp's reads of its hosts' rows: every column of each host of
    the mask once, by lane column mod 32, and no word of another host;
    each host's lane counts its row's live words (DROP_T rows not live),
    for one host, a few, every other one, all 32."""
    rng = np.random.default_rng(OB)
    t = np.where(rng.random((32, OB)) < 0.4, rng.integers(0, 10**9,
                                                          (32, OB)), INF)
    t[rng.random((32, OB)) < 0.1] = DROP_T
    for need in (1 << 7, 0b1011 << 20, 0x55555555, 0xFFFFFFFF,
                 int(rng.integers(1, 2**32))):
        loads, mine = row_walk(t, need)
        hosts = [j for j in range(32) if (need >> j) & 1]
        assert sorted((j, c) for _, j, c in loads) == \
            [(j, c) for j in hosts for c in range(OB)]
        assert all(lane == c % 32 for lane, _, c in loads)
        for j in range(32):
            want = int((t[j] < DROP_T).sum()) if (need >> j) & 1 else 0
            assert mine[j] == want


@pytest.mark.parametrize("nb", [1, 127, 128, 129, 256, 977, 3907])
def test_the_tickets_find_one_last_block_in_any_order(nb):
    """The two-level tickets: whatever order the blocks finish in, one
    block finds itself last and every word is back at 0 (a graph replay
    needs no memset)."""
    rng = np.random.default_rng(nb)
    for order in (range(nb), reversed(range(nb)),
                  *(rng.permutation(nb) for _ in range(5))):
        assert 0 <= last_block(nb, list(order)) < nb


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
