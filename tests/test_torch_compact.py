"""The outbox compaction (`experimental.outbox_compact`, K11
compact_outbox) against the reference: compact_plain against a numpy
transcription of both of the reference's branches, whole runs that do
not overflow (equal to the uncompacted run and to JAX, leaf by leaf),
runs that overflow at the compaction only, under the window rule and
the global rule, against JAX with `merge_strategy` pinned to each, a
paused and resumed compacted run, and a compacted campaign against the
JAX EnsembleRunner. Tolerance everywhere is exact equality: the
simulation is integer-exact.

The JAX engine runs in one child process (this file's __main__
branch), which applies the jax batching patch the reference needs
under the installed jax; the patch never runs in the pytest process.
The child starts before the first test.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 1 << 62
DROP_T = INF - 1
IMAX = (1 << 63) - 1

# tests/test_torch_audit.py's PHOLD (8 + 8 hosts, loss 0.1, msgload 2,
# 2 s): OB = 16, its largest per-phase outbox row holds 5 live rows
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
  judge_placement: flush
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

# tests/test_torch_audit.py's tgen: a server bursting answers to six
# clients (burst_pops 8), lossy, with retries: OB = 252, at most 6 live
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
  judge_placement: flush
hosts:
  server:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 6
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=300KiB count=2 pause=200ms retry=150ms}
"""
CONFIGS = {"phold": PHOLD, "tgen": TGEN}
# the smallest CX that holds each config's rows, and one that overflows
FITS = {"phold": 5, "tgen": 6}
OVER = 2


def compact(cx, rule="window"):
    return [f"experimental.outbox_compact={cx}",
            f"experimental.merge_strategy={rule}"]


# (config, overrides): the runs the child reproduces
RUNS = {
    "phold/plain": ("phold", []),
    "phold/fits": ("phold", compact(FITS["phold"])),
    "phold/fits_global": ("phold", compact(FITS["phold"], "global")),
    "phold/over_window": ("phold", compact(OVER)),
    "phold/over_global": ("phold", compact(OVER, "global")),
    "tgen/plain": ("tgen", []),
    "tgen/fits": ("tgen", compact(FITS["tgen"])),
    "tgen/over_window": ("tgen", compact(OVER)),
    "tgen/over_global": ("tgen", compact(OVER, "global")),
}
# a compacted campaign: the PHOLD over two seeds, rows overflowing
CAMPAIGN = ("phold", compact(OVER) + [
    "ensemble={replicas: 2, vary: {seed: [5, 6]}}"])


# ----------------------------------------------------------------------
# compact_plain against the reference's two branches, in numpy
# ----------------------------------------------------------------------
def numpy_window(t, m, gid, cx):
    """The CX < OB branch of the reference's `_flat_sorted`: per row a
    sort of skey = dst*SPAN + okey (IMAX where t >= DROP_T) with the
    column beside it, the first CX columns kept, x_overflow += the live
    keys past CX. Returns (kept columns per row, x_overflow adds)."""
    H, OB = t.shape
    span = H * OB
    okey = gid[:, None].astype(np.int64) * OB + np.arange(OB)
    skey = np.where(t < DROP_T, (m >> 32).astype(np.int32)
                    .astype(np.int64) * span + okey, IMAX)
    order = np.argsort(skey, axis=1, kind="stable")
    ssk = np.take_along_axis(skey, order, axis=1)
    return order[:, :cx], (ssk[:, cx:] < IMAX).sum(-1)


def numpy_global(t, cx):
    """`_compact_flat`: a stable row sort by t, the first CX columns
    kept, x_overflow += the rows past CX with t < DROP_T."""
    order = np.argsort(t, axis=1, kind="stable")
    st = np.take_along_axis(t, order, axis=1)
    return order[:, :cx], (st[:, cx:] < DROP_T).sum(-1)


def seeded_outbox(seed, H=257, OB=30):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, OB + 1, H)
    live = np.argsort(rng.random((H, OB)), axis=1) < n[:, None]
    t = rng.integers(10**9, 10**9 + 20, (H, OB))
    t = np.where(rng.random((H, OB)) < 0.1, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    m = (rng.integers(0, 12, (H, OB)).astype(np.int64) << 32) | 0x102
    return t, m, rng.integers(0, 50, H).astype(np.int32)


@pytest.mark.parametrize("rule", ["window", "global"])
@pytest.mark.parametrize("cx", [1, 4, 16, 26])
def test_compact_plain_equals_numpy_transcription(rule, cx):
    import torch

    from shadow_tpu_torch.device.kernels import compact_plain

    t, m, xo = seeded_outbox(cx * 7 + len(rule))
    H, OB = t.shape
    ob = {"t": torch.from_numpy(t.copy()), "m": torch.from_numpy(m)}
    state = {"x_overflow": torch.from_numpy(xo.copy())}
    compact_plain(state, ob, cx, rule == "global")
    if rule == "window":
        keep, over = numpy_window(t, m, np.arange(H), cx)
    else:
        keep, over = numpy_global(t, cx)
    want = np.full_like(t, INF)
    rows = np.arange(H)[:, None]
    want[rows, keep] = t[rows, keep]
    # rows the reference keeps past the live ones are not exchangeable
    # either way; the port leaves them as they were
    want = np.where(t >= DROP_T, t, want)
    np.testing.assert_array_equal(ob["t"].numpy(), want)
    np.testing.assert_array_equal(state["x_overflow"].numpy(), xo + over)
    assert over.sum() > 0


def test_the_two_rules_keep_different_rows():
    import torch

    from shadow_tpu_torch.device.kernels import compact_plain

    t, m, xo = seeded_outbox(3)
    got = []
    for rule in (False, True):
        ob = {"t": torch.from_numpy(t.copy()), "m": torch.from_numpy(m)}
        compact_plain({"x_overflow": torch.from_numpy(xo.copy())}, ob, 4,
                      rule)
        got.append(ob["t"].numpy())
    assert (got[0] != got[1]).any()


# ----------------------------------------------------------------------
# whole runs
# ----------------------------------------------------------------------
_PORT = {}


def port_run(key):
    """(final leaves, rounds, stats) of a RUNS entry on the CPU plain
    path, computed once."""
    if key not in _PORT:
        from shadow_tpu_torch.config import load_config_str
        from shadow_tpu_torch.device import runner
        from shadow_tpu_torch.device.engine import state_to_numpy

        name, ovr = RUNS[key]
        cfg = load_config_str(CONFIGS[name], ovr)
        engine, sim = runner.make_engine(cfg, device="cpu")
        state, rounds = engine.run(engine.init_state(sim.start_times,
                                                     sim.stop_times))
        _PORT[key] = (state_to_numpy(state), rounds, engine)
    return _PORT[key]


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
    job = {"runs": {k: (CONFIGS[n], o) for k, (n, o) in RUNS.items()},
           "campaign": (CONFIGS[CAMPAIGN[0]], CAMPAIGN[1])}
    with tempfile.TemporaryDirectory(prefix="torch_compact_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _same_as_reference(key, reference):
    leaves, rounds, _ = port_run(key)
    assert rounds == int(reference[f"{key}/rounds"])
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, reference[f"{key}/{k}"],
                                      err_msg=f"{key}: leaf {k}")
    return leaves


@pytest.mark.parametrize("key", [k for k in RUNS if "/fits" in k])
def test_compaction_that_fits_equals_the_uncompacted_run_and_jax(
        key, reference):
    """A CX that holds every row changes nothing: the run equals the
    uncompacted one and the reference's, leaf by leaf; K11 ran."""
    name = key.split("/")[0]
    leaves = _same_as_reference(key, reference)
    plain, plain_rounds, _ = port_run(f"{name}/plain")
    _same_as_reference(f"{name}/plain", reference)
    assert port_run(key)[1] == plain_rounds
    assert port_run(key)[2].params.compacts
    for k in plain:
        np.testing.assert_array_equal(leaves[k], plain[k], err_msg=k)
    assert not leaves["x_overflow"].any()


@pytest.mark.parametrize("key", [k for k in RUNS if "/over_" in k])
def test_compaction_overflow_equals_jax_under_each_rule(key, reference):
    """Rows lost at the compaction alone (no arrival window overflows):
    per-host x_overflow and every other leaf equal the reference's with
    merge_strategy pinned to the rule."""
    leaves = _same_as_reference(key, reference)
    assert leaves["x_overflow"].sum() > 0
    assert leaves["overflow"].sum() == 0


def test_the_rules_diverge_where_rows_overflow():
    a, _, _ = port_run("phold/over_window")
    b, _, _ = port_run("phold/over_global")
    assert not np.array_equal(a["chk"], b["chk"])


def test_paused_and_resumed_compaction_keeps_x_overflow():
    """A compacted run paused at 150 ms (windows clamped to the stop),
    with rows lost before the pause and after it, and resumed equals the
    unpaused run, x_overflow per sender too."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import state_to_numpy

    want, rounds, _ = port_run("phold/over_window")
    cfg = load_config_str(PHOLD, compact(OVER))
    engine, sim = runner.make_engine(cfg, device="cpu")
    stop = cfg.general.stop_time
    state, r1 = engine.run(engine.init_state(sim.start_times,
                                             sim.stop_times), 15 * 10**7,
                           stop)
    mid = int(state["x_overflow"].sum())
    assert 0 < mid < want["x_overflow"].sum()
    state, r2 = engine.run(state, stop, stop)
    assert r1 + r2 == rounds
    got = state_to_numpy(state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rule", ["window", "global"])
def test_audit_balances_rows_lost_at_the_compaction(rule):
    """The audit's ledger counts the judged outbox before K11 and its
    balance counts x_overflow: an audited run that loses rows at the
    compaction ends with a zero health word and the unaudited trace."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    plain = runner.run(load_config_str(PHOLD, compact(OVER, rule)),
                       device="cpu")
    audited = runner.run(load_config_str(PHOLD, compact(OVER, rule) + [
        "experimental.state_audit=true"]), device="cpu")
    assert audited.x_overflow == plain.x_overflow > 0
    np.testing.assert_array_equal(audited.host_trace_checksum,
                                  plain.host_trace_checksum)


def test_compacted_campaign_equals_jax_ensemble_runner(reference,
                                                       tmp_path):
    """The PHOLD over two seeds under outbox_compact, rows overflowing:
    the campaign's final state, replica by replica, equals the
    reference EnsembleRunner's; its record names the x_overflow."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    name, ovr = CAMPAIGN
    er = EnsembleRunner(load_config_str(CONFIGS[name], ovr + [
        f"ensemble.record_path={tmp_path / 'rec.json'}"]), device="cpu")
    stats = er.run()
    assert stats.x_overflow > 0 and not stats.ok
    for k, v in er.final_state.items():
        np.testing.assert_array_equal(v, reference[f"campaign/{k}"],
                                      err_msg=f"campaign: {k}")


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
    for key, (yaml, ovr) in job["runs"].items():
        c = Controller(load_config_str(yaml, ovr))
        eng = c.runner.engine
        state, rounds = eng.run(eng.init_state(c.sim.starts))
        for k, v in state.items():
            out[f"{key}/{k}"] = np.asarray(jax.device_get(v))
        out[f"{key}/rounds"] = np.int64(rounds)
    yaml, ovr = job["campaign"]
    c = Controller(load_config_str(yaml, ovr))
    c.run()
    for k, v in c.runner.final_state.items():
        out[f"campaign/{k}"] = np.asarray(jax.device_get(v))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
