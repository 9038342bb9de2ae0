"""The segmented advance and the capacity planner of the port
(shadow_tpu_torch/device/supervise.py `advance`, device/capacity.py,
device/runner.py `DeviceRunner`, ensemble/campaign.py) against the
reference package's, on the CPU:

* the planner's functions (`plan`, `widen`, `two_phase_caps`,
  `choose_exchange`, `estimate_ici_rows`, `merged_measured`,
  `pair_matrix`, `grow_heaps`) and `app_fingerprint` equal to the
  reference's on the same seeded records, pair matrices and states;
* tests/test_capacity.py's PHOLD (:299-391): the static run, a planned
  run (`capacity_warmup: 600ms`: no re-plan, tighter knobs), a forced
  overflow (`capacity_warmup: 50ms`: re-plans, then the static trace)
  and a replay of the written OCC record, each with the reference's
  planned knobs, re-plans, per-host checksums, totals and rounds; a
  record written by either package loaded by the other;
* tests/test_device_heartbeats.py's config (:52-81): the
  `[shadow-heartbeat] [node]` rows equal to the reference's row by row,
  and the run's trace equal to the run without heartbeats; runs cut by
  `dispatch_segment` equal to one unsegmented run;
* `HeartbeatMonitor` on a frozen clock (test_heartbeat_stale.py:32-80);
* a planned campaign with heartbeats equal to its standalone replicas,
  one `[ensemble-heartbeat]` line per replica per boundary;
* a planned tgen run on a 2- and a 4-rank gloo mesh with `exchange:
  auto`: the reference's schedule, estimates, measured marks and caps
  for the same workload, and the one-device trace.

Tolerance everywhere is exact equality: the simulation and the planner
are integer-exact. The JAX reference runs in one child process (this
file's __main__ branch, on 8 virtual CPU devices, its compile cache
off), started before the first test under the jax batching patch the
reference needs; the patch never runs in the pytest process.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_capacity.py's PHOLD_YAML
PHOLD_YAML = """
general:
  stop_time: {stop}
  seed: 9
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.0 ]
      ]
experimental:
  scheduler_policy: {policy}
  event_capacity: 64
  outbox_capacity: 16
{extra}hosts:
  left:
    quantity: {q}
    network_node_id: 0
    processes:
    - path: model:phold
      args: msgload={msgload}
      start_time: 100ms
  right:
    quantity: {q}
    network_node_id: 1
    processes:
    - path: model:phold
      args: msgload={msgload}
      start_time: 150ms
"""

# tests/test_device_heartbeats.py's YAML
HB_YAML = """
general:
  stop_time: 2s
  seed: 5
  {hb}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ] ]
experimental:
  scheduler_policy: tpu
hosts:
  left:
    quantity: 4
    network_node_id: 0
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 10ms}}
  right:
    quantity: 4
    network_node_id: 1
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 10ms}}
"""

PLANNED = "  capacity_plan: auto\n  capacity_warmup: 600ms\n"
FORCED = "  capacity_plan: auto\n  capacity_warmup: 50ms\n"

TGEN_100 = os.path.join(ROOT, "examples", "tgen_100.yaml")
TGEN_BASE = ["general.stop_time=4s", "experimental.scheduler_policy=tpu"]
MESH_PLAN = ["experimental.exchange=auto", "experimental.capacity_plan=auto",
             "experimental.capacity_warmup=3s",
             "experimental.dispatch_segment=1s"]
SWEEP = os.path.join(ROOT, "examples", "ensemble_seed_sweep.yaml")

FINGERPRINTS = {
    "phold": ("str", PHOLD_YAML.format(policy="tpu", stop="1s", q=3,
                                       msgload=2, extra=""), []),
    "tgen_100": ("file", TGEN_100, TGEN_BASE),
    "tor_small": ("file", os.path.join(ROOT, "examples", "tor_small.yaml"),
                  ["experimental.scheduler_policy=tpu"]),
}

# synthetic records for the planner's functions: (shards, seed,
# with final_measured)
RECORD_CASES = [(1, 1, False), (2, 2, True), (4, 3, False), (4, 4, True),
                (6, 5, True), (8, 6, False), (9, 7, True), (16, 8, True)]


def phold(extra="", stop="1s", policy="tpu"):
    return PHOLD_YAML.format(policy=policy, stop=stop, q=3, msgload=2,
                             extra=extra)


def synthetic_record(S: int, seed: int, final: bool) -> dict:
    """A record with seeded maxima and an [S, S] pair matrix (zero
    diagonal), some pairs hot so that each schedule wins somewhere."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 400, (S, S))
    if seed % 3 == 0:
        pairs[:, 0] *= 20        # one hot destination
    if seed % 4 == 0:
        # sparse traffic with one hot pair: two_phase's buffers beat the
        # direct schedule's S - 1 copies of the hot pair's cap
        pairs = rng.integers(0, 6, (S, S))
        pairs[1, S - 1] = 5000
    np.fill_diagonal(pairs, 0)

    def measured(scale):
        return {"heap_rows_max": int(rng.integers(0, 90) * scale),
                "outbox_rows_max": int(rng.integers(0, 70) * scale),
                "arrivals_per_flush_max": int(rng.integers(0, 60)),
                "exchange_rows_max": int(pairs.max()) if S > 1 else 0,
                "exchange_pairs": (pairs * scale).astype(int).tolist(),
                "pop_trips_max": int(rng.integers(0, 20)),
                "phases": int(rng.integers(0, 500)),
                "overflow": 0, "x_overflow": 0}

    hosts = 10**5 if seed % 4 == 0 else int(rng.integers(S, 50 * S + 1))
    rec = {"format": 1, "source": "synthetic",
           "workload": {"app": "PholdDevice", "app_fp": "x",
                        "n_hosts": hosts,
                        "seed": seed, "stop_time": 10**9},
           "measured": measured(1)}
    if final:
        rec["final_measured"] = measured(2)
    return rec


def planner_outputs(cap, rec: dict, S: int) -> dict:
    """Every planner function of `cap` (either package's capacity
    module) on one record, as JSON-able values."""
    m = cap.merged_measured(rec)
    pairs = cap.pair_matrix(m, S)
    out = {"merged": m, "pairs": pairs.tolist(),
           "two_phase_caps": list(cap.two_phase_caps(pairs)),
           "two_phase_caps_h2": list(cap.two_phase_caps(pairs, 2.0))}
    for per_iter, floor, head in ((3, 8, 1.5), (9, 4, 2.0), (1, 8, 1.0)):
        tag = f"{per_iter}/{floor}/{head}"
        for x in ("all_to_all", "two_phase", "all_gather"):
            out[f"plan/{tag}/{x}"] = cap.plan(rec, per_iter, floor, S,
                                              head, x)
        out[f"est/{tag}"] = cap.estimate_ici_rows(rec, S, per_iter,
                                                  floor, head)
        out[f"choose/{tag}"] = list(cap.choose_exchange(rec, S, per_iter,
                                                        floor, head))
    eff = {"E": 40, "IN": 0, "CAP": 300 if S > 1 else 0,
           "CAP2": 500 if S > 2 else 0, "CX": 12, "OB": 32}
    knobs = cap.plan(rec, 3, 8, S)
    for dims in (("event_capacity", "exchange_in_capacity"),
                 ("exchange_capacity", "exchange_capacity2",
                  "outbox_compact")):
        out["widen/" + dims[0]] = cap.widen(knobs, dims, eff)
        out["widen0/" + dims[0]] = cap.widen({}, dims, {**eff, "CX": 20})
    return out


def heap_state(R=None) -> dict:
    """A small host-side state whose heaps hold sorted rows."""
    rng = np.random.default_rng(11 if R is None else 12)
    lead = () if R is None else (R,)
    ht = np.sort(rng.integers(0, 10**9, (*lead, 5, 6)), -1)
    return {"ht": ht, "hk": rng.integers(0, 1 << 40, ht.shape),
            "hm": rng.integers(0, 9, ht.shape),
            "hv": rng.integers(0, 9, ht.shape),
            "hw": rng.integers(0, 9, ht.shape),
            "head": np.zeros((*lead, 5), np.int32)}


# ----------------------------------------------------------------------
# the reference child
# ----------------------------------------------------------------------
class ReferenceChild:
    """The child run in a fresh interpreter, started at once;
    `result()` waits for what it saved."""

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
            [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
            + ["--xla_force_host_platform_device_count=8"])
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


@pytest.fixture(scope="module")
def workdir():
    d = tempfile.mkdtemp(prefix="torch_plan_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def port_record(workdir):
    """The OCC record a planned port run writes (path, text), made
    before the child starts so that the reference can load it."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    occ = os.path.join(workdir, "port_occ")
    old = os.environ.get("SHADOW_TPU_OCC_DIR")
    os.environ["SHADOW_TPU_OCC_DIR"] = occ
    try:
        stats = runner.run(load_config_str(phold(PLANNED)), device="cpu")
    finally:
        if old is None:
            del os.environ["SHADOW_TPU_OCC_DIR"]
        else:
            os.environ["SHADOW_TPU_OCC_DIR"] = old
    assert stats.ok
    (name,) = os.listdir(occ)
    path = os.path.join(occ, name)
    with open(path) as f:
        return path, f.read()


@pytest.fixture(scope="module", autouse=True)
def reference_child(workdir, port_record):
    job = {"phold": {k: phold(x) for k, x in (
               ("static", ""), ("planned", PLANNED), ("forced", FORCED))},
           "port_record": port_record[0],
           "hb": {"hb": HB_YAML.format(hb="heartbeat_interval: 500ms"),
                  "plain": HB_YAML.format(hb="")},
           "fingerprints": FINGERPRINTS,
           "records": [synthetic_record(*c) for c in RECORD_CASES],
           "shards": [c[0] for c in RECORD_CASES],
           "mesh": {str(S): [TGEN_100, TGEN_BASE + MESH_PLAN +
                             [f"experimental.mesh_shards={S}"]]
                    for S in (2, 4)},
           "heaps": {"standalone": {k: v.tolist() for k, v in
                                    heap_state().items()},
                     "campaign": {k: v.tolist() for k, v in
                                  heap_state(3).items()}}}
    d = os.path.join(workdir, "child")
    os.makedirs(d)
    child = ReferenceChild(job, d)
    try:
        yield child
    finally:
        child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _json(reference, key):
    return json.loads(str(reference[key]))


# ----------------------------------------------------------------------
# the planner's functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", range(len(RECORD_CASES)))
def test_planner_functions_equal_the_reference(case, reference):
    """plan, widen, two_phase_caps, choose_exchange, estimate_ici_rows,
    merged_measured and pair_matrix on one seeded record, exactly."""
    from shadow_tpu_torch.device import capacity

    S = RECORD_CASES[case][0]
    got = planner_outputs(capacity, synthetic_record(*RECORD_CASES[case]),
                          S)
    want = _json(reference, f"planner/{case}")
    assert json.loads(json.dumps(got)) == want


def test_choose_exchange_cases_cover_every_schedule(reference):
    chosen = {_json(reference, f"planner/{c}")[f"choose/{t}"][0]
              for c in range(len(RECORD_CASES))
              for t in ("3/8/1.5", "9/4/2.0", "1/8/1.0")}
    assert chosen == {"all_to_all", "two_phase", "all_gather"}


@pytest.mark.parametrize("which", ["standalone", "campaign"])
def test_grow_heaps_equals_the_reference(which, reference):
    from shadow_tpu_torch.device import capacity

    st = heap_state() if which == "standalone" else heap_state(3)
    got = capacity.grow_heaps(st, 9)
    for k in ("ht", "hk", "hm", "hv", "hw", "head"):
        np.testing.assert_array_equal(got[k],
                                      reference[f"heaps/{which}/{k}"])
    assert capacity.grow_heaps(st, 6)["ht"] is st["ht"]
    with pytest.raises(ValueError, match="shrink"):
        capacity.grow_heaps(st, 5)


def test_grow_heaps_pads_with_the_engines_empty_slots():
    """The padding is what the port's init_state leaves in an empty
    slot."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import capacity, runner

    engine, sim = runner.make_engine(load_config_str(phold()), "cpu")
    init = engine.init_arrays(sim.start_times, sim.stop_times)
    grown = capacity.grow_heaps(init, engine.params.E + 3)
    for k in ("ht", "hk", "hm", "hv", "hw"):
        np.testing.assert_array_equal(grown[k][:, -3:],
                                      np.repeat(init[k][:, -1:], 3, 1))


@pytest.mark.parametrize("name", list(FINGERPRINTS))
def test_app_fingerprint_equals_the_reference(name, reference):
    from shadow_tpu_torch.config import load_config, load_config_str
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import capacity

    kind, src, ovr = FINGERPRINTS[name]
    cfg = (load_config(src, ovr) if kind == "file"
           else load_config_str(src, ovr))
    app = build(cfg).app
    assert capacity.app_fingerprint(app) == str(reference[f"fp/{name}"])
    assert capacity.app_scalars(app) == _json(reference,
                                              f"scalars/{name}")


# ----------------------------------------------------------------------
# tests/test_capacity.py's PHOLD runs
# ----------------------------------------------------------------------
_RUNS = {}


def port_run(key: str, extra: str = "", occ: str = ""):
    """(SimStats, the OCC files written) of a PHOLD run on the CPU."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    if key not in _RUNS:
        d = occ or tempfile.mkdtemp(prefix="torch_plan_occ_")
        old = os.environ.get("SHADOW_TPU_OCC_DIR")
        os.environ["SHADOW_TPU_OCC_DIR"] = d
        try:
            stats = runner.run(load_config_str(phold(extra)), device="cpu")
        finally:
            if old is None:
                del os.environ["SHADOW_TPU_OCC_DIR"]
            else:
                os.environ["SHADOW_TPU_OCC_DIR"] = old
        files = sorted(os.path.join(d, f) for f in os.listdir(d)) \
            if os.path.isdir(d) else []
        _RUNS[key] = (stats, files)
    return _RUNS[key]


def _same_as_reference(stats, reference, key):
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  reference[f"phold/{key}/chk"])
    np.testing.assert_array_equal(stats.host_events_executed,
                                  reference[f"phold/{key}/n_exec"])
    for f in ("events_executed", "packets_sent", "packets_dropped",
              "packets_delivered", "rounds", "replans"):
        assert getattr(stats, f) == int(reference[f"phold/{key}/{f}"]), f


def test_static_phold_equals_the_reference(reference):
    stats, _ = port_run("static")
    assert stats.ok and stats.replans == 0
    _same_as_reference(stats, reference, "static")


def test_planned_phold_equals_static_and_the_reference(reference):
    """capacity_warmup: 600ms covers steady state: no re-plan, the
    reference's planned knobs (tighter than the static ones), the static
    run's trace."""
    stats, files = port_run("planned", PLANNED)
    static, _ = port_run("static")
    assert stats.ok and stats.replans == 0
    rec = stats.occupancy
    assert rec["planned"] == _json(reference, "phold/planned/planned")
    assert rec["static"] == _json(reference, "phold/planned/static")
    assert rec["planned"] != rec["static"]
    assert rec["planned"]["event_capacity"] < 64
    assert rec["measured"] == _json(reference, "phold/planned/measured")
    assert rec["final_measured"] == _json(reference,
                                          "phold/planned/final_measured")
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  static.host_trace_checksum)
    _same_as_reference(stats, reference, "planned")
    assert len(files) == 1 and os.path.basename(files[0]).startswith(
        "OCC_PholdDevice_6_")


def test_forced_overflow_replans_and_equals_the_reference(reference):
    """capacity_warmup: 50ms ends before the first boot: the plan is
    sized on an empty slice, the run overflows, widens and replays, and
    ends with the static trace and the reference's re-plans."""
    stats, _ = port_run("forced", FORCED)
    static, _ = port_run("static")
    assert stats.ok and stats.replans >= 1
    rec = stats.occupancy
    assert rec["replans"] == stats.replans
    assert rec["final_measured"]["overflow"] == 0
    assert rec["final_measured"]["x_overflow"] == 0
    assert rec["applied"] == _json(reference, "phold/forced/applied")
    assert stats.pipeline["replayed"] == stats.replans
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  static.host_trace_checksum)
    _same_as_reference(stats, reference, "forced")


def test_record_replay_equals_static(reference):
    _, files = port_run("planned", PLANNED)
    stats, _ = port_run("replay", f"  capacity_plan: {files[0]}\n")
    assert stats.ok and stats.replans == 0
    assert stats.occupancy["planned"] == _json(reference,
                                               "phold/replay/planned")
    _same_as_reference(stats, reference, "static")


def test_reference_record_loads_in_the_port(reference, workdir):
    """The record the reference's planned run wrote, replayed by the
    port: the reference's replay knobs, the static trace."""
    path = os.path.join(workdir, "ref_occ", "OCC_ref.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(str(reference["phold/planned/record"]))
    stats, _ = port_run("ref_record", f"  capacity_plan: {path}\n")
    assert stats.ok
    assert stats.occupancy["planned"] == _json(reference,
                                               "phold/replay/planned")
    _same_as_reference(stats, reference, "static")


def test_port_record_loads_in_the_reference(reference, port_record):
    """The port's record, replayed by the reference: its trace is the
    static one, and its record carries the reference's fields."""
    rec = json.loads(port_record[1])
    ref = json.loads(str(reference["phold/planned/record"]))
    assert set(rec) == set(ref)
    assert set(rec["measured"]) == set(ref["measured"])
    assert set(rec["workload"]) == set(ref["workload"])
    assert rec["workload"] == ref["workload"]
    assert set(rec["effective"]) <= set(ref["effective"]) | {"B"}
    np.testing.assert_array_equal(reference["phold/port_record/chk"],
                                  reference["phold/static/chk"])
    # the replay plans from the warm-up's marks and the run's together
    from shadow_tpu_torch.device import capacity

    assert _json(reference, "phold/port_record/planned") == \
        capacity.plan(rec, per_iter=2, floor_iters=8)


def test_record_of_another_workload_is_refused(tmp_path):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    stats, files = port_run("planned", PLANNED)
    other = phold().replace("msgload=2", "msgload=3")
    cfg = load_config_str(other, [f"experimental.capacity_plan="
                                  f"{files[0]}"])
    with pytest.raises(ValueError, match="re-measure"):
        runner.run(cfg, device="cpu")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": 99}))
    with pytest.raises(ValueError, match="format"):
        runner.run(load_config_str(phold(), [
            f"experimental.capacity_plan={bad}"]), device="cpu")


# ----------------------------------------------------------------------
# heartbeats and segments
# ----------------------------------------------------------------------
def _hb_run(hb: str):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    return runner.run(load_config_str(HB_YAML.format(hb=hb)), device="cpu")


def test_heartbeat_rows_equal_the_reference(reference, caplog):
    with caplog.at_level(logging.INFO, logger="shadow_tpu_torch"):
        stats = _hb_run("heartbeat_interval: 500ms")
    msgs = [r.getMessage() for r in caplog.records]
    rows = [m.split("[shadow-heartbeat] [node] ")[1] for m in msgs
            if "[shadow-heartbeat] [node] " in m]
    assert len(rows) == 24       # 8 hosts x 0.5, 1.0, 1.5 s
    assert rows == _json(reference, "hb/rows")
    assert any("[node-header]" in m for m in msgs)
    sup = [m for m in msgs if "[supervise-heartbeat]" in m]
    assert len(sup) == 3 and "mem=n/a" in sup[0] and "pkts/s=n/a" in \
        sup[0]
    assert any("device perf:" in m and "rounds" in m for m in msgs)
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  reference["hb/hb/chk"])
    assert stats.rounds == int(reference["hb/hb/rounds"])


def test_heartbeat_run_equals_the_run_without(reference):
    hb = _hb_run("heartbeat_interval: 500ms")
    plain = _hb_run("")
    assert hb.ok and plain.ok
    assert hb.events_executed == plain.events_executed
    assert hb.rounds == plain.rounds == int(reference["hb/plain/rounds"])
    assert hb.phases == plain.phases
    np.testing.assert_array_equal(hb.host_trace_checksum,
                                  plain.host_trace_checksum)
    np.testing.assert_array_equal(plain.host_trace_checksum,
                                  reference["hb/plain/chk"])
    assert hb.pipeline["segments"] == 4 and plain.pipeline["segments"] == 1


@pytest.mark.parametrize("segment", ["3ms", "7ms", "250ms", "1s", "5s"])
def test_dispatch_segments_equal_one_unsegmented_run(segment, reference):
    """Any dispatch_segment, heartbeats or not, leaves the trace, the
    totals and the summed rounds and phases of one unsegmented run."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    plain = _hb_run("")
    hb = "heartbeat_interval: 300ms" if segment in ("7ms", "1s") else ""
    stats = runner.run(load_config_str(HB_YAML.format(hb=hb), [
        f"experimental.dispatch_segment={segment}"]), device="cpu")
    assert stats.ok and stats.rounds == plain.rounds
    assert stats.phases == plain.phases
    assert stats.events_executed == plain.events_executed
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  plain.host_trace_checksum)
    assert stats.pipeline["segments"] >= (2 if segment != "5s" else 1)


def test_audited_segmented_run_checks_every_boundary():
    """Under the state audit a segmented run validates its word at every
    boundary and ends as the unaudited run."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    plain = _hb_run("")
    stats = runner.run(load_config_str(HB_YAML.format(hb=""), [
        "experimental.dispatch_segment=300ms",
        "experimental.state_audit=true"]), device="cpu")
    assert stats.ok and stats.pipeline["segments"] == 7
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  plain.host_trace_checksum)


def test_round_budget_is_cumulative_over_segments():
    """max_rounds counts the rounds of every segment, as the reference's
    advance enforces it."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import runner

    cfg = load_config_str(HB_YAML.format(hb=""), [
        "experimental.dispatch_segment=100ms"])
    dr = runner.DeviceRunner(cfg, build(cfg), "cpu")
    dr.engine.config.max_rounds = 5
    stats = dr.run()
    assert not stats.ok
    assert 5 <= stats.rounds < _hb_run("").rounds


# ----------------------------------------------------------------------
# the staleness monitor on a frozen clock
# ----------------------------------------------------------------------
class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_monitor_learns_cadence_and_flags_wide_gap():
    from shadow_tpu_torch.device.supervise import HeartbeatMonitor

    clk = FakeClock()
    mon = HeartbeatMonitor(3, clock=clk)
    for t in (0.0, 1.0, 2.0, 3.1, 4.0):
        clk.t = t
        mon.beat()
    assert mon.stale_events == 0
    clk.t = 12.0
    mon.beat()
    assert mon.stale_events == 1
    clk.t = 20.0
    mon.beat()
    assert mon.stale_events == 2


def test_monitor_live_staleness_probe_without_a_beat():
    from shadow_tpu_torch.device.supervise import HeartbeatMonitor

    clk = FakeClock()
    mon = HeartbeatMonitor(3, clock=clk)
    mon.beat()
    clk.t = 1.0
    mon.beat()
    clk.t = 3.5
    assert not mon.stale()
    clk.t = 9.0
    assert mon.stale()
    assert mon.gap() == 8.0


def test_monitor_is_quiet_before_a_cadence_exists():
    from shadow_tpu_torch.device.supervise import HeartbeatMonitor

    clk = FakeClock()
    mon = HeartbeatMonitor(3, clock=clk)
    assert not mon.stale()
    mon.beat()
    clk.t = 1000.0
    assert not mon.stale()


def test_monitor_clamps_k_to_at_least_two():
    from shadow_tpu_torch.device.supervise import HeartbeatMonitor

    assert HeartbeatMonitor(0).k == 2
    assert HeartbeatMonitor(1).k == 2
    assert HeartbeatMonitor(5).k == 5


def test_stale_heartbeats_reach_the_stats():
    """A run with heartbeat_stale_after owns a monitor; its count lands
    in SimStats.stale_heartbeats (a healthy CPU run's is small and never
    negative)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    stats = runner.run(load_config_str(HB_YAML.format(
        hb="heartbeat_interval: 200ms"), [
        "experimental.heartbeat_stale_after=1000"]), device="cpu")
    assert stats.ok and stats.stale_heartbeats == 0


# ----------------------------------------------------------------------
# a planned campaign
# ----------------------------------------------------------------------
def test_planned_campaign_equals_its_standalone_replicas(caplog, tmp_path,
                                                         monkeypatch):
    """examples/ensemble_seed_sweep.yaml cut to 3 s, planned from a 1 s
    warm-up (the worst-case replica), with heartbeats every second: each
    replica equal to its standalone run, one [ensemble-heartbeat] line
    per replica per boundary, the static campaign's record."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    base = ["general.stop_time=3s"]
    static = EnsembleRunner(load_config(SWEEP, base), device="cpu").run()
    er = EnsembleRunner(load_config(SWEEP, base + [
        "experimental.capacity_plan=auto",
        "experimental.capacity_warmup=1s",
        "general.heartbeat_interval=1s"]), device="cpu")
    with caplog.at_level(logging.INFO, logger="shadow_tpu_torch"):
        stats = er.run()
    assert stats.ok and stats.replans == 0
    rec = stats.occupancy
    assert rec["planned"] != rec["static"]
    assert rec["planned"]["event_capacity"] < rec["static"][
        "event_capacity"]
    lines = [r.getMessage() for r in caplog.records
             if "[ensemble-heartbeat]" in r.getMessage()]
    R = er.worlds.R
    assert len(lines) == 2 * R
    assert [int(x.split("replica=")[1].split()[0]) for x in lines] == \
        list(range(R)) * 2
    assert stats.rounds == static.rounds
    for a, b in zip(stats.ensemble["replicas"],
                    static.ensemble["replicas"]):
        assert a["host_checksums"] == b["host_checksums"]
    for r in range(R):
        engine = er.replica_engine(r)
        state, rounds = engine.run(engine.init_state(er.sim.start_times,
                                                     er.sim.stop_times))
        chk = state_to_numpy(state, ["chk"])["chk"]
        assert [int(c) for c in chk] == \
            stats.ensemble["replicas"][r]["host_checksums"]


def test_forced_campaign_overflow_replays_every_replica(tmp_path,
                                                        monkeypatch):
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    base = ["general.stop_time=2s"]
    static = EnsembleRunner(load_config(SWEEP, base), device="cpu").run()
    stats = EnsembleRunner(load_config(SWEEP, base + [
        "experimental.capacity_plan=auto",
        "experimental.capacity_warmup=1ms",
        "experimental.dispatch_segment=500ms"]), device="cpu").run()
    assert stats.ok and stats.replans >= 1
    assert stats.ensemble["replans"] == stats.replans
    for a, b in zip(stats.ensemble["replicas"],
                    static.ensemble["replicas"]):
        assert a["host_checksums"] == b["host_checksums"]


# ----------------------------------------------------------------------
# a planned mesh on gloo
# ----------------------------------------------------------------------
_ONE = {}


@pytest.mark.parametrize("S", [2, 4])
def test_planned_mesh_picks_the_references_schedule(S, reference):
    """tgen_100 to 4 s on S gloo ranks, `exchange: auto`, planned from a
    3 s warm-up in 1 s segments: the reference's measured marks (the
    ranks' occ_x rows as its pair matrix), estimates, schedule and caps,
    and the one-device trace."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.device import runner

    if "one" not in _ONE:
        _ONE["one"] = runner.run(load_config(TGEN_100, TGEN_BASE),
                                 device="cpu")
    one = _ONE["one"]
    cfg = load_config(TGEN_100, TGEN_BASE + MESH_PLAN +
                      [f"experimental.mesh_shards={S}"])
    with tempfile.TemporaryDirectory() as d:
        old = os.environ.get("SHADOW_TPU_OCC_DIR")
        os.environ["SHADOW_TPU_OCC_DIR"] = d
        try:
            (stats, _), = runner.mesh_runs(["cpu"] * S, [cfg])
        finally:
            if old is None:
                del os.environ["SHADOW_TPU_OCC_DIR"]
            else:
                os.environ["SHADOW_TPU_OCC_DIR"] = old
    rec = stats.occupancy
    want = _json(reference, f"mesh/{S}")
    assert rec["measured"] == want["measured"]
    assert rec["exchange_auto"] == want["exchange_auto"]
    assert rec["planned"] == want["planned"]
    assert stats.mesh["exchange"] == want["exchange_auto"]["chosen"]
    if stats.mesh["exchange"] != "all_gather":
        assert stats.mesh["cap"] == rec["planned"]["exchange_capacity"]
    assert stats.ok and stats.replans == 0
    assert stats.rounds == one.rounds
    assert stats.events_executed == one.events_executed
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  one.host_trace_checksum)


# ----------------------------------------------------------------------
# the JAX child
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu.config import load_config, load_config_str
    from shadow_tpu.core.controller import Controller
    from shadow_tpu.device import capacity

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    # the compile cache off; one shard (the child sees 8 virtual
    # devices, and mesh_shards 0 would take them all)
    off = ["experimental.compile_cache=off"]
    one = off + ["experimental.mesh_shards=1"]
    occ = os.environ["SHADOW_TPU_OCC_DIR"]

    def run(yaml_text, ovr=()):
        c = Controller(load_config_str(yaml_text, list(ovr) + one))
        stats = c.run()
        return c, stats

    def keep(key, c, stats):
        out[f"{key}/chk"] = np.array([h.trace_checksum
                                      for h in c.sim.hosts], np.int64)
        out[f"{key}/n_exec"] = np.array([h.events_executed
                                         for h in c.sim.hosts], np.int64)
        for f in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "rounds", "replans"):
            out[f"{key}/{f}"] = np.int64(getattr(stats, f))
        rec = stats.occupancy or {}
        for f in ("planned", "static", "measured", "final_measured",
                  "applied"):
            if f in rec:
                out[f"{key}/{f}"] = np.array(json.dumps(rec[f]))

    for name in ("static", "planned", "forced"):
        for f in os.listdir(occ) if os.path.isdir(occ) else ():
            os.unlink(os.path.join(occ, f))
        c, stats = run(job["phold"][name])
        keep(f"phold/{name}", c, stats)
        if name == "planned":
            (path,) = [os.path.join(occ, f) for f in os.listdir(occ)]
            with open(path) as f:
                out["phold/planned/record"] = np.array(f.read())
            c, stats = run(job["phold"]["static"],
                           [f"experimental.capacity_plan={path}"])
            keep("phold/replay", c, stats)
    c, stats = run(job["phold"]["static"], [
        f"experimental.capacity_plan={job['port_record']}"])
    keep("phold/port_record", c, stats)

    # the heartbeat rows, as test_device_heartbeats.py reads them
    class Rows(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.rows = []

        def emit(self, record):
            m = record.getMessage()
            if "[shadow-heartbeat] [node] " in m:
                self.rows.append(m.split("[shadow-heartbeat] [node] ")[1])

    handler = Rows()
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    for name, text in job["hb"].items():
        c, stats = run(text)
        keep(f"hb/{name}", c, stats)
    logging.getLogger().removeHandler(handler)
    out["hb/rows"] = np.array(json.dumps(handler.rows))

    for name, (kind, src, ovr) in job["fingerprints"].items():
        cfg = (load_config(src, ovr + one) if kind == "file"
               else load_config_str(src, ovr + one))
        app = Controller(cfg).runner.app
        out[f"fp/{name}"] = np.array(capacity.app_fingerprint(app))
        out[f"scalars/{name}"] = np.array(json.dumps(
            capacity.app_scalars(app)))

    for i, (rec, S) in enumerate(zip(job["records"], job["shards"])):
        out[f"planner/{i}"] = np.array(json.dumps(
            planner_outputs(capacity, rec, S)))

    for which, st in job["heaps"].items():
        st = {k: np.asarray(v, np.int32 if k == "head" else np.int64)
              for k, v in st.items()}
        for k, v in capacity.grow_heaps(st, 9).items():
            out[f"heaps/{which}/{k}"] = np.asarray(v)

    for S, (path, ovr) in job["mesh"].items():
        c = Controller(load_config(path, ovr + off))
        stats = c.run()
        rec = stats.occupancy
        out[f"mesh/{S}"] = np.array(json.dumps(
            {k: rec[k] for k in ("measured", "exchange_auto", "planned")}))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
