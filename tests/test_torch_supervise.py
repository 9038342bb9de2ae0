"""Supervised runs of the port (shadow_tpu_torch/device/supervise.py:
rotation, the preemption drain, dispatch retry and the hybrid failover;
device/chaos.py; the campaign's per-batch rotation; the mesh's
checkpoints) against the reference package's, on the CPU, with
tests/test_supervise.py's, test_chaos.py's and
test_ensemble_batch_preempt.py's configs cut from 800 ms to 400 ms of
simulated time (their boundaries from 200 ms to 100 ms multiples: the
port's plain path takes about 10 ms of wall a window there):

* rotation and pruning, a drain requested through the guard after the
  third boundary (the resume checkpoint the newest of the kept
  entries, stamped audited), the resume from the base path with the
  audit off and on; a real SIGTERM to a `--device cpu` CLI child once
  its first rotation entry exists (exit 75), then a resume;
* `resolve_checkpoint` skipping a truncated newest entry; atomic JSON;
* the batched campaign (replica_batch 2 of 4) drained in its second
  batch, resumed from the batch's entry, equal replica by replica to
  the JAX engine's uninterrupted campaign;
* a chaos `dispatch_error` retried (one retry, equal to the JAX
  engine's run of the same drill), a non-transient one raised, two
  unrelated transient errors each absorbed under one retry, a repeated
  out-of-memory error refused naming item 13, `checkpoint_corrupt`
  falling back to the previous entry, the injector not leaked between
  runs, the guard installed only where boundaries exist;
* `failover: hybrid` finishing the run on the hybrid policy with the
  device run's traces, its checkpoint resumed by the device engine, and
  a failover whose persist fails, with one diagnostic;
* the schema refusals of test_supervise.py and test_chaos.py with the
  reference's text, and what stays refused naming its ROADMAP item;
* a gloo mesh of 2 CPU ranks saved half way, and drained by a SIGTERM
  to a CLI parent (forwarded to the ranks, drained at one boundary by
  their reduced flag), each resumed on 2 ranks equal to one device, and
  the checkpoint refused on 4 ranks and on one device with the
  reference's geometry message.

Tolerance everywhere is exact equality. The JAX reference runs in one
child process (this file's __main__ branch, one CPU device, its compile
cache off), started before the first test under the jax batching patch
the reference needs; the patch never runs in the pytest process.
"""

import glob
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_supervise.py's and test_chaos.py's YAML, to 400 ms
YAML = """
general:
  stop_time: 400ms
  seed: 9
network:
  graph:
    type: 1_gbit_switch
experimental:
  scheduler_policy: tpu
  event_capacity: 48
{extra}
hosts:
  left:
    quantity: 3
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 10ms}}
  right:
    quantity: 3
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 10ms}}
"""

# tests/test_ensemble_batch_preempt.py's ENSEMBLE_YAML, to 400 ms
ENSEMBLE_YAML = """
general:
  stop_time: 400ms
  seed: 9
  heartbeat_interval: 100ms
network:
  graph:
    type: 1_gbit_switch
experimental:
  scheduler_policy: tpu
  event_capacity: 48
ensemble:
  replicas: 4
  replica_batch: 2
  vary:
    seed: [9, 11, 13, 15]
hosts:
  left:
    quantity: 3
    processes:
    - {path: model:phold, args: msgload=2, start_time: 10ms}
  right:
    quantity: 3
    processes:
    - {path: model:phold, args: msgload=2, start_time: 10ms}
"""

RETRY = ("  dispatch_segment: 100ms\n"
         "  dispatch_retries: 2\n"
         "  dispatch_retry_backoff: 0.0\n"
         "  chaos:\n"
         "  - {kind: dispatch_error, segment: 1, "
         "error: RESOURCE_EXHAUSTED}")

CAMPAIGN = """
ensemble:
  replicas: 2
  vary:
    seed: [1, 2]
"""

# the schema refusals: name -> config text; each raises ValueError at
# load in both packages
SCHEMA = {
    "every_no_save": YAML.format(extra="  checkpoint_every: 100ms"),
    "every_and_time": YAML.format(
        extra="  checkpoint_save: /tmp/x.npz\n  checkpoint_every: 100ms\n"
              "  checkpoint_save_time: 1s"),
    "keep_0": YAML.format(
        extra="  checkpoint_save: /tmp/x.npz\n  checkpoint_every: 100ms\n"
              "  checkpoint_keep: 0"),
    "retries_neg": YAML.format(extra="  dispatch_retries: -1"),
    "failover_bad": YAML.format(extra="  failover: sideways"),
    "serial_audit": YAML.format(extra="  state_audit: true").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial"),
    "serial_retries": YAML.format(extra="  dispatch_retries: 2").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial"),
    "serial_failover": YAML.format(extra="  failover: hybrid").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial"),
    "campaign_hybrid": YAML.format(extra="  failover: hybrid") + CAMPAIGN,
    "chaos_kind": YAML.format(
        extra="  chaos:\n  - {kind: sideways, segment: 1}"),
    "chaos_loss_shard": YAML.format(
        extra="  chaos:\n  - {kind: device_loss, segment: 1}"),
    "chaos_no_segment": YAML.format(
        extra="  chaos:\n  - {kind: dispatch_error}"),
    "chaos_no_entry": YAML.format(
        extra="  chaos:\n  - {kind: checkpoint_corrupt}"),
    "chaos_no_store": YAML.format(
        extra="  chaos:\n  - {kind: cache_store_fail}"),
    "chaos_scope": YAML.format(
        extra="  chaos:\n  - {kind: cache_store_fail, store: 0, shard: 1}"),
    "mesh_neg": YAML.format(extra="  mesh_shards: -1"),
    "serial_chaos": YAML.format(
        extra="  chaos:\n  - {kind: cache_store_fail, store: 0}").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial"),
    "serial_mesh": YAML.format(extra="  mesh_shards: 2").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial"),
}


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
        # one device: the reference's single-shard program, like the port
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


@pytest.fixture(scope="module")
def workdir():
    d = tempfile.mkdtemp(prefix="torch_supervise_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def reference_child(workdir):
    d = os.path.join(workdir, "child")
    os.makedirs(d)
    job = {"yaml": YAML, "retry": RETRY, "ensemble": ENSEMBLE_YAML,
           "schema": SCHEMA}
    child = ReferenceChild(job, d)
    try:
        yield child
    finally:
        child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _cfg(extra=""):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(YAML.format(extra=extra))


def _run(extra=""):
    from shadow_tpu_torch.core.controller import Controller

    return Controller(_cfg(extra), device="cpu").run()


def _sig(stats):
    return (stats.events_executed, stats.packets_sent,
            stats.packets_dropped, stats.packets_delivered,
            stats.host_trace_checksum.tolist())


def _ref_sig(ref, key):
    return (int(ref[f"{key}/events_executed"]),
            int(ref[f"{key}/packets_sent"]),
            int(ref[f"{key}/packets_dropped"]),
            int(ref[f"{key}/packets_delivered"]),
            ref[f"{key}/chk"].tolist())


@pytest.fixture(scope="module")
def full():
    stats = _run()
    assert stats.ok
    return _sig(stats)


# ----------------------------------------------------------------------
# atomic writes, rotation resolution
# ----------------------------------------------------------------------
def test_atomic_write_json_lands_whole_or_not_at_all(tmp_path):
    from shadow_tpu_torch.utils.artifacts import atomic_write_json

    path = str(tmp_path / "sub" / "rec.json")
    atomic_write_json({"a": 1, "b": [2, 3]}, path)
    with open(path) as f:
        assert json.load(f) == {"a": 1, "b": [2, 3]}
    assert os.listdir(os.path.dirname(path)) == ["rec.json"]
    with pytest.raises(TypeError):
        atomic_write_json({"bad": object()}, str(tmp_path / "x.json"))
    assert not glob.glob(str(tmp_path / "x.json*"))


def test_resolve_checkpoint_skips_corrupt_newest(tmp_path):
    from shadow_tpu_torch.device import supervise

    base = str(tmp_path / "ck.npz")
    good = f"{base}.t{500:015d}"
    bad = f"{base}.t{900:015d}"
    meta = {"format": 1, "sim_time": 500, "final_stop": 0,
            "fingerprint": {}, "keys": []}
    with open(good, "wb") as f:
        np.savez_compressed(f, __meta__=json.dumps(meta))
    with open(bad, "wb") as f:
        f.write(b"PK\x03\x04 not really an npz")
    with open(f"{base}.t12.tmp", "wb") as f:
        f.write(b"in flight")
    assert [p for _, p in supervise.rotation_entries(base)] == [good, bad]
    assert supervise.resolve_checkpoint(base) == good
    assert supervise.resolve_checkpoint(good) == good
    with pytest.raises(ValueError, match="nothing to resume"):
        supervise.resolve_checkpoint(str(tmp_path / "absent.npz"))


# ----------------------------------------------------------------------
# rotation, the drain, resume
# ----------------------------------------------------------------------
def test_rotation_prune_preempt_and_resume(tmp_path, full, reference,
                                           monkeypatch):
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import checkpoint, runner, supervise
    from shadow_tpu_torch.device.engine import DeviceEngine

    assert full == _ref_sig(reference, "full")
    base = str(tmp_path / "ck.npz")
    cfg = _cfg(f"  checkpoint_save: {base}\n  checkpoint_every: 100ms\n"
               "  checkpoint_keep: 2\n  state_audit: true")
    dr = runner.DeviceRunner(cfg, build(cfg), "cpu")
    orig = DeviceEngine.run
    calls = {"n": 0}

    def poking(self, state, stop=None, final_stop=None):
        out = orig(self, state, stop=stop, final_stop=final_stop)
        calls["n"] += 1
        if calls["n"] == 3:
            dr.guard.request()
        return out

    monkeypatch.setattr(DeviceEngine, "run", poking)
    pre = dr.run()
    monkeypatch.setattr(DeviceEngine, "run", orig)
    assert pre.preempted and pre.end_time == 300_000_000
    rot = supervise.rotation_entries(base)
    assert len(rot) == 2 and rot[-1][1] == pre.resume_path
    assert checkpoint.peek_meta(rot[-1][1])["audit"] == {
        "enabled": True, "violations": 0}
    assert not os.path.exists(base)
    assert pre.events_executed < full[0]
    res = _run(f"  checkpoint_load: {base}")
    assert res.ok and not res.preempted and _sig(res) == full
    res2 = _run(f"  checkpoint_load: {base}\n  state_audit: true")
    assert res2.ok and _sig(res2) == full


def test_sigterm_to_a_cli_child_exits_75_and_resumes(tmp_path, full):
    """A real SIGTERM to `python -m shadow_tpu_torch.cli ... --device
    cpu` once its first rotation entry exists: the child drains at the
    next boundary and exits 75; the resume from the base path finishes
    equal to the uninterrupted run."""
    from shadow_tpu_torch.device import supervise

    base = str(tmp_path / "cli.npz")
    path = str(tmp_path / "run.yaml")
    with open(path, "w") as f:
        f.write(YAML.format(extra=f"  checkpoint_save: {base}\n"
                                  "  checkpoint_every: 50ms"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.cli", path, "--device",
         "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not supervise.rotation_entries(base):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, out[-3000:]
    assert "run preempted at" in out and "(rc 75)" in out
    res = _run(f"  checkpoint_load: {base}\n"
               f"  checkpoint_save: {base}\n  checkpoint_every: 50ms")
    assert res.ok and _sig(res) == full


def test_batched_campaign_drained_and_resumed_equal_to_jax(
        tmp_path, reference, monkeypatch):
    """test_ensemble_batch_preempt.py's batched campaign, drained in its
    second batch (the guard's request after the sixth segment), then
    resumed from that batch's rotation entry: every replica equal to
    the JAX engine's uninterrupted campaign."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import checkpoint
    from shadow_tpu_torch.device.engine import DeviceEngine
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    base = str(tmp_path / "ck.npz")
    ovr = [f"experimental.checkpoint_save={base}",
           "experimental.checkpoint_every=100ms"]
    er = EnsembleRunner(load_config_str(ENSEMBLE_YAML, ovr), device="cpu")
    orig = DeviceEngine.run
    calls = {"n": 0}

    def poking(self, state, stop=None, final_stop=None):
        out = orig(self, state, stop=stop, final_stop=final_stop)
        calls["n"] += 1
        if calls["n"] == 6:
            er.guard.request()
        return out

    monkeypatch.setattr(DeviceEngine, "run", poking)
    pre = er.run()
    monkeypatch.setattr(DeviceEngine, "run", orig)
    assert pre.preempted and ".b1.t" in pre.resume_path
    assert pre.end_time == 200_000_000
    meta = checkpoint.peek_meta(pre.resume_path)["ensemble"]
    assert (meta["replica_lo"], meta["replica_hi"],
            meta["replica_batch"]) == (2, 4, 2)
    res = EnsembleRunner(load_config_str(ENSEMBLE_YAML, ovr + [
        f"experimental.checkpoint_load={base}.b1"]), device="cpu").run()
    assert res.ok and not res.preempted
    sig = [[e["host_checksums_sha256"], e["events_executed"],
            e["packets_sent"], e["packets_dropped"], e["packets_delivered"]]
           for e in res.ensemble["replicas"]]
    assert sig == json.loads(str(reference["ensemble/sig"]))
    # a batch entry under another replica_batch is refused
    with pytest.raises(ValueError, match="set ensemble.replica_batch: 2"):
        EnsembleRunner(load_config_str(ENSEMBLE_YAML, ovr + [
            f"experimental.checkpoint_load={pre.resume_path}",
            "ensemble.replica_batch=1"]), device="cpu").run()


# ----------------------------------------------------------------------
# retry, chaos, failover
# ----------------------------------------------------------------------
def test_one_shot_dispatch_error_retries_equal(full, reference):
    """test_chaos.py:229: a scripted transient error at the second
    dispatch retries once from the validated copy, equal to the
    uninterrupted run and to the JAX engine's run of the same drill; a
    non-transient class is raised, never retried."""
    from shadow_tpu_torch.device import chaos as chaosmod

    stats = _run(RETRY)
    assert stats.ok and stats.retries == 1
    assert int(reference["retry/retries"]) == 1
    assert _sig(stats) == full == _ref_sig(reference, "retry")
    p = stats.pipeline
    assert p["replayed"] == 1 and len(p["recover_s"]) == 1 and \
        len(p["replay_s"]) == 1
    with pytest.raises(chaosmod.ChaosError, match="INVALID_ARGUMENT"):
        _run("  dispatch_segment: 100ms\n  dispatch_retries: 5\n"
             "  chaos:\n  - {kind: dispatch_error, segment: 1, "
             "error: INVALID_ARGUMENT}")


def test_retry_budget_is_per_incident_and_oom_repeat_refused(
        full, monkeypatch):
    """test_supervise.py:222: two transient errors in different segments
    each recover under `dispatch_retries: 1`; a non-transient error is
    raised; the same out-of-memory error twice at one boundary raises,
    naming the unported ladder's ROADMAP item."""
    from shadow_tpu_torch.device.engine import DeviceEngine

    orig = DeviceEngine.run
    calls = {"n": 0}

    def flaky_twice(self, state, stop=None, final_stop=None):
        calls["n"] += 1
        if calls["n"] in (2, 5):
            raise RuntimeError("UNAVAILABLE: injected hiccup")
        return orig(self, state, stop=stop, final_stop=final_stop)

    monkeypatch.setattr(DeviceEngine, "run", flaky_twice)
    stats = _run("  dispatch_retries: 1\n  dispatch_retry_backoff: 0.0\n"
                 "  dispatch_segment: 100ms")
    assert stats.ok and stats.retries == 2 and _sig(stats) == full

    def broken(self, state, stop=None, final_stop=None):
        raise RuntimeError("INVALID_ARGUMENT: bug")

    monkeypatch.setattr(DeviceEngine, "run", broken)
    with pytest.raises(RuntimeError, match="INVALID_ARGUMENT"):
        _run("  dispatch_retries: 5\n  dispatch_retry_backoff: 0.0")
    monkeypatch.setattr(DeviceEngine, "run", orig)
    with pytest.raises(RuntimeError, match=r"queue \(a\) item 13"):
        _run("  dispatch_segment: 100ms\n  dispatch_retries: 5\n"
             "  dispatch_retry_backoff: 0.0\n  chaos:\n"
             "  - {kind: dispatch_error, segment: 1, error: "
             "RESOURCE_EXHAUSTED}\n"
             "  - {kind: dispatch_error, segment: 2, error: "
             "RESOURCE_EXHAUSTED}")


def test_checkpoint_corrupt_engages_newest_readable(tmp_path, full):
    """test_chaos.py:250: the third rotation entry truncated on disk; the
    run goes on, the base path resolves to the second entry, whose
    resume finishes equal."""
    from shadow_tpu_torch.device import checkpoint, supervise

    base = str(tmp_path / "rot.npz")
    stats = _run(f"  checkpoint_save: {base}\n  checkpoint_every: 100ms\n"
                 "  checkpoint_keep: 8\n  dispatch_segment: 100ms\n"
                 "  chaos:\n  - {kind: checkpoint_corrupt, entry: 2}")
    assert stats.ok and _sig(stats) == full
    entries = supervise.rotation_entries(base)
    newest = entries[-1][1]
    os.unlink(base)
    resolved = supervise.resolve_checkpoint(base)
    assert resolved == entries[-2][1] != newest
    with pytest.raises(Exception):
        checkpoint.peek_meta(newest)
    res = _run(f"  checkpoint_load: {base}")
    assert res.ok and _sig(res) == full


def test_injector_not_leaked_and_guard_needs_boundaries(tmp_path):
    """test_chaos.py:291 and test_supervise.py:320: a run without a
    schedule installs no injector; a checkpoint_save run without
    boundaries installs no guard, one with a dispatch segment does."""
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import chaos as chaosmod
    from shadow_tpu_torch.device import runner

    cfg = _cfg("  chaos:\n  - {kind: checkpoint_corrupt, entry: 999}")
    dr = runner.DeviceRunner(cfg, build(cfg), "cpu")
    assert dr.chaos is not None and chaosmod.current() is dr.chaos
    cfg = _cfg(f"  checkpoint_save: {tmp_path / 'solo.npz'}")
    dr = runner.DeviceRunner(cfg, build(cfg), "cpu")
    assert chaosmod.current() is None
    assert dr.run().ok and dr.guard is None
    cfg = _cfg(f"  checkpoint_save: {tmp_path / 'seg.npz'}\n"
               "  dispatch_segment: 200ms")
    dr = runner.DeviceRunner(cfg, build(cfg), "cpu")
    assert dr.run().ok and dr.guard is not None


def test_failover_to_hybrid_finishes_the_run(tmp_path, full, monkeypatch,
                                             caplog):
    """test_supervise.py:292: every dispatch dead; retries spent, the
    validated state persisted and the run finished on the hybrid policy
    with the device run's traces; the failover checkpoint resumes on
    the device engine to the same result."""
    from shadow_tpu_torch.device.engine import DeviceEngine

    orig = DeviceEngine.run

    def dead(self, state, stop=None, final_stop=None):
        raise RuntimeError("UNAVAILABLE: device went away")

    monkeypatch.setattr(DeviceEngine, "run", dead)
    with caplog.at_level(logging.ERROR):
        stats = _run(f"  failover: hybrid\n"
                     f"  checkpoint_save: {tmp_path / 'fo.npz'}\n"
                     "  dispatch_segment: 100ms")
    monkeypatch.setattr(DeviceEngine, "run", orig)
    assert stats.ok and stats.policy == "hybrid"
    assert stats.failover_checkpoint == str(tmp_path / "fo.npz.failover")
    assert os.path.exists(stats.failover_checkpoint)
    assert any("DEVICE FAILOVER" in r.getMessage() for r in caplog.records)
    assert _sig(stats) == full
    res = _run(f"  checkpoint_load: {stats.failover_checkpoint}")
    assert res.ok and _sig(res) == full


def test_failover_persist_failure_still_runs_hybrid(full, monkeypatch,
                                                    caplog):
    """test_chaos.py:341: no state could be saved; the hybrid rerun
    still finishes, `failover_checkpoint` empty, one diagnostic naming
    the persist error."""
    from shadow_tpu_torch.device import checkpoint
    from shadow_tpu_torch.device.engine import DeviceEngine

    def dead(self, state, stop=None, final_stop=None):
        raise RuntimeError("UNAVAILABLE: device went away")

    def unsavable(engine, state, path, sim_time, **kw):
        raise OSError("disk full: injected persist failure")

    monkeypatch.setattr(DeviceEngine, "run", dead)
    monkeypatch.setattr(checkpoint, "save_state", unsavable)
    with caplog.at_level(logging.ERROR):
        stats = _run("  failover: hybrid\n  dispatch_segment: 100ms")
    assert stats.ok and stats.failover_checkpoint == ""
    assert _sig(stats) == full
    diags = [r.getMessage() for r in caplog.records
             if "DEVICE FAILOVER" in r.getMessage()]
    assert len(diags) == 1, diags
    assert "injected persist failure" in diags[0]
    assert "NO device-side resume point" in diags[0]


# ----------------------------------------------------------------------
# the schema and the refusals
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SCHEMA))
def test_schema_refusals_carry_the_reference_text(name, reference):
    from shadow_tpu_torch.config import load_config_str

    with pytest.raises(ValueError) as e:
        load_config_str(SCHEMA[name])
    assert str(e.value) == str(reference[f"schema/{name}"])


@pytest.mark.parametrize("extra,item", [
    ("  failover: shrink", "item 13"),
    ("  chaos:\n  - {kind: oom, segment: 1}", "item 13"),
    ("  chaos:\n  - {kind: server_crash, tick: 0}", "item 14"),
    ("  mesh_shards: 2\n  failover: hybrid", "item 13"),
    ("  mesh_shards: 2\n  chaos:\n  - {kind: dispatch_error, segment: 1}",
     "item 13"),
    ("  round_watchdog_dump: stall.txt", "item 13"),
])
def test_unported_supervision_refused_by_roadmap_item(extra, item):
    """What stays refused names its item: a scripted out-of-memory error
    and the watchdog (item 13), the server (item 14). What ROADMAP (a)
    item 13.1 admitted builds: a campaign's `failover: shrink` (it may
    name it at load, test_chaos.py:117), the hybrid failover and chaos
    on a mesh."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import OutsideSlice, build

    text = YAML.format(extra=extra)
    if "shrink" in extra:
        text += CAMPAIGN
    if "shrink" in extra or "mesh_shards" in extra:
        assert build(load_config_str(text)).app is not None
        return
    with pytest.raises(OutsideSlice, match=rf"queue \(a\) {item}"):
        build(load_config_str(text))


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
def test_mesh_save_drain_resume_and_geometry(tmp_path, full):
    """2 gloo CPU ranks: saved at 200 ms (gathered to rank 0, stamped 2
    shards); a `--device cpu` CLI child on 2 ranks rotating every 50 ms,
    SIGTERM to the parent once its first entry exists: forwarded to the
    ranks, whose reduced flag drains both at one boundary (exit 75);
    both resumed on 2 ranks, equal to one device; the checkpoint, once
    refused on 4 ranks and on one device, adopted on both since ROADMAP
    (a) item 13.1: 2 of the 4 ranks run it, and the one-device resume
    runs on 2 CPU ranks, both equal to one device; a pool of one rank
    refused with the reference's message."""
    from shadow_tpu_torch.device import checkpoint, runner, supervise

    ck = str(tmp_path / "mesh.npz")
    base = str(tmp_path / "drain.npz")
    (part, _), = runner.mesh_runs(["cpu"] * 2, [_cfg(
        f"  mesh_shards: 2\n  checkpoint_save: {ck}\n"
        "  checkpoint_save_time: 200ms")])
    assert part.ok and part.end_time == 200_000_000
    assert checkpoint.peek_meta(ck)["geometry"] == {
        "n_shards": 2, "h_pad": 6, "h_loc": 3}
    path = str(tmp_path / "mesh.yaml")
    with open(path, "w") as f:
        f.write(YAML.format(extra=f"  mesh_shards: 2\n  checkpoint_save: "
                                  f"{base}\n  checkpoint_every: 50ms"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.cli", path, "--device",
         "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not supervise.rotation_entries(base):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, out[-3000:]
    assert out.count("run preempted at") == 3      # two ranks, the CLI
    (res, _), (res2, _) = runner.mesh_runs(["cpu"] * 2, [
        _cfg(f"  mesh_shards: 2\n  checkpoint_load: {ck}"),
        _cfg(f"  mesh_shards: 2\n  checkpoint_load: {base}")])
    assert res.ok and _sig(res) == full
    assert res2.ok and _sig(res2) == full
    (res4, _), = runner.mesh_runs(["cpu"] * 4, [_cfg(
        f"  mesh_shards: 4\n  checkpoint_load: {ck}")])
    assert res4.ok and res4.mesh["shards"] == 2 and _sig(res4) == full
    assert [r.get("left", False) for r in res4.mesh["ranks"]] == [
        False, False, True, True]
    one = _run(f"  checkpoint_load: {ck}")
    assert one.ok and one.mesh["shards"] == 2 and _sig(one) == full
    want = ("saved on 2 shard(s) but only 1 device(s) are available — "
            "resume on a pool of at least the saved shard count")
    with pytest.raises(ValueError, match=want.replace("(", r"\(")
                       .replace(")", r"\)")):
        runner.mesh_runs(["cpu"], [_cfg(f"  checkpoint_load: {ck}")])


def test_mesh_save_then_resume_in_one_call(tmp_path, full):
    """One `mesh_runs` call on 2 gloo CPU ranks: the save half way, then
    the resume of the checkpoint it wrote (the geometry check left to
    the ranks, the file not being there when the call starts), the
    leaves kept for the resume alone; the resume equals one device. A
    flag list of another length than the configs is refused."""
    from shadow_tpu_torch.device import runner

    ck = str(tmp_path / "once.npz")
    cfgs = [_cfg(f"  mesh_shards: 2\n  checkpoint_save: {ck}\n"
                 "  checkpoint_save_time: 200ms"),
            _cfg(f"  mesh_shards: 2\n  checkpoint_load: {ck}")]
    (part, no_leaves), (res, leaves) = runner.mesh_runs(
        ["cpu"] * 2, cfgs, keep_state=[False, True])
    assert part.ok and part.end_time == 200_000_000 and no_leaves is None
    assert res.ok and _sig(res) == full
    assert np.array_equal(leaves["n_exec"][:len(res.host_events_executed)],
                          res.host_events_executed)
    with pytest.raises(ValueError, match="1 flags for 2 configs"):
        runner.mesh_runs(["cpu"] * 2, cfgs, timing=[False])


# ----------------------------------------------------------------------
# the JAX child
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    off = ["experimental.compile_cache=off"]

    def run(text):
        c = Controller(load_config_str(text, off))
        return c, c.run()

    def keep(key, c, stats):
        out[f"{key}/chk"] = np.array([h.trace_checksum
                                      for h in c.sim.hosts], np.int64)
        for f in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "retries"):
            out[f"{key}/{f}"] = np.int64(getattr(stats, f))

    for name, text in job["schema"].items():
        try:
            load_config_str(text)
        except ValueError as e:
            out[f"schema/{name}"] = np.array(str(e))
        else:
            raise AssertionError(f"{name}: not refused")
    keep("full", *run(job["yaml"].format(extra="")))
    keep("retry", *run(job["yaml"].format(extra=job["retry"])))
    _, stats = run(job["ensemble"])
    out["ensemble/sig"] = np.array(json.dumps(
        [[e["host_checksums_sha256"], int(e["events_executed"]),
          int(e["packets_sent"]), int(e["packets_dropped"]),
          int(e["packets_delivered"])] for e in stats.ensemble["replicas"]]))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
