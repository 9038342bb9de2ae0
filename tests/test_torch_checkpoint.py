"""Device-state checkpoints of the port (shadow_tpu_torch/device/
checkpoint.py, the runner's checkpoint block) against the reference
package's, on the CPU, with tests/test_checkpoint.py's configs:

* its tgen config and its Tor config (examples/tor_small.yaml, cut
  from its 12 s to 6 s and paused at 3.5 s, not 7 s, as
  tests/test_torch_tor.py cuts it for time): the port's pause, save and
  resume equal to the port's
  uninterrupted run and to the JAX engine's, the pair's rounds summing
  to the uninterrupted run's;
* across the packages: the port resumes a checkpoint the JAX engine
  wrote, and the JAX engine resumes one the port wrote, both equal to
  the uninterrupted run; the port's meta and leaf keys are the
  reference's;
* the engine fingerprints of both packages equal on PHOLD, the tgen
  config, Tor, a factored star (hierarchical tables) and a link-fault
  schedule;
* every refusal of test_checkpoint.py with the reference's own text (the
  JAX child raises each on the same edit, its message compared with the
  checkpoint's path blanked): a seed, topology and bandwidth edit, an
  unwritable path, a save time without a path, a CPU policy, a resume at
  or past the stop, toward another stop, a layout change; and every
  admission: another `burst_pops`, a checkpoint without the occ_*
  leaves, the saved capacities adopted under a plan (and by a planned
  resume of a static save's config), a resume cut by dispatch segments.

Tolerance everywhere is exact equality. The JAX reference runs in one
child process (this file's __main__ branch, one CPU device, its compile
cache off), started before the first test under the jax batching patch
the reference needs; the patch never runs in the pytest process.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOR_SMALL = os.path.join(ROOT, "examples", "tor_small.yaml")

# tests/test_checkpoint.py's YAML
YAML = """
general:
  stop_time: 3s
  seed: 11
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.1 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.1 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.1 ]
      ]
experimental:
  scheduler_policy: tpu
  event_capacity: 192
  outbox_capacity: 256
{extra}
hosts:
  server:
    network_node_id: 0
    processes:
    - path: model:tgen_server
      start_time: 10ms
  client:
    quantity: 6
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=server size=200KiB count=3 pause=150ms retry=250ms
      start_time: 100ms
"""

# tests/test_torch_hier.py's STAR (test_hierarchy.py's STAR_CFG)
STAR = """
general: {stop_time: 500ms, seed: 3}
network:
  topology:
    representation: hierarchical
  graph:
    type: star_clusters
    clusters: 2
    spokes_per_cluster: 3
    hub_latency: 10 ms
    access_latency: 1 ms
experimental:
  scheduler_policy: tpu
hosts:
  server:
    network_node_id: 2
    processes: [{path: "model:tgen_server", start_time: 10ms}]
  client:
    quantity: 3
    network_node_id: 3
    network_node_stride: 1
    processes:
    - path: model:tgen_client
      args: server=server size=20KiB count=1 pause=50ms retry=200ms
      start_time: 50ms
"""

PHOLD = """
general: {stop_time: 800ms, seed: 9}
network:
  graph:
    type: 1_gbit_switch
experimental:
  scheduler_policy: tpu
  event_capacity: 48
hosts:
  left:
    quantity: 3
    processes:
    - {path: model:phold, args: msgload=2, start_time: 10ms}
"""

FAULTS = ("network.faults=[{kind: link_down, time: 1s, source: 0, "
          "target: 1}, {kind: link_up, time: 2s, source: 0, target: 1}]")

PAUSE = "  checkpoint_save: {ck}\n  checkpoint_save_time: 1500ms"
TOR_STOP, TOR_PAUSE = "6s", "3500ms"

# the refusals: (config text, overrides), with {ck} the package's own
# paused tgen checkpoint; each raises ValueError in both packages
EDITS = {
    "seed": YAML.replace("seed: 11", "seed: 12"),
    "topology": YAML.replace('latency "20 ms"', 'latency "25 ms"'),
    "bandwidth": YAML.replace('id 1 bandwidth_down "1 Gbit"',
                              'id 1 bandwidth_down "500 Mbit"'),
    "stop": YAML.replace("stop_time: 3s", "stop_time: 4s"),
}


def tgen(extra: str = "") -> str:
    return YAML.format(extra=extra)


def fingerprint_jobs() -> dict:
    """name -> (config text or path, overrides, is a path)."""
    return {"phold": (PHOLD, [], False), "tgen": (tgen(), [], False),
            "tor": (TOR_SMALL, [f"general.stop_time={TOR_STOP}"], True),
            "star": (STAR, [], False),
            "faults": (tgen(), [FAULTS], False),
            "star_faults": (STAR, ["network.faults=[{kind: link_down, "
                                   "time: 100ms, source: 0, target: 2}]"],
                            False)}


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


def _port_run(text_or_path, overrides=(), is_path=False):
    from shadow_tpu_torch.config import load_config, load_config_str
    from shadow_tpu_torch.device import runner

    cfg = (load_config(text_or_path, list(overrides)) if is_path
           else load_config_str(text_or_path, list(overrides)))
    return runner.run(cfg, device="cpu")


@pytest.fixture(scope="module")
def workdir():
    d = tempfile.mkdtemp(prefix="torch_checkpoint_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def port_written(workdir):
    """The port's paused tgen and Tor checkpoints (and the paused runs'
    stats), made before the child starts so that it can resume them."""
    tg = os.path.join(workdir, "port_tgen.npz")
    tor = os.path.join(workdir, "port_tor.npz")
    return {
        "tgen": (tg, _port_run(tgen(PAUSE.format(ck=tg)))),
        "tor": (tor, _port_run(TOR_SMALL, [
            f"general.stop_time={TOR_STOP}",
            f"experimental.checkpoint_save={tor}",
            f"experimental.checkpoint_save_time={TOR_PAUSE}"], True)),
    }


@pytest.fixture(scope="module", autouse=True)
def reference_child(workdir, port_written):
    d = os.path.join(workdir, "child")
    os.makedirs(d)
    job = {"tgen": YAML, "pause": PAUSE, "tor": TOR_SMALL,
           "tor_stop": TOR_STOP, "tor_pause": TOR_PAUSE,
           "port": {k: v[0] for k, v in port_written.items()},
           "fingerprints": fingerprint_jobs(), "edits": EDITS,
           "unwritable": os.path.join(d, "no-such-dir", "state.npz")}
    child = ReferenceChild(job, d)
    try:
        yield child
    finally:
        child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


@pytest.fixture(scope="module")
def port_full():
    return {"tgen": _port_run(tgen()),
            "tor": _port_run(TOR_SMALL, [f"general.stop_time={TOR_STOP}"],
                             True)}


def same_trace(stats, ref, key: str, rounds=None):
    """A port run's per-host checksums and events and its totals equal
    to the reference's run `key`; `rounds` the run's own rounds where
    they must sum to the reference's (a paused pair)."""
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  ref[f"{key}/chk"])
    np.testing.assert_array_equal(stats.host_events_executed,
                                  ref[f"{key}/n_exec"])
    for f in ("events_executed", "packets_sent", "packets_dropped",
              "packets_delivered"):
        assert getattr(stats, f) == int(ref[f"{key}/{f}"]), (key, f)
    if rounds is not None:
        assert rounds == int(ref[f"{key}/rounds"]), key


def same_port(a, b):
    np.testing.assert_array_equal(a.host_trace_checksum,
                                  b.host_trace_checksum)
    np.testing.assert_array_equal(a.host_events_executed,
                                  b.host_events_executed)
    assert (a.events_executed, a.packets_sent, a.packets_dropped,
            a.packets_delivered) == (b.events_executed, b.packets_sent,
                                     b.packets_dropped,
                                     b.packets_delivered)


# ----------------------------------------------------------------------
# pause, save and resume
# ----------------------------------------------------------------------
def test_pause_save_resume_equals_uninterrupted_and_jax(
        workdir, port_written, port_full, reference):
    ck, part = port_written["tgen"]
    full = port_full["tgen"]
    assert full.ok and part.ok
    assert part.events_executed < full.events_executed
    assert part.end_time == 1_500_000_000
    res = _port_run(tgen(f"  checkpoint_load: {ck}"))
    assert res.ok and not res.preempted
    same_port(res, full)
    same_trace(full, reference, "tgen/full")
    same_trace(res, reference, "tgen/full", part.rounds + res.rounds)
    from shadow_tpu_torch.device import checkpoint

    meta = checkpoint.peek_meta(ck)
    assert set(meta["capacities"]) == {
        "event_capacity", "outbox_capacity", "exchange_capacity",
        "exchange_capacity2", "exchange_in_capacity", "outbox_compact"}
    ref_meta = json.loads(str(reference["tgen/meta"]))
    for k in ("format", "sim_time", "final_stop", "fingerprint",
              "geometry", "capacities", "exchange", "keys"):
        assert meta[k] == ref_meta[k], k


def test_tor_pause_resume_equals_uninterrupted_and_jax(
        port_written, port_full, reference):
    ck, part = port_written["tor"]
    full = port_full["tor"]
    assert full.ok and part.ok and part.end_time == 3_500_000_000
    res = _port_run(TOR_SMALL, [f"general.stop_time={TOR_STOP}",
                                f"experimental.checkpoint_load={ck}"],
                    True)
    assert res.ok
    same_port(res, full)
    same_trace(full, reference, "tor/full")
    same_trace(res, reference, "tor/full", part.rounds + res.rounds)


def test_port_resumes_jax_checkpoints(port_full, reference):
    """The JAX engine's paused tgen and Tor checkpoints, resumed by the
    port: equal to the uninterrupted run of either package."""
    res = _port_run(tgen(f"  checkpoint_load: {reference['tgen/ck']}"))
    assert res.ok
    same_port(res, port_full["tgen"])
    same_trace(res, reference, "tgen/full")
    res = _port_run(TOR_SMALL, [
        f"general.stop_time={TOR_STOP}",
        f"experimental.checkpoint_load={reference['tor/ck']}"], True)
    assert res.ok
    same_port(res, port_full["tor"])


def test_jax_resumes_port_checkpoints(reference):
    """The port's paused checkpoints, resumed by the JAX engine: equal
    to its own uninterrupted runs (and the JAX engine's resume of its
    own checkpoint too)."""
    for app in ("tgen", "tor"):
        np.testing.assert_array_equal(reference[f"{app}/port_resume/chk"],
                                      reference[f"{app}/full/chk"])
        for f in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered"):
            assert int(reference[f"{app}/port_resume/{f}"]) == \
                int(reference[f"{app}/full/{f}"])
    np.testing.assert_array_equal(reference["tgen/own_resume/chk"],
                                  reference["tgen/full/chk"])


@pytest.mark.parametrize("name", list(fingerprint_jobs()))
def test_fingerprints_equal_across_packages(name, reference):
    from shadow_tpu_torch.config import load_config, load_config_str
    from shadow_tpu_torch.device import checkpoint, runner

    src, ovr, is_path = fingerprint_jobs()[name]
    cfg = (load_config(src, ovr) if is_path
           else load_config_str(src, ovr))
    engine, _ = runner.make_engine(cfg, device="cpu")
    want = json.loads(str(reference[f"fp/{name}"]))
    assert checkpoint._fingerprint(engine) == want
    if name.endswith("faults"):
        assert want["fault_epochs"] > 1


# ----------------------------------------------------------------------
# refusals, with the reference's text
# ----------------------------------------------------------------------
def _refusal(text, overrides=()):
    with pytest.raises(ValueError) as e:
        _port_run(text, overrides)
    return str(e.value)


def _blank(msg: str, path: str) -> str:
    return msg.replace(path, "<ck>")


@pytest.mark.parametrize("edit", list(EDITS))
def test_edited_config_refused_with_reference_text(edit, port_written,
                                                   reference):
    ck = port_written["tgen"][0]
    msg = _refusal(EDITS[edit].format(extra=f"  checkpoint_load: {ck}"))
    want = str(reference[f"refusal/{edit}"])
    assert _blank(msg, ck) == want
    assert ("stop" if edit == "stop" else "does not match") in msg


def test_other_refusals_with_reference_text(workdir, reference):
    bad = os.path.join(workdir, "no-such-dir", "state.npz")
    msg = _refusal(tgen(f"  checkpoint_save: {bad}"))
    assert "not writable" in msg
    assert msg.replace(bad, "<bad>") == str(reference["refusal/unwritable"])
    msg = _refusal(tgen("  checkpoint_save_time: 1s"))
    assert msg == str(reference["refusal/save_time"])
    assert "checkpoint_save_time" in msg
    msg = _refusal(tgen("  checkpoint_save: /tmp/x.npz").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial"))
    assert msg == str(reference["refusal/policy"])
    assert "scheduler_policy: tpu" in msg
    # a resume at or past the stop (a checkpoint written at the stop)
    end = os.path.join(workdir, "at_stop.npz")
    _port_run(tgen(f"  checkpoint_save: {end}"))
    msg = _refusal(tgen(f"  checkpoint_load: {end}"))
    assert "nothing to resume" in msg
    assert _blank(msg, end) == str(reference["refusal/at_stop"])


def test_layout_change_refused_and_missing_telemetry_admitted(
        workdir, port_written, port_full):
    """A checkpoint without the occ_* leaves loads (zeroed marks) and
    resumes equal; one without a trace leaf is refused as a layout
    change (test_checkpoint.py:227)."""
    src = port_written["tgen"][0]
    ck = os.path.join(workdir, "pre_telemetry.npz")
    with np.load(src, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        saved = {k: z[f"leaf_{i}"] for i, k in enumerate(meta["keys"])}

    def write(keys):
        m = dict(meta, keys=keys)
        with open(ck, "wb") as f:
            np.savez_compressed(f, __meta__=json.dumps(m), **{
                f"leaf_{i}": saved[k] for i, k in enumerate(keys)})

    write([k for k in meta["keys"] if "'occ_" not in k])
    res = _port_run(tgen(f"  checkpoint_load: {ck}"))
    assert res.ok
    same_port(res, port_full["tgen"])
    write([k for k in meta["keys"] if "'occ_" not in k
           and "'overflow'" not in k])
    assert "state layout changed" in _refusal(
        tgen(f"  checkpoint_load: {ck}"))


# ----------------------------------------------------------------------
# admissions
# ----------------------------------------------------------------------
def test_resume_at_different_burst_width(workdir, port_full):
    ck = os.path.join(workdir, "burst.npz")
    _port_run(tgen(PAUSE.format(ck=ck) + "\n  burst_pops: 4"))
    res = _port_run(tgen(f"  checkpoint_load: {ck}\n  burst_pops: 8"))
    assert res.ok
    same_port(res, port_full["tgen"])


def test_resume_with_dispatch_segments(workdir, port_written, port_full):
    res = _port_run(tgen(f"  checkpoint_load: {port_written['tgen'][0]}\n"
                         "  dispatch_segment: 700ms"))
    assert res.ok and res.pipeline["segments"] >= 3
    same_port(res, port_full["tgen"])


def test_resume_adopts_saved_capacities_under_plan(workdir, port_full,
                                                   monkeypatch):
    """A save under `capacity_plan: auto` carries the planner's
    capacities; a planned resume adopts them (skipping the plan), and
    both pairs equal the uninterrupted run (test_checkpoint.py:267)."""
    from shadow_tpu_torch.device import checkpoint

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", os.path.join(workdir, "occ"))
    ck = os.path.join(workdir, "planned.npz")
    plan = "  capacity_plan: auto\n  capacity_warmup: 2500ms\n"
    save = _port_run(tgen(plan + PAUSE.format(ck=ck)))
    assert save.ok
    caps = checkpoint.peek_meta(ck)["capacities"]
    assert caps["event_capacity"] != 192
    res = _port_run(tgen(plan + f"  checkpoint_load: {ck}"))
    assert res.ok and res.occupancy["effective"]["E"] == \
        caps["event_capacity"]
    same_port(res, port_full["tgen"])
    res2 = _port_run(tgen(f"  checkpoint_load: {ck}\n"
                          "  capacity_plan: auto"))
    assert res2.ok
    same_port(res2, port_full["tgen"])


def test_standalone_refuses_a_campaign_checkpoint(workdir):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    ck = os.path.join(workdir, "campaign.npz")
    camp = tgen(f"  checkpoint_save: {ck}\n  checkpoint_save_time: 500ms") \
        + "ensemble:\n  replicas: 2\n  vary: {seed: [11, 12]}\n" \
        f"  record_path: {os.path.join(workdir, 'rec.json')}\n"
    assert EnsembleRunner(load_config_str(camp), device="cpu").run().ok
    msg = _refusal(tgen(f"  checkpoint_load: {ck}"))
    assert "was saved by an ensemble campaign" in msg


# ----------------------------------------------------------------------
# the JAX child
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu.config import load_config, load_config_str
    from shadow_tpu.core.controller import Controller
    from shadow_tpu.device import checkpoint

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    off = ["experimental.compile_cache=off"]
    here = os.path.dirname(out_path)

    def run(text, ovr=(), is_path=False):
        cfg = (load_config(text, list(ovr) + off) if is_path
               else load_config_str(text, list(ovr) + off))
        c = Controller(cfg)
        return c, c.run()

    def keep(key, c, stats):
        out[f"{key}/chk"] = np.array([h.trace_checksum
                                      for h in c.sim.hosts], np.int64)
        out[f"{key}/n_exec"] = np.array([h.events_executed
                                         for h in c.sim.hosts], np.int64)
        for f in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "rounds"):
            out[f"{key}/{f}"] = np.int64(getattr(stats, f))

    tgen_text = job["tgen"]
    ck = os.path.join(here, "jax_tgen.npz")
    keep("tgen/full", *run(tgen_text.format(extra="")))
    run(tgen_text.format(extra=job["pause"].format(ck=ck)))
    out["tgen/ck"] = np.array(ck)
    out["tgen/meta"] = np.array(json.dumps(checkpoint.peek_meta(ck)))
    keep("tgen/own_resume",
         *run(tgen_text.format(extra=f"  checkpoint_load: {ck}")))
    keep("tgen/port_resume", *run(tgen_text.format(
        extra=f"  checkpoint_load: {job['port']['tgen']}")))

    def refusal(key, fn, path="<none>", blank="<ck>"):
        try:
            fn()
        except ValueError as e:
            out[f"refusal/{key}"] = np.array(str(e).replace(path, blank))
        else:
            raise AssertionError(f"{key}: not refused")

    for edit, text in job["edits"].items():
        refusal(edit, lambda t=text: run(t.format(
            extra=f"  checkpoint_load: {ck}")), ck)
    bad = job["unwritable"]
    refusal("unwritable", lambda: run(tgen_text.format(
        extra=f"  checkpoint_save: {bad}")), bad, "<bad>")
    refusal("save_time", lambda: load_config_str(tgen_text.format(
        extra="  checkpoint_save_time: 1s")))
    refusal("policy", lambda: load_config_str(tgen_text.format(
        extra="  checkpoint_save: /tmp/x.npz").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial")))
    end = os.path.join(here, "at_stop.npz")
    run(tgen_text.format(extra=f"  checkpoint_save: {end}"))
    refusal("at_stop", lambda: run(tgen_text.format(
        extra=f"  checkpoint_load: {end}")), end)

    stop = [f"general.stop_time={job['tor_stop']}"]
    tck = os.path.join(here, "jax_tor.npz")
    keep("tor/full", *run(job["tor"], stop, True))
    run(job["tor"], stop + [f"experimental.checkpoint_save={tck}",
                            "experimental.checkpoint_save_time="
                            f"{job['tor_pause']}"], True)
    out["tor/ck"] = np.array(tck)
    keep("tor/port_resume", *run(job["tor"], stop + [
        f"experimental.checkpoint_load={job['port']['tor']}"], True))

    for name, (src, ovr, is_path) in job["fingerprints"].items():
        cfg = (load_config(src, ovr + off) if is_path
               else load_config_str(src, ovr + off))
        out[f"fp/{name}"] = np.array(json.dumps(
            checkpoint._fingerprint(Controller(cfg).runner.engine)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
