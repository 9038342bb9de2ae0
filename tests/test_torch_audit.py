"""The port's state audit (`experimental.state_audit`) against the
reference: the health word `aud`, the last popped time `aud_t` and the
row ledger `aud_tx` after whole runs, and the words that seeded
corruptions of a paused state leave behind. Tolerance everywhere is
exact equality: the simulation and the audit are integer-exact.

The JAX engine runs in a child process (this file's __main__ branch),
which applies the jax batching patch the reference needs under the
installed jax; the patch never runs in the pytest process. The child
starts before the first test, so the port's runs overlap its compiles.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_engine.py's PHOLD (8 + 8 hosts, loss 0.1, msgload 2)
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
  scheduler_policy: '{policy}'
  event_capacity: 64
  outbox_capacity: 16
  judge_placement: flush
  merge_strategy: window
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

# a tgen server bursting answers to six clients, lossy, with retries
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
  scheduler_policy: '{policy}'
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
       args: server=server size=300KiB count=2 pause=200ms retry=150ms}
"""

# tests/test_torch_tor.py's Tor (8 relays, 8 clients), lossy, 4 s
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
  scheduler_policy: '{policy}'
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

# tests/test_torch_hier.py's STAR: tgen on a star_clusters graph in
# its factored representation
STAR = """
general: {stop_time: 1s, seed: 3}
network:
  topology: {representation: hierarchical}
  graph:
    type: star_clusters
    clusters: 2
    spokes_per_cluster: 3
    hub_latency: 10 ms
    access_latency: 1 ms
    hub_packet_loss: 0.05
experimental:
  scheduler_policy: '{policy}'
hosts:
  server:
    network_node_id: 2
    processes: [{path: "model:tgen_server", start_time: 10ms}]
  client:
    quantity: 3
    network_node_id: 3
    network_node_stride: 1
    processes:
    - {path: model:tgen_client, start_time: 50ms,
       args: server=server size=20KiB count=2 pause=50ms retry=200ms}
"""

# tests/test_model_nic.py's PHOLD under the model NIC (2 Mbit, loss
# 0.05) with the path counters, cut to 1 s
NIC = """
general: {stop_time: 1s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "2 Mbit" bandwidth_up "2 Mbit" ]
        node [ id 1 bandwidth_down "2 Mbit" bandwidth_up "2 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.05 ] ]
experimental:
  scheduler_policy: '{policy}'
  model_bandwidth: true
  count_paths: true
  event_capacity: 96
  outbox_capacity: 48
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=3 size=4096, start_time: 10ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=3 size=4096, start_time: 10ms}]
"""

# tests/test_torch_faults.py's link faults (degrade, link_down,
# link_up) on a tgen pair of vertices, cut to 6 s
FAULTS = """
general: {stop_time: 6s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ] ]
  faults:
    - {kind: degrade, time: 2500ms, duration: 1s, source: 0,
       target: 1, latency_multiplier: 3, extra_packet_loss: 0.2}
    - {kind: link_down, time: 4s, source: 0, target: 1}
    - {kind: link_up, time: 5s, source: 0, target: 1}
experimental:
  scheduler_policy: '{policy}'
  event_capacity: 256
  outbox_capacity: 256
hosts:
  server:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 3
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=200KiB count=40 pause=50ms retry=300ms}
"""

# PHOLD without loss at msgload 4, with self-sends and a 50 ms runahead:
# every host keeps several events in its heap, at several times within
# one window (self rows take no causality bump), which the corruptions
# below need
BUSY = PHOLD.replace("packet_loss 0.1", "packet_loss 0.0").replace(
    "msgload=2", "msgload=4 selfloop=1").replace(
    "  judge_placement: flush", "  runahead: 50 ms\n  judge_placement: flush")

CONFIGS = {"phold": PHOLD, "tgen": TGEN, "tor": TOR, "star": STAR,
           "nic": NIC, "faults": FAULTS, "busy": BUSY}
RUNS = ("phold", "tgen", "tor", "star", "nic", "faults")
AUDIT = ["experimental.state_audit=true"]

# the corruptions: applied to BUSY's state paused at PAUSE (windows
# clamped to its stop time), then run on to RESUME
PAUSE, RESUME, STOP = 300_000_000, 1_000_000_000, 2_000_000_000
CORRUPTIONS = ("counter", "heap_swap", "head", "clock", "lost_row")
# the invariant each must trip
TRIPS = {"counter": "counter-negativity", "heap_swap": "clock-monotonicity",
         "head": "packet-conservation", "clock": "clock-monotonicity",
         "lost_row": "packet-conservation"}
INF = 1 << 62
IMAX = (1 << 63) - 1


def text(name: str, policy: str = "tpu") -> str:
    return CONFIGS[name].replace("{policy}", policy)


def corrupt(name: str, arrays: dict) -> dict:
    """A copy of a paused state's numpy leaves with one corruption:
    a negative counter; a host's first heap row swapped with its
    earliest row of a strictly later time (the earliest such row of any
    host, so that both pop in the next window, out of order); a head
    past E
    at the host with the most live rows; an `aud_t` above a host's next
    event; that host's last live row deleted."""
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    ht = a["ht"]
    E = ht.shape[1]
    live = (ht < INF).sum(-1)
    busiest = int(np.argmax(live))
    if name == "counter":
        a["n_sent"][0] = -7
    elif name == "heap_swap":
        later = np.where((ht > ht[:, :1]) & (ht < INF), ht, INF)
        h, j = np.unravel_index(int(np.argmin(later)), ht.shape)
        for f in ("ht", "hk", "hm", "hv", "hw"):
            a[f][h, [0, j]] = a[f][h, [j, 0]]
    elif name == "head":
        a["head"][busiest] = E + 3
    elif name == "clock":
        a["aud_t"][busiest] = ht[busiest, 0] + 1
    elif name == "lost_row":
        j = int(live[busiest]) - 1
        a["ht"][busiest, j], a["hk"][busiest, j] = INF, IMAX
        for f in ("hm", "hv", "hw"):
            a[f][busiest, j] = 0
    else:
        raise ValueError(name)
    return a


# ----------------------------------------------------------------------
# the child and its fixture
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


@pytest.fixture(scope="module", autouse=True)
def reference_child():
    job = {"runs": {name: text(name) for name in RUNS},
           "busy": text("busy")}
    with tempfile.TemporaryDirectory(prefix="torch_audit_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _port_run(name: str):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    return runner.run(load_config_str(text(name)), device="cpu")


def _totals(s):
    return [s.events_executed, s.packets_sent, s.packets_dropped,
            s.packets_delivered, s.rounds]


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", RUNS)
def test_audited_runs_equal_unaudited_ones_and_jax(reference, name):
    """An audited run has the unaudited run's trace, a zero word, and
    the JAX engine's audited trace and audit leaves."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.kernels import AUD_KEYS

    off = _port_run(name)
    engine, sim = runner.make_engine(
        load_config_str(text(name), AUDIT), device="cpu")
    state, rounds = engine.run(engine.init_state(sim.start_times,
                                                 sim.stop_times))
    on = [int(state[k].long().sum()) for k in
          ("n_exec", "n_sent", "n_drop", "n_deliv")] + [rounds]
    assert off.ok and off.events_executed > 0
    assert on == _totals(off) == \
        [int(v) for v in reference[f"{name}/totals"]]
    for events, chk in ((off.host_events_executed, off.host_trace_checksum),
                        (state["n_exec"].numpy(), state["chk"].numpy())):
        np.testing.assert_array_equal(events, reference[f"{name}/events"])
        np.testing.assert_array_equal(chk, reference[f"{name}/chk"])
    assert not state["aud"].any()
    for k in AUD_KEYS:
        np.testing.assert_array_equal(state[k].numpy(),
                                      reference[f"{name}/{k}"],
                                      err_msg=k)


def test_unaudited_state_has_no_audit_leaves():
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    engine, sim = runner.make_engine(load_config_str(text("phold")),
                                     device="cpu")
    state = engine.init_state(sim.start_times, sim.stop_times)
    assert not any(k.startswith("aud") for k in state)


def test_footprint_prices_the_audit_leaves():
    """The admission estimate's state bytes are the bytes an audited
    engine's state holds (aud int32, aud_t and aud_tx int64 per host)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    engine, sim = runner.make_engine(load_config_str(text("nic"), AUDIT),
                                     device="cpu")
    state = engine.init_state(sim.start_times, sim.stop_times)
    assert {"aud", "aud_t", "aud_tx", "tx_free", "path_cnt"} <= set(state)
    assert engine.admission["estimate"]["state_bytes"] == sum(
        t.numel() * t.element_size() for t in state.values())


def test_ledger_seed_counts_the_rows_init_wrote():
    """aud_tx starts at one boot row per host plus a stop row where a
    stop time is given, as the reference's t0s != INF and t1s != INF."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    engine, sim = runner.make_engine(load_config_str(text("phold"), AUDIT),
                                     device="cpu")
    stops = np.where(np.arange(len(sim.start_times)) % 3 == 0,
                     sim.start_times + 10**9, -1)
    state = engine.init_state(sim.start_times, stops)
    live = (state["ht"] < INF).sum(-1)
    np.testing.assert_array_equal(state["aud_tx"].numpy(), live.numpy())
    np.testing.assert_array_equal(state["aud_tx"].numpy(),
                                  1 + (stops >= 0))


@pytest.mark.parametrize("loop", ["python", "slots"])
@pytest.mark.parametrize("corruption", CORRUPTIONS)
def test_corruptions_set_the_reference_words(reference, corruption, loop):
    """Each corruption of the paused state, run on with the
    reference's run(state, stop, final_stop), leaves the reference's
    per-host word (and every other leaf) in the port, under both window
    loops."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import state_from_numpy
    from shadow_tpu_torch.device.supervise import decode_audit

    engine, _ = runner.make_engine(load_config_str(text("busy"), AUDIT),
                                   device="cpu")
    pre = f"c/{corruption}"
    keys = sorted(k.split("/")[-1] for k in reference
                  if k.startswith(f"{pre}/in/"))
    state = state_from_numpy({k: reference[f"{pre}/in/{k}"] for k in keys},
                             "cpu")
    assert set(state) == set(keys)
    run = engine.run_python if loop == "python" else engine.run_slots
    state, rounds = run(state, RESUME, STOP)
    assert rounds == int(reference[f"{pre}/rounds"])
    want = reference[f"{pre}/out/aud"]
    assert want.any()
    word = int(np.bitwise_or.reduce(want))
    assert TRIPS[corruption] in decode_audit(word), decode_audit(word)
    np.testing.assert_array_equal(state["aud"].numpy(), want)
    for k in keys:
        np.testing.assert_array_equal(state[k].numpy(),
                                      reference[f"{pre}/out/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("corruption", CORRUPTIONS)
def test_check_audit_raises_the_reference_message(reference, corruption):
    import torch

    from shadow_tpu_torch.device.supervise import AuditFailure, check_audit

    state = {"aud": torch.from_numpy(reference[f"c/{corruption}/out/aud"])}
    with pytest.raises(AuditFailure) as err:
        check_audit(state, where="unit test")
    assert str(err.value) == str(reference[f"c/{corruption}/msg"])
    check_audit({"aud": torch.zeros(4, dtype=torch.int32)})
    check_audit({})


def test_runner_raises_audit_failure_naming_the_stop_time(monkeypatch):
    """A corrupted run stops in the runner with the reference's text,
    `where` naming the stop time."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import DeviceEngine
    from shadow_tpu_torch.device.supervise import AuditFailure

    init = DeviceEngine.init_state

    def negative(self, *args):
        state = init(self, *args)
        state["n_drop"][5] = -2**30
        return state

    monkeypatch.setattr(DeviceEngine, "init_state", negative)
    with pytest.raises(AuditFailure, match=r"state audit failed at "
                       r"t=2000000000 ns: violated invariant\(s\) "
                       r"\['counter-negativity'\] on 1 host slot\(s\)"):
        runner.run(load_config_str(text("phold"), AUDIT), device="cpu")


# ----------------------------------------------------------------------
# the reference, in the child process
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller
    from shadow_tpu.device import supervise
    from shadow_tpu.device.engine import AUD_KEYS

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    for name, yaml in job["runs"].items():
        c = Controller(load_config_str(yaml, AUDIT))
        s = c.run()
        assert s.ok, name
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds], dtype=np.int64)
        out[f"{name}/events"] = np.array(
            [h.events_executed for h in c.sim.hosts], dtype=np.int64)
        out[f"{name}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], dtype=np.int64)
        final = c.runner.final_state
        for k in AUD_KEYS:
            out[f"{name}/{k}"] = np.asarray(final[k])

    # the corruptions, on one compiled run (stops are runtime scalars):
    # pause, corrupt, run on
    c = Controller(load_config_str(job["busy"], AUDIT))
    eng = c.runner.engine
    mid, _ = eng.run(eng.init_state(c.sim.starts), stop=PAUSE,
                     final_stop=STOP)
    mid_np = {k: np.asarray(jax.device_get(v)) for k, v in mid.items()}
    for name in CORRUPTIONS:
        arrays = corrupt(name, mid_np)
        state = {k: jax.device_put(jnp.asarray(v), mid[k].sharding)
                 for k, v in arrays.items()}
        state, rounds = eng.run(state, stop=RESUME, final_stop=STOP)
        for k, v in arrays.items():
            out[f"c/{name}/in/{k}"] = v
            out[f"c/{name}/out/{k}"] = np.asarray(jax.device_get(state[k]))
        out[f"c/{name}/rounds"] = np.int64(rounds)
        try:
            supervise.check_audit(state, where="unit test")
        except supervise.AuditFailure as e:
            out[f"c/{name}/msg"] = np.str_(str(e))
        else:
            out[f"c/{name}/msg"] = np.str_("")
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
