"""The host mesh (`experimental.mesh_shards`, device/mesh.py) and the
cross-shard exchange on it: S = 2 and S = 4 ranks spawned over gloo on
the CPU, each running the port's plain path, held against the JAX
engine at the same S on the conftest's 8 virtual CPU devices (final
state leaf by leaf: per-host counters and checksums, x_overflow, occ_x,
occ_in), against one flush of the reference's `_flush_phase`, and
against the one-device run and the serial oracle. Every exchange
schedule (all_to_all, two_phase, all_gather) under both merges gives
the same traces; an undersized capacity loses rows on the same senders
as the reference, two_phase's at the intermediate too, and fails the
run. Tolerance everywhere is exact equality: the simulation is
integer-exact.

The JAX engine runs in one child process (this file's __main__ branch),
which applies the jax batching patch the reference needs under the
installed jax; the patch never runs in the pytest process. The child
starts before the first test. Each mesh is one spawned group of ranks
for all its runs, with a FileStore in a temporary directory and the
process group's timeout.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_exchange.py's XCHG_YAML (16 hosts, tgen clients of one
# server), the clients on the first shard and the server on the last at
# S = 2 and 4: at S = 4 (g = 2, ng = 2) two_phase relays the clients'
# rows through shard 1. The port runs one process a host, so its fillers
# are idle tgen servers (the reference's have no process).
XCHG = """
general: {stop_time: 2s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "5 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ]
      ]
experimental:
  scheduler_policy: tpu
  event_capacity: 48
  exchange_in_capacity: 48
  judge_placement: flush
hosts:
  cli:
    quantity: 2
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=srv size=1KiB count=1 pause=500ms retry=10s
      start_time: 100ms
  pad_a:
    quantity: 10
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 50ms}]
  srv:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 50ms}]
  pad_b:
    quantity: 3
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 50ms}]
"""

# PHOLD lossy (16 hosts, loss 0.1, msgload 2): tests/test_torch_compact.py's
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

# tgen with bursts (a server answering six lossy clients, burst_pops 8):
# 7 hosts, so every mesh pads
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

# a cut Tor: tests/test_torch_tor.py's (8 relays, 16 clients), lossy,
# to 4 s
TOR = """
general: {stop_time: 4s, seed: 1}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.02 ]
        edge [ source 0 target 1 latency "40 ms" packet_loss 0.02 ]
        edge [ source 1 target 1 latency "20 ms" packet_loss 0.02 ]
      ]
experimental:
  scheduler_policy: tpu
  event_capacity: 96
  outbox_capacity: 48
  judge_placement: flush
hosts:
  relay:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:tor_relay, start_time: 100ms}]
  client:
    quantity: 16
    network_node_id: 1
    processes:
    - {path: model:tor_client, args: cells=48 count=2 pause=500ms, start_time: 1s}
"""

# tests/test_device_engine.py:498: 8 adjacent (server, client) pairs, so
# every pair is shard-local at S = 2 and 4, under exchange_capacity 1
SELF = """
general: {stop_time: 4s, seed: 2}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.01 ]
      ]
experimental:
  scheduler_policy: tpu
  exchange: all_to_all
  exchange_capacity: 1
  judge_placement: flush
hosts:
""" + "".join(f"""  server{i}:
    network_node_id: 0
    processes: [{{path: model:tgen_server, start_time: 10ms}}]
  client{i}:
    network_node_id: 0
    processes:
    - {{path: model:tgen_client, args: server=server{i} size=64KiB count=2 pause=100ms, start_time: 100ms}}
""" for i in range(8))

CONFIGS = {"xchg": XCHG, "phold": PHOLD, "tgen": TGEN, "tor": TOR,
           "self": SELF}
SCHEDULES = ("all_to_all", "two_phase", "all_gather")
MERGES = ("window", "global")


def ovr(S, exchange="all_to_all", merge="window", extra=()):
    return [f"experimental.mesh_shards={S}",
            f"experimental.exchange={exchange}",
            f"experimental.merge_strategy={merge}", *extra]


# the runs the JAX child reproduces: key -> (config, overrides)
JAX_RUNS = {
    "xchg/a2a/window/4": ("xchg", ovr(4)),
    "xchg/tp/window/4": ("xchg", ovr(4, "two_phase")),
    "xchg/ag/window/4": ("xchg", ovr(4, "all_gather")),
    "xchg/a2a/global/4": ("xchg", ovr(4, merge="global")),
    "xchg/tp/global/4": ("xchg", ovr(4, "two_phase", "global")),
    "xchg/ag/global/4": ("xchg", ovr(4, "all_gather", "global")),
    "xchg/a2a/window/2": ("xchg", ovr(2)),
    "phold/a2a/window/2": ("phold", ovr(2)),
    "phold/tp/window/4": ("phold", ovr(4, "two_phase")),
    "tgen/a2a/window/4": ("tgen", ovr(4)),
    "tgen/ag/global/2": ("tgen", ovr(2, "all_gather", "global")),
    "tor/a2a/window/2": ("tor", ovr(2)),
    # undersized capacities: the loss lands on the sender, gid 1
    "over/a2a/window/4": ("xchg", ovr(4, extra=[
        "experimental.exchange_capacity=1"])),
    "over/a2a/global/4": ("xchg", ovr(4, merge="global", extra=[
        "experimental.exchange_capacity=1"])),
    "over/tp_phase2/window/4": ("xchg", ovr(4, "two_phase", extra=[
        "experimental.exchange_capacity2=1"])),
    "over/tp_phase2/global/4": ("xchg", ovr(4, "two_phase", "global", [
        "experimental.exchange_capacity2=1"])),
    "over/tp_phase1/window/4": ("xchg", ovr(4, "two_phase", extra=[
        "experimental.exchange_capacity=1"])),
    "over/a2a/window/2": ("xchg", ovr(2, extra=[
        "experimental.exchange_capacity=1"])),
    "self/a2a/window/4": ("self", ovr(4, extra=[
        "experimental.exchange_capacity=1"])),
}
OVERFLOWS = [k for k in JAX_RUNS if k.startswith("over/")]
# one flush of the reference's `_flush_phase` after pausing at 300 ms
FLUSHES = {
    "phold/a2a/window/2": ("phold", ovr(2)),
    "phold/tp/window/4": ("phold", ovr(4, "two_phase")),
    "phold/ag/global/4": ("phold", ovr(4, "all_gather", "global")),
    "phold/a2a/global/4": ("phold", ovr(4, merge="global")),
}
FLUSH_AT = 300_000_000


def _cfg(name, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(CONFIGS[name], list(overrides))


def _port_keys(S):
    """Every config under every schedule and merge at S, and the JAX
    runs' own keys at S."""
    keys = {f"{n}/{x}/{m}/{S}": (n, ovr(S, x, m))
            for n in ("xchg", "phold", "tgen", "tor")
            for x in SCHEDULES for m in MERGES}
    keys.update({k: v for k, v in JAX_RUNS.items()
                 if k.endswith(f"/{S}")})
    keys[f"self/a2a/window/{S}"] = ("self", ovr(S, extra=[
        "experimental.exchange_capacity=1"]))
    return keys


_MESH = {}


def mesh_results(S):
    """{key: (SimStats, gathered leaves)} of every port run at S, from
    one spawned group of S gloo ranks, computed once."""
    if S not in _MESH:
        from shadow_tpu_torch.device import runner

        keys = _port_keys(S)
        cfgs = [_cfg(n, o) for n, o in keys.values()]
        res = runner.mesh_runs(["cpu"] * S, cfgs, keep_state=True,
                               timeout=300)
        _MESH[S] = dict(zip(keys, res))
    return _MESH[S]


_ONE = {}


def one_device(name):
    """(one-device port SimStats, serial oracle SimStats) of a config."""
    if name not in _ONE:
        from shadow_tpu_torch.device import runner

        port = runner.run(_cfg(name), device="cpu")
        serial = runner.run(_cfg(name, [
            "experimental.scheduler_policy=serial"]), device="cpu")
        _ONE[name] = (port, serial)
    return _ONE[name]


class ReferenceChild:
    """The child run in a fresh interpreter on 8 virtual CPU devices,
    started at once; `result()` waits for the arrays it saved."""

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


@pytest.fixture(scope="module", autouse=True)
def reference_child():
    job = {"runs": {k: (CONFIGS[n], o) for k, (n, o) in JAX_RUNS.items()},
           "flushes": {k: (CONFIGS[n], o) for k, (n, o) in FLUSHES.items()},
           "flush_at": FLUSH_AT}
    with tempfile.TemporaryDirectory(prefix="torch_exchange_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _same_leaves(got: dict, want: dict, key: str, prefix: str) -> None:
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[f"{prefix}/{k}"],
                                      err_msg=f"{key}: leaf {k}")


# ----------------------------------------------------------------------
# whole runs against JAX at the same S
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", [k for k in JAX_RUNS
                                 if not k.startswith("over/")])
def test_mesh_run_equals_jax_leaf_by_leaf(key, reference):
    """The gathered final state, every leaf (per-host counters,
    checksums, heaps, occ_in, x_overflow, the [S, S] occ_x), and the
    rounds equal the JAX engine's at the same mesh_shards."""
    S = int(key.split("/")[-1])
    stats, leaves = mesh_results(S)[key]
    assert stats.rounds == int(reference[f"run/{key}/rounds"])
    _same_leaves(leaves, reference, key, f"run/{key}")
    assert leaves["occ_x"].shape == (S, S)
    assert stats.ok and stats.mesh["backend"] == "gloo"


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["xchg", "phold", "tgen", "tor"])
def test_every_schedule_and_merge_equals_one_device_and_serial(name, S):
    """Per-host events and trace checksums, the run totals and the
    rounds under all_to_all, two_phase and all_gather, window and
    global merges, equal the one-device run's and the serial oracle's
    (traces, totals): exact equality."""
    port, serial = one_device(name)
    res = mesh_results(S)
    for x in SCHEDULES:
        for m in MERGES:
            stats, _ = res[f"{name}/{x}/{m}/{S}"]
            what = f"{name} {x} {m} S={S}"
            assert stats.ok, what
            np.testing.assert_array_equal(stats.host_trace_checksum,
                                          port.host_trace_checksum, what)
            np.testing.assert_array_equal(stats.host_events_executed,
                                          port.host_events_executed, what)
            np.testing.assert_array_equal(stats.host_trace_checksum,
                                          serial.host_trace_checksum, what)
            for f in ("events_executed", "packets_sent", "packets_dropped",
                      "packets_delivered", "downloads_completed", "rounds"):
                assert getattr(stats, f) == getattr(port, f), (what, f)
            assert stats.events_executed == serial.events_executed, what
    assert port.events_executed > 0


@pytest.mark.parametrize("key", OVERFLOWS)
def test_undersized_capacity_loses_rows_on_the_reference_senders(
        key, reference):
    """Two clients on shard 0 send one REQ each to the server on the
    last shard in one window: a capacity of 1 (the direct pack, the
    two_phase phase-1 buffer, or its phase-2 buffer at the intermediate
    shard 1) ships the first and loses the second, whose count lands on
    its sender, gid 1, as in the reference: x_overflow equal per host,
    every leaf equal, the run not ok."""
    S = int(key.split("/")[-1])
    stats, leaves = mesh_results(S)[key]
    _same_leaves(leaves, reference, key, f"run/{key}")
    xov = leaves["x_overflow"]
    assert xov[1] >= 1 and xov[0] == 0 and not xov[2:].any(), xov
    assert not stats.ok and stats.x_overflow == int(xov.sum())


@pytest.mark.parametrize("S", [2, 4])
def test_self_shard_rows_bypass_the_pack(S):
    """tests/test_device_engine.py:498 on the port: every pair of hosts
    is shard-local, so exchange_capacity 1 loses nothing; the traces
    equal the serial oracle's."""
    _, serial = one_device("self")
    stats, leaves = mesh_results(S)[f"self/a2a/window/{S}"]
    assert stats.ok and not leaves["x_overflow"].any()
    assert stats.packets_sent > 0
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  serial.host_trace_checksum)


def test_self_shard_run_equals_jax(reference):
    stats, leaves = mesh_results(4)["self/a2a/window/4"]
    _same_leaves(leaves, reference, "self", "run/self/a2a/window/4")


# ----------------------------------------------------------------------
# one flush against the reference's _flush_phase
# ----------------------------------------------------------------------
_FLUSHED = {}


def flushed(reference):
    """{key: gathered leaves} of one port flush of each FLUSHES entry
    from the reference's state and outbox after its pop, one spawned
    mesh per S."""
    if not _FLUSHED:
        from shadow_tpu_torch.device import mesh, runner

        for S in (2, 4):
            keys = [k for k in FLUSHES if k.endswith(f"/{S}")]
            jobs = []
            for k in keys:
                n, o = FLUSHES[k]
                pre = {f[len(f"flush/{k}/pre/"):]: v
                       for f, v in reference.items()
                       if f.startswith(f"flush/{k}/pre/")}
                ob = {f: reference[f"flush/{k}/ob/{f}"]
                      for f in ("t", "k", "m", "s", "v")}
                jobs.append((_cfg(n, o), pre, ob,
                             int(reference[f"flush/{k}/win_end"])))
            out = mesh.spawn(["cpu"] * S, runner.flush_phases, (jobs,),
                             timeout=300)
            _FLUSHED.update(zip(keys, out))
    return _FLUSHED


@pytest.mark.parametrize("key", list(FLUSHES))
def test_one_flush_equals_jax_flush_phase(key, reference):
    """The same state and raw outbox through one flush: the judge, the
    tallies, the pack (occ_x, x_overflow), the exchange and the merge
    (occ_in, the heaps) give every leaf the reference's flush gives."""
    got = flushed(reference)[key]
    assert int(reference[f"flush/{key}/arrivals"]) > 0
    _same_leaves(got, reference, key, f"flush/{key}/post")


# ----------------------------------------------------------------------
# the layout, auto, refusals and failures
# ----------------------------------------------------------------------
def test_auto_resolves_to_all_to_all():
    """`exchange: auto` without a planner record runs all_to_all, as the
    reference's runner resolves it (runner.py:417-418), and says so."""
    from shadow_tpu_torch.device import runner

    (auto, la), = runner.mesh_runs(["cpu"] * 2, [_cfg("phold", ovr(
        2, "auto"))], keep_state=True, timeout=300)
    direct, ld = mesh_results(2)["phold/all_to_all/window/2"]
    assert auto.mesh["exchange"] == "all_to_all"
    for k in ld:
        np.testing.assert_array_equal(la[k], ld[k], err_msg=k)


def test_shard_and_gather_state_round_trip():
    from shadow_tpu_torch.device.kernels import MeshParams
    from shadow_tpu_torch.device.runner import gather_state, shard_state

    rng = np.random.default_rng(0)
    S, H = 4, 3
    glob = {"ht": rng.integers(0, 9, (S * H, 5)),
            "occ_x": rng.integers(0, 9, (S, S)),
            "occ_phases": rng.integers(0, 9, S)}
    parts = [shard_state(glob, MeshParams(S, s, H)) for s in range(S)]
    assert parts[2]["occ_x"].shape == (1, S)
    np.testing.assert_array_equal(parts[1]["ht"], glob["ht"][3:6])
    back = gather_state(parts)
    for k in glob:
        np.testing.assert_array_equal(back[k], glob[k])


def test_exchange_capacities_are_the_reference_formulas():
    """dense_auto_cap, group_split and the two_phase auto sizes
    (the reference's capacity.py:80-110, engine.py:577-599)."""
    from shadow_tpu_torch.device.capacity import (
        dense_auto_cap,
        exchange_caps,
        group_split,
    )

    assert [group_split(s) for s in (1, 2, 4, 6, 8, 9, 7)] == \
        [(1, 1), (1, 2), (2, 2), (2, 3), (2, 4), (3, 3), (1, 7)]
    assert dense_auto_cap(50_000, 30, 64, 2) == 1_500_000
    assert dense_auto_cap(8, 16, 64, 4) == 128
    assert dense_auto_cap(1000, 30, 64, 8) == 15_000
    assert exchange_caps("all_to_all", 4, 8, 16, 64) == (128, 0, 1, 4)
    assert exchange_caps("all_gather", 4, 8, 16, 64) == (0, 0, 1, 4)
    # R = 128: CAP = min(R, max(64, E, 4R/g)), CAP2 = min(g*CAP,
    # max(64, E, 4Rg/S))
    assert exchange_caps("two_phase", 4, 8, 16, 64) == (128, 256, 2, 2)
    assert exchange_caps("two_phase", 4, 8, 16, 64, 5, 7) == (5, 7, 2, 2)


# what a mesh runs since ROADMAP (a) item 9a: the state audit, the model
# NIC, the path counters, and the hybrid fall-back of host faults and of
# a config with no device twin (tests/test_torch_mesh_state.py runs them);
# since item 9c ensemble campaigns (tests/test_torch_mesh_campaign.py)
MESH_ADMITTED = {
    "experimental.state_audit=true": None,
    "ensemble={replicas: 2, vary: {seed: [5, 6]}}": None,
    "experimental.model_bandwidth=true": None,
    "experimental.count_paths=true": None,
    "network.faults=[{kind: host_crash, time: 1s, host: left0}]":
        "host_crash/host_restart faults",
    "hosts.right.processes=[{path: model:tgen_server, start_time: 10ms}]":
        "no device twin registered for ['phold', 'tgen_server']",
}


@pytest.mark.parametrize("override", [
    "experimental.state_audit=true",
    "experimental.model_bandwidth=true",
    "experimental.count_paths=true",
    "ensemble={replicas: 2, vary: {seed: [5, 6]}}",
    "network.faults=[{kind: host_crash, time: 1s, host: left0}]",
    "hosts.right.processes=[{path: model:tgen_server, start_time: 10ms}]",
])
def test_what_a_mesh_does_not_run_yet_is_refused(override):
    """A campaign on a mesh, the audit, the model NIC, the path counters
    and the hybrid fall-back are admitted (the last two build with the
    reference's reason to run hybrid in `no_twin`); nothing of these is
    refused any more (nor, since ROADMAP (a) item 13.1, a campaign's
    retries, shrink and chaos on a mesh,
    `test_a_campaign_on_a_mesh_refuses_item_13`)."""
    from shadow_tpu_torch.core.build import OutsideSlice, build

    from shadow_tpu_torch.config import load_config_str

    # the model NIC judges in the pop: no judge_placement: flush
    text = PHOLD.replace("  judge_placement: flush\n", "")
    cfg = load_config_str(text, ovr(2) + [override])
    if override not in MESH_ADMITTED:
        with pytest.raises(OutsideSlice, match=r"an ensemble campaign on a "
                           r"mesh .*ROADMAP.md queue \(a\) item 9c "
                           r"\(campaigns on the mesh\)"):
            build(cfg)
        return
    sim = build(cfg)
    reason = MESH_ADMITTED[override]
    if reason is None:
        assert sim.app is not None and sim.no_twin is None
    else:
        assert sim.app is None and reason in sim.no_twin


# what the refusals said until ROADMAP (a) item 13.1 admitted the keys
ITEM_13_ON_A_MESH = (r"on a mesh .*ROADMAP.md queue \(a\) item 13 "
                     r"\(dispatch retry, failover and chaos on a mesh")


@pytest.mark.parametrize("override,match", [
    ("experimental.dispatch_retries=2", ITEM_13_ON_A_MESH),
    # a campaign's failover is the shrink (the schema refuses `hybrid`
    # for campaigns with the reference's message)
    ("experimental.failover=shrink", r"failover: shrink \(the mesh "
     r"shrink.*ROADMAP.md queue \(a\) item 13 \(the mesh shrink\)"),
    ("experimental.chaos=[{kind: dispatch_error, segment: 1}]",
     ITEM_13_ON_A_MESH),
])
def test_a_campaign_on_a_mesh_refuses_item_13(override, match):
    """A campaign on a mesh with dispatch retries, the shrink or chaos,
    refused naming ROADMAP (a) item 13 (`match`) until 13.1, is
    admitted: it builds with its device twin, as a standalone mesh run
    does, and no refusal is raised."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    cfg = load_config_str(PHOLD, ovr(2) + [
        "ensemble={replicas: 2, vary: {seed: [5, 6]}}", override])
    sim = build(cfg)
    assert sim.app is not None and sim.no_twin is None
    assert match.startswith(("on a mesh", "failover"))


def test_mesh_shards_needs_the_tpu_policy_and_a_known_exchange():
    with pytest.raises(ValueError, match="requires scheduler_policy: tpu"):
        _cfg("phold", ovr(2) + ["experimental.scheduler_policy=serial"])
    with pytest.raises(ValueError, match="exchange='ring' is not one of"):
        _cfg("phold", ["experimental.exchange=ring"])


def test_mesh_shards_above_the_cards_is_refused(monkeypatch):
    """More ranks than cards: the reference's message, before any rank
    starts."""
    import torch

    from shadow_tpu_torch.device import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"experimental.mesh_shards=4 but "
                       r"only 2 device\(s\) are available"):
        runner.run(_cfg("phold", ovr(4)))
    assert runner.mesh_devices(2) == ["cuda:0", "cuda:1"]


def test_mesh_backends_follow_the_devices():
    from shadow_tpu_torch.device.mesh import mesh_backend

    assert mesh_backend(["cpu", "cpu"]) == "gloo"
    assert mesh_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh_backend(["cuda:0", "cuda:0"]) == "gloo"
    with pytest.raises(ValueError, match="not a mix"):
        mesh_backend(["cpu", "cuda:0"])


def test_run_slots_raises_on_a_mesh():
    """The captured window loop runs on one device: a mesh engine's
    `run` takes the Python loop, and `run_slots` refuses."""
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.mesh import Mesh

    cfg = _cfg("phold", ovr(2))
    sim = build(cfg)
    eng = runner.engine_from(cfg, sim, device="cpu",
                             mesh=Mesh(1, 2, "cpu", "gloo"))
    assert eng.n_local == 8 and eng.params.g0 == 8
    state = eng.init_state(sim.start_times, sim.stop_times)
    with pytest.raises(RuntimeError, match="captured window loop runs on "
                       "one device"):
        eng.run_slots(state)


def test_a_failing_rank_fails_the_run():
    """A config every rank refuses at build: the spawn raises with the
    ranks' tracebacks instead of returning."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.mesh import MeshFailure

    with pytest.raises(MeshFailure, match="event_capacity must be >= 2"):
        runner.mesh_runs(["cpu"] * 2, [_cfg("phold", ovr(2) + [
            "experimental.event_capacity=1"])], timeout=120)


def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    INF = 1 << 62
    with open(job_path) as f:
        job = json.load(f)
    out = {}
    # the compile cache keys programs without the mesh's size: off
    off = ["experimental.compile_cache=off"]
    for key, (yaml, ovr_) in job["runs"].items():
        c = Controller(load_config_str(yaml, ovr_ + off))
        eng = c.runner.engine
        state, rounds = eng.run(eng.init_state(c.sim.starts))
        for k, v in state.items():
            out[f"run/{key}/{k}"] = np.asarray(jax.device_get(v))
        out[f"run/{key}/rounds"] = np.int64(rounds)
    for key, (yaml, ovr_) in job["flushes"].items():
        c = Controller(load_config_str(yaml, ovr_ + off))
        eng = c.runner.engine
        state, _ = eng.run(eng.init_state(c.sim.starts), job["flush_at"],
                           eng.config.stop_time)
        ht = np.asarray(jax.device_get(state["ht"]))
        head = np.asarray(jax.device_get(state["head"]))
        E = ht.shape[1]
        nxt = int(np.where(head < E, ht[np.arange(len(head)),
                                        np.minimum(head, E - 1)],
                           INF).min())
        win_end = min(nxt + max(1, eng.config.lookahead),
                      eng.config.stop_time)
        shard = NamedSharding(eng.mesh, eng._shard_spec)
        repl = NamedSharding(eng.mesh, eng._repl_spec)
        hv = jax.device_put(jnp.asarray(eng.host_vertex), repl)
        ob = {"t": jax.device_put(jnp.full(eng._ob_shape_global, INF,
                                           jnp.int64), shard)}
        for f in ("k", "m", "s", "v"):
            ob[f] = jax.device_put(jnp.zeros(eng._ob_shape_global,
                                             jnp.int64), shard)
        win = jnp.int64(win_end)
        pre, ob, _ = eng._pop_phase(state, ob, hv, eng.world(), win)
        post = eng._flush_phase(pre, ob, hv, eng.world(), win)
        for k, v in pre.items():
            out[f"flush/{key}/pre/{k}"] = np.asarray(jax.device_get(v))
        for k, v in ob.items():
            out[f"flush/{key}/ob/{k}"] = np.asarray(jax.device_get(v))
        for k, v in post.items():
            out[f"flush/{key}/post/{k}"] = np.asarray(jax.device_get(v))
        out[f"flush/{key}/win_end"] = np.int64(win_end)
        out[f"flush/{key}/arrivals"] = np.int64(
            (np.asarray(jax.device_get(ob["t"])) < INF).sum())
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
