"""The port's link faults (shadow_tpu_torch/faults.py and the epoch axis
of its tables) against the reference: the compiled epoch tables, dense
([T,V,V]) and factored (every leaf with a leading [T] axis), array for
array against shadow_tpu/faults.py; the compiler's validation and its
two loud rejections of factored schedules, message for message; the
epoch lookup (`gather_parts_plain` with `e`) against the JAX
`gather_parts` at every epoch boundary and 1 ns either side; and whole
runs under link faults on the port's plain path against the serial CPU
oracle (in process) and the JAX `tpu` engine (in a child), under the
dense and the hierarchical representation. Tolerance everywhere is
exact equality: the simulation is integer-exact, and the factored
float32 reliabilities compose in one fixed order on every path.

The JAX reference runs in a child process (this file's __main__
branch), one child for the whole file, started before the first test:
the reference package's device engine does not import under the
installed jax without a patch to jax's batching registry, and that
patch must never be applied inside the pytest process.

Run lengths are cut to keep the file near a minute on a CPU:
examples/tgen_faults_hier.yaml runs 8 s of its 10 (past its last link
event at 7 s) with its two host faults removed (the port refuses them,
as the reference's device engine does), and phold_1m_hier_faults'
schedule (chip_smoke.py) runs on its star cut to 4 clusters of 50
spokes for 1 s.
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
MS = 10**6
S = 10**9

# tests/test_faults.py's FAULT_YAML with its LINK_FAULTS
LINK_YAML = """
general: {stop_time: 8s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ]
      ]
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
    processes:
    - path: model:tgen_server
      start_time: 10ms
  client:
    quantity: 3
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=server size=200KiB count=40 pause=50ms retry=300ms
      start_time: 100ms
"""

# examples/tgen_faults_hier.yaml's link faults (its host_crash and
# host_restart left out)
HIER_LINK_FAULTS = (
    "network.faults=["
    "{kind: degrade, time: 2s, duration: 1s, source: 0, target: 1,"
    " latency_multiplier: 3, extra_packet_loss: 0.05},"
    "{kind: degrade, time: 4s, duration: 1s, source: 0, target: 2,"
    " latency_multiplier: 2},"
    "{kind: link_down, time: 6s, source: 0, target: 1},"
    "{kind: link_up, time: 7s, source: 0, target: 1}]")

# chip_smoke.py's phold_1m_hier_faults on its star cut to 4 clusters of
# 50 spokes: PHOLD on one host per spoke, the same schedule with the
# access link of hub 0's first spoke (vertex 4 here, 200 there)
STAR_FAULTS_YAML = """
general: {stop_time: 1s, seed: 7}
network:
  topology:
    representation: {rep}
  graph:
    type: star_clusters
    clusters: 4
    spokes_per_cluster: 50
    hub_latency: 10 ms
    access_latency: 1 ms
    hub_packet_loss: 0.02
  faults:
    - {kind: degrade, time: 200ms, duration: 300ms, source: 0,
       target: 1, latency_multiplier: 3, extra_packet_loss: 0.05}
    - {kind: degrade, time: 300ms, duration: 200ms, source: 0,
       target: 4, latency_multiplier: 2}
    - {kind: link_down, time: 400ms, source: 2, target: 3}
    - {kind: link_up, time: 600ms, source: 2, target: 3}
experimental:
  scheduler_policy: '{policy}'
hosts:
  peer:
    quantity: 200
    network_node_id: 4
    network_node_stride: 1
    processes:
    - path: model:phold
      args: msgload=3 size=512
      start_time: 10ms
"""


def _example(name: str) -> str:
    with open(os.path.join(ROOT, "examples", name)) as f:
        return f.read()


# whole runs: (yaml, overrides, representations the port runs)
RUNS = {
    "link_faults": (LINK_YAML, [], ("dense",)),
    "tgen_faults_hier": (_example("tgen_faults_hier.yaml").replace(
        "scheduler_policy: serial", "scheduler_policy: '{policy}'"),
        [HIER_LINK_FAULTS, "general.stop_time=8s"],
        ("hierarchical", "dense")),
    "star_faults": (STAR_FAULTS_YAML, [], ("hierarchical", "dense")),
}


def _cfg(text: str, policy: str, rep: str = "hierarchical") -> str:
    return text.replace("{policy}", policy).replace("{rep}", rep)


def _rep_override(name, rep):
    """The override that selects `rep` where the config has its own."""
    return [] if name == "link_faults" else [
        f"network.topology.representation={rep}"]


# ----------------------------------------------------------------------
# seeded inputs of the lookup comparison (made here and in the child)
# ----------------------------------------------------------------------
def lookup_inputs():
    """STAR_FAULTS_YAML's factored epoch tables (the reference's
    layout: cl repeated per epoch) and seeded (sv, dv, t) with every
    epoch start and 1 ns either side among the times, a tenth of the
    pairs sv == dv."""
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import load_topology
    from shadow_tpu.faults import compile_link_faults, split_events

    cfg = load_config_str(_cfg(STAR_FAULTS_YAML, "serial"))
    top = load_topology(cfg)
    ft = compile_link_faults(top, split_events(cfg.network.faults)[0])
    rng = np.random.default_rng(8)
    N, V = 4096, top.n_vertices
    sv = rng.integers(0, V, N)
    dv = np.where(rng.random(N) < 0.1, sv, rng.integers(0, V, N))
    edges = np.concatenate([ft.times + d for d in (-1, 0, 1)])
    t = np.where(rng.random(N) < 0.5, rng.choice(edges[edges >= 0], N),
                 rng.integers(0, 10**9, N))
    lat, rel = ft.lat_parts_stacked(), ft.rel_parts_stacked()
    return {"times": ft.times, "t": t.astype(np.int64),
            "sv": sv.astype(np.int32), "dv": dv.astype(np.int32),
            **{f"lat{i}": np.asarray(a, np.int32 if i else np.int32)
               for i, a in enumerate(lat)},
            **{f"rel{i}": np.asarray(a, np.int32 if i == 1 else np.float32)
               for i, a in enumerate(rel)}}


# ----------------------------------------------------------------------
# the child and its fixture
# ----------------------------------------------------------------------
class ReferenceChild:
    """`job` run through this file's __main__ branch in a fresh
    interpreter, started at once; `result()` waits for the arrays it
    saved. Output goes to files, so a chatty child never blocks on a
    full pipe."""

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
    """The JAX child starts before this file's first test, so the tests
    that need no reference (and the port's and the oracle's runs) go on
    while it compiles."""
    job = {"runs": {k: (_cfg(t, "tpu"), ov) for k, (t, ov, _) in
                    RUNS.items()}}
    with tempfile.TemporaryDirectory(prefix="torch_faults_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _port_run(name: str, rep: str):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    text, overrides, _ = RUNS[name]
    return runner.run(load_config_str(_cfg(text, "tpu", rep),
                                      overrides + _rep_override(name, rep)),
                      device="cpu")


def _serial_run(name: str):
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    text, overrides, _ = RUNS[name]
    c = Controller(load_config_str(_cfg(text, "serial"), overrides))
    stats = c.run()
    hosts = c.sim.hosts
    downloads = sum(getattr(h.app, "downloads_done", 0) for h in hosts)
    return stats, hosts, downloads


@pytest.fixture(scope="module")
def local_runs():
    return {name: ({rep: _port_run(name, rep) for rep in reps},
                   _serial_run(name))
            for name, (_, _, reps) in RUNS.items()}


def _totals(stats, downloads):
    return [stats.events_executed, stats.packets_sent,
            stats.packets_dropped, stats.packets_delivered, stats.rounds,
            downloads]


# ----------------------------------------------------------------------
# the compiled tables
# ----------------------------------------------------------------------
def _both_tables(text, overrides=()):
    """(port fault table, reference fault table, port topology) of a
    config's link faults."""
    from shadow_tpu.config import load_config_str as ref_load
    from shadow_tpu.core.controller import load_topology as ref_topology
    from shadow_tpu.faults import compile_link_faults as ref_compile
    from shadow_tpu.faults import split_events as ref_split

    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import load_topology
    from shadow_tpu_torch.faults import compile_link_faults, split_events

    cfg = load_config_str(text, list(overrides))
    rcfg = ref_load(text, list(overrides))
    top = load_topology(cfg)
    port = compile_link_faults(top, split_events(cfg.network.faults)[0])
    ref = ref_compile(ref_topology(rcfg),
                      ref_split(rcfg.network.faults)[0])
    return port, ref, top


def _leaves_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,rep", [
    ("link_faults", "dense"), ("tgen_faults_hier", "hierarchical"),
    ("tgen_faults_hier", "dense"), ("star_faults", "hierarchical"),
    ("star_faults", "dense")])
def test_fault_tables_equal_the_reference(name, rep):
    """Epoch times, the stacked [T,V,V] tables or the stacked factored
    leaves, each epoch's tables, and the lookahead floor, array for
    array; unchanged epochs are the topology's own tables."""
    text, overrides, _ = RUNS[name]
    port, ref, top = _both_tables(_cfg(text, "tpu", rep),
                                  overrides + _rep_override(name, rep))
    assert port.is_hierarchical == ref.is_hierarchical == (
        rep == "hierarchical")
    np.testing.assert_array_equal(port.times, ref.times)
    assert port.n_epochs == ref.n_epochs > 1
    assert port.min_latency_ns == ref.min_latency_ns
    if rep == "dense":
        _leaves_equal((port.latency_ns, port.reliability),
                      (ref.latency_ns, ref.reliability))
        assert port._lat_epochs[0] is top.latency_ns
    else:
        _leaves_equal(port.lat_parts_stacked(), ref.lat_parts_stacked())
        _leaves_equal(port.rel_parts_stacked(), ref.rel_parts_stacked())
        assert port.epochs[0] is top.hier
    V = top.n_vertices
    rng = np.random.default_rng(3)
    for t in np.concatenate([port.times - 1, port.times, port.times + 1]):
        if t < 0:
            continue
        assert port.epoch_of(int(t)) == ref.epoch_of(int(t))
        for sv, dv in rng.integers(0, V, (20, 2)):
            assert port.lookup(int(t), int(sv), int(dv)) == \
                ref.lookup(int(t), int(sv), int(dv))


def test_star_schedule_has_six_epochs_and_keeps_the_lookahead():
    """phold_1m_hier_faults' schedule: epochs at 0, 200, 300, 400, 500
    and 600 ms, hubs 2-3 rerouted (no pair unreachable), and the 1 ms
    access latency stays the lookahead, as the reference's build
    gives it."""
    from shadow_tpu.config import load_config_str as ref_load
    from shadow_tpu.core.controller import build as ref_build

    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    sim = build(load_config_str(_cfg(STAR_FAULTS_YAML, "tpu")))
    np.testing.assert_array_equal(
        sim.fault_table.times, np.array([0, 200, 300, 400, 500, 600]) * MS)
    assert sim.lookahead == 1 * MS
    for name, (text, overrides, _) in RUNS.items():
        sim = build(load_config_str(_cfg(text, "tpu"), overrides))
        ref = ref_build(ref_load(_cfg(text, "tpu"), overrides))
        assert sim.lookahead == ref.lookahead, name
    rel = sim.fault_table.epochs[3].cluster_rel
    assert rel.min() > 0.0


def test_world_uploads_one_cl_for_every_epoch():
    """The engine world takes the stacked factored leaves with cl once:
    [V], shared by the latency and the reliability tables; admission
    counts it once (beside the epoch times, the host vertices and the
    run's [1, 2] seed key)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    cfg = load_config_str(_cfg(STAR_FAULTS_YAML, "tpu"))
    engine, sim = runner.make_engine(cfg, device="cpu")
    lat, rel = engine.world["lat"], engine.world["rel"]
    T, V = 6, sim.topology.n_vertices
    assert lat[1] is rel[1] and tuple(lat[1].shape) == (V,)
    assert tuple(lat[0].shape) == (T, 4, 4)
    assert tuple(lat[2].shape) == tuple(rel[3].shape) == (T, V)
    assert engine.world["epoch_times"].tolist() == list(
        sim.fault_table.times)
    est = engine.admission["estimate"]
    leaves = [t for t in (*lat, *rel[:1], *rel[2:])]
    table_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert est["world_bytes"] == table_bytes + T * 8 + \
        engine.world["host_vertex"].numel() * 4 + \
        engine.world["seed_key"].numel() * 8


def test_compile_validation_matches_the_reference():
    """tests/test_faults.py's invalid schedules: the same errors."""
    from shadow_tpu.faults import FaultEvent as RefEvent
    from shadow_tpu.faults import compile_link_faults as ref_compile
    from shadow_tpu.topology.graph import Topology as RefTopology

    from shadow_tpu_torch.faults import FaultEvent, compile_link_faults
    from shadow_tpu_torch.topology.graph import Topology

    gml = """graph [ directed 0
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 2 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
  edge [ source 0 target 1 latency "20 ms" packet_loss 0.0 ]
  edge [ source 1 target 2 latency "30 ms" packet_loss 0.0 ]
  edge [ source 0 target 2 latency "80 ms" packet_loss 0.0 ]
]"""
    bad = [
        [dict(kind="link_down", time=0, source=1, target=1)],
        [dict(kind="link_down", time=0, source=0, target=9)],
        [dict(kind="link_down", time=0, source=0, target=1),
         dict(kind="link_down", time=1, source=1, target=0)],
        [dict(kind="link_up", time=1, source=0, target=1)],
        [dict(kind="link_down", time=5, source=0, target=1),
         dict(kind="link_up", time=5, source=0, target=1)],
        [dict(kind="degrade", time=0, source=0, target=1,
              latency_multiplier=2.0)],
        [dict(kind="degrade", time=0, duration=1, source=0, target=1)],
        [dict(kind="degrade", time=-1, duration=1, source=0, target=1,
              latency_multiplier=2.0)],
    ]
    port_top, ref_top = Topology.from_gml(gml), RefTopology.from_gml(gml)
    for events in bad:
        with pytest.raises(ValueError) as want:
            ref_compile(ref_top, [RefEvent(**e) for e in events])
        with pytest.raises(ValueError) as got:
            compile_link_faults(port_top, [FaultEvent(**e) for e in events])
        assert str(got.value) == str(want.value)
    assert compile_link_faults(port_top, []) is None
    # a downed pair of a complete graph without shortest paths is
    # unreachable: reliability 0 at its base latency, as there
    gml_complete = gml.replace(
        '  edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]\n',
        "")
    for shortest in (True, False):
        events = [dict(kind="link_down", time=S, source=0, target=1),
                  dict(kind="link_down", time=S, source=0, target=2)]
        p = compile_link_faults(
            Topology.from_gml(gml_complete, shortest),
            [FaultEvent(**e) for e in events])
        r = ref_compile(RefTopology.from_gml(gml_complete, shortest),
                        [RefEvent(**e) for e in events])
        np.testing.assert_array_equal(p.latency_ns, r.latency_ns)
        np.testing.assert_array_equal(p.reliability, r.reliability)
        assert p.lookup(S, 0, 2)[1] == 0.0


@pytest.mark.parametrize("case", ["downed_spoke", "split_hubs"])
def test_hierarchical_rejections_match_the_reference(case):
    """The factored compiler's two loud rejections (an unreachable pair
    while latency factors change elsewhere): the same message, and the
    dense representation takes the same schedule."""
    from shadow_tpu.faults import FaultEvent as RefEvent
    from shadow_tpu.faults import compile_link_faults as ref_compile
    from shadow_tpu.topology.graph import Topology as RefTopology

    from shadow_tpu_torch.faults import FaultEvent, compile_link_faults
    from shadow_tpu_torch.topology.graph import Topology

    if case == "downed_spoke":
        # 3 hubs, spokes 3,4 / 5,6 / 7,8: spoke 5's only link goes down
        # while spoke 3's access latency doubles
        hubs, spokes = 3, (2, 2, 2)
        events = [dict(kind="link_down", time=S, source=1, target=5),
                  dict(kind="degrade", time=S, duration=2 * S, source=0,
                       target=3, latency_multiplier=2.0),
                  dict(kind="link_up", time=4 * S, source=1, target=5)]
        msg = "unreachable pair (downed access link)"
    else:
        # 2 hubs: their link goes down while an access latency doubles
        hubs, spokes = 2, (2, 2)
        events = [dict(kind="link_down", time=S, source=0, target=1),
                  dict(kind="degrade", time=S, duration=2 * S, source=0,
                       target=2, latency_multiplier=2.0),
                  dict(kind="link_up", time=4 * S, source=0, target=1)]
        msg = "unreachable hub pair with access-latency changes"
    lines = ["graph [ directed 0"]
    V = hubs + sum(spokes)
    lines += [f'  node [ id {i} bandwidth_down "1 Gbit" '
              f'bandwidth_up "1 Gbit" ]' for i in range(V)]
    lines += [f'  edge [ source {a} target {b} latency "30 ms" '
              f'packet_loss 0.01 ]' for a in range(hubs)
              for b in range(a + 1, hubs)]
    k = hubs
    for h, n in enumerate(spokes):
        for _ in range(n):
            lines.append(f'  edge [ source {h} target {k} latency "3 ms" '
                         f'packet_loss 0.0 ]')
            k += 1
    gml = "\n".join(lines + ["]"])
    with pytest.raises(ValueError) as want:
        ref_compile(RefTopology.from_gml(gml, representation="hierarchical"),
                    [RefEvent(**e) for e in events])
    with pytest.raises(ValueError) as got:
        compile_link_faults(Topology.from_gml(
            gml, representation="hierarchical"),
            [FaultEvent(**e) for e in events])
    assert msg in str(want.value)
    assert str(got.value) == str(want.value)
    dense = compile_link_faults(Topology.from_gml(gml),
                                [FaultEvent(**e) for e in events])
    ref = ref_compile(RefTopology.from_gml(gml),
                      [RefEvent(**e) for e in events])
    np.testing.assert_array_equal(dense.latency_ns, ref.latency_ns)
    np.testing.assert_array_equal(dense.reliability, ref.reliability)


def test_schema_rejects_malformed_fault_entries_as_the_reference():
    """tests/test_faults.py's malformed entries: the same errors."""
    from shadow_tpu.config import load_config_str as ref_load

    from shadow_tpu_torch.config import load_config_str

    base = """
general: {stop_time: 1s}
network:
  faults:
    - %s
hosts:
  a:
    processes: [{path: model:phold}]
"""
    for bad in [
            "{kind: nope, time: 1s}",
            "{kind: link_down, time: 1s}",
            "{kind: host_crash, time: 1s}",
            "{kind: link_down, time: 1s, source: 0, target: 1, host: a}",
            "{kind: link_down, source: 0, target: 1}",
            "{kind: host_crash, time: 1s, host: a, duration: 1s}",
            "{kind: link_down, time: 1s, source: 0, target: 1, "
            "latency_multiplier: 2}",
            "{kind: link_down, time: 1s, source: 0, target: 1, bogus: 2}",
            "not_a_mapping"]:
        with pytest.raises(ValueError) as want:
            ref_load(base % bad)
        with pytest.raises(ValueError) as got:
            load_config_str(base % bad)
        assert str(got.value) == str(want.value), bad


def test_host_faults_are_refused_naming_the_hybrid_policy():
    """examples/tgen_faults_hier.yaml as shipped crashes and restarts a
    host: the reference sends it to its hybrid policy, and so does the
    port: the device engine refuses it, naming the hybrid policy in the
    reference's words, and the run goes to the hybrid policy."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.build import NoDeviceTwin, build
    from shadow_tpu_torch.device import runner

    cfg = load_config(os.path.join(ROOT, "examples",
                                   "tgen_faults_hier.yaml"),
                      ["experimental.scheduler_policy=tpu"])
    sim = build(cfg)
    assert sim.app is None and sim.no_twin == (
        "host_crash/host_restart faults are manager-side events; "
        "running hybrid")
    assert [k for _, _, k in sim.host_faults] == ["host_crash",
                                                  "host_restart"]
    with pytest.raises(NoDeviceTwin, match="running hybrid"):
        runner.engine_from(cfg, sim, device="cpu")


def test_epoch_lookup_matches_jax_gather_parts(reference):
    """gather_parts_plain with the epoch of each time (epoch_of) equals
    the JAX gather_parts with the reference engine's `_ep_of`, at every
    epoch start and 1 ns either side; with the reference's stacked cl
    and with the one shared [V] cl the world uploads."""
    from shadow_tpu_torch.device.kernels import epoch_of
    from shadow_tpu_torch.topology.hierarchy import gather_parts_plain

    x = {k: torch.from_numpy(np.asarray(v)) for k, v in
         lookup_inputs().items()}
    e = epoch_of(x["t"], x["times"])
    assert set(e.tolist()) == set(range(6))
    for kind in ("lat", "rel"):
        parts = tuple(x[f"{kind}{i}"] for i in range(4))
        shared = (parts[0], parts[1][0], parts[2], parts[3])
        want = reference[f"gather/{kind}"]
        for p in (parts, shared):
            got = gather_parts_plain(p, x["sv"], x["dv"], e).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(e.numpy(), reference["gather/epoch"])


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_equal_serial_oracle_and_jax(reference, local_runs, name):
    """Totals, rounds, downloads, per-host events and checksums of the
    port's plain path (under each representation it runs) == the
    serial oracle == the JAX engine; the fault windows really
    dropped."""
    ports, (stats, hosts, downloads) = local_runs[name]
    want = _totals(stats, downloads)
    np.testing.assert_array_equal(reference[f"{name}/totals"], want)
    assert stats.packets_dropped > 0
    for rep, port in ports.items():
        assert port.ok, rep
        assert _totals(port, port.downloads_completed or 0) == want, rep
        np.testing.assert_array_equal(
            port.host_events_executed, [h.events_executed for h in hosts])
        np.testing.assert_array_equal(
            port.host_trace_checksum, [h.trace_checksum for h in hosts])
        np.testing.assert_array_equal(port.host_trace_checksum,
                                      reference[f"{name}/chk"])


# ----------------------------------------------------------------------
# the reference, in the child process
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    """Apply the jax batching patch, then run the reference package and
    save what the tests compare."""
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu._jax import jnp
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller
    from shadow_tpu.topology.hierarchy import gather_parts

    with open(job_path) as f:
        job = json.load(f)
    out = {}

    x = {k: jnp.asarray(v) for k, v in lookup_inputs().items()}
    # the reference engine's epoch rule (engine.py `_ep_of`)
    e = (x["t"][..., None] >= x["times"]).sum(-1).astype(jnp.int32) - 1
    out["gather/epoch"] = np.asarray(e)
    for kind in ("lat", "rel"):
        out[f"gather/{kind}"] = np.asarray(gather_parts(
            tuple(x[f"{kind}{i}"] for i in range(4)), x["sv"], x["dv"],
            e=e))

    for name, (text, overrides) in job["runs"].items():
        c = Controller(load_config_str(text, overrides))
        s = c.run()
        assert s.ok, name
        H = len(c.sim.hosts)
        app = np.asarray(c.runner.final_state["app"])[:H]
        downloads = int(app[:, 4].sum()) if app.shape[1] == 7 else 0
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds, downloads], np.int64)
        out[f"{name}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], np.int64)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
