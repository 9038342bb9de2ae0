"""The port's hierarchical topology (shadow_tpu_torch) against the
reference: the `star_clusters` generator and the factored tables
(`HierTables`) array for array, the two-level lookup against the JAX
`gather_parts`, the plain judge on factored tables against itself on
their dense materialization, whole runs on `star_clusters` graphs held
four ways (the port's hierarchical run, the port's dense run, the JAX
`tpu` engine and the serial oracle), the refusals and fallbacks of
the table construction, the preflight admission verdicts, and the build of
examples/tgen_1000000.yaml as shipped. Tolerance everywhere is exact
equality: the simulation is integer-exact, and the factored float32
reliabilities are composed in one fixed order on every path.

The JAX reference runs in a child process (this file's __main__
branch), one child for the whole file, started before the first test:
the reference package's device engine does not import under the
installed jax without a patch to jax's batching registry, and that
patch must never be applied inside the pytest process. The serial
oracle and the reference's topology modules import without it and run
here.

Run lengths are cut to keep the file near a minute on a CPU: the
`star_clusters` parity config of chip_smoke.py runs 1 s (not 2 s), and
examples/tgen_1000000.yaml's shape is cut to 4 clusters of 50 spokes
(199 clients, all of them asking `server0`, which overflows its heap at
the default capacities: the port is held to the reference's overflow
counts there; the serial oracle has no capacities, so it is left out of
that run alone).
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

# tests/test_hierarchy.py's STAR_CFG at policy tpu, 3 clients, stride 1
STAR = """
general: {stop_time: 500ms, seed: 3}
network:
  topology:
    representation: {rep}
  graph:
    type: star_clusters
    clusters: 2
    spokes_per_cluster: 3
    hub_latency: 10 ms
    access_latency: 1 ms
experimental:
  scheduler_policy: {policy}
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

# chip_smoke.py's star_clusters parity config (V=968: the build verifies
# the factored tables against dense), cut from 2 s to 1 s
PARITY = """
general: {stop_time: 1s, seed: 1}
network:
  topology:
    representation: {rep}
  graph:
    type: star_clusters
    clusters: 8
    spokes_per_cluster: 120
    hub_latency: 10 ms
    access_latency: 1 ms
    hub_packet_loss: 0.02
experimental:
  scheduler_policy: {policy}
  event_capacity: 128
  exchange_in_capacity: 128
hosts:
  server:
    quantity: 8
    network_node_id: 8
    network_node_stride: 120
    processes:
    - path: model:tgen_server
      start_time: 10ms
  client:
    quantity: 952
    network_node_id: 9
    network_node_stride: 1
    processes:
    - path: model:tgen_client
      args: server=server size=50KiB count=2 pause=200ms retry=500ms
      start_time: 100ms
"""

# PHOLD with self-sends on a lossy-hub star: hosts share spoke vertices
# (sv == dv between two hosts) and sit on a hub
PHOLD = """
general: {stop_time: 1s, seed: 9}
network:
  topology:
    representation: {rep}
  graph:
    type: star_clusters
    clusters: 3
    spokes_per_cluster: 20
    hub_latency: 7 ms
    access_latency: 2 ms
    hub_packet_loss: 0.05
experimental:
  scheduler_policy: {policy}
hosts:
  spoke:
    quantity: 40
    network_node_id: 3
    network_node_stride: 1
    processes: [{path: model:phold, args: msgload=2 selfloop=1, start_time: 10ms}]
  twin:
    quantity: 20
    network_node_id: 3
    network_node_stride: 1
    processes: [{path: model:phold, args: msgload=2 selfloop=1, start_time: 13ms}]
  hub:
    quantity: 2
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=2 selfloop=1, start_time: 11ms}]
"""


def _example(name: str) -> str:
    with open(os.path.join(ROOT, "examples", name)) as f:
        text = f.read()
    return (text.replace("representation: hierarchical",
                         "representation: {rep}")
            .replace("scheduler_policy: tpu", "scheduler_policy: {policy}"))


# examples/tgen_1000000.yaml's shape cut to 4 clusters x 50 spokes: one
# server per cluster on its first spoke, a client on every other spoke
# from vertex 5, all asking server0
TGEN_1M_CUT = (["network.graph.clusters=4",
                "network.graph.spokes_per_cluster=50",
                "hosts.server.quantity=4", "hosts.server.network_node_id=4",
                "hosts.server.network_node_stride=50",
                "hosts.client.quantity=199",
                "hosts.client.network_node_id=5"])

RUNS = {
    "star": (STAR, []),
    "parity": (PARITY, []),
    "phold": (PHOLD, []),
    "tgen_1m_cut": (None, TGEN_1M_CUT),
}
# runs the serial oracle can hold (it has no capacities to overflow)
ORACLE_RUNS = ("star", "parity", "phold")


def _text(name: str) -> str:
    text, _ = RUNS[name]
    return _example("tgen_1000000.yaml") if text is None else text


def _cfg(text: str, policy: str, rep: str = "hierarchical") -> str:
    return text.replace("{policy}", policy).replace("{rep}", rep)


# admission cases: (mode, device_memory_budget or None)
ADMISSION = [("off", None), ("off", "1 KiB"), ("auto", None),
             ("auto", "1 KiB"), ("auto", "8 GiB"), ("strict", None),
             ("strict", "1 KiB"), ("strict", "8 GiB")]


def _admission_overrides(mode, budget):
    out = [f"experimental.admission={mode}"]
    if budget is not None:
        out.append(f"experimental.device_memory_budget={budget}")
    return out


# ----------------------------------------------------------------------
# seeded inputs of the lookup comparison (made here and in the child)
# ----------------------------------------------------------------------
def clustered_gml(n_hubs=3, spokes=(2, 2, 2), hub_loss=0.01, rng=None):
    """tests/test_hierarchy.py's `_clustered_gml`: a hub clique with
    lossless spokes, random latencies when an rng is passed."""
    def lat(lo, hi):
        return int(rng.integers(lo, hi)) if rng is not None else lo
    V = n_hubs + sum(spokes)
    lines = ["graph [ directed 0"]
    for i in range(V):
        lines.append(f'  node [ id {i} bandwidth_down "1 Gbit" '
                     f'bandwidth_up "1 Gbit" ]')
    for a in range(n_hubs):
        for b in range(a + 1, n_hubs):
            lines.append(f'  edge [ source {a} target {b} latency '
                         f'"{lat(20, 90)} ms" packet_loss {hub_loss} ]')
    k = n_hubs
    for h, n in enumerate(spokes):
        for _ in range(n):
            lines.append(f'  edge [ source {h} target {k} latency '
                         f'"{lat(1, 9)} ms" packet_loss 0.0 ]')
            k += 1
    lines.append("]")
    return "\n".join(lines)


def random_gml(seed: int) -> str:
    """test_hierarchy.py's property shape (`:84`) at one seed."""
    rng = np.random.default_rng(seed)
    n_hubs = int(rng.integers(2, 6))
    spokes = tuple(int(rng.integers(0, 4)) for _ in range(n_hubs))
    return clustered_gml(n_hubs, spokes,
                         hub_loss=float(rng.choice([0.0, 0.02, 0.1])),
                         rng=rng)


def lookup_inputs():
    """Factored leaves (a 6-hub star with lossy hubs AND lossy access:
    the lookup composes whatever leaves it gets) and seeded (sv, dv)
    pairs, a tenth of them sv == dv, hubs and spokes both."""
    from shadow_tpu_torch.topology.generate import generate_star_clusters

    top = generate_star_clusters(
        {"clusters": 6, "spokes_per_cluster": 9, "hub_latency": "13 ms",
         "access_latency": "3 ms", "hub_packet_loss": 0.07,
         "access_packet_loss": 0.03}, representation="hierarchical")
    ht = top.hier
    rng = np.random.default_rng(4)
    N, V = 4096, ht.n_vertices
    sv = rng.integers(0, V, N)
    dv = np.where(rng.random(N) < 0.1, sv, rng.integers(0, V, N))
    return {"cc_lat": ht.cluster_lat.astype(np.int32),
            "cc_rel": ht.cluster_rel, "cl": ht.cl,
            "acc_lat": ht.acc_lat.astype(np.int32), "acc_rel": ht.acc_rel,
            "self_lat": ht.self_lat.astype(np.int32),
            "self_rel": ht.self_rel,
            "sv": sv.astype(np.int32), "dv": dv.astype(np.int32)}


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
    job = {"runs": {k: (_cfg(_text(k), "tpu"), ov)
                    for k, (_, ov) in RUNS.items()},
           "admission": [(_cfg(STAR, "tpu"), _admission_overrides(m, b))
                         for m, b in ADMISSION],
           "estimate": _port_estimate(),
           "sizes": [0, 1023, 1024, 5 * 2**20 + 1, 3 * 2**30, 2**45]}
    with tempfile.TemporaryDirectory(prefix="torch_hier_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _port_estimate() -> dict:
    """The port's footprint of STAR on the CPU (the diagnostic's
    numbers)."""
    return _port_admit(STAR, [])["estimate"]


def _port_admit(text, overrides):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import runner

    cfg = load_config_str(_cfg(text, "tpu"), overrides)
    sim = build(cfg)
    return runner.admit(cfg, sim, runner.engine_config(cfg, sim), "cpu")


def _port_run(name: str, rep: str) -> dict:
    """A whole run on the port's plain path: totals, rounds, downloads
    and per-host events, checksums and overflow."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.device.runner import make_engine

    _, overrides = RUNS[name]
    cfg = load_config_str(_cfg(_text(name), "tpu", rep), overrides)
    engine, sim = make_engine(cfg, device="cpu")
    assert sim.topology.representation == rep
    state, rounds = engine.run(engine.init_state(sim.start_times,
                                                 sim.stop_times))
    f = state_to_numpy(state, ("n_exec", "n_sent", "n_drop", "n_deliv",
                               "chk", "overflow", "app"))
    downloads = engine.app.downloads(f["app"])
    return {"totals": np.array(
                [f["n_exec"].sum(), f["n_sent"].sum(), f["n_drop"].sum(),
                 f["n_deliv"].sum(), rounds,
                 -1 if downloads is None else downloads], np.int64),
            "events": f["n_exec"].astype(np.int64), "chk": f["chk"],
            "overflow": f["overflow"].astype(np.int64)}


def _serial_run(name: str) -> dict:
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    _, overrides = RUNS[name]
    c = Controller(load_config_str(_cfg(_text(name), "serial"), overrides))
    s = c.run()
    hosts = c.sim.hosts
    tgen = any(hasattr(h.app, "downloads_done") for h in hosts)
    downloads = (sum(getattr(h.app, "downloads_done", 0) for h in hosts)
                 if tgen else -1)
    return {"totals": np.array(
                [s.events_executed, s.packets_sent, s.packets_dropped,
                 s.packets_delivered, s.rounds, downloads], np.int64),
            "events": np.array([h.events_executed for h in hosts],
                               np.int64),
            "chk": np.array([h.trace_checksum for h in hosts], np.int64)}


@pytest.fixture(scope="module")
def port_runs():
    return {(name, rep): _port_run(name, rep) for name in RUNS
            for rep in ("hierarchical", "dense")}


# ----------------------------------------------------------------------
# topology: generator, factored tables, refusals and fallbacks
# ----------------------------------------------------------------------
def _same_topology(port, ref):
    assert port.representation == ref.representation
    assert port.n_vertices == ref.n_vertices
    assert port.min_latency_ns == ref.min_latency_ns
    assert port.table_nbytes() == ref.table_nbytes()
    for f in ("vertex_ids", "edge_src", "edge_dst", "edge_latency_ns",
              "edge_reliability"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if ref.hier is None:
        assert port.hier is None
        for f in ("latency_ns", "reliability"):
            a, b = getattr(port, f), getattr(ref, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        return
    assert port.latency_ns is None and port.reliability is None
    for f in ("cluster_lat", "cluster_rel", "cl", "hub_vertex", "acc_lat",
              "acc_rel", "self_lat", "self_rel"):
        a, b = getattr(port.hier, f), getattr(ref.hier, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


STAR_PARAMS = {
    # tests/test_hierarchy.py's layout test graph
    "layout": {"clusters": 3, "spokes_per_cluster": 2,
               "hub_latency": "10 ms", "access_latency": "2 ms"},
    # the parity config's graph
    "parity": {"clusters": 8, "spokes_per_cluster": 120,
               "hub_latency": "10 ms", "access_latency": "1 ms",
               "hub_packet_loss": 0.02},
    "hubs_only": {"clusters": 4},
    "one_vertex": {"clusters": 1},
    "lossy_access": {"clusters": 3, "spokes_per_cluster": 4,
                     "hub_latency": "30 ms", "access_latency": "4 ms",
                     "hub_packet_loss": 0.249207,
                     "access_packet_loss": 0.429362},
}


def _both_or_errors(port_fn, ref_fn):
    """Both results, or both GmlErrors with the same message."""
    from shadow_tpu.topology.gml import GmlError as RefGmlError

    from shadow_tpu_torch.topology.gml import GmlError

    try:
        ref = ref_fn()
    except RefGmlError as e:
        with pytest.raises(GmlError) as got:
            port_fn()
        assert str(got.value) == str(e)
        return None, None
    return port_fn(), ref


@pytest.mark.parametrize("rep", ["hierarchical", "auto", "dense"])
@pytest.mark.parametrize("graph", list(STAR_PARAMS))
def test_star_clusters_tables_equal_the_reference(graph, rep):
    from shadow_tpu.topology.generate import generate_star_clusters as ref

    from shadow_tpu_torch.topology.generate import generate_star_clusters

    params = STAR_PARAMS[graph]
    port, want = _both_or_errors(
        lambda: generate_star_clusters(params, representation=rep),
        lambda: ref(params, representation=rep))
    if want is not None:
        _same_topology(port, want)


@pytest.mark.parametrize("seed", range(5))
def test_random_clustered_tables_equal_the_reference(seed):
    from shadow_tpu.topology.graph import Topology as RefTopology

    from shadow_tpu_torch.topology.graph import Topology

    text = random_gml(seed)
    for rep in ("hierarchical", "auto", "dense"):
        port, want = _both_or_errors(
            lambda: Topology.from_gml(text, representation=rep),
            lambda: RefTopology.from_gml(text, representation=rep))
        _same_topology(port, want)
    # the scalar lookup is the dense matrices' every entry
    td = Topology.from_gml(text, representation="dense")
    th = Topology.from_gml(text, representation="hierarchical")
    for sv in range(td.n_vertices):
        for dv in range(td.n_vertices):
            assert th.path(sv, dv) == td.path(sv, dv)


# tests/test_hierarchy.py's non-factoring lossy graph (its float32
# product and the factored one round apart by an ulp), a direct-edge
# graph, and a triangle without spokes (C == V)
NONFACTORABLE_LOSSY = """graph [ directed 0
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 2 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 3 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 1 latency "20 ms" packet_loss 0.249207 ]
  edge [ source 0 target 2 latency "2 ms" packet_loss 0.034273 ]
  edge [ source 1 target 3 latency "3 ms" packet_loss 0.429362 ]
]"""
DIRECT_ONLY = """graph [ directed 0
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 1 latency "5 ms" packet_loss 0.0 ]
  edge [ source 0 target 0 latency "2 ms" packet_loss 0.0 ]
  edge [ source 1 target 1 latency "3 ms" packet_loss 0.0 ]
]"""
TRIANGLE = """graph [ directed 0
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 2 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 1 latency "5 ms" packet_loss 0.1 ]
  edge [ source 1 target 2 latency "6 ms" packet_loss 0.0 ]
  edge [ source 0 target 2 latency "7 ms" packet_loss 0.0 ]
]"""
DIRECTED = """graph [ directed 1
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 2 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 1 latency "5 ms" packet_loss 0.0 ]
  edge [ source 1 target 0 latency "5 ms" packet_loss 0.0 ]
  edge [ source 0 target 2 latency "3 ms" packet_loss 0.0 ]
  edge [ source 2 target 0 latency "4 ms" packet_loss 0.0 ]
]"""


@pytest.mark.parametrize("graph,rep,shortest,want", [
    (NONFACTORABLE_LOSSY, "hierarchical", True, "bit for bit"),
    (NONFACTORABLE_LOSSY, "auto", True, "dense"),
    (DIRECT_ONLY, "hierarchical", False, "does not factor"),
    (DIRECT_ONLY, "auto", False, "dense"),
    (TRIANGLE, "auto", True, "dense"),
    (TRIANGLE, "hierarchical", True, "hierarchical"),
    (clustered_gml(), "bogus", True, "must be one of"),
], ids=["lossy-hier", "lossy-auto", "direct-hier", "direct-auto",
        "no-spokes-auto", "no-spokes-hier", "bad-name"])
def test_refusals_and_fallbacks_match_the_reference(graph, rep, shortest,
                                                    want):
    """`hierarchical` is a hard GmlError with the reference's message
    where the graph does not factor or fails the bit-exact check;
    `auto` falls back to the dense tables there and where factoring
    would not shrink them."""
    from shadow_tpu.topology.graph import Topology as RefTopology

    from shadow_tpu_torch.topology.gml import GmlError
    from shadow_tpu_torch.topology.graph import Topology

    port, ref = _both_or_errors(
        lambda: Topology.from_gml(graph, shortest, representation=rep),
        lambda: RefTopology.from_gml(graph, shortest, representation=rep))
    if ref is None:
        with pytest.raises(GmlError, match=want):
            Topology.from_gml(graph, shortest, representation=rep)
        return
    assert port.representation == want
    _same_topology(port, ref)


def test_directed_graph_does_not_factor():
    from shadow_tpu.topology.graph import Topology as RefTopology

    from shadow_tpu_torch.topology.graph import Topology

    port, ref = _both_or_errors(
        lambda: Topology.from_gml(DIRECTED, representation="hierarchical"),
        lambda: RefTopology.from_gml(DIRECTED,
                                     representation="hierarchical"))
    assert ref is None     # both raised, with one message
    port, ref = _both_or_errors(
        lambda: Topology.from_gml(DIRECTED, representation="auto"),
        lambda: RefTopology.from_gml(DIRECTED, representation="auto"))
    assert port.representation == "dense"
    _same_topology(port, ref)


@pytest.mark.parametrize("params,shortest", [
    ({"clusters": 0}, True),
    ({"clusters": 2, "spokes_per_cluster": -1}, True),
    ({"clusters": 2, "hub_latency": "0 ms"}, True),
    ({"clusters": 2, "hub_packet_loss": 1.5}, True),
    ({"clusters": 2, "access_packet_loss": -0.1}, True),
    ({"clusters": 2}, False),
])
def test_star_clusters_value_checks_match_the_reference(params, shortest):
    from shadow_tpu.topology.generate import generate_star_clusters as ref

    from shadow_tpu_torch.topology.generate import generate_star_clusters

    port, want = _both_or_errors(
        lambda: generate_star_clusters(params, shortest),
        lambda: ref(params, shortest))
    assert want is None


def test_schema_refuses_generator_keys_off_star_clusters():
    from shadow_tpu.config import load_config_str as ref_load

    from shadow_tpu_torch.config import load_config_str

    text = _cfg(STAR, "tpu").replace("type: star_clusters", "type: gml")
    with pytest.raises(ValueError) as want:
        ref_load(text)
    with pytest.raises(ValueError) as got:
        load_config_str(text)
    assert str(got.value) == str(want.value)


def test_stride_places_hosts_on_consecutive_spokes():
    """tests/test_hierarchy.py's stride layout, and its walk past the
    graph refused."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    sim = build(load_config_str(_cfg(STAR, "tpu")))
    assert sim.topology.representation == "hierarchical"
    np.testing.assert_array_equal(sim.host_vertex, [2, 3, 4, 5])
    assert sim.lookahead == 1 * MS
    with pytest.raises(ValueError, match="walks past"):
        build(load_config_str(_cfg(STAR, "tpu"),
                              ["hosts.client.network_node_stride=4"]))


# ----------------------------------------------------------------------
# the lookup and the plain kernels on factored tables
# ----------------------------------------------------------------------
def test_gather_parts_plain_matches_jax_gather_parts(reference):
    from shadow_tpu_torch.topology.hierarchy import gather_parts_plain

    x = {k: torch.from_numpy(v) for k, v in lookup_inputs().items()}
    sv, dv = x["sv"], x["dv"]
    assert bool((sv == dv).any()) and bool((sv != dv).any())
    lat = gather_parts_plain(
        (x["cc_lat"], x["cl"], x["acc_lat"], x["self_lat"]), sv, dv)
    rel = gather_parts_plain(
        (x["cc_rel"], x["cl"], x["acc_rel"], x["self_rel"]), sv, dv)
    assert lat.dtype == torch.int32 and rel.dtype == torch.float32
    np.testing.assert_array_equal(lat.numpy(), reference["gather/lat"])
    np.testing.assert_array_equal(rel.numpy(), reference["gather/rel"])
    assert reference["gather/lat"].dtype == np.int32
    assert reference["gather/rel"].dtype == np.float32


def _factored_world(rng, H, lossy_access: bool):
    """A factored world and its dense materialization, with hosts
    sharing vertices and sitting on hubs."""
    from shadow_tpu_torch.device.engine import world_arrays
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.topology.generate import generate_star_clusters
    from shadow_tpu_torch.topology.hierarchy import dense_from_parts

    top = generate_star_clusters(
        {"clusters": 5, "spokes_per_cluster": 6, "hub_latency": "9 ms",
         "access_latency": "2 ms", "hub_packet_loss": 0.3,
         "access_packet_loss": 0.2 if lossy_access else 0.0},
        representation="hierarchical")
    ht = top.hier
    hv = rng.integers(0, top.n_vertices, H)
    app = PholdDevice(n_hosts_total=H, msgload=2, size=64, selfloop=1)
    fact = world_arrays(H, app, hv, ht.lat_parts(), ht.rel_parts())
    dlat, drel = dense_from_parts(ht.lat_parts(), ht.rel_parts())
    dense = world_arrays(H, app, hv, dlat, drel)

    def tensors(w):
        return {k: tuple(torch.from_numpy(a) for a in v)
                if isinstance(v, tuple) else torch.from_numpy(v)
                for k, v in w.items()}
    return app, tensors(fact), tensors(dense)


@pytest.mark.parametrize("lossy_access", [False, True])
def test_plain_judge_on_factored_tables_equals_dense_materialization(
        lossy_access):
    """judge_outbox_plain on the factored leaves == on their [V,V]
    materialization (same composition), every output; random sends to
    hosts on the sender's vertex, its cluster and others."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.prng import seed_key

    rng = np.random.default_rng(17)
    H, OB = 300, 12
    app, fact, dense = _factored_world(rng, H, lossy_access)
    p = K.PhaseParams(E=8, K=1, T=0, P=1, B=OB, IN=8, C=1,
                      boot_end=10**8, seed=seed_key(5), app=app)
    live = rng.random((H, OB)) < 0.6
    t = np.where(live, rng.integers(0, 10**9, (H, OB)), K.INF)
    dst = rng.integers(0, H, (H, OB))
    ob = {"t": torch.from_numpy(t.astype(np.int64)),
          "m": torch.from_numpy((dst << 32) | (2 | (1 << 8))),
          "v": torch.from_numpy(np.full((H, OB), 1 << 32, np.int64))}
    state = {k: torch.from_numpy(rng.integers(0, 2**20, H).astype(
        np.int32)) for k in ("packet_seq", "n_sent", "n_drop")}
    outs = []
    for world in (fact, dense):
        s = {k: v.clone() for k, v in state.items()}
        o = {k: v.clone() for k, v in ob.items()}
        K.judge_outbox_plain(s, o, world, 5 * 10**8, p)
        outs.append((s, o))
    (sf, of), (sd, od) = outs
    for k in sf:
        torch.testing.assert_close(sf[k], sd[k], rtol=0, atol=0)
    for k in of:
        torch.testing.assert_close(of[k], od[k], rtol=0, atol=0)
    assert int((sf["n_drop"] - state["n_drop"]).sum()) > 0


def test_plain_pop_reads_self_latency_through_the_factored_tables():
    """pop_plain's dirty test on the factored leaves (self vector) ==
    on the dense diagonal, PHOLD with self-sends."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.engine import STATE_DTYPES
    from shadow_tpu_torch.device.prng import seed_key

    rng = np.random.default_rng(23)
    H, E = 300, 16
    app, fact, dense = _factored_world(rng, H, False)
    p = K.PhaseParams(E=E, K=2, T=0, P=1, B=8, IN=E, C=1, boot_end=0,
                      seed=seed_key(2), app=app)
    n_live = rng.integers(1, E, H)
    live = np.arange(E)[None, :] < n_live[:, None]
    ht = np.where(live, np.sort(rng.integers(0, 2 * 10**7, (H, E)), 1),
                  K.INF)
    state = {k: torch.zeros(H, dtype=torch.int32) if np.dtype(dt) ==
             np.int32 else torch.zeros(H, dtype=torch.int64)
             for k, dt in STATE_DTYPES.items()}
    state.update({
        "ht": torch.from_numpy(ht.astype(np.int64)),
        "hk": torch.from_numpy(np.where(
            live, (rng.integers(0, H, (H, E)) << 32) | np.arange(E),
            K.IMAX).astype(np.int64)),
        "hm": torch.from_numpy(np.where(live, np.int64(2) << 32, 0)),
        "hv": torch.zeros((H, E), dtype=torch.int64),
        "hw": torch.ones((H, E), dtype=torch.int64),
        "app": torch.zeros((H, 1), dtype=torch.int32)})
    outs = []
    for world in (fact, dense):
        s = {k: v.clone() for k, v in state.items()}
        ob = {f: torch.empty((H, p.OB), dtype=torch.int64)
              for f in K.OB_FIELDS}
        pops = torch.empty(H, dtype=torch.int32)
        K.pop_plain(s, ob, pops, world, 10**7, p)
        outs.append((s, ob, pops))
    (sf, of, pf), (sd, od, pd) = outs
    for d1, d2 in ((sf, sd), (of, od)):
        for k in d1:
            torch.testing.assert_close(d1[k], d2[k], rtol=0, atol=0)
    torch.testing.assert_close(pf, pd, rtol=0, atol=0)
    # some host stopped early on an in-window self-send
    assert bool(((pf < p.B) & (sf["head"] < torch.from_numpy(n_live))
                 & (sf["ht"].gather(1, sf["head"].long()[:, None])[:, 0]
                    < 10**7)).any())


def test_cpu_wrappers_count_no_hier_launch():
    """On CPU tensors the wrappers take the plain path on factored
    tables too: nothing counts, nothing builds."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.kernels import KERNEL_NAMES, Kernels
    from shadow_tpu_torch.device.runner import make_engine

    kernels = Kernels(timing=True)
    engine, sim = make_engine(load_config_str(_cfg(STAR, "tpu")),
                              device="cpu", kernels=kernels)
    assert isinstance(engine.world["lat"], tuple)
    assert engine.world["lat"][1] is engine.world["rel"][1]   # one cl
    engine.run(engine.init_state(sim.start_times, sim.stop_times))
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)
    assert kernels._lib is None


# ----------------------------------------------------------------------
# whole runs: hierarchical == dense == JAX tpu == serial oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(RUNS))
def test_runs_equal_dense_jax_and_oracle(reference, port_runs, name):
    hier = port_runs[(name, "hierarchical")]
    dense = port_runs[(name, "dense")]
    for k in hier:
        np.testing.assert_array_equal(hier[k], dense[k],
                                      err_msg=f"{name}: hier vs dense {k}")
        np.testing.assert_array_equal(
            hier[k], reference[f"{name}/{k}"],
            err_msg=f"{name}: port vs JAX {k}")
    if name in ORACLE_RUNS:
        assert int(hier["overflow"].sum()) == 0
        oracle = _serial_run(name)
        for k in oracle:
            np.testing.assert_array_equal(
                hier[k], oracle[k], err_msg=f"{name}: port vs oracle {k}")
    else:
        # the cut million-host shape overflows server0, as it does in
        # the reference
        assert int(hier["overflow"].sum()) > 0
    assert hier["totals"][0] > 0


def test_the_phold_run_sends_to_self_and_to_shared_vertices():
    """The PHOLD star run takes the sv == dv lookups it exists for."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    sim = build(load_config_str(_cfg(PHOLD, "tpu")))
    hv = sim.host_vertex
    assert len(np.unique(hv)) < len(hv)           # hosts share vertices
    assert (hv < 3).any()                         # and sit on a hub
    assert sim.app.selfloop == 1


# ----------------------------------------------------------------------
# admission and the million-vertex example
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode,budget", ADMISSION)
def test_admission_verdicts_match_the_reference(reference, mode, budget):
    i = ADMISSION.index((mode, budget))
    want = str(reference[f"admission/{i}"])
    try:
        v = _port_admit(STAR, _admission_overrides(mode, budget))
    except ValueError as e:
        got = f"raise: {e}"
        if "admission: needs" in want:
            # the reference prices its own engine: the diagnostic's
            # numbers differ, its form is checked below
            assert got.startswith("raise: admission: needs ")
            assert want.startswith("raise: admission: needs ")
            return
    else:
        got = f"{v['action']} fits={v['fits']} source={v['budget_source']}"
    assert got == want


def test_admission_diagnostic_is_the_reference_format(reference):
    from shadow_tpu_torch.device import capacity

    est = _port_estimate()
    assert est["representation"] == "hierarchical"
    assert capacity.admission_diagnostic(est, 1024, "config") == \
        str(reference["diagnostic"])
    sizes = [0, 1023, 1024, 5 * 2**20 + 1, 3 * 2**30, 2**45]
    assert [capacity.fmt_bytes(n) for n in sizes] == \
        list(reference["fmt_bytes"])


def test_admission_runs_before_the_engine_and_strict_refuses():
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    cfg = load_config_str(_cfg(STAR, "tpu"),
                          _admission_overrides("strict", "1 KiB"))
    with pytest.raises(ValueError, match="admission: needs .* budget "
                       r"1\.0 KiB \(config\)"):
        runner.make_engine(cfg, device="cpu")
    stats = runner.run(load_config_str(
        _cfg(STAR, "tpu"), _admission_overrides("auto", "1 KiB")),
        device="cpu")
    assert stats.ok and stats.admission["action"] == "over"
    assert stats.admission["estimate"]["representation"] == "hierarchical"


def test_million_vertex_example_builds_and_fits_its_budget():
    """examples/tgen_1000000.yaml as shipped through the port's load,
    build and admission (on the CPU: the config's budget), held to the
    reference's own proof (tests/test_hierarchy.py:444-462) and its
    tables."""
    from shadow_tpu.config import load_config as ref_load
    from shadow_tpu.core.controller import load_topology as ref_topology

    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import runner

    path = os.path.join(ROOT, "examples", "tgen_1000000.yaml")
    cfg = load_config(path)
    sim = build(cfg)
    top = sim.topology
    assert top.n_vertices == 1_000_200
    assert top.representation == "hierarchical"
    assert top.hier.n_clusters == 200
    assert top.table_nbytes() == 28_485_600
    assert top.table_nbytes() <= int(cfg.experimental.device_memory_budget)
    assert top.min_latency_ns == 1 * MS and sim.lookahead == 1 * MS
    assert len(sim.host_vertex) == 1_000_000
    assert sim.host_vertex[199] == 200 + 199 * 5000
    assert sim.host_vertex[200] == 201 and sim.host_vertex[-1] == 1_000_000
    # every client asks server0 (an exact host name)
    assert (sim.app.server_gid == 0).all()
    v = runner.admit(cfg, sim, runner.engine_config(cfg, sim), "cpu")
    assert (v["action"], v["budget_source"]) == ("admit", "config")
    assert v["estimate"]["world_bytes"] < 2**30
    _same_topology(top, ref_topology(ref_load(path)))


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
    from shadow_tpu.device import capacity
    from shadow_tpu.topology.hierarchy import gather_parts

    with open(job_path) as f:
        job = json.load(f)
    out = {}

    x = {k: jnp.asarray(v) for k, v in lookup_inputs().items()}
    out["gather/lat"] = np.asarray(gather_parts(
        (x["cc_lat"], x["cl"], x["acc_lat"], x["self_lat"]),
        x["sv"], x["dv"]))
    out["gather/rel"] = np.asarray(gather_parts(
        (x["cc_rel"], x["cl"], x["acc_rel"], x["self_rel"]),
        x["sv"], x["dv"]))

    for name, (text, overrides) in job["runs"].items():
        c = Controller(load_config_str(text, overrides))
        s = c.run()
        H = len(c.sim.hosts)
        final = {k: np.asarray(v)[:H] for k, v in
                 c.runner.final_state.items() if k in (
                     "n_exec", "chk", "overflow", "app")}
        tgen = final["app"].shape[1] == 7
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds,
             int(final["app"][:, 4].sum()) if tgen else -1], np.int64)
        out[f"{name}/events"] = final["n_exec"].astype(np.int64)
        out[f"{name}/chk"] = final["chk"].astype(np.int64)
        out[f"{name}/overflow"] = final["overflow"].astype(np.int64)

    for i, (text, overrides) in enumerate(job["admission"]):
        c = Controller(load_config_str(text, overrides))
        try:
            v = capacity.admission_verdict(
                c.runner.engine, c.cfg.experimental,
                pipeline_depth=getattr(c.cfg.experimental,
                                       "pipeline_depth", 0))
        except ValueError as e:
            out[f"admission/{i}"] = np.str_(f"raise: {e}")
        else:
            out[f"admission/{i}"] = np.str_(
                f"{v['action']} fits={v['fits']} "
                f"source={v['budget_source']}")
    out["diagnostic"] = np.str_(capacity.admission_diagnostic(
        job["estimate"], 1024, "config"))
    out["fmt_bytes"] = np.array([capacity.fmt_bytes(n)
                                 for n in job["sizes"]])
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
