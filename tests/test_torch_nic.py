"""The port's model NIC and path counters (shadow_tpu_torch) against the
reference: `experimental.model_bandwidth` (TX serialization at send, RX
serialization and event-driven CoDel at delivery through the two-stage
KIND_PACKET -> KIND_PACKET_READY pop) and `experimental.count_paths`
(the [V,V] histogram of sent packets). Whole PHOLD, tgen and Tor runs
on the port's plain path are held to the serial CPU oracle (in process)
and the JAX `tpu` engine (in a child), the NIC leaves to the JAX
engine's window by window, the path counters to the oracle's
`NetworkModel.path_packets` and the JAX engine's `path_cnt`, the NIC's
constants to the reference's, and the refusals to the slice's.
Tolerance everywhere is exact equality: the simulation is
integer-exact, and the CoDel law is one integer table built on the
host.

The JAX reference runs in a child process (this file's __main__
branch), one child for the whole file, started before the first test:
the reference package's device engine does not import under the
installed jax without a patch to jax's batching registry, and that
patch must never be applied inside the pytest process.

Run lengths are cut to keep the file near a minute and a half on a CPU:
tests/test_model_nic.py's PHOLD config runs its 3 s, the tgen and Tor
configs 3 s and 4 s with a few clients, examples/tor_small.yaml 3 s
(not 60).
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_model_nic.py's config
PHOLD_YAML = """
general:
  stop_time: 3s
  seed: 3
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "{bw}" bandwidth_up "{bw}" ]
        node [ id 1 bandwidth_down "{bw}" bandwidth_up "{bw}" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss {loss} ]
        edge [ source 0 target 1 latency "10 ms" packet_loss {loss} ]
        edge [ source 1 target 1 latency "10 ms" packet_loss {loss} ]
      ]
experimental:
  scheduler_policy: {{policy}}
  model_bandwidth: true
  event_capacity: 96
  outbox_capacity: 48
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes:
    - path: model:phold
      args: msgload=3 size=4096
      start_time: 10ms
  right:
    quantity: 8
    network_node_id: 1
    processes:
    - path: model:phold
      args: msgload=3 size=4096
      start_time: 10ms
"""

# a tgen server and four clients whose downlink (2 Mbit) is slower than
# the server's uplink (20 Mbit): chunks queue at the clients, retries
# pile on, lossy paths; with the path counters
TGEN_YAML = """
general: {stop_time: 3s, seed: 4}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.1 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.1 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.1 ] ]
experimental: {scheduler_policy: '{policy}', model_bandwidth: true,
               count_paths: true, event_capacity: 128, outbox_capacity: 64}
hosts:
  server:
    network_node_id: 0
    bandwidth_up: 20 Mbit
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 4
    network_node_id: 1
    bandwidth_down: 2 Mbit
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=100KiB count=2 pause=200ms retry=300ms}
"""

# tests/test_torch_tor.py's TOR_YAML (tests/test_tor.py's config), lossy
# with retries, the clients' downlink at 1 Mbit, cut to 4 s
TOR_YAML = """
general: {stop_time: 4s, seed: 1}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Mbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "40 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "20 ms" packet_loss 0.05 ]
      ]
experimental:
  scheduler_policy: '{policy}'
  model_bandwidth: true
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

# PHOLD without the NIC on a lossy 2-vertex graph, with the path
# counters (the judge at the flush marks dead rows DROP_T for them)
PHOLD_CP_YAML = """
general: {stop_time: 500ms, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.05 ] ]
experimental: {scheduler_policy: '{policy}', count_paths: true}
hosts:
  a:
    quantity: 3
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 10ms}]
  b:
    quantity: 3
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=2, start_time: 12ms}]
"""


def phold(bw: str, loss: float) -> str:
    return PHOLD_YAML.format(bw=bw, loss=loss)


def _tor_small():
    """examples/tor_small.yaml under the model NIC, client_us's downlink
    at 1 Mbit, cut to 3 s."""
    with open(os.path.join(ROOT, "examples", "tor_small.yaml")) as f:
        text = f.read()
    return (text.replace("scheduler_policy: tpu",
                         "scheduler_policy: '{policy}'"),
            ["general.stop_time=3s", "experimental.model_bandwidth=true",
             "hosts.client_us.bandwidth_down=1 Mbit"])


# whole runs, held to the serial oracle and the JAX `tpu` engine
RUNS = {
    "phold_constrained": (phold("1 Mbit", 0.0), []),
    "phold_constrained_lossy": (phold("2 Mbit", 0.05),
                                ["experimental.count_paths=true"]),
    "tgen": (TGEN_YAML, []),
    "tor": (TOR_YAML, []),
    "tor_small": _tor_small(),
    "phold_count_paths": (PHOLD_CP_YAML, []),
}
# the runs with the path counters
PATH_RUNS = ("phold_constrained_lossy", "tgen", "phold_count_paths")
WINDOW = (phold("2 Mbit", 0.05), [])
N_WINDOWS = 12


def _cfg(text: str, policy: str) -> str:
    return text.replace("{policy}", policy)


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
    job = {"runs": {k: (_cfg(t, "tpu"), ov) for k, (t, ov) in RUNS.items()},
           "window": (_cfg(WINDOW[0], "tpu"), WINDOW[1]),
           "n_windows": N_WINDOWS}
    with tempfile.TemporaryDirectory(prefix="torch_nic_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


def _port_run(text, overrides):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    return runner.run(load_config_str(_cfg(text, "tpu"), overrides),
                      device="cpu")


def _serial_run(text, overrides):
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    c = Controller(load_config_str(_cfg(text, "serial"), overrides))
    stats = c.run()
    hosts = c.sim.hosts
    downloads = sum(getattr(h.app, "downloads_done", 0) for h in hosts)
    return stats, hosts, downloads, dict(c.sim.netmodel.path_packets)


@pytest.fixture(scope="module")
def local_runs():
    """Every run on the port's plain path and on the serial oracle."""
    return {name: (_port_run(*run), _serial_run(*run))
            for name, run in RUNS.items()}


def _totals(stats, downloads):
    return [stats.events_executed, stats.packets_sent,
            stats.packets_dropped, stats.packets_delivered, stats.rounds,
            downloads]


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
def test_law_table_and_serialization_equal_the_reference():
    from shadow_tpu.host import model_nic as ref

    from shadow_tpu_torch.host import model_nic as port

    np.testing.assert_array_equal(port.LAW, ref.LAW)
    assert port.LAW.dtype == ref.LAW.dtype == np.int64
    for name in ("CODEL_TARGET_NS", "CODEL_INTERVAL_NS", "LAW_SIZE",
                 "MAX_SER_BYTES"):
        assert getattr(port, name) == getattr(ref, name), name
    np.testing.assert_array_equal(port.codel_law_table(7 * 10**7),
                                  ref.codel_law_table(7 * 10**7))
    for size in (-5, 0, 1, 64, 1448, 46336, 2**30, 2**30 + 1, 2**31 - 1):
        for bw in (0, 1, 8_000_000, 10**9, 10**12):
            assert port.serialize_ns(size, bw) == \
                ref.serialize_ns(size, bw), (size, bw)


@pytest.mark.parametrize("name", list(RUNS))
def test_runs_equal_serial_oracle_and_jax(reference, local_runs, name):
    """Totals, rounds, downloads and per-host events and checksums of
    the port's plain path == the serial oracle == the JAX engine."""
    port, (stats, hosts, downloads, _) = local_runs[name]
    assert port.ok
    got = _totals(port, port.downloads_completed or 0)
    assert got == _totals(stats, downloads), name
    np.testing.assert_array_equal(reference[f"{name}/totals"], got)
    np.testing.assert_array_equal(
        port.host_events_executed, [h.events_executed for h in hosts])
    np.testing.assert_array_equal(
        port.host_trace_checksum, [h.trace_checksum for h in hosts])
    np.testing.assert_array_equal(port.host_events_executed,
                                  reference[f"{name}/events"])
    np.testing.assert_array_equal(port.host_trace_checksum,
                                  reference[f"{name}/chk"])


def test_codel_drops_and_the_nic_delays_show_in_the_runs(local_runs):
    """The constrained configs exercise what they are for: CoDel drops
    packets on a lossless graph, and the READY stage doubles the pops
    of every delivered packet."""
    port, _ = local_runs["phold_constrained"]
    assert port.packets_dropped > 0          # loss 0: CoDel alone
    for name in ("tgen", "tor", "phold_constrained_lossy"):
        port, _ = local_runs[name]
        assert port.packets_dropped > 0 and port.packets_delivered > 0
    port, _ = local_runs["tgen"]
    assert port.downloads_completed > 0


@pytest.mark.parametrize("name", PATH_RUNS)
def test_path_counters_equal_oracle_and_jax(reference, local_runs, name):
    """The [V,V] histogram of sent packets (drop-rolled ones included)
    == the serial oracle's NetworkModel.path_packets == the JAX
    engine's path_cnt."""
    port, (stats, _, _, oracle) = local_runs[name]
    assert port.path_packets == oracle
    cnt = reference[f"{name}/path_cnt"]
    V = int(np.sqrt(cnt.shape[-1]))
    ref = cnt.sum(0).reshape(V, V)
    assert port.path_packets == {(int(i), int(j)): int(ref[i, j])
                                 for i, j in zip(*np.nonzero(ref))}
    assert sum(port.path_packets.values()) >= stats.packets_sent


def test_port_windows_match_jax_state_leaf_by_leaf(reference):
    """From the JAX engine's init_state, each of the first windows of the
    lossy constrained PHOLD run equals the reference's `_round_step` on
    every state leaf, the seven NIC leaves included."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.engine import state_from_numpy
    from shadow_tpu_torch.device.kernels import NIC_KEYS
    from shadow_tpu_torch.device.runner import make_engine

    engine, _ = make_engine(load_config_str(_cfg(WINDOW[0], "tpu"),
                                            WINDOW[1]), device="cpu")
    p = engine.params
    assert p.MB and (p.P, p.K, p.T, p.M_out, p.B) == (1, 3, 0, 4, 12)
    keys = sorted({k.split("/")[1] for k in reference
                   if k.startswith("w0/")})
    assert set(NIC_KEYS) <= set(keys)
    state = state_from_numpy({k: reference[f"w0/{k}"] for k in keys},
                             "cpu")
    assert set(state) == set(keys)
    for w in range(1, N_WINDOWS + 1):
        win_end = int(reference[f"w{w}/win_end"])
        nxt = engine.window(state, win_end)
        assert nxt == int(reference[f"w{w}/next"]), w
        for k in keys:
            np.testing.assert_array_equal(
                state[k].numpy(), reference[f"w{w}/{k}"],
                err_msg=f"window {w}, leaf {k}")
    assert int(state["rx_free"].max()) > 0 and \
        int(state["tx_free"].max()) > 0


def test_host_bandwidths_follow_group_overrides_and_vertices():
    """Per-host bandwidths as the reference's builds fill them (its
    columnar plane for tgen, its host objects for Tor): a group's own
    value, else its vertices'."""
    from shadow_tpu.config import load_config_str as ref_load
    from shadow_tpu.core.controller import build as ref_build

    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    for text in (TGEN_YAML, TOR_YAML):
        sim = build(load_config_str(_cfg(text, "tpu")))
        ref = ref_build(ref_load(_cfg(text, "tpu")))
        for f in ("bw_up_bits", "bw_down_bits"):
            want = (getattr(ref.plane, f) if ref.plane is not None else
                    [getattr(h, f) for h in ref.hosts])
            np.testing.assert_array_equal(getattr(sim, f), want)
    sim = build(load_config_str(_cfg(TGEN_YAML, "tpu")))
    assert sim.bw_up_bits[0] == 20 * 10**6
    assert list(sim.bw_down_bits[1:]) == [2 * 10**6] * 4


@pytest.mark.parametrize("override,match", [
    ("experimental.scheduler_policy=thread",
     r"thread .* \(ROADMAP.md queue \(a\) item 10 \(the threaded CPU "
     r"policies\)\)"),
    ("experimental.mesh_shards=2",
     r"model_bandwidth on a mesh .* \(ROADMAP.md queue \(a\) item 9 "
     r"\(multi-GPU: "),
])
def test_outside_the_slice_is_refused_by_name(override, match):
    """The threaded policies are refused by name; the model NIC on a
    mesh, refused until ROADMAP (a) item 9a, builds
    (tests/test_torch_mesh_state.py runs it)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import OutsideSlice, build

    cfg = load_config_str(_cfg(phold("1 Mbit", 0.0), "tpu"), [override])
    if override == "experimental.mesh_shards=2":
        sim = build(cfg)
        assert sim.app is not None and cfg.experimental.model_bandwidth
        return
    with pytest.raises(OutsideSlice, match=match):
        build(cfg)


def test_count_paths_needs_a_small_graph_as_the_reference_says():
    """V*V > 65536 is refused before anything runs, with the
    reference engine's message."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    text = PHOLD_CP_YAML.replace("""  graph:
    type: gml""", """  graph:
    type: star_clusters
    clusters: 2
    spokes_per_cluster: 200
    hub_latency: 10 ms
    access_latency: 1 ms
  unused:
    type: gml""")
    text = text[:text.index("  unused:")] + text[text.index(
        "experimental:"):]
    cfg = load_config_str(_cfg(text, "tpu"))
    with pytest.raises(ValueError, match=r"count_paths needs V\*V <= "
                       r"65536 \(histogram boundaries scale with V\^2; "
                       r"this graph has V=402\)"):
        runner.make_engine(cfg, device="cpu")
    cfg = load_config_str(_cfg(text, "tpu"),
                          ["network.graph.spokes_per_cluster=127"])
    engine, _ = runner.make_engine(cfg, device="cpu")
    assert engine.n_vertices == 256


def test_schema_refuses_what_the_reference_refuses_with_the_nic():
    from shadow_tpu_torch.config import load_config_str

    text = _cfg(phold("1 Mbit", 0.0), "tpu")
    with pytest.raises(ValueError, match="burst_pops > 1 cannot combine"):
        load_config_str(text, ["experimental.burst_pops=4"])
    with pytest.raises(ValueError, match="judge_placement: flush cannot"):
        load_config_str(text, ["experimental.judge_placement=flush"])
    # the tgen app's own burst width is set to 1 under the NIC, and the
    # READY column joins each iteration (B = 64 // 3)
    from shadow_tpu_torch.device.runner import make_engine

    engine, _ = make_engine(load_config_str(_cfg(TGEN_YAML, "tpu")),
                            device="cpu")
    p = engine.params
    assert (p.P, p.K, p.T, p.M_out, p.B) == (1, 1, 1, 3, 21)


@pytest.mark.parametrize("name", ["tgen", "phold_constrained_lossy"])
def test_footprint_prices_the_nic_leaves_ready_column_and_counters(name):
    """The admission estimate's state and scratch bytes are the bytes
    the engine allocates: the seven NIC leaves, path_cnt, and the
    outbox with its READY column."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device import runner

    text, overrides = RUNS[name]
    cfg = load_config_str(_cfg(text, "tpu"), overrides)
    engine, sim = runner.make_engine(cfg, device="cpu")
    est = engine.admission["estimate"]
    state = engine.init_state(sim.start_times, sim.stop_times)
    assert {"tx_free", "cd_drop", "path_cnt"} <= set(state)
    assert est["state_bytes"] == sum(t.numel() * t.element_size()
                                     for t in state.values())
    ob, pops = engine._outbox()
    H, OB = pops.shape[0], engine.params.OB
    assert OB == engine.params.B * (engine.params.K + engine.params.T + 1)
    assert sum(t.numel() * t.element_size() for t in ob.values()) + \
        pops.numel() * 4 + (H * OB + 2 * H + K.route_work_words(
            H * OB, False)) * 8 + (2 + H) * 4 == est["scratch_bytes"]
    world = sum(t.numel() * t.element_size() for k, v in
                engine.world.items()
                for t in (v if isinstance(v, tuple) else (v,)))
    assert est["world_bytes"] == world


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

    with open(job_path) as f:
        job = json.load(f)
    out = {}

    for name, (text, overrides) in job["runs"].items():
        c = Controller(load_config_str(text, overrides))
        s = c.run()
        assert s.ok, name
        final = c.runner.final_state
        H = len(c.sim.hosts)
        app = np.asarray(final["app"])[:H]
        downloads = {7: lambda a: int(a[:, 4].sum()),
                     6: lambda a: int(a[a[:, 0] == 1, 3].sum())}.get(
                         app.shape[1], lambda a: 0)(app)
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds, downloads], np.int64)
        out[f"{name}/events"] = np.array(
            [h.events_executed for h in c.sim.hosts], np.int64)
        out[f"{name}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], np.int64)
        if "path_cnt" in final:
            out[f"{name}/path_cnt"] = np.asarray(final["path_cnt"])

    # window by window, with the window merge pinned (the judge stays
    # in the step under the NIC)
    text, overrides = job["window"]
    text = text.replace("experimental:", "experimental:\n"
                        "  merge_strategy: window")
    c = Controller(load_config_str(text, overrides))
    eng = c.runner.engine
    state = eng.init_state(c.sim.starts)
    world, hv = eng.world(), eng.host_vertex_device()
    stop = eng.config.stop_time

    def save(prefix, st):
        for k, v in st.items():
            out[f"{prefix}/{k}"] = np.asarray(v)

    save("w0", state)
    nxt = int(np.asarray(state["ht"])[:, 0].min())
    for w in range(1, job["n_windows"] + 1):
        win_end = min(nxt + int(eng.config.lookahead), stop)
        state, nxt = eng._round_step(state, jnp.int64(win_end), hv, world)
        nxt = int(nxt)
        save(f"w{w}", state)
        out[f"w{w}/win_end"] = np.int64(win_end)
        out[f"w{w}/next"] = np.int64(nxt)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
