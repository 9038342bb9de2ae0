"""Rules the port keeps: it imports neither jax nor the JAX package, its
entry points run on the card unless told otherwise, it refuses configs
outside its slice by name, and its kernel wrappers take the plain path
only for CPU tensors, counting no launch there."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from shadow_tpu_torch.config import load_config_str
from shadow_tpu_torch.core.build import OutsideSlice, build
from shadow_tpu_torch.device import engine as port_engine
from shadow_tpu_torch.device import runner
from shadow_tpu_torch.device.kernels import KERNEL_NAMES, Kernels

ROOT = Path(__file__).resolve().parent.parent

PHOLD = """
general: {stop_time: 300ms, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.05 ] ]
experimental: {scheduler_policy: tpu}
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


def _port_files():
    files = sorted((ROOT / "shadow_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "shadow_tpu"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    cfg = load_config_str(PHOLD)
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device; the refusal is for "
                    "boxes without one")
    with pytest.raises(port_engine.NoCudaDevice, match="device='cpu'"):
        runner.run(cfg)
    with pytest.raises(port_engine.NoCudaDevice):
        runner.make_engine(cfg)
    assert runner.run(cfg, device="cpu").ok


# admitted since ROADMAP (a) item 9a (the audit on a mesh) and 13.1
# (the mesh shrink, the device_loss chaos kind, retries on a mesh)
MESH_ADMITTED = ("experimental={scheduler_policy: tpu, mesh_shards: 2, "
                 "state_audit: true}",
                 "experimental.failover=shrink",
                 "experimental.chaos=[{kind: device_loss, segment: 1, "
                 "shard: 0}]",
                 "experimental={scheduler_policy: tpu, mesh_shards: 2, "
                 "dispatch_retries: 1}")


@pytest.mark.parametrize("override,item", [
    ("experimental.scheduler_policy=thread", "queue (a) item 10"),
    ("experimental.pipeline_depth=2", "queue (a) item 13"),
    ("experimental={scheduler_policy: tpu, mesh_shards: 2, "
     "state_audit: true}", "queue (a) item 9"),
    ("hosts.a.processes=[{path: model:tgen_tcp_server, start_time: 10ms}]",
     "queue (a) item 10"),
    ("experimental.failover=shrink", "queue (a) item 13"),
    ("experimental.chaos=[{kind: device_loss, segment: 1, shard: 0}]",
     "queue (a) item 13"),
    ("experimental.round_watchdog=5", "queue (a) item 13"),
    ("experimental.chaos=[{kind: cache_store_fail, store: 0}]",
     "queue (a) item 14"),
    ("experimental={scheduler_policy: tpu, mesh_shards: 2, "
     "dispatch_retries: 1}", "queue (a) item 13"),
])
def test_configs_outside_the_slice_are_refused_by_roadmap_item(
        override, item):
    """Each refused key names its ROADMAP item; the audit on a mesh,
    refused until ROADMAP (a) item 9a, and the shrink, a device loss and
    retries on a mesh, refused until item 13.1, are admitted."""
    from shadow_tpu_torch.config.loader import load_config_str as load

    cfg = load(PHOLD, [override])
    if override in MESH_ADMITTED:
        assert build(cfg).app is not None
        return
    with pytest.raises(OutsideSlice, match="ROADMAP.md " +
                       item.replace("(", r"\(").replace(")", r"\)")):
        build(cfg)


@pytest.mark.parametrize("overrides,policy", [
    (["experimental.outbox_compact=8"], "tpu"),
    (["experimental.outbox_compact=2", "experimental.merge_strategy=global"],
     "tpu"),
    (["experimental.scheduler_policy=serial"], "serial"),
    (["experimental.scheduler_policy=hybrid",
      "experimental.hybrid_judge_min_batch=0"], "hybrid"),
    (["network.faults=[{kind: host_crash, time: 100ms, host: a0}, "
      "{kind: host_restart, time: 200ms, host: a0}]"], "hybrid"),
    (["hosts.b.processes=[{path: model:tgen_server, start_time: 10ms}]"],
     "hybrid"),
])
def test_lifted_keys_are_admitted_and_run_on_the_cpu(overrides, policy):
    """What this slice lifts runs: the compaction under either rule, the
    serial and hybrid policies, host faults and a mix of model families
    (the last two on the hybrid policy under `tpu`)."""
    from shadow_tpu_torch.config.loader import load_config_str as load

    stats = runner.run(load(PHOLD, overrides), device="cpu")
    assert stats.policy == policy and stats.events_executed > 0


@pytest.mark.parametrize("case", ["save_time", "every", "load"])
def test_checkpoint_keys_are_admitted_and_run_on_the_cpu(tmp_path, case):
    """The checkpoint keys are inside the slice: a paused save, a
    rotated run and a resume of the pause build and run, the resume
    equal to the uninterrupted run."""
    from shadow_tpu_torch.config.loader import load_config_str as load

    ck = str(tmp_path / "run.npz")
    pause = [f"experimental.checkpoint_save={ck}",
             "experimental.checkpoint_save_time=150ms"]
    if case == "save_time":
        stats = runner.run(load(PHOLD, pause), device="cpu")
        assert stats.ok and stats.end_time == 150_000_000
    elif case == "every":
        stats = runner.run(load(PHOLD, [
            f"experimental.checkpoint_save={ck}",
            "experimental.checkpoint_every=100ms"]), device="cpu")
        assert stats.ok and len(stats.pipeline["checkpoint_io"]
                                ["rotation"]) == 2
    else:
        runner.run(load(PHOLD, pause), device="cpu")
        stats = runner.run(load(PHOLD, [f"experimental.checkpoint_load="
                                        f"{ck}"]), device="cpu")
        plain = runner.run(load_config_str(PHOLD), device="cpu")
        assert stats.ok and stats.events_executed == \
            plain.events_executed
        np.testing.assert_array_equal(stats.host_trace_checksum,
                                      plain.host_trace_checksum)


def test_threaded_hybrid_cpu_policy_and_cpu_engine_keys_are_refused():
    from shadow_tpu_torch.config.loader import load_config_str as load
    from shadow_tpu_torch.core.controller import Controller

    with pytest.raises(OutsideSlice, match="queue \\(a\\) item 10"):
        build(load(PHOLD, ["experimental.scheduler_policy=hybrid",
                           "experimental.hybrid_cpu_policy=thread"]))
    for key in ("general.heartbeat_interval=100ms",
                "hosts.a.pcap_directory=pcap"):
        with pytest.raises(OutsideSlice, match="queue \\(a\\) item 10"):
            Controller(load(PHOLD, ["experimental.scheduler_policy=serial",
                                    key]))
    with pytest.raises(ValueError, match="host_crash/host_restart"):
        build(load(PHOLD, [CAMPAIGN, "network.faults=[{kind: host_crash, "
                           "time: 100ms, host: a0}]"]))


CAMPAIGN = "ensemble={replicas: 2, vary: {seed: [3, 4]}}"


@pytest.mark.parametrize("override,item", [
    ("experimental.failover=shrink", "queue (a) item 13"),
    ("experimental.chaos=[{kind: oom, segment: 1}]", "queue (a) item 13"),
    ("experimental.strategy_plan=auto", "queue (a) item 14"),
    ("experimental.pipeline_depth=2", "queue (a) item 13"),
    ("experimental.round_watchdog=5", "queue (a) item 13"),
    ("experimental.mesh_shards=2", "queue (a) item 9"),
])
def test_campaign_keys_still_refused_name_their_items(override, item):
    """Each key is refused for a campaign naming its item, but two that
    are admitted now: the shrink (a campaign's failover, since item
    13.1), and the mesh (item 9c), where since 13.1 a campaign also
    takes retries, the shrink and chaos."""
    from shadow_tpu_torch.config.loader import load_config_str as load

    cfg = load(PHOLD, [CAMPAIGN, override])
    if override == "experimental.failover=shrink":
        assert build(cfg).app is not None
        return
    if override == "experimental.mesh_shards=2":
        assert build(cfg).app is not None
        cfg = load(PHOLD, [CAMPAIGN, override,
                           "experimental.dispatch_retries=1",
                           "experimental.failover=shrink",
                           "experimental.chaos=[{kind: device_loss, "
                           "segment: 1, shard: 1}]"])
        assert build(cfg).app is not None
        return
    with pytest.raises(OutsideSlice, match="ROADMAP.md " +
                       item.replace("(", r"\(").replace(")", r"\)")):
        build(cfg)


@pytest.mark.parametrize("case", ["save", "every", "load"])
def test_campaign_checkpoint_keys_are_admitted_and_run_on_the_cpu(
        tmp_path, case):
    """A campaign's checkpoint keys run: the end-of-run save and the
    rotation carry the campaign's stamp, and a resume of a paused
    campaign equals the uninterrupted one, replica by replica."""
    from shadow_tpu_torch.config.loader import load_config_str as load
    from shadow_tpu_torch.device import checkpoint
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    ck = str(tmp_path / "run.npz")
    rec = f"ensemble.record_path={tmp_path / 'rec.json'}"

    def run(*extra):
        return EnsembleRunner(load(PHOLD, [CAMPAIGN, rec, *extra]),
                              device="cpu").run()

    if case == "save":
        stats = run(f"experimental.checkpoint_save={ck}")
        assert stats.ok and checkpoint.peek_meta(ck)["ensemble"][
            "replicas"] == 2
    elif case == "every":
        stats = run(f"experimental.checkpoint_save={ck}",
                    "experimental.checkpoint_every=100ms")
        assert stats.ok and len(stats.pipeline["checkpoint_io"]
                                ["rotation"]) == 2
    else:
        plain = run()
        run(f"experimental.checkpoint_save={ck}",
            "experimental.checkpoint_save_time=150ms")
        stats = run(f"experimental.checkpoint_load={ck}")
        assert stats.ok
        assert [r["host_checksums"] for r in stats.ensemble["replicas"]] \
            == [r["host_checksums"] for r in plain.ensemble["replicas"]]


def test_ensemble_is_admitted_and_runs_on_the_cpu(tmp_path):
    """An `ensemble:` config builds (static capacities named or not) and
    runs its campaign on the CPU; a standalone heartbeat is ignored."""
    from shadow_tpu_torch.config.loader import load_config_str as load
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    build(load(PHOLD, [CAMPAIGN, "experimental.capacity_plan=static"]))
    build(load(PHOLD, ["general.heartbeat_interval=100ms"]))
    stats = EnsembleRunner(load(PHOLD, [
        CAMPAIGN, f"ensemble.record_path={tmp_path / 'rec.json'}"]),
        device="cpu").run()
    assert stats.ok and stats.ensemble["workload"]["replicas"] == 2
    assert (tmp_path / "rec.json").exists()


def test_state_audit_is_admitted_and_runs_on_the_cpu():
    """`experimental.state_audit` is inside the slice: an audited PHOLD
    config builds, runs with a clean word and the unaudited trace."""
    from shadow_tpu_torch.config.loader import load_config_str as load

    plain = runner.run(load_config_str(PHOLD), device="cpu")
    cfg = load(PHOLD, ["experimental.state_audit=true"])
    build(cfg)
    audited = runner.run(cfg, device="cpu")
    assert audited.ok and audited.loop == "python"
    assert audited.summary() == plain.summary()
    np.testing.assert_array_equal(audited.host_trace_checksum,
                                  plain.host_trace_checksum)


def test_wrappers_take_the_plain_path_on_cpu_and_count_nothing():
    kernels = Kernels(timing=True)
    engine, sim = runner.make_engine(load_config_str(PHOLD),
                                     device="cpu", kernels=kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    p = engine.params
    ob, pops = engine._outbox()
    win_end = engine.next_time(state) + engine.config.lookahead
    kernels.pop(state, ob, pops, engine.world, win_end, p)
    assert int(pops.sum()) > 0
    kernels.judge_outbox(state, ob, engine.world, win_end, p)
    perm, starts, counts = kernels.route(ob)
    kernels.merge_heaps(state, ob, perm, starts, counts, p)
    engine.run(state)
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)
    assert not any(kernels._events.values())     # nothing was timed
    assert kernels._lib is None          # nothing was built or loaded


@pytest.mark.parametrize("key,value", [
    ("judge_placement", "flush"), ("merge_strategy", "global"),
    ("pop_strategy", "onehot"), ("table_strategy", "gather")])
def test_reference_layout_variant_keys_are_validated_and_ignored(
        key, value):
    from shadow_tpu_torch.config.loader import load_config_str as load

    plain = runner.run(load_config_str(PHOLD), device="cpu")
    pinned = runner.run(load(PHOLD, [f"experimental.{key}={value}"]),
                        device="cpu")
    np.testing.assert_array_equal(pinned.host_trace_checksum,
                                  plain.host_trace_checksum)
    with pytest.raises(ValueError, match=f"experimental.{key}="):
        load(PHOLD, [f"experimental.{key}=bogus"])


def test_cpu_run_is_deterministic_and_overflow_is_loud():
    a = runner.run(load_config_str(PHOLD), device="cpu")
    b = runner.run(load_config_str(PHOLD), device="cpu")
    assert a.ok and a.events_executed > 0
    np.testing.assert_array_equal(a.host_trace_checksum,
                                  b.host_trace_checksum)
    # two heap slots cannot hold a boot plus its in-flight messages
    tight = runner.run(load_config_str(
        PHOLD, ["experimental.event_capacity=2",
                "experimental.exchange_in_capacity=1"]), device="cpu")
    assert not tight.ok and tight.overflow > 0


def test_build_matches_reference_columnar_layout():
    sim = build(load_config_str(PHOLD))
    np.testing.assert_array_equal(sim.host_vertex, [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(sim.start_times,
                                  [10**7] * 3 + [12 * 10**6] * 3)
    assert sim.lookahead == 10**7
    assert (sim.app.msgload, sim.app.n_hosts_total) == (2, 6)


def test_chip_smoke_reports_the_one_card_it_used():
    """chip_smoke.py drives device 0 alone: its last line counts one
    card, whatever torch.cuda.device_count() says on a larger
    machine."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    line = json.loads(smoke.result_line("NVIDIA H100 80GB HBM3"))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("overrides", [
    ["experimental.capacity_plan=auto",
     "experimental.capacity_warmup=100ms"],
    ["experimental.capacity_plan=auto",
     "experimental.capacity_headroom=2.0"],
    ["experimental.dispatch_segment=70ms"],
    ["general.heartbeat_interval=100ms",
     "experimental.heartbeat_stale_after=3"],
    ["experimental.device_batch_rounds=8"],
    [CAMPAIGN, "experimental.capacity_plan=auto"],
    [CAMPAIGN, "experimental.dispatch_segment=70ms"],
    [CAMPAIGN, "general.heartbeat_interval=100ms"],
])
def test_planner_and_segment_keys_are_admitted(overrides, tmp_path,
                                               monkeypatch):
    """The keys of the segmented advance and the capacity planner, which
    the slice check refused by name before, build and run on the CPU,
    standalone and in a campaign, with the static run's totals."""
    from shadow_tpu_torch.config.loader import load_config_str as load
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))

    campaign = CAMPAIGN in overrides
    cfg = load(PHOLD, overrides)
    build(cfg)
    base = load(PHOLD, [CAMPAIGN] if campaign else [])
    if campaign:
        got = EnsembleRunner(cfg, device="cpu").run()
        want = EnsembleRunner(base, device="cpu").run()
    else:
        got = runner.run(cfg, device="cpu")
        want = runner.run(base, device="cpu")
    assert got.ok and got.events_executed == want.events_executed > 0
    assert np.array_equal(got.host_trace_checksum, want.host_trace_checksum)
    assert got.rounds == want.rounds


@pytest.mark.parametrize("override,message", [
    ("experimental.capacity_warmup=50ms", "capacity_warmup"),
    ("experimental.capacity_plan=atuo", "capacity_plan"),
    ("experimental.capacity_headroom=2.0", "capacity_headroom"),
    ("experimental.heartbeat_stale_after=3", "heartbeat_stale_after"),
    ("experimental={scheduler_policy: serial, capacity_plan: auto}",
     "capacity_plan"),
])
def test_planner_keys_are_validated_as_the_reference_validates_them(
        override, message):
    from shadow_tpu_torch.config.loader import load_config_str as load

    with pytest.raises(ValueError, match=message):
        load(PHOLD, [override])
