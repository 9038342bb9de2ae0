"""The port's ensemble campaigns (shadow_tpu_torch/ensemble/, the replica
axis of the device engine) against the reference's shadow_tpu/ensemble/:
the `ensemble:` schema's checks and messages; `build_worlds` array for
array, with its lookahead, descriptors and campaign fingerprint, on a
dense seed sweep, a latency scale with a loss delta, a fault schedule
padded with FAR_EPOCH and factored tables under an integer scale; its
two refusals message for message; `aggregate`; and whole campaigns on
the port's plain path (the CPU): examples/ensemble_seed_sweep.yaml as
shipped, a factored campaign over latency scales and fault schedules
(examples/tgen_faults_hier.yaml's link faults, 8 s of its 10) and a cut
Tor campaign over latency scales, each replica equal to the port's
standalone run with that replica's world and the lookahead pinned, and
to the reference EnsembleRunner's final state; the record equal to the
reference's but for `wall_s` and the admission verdict (each package's
own byte model). Then replica batches against the whole campaign, the
slot schedule (the card's loop, run eagerly) against the Python loop,
and every batched plain kernel at R = 3 against three R = 1 calls.
Tolerance everywhere is exact equality: the simulation is
integer-exact.

The JAX reference runs in a child process (this file's __main__
branch), one child for the whole file, started before the first test:
the reference package's device engine does not import under the
installed jax without a patch to jax's batching registry, and that
patch must never be applied inside the pytest process.
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

# tests/test_ensemble.py's SMALL: one tgen server, four clients
SMALL = """
general: {{stop_time: 1500ms, seed: 1}}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "5 ms" packet_loss 0.02 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ] ]
experimental:
  scheduler_policy: tpu
{ensemble}
hosts:
  server:
    network_node_id: 0
    processes: [{{path: "model:tgen_server", start_time: 50ms}}]
  client:
    quantity: 4
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=server size=60KiB count=2 pause=100ms retry=300ms
      start_time: 100ms
"""


def _example(name: str) -> str:
    with open(os.path.join(ROOT, "examples", name)) as f:
        return f.read()


# examples/tgen_faults_hier.yaml on the tpu policy with its link faults
# alone (campaigns refuse host faults), cut to 8 s (past its last link
# event at 7 s)
STAR = _example("tgen_faults_hier.yaml").replace(
    "scheduler_policy: serial", "scheduler_policy: tpu")
STAR_OVERRIDES = [
    "network.faults=["
    "{kind: degrade, time: 2s, duration: 1s, source: 0, target: 1,"
    " latency_multiplier: 3, extra_packet_loss: 0.05},"
    "{kind: degrade, time: 4s, duration: 1s, source: 0, target: 2,"
    " latency_multiplier: 2},"
    "{kind: link_down, time: 6s, source: 0, target: 1},"
    "{kind: link_up, time: 7s, source: 0, target: 1}]",
    "general.stop_time=8s"]

# tests/test_tor.py's config (8 relays, 16 clients, loss 0.02), 4 s
TOR = """
general: {stop_time: 4s, seed: 3}
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
hosts:
  relay:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:tor_relay, start_time: 100ms}]
  client:
    quantity: 16
    network_node_id: 1
    processes:
    - {path: model:tor_client, start_time: 1s,
       args: cells=48 count=2 pause=500ms}
"""

# the campaigns run whole: (yaml, overrides)
CAMPAIGNS = {
    "sweep": (_example("ensemble_seed_sweep.yaml"), []),
    "star": (STAR, STAR_OVERRIDES + [
        "ensemble={replicas: 2, vary: {latency_scale: [1.0, 2.0], "
        "fault_schedule: [base, none]}}"]),
    "tor": (TOR, ["ensemble={replicas: 3, vary: {latency_scale: "
                  "[1.0, 1.5, 2.0]}}"]),
}

# build_worlds cases: (yaml, overrides)
WORLDS = {
    "seed_sweep": (SMALL.format(ensemble=""), [
        "ensemble={replicas: 2, vary: {seed: [1, 9]}}"]),
    "scale_loss": (SMALL.format(ensemble=""), [
        "ensemble={replicas: 2, vary: {latency_scale: [1.0, 2.0], "
        "packet_loss_delta: [0.0, 0.5]}}"]),
    "fault_padded": (SMALL.format(ensemble=""), [
        "ensemble={replicas: 2, vary: {fault_schedule: [none, slow]}, "
        "fault_schedules: {slow: [{kind: degrade, time: 500ms, "
        "duration: 200ms, source: 0, target: 1, latency_multiplier: "
        "3}]}}"]),
    "factored_int_scale": (STAR, STAR_OVERRIDES + [
        "ensemble={replicas: 3, vary: {latency_scale: [1.0, 3.0, 2.0], "
        "fault_schedule: [none, base, base], seed: [4, 5, 6]}}"]),
}

# the two refusals of build_worlds: (yaml, overrides)
REFUSALS = {
    "lossy_access": ("""
general: {stop_time: 1s}
network:
  topology: {representation: hierarchical}
  graph: {type: star_clusters, clusters: 2, spokes_per_cluster: 3,
          hub_latency: 10 ms, access_latency: 1 ms,
          access_packet_loss: 0.01}
experimental: {scheduler_policy: tpu}
hosts:
  peer:
    quantity: 6
    network_node_id: 2
    network_node_stride: 1
    processes: [{path: model:phold, args: msgload=1, start_time: 1ms}]
""", ["ensemble={replicas: 2, vary: {packet_loss_delta: [0.0, 0.1]}}"]),
    "i32_overflow": (SMALL.format(ensemble=""), [
        "ensemble={replicas: 2, vary: {latency_scale: [1.0, 300.0]}}"]),
}


def _load(name, table):
    from shadow_tpu_torch.config import load_config_str

    yaml, overrides = table[name]
    return load_config_str(yaml, overrides)


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


def _json(x):
    """`x` as JSON gives it back: the records compare as files."""
    return json.loads(json.dumps(x, sort_keys=True))


# ----------------------------------------------------------------------
# the reference, in one child process started before the first test
# ----------------------------------------------------------------------
_REF = {}


def _start_reference():
    d = tempfile.mkdtemp(prefix="torch_ensemble_ref_")
    job = {"worlds": WORLDS, "refusals": REFUSALS, "campaigns": CAMPAIGNS}
    job_path = os.path.join(d, "job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SHADOW_TPU_AOT_DIR"] = os.path.join(d, "aot")
    env["SHADOW_TPU_OCC_DIR"] = os.path.join(d, "occ")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    out = open(os.path.join(d, "child.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job_path, d], cwd=d,
        env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, d


@pytest.fixture(scope="module")
def reference():
    if "data" not in _REF:
        proc, d = _REF.pop("child") if "child" in _REF else \
            _start_reference()
        proc.wait(timeout=900)
        with open(os.path.join(d, "child.log")) as f:
            log = f.read()
        assert proc.returncode == 0, log[-4000:]
        data = {}
        with np.load(os.path.join(d, "out.npz")) as z:
            data.update({k: z[k] for k in z.files})
        with open(os.path.join(d, "out.json")) as f:
            data.update(json.load(f))
        _REF["data"] = data
    return _REF["data"]


def setup_module(module):
    _REF["child"] = _start_reference()


@pytest.fixture(autouse=True)
def _records(tmp_path, monkeypatch):
    """Campaign records land in a temporary directory."""
    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))


# ----------------------------------------------------------------------
# schema (tests/test_ensemble.py's checks)
# ----------------------------------------------------------------------
def test_schema_requires_tpu_policy():
    from shadow_tpu_torch.config import load_config_str

    bad = SMALL.format(ensemble="ensemble: {replicas: 2, vary: "
                       "{seed: [1, 9]}}").replace(
        "scheduler_policy: tpu", "scheduler_policy: serial")
    with pytest.raises(ValueError, match="scheduler_policy: tpu"):
        load_config_str(bad)


@pytest.mark.parametrize("block,match", [
    ({"replicas": 3, "vary": {"seed": [1, 2]}}, "one.*value per replica"),
    ({"replicas": 2, "vary": {"stop_time": [1, 2]}}, "unknown key"),
    ({"replicas": 2}, "empty vary"),
    ({"replicas": 2, "vary": {"latency_scale": [1.0, 0.0]}},
     "latency_scale"),
    ({"replicas": 2, "vary": {"packet_loss_delta": [0.0, 1.5]}},
     "packet_loss_delta"),
    ({"replicas": 2, "vary": {"fault_schedule": ["base", "storm"]}},
     "unknown schedule"),
    ({"replicas": 1, "vary": {"seed": [1]},
      "fault_schedules": {"base": []}}, "reserved"),
    ({"replicas": 2, "vary": {"fault_schedule": ["base", "crashy"]},
      "fault_schedules": {"crashy": [{"kind": "host_crash", "time": "1s",
                                      "host": "client0"}]}},
     "host faults"),
    ({"replicas": 2, "vary": {"seed": [1, 2]}, "aggregate": ["median"]},
     "aggregate"),
    ({"replicas": 2, "vary": {"seed": [1, 2]}, "replica_batch": 3},
     "replica_batch"),
    ({"replicas": 0}, "replicas must be >= 1"),
])
def test_schema_refusals(block, match):
    from shadow_tpu_torch.config.schema import EnsembleOptions

    with pytest.raises(ValueError, match=match):
        EnsembleOptions.from_dict(block)


def test_schema_aggregate_choices():
    from shadow_tpu_torch.config.schema import EnsembleOptions

    opts = EnsembleOptions.from_dict(
        {"replicas": 2, "vary": {"seed": [1, 2]},
         "aggregate": ["mean", "max"]})
    assert opts.aggregate == ("mean", "max")


# ----------------------------------------------------------------------
# worlds (spec.py) against the reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(WORLDS))
def test_build_worlds_equals_the_reference(reference, name):
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.ensemble.spec import build_worlds

    cfg = _load(name, WORLDS)
    w = build_worlds(build(cfg), cfg.ensemble)
    ref = reference[f"worlds/{name}"]
    for field in ("latency", "reliability"):
        leaves = _leaves(getattr(w, field))
        assert len(leaves) == ref[f"{field}_n"]
        for i, a in enumerate(leaves):
            want = reference[f"worlds/{name}/{field}/{i}"]
            assert a.dtype == want.dtype and a.shape == want.shape, \
                (field, i)
            np.testing.assert_array_equal(a, want, err_msg=f"{field} {i}")
    for field in ("epoch_times", "seed_k1", "seed_k2", "seeds"):
        want = reference[f"worlds/{name}/{field}"]
        a = getattr(w, field)
        assert a.dtype == want.dtype, field
        np.testing.assert_array_equal(a, want, err_msg=field)
    assert w.lookahead == ref["lookahead"]
    assert _json(w.descriptors) == ref["descriptors"]
    assert w.campaign_fp == ref["campaign_fp"]


def test_worlds_pad_short_fault_schedules_with_far_epochs():
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.ensemble.spec import FAR_EPOCH, build_worlds

    cfg = _load("fault_padded", WORLDS)
    w = build_worlds(build(cfg), cfg.ensemble)
    assert w.epoch_times.shape == (2, 3)
    assert list(w.epoch_times[1]) == [0, 500_000_000, 700_000_000]
    assert (w.epoch_times[0][1:] == FAR_EPOCH).all()
    assert (w.latency[0][0] == w.latency[0][1]).all()


@pytest.mark.parametrize("name", list(REFUSALS))
def test_build_worlds_refusals_equal_the_reference(reference, name):
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.ensemble.spec import build_worlds

    cfg = _load(name, REFUSALS)
    with pytest.raises(ValueError) as e:
        build_worlds(build(cfg), cfg.ensemble)
    assert str(e.value) == reference[f"refusals/{name}"]


def test_aggregate_ops():
    from shadow_tpu_torch.ensemble.campaign import aggregate

    agg = aggregate([10, 20, 30, 40], ("mean", "p5", "p95", "min", "max"))
    assert agg["mean"] == 25.0
    assert agg["min"] == 10.0 and agg["max"] == 40.0
    assert agg["p5"] == pytest.approx(11.5) and \
        agg["p95"] == pytest.approx(38.5)
    assert aggregate([7], ("mean",)) == {"mean": 7.0}


# ----------------------------------------------------------------------
# whole campaigns
# ----------------------------------------------------------------------
_RUNS = {}


def _campaign(name, **overrides):
    """(runner, stats) of a campaign on the CPU plain path, computed
    once per set of overrides."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    key = (name, tuple(sorted(overrides.items())))
    if key not in _RUNS:
        yaml, ovr = CAMPAIGNS[name]
        extra = [f"ensemble.{k}={v}" for k, v in overrides.items()]
        er = EnsembleRunner(load_config_str(yaml, ovr + extra),
                            device="cpu")
        _RUNS[key] = (er, er.run())
    return _RUNS[key]


def _standalone(er, r):
    """The port's standalone run with replica r's world, seed and the
    campaign's lookahead: its final leaves and rounds."""
    from shadow_tpu_torch.device.engine import state_to_numpy

    engine = er.replica_engine(r)
    state, rounds = engine.run(engine.init_state(er.sim.start_times,
                                                 er.sim.stop_times))
    return state_to_numpy(state), rounds


@pytest.mark.parametrize("name", list(CAMPAIGNS))
def test_campaign_replicas_equal_their_standalone_runs(name):
    er, stats = _campaign(name)
    final, R = er.final_state, er.worlds.R
    rounds = er.loop_stats[0]["rounds"]
    assert stats.ok and stats.loop == "python" and len(rounds) == R
    for r in range(R):
        leaves, want_rounds = _standalone(er, r)
        assert rounds[r] == want_rounds
        for k, v in final.items():
            np.testing.assert_array_equal(
                v[r], leaves[k], err_msg=f"{name} replica {r}: {k}")
    # the replicas differ: the campaign is not one run R times
    assert len({final["chk"][r].tobytes() for r in range(R)}) == R
    assert stats.packets_sent == int(final["n_sent"].sum())
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  final["chk"][0])


def test_seed_sweep_replicas_equal_standalone_configs():
    """Replica i of examples/ensemble_seed_sweep.yaml is the shipped
    config run alone with `general.seed` = vary.seed[i] and the runahead
    pinned to the campaign's lookahead (what scripts/determinism_gate.py
    --ensemble runs on the reference)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    er, _ = _campaign("sweep")
    yaml = _example("ensemble_seed_sweep.yaml")
    for r, seed in enumerate(er.cfg.ensemble.vary["seed"]):
        alone = runner.run(load_config_str(yaml, [
            "ensemble=null", f"general.seed={seed}",
            f"experimental.runahead={er.lookahead}ns"]), device="cpu")
        np.testing.assert_array_equal(alone.host_trace_checksum,
                                      er.final_state["chk"][r])
        np.testing.assert_array_equal(alone.host_events_executed,
                                      er.final_state["n_exec"][r])
        assert alone.rounds == er.loop_stats[0]["rounds"][r]


@pytest.mark.parametrize("name", list(CAMPAIGNS))
def test_campaign_equals_the_reference_ensemble_runner(reference, name):
    er, stats = _campaign(name)
    H = len(er.sim.host_vertex)
    for k, v in er.final_state.items():
        want = reference[f"campaigns/{name}/final/{k}"]
        if want.ndim >= 2 and want.shape[1] != v.shape[1]:
            want = want[:, :H]
        np.testing.assert_array_equal(v, want, err_msg=f"{name}: {k}")
    mine, ref = _json(er.record), reference[f"campaigns/{name}/record"]
    for rec in (mine, ref):
        rec.pop("wall_s")
        rec.pop("admission")
    assert mine == ref


def test_campaign_record_lands_where_it_is_named(tmp_path):
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    er = EnsembleRunner(_load("seed_sweep", WORLDS), device="cpu")
    path = er.record_path()
    assert path == os.path.join(
        str(tmp_path), f"ENSEMBLE_TgenDevice_5_{er.worlds.campaign_fp}.json")
    stats = er.run()
    with open(path) as f:
        assert _json(er.record) == json.load(f)
    assert stats.ensemble is er.record
    assert er.record["ok"] and er.record["workload"]["replicas"] == 2
    named = str(tmp_path / "named" / "campaign.json")
    cfg = _load("seed_sweep", WORLDS)
    cfg.ensemble.record_path = named
    er2 = EnsembleRunner(cfg, device="cpu")
    assert er2.record_path() == named
    er2.run()
    with open(named) as f:
        assert json.load(f)["campaign"] == er.worlds.campaign_fp


@pytest.mark.parametrize("name,batch", [("sweep", 3), ("star", 1)])
def test_replica_batches_equal_the_whole_campaign(name, batch):
    whole, _ = _campaign(name)
    batched, stats = _campaign(name, replica_batch=batch)
    assert len(batched.loop_stats) == -(-whole.worlds.R // batch)
    for k, v in whole.final_state.items():
        np.testing.assert_array_equal(batched.final_state[k], v, err_msg=k)
    a, b = _json(whole.record), _json(batched.record)
    assert b.pop("replica_batch") == batch
    for rec in (a, b):
        rec.pop("wall_s")
        rec.pop("admission")
    assert a == b


def test_slot_schedule_runs_the_campaign_as_the_python_loop():
    """The card's loop (K9 per replica, run eagerly on the CPU) gives
    every replica's leaves and rounds, with one host read a batch."""
    from shadow_tpu_torch.device.engine import state_to_numpy

    er, _ = _campaign("tor")
    engine = er.engine()
    state = engine.init_ensemble_state(er.sim.start_times,
                                       er.sim.stop_times)
    state, rounds = engine.run_slots(state, slots=7)
    assert list(rounds) == er.loop_stats[0]["rounds"]
    assert engine.loop_stats["loop"] == "slots"
    assert engine.loop_stats["phases"] == er.loop_stats[0]["phases"]
    assert engine.loop_stats["host_syncs"] == \
        -(-max(engine.loop_stats["phases"]) // 7)
    leaves = state_to_numpy(state)
    for k, v in er.final_state.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)


def test_tor_seed_sweep_and_campaign_host_faults_are_refused():
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    with pytest.raises(ValueError, match="vary.seed is not supported "
                       "for TorDevice"):
        build(load_config_str(TOR, ["ensemble={replicas: 2, vary: "
                                    "{seed: [1, 2]}}"]))
    # one distinct seed is not a sweep
    build(load_config_str(TOR, ["ensemble={replicas: 2, vary: "
                                "{seed: [3, 3]}}"]))
    with pytest.raises(ValueError, match="host_crash/host_restart "
                       "faults are manager-side"):
        build(load_config_str(STAR, [
            "ensemble={replicas: 2, vary: {latency_scale: [1.0, 2.0]}}"]))


def test_runner_run_refuses_a_campaign_config():
    from shadow_tpu_torch.device import runner

    with pytest.raises(ValueError, match="EnsembleRunner"):
        runner.run(_load("seed_sweep", WORLDS), device="cpu")


def test_admission_offers_a_replica_batch_where_the_campaign_is_over():
    """`admission: auto` halves a batchable campaign until a batch fits
    the budget and the run goes batch by batch, unchanged; `strict`
    refuses it."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    from shadow_tpu_torch.device import capacity
    from shadow_tpu_torch.device.engine import (
        campaign_world_arrays,
        phase_params,
    )

    yaml, ovr = CAMPAIGNS["sweep"]
    er = EnsembleRunner(load_config_str(yaml, ovr), device="cpu")
    config = runner.engine_config(er.cfg, er.sim, er.lookahead)
    est = runner.admit(er.cfg, er.sim, config, "cpu",
                       er.worlds)["estimate"]
    assert est["replicas"] == 4
    world = campaign_world_arrays(config.n_hosts, er.app,
                                  er.sim.host_vertex, er.worlds)
    params = phase_params(config, er.app)
    by_r = [capacity.footprint(config.n_hosts, params, world, k)
            for k in (1, 2, 4)]
    assert by_r[2]["per_device"] == est["per_device"]
    # R copies of the state and scratch, the stacked tables scaled
    assert by_r[0]["per_device"] < by_r[1]["per_device"] < \
        est["per_device"]
    budget = by_r[1]["per_device"]
    cfg = load_config_str(yaml, ovr + [
        f"experimental.device_memory_budget={budget}"])
    er2 = EnsembleRunner(cfg, device="cpu")
    stats = er2.run()
    adm = er2.admission
    assert adm["action"] == "degrade" and adm["fits"]
    assert adm["overrides"] == {"replica_batch": 2}
    assert adm["estimate"]["replicas"] == 2
    assert adm["estimate"]["per_device"] <= budget
    assert er2.record["replica_batch"] == 2 and stats.ok
    whole, _ = _campaign("sweep")
    for k, v in whole.final_state.items():
        np.testing.assert_array_equal(er2.final_state[k], v, err_msg=k)
    with pytest.raises(ValueError, match="ensemble.replicas"):
        EnsembleRunner(load_config_str(yaml, ovr + [
            f"experimental.device_memory_budget={budget}",
            "experimental.admission=strict"]), device="cpu").run()


# ----------------------------------------------------------------------
# the batched plain kernels against R = 1 calls
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mid_campaign():
    """A Tor campaign of 3 replicas (distinct tables) paused mid-run:
    (engine, state)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    er = EnsembleRunner(load_config_str(*CAMPAIGNS["tor"]), device="cpu")
    engine = er.engine()
    state = engine.init_ensemble_state(er.sim.start_times,
                                       er.sim.stop_times)
    # mid-download: the clients start at 1 s
    state, _ = engine.run(state, 1_200_000_000, er.cfg.general.stop_time)
    return engine, state


def _clone(d):
    return {k: v.clone() for k, v in d.items()}


def _same(a, b, what):
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def test_batched_plain_kernels_equal_r1_calls(mid_campaign):
    """One phase, the path counters, the tallies with the audit's ledger,
    the round-end audit and the control step on a [3, H] state, each
    replica equal to the R = 1 plain functions on its slice, its world
    and its seed; replica 1's `run` word is 0 and changes no byte."""
    from shadow_tpu_torch.device import kernels as K

    engine, state0 = mid_campaign
    world = engine.world
    p = K.dataclasses.replace(engine.params, CP=True, AUD=True)
    R, H, OB = engine.replicas, engine.config.n_hosts, engine.params.OB
    V = engine.n_vertices
    assert R == 3 and K.n_replicas(state0) == 3
    gen = torch.Generator().manual_seed(3)
    state0 = {**state0,
              "path_cnt": torch.zeros((R, 1, V * V), dtype=torch.int64),
              "aud": torch.zeros((R, H), dtype=torch.int32),
              "aud_t": torch.zeros((R, H), dtype=torch.int64),
              "aud_tx": torch.randint(0, 9, (R, H), generator=gen)}
    ctl = K.control_block("cpu", R, run=1, round_end=1, stop=K.INF,
                          final_stop=K.INF, lookahead=10**7,
                          max_rounds=1 << 40)
    ctl[:, K.CTL["win_end"]] = K.head_min_plain(state0) + 10**7
    ctl[1, K.CTL["run"]] = 0            # replica 1 is done
    ctl[1, K.CTL["round_end"]] = 0
    ctl[1, K.CTL["done"]] = 1

    def phase(state, ob, pops, w, c, q):
        K.pop_plain(state, ob, pops, w, c, q)
        K.judge_outbox_plain(state, ob, w, c, q)
        K.count_paths_plain(state, ob, w, c)
        K.phase_tally_plain(state, ob, pops, q, c)
        route = K.route_plain(ob)
        K.merge_heaps_plain(state, ob, *route, q, c)
        K.audit_round_plain(state, c)
        K.loop_control_plain(state, c)
        return route

    def empty(lead):
        return ({f: torch.zeros((*lead, H, OB), dtype=torch.int64)
                 for f in K.OB_FIELDS},
                torch.zeros((*lead, H), dtype=torch.int32))

    sb, cb = _clone(state0), ctl.clone()
    obb, popsb = empty((R,))
    routeb = phase(sb, obb, popsb, world, cb, p)
    assert int(popsb[0].sum()) > 0 and int(popsb[2].sum()) > 0
    assert int(sb["path_cnt"][0].sum()) > 0
    for r in range(R):
        w = K.replica_world(world, r)
        q = K.replica_params(w, p)
        s1, c1 = {k: v[r].clone() for k, v in state0.items()}, ctl[r].clone()
        ob1, pops1 = empty(())
        route1 = phase(s1, ob1, pops1, w, c1, q)
        _same(s1, K.at_replica(sb, r), f"replica {r}")
        assert torch.equal(c1, cb[r])
        if r != 1:
            _same(ob1, K.at_replica(obb, r), f"outbox {r}")
            assert torch.equal(pops1, popsb[r])
            for a, b in zip(route1, routeb):
                assert torch.equal(a, b[r])
    _same(K.at_replica(sb, 1), K.at_replica(state0, 1), "done replica")
    # the replicas' tables differ (latency scales); Tor sweeps no seed
    assert not torch.equal(world["lat"][0], world["lat"][2])
    assert world["seed_key"].shape == (R, 2)


def test_kernel_wrappers_take_the_batched_plain_path_on_the_cpu(
        mid_campaign):
    """The Kernels wrappers on a campaign's CPU tensors are the batched
    plain versions and count no launch."""
    from shadow_tpu_torch.device.kernels import KERNEL_NAMES, Kernels

    engine, state0 = mid_campaign
    kernels = Kernels()
    ctl = engine._loop_block(4 * 10**9, 4 * 10**9)
    a, b = _clone(state0), _clone(state0)
    kernels.loop_control(a, ctl, start=True)
    engine.phase(a, ctl)
    from shadow_tpu_torch.device import kernels as K

    ctl2 = engine._loop_block(4 * 10**9, 4 * 10**9)
    K.loop_control_plain(b, ctl2, start=True)
    ob, pops, route = engine._buffers()
    obp = {k: torch.zeros_like(v) for k, v in ob.items()}
    K.pop_plain(b, obp, torch.zeros_like(pops), engine.world, ctl2,
                engine.params)
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)
    assert torch.equal(ctl, ctl2)
    assert any(not torch.equal(a[k], state0[k]) for k in a)


# ----------------------------------------------------------------------
# the reference, in the child process
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_dir: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    import jax

    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller, build
    from shadow_tpu.ensemble.spec import build_worlds

    with open(job_path) as f:
        job = json.load(f)
    arrays, meta = {}, {}

    def plain(x):
        return json.loads(json.dumps(
            x, default=lambda o: o.item() if hasattr(o, "item") else str(o)))

    for name, (yaml, ovr) in job["worlds"].items():
        cfg = load_config_str(yaml, ovr)
        w = build_worlds(build(cfg), cfg.ensemble)
        m = {"lookahead": int(w.lookahead),
             "descriptors": plain(w.descriptors),
             "campaign_fp": w.campaign_fp}
        for field in ("latency", "reliability"):
            leaves = _leaves(getattr(w, field))
            m[f"{field}_n"] = len(leaves)
            for i, a in enumerate(leaves):
                arrays[f"worlds/{name}/{field}/{i}"] = np.asarray(a)
        for field in ("epoch_times", "seed_k1", "seed_k2", "seeds"):
            arrays[f"worlds/{name}/{field}"] = np.asarray(getattr(w, field))
        meta[f"worlds/{name}"] = m
    for name, (yaml, ovr) in job["refusals"].items():
        cfg = load_config_str(yaml, ovr)
        try:
            build_worlds(build(cfg), cfg.ensemble)
            meta[f"refusals/{name}"] = "no refusal"
        except ValueError as e:
            meta[f"refusals/{name}"] = str(e)
    for name, (yaml, ovr) in job["campaigns"].items():
        c = Controller(load_config_str(yaml, ovr))
        stats = c.run()
        assert stats.ok, name
        for k, v in c.runner.final_state.items():
            arrays[f"campaigns/{name}/final/{k}"] = np.asarray(
                jax.device_get(v))
        meta[f"campaigns/{name}/record"] = plain(c.runner.record)
    np.savez(os.path.join(out_dir, "out.npz"), **arrays)
    with open(os.path.join(out_dir, "out.json"), "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
