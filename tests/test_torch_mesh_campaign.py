"""Ensemble campaigns on the host mesh (`ensemble:` with
`experimental.mesh_shards`): S = 2 and 4 gloo ranks on the CPU, each
running the campaign's EnsembleRunner on its hosts of every replica
(the port's plain path), held replica by replica against the reference
EnsembleRunner at the same mesh_shards on the conftest's 8 virtual CPU
devices (every gathered leaf, the rounds, the record's checksums and
aggregates) and against the port's one-device campaign. Every exchange
schedule under both merges; a latency and fault sweep whose replicas
end at different rounds; per-replica loss under undersized capacities,
two_phase's phase 2 too; the planner; a checkpoint saved and resumed on
the mesh; replica batches; the batched plain exchange kernels at R = 3
against R = 1 calls. Tolerance everywhere is exact equality: the
simulation is integer-exact.

The reference runs in one child process (this file's __main__ branch),
which applies the jax batching patch the reference needs under the
installed jax; the patch never runs in the pytest process. The child
and the two spawned meshes (one group of ranks a mesh size, for all its
runs) start before the first test and run side by side.
"""

import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(ROOT, "examples", "ensemble_seed_sweep.yaml")

# tests/test_torch_exchange.py's PHOLD (16 lossy hosts, msgload 2) swept
# over latency scales and a degrade schedule: the replicas' windows
# differ, so they end at different rounds
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
ensemble:
  replicas: 3
  vary:
    latency_scale: [1.0, 1.7, 2.5]
    fault_schedule: [none, slow, none]
  fault_schedules:
    slow:
    - {kind: degrade, time: 500ms, duration: 600ms, source: 0,
       target: 1, latency_multiplier: 3, extra_packet_loss: 0.05}
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

# tests/test_torch_exchange.py's XCHG (two clients on the first shard, the
# server on the last) as a two-seed campaign: under a capacity of 1 the
# second REQ of a window is lost on its sender in each replica
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
ensemble:
  replicas: 2
  vary: {seed: [3, 8]}
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

SCHEDULES = ("all_to_all", "two_phase", "all_gather")
MERGES = ("window", "global")
PLAN = ["experimental.capacity_plan=auto", "experimental.exchange=auto",
        "experimental.capacity_warmup=1s"]


def ovr(S, exchange="all_to_all", merge="window", extra=()):
    return [f"experimental.mesh_shards={S}",
            f"experimental.exchange={exchange}",
            f"experimental.merge_strategy={merge}", *extra]


def _sweep_text():
    with open(SWEEP) as f:
        return f.read()


CONFIGS = {"sweep": _sweep_text(), "phold": PHOLD, "xchg": XCHG}

# the runs the reference reproduces: key -> (config, overrides); each
# schedule under each merge once, and each schedule at both sizes (a
# reference program compiles per run: about 10 s each)
JAX_RUNS = {
    **{f"sweep/{x}/{m}/{S}": ("sweep", ovr(S, x, m)) for S, x, m in (
        (4, "all_to_all", "window"), (4, "two_phase", "global"),
        (4, "all_gather", "window"), (2, "all_to_all", "global"),
        (2, "two_phase", "window"), (2, "all_gather", "global"))},
    "phold/two_phase/global/4": ("phold", ovr(4, "two_phase", "global")),
    # undersized capacities: the direct pack, and two_phase's phase 2 at
    # the intermediate shard
    "over/all_to_all/4": ("xchg", ovr(4, extra=[
        "experimental.exchange_capacity=1"])),
    "over/phase2/4": ("xchg", ovr(4, "two_phase", "global", [
        "experimental.exchange_capacity2=1"])),
    "plan/2": ("sweep", ["experimental.mesh_shards=2", *PLAN]),
}
OVERFLOWS = [k for k in JAX_RUNS if k.startswith("over/")]
# the port's runs besides: every schedule and merge of the sweep at both
# sizes, the PHOLD sweep at S = 2, two_phase's phase-1 loss
PORT_RUNS = {
    **{f"sweep/{x}/{m}/{S}": ("sweep", ovr(S, x, m))
       for S in (2, 4) for x in SCHEDULES for m in MERGES},
    "phold/all_to_all/window/2": ("phold", ovr(2)),
    "over/phase1/4": ("xchg", ovr(4, "two_phase", extra=[
        "experimental.exchange_capacity=1"])),
}


def _cfg(name, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(CONFIGS[name], list(overrides))


# ----------------------------------------------------------------------
# the runs, started at import: the reference child and one spawned mesh
# a mesh size, side by side
# ----------------------------------------------------------------------
PAUSE = "1500ms"
_STARTED = {}


def _ck():
    """The mesh campaign's checkpoint, in this module's work directory
    (made at the first run)."""
    return os.path.join(_STARTED["work"], "sweep_s2.npz")


def _port_jobs(S):
    """(key, config, keep the leaves) of every port run at S, in order
    (the save before its resume)."""
    jobs = [(k, _cfg(n, o), True)
            for k, (n, o) in {**PORT_RUNS, **JAX_RUNS}.items()
            if k.endswith(f"/{S}")]
    if S == 2:
        jobs += [
            ("batch/2", _cfg("sweep", ovr(2, extra=[
                "ensemble.replica_batch=3"])), True),
            # a rank's budget that holds two replicas: admission offers
            # batches of 2
            ("budget/2", _cfg("sweep", ovr(2, extra=[
                "experimental.device_memory_budget="
                f"{_rank_footprints()[2]['per_device']}"])), True),
            # segments at heartbeat boundaries and every 400 ms
            ("segments/2", _cfg("sweep", ovr(2, extra=[
                "general.heartbeat_interval=1s",
                "experimental.dispatch_segment=400ms"])), True),
            ("save/2", _cfg("sweep", ovr(2, extra=[
                f"experimental.checkpoint_save={_ck()}",
                f"experimental.checkpoint_save_time={PAUSE}"])), True),
            ("resume/2", _cfg("sweep", ovr(2, extra=[
                f"experimental.checkpoint_load={_ck()}"])), True)]
    return jobs


def _rank_footprints() -> dict:
    """{k: capacity.footprint of rank 0 of 2 at k replicas} of the
    sweep, and "admitted": the admission estimate of the whole campaign
    on that rank (runner.admit with a mesh)."""
    from types import SimpleNamespace

    from shadow_tpu_torch.core.build import build, pad_hosts
    from shadow_tpu_torch.device import capacity, runner
    from shadow_tpu_torch.device.engine import (
        campaign_world_arrays,
        make_mesh_params,
        phase_params,
    )
    from shadow_tpu_torch.ensemble.spec import build_worlds

    cfg = _cfg("sweep", ovr(2))
    sim = build(cfg)
    worlds = build_worlds(sim, cfg.ensemble)
    config = runner.engine_config(cfg, sim)
    params = phase_params(config, sim.app)
    mp = make_mesh_params(config, params, 2, 0)
    hv, up, down = pad_hosts(mp.H_pad, sim.host_vertex, sim.bw_up_bits,
                             sim.bw_down_bits)
    world = campaign_world_arrays(mp.H_pad, sim.app, hv, worlds, up, down)
    out = {k: capacity.footprint(mp.H_loc, params, world, k, mp)
           for k in (1, 2, 4)}
    out["admitted"] = runner.admit(cfg, sim, config, "cpu", worlds,
                                   mesh=SimpleNamespace(size=2, rank=0))
    out["mesh"], out["OB"] = mp, params.OB
    return out


def _mesh(S):
    from shadow_tpu_torch.device import runner

    jobs = _port_jobs(S)
    res = runner.mesh_runs(["cpu"] * S, [j[1] for j in jobs],
                           [j[2] for j in jobs], timeout=600)
    return {j[0]: r for j, r in zip(jobs, res)}


class ReferenceChild:
    """The reference in a fresh interpreter on 8 virtual CPU devices,
    started at once; `result()` waits for what it saved."""

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
            with open(self.out_path + ".json") as f:
                self._out.update(json.load(f))
        return self._out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _start():
    if not _STARTED:
        work = _STARTED["work"] = tempfile.mkdtemp(
            prefix="torch_mesh_campaign_")
        # the runs' records (the spawned ranks inherit it), until the
        # module's end
        _STARTED["occ_dir"] = os.environ.get("SHADOW_TPU_OCC_DIR")
        os.environ["SHADOW_TPU_OCC_DIR"] = os.path.join(work, "occ")
        job = {"runs": {k: (CONFIGS[n], o) for k, (n, o) in
                        JAX_RUNS.items()}}
        _STARTED["child"] = ReferenceChild(job, work)
        pool = cf.ThreadPoolExecutor(2)
        _STARTED["mesh"] = {S: pool.submit(_mesh, S) for S in (2, 4)}
        _STARTED["pool"] = pool
    return _STARTED


def setup_module(module):
    _start()


def teardown_module(module):
    if _STARTED:
        _STARTED["child"].stop()
        _STARTED["pool"].shutdown(wait=True)
        shutil.rmtree(_STARTED["work"], ignore_errors=True)
        if _STARTED["occ_dir"] is None:
            os.environ.pop("SHADOW_TPU_OCC_DIR", None)
        else:
            os.environ["SHADOW_TPU_OCC_DIR"] = _STARTED["occ_dir"]


@pytest.fixture(scope="module")
def reference():
    return _start()["child"].result()


def mesh_results(S):
    """{key: (SimStats, rank 0's gathered [R, H_pad, ...] leaves)} of
    every port run at S."""
    return _start()["mesh"][S].result()


_ONE = {}


def one_device(name):
    """(EnsembleRunner, SimStats) of the config's one-device campaign
    on the CPU."""
    if name not in _ONE:
        from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

        er = EnsembleRunner(_cfg(name), device="cpu")
        er.keep_heaps = True
        _ONE[name] = (er, er.run())
    return _ONE[name]


# per-host leaves a mesh run shares with the one-device run: all but
# occ_in, which the window merge takes per arrival block
ONE_DEVICE_LEAVES = ("ht", "hk", "hm", "hv", "hw", "head", "event_seq",
                     "packet_seq", "app_seq", "app", "n_exec", "n_sent",
                     "n_drop", "n_deliv", "overflow", "x_overflow", "chk",
                     "occ_heap", "occ_ob")


def _record(rec: dict) -> dict:
    rec = json.loads(json.dumps(rec, sort_keys=True, default=str))
    for k in ("wall_s", "admission", "replica_batch"):
        rec.pop(k, None)
    return rec


# ----------------------------------------------------------------------
# every replica against the reference at the same S
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", [k for k in JAX_RUNS if k != "plan/2"])
def test_mesh_campaign_equals_the_reference_replica_by_replica(
        key, reference):
    """Every gathered [R, H_pad, ...] leaf the reference keeps (all but
    the heaps: counters, checksums, occ_in, x_overflow, the [R, S, S]
    occ_x) equals the reference EnsembleRunner's at the same mesh_shards,
    and the record (each replica's checksums, rounds among the
    aggregates) is the reference's."""
    S = int(key.split("/")[-1])
    stats, leaves = mesh_results(S)[key]
    # the reference keeps every leaf but the heaps
    names = [k for k in leaves if f"run/{key}/{k}" in reference]
    assert set(leaves) - set(names) == {"ht", "hk", "hm", "hv", "hw"}
    for k in names:
        np.testing.assert_array_equal(leaves[k], reference[f"run/{key}/{k}"],
                                      err_msg=f"{key}: leaf {k}")
    assert leaves["occ_x"].shape[1:] == (S, S)
    assert _record(stats.ensemble) == _record(
        reference[f"run/{key}/record"])
    assert stats.mesh["backend"] == "gloo" and stats.mesh["shards"] == S
    assert stats.ok == (not key.startswith("over/"))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["sweep", "phold"])
def test_mesh_campaign_equals_the_one_device_campaign(name, S):
    """Each replica's per-host leaves (but occ_in), totals and rounds
    under every schedule and merge run equal the port's one-device
    campaign; the replicas differ from each other."""
    er, one = one_device(name)
    H = len(er.sim.host_vertex)
    keys = [k for k in mesh_results(S) if k.startswith(f"{name}/")]
    assert keys
    for key in keys:
        stats, leaves = mesh_results(S)[key]
        for k in ONE_DEVICE_LEAVES:
            np.testing.assert_array_equal(
                leaves[k][:, :H], er.final_state[k],
                err_msg=f"{key}: leaf {k}")
        for f in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "rounds", "downloads_completed"):
            assert getattr(stats, f) == getattr(one, f), (key, f)
        assert _record(stats.ensemble) == _record(er.record), key
        np.testing.assert_array_equal(stats.host_trace_checksum,
                                      one.host_trace_checksum)
    R = er.worlds.R
    assert len({er.final_state["chk"][r].tobytes()
                for r in range(R)}) == R


def test_latency_sweep_replicas_end_at_different_rounds(reference):
    """The latency and fault sweep's replicas run different numbers of
    rounds; a replica done before the others changes no byte on any
    rank (its leaves equal its standalone run's), at S = 2 and 4."""
    er, _ = one_device("phold")
    rounds = er.record["aggregates"]["rounds"]
    assert rounds["min"] < rounds["max"]
    H = len(er.sim.host_vertex)
    for key in ("phold/all_to_all/window/2", "phold/two_phase/global/4"):
        _, leaves = mesh_results(int(key[-1]))[key]
        for r in range(er.worlds.R):
            engine = er.replica_engine(r)
            state, alone = engine.run(engine.init_state(
                er.sim.start_times, er.sim.stop_times))
            assert alone == er.loop_stats[0]["rounds"][r]
            np.testing.assert_array_equal(leaves["chk"][r, :H],
                                          state["chk"].numpy())
            np.testing.assert_array_equal(leaves["n_exec"][r, :H],
                                          state["n_exec"].numpy())
        assert len(set(er.loop_stats[0]["rounds"])) > 1


@pytest.mark.parametrize("key", OVERFLOWS + ["over/phase1/4"])
def test_undersized_capacity_loses_rows_per_replica(key, reference):
    """A capacity of 1 loses a REQ on its sender in each replica: the
    [R, H_pad] x_overflow equals the reference's replica by replica,
    phase 2's loss (summed over the ranks) included, and phase 1's (which
    the reference has in its standalone mesh run, tests/
    test_torch_exchange.py) equals the direct pack's; the campaign is
    not ok."""
    stats, leaves = mesh_results(4)[key]
    ref_key = "over/all_to_all/4" if key == "over/phase1/4" else key
    want = reference[f"run/{ref_key}/x_overflow"]
    np.testing.assert_array_equal(leaves["x_overflow"], want)
    assert want.sum() > 0 and (want.sum(1) > 0).all()
    assert not stats.ok and stats.x_overflow == int(want.sum())


def test_planned_mesh_campaign_plans_as_the_reference(reference):
    """capacity_plan: auto with exchange: auto at S = 2: the warm-up's
    worst-case measurements over the replicas and the ranks, the chosen
    schedule and the plan equal the reference's; the planned campaign
    equals the static one replica by replica."""
    stats, leaves = mesh_results(2)["plan/2"]
    occ = json.loads(json.dumps(stats.occupancy, default=str))
    ref = reference["run/plan/2/occupancy"]
    assert occ["measured"] == ref["measured"]
    assert occ["planned"] == ref["planned"]
    assert occ["exchange_auto"]["chosen"] == \
        ref["exchange_auto"]["chosen"]
    _, static = mesh_results(2)["sweep/all_to_all/window/2"]
    for k in ("chk", "n_exec", "n_sent", "app"):
        np.testing.assert_array_equal(leaves[k], static[k], err_msg=k)
    assert stats.ok


def test_mesh_campaign_checkpoint_resumes_and_refuses_another_mesh():
    """A mesh campaign saved half way (the campaign's stamp, gathered
    to rank 0) and resumed on the same mesh equals the uninterrupted
    campaign; a resume on S = 4 (refused until ROADMAP (a) item 13.1)
    adopts the saved 2 shards, and a pool of one rank is refused with
    the reference's message before any rank starts."""
    from shadow_tpu_torch.device import checkpoint, runner

    saved, _ = mesh_results(2)["save/2"]
    resumed, leaves = mesh_results(2)["resume/2"]
    _, whole = mesh_results(2)["sweep/all_to_all/window/2"]
    meta = checkpoint.peek_meta(_ck())
    assert meta["ensemble"]["replicas"] == 4
    assert meta["geometry"]["n_shards"] == 2
    assert saved.ok and resumed.ok
    for k in ("chk", "n_exec", "n_sent", "ht", "hk", "app"):
        np.testing.assert_array_equal(leaves[k], whole[k], err_msg=k)
    with pytest.raises(ValueError, match=r"saved on 2 shard\(s\) but only "
                       r"1 device\(s\) are available — resume on a pool "
                       r"of at least the saved shard count"):
        runner.mesh_runs(["cpu"], [_cfg("sweep", ovr(4, extra=[
            f"experimental.checkpoint_load={_ck()}"]))])
    assert runner.adopted_devices(_cfg("sweep", ovr(4, extra=[
        f"experimental.checkpoint_load={_ck()}"])), ["cpu"] * 4) == \
        ["cpu"] * 2


def test_replica_batches_on_the_mesh_equal_the_whole_campaign():
    stats, leaves = mesh_results(2)["batch/2"]
    whole_stats, whole = mesh_results(2)["sweep/all_to_all/window/2"]
    for k, v in whole.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    assert stats.ensemble["replica_batch"] == 3
    assert _record(stats.ensemble) == _record(whole_stats.ensemble)


def test_admission_prices_a_rank_of_every_replica_and_offers_batches():
    """A campaign rank's estimate counts R replicas' state, outbox and
    routes and R times the exchange's buffers (every replica's packs
    ride each); under a budget that holds two replicas `admission: auto`
    runs batches of 2 on the mesh, equal to the whole campaign."""
    from shadow_tpu_torch.device import capacity

    fp = _rank_footprints()
    est = fp["admitted"]["estimate"]
    assert est["replicas"] == 4 and est == fp[4]
    assert est["exchange_bytes"] == 4 * capacity.mesh_nbytes(
        fp["mesh"], fp["OB"]) > 0
    assert fp[1]["per_device"] < fp[2]["per_device"] < est["per_device"]
    stats, leaves = mesh_results(2)["budget/2"]
    _, whole = mesh_results(2)["sweep/all_to_all/window/2"]
    assert stats.admission["action"] == "degrade"
    assert stats.admission["overrides"] == {"replica_batch": 2}
    assert stats.ensemble["replica_batch"] == 2 and stats.ok
    for k, v in whole.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)


def test_segmented_mesh_campaign_equals_the_whole():
    """Heartbeats every 1 s and 400 ms dispatch segments on the mesh (the
    segmented advance with `ensemble=True`, the drain flag and the
    overflow counts reduced over the ranks): more segments, the same
    leaves and record."""
    stats, leaves = mesh_results(2)["segments/2"]
    whole_stats, whole = mesh_results(2)["sweep/all_to_all/window/2"]
    assert stats.pipeline["segments"] > whole_stats.pipeline["segments"]
    for k, v in whole.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    assert _record(stats.ensemble) == _record(whole_stats.ensemble)


def test_cli_runs_a_mesh_campaign(tmp_path, monkeypatch):
    """The CLI's entry takes a campaign with mesh_shards to its gloo
    ranks on the CPU: the same record as the spawned runs."""
    from shadow_tpu_torch import cli

    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    stats = cli.simulate(SWEEP, ovr(2, "all_gather"), device="cpu")
    want, _ = mesh_results(2)["sweep/all_gather/window/2"]
    assert _record(stats.ensemble) == _record(want.ensemble)
    assert stats.mesh["shards"] == 2
    assert os.path.exists(os.path.join(
        str(tmp_path), f"ENSEMBLE_TgenDevice_7_"
        f"{stats.ensemble['campaign']}.json"))


# ----------------------------------------------------------------------
# the batched plain exchange kernels at R = 3
# ----------------------------------------------------------------------
def _mesh_params(S=4, shard=1, H_loc=5, cap=7, cap2=5):
    from shadow_tpu_torch.device import capacity, kernels as K

    g, ng = capacity.group_split(S)
    return K.MeshParams(S, shard, H_loc, "two_phase", cap, cap2, g, ng)


def _outbox(gen, R, H, OB, H_pad):
    from shadow_tpu_torch.device import kernels as K

    t = torch.randint(0, 1000, (R, H, OB), generator=gen)
    t = torch.where(torch.rand((R, H, OB), generator=gen) < 0.2, K.INF, t)
    t = torch.where(torch.rand((R, H, OB), generator=gen) < 0.1,
                    K.DROP_T, t)
    dst = torch.randint(0, H_pad, (R, H, OB), generator=gen)
    return {"t": t, "k": torch.randint(0, 1 << 40, (R, H, OB),
                                       generator=gen),
            "m": (dst << 32) | 2,
            "s": torch.randint(0, 1 << 40, (R, H, OB), generator=gen),
            "v": torch.randint(0, 1 << 40, (R, H, OB), generator=gen)}


def _state(gen, R, H, E, S):
    t = torch.sort(torch.randint(0, 2000, (R, H, E), generator=gen)).values
    return {"ht": t, "hk": torch.randint(0, 1 << 40, (R, H, E),
                                          generator=gen),
            "hm": torch.zeros((R, H, E), dtype=torch.int64),
            "hv": torch.zeros((R, H, E), dtype=torch.int64),
            "hw": torch.zeros((R, H, E), dtype=torch.int64),
            "head": torch.randint(0, E, (R, H), generator=gen,
                                  dtype=torch.int32),
            **{k: torch.zeros((R, H), dtype=torch.int32) for k in (
                "overflow", "x_overflow", "occ_in", "occ_heap")},
            "occ_x": torch.zeros((R, 1, S), dtype=torch.int32)}


def _at(d, r):
    return {k: v[r].clone() for k, v in d.items()}


def test_batched_plain_exchange_kernels_equal_r1_calls():
    """K5 (the route over H_pad, the window and keyed modes over one and
    two wire regions [nb, R, C, bw]), K12, both K13 halves and K3's
    second block at R = 3, through the Kernels wrappers on CPU tensors
    (the batched plain versions, no launch counted), each replica equal
    to the R = 1 plain functions on its slice; replica 1's `run` word
    is 0 and its outputs and state keep every byte."""
    from shadow_tpu_torch.device import kernels as K

    gen = torch.Generator().manual_seed(7)
    R, E, OB = 3, 6, 4
    mp = _mesh_params()
    H, lo = mp.H_loc, mp.g0
    p = K.PhaseParams(E=E, K=1, T=1, P=1, B=2, IN=4, C=1, boot_end=0,
                      seed=(1, 2), app=None, g0=lo)
    kk = K.Kernels()
    ctl = K.control_block("cpu", R, run=1, win_end=K.INF)
    ctl[1, K.CTL["run"]] = 0
    ob = _outbox(gen, R, H, OB, mp.H_pad)
    state0 = _state(gen, R, H, E, mp.S)
    st = {k: v.clone() for k, v in state0.items()}
    route = tuple(torch.full((R, n), -1, dtype=torch.int64)
                  for n in (H * OB, mp.H_pad, mp.H_pad))
    kk.route_rows(K.Rows(ob), 0, mp.H_pad, False, out=route, ctl=ctl)
    send1 = torch.full((mp.G, R, 6, mp.CAP), -1, dtype=torch.int64)
    kk.pack_two_phase(st, ob, *route, mp, send1, ctl,
                      K.fill_words(send1))
    send = torch.full((mp.S, R, 6, mp.CAP), -1, dtype=torch.int64)
    kk.pack_remote(st, ob, *route, mp, send, ctl)
    # arrivals: replica-batched wire buffers with their keys
    recv1 = send1.clone()
    recv1[:, :, 0] = torch.where(recv1[:, :, 0] < K.INF,
                                 recv1[:, :, 0] + 1, recv1[:, :, 0])
    arr1 = kk.route_rows(K.Rows(recv1), 0, mp.H_pad, True, ctl=ctl)
    send2 = torch.full((mp.NG - 1, R, 6, mp.CAP2), -1, dtype=torch.int64)
    hist = torch.zeros((R, mp.H_pad), dtype=torch.int32)
    kk.pack_two_phase2(K.Rows(recv1), *arr1, mp, OB, send2, hist, ctl,
                       K.fill_words(send2))
    rows = K.Rows(recv1, send2.clone())
    win = kk.route_rows(rows, lo, H, True, ctl=ctl)
    own = (ob, route[0], route[1][:, lo:lo + H], route[2][:, lo:lo + H])
    kk.merge_heaps(st, rows, *win, p, ctl, second=own)
    assert kk.launches == dict.fromkeys(K.KERNEL_NAMES, 0)
    assert int(send1[0, 0, 0].lt(K.INF).sum()) > 0
    for r in range(R):
        s1 = _at(state0, r)
        if r == 1:
            for k, v in st.items():
                assert torch.equal(v[r], s1[k]), k
            assert (send[:, r] == -1).all() and (send1[:, r] == -1).all()
            assert (route[0][r] == -1).all()
            continue
        ob1 = K.at_replica(ob, r)
        rt1 = K.route_rows_plain(K.Rows(ob1), 0, mp.H_pad)
        for a, b in zip(rt1, route):
            assert torch.equal(a, b[r])
        b1 = torch.empty((mp.G, 6, mp.CAP), dtype=torch.int64)
        K.pack_two_phase_plain(s1, ob1, *rt1, mp, b1)
        assert torch.equal(b1, send1[:, r])
        b0 = torch.empty((mp.S, 6, mp.CAP), dtype=torch.int64)
        K.pack_remote_plain(s1, ob1, *rt1, mp, b0)
        assert torch.equal(b0[[d for d in range(mp.S) if d != mp.shard]],
                           send[[d for d in range(mp.S) if d != mp.shard],
                                r])
        a1 = K.route_rows_plain(K.Rows(recv1[:, r]), 0, mp.H_pad, True)
        b2 = torch.empty((mp.NG - 1, 6, mp.CAP2), dtype=torch.int64)
        h1 = torch.zeros(mp.H_pad, dtype=torch.int32)
        K.pack_two_phase2_plain(K.Rows(recv1[:, r]), *a1, mp, OB, b2, h1)
        assert torch.equal(b2, send2[:, r]) and torch.equal(h1, hist[r])
        rows1 = K.Rows(recv1[:, r], send2[:, r].clone())
        w1 = K.route_rows_plain(rows1, lo, H, True)
        for a, b in zip(w1, win):
            assert torch.equal(a, b[r])
        K.merge_heaps_plain(s1, rows1, *w1, p, second=(
            ob1, rt1[0], rt1[1][lo:lo + H], rt1[2][lo:lo + H]))
        for k, v in s1.items():
            assert torch.equal(v, st[k][r]), (r, k)
    # the phase changed something in the replicas that ran
    assert not torch.equal(st["ht"][0], state0["ht"][0])


def test_designs_before_refuse_a_campaigns_buffers():
    """The K13 design before packs one replica: at R > 1 it raises
    naming the design, never another path."""
    from shadow_tpu_torch.device import kernels as K

    kk = K.Kernels()
    kk.designs_before = True
    send = torch.zeros((2, 3, 6, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="design before"):
        kk._fill_args("pack_two_phase", send, K.fill_words(send))


# ----------------------------------------------------------------------
# the reference, in the child process
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    import jax

    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    def plain(x):
        return json.loads(json.dumps(
            x, default=lambda o: o.item() if hasattr(o, "item") else str(o)))

    with open(job_path) as f:
        job = json.load(f)
    out, meta = {}, {}
    # the compile cache keys programs without the mesh's size: off
    off = ["experimental.compile_cache=off"]
    for key, (yaml, ovr_) in job["runs"].items():
        c = Controller(load_config_str(yaml, ovr_ + off))
        c.run()
        er = c.runner
        for k, v in er.final_state.items():
            out[f"run/{key}/{k}"] = np.asarray(jax.device_get(v))
        meta[f"run/{key}/record"] = plain(er.record)
        meta[f"run/{key}/occupancy"] = plain(er.occ_record)
    np.savez(out_path, **out)
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
