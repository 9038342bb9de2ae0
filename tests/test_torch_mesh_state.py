"""The state audit, the model NIC, the path counters, their checkpoints
and the hybrid fall-back on the host mesh (`experimental.mesh_shards`,
device/mesh.py): S = 2 and S = 4 ranks spawned over gloo on the CPU,
each running the port's plain path, held against the JAX engine at the
same S on the conftest's 8 virtual CPU devices (the final state leaf by
leaf: per-host counters and checksums, `aud`, `aud_t`, `aud_tx`, the
NIC leaves, `path_cnt` row by row, and the rounds), against the port's
one-device run (the path counters summed over the rows) and against
the serial oracle (per-host checksums and events).

* tests/test_model_nic.py's PHOLD at 2 Mbit and loss 0.05 with the path
  counters and the audit (CoDel drops and drop rolls both);
* tests/test_exchange.py's tgen config under the model NIC and the path
  counters, all_to_all and two_phase (at S = 4 its rows relay through
  shard 1), and a planned mesh (`capacity_plan: auto`, `exchange: auto`);
* tests/test_torch_exchange.py's lossy PHOLD audited, and corruptions of
  its paused state on one rank: run on, against JAX run on from the same
  state, and audited at once, against the one-device audit of the whole
  state: a heap row out of order (AUD_HEAP on that host only), a
  negative counter (AUD_COUNTER), a lost row (AUD_CONSERVE on every host
  of every rank), and a row moved from a rank-0 host to a rank-1 host,
  whose ranks' balances are non-zero but sum to 0 (no AUD_CONSERVE: a
  decision per rank would get this wrong);
* the hybrid fall-back of a `tpu` mesh config with host faults or no
  device twin: the reference's warning, and the result of the same
  config without `mesh_shards`;
* the NIC run saved half way and resumed at S = 2: the port resuming its
  own checkpoint and the JAX engine's, the JAX engine resuming the
  port's, each equal to the uninterrupted run.

Tolerance everywhere is exact equality: the simulation is
integer-exact. The JAX engine runs in one child process (this file's
__main__ branch, compile cache off), which applies the jax batching
patch the reference needs under the installed jax; the patch never runs
in the pytest process. The child starts before the first test and
resumes the port's checkpoint once the test process has written it.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_model_nic.py's config at 2 Mbit and loss 0.05, with the
# path counters and the audit
NIC = """
general:
  stop_time: 3s
  seed: 3
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "2 Mbit" bandwidth_up "2 Mbit" ]
        node [ id 1 bandwidth_down "2 Mbit" bandwidth_up "2 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.05 ]
      ]
experimental:
  scheduler_policy: tpu
  model_bandwidth: true
  count_paths: true
  state_audit: true
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

# tests/test_exchange.py's XCHG_YAML (16 hosts, tgen clients of one
# server; the clients on the first shard, the server on the last) under
# the model NIC and the path counters, the clients' downlink at 2 Mbit
XNIC = """
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
  model_bandwidth: true
  count_paths: true
  event_capacity: 48
  exchange_in_capacity: 48
hosts:
  cli:
    quantity: 2
    network_node_id: 1
    bandwidth_down: 2 Mbit
    processes:
    - path: model:tgen_client
      args: server=srv size=16KiB count=2 pause=300ms retry=10s
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

# tests/test_torch_exchange.py's lossy PHOLD (16 hosts, msgload 2),
# audited
AUD = """
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
  state_audit: true
  event_capacity: 64
  outbox_capacity: 16
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

CONFIGS = {"nic": NIC, "xnic": XNIC, "aud": AUD}
# the hybrid fall-back's configs: host faults, and no single device twin
HYBRID = {
    "crash": ("aud", ["network.faults=[{kind: host_crash, time: 1s, host: "
                      "left0}, {kind: host_restart, time: 1500ms, host: "
                      "left0}]"]),
    "mixed": ("aud", ["hosts.right.processes=[{path: model:tgen_server, "
                      "start_time: 10ms}]"]),
}
EXCHANGES = {"a2a": "all_to_all", "tp": "two_phase"}
# the NIC run saved half way, then resumed
CK_PAUSE = "1500ms"
# the corruptions: the audited PHOLD paused at PAUSE (windows clamped to
# its stop), corrupted on one rank at S = 2, run on to RESUME
PAUSE, RESUME, STOP = 300_000_000, 1_000_000_000, 2_000_000_000
CORRUPTIONS = ("heap", "counter", "lost_row", "moved_row")
INF = 1 << 62
IMAX = (1 << 63) - 1
AUD_HEAP, AUD_COUNTER, AUD_CONSERVE = 1, 4, 8
S_CORRUPT, H_LOC = 2, 8


def ovr(S, exchange="all_to_all", extra=()):
    return [f"experimental.mesh_shards={S}",
            f"experimental.exchange={exchange}", *extra]


# the runs the JAX child reproduces: key -> (config, overrides)
JAX_RUNS = {
    "nic/a2a/2": ("nic", ovr(2)),
    "nic/a2a/4": ("nic", ovr(4)),
    "xnic/a2a/2": ("xnic", ovr(2)),
    "xnic/a2a/4": ("xnic", ovr(4)),
    "xnic/tp/4": ("xnic", ovr(4, "two_phase")),
    "aud/a2a/2": ("aud", ovr(2)),
    "aud/tp/4": ("aud", ovr(4, "two_phase")),
}


def _cfg(name, overrides=()):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(CONFIGS[name], list(overrides))


def corrupt(name: str, arrays: dict) -> dict:
    """A copy of the paused global state's numpy leaves (S = 2, eight
    hosts a rank) with one corruption on rank 1's hosts: its busiest
    host's first two live rows swapped ("heap"); its
    first host's n_sent set negative ("counter"); its busiest host's
    last live row deleted ("lost_row"); rank 0's busiest host's last
    live row moved into the heap of rank 1's least busy host, in (t,
    key) order ("moved_row": every row is still counted, but each rank's
    own balance moves by one)."""
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    ht, hk, head = a["ht"], a["hk"], a["head"]
    E = ht.shape[1]
    live = ((np.arange(E)[None, :] >= head[:, None]) & (ht < INF)).sum(-1)
    rank1 = np.arange(H_LOC, 2 * H_LOC)
    fields = ("ht", "hk", "hm", "hv", "hw")
    if name == "heap":
        h = int(rank1[np.argmax(live[rank1])])
        assert live[h] >= 2, "no heap of two rows to swap"
        j = int(head[h])
        for f in fields:
            a[f][h, [j, j + 1]] = a[f][h, [j + 1, j]]
    elif name == "counter":
        a["n_sent"][H_LOC] = -7
    elif name == "lost_row":
        h = int(rank1[np.argmax(live[rank1])])
        j = int(head[h] + live[h]) - 1
        a["ht"][h, j], a["hk"][h, j] = INF, IMAX
        for f in ("hm", "hv", "hw"):
            a[f][h, j] = 0
    elif name == "moved_row":
        src = int(np.argmax(live[:H_LOC]))
        dst = int(rank1[np.argmin(live[rank1])])
        j = int(head[src] + live[src]) - 1
        row = {f: a[f][src, j] for f in fields}
        a["ht"][src, j], a["hk"][src, j] = INF, IMAX
        for f in ("hm", "hv", "hw"):
            a[f][src, j] = 0
        n = int(head[dst] + live[dst])
        assert n < E, "the receiving heap is full"
        for f in fields:
            a[f][dst, n] = row[f]
        # the tail from head on in (t, key) order
        lo = int(head[dst])
        order = lo + np.lexsort((a["hk"][dst, lo:], a["ht"][dst, lo:]))
        for f in fields:
            a[f][dst, lo:] = a[f][dst, order]
    else:
        raise ValueError(name)
    return a


# ----------------------------------------------------------------------
# the child and its fixtures
# ----------------------------------------------------------------------
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


@pytest.fixture(scope="module")
def workdir():
    d = tempfile.mkdtemp(prefix="torch_mesh_state_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def occ_dir(workdir):
    """The planned runs' OCC records (and the spawned ranks', which
    inherit the environment) go to the module's directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHADOW_TPU_OCC_DIR", os.path.join(workdir, "occ"))
        yield


@pytest.fixture(scope="module", autouse=True)
def reference_child(workdir):
    d = os.path.join(workdir, "child")
    os.makedirs(d)
    job = {"runs": {k: (CONFIGS[n], o) for k, (n, o) in JAX_RUNS.items()},
           "hybrid": {k: (CONFIGS[n], o + ovr(2))
                      for k, (n, o) in HYBRID.items()},
           "aud": (AUD, ovr(S_CORRUPT)), "pause": PAUSE, "resume": RESUME,
           "stop": STOP, "nic": (NIC, ovr(2)), "ck_pause": CK_PAUSE,
           "port_ck": os.path.join(workdir, "port_nic.npz"),
           "port_ready": os.path.join(workdir, "port_nic.ready")}
    child = ReferenceChild(job, d)
    try:
        yield child
    finally:
        child.stop()


@pytest.fixture(scope="module")
def reference(reference_child, port_checkpoint):
    """The child's arrays; the port's checkpoint, which the child
    resumes last, is written first."""
    return reference_child.result()


_MESH = {}


def _port_keys(S):
    """The runs at S: the JAX runs' own, two_phase at S = 2 too, and at
    S = 2 a planned mesh (the NIC run under `capacity_plan: auto` and
    `exchange: auto`)."""
    keys = {k: v for k, v in JAX_RUNS.items() if k.endswith(f"/{S}")}
    for n in CONFIGS:
        for x, ex in EXCHANGES.items():
            keys.setdefault(f"{n}/{x}/{S}", (n, ovr(S, ex)))
    if S == 2:
        keys["nic/planned/2"] = ("nic", ovr(2, "auto", [
            "experimental.capacity_plan=auto",
            "experimental.capacity_warmup=500ms"]))
    return keys


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
            "experimental.scheduler_policy=serial",
            "experimental.state_audit=false"]), device="cpu")
        _ONE[name] = (port, serial)
    return _ONE[name]


@pytest.fixture(scope="module")
def port_checkpoint(workdir):
    """The port's NIC run at S = 2 saved half way (its SimStats), then
    the marker the child waits for before it resumes the file."""
    from shadow_tpu_torch.device import runner

    path = os.path.join(workdir, "port_nic.npz")
    (part, _), = runner.mesh_runs(["cpu"] * 2, [_cfg("nic", ovr(2, extra=[
        f"experimental.checkpoint_save={path}",
        f"experimental.checkpoint_save_time={CK_PAUSE}"]))], timeout=300)
    with open(os.path.join(workdir, "port_nic.ready"), "w") as f:
        f.write("written\n")
    return path, part


def _same_leaves(got: dict, want: dict, key: str, prefix: str) -> None:
    missing = [k for k in got if f"{prefix}/{k}" not in want]
    assert not missing, (key, missing)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[f"{prefix}/{k}"],
                                      err_msg=f"{key}: leaf {k}")


def _same_trace(a, b, what: str) -> None:
    np.testing.assert_array_equal(a.host_trace_checksum,
                                  b.host_trace_checksum, what)
    np.testing.assert_array_equal(a.host_events_executed,
                                  b.host_events_executed, what)
    for f in ("events_executed", "packets_sent", "packets_dropped",
              "packets_delivered"):
        assert getattr(a, f) == getattr(b, f), (what, f)


# ----------------------------------------------------------------------
# whole runs against JAX at the same S, one device and the serial oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", list(JAX_RUNS))
def test_mesh_run_equals_jax_leaf_by_leaf(key, reference):
    """The gathered final state, every leaf (the heaps and counters, the
    NIC leaves [H_pad], `path_cnt` [S, V*V] row by row, `aud`, `aud_t`,
    `aud_tx`, occ_x), and the rounds equal the JAX engine's at the same
    mesh_shards; the health word is zero."""
    S = int(key.split("/")[-1])
    stats, leaves = mesh_results(S)[key]
    assert stats.ok and stats.mesh["backend"] == "gloo"
    assert stats.rounds == int(reference[f"run/{key}/rounds"])
    _same_leaves(leaves, reference, key, f"run/{key}")
    name = key.split("/")[0]
    if name in ("nic", "xnic"):
        assert leaves["path_cnt"].shape[0] == S
        assert leaves["tx_free"].shape[0] == leaves["ht"].shape[0]
        # each rank counted its own senders' packets
        assert (leaves["path_cnt"].sum(-1) > 0).sum() >= 2, key
    if name in ("nic", "aud"):
        assert not leaves["aud"].any() and leaves["aud_tx"].sum() > 0


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mesh_runs_equal_one_device_and_serial(name, S):
    """Under all_to_all and two_phase (and at S = 2 the planned mesh),
    per-host events and trace checksums, the run totals, the rounds and
    the summed path counters equal the one-device run's; the traces
    equal the serial oracle's."""
    port, serial = one_device(name)
    assert port.ok and port.events_executed > 0
    _same_trace(port, serial, f"{name}: one device vs serial")
    if name == "nic":
        # CoDel drops and drop rolls both
        assert port.packets_dropped > 0
    for key, (n, _) in _port_keys(S).items():
        if n != name:
            continue
        stats, leaves = mesh_results(S)[key]
        assert stats.ok, key
        _same_trace(stats, port, key)
        assert stats.rounds == port.rounds, key
        assert stats.path_packets == port.path_packets, key
        if "path_cnt" in leaves:
            assert leaves["path_cnt"].shape[0] == S
            assert sum(stats.path_packets.values()) == \
                int(leaves["path_cnt"].sum())


def test_planned_mesh_prices_the_new_leaves():
    """The planned mesh resolves `exchange: auto`, and each rank's
    admission estimate prices its NIC leaves, its path counter row and
    its audit leaves (device/capacity.py state_nbytes at H_loc)."""
    import dataclasses

    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import capacity, runner
    from shadow_tpu_torch.device.engine import phase_params
    from shadow_tpu_torch.device.kernels import AUD_KEYS, NIC_KEYS
    from shadow_tpu_torch.device.mesh import Mesh

    stats, _ = mesh_results(2)["nic/planned/2"]
    assert stats.occupancy["planned"] and stats.mesh["exchange"] in (
        "all_to_all", "two_phase", "all_gather")
    cfg = _cfg("nic", ovr(2))
    sim = build(cfg)
    eng = runner.engine_from(cfg, sim, device="cpu",
                             mesh=Mesh(1, 2, "cpu", "gloo"))
    p = phase_params(eng.config, sim.app)
    bare = capacity.state_nbytes(8, dataclasses.replace(
        p, MB=False, CP=False, AUD=False))
    full = capacity.state_nbytes(8, p, eng.n_vertices)
    state = eng.init_state(sim.start_times, sim.stop_times)
    new = (*NIC_KEYS, "path_cnt", *AUD_KEYS)
    assert full - bare == sum(state[k].numel() * state[k].element_size()
                              for k in new) == 8 * 7 * 8 + 4 * 8 + \
        8 * (4 + 8 + 8)
    assert state["path_cnt"].shape == (1, 4)


def test_nic_pops_take_the_world_columns_on_a_rank():
    """The `_nic` pops' launch arguments on a mesh rank: the world's
    [H_pad] bandwidth columns, which the kernel reads at the rank's
    global ids (rank 1's hosts from g0 = 8 on), are taken; columns of
    the rank's H_loc hosts alone, or a rank past the world's hosts, are
    refused."""
    import dataclasses

    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.mesh import Mesh

    cfg = _cfg("nic", ovr(2))
    sim = build(cfg)
    eng = runner.engine_from(cfg, sim, device="cpu",
                             mesh=Mesh(1, 2, "cpu", "gloo"))
    state = eng.init_state(sim.start_times, sim.stop_times)
    world, p = eng.world, eng.params
    assert p.g0 == 8 and world["bw_up"].shape == (16,)
    args, checks = K.nic_args(state, world, p)
    assert args.mb == 1 and len(checks) == 12
    cut = {**world, **K.host_columns(world, p.g0, 8)}
    with pytest.raises(ValueError, match=r"the world's \[H\] \(a mesh's "
                       r"\[H_pad\]\) bandwidths"):
        K.nic_args(state, cut, p)
    with pytest.raises(ValueError, match="bandwidths"):
        K.nic_args(state, world, dataclasses.replace(p, g0=9))


# ----------------------------------------------------------------------
# the audit's corruptions on one rank
# ----------------------------------------------------------------------
def _rank_jobs(mesh, cfg, jobs):
    """Each job on this rank of a mesh: ("audit", global leaves): this
    rank's rows audited once at a round end (the rank's balance word and
    the gathered words); ("run", global leaves, stop, final stop): run
    on to `stop` (the gathered leaves and the rounds). Rank 0 returns
    the results."""
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import (
        state_from_numpy,
        state_to_numpy,
    )
    from shadow_tpu_torch.device.kernels import control_block

    sim = build(cfg)
    out = []
    for job in jobs:
        eng = runner.engine_from(cfg, sim, device=mesh.device, mesh=mesh)
        state = state_from_numpy(runner.shard_state(job[1],
                                                    eng.mesh_params),
                                 mesh.device)
        if job[0] == "audit":
            eng._audit(state, control_block(mesh.device, run=1,
                                             round_end=1))
            got = mesh.gather_leaves({
                "aud": state["aud"].numpy(),
                "balance": eng._xbuf["aud_balance"].numpy().copy()})
            out.append(got)
        else:
            state, rounds = eng.run(state, stop=job[2], final_stop=job[3])
            got = mesh.gather_leaves(state_to_numpy(state))
            out.append((got, rounds))
    return out if mesh.rank == 0 else None


_CORRUPT = {}


def corrupted(reference):
    """{name: (the port's direct audit of the corrupted state, its
    run-on: leaves and rounds)}, one spawned mesh of S_CORRUPT ranks."""
    if not _CORRUPT:
        from shadow_tpu_torch.device import mesh

        jobs = []
        for name in ("clean",) + CORRUPTIONS:
            leaves = {k[len(f"c/{name}/in/"):]: v
                      for k, v in reference.items()
                      if k.startswith(f"c/{name}/in/")}
            jobs.append(("audit", leaves))
            if name != "clean":
                jobs.append(("run", leaves, RESUME, STOP))
        out = mesh.spawn(["cpu"] * S_CORRUPT, _rank_jobs,
                         (_cfg("aud", ovr(S_CORRUPT)), jobs), timeout=300)
        it = iter(out)
        for name in ("clean",) + CORRUPTIONS:
            _CORRUPT[name] = (next(it), None if name == "clean"
                              else next(it))
    return _CORRUPT


def _one_device_words(leaves: dict) -> np.ndarray:
    """The one-device audit of the whole global state (the reference's
    global balance), the port's plain K8."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.engine import state_from_numpy

    state = state_from_numpy(leaves, "cpu")
    K.audit_round_plain(state)
    return state["aud"].numpy()


@pytest.mark.parametrize("name", CORRUPTIONS)
def test_corruption_on_one_rank_runs_on_as_jax(name, reference):
    """The corrupted state run on: every leaf, the health word among
    them, and the rounds equal the JAX engine's at the same S."""
    _, (leaves, rounds) = corrupted(reference)[name]
    assert rounds == int(reference[f"c/{name}/rounds"])
    _same_leaves(leaves, reference, name, f"c/{name}/out")


@pytest.mark.parametrize("name", ("clean",) + CORRUPTIONS)
def test_rank_audit_of_a_corrupted_state(name, reference):
    """The mesh's audit of the corrupted state at once: the words equal
    the JAX engine's `_audit_round` of the same state at the same S (a
    round that pops nothing) and the one-device audit of the whole
    state: a heap row out of order
    marks AUD_HEAP on that host only, a negative counter AUD_COUNTER on
    that host, a lost row AUD_CONSERVE on every host of every rank; the
    moved row and the clean state mark nothing, though a rank's own
    balance is not zero (the sum over the ranks is)."""
    (got, _) = corrupted(reference)[name]
    leaves = {k[len(f"c/{name}/in/"):]: v for k, v in reference.items()
              if k.startswith(f"c/{name}/in/")}
    np.testing.assert_array_equal(got["aud"], reference[f"c/{name}/once"])
    want = _one_device_words(leaves)
    np.testing.assert_array_equal(got["aud"], want)
    base = leaves["aud"]
    new = got["aud"] & ~base
    balance = got["balance"]
    assert balance.shape == (S_CORRUPT,) and int(balance.sum()) == (
        1 if name == "lost_row" else 0)
    clean_balance = corrupted(reference)["clean"][0]["balance"]
    if name == "heap":
        assert (new == AUD_HEAP).sum() == 1 and (new != 0).sum() == 1
        assert np.flatnonzero(new)[0] >= H_LOC
    elif name == "counter":
        assert np.flatnonzero(new).tolist() == [H_LOC]
        assert new[H_LOC] == AUD_COUNTER
    elif name == "lost_row":
        assert ((new & AUD_CONSERVE) != 0).all()
    elif name == "moved_row":
        # each rank's own balance is off by one, the sum is not
        assert not new.any()
        np.testing.assert_array_equal(balance - clean_balance, [1, -1])
        assert (balance != 0).all()
    else:
        assert not new.any() and not base.any()


# ----------------------------------------------------------------------
# the hybrid fall-back on a mesh config
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", list(HYBRID))
def test_hybrid_fall_back_ignores_the_mesh(case, reference, caplog):
    """A `tpu` mesh config with host faults or no device twin runs on the
    hybrid policy (the CPU engine, the judge's plain path on the CPU)
    with the reference's warning, and equals the same config without
    `mesh_shards` and the reference's run."""
    from shadow_tpu_torch.device import runner

    name, extra = HYBRID[case]
    with caplog.at_level(logging.INFO, logger="shadow_tpu_torch"):
        stats = runner.run(_cfg(name, extra + ovr(2)), device="cpu")
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING and "mesh_shards" in
              r.getMessage()]
    assert warned == [str(reference[f"hybrid/{case}/warning"])]
    assert stats.policy == "hybrid"
    plain = runner.run(_cfg(name, extra), device="cpu")
    _same_trace(stats, plain, case)
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  reference[f"hybrid/{case}/chk"])
    assert stats.events_executed == int(reference[f"hybrid/{case}/events"])


def test_campaign_on_a_mesh_is_refused_naming_9c():
    """Since ROADMAP (a) item 9c a campaign on a mesh, audited too, is
    admitted: it builds with its device twin, and no refusal names 9c;
    since 13.1 also with dispatch retries (refused before, naming item
    13)."""
    from shadow_tpu_torch.core.build import build

    sim = build(_cfg("aud", ovr(2) + [
        "ensemble={replicas: 2, vary: {seed: [5, 6]}}"]))
    assert sim.app is not None and sim.no_twin is None
    sim = build(_cfg("aud", ovr(2) + [
        "ensemble={replicas: 2, vary: {seed: [5, 6]}}",
        "experimental.dispatch_retries=1"]))
    assert sim.app is not None and sim.no_twin is None


# ----------------------------------------------------------------------
# checkpoints of the audited, NIC and path-counting run at S = 2
# ----------------------------------------------------------------------
def _resumed(path):
    from shadow_tpu_torch.device import runner

    (stats, leaves), = runner.mesh_runs(["cpu"] * 2, [_cfg("nic", ovr(
        2, extra=[f"experimental.checkpoint_load={path}"]))],
        keep_state=True, timeout=300)
    return stats, leaves


def _check_resume(stats, leaves, part, reference, what):
    full, full_leaves = mesh_results(2)["nic/a2a/2"]
    assert stats.ok and not stats.preempted, what
    _same_trace(stats, full, what)
    for k in ("chk", "n_exec", "path_cnt", "aud", "aud_tx", *(
            "tx_free", "rx_free", "cd_fa", "cd_next", "cd_cnt", "cd_last",
            "cd_drop")):
        np.testing.assert_array_equal(leaves[k], full_leaves[k],
                                      err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(leaves["chk"],
                                  reference["run/nic/a2a/2/chk"])
    if part is not None:
        assert part.end_time == 1_500_000_000
        assert part.events_executed < full.events_executed


def test_port_resumes_its_own_mesh_checkpoint(port_checkpoint, reference):
    """Saved half way on two ranks (the gathered leaves in the
    reference's global layout: path_cnt [S, V*V], the NIC and audit
    leaves [H_pad]) and resumed on two: equal to the uninterrupted run,
    the path counters and the health word included."""
    from shadow_tpu_torch.device import checkpoint

    path, part = port_checkpoint
    saved, meta = checkpoint.load_host_state(path)
    assert meta["geometry"]["n_shards"] == 2
    assert saved["path_cnt"].shape == (2, 4)
    for k in ("tx_free", "cd_drop", "aud", "aud_tx"):
        assert saved[k].shape == (16,), k
    stats, leaves = _resumed(path)
    _check_resume(stats, leaves, part, reference, "port <- port")


def test_port_resumes_the_jax_mesh_checkpoint(reference):
    stats, leaves = _resumed(str(reference["ck/jax_path"]))
    _check_resume(stats, leaves, None, reference, "port <- jax")
    assert json.loads(str(reference["ck/jax_meta"]))["keys"] == \
        json.loads(str(reference["ck/port_meta"]))["keys"]


@pytest.mark.parametrize("who", ["jax_own", "jax_port"])
def test_jax_resumes_mesh_checkpoints(who, port_checkpoint, reference):
    """The JAX engine at S = 2 resuming its own and the port's
    checkpoint: equal to its uninterrupted run, leaf by leaf (every leaf
    its runner reads back: all but the heaps)."""
    from shadow_tpu_torch.device.kernels import AUD_KEYS, NIC_KEYS

    want = {k[len("run/nic/a2a/2/"):]: v for k, v in reference.items()
            if k.startswith("run/nic/a2a/2/") and not k.endswith("rounds")}
    got = {k[len(f"ck/{who}/"):]: v for k, v in reference.items()
           if k.startswith(f"ck/{who}/")}
    assert {"chk", "n_exec", "path_cnt", *NIC_KEYS, *AUD_KEYS} <= set(got)
    assert set(got) <= set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{who} {k}")


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
    from shadow_tpu.device import checkpoint

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    # the compile cache keys programs without the mesh's size: off
    off = ["experimental.compile_cache=off"]
    here = os.path.dirname(out_path)

    def np_of(state):
        return {k: np.asarray(jax.device_get(v)) for k, v in state.items()}

    for key, (yaml, ovr_) in job["runs"].items():
        c = Controller(load_config_str(yaml, ovr_ + off))
        eng = c.runner.engine
        state, rounds = eng.run(eng.init_state(c.sim.starts))
        for k, v in np_of(state).items():
            out[f"run/{key}/{k}"] = v
        out[f"run/{key}/rounds"] = np.int64(rounds)

    # the corruptions: one compiled run, paused, corrupted, run on
    yaml, ovr_ = job["aud"]
    c = Controller(load_config_str(yaml, ovr_ + off))
    eng = c.runner.engine
    mid, _ = eng.run(eng.init_state(c.sim.starts), stop=job["pause"],
                     final_stop=job["stop"])
    mid_np = np_of(mid)
    for k, v in mid_np.items():
        out[f"c/clean/in/{k}"] = v
    hv, world = eng.host_vertex_device(), eng.world()

    def on_device(arrays):
        return {k: jax.device_put(jnp.asarray(v), mid[k].sharding)
                for k, v in arrays.items()}

    def audit_once(arrays):
        # one round whose window ends at the earliest row pops nothing
        # and exchanges nothing: its round-end `_audit_round` alone acts
        win_end = jnp.int64(int(arrays["ht"].min()))
        state, _ = eng._round_step(on_device(arrays), win_end, hv, world)
        return np.asarray(jax.device_get(state["aud"]))

    out["c/clean/once"] = audit_once(mid_np)
    for name in CORRUPTIONS:
        arrays = corrupt(name, mid_np)
        out[f"c/{name}/once"] = audit_once(arrays)
        state, rounds = eng.run(on_device(arrays), stop=job["resume"],
                                final_stop=job["stop"])
        for k, v in arrays.items():
            out[f"c/{name}/in/{k}"] = v
        for k, v in np_of(state).items():
            out[f"c/{name}/out/{k}"] = v
        out[f"c/{name}/rounds"] = np.int64(rounds)

    # the hybrid fall-back: the warning and the trace
    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())

    for key, (yaml, ovr_) in job["hybrid"].items():
        keep = Keep()
        logger = logging.getLogger("shadow_tpu")
        logger.addHandler(keep)
        try:
            c = Controller(load_config_str(yaml, ovr_ + off))
            stats = c.run()
        finally:
            logger.removeHandler(keep)
        warned = [m for m in keep.msgs if "mesh_shards" in m]
        assert len(warned) == 1, keep.msgs
        out[f"hybrid/{key}/warning"] = np.str_(warned[0])
        out[f"hybrid/{key}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], np.int64)
        out[f"hybrid/{key}/events"] = np.int64(stats.events_executed)

    # the NIC run at S = 2: saved half way, resumed; then the port's
    # checkpoint, once the test process has written it
    yaml, ovr_ = job["nic"]
    ck = os.path.join(here, "jax_nic.npz")
    Controller(load_config_str(yaml, ovr_ + off + [
        f"experimental.checkpoint_save={ck}",
        f"experimental.checkpoint_save_time={job['ck_pause']}"])).run()
    out["ck/jax_path"] = np.str_(ck)
    out["ck/jax_meta"] = np.str_(json.dumps(checkpoint.peek_meta(ck)))

    def resume(path, key):
        c = Controller(load_config_str(yaml, ovr_ + off + [
            f"experimental.checkpoint_load={path}"]))
        stats = c.run()
        assert stats.ok, key
        for k, v in np_of(c.runner.final_state).items():
            out[f"ck/{key}/{k}"] = v

    resume(ck, "jax_own")
    deadline = time.monotonic() + 600
    while not os.path.exists(job["port_ready"]):
        if time.monotonic() > deadline:
            raise TimeoutError("the port's checkpoint was not written")
        time.sleep(0.5)
    out["ck/port_meta"] = np.str_(json.dumps(
        checkpoint.peek_meta(job["port_ck"])))
    resume(job["port_ck"], "jax_port")
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
