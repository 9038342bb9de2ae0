"""The port's CPU engine and hybrid policy against the reference: the
`serial` policy, the `hybrid` policy (the judge's plain path on the CPU,
K10's plain version), and the `tpu` policy's fall-back to hybrid for host
faults and mixed model families. Tolerance everywhere is exact equality:
the simulation and the judge are integer-exact, and the drop roll
compares the same float32 values.

The reference's serial Controller runs in this process (its serial path
imports no device module). The reference's DeviceJudge and its
`tpu`->hybrid run need the jax batching patch the reference needs under
the installed jax: they run in one child process (this file's __main__
branch), started before the first test; the patch never runs in the
pytest process.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from shadow_tpu_torch.config import load_config, load_config_str
from shadow_tpu_torch.core.build import build
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.device.judge import DeviceJudge
from shadow_tpu_torch.device.kernels import judge_batch_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")

GML_LOSSY = """graph [ directed 0
  node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
  node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
  edge [ source 0 target 0 latency "10 ms" packet_loss 0.02 ]
  edge [ source 0 target 1 latency "25 ms" packet_loss 0.02 ]
  edge [ source 1 target 1 latency "10 ms" packet_loss 0.02 ]
]"""


def _indent(text: str, n: int) -> str:
    return "\n".join(" " * n + line for line in text.splitlines())


# tests/test_hybrid.py's lossy PHOLD (8 + 8 hosts, 2 s)
PHOLD = f"""
general:
  stop_time: 2s
  seed: 7
network:
  graph:
    type: gml
    inline: |
{_indent(GML_LOSSY, 6)}
experimental:
  scheduler_policy: serial
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes:
    - path: model:phold
      args: msgload=3 size=64
      start_time: 10ms
  right:
    quantity: 8
    network_node_id: 1
    processes:
    - path: model:phold
      args: msgload=3 size=64
      start_time: 10ms
"""
# and its selfloop case: a runahead above the self-path latency
SELFLOOP = PHOLD.replace("  scheduler_policy: serial",
                         "  scheduler_policy: serial\n  runahead: 100ms") \
    .replace("msgload=3 size=64", "msgload=3 size=64 selfloop=1")

# PHOLD and tgen on one graph: no single device twin
MIX = f"""
general: {{stop_time: 3s, seed: 5}}
network:
  graph:
    type: gml
    inline: |
{_indent(GML_LOSSY.replace("0.02", "0.05"), 6)}
experimental: {{scheduler_policy: serial}}
hosts:
  peer:
    quantity: 6
    network_node_id: 0
    processes: [{{path: model:phold, args: msgload=2, start_time: 10ms}}]
  server:
    network_node_id: 0
    processes: [{{path: model:tgen_server, start_time: 10ms}}]
  client:
    quantity: 3
    network_node_id: 1
    processes:
    - {{path: model:tgen_client, start_time: 100ms,
       args: server=server size=60KiB count=3 pause=50ms retry=300ms}}
"""

# examples/tor_small.yaml cut to 6.5 s, a relay down from 5.6 s to 6.2 s
TOR_CRASH = ["general.stop_time=6500ms",
             "network.faults=[{kind: host_crash, time: 5600ms, host: "
             "relay_us3}, {kind: host_restart, time: 6200ms, host: "
             "relay_us3}]"]

# (name, source: YAML text or an examples/ file, overrides)
CONFIGS = {
    "phold": (PHOLD, []),
    "selfloop": (SELFLOOP, []),
    "tgen_faults": ("tgen_faults.yaml", []),
    "tgen_faults_hier": ("tgen_faults_hier.yaml", []),
    "mix": (MIX, []),
    "tor_crash": ("tor_small.yaml", TOR_CRASH),
}
POLICY = "experimental.scheduler_policy="


def _port_cfg(name: str, extra=()):
    source, overrides = CONFIGS[name]
    if source.endswith(".yaml"):
        return load_config(os.path.join(EXAMPLES, source),
                           overrides + list(extra))
    return load_config_str(source, overrides + list(extra))


def _ref_cfg(name: str, extra=()):
    from shadow_tpu.config import load_config as rload
    from shadow_tpu.config import load_config_str as rload_str

    source, overrides = CONFIGS[name]
    if source.endswith(".yaml"):
        return rload(os.path.join(EXAMPLES, source),
                     overrides + list(extra))
    return rload_str(source, overrides + list(extra))


def _leaves(hosts) -> dict:
    return {f: [getattr(h, f) for h in hosts] for f in (
        "name", "vertex", "bw_up_bits", "bw_down_bits", "events_executed",
        "trace_checksum", "packets_sent", "packets_dropped",
        "packets_delivered", "events_quarantined")}


_REF = {}


def reference_serial(name: str):
    """(trace, per-host leaves, totals, path counters) of the reference's
    serial run, cached per config."""
    if name not in _REF:
        from shadow_tpu.core.controller import Controller as RefController

        trace = []
        c = RefController(_ref_cfg(name, [POLICY + "serial"]), trace=trace)
        s = c.run()
        _REF[name] = (trace, _leaves(c.sim.hosts),
                      (s.events_executed, s.packets_sent, s.packets_dropped,
                       s.packets_delivered, s.rounds),
                      dict(c.sim.netmodel.path_packets))
    return _REF[name]


def port_run(name: str, extra=(), device="cpu"):
    trace = []
    c = Controller(_port_cfg(name, extra), trace=trace, device=device)
    s = c.run()
    return trace, _leaves(c.manager.hosts), (
        s.events_executed, s.packets_sent, s.packets_dropped,
        s.packets_delivered, s.rounds), s


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serial_equals_reference_serial(name):
    """The port's serial policy equals the reference's: the full (time,
    dst, src, kind) trace, every per-host leaf, the totals and the path
    counters."""
    trace, leaves, totals, stats = port_run(name, [POLICY + "serial"])
    ref = reference_serial(name)
    assert stats.policy == "serial" and stats.judge is None
    assert trace == ref[0] and len(trace) > 0
    assert leaves == ref[1]
    assert totals == ref[2]
    assert stats.path_packets == ref[3]
    np.testing.assert_array_equal(stats.host_trace_checksum,
                                  ref[1]["trace_checksum"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hybrid_equals_reference_serial(name):
    """The hybrid policy (the judge on the CPU, every round at or above
    min_batch judged in one batch) equals the reference's serial run."""
    trace, leaves, totals, stats = port_run(
        name, [POLICY + "hybrid", "experimental.hybrid_judge_min_batch=2"])
    ref = reference_serial(name)
    assert stats.policy == "hybrid"
    assert stats.judge["batches"] > 0
    assert trace == ref[0]
    assert leaves == ref[1]
    assert totals == ref[2]


@pytest.mark.parametrize("name", ["tgen_faults", "tgen_faults_hier", "mix",
                                  "tor_crash"])
def test_tpu_policy_falls_back_to_hybrid(name, caplog):
    """Under `tpu` a config with host faults or no single device twin
    runs on the hybrid policy, with the reference's log line, and equals
    the reference's serial run."""
    with caplog.at_level(logging.INFO, logger="shadow_tpu_torch"):
        trace, leaves, totals, stats = port_run(name, [POLICY + "tpu"])
    ref = reference_serial(name)
    assert stats.policy == "hybrid"
    assert any("tpu policy -> hybrid: " in r.getMessage()
               and "running hybrid" in r.getMessage()
               for r in caplog.records)
    assert trace == ref[0]
    assert leaves == ref[1]
    assert totals == ref[2]


def test_min_batch_routes_rounds_and_never_changes_traces():
    """hybrid_judge_min_batch 0 sends every round to the judge's batch,
    1,000,000,000 keeps every round on the CPU roll: equal traces, and
    the counters show which path ran."""
    t0, l0, _, s0 = port_run(
        "phold", [POLICY + "hybrid", "experimental.hybrid_judge_min_batch=0"])
    t1, l1, _, s1 = port_run(
        "phold", [POLICY + "hybrid",
                  "experimental.hybrid_judge_min_batch=1000000000"])
    assert t0 == t1 == reference_serial("phold")[0]
    assert l0 == l1
    assert s0.judge["batches"] > 0 and s0.judge["cpu_batches"] == 0
    assert s0.judge["packets"] == s1.judge["cpu_packets"] > 0
    assert s1.judge["batches"] == 0 and s1.judge["cpu_batches"] > 0


def test_restart_respawns_and_quarantines():
    """tgen_faults.yaml: client0 quarantines events while down, counts
    its quarantined packets as drops, and downloads again after its
    restart (its events resume past 7 s)."""
    c = Controller(_port_cfg("tgen_faults"), trace=(trace := []),
                   device="cpu")
    c.run()
    h = next(h for h in c.manager.hosts if h.name == "client0")
    assert h.events_quarantined > 0 and not h.crashed
    cid = h.host_id
    assert any(t > 7 * 10**9 for t, dst, _, _ in trace if dst == cid)
    assert not any(4 * 10**9 < t < 7 * 10**9
                   for t, dst, _, _ in trace if dst == cid)


# ----------------------------------------------------------------------
# the judge: judge_batch_plain against the reference's NetworkModel
# ----------------------------------------------------------------------
STAR = """
general: {stop_time: 1s, seed: 3, bootstrap_end_time: 300ms}
network:
  topology: {representation: hierarchical}
  graph:
    type: star_clusters
    clusters: 3
    spokes_per_cluster: 3
    hub_latency: 10 ms
    access_latency: 1 ms
    hub_packet_loss: 0.05
experimental: {scheduler_policy: serial}
hosts:
  peer:
    quantity: 9
    network_node_id: 3
    network_node_stride: 1
    processes: [{path: model:phold, start_time: 10ms}]
"""
# six epochs: starts at 0, 1, 2, 3, 4 and 5 s
DENSE_EPOCHS = PHOLD.replace("  stop_time: 2s\n", "  stop_time: 2s\n"
                             "  bootstrap_end_time: 500ms\n").replace(
    "experimental:", """  faults:
    - {kind: degrade, time: 1s, duration: 1s, source: 0, target: 1,
       latency_multiplier: 3, extra_packet_loss: 0.2}
    - {kind: link_down, time: 3s, source: 0, target: 1}
    - {kind: link_up, time: 4s, source: 0, target: 1}
    - {kind: link_down, time: 5s, source: 0, target: 1}
experimental:""", 1)
# examples/tgen_faults_hier.yaml's factored epochs (its hub and access
# degrades, the hub link's outage), with a bootstrap end
FACTORED_EPOCHS = ("tgen_faults_hier.yaml",
                   ["general.bootstrap_end_time=2500ms"])
JUDGE_CONFIGS = {
    "dense": (PHOLD.replace("  stop_time: 2s\n", "  stop_time: 2s\n"
                            "  bootstrap_end_time: 500ms\n"), []),
    "factored": (STAR, []),
    "dense_epochs": (DENSE_EPOCHS, []),
    "factored_epochs": FACTORED_EPOCHS,
}
JUDGE_N = 3000


def _judge_source(name):
    source, overrides = JUDGE_CONFIGS[name]
    if source.endswith(".yaml"):
        return os.path.join(EXAMPLES, source), overrides, True
    return source, overrides, False


def judge_batch_of(name: str, H: int, epoch_starts, boot_end: int):
    """A seeded batch: times at, 1 ns before and after every epoch
    start and the bootstrap end, and uniform in [0, 7 s); uniform hosts
    (a tenth self-sends); packet seqs with 0, 2^31-1 and -1 among them."""
    rng = np.random.default_rng(sum(map(ord, name)))
    near = [b + d for b in list(epoch_starts) + [boot_end]
            for d in (-1, 0, 1) if b + d >= 0]
    now = rng.integers(0, 7 * 10**9, JUDGE_N)
    now[:len(near)] = near
    src = rng.integers(0, H, JUDGE_N)
    dst = np.where(rng.random(JUDGE_N) < 0.1, src,
                   rng.integers(0, H, JUDGE_N))
    seq = rng.integers(-2**31, 2**31, JUDGE_N)
    seq[-3:] = [0, 2**31 - 1, -1]
    return (now.astype(np.int64), src.astype(np.int32),
            dst.astype(np.int32), seq.astype(np.int32))


def _port_sim(name):
    source, overrides, is_file = _judge_source(name)
    cfg = (load_config(source, overrides) if is_file
           else load_config_str(source, overrides))
    return cfg, build(cfg)


def port_judge(name):
    """(batch, port judge_batch_plain's verdicts) of a JUDGE_CONFIGS
    config."""
    cfg, sim = _port_sim(name)
    judge = DeviceJudge(sim.topology, sim.host_vertex, cfg.general.seed,
                        bootstrap_end=cfg.general.bootstrap_end_time,
                        fault_table=sim.fault_table, device="cpu")
    starts = ([] if sim.fault_table is None
              else sim.fault_table.times.tolist())
    batch = judge_batch_of(name, len(sim.host_vertex), starts,
                           cfg.general.bootstrap_end_time)
    d, t = judge_batch_plain(judge.world, judge.boot_end,
                             *(torch.from_numpy(a) for a in batch))
    return cfg, sim, starts, batch, d.numpy(), t.numpy()


@pytest.mark.parametrize("name", list(JUDGE_CONFIGS))
def test_judge_batch_plain_equals_reference_netmodel(name):
    """judge_batch_plain, packet by packet, equals the reference's
    NetworkModel.judge on the same tables, fault epochs and bootstrap
    end."""
    from shadow_tpu.config import load_config as rload
    from shadow_tpu.config import load_config_str as rload_str
    from shadow_tpu.core.controller import build as rbuild

    cfg, sim, starts, batch, d, t = port_judge(name)
    if name.endswith("epochs"):
        assert len(starts) >= 6
    source, overrides, is_file = _judge_source(name)
    rsim = rbuild(rload(source, overrides) if is_file
                  else rload_str(source, overrides))
    nm = rsim.netmodel
    want = [nm.judge(int(a), int(b), int(c), int(s) & 0xFFFFFFFF)
            for a, b, c, s in zip(*batch)]
    np.testing.assert_array_equal(d, [v.delivered for v in want])
    np.testing.assert_array_equal(t, [v.deliver_time for v in want])
    # both sides of the bootstrap end, and drops after it
    boot = cfg.general.bootstrap_end_time
    assert (~d[batch[0] >= boot]).any()
    assert d[batch[0] < boot].all()


def test_judge_counts_batches_and_refuses_no_cuda():
    cfg, sim = _port_sim("dense")
    judge = DeviceJudge(sim.topology, sim.host_vertex, 7, device="cpu",
                        min_batch=5)
    batch = judge_batch_of("dense", len(sim.host_vertex), [], 0)
    judge.judge_batch(*(a[:10] for a in batch))
    judge.judge_batch(*(a[:7] for a in batch))
    c = judge.counters()
    assert (c["batches"], c["packets"], c["min_batch"]) == (2, 17, 5)
    if not torch.cuda.is_available():
        from shadow_tpu_torch.device.engine import NoCudaDevice

        with pytest.raises(NoCudaDevice):
            DeviceJudge(sim.topology, sim.host_vertex, 7)
        with pytest.raises(NoCudaDevice):
            Controller(_port_cfg("phold", [POLICY + "hybrid"]))


# ----------------------------------------------------------------------
# against the JAX package, in the child
# ----------------------------------------------------------------------
HIER_RUNS = {"shipped": [], "min_batch_0":
             ["experimental.hybrid_judge_min_batch=0"]}


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
        # the child imports this file, and with it the port
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
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


def _job() -> dict:
    batches = {}
    for name in JUDGE_CONFIGS:
        source, overrides, is_file = _judge_source(name)
        cfg, sim = _port_sim(name)
        starts = ([] if sim.fault_table is None
                  else sim.fault_table.times.tolist())
        batch = judge_batch_of(name, len(sim.host_vertex), starts,
                               cfg.general.bootstrap_end_time)
        batches[name] = {"source": source, "overrides": overrides,
                         "is_file": is_file,
                         "batch": [a.tolist() for a in batch]}
    return {"batches": batches,
            "hier": os.path.join(EXAMPLES, "tgen_faults_hier.yaml"),
            "runs": HIER_RUNS}


@pytest.fixture(scope="module", autouse=True)
def reference_child():
    with tempfile.TemporaryDirectory(prefix="torch_hybrid_ref_") as d:
        child = ReferenceChild(_job(), d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


@pytest.mark.parametrize("name", list(JUDGE_CONFIGS))
def test_judge_batch_plain_equals_jax_device_judge(name, reference):
    """judge_batch_plain equals the JAX DeviceJudge.judge_batch on the
    same seeded batch."""
    _, _, _, _, d, t = port_judge(name)
    np.testing.assert_array_equal(d, reference[f"judge/{name}/delivered"])
    np.testing.assert_array_equal(t, reference[f"judge/{name}/time"])


@pytest.mark.parametrize("run", list(HIER_RUNS))
def test_tpu_hybrid_run_equals_jax(run, reference):
    """examples/tgen_faults_hier.yaml under `tpu` (hybrid, host faults)
    equals the JAX package's run: per-host events and checksums, the
    totals and the judge's counters."""
    c = Controller(load_config(os.path.join(EXAMPLES,
                                            "tgen_faults_hier.yaml"),
                               [POLICY + "tpu", *HIER_RUNS[run]]),
                   device="cpu")
    s = c.run()
    assert s.policy == "hybrid"
    np.testing.assert_array_equal(s.host_events_executed,
                                  reference[f"run/{run}/events"])
    np.testing.assert_array_equal(s.host_trace_checksum,
                                  reference[f"run/{run}/chk"])
    np.testing.assert_array_equal(
        [s.events_executed, s.packets_sent, s.packets_dropped,
         s.packets_delivered, s.rounds], reference[f"run/{run}/totals"])
    j = s.judge
    np.testing.assert_array_equal(
        [j["batches"], j["packets"], j["cpu_batches"], j["cpu_packets"]],
        reference[f"run/{run}/judge"])
    assert j["batches"] > 0 if run == "min_batch_0" else \
        j["cpu_batches"] > 0


def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu.config import load_config as rload
    from shadow_tpu.config import load_config_str as rload_str
    from shadow_tpu.core.controller import Controller as RefController
    from shadow_tpu.core.controller import build as rbuild
    from shadow_tpu.device.judge import DeviceJudge as RefJudge

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    for name, b in job["batches"].items():
        cfg = (rload(b["source"], b["overrides"]) if b["is_file"]
               else rload_str(b["source"], b["overrides"]))
        sim = rbuild(cfg)
        judge = RefJudge(sim.topology, sim.netmodel.host_vertex,
                         cfg.general.seed,
                         bootstrap_end=cfg.general.bootstrap_end_time,
                         fault_table=sim.fault_table)
        now, src, dst, seq = (np.asarray(a) for a in b["batch"])
        d, t = judge.judge_batch(now.astype(np.int64), src.astype(np.int32),
                                 dst.astype(np.int32), seq.astype(np.int32))
        out[f"judge/{name}/delivered"] = np.asarray(d)
        out[f"judge/{name}/time"] = np.asarray(t)
    for run, overrides in job["runs"].items():
        c = RefController(rload(
            job["hier"], ["experimental.scheduler_policy=tpu", *overrides]))
        s = c.run()
        j = c.manager.net_judge
        out[f"run/{run}/events"] = np.array(
            [h.events_executed for h in c.sim.hosts], np.int64)
        out[f"run/{run}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], np.int64)
        out[f"run/{run}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds], np.int64)
        out[f"run/{run}/judge"] = np.array(
            [j.batches, j.packets, j.cpu_batches, j.cpu_packets], np.int64)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
