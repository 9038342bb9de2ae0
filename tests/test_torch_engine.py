"""The port's device engine (shadow_tpu_torch) against the reference:
window by window against the JAX engine's state, and whole PHOLD runs
against both the serial CPU oracle and the JAX `tpu` policy. Tolerance
everywhere is exact equality: the simulation is integer-exact.

The JAX engine runs in a child process (this file's __main__ branch):
the reference package does not import under the installed jax without
a patch to jax's batching registry, and that patch must never be
applied inside the pytest process, where it would leak into whichever
other test files share the worker. The serial oracle never imports the
JAX engine and runs here in the test process.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHOLD_YAML = """
general:
  stop_time: 2s
  seed: {seed}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss {loss} ]
        edge [ source 0 target 1 latency "10 ms" packet_loss {loss} ]
        edge [ source 1 target 1 latency "30 ms" packet_loss {loss} ]
      ]
experimental:
  scheduler_policy: {policy}
  event_capacity: 64
  outbox_capacity: 16
hosts:
  left:
    quantity: {q}
    network_node_id: 0
    processes:
    - path: model:phold
      args: msgload={msgload}
      start_time: 100ms
  right:
    quantity: {q}
    network_node_id: 1
    processes:
    - path: model:phold
      args: msgload={msgload}
      start_time: 150ms
"""

# runahead above the self-path latency: self packets deliver inside the
# window and must execute in-window, in timestamp order
SELFLOOP_YAML = """
general: {{stop_time: 1s, seed: 4}}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ] ]
experimental:
  scheduler_policy: {policy}
  runahead: 100 ms
hosts:
  peer:
    quantity: 4
    network_node_id: 0
    processes:
    - path: model:phold
      args: msgload=2 selfloop=1
      start_time: 5ms
"""

RUNS = {
    f"phold_loss{loss}_m{m}": PHOLD_YAML.replace(
        "{loss}", str(loss)).replace("{msgload}", str(m)).replace(
        "{seed}", "5").replace("{q}", "8")
    for loss, m in [(0.0, 2), (0.1, 2), (0.0, 1)]
}
RUNS["selfloop"] = SELFLOOP_YAML.replace("{{", "{").replace("}}", "}")
WINDOW_YAML = RUNS["phold_loss0.1_m2"]
N_WINDOWS = 4


def _policy(yaml: str, policy: str) -> str:
    return yaml.replace("{policy}", policy)


def run_reference_child(job: dict, workdir: str) -> dict:
    """Run `job` through this file's __main__ branch in a fresh
    interpreter; returns the arrays it saved."""
    job_path = os.path.join(workdir, "job.json")
    out_path = os.path.join(workdir, "out.npz")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SHADOW_TPU_AOT_DIR"] = os.path.join(workdir, "aot")
    # one device: the reference's single-shard program, like the port
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), job_path, out_path],
        cwd=workdir, env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reference():
    job = {"runs": {name: _policy(y, "tpu") for name, y in RUNS.items()},
           "window_yaml": _policy(WINDOW_YAML, "tpu"),
           "n_windows": N_WINDOWS}
    with tempfile.TemporaryDirectory(prefix="torch_ref_") as d:
        return run_reference_child(job, d)


def _port_run(yaml: str):
    from shadow_tpu_torch.config import load_config_str as port_load
    from shadow_tpu_torch.device import runner

    return runner.run(port_load(_policy(yaml, "tpu")), device="cpu")


def _serial_run(yaml: str):
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    c = Controller(load_config_str(_policy(yaml, "serial")))
    stats = c.run()
    return stats, c.sim.hosts


@pytest.mark.parametrize("name", list(RUNS))
def test_port_run_matches_serial_oracle_and_jax(reference, name):
    yaml = RUNS[name]
    port = _port_run(yaml)
    s_stats, s_hosts = _serial_run(yaml)
    assert port.ok
    totals = (port.events_executed, port.packets_sent,
              port.packets_dropped, port.packets_delivered, port.rounds)
    assert totals == (s_stats.events_executed, s_stats.packets_sent,
                      s_stats.packets_dropped, s_stats.packets_delivered,
                      s_stats.rounds)
    np.testing.assert_array_equal(
        port.host_events_executed,
        np.array([h.events_executed for h in s_hosts]))
    np.testing.assert_array_equal(
        port.host_trace_checksum,
        np.array([h.trace_checksum for h in s_hosts], dtype=np.int64))
    ref_totals = tuple(int(v) for v in reference[f"{name}/totals"])
    assert totals == ref_totals
    np.testing.assert_array_equal(port.host_events_executed,
                                  reference[f"{name}/events"])
    np.testing.assert_array_equal(port.host_trace_checksum,
                                  reference[f"{name}/chk"])


def test_port_windows_match_jax_state_leaf_by_leaf(reference):
    """From the JAX engine's init_state, each of the first windows of
    the port equals the reference's `_round_step` (judge at flush,
    window merge) on every state leaf."""
    from shadow_tpu_torch.config import load_config_str as port_load
    from shadow_tpu_torch.device.engine import state_from_numpy
    from shadow_tpu_torch.device.runner import make_engine

    engine, _ = make_engine(port_load(_policy(WINDOW_YAML, "tpu")),
                            device="cpu")
    keys = sorted({k.split("/")[1] for k in reference
                   if k.startswith("w0/")})
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


def _reference_main(job_path: str, out_path: str) -> None:
    """The child: apply the jax batching patch, then run the reference
    package's engines and save what the tests compare."""
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu._jax import jnp
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    for name, yaml in job["runs"].items():
        c = Controller(load_config_str(yaml))
        s = c.run()
        assert s.ok, name
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds], dtype=np.int64)
        out[f"{name}/events"] = np.array(
            [h.events_executed for h in c.sim.hosts], dtype=np.int64)
        out[f"{name}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], dtype=np.int64)

    # window by window, with the port's variants pinned: judge at
    # flush, window merge
    yaml = job["window_yaml"].replace(
        "experimental:", "experimental:\n  judge_placement: flush\n"
        "  merge_strategy: window")
    c = Controller(load_config_str(yaml))
    eng = c.runner.engine
    state = eng.init_state(c.sim.starts)
    world, hv = eng.world(), eng.host_vertex_device()
    stop = eng.config.stop_time

    def save(prefix, st):
        for k, v in st.items():
            out[f"{prefix}/{k}"] = np.asarray(v)

    save("w0", state)
    ht = np.asarray(state["ht"])
    nxt = int(ht[:, 0].min())
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
