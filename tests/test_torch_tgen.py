"""The port's tgen path (shadow_tpu_torch) against the reference: the
plain TgenDevice against the JAX TgenDevice on seeded inputs, the plain
pop window by window against the JAX engine's state at tgen shapes,
whole tgen runs against both the serial CPU oracle and the JAX `tpu`
policy, the route's order and overflow cut, and the build's refusals.
Tolerance everywhere is exact equality: the simulation is
integer-exact.

The JAX reference runs in a child process (this file's __main__
branch), one child for the whole file: the reference package does not
import under the installed jax without a patch to jax's batching
registry, and that patch must never be applied inside the pytest
process. The serial oracle never imports the JAX engine and runs here.
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

# tests/test_tgen_device.py's config
TGEN_YAML = """
general:
  stop_time: {stop}
  seed: {seed}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss {loss} ]
        edge [ source 0 target 1 latency "20 ms" packet_loss {loss} ]
        edge [ source 1 target 1 latency "10 ms" packet_loss {loss} ]
      ]
experimental:
  scheduler_policy: {{policy}}
  event_capacity: 192
  outbox_capacity: 256
hosts:
  server:
    network_node_id: 0
    processes:
    - path: model:tgen_server
      start_time: 10ms
  client:
    quantity: {clients}
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=server size={size} count={count} pause=200ms {extra}
      start_time: 100ms
"""


def tgen(loss=0.0, extra="", seed=1, clients=4, size="200KiB", count=2,
         stop="10s"):
    return TGEN_YAML.format(loss=loss, extra=extra, seed=seed,
                            clients=clients, size=size, count=count,
                            stop=stop)


# clients with different count/pause/retry (test_tgen_device.py's
# HET_YAML shape)
HET_YAML = """
general: {stop_time: 6s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.02 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.02 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.02 ] ]
experimental: {scheduler_policy: '{policy}', event_capacity: 192,
               outbox_capacity: 256}
hosts:
  server:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 10ms}]
  fast:
    quantity: 3
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=200KiB count=3 pause=100ms retry=300ms}
  slow:
    quantity: 3
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 200ms,
       args: server=server size=200KiB count=1 pause=900ms retry=800ms}
"""

# a server group of three (clients fan out by id % 3) and an exact-name
# server (a group of one is named after the group; a larger group's
# hosts are name0..name{n-1})
GROUP_YAML = """
general: {stop_time: 4s, seed: 9}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "5 ms" packet_loss 0.01 ]
        edge [ source 0 target 1 latency "15 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "5 ms" packet_loss 0.01 ] ]
experimental: {scheduler_policy: '{policy}', event_capacity: 64,
               outbox_capacity: 40}
hosts:
  farm:
    quantity: 3
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 5ms}]
  solo:
    network_node_id: 1
    processes: [{path: model:tgen_server, start_time: 5ms}]
  many:
    quantity: 7
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 50ms,
       args: server=farm size=100KiB count=3 pause=150ms retry=200ms}
  pinned:
    quantity: 3
    network_node_id: 0
    processes:
    - {path: model:tgen_client, start_time: 60ms,
       args: server=farm1 size=100KiB count=2 pause=100ms}
  one:
    network_node_id: 0
    processes:
    - {path: model:tgen_client, start_time: 70ms,
       args: server=solo size=100KiB count=2 pause=100ms}
"""


def _gml6():
    """examples/tgen_1000.yaml (the 6-city graph with per-edge loss, its
    E=IN=48 and outbox_capacity 40) cut to 2 servers per server group,
    5 clients per client group and 4 simulated seconds."""
    with open(os.path.join(ROOT, "examples", "tgen_1000.yaml")) as f:
        text = f.read()
    text = text.replace("scheduler_policy: tpu",
                        "scheduler_policy: '{policy}'")
    quantities = [f"hosts.server_{c}.quantity=2"
                  for c in ("nyc", "lon", "sin")]
    quantities += [f"hosts.client_{c}.quantity=5"
                   for c in ("nyc", "lon", "fra", "sfo", "sin", "syd")]
    return text, quantities + ["general.stop_time=4s"]


def _minimal():
    with open(os.path.join(ROOT, "examples", "minimal.yaml")) as f:
        text = f.read()
    return (text.replace("scheduler_policy: serial",
                         "scheduler_policy: '{policy}'"), [])


BURST = tgen(loss=0.15, extra="retry=150ms", seed=11, clients=6,
             size="300KiB", count=2, stop="6s")
RUNS = {
    "loss0": (tgen(loss=0.0), []),
    "loss0.02_retry500": (tgen(loss=0.02, extra="retry=500ms"), []),
    "loss0.25_retry120": (tgen(loss=0.25, extra="retry=120ms"), []),
    "het_args": (HET_YAML, []),
    "server_group": (GROUP_YAML, []),
    "burst1": (BURST, ["experimental.burst_pops=1"]),
    "burst8": (BURST, ["experimental.burst_pops=8"]),
    "gml6": _gml6(),
    "minimal": _minimal(),
}
# arrivals past a low IN: the run must fail loudly in both engines
OVERFLOW = (tgen(loss=0.02, extra="retry=300ms", clients=6, stop="2s"),
            ["experimental.exchange_in_capacity=2"])
# six clients boot together: the server answers their requests in one
# burst iteration; loss and retries bring trains and timers
WINDOW = (BURST, [])
N_WINDOWS = 8


def _cfg(text: str, policy: str):
    return text.replace("{policy}", policy)


# refusals: (name, yaml, overrides); the reference raises while it maps
# the config to its device twin
REFUSALS = {
    "size_differs": (HET_YAML, ["hosts.slow.processes=[{path: "
                                "model:tgen_client, args: 'server=server "
                                "size=100KiB count=1'}]"]),
    "unknown_server": (HET_YAML, ["hosts.fast.processes=[{path: "
                                  "model:tgen_client, args: 'server=nope "
                                  "size=200KiB'}]"]),
    "no_clients": (HET_YAML, ["hosts.fast.processes=[{path: "
                              "model:tgen_server}]",
                              "hosts.slow.processes=[{path: "
                              "model:tgen_server}]"]),
    "phold_mix": (HET_YAML, ["hosts.slow.processes=[{path: model:phold, "
                             "args: msgload=1}]"]),
}


# ----------------------------------------------------------------------
# seeded inputs of the app comparison (made here and in the child)
# ----------------------------------------------------------------------
APP_SIZE = 200 * 1024            # 141 packets: the last chunk is short
APP_H, APP_P = 512, 8


def app_inputs():
    from shadow_tpu_torch.core.tgen_args import (
        CHUNK_PKTS,
        TAG_DATA,
        TAG_REQ,
        n_packets,
    )

    rng = np.random.default_rng(20261017)
    H, P = APP_H, APP_P
    npkts = n_packets(APP_SIZE)
    roles = (rng.random(H) < 0.7).astype(np.int32)
    chunk_start = CHUNK_PKTS * rng.integers(0, (npkts + 31) // 32, H)
    odd = rng.random(H) < 0.1
    chunk_start[odd] = rng.integers(0, npkts, int(odd.sum()))
    gen = rng.integers(0, 50, H)
    state = np.stack([
        roles, rng.integers(0, H, H), chunk_start, rng.integers(0, 32, H),
        rng.integers(0, 5, H), gen,
        rng.integers(0, 2**32, H, dtype=np.uint64).astype(
            np.uint32).view(np.int32)], 1).astype(np.int32)
    count = rng.choice([0, 1, 3, 40], H).astype(np.int32)
    pause = rng.choice([0, 10**6, 5 * 10**8], H).astype(np.int64)
    retry = rng.choice([0, 10**6, 12 * 10**7], H).astype(np.int64)
    shape = (H, P)
    kind = rng.choice([-1, 0, 1, 2, 2, 2, 3], shape).astype(np.int32)
    d0 = np.where(rng.random(shape) < 0.5, TAG_REQ, TAG_DATA)
    d0 = np.where(rng.random(shape) < 0.05, 7, d0)
    timer_d0 = np.choose(rng.integers(0, 4, shape),
                         [np.full(shape, -1), np.broadcast_to(
                             gen[:, None], shape),
                          np.broadcast_to(gen[:, None] - 1, shape),
                          rng.integers(-3, 60, shape)])
    d0 = np.where(kind == 1, timer_d0, d0).astype(np.int32)
    shifts = np.array([-40, -32, -1, 0, 1, 31, 32, 40])
    d1 = chunk_start[:, None] + rng.choice(shifts, shape)
    d1 = np.where(rng.random(shape) < 0.3,
                  rng.choice(np.array([0, 32, npkts - 13, npkts - 1,
                                       npkts, npkts + 4, -5]), shape), d1)
    d2 = np.choose(rng.integers(0, 3, shape),
                   [np.zeros(shape, np.int64), np.full(shape, 2**32 - 1),
                    rng.integers(0, 2**32, shape)])
    return {
        "roles": roles, "server_gid": state[:, 1].copy(), "count": count,
        "pause": pause, "retry": retry, "state": state,
        "now": np.sort(rng.integers(0, 10**10, shape), 1),
        "kind": kind, "src": rng.integers(0, H, shape).astype(np.int32),
        "size": rng.integers(0, 1500, shape).astype(np.int32),
        "d0": d0, "d1": d1.astype(np.int64).astype(np.int32),
        "d2": d2.astype(np.uint32).view(np.int32)}


APP_FIELDS = ("send_dst", "send_size", "send_d0", "send_d1", "send_valid",
              "timer_delay", "timer_d0", "timer_valid", "n_draws",
              "app_state", "send_count")


# ----------------------------------------------------------------------
# the child and its fixture
# ----------------------------------------------------------------------
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
    job = {"runs": {k: (_cfg(t, "tpu"), ov) for k, (t, ov) in RUNS.items()},
           "overflow": (_cfg(OVERFLOW[0], "tpu"), OVERFLOW[1]),
           "window": (_cfg(WINDOW[0], "tpu"), WINDOW[1]),
           "n_windows": N_WINDOWS,
           "refusals": {k: (_cfg(t, "tpu"), ov)
                        for k, (t, ov) in REFUSALS.items()}}
    with tempfile.TemporaryDirectory(prefix="torch_tgen_ref_") as d:
        return run_reference_child(job, d)


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
    return stats, hosts, sum(getattr(h.app, "downloads_done", 0)
                             for h in hosts)


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
def test_tgen_app_plain_matches_jax_handle_and_burst(reference):
    from shadow_tpu_torch.device.apps import TgenDevice

    x = app_inputs()
    app = TgenDevice(roles=x["roles"], server_gid=x["server_gid"],
                     size=APP_SIZE, count=x["count"], pause_ns=x["pause"],
                     retry_ns=x["retry"])
    world = {k: torch.from_numpy(v.copy())
             for k, v in app.world_columns().items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    gid = torch.arange(APP_H, dtype=torch.int32)
    draws = torch.zeros((APP_H, 0), dtype=torch.int64)
    outs = {
        "handle": app.handle(gid, t["now"][:, 0], t["kind"][:, 0],
                             t["src"][:, 0], t["size"][:, 0], t["d0"][:, 0],
                             t["d1"][:, 0], t["d2"][:, 0], t["state"],
                             draws, world),
        "burst": app.handle_burst(gid, t["now"], t["kind"], t["src"],
                                  t["size"], t["d0"], t["d1"], t["d2"],
                                  t["state"], draws, world)}
    fired = outs["burst"]
    assert bool(fired.timer_valid.any()) and bool(fired.send_valid.any())
    assert bool(fired.send_valid[:, 1:].any())       # burst lanes answered
    for which, out in outs.items():
        for f in APP_FIELDS:
            got = getattr(out, f)
            np.testing.assert_array_equal(
                got.numpy(), reference[f"app/{which}/{f}"],
                err_msg=f"{which}: {f}")


@pytest.mark.parametrize("name", list(RUNS))
def test_port_tgen_run_matches_serial_oracle_and_jax(reference, name):
    text, overrides = RUNS[name]
    port = _port_run(text, overrides)
    s_stats, s_hosts, s_downloads = _serial_run(text, overrides)
    assert port.ok
    totals = (port.events_executed, port.packets_sent,
              port.packets_dropped, port.packets_delivered, port.rounds,
              port.downloads_completed)
    assert totals == (s_stats.events_executed, s_stats.packets_sent,
                      s_stats.packets_dropped, s_stats.packets_delivered,
                      s_stats.rounds, s_downloads)
    np.testing.assert_array_equal(
        port.host_events_executed,
        np.array([h.events_executed for h in s_hosts]))
    np.testing.assert_array_equal(
        port.host_trace_checksum,
        np.array([h.trace_checksum for h in s_hosts], dtype=np.int64))
    assert totals == tuple(int(v) for v in reference[f"{name}/totals"])
    np.testing.assert_array_equal(port.host_events_executed,
                                  reference[f"{name}/events"])
    np.testing.assert_array_equal(port.host_trace_checksum,
                                  reference[f"{name}/chk"])


def test_burst_width_leaves_the_trace_unchanged():
    """Burst width only moves phase boundaries: the per-host pop order
    is (t, src, seq) at any width."""
    one = _port_run(*RUNS["burst1"])
    eight = _port_run(*RUNS["burst8"])
    np.testing.assert_array_equal(one.host_trace_checksum,
                                  eight.host_trace_checksum)
    assert one.events_executed == eight.events_executed


def test_port_tgen_windows_match_jax_state_leaf_by_leaf(reference):
    """From the JAX engine's init_state, each of the first windows of a
    lossy tgen run with retries (server bursts, trains, timers) equals
    the reference's `_round_step` on every state leaf, occupancy marks
    (occ_trips counts loop iterations) and app words included."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.engine import state_from_numpy
    from shadow_tpu_torch.device.runner import make_engine

    engine, _ = make_engine(load_config_str(_cfg(WINDOW[0], "tpu"),
                                            WINDOW[1]), device="cpu")
    assert engine.params.P == 8 and engine.params.T == 1
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
    # the server popped its boot and the six requests
    assert int(state["n_exec"][0]) >= 7


def test_route_orders_live_rows_by_destination_then_flat_index():
    from shadow_tpu_torch.device.kernels import DROP_T, INF, route_plain

    rng = np.random.default_rng(3)
    H, OB = 40, 9
    t = np.where(rng.random((H, OB)) < 0.4,
                 rng.integers(0, 10**9, (H, OB)), INF)
    t[rng.random((H, OB)) < 0.05] = DROP_T
    dst = np.where(rng.random((H, OB)) < 0.3, 5, rng.integers(0, H, (H, OB)))
    ob = {"t": torch.from_numpy(t.astype(np.int64)),
          "m": torch.from_numpy((dst.astype(np.int64) << 32) | 2)}
    perm, starts, counts = route_plain(ob)
    live = np.flatnonzero(t.reshape(-1) < DROP_T)
    order = live[np.lexsort((live, dst.reshape(-1)[live]))]
    L = len(live)
    np.testing.assert_array_equal(perm[:L].numpy(), order)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(dst.reshape(-1)[live], minlength=H))
    np.testing.assert_array_equal(
        starts.numpy(), np.concatenate([[0], np.cumsum(counts.numpy())[:-1]]))
    assert int(counts[5]) > OB                  # one hot destination


def test_arrivals_past_in_cut_the_same_rows_as_jax(reference):
    """A destination with more than IN arrivals in a flush: the port
    cuts the same rows (the route's (src, column) order decides which)
    and counts the same overflow per host, and fails loudly, as the
    reference does."""
    port = _port_run(*OVERFLOW)
    assert not port.ok and port.overflow > 0
    assert not bool(reference["overflow/ok"])
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.device.runner import make_engine

    engine, sim = make_engine(load_config_str(_cfg(OVERFLOW[0], "tpu"),
                                              OVERFLOW[1]), device="cpu")
    state, rounds = engine.run(engine.init_state(sim.start_times,
                                                 sim.stop_times))
    final = state_to_numpy(state, ("overflow", "n_exec", "chk"))
    np.testing.assert_array_equal(final["overflow"],
                                  reference["overflow/overflow"])
    np.testing.assert_array_equal(final["n_exec"],
                                  reference["overflow/events"])
    np.testing.assert_array_equal(final["chk"], reference["overflow/chk"])
    assert int(final["overflow"].sum()) == port.overflow


PHOLD_MASK = """
general: {stop_time: 400ms, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ] ]
experimental: {scheduler_policy: tpu}
hosts:
  a:
    quantity: 6
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 10ms}]
"""


@pytest.mark.parametrize("text", [BURST, PHOLD_MASK], ids=["tgen", "phold"])
def test_phold_and_tgen_send_rows_keep_an_all_ones_live_mask(text):
    """PHOLD and tgen give no send mask: every send row's outbox `v` hi
    word is 0xFFFFFFFF (all lanes live), as before Tor's masked trains
    shared the send path."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.runner import make_engine

    his = []

    class Recording(K.Kernels):
        def pop(self, state, ob, pops, world, win_end, p, outside=None):
            super().pop(state, ob, pops, world, win_end, p, outside)
            send = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
            his.append((ob["v"][send] >> 32) & K.U32)

    engine, sim = make_engine(load_config_str(_cfg(text, "tpu")),
                              device="cpu", kernels=Recording())
    engine.run(engine.init_state(sim.start_times, sim.stop_times))
    hi = torch.cat(his)
    assert hi.numel() > 0
    assert bool((hi == 0xFFFFFFFF).all())


def test_tgen_wrappers_take_the_plain_path_on_cpu_and_count_nothing():
    """On CPU tensors the pop (K4's wrapper) and the route (K5's) run
    their plain versions: nothing is built, launched or timed."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.kernels import DROP_T, KERNEL_NAMES, Kernels
    from shadow_tpu_torch.device.runner import make_engine

    kernels = Kernels(timing=True)
    engine, sim = make_engine(load_config_str(_cfg(BURST, "tpu")),
                              device="cpu", kernels=kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    ob, pops = engine._outbox()
    win_end = engine.next_time(state) + engine.config.lookahead
    kernels.pop(state, ob, pops, engine.world, win_end, engine.params)
    assert int(pops.sum()) > 0
    perm, starts, counts = kernels.route(ob)
    assert int(counts.sum()) == int((ob["t"] < DROP_T).sum())
    engine.run(state)
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)
    assert not any(kernels._events.values())
    assert kernels._lib is None


@pytest.mark.parametrize("name", list(REFUSALS))
def test_build_refuses_what_the_reference_refuses(reference, name):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    text, overrides = REFUSALS[name]
    ref = str(reference[f"refusal/{name}"])
    if name == "phold_mix":
        # the reference runs a mix on its hybrid policy, and so does the
        # port: its build finds no twin and says why, in the reference's
        # words (core/controller.py then runs the hybrid policy)
        sim = build(load_config_str(_cfg(text, "tpu"), overrides))
        assert ref.startswith("no device twin registered for")
        assert sim.app is None and sim.no_twin == ref
        return
    with pytest.raises(ValueError) as e:
        build(load_config_str(_cfg(text, "tpu"), overrides))
    assert str(e.value) == ref


# ----------------------------------------------------------------------
# the child: the JAX reference
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    """Apply the jax batching patch, then run the reference package and
    save what the tests compare."""
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu._jax import jnp
    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller, build
    from shadow_tpu.device.apps import TgenDevice
    from shadow_tpu.device.runner import device_twin

    with open(job_path) as f:
        job = json.load(f)
    out = {}

    # the app on the seeded inputs
    x = app_inputs()
    app = TgenDevice(roles=x["roles"], server_gid=x["server_gid"],
                     size=APP_SIZE, count=x["count"], pause_ns=x["pause"],
                     retry_ns=x["retry"])
    j = {k: jnp.asarray(v) for k, v in x.items()}
    gid = jnp.arange(APP_H, dtype=jnp.int32)
    draws = jnp.zeros((APP_H, 1), jnp.uint32)
    res = {"handle": app.handle(gid, j["now"][:, 0], j["kind"][:, 0],
                                j["src"][:, 0], j["size"][:, 0],
                                j["d0"][:, 0], j["d1"][:, 0],
                                j["d2"][:, 0], j["state"], draws),
           "burst": app.handle_burst(gid, j["now"], j["kind"], j["src"],
                                     j["size"], j["d0"], j["d1"], j["d2"],
                                     j["state"], draws)}
    for which, r in res.items():
        for f in APP_FIELDS:
            out[f"app/{which}/{f}"] = np.asarray(getattr(r, f))

    def run(text, overrides):
        c = Controller(load_config_str(text, overrides))
        s = c.run()
        H = len(c.sim.hosts)
        final = c.runner.final_state
        return c, s, H, final

    for name, (text, overrides) in job["runs"].items():
        c, s, H, final = run(text, overrides)
        assert s.ok, name
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds,
             int(np.asarray(final["app"])[:H, 4].sum())], dtype=np.int64)
        out[f"{name}/events"] = np.array(
            [h.events_executed for h in c.sim.hosts], dtype=np.int64)
        out[f"{name}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], dtype=np.int64)

    c, s, H, final = run(*job["overflow"])
    out["overflow/ok"] = np.bool_(s.ok)
    out["overflow/overflow"] = np.asarray(final["overflow"])[:H]
    out["overflow/events"] = np.asarray(final["n_exec"])[:H]
    out["overflow/chk"] = np.asarray(final["chk"])[:H]

    for name, (text, overrides) in job["refusals"].items():
        try:
            device_twin(build(load_config_str(text, overrides)))
        except Exception as e:      # noqa: BLE001 — the message is kept
            out[f"refusal/{name}"] = np.str_(str(e))
        else:
            raise AssertionError(f"the reference accepted {name}")

    # window by window, with the port's variants pinned: judge at
    # flush, window merge
    text, overrides = job["window"]
    text = text.replace("experimental:", "experimental:\n"
                        "  judge_placement: flush\n"
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
