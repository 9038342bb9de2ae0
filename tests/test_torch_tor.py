"""The port's Tor path (shadow_tpu_torch) against the reference: the plain
TorDevice against the JAX TorDevice on seeded inputs that hit every relay
branch, the port's route rule against the reference's `pick_route`, the
plain pop window by window against the JAX engine's state at Tor shapes,
whole Tor runs against both the serial CPU oracle and the JAX `tpu`
policy, and the build's refusals. Tolerance everywhere is exact
equality: the simulation is integer-exact.

The survivor masks that trains carry between hops are held three ways:
the app's `send_mask` equals the JAX app's, the plain pop writes it as
the hi word of the outbox `v` field, and the judged survivors it leads
to (the heap's `hw` words, `n_sent`, `n_drop`) equal the JAX engine's
leaf by leaf.

The JAX reference runs in a child process (this file's __main__
branch), one child for the whole file: the reference package does not
import under the installed jax without a patch to jax's batching
registry, and that patch must never be applied inside the pytest
process. The serial oracle never imports the JAX engine and runs here.

Run lengths are cut to keep the file near two minutes on a CPU: the
configs of tests/test_tor.py run 8 simulated seconds (not 20), and
examples/tor_small.yaml runs 6 s (not 60), past its 5 s bootstrap so
that drops roll.
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

# tests/test_tor.py's config
TOR_YAML = """
general:
  stop_time: {stop}
  seed: {seed}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss {loss} ]
        edge [ source 0 target 1 latency "40 ms" packet_loss {loss} ]
        edge [ source 1 target 1 latency "20 ms" packet_loss {loss} ]
      ]
experimental:
  scheduler_policy: {{policy}}
  event_capacity: 96
  outbox_capacity: 48
hosts:
  relay:
    quantity: {relays}
    network_node_id: 0
    processes: [{{path: model:tor_relay, start_time: 100ms}}]
  client:
    quantity: {clients}
    network_node_id: 1
    processes:
    - {{path: model:tor_client, args: cells={cells} count=2 pause=500ms{retry}, start_time: 1s}}
"""


def tor(seed=1, loss=0.0, relays=8, clients=16, cells=48, stop="8s",
        retry=""):
    return TOR_YAML.format(seed=seed, loss=loss, relays=relays,
                           clients=clients, cells=cells, stop=stop,
                           retry=retry)


# the reference's on-chip strategy stack (tests/test_tor.py TPU_STACK):
# validated and ignored by the port
TPU_STACK = ("experimental:\n  judge_placement: flush\n"
             "  merge_strategy: global\n  pop_strategy: onehot")

# tests/test_tor.py's heterogeneous client args
HET_YAML = tor(seed=5, loss=0.02, clients=8, retry=" retry=400ms") + """\
  client_slow:
    quantity: 8
    network_node_id: 0
    processes:
    - {path: model:tor_client, args: cells=48 count=1 pause=2s retry=900ms, start_time: 2s}
"""

# few relays carry many circuits (burst runs); cells=40 ends every
# download with a partial chunk of 8 cells; loss and retries bring holed
# masks, stale and current retry timers
BURST = tor(seed=7, loss=0.05, relays=5, clients=14, cells=40,
            retry=" retry=1s")


def _tor_small():
    with open(os.path.join(ROOT, "examples", "tor_small.yaml")) as f:
        text = f.read()
    return (text.replace("scheduler_policy: tpu",
                         "scheduler_policy: '{policy}'"),
            ["general.stop_time=6s"])


# whole runs held to the serial oracle and the JAX `tpu` policy
RUNS = {
    "lossless": (tor(), []),
    "lossy_retry": (tor(loss=0.05, retry=" retry=2s"), []),
    "lossy_tpu_stack": (tor(loss=0.05, retry=" retry=2s").replace(
        "experimental:", TPU_STACK), []),
    "het_args": (HET_YAML, []),
    "tor_small": _tor_small(),
}
# held to the serial oracle only (each JAX run costs a compile of about
# 15 s here); the JAX engine's windows of BURST are held leaf by leaf
ORACLE_RUNS = {
    "burst1": (BURST, ["experimental.burst_pops=1"]),
    "burst8": (BURST, ["experimental.burst_pops=8"]),
}
WINDOW = (BURST, [])
N_WINDOWS = 10


def _cfg(text: str, policy: str):
    return text.replace("{policy}", policy)


# refusals: (yaml, overrides); the reference raises while it maps the
# config to its device twin
REFUSALS = {
    "no_clients": (tor(), ["hosts.client.processes=[{path: "
                           "model:tor_relay}]"]),
    "two_relays": (tor(relays=2), []),
    "cells_differ": (HET_YAML, ["hosts.client_slow.processes=[{path: "
                                "model:tor_client, args: 'cells=32'}]"]),
    "tgen_mix": (tor(), ["hosts.client.processes=[{path: "
                         "model:tgen_client, args: 'server=relay0'}]"]),
}


# ----------------------------------------------------------------------
# seeded inputs of the app comparison (made here and in the child)
# ----------------------------------------------------------------------
APP_H, APP_P, APP_CELLS, APP_SEED = 512, 8, 200, 11


def route_of(circ: np.ndarray, relay_gids: np.ndarray, seed: int):
    """[N,3] (guard, middle, exit) ids of circuits `circ`, from the
    port's counter RNG and its `pick_route` (both held to the reference
    by the tests below)."""
    from shadow_tpu_torch.core.tor_args import pick_route
    from shadow_tpu_torch.device import prng
    from shadow_tpu_torch.utils.rng import PURPOSE_TOR_ROUTE

    c = torch.from_numpy(np.asarray(circ, np.int64))
    bits = [prng.random_bits32(prng.chain_key(
        prng.seed_key(seed), PURPOSE_TOR_ROUTE, c, j)).numpy()
        for j in range(3)]
    idx = [pick_route(tuple(int(b[i]) for b in bits), len(relay_gids))
           for i in range(len(c))]
    return relay_gids[np.array(idx, np.int64).reshape(-1, 3)]


def app_inputs():
    """Relays get packets of circuits they sit on (as guard, middle or
    exit) and of others; REQs for every chunk start incl. the tail and
    past the end; DATA trains with full, holed and empty masks; clients
    get DATA trains shifted around their window (past +-32 too),
    pause timers and current and stale retry timers."""
    from shadow_tpu_torch.core.tor_args import (
        CHUNK_CELLS,
        SEQ_BITS,
        TAG_TOR_DATA,
        TAG_TOR_REQ,
    )

    rng = np.random.default_rng(20261018)
    H, P = APP_H, APP_P
    roles = (rng.random(H) < 0.6).astype(np.int32)
    relay_gids = np.flatnonzero(roles == 0).astype(np.int64)
    circs = np.arange(H)
    routes = route_of(circs, relay_gids, APP_SEED)
    shape = (H, P)
    # a circuit each relay sits on, at a random hop, where one exists
    circ = rng.integers(0, H, shape)
    for h in relay_gids:
        on = np.flatnonzero((routes == h).any(1))
        if on.size:
            pick = rng.random(P) < 0.8
            circ[h, pick] = rng.choice(on, int(pick.sum()))
    circ = np.where(rng.random(shape) < 0.03,
                    rng.integers(-2**19, 2**19, shape), circ)
    starts = np.array([0, 16, 32, 176, 192, APP_CELLS - 1, APP_CELLS,
                       APP_CELLS + 5, 4095])
    chunk_start = CHUNK_CELLS * rng.integers(0, 13, H)
    gen = rng.integers(0, 50, H)
    state = np.stack([
        roles, chunk_start, rng.integers(0, 16, H), rng.integers(0, 4, H),
        gen, rng.integers(0, 2**16, H)], 1).astype(np.int32)
    state[roles == 0, 1:] = 0
    kind = rng.choice([-1, 0, 1, 2, 2, 2, 2, 3], shape).astype(np.int32)
    d0 = np.where(rng.random(shape) < 0.5, TAG_TOR_REQ, TAG_TOR_DATA)
    d0 = np.where(rng.random(shape) < 0.05, 2, d0)
    timer_d0 = np.choose(rng.integers(0, 4, shape),
                         [np.full(shape, -1), np.broadcast_to(
                             gen[:, None], shape),
                          np.broadcast_to(gen[:, None] - 1, shape),
                          rng.integers(-3, 60, shape)])
    d0 = np.where(kind == 1, timer_d0, d0).astype(np.int32)
    client = (roles == 1)[:, None]
    shifts = np.array([-40, -32, -17, -1, 0, 1, 15, 16, 31, 32, 40])
    start = np.where(client, np.clip(chunk_start[:, None] + rng.choice(
        shifts, shape), 0, 4095), rng.choice(starts, shape))
    d1 = (circ.astype(np.int64) << SEQ_BITS) | start
    d2 = np.choose(rng.integers(0, 4, shape),
                   [np.zeros(shape, np.int64), np.full(shape, 2**32 - 1),
                    rng.integers(0, 2**16, shape),
                    rng.integers(0, 2**32, shape)])
    count = rng.choice([0, 1, 3], H).astype(np.int32)
    return {
        "roles": roles, "relay_gids": relay_gids, "state": state,
        "count": count,
        "pause": rng.choice([0, 10**6, 5 * 10**8], H).astype(np.int64),
        "retry": rng.choice([0, 10**6, 12 * 10**7], H).astype(np.int64),
        "now": np.sort(rng.integers(0, 10**10, shape), 1),
        "kind": kind, "src": rng.integers(0, H, shape).astype(np.int32),
        "size": rng.integers(0, 1500, shape).astype(np.int32),
        "d0": d0, "d1": d1.astype(np.int32),
        "d2": d2.astype(np.uint32).view(np.int32)}


APP_FIELDS = ("send_dst", "send_size", "send_d0", "send_d1", "send_valid",
              "timer_delay", "timer_d0", "timer_valid", "n_draws",
              "app_state", "send_count", "send_mask")
ROUTE_IDS = np.concatenate([np.arange(64), [2**19 - 1, 2**31 - 1],
                            np.arange(-3, 0)]).astype(np.int64)


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
           "n_windows": N_WINDOWS,
           "refusals": {k: (_cfg(t, "tpu"), ov)
                        for k, (t, ov) in REFUSALS.items()}}
    with tempfile.TemporaryDirectory(prefix="torch_tor_ref_") as d:
        child = ReferenceChild(job, d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


@pytest.fixture(scope="module")
def local_runs():
    """Every run of RUNS and ORACLE_RUNS on the port's plain path and on
    the serial oracle: (port stats, (oracle stats, hosts, downloads))."""
    return {name: (_port_run(*run), _serial_run(*run))
            for name, run in {**RUNS, **ORACLE_RUNS}.items()}


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


def _port_app(x):
    from shadow_tpu_torch.device.apps import TorDevice

    app = TorDevice(roles=x["roles"], relay_gids=x["relay_gids"],
                    seed=APP_SEED, cells=APP_CELLS, count=x["count"],
                    pause_ns=x["pause"], retry_ns=x["retry"])
    world = {k: torch.from_numpy(v.copy())
             for k, v in app.world_columns().items()}
    return app, world


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
def test_pick_route_matches_the_reference():
    from shadow_tpu.models.tor import pick_route as ref_pick_route

    from shadow_tpu_torch.core.tor_args import pick_route

    rng = np.random.default_rng(5)
    for _ in range(500):
        bits = tuple(int(b) for b in rng.integers(0, 2**32, 3))
        for r in (3, 4, 7, 50, 5600):
            assert pick_route(bits, r) == ref_pick_route(bits, r)


def test_plain_pop_writes_the_send_mask_as_the_v_hi_word():
    """The outbox `v` hi word of a Tor send row is the app's live-lane
    mask: 1 for a REQ, the low `cnt` bits for an exit's chunk, the
    survivors for a forwarded train."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.runner import make_engine

    masks = set()

    class Recording(K.Kernels):
        def pop(self, state, ob, pops, world, win_end, p, outside=None):
            super().pop(state, ob, pops, world, win_end, p, outside)
            send = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
            cnt = (ob["m"] & K.U32) >> 8
            hi = (ob["v"] >> 32) & K.U32
            masks.update(zip(cnt[send].tolist(), hi[send].tolist()))

    engine, sim = make_engine(load_config_str(_cfg(BURST, "tpu")),
                              device="cpu", kernels=Recording())
    engine.run(engine.init_state(sim.start_times, sim.stop_times))
    assert (1, 1) in masks                       # REQs
    assert (16, 0xFFFF) in masks                 # a full exit chunk
    assert (16, 0xFF) in masks                   # the 8-cell tail chunk
    assert any(c == 16 and m not in (0xFF, 0xFFFF) for c, m in masks)
    assert all(m != 0 and m <= 0xFFFF for _, m in masks)


def test_tor_wrapper_takes_the_plain_path_on_cpu_and_counts_nothing():
    """On CPU tensors the pop (K6's wrapper) runs the plain version:
    nothing is built, launched or timed."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.kernels import KERNEL_NAMES, Kernels
    from shadow_tpu_torch.device.runner import make_engine

    kernels = Kernels(timing=True)
    engine, sim = make_engine(load_config_str(_cfg(BURST, "tpu")),
                              device="cpu", kernels=kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    ob, pops = engine._outbox()
    win_end = engine.next_time(state) + engine.config.lookahead
    kernels.pop(state, ob, pops, engine.world, win_end, engine.params)
    assert int(pops.sum()) > 0
    engine.run(state)
    assert "pop_tor" in KERNEL_NAMES
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)
    assert not any(kernels._events.values())
    assert kernels._lib is None


def test_build_matches_the_reference_object_layout():
    """Host ids in group order, relays listed in id order, per-host
    client args, start times and vertices as the reference's object
    build gives them."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    sim = build(load_config_str(_cfg(HET_YAML, "tpu")))
    app = sim.app
    np.testing.assert_array_equal(app.relay_gids, np.arange(8))
    np.testing.assert_array_equal(app.roles, [0] * 8 + [1] * 16)
    np.testing.assert_array_equal(app.count, [0] * 8 + [2] * 8 + [1] * 8)
    np.testing.assert_array_equal(
        app.retry_ns, [0] * 8 + [4 * 10**8] * 8 + [9 * 10**8] * 8)
    np.testing.assert_array_equal(
        sim.start_times, [10**8] * 8 + [10**9] * 8 + [2 * 10**9] * 8)
    np.testing.assert_array_equal(sim.host_vertex,
                                  [0] * 8 + [1] * 8 + [0] * 8)
    assert app.cells == 48 and sim.lookahead == 2 * 10**7


def _matches_oracle(port, oracle):
    s_stats, s_hosts, s_downloads = oracle
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
    return totals


def test_burst_width_leaves_the_tor_trace_unchanged(local_runs):
    """Burst width only moves phase boundaries: the per-host pop order
    is (t, src, seq) at any width; both widths equal the oracle."""
    one, eight = local_runs["burst1"][0], local_runs["burst8"][0]
    for name in ORACLE_RUNS:
        _matches_oracle(*local_runs[name])
    np.testing.assert_array_equal(one.host_trace_checksum,
                                  eight.host_trace_checksum)
    assert one.events_executed == eight.events_executed
    assert one.packets_dropped > 0


def test_tor_downloads_are_the_clients_word_3(local_runs):
    """downloads_completed counts the Tor clients' `done` word (app
    word 3), which equals the serial oracle's downloads_done sum; word
    4, which tgen counts, is the Tor clients' request generation."""
    port, (_, _, s_downloads) = local_runs["het_args"]
    assert port.downloads_completed == s_downloads > 0
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.device.runner import make_engine

    engine, sim = make_engine(load_config_str(_cfg(HET_YAML, "tpu")),
                              device="cpu")
    state, _ = engine.run(engine.init_state(sim.start_times,
                                            sim.stop_times))
    app = state_to_numpy(state, ["app"])["app"]
    assert engine.app.downloads(app) == s_downloads
    assert int(app[:, 4].sum()) != s_downloads


def test_tor_app_plain_matches_jax_route_handle_and_burst(reference):
    x = app_inputs()
    app, world = _port_app(x)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    gid = torch.arange(APP_H, dtype=torch.int32)
    draws = torch.zeros((APP_H, 0), dtype=torch.int64)
    circ = torch.from_numpy(ROUTE_IDS.astype(np.int32))
    for hop, got in zip("gme", app.route(circ, world)):
        np.testing.assert_array_equal(got.numpy(),
                                      reference[f"route/{hop}"])
    np.testing.assert_array_equal(app.guard(circ, world).numpy(),
                                  reference["route/g"])
    outs = {
        "handle": app.handle(gid, t["now"][:, 0], t["kind"][:, 0],
                             t["src"][:, 0], t["size"][:, 0], t["d0"][:, 0],
                             t["d1"][:, 0], t["d2"][:, 0], t["state"],
                             draws, world),
        "burst": app.handle_burst(gid, t["now"], t["kind"], t["src"],
                                  t["size"], t["d0"], t["d1"], t["d2"],
                                  t["state"], draws, world)}
    # every relay branch fired, with partial and holed masks
    from shadow_tpu_torch.core.tor_args import CHUNK_CELLS, TAG_TOR_DATA

    b = outs["burst"]
    relay = (t["state"][:, 0] == 0)[:, None].expand_as(b.send_valid)
    d1 = t["d1"]
    G, M, E = app.route(d1 >> 12, world)
    me = gid[:, None].expand_as(d1)
    pkt = (t["kind"] == 2) & relay & b.send_valid
    req, data = pkt & (t["d0"] == 3), pkt & (t["d0"] == TAG_TOR_DATA)
    for name, hit in (("fwd_req_g", req & (me == G)),
                      ("fwd_req_m", req & (me == M)),
                      ("serve", req & (me == E)),
                      ("fwd_data_m", data & (me == M)),
                      ("fwd_data_g", data & (me == G))):
        assert bool(hit.any()), name
    full = (1 << CHUNK_CELLS) - 1
    served = req & (me == E)
    assert bool((served & (b.send_mask < full)).any())     # tail chunk
    fwd = data & ((me == M) | (me == G))
    assert bool((fwd & (b.send_mask != full) & (b.send_mask != -1)).any())
    assert bool(b.timer_valid.any()) and bool(b.send_valid[:, 1:].any())
    for which, out in outs.items():
        for f in APP_FIELDS:
            np.testing.assert_array_equal(
                getattr(out, f).numpy(), reference[f"app/{which}/{f}"],
                err_msg=f"{which}: {f}")


@pytest.mark.parametrize("name", list(RUNS))
def test_port_tor_run_matches_serial_oracle_and_jax(local_runs, reference,
                                                    name):
    port, oracle = local_runs[name]
    totals = _matches_oracle(port, oracle)
    assert totals == tuple(int(v) for v in reference[f"{name}/totals"])
    np.testing.assert_array_equal(port.host_events_executed,
                                  reference[f"{name}/events"])
    np.testing.assert_array_equal(port.host_trace_checksum,
                                  reference[f"{name}/chk"])
    if name == "lossless":
        assert port.downloads_completed == 2 * 16
    else:
        assert port.packets_dropped > 0
    if name == "tor_small":
        assert port.downloads_completed > 0


def test_port_tor_windows_match_jax_state_leaf_by_leaf(reference):
    """From the JAX engine's init_state, each of the first windows of a
    lossy Tor run with retries (relay bursts, holed trains, timers)
    equals the reference's `_round_step` on every state leaf, the heap's
    survivor words included."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device.engine import state_from_numpy
    from shadow_tpu_torch.device.runner import make_engine

    engine, _ = make_engine(load_config_str(_cfg(WINDOW[0], "tpu"),
                                            WINDOW[1]), device="cpu")
    p = engine.params
    assert (p.P, p.T, p.C, p.B) == (8, 1, 16, 5)
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
    assert int(state["n_deliv"].sum()) > 0


@pytest.mark.parametrize("name", list(REFUSALS))
def test_build_refuses_what_the_reference_refuses(reference, name):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build

    text, overrides = REFUSALS[name]
    ref = str(reference[f"refusal/{name}"])
    if name == "tgen_mix":
        # the reference runs a mix on its hybrid policy, and so does the
        # port: its build finds no twin and says why, in the reference's
        # words (core/controller.py then runs the hybrid policy)
        sim = build(load_config_str(_cfg(text, "tpu"), overrides))
        assert ref.startswith("no device twin registered for")
        assert "tor (relay+client)" in ref
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
    from shadow_tpu.device.apps import TorDevice
    from shadow_tpu.device.runner import device_twin

    with open(job_path) as f:
        job = json.load(f)
    out = {}

    # the app on the seeded inputs
    x = app_inputs()
    app = TorDevice(roles=x["roles"], relay_gids=x["relay_gids"],
                    seed=APP_SEED, cells=APP_CELLS, count=x["count"],
                    pause_ns=x["pause"], retry_ns=x["retry"])
    for hop, ids in zip("gme", app._route(jnp.asarray(
            ROUTE_IDS.astype(np.int32)))):
        out[f"route/{hop}"] = np.asarray(ids)
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

    for name, (text, overrides) in job["runs"].items():
        c = Controller(load_config_str(text, overrides))
        s = c.run()
        assert s.ok, name
        H = len(c.sim.hosts)
        app_words = np.asarray(c.runner.final_state["app"])[:H]
        out[f"{name}/totals"] = np.array(
            [s.events_executed, s.packets_sent, s.packets_dropped,
             s.packets_delivered, s.rounds,
             int(app_words[app_words[:, 0] == 1, 3].sum())],
            dtype=np.int64)
        out[f"{name}/events"] = np.array(
            [h.events_executed for h in c.sim.hosts], dtype=np.int64)
        out[f"{name}/chk"] = np.array(
            [h.trace_checksum for h in c.sim.hosts], dtype=np.int64)

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
