"""The port's window loop as slots (DeviceEngine.run_slots: a phase, K9
loop_control and, under the audit, K8 audit_round per slot, the control
block deciding on the device) against its Python loop (run_python) and
the reference's `run(state, stop, final_stop)`. On the CPU the slots run
eagerly on the plain versions, so these tests hold the schedule that the
card captures into a CUDA graph. Tolerance everywhere is exact
equality.

The JAX engine runs in a child process (this file's __main__ branch),
which applies the jax batching patch the reference needs; the patch
never runs in the pytest process.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_torch_audit import AUDIT, CONFIGS, text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOOP_CONFIGS = ("phold", "tgen", "tor", "nic", "faults")
SLOTS = (1, 3, 64)
# the paused runs: (config, pause, stop)
PAUSED = {"phold": (700_000_000, 2_000_000_000),
          "tgen": (1_250_000_000, 3_000_000_000)}
MAX_ROUNDS = 7


def _engine(name: str, audit: bool):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    return runner.make_engine(
        load_config_str(text(name), AUDIT if audit else []), device="cpu")


def _fresh(engine, sim) -> dict:
    return engine.init_state(sim.start_times, sim.stop_times)


def _same_state(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(),
                                      err_msg=f"{what}: leaf {k}")


@pytest.fixture(scope="module")
def python_runs():
    """The Python loop's final state, rounds and phases per (config,
    audit), computed once."""
    cache = {}

    def get(name, audit):
        if (name, audit) not in cache:
            engine, sim = _engine(name, audit)
            state, rounds = engine.run_python(_fresh(engine, sim))
            cache[name, audit] = (state, rounds,
                                  engine.loop_stats["phases"])
        return cache[name, audit]

    return get


# ----------------------------------------------------------------------
# the child and its fixture
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    job = {"paused": {name: text(name) for name in PAUSED},
           "max_rounds": text("phold")}
    with tempfile.TemporaryDirectory(prefix="torch_loop_ref_") as d:
        job_path = os.path.join(d, "job.json")
        out_path = os.path.join(d, "out.npz")
        with open(job_path, "w") as f:
            json.dump(job, f)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["SHADOW_TPU_AOT_DIR"] = os.path.join(d, "aot")
        env["XLA_FLAGS"] = " ".join(
            f for f in env.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), job_path,
             out_path], cwd=d, env=env, capture_output=True, text=True,
            timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(out_path) as z:
            return {k: z[k] for k in z.files}


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------
@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("name", LOOP_CONFIGS)
def test_slot_schedule_equals_the_python_loop(python_runs, name, slots):
    """Audited: every state leaf (occ_phases and the audit's included),
    rounds and phases."""
    engine, sim = _engine(name, True)
    state, rounds = engine.run_slots(_fresh(engine, sim), slots=slots)
    want, want_rounds, want_phases = python_runs(name, True)
    assert rounds == want_rounds > 0
    assert engine.loop_stats["phases"] == want_phases
    assert int(state["occ_phases"][0]) == want_phases
    # the host reads the block once a batch of slots
    assert engine.loop_stats["host_syncs"] == max(1, -(-want_phases
                                                       // slots))
    _same_state(state, want, f"{name}, {slots} slots")


@pytest.mark.parametrize("name", LOOP_CONFIGS)
def test_slot_schedule_equals_the_python_loop_unaudited(python_runs, name):
    engine, sim = _engine(name, False)
    state, rounds = engine.run_slots(_fresh(engine, sim), slots=3)
    want, want_rounds, _ = python_runs(name, False)
    assert rounds == want_rounds
    assert "aud" not in state
    _same_state(state, want, name)


@pytest.mark.parametrize("loop", ["python", "slots"])
@pytest.mark.parametrize("name", list(PAUSED))
def test_paused_and_resumed_run_equals_unpaused_and_reference(
        reference, python_runs, name, loop):
    """Paused at `pause` with windows clamped to the stop time, then
    resumed: the state at the pause is the reference's, and the end
    state is the unpaused run's (and the reference's)."""
    pause, stop = PAUSED[name]
    engine, sim = _engine(name, True)
    run = engine.run_python if loop == "python" else engine.run_slots
    state, r1 = run(_fresh(engine, sim), pause, stop)
    assert r1 == int(reference[f"{name}/rounds1"])
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(),
                                      reference[f"{name}/mid/{k}"],
                                      err_msg=f"at the pause: {k}")
    state, r2 = run(state, stop, stop)
    assert r2 == int(reference[f"{name}/rounds2"])
    want, want_rounds, _ = python_runs(name, True)
    assert r1 + r2 == want_rounds
    _same_state(state, want, f"{name} resumed")
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(),
                                      reference[f"{name}/end/{k}"],
                                      err_msg=f"at the end: {k}")


@pytest.mark.parametrize("loop", ["python", "slots"])
def test_max_rounds_stops_where_the_reference_stops(reference, loop):
    engine, sim = _engine("phold", True)
    engine.config.max_rounds = MAX_ROUNDS
    run = engine.run_python if loop == "python" else engine.run_slots
    state, rounds = run(_fresh(engine, sim))
    assert rounds == MAX_ROUNDS == int(reference["max_rounds/rounds"])
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(),
                                      reference[f"max_rounds/{k}"],
                                      err_msg=k)


def test_a_slot_after_done_changes_no_byte():
    from shadow_tpu_torch.device.kernels import CTL, control_block

    engine, sim = _engine("tgen", True)
    state, _ = engine.run_slots(_fresh(engine, sim), slots=4)
    before = {k: v.clone() for k, v in state.items()}
    ob, pops = engine._outbox()
    ob_before = {k: v.clone() for k, v in ob.items()}
    ctl = control_block("cpu", done=1, win_end=10**12, stop=10**12,
                        final_stop=10**12, lookahead=10**6,
                        max_rounds=1 << 40, run=0)
    words = ctl.clone()
    engine._slots(state, ctl, 5)
    _same_state(state, before, "after done")
    for k in ob:
        assert torch.equal(ob[k], ob_before[k]), k
    assert torch.equal(ctl, words)
    assert int(ctl[CTL["run"]]) == 0


def test_stops_and_slots_are_checked():
    engine, sim = _engine("phold", False)
    with pytest.raises(ValueError, match="final_stop"):
        engine.run_slots(_fresh(engine, sim), 10**9, 10**8)
    with pytest.raises(ValueError, match="final_stop"):
        engine.run_python(_fresh(engine, sim), 10**9, 10**8)
    with pytest.raises(ValueError, match="slots"):
        engine.run_slots(_fresh(engine, sim), slots=0)


def test_cpu_run_takes_the_python_loop_and_card_loop_refuses_timing():
    """On the CPU `run` is the Python loop (the plain path); the
    captured loop refuses timing mode on the card rather than switch
    loops (checked here through its guard, which needs no card)."""
    from shadow_tpu_torch.device.kernels import Kernels

    engine, sim = _engine("phold", False)
    engine.run(_fresh(engine, sim))
    assert engine.loop_stats["loop"] == "python"
    assert engine.loop_stats["host_syncs"] == \
        engine.loop_stats["phases"] + 1
    engine.kernels = Kernels(timing=True)
    engine.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="timing mode"):
        engine.run_slots({})


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

    with open(job_path) as f:
        job = json.load(f)
    out = {}

    def save(prefix, state):
        for k, v in state.items():
            out[f"{prefix}/{k}"] = np.asarray(jax.device_get(v))

    for name, yaml in job["paused"].items():
        pause, stop = PAUSED[name]
        c = Controller(load_config_str(yaml, AUDIT))
        eng = c.runner.engine
        state, r1 = eng.run(eng.init_state(c.sim.starts), stop=pause,
                            final_stop=stop)
        save(f"{name}/mid", state)
        state, r2 = eng.run(state, stop=stop, final_stop=stop)
        save(f"{name}/end", state)
        out[f"{name}/rounds1"] = np.int64(r1)
        out[f"{name}/rounds2"] = np.int64(r2)

    c = Controller(load_config_str(job["max_rounds"], AUDIT))
    eng = c.runner.engine
    # max_rounds is read when the run is traced: off the compile cache,
    # which keys programs by the engine's construction-time facts
    eng.config.max_rounds = MAX_ROUNDS
    eng.aot_cache = None
    state, rounds = eng.run(eng.init_state(c.sim.starts))
    save("max_rounds", state)
    out["max_rounds/rounds"] = np.int64(rounds)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
