"""The mesh shrink of the port (`failover: shrink`,
shadow_tpu_torch/device/supervise.py `_shrink_recover`,
capacity.reshard_state, the `device_loss` chaos kind, the adoption of a
shrunken checkpoint's geometry, and retry, failover and chaos on the
host mesh), held against the reference package's tests/test_chaos.py
scenarios on gloo CPU ranks: its YAML (6 PHOLD hosts, 800 ms), SHRINK
(4 ranks, 200 ms segments, audited, `device_loss` at dispatch 2 of
shard 1, one retry) and ENS (a 2-seed campaign):

* an uninterrupted 3-rank mesh under all_to_all, two_phase and
  all_gather against the JAX engine at `mesh_shards: 3` under each;
* the 4 -> 3 shrink (of shard 1, and of shard 0, whose result comes
  from the lowest survivor) against the 3-shard reference: events,
  sent, dropped, delivered, per-host checksums, one reshard, a retry,
  3 shards, `device_loss` in the injector's ledger, a zero health word;
  2 ranks -> 1, the survivor on the one-device engine;
* post-shrink rotation entries stamping 3 shards (h_pad 6, h_loc 2),
  resumed without `mesh_shards` (adopted onto 3 CPU ranks, the lowest 3
  of a 4-rank spawn sitting out one rank), the reference's own
  post-shrink entry resumed the same way;
* `reshard_state` leaf by leaf against the reference's on one paused
  4-shard snapshot (audit, model NIC and path counters on), and its
  refusals;
* the campaign's shrink (from its newest rotation entry, its validated
  copy made unreadable) against the JAX 3-shard campaign, replica by
  replica, and its post-shrink entry resumed on 3 of 4 ranks;
* a re-shard made to fail on every survivor rolled back (the failover
  checkpoint stamps 4 shards), the hybrid rung finishing the run;
  `failover: shrink` with nothing dead escalating to hybrid ("cannot be
  attributed"), on one device and on the mesh;
* a one-shot `dispatch_error` on the mesh retried, a non-transient one
  aborting; `checkpoint_corrupt` on the mesh resolved to the newest
  readable entry.

Tolerance everywhere is exact equality. The reference runs in one child
process (this file's __main__ branch, 8 virtual CPU devices, its compile
cache off) under the jax batching patch the reference needs; the patch
never runs in the pytest process. The child and the port's spawned
meshes start before the first test and run side by side.
"""

import concurrent.futures as cf
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_chaos.py's YAML, SHRINK and ENS
YAML = """
general:
  stop_time: 800ms
  seed: 9
network:
  graph:
    type: 1_gbit_switch
experimental:
  scheduler_policy: tpu
  event_capacity: 48
{extra}
hosts:
  left:
    quantity: 3
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 10ms}}
  right:
    quantity: 3
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 10ms}}
"""

SHRINK = """  mesh_shards: 4
  dispatch_segment: 200ms
  state_audit: true
  failover: shrink
  dispatch_retries: 1
  dispatch_retry_backoff: 0.0
  chaos:
  - {{kind: device_loss, segment: 2, shard: {shard}}}
"""

ENS = """
ensemble:
  replicas: 2
  vary:
    seed: [9, 11]
  record_path: {rec}
"""

# the uninterrupted 3-shard run every recovery is held against
REF3 = "  mesh_shards: 3\n  dispatch_segment: 200ms\n  state_audit: true\n"
EXCHANGES = ("all_to_all", "two_phase", "all_gather")
# the post-shrink rotation entry a resume starts from (t = 600 ms)
POST = 600_000_000
# the paused 4-shard snapshot reshard_state is held on: every leaf class
SNAP = ("  mesh_shards: 4\n  state_audit: true\n  model_bandwidth: true\n"
        "  count_paths: true\n")
CAMPAIGN_LEAVES = ("chk", "n_exec", "n_sent", "n_drop", "n_deliv")


def _text(extra: str, rec: str = "") -> str:
    return YAML.format(extra=extra) + (ENS.format(rec=rec) if rec else "")


def _shrink(shard: int = 1) -> str:
    return SHRINK.format(shard=shard)


def _sig(stats):
    return (stats.events_executed, stats.packets_sent,
            stats.packets_dropped, stats.packets_delivered,
            [int(c) for c in stats.host_trace_checksum])


def _ref_sig(ref, key):
    return tuple(int(v) for v in ref[f"{key}/totals"]) + (
        ref[f"{key}/chk"].tolist(),)


# ----------------------------------------------------------------------
# the background work: the JAX child and the port's spawned meshes
# ----------------------------------------------------------------------
class Background:
    """The reference child and the port's spawned meshes, started once
    for the module and read by the tests."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.jax_ck = os.path.join(workdir, "jax_ck.npz")
        child = os.path.join(workdir, "child")
        os.makedirs(child)
        job = {"yaml": YAML, "shrink": _shrink(1), "ref3": REF3,
               "exchanges": list(EXCHANGES), "ens": ENS, "snap": SNAP,
               "jax_ck": self.jax_ck, "post": POST,
               "rec": os.path.join(child, "ENSEMBLE.json")}
        self.out_path = os.path.join(child, "out.npz")
        self.log_path = os.path.join(child, "child.log")
        job_path = os.path.join(child, "job.json")
        with open(job_path, "w") as f:
            json.dump(job, f)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["SHADOW_TPU_AOT_DIR"] = os.path.join(child, "aot")
        env["SHADOW_TPU_OCC_DIR"] = os.path.join(child, "occ")
        env["XLA_FLAGS"] = " ".join(
            [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
            + ["--xla_force_host_platform_device_count=8"])
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job_path,
                 self.out_path], cwd=child, env=env, stdout=log,
                stderr=subprocess.STDOUT)
        self._ref = None
        # the two 4-rank spawns and the 3-rank one, side by side
        self.pool = cf.ThreadPoolExecutor(max_workers=3)
        self.spawns = [self.pool.submit(self._four, part)
                       for part in (0, 1)]
        self.three = self.pool.submit(self._three)

    # -- the port's meshes ---------------------------------------------
    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def four_jobs(self, part: int) -> dict:
        """{key: (config text, keep the leaves, what `_four_rank` breaks:
        "" nothing, "reshard" the re-shard, "fetch" the read-back of the
        validated copy)} of the 4-rank spawn `part`, in run order (the
        resume after the run that writes its entry)."""
        ck = self.path("ck.npz")
        if part == 0:
            return {
                # SHRINK, rotating: the shrink and its checkpoints
                "shrink/1": (_text(_shrink(1) + f"  checkpoint_save: {ck}\n"
                                   "  checkpoint_every: 200ms\n"
                                   "  checkpoint_keep: 8\n"), True, ""),
                "resume": (_text(f"  checkpoint_load: {ck}.t{POST:015d}\n"
                                 "  dispatch_segment: 200ms\n"), True, ""),
                "shrink/0": (_text(_shrink(0)), True, ""),
                # mesh_shards 3 of the 4 ranks: the fourth sits it out
                "ref/all_gather": (_text(REF3 + "  exchange: all_gather\n"),
                                   True, ""),
                # 2 ranks -> 1: the survivor runs the one-device engine
                "shrink/2to1": (_text(_shrink(0).replace(
                    "mesh_shards: 4", "mesh_shards: 2")), True, ""),
            }
        eck = self.path("ens_ck.npz")
        return {
            # the copy unreadable on every rank: the shrink re-shards the
            # newest readable rotation entry (t = 400 ms)
            "ens": (_text(_shrink(1) + f"  checkpoint_save: {eck}\n"
                          "  checkpoint_every: 200ms\n"
                          "  checkpoint_keep: 8\n", self.path("ens.json")),
                    True, "fetch"),
            "ens/resume": (_text(f"  checkpoint_load: {eck}.t{POST:015d}\n"
                                 "  dispatch_segment: 200ms\n",
                                 self.path("ens2.json")), True, ""),
            # a one-shot retry and a corrupted rotation entry in one run
            "retry": (_text(
                "  mesh_shards: 4\n  dispatch_segment: 200ms\n"
                "  dispatch_retries: 2\n  dispatch_retry_backoff: 0.0\n"
                f"  checkpoint_save: {self.path('rot.npz')}\n"
                "  checkpoint_every: 200ms\n  checkpoint_keep: 8\n"
                "  chaos:\n  - {kind: dispatch_error, segment: 1, "
                "error: RESOURCE_EXHAUSTED}\n"
                "  - {kind: checkpoint_corrupt, entry: 2}\n"), False, ""),
            "rollback": (_text(_shrink(1) + "  checkpoint_save: "
                               f"{self.path('fo.npz')}\n"), False,
                         "reshard"),
            "nothing_dead": (_text(
                "  mesh_shards: 4\n  dispatch_segment: 200ms\n"
                "  failover: shrink\n  checkpoint_save: "
                f"{self.path('nd.npz')}\n  chaos:\n"
                "  - {kind: dispatch_error, segment: 1}\n"), False, ""),
        }

    def _four(self, part: int) -> dict:
        from shadow_tpu_torch.config import load_config_str
        from shadow_tpu_torch.device import mesh

        jobs = self.four_jobs(part)
        cfgs = [load_config_str(t) for t, _, _ in jobs.values()]
        out = mesh.spawn(["cpu"] * 4, _four_rank, (
            cfgs, [k for _, k, _ in jobs.values()],
            [b for _, _, b in jobs.values()]), timeout=300)
        return dict(zip(jobs, out))

    def four(self) -> dict:
        return {**self.spawns[0].result(), **self.spawns[1].result()}

    def _three(self) -> dict:
        """The uninterrupted 3-rank runs under all_to_all and two_phase
        (all_gather's runs on 3 ranks of the 4-rank spawn)."""
        from shadow_tpu_torch.config import load_config_str
        from shadow_tpu_torch.device import runner

        cfgs = [load_config_str(_text(REF3 + f"  exchange: {x}\n"))
                for x in EXCHANGES[:2]]
        return dict(zip((f"ref/{x}" for x in EXCHANGES[:2]),
                        runner.mesh_runs(["cpu"] * 3, cfgs, keep_state=True,
                                         timeout=300)))

    # -- results --------------------------------------------------------
    def ref(self) -> dict:
        if self._ref is None:
            rc = self.proc.wait(timeout=900)
            with open(self.log_path) as f:
                assert rc == 0, f.read()[-4000:]
            with np.load(self.out_path) as z:
                self._ref = {k: z[k] for k in z.files}
        return self._ref

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.pool.shutdown(wait=True, cancel_futures=True)


def _four_rank(mesh, cfgs: list, keeps: list, broken: list) -> list:
    """The 4-rank spawn on one rank: each config through the ranks'
    loop (runner._mesh_runs_rank), with capacity.reshard_state raising
    on every survivor ("reshard") or the validated copy failing to read
    back on every rank ("fetch") where `broken` says so."""
    from shadow_tpu_torch.device import capacity, runner, supervise

    def fail(*args):
        raise RuntimeError("UNAVAILABLE: injected failure")

    out = []
    for cfg, keep, brk in zip(cfgs, keeps, broken):
        mod, name = {"reshard": (capacity, "reshard_state"),
                     "fetch": (supervise, "_host_copy"),
                     "": (None, None)}[brk]
        orig = getattr(mod, name) if mod else None
        if mod:
            setattr(mod, name, fail)
        try:
            out += runner._mesh_runs_rank(mesh, [cfg], [keep], [False])
        finally:
            if mod:
                setattr(mod, name, orig)
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def bg():
    d = tempfile.mkdtemp(prefix="torch_shrink_")
    b = Background(d)
    try:
        yield b
    finally:
        b.stop()
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def ref(bg):
    return bg.ref()


@pytest.fixture(scope="module")
def four(bg):
    return bg.four()


@pytest.fixture(scope="module")
def three(bg):
    return bg.three.result()


@pytest.fixture(scope="module")
def ref3(ref):
    return _ref_sig(ref, "ref/all_to_all")


# ----------------------------------------------------------------------
# the uninterrupted 3-rank mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_three_rank_mesh_equals_jax_at_three_shards(exchange, ref, three,
                                                   four):
    """H_pad = 6 on 3 ranks (group_split(3) = (1, 3) under two_phase):
    the port equals the JAX engine at mesh_shards 3, and every exchange
    the others; all_gather's run is the first 3 ranks of a 4-rank spawn
    (the config's mesh_shards), the fourth sitting it out."""
    stats, leaves = {**three, **four}[f"ref/{exchange}"]
    assert [r.get("left", False) for r in stats.mesh["ranks"]] == (
        [False] * 3 + [True] * (exchange == "all_gather"))
    assert stats.ok and stats.mesh["shards"] == 3
    assert stats.mesh["exchange"] == exchange
    assert _sig(stats) == _ref_sig(ref, f"ref/{exchange}")
    assert _ref_sig(ref, f"ref/{exchange}") == _ref_sig(ref,
                                                         "ref/all_to_all")
    assert leaves["ht"].shape[0] == 6
    assert int(leaves["aud"].max()) == 0


# ----------------------------------------------------------------------
# the shrink
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shard", [1, 0])
def test_shrink_bitmatches_the_three_shard_run(shard, ref, ref3, four):
    """A scripted loss of shard 1 (test_chaos.py's SHRINK) and of shard
    0, whose result the lowest survivor hands back: one reshard after
    the retry ran out, 3 shards, equal to the uninterrupted 3-shard run,
    the audit's word zero across the reshard."""
    stats, leaves = four[f"shrink/{shard}"]
    assert stats.ok
    assert stats.reshards == 1 == int(ref["shrink/reshards"])
    assert stats.retries >= 1 and int(ref["shrink/retries"]) >= 1
    assert stats.mesh["shards"] == 3 == int(ref["shrink/n_shards"])
    assert _sig(stats) == ref3 == _ref_sig(ref, "shrink")
    assert int(leaves["aud"].max()) == 0
    assert leaves["ht"].shape[0] == 6
    left = [r.get("left", False) for r in stats.mesh["ranks"]]
    assert left == [p == shard for p in range(4)]
    assert json.loads(str(ref["shrink/fired"])) == ["device_loss"]


def test_shrink_to_one_rank_runs_the_one_device_engine(ref3, four):
    """SHRINK on 2 of the 4 ranks losing shard 0: the last survivor (a
    mesh of one rank) goes on on the one-device engine, H_pad 6, equal
    to the uninterrupted run; the other two ranks sat the config out."""
    stats, leaves = four["shrink/2to1"]
    assert stats.ok and stats.reshards == 1 and stats.mesh["shards"] == 1
    assert _sig(stats) == ref3 and leaves["ht"].shape[0] == 6
    assert [r.get("left", False) for r in stats.mesh["ranks"]] == [
        True, False, True, True]


def test_injector_ledger_names_the_device_loss():
    """The port's injector on one rank's view: the loss marks its
    position dead, every later dispatch on a mesh holding it raises the
    scripted class, a mesh of the survivors runs."""
    from types import SimpleNamespace

    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import chaos

    inj = chaos.from_config(load_config_str(
        _text(_shrink(1))).experimental)
    four = SimpleNamespace(members=[0, 1, 2, 3])
    three = SimpleNamespace(members=[0, 2, 3])
    inj.on_dispatch_issue(four)
    inj.on_dispatch_issue(four)
    for _ in range(2):
        with pytest.raises(chaos.ChaosError, match=r"UNAVAILABLE: .*"
                           r"\[1\] are down"):
            inj.on_dispatch_issue(four)
    inj.on_dispatch_issue(three)
    assert inj.is_dead(1) and not inj.is_dead(0)
    assert [f["kind"] for f in inj.fired] == ["device_loss"]
    assert inj.fired[0]["position"] == 1
    with pytest.raises(ValueError, match="out of range"):
        chaos.from_config(load_config_str(_text(
            "  chaos:\n  - {kind: device_loss, segment: 0, shard: 1}\n"))
            .experimental).on_dispatch_issue(None)


def test_shrunken_checkpoints_stamp_and_resume_adopts(bg, ref3, four):
    """Rotation entries after the shrink stamp 3 shards; a resume of the
    entry at 600 ms without mesh_shards adopts them: on the 4-rank spawn
    its first 3 ranks run it and the fourth sits it out, and through the
    controller `--device cpu` puts it on 3 CPU ranks; both equal the
    uninterrupted run."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.device import checkpoint, supervise

    stats, _ = four["shrink/1"]
    assert stats.ok and stats.reshards == 1
    base = bg.path("ck.npz")
    entries = supervise.rotation_entries(base)
    assert [t for t, _ in entries] == [200_000_000, 400_000_000, POST]
    geoms = [checkpoint.peek_geometry(checkpoint.peek_meta(p))
             for _, p in entries]
    assert geoms[0]["n_shards"] == 4
    assert geoms[-1] == {"n_shards": 3, "h_pad": 6, "h_loc": 2}
    res, leaves = four["resume"]
    assert res.ok and res.mesh["shards"] == 3 and _sig(res) == ref3
    assert [r.get("left", False) for r in res.mesh["ranks"]] == [
        False, False, False, True]
    c = Controller(load_config_str(_text(
        f"  checkpoint_load: {entries[-1][1]}\n"
        "  dispatch_segment: 200ms\n")), device="cpu")
    got = c.run()
    assert got.ok and got.mesh["shards"] == 3 and _sig(got) == ref3


def test_the_references_shrunken_checkpoint_resumes_on_the_port(bg, ref,
                                                                ref3):
    """The JAX engine's post-shrink entry (3 shards) resumed by the
    port's controller without mesh_shards: adopted onto 3 CPU ranks,
    equal to the uninterrupted run."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.device import checkpoint

    path = str(ref["geo/post"])
    assert checkpoint.peek_geometry(checkpoint.peek_meta(path)) == {
        "n_shards": 3, "h_pad": 6, "h_loc": 2}
    got = Controller(load_config_str(_text(
        f"  checkpoint_load: {path}\n  dispatch_segment: 200ms\n")),
        device="cpu").run()
    assert got.ok and got.mesh["shards"] == 3 and _sig(got) == ref3


def test_adoption_refuses_a_smaller_pool(bg, four):
    """A 3-shard entry on a 2-rank mesh: the reference's message, before
    any rank starts; a one-device pool on the card side follows the same
    rule (`device_pool`)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    four["resume"]
    path = f"{bg.path('ck.npz')}.t{POST:015d}"
    cfg = load_config_str(_text(f"  mesh_shards: 2\n  checkpoint_load: "
                                f"{path}\n"))
    with pytest.raises(ValueError, match=r"saved on 3 shard\(s\) but only "
                       r"2 device\(s\) are available — resume on a pool of "
                       r"at least the saved shard count"):
        runner.mesh_runs(["cpu"] * 2, [cfg])
    assert runner.adopted_devices(cfg, ["cpu"] * 4) == ["cpu"] * 3
    assert runner.device_pool(load_config_str(_text(
        f"  checkpoint_load: {path}\n")), "cpu") == ["cpu"] * 3


# ----------------------------------------------------------------------
# reshard_state
# ----------------------------------------------------------------------
def test_reshard_state_equals_the_reference_leaf_by_leaf(ref):
    """One paused 4-shard snapshot (audit, model NIC, path counters)
    re-padded onto a 3-shard template by both packages."""
    from shadow_tpu_torch.device import capacity

    def part(tag):
        return {k[len(f"reshard/{tag}/"):]: v for k, v in ref.items()
                if k.startswith(f"reshard/{tag}/")}

    snap, tmpl, want = part("in"), part("tmpl"), part("out")
    assert {"path_cnt", "tx_free", "aud_tx", "occ_x"} <= set(snap)
    got = capacity.reshard_state(snap, 6, tmpl)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a snapshot without the audit reseeds the ledger as the reference
    bare = {k: v for k, v in snap.items() if not k.startswith("aud")}
    np.testing.assert_array_equal(
        capacity.reshard_state(bare, 6, tmpl)["aud_tx"],
        part("bare")["aud_tx"])


def test_reshard_state_refuses_unregistered_leaves(ref):
    """test_chaos.py's refusals: a leaf in no class, a non-auxiliary
    leaf the target lacks, a missing leaf, a change of capacity."""
    from shadow_tpu_torch.device import capacity

    snap = {k[len("reshard/in/"):]: v for k, v in ref.items()
            if k.startswith("reshard/in/")}
    tmpl = {k[len("reshard/tmpl/"):]: v for k, v in ref.items()
            if k.startswith("reshard/tmpl/")}
    with pytest.raises(ValueError, match="mystery.*not registered in any "
                       "reshard class"):
        capacity.reshard_state({**snap, "mystery": np.zeros(8)}, 6,
                               {**tmpl, "mystery": np.zeros(8)})
    with pytest.raises(ValueError, match="snapshot carries leaves the "
                       "target engine lacks: \\['mystery'\\]"):
        capacity.reshard_state({**snap, "mystery": np.zeros(8)}, 6, tmpl)
    with pytest.raises(ValueError, match="missing leaf 'head'"):
        capacity.reshard_state({k: v for k, v in snap.items()
                                if k != "head"}, 6, tmpl)
    wide = {**tmpl, "ht": np.zeros((6, 64), np.int64)}
    with pytest.raises(ValueError, match="geometry only"):
        capacity.reshard_state(snap, 6, wide)
    with pytest.raises(ValueError, match="does not fit"):
        capacity.reshard_state(snap, 9, tmpl)


# ----------------------------------------------------------------------
# the campaign
# ----------------------------------------------------------------------
def test_campaign_shrink_equals_the_three_shard_campaign(ref, four):
    """ENS on 4 ranks losing shard 1, its validated copy unreadable on
    every rank, so that the shrink re-shards the newest readable
    rotation entry: one reshard, 3 shards, each replica's leaves equal
    to the JAX 3-shard campaign's (and to its 4 -> 3 shrink), the
    audit's word zero, and replica 0 equal to the standalone 3-shard
    run."""
    stats, leaves = four["ens"]
    assert stats.ok and stats.reshards == 1 and stats.mesh["shards"] == 3
    assert int(ref["ens/shrink/reshards"]) == 1
    assert leaves["ht"].shape[:2] == (2, 6)
    for k in CAMPAIGN_LEAVES:
        np.testing.assert_array_equal(leaves[k][:, :6], ref[f"ens/ref/{k}"],
                                      err_msg=k)
        np.testing.assert_array_equal(leaves[k][:, :6],
                                      ref[f"ens/shrink/{k}"], err_msg=k)
    assert int(leaves["aud"].max()) == 0
    assert leaves["chk"][0].tolist() == _ref_sig(ref, "ref/all_to_all")[-1]


def test_campaign_resume_adopts_the_shrunken_geometry(ref, four):
    """The shrunken campaign's entry at 600 ms (3 shards) resumed
    without mesh_shards on the 4-rank spawn: its first 3 ranks run it,
    every replica equal to the JAX 3-shard campaign."""
    stats, leaves = four["ens/resume"]
    assert stats.ok and stats.mesh["shards"] == 3
    assert [r.get("left", False) for r in stats.mesh["ranks"]] == [
        False, False, False, True]
    for k in CAMPAIGN_LEAVES:
        np.testing.assert_array_equal(leaves[k][:, :6], ref[f"ens/ref/{k}"],
                                      err_msg=k)


# ----------------------------------------------------------------------
# the failover ladder
# ----------------------------------------------------------------------
def test_failed_reshard_rolls_back_and_fails_over(four, ref3):
    """The re-shard raising on every survivor: the runner rolls back to
    the 4-rank mesh, the failover checkpoint stamps 4 shards, the ranks
    hand the failover back, and the hybrid rung finishes the run equal
    to the reference."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.device import checkpoint, supervise

    exc, leaves = four["rollback"]
    assert isinstance(exc, supervise.DeviceFailover) and leaves is None
    geom = checkpoint.peek_geometry(checkpoint.peek_meta(
        exc.checkpoint_path))
    assert geom == {"n_shards": 4, "h_pad": 8, "h_loc": 2}
    assert exc.checkpoint_path.endswith("fo.npz.failover")
    c = Controller(load_config_str(_text(_shrink(1))), device="cpu")
    stats = c._failover_run(exc)
    assert stats.ok and stats.reshards == 0 and _sig(stats) == ref3
    assert stats.failover_checkpoint == exc.checkpoint_path


def test_shrink_with_nothing_dead_escalates_to_hybrid(four, ref3,
                                                      monkeypatch, caplog):
    """No probe can attribute the failure: on the mesh (a one-shot
    dispatch error, no retries) every rank escalates and the lead hands
    the failover back; on one device (the reference's drill, the
    engine's run raising) the controller's hybrid rung finishes the run,
    logging that the failure cannot be attributed."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.device import checkpoint, supervise
    from shadow_tpu_torch.device.engine import DeviceEngine

    exc, _ = four["nothing_dead"]
    assert isinstance(exc, supervise.DeviceFailover)
    assert checkpoint.peek_geometry(checkpoint.peek_meta(
        exc.checkpoint_path))["n_shards"] == 4

    def dead(self, state, stop=None, final_stop=None):
        raise RuntimeError("UNAVAILABLE: flaky fabric, no dead chip")

    monkeypatch.setattr(DeviceEngine, "run", dead)
    with caplog.at_level(logging.ERROR):
        stats = Controller(load_config_str(_text(
            "  failover: shrink\n  dispatch_segment: 200ms\n")),
            device="cpu").run()
    assert stats.ok and _sig(stats) == ref3
    msgs = [r.getMessage() for r in caplog.records]
    assert any("cannot be attributed" in m for m in msgs)
    assert any("DEVICE FAILOVER" in m for m in msgs)


def test_a_mesh_failover_reaches_the_controller(monkeypatch, ref3):
    """The ranks' DeviceFailover (handed back by their lead) raises in
    the caller's process (runner.run_mesh), where the controller's
    hybrid rung finishes the run, the failover checkpoint kept."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.device import runner, supervise

    exc = supervise.DeviceFailover("UNAVAILABLE: lost", "/x.failover",
                                   400_000_000)
    calls = []

    def handed_back(devices, cfgs, **kw):
        calls.append(list(devices))
        return [(exc, None)]

    monkeypatch.setattr(runner, "mesh_runs", handed_back)
    stats = Controller(load_config_str(_text(_shrink(1))),
                       device="cpu").run()
    assert calls == [["cpu"] * 4]
    assert stats.ok and _sig(stats) == ref3
    assert stats.failover_checkpoint == "/x.failover"


def test_a_lost_single_device_escalates_to_hybrid(ref3, caplog):
    """`failover: shrink` on one device whose only rank is scripted dead:
    no survivor, so the ladder's hybrid rung finishes the run."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.controller import Controller

    with caplog.at_level(logging.ERROR):
        stats = Controller(load_config_str(_text(
            "  dispatch_segment: 200ms\n  failover: shrink\n  chaos:\n"
            "  - {kind: device_loss, segment: 1, shard: 0}\n")),
            device="cpu").run()
    assert stats.ok and _sig(stats) == ref3 and stats.reshards == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("no mesh device survived" in m for m in msgs)
    assert any("DEVICE FAILOVER" in m for m in msgs)


def test_dispatch_retry_and_abort_on_the_mesh(four, ref3):
    """A one-shot RESOURCE_EXHAUSTED on 4 ranks (the run also rotating,
    its third entry corrupted): one retry, no reshard, equal; an
    INVALID_ARGUMENT is never retried: every rank raises it."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.mesh import MeshFailure

    stats, _ = four["retry"]
    assert stats.ok and stats.retries == 1 and stats.reshards == 0
    assert _sig(stats) == ref3
    with pytest.raises(MeshFailure, match="INVALID_ARGUMENT"):
        runner.mesh_runs(["cpu"] * 2, [load_config_str(_text(
            "  mesh_shards: 2\n  dispatch_segment: 200ms\n"
            "  dispatch_retries: 5\n  chaos:\n"
            "  - {kind: dispatch_error, segment: 1, "
            "error: INVALID_ARGUMENT}\n"))], timeout=120)


def test_checkpoint_corrupt_on_the_mesh_resolves_to_newest_readable(
        bg, four):
    """Three rotation entries on 4 ranks, the last truncated by the
    schedule on the writing rank: resolution skips it."""
    from shadow_tpu_torch.device import checkpoint, supervise

    stats, _ = four["retry"]
    assert stats.ok
    base = bg.path("rot.npz")
    entries = supervise.rotation_entries(base)
    assert len(entries) == 3
    os.unlink(base)
    assert supervise.resolve_checkpoint(base) == entries[-2][1]
    with pytest.raises(Exception):
        checkpoint.peek_meta(entries[-1][1])


# ----------------------------------------------------------------------
# the JAX child
# ----------------------------------------------------------------------
def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    import jax

    from shadow_tpu.config import load_config_str
    from shadow_tpu.core.controller import Controller
    from shadow_tpu.device import capacity, checkpoint

    with open(job_path) as f:
        job = json.load(f)
    out = {}
    off = ["experimental.compile_cache=off"]

    def text(extra, rec=""):
        return job["yaml"].format(extra=extra) + (
            job["ens"].format(rec=rec) if rec else "")

    def run(t):
        c = Controller(load_config_str(t, off))
        return c, c.run()

    def keep(key, c, stats):
        out[f"{key}/chk"] = np.array([h.trace_checksum
                                      for h in c.sim.hosts], np.int64)
        out[f"{key}/totals"] = np.array(
            [stats.events_executed, stats.packets_sent,
             stats.packets_dropped, stats.packets_delivered], np.int64)

    for x in job["exchanges"]:
        c, stats = run(text(job["ref3"] + f"  exchange: {x}\n"))
        assert stats.ok
        keep(f"ref/{x}", c, stats)
    base = job["jax_ck"]
    c, stats = run(text(job["shrink"] + f"  checkpoint_save: {base}\n"
                        "  checkpoint_every: 200ms\n"
                        "  checkpoint_keep: 8\n"))
    assert stats.ok
    keep("shrink", c, stats)
    out["shrink/reshards"] = np.int64(stats.reshards)
    out["shrink/retries"] = np.int64(stats.retries)
    out["shrink/n_shards"] = np.int64(c.runner.engine.n_shards)
    out["shrink/fired"] = np.array(json.dumps(
        [f["kind"] for f in c.runner.chaos.fired]))
    post = f"{base}.t{job['post']:015d}"
    out["geo/post"] = np.array(post)
    # the paused 4-shard snapshot and a 3-shard template
    snap_ck = base + ".snap"
    c, stats = run(text(job["snap"] + f"  checkpoint_save: {snap_ck}\n"
                        "  checkpoint_save_time: 400ms\n"))
    snap, _ = checkpoint.load_host_state(snap_ck)
    c3 = Controller(load_config_str(text(job["snap"].replace(
        "mesh_shards: 4", "mesh_shards: 3")), off))
    r = c3.runner
    tmpl = jax.device_get(r.engine.init_state(r.sim.starts))
    tmpl = {k: np.asarray(v) for k, v in tmpl.items()}
    res = capacity.reshard_state(snap, 6, tmpl)
    bare = capacity.reshard_state(
        {k: v for k, v in snap.items() if not k.startswith("aud")}, 6, tmpl)
    for k in snap:
        out[f"reshard/in/{k}"] = np.asarray(snap[k])
    for k in tmpl:
        out[f"reshard/tmpl/{k}"] = tmpl[k]
        out[f"reshard/out/{k}"] = np.asarray(res[k])
    out["reshard/bare/aud_tx"] = np.asarray(bare["aud_tx"])
    # the campaign: 3 shards uninterrupted, and 4 -> 3
    for key, extra in (("ref", job["ref3"]), ("shrink", job["shrink"])):
        c, stats = run(text(extra, job["rec"]))
        assert stats.ok
        f = c.runner.final_state
        for k in ("chk", "n_exec", "n_sent", "n_drop", "n_deliv"):
            out[f"ens/{key}/{k}"] = np.asarray(f[k])[:, :6]
        out[f"ens/{key}/reshards"] = np.int64(stats.reshards)
    assert os.path.exists(post)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
