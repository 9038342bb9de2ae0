"""K10 judge_batch as redesigned for the H100, on the CPU: what
`kernels.judge_tables` builds once for the hybrid judge, and a numpy
mirror of how csrc/judge_batch.cu's `judge_kernel` reads it.

* The drop key table ([H, 2]) against the port's
  torch chain (device/prng.py `purpose_id_key`) and the JAX package's
  `prng.purpose_id_key`.
* On factored tables the per-host records, the packed access pair
  (under fault epochs) and the packed core pair, composed as the kernel
  composes them, against the JAX `hierarchy.gather_parts`, with and
  without epochs.
* The mirror (keys from the table, a sender outside [0, H) from the
  full chain of its raw id; ends from the records) against
  `judge_batch_plain` and the JAX `DeviceJudge` on seeded batches over
  the four views (dense, factored, each with and without epochs):
  seqs 0, 2^31-1, -1 and -2^31; send times at the bootstrap end and at
  each epoch start, 1 ns before and after; same-vertex, same-cluster and
  cross-cluster pairs; senders and destinations outside [0, H).
* `DeviceJudge` on the CPU with its counters, `judge_s` among them.

Tolerance everywhere is exact equality: the lookup is integer and the
drop roll compares the same float32 values. An id in [-H, -1] reads
host id + H (numpy's and jax's negative indexing, which the reference's
gather uses), every other id outside [0, H) the nearest end, in the
port's plain path and K10 alike (`kernels.host_index`); every batch,
those held against JAX too, holds outside ids of all three kinds. The
JAX side runs in one child process (this
file's __main__ branch) under the jax batching patch the reference
needs; the patch never runs in the pytest process.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from shadow_tpu_torch.config import load_config, load_config_str
from shadow_tpu_torch.core.build import build
from shadow_tpu_torch.device import prng
from shadow_tpu_torch.device.judge import DeviceJudge
from shadow_tpu_torch.device.kernels import (
    KERNEL_NAMES,
    Kernels,
    judge_batch_plain,
    judge_tables,
)
from shadow_tpu_torch.utils import nprng
from shadow_tpu_torch.utils.rng import PURPOSE_PACKET_DROP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
I32 = np.iinfo(np.int32)

DENSE = """
general: {stop_time: 2s, seed: 7, bootstrap_end_time: 500ms}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.02 ]
        edge [ source 0 target 1 latency "25 ms" packet_loss 0.02 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.02 ]
      ]
experimental: {scheduler_policy: serial}
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=3, start_time: 10ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=3, start_time: 10ms}]
"""
# six epochs: starts at 0, 1, 2, 3, 4 and 5 s
DENSE_EPOCHS = DENSE.replace("experimental:", """  faults:
    - {kind: degrade, time: 1s, duration: 1s, source: 0, target: 1,
       latency_multiplier: 3, extra_packet_loss: 0.2}
    - {kind: link_down, time: 3s, source: 0, target: 1}
    - {kind: link_up, time: 4s, source: 0, target: 1}
    - {kind: link_down, time: 5s, source: 0, target: 1}
experimental:""", 1)
# a lossy hub star, two hosts on each spoke (same-vertex pairs of two
# hosts), three clusters
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
  twin:
    quantity: 9
    network_node_id: 3
    network_node_stride: 1
    processes: [{path: model:phold, start_time: 10ms}]
"""
# (source: YAML text or an examples/ file, overrides)
CONFIGS = {
    "dense": (DENSE, []),
    "factored": (STAR, []),
    "dense_epochs": (DENSE_EPOCHS, []),
    # the hub degrade, the access degrade and the hub outage
    "factored_epochs": ("tgen_faults_hier.yaml",
                        ["general.bootstrap_end_time=2500ms"]),
}
FACTORED = ("factored", "factored_epochs")
N = 4000


def _source(name):
    source, overrides = CONFIGS[name]
    if source.endswith(".yaml"):
        return os.path.join(EXAMPLES, source), overrides, True
    return source, overrides, False


def _cfg(name):
    source, overrides, is_file = _source(name)
    return (load_config(source, overrides) if is_file
            else load_config_str(source, overrides))


def port_judge(name, kernels=None) -> DeviceJudge:
    """The port's judge of a CONFIGS config, on the CPU."""
    cfg = _cfg(name)
    sim = build(cfg)
    return DeviceJudge(sim.topology, sim.host_vertex, cfg.general.seed,
                       bootstrap_end=cfg.general.bootstrap_end_time,
                       fault_table=sim.fault_table, device="cpu",
                       kernels=kernels)


def _outside(rng, n, H):
    """n ids outside [0, H): both ends of int32, H and H + 1, -H - 1,
    -H, -2 and -1, others above H, below -H or in [-H, -1] (which read
    host id + H)."""
    fixed = [I32.min, H, H + 1, I32.max, -H - 1, -H, -2, -1]
    low = np.where(rng.random(n) < 0.5, rng.integers(I32.min, -H, n),
                   rng.integers(-H, 0, n))
    x = np.where(rng.random(n) < 0.5, low,
                 rng.integers(H, I32.max, n, endpoint=True))
    x[:len(fixed)] = fixed
    return x


def batch_of(name, judge: DeviceJudge, for_jax: bool):
    """N seeded packets on `judge`'s hosts: send times at, 1 ns before
    and after the bootstrap end and every epoch start, the rest uniform
    in [0, 7 s); destinations a tenth the sender, a tenth a host on the
    sender's vertex, a tenth its next id, the rest uniform; a twentieth
    of senders and of destinations outside [0, H) (`_outside`); seqs
    uniform int32 with 0, 2^31-1, -1 and -2^31 among them. `for_jax`
    seeds the batches the JAX child judges apart from the others."""
    rng = np.random.default_rng(sum(map(ord, name)) + 17 * for_jax)
    world = judge.world
    hv = world["host_vertex"].numpy().astype(np.int64)
    H = len(hv)
    starts = world["epoch_times"].tolist()[1:]
    near = [b + d for b in starts + [judge.boot_end] for d in (-1, 0, 1)
            if b + d >= 0]
    now = rng.integers(0, 7 * 10**9, N)
    now[:len(near)] = near
    src = rng.integers(0, H, N)
    twin = np.array([np.flatnonzero(hv == hv[h])[-1] if
                     (hv == hv[h]).sum() > 1 and
                     np.flatnonzero(hv == hv[h])[-1] != h
                     else np.flatnonzero(hv == hv[h])[0]
                     for h in range(H)])
    pick = rng.random(N)
    dst = np.where(pick < 0.1, src, np.where(
        pick < 0.2, twin[src], np.where(
            pick < 0.3, np.minimum(src + 1, H - 1),
            rng.integers(0, H, N))))
    out_s, out_d = rng.random(N) < 0.05, rng.random(N) < 0.05
    src[out_s] = _outside(rng, int(out_s.sum()), H)
    dst[out_d] = _outside(rng, int(out_d.sum()), H)
    seq = rng.integers(I32.min, I32.max, N, endpoint=True)
    seq[-4:] = [0, I32.max, -1, I32.min]
    return (now.astype(np.int64), src.astype(np.int32),
            dst.astype(np.int32), seq.astype(np.int32))


# ----------------------------------------------------------------------
# the numpy mirror of judge_kernel's reading
# ----------------------------------------------------------------------
def _f32(bits: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(bits, np.int32).view(np.float32)


def mirror_ends(tables, sv_host, dv_host, e):
    """(lat int32, rel float32) of the pairs of host rows sv_host,
    dv_host (in [0, H)) in epochs e, read as judge_kernel reads them:
    dense through host_vertex; factored from the records, the packed
    access pair (epochs) and the packed core pair, composed in the
    reference's order: int32 sums, (acc_s * core) * acc_d in float32."""
    world = tables.world
    hv = world["host_vertex"].numpy()
    if tables.core is None:
        lat, rel = world["lat"].numpy(), world["rel"].numpy()
        vs, vd = hv[sv_host], hv[dv_host]
        if lat.ndim == 3:
            return lat[e, vs, vd], rel[e, vs, vd]
        return lat[vs, vd], rel[vs, vd]
    rec = tables.records.numpy()
    core = tables.core.numpy()
    rs, rd = rec[sv_host], rec[dv_host]
    slat, srel = world["lat"][3].numpy(), world["rel"][3].numpy()
    if tables.access is None:
        c = core[rs[:, 1], rd[:, 1]]
        a_s, a_d = rs[:, 2:4], rd[:, 2:4]
        self_l, self_r = slat[rs[:, 0]], srel[rs[:, 0]]
    else:
        acc = tables.access.numpy()
        c = core[e, rs[:, 1], rd[:, 1]]
        a_s, a_d = acc[e, rs[:, 0]], acc[e, rd[:, 0]]
        self_l, self_r = slat[e, rs[:, 0]], srel[e, rs[:, 0]]
    same = rs[:, 0] == rd[:, 0]
    with np.errstate(over="ignore"):
        lat = a_s[:, 0] + c[:, 0] + a_d[:, 0]
    rel = (_f32(a_s[:, 1]) * _f32(c[:, 1])) * _f32(a_d[:, 1])
    return (np.where(same, self_l, lat).astype(np.int32),
            np.where(same, self_r, rel).astype(np.float32))


def mirror(tables, boot_end, now, src, dst, seq):
    """(delivered bool, deliver_time int64) as judge_kernel computes
    them: ends read at `host_index` (id + H for an id in [-H, -1],
    else clamped into [0, H)), the epoch the count of starts <= now
    less one, the sender's key from the table where it lies in [0, H)
    and from the full chain of its raw id otherwise."""
    world = tables.world
    H = world["host_vertex"].shape[0]
    starts = world["epoch_times"].numpy()
    e = np.maximum((now[:, None] >= starts[None, :]).sum(1) - 1, 0)
    def row(ids):
        i = ids.astype(np.int64)
        return np.clip(np.where(i < 0, i + H, i), 0, H - 1)

    lat, rel = mirror_ends(tables, row(src), row(dst), e)
    keys = tables.keys.numpy().view(np.uint32)
    inside = src.astype(np.int64).astype(np.uint64) < H
    k1 = keys[np.clip(src, 0, H - 1), 0]
    k2 = keys[np.clip(src, 0, H - 1), 1]
    seed = [int(x) for x in world["seed_key"].reshape(-1).tolist()]
    full = nprng.fold_in(nprng.fold_in(
        (np.uint32(seed[0]), np.uint32(seed[1])), PURPOSE_PACKET_DROP),
        src.astype(np.uint32))
    key = (np.where(inside, k1, full[0]), np.where(inside, k2, full[1]))
    u = nprng.uniform01(nprng.fold_in(key, seq.astype(np.uint32)))
    drop = (rel < np.float32(1)) & (now >= boot_end) & (u >= rel)
    return ~drop, now + lat.astype(np.int64)


def _plain(judge, batch):
    d, t = judge_batch_plain(judge.world, judge.boot_end,
                             *(torch.from_numpy(a) for a in batch))
    return d.numpy(), t.numpy()


# ----------------------------------------------------------------------
# the tables, against the port's chain and the plain lookup
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_drop_keys_equal_the_port_chain(name):
    judge = port_judge(name)
    H = judge.world["host_vertex"].shape[0]
    seed = tuple(int(x) for x in judge.world["seed_key"][0].tolist())
    k1, k2 = prng.purpose_id_key(seed, PURPOSE_PACKET_DROP,
                                 torch.arange(H))
    keys = judge.tables.keys
    assert keys.dtype == torch.int32 and keys.shape == (H, 2)
    np.testing.assert_array_equal(keys.numpy().view(np.uint32),
                                  np.stack([k1.numpy(), k2.numpy()], 1))


def test_drop_keys_at_a_hundred_thousand_hosts():
    """The table at 100,003 hosts under a seed of 64 bits equals the
    torch chain host for host."""
    from shadow_tpu_torch.device.kernels import drop_keys

    seed = prng.seed_key(0xDEADBEEF12345678)
    keys = drop_keys(torch.tensor([list(seed)], dtype=torch.int64),
                     100_003)
    k1, k2 = prng.purpose_id_key(seed, PURPOSE_PACKET_DROP,
                                 torch.arange(100_003))
    np.testing.assert_array_equal(keys.numpy().view(np.uint32),
                                  np.stack([k1.numpy(), k2.numpy()], 1))


@pytest.mark.parametrize("name", FACTORED)
def test_records_hold_the_factored_leaves(name):
    """The records and packed pairs are the world's leaves, rearranged:
    {vertex, cluster(, acc_lat, acc_rel bits)} a host, {lat, rel bits}
    an (epoch,) vertex or cluster pair; the mirror's lookup equals the
    plain two-level lookup on every ordered host pair in every epoch."""
    from shadow_tpu_torch.device.kernels import table_lookup

    t = port_judge(name).tables
    world = t.world
    hv = world["host_vertex"].long()
    cc, cl, acc, _ = world["lat"]
    ccr, _, accr, _ = world["rel"]
    T = world["epoch_times"].shape[0]
    rec = t.records
    assert rec.dtype == torch.int32
    assert torch.equal(rec[:, 0], hv.int())
    assert torch.equal(rec[:, 1], cl[hv])
    if T == 1:
        assert t.access is None and rec.shape == (len(hv), 4)
        assert torch.equal(rec[:, 2], acc[hv])
        assert torch.equal(rec[:, 3].view(torch.float32), accr[hv])
    else:
        assert rec.shape == (len(hv), 2)
        assert t.access.shape == (*acc.shape, 2)
        assert torch.equal(t.access[..., 0], acc)
        assert torch.equal(t.access[..., 1].view(torch.float32), accr)
    assert torch.equal(t.core[..., 0], cc)
    assert torch.equal(t.core[..., 1].view(torch.float32), ccr)
    H = len(hv)
    s, d = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    s, d = s.ravel(), d.ravel()
    for e in range(T):
        ev = np.full(len(s), e)
        lat, rel = mirror_ends(t, s, d, ev)
        ep = None if T == 1 else torch.from_numpy(ev)
        want_l = table_lookup(world["lat"], hv[s], hv[d], ep)
        want_r = table_lookup(world["rel"], hv[s], hv[d], ep)
        np.testing.assert_array_equal(lat, want_l.numpy())
        np.testing.assert_array_equal(rel.view(np.int32),
                                      want_r.numpy().view(np.int32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mirror_equals_judge_batch_plain(name):
    """Keys from the table, ends from the records: equal to the yardstick
    on a batch whose outside ids include -1 and -2; drops on both sides
    of the bootstrap end's rule, and among the outside senders."""
    judge = port_judge(name)
    batch = batch_of(name, judge, for_jax=False)
    d, t = mirror(judge.tables, judge.boot_end, *batch)
    dp, tp = _plain(judge, batch)
    np.testing.assert_array_equal(d, dp)
    np.testing.assert_array_equal(t, tp)
    now, src = batch[0], batch[1]
    H = judge.world["host_vertex"].shape[0]
    assert d[now < judge.boot_end].all()
    assert (~d[now >= judge.boot_end]).any()
    assert (~d[(src < 0) | (src >= H)]).any()


def test_outside_sender_takes_the_full_chain():
    """A sender outside [0, H) rolls on the chain of its raw id: the
    table's key of the clamped host would give other verdicts."""
    judge = port_judge("dense")
    t = judge.tables
    H = judge.world["host_vertex"].shape[0]
    batch = batch_of("dense", judge, for_jax=False)
    now, src, dst, seq = batch
    out = (src < 0) | (src >= H)
    keys = t.keys.numpy().view(np.uint32)[np.clip(src, 0, H - 1)]
    u_clamped = nprng.uniform01(nprng.fold_in(
        (keys[:, 0], keys[:, 1]), seq.astype(np.uint32)))
    seed = [int(x) for x in judge.world["seed_key"].reshape(-1).tolist()]
    u_raw = nprng.packet_uniform((seed[0] << 32) | seed[1],
                                 PURPOSE_PACKET_DROP, src.astype(np.uint32),
                                 seq.astype(np.uint32))
    assert (u_clamped != u_raw)[out].all()
    np.testing.assert_array_equal(u_clamped[~out], u_raw[~out])
    d, _ = mirror(t, judge.boot_end, *batch)
    dp, _ = _plain(judge, batch)
    np.testing.assert_array_equal(d, dp)


# ----------------------------------------------------------------------
# DeviceJudge and the wrapper on the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("before", [False, True])
def test_device_judge_on_the_cpu_counts_and_times(before):
    """The CPU judge (the plain path, either design) returns the
    yardstick's verdicts, counts batches and packets, times its host
    wall in `judge_s`, builds nothing and launches nothing."""
    kernels = Kernels()
    kernels.designs_before = before
    judge = port_judge("factored_epochs", kernels)
    batch = batch_of("factored_epochs", judge, for_jax=False)
    d, t = judge.judge_batch(*(a[:1500] for a in batch))
    d2, t2 = judge.judge_batch(*(a[1500:] for a in batch))
    dp, tp = _plain(judge, batch)
    np.testing.assert_array_equal(np.concatenate([d, d2]), dp)
    np.testing.assert_array_equal(np.concatenate([t, t2]), tp)
    c = judge.counters()
    assert (c["batches"], c["packets"]) == (2, N)
    assert c["judge_s"] > 0.0
    assert c["kernel_ms"] == c["copy_ms"] == c["flush_s"] == 0.0
    assert set(c) == {"batches", "packets", "cpu_batches", "cpu_packets",
                      "min_batch", "flush_s", "judge_s", "kernel_ms",
                      "copy_ms"}
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)
    assert kernels._lib is None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_name_the_launch_and_stay_off_the_card(name):
    """`judge_tables` on the CPU names the view's launch and builds no
    argument block; the wrapper takes the plain path on them."""
    judge = port_judge(name)
    t = judge.tables
    hier = name in FACTORED
    epochs = name.endswith("epochs")
    assert t.name == "judge_batch" + ("_ep" if epochs else "") + \
        ("_hier" if hier else "")
    assert t.args is None
    H = judge.world["host_vertex"].shape[0]
    if hier:
        assert t.records.shape == (H, 2 if epochs else 4)
        assert torch.equal(t.records[:, 0], judge.world["host_vertex"])
    else:
        assert t.records is None
    assert (t.core is None) == (not hier)
    assert (t.access is None) == (not (hier and epochs))
    batch = batch_of(name, judge, for_jax=True)
    kernels = Kernels()
    d, tt = kernels.judge_batch(t, judge.boot_end,
                                *(torch.from_numpy(a) for a in batch))
    dp, tp = _plain(judge, batch)
    np.testing.assert_array_equal(d.numpy(), dp)
    np.testing.assert_array_equal(tt.numpy(), tp)
    assert kernels.launches == dict.fromkeys(KERNEL_NAMES, 0)


def test_judge_tables_refuse_a_campaign_world():
    judge = port_judge("dense")
    w = judge.world
    campaign = {**w, "lat": torch.stack([w["lat"]] * 2),
                "rel": torch.stack([w["rel"]] * 2),
                "epoch_times": torch.stack([w["epoch_times"]] * 2),
                "seed_key": torch.cat([w["seed_key"]] * 2)}
    with pytest.raises(ValueError, match="replica"):
        judge_tables(campaign)


# ----------------------------------------------------------------------
# against the JAX package, in the child
# ----------------------------------------------------------------------
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


def _pairs(judge):
    """Every ordered pair of host rows, in every epoch: (sv, dv, e) as
    vertex ids and epochs, and the host rows."""
    world = judge.world
    hv = world["host_vertex"].numpy()
    H, T = len(hv), world["epoch_times"].shape[0]
    s, d, e = np.meshgrid(np.arange(H), np.arange(H), np.arange(T),
                          indexing="ij")
    s, d, e = s.ravel(), d.ravel(), e.ravel()
    return hv[s], hv[d], e, s, d


def _job() -> dict:
    jobs = {}
    for name in CONFIGS:
        source, overrides, is_file = _source(name)
        judge = port_judge(name)
        sv, dv, e, _, _ = _pairs(judge)
        jobs[name] = {
            "source": source, "overrides": overrides, "is_file": is_file,
            "H": int(judge.world["host_vertex"].shape[0]),
            "batch": [a.tolist() for a in batch_of(name, judge, True)],
            "pairs": [sv.tolist(), dv.tolist(), e.tolist()]}
    return jobs


@pytest.fixture(scope="module", autouse=True)
def reference_child():
    with tempfile.TemporaryDirectory(prefix="torch_judge_batch_ref_") as d:
        child = ReferenceChild(_job(), d)
        try:
            yield child
        finally:
            child.stop()


@pytest.fixture(scope="module")
def reference(reference_child):
    return reference_child.result()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_drop_keys_equal_jax_purpose_id_key(name, reference):
    judge = port_judge(name)
    np.testing.assert_array_equal(judge.tables.keys.numpy().view(np.uint32),
                                  reference[f"{name}/keys"])


@pytest.mark.parametrize("name", FACTORED)
def test_records_compose_as_jax_gather_parts(name, reference):
    """Records, packed access and core pairs, composed as the kernel
    composes them, equal the JAX gather_parts on every ordered host pair
    in every epoch."""
    judge = port_judge(name)
    _, _, e, s, d = _pairs(judge)
    lat, rel = mirror_ends(judge.tables, s, d, e)
    np.testing.assert_array_equal(lat, reference[f"{name}/gather_lat"])
    np.testing.assert_array_equal(
        rel.view(np.int32),
        reference[f"{name}/gather_rel"].astype(np.float32).view(np.int32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mirror_equals_jax_device_judge(name, reference):
    """The mirror, and judge_batch_plain, equal the JAX DeviceJudge on a
    batch whose outside ids lie below -H, in [-H, -1] and from H
    upwards."""
    judge = port_judge(name)
    batch = batch_of(name, judge, for_jax=True)
    d, t = mirror(judge.tables, judge.boot_end, *batch)
    np.testing.assert_array_equal(d, reference[f"{name}/delivered"])
    np.testing.assert_array_equal(t, reference[f"{name}/time"])
    dp, tp = _plain(judge, batch)
    np.testing.assert_array_equal(dp, d)
    np.testing.assert_array_equal(tp, t)
    H = judge.world["host_vertex"].shape[0]
    src = batch[1]
    assert ((src < -H) | (src >= H)).any()
    assert ((src >= -H) & (src < 0)).any()
    assert ((batch[2] >= -H) & (batch[2] < 0)).any()
    assert (~d).any()


def _reference_main(job_path: str, out_path: str) -> None:
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    sys.path.insert(0, ROOT)
    from shadow_tpu._jax import jnp
    from shadow_tpu.config import load_config as rload
    from shadow_tpu.config import load_config_str as rload_str
    from shadow_tpu.core.controller import build as rbuild
    from shadow_tpu.device import prng as rprng
    from shadow_tpu.device.judge import DeviceJudge as RefJudge
    from shadow_tpu.topology import hierarchy as rhier
    from shadow_tpu.utils.rng import PURPOSE_PACKET_DROP as DROP

    with open(job_path) as f:
        jobs = json.load(f)
    out = {}
    for name, b in jobs.items():
        cfg = (rload(b["source"], b["overrides"]) if b["is_file"]
               else rload_str(b["source"], b["overrides"]))
        sim = rbuild(cfg)
        k1, k2 = rprng.purpose_id_key(rprng.seed_key(cfg.general.seed),
                                      DROP, np.arange(b["H"]))
        out[f"{name}/keys"] = np.stack([np.asarray(k1), np.asarray(k2)], 1)
        judge = RefJudge(sim.topology, sim.netmodel.host_vertex,
                         cfg.general.seed,
                         bootstrap_end=cfg.general.bootstrap_end_time,
                         fault_table=sim.fault_table)
        now, src, dst, seq = (np.asarray(a) for a in b["batch"])
        d, t = judge.judge_batch(now.astype(np.int64), src.astype(np.int32),
                                 dst.astype(np.int32), seq.astype(np.int32))
        out[f"{name}/delivered"] = np.asarray(d)
        out[f"{name}/time"] = np.asarray(t)
        lat, rel, ep = rhier.world_tables(sim.topology, sim.fault_table)
        if isinstance(lat, tuple):
            sv, dv, e = (jnp.asarray(np.asarray(a, np.int32))
                         for a in b["pairs"])
            e = None if ep is None else e
            for kind, parts in (("lat", lat), ("rel", rel)):
                out[f"{name}/gather_{kind}"] = np.asarray(
                    rhier.gather_parts(tuple(jnp.asarray(p) for p in parts),
                                       sv, dv, e))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
