"""Device-state checkpoint and resume (the port's copy of the reference
package's device/checkpoint.py, in its file format, so that either
package resumes a checkpoint the other wrote).

A run's state is a dict of tensors under the reference's leaf names and
dtypes (device/engine.py), so a checkpoint is the state read back to
the host and written as one .npz: a JSON `__meta__` entry (`format`,
the pause `sim_time`, the run's global stop `final_stop`, the engine
`fingerprint`, the shard `geometry`, every `capacities` knob, the
`exchange` schedule, the leaf `keys` in the reference's key-path order,
e.g. `['ht']`, and, where present, the campaign stamp `ensemble` and
the supervisor's `audit` stamp) and one array `leaf_i` per key, written
with np.savez_compressed through an atomic tmp + rename
(utils/artifacts.py).

Bit-identity: a paused then resumed run equals the uninterrupted one,
because `DeviceEngine.run` clamps every window on the global stop
(`final_stop`), not the pause; the runner passes the same stop on both
sides, and a load under another stop is refused.

The fingerprint pins what determines the state's layout and the trace:
host count, the two layout capacities, seed, the model NIC, the app's
class and scalars, and a hash of the world (host vertices, latency and
reliability, dense or factored, the NIC bandwidths and, under a fault
schedule, the epoch start times). The port's own tables are GPU-shaped
(drop thresholds, factored records), so the hash is taken over the
reference engine's view of the same world (`reference_tables`): its
dtypes, its squeezed single epoch, its hosts padded to the mesh.

A loaded state enters the engine from outside: `load_state` places it
through capacity.transfer, which arms the engine (the next merge checks
every heap's order, the next pop clears every outbox row).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Optional

import numpy as np

log = logging.getLogger("shadow_tpu_torch.checkpoint")

FORMAT = 1
# the heap rows' empty-slot time (device/kernels.py INF): a live row's
# time lies below it
_INF = np.int64(1) << np.int64(62)


def probe_writable(path: str) -> None:
    """Fail on an unwritable checkpoint_save path now, in milliseconds,
    before a warm-up spends minutes and not after a long run; the probe
    leaves no zero-byte decoy behind."""
    existed = os.path.lexists(path)
    try:
        with open(path, "ab"):
            pass
    except OSError as e:
        raise ValueError(
            f"checkpoint_save path {path!r} is not writable: "
            f"{e}") from e
    if not existed:
        os.unlink(path)


def prevalidate_resume(path: str, stop: int, save_path: str = "",
                       save_time: int = 0) -> int:
    """Check the resume parameters from the npz meta alone (no array
    payloads), for the same fail-fast reason as probe_writable. Returns
    the saved pause time."""
    t_peek = int(peek_meta(path)["sim_time"])
    if t_peek >= stop:
        raise ValueError(
            f"checkpoint_load: saved state pauses at {t_peek} ns, "
            f"at/after stop_time {stop} ns — nothing to resume")
    if save_path and save_time and min(stop, save_time) <= t_peek:
        raise ValueError(
            f"checkpoint_save_time {min(stop, save_time)} ns is not "
            f"after the run's start time {t_peek} ns")
    return t_peek


def reference_tables(engine) -> tuple[list, int]:
    """(the arrays the reference engine hashes into its world digest,
    in its order; the number of fault epochs): the engine's
    `reference_world` normalized as the reference's DeviceEngine
    normalizes its arguments (engine.py:259-334): hosts padded to
    H_pad (vertex 0, bandwidth 1 Gbit/s, bandwidths floored at 1), a
    single epoch squeezed, latency leaves int32, reliability float32
    (the factored cluster-of vector int32)."""
    hv, lat, rel, epoch_times, up, down = engine.reference_world
    H, H_pad = int(engine.config.n_hosts), int(engine.H_pad)
    hier = isinstance(lat, tuple)
    if hier:
        lat = tuple(np.asarray(p) for p in lat)
        rel = tuple(np.asarray(p) for p in rel)
        n_epochs = lat[0].shape[0] if lat[0].ndim == 3 else 1
    else:
        lat, rel = np.asarray(lat), np.asarray(rel)
        n_epochs = lat.shape[0] if lat.ndim == 3 else 1
    if epoch_times is None:
        epoch_times = np.zeros(n_epochs, dtype=np.int64)
    epoch_times = np.asarray(epoch_times, dtype=np.int64)
    if n_epochs == 1:
        if hier and lat[0].ndim == 3:
            lat = tuple(p[0] for p in lat)
            rel = tuple(p[0] for p in rel)
        elif not hier and lat.ndim == 3:
            lat, rel = lat[0], rel[0]
    vertex = np.zeros(H_pad, dtype=np.int32)
    vertex[:H] = np.asarray(hv)
    if hier:
        lat = tuple(p.astype(np.int32) for p in lat)
        rel = tuple(p.astype(np.int32 if i == 1 else np.float32)
                    for i, p in enumerate(rel))
    else:
        lat, rel = lat.astype(np.int32), rel.astype(np.float32)
    bw = []
    for given in (up, down):
        b = np.full(H_pad, 10**9, dtype=np.int64)
        if given is not None:
            b[:H] = np.maximum(1, np.asarray(given))
        bw.append(b)
    arrs = [vertex]
    for t in (lat, rel):
        arrs.extend(t if isinstance(t, tuple) else (t,))
    arrs += bw
    if len(epoch_times) > 1:
        arrs.append(epoch_times)
    return arrs, len(epoch_times)


def _fingerprint(engine) -> dict:
    """The engine fingerprint of checkpoint.py:86-147: the shard
    geometry stays out of it (its readable `geometry` keys name a
    mismatch), burst_pops too (a width that never changes the trace)."""
    import hashlib

    from shadow_tpu_torch.device.capacity import app_scalars

    cfg = engine.config
    arrs, n_epochs = reference_tables(engine)
    h = hashlib.sha256()
    for arr in arrs:
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(json.dumps(app_scalars(engine.app), sort_keys=True).encode())
    fp = {
        "n_hosts": int(cfg.n_hosts),
        "event_capacity": int(cfg.event_capacity),
        "outbox_capacity": int(cfg.outbox_capacity),
        "seed": int(cfg.seed),
        "model_bandwidth": bool(cfg.model_bandwidth),
        "app": type(engine.app).__name__,
        "world": h.hexdigest(),
    }
    if n_epochs > 1:
        fp["fault_epochs"] = int(n_epochs)
    return fp


def _key(name: str) -> str:
    """A leaf's key path as the reference writes it (jax `keystr`)."""
    return f"['{name}']"


def host_state(engine, state) -> Optional[dict]:
    """A state's leaves as numpy arrays in the reference's global
    layout: on a mesh the ranks' rows gathered to rank 0 (every rank
    must call; None on the others), shard-major as the reference's
    arrays are (runner.gather_state; a campaign's along its host axis,
    [R, H_pad, ...])."""
    leaves = {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
              for k, v in state.items()}
    if engine.mesh is not None:
        return engine.mesh.gather_leaves(
            leaves, axis=0 if engine.replicas is None else 1)
    return leaves


def save_state(engine, state, path: str, sim_time: int,
               final_stop: int = 0, extra_meta: Optional[dict] = None,
               audit_meta: Optional[dict] = None) -> Optional[dict]:
    """Write `state` (tensors of this engine, or numpy leaves already
    gathered) with its pause `sim_time`, the run's global stop, the
    fingerprint, geometry and capacities to `path`. `extra_meta` (a
    campaign's stamp) lands under meta["ensemble"]: its presence marks
    a campaign checkpoint, which standalone runs refuse. On a mesh every
    rank calls and rank 0 writes. Returns {"path", "bytes", "wall_s"}
    (the host read, the compression and the write), None on the other
    ranks."""
    from shadow_tpu_torch.device.capacity import CAPACITY_KNOBS
    from shadow_tpu_torch.utils.artifacts import atomic_write

    t0 = time.perf_counter()
    leaves = host_state(engine, state)
    if leaves is None:
        return None
    names = sorted(leaves)
    meta = {
        "format": FORMAT,
        "sim_time": int(sim_time),
        "final_stop": int(final_stop),
        "fingerprint": _fingerprint(engine),
        "geometry": {"n_shards": int(engine.n_shards),
                     "h_pad": int(engine.H_pad),
                     "h_loc": int(engine.H_loc)},
        "capacities": {k: int(getattr(engine.config, k))
                       for k in CAPACITY_KNOBS},
        "exchange": str(engine.effective["exchange"]),
        "keys": [_key(k) for k in names],
    }
    if extra_meta:
        meta["ensemble"] = dict(extra_meta)
    if audit_meta is not None:
        meta["audit"] = dict(audit_meta)
    arrays = {f"leaf_{i}": leaves[k] for i, k in enumerate(names)}
    atomic_write(path, lambda f: np.savez_compressed(
        f, __meta__=json.dumps(meta), **arrays))
    io = {"path": path, "bytes": os.path.getsize(path),
          "wall_s": time.perf_counter() - t0}
    log.info("checkpoint t=%d ns -> %s: %d B in %.3f s", sim_time, path,
             io["bytes"], io["wall_s"])
    return io


def peek_meta(path: str) -> dict:
    """The npz meta alone (no array payloads): to adopt a checkpoint's
    capacities before loading, and to check resume parameters in
    milliseconds."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def peek_fingerprint(path: str) -> dict:
    return peek_meta(path)["fingerprint"]


def peek_geometry(meta: dict) -> dict:
    """The shard-geometry stamp of a checkpoint's meta; checkpoints
    before the stamp carried only h_pad, inside the fingerprint."""
    geom = meta.get("geometry")
    if geom is not None:
        return dict(geom)
    fp = meta.get("fingerprint") or {}
    return ({"h_pad": int(fp["h_pad"])} if "h_pad" in fp else {})


def validate_geometry(path: str, meta: dict, engine) -> None:
    """Refuse a geometry mismatch with a readable message naming the
    shard counts and padded widths."""
    geom = peek_geometry(meta)
    if not geom:
        return
    saved_n = geom.get("n_shards")
    saved_pad = geom.get("h_pad")
    if (saved_n is not None and int(saved_n) != engine.n_shards) or \
            (saved_pad is not None and int(saved_pad) != engine.H_pad):
        raise ValueError(
            f"checkpoint {path}: saved on "
            f"{saved_n if saved_n is not None else '?'} shard(s) "
            f"(H_pad {saved_pad}), loading on {engine.n_shards} "
            f"(H_pad {engine.H_pad}) — resume on a mesh of the saved "
            "shard count (the tpu runner adopts it automatically "
            "from this stamp; experimental.mesh_shards pins it by "
            "hand), or re-run from scratch")


def _read(path: str) -> tuple[dict, dict]:
    """(meta, {key path: array}) of a checkpoint, its format checked."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"checkpoint {path}: format {meta.get('format')} "
                f"(this build reads format {FORMAT})")
        saved = {k: z[f"leaf_{i}"] for i, k in enumerate(meta["keys"])}
    return meta, saved


def load_host_state(path: str):
    """Raw host-side leaves and meta with no engine validation; keys
    come back plain (``"['ht']"`` -> ``"ht"``). Returns (state, meta)."""
    meta, saved = _read(path)
    state = {}
    for k, v in saved.items():
        m = re.fullmatch(r"\['(\w+)'\]", k)
        if not m:
            raise ValueError(
                f"checkpoint {path}: unexpected state key {k!r}")
        state[m.group(1)] = v
    return state, meta


def _aux(k: str) -> bool:
    """Leaves that may differ between the saving and the resuming
    engine without touching the trace (checkpoint.py:366): the occ_*
    marks and the audit's aud* leaves."""
    return "'occ_" in k or "'aud" in k


def load_state(engine, template: dict, path: str, final_stop: int = 0):
    """Load a checkpoint onto `engine`, whose initial leaves (numpy;
    engine.init_arrays: a campaign's with its [R] axis, a mesh rank's
    own rows) are `template`: the format, the run's global stop, a
    campaign stamp against a standalone engine, the geometry, the
    fingerprint and every leaf's key, shape and dtype are checked, the
    rank's rows taken on a mesh, a missing audit ledger reseeded from
    the saved counters, other missing auxiliary leaves taken from the
    template, and the state placed and armed (capacity.transfer).
    Returns (state, sim_time, {"bytes", "wall_s"})."""
    from shadow_tpu_torch.device import capacity

    t0 = time.perf_counter()
    meta, saved = _read(path)
    saved_stop = int(meta.get("final_stop", 0))
    if final_stop and saved_stop and saved_stop != final_stop:
        raise ValueError(
            f"checkpoint {path} was saved for a run with stop_time "
            f"{saved_stop} ns; this run stops at {final_stop} ns — "
            "the saved prefix's event windows were clamped on the "
            "original stop, so resuming toward a different one would "
            "not bit-match an uninterrupted run (re-run from scratch "
            "or restore the original stop_time)")
    if meta.get("ensemble") and engine.replicas is None:
        raise ValueError(
            f"checkpoint {path} was saved by an ensemble campaign "
            f"({meta['ensemble']}); a standalone run cannot resume "
            "it — load it under the same ensemble config")
    validate_geometry(path, meta, engine)
    fp, want = dict(meta["fingerprint"]), _fingerprint(engine)
    fp.pop("h_pad", None)
    if fp != want:
        diffs = {k: (fp.get(k), want[k]) for k in want
                 if fp.get(k) != want[k]}
        raise ValueError(
            f"checkpoint {path} does not match this simulation "
            f"(saved vs configured): {diffs}")
    want_keys = [_key(k) for k in sorted(template)]
    saved_keys = list(meta["keys"])
    missing = [k for k in want_keys if k not in saved_keys]
    extra = [k for k in saved_keys if k not in want_keys]
    aux_only = all(_aux(k) for k in missing) and \
        all(_aux(k) for k in extra) and \
        [k for k in saved_keys if k not in extra] == \
        [k for k in want_keys if k not in missing]
    if want_keys != saved_keys and not aux_only:
        raise ValueError(
            f"checkpoint {path}: state layout changed "
            f"(saved keys != this engine's state keys)")
    leaves = {k[2:-2]: v for k, v in saved.items() if k not in extra}
    mp = engine.mesh_params
    if mp is not None:
        from shadow_tpu_torch.device.runner import shard_state

        leaves = shard_state(leaves, mp,
                             axis=0 if engine.replicas is None else 1)
    if "aud_tx" in template and "aud_tx" not in leaves:
        # the conservation ledger reseeded from the saved counters, so
        # that rows produced == rows popped + live + counted lost holds
        # at the resume point (the audit balances the sum)
        E = leaves["ht"].shape[-1]
        live = ((np.arange(E) >= leaves["head"][..., None])
                & (leaves["ht"] < _INF)).sum(-1)
        leaves["aud_tx"] = (leaves["n_exec"].astype(np.int64) + live
                            + leaves["overflow"].astype(np.int64)
                            + leaves["x_overflow"].astype(np.int64))
    for k, tmpl in template.items():
        if k not in leaves:
            leaves[k] = np.array(tmpl)
            continue
        arr = leaves[k]
        if arr.shape != tmpl.shape or arr.dtype != tmpl.dtype:
            raise ValueError(
                f"checkpoint {path}: leaf {_key(k)} is "
                f"{arr.shape}/{arr.dtype}, engine expects "
                f"{tmpl.shape}/{tmpl.dtype}")
    state = capacity.transfer(engine, leaves, template)
    io = {"bytes": os.path.getsize(path),
          "wall_s": time.perf_counter() - t0}
    log.info("checkpoint %s loaded at t=%d ns: %d B in %.3f s", path,
             int(meta["sim_time"]), io["bytes"], io["wall_s"])
    return state, int(meta["sim_time"]), io
