"""Atomic artifact writes (the port's copy of the reference package's
utils/artifacts.py `atomic_write` and `atomic_write_json`).

Every JSON or state artifact the port writes (OCC_*.json occupancy
records, ENSEMBLE_*.json campaign records, device checkpoints) lands
whole or not at all: the payload goes to a sibling tmp file named with
the pid, is fsync'd, and os.replace()s the target, so a reader sees the
old content or the new, never a prefix, and a kill mid-write leaves the
previous file (the previous rotation entry of a checkpoint) in place.
"""

from __future__ import annotations

import json
import os


def atomic_write(path: str, write_fn, mode: str = "wb") -> None:
    """Write via `write_fn(file_object)` into `path + .<pid>.tmp`,
    fsync, then atomically os.replace into place. On any failure the
    tmp file is removed: no decoy artifacts."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(obj, path: str, **json_kwargs) -> None:
    """Serialize `obj` before opening the tmp file (a non-serializable
    object must not even leave a tmp behind), then write atomically."""
    json_kwargs.setdefault("indent", 1)
    json_kwargs.setdefault("sort_keys", True)
    text = json.dumps(obj, **json_kwargs)
    atomic_write(path, lambda f: f.write(text), mode="w")
