"""Deterministic randomness (the port's copy of the reference package's
utils/rng.py, without its jax half).

* The counter-RNG purpose ids: the stable tags that key every
  stochastic decision (purpose -> host id -> seq), so both engines draw
  from the same domains.
* `SeededRandom`, the host-side hierarchy controller -> host: children
  are derived by hashing (parent seed, label), so a host's generator
  does not depend on creation order. The numpy generator is built on
  first use.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

PURPOSE_PACKET_DROP = 1
PURPOSE_HOST_BOOT = 2
PURPOSE_APP = 3
PURPOSE_JITTER = 4
PURPOSE_TOR_ROUTE = 5


def _derive(seed: int, label: str) -> int:
    h = hashlib.blake2b(
        struct.pack("<q", seed) + label.encode(), digest_size=8
    ).digest()
    return struct.unpack("<q", h)[0] & 0x7FFF_FFFF_FFFF_FFFF


class SeededRandom:
    """One node of the controller -> host hierarchy."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._rng = None

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = np.random.Generator(np.random.PCG64(self.seed))
        return self._rng

    def child(self, label: str) -> "SeededRandom":
        return SeededRandom(_derive(self.seed, label))
