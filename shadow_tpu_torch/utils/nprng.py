"""Threefry-2x32 counter RNG in numpy (the port's copy of the reference
package's utils/nprng.py).

The CPU engine (core/) makes the same stochastic decisions, the packet
drop rolls and the apps' draws, as the device kernels, bit for bit,
without a device call per packet: the same chain as device/prng.py
(seed -> purpose -> id -> seq, each fold threefry(k, (0, data))) on
numpy uint32 words. Every function is vectorized.
"""

from __future__ import annotations

import struct

import numpy as np

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher, 20 rounds."""
    with np.errstate(over="ignore"):
        k1 = np.asarray(k1, dtype=np.uint32)
        k2 = np.asarray(k2, dtype=np.uint32)
        x0 = np.asarray(x0, dtype=np.uint32).copy()
        x1 = np.asarray(x1, dtype=np.uint32).copy()
        ks = (k1, k2, k1 ^ k2 ^ _PARITY)

        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for block in range(5):
            rots = _ROT_A if block % 2 == 0 else _ROT_B
            for r in rots:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
        return x0, x1


def seed_key(seed) -> tuple[np.ndarray, np.ndarray]:
    """A 64-bit seed -> its (k1, k2) uint32 key pair."""
    seed = np.asarray(seed, dtype=np.uint64)
    return (seed >> np.uint64(32)).astype(np.uint32), \
        (seed & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def fold_in(key: tuple[np.ndarray, np.ndarray], data
            ) -> tuple[np.ndarray, np.ndarray]:
    """Fold `data` (cast to uint32) into a key pair."""
    k1, k2 = key
    data = np.asarray(data, dtype=np.uint32)
    zero = np.zeros_like(data)
    return threefry2x32(k1, k2, zero, data)


def random_bits32(key: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """32 random bits per key: threefry(k1, k2, 0, 0) -> bits1 ^ bits2."""
    k1, k2 = key
    zero = np.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, zero, zero)
    return b1 ^ b2


def uniform01(key: tuple[np.ndarray, np.ndarray]) -> np.ndarray:
    """A float32 uniform in [0, 1): the mantissa-fill trick."""
    bits = random_bits32(key)
    float_bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return float_bits.view(np.float32) - np.float32(1.0)


def packet_uniform(seed: int, purpose, host_id, seq) -> np.ndarray:
    """The packet decisions' chain: purpose -> host -> seq fold-ins."""
    k = seed_key(seed)
    k = fold_in(k, purpose)
    k = fold_in(k, host_id)
    k = fold_in(k, seq)
    return uniform01(k)


# ---------------------------------------------------------------------
# The same chain on Python ints, for one draw at a time: the CPU
# engine's per-event draws (an app's bits, one packet's drop roll), where
# numpy's per-call overhead on 0-d arrays costs tens of times more.
M32 = 0xFFFFFFFF
def threefry2x32_int(k1: int, k2: int, x0: int, x1: int
                     ) -> tuple[int, int]:
    """threefry2x32 on one block of Python ints in [0, 2**32), its 20
    rounds written out: (13, 15, 26, 6) and (17, 29, 16, 24) in turn,
    a key injection after every four."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    x0 = (x0 + k1) & M32
    x1 = (x1 + k2) & M32
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 13) & M32) | (x1 >> 19)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 15) & M32) | (x1 >> 17)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 26) & M32) | (x1 >> 6)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 6) & M32) | (x1 >> 26)) ^ x0
    x0 = (x0 + k2) & M32
    x1 = (x1 + k3 + 1) & M32
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 17) & M32) | (x1 >> 15)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 29) & M32) | (x1 >> 3)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 16) & M32) | (x1 >> 16)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 24) & M32) | (x1 >> 8)) ^ x0
    x0 = (x0 + k3) & M32
    x1 = (x1 + k1 + 2) & M32
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 13) & M32) | (x1 >> 19)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 15) & M32) | (x1 >> 17)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 26) & M32) | (x1 >> 6)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 6) & M32) | (x1 >> 26)) ^ x0
    x0 = (x0 + k1) & M32
    x1 = (x1 + k2 + 3) & M32
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 17) & M32) | (x1 >> 15)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 29) & M32) | (x1 >> 3)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 16) & M32) | (x1 >> 16)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 24) & M32) | (x1 >> 8)) ^ x0
    x0 = (x0 + k2) & M32
    x1 = (x1 + k3 + 4) & M32
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 13) & M32) | (x1 >> 19)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 15) & M32) | (x1 >> 17)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 26) & M32) | (x1 >> 6)) ^ x0
    x0 = (x0 + x1) & M32
    x1 = (((x1 << 6) & M32) | (x1 >> 26)) ^ x0
    x0 = (x0 + k3) & M32
    x1 = (x1 + k1 + 5) & M32
    return x0, x1


def key_int(seed: int) -> tuple[int, int]:
    """seed_key on a Python int."""
    seed &= 0xFFFF_FFFF_FFFF_FFFF
    return seed >> 32, seed & M32


def fold_in_int(key: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32_int(key[0], key[1], 0, data & M32)


def random_bits32_int(key: tuple[int, int]) -> int:
    b1, b2 = threefry2x32_int(key[0], key[1], 0, 0)
    return b1 ^ b2


def uniform01_int(key: tuple[int, int]) -> float:
    """uniform01 of one key, as a Python float: the float32 in [1, 2)
    of the mantissa-fill trick minus 1, which is exact."""
    bits = (random_bits32_int(key) >> 9) | 0x3F800000
    return struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0
