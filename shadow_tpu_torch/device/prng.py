"""Threefry-2x32 counter RNG on torch tensors (the port of the reference
package's device/prng.py).

The same algorithm, bit for bit, as the JAX reference and its numpy
twin: keys chain seed -> purpose -> id -> seq, each fold being
threefry(k, (0, uint32(data))). This is the plain PyTorch form; the
CUDA kernels carry the same function as device code
(csrc/threefry.cuh).

torch on the CPU has no uint32 add or shift kernels, so a u32 value is
held in an int64 tensor in [0, 2**32) and every step is masked back to
32 bits. Arguments may be tensors of any integer dtype (an int32 -1 is
the u32 0xFFFFFFFF) or Python ints; they broadcast.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def u32(x):
    """Reinterpret an integer tensor (or int) as u32, held in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    k1, k2, x0, x1 = u32(k1), u32(k2), u32(x0), u32(x1)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for block in range(5):
        for r in (_ROT_A if block % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def seed_key(seed: int) -> tuple[int, int]:
    """Python-int seed -> (k1, k2) u32 pair."""
    seed = int(seed) & 0xFFFF_FFFF_FFFF_FFFF
    return seed >> 32, seed & M32


def fold_in(key, data):
    k1, k2 = key
    return threefry2x32(k1, k2, 0, data)


def random_bits32(key):
    k1, k2 = key
    b1, b2 = threefry2x32(k1, k2, 0, 0)
    return b1 ^ b2


def uniform01(key) -> torch.Tensor:
    """Uniform float32 in [0, 1): the mantissa-fill trick,
    (bits >> 9) | 0x3F800000 read as float32, minus 1."""
    bits = random_bits32(key)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def purpose_id_key(seed_pair, purpose: int, ids):
    """The first two chain_key folds, (purpose, id), at the ids'
    shape; fold_seq(purpose_id_key(s, p, ids), seqs) equals
    chain_key(s, p, ids, seqs)."""
    return fold_in(fold_in(seed_pair, purpose), ids)


def fold_seq(key, seqs):
    """The last chain_key fold: fold_in(key, seqs), broadcast."""
    return fold_in(key, seqs)


def chain_key(seed_pair, purpose: int, ids, seqs):
    """fold(fold(fold(seed, purpose), id), seq), broadcast over
    ids/seqs."""
    return fold_seq(purpose_id_key(seed_pair, purpose, ids), seqs)
