"""The port's counter RNG and drop rule (shadow_tpu_torch.device.prng,
.netsem) against the reference: the JAX `prng`/`netsem` functions (in a
child process, see test_torch_engine.py for why) and the numpy twin
`shadow_tpu.utils.nprng` (in process). Exact equality, at broadcast
shapes, with ids and seqs at 0 and 0xFFFFFFFF."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from shadow_tpu.utils import nprng
from shadow_tpu_torch.device import netsem, prng
from shadow_tpu_torch.utils.rng import PURPOSE_APP, PURPOSE_PACKET_DROP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 42, 0xFFFF_FFFF_FFFF_FFFF)


def _inputs():
    rng = np.random.default_rng(20261017)
    ids = np.concatenate([[0, 1, 0xFFFFFFFF],
                          rng.integers(0, 2**32, 5)]).astype(np.uint32)
    seqs = np.concatenate([[0, 0xFFFFFFFF, 7],
                           rng.integers(0, 2**32, 3)]).astype(np.uint32)
    now = rng.integers(0, 10**9, (ids.size, seqs.size)).astype(np.int64)
    rel = rng.choice(np.array([0.0, 0.25, 0.9, 0.999, 1.0], np.float32),
                     (ids.size, seqs.size))
    # ids [N,1] broadcast against seqs [1,M]
    return ids[:, None], seqs[None, :], now, rel


def _t(a):
    """numpy u32 -> torch, through int64 (the port's u32 holder)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory(prefix="torch_prng_ref_") as d:
        out = os.path.join(d, "out.npz")
        path = os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
                   SHADOW_TPU_AOT_DIR=os.path.join(d, "aot"))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), out], cwd=d,
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_key_and_bits_match_jax(reference, seed):
    ids, seqs, _, _ = _inputs()
    for purpose in (PURPOSE_APP, PURPOSE_PACKET_DROP):
        k = prng.chain_key(prng.seed_key(seed), purpose, _t(ids), _t(seqs))
        np.testing.assert_array_equal(
            k[0].numpy(), reference[f"{seed}/{purpose}/k1"])
        np.testing.assert_array_equal(
            k[1].numpy(), reference[f"{seed}/{purpose}/k2"])
        np.testing.assert_array_equal(
            prng.random_bits32(k).numpy(),
            reference[f"{seed}/{purpose}/bits"])
        np.testing.assert_array_equal(
            prng.uniform01(k).numpy(), reference[f"{seed}/{purpose}/u"])


@pytest.mark.parametrize("seed", SEEDS)
def test_packet_drop_mask_matches_jax(reference, seed):
    ids, seqs, now, rel = _inputs()
    key = prng.seed_key(seed)
    boot_end = 5 * 10**8
    plain = netsem.packet_drop_mask(key, boot_end, _t(now), _t(ids),
                                    _t(seqs), torch.from_numpy(rel))
    hoisted = netsem.packet_drop_mask(
        key, boot_end, _t(now), None, _t(seqs), torch.from_numpy(rel),
        src_key=prng.purpose_id_key(key, PURPOSE_PACKET_DROP, _t(ids)))
    np.testing.assert_array_equal(plain.numpy(),
                                  reference[f"{seed}/drop"])
    np.testing.assert_array_equal(hoisted.numpy(),
                                  reference[f"{seed}/drop"])


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_matches_numpy_twin(seed):
    ids, seqs, _, _ = _inputs()
    u = prng.uniform01(prng.chain_key(prng.seed_key(seed),
                                      PURPOSE_PACKET_DROP, _t(ids),
                                      _t(seqs)))
    np.testing.assert_array_equal(
        u.numpy(), nprng.packet_uniform(seed, PURPOSE_PACKET_DROP, ids,
                                        seqs))
    k = nprng.fold_in(nprng.fold_in(nprng.fold_in(
        nprng.seed_key(seed), PURPOSE_APP), ids), seqs)
    bits = prng.random_bits32(prng.chain_key(
        prng.seed_key(seed), PURPOSE_APP, _t(ids), _t(seqs)))
    np.testing.assert_array_equal(bits.numpy(), nprng.random_bits32(k))
    x0, x1 = prng.threefry2x32(_t(ids), _t(seqs), _t(seqs), _t(ids))
    n0, n1 = nprng.threefry2x32(ids, seqs, seqs, ids)
    np.testing.assert_array_equal(x0.numpy(), n0)
    np.testing.assert_array_equal(x1.numpy(), n1)


def _reference_main(out_path: str) -> None:
    """The child: apply the jax batching patch, then evaluate the
    reference package's prng/netsem on the same inputs."""
    import jax._src.interpreters.batching as batching

    batching.PrimitiveBatchersProxy.__contains__ = lambda self, k: False
    from shadow_tpu._jax import jnp
    from shadow_tpu.device import netsem as jnetsem
    from shadow_tpu.device import prng as jprng

    ids, seqs, now, rel = _inputs()
    out = {}
    for seed in SEEDS:
        sk = jprng.seed_key(seed)
        for purpose in (PURPOSE_APP, PURPOSE_PACKET_DROP):
            k = jprng.chain_key(sk, purpose, jnp.asarray(ids),
                                jnp.asarray(seqs))
            out[f"{seed}/{purpose}/k1"] = np.asarray(k[0])
            out[f"{seed}/{purpose}/k2"] = np.asarray(k[1])
            out[f"{seed}/{purpose}/bits"] = np.asarray(
                jprng.random_bits32(k))
            out[f"{seed}/{purpose}/u"] = np.asarray(jprng.uniform01(k))
        out[f"{seed}/drop"] = np.asarray(jnetsem.packet_drop_mask(
            sk, 5 * 10**8, jnp.asarray(now), jnp.asarray(ids),
            jnp.asarray(seqs), jnp.asarray(rel)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
