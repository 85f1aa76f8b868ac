"""K5 (SHA-256 compression) and K6 (HMAC-SHA256 verify) of the port on
the CPU, where their wrappers run the plain PyTorch versions, against the
JAX package and the standard library.

- plain compression against the JAX ``compress_batch`` (16 random lanes)
  and multi-block digests through ``pad_message`` against ``hashlib``;
- plain HMAC verify against the JAX ``hmac_verify_kernel_packed`` and
  Python's ``hmac`` on 16 lanes, forged lanes and zero rows included;
- the port engine's ``_dispatch_hmac`` against the reference engine's on
  the same items: the staged rows (padding lanes included) and the
  verdicts; and the port engine's ``verify_hmac_sha256`` queue.

Inputs are made from a numpy seed; all comparisons are exact."""

import asyncio
import hashlib
import hmac as py_hmac

import numpy as np
import pytest
import torch

from minbft_tpu.ops import hmac_sha256 as ref_hmac
from minbft_tpu.ops import sha256 as ref_sha
from minbft_tpu.parallel import BatchVerifier as RefBatchVerifier
from minbft_tpu_torch.ops import hmac_sha256, sha256
from minbft_tpu_torch.parallel import BatchVerifier

_LANES = 16


def _u32(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def test_host_helpers_match_the_reference():
    for data in (b"", b"abc", b"a" * 119):
        np.testing.assert_array_equal(sha256.pad_message(data), ref_sha.pad_message(data))
    words = _u32(np.random.default_rng(0), 8)
    assert sha256.words_to_bytes(words) == ref_sha.words_to_bytes(words)
    np.testing.assert_array_equal(
        sha256.bytes_to_words(words.tobytes()), ref_sha.bytes_to_words(words.tobytes())
    )
    np.testing.assert_array_equal(sha256.IV, ref_sha.IV)
    np.testing.assert_array_equal(sha256._K, ref_sha._K)


def test_plain_compress_matches_jax_compress_batch():
    rng = np.random.default_rng(1)
    state, block = _u32(rng, _LANES, 8), _u32(rng, _LANES, 16)
    state[0] = sha256.IV
    want = np.asarray(ref_sha.compress_batch(state, block))
    got = sha256.sha256_compress(sha256.as_i32(state), sha256.as_i32(block))
    np.testing.assert_array_equal(sha256.as_u32(got), want)


@pytest.mark.parametrize("length", [0, 3, 55, 56, 64, 119, 301])
def test_plain_multiblock_digest_matches_hashlib(length):
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    blocks = torch.from_numpy(sha256.pad_message(data).astype(np.int64))[None]
    digest = sha256.sha256_fixed(blocks)
    assert sha256.words_to_bytes(sha256.as_u32(digest[0])) == hashlib.sha256(data).digest()


def _hmac_rows(seed):
    """16 rows of key | msg | mac: honest lanes, one flipped bit in the
    mac (lane 3), the key (lane 7) and the message (lane 11), and two
    all-zero rows (lanes 14 and 15, engine padding)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((_LANES, 24), dtype=np.uint32)
    for i in range(_LANES - 2):
        key, msg = rng.bytes(32), rng.bytes(32)
        mac = py_hmac.new(key, msg, hashlib.sha256).digest()
        rows[i] = np.frombuffer(key + msg + mac, dtype=">u4")
    rows[3, 20] ^= np.uint32(1 << 7)
    rows[7, 2] ^= np.uint32(1)
    rows[11, 15] ^= np.uint32(1 << 31)
    return rows


def test_plain_hmac_verify_matches_jax_and_python_hmac():
    rows = _hmac_rows(2)
    got = hmac_sha256.hmac_verify_kernel_packed(sha256.as_i32(rows)).numpy()
    want = np.asarray(ref_hmac.hmac_verify_kernel_packed(rows))
    np.testing.assert_array_equal(got, want)
    py = []
    for r in rows:
        b = r.astype(">u4").tobytes()
        py.append(py_hmac.compare_digest(
            py_hmac.new(b[:32], b[32:64], hashlib.sha256).digest(), b[64:]))
    np.testing.assert_array_equal(got, py)
    assert got.tolist() == [i not in (3, 7, 11, 14, 15) for i in range(_LANES)]


def _items(seed, n):
    rows = _hmac_rows(seed)[:n]
    return [tuple(r.astype(">u4").tobytes()[k : k + 32] for k in (0, 32, 64)) for r in rows]


def test_dispatch_hmac_matches_the_reference_engine(monkeypatch):
    """Same items, one dispatch each: the rows each engine hands its
    kernel (the 8-lane bucket, padding lanes included) and the verdicts
    agree exactly."""
    import minbft_tpu.ops.hmac_sha256 as ref_mod
    import minbft_tpu_torch.ops.hmac_sha256 as port_mod

    seen = {}

    def spy(name, fn, to_np):
        def wrapped(rows):
            seen[name] = to_np(rows)
            return fn(rows)
        return wrapped

    monkeypatch.setattr(ref_mod, "hmac_verify_kernel_packed", spy(
        "ref", ref_mod.hmac_verify_kernel_packed, lambda r: np.asarray(r).copy()))
    monkeypatch.setattr(port_mod, "hmac_verify_kernel_packed", spy(
        "port", port_mod.hmac_verify_kernel_packed, lambda r: sha256.as_u32(r).copy()))
    items = _items(3, 12)[3:8]  # lanes 3 and 7 of the rows are forged
    ref_engine = RefBatchVerifier(max_batch=8, buckets=(8,))
    port_engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu")
    for eng in (ref_engine, port_engine):  # the stats slot a dispatch fills
        eng._queue("hmac_sha256", eng._dispatch_hmac)
    want = ref_engine._dispatch_hmac(items)
    got = port_engine._dispatch_hmac(items)
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    assert seen["port"].shape == (8, 24) and not seen["port"][5:].any()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [False, True, True, True, False]
    assert port_engine.stats["hmac_sha256"].padded_lanes == 3


def test_verify_hmac_sha256_queue_batches_and_dedups():
    items = _items(4, 6)
    engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu")
    engine.enable_obs_ring()

    async def run():
        return await asyncio.gather(
            *[engine.verify_hmac_sha256(*it) for it in items + items[:2]]
        )

    assert asyncio.run(run()) == [i != 3 for i in range(6)] + [True, True]
    st = engine.stats["hmac_sha256"]
    assert (st.items, st.batches, st.memo_hits, st.padded_lanes) == (6, 1, 2, 2)
    assert st.dispatch_timeouts == 0
    assert [e[0] for e in engine.drain_obs_events()] == ["hmac_sha256"]
