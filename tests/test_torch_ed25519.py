"""The port's Ed25519 path (minbft_tpu_torch/ops/ed25519.py: host prep,
the plain versions of kernels K7 and K8, batched signing, and the
engine's Ed25519 queues) against the JAX reference
(minbft_tpu/ops/ed25519.py, minbft_tpu/parallel/engine.py) and the host
oracles.

- the plain field ops mod 2^255 - 19 against the reference's ``limbs``
  ops, on random and edge values (0, 1, p - 1, 38, a * a^-1);
- ``prepare_batch``, ``prepare_batch_scalar`` and ``prepare_packed`` on
  the adversarial lanes of tests/test_ed25519.py (tampered message, wrong
  key, bit-flipped R, S + L, non-canonical R with y >= p, undecodable
  public key, wrong-length signature) and on an empty batch;
- plain K7 against the reference's ``ed25519_verify_kernel_packed`` and
  ``hostcrypto.ed25519_verify_py``; plain K7' (seven arrays) against the
  reference's packed form on the same lanes; plain K8 against the reference's
  ``ed25519_rb_kernel`` bit for bit, and the comb tables;
- ``sign_batch`` against ``hostcrypto.ed25519_sign`` and the reference's
  ``sign_batch``;
- the CPU engine's Ed25519 verify queue (the rows it stages equal the
  reference engine's, the dedup memo) and sign queue.

The JAX oracle runs at the shapes tests/test_ed25519.py compiles ([8, 82]
rows, [8, 16] nonces), so it compiles once.  Everything is an integer:
comparisons are exact.  Inputs are made from a numpy seed."""

import asyncio
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import undecodable_pub
from minbft_tpu.ops import ed25519 as ref
from minbft_tpu.ops import limbs as ref_limbs
from minbft_tpu.parallel import BatchVerifier as RefBatchVerifier
from minbft_tpu_torch.ops import ed25519 as port
from minbft_tpu_torch.ops import limbs
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.utils import hostcrypto as hc
from test_torch_limbs import _ref_batched

R = 1 << 256
_BUCKET = 8


def _seeds(seed, count):
    g = np.random.default_rng(seed)
    return [g.bytes(32) for _ in range(count)]


@pytest.fixture(scope="module")
def lanes():
    """(items, expected host verdict): 12 lanes of (pub32, msg32, sig)."""
    g = np.random.default_rng(25519)
    seeds = _seeds(1, 3)
    pubs = [hc.ed25519_keygen(s)[1] for s in seeds]
    items = []
    for s, pub in zip(seeds, pubs):
        msg = g.bytes(32)
        items.append((pub, msg, hc.ed25519_sign(s, msg)))
    pub, msg, sig = items[0]
    s_big = int.from_bytes(sig[32:], "little") + hc.ED_L
    y_big = (hc.ED_P + 5) | (sig[31] >> 7 << 255)
    items += [
        (pub, g.bytes(32), sig),  # tampered message
        (pubs[1], msg, sig),  # wrong key
        (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),  # bit-flipped R
        (pub, msg, sig[:32] + s_big.to_bytes(32, "little")),  # S + L
        (pub, msg, y_big.to_bytes(32, "little") + sig[32:]),  # R's y >= p
        (undecodable_pub(hc), msg, sig),  # no curve point
        (pub, msg, sig[:63]),  # wrong length
    ]
    for k in range(2):  # honest again, under a cached key
        msg = g.bytes(32)
        items.append((pubs[0], msg, hc.ed25519_sign(seeds[0], msg)))
    expected = [hc.ed25519_verify_py(*it) for it in items]
    assert expected == [True] * 3 + [False] * 7 + [True] * 2
    assert [hc.ed25519_verify(*it) for it in items] == expected
    return items, expected


@pytest.fixture(scope="module")
def rows(lanes):
    """16 packed rows: the 12 lanes and 4 all-zero pad rows."""
    return port.prepare_packed(lanes[0], 16)


@pytest.fixture(scope="module")
def plain_verdicts(rows):
    return port.ed25519_verify_kernel_packed(torch.from_numpy(rows)).numpy()


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_field_ops_mod_the_ed25519_prime_match_reference(op):
    p = port.P
    g = np.random.default_rng(19)
    edges = [0, 1, p - 1, 38, 19, p - 38]
    rand = [int.from_bytes(g.bytes(40), "little") % p for _ in range(10)]
    a, b = edges + rand, edges[::-1] + rand[::-1]
    la, lb = limbs.to_limbs_batch(a), limbs.to_limbs_batch(b)
    want = np.asarray(_ref_batched(ref.FIELD, getattr(ref_limbs, op))(la, lb))
    got = getattr(limbs, op)(port.FIELD, limbs.fe_tensor(la), limbs.fe_tensor(lb))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    expect = {
        "mont_mul": lambda x, y: x * y * pow(R, -1, p) % p,
        "add_mod": lambda x, y: (x + y) % p,
        "sub_mod": lambda x, y: (x - y) % p,
    }[op]
    assert limbs.from_limbs_batch(got) == [expect(x, y) for x, y in zip(a, b)]


def test_fermat_inverse_mod_the_ed25519_prime_matches_reference():
    p = port.P
    a = [1, p - 1, 38, 2, 12345678901234567890]
    la = limbs.to_limbs_batch([x * R % p for x in a])  # Montgomery form
    want = np.asarray(
        jax.jit(jax.vmap(lambda x: ref_limbs.fe_to_array(
            ref_limbs.mont_inv(ref.FIELD, ref_limbs.fe_from_array(x)))))(la)
    )
    inv = limbs.mont_inv(port.FIELD, limbs.fe_tensor(la))
    assert np.array_equal(inv.numpy(), want.astype(np.int64))
    assert limbs.from_limbs_batch(limbs.from_mont(port.FIELD, inv)) == [
        pow(x, -1, p) for x in a
    ]
    # a * a^-1 is the Montgomery one, 2^256 mod p = 38.
    one = limbs.mont_mul(port.FIELD, limbs.fe_tensor(la), inv)
    assert limbs.from_limbs_batch(one) == [38] * len(a)


def test_host_prep_matches_reference(lanes):
    items, _ = lanes
    for bucket, its in ((16, items), (8, [])):
        assert np.array_equal(
            port.prepare_packed(its, bucket), ref.prepare_packed(its, bucket)
        )
        a, b = port.prepare_batch(its, bucket), ref.prepare_batch(its, bucket)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        scalar = port.prepare_batch_scalar(its, bucket)
        for x, y in zip(scalar, ref.prepare_batch_scalar(its, bucket)):
            assert np.array_equal(x, y)
        for x, y in zip(scalar, a):
            assert np.array_equal(x, y)
        assert np.array_equal(port.pack_arrays(a), ref.pack_arrays(b))
    assert port.PACKED_COLS == ref.PACKED_COLS == 82


def test_plain_verify_matches_reference_kernel_and_host(lanes, rows, plain_verdicts):
    want = np.concatenate([
        np.asarray(ref.ed25519_verify_kernel_packed(jnp.asarray(rows[k : k + 8])))
        for k in (0, 8)
    ])
    assert np.array_equal(plain_verdicts, want)
    _, expected = lanes
    assert list(plain_verdicts) == expected + [False] * 4


def test_plain_verify_arrays_match_reference_kernel(lanes, rows, plain_verdicts):
    """K7''s plain version (the seven arrays of ``prepare_batch``) on the
    16 lanes of ``rows``, adversarial lanes and pad rows included, against
    the reference's packed ``ed25519_verify_kernel_packed`` on the same
    lanes (in two halves of 8), not its seven-array
    ``ed25519_verify_kernel``: both call the reference's ``_verify_one``
    (minbft_tpu/ops/ed25519.py), and the packed form is compiled at this
    shape already, where the seven-array one would cost a compile of its
    own (~40 s on the CPU).  Its verdicts also equal plain K7's."""
    arrays = port.prepare_batch(lanes[0], 16)
    assert np.array_equal(port.pack_arrays(arrays), rows)
    got = port.ed25519_verify_kernel(*limbs.arrays_to(arrays, "cpu")).numpy()
    want = np.concatenate([
        np.asarray(ref.ed25519_verify_kernel_packed(jnp.asarray(rows[k : k + 8])))
        for k in (0, 8)
    ])
    assert np.array_equal(got, want)
    assert np.array_equal(got, plain_verdicts)
    assert port.ed25519_verify_kernel.launches == 0


def test_plain_rb_matches_reference_kernel_bit_for_bit(rows):
    nonces = np.ascontiguousarray(rows[:8, 32:48])  # u1 = S limbs as r
    nonces[5:] = limbs.to_limbs_batch([0, 1, hc.ED_L - 1])
    got = port.ed25519_rb_kernel(torch.from_numpy(nonces))
    want = np.asarray(ref.ed25519_rb_kernel(nonces))
    assert got.dtype == torch.uint16 and got.shape == (8, 3, 16)
    assert np.array_equal(got.numpy(), want)


def test_comb_table_matches_reference_bit_for_bit():
    assert np.array_equal(port._comb_table_np(), ref._comb_table_np())


def test_sign_batch_matches_host_signer_and_reference():
    seeds = _seeds(2, 3)
    msgs = [b"", b"x", hashlib.sha256(b"m").digest()] + [b"m" * k for k in (5, 31, 64, 200)]
    items = [(seeds[i % 3], m) for i, m in enumerate(msgs)] + [(seeds[0], b"x")]
    want = [hc.ed25519_sign(s, m) for s, m in items]
    assert port.sign_batch(items, device="cpu") == want
    assert ref.sign_batch(items) == want
    assert port.sign_batch([], device="cpu") == []


def test_wrappers_default_to_cuda_and_reject_other_devices(monkeypatch):
    meta = torch.zeros((8, port.PACKED_COLS), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError):
        port.ed25519_verify_kernel_packed(meta)
    with pytest.raises(ValueError):
        port.ed25519_rb_kernel(meta[:, :16])
    flags = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        port.ed25519_verify_kernel(*[meta[:, :16]] * 5, flags, flags != 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.verify_batch([])
    with pytest.raises(RuntimeError):
        port.sign_batch([(b"\x00" * 32, b"m")])
    assert port.ed25519_verify_kernel_packed.launches == 0
    assert port.ed25519_rb_kernel.launches == 0
    assert port.ed25519_verify_kernel.launches == 0


def test_group_size_and_the_launchers_alignment_checks():
    """K7/K7' and K8 run a group of 4 threads per lane at every batch (no
    size to pick; K1, their field ops' test kernel, runs at 1 and 4), and
    each launcher refuses a view whose storage is misaligned for the
    kernel's widest load (which would fault on the card) before a kernel
    sees it."""
    def misaligned(dtype, cols, skip):
        """Two contiguous rows that start ``skip`` elements into their storage."""
        return torch.zeros(2 * cols + skip, dtype=dtype)[skip:].view(2, cols)

    rows = misaligned(torch.uint16, port.PACKED_COLS, 1)  # 2 bytes in, u32 reads
    nonces = misaligned(torch.uint16, 16, 4)  # 8 bytes in, 16-byte reads
    limb = misaligned(torch.int32, 16, 1)  # 4 bytes in, 8-byte reads
    rsign = torch.zeros(3, dtype=torch.int32)[1:]  # aligned: 4-byte reads
    flags = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="4-byte aligned"):
        port._launch_verify_packed(rows)
    with pytest.raises(ValueError, match="16-byte aligned"):
        port._launch_rb(nonces)
    with pytest.raises(ValueError, match="8-byte aligned"):
        port._launch_verify_arrays([limb] * 5 + [rsign, flags])
    for t in (1, 4):
        with pytest.raises(ValueError, match="4-byte aligned"):
            limbs._launch_field_op("mul", misaligned(torch.uint16, 16, 1),
                                   torch.zeros((2, 16), dtype=torch.uint16), "ed", t)


def test_k8_table_holds_the_reference_rows_addend_terms():
    """K8's table (plain y - x, y + x, 2d*t) is the reference's comb table
    (Montgomery x, y, t) row for row; the v = 0 rows are the identity's
    (1, 1, 0)."""
    words = port.comb_table_words("cpu").numpy().view(np.uint32)
    got = [sum(int(w) << (32 * j) for j, w in enumerate(row))
           for row in words.reshape(-1, 8)]
    ref_tab = ref._comb_table_np()
    r_inv = pow(R, -1, port.P)
    for j, v in ((0, 0), (0, 1), (5, 7), (63, 15)):
        x, y, t = (v_m * r_inv % port.P for v_m in limbs.from_limbs_batch(ref_tab[j, v]))
        want = [(y - x) % port.P, (y + x) % port.P, 2 * hc.ED_D * t % port.P]
        assert got[(j * 16 + v) * 3 : (j * 16 + v) * 3 + 3] == want
    assert got[:3] == [1, 1, 0]


def test_engine_verify_queue_stages_the_reference_rows_and_dedups(monkeypatch, lanes):
    """The 8-lane bucket each engine hands its kernel (padding included)
    and the verdicts agree exactly; a re-submitted item is a memo hit."""
    import minbft_tpu.ops.ed25519 as ref_mod
    import minbft_tpu_torch.ops.ed25519 as port_mod

    seen = {}

    def spy(name, fn, to_np):
        def wrapped(rows):
            seen[name] = to_np(rows)
            return fn(rows)
        return wrapped

    monkeypatch.setattr(ref_mod, "ed25519_verify_kernel_packed", spy(
        "ref", ref_mod.ed25519_verify_kernel_packed, lambda r: np.asarray(r).copy()))
    monkeypatch.setattr(port_mod, "ed25519_verify_kernel_packed", spy(
        "port", port_mod.ed25519_verify_kernel_packed, lambda r: r.numpy().copy()))
    items, expected = lanes
    batch = items[1:7]  # honest lanes 1, 2 and four adversarial ones
    ref_engine = RefBatchVerifier(max_batch=_BUCKET, buckets=(_BUCKET,))
    port_engine = BatchVerifier(max_batch=_BUCKET, buckets=(_BUCKET,), device="cpu")
    ref_engine._queue("ed25519", ref_engine._dispatch_ed25519)
    want = ref_engine._dispatch_ed25519(batch)

    async def submit():
        singles = [port_engine.verify_ed25519(*it) for it in batch[:2]]
        many = port_engine.verify_ed25519_many(batch[2:] + batch[:1])
        out = await asyncio.gather(*singles, many)
        return list(out[:2]) + list(out[2])

    got = asyncio.run(submit())
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    assert seen["port"].shape == (_BUCKET, 82) and not seen["port"][6:].any()
    assert got[:6] == list(want) == expected[1:7] and got[6] == got[0]
    st = port_engine.stats["ed25519"]
    assert (st.items, st.batches, st.padded_lanes, st.memo_hits) == (6, 1, 2, 1)

    async def again():
        return await asyncio.gather(*[port_engine.verify_ed25519(*it) for it in batch[:3]])

    assert asyncio.run(again()) == expected[1:4]
    assert (st.items, st.batches, st.memo_hits) == (6, 1, 4)


@pytest.mark.parametrize("on_device", [True, None], ids=["plain-rb", "host"])
def test_engine_sign_queue_signs_byte_identically(on_device):
    seeds = _seeds(3, 2)
    items = [(seeds[i % 2], b"reply-%d" % i) for i in range(5)]
    engine = BatchVerifier(
        max_batch=_BUCKET, buckets=(_BUCKET,), device="cpu", sign_on_device=on_device
    )

    async def sign():
        return await asyncio.gather(*[engine.sign_ed25519(s, m) for s, m in items])

    assert asyncio.run(sign()) == [hc.ed25519_sign(s, m) for s, m in items]
    st = engine.sign_stats["ed25519"]
    assert st.items == 5 and st.dispatch_timeouts == 0
    assert st.host_fallback_items == (0 if on_device else 5)
    assert engine._host_signer_for("ed25519")(items[:1]) == [hc.ed25519_sign(*items[0])]
