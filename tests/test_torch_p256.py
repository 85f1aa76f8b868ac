"""The port's ECDSA-P256 path (minbft_tpu_torch/ops/p256.py: host prep and
the plain versions of kernels K2 and K3) against the JAX reference
(minbft_tpu/ops/p256.py) and the host oracles.

The same packed rows go through the reference's
``ecdsa_verify_kernel_packed`` and ``_verify_batch`` (the eight-array
form, K2') and the port's plain versions: valid lanes,
the forged lanes of tests/test_p256.py (tampered digest, wrong key,
r = 0, s = n, bit-flipped s), the keys Q = G and Q = -G (private keys 1
and n-1, the exact doubling and negation cases of the G+Q table entry),
and rows with r2_ok = 1 built directly.  The ladder k*G (K4) is held against
the reference's ``ecdsa_kg_ladder_kernel`` and, through ``sign_finish``,
against the comb K3.  The JAX oracle runs at the reference suite's own
shapes (8 lanes of ``_verify_batch``, the packed rows' lane function; 6
nonces of the comb), so a whole run compiles it once per shape, except
K4 (8 nonces), which no reference test compiles.  Everything is an integer: comparisons
are exact.  Inputs are made from a numpy seed."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minbft_tpu.ops import p256 as ref
from minbft_tpu_torch.ops import limbs
from minbft_tpu_torch.ops import p256 as port
from minbft_tpu_torch.utils import hostcrypto as hc


class _SeededRng:
    """numpy-seeded stand-in for ``secrets`` (hostcrypto.keygen's rng)."""

    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def randbelow(self, n):
        return int.from_bytes(self._g.bytes(40), "little") % n

    def digest(self):
        return self._g.bytes(32)


@pytest.fixture(scope="module")
def lanes():
    """(items, expected host verdict) for the signature lanes."""
    rng = _SeededRng(256)
    keys = [hc.keygen(rng) for _ in range(3)]
    items = []
    for d, q in keys:
        dg = rng.digest()
        items.append((q, dg, hc.ecdsa_sign_py(d, dg)))
    d0, q0 = keys[0]
    dg = hashlib.sha256(b"orig").digest()
    r, s = hc.ecdsa_sign_py(d0, dg)
    items += [
        (q0, hashlib.sha256(b"tampered").digest(), (r, s)),
        (keys[1][1], dg, (r, s)),
        (q0, dg, (0, s)),
        (q0, dg, (r, hc.N)),
        (q0, dg, (r, s ^ 1)),
    ]
    for d, q in ((1, (hc.GX, hc.GY)), (hc.N - 1, (hc.GX, hc.P - hc.GY))):
        dg = rng.digest()
        items.append((q, dg, hc.ecdsa_sign_py(d, dg)))
    expected = [hc.ecdsa_verify_py(q, dg, sig) for q, dg, sig in items]
    assert expected == [True] * 3 + [False] * 5 + [True] * 2
    return items, expected


@pytest.fixture(scope="module")
def rows(lanes):
    """16 packed rows: the 10 signature lanes, 3 crafted second-candidate
    rows, 3 pad rows."""
    items, _ = lanes
    out = port.prepare_packed(items, 16)
    L = 16
    for i, src in zip((10, 11, 12), (0, 1, 2)):
        out[i] = out[src]
        out[i, 6 * L] = 1  # r2_ok
        out[i, 5 * L : 6 * L] = out[i, 4 * L : 5 * L]  # r2 = r
    out[11, 4 * L] ^= 1  # r wrong: only r2 matches
    out[12, 4 * L] ^= 1
    out[12, 6 * L] = 0  # r wrong and r2 gated off: rejected
    return out


@pytest.fixture(scope="module")
def plain_verdicts(rows):
    return port.ecdsa_verify_kernel_packed(torch.from_numpy(rows)).numpy()


def test_prepare_packed_matches_reference(lanes):
    items, _ = lanes
    assert np.array_equal(port.prepare_packed(items, 16), ref.prepare_packed(items, 16))
    a, b = port.prepare_batch(items), ref.prepare_batch(items)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    for x, y in zip(port.prepare_batch_scalar(items), ref.prepare_batch_scalar(items)):
        assert np.array_equal(x, y)
    assert np.array_equal(port.pack_arrays(a), ref.pack_arrays(b))


def test_plain_verify_matches_reference_kernel(rows, plain_verdicts):
    """K2's plain version on the packed rows against the reference's
    lane function.  The reference's packed kernel is ``vmap`` of
    ``_verify_one_packed``, which slices the row into ``_verify_one``'s
    eight arguments; its oracle here is that same lane function over the
    same slices (``_verify_batch``, ``ecdsa_verify_kernel``) at
    tests/test_p256.py's shape of 8 lanes, which a whole run compiles
    once, and the slicing is the reference's own ``pack_arrays`` layout."""
    arrays = _arrays_of(rows)
    for k in (0, 8):
        assert np.array_equal(ref.pack_arrays([a[k : k + 8] for a in arrays]),
                              rows[k : k + 8])
    want = np.concatenate([
        np.asarray(ref.ecdsa_verify_kernel(*(jnp.asarray(a[k : k + 8]) for a in arrays)))
        for k in (0, 8)
    ])
    assert np.array_equal(plain_verdicts, want)


def test_plain_verify_matches_host_oracle(lanes, plain_verdicts):
    _, expected = lanes
    assert list(plain_verdicts[:10]) == expected
    # crafted rows: r2 = r accepted, r wrong but r2 right accepted, r2
    # gated off rejected; pad rows (valid = 0) rejected
    assert list(plain_verdicts[10:]) == [True, True, False, False, False, False]


def test_plain_kg_matches_reference_kernel(rows):
    """K3's plain version on 16 nonces against the reference's comb
    kernel, run in chunks of 6 lanes (the last padded with k = 1, as
    ``sign_prepare`` pads): tests/test_p256_sign.py's shape, which a
    whole run compiles once."""
    nonces = np.ascontiguousarray(rows[:, 32:48])  # u1 limbs as k
    nonces[13:] = limbs.to_limbs_batch([1, 2, hc.N - 1])
    got = port.ecdsa_kg_kernel(torch.from_numpy(nonces))
    padded = np.concatenate([nonces, limbs.to_limbs_batch([1, 1]).astype(nonces.dtype)])
    want = np.concatenate([np.asarray(ref.ecdsa_kg_kernel(padded[k : k + 6]))
                           for k in range(0, 18, 6)])[:16]
    assert got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), want)


def test_comb_table_matches_reference_bit_for_bit():
    assert np.array_equal(port._comb_table_np(), ref._comb_table_np())


def test_sign_batch_matches_host_signer_byte_for_byte():
    rng = _SeededRng(9)
    keys = [hc.keygen(rng)[0] for _ in range(2)]
    digests = [b"\x00" * 32, b"\xff" * 32, hc.N.to_bytes(32, "big")]
    digests += [rng.digest() for _ in range(5)]
    items = [(keys[i % 2], dg) for i, dg in enumerate(digests)]
    assert port.sign_batch(items, bucket=8, device="cpu") == [
        hc.ecdsa_sign_py(d, dg) for d, dg in items
    ]


def test_wrappers_default_to_cuda_and_reject_other_devices(monkeypatch):
    meta = torch.zeros((8, port.PACKED_COLS), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError):
        port.ecdsa_verify_kernel_packed(meta)
    with pytest.raises(ValueError):
        port.ecdsa_kg_kernel(meta[:, :16])
    with pytest.raises(ValueError):
        port.ecdsa_kg_ladder_kernel(meta[:, :16])
    flags = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        port.ecdsa_verify_kernel(*[meta[:, :16]] * 6, flags, flags)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.verify_batch([])
    with pytest.raises(RuntimeError):
        port.sign_batch([(1, b"\x00" * 32)])
    assert port.ecdsa_verify_kernel_packed.launches == 0
    assert port.ecdsa_kg_kernel.launches == 0
    assert port.ecdsa_kg_ladder_kernel.launches == 0
    assert port.ecdsa_verify_kernel.launches == 0


def test_group_size_and_the_launchers_alignment_checks():
    """K2/K2', K3 and K4 get 4 threads per lane up to GROUP_LIMIT lanes, 1
    above; and each launcher refuses a view whose storage is misaligned for
    the kernel's widest load (which would fault on the card) before a
    kernel sees it."""
    sizes = [port.group_size(n) for n in (1, 128, 512, 2048, port.GROUP_LIMIT,
                                          port.GROUP_LIMIT + 1, 16384, 32768)]
    assert sizes == [4, 4, 4, 4, 4, 1, 1, 1]
    assert set(sizes) == set(port.GROUP_SIZES)

    def misaligned(dtype, cols, skip):
        """Two contiguous rows that start ``skip`` elements into their storage."""
        return torch.zeros(2 * cols + skip, dtype=dtype)[skip:].view(2, cols)

    rows = misaligned(torch.uint16, port.PACKED_COLS, 1)  # 2 bytes in, u32 reads
    nonces = misaligned(torch.uint16, 16, 4)  # 8 bytes in, 16-byte reads
    limb = misaligned(torch.int32, 16, 1)  # 4 bytes in, 8-byte reads
    flags = torch.zeros(2, dtype=torch.bool)
    for t in port.GROUP_SIZES:
        with pytest.raises(ValueError, match="4-byte aligned"):
            port._launch_verify_packed(rows, t)
        with pytest.raises(ValueError, match="16-byte aligned"):
            port._launch_kg(nonces, t)
        with pytest.raises(ValueError, match="16-byte aligned"):
            port._launch_kg_ladder(nonces, t)
        with pytest.raises(ValueError, match="8-byte aligned"):
            port._launch_verify_arrays([limb] * 6 + [flags, flags], t)
        with pytest.raises(ValueError, match="4-byte aligned"):
            limbs._launch_field_op("mul", misaligned(torch.uint16, 16, 1),
                                   torch.zeros((2, 16), dtype=torch.uint16), "p", t)


def test_is_on_curve(lanes):
    items, _ = lanes
    x, y = items[0][0]
    assert port.is_on_curve(x, y) and ref.is_on_curve(x, y)
    assert not port.is_on_curve(x, (y + 1) % hc.P)
    assert not port.is_on_curve(hc.P, 0)


def _arrays_of(rows):
    """[B, 98] packed rows -> the eight arrays of ``prepare_batch`` (u32
    limbs, bool flags)."""
    L = 16
    limb_arrays = [rows[:, k * L : (k + 1) * L].astype(np.uint32) for k in range(6)]
    return limb_arrays + [rows[:, 6 * L] != 0, rows[:, 6 * L + 1] != 0]


def test_plain_verify_arrays_match_reference_verify_batch(rows, plain_verdicts):
    """K2''s plain version against the reference's eight-array
    ``_verify_batch`` at tests/test_p256.py's shape (8 lanes): the two
    halves of the rows hold honest lanes, the forged ones (tampered
    digest, wrong key, bit-flipped s), r = 0 and s = n (valid = 0), the
    crafted r2_ok lanes and pad rows; its verdicts also equal K2's."""
    arrays = _arrays_of(rows)
    got = port.ecdsa_verify_kernel(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.concatenate([
        np.asarray(ref._verify_batch(*(jnp.asarray(a[k : k + 8]) for a in arrays)))
        for k in (0, 8)
    ])
    assert np.array_equal(got, want)
    assert np.array_equal(got, plain_verdicts)
    assert port.ecdsa_verify_kernel.launches == 0


def test_plain_kg_ladder_matches_reference_and_signs_like_the_comb():
    """K4's plain version against the reference's
    ``ecdsa_kg_ladder_kernel`` bit for bit at one shape of 8 lanes (k = 0,
    1, 2, n - 1, one random k < n and three RFC 6979 nonces), and
    ``sign_finish`` on its (X, Z) against ``sign_finish`` on K3's and the
    host signer."""
    rng = _SeededRng(4)
    d = hc.keygen(rng)[0]
    items = [(d, rng.digest()) for _ in range(3)]
    k_sign, meta = port.sign_prepare(items, 3)
    nonces = np.concatenate([
        limbs.to_limbs_batch([0, 1, 2, hc.N - 1, rng.randbelow(hc.N)]), k_sign
    ]).astype(np.uint16)
    got = port.ecdsa_kg_ladder_kernel(torch.from_numpy(nonces))
    want = np.asarray(ref.ecdsa_kg_ladder_kernel(nonces.astype(np.uint32)))
    assert got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), want)
    comb = port.ecdsa_kg_kernel(torch.from_numpy(k_sign)).numpy()
    ladder_sigs = port.sign_finish(items, meta, got.numpy()[5:])
    assert ladder_sigs == port.sign_finish(items, meta, comb)
    assert ladder_sigs == [hc.ecdsa_sign_py(d, dg) for d, dg in items]
    assert port.ecdsa_kg_ladder_kernel.launches == 0
