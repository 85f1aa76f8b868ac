"""Batched Ed25519: host prep, plain PyTorch versions and the wrappers of
kernels K7 (verify over packed rows), K7' (the same verify over
``prepare_batch``'s seven arrays) and K8 (fixed-base r·B).

Port of :mod:`minbft_tpu.ops.ed25519` (BASELINE config 5: n = 31, bucket
1,024).  Division of labour as in the reference: the host computes the
challenge k = SHA-512(R || A || M) mod L, decompresses A once per public
key (cached) and packs one ``[B, 82]`` u16 row per lane
(:func:`prepare_packed`); the device computes P = S·B + k·(−A) with 256
doublings and 256 complete twisted-Edwards additions (a = −1, extended
coordinates), normalises it with one Fermat inversion and accepts iff
P's encoding equals R's bytes (K7).  R is never decompressed.  Signing
puts the nonce scalar multiplication r·B on the device, as a 64-window
fixed-base comb (K8); the host derives the scalars (SHA-512), batch-
inverts the Zs for compression and finishes s = r + k·a.

Verification semantics are the reference's (strict, cofactorless; see
``utils/hostcrypto.py``): non-canonical R or S, undecodable keys and
wrong-length signatures become ``valid = 0`` lanes.

The plain versions below use the reference's ``_add`` / ``_dbl`` op for
op.  The CUDA kernels (``csrc/ed25519_verify.cu``, ``csrc/ed25519_rb.cu``)
run the same formulas on exact field ops mod 2^255 - 19 specialised at
compile time (``csrc/ed25519_field.cuh``), on a group of 4 threads per
lane, so K7's verdicts and K8's projective (X, Y, Z) bits equal the
reference's on every lane.  Wrappers take CPU tensors to the plain
version and CUDA tensors to the kernel; any other device raises.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import hostcrypto as hc
from . import backend, limbs
from .limbs import (
    FieldSpec,
    add_sub_many,
    mont_inv,
    mont_mul_many,
    mont_one,
    to_limbs,
)

P = hc.ED_P  # 2^255 - 19
L = hc.ED_L
D = hc.ED_D

FIELD = FieldSpec.make(P)

# Montgomery-domain constants (R = 2^256).
_BX_M = (hc.ED_BX << 256) % P
_BY_M = (hc.ED_BY << 256) % P
_BT_M = ((hc.ED_BX * hc.ED_BY % P) << 256) % P
_D2_M = ((2 * D % P) << 256) % P

# ---------------------------------------------------------------------------
# Plain PyTorch point arithmetic (the reference's formulas, op for op).
#
# Points are (x, y, z, t) tuples of [B, 16] int64 limb tensors, extended
# coordinates, Montgomery domain.  Independent field operations of one
# formula are evaluated together (mont_mul_many / add_sub_many): the same
# values as the reference's one-at-a-time sequence, with far fewer
# PyTorch ops.

_ADD, _SUB = False, True


@functools.lru_cache(maxsize=None)
def _const(value: int, device: str) -> torch.Tensor:
    """A field constant as a [16] int64 limb tensor on ``device``."""
    return limbs.fe_tensor(value, device)


def _add(p, q):
    """Complete unified addition, a = -1 (add-2008-hwcd-3 with k = 2d).
    Identity and doubling inputs need no special case."""
    f = FIELD
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    d2 = _const(_D2_M, str(pt.device))
    p_m, p_p, q_m, q_p = add_sub_many(
        f, [(py, px, _SUB), (py, px, _ADD), (qy, qx, _SUB), (qy, qx, _ADD)]
    )
    a, b, ptd, zz = mont_mul_many(f, [(p_m, q_m), (p_p, q_p), (pt, d2), (pz, qz)])
    (c,) = mont_mul_many(f, [(ptd, qt)])
    (d,) = add_sub_many(f, [(zz, zz, _ADD)])
    e, ff, g, h = add_sub_many(
        f, [(b, a, _SUB), (d, c, _SUB), (d, c, _ADD), (b, a, _ADD)]
    )
    return tuple(mont_mul_many(f, [(e, ff), (g, h), (ff, g), (e, h)]))


def _dbl(p):
    """Dedicated doubling (dbl-2008-hwcd, a = -1): 4M + 4S."""
    f = FIELD
    x, y, z, _t = p
    (xy,) = add_sub_many(f, [(x, y, _ADD)])
    a, b, zz, s = mont_mul_many(f, [(x, x), (y, y), (z, z), (xy, xy)])
    c, e1, g, ab = add_sub_many(
        f, [(zz, zz, _ADD), (s, a, _SUB), (b, a, _SUB), (a, b, _ADD)]
    )
    e, ff, h = add_sub_many(
        f, [(e1, b, _SUB), (g, c, _SUB), (torch.zeros_like(ab), ab, _SUB)]
    )
    return tuple(mont_mul_many(f, [(e, ff), (g, h), (ff, g), (e, h)]))


def _identity(b: int, dev):
    one = mont_one(FIELD, dev).expand(b, limbs.NLIMBS)
    zero = torch.zeros_like(one)
    return (zero, one, one, zero)


def _bits_of(scalar: torch.Tensor) -> torch.Tensor:
    """[B, 16] limbs -> [B, 256] bits, bit j = bit j of the scalar."""
    shifts = torch.arange(limbs.LIMB_BITS, device=scalar.device)
    return ((scalar.unsqueeze(-1) >> shifts) & 1).reshape(scalar.shape[0], 256)


def verify_packed_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: [B, 82] packed rows (any integer
    dtype) -> [B] bool, the reference's ``_verify_one_packed`` per lane:
    the row sliced into :func:`verify_plain`'s seven arrays."""
    nl = limbs.NLIMBS
    cols = [rows[:, k * nl : (k + 1) * nl] for k in range(5)]
    return verify_plain(*cols, rows[:, 5 * nl], rows[:, 5 * nl + 1] != 0)


@torch.inference_mode()
def verify_plain(ax, ay, u1, u2, ry, rsign, valid) -> torch.Tensor:
    """Plain PyTorch version of K7' (and, through
    :func:`verify_packed_plain`, of K7): ax, ay, u1, u2, ry [B, 16] limbs
    (any integer dtype), rsign [B] (int32 bit patterns of u32 values
    included), valid [B] (nonzero = set) -> [B] bool, the reference's
    ``_verify_one`` per lane."""
    f = FIELD
    ax, ay, u1, u2, ry = (t.to(torch.int64) for t in (ax, ay, u1, u2, ry))
    rsign = rsign.to(torch.int64) & 0xFFFFFFFF
    valid = valid != 0
    b = ax.shape[0]
    dev = ax.device
    nl = limbs.NLIMBS

    r2 = limbs.fe_tensor(np.array(f.r2_mod, np.uint32), dev)
    ax_m, ay_m = mont_mul_many(f, [(ax, r2), (ay, r2)])
    (at_m,) = mont_mul_many(f, [(ax_m, ay_m)])
    ident = _identity(b, dev)
    one = ident[1]
    aq = (ax_m, ay_m, one, at_m)
    bx, by, bt = (_const(v, str(dev)).expand(b, nl) for v in (_BX_M, _BY_M, _BT_M))
    bpt = (bx, by, one, bt)
    ba = _add(bpt, aq)  # B + A'
    # [B, 4 entries, 4 coordinates, 16]; entry index = 2*bit(u1) + bit(u2)
    tab = torch.stack([torch.stack(pt, 1) for pt in (ident, aq, bpt, ba)], 1)
    lane = torch.arange(b, device=dev)
    bits1, bits2 = _bits_of(u1), _bits_of(u2)
    acc = ident
    for j in range(255, -1, -1):
        acc = _dbl(acc)
        addend = tab[lane, bits1[:, j] * 2 + bits2[:, j]]
        acc = _add(acc, tuple(addend.unbind(1)))

    zi = mont_inv(f, acc[2])
    xz, yz = mont_mul_many(f, [(acc[0], zi), (acc[1], zi)])
    unit = _const(1, str(dev))
    x_aff, y_aff = mont_mul_many(f, [(xz, unit), (yz, unit)])  # from_mont
    ok_y = limbs.fe_eq(y_aff, ry)
    ok_sign = (x_aff[:, 0] & 1) == rsign
    return ok_y & ok_sign & valid


def ed25519_verify_kernel_packed(rows: torch.Tensor) -> torch.Tensor:
    """Batched Ed25519 verify over packed rows -> [B] bool.

    CPU: the plain version (any integer dtype).  CUDA: K7
    (``csrc/ed25519_verify.cu``, 4 threads per lane) on PyTorch's current
    stream; ``rows`` must be a contiguous [B, 82] uint16 tensor whose
    storage is 4-byte aligned (the kernel reads a row as 41 32-bit words; a
    row is 164 bytes, so no wider load is aligned)."""
    if rows.device.type == "cpu":
        return verify_packed_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(
            f"ed25519_verify_kernel_packed: unsupported device {rows.device}"
        )
    out = _launch_verify_packed(rows)
    backend.count_launch(ed25519_verify_kernel_packed)
    return out


def _launch_verify_packed(rows: torch.Tensor) -> torch.Tensor:
    """K7 after the wrapper-side checks; counts no launch."""
    n = rows.shape[0]
    backend.require(rows, torch.uint16, (n, PACKED_COLS), "ed25519 verify rows", align=4)
    out = torch.empty(n, dtype=torch.bool, device=rows.device)
    lib = backend.EXTENSION.library("ed25519_verify")
    with torch.cuda.device(rows.device):  # the launch goes to the current device
        rc = lib.mbt_ed25519_verify(
            backend.ptr(rows), backend.ptr(out), n,
            backend.current_stream(rows.device),
        )
    backend.check(lib, rc, "ed25519_verify")
    return out


ed25519_verify_kernel_packed.launches = 0

_VERIFY_LIMB_ARGS = ("ax", "ay", "u1", "u2", "ry")


def ed25519_verify_kernel(ax, ay, u1, u2, ry, rsign, valid) -> torch.Tensor:
    """Batched Ed25519 verify over :func:`prepare_batch`'s seven arrays ->
    [B] bool (the reference's ``ed25519_verify_kernel``).

    CPU: the plain version (any integer dtypes).  CUDA: K7'
    (``csrc/ed25519_verify.cu``, K7's lane function over the arrays, 4
    threads per lane) on PyTorch's current stream; the five limb arrays
    must be contiguous [B, 16] int32 tensors of u32 limbs (each < 2^16)
    whose storage is 8-byte aligned (the kernel reads two limbs at a time),
    rsign a contiguous [B] int32 tensor of u32 bits and valid a contiguous
    [B] bool tensor, all on one device."""
    arrays = (ax, ay, u1, u2, ry, rsign, valid)
    dev = ax.device
    if any(a.device != dev for a in arrays):
        raise ValueError("ed25519_verify_kernel: arrays on different devices")
    if dev.type == "cpu":
        return verify_plain(*arrays)
    if dev.type != "cuda":
        raise ValueError(f"ed25519_verify_kernel: unsupported device {dev}")
    out = _launch_verify_arrays(arrays)
    backend.count_launch(ed25519_verify_kernel)
    return out


def _launch_verify_arrays(arrays) -> torch.Tensor:
    """K7' after the wrapper-side checks; counts no launch."""
    n = arrays[0].shape[0]
    dev = arrays[0].device
    for name, a in zip(_VERIFY_LIMB_ARGS, arrays[:5]):
        backend.require(a, torch.int32, (n, limbs.NLIMBS), f"ed25519 verify {name}",
                        align=8)
    backend.require(arrays[5], torch.int32, (n,), "ed25519 verify rsign", align=4)
    backend.require(arrays[6], torch.bool, (n,), "ed25519 verify valid")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = backend.EXTENSION.library("ed25519_verify")
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.mbt_ed25519_verify_arrays(
            *(backend.ptr(a) for a in arrays), backend.ptr(out), n,
            backend.current_stream(dev),
        )
    backend.check(lib, rc, "ed25519_verify_arrays")
    return out


ed25519_verify_kernel.launches = 0


# ---------------------------------------------------------------------------
# Host-side batch preparation (copied from the reference unchanged).
#
# The only per-item host work is one SHA-512 (the challenge k) and the
# per-public-key decompression cache; the signature's S and R-encoding
# halves are '<u2' views of the concatenated signature bytes, and the
# S < L / y_r < p canonicality checks are vectorised word compares.
# ``prepare_batch_scalar`` is the per-item oracle.


@functools.lru_cache(maxsize=4096)
def _neg_pub_limbs(pub: bytes):
    """pub32 -> (limbs of -A.x, limbs of A.y), or None if not a curve
    point.  Decompression (a big-int sqrt) and limb packing both cached:
    the cluster's key set is small and every signature reuses it."""
    a_pt = hc.ed_decompress(pub)
    if a_pt is None:
        return None
    x, y = a_pt[0], a_pt[1]  # decompress returns Z = 1
    return to_limbs((P - x) % P if x else 0), to_limbs(y)


_ZERO64 = b"\x00" * 64
_L_WORDS = limbs.words_of(L)
_P_WORDS = limbs.words_of(P)


def prepare_batch_scalar(
    items: Sequence[Tuple[bytes, bytes, bytes]], bucket: int
) -> Tuple[np.ndarray, ...]:
    """Per-item reference prep — the differential oracle for the
    vectorised :func:`prepare_batch`, kept verbatim."""
    b = bucket
    ax = np.zeros((b, limbs.NLIMBS), np.uint32)
    ay = np.zeros((b, limbs.NLIMBS), np.uint32)
    u1 = np.zeros((b, limbs.NLIMBS), np.uint32)
    u2 = np.zeros((b, limbs.NLIMBS), np.uint32)
    ry = np.zeros((b, limbs.NLIMBS), np.uint32)
    rsign = np.zeros((b,), np.uint32)
    valid = np.zeros((b,), np.bool_)
    for i, (pub, msg, sig) in enumerate(items):
        if len(sig) != 64:
            continue
        a_limbs = _neg_pub_limbs(pub)
        if a_limbs is None:
            continue
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            continue
        y_enc = int.from_bytes(sig[:32], "little")
        y_r = y_enc & ((1 << 255) - 1)
        if y_r >= P:
            continue  # non-canonical R encoding (strict semantics)
        k = (
            int.from_bytes(
                hashlib.sha512(sig[:32] + pub + msg).digest(), "little"
            )
            % L
        )
        ax[i], ay[i] = a_limbs  # A' = -A
        u1[i] = to_limbs(s)
        u2[i] = to_limbs(k)
        ry[i] = to_limbs(y_r)
        rsign[i] = y_enc >> 255
        valid[i] = True
    return ax, ay, u1, u2, ry, rsign, valid


def prepare_batch(
    items: Sequence[Tuple[bytes, bytes, bytes]], bucket: int
) -> Tuple[np.ndarray, ...]:
    """[(pub32, msg, sig64)] -> device-ready limb arrays, padded to
    ``bucket`` lanes.  Malformed and non-canonical inputs get
    valid=False.  Bit-identical to :func:`prepare_batch_scalar`."""
    b = bucket
    n = len(items)
    nl = limbs.NLIMBS
    ax = np.zeros((b, nl), np.uint32)
    ay = np.zeros((b, nl), np.uint32)
    u1 = np.zeros((b, nl), np.uint32)
    u2 = np.zeros((b, nl), np.uint32)
    ry = np.zeros((b, nl), np.uint32)
    rsign = np.zeros((b,), np.uint32)
    valid = np.zeros((b,), np.bool_)
    if n == 0:
        return ax, ay, u1, u2, ry, rsign, valid

    # Pass 1 (per item): structural sig check + cached decompression.
    sigbuf = bytearray()
    a_rows: list = []
    ok = np.zeros((n,), np.bool_)
    for i, (pub, _msg, sig) in enumerate(items):
        a_limbs = _neg_pub_limbs(pub) if len(sig) == 64 else None
        if a_limbs is None:
            sigbuf += _ZERO64
            a_rows.append(None)
            continue
        sigbuf += sig
        a_rows.append(a_limbs)
        ok[i] = True

    raw = bytes(sigbuf)
    srows = np.frombuffer(raw, dtype="<u2").reshape(n, 2, nl)
    swords = np.frombuffer(raw, dtype="<u8").reshape(n, 2, 4)
    ry16 = srows[:, 0].copy()
    rsign_n = (ry16[:, nl - 1] >> 15).astype(np.uint32)
    ry16[:, nl - 1] &= 0x7FFF  # y_r = y_enc & (2^255 - 1)

    # Vectorised canonicality: s < L, y_r < p (strict semantics).
    ok &= limbs.words_lt(swords[:, 1], _L_WORDS)
    ok &= limbs.words_lt(limbs.limb_words(ry16), _P_WORDS)

    # Pass 2 (valid lanes only): one SHA-512 per lane for the challenge k.
    vidx = np.flatnonzero(ok)
    idx = vidx.tolist()
    if idx:
        sha = hashlib.sha512
        k_ints = []
        for i in idx:
            pub, msg, sig = items[i]
            k_ints.append(
                int.from_bytes(sha(sig[:32] + pub + msg).digest(), "little")
                % L
            )
        ax[vidx] = np.stack([a_rows[i][0] for i in idx])
        ay[vidx] = np.stack([a_rows[i][1] for i in idx])
        u1[vidx] = srows[vidx, 1]
        u2[vidx] = limbs.to_limbs_batch(k_ints)
        ry[vidx] = ry16[vidx]
        rsign[vidx] = rsign_n[vidx]
        valid[vidx] = True
    return ax, ay, u1, u2, ry, rsign, valid


# Packed I/O: one u16 row per lane (limb values are 16-bit by
# construction, rsign and valid are 0/1) — one upload per dispatch.

PACKED_COLS = 5 * limbs.NLIMBS + 2  # ax ay u1 u2 ry | rsign valid


def pack_arrays(arrays) -> np.ndarray:
    """prepare_batch output -> [B, PACKED_COLS] u16 (one upload)."""
    ax, ay, u1, u2, ry, rsign, valid = arrays
    return np.concatenate(
        [
            ax, ay, u1, u2, ry,
            rsign[:, None].astype(np.uint32),
            valid[:, None].astype(np.uint32),
        ],
        axis=1,
    ).astype(np.uint16)


def prepare_packed(
    items: Sequence[Tuple[bytes, bytes, bytes]],
    bucket: int,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """prepare_batch + pack_arrays fused into one [bucket, PACKED_COLS]
    u16 staging write; ``out`` is an engine-owned recycled staging
    buffer."""
    n = len(items)
    out = limbs.staging_out(out, bucket, PACKED_COLS, n)
    ax, ay, u1, u2, ry, rsign, valid = prepare_batch(items, bucket)
    nl = limbs.NLIMBS
    out[:, 0:nl] = ax
    out[:, nl : 2 * nl] = ay
    out[:, 2 * nl : 3 * nl] = u1
    out[:, 3 * nl : 4 * nl] = u2
    out[:, 4 * nl : 5 * nl] = ry
    out[:, 5 * nl] = rsign
    out[:, 5 * nl + 1] = valid
    return out


def verify_batch(items: Sequence[Tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Convenience wrapper: prepare on host, verify on ``device`` (default
    ``cuda:0``) -> [B] bool."""
    dev = backend.resolve_device(device)
    rows = torch.from_numpy(prepare_packed(items, len(items))).to(dev)
    return ed25519_verify_kernel_packed(rows).cpu().numpy()


# ---------------------------------------------------------------------------
# Batched signing: the fixed-base comb.
#
# r = sum_j r_j * 16^j over 64 nibble windows; T[j][v] = v * 16^j * B
# (affine (x, y, t = xy), Montgomery domain) is built on the host, so
# r*B is 64 complete additions with no doublings and no flags: the v = 0
# rows are the identity (0, 1, 0) and flow through _add like any point.

_COMB_WINDOWS = 64
_COMB_TABLE_NP: np.ndarray | None = None


def _comb_table_np() -> np.ndarray:
    """[64, 16, 3, NLIMBS] u32: (x, y, t=xy) affine Montgomery rows of
    v * 16^j * B; v = 0 rows are the identity (0, 1, 0)."""
    global _COMB_TABLE_NP
    if _COMB_TABLE_NP is not None:
        return _COMB_TABLE_NP
    tab = np.zeros((_COMB_WINDOWS, 16, 3, limbs.NLIMBS), np.uint32)
    one_m = to_limbs((1 << 256) % P)
    for j in range(_COMB_WINDOWS):
        tab[j, 0, 1] = one_m  # identity: (0 : 1 : 1 : 0)
    base = hc.ED_BASE  # extended affine-ish host tuple (x, y, z=1, t)
    for j in range(_COMB_WINDOWS):
        acc = None
        for v in range(1, 16):
            acc = base if acc is None else hc.ed_add(acc, base)
            x, y, z, _t = acc
            zi = pow(z, -1, P)
            xa, ya = x * zi % P, y * zi % P
            tab[j, v, 0] = to_limbs((xa << 256) % P)
            tab[j, v, 1] = to_limbs((ya << 256) % P)
            tab[j, v, 2] = to_limbs((xa * ya % P << 256) % P)
        base = hc.ed_scalar_mult(16, base)
    _COMB_TABLE_NP = tab
    return tab


@torch.inference_mode()
def rb_plain(r: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: [B, 16] nonce limbs (any integer
    dtype) and the [64, 16, 3, 16] comb table -> [B, 3, 16] int64
    (X, Y, Z), extended coordinates, Montgomery domain."""
    r = r.to(torch.int64)
    table = table.to(torch.int64)
    b = r.shape[0]
    dev = r.device
    shifts = 4 * torch.arange(4, device=dev)
    nibs = ((r.unsqueeze(-1) >> shifts) & 0xF).reshape(b, _COMB_WINDOWS)
    acc = _identity(b, dev)
    one = acc[1]
    for j in range(_COMB_WINDOWS):
        sel = table[j][nibs[:, j]]  # [B, 3, L]: x, y, t
        acc = _add(acc, (sel[:, 0], sel[:, 1], one, sel[:, 2]))
    return torch.stack(acc[:3], dim=1)


@functools.lru_cache(maxsize=None)
def comb_table_limbs() -> torch.Tensor:
    """The plain version's comb table, built once: [64, 16, 3, 16] int64
    limbs on the CPU (move it with ``.to`` to run the plain version on
    another device)."""
    return torch.from_numpy(_comb_table_np().astype(np.int64))


def _addend_table_np() -> np.ndarray:
    """K8's table from :func:`_comb_table_np`: [64, 16, 3, 8] u32 words of
    each row's addend terms (y - x, y + x, 2d*t) as plain residues mod p
    (the kernel's field ops work on plain values; the reference's rows
    are their Montgomery images)."""
    r_inv = pow(1 << 256, -1, P)
    ints = limbs.from_limbs_batch(_comb_table_np().reshape(-1, limbs.NLIMBS))
    terms = []
    for x_m, y_m, t_m in zip(ints[0::3], ints[1::3], ints[2::3]):
        x, y, t = (v * r_inv % P for v in (x_m, y_m, t_m))
        terms += [(y - x) % P, (y + x) % P, 2 * D * t % P]
    tab = limbs.to_limbs_batch(terms)
    words = tab[:, 0::2] | (tab[:, 1::2] << np.uint32(16))
    return words.reshape(_COMB_WINDOWS, 16, 3, 8)


@functools.lru_cache(maxsize=None)
def comb_table_words(device: str) -> torch.Tensor:
    """K8's table (:func:`_addend_table_np`) on ``device``, built and
    uploaded once: [64, 16, 3, 8] 32-bit words stored as int32 (96 KiB)."""
    words = _addend_table_np()
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


def ed25519_rb_kernel(r: torch.Tensor) -> torch.Tensor:
    """Batched r*B: [B, 16] uint16 nonce limbs -> [B, 3, 16] uint16
    (X, Y, Z), extended coordinates, Montgomery domain.

    CPU: the plain version.  CUDA: K8 (``csrc/ed25519_rb.cu``, 4 threads
    per lane, the table in global memory) on
    the current stream; ``r`` must be contiguous and its storage 16-byte
    aligned (the kernel reads a nonce as two 16-byte words)."""
    if r.device.type == "cpu":
        return rb_plain(r, comb_table_limbs()).to(torch.uint16)
    if r.device.type != "cuda":
        raise ValueError(f"ed25519_rb_kernel: unsupported device {r.device}")
    out = _launch_rb(r)
    backend.count_launch(ed25519_rb_kernel)
    return out


def _launch_rb(r: torch.Tensor) -> torch.Tensor:
    """K8 after the wrapper-side checks; counts no launch."""
    n = r.shape[0]
    backend.require(r, torch.uint16, (n, limbs.NLIMBS), "rb nonces", align=16)
    table = comb_table_words(str(r.device))
    backend.require(table, torch.int32, (_COMB_WINDOWS, 16, 3, 8), "rb table", align=16)
    out = torch.empty((n, 3, limbs.NLIMBS), dtype=torch.uint16, device=r.device)
    lib = backend.EXTENSION.library("ed25519_rb")
    with torch.cuda.device(r.device):  # the launch goes to the current device
        rc = lib.mbt_ed25519_rb(
            backend.ptr(r), backend.ptr(table), backend.ptr(out), n,
            backend.current_stream(r.device),
        )
    backend.check(lib, rc, "ed25519_rb")
    return out


ed25519_rb_kernel.launches = 0

_batch_inv = limbs.batch_inv_host

# Staging layout for the sign path: one [16] u16 nonce-limb row per lane,
# recycled through the engine's staging pool.
SIGN_COLS = limbs.NLIMBS


def sign_prepare(
    items: Sequence[Tuple[bytes, bytes]],
    bucket: int,
    out: "np.ndarray | None" = None,
) -> Tuple[np.ndarray, tuple]:
    """Host half 1 of batched Ed25519 signing: the RFC 8032 SHA-512
    scalar derivations, with the whole batch's nonce limbs packed into
    ``out`` (engine staging buffer when given) via one bulk conversion.
    Pad lanes get r = 1 (valid, discarded).  Returns ``(staging, meta)``
    for :func:`sign_finish`."""
    n = len(items)
    out = limbs.staging_out(out, bucket, SIGN_COLS, n)
    # Per-seed derivation cache: the production shape is ONE signer, many
    # messages — the SHA-512 seed expansion, clamp, and public key are
    # computed once per distinct seed, not per item.
    per_seed: dict = {}
    rs = []
    lanes = []
    for seed, msg in items:
        entry = per_seed.get(seed)
        if entry is None:
            h = hashlib.sha512(seed).digest()
            a = int.from_bytes(h[:32], "little")
            a = (a & ((1 << 254) - 8)) | (1 << 254)
            entry = (a, h[32:], hc.ed25519_keygen(seed)[1])
            per_seed[seed] = entry
        a, prefix, pub = entry
        r = (
            int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little")
            % L
        )
        rs.append(r)
        lanes.append((a, pub, msg))
    if n:
        out[:n] = limbs.to_limbs_batch(rs)
    out[n:] = 0
    out[n:, 0] = 1  # r = 1: a valid lane, result discarded
    return out, (rs, lanes)


def sign_finish(meta: tuple, xyz) -> list:
    """Host half 2: batch-invert the device Zs (one Montgomery sweep),
    compress R, and finish s = r + k*a per lane (RFC 8032)."""
    rs, lanes = meta
    b = len(lanes)
    xyz = np.concatenate([np.asarray(o) for o in xyz]) if isinstance(
        xyz, (list, tuple)
    ) else np.asarray(xyz)
    xyz = xyz[:b]  # [B,3,16] u16

    # No Montgomery undo needed: the R factor cancels in the X/Z and Y/Z
    # ratios ((X*R) * (Z*R)^-1 == X/Z), so the raw device limbs feed the
    # batch inversion directly.
    ints = [
        [int.from_bytes(row.astype("<u2").tobytes(), "little") for row in lane]
        for lane in xyz
    ]
    z_invs = _batch_inv([lane[2] for lane in ints], P)
    out = []
    for i, (a, pub, msg) in enumerate(lanes):
        x, y, _z = ints[i]
        zi = z_invs[i]
        xa, ya = x * zi % P, y * zi % P
        rp = (ya | ((xa & 1) << 255)).to_bytes(32, "little")
        k = (
            int.from_bytes(hashlib.sha512(rp + pub + msg).digest(), "little")
            % L
        )
        s = (rs[i] + k * a) % L
        out.append(rp + s.to_bytes(32, "little"))
    return out


def sign_batch(
    items: Sequence[Tuple[bytes, bytes]],
    bucket: int = 0,
    device=None,
) -> list:
    """[(seed32, msg)] -> [signature64] — RFC 8032 deterministic,
    byte-identical to :func:`minbft_tpu_torch.utils.hostcrypto.ed25519_sign`.
    ``bucket`` pads the device batch (pad lanes compute 1*B and are
    discarded).  Composition of :func:`sign_prepare` → r*B on ``device``
    (default ``cuda:0``) → :func:`sign_finish`."""
    b = len(items)
    if b == 0 and bucket == 0:
        return []
    dev = backend.resolve_device(device)
    r_arr, meta = sign_prepare(items, max(bucket, b))
    xyz = ed25519_rb_kernel(torch.from_numpy(r_arr).to(dev)).cpu().numpy()
    return sign_finish(meta, xyz)
