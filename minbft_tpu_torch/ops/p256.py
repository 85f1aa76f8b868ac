"""Batched ECDSA-P256: host prep, plain PyTorch versions and the wrappers
of kernels K2 (verify over packed rows), K2' (the same verify over
``prepare_batch``'s eight arrays), K3 (fixed-base k·G comb) and K4 (k·G
by the double-then-add ladder, K3's differential reference).

Port of :mod:`minbft_tpu.ops.p256`.  Division of labour as in the
reference: the host hashes, inverts s once per batch (Montgomery batch
inversion), range-checks and packs one ``[B, 98]`` u16 row per lane
(:func:`prepare_packed`); the device runs the 256-step interleaved Shamir
ladder u1·G + u2·Q and the affine-free check X == r·Z² (K2), or the
64-window fixed-base comb k·G for signing (K3); K4 computes the same
(X, Z) as the reference's 256-step ladder.

Adversarial-input policy (unchanged from the reference): the mixed
addition is incomplete; the kernel flags its undefined case (``exc``) and
rejects the lane, so the kernel only ever errs toward rejection.  Both
the plain versions below and the CUDA kernels (``csrc/p256_verify.cu``,
``csrc/p256_kg.cu``, ``csrc/p256_kg_ladder.cu``) use the reference's
exact point formulas and selects, so their verdicts and (X, Z) bits equal
the reference's on every lane, adversarial ones included.  The kernels
run their field ops specialised to p (``csrc/p256_field.cuh``), K2, K3
and K4 with a group of 4 threads per lane at small batches
(:func:`group_size`).

Wrappers take CPU tensors to the plain version and CUDA tensors to the
kernel; any other device raises.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import hostcrypto as hc
from . import backend, limbs
from .limbs import (
    FieldSpec,
    add_sub_many,
    fe_is_zero,
    fe_select,
    mont_inv,
    mont_mul_many,
    mont_one,
    to_limbs,
)

# ---------------------------------------------------------------------------
# Curve constants (NIST P-256 / secp256r1, FIPS 186-4 D.1.2.3).

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5

FIELD = FieldSpec.make(P)
ORDER = FieldSpec.make(N)

_GX_M = (GX << 256) % P  # Montgomery-domain constants
_GY_M = (GY << 256) % P

# Threads per lane of K2/K2', K3 and K4 on the card: 4 for a batch of at most
# GROUP_LIMIT lanes, else 1.  A group of 4 threads shares out the
# independent multiplies of each level of a point formula
# (csrc/p256_field.cuh P256Tasks): a shorter chain per lane where the card
# is nearly empty; where it is full the group's duplicated work costs
# issue and one thread per lane wins.  chip_smoke.py phases 3, 4, 11 and
# 12 time both sizes at every batch they check (PERF.md section 6): 4 wins
# up to 2,048 lanes, 1 from 16,384; no path sends a batch in between.
GROUP_SIZES = (1, 4)
GROUP_LIMIT = 4096


def group_size(n: int) -> int:
    """Threads per lane the launchers give a batch of ``n`` lanes."""
    return 4 if n <= GROUP_LIMIT else 1


# ---------------------------------------------------------------------------
# Plain PyTorch point arithmetic (the reference's formulas, op for op).
#
# Points are (x, y, z) tuples of [B, 16] int64 limb tensors, Jacobian,
# Montgomery domain, Z == 0 <=> identity.  Independent field operations
# of one formula are evaluated together (mont_mul_many / add_sub_many):
# the same values as the reference's one-at-a-time sequence, with far
# fewer PyTorch ops.

_ADD, _SUB = False, True


def _dbl(p):
    """Jacobian doubling, a = -3 (dbl-2001-b).  Maps identity to identity."""
    f = FIELD
    x, y, z = p
    delta, gamma = mont_mul_many(f, [(z, z), (y, y)])
    t0, t1, yz = add_sub_many(f, [(x, delta, _SUB), (x, delta, _ADD), (y, z, _ADD)])
    (t00,) = add_sub_many(f, [(t0, t0, _ADD)])
    (a3,) = add_sub_many(f, [(t00, t0, _ADD)])  # 3(x-d)
    beta, alpha, yz2, g2 = mont_mul_many(
        f, [(x, gamma), (a3, t1), (yz, yz), (gamma, gamma)]
    )
    b2, g2b, z3a = add_sub_many(
        f, [(beta, beta, _ADD), (g2, g2, _ADD), (yz2, gamma, _SUB)]
    )
    beta4, g4, z3 = add_sub_many(
        f, [(b2, b2, _ADD), (g2b, g2b, _ADD), (z3a, delta, _SUB)]
    )
    beta8, g8 = add_sub_many(f, [(beta4, beta4, _ADD), (g4, g4, _ADD)])
    (alpha2,) = mont_mul_many(f, [(alpha, alpha)])
    (x3,) = add_sub_many(f, [(alpha2, beta8, _SUB)])
    (bx,) = add_sub_many(f, [(beta4, x3, _SUB)])
    (ab,) = mont_mul_many(f, [(alpha, bx)])
    (y3,) = add_sub_many(f, [(ab, g8, _SUB)])
    return x3, y3, z3


def _madd(p, qx, qy, q_inf):
    """Mixed Jacobian + affine addition (madd, 8M+3S) -> (point, exc).

    ``exc`` flags the formula's undefined case p == q (both finite);
    p == -q falls out as the identity; identity operands are resolved by
    the reference's selects (including the x/y it leaves in an identity
    result)."""
    f = FIELD
    x1, y1, z1 = p
    (z1z1,) = mont_mul_many(f, [(z1, z1)])
    u2, z1c = mont_mul_many(f, [(qx, z1z1), (z1, z1z1)])
    (h,) = add_sub_many(f, [(u2, x1, _SUB)])
    s2, hh = mont_mul_many(f, [(qy, z1c), (h, h)])
    (r,) = add_sub_many(f, [(s2, y1, _SUB)])
    hhh, v, rr, z3 = mont_mul_many(f, [(h, hh), (x1, hh), (r, r), (z1, h)])
    t, v2 = add_sub_many(f, [(rr, hhh, _SUB), (v, v, _ADD)])
    (x3,) = add_sub_many(f, [(t, v2, _SUB)])
    (vx,) = add_sub_many(f, [(v, x3, _SUB)])
    ya, yb = mont_mul_many(f, [(r, vx), (y1, hhh)])
    (y3,) = add_sub_many(f, [(ya, yb, _SUB)])

    p_inf = fe_is_zero(z1)
    exc = fe_is_zero(h) & fe_is_zero(r) & ~p_inf & ~q_inf
    one = mont_one(f, z1.device).expand_as(z1)
    zero = torch.zeros_like(z1)
    x3 = fe_select(p_inf, qx, fe_select(q_inf, x1, x3))
    y3 = fe_select(p_inf, qy, fe_select(q_inf, y1, y3))
    z3 = fe_select(p_inf, fe_select(q_inf, zero, one), fe_select(q_inf, z1, z3))
    return (x3, y3, z3), exc


def _madd_complete_table(p, qx, qy, q_inf):
    """madd with the doubling case handled exactly (one extra _dbl) —
    used once per verify to build the G+Q table entry (Q == G yields 2G)."""
    res, exc = _madd(p, qx, qy, q_inf)
    d = _dbl(p)
    return tuple(fe_select(exc, dv, rv) for dv, rv in zip(d, res))


def _bits_of(scalar: torch.Tensor) -> torch.Tensor:
    """[B, 16] limbs -> [B, 256] bits, bit j = bit j of the scalar."""
    shifts = torch.arange(limbs.LIMB_BITS, device=scalar.device)
    return ((scalar.unsqueeze(-1) >> shifts) & 1).reshape(scalar.shape[0], 256)


def verify_packed_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: [B, 98] packed rows (any integer
    dtype) -> [B] bool, the reference's ``_verify_one_packed`` per lane:
    the row sliced into :func:`verify_plain`'s eight arrays."""
    L = limbs.NLIMBS
    cols = [rows[:, k * L : (k + 1) * L] for k in range(6)]
    return verify_plain(*cols, rows[:, 6 * L] != 0, rows[:, 6 * L + 1] != 0)


@torch.inference_mode()
def verify_plain(qx, qy, u1, u2, rr, r2, r2_ok, valid) -> torch.Tensor:
    """Plain PyTorch version of K2' (and, through
    :func:`verify_packed_plain`, of K2): qx, qy, u1, u2, r, r2 [B, 16]
    limbs (any integer dtype), r2_ok and valid [B] (nonzero = set) ->
    [B] bool, the reference's ``_verify_one`` per lane."""
    f = FIELD
    qx, qy, u1, u2, rr, r2 = (t.to(torch.int64) for t in (qx, qy, u1, u2, rr, r2))
    r2_ok, valid = r2_ok != 0, valid != 0
    b = qx.shape[0]
    dev = qx.device
    L = limbs.NLIMBS

    one = mont_one(f, dev).expand(b, L)
    gx = limbs.fe_tensor(_GX_M, dev).expand(b, L)
    gy = limbs.fe_tensor(_GY_M, dev).expand(b, L)
    r2m = limbs.fe_tensor(np.array(f.r2_mod, np.uint32), dev)
    qx_m, qy_m = mont_mul_many(f, [(qx, r2m), (qy, r2m)])

    # Table entry G+Q (affine).  Q == ±G handled exactly.
    no = torch.zeros(b, dtype=torch.bool, device=dev)
    gq = _madd_complete_table((gx, gy, one), qx_m, qy_m, no)
    gq_inf = fe_is_zero(gq[2])
    zsafe = fe_select(gq_inf, one, gq[2])
    zi = mont_inv(f, zsafe)
    (zi2,) = mont_mul_many(f, [(zi, zi)])
    gqx, zi3 = mont_mul_many(f, [(gq[0], zi2), (zi, zi2)])
    (gqy,) = mont_mul_many(f, [(gq[1], zi3)])

    bits1, bits2 = _bits_of(u1), _bits_of(u2)
    acc = (one, one, torch.zeros_like(one))  # identity
    exc = no
    for j in range(255, -1, -1):
        acc = _dbl(acc)
        d = bits1[:, j] * 2 + bits2[:, j]
        is1, is2, is3 = d == 1, d == 2, d == 3
        ax = fe_select(is1, qx_m, fe_select(is2, gx, gqx))
        ay = fe_select(is1, qy_m, fe_select(is2, gy, gqy))
        ainf = torch.where(d == 0, True, is3 & gq_inf)
        acc, e = _madd(acc, ax, ay, ainf)
        exc = exc | e

    x, _y, z = acc
    inf = fe_is_zero(z)
    (z2,) = mont_mul_many(f, [(z, z)])
    rm, r2mm = mont_mul_many(f, [(rr, r2m), (r2, r2m)])
    c1, c2 = mont_mul_many(f, [(rm, z2), (r2mm, z2)])
    ok = limbs.fe_eq(x, c1) | (r2_ok & limbs.fe_eq(x, c2))
    return ok & ~inf & ~exc & valid


def ecdsa_verify_kernel_packed(rows: torch.Tensor) -> torch.Tensor:
    """Batched ECDSA-P256 verify over packed rows -> [B] bool.

    CPU: the plain version (any integer dtype).  CUDA: K2
    (``csrc/p256_verify.cu``, :func:`group_size` threads per lane) on
    PyTorch's current stream; ``rows`` must be a contiguous [B, 98] uint16
    tensor whose storage is 4-byte aligned (the kernel reads a row as 49
    32-bit words)."""
    if rows.device.type == "cpu":
        return verify_packed_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"ecdsa_verify_kernel_packed: unsupported device {rows.device}")
    out = _launch_verify_packed(rows, group_size(rows.shape[0]))
    backend.count_launch(ecdsa_verify_kernel_packed)
    return out


def _launch_verify_packed(rows: torch.Tensor, t: int) -> torch.Tensor:
    """K2 at ``t`` threads per lane, after the wrapper-side checks; counts
    no launch (chip_smoke.py runs every group size through it)."""
    n = rows.shape[0]
    backend.require(rows, torch.uint16, (n, PACKED_COLS), "verify rows", align=4)
    out = torch.empty(n, dtype=torch.bool, device=rows.device)
    lib = backend.EXTENSION.library("p256_verify")
    with torch.cuda.device(rows.device):  # the launch goes to the current device
        rc = lib.mbt_p256_verify(
            backend.ptr(rows), backend.ptr(out), n, t, backend.current_stream(rows.device)
        )
    backend.check(lib, rc, "p256_verify")
    return out


ecdsa_verify_kernel_packed.launches = 0

_VERIFY_LIMB_ARGS = ("qx", "qy", "u1", "u2", "r", "r2")


def ecdsa_verify_kernel(qx, qy, u1, u2, rr, r2, r2_ok, valid) -> torch.Tensor:
    """Batched ECDSA-P256 verify over :func:`prepare_batch`'s eight arrays
    -> [B] bool (the reference's ``ecdsa_verify_kernel``, ``_verify_batch``).

    CPU: the plain version (any integer dtypes).  CUDA: K2'
    (``csrc/p256_verify.cu``, K2's lane function over the arrays, threads
    per lane as K2) on PyTorch's current stream; the six limb arrays must
    be contiguous [B, 16] int32 tensors of u32 limbs (each < 2^16) whose
    storage is 8-byte aligned (the kernel reads two limbs at a time),
    r2_ok and valid contiguous [B] bool tensors, all on one device."""
    arrays = (qx, qy, u1, u2, rr, r2, r2_ok, valid)
    dev = qx.device
    if any(a.device != dev for a in arrays):
        raise ValueError("ecdsa_verify_kernel: arrays on different devices")
    if dev.type == "cpu":
        return verify_plain(*arrays)
    if dev.type != "cuda":
        raise ValueError(f"ecdsa_verify_kernel: unsupported device {dev}")
    out = _launch_verify_arrays(arrays, group_size(qx.shape[0]))
    backend.count_launch(ecdsa_verify_kernel)
    return out


def _launch_verify_arrays(arrays, t: int) -> torch.Tensor:
    """K2' at ``t`` threads per lane, after the wrapper-side checks;
    counts no launch."""
    qx, r2_ok, valid = arrays[0], arrays[6], arrays[7]
    n, dev = qx.shape[0], qx.device
    for name, a in zip(_VERIFY_LIMB_ARGS, arrays[:6]):
        backend.require(a, torch.int32, (n, limbs.NLIMBS), f"verify {name}", align=8)
    backend.require(r2_ok, torch.bool, (n,), "verify r2_ok")
    backend.require(valid, torch.bool, (n,), "verify valid")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = backend.EXTENSION.library("p256_verify")
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.mbt_p256_verify_arrays(
            *(backend.ptr(a) for a in arrays), backend.ptr(out), n, t,
            backend.current_stream(dev),
        )
    backend.check(lib, rc, "p256_verify_arrays")
    return out


ecdsa_verify_kernel.launches = 0


# ---------------------------------------------------------------------------
# Host-side batch preparation (copied from the reference unchanged).
#
# ONE modular inversion per batch (Montgomery batch inversion), whole-
# batch limb packing through one '<u2' view, and range validity (r, s in
# [1, n-1], coordinates < p, the r + n < p second-candidate window) as
# vectorized limb comparisons feeding the kernel's ``valid`` lanes.
# ``prepare_batch_scalar`` is the per-item oracle.

_ZERO128 = b"\x00" * 128  # one all-zero packed record (r | s | x | y)
_N_WORDS = limbs.words_of(N)
_P_WORDS = limbs.words_of(P)
_PN_WORDS = limbs.words_of(P - N)  # r + n < p  <=>  r < p - n


def prepare_batch_scalar(
    items: Sequence[Tuple[Tuple[int, int], bytes, Tuple[int, int]]],
) -> Tuple[np.ndarray, ...]:
    """Per-item reference prep: one ``pow(s, -1, N)`` and six ``to_limbs``
    per lane.  The differential ORACLE for the vectorized
    :func:`prepare_batch`, kept verbatim."""
    b = len(items)
    qx = np.zeros((b, limbs.NLIMBS), np.uint32)
    qy = np.zeros((b, limbs.NLIMBS), np.uint32)
    u1 = np.zeros((b, limbs.NLIMBS), np.uint32)
    u2 = np.zeros((b, limbs.NLIMBS), np.uint32)
    rr = np.zeros((b, limbs.NLIMBS), np.uint32)
    r2 = np.zeros((b, limbs.NLIMBS), np.uint32)
    r2_ok = np.zeros((b,), np.bool_)
    valid = np.zeros((b,), np.bool_)
    for i, ((x, y), digest, (r, s)) in enumerate(items):
        if not (0 < r < N and 0 < s < N and 0 <= x < P and 0 <= y < P):
            continue
        z = int.from_bytes(digest[:32], "big") % N
        w = pow(s, -1, N)
        qx[i] = to_limbs(x)
        qy[i] = to_limbs(y)
        u1[i] = to_limbs((z * w) % N)
        u2[i] = to_limbs((r * w) % N)
        rr[i] = to_limbs(r)
        if r + N < P:
            r2[i] = to_limbs(r + N)
            r2_ok[i] = True
        valid[i] = True
    return qx, qy, u1, u2, rr, r2, r2_ok, valid


def prepare_batch(
    items: Sequence[Tuple[Tuple[int, int], bytes, Tuple[int, int]]],
) -> Tuple[np.ndarray, ...]:
    """[(pubkey (x, y), digest32, (r, s))] -> device-ready limb arrays.

    Host computes w = s^-1 mod n (ONE batch inversion for the whole
    batch), u1 = z*w, u2 = r*w (mod n) with Python big ints, and packs /
    range-checks the batch with vectorized numpy (see the section note
    above).  Out-of-range signatures get valid=False and all-zero lanes so
    the batch shape never changes.  Bit-identical to
    :func:`prepare_batch_scalar`.
    """
    b = len(items)
    nl = limbs.NLIMBS
    if b == 0:
        z16 = np.zeros((0, nl), np.uint32)
        zb = np.zeros((0,), np.bool_)
        return z16, z16, z16, z16, z16, z16, zb, zb

    # Pass 1 (per item, C-level): ints -> little-endian bytes.  Values
    # outside [0, 2^256) cannot pack (to_bytes raises) — their lane is
    # invalid regardless of the curve-order checks below, so pack zeros
    # and mark unfit.
    buf = bytearray()
    unfit = []
    for i, ((x, y), _digest, (r, s)) in enumerate(items):
        try:
            rec = (
                r.to_bytes(32, "little")
                + s.to_bytes(32, "little")
                + x.to_bytes(32, "little")
                + y.to_bytes(32, "little")
            )
        except (OverflowError, TypeError, AttributeError):
            rec = _ZERO128
            unfit.append(i)
        buf += rec
    raw = bytes(buf)
    rows = np.frombuffer(raw, dtype="<u2").reshape(b, 4, nl)
    words = np.frombuffer(raw, dtype="<u8").reshape(b, 4, 4)
    rw, sw = words[:, 0], words[:, 1]

    # Vectorized range validity: r, s in [1, n-1]; coordinates < p.
    valid = (
        rw.any(axis=1)
        & limbs.words_lt(rw, _N_WORDS)
        & sw.any(axis=1)
        & limbs.words_lt(sw, _N_WORDS)
        & limbs.words_lt(words[:, 2], _P_WORDS)
        & limbs.words_lt(words[:, 3], _P_WORDS)
    )
    if unfit:
        valid[unfit] = False

    # Pass 2 (valid lanes only): ONE inversion for the batch, then 2
    # multiplies per lane for the scalars.
    all_valid = bool(valid.all())
    idx = range(b) if all_valid else np.flatnonzero(valid).tolist()
    ws = limbs.batch_inv_host([items[i][2][1] for i in idx], N)
    u1_ints, u2_ints = [], []
    for i, w in zip(idx, ws):
        (_xy, digest, (r, _s)) = items[i]
        z = int.from_bytes(digest[:32], "big") % N
        u1_ints.append(z * w % N)
        u2_ints.append(r * w % N)
    if all_valid:
        u1 = limbs.to_limbs_batch(u1_ints)
        u2 = limbs.to_limbs_batch(u2_ints)
    else:
        u1 = np.zeros((b, nl), np.uint32)
        u2 = np.zeros((b, nl), np.uint32)
        if idx:
            u1[idx] = limbs.to_limbs_batch(u1_ints)
            u2[idx] = limbs.to_limbs_batch(u2_ints)

    # Second x-candidate: r + n < p  <=>  r < p - n, so the window check
    # needs no addition; the candidate itself is a vectorized limb add
    # computed only over the (rare: r < ~2^224) lanes inside the window —
    # no overflow there since r + n < p < 2^256.
    r2_ok = valid & limbs.words_lt(rw, _PN_WORDS)
    r2 = np.zeros((b, nl), np.uint32)
    i2 = np.flatnonzero(r2_ok)
    if len(i2):
        r2[i2] = limbs.limbs_add_const(rows[i2, 0], N)

    # Invalid lanes are all-zero in the oracle (its loop skips them
    # before writing) — mask for bit-identical output.
    if all_valid:
        qx = rows[:, 2].astype(np.uint32)
        qy = rows[:, 3].astype(np.uint32)
        rr = rows[:, 0].astype(np.uint32)
    else:
        lane = valid[:, None]
        z16 = np.uint16(0)
        qx = np.where(lane, rows[:, 2], z16).astype(np.uint32)
        qy = np.where(lane, rows[:, 3], z16).astype(np.uint32)
        rr = np.where(lane, rows[:, 0], z16).astype(np.uint32)
    return qx, qy, u1, u2, rr, r2, r2_ok, valid


def verify_batch(items, device=None) -> np.ndarray:
    """Convenience wrapper: prepare on host, verify on ``device`` (default
    ``cuda:0``) through the eight-array form, as the reference's does ->
    [B] bool."""
    dev = backend.resolve_device(device)
    arrays = limbs.arrays_to(prepare_batch(items), dev)
    return ecdsa_verify_kernel(*arrays).cpu().numpy()


# Packed I/O: one u16 row per lane (limb values are 16-bit by
# construction, flags are 0/1) — one upload per dispatch.

PACKED_COLS = 6 * limbs.NLIMBS + 2  # qx qy u1 u2 r r2 | r2_ok valid


def pack_arrays(arrays) -> np.ndarray:
    """prepare_batch output -> [B, PACKED_COLS] u16 (one upload)."""
    qx, qy, u1, u2, rr, r2, r2_ok, valid = arrays
    return np.concatenate(
        [
            qx, qy, u1, u2, rr, r2,
            r2_ok[:, None].astype(np.uint32),
            valid[:, None].astype(np.uint32),
        ],
        axis=1,
    ).astype(np.uint16)


def prepare_packed(
    items: Sequence[Tuple[Tuple[int, int], bytes, Tuple[int, int]]],
    bucket: int,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """prepare_batch + pack_arrays fused into one [bucket, PACKED_COLS]
    u16 staging write.  ``out`` (engine-owned staging buffer, recycled
    across dispatches) is written in place when given; padding the batch
    to ``bucket`` is a tail slice-zero instead of materializing
    ``list(items) + [PAD] * k`` and prepping the pad lanes."""
    n = len(items)
    out = limbs.staging_out(out, bucket, PACKED_COLS, n)
    qx, qy, u1, u2, rr, r2, r2_ok, valid = prepare_batch(items)
    L = limbs.NLIMBS
    out[:n, 0:L] = qx
    out[:n, L : 2 * L] = qy
    out[:n, 2 * L : 3 * L] = u1
    out[:n, 3 * L : 4 * L] = u2
    out[:n, 4 * L : 5 * L] = rr
    out[:n, 5 * L : 6 * L] = r2
    out[:n, 6 * L] = r2_ok
    out[:n, 6 * L + 1] = valid
    out[n:] = 0
    return out


# ---------------------------------------------------------------------------
# Batched signing: the fixed-base comb.
#
# k = sum_j k_j * 16^j over 64 nibble windows; T[j][v] = v * 16^j * G
# (affine, Montgomery domain) is built on the host, so k*G is 64 mixed
# additions with no doublings.  The RFC 6979 nonce, k^-1 and s stay on
# the host; signatures are byte-identical to hostcrypto.ecdsa_sign_py.

_COMB_WINDOWS = 64
_COMB_TABLE_NP: np.ndarray | None = None


def _comb_table_np() -> np.ndarray:
    """[64, 16, 2, NLIMBS] u32: T[j][v] = affine(v * 16^j * G), Montgomery
    domain; the v=0 rows are zeros (skipped via the q_inf flag).  Built
    once with host big-int affine arithmetic (~1k cheap ops)."""
    global _COMB_TABLE_NP
    if _COMB_TABLE_NP is not None:
        return _COMB_TABLE_NP

    def aff_add(p1, p2):
        if p1 is None:
            return p2
        (x1, y1), (x2, y2) = p1, p2
        if x1 == x2:
            if (y1 + y2) % P == 0:
                return None
            lam = (3 * x1 * x1 - 3) * pow(2 * y1, -1, P) % P
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
        x3 = (lam * lam - x1 - x2) % P
        return x3, (lam * (x1 - x3) - y1) % P

    tab = np.zeros((_COMB_WINDOWS, 16, 2, limbs.NLIMBS), np.uint32)
    base = (GX, GY)  # 16^j * G for the current window
    for j in range(_COMB_WINDOWS):
        acc = None
        for v in range(1, 16):
            acc = aff_add(acc, base)
            x, y = acc
            tab[j, v, 0] = to_limbs((x << 256) % P)
            tab[j, v, 1] = to_limbs((y << 256) % P)
        for _ in range(4):  # base <- 16 * base
            base = aff_add(base, base)
    _COMB_TABLE_NP = tab
    return tab

@torch.inference_mode()
def kg_plain(k: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: [B, 16] nonce limbs (any integer
    dtype) and the [64, 16, 2, 16] comb table -> [B, 2, 16] int64 (X, Z),
    Jacobian, Montgomery domain; ``exc`` folds to Z = 0."""
    k = k.to(torch.int64)
    table = table.to(torch.int64)
    b = k.shape[0]
    dev = k.device
    L = limbs.NLIMBS
    shifts = 4 * torch.arange(4, device=dev)
    nibs = ((k.unsqueeze(-1) >> shifts) & 0xF).reshape(b, _COMB_WINDOWS)
    one = mont_one(FIELD, dev).expand(b, L)
    acc = (one, one, torch.zeros_like(one))
    exc = torch.zeros(b, dtype=torch.bool, device=dev)
    for j in range(_COMB_WINDOWS):
        v = nibs[:, j]
        sel = table[j][v]  # [B, 2, L]; the v = 0 rows are zeros
        acc, e = _madd(acc, sel[:, 0], sel[:, 1], v == 0)
        exc = exc | e
    z = fe_select(exc, torch.zeros_like(acc[2]), acc[2])
    return torch.stack([acc[0], z], dim=1)


@functools.lru_cache(maxsize=None)
def comb_table_limbs() -> torch.Tensor:
    """The plain version's comb table, built once: [64, 16, 2, 16] int64
    limbs on the CPU (move it with ``.to`` to run the plain version on
    another device)."""
    return torch.from_numpy(_comb_table_np().astype(np.int64))


@functools.lru_cache(maxsize=None)
def comb_table_words(device: str) -> torch.Tensor:
    """K3's comb table on the CUDA ``device``, uploaded once: [64, 16, 2, 8]
    32-bit words (stored as int32, 64 KiB)."""
    tab = _comb_table_np()
    words = tab[..., 0::2] | (tab[..., 1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


def ecdsa_kg_kernel(k: torch.Tensor) -> torch.Tensor:
    """Batched k*G: [B, 16] uint16 nonce limbs -> [B, 2, 16] uint16 (X, Z),
    Jacobian, Montgomery domain.

    CPU: the plain version.  CUDA: K3 (``csrc/p256_kg.cu``,
    :func:`group_size` threads per lane, the table in global memory) on
    the current stream; ``k`` must be contiguous and its storage 16-byte
    aligned (the kernel reads a nonce as two 16-byte words)."""
    if k.device.type == "cpu":
        return kg_plain(k, comb_table_limbs()).to(torch.uint16)
    if k.device.type != "cuda":
        raise ValueError(f"ecdsa_kg_kernel: unsupported device {k.device}")
    out = _launch_kg(k, group_size(k.shape[0]))
    backend.count_launch(ecdsa_kg_kernel)
    return out


def _launch_kg(k: torch.Tensor, t: int) -> torch.Tensor:
    """K3 at ``t`` threads per lane, after the wrapper-side checks; counts
    no launch."""
    n = k.shape[0]
    backend.require(k, torch.uint16, (n, limbs.NLIMBS), "kg nonces", align=16)
    table = comb_table_words(str(k.device))
    out = torch.empty((n, 2, limbs.NLIMBS), dtype=torch.uint16, device=k.device)
    lib = backend.EXTENSION.library("p256_kg")
    with torch.cuda.device(k.device):  # the launch goes to the current device
        rc = lib.mbt_p256_kg(
            backend.ptr(k), backend.ptr(table), backend.ptr(out), n, t,
            backend.current_stream(k.device),
        )
    backend.check(lib, rc, "p256_kg")
    return out


ecdsa_kg_kernel.launches = 0


@torch.inference_mode()
def kg_ladder_plain(k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, the reference's ``_kg_one`` per lane:
    [B, 16] nonce limbs (any integer dtype) -> [B, 2, 16] int64 (X, Z),
    Jacobian, Montgomery domain, by 256 steps of double then mixed add of
    G (skipped by ``q_inf`` for a 0 bit) from bit 255 down; ``exc`` folds
    to Z = 0."""
    k = k.to(torch.int64)
    b = k.shape[0]
    dev = k.device
    L = limbs.NLIMBS
    bits = _bits_of(k)
    one = mont_one(FIELD, dev).expand(b, L)
    gx = limbs.fe_tensor(_GX_M, dev).expand(b, L)
    gy = limbs.fe_tensor(_GY_M, dev).expand(b, L)
    acc = (one, one, torch.zeros_like(one))
    exc = torch.zeros(b, dtype=torch.bool, device=dev)
    for j in range(255, -1, -1):
        acc = _dbl(acc)
        acc, e = _madd(acc, gx, gy, bits[:, j] == 0)
        exc = exc | e
    z = fe_select(exc, torch.zeros_like(acc[2]), acc[2])
    return torch.stack([acc[0], z], dim=1)


def ecdsa_kg_ladder_kernel(k: torch.Tensor) -> torch.Tensor:
    """Batched k*G by the double-then-add ladder (the reference's
    ``ecdsa_kg_ladder_kernel``, K3's differential reference): [B, 16]
    uint16 nonce limbs -> [B, 2, 16] uint16 (X, Z), Jacobian, Montgomery
    domain: K3's layout, so :func:`sign_finish` takes either kernel's
    output.  The values equal the reference's u32 output bit for bit.

    CPU: the plain version.  CUDA: K4 (``csrc/p256_kg_ladder.cu``,
    :func:`group_size` threads per lane: 4 up to ``GROUP_LIMIT`` lanes, 1
    above) on the current stream; ``k`` must be contiguous and its storage
    16-byte aligned (the kernel reads a nonce as two 16-byte words)."""
    if k.device.type == "cpu":
        return kg_ladder_plain(k).to(torch.uint16)
    if k.device.type != "cuda":
        raise ValueError(f"ecdsa_kg_ladder_kernel: unsupported device {k.device}")
    out = _launch_kg_ladder(k, group_size(k.shape[0]))
    backend.count_launch(ecdsa_kg_ladder_kernel)
    return out


def _launch_kg_ladder(k: torch.Tensor, t: int) -> torch.Tensor:
    """K4 at ``t`` threads per lane, after the wrapper-side checks; counts
    no launch."""
    n = k.shape[0]
    backend.require(k, torch.uint16, (n, limbs.NLIMBS), "kg ladder nonces", align=16)
    out = torch.empty((n, 2, limbs.NLIMBS), dtype=torch.uint16, device=k.device)
    lib = backend.EXTENSION.library("p256_kg_ladder")
    with torch.cuda.device(k.device):  # the launch goes to the current device
        rc = lib.mbt_p256_kg_ladder(
            backend.ptr(k), backend.ptr(out), n, t, backend.current_stream(k.device)
        )
    backend.check(lib, rc, "p256_kg_ladder")
    return out


ecdsa_kg_ladder_kernel.launches = 0

_batch_inv = limbs.batch_inv_host

# Staging layout for the sign path: one [16] u16 nonce-limb row per lane
# (the k*G kernels upload u16 and widen on device).  The engine's sign
# queue recycles [bucket, SIGN_COLS] buffers through its _StagingPool
# exactly like the verify path's packed uploads.
SIGN_COLS = limbs.NLIMBS


def sign_prepare(
    items: Sequence[Tuple[int, bytes]],
    bucket: int,
    out: "np.ndarray | None" = None,
) -> Tuple[np.ndarray, list]:
    """Host half 1 of batched signing: derive the RFC 6979 nonce per item
    (an HMAC-SHA256 chain — inherently per-item, but cheap host hashing)
    and pack the whole batch's nonce limbs with one bulk '<u2' view
    (:func:`minbft_tpu.ops.limbs.to_limbs_batch`) into ``out`` (an
    engine-owned recycled staging buffer when given).  Pad lanes get
    k = 1 — a valid scalar whose result is discarded — as a tail write,
    never a re-derivation.  Returns ``(staging, meta)``; ``meta`` is the
    per-lane ``(d, z, k)`` list :func:`sign_finish` consumes."""
    n = len(items)
    out = limbs.staging_out(out, bucket, SIGN_COLS, n)
    meta = []
    ks = []
    for d, digest in items:
        z = int.from_bytes(digest[:32], "big") % N
        k = hc._rfc6979_k(d, z)
        meta.append((d, z, k))
        ks.append(k)
    if n:
        out[:n] = limbs.to_limbs_batch(ks)
    out[n:] = 0
    out[n:, 0] = 1  # k = 1: a valid lane, result discarded
    return out, meta


def sign_finish(
    items: Sequence[Tuple[int, bytes]], meta: list, xz
) -> list:
    """Host half 2: turn the device's [B, 2, 16] X/Z limbs into (r, s).

    ONE Montgomery batch inversion each for the Z^2 chain (mod p) and the
    nonces (mod n) — 3 big-int multiplies per lane instead of a ~25us
    ``pow`` each (``batch_inv_host``).  Exceptional
    lanes (Z == 0) and the vanishing-probability r == 0 / s == 0 RFC 6979
    retries fall back to the serial host signer per lane."""
    b = len(meta)
    xz = np.concatenate([np.asarray(o) for o in xz]) if isinstance(
        xz, (list, tuple)
    ) else np.asarray(xz)
    xz = xz.astype("<u2")[:b]  # [B,2,16]
    # Vectorized limb→int: uint16 rows → little-endian bytes → one
    # int.from_bytes per row (a per-limb shift-sum costs ~250us/row).
    x_ints = [int.from_bytes(row.tobytes(), "little") for row in xz[:, 0]]
    z_ints = [int.from_bytes(row.tobytes(), "little") for row in xz[:, 1]]

    r_inv = pow(1 << 256, -1, P)  # undo the Montgomery factor on host
    valid = [i for i in range(b) if z_ints[i] != 0]
    zj = {i: z_ints[i] * r_inv % P for i in valid}
    zz_invs = dict(
        zip(valid, _batch_inv([zj[i] * zj[i] % P for i in valid], P))
    )
    k_invs = dict(zip(valid, _batch_inv([meta[i][2] for i in valid], N)))

    out = []
    for i, (d, z, k) in enumerate(meta):
        if i not in zz_invs:  # infinity / exceptional lane: serial fallback
            out.append(hc.ecdsa_sign_py(d, items[i][1]))
            continue
        x_aff = (x_ints[i] * r_inv % P) * zz_invs[i] % P
        r = x_aff % N
        s = k_invs[i] * (z + r * d) % N
        if r == 0 or s == 0:  # vanishing-probability RFC 6979 retry path
            out.append(hc.ecdsa_sign_py(d, items[i][1]))
            continue
        out.append((r, s))
    return out

def sign_batch(
    items: Sequence[Tuple[int, bytes]],
    bucket: int = 0,
    device=None,
) -> list:
    """[(private scalar d, digest32)] -> [(r, s)] — RFC 6979 deterministic,
    byte-identical to :func:`minbft_tpu_torch.utils.hostcrypto.ecdsa_sign_py`.
    ``bucket`` pads the device batch (pad lanes compute 1*G and are
    discarded).  Composition of :func:`sign_prepare` → k*G on ``device``
    (default ``cuda:0``) → :func:`sign_finish`."""
    b = len(items)
    if b == 0 and bucket == 0:
        return []
    dev = backend.resolve_device(device)
    k_arr, meta = sign_prepare(items, max(bucket, b))
    xz = ecdsa_kg_kernel(torch.from_numpy(k_arr).to(dev)).cpu().numpy()
    return sign_finish(items, meta, xz)


def is_on_curve(x: int, y: int) -> bool:
    """Host-side curve membership check (not hot path)."""
    if not (0 <= x < P and 0 <= y < P):
        return False
    return (y * y - (x * x * x - 3 * x + B)) % P == 0
