"""256-bit modular arithmetic: host limb helpers, plain PyTorch field ops
and the K1 field kernel's wrapper.

Port of :mod:`minbft_tpu.ops.limbs`.  Three layers:

- **Host helpers** (numpy, copied from the reference unchanged):
  ``to_limbs*`` / ``from_limbs*``, the vectorized 256-bit comparisons
  that feed the verify prep's range checks, ``staging_out``,
  ``batch_inv_host`` and :class:`FieldSpec`.
- **Plain PyTorch field ops** over ``[..., 16]`` int64 tensors of 16-bit
  little-endian limbs: the reference's lazy-carry CIOS Montgomery
  multiply (R = 2^256), modular add/sub with the same single conditional
  subtract, Fermat inversion.  Every op returns the same bits as the
  reference's (all outputs are fully reduced, and the one conditional
  subtract follows the reference's ``t_hi >= borrow`` rule exactly).
  These are the CPU path and the yardstick the CUDA kernels are held
  against.
- **K1** (:func:`field_op`): a launchable test kernel over the device
  field libraries K2-K4, K7 and K8 are built on: ``csrc/p256_field.cuh``
  (mod the P-256 prime, specialised to it, at one thread per lane or in
  groups of 4) and ``csrc/field.cuh`` (mod n and 2^255 - 19).

Nothing here imports ``jax`` or the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from . import backend

NLIMBS = 16
LIMB_BITS = 16
MASK = np.uint32(0xFFFF)
BITS = NLIMBS * LIMB_BITS  # 256


# ---------------------------------------------------------------------------
# Host-side conversions (Python int <-> limbs).


def to_limbs(x: int) -> np.ndarray:
    """Python int (< 2^256) -> [16] uint32 little-endian 16-bit limbs."""
    if not 0 <= x < (1 << BITS):
        raise ValueError("value out of 256-bit range")
    return np.array(
        [(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(NLIMBS)], dtype=np.uint32
    )


def from_limbs(limbs) -> int:
    """[16] limb vector -> Python int."""
    arr = np.asarray(limbs, dtype=np.uint64)
    return sum(int(arr[..., i]) << (LIMB_BITS * i) for i in range(NLIMBS))


def staging_out(out, bucket: int, cols: int, n: int) -> np.ndarray:
    """Validate (or allocate) a [bucket, cols] u16 staging buffer for a
    fused prepare_packed write."""
    if n > bucket:
        raise ValueError(f"batch {n} exceeds bucket {bucket}")
    if out is None:
        return np.empty((bucket, cols), np.uint16)
    if out.shape != (bucket, cols) or out.dtype != np.uint16:
        raise ValueError(
            f"staging buffer {out.shape}/{out.dtype} != "
            f"({bucket}, {cols})/uint16"
        )
    return out
#
# The 16-bit little-endian limb layout IS numpy's '<u2' byte layout, so a
# whole batch converts with one ``frombuffer`` over the concatenated
# little-endian int bytes — no per-limb Python.


def to_limbs_batch(vals) -> np.ndarray:
    """Iterable of B Python ints (each in [0, 2^256)) -> [B, 16] uint32."""
    vals = vals if isinstance(vals, (list, tuple)) else list(vals)
    if not vals:
        return np.zeros((0, NLIMBS), np.uint32)
    buf = b"".join([v.to_bytes(32, "little") for v in vals])
    return (
        np.frombuffer(buf, dtype="<u2")
        .reshape(len(vals), NLIMBS)
        .astype(np.uint32)
    )


def from_limbs_batch(rows) -> list:
    """[B, 16] limb rows (any int dtype, values < 2^16) -> list of B ints."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(rows), dtype="<u2")
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


def limb_words(rows: np.ndarray) -> np.ndarray:
    """[B, 16] limb rows (values < 2^16) -> [B, 4] '<u8' word view."""
    rows = np.asarray(rows)
    if rows.dtype != np.dtype("<u2"):
        rows = rows.astype("<u2")
    return np.ascontiguousarray(rows).view("<u8")


def words_of(x: int) -> np.ndarray:
    """Host constant -> [4] '<u8' little-endian words (for words_lt)."""
    return np.frombuffer(x.to_bytes(32, "little"), dtype="<u8")


def words_lt(words: np.ndarray, bound_words: np.ndarray) -> np.ndarray:
    """Vectorized 256-bit compare over [B, 4] '<u8' words -> [B] bool
    (lexicographic scan from the most-significant word down)."""
    lt = np.zeros(words.shape[0], np.bool_)
    decided = np.zeros(words.shape[0], np.bool_)
    for i in (3, 2, 1, 0):
        col = words[:, i]
        b = bound_words[i]
        lt |= ~decided & (col < b)
        decided |= col != b
    return lt


def limbs_lt(rows: np.ndarray, bound: int) -> np.ndarray:
    """Vectorized 256-bit compare: [B, 16] limb rows < bound -> [B] bool."""
    return words_lt(limb_words(rows), words_of(bound))


def limbs_is_zero(rows: np.ndarray) -> np.ndarray:
    """[B, 16] limb rows == 0 -> [B] bool (vectorized)."""
    return ~limb_words(rows).any(axis=1)


def limbs_add_const(rows: np.ndarray, c: int) -> np.ndarray:
    """(rows + c) mod 2^256 -> [B, 16] uint32, limbwise with vectorized
    carry propagation.  Callers gate on a no-overflow condition."""
    cl = to_limbs(c)
    rows = np.asarray(rows, dtype=np.uint32)
    out = np.empty_like(rows)
    carry = np.zeros(rows.shape[0], np.uint32)
    for i in range(NLIMBS):
        s = rows[:, i] + cl[i] + carry
        out[:, i] = s & MASK
        carry = s >> np.uint32(LIMB_BITS)
    return out


def fe_const(x: int) -> Tuple[np.uint32, ...]:
    """Host constant as a tuple of uint32 limbs."""
    return tuple(np.uint32(int(v)) for v in to_limbs(x))


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Constants for Montgomery arithmetic mod a fixed 256-bit modulus."""

    modulus_int: int
    modulus: Tuple[np.uint32, ...]
    m_prime: np.uint32  # -modulus^-1 mod 2^16
    r_mod: Tuple[np.uint32, ...]  # R mod m    (Montgomery one)
    r2_mod: Tuple[np.uint32, ...]  # R^2 mod m  (to-Montgomery factor)

    @staticmethod
    def make(modulus: int) -> "FieldSpec":
        r = 1 << BITS
        m_inv = pow(modulus, -1, 1 << LIMB_BITS)
        return FieldSpec(
            modulus_int=modulus,
            modulus=fe_const(modulus),
            m_prime=np.uint32((-m_inv) % (1 << LIMB_BITS)),
            r_mod=fe_const(r % modulus),
            r2_mod=fe_const((r * r) % modulus),
        )


def batch_inv_host(vals, mod):
    """Host-side Montgomery batch inversion: one ``pow`` + 3(B-1) mults
    for B inverses.  All vals must be nonzero."""
    n = len(vals)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    p = 1
    for i, v in enumerate(vals):
        p = p * v % mod
        prefix[i + 1] = p
    inv_total = pow(p, -1, mod)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_total % mod
        inv_total = inv_total * vals[i] % mod
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch field ops.
#
# A field element is a [..., 16] int64 tensor of 16-bit limbs.  int64
# leaves room for the lazy carries (column sums stay below 2^40), and the
# arithmetic right shift of a negative int64 is a floor, so one carry
# helper serves additions and borrows alike.  On the CPU these ops are
# bound by PyTorch's per-op overhead, not by arithmetic: they work on
# whole columns of the batch at once and keep the op count per field
# operation small (the carry ripple runs over 48-bit words, three limbs
# each, instead of over 16 limbs).  The plain versions the wrappers call
# (``field_op_plain`` here, ``verify_plain``/``kg_plain``/``kg_ladder_plain``
# in p256.py, ``verify_plain``/``rb_plain`` in ed25519.py) run under
# ``torch.inference_mode()``, which drops autograd's share of that
# overhead (about a third of a plain K2 call on the CPU).

_M16 = 0xFFFF
_M48 = (1 << 48) - 1


@functools.lru_cache(maxsize=None)
def _consts(modulus: int, device: str):
    spec = FieldSpec.make(modulus)

    def t(v):
        return torch.tensor([int(x) for x in v], dtype=torch.int64, device=device)

    m = t(spec.modulus)
    return {
        "m": m,
        "m_words": _to_words(torch.nn.functional.pad(m, (0, 2))),
        "mp": int(spec.m_prime),
        "one": t(spec.r_mod),
        "r2": t(spec.r2_mod),
        "unit": t(fe_const(1)),
    }


def arrays_to(arrays, device) -> tuple:
    """Host prep's numpy arrays (``prepare_batch``'s) as the multi-array
    kernels' tensors on ``device``: bool arrays stay bool, the others (u32
    limbs and words) become int32 tensors of the same bits."""
    return tuple(
        torch.from_numpy(
            a if a.dtype == np.bool_
            else np.ascontiguousarray(a, np.uint32).view(np.int32)
        ).to(device)
        for a in map(np.asarray, arrays)
    )


def fe_tensor(x, device="cpu") -> torch.Tensor:
    """Limb rows (numpy, tensor of any int dtype, or a Python int) ->
    int64 tensor on ``device``."""
    if isinstance(x, int):
        x = to_limbs(x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).astype(np.int64))
    return x.to(device=device, dtype=torch.int64)


# The carry work runs over six 48-bit words (three limbs each; word 5
# holds limb 15 and the two headroom limbs above bit 256) instead of over
# 16 limbs: five ripple steps per propagation.


def _to_words(t18: torch.Tensor) -> torch.Tensor:
    """[..., 18] columns (|column| < 2^24) -> [..., 6] int64 words."""
    w = t18.reshape(t18.shape[:-1] + (6, 3))
    return w[..., 0] + (w[..., 1] << 16) + (w[..., 2] << 32)


def _ripple(w: torch.Tensor) -> list:
    """Propagate carries (or borrows: >> is a floor) up the six words.
    Words 0-4 keep their unmasked values; word 5 receives every carry."""
    cols = list(w.unbind(-1))
    for j in range(5):
        cols[j + 1] = cols[j + 1] + (cols[j] >> 48)
    return cols


def _low_words(cols: list) -> torch.Tensor:
    """The low 256 bits of rippled words, as [..., 6] words."""
    return torch.stack(cols[:5] + [cols[5] & _M16], -1) & _M48


def _reduce(c, raw: torch.Tensor) -> torch.Tensor:
    """[..., 18] columns of a value t -> its 16 limbs after the
    reference's ``_cond_sub``: with t_hi = t >> 256 read as uint32 and
    borrow = (t mod 2^256 < m), t - m (mod 2^256) if t_hi >= borrow,
    else t mod 2^256."""
    cols = _ripple(_to_words(raw))
    t_hi = cols[5] >> 16
    low = _low_words(cols)
    dcols = _ripple(low - c["m_words"])
    borrow = ((dcols[5] >> 16) != 0).to(torch.int64)
    ge = (t_hi & 0xFFFFFFFF) >= borrow
    w = torch.where(ge.unsqueeze(-1), _low_words(dcols), low)
    limbs = torch.stack((w & _M16, (w >> 16) & _M16, w >> 32), -1)
    return limbs.reshape(w.shape[:-1] + (18,))[..., :NLIMBS]


def _pad2(t: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 2))


def add_mod(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod m; inputs fully reduced < m, output fully reduced."""
    c = _consts(spec.modulus_int, str(a.device))
    return _reduce(c, _pad2(a + b))


def sub_mod(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod m as the reference computes it: a + m - b, whose high
    part (carry minus borrow, read as uint32) drives one conditional
    subtract."""
    c = _consts(spec.modulus_int, str(a.device))
    return _reduce(c, _pad2(a + c["m"] - b))


def add_sub_many(spec: FieldSpec, terms) -> list:
    """Independent :func:`add_mod` / :func:`sub_mod` results in one carry
    pass: ``terms = [(a, b, subtract), ...]``.  Same values as one call
    each."""
    c = _consts(spec.modulus_int, str(terms[0][0].device))
    raws = [a + c["m"] - b if neg else a + b for a, b, neg in terms]
    out = _reduce(c, _pad2(torch.stack(torch.broadcast_tensors(*raws))))
    return list(out.unbind(0))


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod m (R = 2^256) by the reference's
    lazy-carry CIOS: 16 outer steps, each adding a_i*b and u*m into
    column accumulators with no carry propagation except column i's
    carry into column i+1 (column i's low 16 bits are exact when its
    quotient digit u = t_i * m' mod 2^16 is taken).  One carry pass and
    one conditional subtract finish it.  ``a`` and ``b`` broadcast."""
    c = _consts(spec.modulus_int, str(a.device))
    a, b = torch.broadcast_tensors(a, b)
    m, mp = c["m"], c["mp"]
    t = a.new_zeros(a.shape[:-1] + (2 * NLIMBS + 2,))
    a_cols = a.unsqueeze(-1).unbind(-2)
    t_cols = t.unbind(-1)  # views: they see every update below
    for i in range(NLIMBS):
        win = t[..., i : i + NLIMBS]
        win.addcmul_(a_cols[i], b)
        ti = t_cols[i]
        u = ti & _M16 if mp == 1 else (ti * mp) & _M16
        win.addcmul_(u.unsqueeze(-1), m)
        t_cols[i + 1].add_(ti >> 16)
    # Columns are below 2^40: one partial carry pass brings them under
    # 2^24 for the word packing (t < 2R, so nothing leaves column 17).
    w = t[..., NLIMBS:]
    w = (w & _M16) + torch.nn.functional.pad(w[..., :-1] >> 16, (1, 0))
    return _reduce(c, w)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a -> a*R mod m."""
    return mont_mul(spec, a, _consts(spec.modulus_int, str(a.device))["r2"])


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a*R -> a mod m (multiply by 1)."""
    return mont_mul(spec, a, _consts(spec.modulus_int, str(a.device))["unit"])


def mont_one(spec: FieldSpec, device) -> torch.Tensor:
    return _consts(spec.modulus_int, str(device))["one"]


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion a^(m-2), Montgomery domain — modulus must be
    prime.  Square-and-multiply over the exponent's 256 bits from the
    top, starting from the Montgomery one (the reference's
    ``mont_pow_static``; the exponent is static, so the multiply is
    skipped where its bit is 0 rather than computed and discarded)."""
    e = spec.modulus_int - 2
    acc = mont_one(spec, a.device).expand_as(a)
    for i in range(BITS - 1, -1, -1):
        acc = mont_sqr(spec, acc)
        if (e >> i) & 1:
            acc = mont_mul(spec, acc, a)
    return acc


def fe_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(cond, a, b) limbwise; cond is [...] bool."""
    return torch.where(cond.unsqueeze(-1), a, b)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def mont_mul_many(spec: FieldSpec, pairs) -> list:
    """Independent Montgomery products in ONE :func:`mont_mul` call over
    the stacked pairs — the same values as one call each, at a fraction
    of the per-op overhead that bounds the plain version on the CPU."""
    if len(pairs) == 1:
        return [mont_mul(spec, *pairs[0])]
    a = torch.stack([torch.broadcast_tensors(x, y)[0] for x, y in pairs])
    b = torch.stack([torch.broadcast_tensors(x, y)[1] for x, y in pairs])
    return list(mont_mul(spec, a, b).unbind(0))


# ---------------------------------------------------------------------------
# K1: the device field library's test kernel.
#
# Replaces the field arithmetic of minbft_tpu/ops/limbs.py (mont_mul and
# its three lowerings, _mont_finish, _cond_sub, add_mod, sub_mod,
# mont_pow_static, mont_inv), which the TPU program inlined into every
# kernel.  On the H100 it is csrc/p256_field.cuh (mod the P-256 prime,
# inlined into K2-K4), csrc/ed25519_field.cuh (mod 2^255 - 19, inlined into
# K7 and K8) and csrc/field.cuh (mod n); csrc/field_op.cu wraps one op per
# launch so the libraries can be held against the plain ops above.

FIELD_OPS = (
    "mul", "sqr", "add", "sub", "to_mont", "from_mont", "inv",
    "select", "eq", "is_zero",
)
_FIELDS = {"p": 0, "n": 1, "ed": 2}


def field_spec(field: str) -> FieldSpec:
    """The modulus of a K1 field name: ``"p"`` the P-256 prime, ``"n"``
    its group order, ``"ed"`` the Ed25519 prime 2^255 - 19."""
    from . import ed25519, p256  # the field constants live with the curves

    return {"p": p256.FIELD, "n": p256.ORDER, "ed": ed25519.FIELD}[field]


@torch.inference_mode()
def field_op_plain(op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version of :func:`field_op` on int64 limb rows.

    ``select`` picks ``a`` where bit 0 of a's low limb is set, else ``b``;
    ``eq`` / ``is_zero`` put their verdict in limb 0 (other limbs 0)."""
    if op == "mul":
        return mont_mul(spec, a, b)
    if op == "sqr":
        return mont_sqr(spec, a)
    if op == "add":
        return add_mod(spec, a, b)
    if op == "sub":
        return sub_mod(spec, a, b)
    if op == "to_mont":
        return to_mont(spec, a)
    if op == "from_mont":
        return from_mont(spec, a)
    if op == "inv":
        return mont_inv(spec, a)
    if op == "select":
        return fe_select((a[..., 0] & 1) == 1, a, b)
    flag = fe_eq(a, b) if op == "eq" else fe_is_zero(a)
    out = torch.zeros_like(a)
    out[..., 0] = flag.to(a.dtype)
    return out


def field_op(op: str, a: torch.Tensor, b: torch.Tensor, field: str = "p"):
    """One field op over [B, 16] uint16 limb rows -> [B, 16] uint16, mod
    the modulus :func:`field_spec` names (``"p"``, ``"n"`` or ``"ed"``).

    CPU tensors take the plain version; CUDA tensors launch K1
    (``csrc/field_op.cu``, one thread per lane) or raise.  Mod ``"p"`` and
    ``"ed"`` the kernel runs the ops specialised to that prime
    (``csrc/p256_field.cuh``, ``csrc/ed25519_field.cuh``) and reads 32-bit
    words, so ``a`` and ``b`` must be 4-byte aligned there."""
    spec = field_spec(field)
    if a.device.type == "cpu":
        out = field_op_plain(op, spec, a.to(torch.int64), b.to(torch.int64))
        return out.to(torch.uint16)
    if a.device.type != "cuda":
        raise ValueError(f"field_op: unsupported device {a.device}")
    out = _launch_field_op(op, a, b, field, 1)
    backend.count_launch(field_op)
    return out


def _launch_field_op(op: str, a: torch.Tensor, b: torch.Tensor, field: str, t: int):
    """K1 with ``t`` threads per group (4 mod ``"p"`` or ``"ed"`` runs the
    multiplies of 4 lanes through the group form K2/K3 or K7/K8 use, one
    to a thread), after the wrapper-side checks; counts no launch."""
    n = a.shape[0]
    align = 1 if field == "n" else 4
    backend.require(a, torch.uint16, (n, NLIMBS), "field_op a", align=align)
    backend.require(b, torch.uint16, (n, NLIMBS), "field_op b", align=align)
    if b.device != a.device:
        raise ValueError("field_op: a and b on different devices")
    out = torch.empty_like(a)
    lib = backend.EXTENSION.library("field_op")
    with torch.cuda.device(a.device):  # the launch goes to the current device
        rc = lib.mbt_field_op(
            FIELD_OPS.index(op), _FIELDS[field], t, backend.ptr(a), backend.ptr(b),
            backend.ptr(out), n, backend.current_stream(a.device),
        )
    backend.check(lib, rc, "field_op")
    return out


field_op.launches = 0

