"""SHA-256 compression: host helpers, the plain PyTorch version and the
wrapper of the K5 test kernel.

Port of :mod:`minbft_tpu.ops.sha256`.  The reference expresses one
FIPS 180-4 compression in ``uint32`` jax.numpy ops and vmaps it over the
batch; here the plain version runs the same rounds over a batch axis,
and the CUDA device function (``csrc/sha256.cuh``, K5) is what K6
inlines.  ``csrc/sha256_compress.cu`` wraps K5 in a thin test kernel so
it can be held against the plain version on the card.

PyTorch has no arithmetic on ``uint32``: the plain version works on int64
tensors holding values in [0, 2^32) and masks after every add and shift.
Device tensors carry u32 words as int32 bit patterns (``as_i32`` /
``as_u32`` convert numpy arrays without copying a value).
"""

from __future__ import annotations

import numpy as np
import torch

from . import backend

# Round constants (FIPS 180-4 §4.2.2).
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

IV = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

_M = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host helpers (numpy), as in the reference.


def pad_message(data: bytes) -> np.ndarray:
    """FIPS 180-4 padding -> [nblocks, 16] uint32 big-endian words."""
    bitlen = len(data) * 8
    data = data + b"\x80"
    data += b"\x00" * ((56 - len(data)) % 64)
    data += bitlen.to_bytes(8, "big")
    words = np.frombuffer(data, dtype=">u4").astype(np.uint32)
    return words.reshape(-1, 16)


def words_to_bytes(words: np.ndarray) -> bytes:
    """uint32 big-endian words -> bytes."""
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def bytes_to_words(data: bytes) -> np.ndarray:
    """bytes (multiple of 4) -> uint32 big-endian words."""
    if len(data) % 4:
        raise ValueError("length must be a multiple of 4")
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


def as_i32(words: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> an int32 tensor of the same bits (the device
    carrier of u32 words)."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


def as_u32(t: torch.Tensor) -> np.ndarray:
    """An int32 or int64 tensor of u32 words -> uint32 numpy words."""
    t = t.cpu()
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return (t.to(torch.int64) & _M).numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Plain PyTorch version (int64 lanes masked to 32 bits).


def _u64(t: torch.Tensor) -> torch.Tensor:
    """Any integer tensor of u32 words (int32 bit patterns included) ->
    int64 values in [0, 2^32)."""
    return t.to(torch.int64) & _M


def _twice(x: torch.Tensor) -> torch.Tensor:
    """x < 2^32 written twice, in bits 0-31 and 32-63 (bit 63 may wrap):
    ``(_twice(x) >> n) & _M`` is x rotated right by n < 32."""
    return x | (x << 32)


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression per lane: ``state`` [B, 8] and ``block``
    [B, 16] u32 words (big-endian, any integer dtype) -> [B, 8] int64.

    The reference's ``_compress_loop``: a rolling 16-word schedule
    window, 64 rounds.  Each rotation reads the word written twice
    (:func:`_twice`), and the three rotations of a sigma share one mask:
    on the CPU the time is the number of tensor operations, not lanes."""
    st = _u64(state)
    w = list(_u64(block).unbind(1))
    a, b, c, d, e, f, g, h = st.unbind(1)
    for t in range(64):
        if t < 16:
            wt = w[t]
        else:
            w15, w2 = w[(t - 15) & 15], w[(t - 2) & 15]
            x, y = _twice(w15), _twice(w2)
            s0 = (((x >> 7) ^ (x >> 18)) & _M) ^ (w15 >> 3)
            s1 = (((y >> 17) ^ (y >> 19)) & _M) ^ (w2 >> 10)
            wt = (w[t & 15] + s0 + w[(t - 7) & 15] + s1) & _M
            w[t & 15] = wt
        x = _twice(e)
        big_s1 = ((x >> 6) ^ (x >> 11) ^ (x >> 25)) & _M
        ch = g ^ (e & (f ^ g))
        t1 = h + big_s1 + ch + int(_K[t]) + wt
        x = _twice(a)
        big_s0 = ((x >> 2) ^ (x >> 13) ^ (x >> 22)) & _M
        maj = (a & b) | (c & (a | b))
        h, g, f, e = g, f, e, (d + t1) & _M
        d, c, b, a = c, b, a, (t1 + big_s0 + maj) & _M
    return (st + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & _M


def iv(batch: int, device="cpu") -> torch.Tensor:
    """The initial hash value for ``batch`` lanes, [batch, 8] int64."""
    return torch.from_numpy(IV.astype(np.int64)).to(device).expand(batch, 8).clone()


def sha256_fixed(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 over pre-padded blocks: [B, nblocks, 16] u32 words ->
    digest [B, 8] int64 (the reference's ``sha256_fixed_batch``)."""
    state = iv(blocks.shape[0], blocks.device)
    for i in range(blocks.shape[1]):
        state = compress(state, blocks[:, i])
    return state


# ---------------------------------------------------------------------------
# K5 test kernel wrapper.


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression per lane -> [B, 8].

    CPU: the plain :func:`compress` (any integer dtype; int64 out).
    CUDA: the K5 test kernel (``csrc/sha256_compress.cu``) on PyTorch's
    current stream; ``state`` [B, 8] and ``block`` [B, 16] must be
    contiguous int32 tensors of u32 bits, and so is the result."""
    if state.device.type == "cpu":
        return compress(state, block)
    if state.device.type != "cuda":
        raise ValueError(f"sha256_compress: unsupported device {state.device}")
    if block.device != state.device:
        raise ValueError("sha256_compress: state and block on different devices")
    n = state.shape[0]
    backend.require(state, torch.int32, (n, 8), "sha256 state")
    backend.require(block, torch.int32, (n, 16), "sha256 block")
    out = torch.empty_like(state)
    lib = backend.EXTENSION.library("sha256_compress")
    with torch.cuda.device(state.device):  # the launch goes to the current device
        rc = lib.mbt_sha256_compress(
            backend.ptr(state), backend.ptr(block), backend.ptr(out), n,
            backend.current_stream(state.device),
        )
    backend.check(lib, rc, "sha256_compress")
    backend.count_launch(sha256_compress)
    return out


sha256_compress.launches = 0
