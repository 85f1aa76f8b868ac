"""Batched HMAC-SHA256 over fixed 32-byte inputs: the plain PyTorch
versions and the wrappers of kernels K6 (packed verify), K6' (verify over
three arrays) and K6s (MAC generation).

Port of :mod:`minbft_tpu.ops.hmac_sha256`.  Key = 32 bytes, message = a
32-byte digest, so one HMAC is exactly four SHA-256 compressions (RFC 2104
with a 64-byte block):

    inner = H( (key ^ ipad) || msg32 || pad )   - 2 compressions
    mac   = H( (key ^ opad) || inner || pad )   - 2 compressions

K6's batch is ``[B, 24]`` u32 rows of key | msg | mac as big-endian words
(the engine's staging layout); K6' takes the three ``[B, 8]`` arrays and
K6s keys and msgs, as the reference's bench does.  The CUDA kernels are in
``csrc/hmac_sha256.cu``; they share one ``hmac32`` and inline K5
(``csrc/sha256.cuh``).  A lane runs on 2 threads, which compress the
ipad and opad blocks side by side, so its chain is three compressions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import backend
from .sha256 import _u64, compress, iv

PACKED_COLS = 24
_IPAD = 0x36363636
_OPAD = 0x5C5C5C5C

# Padding tail for a 64+32-byte message: 0x80, zeros, bit length 768.
_TAIL = np.array([0x80000000, 0, 0, 0, 0, 0, 0, 768], dtype=np.uint32)


def hmac32(key: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """HMAC-SHA256(key32, msg32) per lane: key, msg [B, 8] u32 words (any
    integer dtype) -> mac [B, 8] int64."""
    key, msg = _u64(key), _u64(msg)
    b = key.shape[0]
    tail = torch.from_numpy(_TAIL.astype(np.int64)).to(key.device).expand(b, 8)

    def pad_block(pad):
        return torch.cat([key ^ pad, torch.full_like(key, pad)], 1)

    # The ipad and opad blocks in one compression over 2B lanes, as K6's
    # two threads a lane run them side by side: a chain of three.
    first = compress(iv(2 * b, key.device),
                     torch.cat([pad_block(_IPAD), pad_block(_OPAD)]))
    inner = compress(first[:b], torch.cat([msg, tail], 1))
    return compress(first[b:], torch.cat([inner, tail], 1))


def hmac_verify_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain version of K6: [B, 24] rows -> [B] bool."""
    rows = _u64(rows)
    mac = hmac32(rows[:, 0:8], rows[:, 8:16])
    return (mac == rows[:, 16:24]).all(dim=1)


def hmac_verify_kernel_packed(rows: torch.Tensor) -> torch.Tensor:
    """Batched HMAC-SHA256 verify over packed rows -> [B] bool.

    CPU: the plain version (any integer dtype).  CUDA: K6
    (``csrc/hmac_sha256.cu``, 2 threads per lane) on PyTorch's current
    stream; ``rows`` must be a contiguous [B, 24] int32 tensor of u32
    bits whose storage starts 16-byte aligned."""
    if rows.device.type == "cpu":
        return hmac_verify_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"hmac_verify_kernel_packed: unsupported device {rows.device}")
    n = rows.shape[0]
    backend.require(rows, torch.int32, (n, PACKED_COLS), "hmac rows")
    if rows.data_ptr() % 16:
        raise ValueError("hmac rows: storage must be 16-byte aligned")
    out = torch.empty(n, dtype=torch.bool, device=rows.device)
    lib = backend.EXTENSION.library("hmac_sha256")
    with torch.cuda.device(rows.device):  # the launch goes to the current device
        rc = lib.mbt_hmac_sha256_verify(
            backend.ptr(rows), backend.ptr(out), n, backend.current_stream(rows.device)
        )
    backend.check(lib, rc, "hmac_sha256")
    backend.count_launch(hmac_verify_kernel_packed)
    return out


hmac_verify_kernel_packed.launches = 0


def hmac_sign_plain(keys: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """The plain version of K6s: keys, msgs [B, 8] u32 words (any integer
    dtype, int32 bit patterns included) -> macs [B, 8] int64 words."""
    return hmac32(keys, msgs)


def hmac_verify_plain3(
    keys: torch.Tensor, msgs: torch.Tensor, macs: torch.Tensor
) -> torch.Tensor:
    """The plain version of K6': keys, msgs, macs [B, 8] u32 words -> [B]
    bool."""
    return (hmac32(keys, msgs) == _u64(macs)).all(dim=1)


def _require_words(arrays, names, what: str) -> int:
    """Wrapper-side checks of [B, 8] int32 word arrays on one CUDA device,
    each 16-byte aligned (the kernels read 16-byte words); returns B."""
    dev = arrays[0].device
    n = arrays[0].shape[0]
    for a, name in zip(arrays, names):
        if a.device != dev:
            raise ValueError(f"{what}: arrays on different devices")
        backend.require(a, torch.int32, (n, 8), f"{what} {name}")
        if a.data_ptr() % 16:
            raise ValueError(f"{what} {name}: storage must be 16-byte aligned")
    return n


def hmac_verify_kernel(
    keys: torch.Tensor, msgs: torch.Tensor, macs: torch.Tensor
) -> torch.Tensor:
    """Batched HMAC-SHA256 verify over three [B, 8] word arrays -> [B] bool
    (the reference's ``hmac_verify_kernel``).

    CPU: the plain version.  CUDA: K6' (``csrc/hmac_sha256.cu``, K6's
    ``hmac32`` over the arrays) on PyTorch's current stream; each array a
    contiguous [B, 8] int32 tensor of u32 bits, 16-byte aligned."""
    dev = keys.device
    if dev.type == "cpu" and msgs.device == dev and macs.device == dev:
        return hmac_verify_plain3(keys, msgs, macs)
    if dev.type != "cuda":
        raise ValueError(f"hmac_verify_kernel: unsupported device {dev}")
    n = _require_words((keys, msgs, macs), ("keys", "msgs", "macs"), "hmac verify")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = backend.EXTENSION.library("hmac_sha256")
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.mbt_hmac_sha256_verify_arrays(
            backend.ptr(keys), backend.ptr(msgs), backend.ptr(macs),
            backend.ptr(out), n, backend.current_stream(dev),
        )
    backend.check(lib, rc, "hmac_sha256_verify_arrays")
    backend.count_launch(hmac_verify_kernel)
    return out


hmac_verify_kernel.launches = 0


def hmac_sign_kernel(keys: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """Batched HMAC-SHA256 generation: keys, msgs [B, 8] words -> macs
    [B, 8] (the reference's ``hmac_sign_kernel``).

    CPU: the plain version (int64 words).  CUDA: K6s
    (``csrc/hmac_sha256.cu``) on PyTorch's current stream; each input a
    contiguous [B, 8] int32 tensor of u32 bits, 16-byte aligned; the MACs
    come back as int32 bit patterns."""
    dev = keys.device
    if dev.type == "cpu" and msgs.device == dev:
        return hmac_sign_plain(keys, msgs)
    if dev.type != "cuda":
        raise ValueError(f"hmac_sign_kernel: unsupported device {dev}")
    n = _require_words((keys, msgs), ("keys", "msgs"), "hmac sign")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    lib = backend.EXTENSION.library("hmac_sha256")
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.mbt_hmac_sha256_sign(
            backend.ptr(keys), backend.ptr(msgs), backend.ptr(out), n,
            backend.current_stream(dev),
        )
    backend.check(lib, rc, "hmac_sha256_sign")
    backend.count_launch(hmac_sign_kernel)
    return out


hmac_sign_kernel.launches = 0
