"""Batched HMAC-SHA256 verify over fixed 32-byte inputs: the plain
PyTorch version and the wrapper of kernel K6.

Port of :mod:`minbft_tpu.ops.hmac_sha256`.  Key = 32 bytes, message = a
32-byte digest, so one HMAC is exactly four SHA-256 compressions (RFC 2104
with a 64-byte block):

    inner = H( (key ^ ipad) || msg32 || pad )   - 2 compressions
    mac   = H( (key ^ opad) || inner || pad )   - 2 compressions

A batch is ``[B, 24]`` u32 rows of key | msg | mac as big-endian words
(the engine's staging layout); the result is ``[B]`` bool.  The CUDA
kernel is ``csrc/hmac_sha256.cu``; it inlines K5 (``csrc/sha256.cuh``).
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

    inner = compress(iv(b, key.device), pad_block(_IPAD))
    inner = compress(inner, torch.cat([msg, tail], 1))
    outer = compress(iv(b, key.device), pad_block(_OPAD))
    return compress(outer, torch.cat([inner, tail], 1))


def hmac_verify_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain version of K6: [B, 24] rows -> [B] bool."""
    rows = _u64(rows)
    mac = hmac32(rows[:, 0:8], rows[:, 8:16])
    return (mac == rows[:, 16:24]).all(dim=1)


def hmac_verify_kernel_packed(rows: torch.Tensor) -> torch.Tensor:
    """Batched HMAC-SHA256 verify over packed rows -> [B] bool.

    CPU: the plain version (any integer dtype).  CUDA: K6
    (``csrc/hmac_sha256.cu``, one thread per lane) on PyTorch's current
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
