"""Batch-axis split of the verify and sign kernels over CUDA devices.

Port of :mod:`minbft_tpu.parallel.mesh`.  The reference places the batch
axis over a 1-D ``jax.sharding.Mesh`` and lets XLA partition the kernel;
here a :class:`Mesh` is a tuple of torch devices, and
:func:`sharded_verifier` splits the leading axis into ``mesh.size`` equal
contiguous chunks, launches chunk c on ``mesh.devices[c]`` through the
kernel's own wrapper (K2, K3, K6, K7 or K8 on a CUDA device, the plain
PyTorch version on a CPU device) and gathers the results in lane order.
It adds no arithmetic: each chunk is one ordinary launch, counted by its
wrapper, at the group size its own length picks.

Every chunk is uploaded and launched before any is read back, so chunks
on different cards run at the same time; the upload, the launch and the
readback of one chunk share its device's current stream, so no tensor
crosses streams.  A device may repeat (``("cuda:0", "cuda:0")``): its
chunks then run one after another on that card, which is how a one-GPU
machine rehearses a two-device split (the reference's mesh refuses a
repeated device).

Left out: ``batch_sharding`` and ``replicated`` (reference ``mesh.py:36``,
``:52``), JAX sharding specs with no counterpart here.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops import backend


class Mesh:
    """A 1-D device list over the batch axis (``devices``, ``size``)."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: Tuple[torch.device, ...] = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"


def devices_from(device=None) -> List[str]:
    """The devices a pool or mesh spans from ``device``: ``["cpu"]`` for
    the CPU; else every visible CUDA device, starting at ``device``'s
    index (``None``: at ``cuda:0``); ``[]`` without CUDA."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"]
    if not torch.cuda.is_available():
        return []
    first = 0 if device is None else torch.device(device).index or 0
    count = torch.cuda.device_count()
    return [f"cuda:{(first + k) % count}" for k in range(count)]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the batch axis.

    ``None`` is every visible CUDA device; an explicit list may name CPU
    devices (the plain versions, as the tests run) or repeat a device.
    Each entry goes through :func:`backend.resolve_device`, so CUDA asked
    for and absent raises ``RuntimeError``, and ``"cuda"`` and
    ``"cuda:0"`` name one device."""
    if devices is None:
        devices = devices_from()
        if not devices:
            raise RuntimeError(
                "make_mesh() needs CUDA devices (torch.cuda.is_available() is "
                "False); pass devices=['cpu', ...] for the plain versions"
            )
    devs = tuple(backend.resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh holds devices of one type, got {devs}")
    return Mesh(devs)


def round_up_to_mesh(mesh: Mesh, n: int) -> int:
    """Smallest multiple of the mesh size >= n: the engine rounds every
    bucket through it, so each chunk of a padded batch has one length."""
    sz = mesh.size
    return -(-n // sz) * sz


def _scope(dev: torch.device):
    """``torch.cuda.device`` on a CUDA device, nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def sharded_verifier(kernel: Callable, mesh: Mesh):
    """``kernel`` (a wrapper of :mod:`minbft_tpu_torch.ops` taking one
    batch-leading tensor) split over ``mesh``.

    The returned function takes rows on any device, typically the
    engine's pinned host staging tensor, whose leading dimension is a
    multiple of ``mesh.size``, and returns the kernel's output for every
    lane on the host, in lane order.  A chunk's failure fails the whole
    call.  Over a 1-device mesh it is one upload, launch and readback:
    every engine dispatches through it (:mod:`.engine`)."""
    devices = mesh.devices
    size = mesh.size

    def run(rows: torch.Tensor) -> torch.Tensor:
        n = rows.shape[0]
        if n % size:
            raise ValueError(f"batch of {n} rows is not a multiple of the mesh size {size}")
        per = n // size
        outs = []
        # Launch every chunk before reading any back: a readback waits
        # for its stream, and reading chunk 0 first would keep card 1
        # idle until card 0 is done.
        for c, dev in enumerate(devices):
            with _scope(dev):
                chunk = rows[c * per:(c + 1) * per].to(dev, non_blocking=True)
                outs.append(kernel(chunk))
        host = []
        for dev, out in zip(devices, outs):
            with _scope(dev):
                host.append(out.cpu())
        return host[0] if size == 1 else torch.cat(host)

    return run


def sharded_ecdsa_kernel(mesh: Mesh):
    """ECDSA-P256 verify over packed [B, 98] u16 rows (K2) split over
    ``mesh`` -> [B] bool."""
    from ..ops import p256

    return sharded_verifier(p256.ecdsa_verify_kernel_packed, mesh)


def sharded_hmac_kernel(mesh: Mesh):
    """HMAC-SHA256 verify over packed [B, 24] u32 rows (K6) split over
    ``mesh`` -> [B] bool."""
    from ..ops import hmac_sha256

    return sharded_verifier(hmac_sha256.hmac_verify_kernel_packed, mesh)


def sharded_ed25519_kernel(mesh: Mesh):
    """Strict Ed25519 verify over packed [B, 82] u16 rows (K7) split over
    ``mesh`` -> [B] bool."""
    from ..ops import ed25519

    return sharded_verifier(ed25519.ed25519_verify_kernel_packed, mesh)


def sharded_ecdsa_sign_kernel(mesh: Mesh):
    """Fixed-base k*G, the device half of ECDSA signing (K3), split over
    ``mesh``: [B, 16] u16 nonce limbs -> [B, 2, 16] u16 (X, Z).  Each
    device reads its own copy of the comb table (``p256.comb_table_words``,
    uploaded once per device)."""
    from ..ops import p256

    return sharded_verifier(p256.ecdsa_kg_kernel, mesh)


def sharded_ed25519_sign_kernel(mesh: Mesh):
    """Fixed-base r*B, the device half of Ed25519 signing (K8), split over
    ``mesh``: [B, 16] u16 nonce limbs -> [B, 3, 16] u16 (X, Y, Z)."""
    from ..ops import ed25519

    return sharded_verifier(ed25519.ed25519_rb_kernel, mesh)
