"""Device resolution and the CUDA build of the port's kernels.

Counterpart of :mod:`minbft_tpu.ops.lowering` and
:mod:`minbft_tpu.utils.jaxcache`.  The reference picks one of three XLA
lowerings per backend and keys a persistent compilation cache to a hash
of its kernel sources; here there is one hand-written CUDA build, keyed
the same way.

- :func:`resolve_device`: ``None`` means ``cuda:0``; the CPU only when
  the caller passes ``"cpu"``; asking for CUDA where there is none
  raises ``RuntimeError`` (nothing falls back to the CPU).
- :data:`EXTENSION`: builds ``csrc/*.cu`` at first use, one ``nvcc``
  per source, all started together, into
  ``build/torch_ext/<source hash>/`` beside the package, under a
  thread lock and a file lock (two processes never build into one
  directory at once).  Each source becomes a shared library with a plain
  C interface, loaded with ``ctypes``: a source that includes PyTorch's
  headers takes minutes to compile, one with a C interface seconds.
  Every launch function returns ``cudaGetLastError()`` after its launch
  and :func:`check` raises on anything but success.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_ext")

# One shared library per kernel source (the P-256 ones include
# p256_field.cuh over field.cuh, the Ed25519 ones ed25519.cuh over
# ed25519_field.cuh over field.cuh, the SHA-256 ones sha256.cuh), with
# the C signature of each of
# its launch functions: every pointer and the stream as c_void_p, counts
# and threads per lane as c_int, an int return (cudaGetLastError()).
_P, _I = ctypes.c_void_p, ctypes.c_int
LAUNCHERS = {
    "field_op": {"mbt_field_op": [_I, _I, _I, _P, _P, _P, _I, _P]},
    "p256_verify": {
        "mbt_p256_verify": [_P, _P, _I, _I, _P],
        "mbt_p256_verify_arrays": [_P] * 9 + [_I, _I, _P],
    },
    "p256_kg": {"mbt_p256_kg": [_P, _P, _P, _I, _I, _P]},
    "p256_kg_ladder": {"mbt_p256_kg_ladder": [_P, _P, _I, _I, _P]},
    "sha256_compress": {"mbt_sha256_compress": [_P, _P, _P, _I, _P]},
    "hmac_sha256": {
        "mbt_hmac_sha256_verify": [_P, _P, _I, _P],
        "mbt_hmac_sha256_verify_arrays": [_P, _P, _P, _P, _I, _P],
        "mbt_hmac_sha256_sign": [_P, _P, _P, _I, _P],
    },
    "ed25519_verify": {
        "mbt_ed25519_verify": [_P, _P, _I, _P],
        "mbt_ed25519_verify_arrays": [_P] * 8 + [_I, _P],
    },
    "ed25519_rb": {"mbt_ed25519_rb": [_P, _P, _P, _I, _P]},
}
SOURCES = tuple(LAUNCHERS)

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def resolve_device(device=None) -> torch.device:
    """The engine's and the wrappers' device rule: ``None`` is
    ``cuda:0``, ``"cpu"`` the plain PyTorch path; CUDA asked for and
    absent raises."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' for the plain PyTorch path"
            )
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def tree_key() -> str:
    """Short content hash of the kernel sources and the build flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if not name.endswith((".cu", ".cuh")):
            continue
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


class _Extension:
    """The built kernel libraries of this process (built once, lazily)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds = 0.0
        self.build_dir = ""
        # ptxas' per-kernel report (registers, spills) of each source,
        # from the build that produced the loaded libraries.
        self.ptxas_log: Dict[str, str] = {}

    def library(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if not self._libs:
                self._build_and_load()
            return self._libs[name]

    def _build_and_load(self) -> None:
        t0 = time.perf_counter()
        out_dir = os.path.join(BUILD_ROOT, tree_key())
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "lock"), "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            procs = {}
            for name in SOURCES:
                so = os.path.join(out_dir, f"lib{name}.so")
                log = os.path.join(out_dir, f"{name}.ptxas.txt")
                if os.path.exists(so):
                    continue
                tmp = so + f".tmp{os.getpid()}"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC_DIR, f"{name}.cu")]
                procs[name] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
                    ),
                    tmp, so, log,
                )
            failed = []
            for name, (proc, tmp, so, log) in procs.items():
                out, _ = proc.communicate()
                with open(log, "wb") as fh:
                    fh.write(out)
                if proc.returncode != 0:
                    failed.append(f"{name}.cu:\n{out.decode(errors='replace')}")
                    continue
                os.replace(tmp, so)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
            for name in SOURCES:
                log = os.path.join(out_dir, f"{name}.ptxas.txt")
                if os.path.exists(log):
                    with open(log, encoding="utf-8", errors="replace") as fh:
                        self.ptxas_log[name] = fh.read()
                lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
                lib.mbt_error_string.argtypes = [ctypes.c_int]
                lib.mbt_error_string.restype = ctypes.c_char_p
                for fn_name, argtypes in LAUNCHERS[name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._libs[name] = lib
        self.build_dir = out_dir
        self.build_seconds = time.perf_counter() - t0

    def build_all(self) -> float:
        """Build (or load) every library now; returns the seconds it took."""
        self.library(SOURCES[0])
        return self.build_seconds


EXTENSION = _Extension()


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if rc != 0:
        msg = lib.mbt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def current_stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a launch argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str,
            align: int = 1) -> None:
    """Wrapper-side argument check before a kernel sees a pointer; ``align``
    is the width in bytes of the kernel's widest load from ``t`` (a
    misaligned load would fault on the card and poison the context)."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype} != {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: storage must be {align}-byte aligned")


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` (a plain int attribute
    of the wrapper function).  Called where the wrapper launches its
    kernel and nowhere else; the lock keeps concurrent engine workers
    from losing an increment."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
