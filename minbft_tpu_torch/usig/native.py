"""ctypes binding for the native C++ USIG module, and its build.

Port of :mod:`minbft_tpu.usig.native`.  The C++ sources are the port's
own copies in ``minbft_tpu_torch/native/`` (``usig.cc``, ``usig.h``,
``ossl.h``, ``usig_test.cc``).  :func:`build` replaces the reference's
Makefile: the same ``g++ -O2 -fPIC -Wall -Wextra -Werror -std=c++17``,
linked against the system ``libcrypto.so.3``, at first use, into
``build/native/<source hash>/`` beside the package.  A replica cluster
starts n processes at once and each may be the first to need the
library, so the build runs under a thread lock and a file lock, and the
library is linked under a temporary name and renamed into place.  A
missing ``g++`` or ``libcrypto.so.3`` raises :class:`NativeBuildError`;
:func:`available` is the one place that turns it into False (the
keystore's ``usig_spec="auto"`` rule).

``NativeEcdsaUSIG`` produces byte-identical UI certificates to
``EcdsaUSIG`` (cert = epoch8 || r32 || s32, ID = epoch8 || x32 || y32), so
its UIs verify on the GPU batch path (K2, through ``usig_verify_items``)
unchanged.  It supports key **sealing**: ``seal()`` exports a blob that
``from_sealed`` restores, in the reference's v2 (plain) and v3 (AES-GCM
under a secret) layouts, so a blob sealed by either package restores in
the other.  Only the KEY is sealed: every init draws a fresh random epoch
(reference usig/sgx/enclave/usig.c:168-186), so a restored instance —
whose counter restarts at 1 — can never re-certify (epoch, cv) values
issued by a previous instance of the same key.  Verifiers learn the new
epoch trust-on-first-use (SampleAuthenticator epoch capture).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from .usig import UI, USIG, UsigError

_EPOCH_LEN = 8

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")

CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-Werror", "-std=c++17")
_SOURCES = ("usig.cc", "usig.h", "ossl.h", "usig_test.cc")
# Where the reference's Makefile looks for the runtime library (the image
# ships it without the development headers; ossl.h declares the API).
LIBCRYPTO_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libcrypto.so.3",
    "/lib/x86_64-linux-gnu/libcrypto.so.3",
    "/usr/lib/libcrypto.so.3",
    "/usr/lib64/libcrypto.so.3",
    "/usr/lib/aarch64-linux-gnu/libcrypto.so.3",
)

USIG_OK = 0

_build_lock = threading.Lock()
_lib = None


class NativeBuildError(UsigError):
    """The native module cannot be built or loaded here (no ``g++``, no
    ``libcrypto.so.3``, or a compiler error)."""


def source_key() -> str:
    """Short content hash of the sources and the compiler flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        with open(os.path.join(NATIVE_DIR, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, source_key())


def _libcrypto() -> str:
    for path in LIBCRYPTO_CANDIDATES:
        if os.path.exists(path):
            return path
    raise NativeBuildError(
        "libusig.so: libcrypto.so.3 not found (looked in "
        f"{', '.join(LIBCRYPTO_CANDIDATES)}): the native USIG links OpenSSL 3"
    )


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise NativeBuildError(f"the native USIG needs a C++ compiler: {cxx!r} not found")
    return found


def _compile(out: str, args: list) -> None:
    """Run the compiler into ``out`` through a temporary name: relinking
    in place would rewrite a library another process may have mapped."""
    if os.path.exists(out):
        return
    tmp = f"{out}.tmp{os.getpid()}"
    res = subprocess.run(
        [_cxx(), *CXXFLAGS, "-o", tmp, *args],
        cwd=NATIVE_DIR, capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        raise NativeBuildError(
            f"building {os.path.basename(out)} failed:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)


def build(with_test: bool = False) -> str:
    """Build ``libusig.so`` (and, with ``with_test``, the ``usig_test``
    binary linked against it) unless this source hash has been built;
    returns the library's path.  Safe against concurrent callers in this
    process (thread lock) and in others (``fcntl`` lock on the build
    directory)."""
    out_dir = build_dir()
    lib = os.path.join(out_dir, "libusig.so")
    with _build_lock:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "lock"), "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            _compile(lib, ["-shared", os.path.join(NATIVE_DIR, "usig.cc"), _libcrypto()])
            if with_test:
                _compile(
                    os.path.join(out_dir, "usig_test"),
                    [os.path.join(NATIVE_DIR, "usig_test.cc"), f"-L{out_dir}",
                     "-lusig", "-Wl,-rpath,$ORIGIN"],
                )
    return lib


def load() -> ctypes.CDLL:
    """The native library of this process, built at first use; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e}") from e
    _bind(lib)
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native module builds and loads here."""
    try:
        load()
    except NativeBuildError:
        return False
    return True


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.usig_destroy.argtypes = [ctypes.c_void_p]
    lib.usig_create_ui.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        u8p,
    ]
    lib.usig_get_epoch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.usig_get_pubkey.argtypes = [ctypes.c_void_p, u8p]
    lib.usig_verify_ui.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
    ]
    lib.usig_native_version.restype = ctypes.c_char_p
    lib.usig_init2.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    lib.usig_sealed_size2.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.usig_seal2.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        u8p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    for fn in (lib.usig_destroy, lib.usig_create_ui, lib.usig_get_epoch,
               lib.usig_get_pubkey, lib.usig_verify_ui, lib.usig_init2,
               lib.usig_sealed_size2, lib.usig_seal2):
        fn.restype = ctypes.c_int


class NativeEcdsaUSIG(USIG):
    """USIG backed by the native module (reference SGXUSIG analogue,
    usig/sgx/sgx-usig.go:42-62)."""

    SCHEME = "ecdsa-p256"

    def __init__(self, sealed: Optional[bytes] = None, secret: Optional[bytes] = None):
        lib = load()
        self._lib = lib
        handle = ctypes.c_void_p()
        rc = lib.usig_init2(
            ctypes.byref(handle),
            sealed if sealed is not None else None,
            len(sealed) if sealed is not None else 0,
            secret if secret else None,
            len(secret) if secret else 0,
        )
        if rc != USIG_OK:
            raise UsigError(
                "usig_init failed: encrypted blob needs the sealing secret"
                if rc == 6
                else f"usig_init failed (rc={rc})"
            )
        self._h = handle
        epoch = ctypes.c_uint64()
        if lib.usig_get_epoch(self._h, ctypes.byref(epoch)) != USIG_OK:
            raise UsigError("usig_get_epoch failed")
        self._epoch = int(epoch.value).to_bytes(8, "big")
        pub = (ctypes.c_uint8 * 64)()
        if lib.usig_get_pubkey(self._h, pub) != USIG_OK:
            raise UsigError("usig_get_pubkey failed")
        self._pub = bytes(pub)

    def __del__(self):  # release the native instance
        h = getattr(self, "_h", None)
        if h:
            self._lib.usig_destroy(h)
            self._h = None

    # -- USIG interface ------------------------------------------------------

    @property
    def epoch(self) -> bytes:
        return self._epoch

    @property
    def public_key(self):
        return (
            int.from_bytes(self._pub[:32], "big"),
            int.from_bytes(self._pub[32:], "big"),
        )

    def id(self) -> bytes:
        return self._epoch + self._pub

    def create_ui(self, message: bytes) -> UI:
        digest = hashlib.sha256(message).digest()
        counter = ctypes.c_uint64()
        sig = (ctypes.c_uint8 * 64)()
        rc = self._lib.usig_create_ui(self._h, digest, ctypes.byref(counter), sig)
        if rc != USIG_OK:
            raise UsigError(f"usig_create_ui failed (rc={rc})")
        return UI(counter=int(counter.value), cert=self._epoch + bytes(sig))

    def verify_ui(self, message: bytes, ui: UI, usig_id: bytes) -> None:
        if ui.counter == 0:
            raise UsigError("zero counter")
        if len(ui.cert) != _EPOCH_LEN + 64:
            raise UsigError("malformed certificate")
        cert_epoch, sig = ui.cert[:_EPOCH_LEN], ui.cert[_EPOCH_LEN:]
        if len(usig_id) != _EPOCH_LEN + 64:
            raise UsigError("malformed USIG ID")
        id_epoch, pub = usig_id[:_EPOCH_LEN], usig_id[_EPOCH_LEN:]
        if cert_epoch != id_epoch:
            raise UsigError("epoch mismatch")
        digest = hashlib.sha256(message).digest()
        rc = self._lib.usig_verify_ui(
            pub,
            int.from_bytes(id_epoch, "big"),
            digest,
            ui.counter,
            sig,
        )
        if rc != USIG_OK:
            raise UsigError("invalid UI certificate")

    # -- sealing (durable state) --------------------------------------------

    def seal(self, secret: Optional[bytes] = None) -> bytes:
        """Export the sealed key blob (reference SealedKey,
        usig/sgx/usig-enclave.go:254-268).  The epoch is volatile by
        design and is not part of the blob.  With ``secret`` the blob is
        AES-256-GCM encrypted inside the native module (v3); without, the
        plaintext v2 layout."""
        need = ctypes.c_size_t()
        if (
            self._lib.usig_sealed_size2(
                self._h, len(secret) if secret else 0, ctypes.byref(need)
            )
            != USIG_OK
        ):
            raise UsigError("usig_sealed_size failed")
        buf = (ctypes.c_uint8 * need.value)()
        out_len = ctypes.c_size_t()
        rc = self._lib.usig_seal2(
            self._h,
            secret if secret else None,
            len(secret) if secret else 0,
            buf,
            need.value,
            ctypes.byref(out_len),
        )
        if rc != USIG_OK:
            raise UsigError(f"usig_seal failed (rc={rc})")
        return bytes(buf[: out_len.value])

    @classmethod
    def from_sealed(
        cls, sealed: bytes, secret: Optional[bytes] = None
    ) -> "NativeEcdsaUSIG":
        """Restore an instance: same key, FRESH epoch, counter restarts
        at 1 (reference usig.c:168-186).  ``secret`` is required for v3
        (encrypted) blobs."""
        return cls(sealed=sealed, secret=secret)
