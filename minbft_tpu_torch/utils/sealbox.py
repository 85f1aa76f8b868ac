"""Encrypted-at-rest sealing for key material (port of
:mod:`minbft_tpu.utils.sealbox`; the same blobs and key derivation).

The reference seals the USIG private key to the enclave identity with
``sgx_seal_data`` (reference usig/sgx/enclave/usig.c:107-116): a stolen
keys.yaml discloses nothing.  Without SGX the honest analogue is
symmetric encryption under an **operator-supplied secret**: AES-256-GCM
with a PBKDF2-HMAC-SHA256 key, random salt and nonce per use.

The secret is sourced from the environment (never stored in the repo or
the keystore):

- ``MINBFT_SEAL_SECRET``       — the secret itself (for dev/test), or
- ``MINBFT_SEAL_SECRET_FILE``  — path to a file holding it (deployment:
  mount a secret file; trailing whitespace is stripped).

With neither set, sealing degrades to the round-3 behavior (plaintext
fields, 0600 file permissions as the only protection) so existing
un-sealed deployments keep working; the keystore records whether a file
was written sealed and refuses to silently "open" a sealed file without
the secret.
"""

from __future__ import annotations

import hashlib
import os
import secrets
from typing import Optional

KDF = "pbkdf2-sha256"
ITERATIONS = 60_000  # one derivation per keystore FILE, not per field
SALT_LEN = 16
NONCE_LEN = 12


class SealError(Exception):
    pass


def seal_secret(env=None) -> Optional[bytes]:
    """The operator's sealing secret, or None when sealing is not
    configured (see module docstring)."""
    if env is None:
        env = os.environ
    v = env.get("MINBFT_SEAL_SECRET")
    if v:
        return v.encode()
    p = env.get("MINBFT_SEAL_SECRET_FILE")
    if p:
        with open(p, "rb") as fh:
            data = fh.read().strip()
        if not data:
            raise SealError(f"seal secret file {p!r} is empty")
        return data
    return None


def derive_key(secret: bytes, salt: bytes, iterations: int = ITERATIONS) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", secret, salt, iterations, dklen=32)


def _aesgcm(key: bytes):
    """AESGCM gated behind actual use: sealing is an OPT-IN feature (no
    MINBFT_SEAL_SECRET -> plaintext fields, 0600 perms), and an image may
    ship without the cryptography package — importing it at module load
    would take the whole keystore down for unsealed deployments too."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:
        raise SealError(
            "keystore sealing requires the 'cryptography' package "
            "(unset MINBFT_SEAL_SECRET / _FILE to run unsealed)"
        ) from e
    return AESGCM(key)


def box(plain: bytes, key: bytes) -> bytes:
    """nonce(12) || AES-256-GCM(ciphertext || tag16)."""
    nonce = secrets.token_bytes(NONCE_LEN)
    return nonce + _aesgcm(key).encrypt(nonce, plain, b"")


def unbox(blob: bytes, key: bytes) -> bytes:
    if len(blob) < NONCE_LEN + 16:
        raise SealError("sealed blob too short")
    try:
        return _aesgcm(key).decrypt(blob[:NONCE_LEN], blob[NONCE_LEN:], b"")
    except SealError:
        raise
    except Exception as e:
        raise SealError(
            "sealed blob failed to decrypt (wrong secret or corrupted data)"
        ) from e
