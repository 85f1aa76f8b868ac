"""Persistent keystore: the keys.yaml of this build.

Port of :mod:`minbft_tpu.sample.authentication.keystore`: the same file
layout, keyspecs and sealing, so a keys.yaml written by either package
loads in the other.  The authenticators it builds take only ``engine=``:
with an engine every signature, MAC and USIG certificate is checked in
the engine's queues on the card (K2, K6), and own REQUEST/REPLY
signatures are made by its sign queue (K3).

The reference stores all testnet key material in one YAML file with three
sections — replica / usig / client, each ``{keyspec, keys: [{id, ...}]}``
(reference sample/authentication/keymanager.go:129-162) — and pluggable
keyspecs (``ECDSA``, ``SGX_ECDSA``; keymanager.go:169-328).  This build
keeps that shape with its own specs:

- ``ECDSA_P256`` / ``ED25519`` — signature keypairs for the replica and
  client sections (privateKey/publicKey, base64).
- ``NATIVE_ECDSA`` — USIG sealed by the native C++ module
  (``minbft_tpu_torch/native``, see :mod:`~minbft_tpu_torch.usig.native`);
  the sealed blob is opaque to Python, exactly as the
  enclave-sealed key is opaque to the reference's Go side
  (keymanager.go:299-328 stores it base64).
- ``SOFT_ECDSA`` — software-sealed USIG (SIM mode): a self-describing blob
  holding the private scalar with an integrity checksum.  Like SGX SIM
  sealing, this provides durability, not confidentiality.
- ``HMAC_SHA256`` — the shared-key testnet USIG; the blob holds the
  cluster-shared MAC key.

Every usig entry also records the **public** ``usigKey`` — the key
material (ECDSA x||y, or the HMAC key fingerprint) that anchors trust in
that replica's USIG (the reference stores the USIG *public key* the same
way, reference keymanager.go:169-239).  The epoch is deliberately NOT part
of the anchor: every USIG init draws a fresh random epoch (reference
usig/sgx/enclave/usig.c:168-186), and verifiers capture each peer's
current epoch trust-on-first-use from its first counter-1 UI
(SampleAuthenticator, reference crypto.go:204-218).

Durable-state story (SURVEY.md §5 "checkpoint/resume"): the sealed USIG
key is the system's only durable state.  ``KeyStore.make_usig`` restores a
replica's USIG from its sealed blob: same key — peers' key anchors remain
valid — but a fresh epoch and a counter restarting at 1 (volatile), so a
restart can never re-certify already-issued (epoch, cv) values.
"""

from __future__ import annotations

import base64
import hashlib
import secrets
from typing import Dict, Optional, Tuple

from ...usig.software import EcdsaUSIG, HmacUSIG
from ...utils import hostcrypto as hc
from .authenticator import SampleAuthenticator

_EPOCH_LEN = 8
_SOFT_MAGIC = b"SSL2"    # v2: magic || scalar32 || check8 (no epoch)
_SOFT_MAGIC_V1 = b"SSL1"  # v1 carried a sealed epoch; ignored on restore


# --------------------------------------------------------------------------
# signature keyspecs


def _ecdsa_generate() -> Tuple[bytes, bytes]:
    d, (x, y) = hc.keygen()
    return d.to_bytes(32, "big"), x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _ecdsa_decode(priv: Optional[bytes], pub: bytes):
    q = (int.from_bytes(pub[:32], "big"), int.from_bytes(pub[32:], "big"))
    return (int.from_bytes(priv, "big") if priv else None), q


def _ed25519_generate() -> Tuple[bytes, bytes]:
    seed, pub = hc.ed25519_keygen()
    return seed, pub


def _ed25519_decode(priv: Optional[bytes], pub: bytes):
    return priv, pub


def _nist_generate(curve: str):
    def gen() -> Tuple[bytes, bytes]:
        return hc.nist_keygen(curve)

    return gen


def _nist_decode(priv: Optional[bytes], pub: bytes):
    return priv, pub


_SIG_SPECS = {
    "ECDSA_P256": ("ecdsa-p256", _ecdsa_generate, _ecdsa_decode),
    "ED25519": ("ed25519", _ed25519_generate, _ed25519_decode),
    # Wider-curve keyspecs (reference keymanager.go:169-241 accepts
    # P-224..P-521): host-path verification only — the kernels are
    # P-256/Ed25519; see authenticator.NistEcdsaScheme.
    "ECDSA_P384": ("ecdsa-p384", _nist_generate("p384"), _nist_decode),
    "ECDSA_P521": ("ecdsa-p521", _nist_generate("p521"), _nist_decode),
}
_SPEC_FOR_SCHEME = {v[0]: k for k, v in _SIG_SPECS.items()}


# --------------------------------------------------------------------------
# USIG keyspecs (sealed blobs)


def _soft_seal(d: int) -> bytes:
    body = _SOFT_MAGIC + d.to_bytes(32, "big")
    return body + hashlib.sha256(body).digest()[:8]


def _soft_unseal(blob: bytes) -> int:
    """Recover the private scalar; the epoch is never restored (a fresh
    one is drawn per instance, reference usig.c:168-186).  v1 blobs
    (which sealed an epoch) are accepted with the epoch discarded."""
    if len(blob) == 4 + 32 + 8 and blob[:4] == _SOFT_MAGIC:
        scalar = blob[4:-8]
    elif len(blob) == 4 + _EPOCH_LEN + 32 + 8 and blob[:4] == _SOFT_MAGIC_V1:
        scalar = blob[4 + _EPOCH_LEN : -8]
    else:
        raise ValueError("malformed soft-sealed USIG blob")
    body, check = blob[:-8], blob[-8:]
    if hashlib.sha256(body).digest()[:8] != check:
        raise ValueError("soft-sealed USIG blob failed integrity check")
    return int.from_bytes(scalar, "big")


def _new_usig(spec: str, shared_hmac_key: Optional[bytes] = None):
    """Create a fresh USIG for ``spec``; returns (usig, sealed_blob)."""
    if spec == "NATIVE_ECDSA":
        from ...usig.native import NativeEcdsaUSIG

        u = NativeEcdsaUSIG()
        return u, u.seal()
    if spec == "SOFT_ECDSA":
        u = EcdsaUSIG()
        return u, _soft_seal(u._d)
    if spec == "HMAC_SHA256":
        key = shared_hmac_key or secrets.token_bytes(32)
        return HmacUSIG(key), key
    raise ValueError(f"unknown USIG keyspec {spec!r}")


def _restore_usig(spec: str, sealed: bytes):
    """Restore a USIG from its sealed blob: same key, fresh random epoch,
    counter restarting at 1 (reference usig.c:168-186)."""
    if spec == "NATIVE_ECDSA":
        from ...usig.native import NativeEcdsaUSIG

        return NativeEcdsaUSIG.from_sealed(sealed)
    if spec == "SOFT_ECDSA":
        return EcdsaUSIG(private_key=_soft_unseal(sealed))
    if spec == "HMAC_SHA256":
        if len(sealed) == 32:
            return HmacUSIG(sealed)
        if len(sealed) == _EPOCH_LEN + 32:  # v1 blob: epoch || key
            return HmacUSIG(sealed[_EPOCH_LEN:])
        raise ValueError("malformed HMAC USIG blob")
    raise ValueError(f"unknown USIG keyspec {spec!r}")


def usig_key_anchor(usig) -> bytes:
    """The epoch-free trust anchor for a USIG: its ID minus the volatile
    epoch prefix (= key material: x||y for ECDSA, key fingerprint for
    HMAC)."""
    return usig.id()[_EPOCH_LEN:]


# --------------------------------------------------------------------------


class KeyStoreError(Exception):
    pass


class KeyStore:
    """In-memory form of a keys.yaml (reference BftKeyStorer,
    keymanager.go:39-47): per-section keyspec + id-indexed key material."""

    def __init__(
        self,
        scheme: str = "ecdsa-p256",
        usig_spec: str = "SOFT_ECDSA",
    ):
        if scheme not in _SPEC_FOR_SCHEME:
            raise KeyStoreError(f"unknown signature scheme {scheme!r}")
        if usig_spec not in ("NATIVE_ECDSA", "SOFT_ECDSA", "HMAC_SHA256"):
            raise KeyStoreError(f"unknown USIG keyspec {usig_spec!r}")
        self.scheme = scheme
        self.usig_spec = usig_spec
        # {id: (privateKey bytes|None, publicKey bytes)}
        self.replica_keys: Dict[int, Tuple[Optional[bytes], bytes]] = {}
        self.client_keys: Dict[int, Tuple[Optional[bytes], bytes]] = {}
        # {id: (sealed bytes|None, key-material anchor bytes)} — the
        # anchor is epoch-free (see module docstring).
        self.usig_keys: Dict[int, Tuple[Optional[bytes], bytes]] = {}
        # optional pairwise-MAC material (sample/authentication/mac.py)
        self.mac_keys = None  # Optional[MacKeys]

    # -- serialization -------------------------------------------------------

    def to_dict(self, secret: Optional[bytes] = None) -> dict:
        """Serializable form.  With ``secret``, every PRIVATE field —
        signature private keys, sealed USIG blobs, the pairwise MAC
        matrix — is AES-256-GCM encrypted under a per-file master key
        (one PBKDF2 derivation, random salt recorded in the ``seal``
        section): a stolen keys.yaml then discloses no key material,
        matching the reference's sgx_seal_data property
        (reference usig/sgx/enclave/usig.c:107-116).  Public fields stay
        plaintext (peers need them)."""
        from ...utils import sealbox

        has_private = (
            any(priv is not None for priv, _ in self.replica_keys.values())
            or any(priv is not None for priv, _ in self.client_keys.values())
            or any(sealed is not None for sealed, _ in self.usig_keys.values())
            or self.mac_keys is not None
        )
        seal_hdr = {}
        if secret is not None and not has_private:
            # A strip_private() copy holds only public material: emitting
            # a seal header would make a fully-public file unreadable to
            # consumers without the operator secret for no benefit.
            secret = None
        if secret is not None:
            salt = secrets.token_bytes(sealbox.SALT_LEN)
            mk = sealbox.derive_key(secret, salt)
            seal_hdr["seal"] = {
                "kdf": sealbox.KDF,
                "salt": base64.b64encode(salt).decode(),
                "iterations": sealbox.ITERATIONS,
            }

            def enc(v: bytes) -> str:
                return base64.b64encode(sealbox.box(v, mk)).decode()

        else:

            def enc(v: bytes) -> str:
                return base64.b64encode(v).decode()

        def sig_section(keys):
            return {
                "keyspec": _SPEC_FOR_SCHEME[self.scheme],
                "keys": [
                    {
                        "id": kid,
                        **(
                            {"privateKey": enc(priv)}
                            if priv is not None
                            else {}
                        ),
                        "publicKey": base64.b64encode(pub).decode(),
                    }
                    for kid, (priv, pub) in sorted(keys.items())
                ],
            }

        mac_section = {}
        if self.mac_keys is not None:
            mac_section["macs"] = {
                "keyspec": "HMAC_PAIRWISE",
                "clientReplica": [
                    {"client": c, "replica": r, "key": enc(k)}
                    for (c, r), k in sorted(self.mac_keys.client_replica.items())
                ],
                "replicaPair": [
                    {"i": i, "j": j, "key": enc(k)}
                    for (i, j), k in sorted(self.mac_keys.replica_pair.items())
                ],
            }
        return {
            **seal_hdr,
            "replica": sig_section(self.replica_keys),
            "client": sig_section(self.client_keys),
            **mac_section,
            "usig": {
                "keyspec": self.usig_spec,
                "keys": [
                    {
                        "id": kid,
                        **(
                            {"sealedKey": enc(sealed)}
                            if sealed is not None
                            else {}
                        ),
                        "usigKey": base64.b64encode(anchor).decode(),
                    }
                    for kid, (sealed, anchor) in sorted(self.usig_keys.items())
                ],
            },
        }

    @classmethod
    def from_dict(cls, data: dict, secret: Optional[bytes] = None) -> "KeyStore":
        from ...utils import sealbox

        seal = data.get("seal")
        if seal is not None:
            if secret is None:
                raise KeyStoreError(
                    "keystore is sealed: set MINBFT_SEAL_SECRET or "
                    "MINBFT_SEAL_SECRET_FILE to open it"
                )
            if seal.get("kdf") != sealbox.KDF:
                raise KeyStoreError(f"unknown seal kdf {seal.get('kdf')!r}")
            iters = int(seal.get("iterations", sealbox.ITERATIONS))
            if not 0 < iters <= 10_000_000:
                # Mirror the native v3 parser's bound: a tampered file
                # must not be able to spin PBKDF2 for hours.
                raise KeyStoreError(f"seal iteration count {iters} out of range")
            mk = sealbox.derive_key(
                secret, base64.b64decode(seal["salt"]), iters
            )

            def dec(s: str) -> bytes:
                try:
                    return sealbox.unbox(base64.b64decode(s), mk)
                except sealbox.SealError as e:
                    raise KeyStoreError(str(e)) from e

        else:

            def dec(s: str) -> bytes:
                return base64.b64decode(s)

        rep = data.get("replica", {})
        spec = rep.get("keyspec", "ECDSA_P256")
        if spec not in _SIG_SPECS:
            raise KeyStoreError(f"unknown signature keyspec {spec!r}")
        client_spec = data.get("client", {}).get("keyspec", spec)
        if client_spec != spec:
            # One signature scheme per store (the decode path is shared);
            # refuse rather than silently misdecode client keys.
            raise KeyStoreError(
                f"client keyspec {client_spec!r} != replica keyspec {spec!r}"
            )
        usig = data.get("usig", {})
        store = cls(scheme=_SIG_SPECS[spec][0], usig_spec=usig.get("keyspec", "SOFT_ECDSA"))

        def read_sig(section) -> Dict[int, Tuple[Optional[bytes], bytes]]:
            out = {}
            for entry in section.get("keys", []):
                priv = entry.get("privateKey")
                out[int(entry["id"])] = (
                    dec(priv) if priv else None,
                    base64.b64decode(entry["publicKey"]),
                )
            return out

        store.replica_keys = read_sig(rep)
        store.client_keys = read_sig(data.get("client", {}))
        macs = data.get("macs")
        if macs:
            mac_spec = macs.get("keyspec", "HMAC_PAIRWISE")
            if mac_spec != "HMAC_PAIRWISE":
                raise KeyStoreError(f"unknown MAC keyspec {mac_spec!r}")
            from .mac import MacKeys

            store.mac_keys = MacKeys(
                {
                    (int(e["client"]), int(e["replica"])): dec(e["key"])
                    for e in macs.get("clientReplica", [])
                },
                {
                    (int(e["i"]), int(e["j"])): dec(e["key"])
                    for e in macs.get("replicaPair", [])
                },
            )
        for entry in usig.get("keys", []):
            sealed = entry.get("sealedKey")
            if "usigKey" in entry:
                anchor = base64.b64decode(entry["usigKey"])
            else:
                # legacy usigId = epoch(8) || key material: the epoch part
                # is volatile and must not be pinned — strip it.
                anchor = base64.b64decode(entry["usigId"])[_EPOCH_LEN:]
            store.usig_keys[int(entry["id"])] = (
                dec(sealed) if sealed else None,
                anchor,
            )
        return store

    _SECRET_FROM_ENV = object()  # sentinel: source the seal secret lazily

    def save(self, path: str, secret=_SECRET_FROM_ENV) -> None:
        """Write keys.yaml with owner-only permissions.  When a sealing
        secret is configured (MINBFT_SEAL_SECRET / _FILE, or passed
        explicitly) every private field is encrypted at rest — see
        :meth:`to_dict`; otherwise 0600 permissions are the only
        protection (the round-3 behavior).  Deployment flows should
        distribute per-replica ``strip_private(keep_replica=i)`` copies,
        not this full store."""
        import os as _os

        import yaml

        from ...utils import sealbox

        if secret is KeyStore._SECRET_FROM_ENV:
            secret = sealbox.seal_secret()
        fd = _os.open(path, _os.O_CREAT | _os.O_WRONLY | _os.O_TRUNC, 0o600)
        # O_CREAT's mode only applies to newly-created files; tighten a
        # pre-existing laxer file too before writing secrets into it.
        _os.fchmod(fd, 0o600)
        with _os.fdopen(fd, "w") as fh:
            yaml.safe_dump(self.to_dict(secret=secret), fh, sort_keys=False)

    @classmethod
    def load(cls, path: str, secret=_SECRET_FROM_ENV) -> "KeyStore":
        import yaml

        from ...utils import sealbox

        if secret is KeyStore._SECRET_FROM_ENV:
            secret = sealbox.seal_secret()
        with open(path) as fh:
            data = yaml.safe_load(fh) or {}
        return cls.from_dict(data, secret=secret)

    def strip_private(self, keep_replica: Optional[int] = None) -> "KeyStore":
        """A copy safe to hand to other nodes: private material removed
        except (optionally) one replica's own keys (for MACs: its pairwise
        rows only — MAC secrets are inherently shared per pair)."""
        out = KeyStore(scheme=self.scheme, usig_spec=self.usig_spec)
        out.replica_keys = {
            kid: (priv if kid == keep_replica else None, pub)
            for kid, (priv, pub) in self.replica_keys.items()
        }
        out.client_keys = {kid: (None, pub) for kid, (_, pub) in self.client_keys.items()}
        out.usig_keys = {
            kid: (sealed if kid == keep_replica else None, uid)
            for kid, (sealed, uid) in self.usig_keys.items()
        }
        if self.mac_keys is not None and keep_replica is not None:
            out.mac_keys = self.mac_keys.view_for_replica(keep_replica)
        return out

    # -- restoration ---------------------------------------------------------

    def make_usig(self, replica_id: int):
        """Restore replica_id's USIG from its sealed blob (durable state).

        The restored instance has a fresh epoch, so only the key-material
        anchor — never the full (epoch-bearing) ID — is checked."""
        sealed, anchor = self.usig_keys[replica_id]
        if sealed is None:
            raise KeyStoreError(f"no sealed USIG key for replica {replica_id}")
        u = _restore_usig(self.usig_spec, sealed)
        if usig_key_anchor(u) != anchor:
            raise KeyStoreError(
                f"restored USIG key mismatch for replica {replica_id}"
            )
        return u

    def usig_anchors(self) -> Dict[int, bytes]:
        """Epoch-free key-material trust anchors, one per replica (what
        SampleAuthenticator consumes for TOFU epoch capture)."""
        return {kid: anchor for kid, (_, anchor) in self.usig_keys.items()}


    def _decode_sig(self, keys, kid: int):
        if kid not in keys:
            raise KeyStoreError(f"no key with id {kid}")
        priv, pub = keys[kid]
        return _SIG_SPECS[_SPEC_FOR_SCHEME[self.scheme]][2](priv, pub)

    def replica_pubs(self) -> Dict[int, object]:
        return {kid: self._decode_sig(self.replica_keys, kid)[1] for kid in self.replica_keys}

    def client_pubs(self) -> Dict[int, object]:
        return {kid: self._decode_sig(self.client_keys, kid)[1] for kid in self.client_keys}

    def replica_authenticator(self, replica_id: int, engine=None) -> SampleAuthenticator:
        priv, _ = self._decode_sig(self.replica_keys, replica_id)
        if priv is None:
            raise KeyStoreError(f"no private key for replica {replica_id}")
        return SampleAuthenticator(
            scheme=self.scheme,
            replica_priv=priv,
            replica_pubs=self.replica_pubs(),
            client_pubs=self.client_pubs(),
            usig=self.make_usig(replica_id),
            usig_ids=self.usig_anchors(),
            engine=engine,
            own_replica_id=replica_id,
        )

    def mac_replica_authenticator(self, replica_id: int, engine=None):
        """MAC-scheme authenticator for a replica (requires a ``macs``
        section; USIG delegates to this store's sealed USIG)."""
        if self.mac_keys is None:
            raise KeyStoreError("keystore has no MAC section")
        from .mac import MacAuthenticator

        n = len(self.usig_keys)
        inner = SampleAuthenticator(
            usig=self.make_usig(replica_id),
            usig_ids=self.usig_anchors(),
            engine=engine,
            own_replica_id=replica_id,
        )
        # The principal's view only — handing out the full matrix would let
        # one compromised replica forge other principals' MAC slots.
        return MacAuthenticator(
            replica_id, False, n, self.mac_keys.view_for_replica(replica_id),
            inner=inner, engine=engine,
        )

    def mac_client_authenticator(self, client_id: int, engine=None):
        if self.mac_keys is None:
            raise KeyStoreError("keystore has no MAC section")
        from .mac import MacAuthenticator

        return MacAuthenticator(
            client_id, True, len(self.usig_keys),
            self.mac_keys.view_for_client(client_id), engine=engine,
        )

    def client_authenticator(self, client_id: int, engine=None) -> SampleAuthenticator:
        priv, _ = self._decode_sig(self.client_keys, client_id)
        if priv is None:
            raise KeyStoreError(f"no private key for client {client_id}")
        return SampleAuthenticator(
            scheme=self.scheme,
            client_priv=priv,
            replica_pubs=self.replica_pubs(),
            client_pubs=self.client_pubs(),
            engine=engine,
        )


def generate_testnet_keys(
    n: int,
    n_clients: int = 1,
    scheme: str = "ecdsa-p256",
    usig_spec: str = "auto",
    with_macs: bool = False,
) -> KeyStore:
    """Generate a full testnet keystore (reference GenerateTestnetKeys,
    keymanager.go:404-450): n replica keypairs + USIGs, n_clients client
    keypairs.  ``usig_spec="auto"`` prefers the native module and falls
    back to the software seal when the native module cannot be built
    here (no ``g++`` or no ``libcrypto.so.3``)."""
    if usig_spec == "auto":
        from ...usig import native as native_mod

        usig_spec = "NATIVE_ECDSA" if native_mod.available() else "SOFT_ECDSA"
    store = KeyStore(scheme=scheme, usig_spec=usig_spec)
    spec = _SPEC_FOR_SCHEME[scheme]
    gen = _SIG_SPECS[spec][1]
    for i in range(n):
        store.replica_keys[i] = gen()
    for c in range(n_clients):
        store.client_keys[c] = gen()
    shared = secrets.token_bytes(32) if usig_spec == "HMAC_SHA256" else None
    for i in range(n):
        u, sealed = _new_usig(usig_spec, shared_hmac_key=shared)
        store.usig_keys[i] = (sealed, usig_key_anchor(u))
    if with_macs:
        from .mac import generate_testnet_mac_keys

        store.mac_keys = generate_testnet_mac_keys(n, n_clients)
    return store
