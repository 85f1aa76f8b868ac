"""Pairwise-MAC message authentication: PBFT-style MAC vectors over the
batch engine.

Port of :mod:`minbft_tpu.sample.authentication.mac`.  Scheme (symmetric,
pairwise 32-byte secrets):

- REQUEST (client c → all): a vector of n MACs; slot r is
  ``HMAC(K(c,r), SHA256(authen_bytes))``.  Replica r verifies its slot.
- REPLY (replica r → client c): a single MAC under K(c,r) — the tag is
  recipient-specific, which is what the ``audience`` parameter of
  :meth:`minbft_tpu_torch.api.Authenticator.generate_message_authen_tag`
  exists for.
- REQ-VIEW-CHANGE (replica i → all): a vector of n MACs under the
  replica-pair keys K(i,j); the own slot is zeros (own messages are
  trusted, never self-verified).
- PREPARE/COMMIT UI certificates are unchanged: they come from the USIG
  (the protocol's equivocation guard must not be forgeable by MAC-key
  holders), delegated to a wrapped :class:`SampleAuthenticator`.

Tags are byte-identical to the reference's under the same keys, so a
cluster can mix the two packages (:func:`mac_keys_from` carries the
reference's key material across).

Placement (a deliberate difference from the reference): an authenticator
with an engine checks every MAC in the engine's HMAC-SHA256 queue, one
lane of kernel K6 each (``BatchVerifier.verify_hmac_sha256``, with the
queue's dedup memo); the reference's default sends them to the engine's
host queue, which the port does not have (on a CUDA engine it would move
the card's work to the host).  Without an engine a MAC is checked inline
with Python's ``hmac``, as in the reference.  MAC generation stays on the
host in both.

Trust caveat (inherent to MAC authenticators, known from PBFT): a faulty
*client* can craft a vector whose slots verify at the primary but fail at
a correct backup.  The backup rejects the whole PREPARE embedding it, so
the primary's UI counter is never captured there and every later message
from that primary parks on the counter gap until a view change deposes
it (the core demands one at once on
:class:`minbft_tpu_torch.api.EmbeddedRequestAuthError`): a liveness
stall, never a safety fault — no forged request can commit.  Public-key
signatures remain the default scheme; MAC deployments assume clients are
trusted or expendable.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import secrets
from typing import Dict, Mapping, Optional, Tuple

from ... import api
from .authenticator import SampleAuthenticator, authenticators_from_keys, make_test_keys

_MAC_LEN = 32


class MacKeys:
    """Pairwise secrets: ``client_replica[(c, r)]`` and
    ``replica_pair[(min(i,j), max(i,j))]``, each 32 bytes."""

    def __init__(
        self,
        client_replica: Dict[Tuple[int, int], bytes],
        replica_pair: Dict[Tuple[int, int], bytes],
    ):
        self.client_replica = client_replica
        self.replica_pair = replica_pair

    def k_client(self, client_id: int, replica_id: int) -> bytes:
        key = self.client_replica.get((client_id, replica_id))
        if key is None:
            # AuthenticationError, not KeyError: an unknown principal id is
            # an authentication failure (a rejected message), never an
            # internal error (the Authenticator error contract).
            raise api.AuthenticationError(
                f"no MAC key for client {client_id} / replica {replica_id}"
            )
        return key

    def k_replicas(self, i: int, j: int) -> bytes:
        key = self.replica_pair.get((min(i, j), max(i, j)))
        if key is None:
            raise api.AuthenticationError(f"no MAC key for replicas {i},{j}")
        return key

    def view_for_replica(self, r: int) -> "MacKeys":
        """This replica's share only (what its keystore would hold)."""
        return MacKeys(
            {k: v for k, v in self.client_replica.items() if k[1] == r},
            {k: v for k, v in self.replica_pair.items() if r in k},
        )

    def view_for_client(self, c: int) -> "MacKeys":
        return MacKeys(
            {k: v for k, v in self.client_replica.items() if k[0] == c}, {}
        )


def generate_testnet_mac_keys(n: int, n_clients: int) -> MacKeys:
    """Fresh random pairwise secrets for an in-process testnet."""
    return MacKeys(
        {
            (c, r): secrets.token_bytes(32)
            for c in range(n_clients)
            for r in range(n)
        },
        {
            (i, j): secrets.token_bytes(32)
            for i in range(n)
            for j in range(i + 1, n)
        },
    )


def mac_keys_from(
    client_replica: Mapping[Tuple[int, int], bytes],
    replica_pair: Mapping[Tuple[int, int], bytes],
) -> MacKeys:
    """The port's :class:`MacKeys` from carried-over pairwise key material
    (the two maps the reference's ``generate_testnet_mac_keys`` fills:
    ``(client, replica)`` and ``(i, j)`` with i < j, to 32-byte secrets),
    checked and copied."""

    def take(src, what):
        out = {}
        for (a, b), key in src.items():
            key = bytes(key)
            if len(key) != _MAC_LEN:
                raise ValueError(f"{what} key {(a, b)}: {len(key)} bytes, not 32")
            out[(int(a), int(b))] = key
        return out

    pairs = take(replica_pair, "replica pair")
    if any(i >= j for i, j in pairs):
        raise ValueError("replica pair keys must be keyed (i, j) with i < j")
    return MacKeys(take(client_replica, "client/replica"), pairs)


def _mac(key: bytes, digest: bytes) -> bytes:
    return hmac_mod.new(key, digest, hashlib.sha256).digest()


class MacAuthenticator(api.Authenticator):
    """MAC-vector authenticator; USIG certificates delegate to ``inner``
    (a :class:`SampleAuthenticator` carrying the USIG).  With ``engine``,
    MAC checks go through its HMAC-SHA256 queue (kernel K6)."""

    def __init__(
        self,
        own_id: int,
        is_client: bool,
        n: int,
        keys: MacKeys,
        inner: Optional[SampleAuthenticator] = None,
        engine=None,
    ):
        self.own_id = own_id
        self.is_client = is_client
        self.n = n
        self._keys = keys
        self._inner = inner
        self._engine = engine

    def bind_engine(self, engine) -> None:
        """Late-bind a batching engine (an engine-pool home-chip facade):
        MAC checks then go through its HMAC-SHA256 queue, and the inner
        USIG authenticator gets the same binding.  No-op when an engine
        was already injected, as :meth:`SampleAuthenticator.bind_engine`."""
        if self._engine is None and engine is not None:
            self._engine = engine
        if self._inner is not None and hasattr(self._inner, "bind_engine"):
            self._inner.bind_engine(engine)

    # -- generation ---------------------------------------------------------

    def generate_message_authen_tag(
        self, role: api.AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        digest = hashlib.sha256(msg).digest()
        if role == api.AuthenticationRole.CLIENT:
            if not self.is_client:
                raise api.AuthenticationError("not a client")
            return b"".join(
                _mac(self._keys.k_client(self.own_id, r), digest)
                for r in range(self.n)
            )
        if role == api.AuthenticationRole.REPLICA:
            if self.is_client:
                raise api.AuthenticationError("not a replica")
            if audience >= 0:  # REPLY to one client
                return _mac(self._keys.k_client(audience, self.own_id), digest)
            # REQ-VIEW-CHANGE: vector over replicas, own slot zeroed
            return b"".join(
                (
                    b"\x00" * _MAC_LEN
                    if r == self.own_id
                    else _mac(self._keys.k_replicas(self.own_id, r), digest)
                )
                for r in range(self.n)
            )
        if role == api.AuthenticationRole.USIG:
            if self._inner is None:
                raise api.AuthenticationError("no USIG authenticator")
            return self._inner.generate_message_authen_tag(role, msg, audience)
        raise api.AuthenticationError(f"unknown role {role}")

    # -- verification -------------------------------------------------------

    async def _verify_mac(self, key: bytes, digest: bytes, mac: bytes) -> None:
        if len(mac) != _MAC_LEN:
            raise api.AuthenticationError("malformed MAC")
        if self._engine is not None:
            ok = await self._engine.verify_hmac_sha256(key, digest, mac)
        else:
            ok = hmac_mod.compare_digest(_mac(key, digest), mac)
        if not ok:
            raise api.AuthenticationError("bad MAC")

    async def verify_message_authen_tag(
        self, role: api.AuthenticationRole, peer_id: int, msg: bytes, tag: bytes
    ) -> None:
        digest = hashlib.sha256(msg).digest()
        if role == api.AuthenticationRole.CLIENT:
            # replica self verifying client peer_id's REQUEST vector
            if self.is_client:
                raise api.AuthenticationError("clients don't verify requests")
            if len(tag) != self.n * _MAC_LEN:
                raise api.AuthenticationError("malformed MAC vector")
            slot = tag[self.own_id * _MAC_LEN : (self.own_id + 1) * _MAC_LEN]
            await self._verify_mac(
                self._keys.k_client(peer_id, self.own_id), digest, slot
            )
            return
        if role == api.AuthenticationRole.REPLICA:
            if self.is_client:  # client verifying a REPLY from peer_id
                await self._verify_mac(
                    self._keys.k_client(self.own_id, peer_id), digest, tag
                )
                return
            # replica verifying a replica's vector (REQ-VIEW-CHANGE)
            if len(tag) != self.n * _MAC_LEN:
                raise api.AuthenticationError("malformed MAC vector")
            slot = tag[self.own_id * _MAC_LEN : (self.own_id + 1) * _MAC_LEN]
            await self._verify_mac(
                self._keys.k_replicas(peer_id, self.own_id), digest, slot
            )
            return
        if role == api.AuthenticationRole.USIG:
            if self._inner is None:
                raise api.AuthenticationError("no USIG authenticator")
            await self._inner.verify_message_authen_tag(role, peer_id, msg, tag)
            return
        raise api.AuthenticationError(f"unknown role {role}")

    def reset_usig_epoch(self, peer_id: int) -> None:
        """Operator re-bootstrap hook (see SampleAuthenticator): forwarded
        to the inner USIG authenticator."""
        if self._inner is not None:
            self._inner.reset_usig_epoch(peer_id)

    def allow_epoch_capture_from(self, peer_id: int, counter: int) -> None:
        """State-transfer TOFU floor (see SampleAuthenticator): forwarded
        to the inner USIG authenticator."""
        if self._inner is not None:
            self._inner.allow_epoch_capture_from(peer_id, counter)


def mac_authenticators_from_keys(
    keys: dict,
    mac_keys: MacKeys,
    n_clients: int,
    engine=None,
    engines=None,
    client_engine=None,
):
    """MAC authenticators over carried-over key material: the USIGs of
    ``keys`` (the dict :func:`authenticators_from_keys` takes; only its
    USIG entries matter here) and the pairwise secrets ``mac_keys``.
    ``engine`` is shared by every replica, or ``engines[i]`` is replica
    i's; ``client_engine`` serves every client.  Returns (replica_auths,
    client_auths)."""
    n = keys["n"]
    # The inner authenticators carry only the USIG role here: MACs
    # replace the signature roles.
    inner, _ = authenticators_from_keys(keys, engine=engine, engines=engines)
    replica_auths = [
        MacAuthenticator(
            i, False, n, mac_keys.view_for_replica(i), inner=inner[i],
            engine=(engines[i] if engines else engine),
        )
        for i in range(n)
    ]
    client_auths = [
        MacAuthenticator(c, True, n, mac_keys.view_for_client(c), engine=client_engine)
        for c in range(n_clients)
    ]
    return replica_auths, client_auths


def new_test_mac_authenticators(
    n: int,
    n_clients: int = 1,
    usig_kind: str = "hmac",
    engines=None,
    engine=None,
    client_engine=None,
):
    """Testnet MAC authenticators with fresh keys (mirrors
    new_test_authenticators): returns (replica_auths, client_auths)."""
    return mac_authenticators_from_keys(
        make_test_keys(n, 0, usig_kind),
        generate_testnet_mac_keys(n, n_clients),
        n_clients,
        engine=engine,
        engines=engines,
        client_engine=client_engine,
    )
