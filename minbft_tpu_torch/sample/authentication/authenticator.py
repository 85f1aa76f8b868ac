"""The sample Authenticator: role → scheme dispatch with GPU batch verify.

Port of :mod:`minbft_tpu.sample.authentication.authenticator`.  For the
``ecdsa-p256`` and ``ed25519`` schemes every ``verify`` call becomes an
awaitable lane of the :class:`minbft_tpu_torch.parallel.BatchVerifier`
(K2 or K7 on the card), and own CLIENT/REPLICA signatures go through the
engine's sign queue (K3 or K8).  USIG certificates are checked in the
engine too: ECDSA ones by K2, HMAC-SHA256 ones by K6.  The wider NIST
curves (``ecdsa-p384``, ``ecdsa-p521``) run on the host, as in the
reference: no kernel computes them.

Scheme wire formats (canonical, byte-identical to the reference):

- ECDSA-P256 signature tag: r(32) || s(32), big-endian.
- Ed25519 signature tag: RFC 8032 (R(32) || S(32)) over SHA-256(msg).
- USIG tag: marshalled UI = counter_be8 || cert, where cert =
  epoch(8) || scheme-specific certificate (see usig/software.py).

:func:`authenticators_from_keys` builds a coherent set of authenticators
from a plain dict of key material (:func:`make_test_keys` makes one), so
the port and the reference can sign and verify under the same keys.
"""

from __future__ import annotations

import asyncio
import hashlib
import secrets
from typing import Dict, Optional, Tuple

import numpy as np

from ... import api
from ...messages import UI
from ...parallel import BatchVerifier
from ...usig.software import (
    EcdsaUSIG,
    HmacUSIG,
    UsigError,
    _signed_payload,
    parse_usig_id,
)
from ...utils import hostcrypto as hc

_EPOCH_LEN = 8


class SigScheme:
    """Public-key signature scheme plug-in.

    ``verify`` placement: ``engine=None`` verifies inline on the host;
    with an engine, the item joins the engine's verify queue (K2 or K7)."""

    name = "?"
    sign_capable = False

    def sign(self, priv, msg: bytes) -> bytes:
        raise NotImplementedError

    async def sign_async(self, priv, msg: bytes, engine) -> bytes:
        raise NotImplementedError

    async def verify(self, pub, msg: bytes, tag: bytes, engine) -> bool:
        raise NotImplementedError

    async def verify_many(self, items, engine) -> list:
        """Whole-bundle verification: ``items = [(pub, msg, tag), ...]``
        -> [bool, ...].  Default is the serial loop."""
        return [await self.verify(pub, msg, tag, engine) for pub, msg, tag in items]


class EcdsaScheme(SigScheme):
    name = "ecdsa-p256"
    sign_capable = True

    def sign(self, priv: int, msg: bytes) -> bytes:
        digest = hashlib.sha256(msg).digest()
        r, s = hc.ecdsa_sign(priv, digest)
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    async def sign_async(self, priv: int, msg: bytes, engine) -> bytes:
        digest = hashlib.sha256(msg).digest()
        r, s = await engine.sign_ecdsa_p256(priv, digest)
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    async def verify(
        self, pub: Tuple[int, int], msg: bytes, tag: bytes, engine
    ) -> bool:
        if len(tag) != 64:
            return False
        digest = hashlib.sha256(msg).digest()
        sig = (int.from_bytes(tag[:32], "big"), int.from_bytes(tag[32:], "big"))
        if engine is not None:
            return await engine.verify_ecdsa_p256(pub, digest, sig)
        return hc.ecdsa_verify(pub, digest, sig)

    async def verify_many(self, items, engine) -> list:
        if engine is None:
            return await super().verify_many(items, engine)
        lanes = []
        bad = []  # malformed tags short-circuit to False, item-wise
        for i, (pub, msg, tag) in enumerate(items):
            if len(tag) != 64:
                bad.append(i)
                continue
            digest = hashlib.sha256(msg).digest()
            sig = (
                int.from_bytes(tag[:32], "big"),
                int.from_bytes(tag[32:], "big"),
            )
            lanes.append((pub, digest, sig))
        verdicts = iter(await engine.verify_ecdsa_p256_many(lanes) if lanes else ())
        bad_set = set(bad)
        return [
            False if i in bad_set else next(verdicts)
            for i in range(len(items))
        ]


class Ed25519Scheme(SigScheme):
    """Ed25519 over SHA-256(msg), as the reference signs and verifies it
    (so port and reference replicas agree on every tag)."""

    name = "ed25519"
    sign_capable = True

    def sign(self, priv: bytes, msg: bytes) -> bytes:
        return hc.ed25519_sign(priv, hashlib.sha256(msg).digest())

    async def sign_async(self, priv: bytes, msg: bytes, engine) -> bytes:
        return await engine.sign_ed25519(priv, hashlib.sha256(msg).digest())

    async def verify(self, pub: bytes, msg: bytes, tag: bytes, engine) -> bool:
        digest = hashlib.sha256(msg).digest()
        if engine is not None:
            return await engine.verify_ed25519(pub, digest, tag)
        return hc.ed25519_verify(pub, digest, tag)

    async def verify_many(self, items, engine) -> list:
        if engine is None:
            return await super().verify_many(items, engine)
        lanes = [
            (pub, hashlib.sha256(msg).digest(), tag) for pub, msg, tag in items
        ]
        return await engine.verify_ed25519_many(lanes) if lanes else []


class NistEcdsaScheme(SigScheme):
    """The wider NIST curves (P-384, P-521), on the host only, as in the
    reference (reference keymanager.go:169-241 accepts P-224..P-521 keys):
    no kernel computes them, so with or without an engine a tag is signed
    and checked inline by ``hostcrypto`` (OpenSSL where the
    ``cryptography`` package is present).  The engine's verify and sign
    queues never see them."""

    def __init__(self, curve: str):
        self.name = f"ecdsa-{curve}"
        self._curve = curve

    def sign(self, priv: bytes, msg: bytes) -> bytes:
        return hc.nist_sign(self._curve, priv, msg)

    async def verify(self, pub: bytes, msg: bytes, tag: bytes, engine) -> bool:
        return hc.nist_verify(self._curve, pub, msg, tag)


SCHEMES = {
    s.name: s
    for s in (
        EcdsaScheme(),
        Ed25519Scheme(),
        NistEcdsaScheme("p384"),
        NistEcdsaScheme("p521"),
    )
}


def _scheme(name: str) -> SigScheme:
    if name not in SCHEMES:
        raise ValueError(f"unknown scheme {name!r}")
    return SCHEMES[name]


class SampleAuthenticator(api.Authenticator):
    """Role-dispatching authenticator with GPU-batched verification.

    ``sig_keys``: {role: (own_private_key, {peer_id: public_key})} for the
    CLIENT/REPLICA roles (only the roles this node plays need a private
    key; pass None).  ``usig``: own USIG instance (replicas only).
    ``usig_ids``: {replica_id: anchor bytes} — trust anchors for peers'
    USIGs, in either of two forms:

    - **key-material anchor** (64B ECDSA x||y / 32B HMAC fingerprint, the
      keystore's ``usigKey``): the peer's epoch is captured
      trust-on-first-use from its first valid counter-1 UI and pinned
      thereafter — the reference's SGXUSIGAuthenticationScheme behavior
      (crypto.go:204-239, assumption comment at 204-218).  A peer restart
      draws a fresh epoch (reference usig.c:168-186); verifiers that
      already captured the old epoch reject the new one until an operator
      re-bootstraps them (:meth:`reset_usig_epoch`), exactly the
      reference's documented assumption.
    - **full pinned ID** (epoch || key material, 72B/40B): no capture —
      for single-run in-process tests where instances live exactly once.
    """

    def __init__(
        self,
        scheme: str = "ecdsa-p256",
        client_priv=None,
        client_pubs: Optional[Dict[int, object]] = None,
        replica_priv=None,
        replica_pubs: Optional[Dict[int, object]] = None,
        usig=None,
        usig_ids: Optional[Dict[int, bytes]] = None,
        engine: Optional[BatchVerifier] = None,
        own_replica_id: Optional[int] = None,
    ):
        self._scheme = _scheme(scheme)
        self._client_priv = client_priv
        self._client_pubs = client_pubs or {}
        self._replica_priv = replica_priv
        self._replica_pubs = replica_pubs or {}
        self._usig = usig
        self._usig_ids = usig_ids or {}
        # TOFU-captured epochs per peer (reference crypto.go:149-152
        # "USIG key fingerprint -> captured epoch value"), plus one
        # in-flight first-contact capture future per peer so concurrent
        # higher-counter UIs wait instead of spuriously failing.
        self._usig_epochs: Dict[int, bytes] = {}
        self._usig_epoch_pending: Dict[int, "asyncio.Future"] = {}
        # Per-peer minimum counters from which first-contact epoch capture
        # is allowed WITHOUT counter 1 (state-transfer joins; see
        # allow_epoch_capture_from).
        self._epoch_capture_floor: Dict[int, int] = {}
        # Self-anchor: our own epoch needs no first-contact capture — we
        # ARE the trusted source.  Without this, a replica that becomes
        # primary after a view change cannot verify its own UIs embedded
        # in peers' COMMITs: its own counter-1 message never passes
        # through its validation path (own messages are trusted), so TOFU
        # would wait for a first contact that cannot happen.  Keyed by the
        # explicit own id — anchors alone cannot identify "self" (the
        # HMAC scheme's key fingerprint is shared by every replica).
        if usig is not None and own_replica_id is not None:
            anchor = self._usig_ids.get(own_replica_id)
            own_id = usig.id()
            if anchor is not None and own_id[_EPOCH_LEN:] == anchor:
                self._usig_epochs[own_replica_id] = own_id[:_EPOCH_LEN]
        # How long a non-counter-1 UI waits for a first-contact capture
        # before rejecting (only relevant before a peer's epoch is known).
        self.tofu_capture_timeout = 10.0
        # With an engine, CLIENT/REPLICA signatures are verified in its
        # verify queue (K2 or K7) and own ones signed in its sign queue
        # (K3 or K8); USIG signing is unaffected by design — see
        # generate_message_authen_tag_async.
        self._engine = engine

    # -- generation ---------------------------------------------------------

    def generate_message_authen_tag(
        self, role: api.AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        if role == api.AuthenticationRole.CLIENT:
            if self._client_priv is None:
                raise api.AuthenticationError("no client key")
            return self._scheme.sign(self._client_priv, msg)
        if role == api.AuthenticationRole.REPLICA:
            if self._replica_priv is None:
                raise api.AuthenticationError("no replica key")
            return self._scheme.sign(self._replica_priv, msg)
        if role == api.AuthenticationRole.USIG:
            if self._usig is None:
                raise api.AuthenticationError("no USIG")
            return self._usig.create_ui(msg).to_bytes()
        raise api.AuthenticationError(f"unknown role {role}")

    async def generate_message_authen_tag_async(
        self, role: api.AuthenticationRole, msg: bytes, audience: int = -1
    ) -> bytes:
        """Batch-aware signing: CLIENT/REPLICA tags of sign-capable
        schemes join the engine's sign queue (an awaitable batch lane
        over the comb kernel); everything else takes the synchronous path.

        The USIG role ALWAYS signs serially: create_ui holds the counter
        lock across certify-then-increment (reference usig.c:66-69) and
        must keep doing so — batching UI creation would either reorder
        counters against send order or serialize on the lock anyway.
        Tests pin this boundary by asserting no sign-queue traffic from
        USIG tag generation."""
        if (
            self._engine is not None
            and self._scheme.sign_capable
            and role
            in (api.AuthenticationRole.CLIENT, api.AuthenticationRole.REPLICA)
        ):
            priv = (
                self._client_priv
                if role == api.AuthenticationRole.CLIENT
                else self._replica_priv
            )
            if priv is not None:
                return await self._scheme.sign_async(priv, msg, self._engine)
        return self.generate_message_authen_tag(role, msg, audience)

    # -- verification -------------------------------------------------------

    async def verify_message_authen_tag(
        self, role: api.AuthenticationRole, peer_id: int, msg: bytes, tag: bytes
    ) -> None:
        # Signature placement: the engine's verify queue when there is an
        # engine, plain inline verification when not.
        sig_engine = self._engine
        if role == api.AuthenticationRole.CLIENT:
            pub = self._client_pubs.get(peer_id)
            if pub is None:
                raise api.AuthenticationError(f"unknown client {peer_id}")
            if not await self._scheme.verify(pub, msg, tag, sig_engine):
                raise api.AuthenticationError("bad client signature")
            return
        if role == api.AuthenticationRole.REPLICA:
            pub = self._replica_pubs.get(peer_id)
            if pub is None:
                raise api.AuthenticationError(f"unknown replica {peer_id}")
            if not await self._scheme.verify(pub, msg, tag, sig_engine):
                raise api.AuthenticationError("bad replica signature")
            return
        if role == api.AuthenticationRole.USIG:
            await self._verify_usig(peer_id, msg, tag)
            return
        raise api.AuthenticationError(f"unknown role {role}")

    @property
    def supports_batch_verify(self) -> bool:
        # Engine-backed AND a scheme that actually overrides verify_many:
        # the verify queues' dedup/in-flight coalescing is what makes the
        # ingest seed free.  Without an engine — or for schemes stuck on
        # the base class's serial loop (the wider NIST curves) — the
        # batch surface IS the serial loop and must not be seeded.
        return (
            self._engine is not None
            and type(self._scheme).verify_many is not SigScheme.verify_many
        )

    async def verify_message_authen_tags(
        self, role: api.AuthenticationRole, items
    ) -> list:
        """Batch surface for the bundle-ingest runtime (api.Authenticator
        contract): CLIENT/REPLICA signature checks of a whole decoded
        bundle land on the engine verify queue in ONE call
        (scheme.verify_many -> engine.submit_many), so the device sees
        the bundle as one batch instead of len(bundle) racing submits.
        USIG tags keep the serial path — the TOFU epoch-capture state
        machine is inherently per-message (the base-class loop is used)."""
        if role not in (
            api.AuthenticationRole.CLIENT,
            api.AuthenticationRole.REPLICA,
        ):
            return await super().verify_message_authen_tags(role, items)
        pubs = (
            self._client_pubs
            if role == api.AuthenticationRole.CLIENT
            else self._replica_pubs
        )
        who = "client" if role == api.AuthenticationRole.CLIENT else "replica"
        out: list = [None] * len(items)
        lanes = []
        lane_rows = []
        for i, (peer_id, msg, tag) in enumerate(items):
            pub = pubs.get(peer_id)
            if pub is None:
                out[i] = api.AuthenticationError(f"unknown {who} {peer_id}")
                continue
            lanes.append((pub, msg, tag))
            lane_rows.append(i)
        if lanes:
            verdicts = await self._scheme.verify_many(lanes, self._engine)
            for row, ok in zip(lane_rows, verdicts):
                if not ok:
                    out[row] = api.AuthenticationError(f"bad {who} signature")
        return out

    def reset_usig_epoch(self, peer_id: int) -> None:
        """Forget the captured epoch for a peer so its next counter-1 UI
        re-captures — the operator re-bootstrap hook for accepting a
        restarted peer's fresh epoch (the reference leaves this to "some
        bootstrapping procedure", crypto.go:219-225).

        Any state-transfer capture floor is dropped too: a restarted peer
        signs from counter 1 again, and a surviving floor would let a
        delayed PRE-restart message (counter >= floor) re-pin the stale
        epoch and undo this reset — the exact race the counter-1 rule
        exists to narrow."""
        self._usig_epochs.pop(peer_id, None)
        self._epoch_capture_floor.pop(peer_id, None)

    def allow_epoch_capture_from(self, peer_id: int, counter: int) -> None:
        """Permit first-contact epoch capture from a UI at counter >=
        ``counter`` for ``peer_id``.

        A replica that joins late via state transfer NEVER sees any
        peer's counter-1 UI — that history is provably covered by an
        f+1-certified checkpoint and was truncated — so the reference's
        counter-1-only TOFU rule would leave it unable to establish any
        epoch and deaf to all live traffic.  The core calls this when it
        validates a peer's LOG-BASE announcement (the f+1 certificate
        proves counters <= base hold no live evidence): capturing from
        the first valid UI above the certified base trusts exactly what
        counter-1 capture trusts — the first contact signed by the
        anchored key (reference crypto.go:204-218's stated assumption),
        no more."""
        cur = self._epoch_capture_floor.get(peer_id)
        if cur is None or counter < cur:
            self._epoch_capture_floor[peer_id] = counter

    def _resolve_usig_id(self, peer_id: int, ui: UI) -> Tuple[bytes, bool]:
        """Resolve the effective usig_id (epoch || key material) for a
        peer from its trust anchor; returns (usig_id, capture_needed).
        ``capture_needed`` is True only when the epoch was taken from the
        UI certificate itself (first contact) — an epoch read from the
        captured map must NOT be re-pinned after the verify await, or an
        in-flight old-epoch UI would silently undo reset_usig_epoch."""
        anchor = self._usig_ids.get(peer_id)
        if anchor is None:
            raise api.AuthenticationError(f"unknown USIG for replica {peer_id}")
        if len(anchor) in (_EPOCH_LEN + 64, _EPOCH_LEN + 32):
            return anchor, False  # full pinned ID
        if len(anchor) not in (64, 32):
            raise api.AuthenticationError("malformed USIG trust anchor")
        epoch = self._usig_epochs.get(peer_id)
        if epoch is not None:
            return epoch + anchor, False
        # Capture the epoch from the first valid UI — which must carry
        # counter 1 (reference crypto.go:220-226: epoch is taken from
        # the cert only when none is captured AND ui.Counter == 1), OR
        # sit at/above a checkpoint-certified log base this replica
        # adopted (state-transfer join: counter-1 history is truncated —
        # see allow_epoch_capture_from).
        floor = self._epoch_capture_floor.get(peer_id)
        if ui.counter != 1 and (floor is None or ui.counter < floor):
            raise api.AuthenticationError(
                f"no captured epoch for replica {peer_id} and UI counter "
                f"{ui.counter} != 1"
                + (f" (state-transfer capture floor: {floor})" if floor else "")
            )
        if len(ui.cert) < _EPOCH_LEN:
            raise api.AuthenticationError("malformed UI certificate")
        return ui.cert[:_EPOCH_LEN] + anchor, True

    def _capture_usig_epoch(self, peer_id: int, epoch: bytes) -> None:
        """Pin the epoch after a successful verification.  First capture
        wins; a concurrently-captured different epoch fails this UI (the
        reference holds a lock across verify, crypto.go:198-200 — here
        verification awaits the batch engine, so re-check instead)."""
        cur = self._usig_epochs.get(peer_id)
        if cur is None:
            self._usig_epochs[peer_id] = epoch
        elif cur != epoch:
            raise api.AuthenticationError(
                f"USIG epoch for replica {peer_id} changed during verification"
            )

    async def _verify_usig(self, peer_id: int, msg: bytes, tag: bytes) -> None:
        try:
            ui = UI.from_bytes(tag)
        except ValueError as e:
            raise api.AuthenticationError(f"malformed UI: {e}") from e
        if ui.counter == 0:
            raise api.AuthenticationError("zero UI counter")
        try:
            usig_id, tofu = self._resolve_usig_id(peer_id, ui)
        except api.AuthenticationError:
            # Startup race: this peer's counter-1 UI may be concurrently
            # in flight (concurrent stream tasks co-batch their UI checks)
            # but not yet captured — it may not even have reached
            # _verify_usig yet.  Wait (bounded) on a shared per-peer
            # future that the first-contact verification completes, then
            # retry the resolve once; if nothing was captured meanwhile,
            # the second resolve raises the right error.  (The reference
            # holds a lock across verify, crypto.go:198-200 — this is the
            # async analogue.)
            if self._usig_ids.get(peer_id) is None:
                raise  # unknown peer: waiting can't help
            fut = self._usig_epoch_pending.get(peer_id)
            if fut is None:
                fut = asyncio.get_event_loop().create_future()
                self._usig_epoch_pending[peer_id] = fut
            try:
                await asyncio.wait_for(
                    asyncio.shield(fut), self.tofu_capture_timeout
                )
            except asyncio.TimeoutError:
                if self._usig_epoch_pending.get(peer_id) is fut:
                    self._usig_epoch_pending.pop(peer_id, None)
                if self._usig_epochs.get(peer_id) is None:
                    raise api.AuthenticationError(
                        f"no counter-1 UI from replica {peer_id} to "
                        "establish its USIG epoch"
                    ) from None
            usig_id, tofu = self._resolve_usig_id(peer_id, ui)
        if tofu:
            # First contact: make sure a pending future exists for
            # concurrent non-counter-1 UIs to wait on, and complete it
            # when this verification settles (success or failure — the
            # waiters re-resolve and get the accurate outcome).
            fut = self._usig_epoch_pending.get(peer_id)
            if fut is None:
                fut = asyncio.get_event_loop().create_future()
                self._usig_epoch_pending[peer_id] = fut
            try:
                await self._verify_usig_resolved(peer_id, msg, ui, usig_id, tofu)
            finally:
                if self._usig_epoch_pending.get(peer_id) is fut:
                    self._usig_epoch_pending.pop(peer_id, None)
                if not fut.done():
                    fut.set_result(None)
            return
        await self._verify_usig_resolved(peer_id, msg, ui, usig_id, tofu)

    async def _verify_usig_resolved(
        self, peer_id: int, msg: bytes, ui: UI, usig_id: bytes, tofu: bool
    ) -> None:
        usig_scheme = getattr(self._usig, "SCHEME", None)
        if self._engine is not None and usig_scheme == "ecdsa-p256":
            # Batched device verification of the UI certificate (K2).
            from ...usig.software import usig_verify_items

            try:
                q, payload, sig = usig_verify_items(msg, ui, usig_id)
            except UsigError as e:
                raise api.AuthenticationError(str(e)) from e
            if not await self._engine.verify_ecdsa_p256(q, payload, sig):
                raise api.AuthenticationError("invalid UI certificate")
            if tofu:
                self._capture_usig_epoch(peer_id, usig_id[:_EPOCH_LEN])
            return
        if self._engine is not None and usig_scheme == "hmac-sha256":
            # Batched device verification of the UI certificate (K6).

            try:
                epoch, fp = parse_usig_id(usig_id)
            except UsigError as e:
                raise api.AuthenticationError(str(e)) from e
            # Mirror the serial HmacUSIG._verify checks exactly so batch and
            # serial verification can never disagree: key-fingerprint match
            # and an exact-length cert (no trailing bytes after the MAC).
            if fp != hashlib.sha256(self._usig._key).digest():
                raise api.AuthenticationError("USIG key fingerprint mismatch")
            if len(ui.cert) != _EPOCH_LEN + 32 or ui.cert[:_EPOCH_LEN] != epoch:
                raise api.AuthenticationError("epoch mismatch")
            digest = hashlib.sha256(msg).digest()
            payload = _signed_payload(digest, epoch, ui.counter)
            mac = ui.cert[_EPOCH_LEN : _EPOCH_LEN + 32]
            if not await self._engine.verify_hmac_sha256(
                self._usig._key, payload, mac
            ):
                raise api.AuthenticationError("invalid UI certificate")
            if tofu:
                self._capture_usig_epoch(peer_id, epoch)
            return
        # Serial host verification (no engine).
        if self._usig is None:
            raise api.AuthenticationError("no USIG to verify with")
        try:
            self._usig.verify_ui(msg, ui, usig_id)
        except UsigError as e:
            raise api.AuthenticationError(str(e)) from e
        if tofu:
            self._capture_usig_epoch(peer_id, usig_id[:_EPOCH_LEN])


def new_test_authenticators(
    n: int,
    n_clients: int = 1,
    scheme: str = "ecdsa-p256",
    usig_kind: str = "ecdsa",
    engine: Optional[BatchVerifier] = None,
    engines: Optional[list] = None,
    client_engine: Optional[BatchVerifier] = None,
    tofu_anchors: bool = False,
):
    """Generate a coherent set of authenticators for an in-process testnet
    with fresh keys.  Returns (replica_auths, client_auths).  See
    :func:`authenticators_from_keys` for the arguments."""
    keys = make_test_keys(n, n_clients, usig_kind, scheme=scheme)
    return authenticators_from_keys(
        keys,
        engine=engine,
        engines=engines,
        client_engine=client_engine,
        tofu_anchors=tofu_anchors,
    )


# ---------------------------------------------------------------------------
# Carried-over key material.
#
# A plain dict of ints, bytes and numpy arrays — the port's counterpart of
# carrying weights across:
#
#   n                  replica count
#   scheme             "ecdsa-p256" (the default when absent) or "ed25519"
#   replica_priv       [n] ECDSA scalars (Python ints) or Ed25519 32-byte
#                      seeds
#   replica_pub        [n, 64] uint8: x || y, big-endian (ECDSA), or
#                      [n, 32] uint8 compressed public keys (Ed25519)
#   client_priv        [c] as replica_priv
#   client_pub         [c, 64] or [c, 32] uint8
#   usig_kind          "ecdsa" or "hmac"
#   usig_priv          [n] USIG ECDSA scalars (ecdsa kind)
#   usig_key           32-byte shared MAC key (hmac kind)
#   usig_epoch         [n] 8-byte epochs
#   usig_counter       [n] next counter of each USIG


def _pub_rows(pubs) -> np.ndarray:
    return np.array(
        [list(x.to_bytes(32, "big") + y.to_bytes(32, "big")) for x, y in pubs],
        dtype=np.uint8,
    ).reshape(len(pubs), 64)


def pub_from_row(row) -> Tuple[int, int]:
    """[64] uint8 x || y row -> public point (x, y)."""
    raw = bytes(np.asarray(row, dtype=np.uint8))
    return int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")


def _scheme_keys(scheme: str, count: int, rng) -> Tuple[list, np.ndarray]:
    """``count`` (private keys, [count, 64 or 32] uint8 public rows) of a
    signature scheme, drawn from ``rng``."""
    if scheme == "ecdsa-p256":
        pairs = [hc.keygen(rng) for _ in range(count)]
        return [d for d, _ in pairs], _pub_rows([q for _, q in pairs])
    if scheme != "ed25519":
        raise ValueError(
            f"no key-dict layout for {scheme!r}: the keystore carries the "
            "NIST curves (generate_testnet_keys)"
        )
    seeds = [rng.randbelow(1 << 256).to_bytes(32, "big") for _ in range(count)]
    pubs = [hc.ed25519_keygen(seed)[1] for seed in seeds]
    return seeds, np.frombuffer(b"".join(pubs), np.uint8).reshape(count, 32).copy()


def _pub_of(scheme: str, row):
    """A public-key row of ``scheme`` as the scheme's verify takes it."""
    if scheme == "ecdsa-p256":
        return pub_from_row(row)
    return bytes(np.asarray(row, dtype=np.uint8))


def make_test_keys(
    n: int,
    n_clients: int = 1,
    usig_kind: str = "ecdsa",
    rng=None,
    scheme: str = "ecdsa-p256",
) -> dict:
    """Fresh key material for an n-replica testnet, as the plain dict
    :func:`authenticators_from_keys` takes.  ``rng`` (anything with
    ``randbelow``, default :mod:`secrets`) makes it reproducible;
    ``scheme`` is the CLIENT/REPLICA signature scheme."""
    _scheme(scheme)
    rng = rng or secrets
    replica_priv, replica_pub = _scheme_keys(scheme, n, rng)
    client_priv, client_pub = _scheme_keys(scheme, n_clients, rng)
    keys = {
        "n": n,
        "scheme": scheme,
        "replica_priv": replica_priv,
        "replica_pub": replica_pub,
        "client_priv": client_priv,
        "client_pub": client_pub,
        "usig_kind": usig_kind,
        "usig_epoch": [
            rng.randbelow(1 << (8 * _EPOCH_LEN)).to_bytes(_EPOCH_LEN, "big")
            for _ in range(n)
        ],
        "usig_counter": [1] * n,
    }
    if usig_kind == "ecdsa":
        keys["usig_priv"] = [hc.keygen(rng)[0] for _ in range(n)]
    elif usig_kind == "hmac":
        keys["usig_key"] = hashlib.sha256(b"testnet-usig-key").digest()
    else:
        raise ValueError(usig_kind)
    return keys


def usigs_from_keys(keys: dict) -> list:
    """The n USIG instances of ``keys``, resuming their counters."""
    n = keys["n"]
    if keys["usig_kind"] == "ecdsa":
        return [
            EcdsaUSIG(
                keys["usig_priv"][i],
                epoch=keys["usig_epoch"][i],
                counter=keys["usig_counter"][i],
            )
            for i in range(n)
        ]
    return [
        HmacUSIG(
            keys["usig_key"],
            epoch=keys["usig_epoch"][i],
            counter=keys["usig_counter"][i],
        )
        for i in range(n)
    ]


def authenticators_from_keys(
    keys: dict,
    engine: Optional[BatchVerifier] = None,
    engines: Optional[list] = None,
    client_engine: Optional[BatchVerifier] = None,
    tofu_anchors: bool = False,
    client_engines: Optional[list] = None,
):
    """Replica and client authenticators from a dict of key material (see
    the layout above; the signature scheme is ``keys["scheme"]``).
    Returns (replica_auths, client_auths).

    ``engine`` is shared by every replica, or ``engines[i]`` is replica
    i's; ``client_engine`` serves every client (REPLY verification and
    REQUEST signing), or ``client_engines[i]`` is client i's; without an
    engine a role verifies and signs inline on the host.
    ``tofu_anchors=True`` hands out key-material anchors
    instead of full pinned IDs, so the epoch trust-on-first-use
    machinery is exercised like a deployed keystore."""
    n = keys["n"]
    scheme = keys.get("scheme", "ecdsa-p256")
    replica_pubs = {i: _pub_of(scheme, r) for i, r in enumerate(keys["replica_pub"])}
    client_pubs = {i: _pub_of(scheme, r) for i, r in enumerate(keys["client_pub"])}
    usigs = usigs_from_keys(keys)
    usig_ids = {i: u.id() for i, u in enumerate(usigs)}
    if tofu_anchors:
        usig_ids = {i: uid[_EPOCH_LEN:] for i, uid in usig_ids.items()}
    replica_auths = [
        SampleAuthenticator(
            scheme=scheme,
            replica_priv=keys["replica_priv"][i],
            replica_pubs=replica_pubs,
            client_pubs=client_pubs,
            usig=usigs[i],
            usig_ids=usig_ids,
            engine=(engines[i] if engines else engine),
            own_replica_id=i,
        )
        for i in range(n)
    ]
    client_auths = [
        SampleAuthenticator(
            scheme=scheme,
            client_priv=d,
            replica_pubs=replica_pubs,
            client_pubs=client_pubs,
            engine=(client_engines[i] if client_engines else client_engine),
        )
        for i, d in enumerate(keys["client_priv"])
    ]
    return replica_auths, client_auths
