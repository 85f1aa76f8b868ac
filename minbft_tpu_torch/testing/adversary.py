"""Byzantine replica harnesses: real keys, real codec, hostile content
(the port's copy of :mod:`minbft_tpu.testing.adversary`).

The forged-message tests (tests/test_byzantine.py and its port) throw garbage
signatures at the cluster; this module goes further — an
:class:`Adversary` holds a replica's GENUINE authenticator (its
signature keys and its USIG) and crafts protocol messages that are
well-formed and partially genuine, probing exactly the properties the
paper's argument leans on:

- **equivocation** (`equivocating_prepares`): two conflicting PREPAREs
  for one view — the first genuinely certified, the second reusing the
  SAME UI over different content.  USIG counter monotonicity is the
  defense: one counter value certifies one message, so the second can
  only be a cert forgery and must fail verification.
- **stale-UI replay** (`replay`): a genuine old certified message
  re-sent; per-peer in-order once-only capture must make it a no-op.
- **wrong-view PREPARE** (`wrong_view_prepare`): genuinely certified,
  but for a view the cluster is not in; it must never apply in the
  current view.
- **counter-gap COMMIT** (`counter_gap_commit`): a genuine cert whose
  counter skips a value (the adversary signed something it never sent).
  Receivers must not process past the gap — the skipped slot could hide
  anything.
- **conflicting REPLYs** (:class:`ConflictingReplyReplica`): a replica
  answering clients with correctly-signed WRONG results; the client's
  f+1 matching-reply quorum must keep a single liar's vote worthless.

The adversary is expected to own its identity exclusively while active
(crash the real replica first — its USIG counter is a shared serial
resource), which also keeps the cluster inside its f = 1 fault budget.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Iterable, List, Optional, Sequence

from .. import api
from ..core import usig_ui
from ..core import utils as core_utils
from ..messages import (
    Commit,
    Hello,
    Message,
    Prepare,
    Reply,
    Request,
    UI,
    authen_bytes,
    marshal,
    split_multi,
    unmarshal,
)


class Adversary:
    """Craft signed/certified messages under a replica's genuine keys."""

    def __init__(self, replica_id: int, authenticator: api.Authenticator, n: int):
        self.replica_id = replica_id
        self.n = n
        self._auth = authenticator
        self._assign_ui = usig_ui.make_ui_assigner(authenticator)

    # -- primitives ----------------------------------------------------

    def sign(self, msg: Message) -> Message:
        """Genuine plain signature (REPLICA role for replica-signed
        kinds; REPLYs are audience-keyed for MAC schemes)."""
        audience = msg.client_id if isinstance(msg, Reply) else -1
        msg.signature = self._auth.generate_message_authen_tag(
            core_utils.signing_role(msg), authen_bytes(msg), audience
        )
        return msg

    def certify(self, msg: Message) -> Message:
        """Genuine USIG certification — consumes the next counter."""
        self._assign_ui(msg)
        return msg

    def burn_counter(self) -> int:
        """Consume one USIG counter on a message that is never sent
        (the gap maker).  Returns the burned counter value."""
        ghost = Prepare(
            replica_id=self.replica_id, view=0, requests=(Request(
                client_id=0, seq=0, operation=b"burned"
            ),),
        )
        self.certify(ghost)
        return ghost.ui.counter

    # -- behaviors -----------------------------------------------------

    def equivocating_prepares(
        self, view: int, requests_a: Sequence[Request], requests_b: Sequence[Request]
    ) -> List[Prepare]:
        """A genuinely-certified PREPARE for ``requests_a`` plus a
        conflicting PREPARE for ``requests_b`` reusing the SAME UI —
        the equivocation attempt USIG monotonicity must reject past the
        first (the cert binds the authen bytes, so the copy's cert is a
        forgery)."""
        a = Prepare(
            replica_id=self.replica_id, view=view, requests=tuple(requests_a)
        )
        self.certify(a)
        b = Prepare(
            replica_id=self.replica_id,
            view=view,
            requests=tuple(requests_b),
            ui=UI(counter=a.ui.counter, cert=a.ui.cert),
        )
        return [a, b]

    def wrong_view_prepare(
        self, view: int, requests: Sequence[Request]
    ) -> Prepare:
        """A genuinely-certified PREPARE for a view the cluster is NOT
        in.  Pick a view whose primary this adversary actually is
        (``view % n == replica_id``) so the rejection under test is the
        view check, not the primary check."""
        if view % self.n != self.replica_id:
            raise ValueError(
                f"adversary {self.replica_id} is not the primary of view "
                f"{view} — use view {self.replica_id} (+ k*n)"
            )
        p = Prepare(replica_id=self.replica_id, view=view, requests=tuple(requests))
        return self.certify(p)

    def counter_gap_commit(self, prepare: Prepare) -> Commit:
        """A genuinely-certified COMMIT whose counter skips a value: one
        counter is burned unsent, so the receiver's in-order capture
        must park (and never process) this message — the gap could hide
        an equivocation."""
        self.burn_counter()
        c = Commit(replica_id=self.replica_id, prepare=prepare)
        return self.certify(c)

    def conflicting_reply(
        self, client_id: int, seq: int, result: bytes, read_only: bool = False
    ) -> Reply:
        """A correctly-signed REPLY carrying a WRONG result."""
        r = Reply(
            replica_id=self.replica_id,
            client_id=client_id,
            seq=seq,
            result=result,
            read_only=read_only,
        )
        return self.sign(r)

    @staticmethod
    def replay(msg: Message) -> Message:
        """A stale replay is just the message again (self-documenting
        call site; capture-side dedup is the property under test)."""
        return msg

    # -- delivery ------------------------------------------------------

    async def inject(
        self,
        victim_handler: api.MessageStreamHandler,
        payloads: Iterable[Message],
        hold_s: float = 0.5,
    ) -> None:
        """Open a peer stream to a victim (its
        ``peer_message_stream_handler()``) with this adversary's GENUINE
        signed HELLO — the handshake is authenticated, an outsider
        cannot even reach the dispatch — and pump the payloads through
        the real codec.  Holds the stream open ``hold_s`` so parked
        captures (gap messages) are observable, then withdraws."""
        done = asyncio.Event()

        async def outgoing() -> AsyncIterator[bytes]:
            hello = Hello(replica_id=self.replica_id)
            self.sign(hello)
            yield marshal(hello)
            for msg in payloads:
                yield marshal(msg)
            try:
                await asyncio.wait_for(done.wait(), hold_s)
            except asyncio.TimeoutError:
                return

        async def drain() -> None:
            async for _ in victim_handler.handle_message_stream(outgoing()):
                pass

        consumer = asyncio.ensure_future(drain())
        await asyncio.sleep(hold_s)
        done.set()
        consumer.cancel()
        try:
            await consumer
        except (asyncio.CancelledError, Exception):
            pass


class ConflictingReplyReplica:
    """A drop-in for a ReplicaStub's replica slot that answers every
    client REQUEST with a correctly-signed WRONG result (and serves no
    peer traffic): the conflicting-REPLY adversary.  The client's f+1
    matching quorum must never count it toward acceptance."""

    def __init__(
        self,
        adversary: Adversary,
        forged_result: bytes = b"\xde\xad" * 16,
    ):
        self.id = adversary.replica_id
        self._adv = adversary
        self.forged_result = forged_result
        self.replies_sent = 0

    def peer_message_stream_handler(self) -> api.MessageStreamHandler:
        return _SilentHandler()

    def client_message_stream_handler(self) -> api.MessageStreamHandler:
        return _ForgingClientHandler(self)

    async def start(self) -> None:  # api.Replica shape (stub assignment)
        return None

    async def stop(self) -> None:
        return None


class _SilentHandler(api.MessageStreamHandler):
    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        async for _ in in_stream:
            pass
        return
        yield b""  # pragma: no cover - makes this an async generator


class _ForgingClientHandler(api.MessageStreamHandler):
    def __init__(self, owner: ConflictingReplyReplica):
        self._owner = owner

    async def handle_message_stream(
        self, in_stream: AsyncIterator[bytes]
    ) -> AsyncIterator[bytes]:
        owner = self._owner
        async for data in in_stream:
            try:
                frames = split_multi(data)
            except Exception:
                continue
            for fr in frames:
                try:
                    msg = unmarshal(fr)
                except Exception:
                    continue
                if not isinstance(msg, Request):
                    continue
                reply = owner._adv.conflicting_reply(
                    msg.client_id,
                    msg.seq,
                    owner.forged_result,
                    read_only=msg.is_fast_read,
                )
                owner.replies_sent += 1
                yield marshal(reply)


def take_over(replica, stub, adversary: Optional[Adversary] = None) -> Adversary:
    """Convert a running replica into an adversary identity: crash its
    streams, stop its tasks, and hand back an Adversary over its
    authenticator (counter continuity included — the next certified
    message extends the replica's genuine USIG sequence)."""
    stub.crash()
    adv = adversary or Adversary(
        replica.id, replica.handlers.authenticator, replica.n
    )
    return adv
