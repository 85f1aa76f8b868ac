"""Backoff policies shared by the redial and retransmit loops.

Both `core.message_handling.run_peer_connection` and
`client.Client._run_connection` redial dropped streams (the reference
instead relies on operators restarting peers, core/message-handling.go:
316-350 HELLO replay handles only the receiving side), and
`client.Client._await_with_retransmit` re-sends unresolved requests.
The ladders live here once so the loops cannot drift apart.

Jitter: a partition heal (or a replica restart) ends MANY streams in the
same event-loop turn — identical deterministic ladders would then redial
in lockstep forever, hammering the recovered peer with synchronized
connection storms (the classic thundering herd).  Every delay is
therefore spread by a multiplicative jitter factor drawn from the
policy's own RNG; tests that pin exact ladder values pass
``jitter_frac=0``.
"""

from __future__ import annotations

import random
from typing import Optional


class ReconnectBackoff:
    """Exponential redial ladder with a lived-connection reset.

    A connection that survived longer than ``lived_reset_s`` was healthy
    (not a crash-looping peer whose replay counts as liveness every
    attempt), so the next failure restarts the ladder at ``start_s``.

    ``jitter_frac`` spreads each returned delay uniformly over
    ``[delay*(1-j), delay*(1+j)]`` (still capped at ``cap_s``) so
    simultaneous stream deaths — a healed partition, a bounced peer —
    do not produce a synchronized redial herd.  The ladder itself
    (the un-jittered ``_delay``) advances deterministically.
    """

    def __init__(
        self,
        start_s: float = 0.2,
        cap_s: float = 10.0,
        lived_reset_s: float = 5.0,
        factor: float = 2.0,
        jitter_frac: float = 0.25,
        rng: Optional[random.Random] = None,
    ):
        self._start = start_s
        self._cap = cap_s
        self._lived = lived_reset_s
        self._factor = factor
        self._delay = start_s
        self._jitter = max(0.0, min(jitter_frac, 1.0))
        self._rng = rng if rng is not None else random.Random()

    def next_delay(self, attempt_lived_s: float) -> float:
        """Delay before the next dial, given how long the last attempt
        lived.  Advances the ladder."""
        if attempt_lived_s > self._lived:
            self._delay = self._start
        delay = self._delay
        self._delay = min(self._delay * self._factor, self._cap)
        if self._jitter:
            delay *= 1.0 + self._jitter * (2.0 * self._rng.random() - 1.0)
        return min(delay, self._cap)


class RetransmitBackoff:
    """Capped exponential retransmit ladder with jitter (no lived-reset:
    a retransmit loop serves ONE request and dies with it).

    The client's request retransmitter used a fixed interval — under a
    lossy or partitioned network every unresolved pipelined request then
    re-broadcast in the same tick, and the whole fleet of clients
    re-synchronized on the heal.  This ladder starts at ``start_s``,
    doubles to ``cap_s`` (default ``8 * start_s``), and jitters each
    interval like :class:`ReconnectBackoff`."""

    def __init__(
        self,
        start_s: float,
        cap_s: Optional[float] = None,
        factor: float = 2.0,
        jitter_frac: float = 0.25,
        rng: Optional[random.Random] = None,
    ):
        if start_s <= 0:
            raise ValueError("retransmit start_s must be positive")
        self._start = start_s
        self._cap = cap_s if cap_s is not None else 8.0 * start_s
        self._factor = factor
        self._delay = start_s
        self._jitter = max(0.0, min(jitter_frac, 1.0))
        self._rng = rng if rng is not None else random.Random()

    def next_delay(self) -> float:
        """The wait before the next retransmission.  Advances the ladder."""
        delay = self._delay
        self._delay = min(self._delay * self._factor, self._cap)
        if self._jitter:
            delay *= 1.0 + self._jitter * (2.0 * self._rng.random() - 1.0)
        return min(delay, self._cap)
