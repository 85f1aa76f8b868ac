"""Replica-side admission control for client streams.

The inbound client path already has two bounds: the bundle ingestor's rx
queue (transport backpressure) and the stream processor's concurrency
semaphore (in-flight task bound, the shed-on-saturated-group probe).
Before this module, hitting the second bound under an OPEN-LOOP offered
load had only bad outcomes: block the ingest tick (head-of-line blocks
the whole stream, rx queue wedges at its bound, the generator keeps
pushing) or drop silently (the client retransmits into the same
saturation and makes it worse).

:class:`AdmissionController` wraps the processor's non-blocking submit:
when the concurrency bound is exhausted the message is SHED — counted,
and (for REQUESTs) answered with a signed :class:`~minbft_tpu_torch.messages.
Busy` carrying a retry-after hint scaled by the observed rx saturation.
The client's retransmit ladder honors the hold
(``client.Client._handle_busy``), so offered load beyond saturation
drains into backoff instead of queue growth — the replica keeps
committing at its capacity and the overload is visible on both ends
(``admission_shed`` / ``admission_busy_sent`` counters,
``minbft_admission_*`` Prometheus families, ``peer top`` SHED/S column).

BUSY signing itself costs a signature, so an attacker flooding garbage
must not be able to convert shed work into sign work: a token bucket
bounds BUSY emission; beyond the budget sheds stay silent (counted as
``admission_busy_suppressed``) and the client's plain retransmit ladder
carries the backoff.

``MINBFT_ADMISSION=0`` reverts to the blocking submit (the
A/B lever: backpressure-only vs shed-and-signal).
"""

from __future__ import annotations

import os
import time

from ..messages import Busy, Message, Request, marshal

# BUSY emission budget: sustained signals/sec and burst size.  Sized so a
# saturated replica can tell every live client to back off within one
# retransmit interval, while a garbage flood cannot push sign load past
# a small constant rate.
_BUSY_RATE_PER_SEC = 400.0
_BUSY_BURST = 200

# retry-after hint bounds (milliseconds).  The low end covers a transient
# semaphore blip; the high end is one full saturation's worth of drain
# time at the committed ~1k req/s ceiling.
_RETRY_MIN_MS = 25
_RETRY_MAX_MS = 1000

_ADMISSION_ENV = "MINBFT_ADMISSION"


def admission_enabled() -> bool:
    return os.environ.get(_ADMISSION_ENV, "").lower() not in (
        "0", "false", "no",
    )


class AdmissionController:
    """Shed-and-signal submit wrapper for ONE client stream.

    Concurrency: confined to the owning stream's event-loop tasks (the
    ingest tick loop and the per-frame fallback path call submit; nothing
    else touches the instance) — same confinement contract as
    ``_BundleIngestor``.
    """

    def __init__(self, handlers, proc, out_queue, wrap=None):
        self._handlers = handlers
        self._proc = proc
        self._out_queue = out_queue
        # Optional frame envelope (the grouped runtime passes pack_group
        # so a BUSY demuxes to the right group client-side).
        self._wrap = wrap
        self._tokens = float(_BUSY_BURST)
        self._refill_at = time.monotonic()

    # -- submit paths (bundle ingest / per-frame fallback) ------------------

    async def submit_msg(self, msg: Message) -> None:
        if await self._proc.try_submit_msg(msg):
            return
        await self._shed(msg)

    async def submit(self, data: bytes) -> None:
        if await self._proc.try_submit(data):
            return
        # Decode only on the shed path (the happy path stays zero-copy):
        # a BUSY needs the request's client/seq attribution.
        from ..messages import unmarshal

        try:
            msg = unmarshal(data)
        except Exception:
            self._handlers.metrics.inc("admission_shed")
            return
        await self._shed(msg)

    # -- shed ---------------------------------------------------------------

    async def _shed(self, msg: Message) -> None:
        h = self._handlers
        h.metrics.inc("admission_shed")
        if not isinstance(msg, Request):
            return  # only REQUESTs have a client to signal
        if not self._take_token():
            h.metrics.inc("admission_busy_suppressed")
            return
        busy = Busy(
            replica_id=h.replica_id,
            client_id=msg.client_id,
            seq=msg.seq,
            retry_after_ms=self._retry_after_ms(),
        )
        try:
            # Batch-aware signing: concurrent sheds co-batch with reply
            # signatures on the engine's sign queue.
            await h.sign_message_async(busy)
        except Exception as e:
            h.metrics.inc("admission_busy_suppressed")
            h.log.warning("BUSY sign failed: %r", e)
            return
        h.metrics.inc("admission_busy_sent")
        frame = marshal(busy)
        if self._wrap is not None:
            frame = self._wrap(frame)
        await self._out_queue.put(frame)

    def _retry_after_ms(self) -> int:
        """Hold hint scaled by the last-stamped rx saturation: a blip
        earns a short hold, a wedged-full rx queue the max."""
        frac = self._handlers.metrics.admission_rx_saturation()
        return int(_RETRY_MIN_MS + frac * (_RETRY_MAX_MS - _RETRY_MIN_MS))

    def _take_token(self) -> bool:
        now = time.monotonic()
        self._tokens = min(
            float(_BUSY_BURST),
            self._tokens + (now - self._refill_at) * _BUSY_RATE_PER_SEC,
        )
        self._refill_at = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False
