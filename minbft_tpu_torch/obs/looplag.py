"""Event-loop lag sampler: GIL/loop saturation as a first-class metric.

A periodic task sleeps a fixed interval and measures how late the loop
woke it (scheduled-vs-actual delta).  On a healthy loop the lag is
microseconds; when pure-Python crypto, a long handler, or GIL pressure
from engine worker threads holds the loop, every timer, heartbeat, and
protocol coroutine is delayed by exactly this much — the blind spot
that made host saturation invisible in the per-stage trace.

Samples land in a mergeable :class:`~minbft_tpu_torch.obs.hist.Log2Histogram`
(one observe per tick — ~20 Hz by default, unmeasurable overhead),
exposed over Prometheus as ``minbft_eventloop_lag_seconds`` (prom.py)
and carried in the flight-recorder dump (``loop_lag`` extra) so the
cluster critical-path merge (obs/critpath.py) can attribute a
loop-saturation segment.

``MINBFT_LOOPLAG_INTERVAL`` overrides the sampling interval in seconds;
``0`` disables the sampler entirely.
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional

from .hist import Log2Histogram

INTERVAL_ENV = "MINBFT_LOOPLAG_INTERVAL"
DEFAULT_INTERVAL = 0.05


class LoopLagSampler:
    """Samples the owning event loop's scheduling lag into ``hist``.

    Single-task, loop-confined: ``start`` must run on the loop being
    measured; ``stop`` cancels the task.  The histogram may be a shared
    one (ReplicaMetrics.loop_lag) — observes are loop-side, scrape
    threads only read (the standard monitoring contract).
    """

    def __init__(self, hist: Optional[Log2Histogram] = None,
                 interval: float = DEFAULT_INTERVAL):
        self.hist = hist if hist is not None else Log2Histogram()
        self.interval = interval
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="minbft-looplag"
            )

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        interval = self.interval
        hist = self.hist
        while True:
            target = loop.time() + interval
            await asyncio.sleep(interval)
            # sleep() never wakes early; a negative delta here is loop
            # clock weirdness and lands in the hist's negatives counter.
            hist.observe(loop.time() - target)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


def maybe_sampler(hist: Log2Histogram) -> Optional[LoopLagSampler]:
    """A sampler at the env-configured interval, or None when disabled
    (``MINBFT_LOOPLAG_INTERVAL=0``)."""
    try:
        interval = float(os.environ.get(INTERVAL_ENV, "") or DEFAULT_INTERVAL)
    except ValueError:
        interval = DEFAULT_INTERVAL
    if interval <= 0:
        return None
    return LoopLagSampler(hist, interval)
