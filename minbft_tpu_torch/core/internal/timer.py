"""Injectable timer abstraction (reference core/internal/timer/timer.go:30-87).

Exists so protocol timeouts can be tested without real time elapsing: tests
inject :class:`FakeTimerProvider` and fire timers explicitly (the reference
injects a gomock timer provider, core/internal/clientstate/timeout_test.go).
"""

from __future__ import annotations

import asyncio
from typing import Callable, List


class Timer:
    def cancel(self) -> None:
        raise NotImplementedError


class TimerProvider:
    def after(self, delay: float, callback: Callable[[], None]) -> Timer:
        raise NotImplementedError


class _StandardTimer(Timer):
    def __init__(self, handle: asyncio.TimerHandle):
        self._handle = handle

    def cancel(self) -> None:
        self._handle.cancel()


class StandardTimerProvider(TimerProvider):
    """Real-time timers on the running event loop."""

    def after(self, delay: float, callback: Callable[[], None]) -> Timer:
        loop = asyncio.get_running_loop()
        return _StandardTimer(loop.call_later(delay, callback))


class FakeTimer(Timer):
    def __init__(self, provider: "FakeTimerProvider", delay: float, callback):
        self.provider = provider
        self.delay = delay
        self.callback = callback
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def fire(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            self.callback()


class FakeTimerProvider(TimerProvider):
    """Manual-fire timers for tests (no real time elapses)."""

    def __init__(self):
        self.timers: List[FakeTimer] = []

    def after(self, delay: float, callback: Callable[[], None]) -> FakeTimer:
        t = FakeTimer(self, delay, callback)
        self.timers.append(t)
        return t

    def fire_all(self) -> None:
        for t in list(self.timers):
            t.fire()
