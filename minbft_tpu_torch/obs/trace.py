"""Dispatcher span rings for the batch engine.

Port of the ring classes of :mod:`minbft_tpu.obs.trace` — only what
:meth:`minbft_tpu_torch.parallel.engine.BatchVerifier.enable_obs_ring`
needs.  The flight recorder, dump and merge helpers come with the core
slice of the port.
"""

from __future__ import annotations

import threading
from array import array
from typing import List, Optional, Tuple

_DEFAULT_RING = 1 << 15


class StageRing:
    """Preallocated single-writer ring of (a, b, stage, t_ns) events.

    Four parallel ``array('q')`` columns: a push is four C-level stores
    plus two int updates — no allocation, no lock.  ONLY the owning
    event loop may push; cross-thread producers use :class:`MTStageRing`.
    """

    __slots__ = ("_a", "_b", "_c", "_t", "_cap", "_idx", "_n")

    def __init__(self, capacity: int = _DEFAULT_RING):
        cap = 1
        while cap < max(2, capacity):
            cap <<= 1
        self._cap = cap
        self._a = array("q", bytes(8 * cap))
        self._b = array("q", bytes(8 * cap))
        self._c = array("q", bytes(8 * cap))
        self._t = array("q", bytes(8 * cap))
        self._idx = 0  # next write slot
        self._n = 0  # valid entries (saturates at _cap)

    def push(self, a: int, b: int, c: int, t_ns: int) -> None:
        i = self._idx
        self._a[i] = a
        self._b[i] = b
        self._c[i] = c
        self._t[i] = t_ns
        self._idx = (i + 1) & (self._cap - 1)
        if self._n < self._cap:
            self._n += 1

    def __len__(self) -> int:
        return self._n

    def snapshot(self, limit: Optional[int] = None) -> List[Tuple[int, int, int, int]]:
        """Events oldest→newest (optionally only the newest ``limit``)."""
        n = self._n
        if limit is not None:
            n = min(n, limit)
        start = (self._idx - n) & (self._cap - 1)
        out = []
        for k in range(n):
            i = (start + k) & (self._cap - 1)
            out.append((self._a[i], self._b[i], self._c[i], self._t[i]))
        return out


class MTStageRing(StageRing):
    """Multi-producer sibling of :class:`StageRing`: engine worker
    threads (up to ``max_inflight`` concurrent dispatchers) push under
    the ring's lock, and drains hold the same lock.  Same storage/wrap
    semantics as the base; only the lock wrapping differs."""

    __slots__ = ("_lock",)

    def __init__(self, capacity: int = 4096):
        super().__init__(capacity)
        self._lock = threading.Lock()

    def push(self, a: int, b: int, c: int, t_ns: int) -> None:
        with self._lock:
            super().push(a, b, c, t_ns)

    def __len__(self) -> int:
        with self._lock:
            return super().__len__()

    def snapshot(self, limit: Optional[int] = None) -> List[Tuple[int, int, int, int]]:
        with self._lock:
            return super().snapshot(limit)
