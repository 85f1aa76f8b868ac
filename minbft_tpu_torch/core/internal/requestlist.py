"""Pending-request set (reference core/internal/requestlist/
request-list.go:36-80).

The reference keeps ONE slot per client — sound for its strictly serial
clients, where a new request genuinely supersedes the previous one.
This build's clients pipeline: with a single slot, each captured request
OVERWRITES the previous still-in-flight one, so a view change re-applies
only the newest pending request per client and the rest silently starve
(the chaos soak wedged on this — 1 of 6 pipelined requests survived the
transition).  The set therefore tracks every in-flight (client, seq),
bounded per client by ``_PER_CLIENT`` (evicting the oldest — the
reference's overwrite semantic, widened from depth 1 to any sane
pipeline depth)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List


class RequestList:
    _PER_CLIENT = 128  # >= any sane client pipeline depth

    def __init__(self):
        self._by_client: Dict[int, "OrderedDict[int, object]"] = {}

    def add(self, request) -> None:
        d = self._by_client.setdefault(request.client_id, OrderedDict())
        d[request.seq] = request
        d.move_to_end(request.seq)
        while len(d) > self._PER_CLIENT:
            d.popitem(last=False)

    def remove(self, request) -> bool:
        d = self._by_client.get(request.client_id)
        if d is not None and request.seq in d:
            del d[request.seq]
            if not d:
                del self._by_client[request.client_id]
            return True
        return False

    def all(self) -> List[object]:
        return [r for d in self._by_client.values() for r in d.values()]

    def __len__(self) -> int:
        return sum(len(d) for d in self._by_client.values())
