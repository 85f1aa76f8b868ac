"""Protocol flight recorder: per-request stage spans.

Every pipeline hook notes a (request-key, stage, monotonic-ns) event:

- **replica** capture points: ``recv`` → ``verify_enqueue`` →
  ``verify_done`` → ``prepare`` → ``commit_quorum`` → ``execute`` →
  ``reply_sign`` → ``reply_sent``;
- **client** capture points: ``start`` → ``sign`` → ``broadcast`` →
  ``first_reply`` → ``quorum``.

Two artifacts come out of a note:

1. the raw event lands in a **preallocated ring buffer** (forensics:
   the JSON trace dump carries the tail of the run, request by request);
2. the duration since the request's PREVIOUS noted point is folded into
   that stage's :class:`~minbft_tpu_torch.obs.hist.Log2Histogram` — so
   ``stage_commit_quorum`` reads "time from prepare to commit quorum",
   and the histograms answer "where does a committed request's time go"
   without post-processing (and merge across replicas, unlike a
   reservoir).

Cost discipline: with tracing disabled every hook
is ONE predicated attribute check (``if tr is not None``) — the recorder
simply doesn't exist.  Enabled, a note is two dict operations, four
array stores into the preallocated ring, and one histogram increment; no
per-event object survives the call.

Threading: a :class:`StageRing` has a SINGLE writer (the event loop) and
is deliberately lock-free — asyncio callbacks never preempt mid-push.
Engine worker threads must never touch it; they get their own
:class:`MTStageRing`, whose push/drain are serialized by its lock (the
same locked-writes discipline as the engine's ``_stats_lock`` stats;
``tools/analyze`` lock-discipline enforces both).
"""

from __future__ import annotations

import json
import os
import time
from array import array
from typing import Dict, Iterable, List, Optional, Tuple

from .hist import Log2Histogram

# Replica capture points, in pipeline order.  ``ingest`` is the
# bundle-runtime entry (the tick that decoded this request's frame
# bundle); ``recv`` is the legacy per-task entry (MINBFT_BUNDLE_INGEST=0)
# — both are ENTRY stages (they open spans, never record durations), so
# retransmit gaps can't pollute the cost table on either path.
REPLICA_STAGES: Tuple[str, ...] = (
    "ingest",
    "recv",
    "verify_enqueue",
    "verify_done",
    "prepare",
    "commit_quorum",
    "execute",
    "reply_sign",
    "reply_sent",
)
R_INGEST = 0
R_RECV = 1
R_VERIFY_ENQUEUE = 2
R_VERIFY_DONE = 3
R_PREPARE = 4
R_COMMIT_QUORUM = 5
R_EXECUTE = 6
R_REPLY_SIGN = 7
R_REPLY_SENT = 8
# Stages that never close a span (see FlightRecorder.note).
_REPLICA_ENTRY_STAGES = frozenset((R_INGEST, R_RECV))

# Client capture points ("start" is the implicit entry of request()).
CLIENT_STAGES: Tuple[str, ...] = (
    "start",
    "sign",
    "broadcast",
    "first_reply",
    "quorum",
)
C_START = 0
C_SIGN = 1
C_BROADCAST = 2
C_FIRST_REPLY = 3
C_QUORUM = 4

# Environment knobs (read once per recorder construction, never per event).
TRACE_ENV = "MINBFT_TRACE"
TRACE_DUMP_ENV = "MINBFT_TRACE_DUMP"
_RING_ENV = "MINBFT_TRACE_RING"

_DEFAULT_RING = 1 << 15
# In-flight pairing state is bounded: a key whose final stage never
# arrives (dropped request) would leak its entry, so past this many keys
# the map is reset wholesale — losing pairing for the requests in flight
# at that instant, never memory.
_MAX_INFLIGHT_KEYS = 1 << 16


def tracing_enabled() -> bool:
    """True when the operator asked for tracing: ``MINBFT_TRACE`` set to
    anything but the usual falsy spellings (so ``MINBFT_TRACE=0``
    DISABLES, matching the repo's env-flag convention), or a
    ``MINBFT_TRACE_DUMP`` path (any non-empty value — it names a file
    prefix, not a flag)."""
    flag = os.environ.get(TRACE_ENV, "")
    if flag.lower() not in ("", "0", "false", "no"):
        return True
    return bool(os.environ.get(TRACE_DUMP_ENV))


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

    @property
    def capacity(self) -> int:
        return self._cap

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
    the ring's lock, and drains hold the same lock — the locked-writes
    discipline ``tools/analyze`` enforces for every cross-thread
    mutation in this codebase.  Same storage/wrap semantics as the
    base; only the lock wrapping differs."""

    __slots__ = ("_lock",)

    def __init__(self, capacity: int = 4096):
        import threading

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


class FlightRecorder:
    """Stage-span recorder for one replica or client.

    ``note(stage, cid, seq)`` is THE hot-path entry point; everything
    else (snapshots, dumps, tables) is cold-path reporting.  Histograms
    may be read by a scrape thread while the loop writes — int mutations
    are GIL-atomic, so a reader sees a slightly stale but never torn
    view (standard monitoring semantics).
    """

    def __init__(
        self,
        kind: str,
        ident: int,
        stages: Tuple[str, ...],
        ring_capacity: Optional[int] = None,
        entry_stages: Optional[frozenset] = None,
        group: Optional[int] = None,
    ):
        if ring_capacity is None:
            ring_capacity = int(os.environ.get(_RING_ENV, _DEFAULT_RING))
        self.kind = kind  # "replica" | "client" | "engine"
        self.ident = ident
        # Consensus-group id (multi-group runtime): stamped into dumps so
        # stage_table/critpath_table can filter one group's spans out of
        # a shared-process dump set; None = ungrouped.
        self.group = group
        self.stages = stages
        self.ring = StageRing(ring_capacity)
        self.hists: List[Log2Histogram] = [Log2Histogram() for _ in stages]
        self._final = len(stages) - 1
        # Pipeline entries: stages that open a span but never close one
        # (a retransmission re-noting an entry mid-pipeline must not fold
        # its gap into the cost table).  Default: stage 0 only.
        self._entries = frozenset((0,)) if entry_stages is None else entry_stages
        # (cid, seq) -> monotonic-ns of the previous noted point.
        self._last: Dict[Tuple[int, int], int] = {}

    @staticmethod
    def for_replica(
        replica_id: int, group: Optional[int] = None
    ) -> "FlightRecorder":
        return FlightRecorder(
            "replica",
            replica_id,
            REPLICA_STAGES,
            entry_stages=_REPLICA_ENTRY_STAGES,
            group=group,
        )

    @staticmethod
    def for_client(
        client_id: int, group: Optional[int] = None
    ) -> "FlightRecorder":
        return FlightRecorder("client", client_id, CLIENT_STAGES, group=group)

    def note(self, stage: int, cid: int, seq: int) -> None:
        t = time.monotonic_ns()
        self.ring.push(cid, seq, stage, t)
        key = (cid, seq)
        last = self._last
        prev = last.get(key)
        if prev is not None and stage not in self._entries:
            # Entry stages (ingest/recv on replicas, start on clients)
            # open spans but never close one — a client retransmission
            # re-noting an entry mid-pipeline would otherwise fold the
            # 30s retransmit gap into the cost table as "recv time".
            # (The raw ring still keeps the duplicate arrival for
            # forensics.)
            self.hists[stage].observe_ns(t - prev)
        if stage == self._final:
            last.pop(key, None)
        else:
            if len(last) >= _MAX_INFLIGHT_KEYS:
                last.clear()
            last[key] = t

    # -- reporting ------------------------------------------------------

    def stage_hists(self) -> Dict[str, Log2Histogram]:
        """Stage name -> histogram of "time from the previous noted
        point to this point" (entry points with no predecessor record
        nothing)."""
        return {
            name: h
            for name, h in zip(self.stages, self.hists)
            if h.count
        }

    def to_dict(self, max_events: int = 4096) -> dict:
        doc = {
            "kind": self.kind,
            "id": self.ident,
            "stages": list(self.stages),
            "clock_domain": clock_domain(),
            "hists": {n: h.to_dict() for n, h in self.stage_hists().items()},
            "events": [
                list(e) for e in self.ring.snapshot(limit=max_events)
            ],
        }
        if self.group is not None:
            doc["group"] = self.group
        return doc


# ---------------------------------------------------------------------------
# JSON trace dumps (MINBFT_TRACE_DUMP=path) and the bench stage table.


def clock_domain() -> str:
    """Identity of this process's monotonic-clock domain, stamped into
    every dump: ``time.monotonic`` reads the system-wide boot-relative
    CLOCK_MONOTONIC, so EVERY process on one host (one boot) shares the
    epoch — dumps with equal domains merge with zero offset and zero
    uncertainty, and only genuinely cross-host dumps pay the
    Cristian-style estimation (obs/clockalign.py).  Containers with
    private hostnames conservatively fall into separate domains even
    when the kernel clock is shared — estimation is the safe default,
    exactness the proven special case."""
    import socket

    return socket.gethostname()


def dump_path_for(
    kind: str,
    ident: int,
    base: Optional[str] = None,
    group: Optional[int] = None,
) -> Optional[str]:
    """Per-process-safe dump path: ``{base}.{r|c}{id}.json`` (multiple
    replicas/clients — in one process or many — never clobber).  Grouped
    recorders append ``g{group}``: a GroupRuntime's G cores share one
    replica id, so the group must be part of the filename or the cores'
    dumps clobber each other."""
    base = base if base is not None else os.environ.get(TRACE_DUMP_ENV)
    if not base:
        return None
    tag = {"replica": "r", "client": "c"}.get(kind, kind)
    gtag = "" if group is None else f"g{group}"
    return f"{base}.{tag}{ident}{gtag}.json"


def dump_recorder(rec: FlightRecorder, base: Optional[str] = None,
                  extra: Optional[dict] = None) -> Optional[str]:
    """Write one recorder's dump; returns the path (None when the dump
    env/base is unset — the recorder may be enabled for live scraping
    only)."""
    path = dump_path_for(rec.kind, rec.ident, base, group=rec.group)
    if path is None:
        return None
    doc = rec.to_dict()
    # Incarnation attribution: every dump says which process
    # produced it, so cross-node mergers can refuse to splice a restarted
    # replica onto its predecessor's timeline (obs/critpath.py) and a
    # merged artifact's numbers stay traceable to concrete pids/revs.
    # ``extra`` may override (tests construct synthetic incarnations).
    from . import runinfo

    doc.setdefault("run_id", runinfo.RUN_ID)
    doc.setdefault("build", runinfo.build_info())
    if extra:
        doc.update(extra)
    # noqa: AH102 - one-shot crash/shutdown dump; forensics cannot rely on executors
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def load_dumps(base: str) -> List[dict]:
    """Load every ``{base}.*.json`` trace dump (bench ingestion)."""
    import glob

    docs = []
    for path in sorted(glob.glob(base + ".*.json")):
        try:
            # noqa: AH102 - one-shot ingestion at bench report time
            with open(path) as fh:
                docs.append(json.load(fh))
        except (OSError, ValueError):
            continue
    return docs


def filter_group(docs: Iterable[dict], group: Optional[int]) -> List[dict]:
    """Restrict a dump set to one consensus group: docs stamped with a
    DIFFERENT group are dropped; unstamped docs (ungrouped recorders,
    shared engine docs, clients without a group label) are kept — the
    engine queues really are shared across groups, so excluding their
    doc would just lose the queue-wait attribution.  ``group=None`` is
    the identity."""
    docs = list(docs)
    if group is None:
        return docs
    return [d for d in docs if d.get("group") in (None, group)]


def merged_stage_hists(docs: Iterable[dict]) -> Dict[str, Log2Histogram]:
    """Merge dumped stage histograms across recorders.  Client stages
    are namespaced (``client_sign``...) so the one table carries both
    sides without key collisions; replica stages keep their bare names."""
    out: Dict[str, Log2Histogram] = {}
    for doc in docs:
        prefix = "client_" if doc.get("kind") == "client" else ""
        for name, hd in (doc.get("hists") or {}).items():
            h = Log2Histogram.from_dict(hd)
            key = prefix + name
            if key in out:
                out[key].merge(h)
            else:
                out[key] = h
    return out


def stage_table(
    docs: Iterable[dict], prefix: str, group: Optional[int] = None
) -> dict:
    """The bench's per-stage cost-breakdown keys:

    - ``{prefix}_stage_{name}_p50_ms`` — median time from the previous
      capture point to ``name`` (merged across every dumped recorder);
    - ``{prefix}_stage_{name}_share`` — that stage's fraction of the
      total replica-side recorded time (client stages overlap the
      replica pipeline by construction, so shares are computed over the
      replica stages only — they sum to 1.0).

    ``group`` restricts the table to one consensus group's recorders
    (see :func:`filter_group`) — the multi-group runtime dumps every
    core into one dump set.

    Returns {} when no dump carries histogram data, so a tracing-disabled
    bench emits byte-identical keys to a tracing-absent one.
    """
    hists = merged_stage_hists(filter_group(docs, group))
    if not hists:
        return {}
    out: dict = {}
    replica_total = sum(
        h.total_s for n, h in hists.items() if not n.startswith("client_")
    )
    for name, h in sorted(hists.items()):
        out[f"{prefix}_stage_{name}_p50_ms"] = round(h.percentile(50) * 1e3, 3)
        if not name.startswith("client_") and replica_total > 0:
            out[f"{prefix}_stage_{name}_share"] = round(
                h.total_s / replica_total, 4
            )
    return out
