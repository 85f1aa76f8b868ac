"""Cross-replica safety invariants, checkable mid-run and at teardown
(the port's copy of :mod:`minbft_tpu.testing.invariants`, same rules).

What BFT safety means for this build, stated as executable checks over
an in-process cluster (the chaos soak and the adversary suite call these
while faults are still in flight, then again after convergence):

1. **Prefix consistency** — the executed-request logs of all CORRECT
   replicas are prefixes of one another.  SimpleLedger hash-chains its
   blocks, so equal digests at the shorter ledger's head imply equal
   prefixes (one comparison per pair, not one per block).
2. **UI integrity** — each correct replica's OWN certified-message log
   holds contiguous USIG counters from its truncation base (an omission
   or fork would show as a gap or duplicate), and every replica's
   per-peer accepted-UI watermark only ever moves forward (checked
   against the previous snapshot when called repeatedly).
3. **Committed results** — every result a client ACCEPTED (an f+1
   quorum) appears in every correct replica's ledger as the digest of a
   block carrying that operation: what the client believes committed IS
   what the cluster executed.

Violations raise :class:`InvariantViolation` (an AssertionError, so
pytest renders it as a failure with the offending detail).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..messages import CERTIFIED_MESSAGES


class InvariantViolation(AssertionError):
    """A cross-replica safety invariant does not hold."""


class InvariantChecker:
    """Holds the cluster handles plus the previous watermark snapshot so
    repeated mid-run calls can assert monotonicity, not just shape.

    ``correct`` lists the replica indices to hold to the safety bar
    (default: all) — crashed or Byzantine replicas are excluded by the
    caller, exactly as the BFT property is stated.
    """

    def __init__(
        self,
        replicas: Sequence,
        ledgers: Sequence,
        correct: Optional[Iterable[int]] = None,
    ):
        self._replicas = list(replicas)
        self._ledgers = list(ledgers)
        self._correct = (
            sorted(correct) if correct is not None else list(range(len(replicas)))
        )
        # (observer_idx, peer_id) -> last seen accepted-UI watermark.
        self._prev_marks: Dict[Tuple[int, int], int] = {}

    def set_correct(self, correct: Iterable[int]) -> None:
        """Narrow the correct set mid-run (a replica just crashed or
        turned adversarial)."""
        self._correct = sorted(correct)

    # -- individual invariants ----------------------------------------

    def check_prefix_consistency(self) -> None:
        idxs = self._correct
        for a in range(len(idxs)):
            for b in range(a + 1, len(idxs)):
                ia, ib = idxs[a], idxs[b]
                la, lb = self._ledgers[ia], self._ledgers[ib]
                h = min(la.length, lb.length)
                da = la.block(h).digest()
                db = lb.block(h).digest()
                if da != db:
                    # Hash chaining makes the head compare sufficient;
                    # walk back for the FIRST diverging height and name
                    # the executed operations around it — the detail
                    # that turns "fork" into a debuggable report.
                    first = h
                    while first > 1 and (
                        la.block(first - 1).digest()
                        != lb.block(first - 1).digest()
                    ):
                        first -= 1
                    ops_a = [
                        la.block(k).payload
                        for k in range(first, min(h, first + 4) + 1)
                    ]
                    ops_b = [
                        lb.block(k).payload
                        for k in range(first, min(h, first + 4) + 1)
                    ]
                    raise InvariantViolation(
                        f"ledger fork: replicas {ia} and {ib} diverge from "
                        f"height {first} (checked at {h}: {da.hex()[:12]} vs "
                        f"{db.hex()[:12]}); executed there: "
                        f"r{ia}={ops_a} vs r{ib}={ops_b}"
                    )

    def check_ui_integrity(self) -> None:
        for i in self._correct:
            r = self._replicas[i]
            h = r.handlers
            base = h._own_log_base[0]
            counters = [
                m.ui.counter
                for m in h.message_log.snapshot()
                if isinstance(m, CERTIFIED_MESSAGES)
                and m.replica_id == r.id
                and m.ui is not None
            ]
            expect = list(range(base + 1, base + 1 + len(counters)))
            if counters != expect:
                raise InvariantViolation(
                    f"replica {r.id}: own certified log counters not "
                    f"contiguous from base {base}: {counters[:16]}..."
                )
            for peer_id, st in h.peer_states._peers.items():
                mark = st._next_cv
                key = (i, peer_id)
                prev = self._prev_marks.get(key, 0)
                if mark < prev:
                    raise InvariantViolation(
                        f"replica {r.id}: accepted-UI watermark for peer "
                        f"{peer_id} moved backwards ({prev} -> {mark})"
                    )
                self._prev_marks[key] = mark

    def check_committed_results(
        self, accepted: Iterable[Tuple[bytes, bytes]]
    ) -> None:
        for op, result in accepted:
            for i in self._correct:
                lg = self._ledgers[i]
                blocks = [
                    lg.block(height)
                    for height in range(1, lg.length + 1)
                ]
                match = [b for b in blocks if b.payload == op]
                if not match:
                    raise InvariantViolation(
                        f"replica {self._replicas[i].id}: client-accepted "
                        f"operation {op!r} missing from the ledger"
                    )
                if all(b.digest() != result for b in match):
                    raise InvariantViolation(
                        f"replica {self._replicas[i].id}: no block for "
                        f"{op!r} digests to the client-accepted result "
                        f"{result.hex()[:12]}"
                    )

    # -- the combined check -------------------------------------------

    def check(
        self, accepted: Iterable[Tuple[bytes, bytes]] = ()
    ) -> dict:
        """Run every invariant; returns a summary dict for logs/census.

        ``accepted`` is the client's view: (operation, accepted result)
        pairs for ORDERED requests that resolved (reads don't append
        blocks and are excluded by the caller)."""
        self.check_prefix_consistency()
        self.check_ui_integrity()
        accepted = list(accepted)
        self.check_committed_results(accepted)
        return {
            "correct": list(self._correct),
            "ledger_lengths": [
                self._ledgers[i].length for i in self._correct
            ],
            "accepted_checked": len(accepted),
        }


class RecoveryInvariantChecker:
    """Durable-store invariants for crash-recovery soaks.

    :class:`InvariantChecker` above reaches into in-process replica
    objects; a recovery soak runs REAL ``peer run`` processes, so its
    safety surface is what survives a SIGKILL: the on-disk durable
    stores (minbft_tpu_torch/recovery).  Checked per store and across stores:

    1. **Store self-consistency** — the committed file decodes (torn or
       tampered bytes are an InvariantViolation, mirroring the fatal
       startup refusal), carries a structurally valid f+1 certificate
       (distinct claimants, all claims matching on position + digest),
       and the persisted snapshot + watermarks RECOMPUTE to exactly the
       certified composite digest — the store can never testify to
       state it does not actually hold.
    2. **Durable monotonicity** — a replica's persisted stable count
       and USIG watermark never move backwards across repeated checks
       (i.e. across kill/restart cycles): crash-recovery must not
       un-happen progress the cluster certified.
    3. **No checkpoint fork** — any two stores claiming the same stable
       count carry the same certified digest.

    Signature VALIDITY is deliberately out of scope here (the live
    ``restore_from_store`` path re-verifies every cert signature through
    the real authenticator); this checker is the offline, between-kills
    view of the same evidence.
    """

    def __init__(self, f: int, digest_fn=None):
        self._f = f
        if digest_fn is None:
            from ..sample.requestconsumer import SimpleLedger

            digest_fn = SimpleLedger().snapshot_digest
        self._digest_fn = digest_fn
        # replica_id -> (count, usig) high-water marks across checks.
        self._prev: Dict[int, Tuple[int, int]] = {}
        # stable count -> (digest, claiming replica) across ALL checks.
        self._digests: Dict[int, Tuple[bytes, int]] = {}

    def check_store(self, path: str, replica_id: int) -> Optional[dict]:
        """Validate one replica's durable store file; returns a summary
        dict, or None when the file does not exist yet (a replica that
        has not reached its first stable checkpoint has nothing durable
        to hold to the bar)."""
        import os as _os

        from ..core.checkpoint import checkpoint_digest
        from ..recovery import CorruptStoreError, DurableStore

        if not _os.path.exists(path):
            return None
        try:
            state = DurableStore(path, replica_id).load()
        except CorruptStoreError as e:
            raise InvariantViolation(
                f"replica {replica_id}: durable store {path} is corrupt: {e}"
            ) from e
        if state is None:
            return None

        cert = state.cert
        if len(cert) < self._f + 1:
            raise InvariantViolation(
                f"replica {replica_id}: durable cert has {len(cert)} "
                f"claims, needs f+1={self._f + 1}"
            )
        claimants = {c.replica_id for c in cert}
        if len(claimants) != len(cert):
            raise InvariantViolation(
                f"replica {replica_id}: durable cert has duplicate "
                f"claimants {sorted(c.replica_id for c in cert)}"
            )
        claim = (cert[0].count, cert[0].view, cert[0].cv, cert[0].digest)
        for c in cert[1:]:
            if (c.count, c.view, c.cv, c.digest) != claim:
                raise InvariantViolation(
                    f"replica {replica_id}: durable cert claims disagree"
                )
        if claim[:3] != (state.count, state.view, state.cv):
            raise InvariantViolation(
                f"replica {replica_id}: durable position "
                f"{(state.count, state.view, state.cv)} does not match "
                f"its certificate {claim[:3]}"
            )
        composite = checkpoint_digest(
            self._digest_fn(state.app_state),
            state.count, state.view, state.cv, state.watermarks,
        )
        if composite != cert[0].digest:
            raise InvariantViolation(
                f"replica {replica_id}: persisted snapshot at count "
                f"{state.count} recomputes to {composite.hex()[:12]}, "
                f"cert says {cert[0].digest.hex()[:12]}"
            )

        prev = self._prev.get(replica_id)
        if prev is not None:
            if state.count < prev[0]:
                raise InvariantViolation(
                    f"replica {replica_id}: durable stable count moved "
                    f"backwards ({prev[0]} -> {state.count})"
                )
            if state.count == prev[0] and state.usig_counter < prev[1]:
                raise InvariantViolation(
                    f"replica {replica_id}: durable USIG watermark moved "
                    f"backwards at count {state.count} "
                    f"({prev[1]} -> {state.usig_counter})"
                )
        self._prev[replica_id] = (state.count, state.usig_counter)

        seen = self._digests.get(state.count)
        if seen is not None and seen[0] != cert[0].digest:
            raise InvariantViolation(
                f"checkpoint fork at stable count {state.count}: replica "
                f"{replica_id} certifies {cert[0].digest.hex()[:12]}, "
                f"replica {seen[1]} certified {seen[0].hex()[:12]}"
            )
        self._digests.setdefault(state.count, (cert[0].digest, replica_id))

        return {
            "replica": replica_id,
            "count": state.count,
            "view": state.view,
            "cv": state.cv,
            "usig": state.usig_counter,
            "cert": len(cert),
        }

    def check_all(self, paths: Dict[int, str]) -> dict:
        """Check every registered store; returns a per-replica summary
        (missing stores excluded)."""
        out = {}
        for replica_id, path in sorted(paths.items()):
            summary = self.check_store(path, replica_id)
            if summary is not None:
                out[replica_id] = summary
        return out
