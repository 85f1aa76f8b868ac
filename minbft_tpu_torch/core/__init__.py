"""Core replica protocol engine.

An asyncio re-design of the reference ``core`` package (reference
core/replica.go, core/message-handling.go): the goroutine-per-stream +
closure-graph architecture becomes asyncio tasks over async streams, with
the same layering — validators (stateless, side-effect-free), processors
(stateful, idempotent), appliers (protocol actions) — and the same internal
state machines (clientstate, peerstate, viewstate, messagelog).

The one deliberate restructuring (the BASELINE.json north star): validators
*await* batched verification futures from
:class:`minbft_tpu_torch.parallel.BatchVerifier` instead of verifying serially,
so all in-flight PREPARE/COMMIT/REQUEST authentication coalesces into
fixed-shape GPU kernel dispatches.  Stateful capture/apply stays strictly
sequential per peer (reference peerstate semantics), preserving the
protocol's exactly-once, in-counter-order guarantees.
"""

from .replica import new_replica

__all__ = ["new_replica"]
