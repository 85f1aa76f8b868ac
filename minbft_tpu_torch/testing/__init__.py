"""Deterministic fault injection, Byzantine adversaries, and safety
invariants: the port's copy of :mod:`minbft_tpu.testing` (its exports;
the crash-recovery soak is :mod:`~minbft_tpu_torch.testing.recovery_soak`,
imported by its callers, as in the reference).

Three modules, usable from tests AND from the ``peer selftest
--chaos-seed`` CLI smoke path:

- :mod:`~minbft_tpu_torch.testing.faultnet` — a seeded, replayable
  fault-injection layer wrapping any :class:`minbft_tpu_torch.api.ReplicaConnector`
  (in-process, TCP, and gRPC all flow through the same interface): drop,
  delay, duplicate, reorder, byte-corrupt, stream reset, half-open stall,
  partition/heal, with a scrapeable fault census;
- :mod:`~minbft_tpu_torch.testing.adversary` — Byzantine replica harnesses
  that speak real signed/certified messages through the real codec
  (equivocation, stale-UI replay, wrong-view PREPARE, counter-gap COMMIT,
  conflicting REPLYs);
- :mod:`~minbft_tpu_torch.testing.invariants` — cross-replica safety checks
  (prefix-consistent execution logs, gap-free monotonic UI sequences,
  client-accepted results present in every correct ledger), callable
  mid-run and at teardown.
"""

from .faultnet import (
    CHAOS_PLAN_ENV,
    CHAOS_SEED_ENV,
    PROFILES,
    FaultCensus,
    FaultNet,
    FaultPlan,
    FaultyConnectionHandler,
    FaultyConnector,
    ProcessChaos,
    chaos_seed,
    plan_from_spec,
)
from .invariants import (
    InvariantChecker,
    InvariantViolation,
    RecoveryInvariantChecker,
)

__all__ = [
    "CHAOS_PLAN_ENV",
    "CHAOS_SEED_ENV",
    "PROFILES",
    "FaultCensus",
    "FaultNet",
    "FaultPlan",
    "FaultyConnectionHandler",
    "FaultyConnector",
    "InvariantChecker",
    "InvariantViolation",
    "ProcessChaos",
    "RecoveryInvariantChecker",
    "chaos_seed",
    "plan_from_spec",
]
