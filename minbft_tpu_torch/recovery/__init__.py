"""Crash-recovery subsystem.

Three cooperating pieces, all optional (a replica without ``--state-dir``
behaves exactly as before):

- :mod:`minbft_tpu_torch.recovery.store` — durable stable-checkpoint store:
  atomic write-rename persistence of the f+1 checkpoint certificate, the
  application snapshot, the retire watermarks, and the USIG counter
  watermark; crash-consistent load on restart (torn writes discarded by
  digest, corrupted committed files refused loudly — never silently
  restarted fresh).
- :mod:`minbft_tpu_torch.recovery.transfer` — deterministic chunking + the
  digest-chained :class:`~minbft_tpu_torch.recovery.transfer.ChunkAssembler`
  behind the ``STATE_REQ``/``STATE_CHUNK``/``STATE_DONE`` resumable
  state-transfer messages (the ``Hello.resume_counter`` pattern
  generalized to state).
- :mod:`minbft_tpu_torch.recovery.manager` — per-replica recovery telemetry:
  phase machine, chunk/byte/resume counters, and the
  restart-to-first-executed-request ``recovery_time_ms`` clock exported
  as the ``minbft_recovery_*`` Prometheus families (obs/prom.py) and
  gated by benchgate (``chaos_recovery_time_ms``).
"""

from .manager import (
    PHASE_CATCHUP,
    PHASE_DONE,
    PHASE_FETCHING,
    PHASE_IDLE,
    PHASE_INSTALLING,
    PHASE_LOADING,
    PHASE_NAMES,
    RecoveryManager,
)
from .store import (
    STATE_DIR_ENV,
    CorruptStoreError,
    DurableStore,
    StableState,
    state_dir_from_env,
    store_path,
)
from .transfer import (
    CHUNK_BYTES_ENV,
    ChainMismatch,
    ChunkAssembler,
    chain_extend,
    chunk_bytes,
    iter_chunks,
)

__all__ = [
    "RecoveryManager",
    "PHASE_IDLE",
    "PHASE_LOADING",
    "PHASE_FETCHING",
    "PHASE_INSTALLING",
    "PHASE_CATCHUP",
    "PHASE_DONE",
    "PHASE_NAMES",
    "DurableStore",
    "StableState",
    "CorruptStoreError",
    "STATE_DIR_ENV",
    "state_dir_from_env",
    "store_path",
    "ChunkAssembler",
    "ChainMismatch",
    "chain_extend",
    "chunk_bytes",
    "iter_chunks",
    "CHUNK_BYTES_ENV",
]
