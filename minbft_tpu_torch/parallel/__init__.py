"""Parallel execution layer: the asyncio↔GPU batching engine, the batch
split over several devices (``mesh``) and the engine pool (one engine per
home chip, ``pool``).

Port of :mod:`minbft_tpu.parallel` for CUDA devices.  ``dryrun`` holds
the multi-device dry run (``dryrun_multichip``).
"""

from .engine import BatchVerifier, SignStats, VerifyStats
from .pool import EnginePool

__all__ = ["BatchVerifier", "EnginePool", "SignStats", "VerifyStats"]
