"""Parallel execution layer: the asyncio↔GPU batching engine.

Port of :mod:`minbft_tpu.parallel` for one CUDA device.  The engine pool
and the multi-device mesh wrappers come with a later slice.
"""

from .engine import BatchVerifier, SignStats, VerifyStats

__all__ = ["BatchVerifier", "SignStats", "VerifyStats"]
