"""USIG — Unique Sequential Identifier Generator (the trusted component).

Mirrors the reference ``usig`` package (reference usig/usig.go:28-51) and the
SGX enclave semantics (reference usig/sgx/enclave/usig.c:36-76): a per-
replica monotonic counter bound to message digests under a per-instance
epoch, such that a (digest, counter) pair can never be produced twice —
the property that lets MinBFT run with n = 2f+1 replicas and 2 rounds.

Port of :mod:`minbft_tpu.usig`.  Implementations in this slice:

- :class:`minbft_tpu_torch.usig.software.HmacUSIG` — SGX-less symmetric
  mode; a cluster-shared MAC key stands in for hardware trust.
- :class:`minbft_tpu_torch.usig.software.EcdsaUSIG` — the reference
  enclave's scheme (ECDSA-P256 over {digest, epoch, counter}); public
  verification, batched on the GPU through the engine.

The native C++ USIG comes with a later slice.
"""

from .usig import UI, USIG, UsigError, ui_from_bytes, ui_to_bytes

__all__ = ["UI", "USIG", "UsigError", "ui_from_bytes", "ui_to_bytes"]
