"""PyTorch/CUDA port of :mod:`minbft_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths: each module here is
the counterpart of the module at the same relative path there.  It imports
``torch`` and numpy, never ``jax`` and never the JAX package itself.

This slice holds the ECDSA-P256 authentication path: field arithmetic
(:mod:`.ops.limbs`), batched verify and fixed-base k·G (:mod:`.ops.p256`,
CUDA sources under ``csrc/``), the batch engine (:mod:`.parallel.engine`),
messages, USIGs and the sample authenticator.  Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"``.
"""
