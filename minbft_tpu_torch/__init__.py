"""PyTorch/CUDA port of :mod:`minbft_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths: each module here is
the counterpart of the module at the same relative path there.  It imports
``torch`` and numpy, never ``jax`` and never the JAX package itself.

Ported so far: the ECDSA-P256 authentication path (field arithmetic
:mod:`.ops.limbs`, batched verify and fixed-base k·G :mod:`.ops.p256`),
the HMAC-SHA256 USIG path (:mod:`.ops.sha256`, :mod:`.ops.hmac_sha256`),
their CUDA sources under ``csrc/``, the batch engine
(:mod:`.parallel.engine`), messages, USIGs, the sample authenticator, and
the replica core (:mod:`.core`), client (:mod:`.client`) and in-process
transport (:mod:`.sample.conn.inprocess`), and the deployment path: the
TCP and gRPC transports, the native USIG (:mod:`.usig.native`), the
keystore, and the ``peer`` CLI (:mod:`.sample.peer`), one process per
replica; multi-group consensus on one engine (:mod:`.groups`) and the
open-loop load harness (:mod:`.loadgen`).  Entry points run on ``cuda:0``
unless the caller passes ``device="cpu"``.
"""
