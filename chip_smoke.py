#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minbft_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the port's CUDA kernels from ``minbft_tpu_torch/csrc`` (into
``build/torch_ext/``), then runs, in order, failing at the first check
that does not hold:

1. the card's name and power limit (``nvidia-smi``), the build time and
   ``torch.version.cuda``, the host's Python, CPUs, ``yaml``, ``grpc`` and
   ``cryptography``, the native USIG's build (``g++``, ``libcrypto.so.3``,
   into ``build/native/``), every kernel instance's registers, stack frame
   and spills (``-Xptxas -v``), and, where the toolkit has ``cuobjdump``,
   the SASS instructions per thread of K5's and K6's kernels with their
   longest chain of dependent instructions;
2. K1 (field libraries, ``field_op`` test kernel) against the plain
   PyTorch field ops, every op, 4,096 random and edge elements, exact:
   mod the P-256 prime p and the Ed25519 prime 2^255 - 19 the ops
   specialised to each prime at one thread per lane and in groups of 4
   (the group's shared multiplies; mod p mul, to_mont and from_mont also
   on first operands in [p, 2^256), mod 2^255 - 19 every op on edges in
   [p, 2^256)), mod its order n the generic ops;
3. K2 (batched ECDSA-P256 verify) at B = 128 (cfg4's bucket), 512,
   16,384 and 32,768 (the bench's batch), each batch of distinct rows
   signed afresh on the card, against the plain version on every lane
   (on the adversarial lanes and an even spread at 32,768) and against
   ``hostcrypto.ecdsa_verify_py`` on every honest or plainly forged lane
   (B <= 512) or on a sample of them, adversarial lanes included, at the
   group size (threads per lane, 4 or 1) the launcher picks, and the
   other group size against those verdicts on every lane (the picked
   instance's registers and spills from ptxas, each size's device ms;
   each size picked at one checked batch at least); then K2's device ms
   before and after its redesign, side by side;
4. K3 (fixed-base k·G) at B = 128, 512, 2,048 (the bench's sign batch
   and sign-queue bucket) and 32,768 against the plain version (every
   lane up to 2,048, an even spread above; k = 1, 2, n - 1 included),
   and ``sign_batch`` signatures against ``hostcrypto.ecdsa_sign_py``,
   every group size as for K2;
5. the authentication flow — the first slice's path — at n = 4, f = 1,
   4 clients, 512 requests: client REQUEST signing (K3), REQUEST, PREPARE
   and COMMIT verification (K2), REPLY signing (K3) and client REPLY
   verification (K2), one engine per replica and per client, one forged
   lane in 64 per phase; launch counters are zeroed just before it and
   read just after;
6. K5 (SHA-256 compression, ``sha256_compress`` test kernel) against the
   plain compression on 4,096 random (state, block) pairs, and K6
   (HMAC-SHA256 verify) at B = 128, 512, 1,024 (the clusters' buckets),
   8,192 (the bench's HMAC batch) and 16,384 distinct rows against the
   plain version and Python's ``hmac`` on every lane, with forged lanes
   (one flipped bit in the mac, the key or the message) and all-zero
   padding rows; then K5's and K6's device ms before and after their
   redesign (16,384 is a batch no path sends);
7. K7 (batched Ed25519 verify) at B = 1,024, 16,384 and 32,768 (the
   bench's batch) distinct rows,
   honest lanes signed on the card, with adversarial lanes (tampered
   message, wrong key, bit-flipped R, S + L, non-canonical R with
   y >= p, undecodable public key, wrong-length signature) and all-zero
   padding rows, against the plain version on every lane (on the
   adversarial lanes and an even spread at 32,768) and against
   ``hostcrypto.ed25519_verify_py`` on a sample; K8 (fixed-base r·B) at
   B = 1,024, 2,048 and 8,192 (the bench's sign-queue bucket and sign
   batch) and 16,384, r = 0, 1 and L - 1 among the nonces, against
   the plain version bit for bit, and ``sign_batch`` signatures against
   ``hostcrypto.ed25519_sign``;
8. cluster A, the main path: an in-process MinBFT cluster (replica core,
   client, in-process transport) at n = 7, f = 3 with ECDSA-P256 client
   and replica signatures and ECDSA USIGs, one engine shared by the
   replicas and the clients, 100 clients pipelining 24 requests each,
   4,000 requests (BASELINE config 3's 10,000, cut so the smoke keeps
   inside its time);
9. cluster B: the same layout at n = 4, f = 1 with HMAC-SHA256 USIGs
   (their certificates checked by K6), 50 clients, 4,000 requests, plus
   8 REQUESTs with a flipped signature bit injected over a client stream;
10. cluster C (BASELINE config 5): n = 31, f = 15 with Ed25519 client
   and replica signatures (K7, K8) and HMAC-SHA256 USIGs (K6), one
   engine with one 1,024 bucket, 50 clients, 1,200 requests, plus 8
   forged REQUESTs; in every cluster phase every request must return,
   every replica's ledger must hold exactly the honest requests with
   equal state digests, every queue must be free of dispatch timeouts
   and host-signed lanes, no ERROR record may come from the core or the
   client, and the launch counters, zeroed just before the timed drive
   and read just after, must show the path's kernels;
11. K4 (the k·G ladder) at B = 512 and 16,384 on RFC 6979 nonces plus
   k = 1, 2, n - 1 and a random k: the signing path through it (nonces,
   K4, ``sign_finish``; its launch window) gives signatures
   byte-identical to ``sign_finish`` on K3's (X, Z) on every lane and to
   ``hostcrypto.ecdsa_sign_py`` on a sample, no lane has Z = 0, and
   (X, Z) equals the plain ladder bit for bit on at least 64 lanes, every
   group size as for K2; then K4's device ms before and after its
   redesign;
12. the multi-array forms on the packed phases' rows, at the packed
   sibling's bucket, 16,384 and the bench's batch (32,768; 8,192 for
   HMAC): K2' (eight arrays) and K7' (seven), every group size as for
   K2 and K7, give K2's and K7's verdicts on every lane and equal their
   plain versions on at least 64 lanes, the adversarial ones included,
   then K7's, K7''s and K8's device ms before and after their redesign
   for Hopper (a group of 4 threads per lane); K6' (three arrays) equals K6 and its plain version, and
   K6s (MAC generation) Python's ``hmac`` and its plain version, on every
   lane, then their device ms before and after their redesign;
13. the bench entry point, ``minbft_tpu_torch.bench.main``, in-process:
   the kernel section at its default batches (32,768), then the ``mac``
   (n = 7, 2,000 requests) and ``cfg4`` (n = 13, bucket 128, 800
   requests; a quarter of the bench's defaults, through its knobs) cluster
   configurations, one timed run each plus the traced and SLO runs, the ``ingest`` sweep (n = 4, HMAC USIGs, bucket 128,
   600 requests asked, 592 of them driven in 16 equal shares, at each of
   ``ingest_off``, ``ingest8``, ``ingest64`` and ``ingest1024``) and
   ``readonly`` (4,000 fast reads from 16 clients, host crypto); each
   must exit 0 with every self-check passed, write
   ``build/torch_bench/extras.json`` with the reference's keys for what
   it ran, commit every request with no dispatch timed out and no
   host-signed lane, log no ERROR record, and launch its path's kernels
   in its window (K6 for ``mac``; K2, K3 and K6 for ``cfg4`` and
   ``ingest``; none for ``readonly``);
14. the deployment path, one process per replica, through the ``peer``
   entry point (``python -m minbft_tpu_torch.sample.peer``) as a user
   runs it: ``testnet`` (n = 4, f = 1, NATIVE_ECDSA USIGs from the native
   module, which builds itself into ``build/native/``, 20 clients; its
   keys.yaml must name NATIVE_ECDSA), four ``run`` processes over TCP,
   each with its engine on cuda:0 and ``MINBFT_TRACE_DUMP`` set, one
   ``request`` (a 64-hex result), one ``bench`` process (20 clients x
   depth 24, 2,000 requests, its engine on cuda:0), then SIGTERM to the
   replicas; then the port bench's ``mptcp`` section (n = 7, f = 3, seven
   replica processes and one client process over TCP, 20 x 48, one run of
   1,200 requests with ``MINBFT_BENCH_RUNS=1``, plus its SLO run).  Every
   request must commit, every process exit 0 (the replicas within 60 s of
   SIGTERM), no log hold an ERROR record (the bench reads each replica's
   up to SIGTERM), no dispatch time out, every replica's and client's
   engine report (the trace dump's, the bench's) show K2 and K3 launched
   and ECDSA verify and sign batches on cuda:0, and every process report
   a CUDA context of its own; it prints req/s, latency p50/p99, each
   replica's host CPU seconds per wall second, the contexts, each
   process's allocator MiB and the device memory they took together;
15. the deployment path under chaos, with its metrics endpoint: ``peer
   selftest --chaos-seed`` (in-process, its four replicas and its client
   on one engine on cuda:0: its engine report must show K2 and K3
   launched, ECDSA verify and sign batches, no dispatch timed out and no
   host-signed lane) once, then ``testnet``
   (n = 4, NATIVE_ECDSA), four ``run`` processes over TCP with
   ``--metrics-port 0``, ``MINBFT_CHAOS_SEED`` pinned and
   ``MINBFT_CHAOS_PLAN=lossy``, engines on cuda:0, the reference's chaos
   timeouts (request 60 s, prepare 30 s), one ``bench`` of 20 x 24, 1,000
   requests; then ``metrics`` (every target, merged), ``top --once`` and
   ``slo --json`` on the live replicas, and SIGTERM, in a budget of 150
   s.  Every request must commit, every process exit 0, every replica's
   scraped engine families show verify and sign items, no scraped queue
   count exceed the replica's engine report at SIGTERM, and each
   replica's scraped fault census be non-zero and equal
   ``FaultNet.replay_counts`` of the seed over the scrape's per-link
   frames; it prints req/s and p50/p99 beside phase 14's clean testnet,
   each census and the scraped engine rows;
16. multi-group consensus on one engine: the bench's ``groups`` section
   (``bench.main(["groups"])``: n = 4, HMAC USIGs, bucket 128, G = 1, 2,
   4, 8 and 16 group cores in each replica sharing one engine and the
   clients', ``GROUPS_SWEEP_REQUESTS`` requests a group, REQUEST and REPLY
   signatures through K2 and K3, USIG certificates through K6), whose
   ``groups16_verify_mean_batch`` must exceed ``groups1_verify_mean_batch``
   (the shared queue's fill rises with G), K2, K3 and K6 launched in its
   window and every group's ledger equal on every replica; then the
   deployment path with ``GROUPS_DEPLOY`` groups: ``testnet --groups``
   (n = 4, NATIVE_ECDSA), four ``run`` processes over TCP with
   ``--metrics-port 0``, and one ``bench`` whose clients route each
   operation to its group by key, every replica scraped
   until it has executed every request (each group's label present, one
   set of engine families), then SIGTERM: every replica's ledgers line
   (each group's length and state digest) equal to the others', K2 and K3
   launched, no dispatch timed out, no ERROR record; it prints each
   point's req/s, p50/p99 and mean batches;
17. the open-loop load harness: ``python -m minbft_tpu_torch.sample.peer
   load`` as a user runs it (its default 1,000 clients over 16 sockets,
   n = 4, pairwise MACs, HMAC USIGs, ``LOAD_RATE`` arrivals/s for
   ``LOAD_DURATION_S`` s, its engine on cuda:0), at 1 and at 4 groups,
   each exiting 0 with its fired census equal to the seed's replay, K6
   launched in its process and no ERROR record; then the bench's ``load``
   section (``bench.main(["load"])``, ``LOAD_BENCH_REQUESTS`` requests a
   point: the saturation probe and the half, sat and over points), every
   census the seed's replay and K6 launched in its window; it prints the
   offered rate, goodput, p50/p99, shed and BUSY counts;
18. the crash-recovery soak on the card (``testing/recovery_soak.py``, the
   bench's ``recovery`` run): ``testnet`` (n = 4, SOFT_ECDSA USIGs, 6
   clients), four ``run`` processes over TCP with durable stores,
   ``--metrics-port 0`` and the pinned chaos seed, every replica's and the
   ``bench`` client's engine on cuda:0, 6 clients x depth 4,
   ``bench.RECOVERY_REQUESTS_CARD`` requests; replica 3 is killed with
   ``kill -9`` once its store exists and restarted against it after 0.5
   s.  Every request must commit, the restarted replica report its
   restored count and a finite recovery time, every store hold its
   invariants, every census equal the seed's replay, every engine report
   (the restarted replica's second instance and the client's included)
   show K2 and K3 launched with no dispatch timed out, one ledger digest
   on every replica that executed every request (f + 1 at least), and no
   log hold an ERROR record but those of a count that a view change the
   dropped frames set off re-certified: "checkpoint divergence" records
   whose every conflicting claim is in another view, and local snapshots
   certified in another view with the same state (counted and printed;
   ``recertified``), every wait inside a
   budget of 180 s; it prints ``restart_to_listen_ms`` apart from
   ``chaos_recovery_time_ms``, ``wall_recovery_ms``, the drain margin
   (the load left after the restarted replica's first execution), the
   goodput and the CUDA contexts, beside the card's name and power limit;
19. the batch split and the engine pool (``parallel/mesh.py``,
   ``parallel/pool.py``), rehearsed over the one card named twice
   (``REHEARSAL_DEVICES``), inside a budget of ``POOL_BUDGET_S``: the five
   sharded kernels (K2, K3, K6, K7, K8 split in two) on phases 3, 4, 6
   and 7's rows at the deployment bucket (1,024 for Ed25519), adversarial
   and padding lanes included, equal to one launch lane for lane and bit
   for bit from device and host rows, one counted launch a chunk, each
   call's ms beside one launch's; an ``EnginePool(chips=1)`` against a
   bare engine on cuda:0 over the same ECDSA, HMAC and Ed25519 verify
   items and sign items (verdicts, signatures, per-queue stats and
   launches equal); ``parallel.dryrun.dryrun_multichip`` at bucket 512
   (the split K2 and K6, an uneven-bucket mesh engine, an n = 4 grouped
   cluster of C = 2 pools, ``POOL_REQUESTS_PER_GROUP`` requests a group,
   then an oversized batch through a group's facade onto the striped
   engine), both chip engines launching K6, no dispatch timed out, no
   ERROR record, and ``collect_engine_pool`` reading 2 chips, both up;
   then the bench's ``groups_chips`` grid cut to G = 2 (C clamped to the
   visible cards), every key present, every census the seed's replay and
   K6 launched in its window;
20. one JSON line of per-kernel numbers (launches, parity, times, bounds).

Each phase's start is printed with the seconds since the smoke began.
Kernel times are CUDA-event medians: ``ms`` brackets one wrapper call
(host launch overhead included), ``device_ms`` replays the kernel
captured in a CUDA graph (the kernel alone).  Bounds count the integer
multiply-add issues each function needs on the run's inputs (``k2_imads``
and its siblings) or, for SHA-256, its ALU instructions, against the
bytes it must move.

The last line of standard output is the device JSON.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

# Published H100 SXM memory rate (NVIDIA data sheet), for the byte bound.
HBM_BYTES_PER_S = 3.35e12
# IMAD issues of the least field ops mod the P-256 prime p (K1-K4),
# counted as the functions need them: a product of two 8-word values is
# 64 32x32->64 products (36 for a square), two issues each; the Montgomery
# reduction by p needs none (-p^-1 mod 2^32 = 1, so u is the low word, and
# p's words are 0, 1 and 2^32 - 1, so u*p is shifts and adds).
P256_MUL = 2 * 64
P256_SQR = 2 * 36
# A multiply mod the group order n (K1's timed op): the reduction's u (a
# 32-bit multiply) and u*n (8 products) per word.
ORDER_MUL = 2 * 64 + 8 * (1 + 2 * 8)
# Fermat inversion mod p by the addition chain K2 runs (csrc/p256_field.cuh
# p256_inv: x^(2^32 - 1) on the way, then the runs of p - 2's bits): 255
# squarings, 12 multiplies.
P256_INV = 255 * P256_SQR + 12 * P256_MUL
# Doubling, a = -3 (dbl-2001-b): 3 multiplies, 5 squarings.  Mixed
# Jacobian + affine addition (madd-2007-bl): 7 multiplies, 4 squarings.
P256_DBL = 3 * P256_MUL + 5 * P256_SQR
P256_MADD = 7 * P256_MUL + 4 * P256_SQR
# IMAD issues of the least field ops mod m = 2^255 - 19 (K7, K8), counted
# as the functions need them; every field op returns the unique fully
# reduced value, so these give the kernels' bits.  A product of two 8-word
# values is 64 32x32->64 products (36 for a square), two issues each; the
# reduction (2^256 = 38 mod m) folds each of the 8 high columns times 38
# into its low one (a product by a small constant, two issues each) and
# the bits from 2^255 up times 19 into word 0 (one issue).
ED_REDC = 8 * 2 + 1
ED_MUL = 2 * 64 + ED_REDC
ED_SQR = 2 * 36 + ED_REDC
# A value times 38 (2^256 mod m: the map to the Montgomery domain).
ED_MUL38 = 8 * 2 + 1
# Fermat inversion by the standard addition chain for p - 2.
ED_INV = 254 * ED_SQR + 11 * ED_MUL
# Doubling (dbl-2008-hwcd): 4 squarings, 4 multiplies, 3 where no add
# follows (only an add reads T).  Complete addition (add-2008-hwcd-3) with
# the addend's y - x, y + x, 2d*t and 2z stored with it: A, B, C and
# z1*2z2, then X, Y, Z, T; z1*2z2 is z1 + z1 when the addend has Z = 1 (a
# mixed add), and T is left out where a doubling comes next (K7).  Adding
# an identity entry (0 : 1 : 1 : 0) costs its four output products, 3
# multiplies and a square.
ED_DBL = 4 * ED_SQR + 4 * ED_MUL
ED_DBL_NO_T = 4 * ED_SQR + 3 * ED_MUL
ED_ADD_XYZ = 7 * ED_MUL
ED_MADD_XYZ = 6 * ED_MUL
ED_MADD = 7 * ED_MUL
ED_ADD_IDENTITY = 3 * ED_MUL + ED_SQR
# Instructions of one SHA-256 compression (csrc/sha256.cuh) on sm_90,
# counted as the least the function needs: per round 6 SHF (the rotates
# of Sigma0 and Sigma1), 4 LOP3 (each Sigma's 3-way XOR, Ch, Maj) and 4
# IADD3 (T1 = h + K + W + Sigma1 + Ch in two, e = d + T1, a = T1 +
# Sigma0 + Maj); per schedule word 6 SHF, 2 LOP3 and 2 IADD3; 8 final
# adds.  SHF and LOP3 issue only on the ALU pipe; an add may issue there
# or as an IMAD on the FMA pipe.
SHA256_ALU_OPS = 64 * (6 + 4) + 48 * (6 + 2)
SHA256_ADD_OPS = 64 * 4 + 48 * 2 + 8
# One K6 (or K6') lane: four compressions, 16 LOP3 for the key pads, 8
# LOP3 and one ISETP for the compare with the mac; a K6s lane has no
# compare.
HMAC_ALU_OPS = 4 * SHA256_ALU_OPS + 16 + 8 + 1
HMAC_SIGN_ALU_OPS = 4 * SHA256_ALU_OPS + 16
HMAC_ADD_OPS = 4 * SHA256_ADD_OPS
# K2's device ms (CUDA-graph replay) before its redesign for Hopper, one
# thread per lane on the generic field ops: PERF.md section 6, the smoke of
# the commit before it (NVIDIA H100 80GB HBM3, 700.00 W).
K2_BEFORE_MS = {512: 9.990, 128: 9.643}
# K7's, K7''s and K8's device ms before their redesign for Hopper (one
# thread per lane on the generic field ops): PERF.md section 6, the smoke
# of the commit before it (NVIDIA H100 80GB HBM3, 700.00 W).
ED_BEFORE_MS = {
    "K7": {1024: 8.451, 16384: 8.795, 32768: 9.298},
    "K7'": {1024: 8.474, 16384: 8.720, 32768: 9.231},
    "K8": {1024: 0.489, 2048: 0.492, 8192: 0.538, 16384: 0.539},
}
# K5's, K6's, K6''s and K6s's device ms before their redesign for Hopper
# (one thread per lane, four compressions in series) and K4's (one thread
# per lane): PERF.md section 6, the smoke of the commit before it (NVIDIA
# H100 80GB HBM3, 700.00 W).  No path sends an HMAC batch above 8,192
# lanes; 16,384 is checked and timed all the same.
SHA_BEFORE_MS = {
    "K5": {4096: 0.0042},
    "K6": {128: 0.0076, 512: 0.0081, 1024: 0.0078, 8192: 0.0095, 16384: 0.0098},
    "K6'": {512: 0.0082, 8192: 0.0096, 16384: 0.0097},
    "K6s": {512: 0.0085, 8192: 0.0098, 16384: 0.0099},
}
K4_BEFORE_MS = {"K4": {512: 1.549, 16384: 1.915}}
# Requests of cluster phase A (the main path, n = 7).
CLUSTER_A_REQUESTS = 4_000
# Requests of cluster phase C (BASELINE config 5, n = 31).  Config 5
# names a sustained 100k-request stream; this is one window of the 1,200
# requests in flight (50 clients x 24), so its requests/s is fill and
# drain, not that stream's steady rate.
CLUSTER_C_REQUESTS = 1_200
# How long each cluster request may take before its phase fails.
REQUEST_TIMEOUT_S = 120.0
# Phase 13: the bench's sections that the smoke runs (the kernel section
# at its default batches, and two cluster configurations at a quarter of
# the bench's default lengths, one timed run each); the other
# configurations' paths are clusters A-C's.
BENCH_SECTIONS = ("kernels", "mac", "cfg4", "ingest", "readonly")
BENCH_REQUESTS = {"mac": 2000, "cfg4": 800}
# The ingest sweep's points and requests a point, the read-only section's
# reads and clients (the reference's defaults off the CPU).
INGEST_PREFIXES = ("ingest_off", "ingest8", "ingest64", "ingest1024")
INGEST_REQUESTS = 600
# Each of the sweep's 16 clients drives an equal share: 37 of the 600.
INGEST_COMMITTED = INGEST_REQUESTS // 16 * 16
RO_READS, RO_CLIENTS = 4000, 16


# DeviceLedger.util_keys' suffixes (obs/ledger.py), as the reference's.
UTIL_SUFFIXES = {
    "util_busy", "util_fill", "util_useful", "util_effective_per_sec",
    "util_per_device_per_sec", "util_ceiling_per_sec", "util_ceiling_source",
    "util_idle_s", "util_lanes_useful", "util_lanes_padding", "util_lanes_memo",
    "util_lanes_fallback",
}


def bench_expected_keys(section: str, points=((2, 1),)) -> set:
    """The keys the reference's bench.py emits for ``section``'s functions
    or configuration prefix (one timed run, the SLO run), less the ones it
    emits only for the TPU (``*_mode``, the compile cache, ``last_tpu``).
    The port's bench traces every configuration, so its ``_stage_`` and
    ``_critpath_`` keys are checked apart."""
    if section == "kernels":
        keys = {"backend", "device", "uvloop", "hmac_batch", "hmac_verifies_per_sec",
                "prep_batch", "ed25519_prep_batch", "ecdsa_sign_big_batch",
                "ecdsa_sign_big_per_sec"}
        for s in ("ecdsa", "ed25519"):
            keys |= {f"{s}_prep_items_per_sec", f"{s}_prep_scalar_items_per_sec",
                     f"{s}_prep_speedup", f"{s}_batch", f"{s}_ms_per_batch",
                     f"{s}_verifies_per_sec", f"{s}_compile_s", f"{s}_sign_batch",
                     f"{s}_signs_per_sec", f"{s}_sign_compile_s",
                     f"{s}_device_signs_per_sec", f"{s}_sign_queue_mean_batch",
                     f"{s}_sign_queue_compile_s", f"{s}_sign_queue_fallback"}
        return keys
    if section == "readonly":
        return {"ro_reads", "ro_clients", "ro_reads_per_sec", "ro_fast_replies"}
    if section == "ingest":
        # One _bench_cluster run a point: no repeat, traced or SLO keys.
        once = {s.split("_", 1)[1] for s in bench_expected_keys("e2e")} - {
            "req_per_sec_runs", "req_per_sec_mean", "req_per_sec_stddev",
            "req_per_sec_at_p50_500ms", "slo_depth", "slo_achieved_p50_ms",
            "slo_achieved_p99_ms"}
        return {f"{p}_{s}" for p in INGEST_PREFIXES for s in once}
    if section == "groups":
        # _bench_groups_cluster's and bench_groups' keys at every G (the
        # saturation timeline only when the sampler ticked in the run).
        per = {"n", "f", "requests", "clients", "committed_req_per_sec",
               "request_latency_p50_ms", "verify_mean_batch", "verify_batches",
               "device_verifies_per_sec", "queue_depth_peak", "req_per_sec_runs",
               "req_per_sec_mean", "req_per_sec_stddev"} | UTIL_SUFFIXES
        return {f"groups{G}_{s}" for G in (1, 2, 4, 8, 16) for s in per} | {
            "groups_sweep_Gs", "groups_sweep_per_group_requests"}
    if section == "load":
        per = {"offered_per_sec", "goodput_per_sec", "p50_ms", "p99_ms", "send_p99_ms",
               "finality_p99_ms", "slo_good_fraction", "timeouts", "census_ok",
               "busy_received", "shed", "busy_sent", "rx_peak"}
        return {f"load_{t}_{s}" for t in ("half", "sat", "over") for s in per} | {
            "load_seed", "load_clients", "load_requests_per_point",
            "load_burst_peak_per_sec", "load_probe_offered_per_sec",
            "load_probe_census_ok", "load_probe_goodput_per_sec", "load_probe_shed",
            "load_probe_busy_sent", "load_probe_busy_received", "load_probe_timeouts",
            "load_probe_rx_peak", "load_peak_per_sec", "load_over_goodput_fraction"}
    if section == "groups_chips":
        # bench_groups_chips' keys at each (G, C) point of ``points``:
        # every chip of a point holds groups when G >= C.
        keys = {"groups_chips_grid_Gs", "groups_chips_grid_chips",
                "groups_chips_requested_chips", "groups_chips_devices_visible"}
        run = {"offered_per_sec", "goodput_per_sec", "p50_ms", "p99_ms", "finality_p99_ms",
               "slo_good_fraction", "census_ok", "shed", "busy_sent"}
        chip = {"util_busy", "util_fill", "util_lanes_useful", "util_lanes_padding",
                "util_lanes_memo", "util_lanes_fallback"}
        for G, C in points:
            p = f"groups{G}x{C}"
            keys |= {f"{p}_load_burst_peak_per_sec", f"{p}_chips", f"{p}_placement",
                     f"{p}_verify_mean_batch"}
            keys |= {f"{p}_load_{t}_{s}" for t in ("sat", "over") for s in run}
            keys |= {f"{p}_{s}" for s in UTIL_SUFFIXES}
            keys |= {f"{p}_chip{c}_{s}" for c in range(min(G, C)) for s in chip}
        return keys
    if section in ("mp", "mptcp"):
        # _bench_mp_cluster's keys and _bench_mp_repeated's.
        suffixes = {
            "n", "f", "requests", "clients", "client_procs", "depth",
            "committed_req_per_sec", "request_latency_p50_ms",
            "request_latency_p99_ms", "req_per_sec_runs", "req_per_sec_mean",
            "req_per_sec_stddev", "req_per_sec_at_p50_500ms", "slo_depth",
            "slo_achieved_p50_ms", "slo_achieved_p99_ms",
        }
        return {f"{section}_{s}" for s in suffixes}
    suffixes = {
        "request_latency_p50_ms", "request_latency_p99_ms", "exec_latency_p50_ms",
        "exec_latency_p99_ms", "messages_handled", "messages_dropped", "n", "f",
        "clients", "requests", "committed_req_per_sec", "ingest_batch_mean",
        "ingest_ticks_per_sec", "batched_verifies", "batches", "mean_batch",
        "device_verifies_per_sec", "logical_verifies", "memo_hits",
        "hmac_sha256_prep_share", "queue_depth_peak", "timeline", "req_per_sec_runs",
        "req_per_sec_mean", "req_per_sec_stddev", "req_per_sec_at_p50_500ms",
        "slo_depth", "slo_achieved_p50_ms", "slo_achieved_p99_ms",
    } | UTIL_SUFFIXES
    if section != "mac":  # signatures: the ECDSA verify and sign queues
        suffixes |= {"ecdsa_p256_prep_share", "device_signs_per_sec", "sign_share",
                     "sign_fallback_items", "queue_signs", "sign_prep_share"}
    return {f"{section}_{s}" for s in suffixes}


def int_mix(alu_ops: float, add_ops: float) -> float:
    """Issue slots, at 64 lanes per SM per clock, of a 32-bit integer mix
    of ALU-only instructions (SHF, LOP3: the ALU pipe, 64 lanes per SM
    per clock on sm_90) and adds (the ALU pipe or IMAD on the FMA pipe):
    the ALU pipe's share, or the whole mix at the SM's dispatch rate of
    128 lanes per clock, whichever is longer."""
    return max(alu_ops, (alu_ops + add_ops) / 2)


def _bits(limb_rows) -> "np.ndarray":
    """[lanes, 16] u16 limbs -> [lanes, 256] bits, index j = bit j."""
    import numpy as np

    scalar = np.ascontiguousarray(limb_rows).astype("<u2")
    return np.unpackbits(scalar.view(np.uint8), axis=1, bitorder="little")


def _ladder_counts(nonzero) -> tuple:
    """For [lanes, positions] nonzero digits of a top-down ladder: the
    doublings (one per position below a lane's top nonzero digit) and the
    adds (one per nonzero digit below it), summed over the lanes; the
    top digit's entry is loaded, not added, and an all-zero lane needs
    neither."""
    import numpy as np

    has = nonzero.any(axis=1)
    top = nonzero.shape[1] - 1 - np.argmax(nonzero[:, ::-1], axis=1)
    dbls = int(np.where(has, top, 0).sum())
    adds = int(np.where(has, nonzero.sum(axis=1) - 1, 0).sum())
    return dbls, adds


def k2_imads(rows: "np.ndarray") -> int:
    """IMAD issues that K2's (and K2''s) function needs on these [B, 98]
    packed rows, summed over the lanes.  A lane with valid = 0 needs none
    (its verdict is false).  A valid lane: Q into the Montgomery domain
    (2 multiplies); G + Q from the two affine points (4 multiplies, 2
    squarings) made affine by one inversion, a squaring and 3 multiplies;
    from the top nonzero digit 2*bit(u1) + bit(u2) down, a doubling per
    lower bit and a mixed add of Q, G or G + Q per nonzero digit; the
    check X == r*Z^2 (a squaring, r into the domain, a multiply), and the
    same for r2 where r2_ok is set."""
    from minbft_tpu_torch.ops import p256

    live = rows[rows[:, p256.PACKED_COLS - 1] != 0]
    if not len(live):
        return 0
    digit = 2 * _bits(live[:, 32:48]).astype(int) + _bits(live[:, 48:64])
    dbls, adds = _ladder_counts(digit != 0)
    per_lane = (2 * P256_MUL + 4 * P256_MUL + 2 * P256_SQR + P256_INV + P256_SQR
                + 3 * P256_MUL + P256_SQR + 2 * P256_MUL)
    r2 = int((live[:, 96] != 0).sum()) * 2 * P256_MUL
    return len(live) * per_lane + r2 + dbls * P256_DBL + adds * P256_MADD


def k3_imads(k: "np.ndarray") -> int:
    """IMAD issues that K3's function needs on these [B, 16] nonce limbs:
    a mixed add of a table row per nonzero nibble window after a lane's
    first nonzero one (whose row is loaded); zero windows need nothing."""
    import numpy as np

    nib = (k.astype(np.int64)[:, :, None] >> np.array([0, 4, 8, 12])) & 0xF
    nonzero = nib.reshape(len(k), 64) != 0
    return int(np.maximum(nonzero.sum(axis=1) - 1, 0).sum()) * P256_MADD


def k4_imads(k: "np.ndarray") -> int:
    """IMAD issues that K4's function needs on these [B, 16] nonce limbs:
    from a lane's top 1-bit down, a doubling per lower bit and a mixed add
    of G per 1-bit."""
    dbls, adds = _ladder_counts(_bits(k) != 0)
    return dbls * P256_DBL + adds * P256_MADD


def k7_imads(rows: np.ndarray) -> int:
    """IMAD issues that K7's (and K7''s) function needs on these [B, 82]
    packed rows, summed over the lanes.  A lane with valid = 0 needs none
    (its verdict is false).  A valid lane: 10 multiplies of setup (T of
    A', B + A' as a mixed add, 2d*t of A' and of B + A'); from the top
    nonzero digit 2*bit(u1) + bit(u2) down, that digit's entry is loaded
    and every lower bit costs a doubling plus, for a nonzero digit, an add
    of A' or B (mixed) or B + A' (general), neither computing T; then the
    inversion and x*zi, y*zi (the values are plain residues: no map out
    of a Montgomery domain)."""
    import numpy as np

    from minbft_tpu_torch.ops import ed25519, limbs

    nl = limbs.NLIMBS
    live = rows[rows[:, ed25519.PACKED_COLS - 1] != 0]
    if not len(live):
        return 0
    u1, u2 = live[:, 2 * nl : 3 * nl], live[:, 3 * nl : 4 * nl]
    digit = 2 * _bits(u1).astype(np.int64) + _bits(u2)
    nonzero = digit != 0
    has = nonzero.any(axis=1)
    top = 255 - np.argmax(nonzero[:, ::-1], axis=1)
    top_digit = digit[np.arange(len(live)), top]
    general = (digit == 3).sum(axis=1) - (top_digit == 3)
    mixed = nonzero.sum(axis=1) - general - 1
    dbls = int(np.where(has, top, 0).sum())
    general = int(np.where(has, general, 0).sum())
    mixed = int(np.where(has, mixed, 0).sum())
    adds = general + mixed
    per_lane = 10 * ED_MUL + ED_INV + 2 * ED_MUL
    return (len(live) * per_lane + adds * ED_DBL + (dbls - adds) * ED_DBL_NO_T
            + mixed * ED_MADD_XYZ + general * ED_ADD_XYZ)


def k8_imads(r: np.ndarray) -> int:
    """IMAD issues that K8's function needs on these [B, 16] nonce limbs,
    summed over the lanes: the first window's add onto the identity needs
    one multiply (T) for a nonzero nibble and none for zero; each later
    window a mixed add of its table row (y - x, y + x, 2d*t; Z = 1), or the
    identity's cheaper add for a zero nibble, the last window's without T;
    then X, Y, Z times 38 into the Montgomery domain."""
    import numpy as np

    nib = (r.astype(np.int64)[:, :, None] >> np.array([0, 4, 8, 12])) & 0xF
    nib = nib.reshape(len(r), 64)
    zero_mid = int((nib[:, 1:63] == 0).sum())
    zero_last = int((nib[:, 63] == 0).sum())
    return (int((nib[:, 0] != 0).sum()) * ED_MUL
            + (nib[:, 1:63].size - zero_mid) * ED_MADD + zero_mid * ED_ADD_IDENTITY
            + (len(r) - zero_last) * ED_MADD_XYZ
            + zero_last * (ED_ADD_IDENTITY - ED_MUL)
            + len(r) * 3 * ED_MUL38)


def spread(bsz: int, must) -> list:
    """The lanes ``must`` plus an even spread, at least 64 in all."""
    return sorted(set(must) | set(range(3, bsz, max(1, bsz // 64))))


def kernel_entry(runs: dict, main: int, plain_ms: float, max_abs_err: int = 0,
                 groups: dict = None) -> dict:
    """A kernel's numbers for the kernels line from ``runs`` ({batch: (ms,
    device ms, bound ms, bound by)}): those at ``main``, its deployment
    bucket, and, under ``other``, those at every other batch it ran; with
    ``groups`` ({batch: (picked group size, {size: device ms})}), the
    group size the launcher picked and each size's device ms per batch."""
    ms, dev_ms, b_ms, b_by = runs[main]
    entry = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 max_abs_err=max_abs_err,
                 other={b: r for b, r in runs.items() if b != main})
    if groups:
        entry["group"] = {b: g for b, (g, _) in groups.items()}
        entry["device_ms_by_group"] = {b: by for b, (_, by) in groups.items()}
    return entry


def before_after(kernels: dict, before: dict) -> str:
    """'was / now (factor)' of each kernel's device ms at each batch of
    ``before`` ({kernel: {batch: ms before}}), from the kernels line's
    entries."""
    parts = []
    for kid, by_b in before.items():
        k = kernels[kid]
        for b, was in by_b.items():
            now = k["other"][b][1] if b in k.get("other", {}) else k["device_ms"]
            parts.append(f"{kid} B={b}: {was:.4f} / {now:.4f} ({was / now:.2f}x)")
    return "; ".join(parts)


def ptxas_kernels(log: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel entry (mangled): (registers, stack
    frame bytes, spill store bytes, spill load bytes)}."""
    out, entry, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)),) + frame
            entry = None
    return out


def sass_profile(lib: str) -> dict:
    """``cuobjdump -sass`` of a built library -> {kernel entry (mangled):
    (instructions, SHF + LOP3 (the ALU pipe only), IADD3, IMAD, the longest
    chain of dependent instructions)}: a per-lane instruction count of a
    straight-line kernel and the depth of its critical path, read from the
    code the card runs.  Empty where the toolkit has no cuobjdump."""
    from collections import Counter, defaultdict

    from minbft_tpu_torch.ops import backend

    tool = os.path.join(os.path.dirname(backend._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    reg = re.compile(r"(?<![A-Za-z])(U?R\d+|P\d)(\.64)?")

    def regs(operand):
        out = []
        for m in reg.finditer(operand):
            out.append(m.group(1))
            if m.group(2):  # a register pair
                pre = m.group(1).rstrip("0123456789")
                out.append(pre + str(int(m.group(1)[len(pre):]) + 1))
        return out

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(\S+)\s*(.*?);", line)
        if m and cur is not None:
            cur.append((m.group(1).split(".")[0], [o.strip() for o in m.group(2).split(",")]))
    out = {}
    for name, ins in funcs.items():
        count = Counter(op for op, _ in ins)
        depth, chain = defaultdict(int), 0
        for op, ops in ins:
            if op in ("ST", "STG", "STS", "BRA", "EXIT", "BAR", "RET", "NOP", "BSSY",
                      "BSYNC", "WARPSYNC") or not ops[0]:
                continue
            nd = 2 if op in ("ISETP", "SHFL") else 1  # predicate and value outputs
            d = 1 + max([depth[r] for o in ops[nd:] for r in regs(o)] + [0])
            for o in ops[:nd]:
                for r in regs(o):
                    depth[r] = d
            chain = max(chain, d)
        out[name] = (len(ins), count["SHF"] + count["LOP3"], count["IADD3"],
                     count["IMAD"], chain)
    return out


def regs_phrase(regs: int, frame: int, st: int, ld: int) -> str:
    return (f"{regs} registers, {frame}-byte frame, {st} / {ld} bytes of spill "
            "stores / loads")


def kernel_regs(kernels: dict, name: str, group: int) -> str:
    """The registers, stack frame and spills of ``name``'s instance for
    ``group`` threads per lane (its template argument), as one printable
    phrase."""
    for entry, report in kernels.items():
        if f"{name}ILi{group}E" in entry:
            return regs_phrase(*report)
    return "not in the ptxas report"


def demangle(names) -> dict:
    """Mangled kernel names -> readable ones (``c++filt`` where the
    machine has it, else the names as they are)."""
    names = list(names)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = names
    return dict(zip(names, out if len(out) == len(names) else names))


def module_version(name: str) -> str:
    """A Python module's version, or "absent"."""
    import importlib

    try:
        return getattr(importlib.import_module(name), "__version__", "?")
    except ImportError:
        return "absent"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events, warm)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, copies: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn`` call in ms: ``copies`` calls captured in
    one CUDA graph, replayed between two CUDA events (median of
    ``reps``), over ``copies``.  Unlike :func:`cuda_ms`, whose events
    bracket the Python wrapper (argument checks, allocation, the ctypes
    launch), this leaves out the host's launch overhead, which is longer
    than a small kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / copies)
    return statistics.median(times)


class Rng:
    """Seeded stand-in for ``secrets`` (hostcrypto.keygen's rng)."""

    def __init__(self, seed: int):
        import random

        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)

    def bytes(self, k: int) -> bytes:
        return bytes(self._r.randrange(256) for _ in range(k))


# ---------------------------------------------------------------------------
# Phase 5: the authentication flow (also driven on the CPU by
# tests/test_torch_slice.py at a small size).


def _forged(tag: bytes) -> bytes:
    """The tag with its last byte flipped (the low byte of s, or of a UI
    certificate's s)."""
    return tag[:-1] + bytes([tag[-1] ^ 0x01])


def _forge_lanes(n: int, every: int) -> set:
    """Indices of the forged copies: one per ``every`` honest lanes, at
    least one."""
    return set(range(0, n, every))


async def run_auth_flow(
    replica_auths,
    client_auths,
    n_requests: int,
    prepare_size: int,
    f: int,
    forge_every: int = 64,
) -> dict:
    """Drive the protocol's authentication traffic through the port's
    authenticators and return the per-phase verdict counts.

    Each phase verifies every honest message plus one forged copy (last
    tag byte flipped) per ``forge_every`` honest lanes; the result holds,
    per phase, the number of honest lanes, forged lanes, honest lanes
    rejected and forged lanes accepted — the latter two must be 0."""
    from minbft_tpu_torch import api
    from minbft_tpu_torch.messages import UI, Commit, Prepare, Reply, Request
    from minbft_tpu_torch.messages import authen_bytes

    CLIENT, REPLICA, USIG = (
        api.AuthenticationRole.CLIENT,
        api.AuthenticationRole.REPLICA,
        api.AuthenticationRole.USIG,
    )
    n = len(replica_auths)
    n_clients = len(client_auths)
    phases = {}
    # Host wall time of each step, in flow order (the steps run one
    # after another; within a step the work is concurrent).
    step_s = {}
    t_step = [time.perf_counter()]

    def step_done(name):
        now = time.perf_counter()
        step_s[name] = now - t_step[0]
        t_step[0] = now

    def tally(name, honest_errs, forged_errs):
        phases[name] = {
            "honest": len(honest_errs),
            "forged": len(forged_errs),
            "honest_rejected": sum(e is not None for e in honest_errs),
            "forged_accepted": sum(e is None for e in forged_errs),
        }

    async def outcome(coro):
        try:
            await coro
        except api.AuthenticationError as e:
            return e
        return None

    # 1. Clients sign their REQUESTs through their engines' sign queues.
    reqs = [
        Request(client_id=i % n_clients, seq=i // n_clients + 1,
                operation=b"op-%d" % i)
        for i in range(n_requests)
    ]
    sigs = await asyncio.gather(*[
        client_auths[r.client_id].generate_message_authen_tag_async(
            CLIENT, authen_bytes(r)
        )
        for r in reqs
    ])
    for r, s in zip(reqs, sigs):
        r.signature = s
    step_done("client_sign")

    # 2. Every replica verifies every REQUEST, one call per PREPARE-sized
    #    bundle (the bundle-ingest surface).
    forged_req = _forge_lanes(n_requests, forge_every)

    async def verify_requests(auth):
        lanes = [(r.client_id, authen_bytes(r), r.signature) for r in reqs]
        lanes += [
            (reqs[i].client_id, authen_bytes(reqs[i]), _forged(reqs[i].signature))
            for i in sorted(forged_req)
        ]
        bundles = [
            lanes[k : k + prepare_size] for k in range(0, len(lanes), prepare_size)
        ]
        outs = await asyncio.gather(*[
            auth.verify_message_authen_tags(CLIENT, b) for b in bundles
        ])
        return [e for out in outs for e in out]

    per_replica = await asyncio.gather(*[verify_requests(a) for a in replica_auths])
    honest, forged = [], []
    for errs in per_replica:
        honest += errs[:n_requests]
        forged += errs[n_requests:]
    tally("request", honest, forged)
    step_done("request_verify")

    # 3. The primary orders the requests: one PREPARE per prepare_size
    #    requests, each with a USIG UI (host-signed, counter order).
    primary = replica_auths[0]
    prepares = []
    for k in range(0, n_requests, prepare_size):
        prep = Prepare(replica_id=0, view=0, requests=reqs[k : k + prepare_size])
        prep.ui = UI.from_bytes(
            primary.generate_message_authen_tag(USIG, authen_bytes(prep))
        )
        prepares.append(prep)
    step_done("prepare_usig_sign")

    # 4. Every backup verifies every PREPARE's UI.
    backups = list(range(1, n))
    lanes = [(b, p) for p in prepares for b in backups]
    forged_prep = _forge_lanes(len(lanes), forge_every)
    honest = await asyncio.gather(*[
        outcome(replica_auths[b].verify_message_authen_tag(
            USIG, 0, authen_bytes(p), p.ui.to_bytes()))
        for b, p in lanes
    ])
    forged = await asyncio.gather(*[
        outcome(replica_auths[lanes[i][0]].verify_message_authen_tag(
            USIG, 0, authen_bytes(lanes[i][1]), _forged(lanes[i][1].ui.to_bytes())))
        for i in sorted(forged_prep)
    ])
    tally("prepare", list(honest), list(forged))
    prep_errs = list(honest)
    step_done("prepare_verify")

    # 5. Every backup COMMITs every PREPARE (USIG UI, host-signed); every
    #    other replica verifies each COMMIT's UI.
    commits = []
    for b in backups:
        for p in prepares:
            c = Commit(replica_id=b, prepare=p)
            c.ui = UI.from_bytes(
                replica_auths[b].generate_message_authen_tag(USIG, authen_bytes(c))
            )
            commits.append(c)
    step_done("commit_usig_sign")
    lanes = [(v, c) for c in commits for v in range(n) if v != c.replica_id]
    forged_commit = _forge_lanes(len(lanes), forge_every)
    honest = await asyncio.gather(*[
        outcome(replica_auths[v].verify_message_authen_tag(
            USIG, c.replica_id, authen_bytes(c), c.ui.to_bytes()))
        for v, c in lanes
    ])
    forged = await asyncio.gather(*[
        outcome(replica_auths[lanes[i][0]].verify_message_authen_tag(
            USIG, lanes[i][1].replica_id, authen_bytes(lanes[i][1]),
            _forged(lanes[i][1].ui.to_bytes())))
        for i in sorted(forged_commit)
    ])
    tally("commit", list(honest), list(forged))
    step_done("commit_verify")
    # A replica commits a PREPARE on f+1 certificates it accepted: the
    # primary's UI plus valid backup COMMITs; the REPLY goes out for
    # PREPAREs committed at every replica.
    prep_ok = {}
    for (b, p), e in zip([(b, p) for p in prepares for b in backups], prep_errs):
        prep_ok[(b, id(p))] = e is None
    committed = []
    for p in prepares:
        ok_everywhere = True
        for v in range(n):
            certs = 1 if v == 0 else int(prep_ok[(v, id(p))])
            certs += sum(
                1 for (w, c), e in zip(lanes, honest)
                if w == v and c.prepare is p and e is None
            )
            ok_everywhere &= certs >= f + 1
        if ok_everywhere:
            committed.append(p)

    # 6. Every replica signs one REPLY per committed request (sign queue).
    replies = [
        Reply(replica_id=rid, client_id=r.client_id, seq=r.seq,
              result=hashlib.sha256(r.operation).digest())
        for p in committed for r in p.requests for rid in range(n)
    ]
    sigs = await asyncio.gather(*[
        replica_auths[rp.replica_id].generate_message_authen_tag_async(
            REPLICA, authen_bytes(rp)
        )
        for rp in replies
    ])
    for rp, s in zip(replies, sigs):
        rp.signature = s
    step_done("reply_sign")

    # 7. Each client verifies its replies through its engine (one bundle)
    #    and accepts a request on f+1 matching valid replies.
    accepted = 0
    honest, forged = [], []
    for cid in range(n_clients):
        mine = [rp for rp in replies if rp.client_id == cid]
        fidx = sorted(_forge_lanes(len(mine), forge_every))
        lanes = [(rp.replica_id, authen_bytes(rp), rp.signature) for rp in mine]
        lanes += [
            (mine[i].replica_id, authen_bytes(mine[i]), _forged(mine[i].signature))
            for i in fidx
        ]
        errs = await client_auths[cid].verify_message_authen_tags(REPLICA, lanes)
        honest += errs[: len(mine)]
        forged += errs[len(mine):]
        votes = {}
        for rp, e in zip(mine, errs):
            if e is None:
                votes.setdefault((rp.seq, rp.result), set()).add(rp.replica_id)
        accepted += sum(1 for v in votes.values() if len(v) >= f + 1)
    tally("reply", honest, forged)
    step_done("reply_verify")
    return {"phases": phases, "committed_requests": accepted, "step_s": step_s}


def check_flow(result: dict, n_requests: int) -> None:
    for name, ph in result["phases"].items():
        check(ph["honest_rejected"] == 0, f"flow {name}: honest lanes rejected {ph}")
        check(ph["forged_accepted"] == 0, f"flow {name}: forged lanes accepted {ph}")
        check(ph["forged"] >= 1, f"flow {name}: no forged lane")
    check(
        result["committed_requests"] == n_requests,
        f"flow: {result['committed_requests']} of {n_requests} requests accepted",
    )


# ---------------------------------------------------------------------------
# Phases 8-10: an in-process cluster committing requests (also driven on
# the CPU by tests/test_torch_cluster.py at a small size).


class _ErrorRecords(logging.Handler):
    """Keeps every ERROR-or-worse record of the core (``minbft.replica<i>``)
    and the client (``minbft_tpu_torch.*``) while installed on the root
    logger: a batched REPLY signature that failed (the core then loses
    that REPLY) logs one, as does any engine error the core swallows."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record):
        if record.name.startswith("minbft"):
            self.records.append(f"{record.name}: {record.getMessage()}")

    def __enter__(self):
        logging.getLogger().addHandler(self)
        return self.records

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self)


def _quantile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


async def run_cluster(
    keys: dict,
    f: int,
    engine,
    n_clients: int,
    depth: int,
    n_requests: int,
    window: tuple,
    forged: int = 0,
) -> dict:
    """Commit ``n_requests`` no-op requests through an in-process cluster
    of the port: n = ``keys["n"]`` replicas (replica core, SimpleLedger)
    and ``n_clients`` clients on in-process stubs, every authenticator on
    the one ``engine`` (the layout of bench.py ``_bench_cluster``).  Each
    client pipelines ``depth`` requests at a time, each awaited within
    ``REQUEST_TIMEOUT_S``.  With ``forged`` > 0, that many REQUESTs from
    client id ``n_clients`` (a key with no running client), signed
    through the engine and then given a flipped signature bit, are
    injected over a client stream into every replica during the drive.

    ``window`` is (reset, read): called just before and just after the
    timed drive; what ``read`` returns is the result's ``window``."""
    from minbft_tpu_torch import api
    from minbft_tpu_torch.client import new_client
    from minbft_tpu_torch.core import new_replica
    from minbft_tpu_torch.messages import Request, authen_bytes, marshal
    from minbft_tpu_torch.sample.authentication import authenticators_from_keys
    from minbft_tpu_torch.sample.config import SimpleConfiger
    from minbft_tpu_torch.sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from minbft_tpu_torch.sample.requestconsumer import SimpleLedger

    n = keys["n"]
    r_auths, c_auths = authenticators_from_keys(keys, engine=engine, client_engine=engine)
    cfg = SimpleConfiger(n=n, f=f, timeout_request=900.0, timeout_prepare=450.0,
                         batchsize_prepare=256)
    stubs = make_testnet_stubs(n)
    ledgers = [SimpleLedger() for _ in range(n)]
    replicas = []
    with _ErrorRecords() as error_records:
        for i in range(n):
            r = new_replica(i, cfg, r_auths[i], InProcessPeerConnector(stubs), ledgers[i])
            stubs[i].assign_replica(r)
            replicas.append(r)
        for r in replicas:
            await r.start()
        clients = []
        for c in range(n_clients):
            cl = new_client(c, n, f, c_auths[c], InProcessClientConnector(stubs),
                            seq_start=0, retransmit_interval=30.0)
            await cl.start()
            clients.append(cl)

        bad = [Request(client_id=n_clients, seq=k + 1, operation=b"forged-%d" % k)
               for k in range(forged)]
        for req in bad:
            tag = await c_auths[n_clients].generate_message_authen_tag_async(
                api.AuthenticationRole.CLIENT, authen_bytes(req))
            req.signature = _forged(tag)
        stop_injecting = asyncio.Event()

        async def inject(i):
            async def frames():
                for req in bad:
                    yield marshal(req)
                await stop_injecting.wait()

            out = []
            handler = stubs[i].client_message_stream_handler()
            async for data in handler.handle_message_stream(frames()):
                out.append(data)
            return out

        per_client = n_requests // n_clients
        latencies = []
        results = {}

        async def timed(cl, k):
            t = time.perf_counter()
            results[k] = await asyncio.wait_for(cl.request(b"op-%d" % k), REQUEST_TIMEOUT_S)
            latencies.append(time.perf_counter() - t)

        async def drive(c, cl):
            base = c * per_client
            for k0 in range(0, per_client, depth):
                await asyncio.gather(*[
                    timed(cl, base + k)
                    for k in range(k0, min(k0 + depth, per_client))
                ])

        window[0]()
        t0, cpu0 = time.perf_counter(), time.process_time()
        injectors = [asyncio.ensure_future(inject(i)) for i in range(n)] if bad else []
        await asyncio.gather(*[drive(c, cl) for c, cl in enumerate(clients)])
        wall = time.perf_counter() - t0
        host_cpu = time.process_time() - cpu0
        in_window = window[1]()

        # Every request has its f+1 replies; wait (bounded) until every
        # replica has executed all of them.
        honest = per_client * n_clients
        deadline = time.monotonic() + REQUEST_TIMEOUT_S
        while (any(led.length < honest for led in ledgers)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        stop_injecting.set()
        injected_out = []
        for t in injectors:
            try:
                injected_out += await asyncio.wait_for(t, 5.0)
            except asyncio.TimeoutError:
                pass
        for cl in clients:
            await cl.stop()
        for r in replicas:
            await r.stop()
    return {
        "n": n, "f": f, "clients": n_clients, "depth": depth,
        "requests": honest, "returned": len(results), "forged": forged,
        "wall_s": wall,
        # CPU seconds of every thread of this process during the drive:
        # near 1 per wall second means the interpreter lock sets the pace.
        "host_cpu_s": host_cpu,
        "committed_per_s": len(results) / wall,
        "latency_p50_ms": _quantile(latencies, 0.50) * 1e3,
        "latency_p99_ms": _quantile(latencies, 0.99) * 1e3,
        "ledger_lengths": [led.length for led in ledgers],
        "state_digests": [led.state_digest().hex() for led in ledgers],
        "ledger_ops": [
            {led.block(h).payload for h in range(1, led.length + 1)} for led in ledgers
        ],
        "dropped": [r.metrics.counters.get("messages_dropped", 0) for r in replicas],
        "replies_to_forged": len(injected_out),
        "error_records": list(error_records),
        "window": in_window,
    }


def check_cluster(result: dict, label: str) -> None:
    honest = result["requests"]
    check(result["returned"] == honest,
          f"{label}: {result['returned']} of {honest} requests returned")
    check(all(x == honest for x in result["ledger_lengths"]),
          f"{label}: ledger lengths {result['ledger_lengths']} != {honest}")
    check(len(set(result["state_digests"])) == 1,
          f"{label}: state digests differ {result['state_digests']}")
    expected = {b"op-%d" % k for k in range(honest)}
    for ops in result["ledger_ops"]:
        check(ops == expected, f"{label}: a ledger's operations are not the honest requests")
    if result["forged"]:
        check(result["replies_to_forged"] == 0, f"{label}: a forged request was answered")
        check(all(d >= result["forged"] for d in result["dropped"]),
              f"{label}: forged requests not rejected by every replica {result['dropped']}")
    check(not result["error_records"],
          f"{label}: ERROR records from the core or client: {result['error_records'][:5]}")


def check_engine(engine, label: str) -> list:
    """No queue of ``engine`` timed out or signed on the host; returns one
    printable line per queue."""
    lines = []
    for qname, st in list(engine.stats.items()) + [
        ("sign_" + k, v) for k, v in engine.sign_stats.items()
    ]:
        fb = getattr(st, "host_fallback_items", 0)
        check(fb == 0 and st.dispatch_timeouts == 0,
              f"{label} {qname}: host fallback {fb}, timeouts {st.dispatch_timeouts}")
        share = st.host_prep_time_s / st.device_time_s if st.device_time_s else 0.0
        lines.append(
            f"  {label} {qname}: items {st.items} batches {st.batches} "
            f"mean_batch {st.mean_batch:.1f} memo_hits {getattr(st, 'memo_hits', 0)} "
            f"host-prep share {share:.3f}"
        )
    return lines


# ---------------------------------------------------------------------------
# Phase 14: the deployment path, one process per replica (``peer``).
DEPLOY_N = 4
DEPLOY_CLIENTS = 20
DEPLOY_DEPTH = 24
DEPLOY_REQUESTS = 2000
# The bench's mptcp run (n = 7, f = 3): one run of this many requests
# (the reference's default is the e2e count, 10,000).
MPTCP_REQUESTS = 1200


# Phase 15: the same path under chaos, with the metrics endpoint.
CHAOS_REQUESTS = 1000
# The pinned replay token of the fault schedule (a public seed, not key
# material) and the plan every replica's outbound links run.
CHAOS_SEED = 0x5EED15
CHAOS_PLAN = "lossy"
# Each run's own budget: the scaffold, the drive, the scrapes and the stop.
DEPLOY_BUDGET_S = 900.0
CHAOS_BUDGET_S = 150.0
# Phase 14's timeouts keep a slow first batch from turning into a view
# change; the reference's chaos-run timeouts (testing/recovery_soak.py)
# let a frame the plan drops be retransmitted, or its request time out
# into a view change, inside the chaos budget.
DEPLOY_TIMEOUTS = {"CONSENSUS_TIMEOUT_REQUEST": "600s",
                   "CONSENSUS_TIMEOUT_PREPARE": "300s",
                   "CONSENSUS_TIMEOUT_VIEWCHANGE": "600s"}
CHAOS_TIMEOUTS = {"CONSENSUS_TIMEOUT_REQUEST": "60s",
                  "CONSENSUS_TIMEOUT_PREPARE": "30s"}


# Phase 16: multi-group consensus.  The bench's groups sweep at this many
# requests a group (the reference's default: 400), then the deployment
# path with this many groups in every replica process and this many
# requests across them.
GROUPS_SWEEP_REQUESTS = 120
GROUPS_DEPLOY = 4
GROUPS_REQUESTS = 1000
GROUPS_BUDGET_S = 240.0


# Phase 17: the open-loop load harness.  ``peer load`` at its default
# 1,000 clients, at this offered rate for this long, once per group
# count; then the bench's load section at this many requests a point.
LOAD_RATE = 200.0
LOAD_DURATION_S = 5.0
LOAD_GROUPS = (1, 4)
LOAD_BENCH_REQUESTS = 400
LOAD_TIMEOUT_S = 240.0


# Phase 18: the crash-recovery soak (the bench's recovery section's run,
# ``bench.RECOVERY_SOAK`` at its count on the card), in a budget of its own.
SOAK_BUDGET_S = 180.0

# Phase 19 (the batch split and the engine pool): the card named twice
# (the two-device rehearsal on a one-GPU machine), the dry run's requests
# to each of its two groups, the grid's requests a run (probe, SAT, OVER)
# and the phase's budget.
REHEARSAL_DEVICES = ("cuda:0", "cuda:0")
POOL_REQUESTS_PER_GROUP = 200
GRID_REQUESTS = 400
POOL_BUDGET_S = 120.0


def executed_by_group(fams: dict) -> dict:
    """{group label: requests executed} from one grouped scrape."""
    fam = fams.get("minbft_requests_executed_total")
    return {dict(k).get("group"): int(v) for k, v in (fam["samples"] if fam else {}).items()}


def settle_grouped(addrs: list, n_groups: int, total: int, left,
                   engine: bool = True) -> list:
    """Scrape every replica of a grouped deployment until each one has
    executed ``total`` requests across its groups and the groups agree
    across replicas (the clients finish on f + 1 replies, so a replica may
    still be executing), then check the last scrape of each: every
    group's label on the protocol families, the stale-group gauge for
    every group, and exactly one set of engine families (no group label,
    each queue once; none without an ``engine``).  Returns each replica's
    executed count by group."""
    from minbft_tpu_torch.obs.prom import parse_exposition, scrape

    while True:
        scrapes = [parse_exposition(scrape(a, timeout=10)) for a in addrs]
        per = [executed_by_group(f) for f in scrapes]
        if all(sum(p.values()) == total for p in per) and all(p == per[0] for p in per):
            break
        check(left() > 5, f"groups: executed by group {per}, want {total} on each")
        time.sleep(0.5)
    labels = {str(g) for g in range(n_groups)}
    for i, fams in enumerate(scrapes):
        check(set(per[i]) == labels, f"groups replica {i}: group labels {sorted(per[i])}")
        stale = fams.get("minbft_health_stale_group")
        check(stale is not None and {dict(k)["group"] for k in stale["samples"]} == labels,
              f"groups replica {i}: stale-group gauge {stale and stale['samples']}")
        for side in ("verify", "sign"):
            fam = fams.get(f"minbft_{side}_queue_items_total")
            keys = [dict(k) for k in (fam["samples"] if fam else {})]
            check(bool(keys) == engine and all("group" not in k for k in keys)
                  and len(keys) == len({k["queue"] for k in keys}),
                  f"groups replica {i}: engine family {side} samples {keys}")
    return per


def run_peer_load(repo: str, n_groups: int, device: "str | None" = "cuda:0",
                  rate: float = LOAD_RATE, duration: float = LOAD_DURATION_S,
                  clients: "int | None" = None) -> dict:
    """``python -m minbft_tpu_torch.sample.peer load`` as a user runs it
    (its default 1,000 clients unless ``clients``), at ``rate`` for
    ``duration`` seconds with ``n_groups`` groups, its engine on
    ``device`` (None: ``--no-batch``, host crypto, a CPU rehearsal).  It
    must exit 0 with a fired census equal to the seed's replay, log no
    ERROR record and, with a device, report its engine there with HMAC
    batches, K6 launched (on the card) and no dispatch timed out.
    Returns its JSON report."""
    peer = [sys.executable, "-m", "minbft_tpu_torch.sample.peer", "load"]
    args = ["--rate", str(rate), "--duration", str(duration), "--groups", str(n_groups),
            *(["--clients", str(clients)] if clients else []),
            *(["--device", device] if device else ["--no-batch"])]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    res = subprocess.run(peer + args, env=env, capture_output=True, text=True,
                         timeout=LOAD_TIMEOUT_S)
    label = f"peer load --groups {n_groups}"
    check(res.returncode == 0, f"{label}: rc {res.returncode}: {res.stderr[-800:]}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    check(report["census_ok"], f"{label}: census {report['census']} is not the seed's replay")
    errs = [ln for ln in res.stderr.splitlines() if " ERROR " in ln]
    check(not errs, f"{label} logged ERROR: {errs[:3]}")
    if device:
        eng = report["engine"]
        timeouts = sum(q["dispatch_timeouts"] for side in ("verify", "sign")
                       for q in eng[side].values())
        check(eng["device"] == device and eng["verify"].get("hmac_sha256", {}).get("batches")
              and not timeouts and (eng["launches"]["K6"] > 0 or not device.startswith("cuda")),
              f"{label}: engine report {eng}")
    report["process_s"] = time.time() - t0
    return report


def ledger_lines(text: str) -> list:
    """The ``replica <id> ledgers [...]`` line a replica prints at a clean
    stop: each group's length and state digest."""
    for line in text.splitlines():
        if line.startswith("replica ") and " ledgers [" in line:
            return json.loads(line.split(" ledgers ", 1)[1])
    fail("no ledgers line in a replica log")


def engine_rows(fams: dict) -> dict:
    """{side: {queue: (items, batches)}} from the ``minbft_engine``
    families of one scrape (``minbft_{verify,sign}_queue_*_total``)."""
    rows: dict = {}
    for side in ("verify", "sign"):
        for field in ("items", "batches"):
            fam = fams.get(f"minbft_{side}_queue_{field}_total")
            for key, v in (fam["samples"] if fam else {}).items():
                q = rows.setdefault(side, {}).setdefault(dict(key)["queue"], [0, 0])
                q[0 if field == "items" else 1] = int(v)
    return {side: {q: tuple(v) for q, v in qs.items()} for side, qs in rows.items()}


def probe_live_replicas(run_cli, addrs: list, left) -> dict:
    """The operator's tools on a live chaos cluster: ``peer metrics``
    (every target, merged), ``peer top --once``, ``peer slo --json``, then
    a last scrape of each replica once its frame counts stop moving (the
    census and the frames are read by one render, while the replica's
    loop may still carry frames)."""
    from minbft_tpu_torch.obs.prom import parse_exposition, scrape
    from minbft_tpu_torch.testing.recovery_soak import _census_from_scrape

    res = run_cli("metrics", *addrs)
    check(res.returncode == 0 and "merged cluster aggregate" in res.stdout,
          f"peer metrics: rc {res.returncode}: {res.stderr[-500:]}")
    merged = parse_exposition(res.stdout.split("merged cluster aggregate", 1)[1]
                              .split("\n", 1)[1])
    res = run_cli("top", "--once", *addrs)
    check(res.returncode == 0, f"peer top --once: rc {res.returncode}: "
          f"{res.stdout[-300:]} {res.stderr[-300:]}")
    top = res.stdout.rstrip().splitlines()
    res = run_cli("slo", "--json", *addrs)
    check(res.returncode == 0, f"peer slo --json: rc {res.returncode}: {res.stderr[-300:]}")
    slo = json.loads(res.stdout)
    check(len(slo["targets"]) == len(addrs), f"peer slo: {len(slo['targets'])} targets")
    scrapes = []
    for addr in addrs:
        last = None
        while True:
            fams = parse_exposition(scrape(addr, timeout=10))
            census = _census_from_scrape(fams)
            if last is not None and census == last:
                break
            last = census
            check(left() > 5, f"chaos: {addr}'s frame counts never settled")
            time.sleep(0.5)
        scrapes.append((fams, census))
    return {"top": top, "scrapes": scrapes,
            "merged_items": sum(merged.get("minbft_verify_queue_items_total",
                                           {"samples": {}})["samples"].values())}


def check_chaos_replica(i: int, fams: dict, census: dict, rep, replay, fault_plan) -> dict:
    """One chaos replica's row: its scraped engine families show verify
    and sign items and no queue count above its engine report at SIGTERM
    (``rep``; None without an engine), and its scraped fault census is
    non-zero and equals the replay of the seed over the scrape's frames."""
    rows = engine_rows(fams)
    row = {"census": census["seeded"], "frames": sum(census["frames"].values()),
           "scrape": rows}
    if rep is not None:
        check(any(v[0] > 0 for v in rows.get("verify", {}).values())
              and any(v[0] > 0 for v in rows.get("sign", {}).values()),
              f"chaos replica {i}: scraped engine families {rows}")
        for side in ("verify", "sign"):
            for q, (items, batches) in rows.get(side, {}).items():
                dq = rep[side].get(q, {"items": 0, "batches": 0})
                check(items <= dq["items"] and batches <= dq["batches"],
                      f"chaos replica {i} {side} {q}: scraped ({items}, {batches}) above "
                      f"the SIGTERM report ({dq['items']}, {dq['batches']})")
        row["report"] = {side: {q: (v["items"], v["batches"]) for q, v in rep[side].items()}
                         for side in ("verify", "sign")}
    want = replay.replay_counts(census["frames"], plan=fault_plan)
    check(sum(census["seeded"].values()) > 0,
          f"chaos replica {i}: an empty fault census {census}")
    check(census["seeded"] == want,
          f"chaos replica {i}: scraped census {census['seeded']} != the replay "
          f"of seed {CHAOS_SEED:#x} over its frames {want}")
    check(census["frames"] and all(f"r{i}" in link for link in census["frames"]),
          f"chaos replica {i}: links {sorted(census['frames'])}")
    return row


def run_deployment(bench, repo: str, device: "str | None" = "cuda:0",
                   n_requests: int = DEPLOY_REQUESTS,
                   n_clients: int = DEPLOY_CLIENTS,
                   depth: int = DEPLOY_DEPTH, chaos: bool = False,
                   groups: int = 1) -> dict:
    """``peer testnet`` (n = 4, NATIVE_ECDSA USIGs), four ``peer run``
    processes over TCP with their engines on ``device`` (None:
    ``--no-batch``, host crypto, a CPU rehearsal) and the trace dump on,
    one ``peer request`` (not under chaos), one ``peer bench`` of
    ``n_clients`` x ``depth``, ``n_requests`` requests, then SIGTERM:
    every request must commit, every process exit 0, every engine dump
    show K2 and K3 batches on ``device`` with no dispatch timed out, and
    no replica log hold an ERROR record.

    With ``chaos`` the replicas also run ``--metrics-port 0`` with
    ``MINBFT_CHAOS_SEED`` pinned to ``CHAOS_SEED`` and
    ``MINBFT_CHAOS_PLAN`` = ``CHAOS_PLAN`` (each replica's outbound links
    go through the seeded fault-injection network), and before SIGTERM
    :func:`probe_live_replicas` reads them; each replica must then pass
    :func:`check_chaos_replica`.

    With ``groups`` > 1 the scaffold declares that many consensus groups,
    every replica process hosts them all over its one engine and serves
    ``--metrics-port 0``, there is no ``peer request``, and the bench
    routes each operation to its group; before SIGTERM :func:`settle_grouped` waits
    for every replica to execute every request and checks each scrape,
    and after it every replica's ledgers line must equal the others'
    (each group's length and state digest).  Everything runs inside
    ``CHAOS_BUDGET_S`` (``GROUPS_BUDGET_S`` with groups,
    ``DEPLOY_BUDGET_S`` otherwise)."""
    import shutil
    import tempfile

    import yaml

    from minbft_tpu_torch.testing.recovery_soak import _metrics_port

    t_phase = time.time()
    grouped = groups > 1
    budget = CHAOS_BUDGET_S if chaos else GROUPS_BUDGET_S if grouped else DEPLOY_BUDGET_S
    label = "chaos" if chaos else "groups" if grouped else "deploy"
    d = tempfile.mkdtemp(prefix=f"minbft-smoke-{label}.")
    base_port = bench._free_base_port(DEPLOY_N)
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MINBFT_TRACE_DUMP=f"{d}/trace",
               **(CHAOS_TIMEOUTS if chaos else DEPLOY_TIMEOUTS))
    replica_env = dict(env, MINBFT_CHAOS_SEED=hex(CHAOS_SEED),
                       MINBFT_CHAOS_PLAN=CHAOS_PLAN) if chaos else env
    peer = ["-m", "minbft_tpu_torch.sample.peer"]
    dev_args = ["--device", device] if device else ["--no-batch"]
    run_args = [*dev_args, "--metrics-port", "0"] if chaos or grouped else dev_args
    on_card = bool(device) and device.startswith("cuda")
    procs: list = []
    logs: list = []

    def left() -> float:
        remaining = budget - (time.time() - t_phase)
        check(remaining > 0, f"{label}: past its {budget:.0f} s budget")
        return remaining

    def run_cli(*args) -> subprocess.CompletedProcess:
        return subprocess.run(bench._child_cmd(*peer, *args), env=env,
                              capture_output=True, text=True, timeout=left())

    try:
        baseline_mib = bench.gpu_memory_used_mib() if on_card else 0.0
        res = subprocess.run(
            [sys.executable, *peer, "testnet", "-n", str(DEPLOY_N), "--usig", "NATIVE_ECDSA",
             "--clients", str(n_clients), "-d", d, "--base-port", str(base_port),
             "--groups", str(groups)],
            env=env, capture_output=True, text=True, timeout=left())
        check(res.returncode == 0, f"{label} testnet: rc {res.returncode}: {res.stderr[-500:]}")
        with open(f"{d}/keys.yaml") as fh:
            spec = yaml.safe_load(fh)["usig"]["keyspec"]
        check(spec == "NATIVE_ECDSA", f"{label} testnet: keys.yaml names {spec}")
        common = ["--config", f"{d}/consensus.yaml", "--transport", "tcp"]
        t0 = time.time()
        for i in range(DEPLOY_N):
            log = open(f"{d}/replica{i}.log", "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                bench._child_cmd(*peer, "--keys", f"{d}/keys.replica{i}.yaml", *common,
                                 "run", str(i), *run_args),
                env=replica_env, stdout=subprocess.DEVNULL, stderr=log))
        check(bench._wait_ports([base_port + i for i in range(DEPLOY_N)], timeout=left()),
              f"{label}: replicas never bound their ports")
        start_s = time.time() - t0
        if chaos or grouped:
            addrs = [f"127.0.0.1:{_metrics_port(f'{d}/replica{i}.log', 0, left())}"
                     for i in range(DEPLOY_N)]
        if chaos:
            for i in range(DEPLOY_N):
                with open(f"{d}/replica{i}.log", errors="replace") as fh:
                    check(f"chaos: seed={CHAOS_SEED:#x} plan={CHAOS_PLAN}" in fh.read(),
                          f"chaos: replica {i} did not announce the chaos wrap")
        client = [*peer, "--keys", f"{d}/keys.yaml", *common]
        if not chaos and not grouped:
            res = run_cli("--keys", f"{d}/keys.yaml", *common, "request", "--timeout", "120",
                          *dev_args, "smoke-deploy-op")
            out = res.stdout.strip()
            check(res.returncode == 0 and len(out) == 64
                  and all(c in "0123456789abcdef" for c in out),
                  f"peer request: rc {res.returncode}, stdout {out!r}, {res.stderr[-500:]}")
            check(" ERROR " not in res.stderr, f"peer request logged ERROR: {res.stderr[-500:]}")
        bench_proc = subprocess.Popen(
            bench._child_cmd(*client, "bench", "--clients", str(n_clients),
                             "--depth", str(depth), "--requests", str(n_requests),
                             "--tag", label, "--timeout", str(int(min(budget, 240))),
                             *dev_args),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(bench_proc)
        with bench.ProcessSampler([p.pid for p in procs[:DEPLOY_N]],
                                  gpu=on_card) as sampler:
            try:
                stdout, stderr = bench_proc.communicate(timeout=left())
            except subprocess.TimeoutExpired:
                bench_proc.kill()
                stdout, stderr = bench_proc.communicate()
                fail(f"{label}: peer bench did not finish inside the {budget:.0f} s budget: "
                     f"{stderr[-800:]}")
            t_end = time.time()
        check(bench_proc.returncode == 0,
              f"{label} peer bench: rc {bench_proc.returncode}: {stderr[-800:]}")
        if not chaos:
            errs = [ln for ln in stderr.splitlines() if " ERROR " in ln]
            check(not errs, f"peer bench logged ERROR: {errs[:3]}")
        report = json.loads(stdout.strip().splitlines()[-1])
        check(report["committed"] == n_requests
              and len(report["latencies_ms"]) == n_requests,
              f"{label} peer bench: {report['committed']} of {n_requests} committed")
        if device:
            faults = bench.engine_faults(report["engine"], device)
            check(not faults, f"{label} peer bench (client process): {'; '.join(faults)}")
        cpu = sampler.cpu_per_wall(t_end - report["seconds"], t_end)
        probe = probe_live_replicas(run_cli, addrs, left) if chaos else {}
        # Every request and the bench's warmup into each group.
        executed = (settle_grouped(addrs, groups, n_requests + groups, left,
                                   engine=bool(device)) if grouped else [])
        for p in procs[:DEPLOY_N]:
            p.terminate()
        for i, p in enumerate(procs[:DEPLOY_N]):
            try:
                rc = p.wait(timeout=max(min(left(), bench.MP_STOP_TIMEOUT_S), 1))
            except subprocess.TimeoutExpired:
                fail(f"{label} peer run {i}: still running after SIGTERM")
            check(rc == 0, f"{label} peer run {i}: exit code {rc} after SIGTERM")
        if chaos:
            from minbft_tpu_torch.testing import FaultNet, plan_from_spec

            fault_plan = plan_from_spec(CHAOS_PLAN)
            replay = FaultNet(seed=CHAOS_SEED, default_plan=fault_plan)
        launches = dict(report["engine"]["launches"]) if device else {}
        dumps, replicas, ledgers = [], [], []
        for i in range(DEPLOY_N):
            with open(f"{d}/replica{i}.log", errors="replace") as fh:
                text = fh.read()
            errs = [ln for ln in text.splitlines() if " ERROR " in ln]
            check(not errs, f"{label} peer run {i} logged ERROR: {errs[:3]}")
            if grouped:
                ledgers.append(ledger_lines(text))
                check(ledgers[-1] == ledgers[0] and len(ledgers[0]) == groups
                      and sum(g["length"] for g in ledgers[0]) == n_requests + groups,
                      f"groups replica {i} ledgers {ledgers[-1]} != replica 0's {ledgers[0]}")
            rep = None
            if device:
                with open(f"{d}/trace.engine{i}.json") as fh:
                    rep = json.load(fh)["engine"]
                faults = bench.engine_faults(rep, device)
                check(not faults, f"{label} peer run {i} (engine dump): {'; '.join(faults)}")
                for kid, v in rep["launches"].items():
                    launches[kid] = launches.get(kid, 0) + v
                dumps.append(rep)
            if chaos:
                fams, census = probe["scrapes"][i]
                replicas.append(check_chaos_replica(i, fams, census, rep, replay, fault_plan))
        lat = sorted(report["latencies_ms"])
        engines = dumps + ([report["engine"]] if device else [])
        return {
            "requests": report["committed"], "seconds": report["seconds"],
            "req_per_sec": report["req_per_sec"],
            "p50_ms": _quantile(lat, 0.50), "p99_ms": _quantile(lat, 0.99),
            "replica_cpu_per_wall": cpu, "client_cpu_per_wall": report["cpu_per_wall"],
            # The CUDA contexts as the processes report them (each says
            # whether it initialised CUDA) and each one's allocator MiB;
            # the card's sandbox lists every process under one pid, so the
            # memory they took together is the device's in use over the
            # drive less the baseline.
            "contexts": sum(bool(rep["cuda_context"]) for rep in engines),
            "cuda_reserved_mib": [rep["cuda_reserved_mib"] for rep in engines],
            "gpu_memory_mib": (sampler.gpu_peak_mib - baseline_mib) if on_card else 0.0,
            "start_s": start_s, "launches": launches, "engines": dumps,
            "replicas": replicas, "top": probe.get("top", []),
            "merged_items": probe.get("merged_items", 0),
            "executed_by_group": executed, "ledgers": ledgers[:1],
            "phase_s": time.time() - t_phase,
        }
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
        shutil.rmtree(d, ignore_errors=True)


def recertified(record: str) -> bool:
    """Whether an ERROR record of a diverged checkpoint is a view change's
    re-certification of one count (the digest covers the view, so one
    state reads as another digest; ROADMAP.md queue 3): a "checkpoint
    divergence" whose every conflicting claim is in another view than the
    claim it was held against, or a local snapshot that was certified in
    another view than it executed in with the same state.  A conflict
    inside one view is a fork and never excused."""
    m = re.search(r"executed in view (\d+) cv \d+, certified in view (\d+) cv \d+: "
                  r"the same state\)$", record)
    if m:
        return m.group(1) != m.group(2)
    m = re.search(r"certified \S+ in view (\d+) cv \d+ vs stable \S+ in view (\d+) cv", record)
    if m:
        return m.group(1) != m.group(2)
    m = re.search(r"at count \d+: \S+ in view (\d+) cv \d+ vs replicas (.+)$", record)
    if not m:
        return False
    views = re.findall(r"\d+ in view (\d+) cv \d+", m.group(2))
    return bool(views) and m.group(1) not in views


def run_soak(bench) -> dict:
    """One kill -9 soak of real ``peer run`` processes
    (``testing.recovery_soak.run_recovery_soak`` at ``bench.RECOVERY_SOAK``:
    n = 4, SOFT_ECDSA USIGs, TCP, 6 clients x depth 4, the default soak
    plan under ``bench.RECOVERY_SEED``, replica 3 killed once its store
    exists, restarted after 0.5 s; ``bench.RECOVERY_REQUESTS_CARD``
    requests), every replica's and the client's engine on cuda:0, every
    wait inside ``SOAK_BUDGET_S``.  Beyond the soak's own checks (every
    request committed, a durable restore, a finite recovery time, the
    store invariants, every census the seed's replay), every process's
    engine report must show its engine on cuda:0 with K2 and K3 launched,
    ECDSA verify and sign batches, no dispatch timed out and no
    host-signed lane (the restarted replica's second instance included),
    and no replica or client log may hold an ERROR record other than a
    view change's re-certification of a count (``recertified``).  Returns the
    soak's report with the phase's seconds, the CUDA contexts the
    processes report and the launches."""
    import tempfile

    from minbft_tpu_torch.testing import InvariantViolation
    from minbft_tpu_torch.testing.recovery_soak import run_recovery_soak

    requests = bench.RECOVERY_REQUESTS_CARD
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="minbft-smoke-soak.") as wd:
        try:
            rep = run_recovery_soak(
                wd, requests=requests, chaos_seed=bench.RECOVERY_SEED, device="cuda:0",
                budget_s=SOAK_BUDGET_S, **bench.RECOVERY_SOAK)
        except (AssertionError, InvariantViolation, subprocess.TimeoutExpired) as e:
            fail(f"recovery soak: {type(e).__name__}: {e}")
        errs, ledgers, rep["view_change_errors"] = {}, [], 0
        for name in [f"replica{i}.log" for i in range(4)] + ["bench.log"]:
            with open(os.path.join(wd, name), errors="replace") as fh:
                text = fh.read()
            lines = [ln for ln in text.splitlines() if " ERROR " in ln]
            if name.startswith("replica"):
                ledgers.append(ledger_lines(text))
                excused = [ln for ln in lines if recertified(ln)]
                rep["view_change_errors"] += len(excused)
                lines = [ln for ln in lines if ln not in excused]
            if lines:
                errs[name] = lines[:3]
    rep["phase_s"] = time.time() - t0
    rep["ledgers"] = ledgers
    check(not errs, f"recovery soak: ERROR records {errs}")
    # A replica may still be behind when the cluster stops (the client
    # finishes on f + 1 REPLYs): every replica that executed every request
    # and the bench's warmup must hold one digest, and f + 1 must have.
    full = [lg[0]["digest"] for lg in ledgers if lg[0]["length"] == rep["requested"] + 1]
    check(len(full) >= 2 and len(set(full)) == 1,
          f"recovery soak: ledgers {ledgers} (want {rep['requested']} requests and the "
          "warmup on f + 1 replicas at least, one digest)")
    check(rep["phase_s"] <= SOAK_BUDGET_S,
          f"recovery soak: {rep['phase_s']:.1f} s, past its {SOAK_BUDGET_S:.0f} s budget")
    check(rep["committed"] == rep["requested"] == requests // 6 * 6,
          f"recovery soak: {rep['committed']} of {rep['requested']} committed")
    check(rep["restored_count"] > 0 and 0 < rep["chaos_recovery_time_ms"] < float("inf"),
          f"recovery soak: restored {rep['restored_count']}, recovery "
          f"{rep['chaos_recovery_time_ms']} ms")
    check(3 in rep["stores"] and sorted(rep["census"]) == [0, 1, 2, 3],
          f"recovery soak: stores {sorted(rep['stores'])}, census {sorted(rep['census'])}")
    check(sorted(rep["engines"], key=str) == sorted([0, 1, 2, 3, "client"], key=str),
          f"recovery soak: engine reports {sorted(rep['engines'], key=str)}")
    launches: dict = {}
    for who, eng in rep["engines"].items():
        faults = bench.engine_faults(eng, "cuda:0")
        check(not faults, f"recovery soak {who}: {'; '.join(faults)}")
        for kid, v in eng["launches"].items():
            launches[kid] = launches.get(kid, 0) + v
    rep["contexts"] = sum(bool(eng["cuda_context"]) for eng in rep["engines"].values())
    rep["launches"] = launches
    return rep


# Phases 2-4, 6 and 7: kernels against their plain versions.


def run_pool_phase(torch, bench, name_power: str, split_rows: dict, work: tuple,
                   reset_counts, read_counts, path_launches: dict) -> dict:
    """Phase 19: the batch split and the engine pool on the card, rehearsed
    over ``REHEARSAL_DEVICES``.  ``split_rows`` holds each split kernel's
    rows on cuda:0 (K2, K3, K6, K7, K8), ``work`` the C = 1 identity's
    ECDSA, HMAC and Ed25519 verify items and ECDSA and Ed25519 sign items.
    Adds the pool paths' launch counts to ``path_launches`` and returns
    each kernel's split output, for the caller to hold against its own
    phase."""
    from minbft_tpu_torch.obs.prom import collect_engine_pool
    from minbft_tpu_torch.ops import ed25519, hmac_sha256, p256
    from minbft_tpu_torch.parallel import BatchVerifier, EnginePool
    from minbft_tpu_torch.parallel import mesh as mesh_mod
    from minbft_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    # One card named twice: the rehearsal of two devices on a one-GPU
    # machine (each chunk runs on cuda:0 in turn).
    mesh2 = mesh_mod.make_mesh(REHEARSAL_DEVICES)
    # (a) Each sharded kernel on the phase's own rows at the deployment
    # bucket (1,024 for Ed25519): the adversarial and padding lanes of
    # phases 3, 4, 6 and 7 included.  These launches hold the split
    # against one launch and are counted in no path.
    split_cases = (
        ("K2", mesh_mod.sharded_ecdsa_kernel, p256.ecdsa_verify_kernel_packed),
        ("K3", mesh_mod.sharded_ecdsa_sign_kernel, p256.ecdsa_kg_kernel),
        ("K6", mesh_mod.sharded_hmac_kernel, hmac_sha256.hmac_verify_kernel_packed),
        ("K7", mesh_mod.sharded_ed25519_kernel, ed25519.ed25519_verify_kernel_packed),
        ("K8", mesh_mod.sharded_ed25519_sign_kernel, ed25519.ed25519_rb_kernel),
    )
    outputs = {}
    for kid, make_split, kernel in split_cases:
        rows_d = split_rows[kid]
        split = make_split(mesh2)
        before = kernel.launches
        got = split(rows_d)
        check(kernel.launches - before == 2,
              f"{kid} split: {kernel.launches - before} launches counted, not one a chunk")
        got_host = split(rows_d.cpu())  # host rows, as the engine feeds it
        want = kernel(rows_d).cpu()
        for form, out in (("device", got), ("host", got_host)):
            check(out.dtype == want.dtype and out.shape == want.shape
                  and torch.equal(out, want),
                  f"{kid} split over {mesh2} ({form} rows) differs from one launch")
        outputs[kid] = got
        bsz = rows_d.shape[0]
        one = cuda_ms(torch, lambda: kernel(rows_d).cpu())
        two = cuda_ms(torch, lambda: split(rows_d))
        print(f"{kid} split over {mesh2} at B={bsz}: equal to one launch on every lane "
              f"({'bit for bit' if want.dim() > 1 else 'verdicts'}), from device and host "
              f"rows; {two:.3f} ms per call (two {bsz // 2}-lane launches and their "
              f"readbacks) beside {one:.3f} ms for one {bsz}-lane launch and its readback "
              f"(CUDA-event medians, not a scaling figure: one card); on {name_power}")

    # (b) The C = 1 pool is the bare engine: same verdicts, signatures,
    # per-queue stats and launches over the same items.
    def drive(eng):
        async def go():
            v_ecdsa, v_hmac, v_ed, s_ecdsa, s_ed = work
            return (
                await eng.verify_ecdsa_p256_many(v_ecdsa),
                list(await asyncio.gather(*[eng.verify_hmac_sha256(*it) for it in v_hmac])),
                await eng.verify_ed25519_many(v_ed),
                list(await asyncio.gather(*[eng.sign_ecdsa_p256(*it) for it in s_ecdsa])),
                list(await asyncio.gather(*[eng.sign_ed25519(*it) for it in s_ed])),
            )
        return asyncio.run(go())

    def queue_census(eng) -> dict:
        fields = ("items", "batches", "max_batch_seen", "padded_lanes", "dispatch_timeouts",
                  "flush_reasons", "occupancy")
        out = {f"verify:{q}": [getattr(st, k) for k in fields] + [st.memo_hits]
               for q, st in eng.stats.items()}
        out.update({f"sign:{q}": [getattr(st, k) for k in fields] + [st.host_fallback_items]
                    for q, st in eng.sign_stats.items()})
        return out

    identity = {}
    card = REHEARSAL_DEVICES[0]
    for label, make in (("bare", lambda: BatchVerifier(max_batch=512, buckets=(512,),
                                                         device=card)),
                        ("pool", lambda: EnginePool(chips=1, devices=[card],
                                                    max_batch=512, buckets=(512,)))):
        eng = make()
        front = eng.engine_for(0) if label == "pool" else eng
        reset_counts()
        # The C = 1 path: every count moves only from here ...
        results = drive(front)
        # ... to here.
        identity[label] = (results, queue_census(eng), read_counts())
    path_launches["pool_c1"] = identity["pool"][2]
    for part, what in enumerate(("ECDSA verdicts", "HMAC verdicts", "Ed25519 verdicts",
                                 "ECDSA signatures", "Ed25519 signatures")):
        check(identity["bare"][0][part] == identity["pool"][0][part],
              f"C = 1 pool: {what} differ from the bare engine's")
    check(identity["bare"][1] == identity["pool"][1],
          f"C = 1 pool: queue stats {identity['pool'][1]} != {identity['bare'][1]}")
    check(identity["bare"][2] == identity["pool"][2],
          f"C = 1 pool: launches {identity['pool'][2]} != {identity['bare'][2]}")
    c1 = identity["pool"]
    print(f"pool_c1 (EnginePool(chips=1) on {card} against a bare BatchVerifier on {card}): "
          + ", ".join(f"{sum(v)}/{len(v)} {what}" for v, what in zip(
              c1[0][:3], ("ECDSA", "HMAC", "Ed25519")))
          + f" accepted, {len(c1[0][3])} + {len(c1[0][4])} signatures, all equal; "
          f"per-queue stats equal "
          f"{ {q: v[:2] for q, v in c1[1].items()} } (items, batches); launches equal "
          f"{c1[2]}")

    # (c) The dry run over the card named twice, at the deployment bucket:
    # the split K2 and K6, an uneven-bucket mesh engine, then the grouped
    # n = 4 cluster whose replicas each hold a C = 2 pool, then one
    # oversized batch through a group's facade onto the striped engine.
    with _ErrorRecords() as errors:
        reset_counts()
        # The dry run: every count moves only from here ...
        dry = dryrun_multichip(REHEARSAL_DEVICES, batch=512,
                               requests_per_group=POOL_REQUESTS_PER_GROUP, n_clients=4)
        # ... to here.
        win = read_counts()
    path_launches["pool_dryrun"] = win
    check(not errors, f"pool_dryrun: ERROR records {errors[:5]}")
    pools = dry["pools"]
    for i, pool in enumerate(pools):
        for c, eng in enumerate(pool.engines):
            st = eng.stats.get("hmac_sha256")
            check(st is not None and st.batches > 0,
                  f"pool_dryrun: replica {i} chip {c} engine launched no K6")
    stripe = pools[0].striped_engine.stats.get("ecdsa_p256")
    check(stripe is not None and stripe.batches >= 1 and win["K2"] > 0,
          "pool_dryrun: the striped engine launched no split kernel")
    timeouts = sum(st.dispatch_timeouts for pool in pools
                   for eng in (*pool.engines, pool.striped_engine)
                   for st in (*eng.stats.values(), *eng.sign_stats.values()))
    check(timeouts == 0, f"pool_dryrun: {timeouts} dispatch timeouts")
    check(win["K6"] > 0, f"pool_dryrun: K6 was not launched {win}")
    fams = {fam[0]: fam for fam in collect_engine_pool(pools[0])}
    check(fams["minbft_engine_pool_chips"][3][0][1] == 2, "pool_dryrun: scrape reads "
          f"{fams['minbft_engine_pool_chips'][3]} chips")
    ups = {lb["chip"]: v for lb, v in fams["minbft_engine_pool_chip_up"][3]}
    check(ups == {"0": 1, "1": 1}, f"pool_dryrun: chip_up {ups}")
    per_chip = {c: (eng.stats["hmac_sha256"].items, eng.stats["hmac_sha256"].batches)
                for c, eng in enumerate(pools[0].engines)}
    print(f"pool_dryrun ({dry['devices']}, bucket {dry['batch']}; n=4, MACs, HMAC USIGs, "
          f"{dry['groups']} groups, {dry['requests']} requests from 4 clients): every request "
          f"committed, per-group ledgers equal on every replica {dry['ledgers'][0]}; "
          f"placement {dry['placement']}; replica 0's chips' K6 queues {per_chip} (items, "
          f"batches); {dry['stripe_items']} items through the striped engine "
          f"({stripe.batches} batch, two chunks); scrape: chips 2, chip_up {ups}; cluster "
          f"{dry['cluster_s']:.1f} s, dry run {dry['seconds']:.1f} s; launches {win}; "
          f"on {name_power}")

    # (d) The bench's (G, C) grid, cut to G = 2 and C as clamped (1 on a
    # one-GPU machine).
    os.environ.update(MINBFT_BENCH_GRID_GS="2", MINBFT_BENCH_GRID_CHIPS="1,2",
                      MINBFT_BENCH_GRID_REQUESTS=str(GRID_REQUESTS))
    for knob in ("MINBFT_LOAD_SEED", "MINBFT_BENCH_GRID_CLIENTS", "MINBFT_LOAD_PROBE_RATE"):
        os.environ.pop(knob, None)
    out = io.StringIO()
    with _ErrorRecords() as errors:
        reset_counts()
        # The bench's groups_chips section: every count moves only from here ...
        try:
            with contextlib.redirect_stdout(out):
                rc = bench.main(["--device", REHEARSAL_DEVICES[0], "groups_chips"])
        except Exception as e:  # the bench's own failure, reported
            fail(f"bench_groups_chips: {type(e).__name__}: {e}")
        # ... to here.
        win = read_counts()
    path_launches["bench_groups_chips"] = win
    check(rc == 0, f"bench_groups_chips: exit code {rc}")
    check(not errors, f"bench_groups_chips: ERROR records {errors[:5]}")
    with open(os.path.join(bench.OUT_DIR, "extras.json")) as fh:
        extras = json.load(fh)
    grid_c = extras["groups_chips_grid_chips"]
    missing = sorted(bench_expected_keys("groups_chips", points=[(2, c) for c in grid_c])
                     - set(extras))
    check(not missing, f"bench_groups_chips: keys missing {missing}")
    check(all(extras[f"groups2x{c}_load_{t}_census_ok"] for c in grid_c
              for t in ("sat", "over")), "bench_groups_chips: a census is not the seed's replay")
    check(win["K6"] > 0, f"bench_groups_chips: K6 was not launched {win}")
    for c in grid_c:
        p = f"groups2x{c}"
        print(f"bench_groups_chips {p} (chips requested 1,2, built {extras[f'{p}_chips']} of "
              f"{extras['groups_chips_devices_visible']} visible): burst peak "
              f"{extras[f'{p}_load_burst_peak_per_sec']}/s; sat offered "
              f"{extras[f'{p}_load_sat_offered_per_sec']}/s goodput "
              f"{extras[f'{p}_load_sat_goodput_per_sec']}/s p50 "
              f"{extras[f'{p}_load_sat_p50_ms']} ms p99 {extras[f'{p}_load_sat_p99_ms']} ms; "
              f"over goodput {extras[f'{p}_load_over_goodput_per_sec']}/s; K6 mean batch "
              f"{extras[f'{p}_verify_mean_batch']}, pool busy {extras[f'{p}_util_busy']}; "
              f"placement {extras[f'{p}_placement']}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 19: {phase_s:.1f} s of its {POOL_BUDGET_S:.0f} s budget; launches "
          f"{win}; on {name_power}")
    check(phase_s <= POOL_BUDGET_S,
          f"phase 19: {phase_s:.1f} s, past its {POOL_BUDGET_S:.0f} s budget")
    return outputs


def verify_items(hc, rng, keys, count: int):
    """``count`` verify items with distinct digests: honest lanes signed
    by the port's sign_batch on the card, lanes 0-2 under the keys Q = G,
    -G and 2G (private keys 1, n-1 and 2), and on every 16th lane an
    adversarial one — tampered digest, wrong key, r = 0, s = n or
    bit-flipped s."""
    from minbft_tpu_torch.ops import p256

    G = (hc.GX, hc.GY)
    neg_g = (hc.GX, hc.P - hc.GY)
    digests = [rng.bytes(32) for _ in range(count)]
    signers = [keys[i % len(keys)] for i in range(count)]
    signers[0] = (1, G)
    signers[1] = (hc.N - 1, neg_g)
    signers[2] = (2, hc.point_double(G))
    sigs = p256.sign_batch(
        [(d, dg) for (d, _q), dg in zip(signers, digests)], bucket=count
    )
    items = [(q, dg, s) for (_d, q), dg, s in zip(signers, digests, sigs)]
    for i in range(8, count, 16):
        q, dg, (r, s) = items[i]
        kind = (i // 16) % 5
        if kind == 0:
            items[i] = (q, rng.bytes(32), (r, s))
        elif kind == 1:
            items[i] = (keys[(i + 1) % len(keys)][1], dg, (r, s))
        elif kind == 2:
            items[i] = (q, dg, (0, s))
        elif kind == 3:
            items[i] = (q, dg, (r, hc.N))
        else:
            items[i] = (q, dg, (r, s ^ 1))
    return items


def undecodable_pub(hc) -> bytes:
    """The first 32-byte encoding y = 2, 3, ... that is no curve point."""
    y = 2
    while hc.ed_decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    return y.to_bytes(32, "little")


def ed25519_items(hc, rng, seeds, count: int):
    """``count`` Ed25519 verify items (pub32, msg32, sig64) with distinct
    messages: honest lanes signed by the port's sign_batch on the card
    (K8), and on every 16th lane (from lane 8) an adversarial one, in
    turn: tampered message, wrong key, bit-flipped R, S + L,
    non-canonical R (y >= p), undecodable public key, wrong-length
    signature."""
    from minbft_tpu_torch.ops import ed25519 as ed

    pubs = [hc.ed25519_keygen(sd)[1] for sd in seeds]
    msgs = [rng.bytes(32) for _ in range(count)]
    who = [i % len(seeds) for i in range(count)]
    sigs = ed.sign_batch([(seeds[w], m) for w, m in zip(who, msgs)], bucket=count)
    items = [(pubs[w], m, sg) for w, m, sg in zip(who, msgs, sigs)]
    bad_pub = undecodable_pub(hc)
    for j, i in enumerate(range(8, count, 16)):
        pub, msg, sig = items[i]
        kind = j % 7
        if kind == 0:
            items[i] = (pub, rng.bytes(32), sig)
        elif kind == 1:
            items[i] = (pubs[(who[i] + 1) % len(pubs)], msg, sig)
        elif kind == 2:
            items[i] = (pub, msg, bytes([sig[0] ^ 1]) + sig[1:])
        elif kind == 3:
            s_big = int.from_bytes(sig[32:], "little") + hc.ED_L
            items[i] = (pub, msg, sig[:32] + s_big.to_bytes(32, "little"))
        elif kind == 4:
            y_enc = (ed.P + j % 19) | (sig[31] >> 7 << 255)
            items[i] = (pub, msg, y_enc.to_bytes(32, "little") + sig[32:])
        elif kind == 5:
            items[i] = (bad_pub, msg, sig)
        else:
            items[i] = (pub, msg, sig[:63])
    return items


def hmac_rows(np_rng, count: int):
    """``count`` distinct [24] u32 rows of key | msg | mac (big-endian
    words) with their expected verdicts from Python's ``hmac``: honest
    lanes, and on every 16th lane (from lane 5) a forged one — one bit
    flipped in the mac, the key or the message, in turn — and the last 8
    rows all zero (engine padding).  Returns (rows, expect, forged)."""
    import hmac as py_hmac

    import numpy as np

    raw = np_rng.integers(0, 256, size=(count, 64), dtype=np.uint8)
    rows = np.zeros((count, 24), dtype=np.uint32)
    for i in range(count - 8):
        key, msg = raw[i, :32].tobytes(), raw[i, 32:].tobytes()
        mac = py_hmac.new(key, msg, hashlib.sha256).digest()
        rows[i] = np.frombuffer(key + msg + mac, dtype=">u4")
    forged = np.arange(5, count - 8, 16)
    for j, i in enumerate(forged):
        word = [16, 0, 8][j % 3] + (j // 3) % 8  # mac, key, msg
        rows[i, word] ^= np.uint32(1 << (j % 32))
    expect = np.zeros(count, dtype=bool)
    for i in range(count):
        b = rows[i].astype(">u4").tobytes()
        mac = py_hmac.new(b[:32], b[32:64], hashlib.sha256).digest()
        expect[i] = py_hmac.compare_digest(mac, b[64:])
    return rows, expect, forged


def craft_r2_rows(rows, idx):
    """Second-candidate rows built directly on honest lanes (an honest
    r + n < p is too rare to meet): r2 = r with r2_ok = 1; then, on every
    second lane, r corrupted so only r2 can match; on every fourth, r2_ok
    cleared again so neither can (the lane must be rejected)."""
    L = 16
    for j, i in enumerate(idx):
        rows[i, 6 * L] = 1
        rows[i, 5 * L : 6 * L] = rows[i, 4 * L : 5 * L]
        if j % 2:
            rows[i, 4 * L] ^= 1
        if j % 4 == 3:
            rows[i, 6 * L] = 0
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from minbft_tpu_torch import bench
    from minbft_tpu_torch.ops import backend, ed25519, hmac_sha256, limbs, p256, sha256
    from minbft_tpu_torch.parallel import BatchVerifier
    from minbft_tpu_torch.sample.authentication import authenticators_from_keys
    from minbft_tpu_torch.sample.authentication.authenticator import (
        _pub_rows,
        make_test_keys,
    )
    from minbft_tpu_torch.usig import native
    from minbft_tpu_torch.utils import hostcrypto as hc

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    name_power = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    imad_per_s = n_sms * 64 * sm_clock_mhz * 1e6
    rng = Rng(20261017)

    # -- phase 1 -------------------------------------------------------------
    build_s = backend.EXTENSION.build_all()
    print(f"card: {name_power}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"SMs {n_sms}, max SM clock {sm_clock_mhz:.0f} MHz")
    print(f"extension build: {build_s:.1f} s into {backend.EXTENSION.build_dir}")
    # What the deployment path (phase 14) needs from the machine.
    print(f"host: Python {sys.version.split()[0]}, {os.cpu_count()} CPUs; "
          + ", ".join(f"{m} {module_version(m)}" for m in ("yaml", "grpc", "cryptography")))
    t0 = time.perf_counter()
    native.build()
    print(f"native USIG: {native._cxx()} "
          f"({subprocess.run([native._cxx(), '--version'], capture_output=True, text=True).stdout.splitlines()[0]}) "
          f"against {native._libcrypto()}, built in {time.perf_counter() - t0:.1f} s "
          f"into {native.build_dir()}")
    ptx = {src: ptxas_kernels(log) for src, log in backend.EXTENSION.ptxas_log.items()}
    # Every kernel instance's registers, stack frame and spills.
    names = demangle(e for kern in ptx.values() for e in kern)
    for src, kern in ptx.items():
        for entry, report in kern.items():
            print(f"  ptxas {src}: {names[entry]}: {regs_phrase(*report)}")
    # The SHA-256 kernels' code as the card runs it: instructions per
    # thread (a K6 lane runs two such streams, one on each of its threads)
    # and the longest chain of dependent instructions.
    for src in ("sha256_compress", "hmac_sha256"):
        prof = sass_profile(os.path.join(backend.EXTENSION.build_dir, f"lib{src}.so"))
        if not prof:
            print(f"  SASS {src}: no cuobjdump in the toolkit")
        for entry, (n_ins, alu, iadd3, imad, chain) in prof.items():
            print(f"  SASS {src}: {demangle([entry])[entry]}: {n_ins} instructions "
                  f"({alu} SHF/LOP3, {iadd3} IADD3, {imad} IMAD), a chain of {chain}")

    def bound(ops: float, nbytes: float):
        """Least time for ``ops`` issues at 64 lanes per SM per clock
        and ``nbytes`` at the memory rate: (ms, which bounds it)."""
        t_ops = ops / imad_per_s * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def every_group(kid, bsz, got, dev_ms, launch, report, entry):
        """Run ``launch(g)`` (the kernel's uncounted launcher) at every
        group size g the P-256 launchers pick from: each must give ``got``
        (the picked size's checked output) on every lane; print the picked
        size with its registers, frame and spills and each size's device
        ms.  Returns (picked size, {g: device ms})."""
        picked = p256.group_size(bsz)
        by_g = {}
        for g in p256.GROUP_SIZES:
            other = launch(g).cpu().numpy()
            same = other.shape == got.shape and bool((other == got).all())
            check(same, f"{kid} B={bsz} T={g}: output differs from T={picked}'s")
            by_g[g] = dev_ms if g == picked else graph_ms(torch, lambda: launch(g), copies=3)
        print(f"{kid} B={bsz}: the launcher picks T={picked} "
              f"({kernel_regs(report, entry, picked)}); T = "
              + ", ".join(map(str, p256.GROUP_SIZES)) + " give the same output on every "
              "lane; device ms " + ", ".join(f"T={g} {v:.4f}" for g, v in by_g.items()))
        return picked, by_g

    def k1(op, x, y, field, g):
        """K1 at ``g`` threads per group: the wrapper at 1, its uncounted
        launcher at 4 (the group form K2, K3, K7, K7' and K8 use)."""
        if g == 1:
            return limbs.field_op(op, x, y, field)
        return limbs._launch_field_op(op, x, y, field, g)

    def every_group_picked(kid, groups):
        """Each group size is the launcher's pick at a checked batch."""
        picked = {g for g, _ in groups.values()}
        check(picked == set(p256.GROUP_SIZES),
              f"{kid}: the checked batches pick T in {sorted(picked)}, "
              f"not every size of {p256.GROUP_SIZES}")

    kernels = {}

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 2")
    # -- phase 2: K1 -----------------------------------------------------------
    nk1 = 4096
    k1_err = 0
    for field, mod in (("p", p256.P), ("n", p256.N), ("ed", ed25519.P)):
        spec = limbs.field_spec(field)
        edges = [0, 1, 2, mod - 1, mod - 2, (1 << 256) - 1 - mod, mod >> 1, 1 << 255]
        va = edges + [rng.randbelow(mod) for _ in range(nk1 - len(edges))]
        vb = edges[::-1] + [rng.randbelow(mod) for _ in range(nk1 - len(edges))]
        a = torch.from_numpy(limbs.to_limbs_batch(va).astype(np.uint16)).to(dev)
        b = torch.from_numpy(limbs.to_limbs_batch(vb).astype(np.uint16)).to(dev)
        # Mod the primes the ops are the ones specialised to each, at one
        # thread per lane and in the group of 4 the kernels use; mod p where an op takes a
        # first operand of any 256 bits (a product by b < p), 8 of them in
        # [p, 2^256) (mod 2^255 - 19 the edges hold two such operands).
        groups = (1,) if field == "n" else (1, 4)
        wide = None
        if field == "p":
            big = [mod, mod + 1, (1 << 256) - 1] + [
                mod + rng.randbelow((1 << 256) - mod) for _ in range(5)]
            wide = torch.from_numpy(
                limbs.to_limbs_batch(va[:-len(big)] + big).astype(np.uint16)).to(dev)
        for op in limbs.FIELD_OPS:
            x = wide if wide is not None and op in ("mul", "to_mont", "from_mont") else a
            want = limbs.field_op_plain(op, spec, x.to(torch.int64), b.to(torch.int64))
            for g in groups:
                got = k1(op, x, b, field, g).to(torch.int64)
                err = int((got - want).abs().max())
                k1_err = max(k1_err, err)
                check(err == 0, f"K1 {op} mod {field} T={g}: kernel != plain (max |err| {err})")
        print(f"K1 mod {field}: {len(limbs.FIELD_OPS)} ops x {nk1} elements exact"
              + " at T = " + ", ".join(map(str, groups))
              + (" (mul, to_mont, from_mont also on 8 first operands in [p, 2^256))"
                 if field == "p" else ""))
        if field != "n":
            print(f"K1 mul mod {field} B=4096 on the device: " + ", ".join(
                f"T={g} {graph_ms(torch, lambda: k1('mul', a, b, field, g)):.4f} ms"
                for g in groups))
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    k1_ms = cuda_ms(torch, lambda: limbs.field_op("mul", a, b, "n"))
    k1_dev_ms = graph_ms(torch, lambda: limbs.field_op("mul", a, b, "n"))
    k1_plain_ms = cuda_ms(torch, lambda: limbs.mont_mul(p256.ORDER, a64, b64), reps=5)
    k1_bound, k1_by = bound(nk1 * ORDER_MUL, nk1 * 3 * 32)
    kernels["K1"] = dict(ms=k1_ms, device_ms=k1_dev_ms, plain_ms=k1_plain_ms,
                         bound_ms=k1_bound, bound_by=k1_by, max_abs_err=k1_err)
    print(f"K1 mont_mul B={nk1}: {k1_ms:.4f} ms per call, {k1_dev_ms:.4f} ms on the "
          f"device (plain {k1_plain_ms:.3f} ms, bound {k1_bound:.5f} ms by {k1_by})")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 3")
    # -- phase 3: K2 -----------------------------------------------------------
    keys = [hc.keygen(rng) for _ in range(8)]
    k2 = {}
    # The group size the launcher picked and each group size's device ms,
    # per batch.
    k2_groups = {}
    # The phase's rows and verdicts, which phase 12 feeds to K2'.
    k2_runs = {}
    # cfg4's bucket, the deployment bucket, a large batch and the bench's
    # verify batch (K2' runs there; phase 12 holds it to these rows).
    for bsz in (bench.CFG4_BUCKET, 512, 16384, bench.BATCH):
        # Distinct rows at each size: fresh digests, signed on the card.
        items = verify_items(hc, rng, keys, bsz)
        crafted = set(range(12, bsz, 64))
        rows = craft_r2_rows(p256.prepare_packed(items, bsz), sorted(crafted))
        live = rows[rows[:, p256.PACKED_COLS - 1] != 0]  # invalid lanes are zeros
        check(len({r.tobytes() for r in live}) == len(live), f"K2 B={bsz}: rows repeat")
        rows_d = torch.from_numpy(rows).to(dev)
        got = p256.ecdsa_verify_kernel_packed(rows_d)
        torch.cuda.synchronize()
        # The plain version on every lane up to 16,384; at the bench's
        # batch on the crafted and adversarial lanes and an even spread
        # (every plain call costs seconds, whatever its width).
        sub = (slice(None) if bsz <= 16384 else
               spread(bsz, [0, 1, 2] + sorted(crafted)[:8] + list(range(8, bsz, 16))[:24]))
        # (CUDA has no uint16 gather: the lanes are picked on the host.)
        want = p256.verify_packed_plain(torch.from_numpy(rows[sub]).to(dev))
        mism = int((got[sub] != want).sum())
        check(mism == 0, f"K2 B={bsz}: {mism} lanes differ from the plain version")
        got_np = got.cpu().numpy()
        # The host oracle is pure Python: every lane up to 512, a spread
        # sample (a prime stride, so it meets every lane residue) above.
        # Lanes 0-2 (Q = G, -G, 2G) are left to the plain version: their
        # ladders can meet the incomplete add's exceptional case, which
        # the reference (and so the port) rejects even for an honest
        # signature.
        oracle = range(bsz) if bsz <= 512 else range(5, bsz, 37 if bsz <= 16384 else 73)
        oracle = [i for i in oracle if i > 2 and i not in crafted]
        host = {i: hc.ecdsa_verify_py(*items[i]) for i in oracle}
        check(sum(host.values()) > len(host) // 2, f"K2 B={bsz}: too few honest lanes")
        for i, ok in host.items():
            if bool(got_np[i]) != ok:
                fail(f"K2 B={bsz} lane {i}: kernel {bool(got_np[i])} != host {ok}")
        ms = cuda_ms(torch, lambda: p256.ecdsa_verify_kernel_packed(rows_d))
        dev_ms = graph_ms(torch, lambda: p256.ecdsa_verify_kernel_packed(rows_d), copies=5)
        imads = k2_imads(rows)
        b_ms, b_by = bound(imads, bsz * (p256.PACKED_COLS * 2 + 1))
        k2[bsz] = (ms, dev_ms, b_ms, b_by)
        k2_runs[bsz] = (rows, got_np, sorted(crafted))
        n_plain = bsz if bsz <= 16384 else len(sub)
        print(f"K2 B={bsz}: verdicts equal plain on {n_plain} lanes and host on "
              f"{len(host)} honest/forged lanes ({int(got_np.sum())} accepted); "
              f"{ms:.3f} ms per batch ({dev_ms:.3f} on the device), "
              f"{bsz / ms * 1e3:,.0f} verifies/s, bound {b_ms:.4f} ms by {b_by} "
              f"({imads / bsz:,.0f} IMAD issues per lane)")
        k2_groups[bsz] = every_group(
            "K2", bsz, got_np, dev_ms, lambda g: p256._launch_verify_packed(rows_d, g),
            ptx["p256_verify"], "p256_verify_kernel")
        if bsz == 512:
            plain_ms = cuda_ms(
                torch, lambda: p256.verify_packed_plain(rows_d), reps=1, warm=1
            )
    every_group_picked("K2", k2_groups)
    kernels["K2"] = kernel_entry(k2, 512, plain_ms, groups=k2_groups)
    print(f"K2 plain B=512: {plain_ms:.1f} ms")
    print("K2 device ms before (one thread per lane on the generic field ops, "
          "PERF.md) / after: " + before_after(kernels, {"K2": K2_BEFORE_MS}))

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 4")
    # -- phase 4: K3 -----------------------------------------------------------
    k3 = {}
    k3_groups = {}
    table_d = p256.comb_table_limbs().to(dev)
    # cfg4's bucket, the deployment bucket, the bench's sign batch and
    # sign-queue bucket, and its large sign batch.
    for bsz in (bench.CFG4_BUCKET, 512, bench.SIGN_BATCH, bench.BATCH):
        nonces = [1, 2, p256.N - 1] + [rng.randbelow(p256.N - 1) + 1
                                       for _ in range(bsz - 3)]
        k_d = torch.from_numpy(limbs.to_limbs_batch(nonces).astype(np.uint16)).to(dev)
        got = p256.ecdsa_kg_kernel(k_d).to(torch.int64)
        torch.cuda.synchronize()
        # The plain version on every lane up to the sign batch, on an even
        # spread (k = 1, 2, n - 1 included) at the large one.
        sub = slice(None) if bsz <= bench.SIGN_BATCH else spread(bsz, [0, 1, 2])
        want = p256.kg_plain(k_d.to(torch.int64)[sub], table_d)
        err = int((got[sub] - want).abs().max())
        check(err == 0, f"K3 B={bsz}: kernel != plain (max |err| {err})")
        sign_items = [(keys[i % len(keys)][0], rng.bytes(32)) for i in range(bsz)]
        sigs = p256.sign_batch(sign_items, bucket=bsz)
        host = range(0, bsz, max(1, bsz // 32))
        for i in host:
            d, dg = sign_items[i]
            check(sigs[i] == hc.ecdsa_sign_py(d, dg), f"K3 B={bsz}: signature {i} != host")
        ms = cuda_ms(torch, lambda: p256.ecdsa_kg_kernel(k_d))
        dev_ms = graph_ms(torch, lambda: p256.ecdsa_kg_kernel(k_d))
        b_ms, b_by = bound(k3_imads(k_d.cpu().numpy()), bsz * (32 + 64) + 65536)
        k3[bsz] = (ms, dev_ms, b_ms, b_by)
        n_plain = bsz if bsz <= bench.SIGN_BATCH else len(sub)
        print(f"K3 B={bsz}: (X, Z) equal plain on {n_plain} lanes (k = 1, 2, n-1 "
              f"included); {len(host)} signatures byte-identical to host; {ms:.3f} ms "
              f"per batch ({dev_ms:.3f} on the device), bound {b_ms:.4f} ms by {b_by}")
        k3_groups[bsz] = every_group(
            "K3", bsz, got.cpu().numpy().astype(np.uint16), dev_ms,
            lambda g: p256._launch_kg(k_d, g),
            ptx["p256_kg"], "p256_kg_kernel")
        if bsz == 512:
            k3_plain_ms = cuda_ms(torch, lambda: p256.kg_plain(k_d, table_d), reps=2, warm=1)
            k3_nonces = k_d  # phase 19 splits these over two devices
    every_group_picked("K3", k3_groups)
    kernels["K3"] = kernel_entry(k3, 512, k3_plain_ms, groups=k3_groups)
    print(f"K3 plain B=512: {k3_plain_ms:.1f} ms")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 5")
    # -- phase 5: the authentication flow (main path) --------------------------
    n, f, n_clients, n_requests = 4, 1, 4, 512
    flow_keys = {
        "n": n,
        "replica_priv": [], "client_priv": [], "usig_priv": [],
        "usig_kind": "ecdsa",
        "usig_epoch": [rng.bytes(8) for _ in range(n)],
        "usig_counter": [1] * n,
    }
    rep = [hc.keygen(rng) for _ in range(n)]
    cli = [hc.keygen(rng) for _ in range(n_clients)]
    flow_keys["replica_priv"] = [d for d, _ in rep]
    flow_keys["replica_pub"] = _pub_rows([q for _, q in rep])
    flow_keys["client_priv"] = [d for d, _ in cli]
    flow_keys["client_pub"] = _pub_rows([q for _, q in cli])
    flow_keys["usig_priv"] = [hc.keygen(rng)[0] for _ in range(n)]
    engines = [BatchVerifier(max_batch=512, buckets=(512,)) for _ in range(n)]
    client_engines = [BatchVerifier(max_batch=512, buckets=(512,))
                      for _ in range(n_clients)]
    r_auths, c_auths = authenticators_from_keys(
        flow_keys, engines=engines, client_engines=client_engines
    )
    # Every kernel wrapper's launch count; each path below sets them to 0
    # just before it runs and reads them just after.
    wrappers = {
        "K1": limbs.field_op,
        "K2": p256.ecdsa_verify_kernel_packed,
        "K3": p256.ecdsa_kg_kernel,
        "K5": sha256.sha256_compress,
        "K6": hmac_sha256.hmac_verify_kernel_packed,
        "K7": ed25519.ed25519_verify_kernel_packed,
        "K8": ed25519.ed25519_rb_kernel,
        "K4": p256.ecdsa_kg_ladder_kernel,
        "K2'": p256.ecdsa_verify_kernel,
        "K6'": hmac_sha256.hmac_verify_kernel,
        "K6s": hmac_sha256.hmac_sign_kernel,
        "K7'": ed25519.ed25519_verify_kernel,
    }

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {kid: w.launches for kid, w in wrappers.items()}

    reset_counts()
    # The flow: every count above moves only from here ...
    t0 = time.perf_counter()
    result = asyncio.run(run_auth_flow(r_auths, c_auths, n_requests, 64, f))
    flow_s = time.perf_counter() - t0
    # ... to here.
    launches = read_counts()
    path_launches = {"auth_flow": launches}
    check_flow(result, n_requests)
    check(launches["K2"] > 0 and launches["K3"] > 0,
          f"flow: a kernel of the path was not launched {launches}")
    for label, eng in [(f"replica{i}", e) for i, e in enumerate(engines)] + [
        (f"client{i}", e) for i, e in enumerate(client_engines)
    ]:
        for line in check_engine(eng, label):
            print(line)
    print(f"flow: {json.dumps(result['phases'])}")
    print("flow steps (host wall s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in result["step_s"].items()))
    print(f"flow: n={n} f={f} clients={n_clients} requests={n_requests}: "
          f"{flow_s:.2f} s wall, {result['committed_requests'] / flow_s:,.1f} "
          f"committed requests/s, launches {launches}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6")
    # -- phase 6: K5 and K6 -----------------------------------------------------
    np_rng = np.random.default_rng(20261017)
    nk5 = 4096
    st_np = np_rng.integers(0, 2**32, size=(nk5, 8), dtype=np.uint32)
    blk_np = np_rng.integers(0, 2**32, size=(nk5, 16), dtype=np.uint32)
    st_np[0], blk_np[0] = sha256.IV, sha256.pad_message(b"abc")[0]
    st_d, blk_d = sha256.as_i32(st_np).to(dev), sha256.as_i32(blk_np).to(dev)
    got = sha256.sha256_compress(st_d, blk_d)
    torch.cuda.synchronize()
    want = sha256.compress(st_d, blk_d)
    k5_err = int(((got.to(torch.int64) & 0xFFFFFFFF) - want).abs().max())
    check(k5_err == 0, f"K5: kernel != plain (max |err| {k5_err})")
    check(sha256.words_to_bytes(sha256.as_u32(got[0])) == hashlib.sha256(b"abc").digest(),
          "K5: lane 0 is not SHA-256('abc')")
    k5_ms = cuda_ms(torch, lambda: sha256.sha256_compress(st_d, blk_d))
    k5_dev_ms = graph_ms(torch, lambda: sha256.sha256_compress(st_d, blk_d))
    k5_plain_ms = cuda_ms(torch, lambda: sha256.compress(st_d, blk_d), reps=3, warm=1)
    k5_bound, k5_by = bound(nk5 * int_mix(SHA256_ALU_OPS, SHA256_ADD_OPS),
                            nk5 * (8 + 16 + 8) * 4)
    kernels["K5"] = dict(ms=k5_ms, device_ms=k5_dev_ms, plain_ms=k5_plain_ms,
                         bound_ms=k5_bound, bound_by=k5_by, max_abs_err=k5_err)
    print(f"K5 B={nk5}: equal plain on every word, lane 0 = SHA-256('abc'); "
          f"{k5_ms:.4f} ms per call, {k5_dev_ms:.4f} ms on the device (plain "
          f"{k5_plain_ms:.3f} ms, bound {k5_bound:.5f} ms by {k5_by}); device ms "
          "before its redesign (PERF.md) / after: "
          + before_after(kernels, {"K5": SHA_BEFORE_MS["K5"]}))

    k6 = {}
    k6_runs = {}  # rows, verdicts and forged lanes, for phase 12
    # cfg4's bucket, the deployment bucket, cluster C's bucket, the
    # bench's HMAC batch (K6' and K6s run there) and a larger batch, which
    # no path sends.
    for bsz in (bench.CFG4_BUCKET, 512, 1024, bench.HMAC_BATCH, 16384):
        rows, expect, forged_idx = hmac_rows(np_rng, bsz)
        live = rows[rows.any(axis=1)]
        check(len({r.tobytes() for r in live}) == len(live), f"K6 B={bsz}: rows repeat")
        rows_d = sha256.as_i32(rows).to(dev)
        got = hmac_sha256.hmac_verify_kernel_packed(rows_d)
        torch.cuda.synchronize()
        want = hmac_sha256.hmac_verify_plain(rows_d)
        mism = int((got != want).sum())
        check(mism == 0, f"K6 B={bsz}: {mism} lanes differ from the plain version")
        got_np = got.cpu().numpy()
        bad = np.nonzero(got_np != expect)[0]
        check(len(bad) == 0, f"K6 B={bsz}: lanes {bad[:8].tolist()} differ from Python hmac")
        check(not got_np[forged_idx].any(), f"K6 B={bsz}: a forged lane accepted")
        k6_runs[bsz] = (rows, got_np, forged_idx)
        ms = cuda_ms(torch, lambda: hmac_sha256.hmac_verify_kernel_packed(rows_d))
        dev_ms = graph_ms(torch, lambda: hmac_sha256.hmac_verify_kernel_packed(rows_d))
        b_ms, b_by = bound(bsz * int_mix(HMAC_ALU_OPS, HMAC_ADD_OPS),
                           bsz * (hmac_sha256.PACKED_COLS * 4 + 1))
        k6[bsz] = (ms, dev_ms, b_ms, b_by)
        print(f"K6 B={bsz}: verdicts equal plain and Python hmac on every lane "
              f"({int(got_np.sum())} accepted, {len(forged_idx)} forged, "
              f"{int((~rows.any(axis=1)).sum())} zero rows); {ms:.4f} ms per call, "
              f"{dev_ms:.4f} ms on the device ({bsz / dev_ms * 1e3:,.0f} verifies/s), "
              f"bound {b_ms:.5f} ms by {b_by}")
        if bsz == 512:
            k6_plain_ms = cuda_ms(
                torch, lambda: hmac_sha256.hmac_verify_plain(rows_d), reps=3, warm=1
            )
    kernels["K6"] = kernel_entry(k6, 512, k6_plain_ms)
    print(f"K6 plain B=512: {k6_plain_ms:.1f} ms")
    print("K6 device ms before its redesign (one thread per lane, four compressions "
          "in series; PERF.md) / after (B=16384: no path sends it): "
          + before_after(kernels, {"K6": SHA_BEFORE_MS["K6"]}))

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7")
    # -- phase 7: K7 and K8 ----------------------------------------------------------
    ed_seeds = [rng.bytes(32) for _ in range(8)]
    k7 = {}
    k7_runs = {}  # rows and verdicts, for phase 12
    # Cluster C's bucket, a large batch and the bench's verify batch (K7'
    # runs there; phase 12 holds it to these rows).
    for bsz in (1024, 16384, bench.BATCH):
        # Distinct rows at each size (fresh messages, signed on the card);
        # the last 8 rows are engine padding (all zero, valid = 0).
        items = ed25519_items(hc, rng, ed_seeds, bsz - 8)
        rows = ed25519.prepare_packed(items, bsz)
        live = rows[rows[:, ed25519.PACKED_COLS - 1] != 0]
        check(len({r.tobytes() for r in live}) == len(live), f"K7 B={bsz}: rows repeat")
        rows_d = torch.from_numpy(rows).to(dev)
        got = ed25519.ed25519_verify_kernel_packed(rows_d)
        torch.cuda.synchronize()
        adversarial = list(range(8, bsz - 8, 16))
        # The plain version on every lane up to 16,384; at the bench's
        # batch on the adversarial and padding lanes and an even spread.
        sub = (slice(None) if bsz <= 16384 else
               spread(bsz, adversarial[:28] + list(range(bsz - 8, bsz))))
        want = ed25519.verify_packed_plain(torch.from_numpy(rows[sub]).to(dev))
        mism = int((got[sub] != want).sum())
        check(mism == 0, f"K7 B={bsz}: {mism} lanes differ from the plain version")
        got_np = got.cpu().numpy()
        check(not got_np[bsz - 8:].any(), f"K7 B={bsz}: a padding row accepted")
        check(not got_np[adversarial].any(), f"K7 B={bsz}: an adversarial lane accepted")
        k7_runs[bsz] = (rows, got_np)
        # The host oracle is pure Python: a spread sample (a prime stride)
        # plus the first two adversarial lanes of each kind.
        oracle = sorted(set(range(3, bsz - 8, {1024: 7, 16384: 97}.get(bsz, 193)))
                        | set(adversarial[:14]))
        host = {i: hc.ed25519_verify_py(*items[i]) for i in oracle}
        check(sum(host.values()) > len(host) // 2, f"K7 B={bsz}: too few honest lanes")
        for i, ok in host.items():
            if bool(got_np[i]) != ok:
                fail(f"K7 B={bsz} lane {i}: kernel {bool(got_np[i])} != host {ok}")
        ms = cuda_ms(torch, lambda: ed25519.ed25519_verify_kernel_packed(rows_d))
        dev_ms = graph_ms(torch, lambda: ed25519.ed25519_verify_kernel_packed(rows_d),
                          copies=5)
        imads = k7_imads(rows)
        b_ms, b_by = bound(imads, bsz * (ed25519.PACKED_COLS * 2 + 1))
        k7[bsz] = (ms, dev_ms, b_ms, b_by)
        n_plain = bsz if bsz <= 16384 else len(sub)
        print(f"K7 B={bsz}: verdicts equal plain on {n_plain} lanes and host on "
              f"{len(host)} lanes ({int(got_np.sum())} accepted, {len(adversarial)} "
              f"adversarial, 8 zero rows); {ms:.3f} ms per batch ({dev_ms:.3f} on the "
              f"device, {bsz / dev_ms * 1e3:,.0f} verifies/s), bound {b_ms:.4f} ms by {b_by} "
              f"({imads / bsz:,.0f} IMAD issues per lane)")
        if bsz == 1024:
            k7_plain_ms = cuda_ms(
                torch, lambda: ed25519.verify_packed_plain(rows_d), reps=1, warm=1
            )
    kernels["K7"] = kernel_entry(k7, 1024, k7_plain_ms)
    print(f"K7 plain B=1024: {k7_plain_ms:.1f} ms")

    k8 = {}
    table_d = ed25519.comb_table_limbs().to(dev)
    # Cluster C's bucket, the bench's sign-queue bucket and sign batch,
    # and a large batch.
    for bsz in (1024, bench.SIGN_QUEUE_BUCKET, bench.ED_SIGN_BATCH, 16384):
        nonces = [0, 1, ed25519.L - 1] + [rng.randbelow(ed25519.L) for _ in range(bsz - 3)]
        r_np = limbs.to_limbs_batch(nonces).astype(np.uint16)
        r_d = torch.from_numpy(r_np).to(dev)
        got = ed25519.ed25519_rb_kernel(r_d).to(torch.int64)
        torch.cuda.synchronize()
        want = ed25519.rb_plain(r_d, table_d)
        err = int((got - want).abs().max())
        check(err == 0, f"K8 B={bsz}: kernel != plain (max |err| {err})")
        ms = cuda_ms(torch, lambda: ed25519.ed25519_rb_kernel(r_d))
        dev_ms = graph_ms(torch, lambda: ed25519.ed25519_rb_kernel(r_d))
        imads = k8_imads(r_np)
        b_ms, b_by = bound(imads, bsz * (32 + 96) + table_d.numel() * 2)
        k8[bsz] = (ms, dev_ms, b_ms, b_by)
        print(f"K8 B={bsz}: (X, Y, Z) equal plain bit for bit (r = 0, 1, L-1 "
              f"included); {ms:.3f} ms per batch ({dev_ms:.3f} on the device), "
              f"bound {b_ms:.5f} ms by {b_by} ({imads / bsz:,.0f} IMAD issues per lane)")
        if bsz == 1024:
            k8_plain_ms = cuda_ms(torch, lambda: ed25519.rb_plain(r_d, table_d),
                                  reps=2, warm=1)
            k8_nonces = r_d  # phase 19 splits these over two devices
    sign_items = [(ed_seeds[i % len(ed_seeds)], rng.bytes(32)) for i in range(1024)]
    sigs = ed25519.sign_batch(sign_items, bucket=1024)
    for i in range(0, 1024, 4):
        check(sigs[i] == hc.ed25519_sign(*sign_items[i]), f"K8: signature {i} != host")
    kernels["K8"] = kernel_entry(k8, 1024, k8_plain_ms)
    print(f"K8 plain B=1024: {k8_plain_ms:.1f} ms; 256 sign_batch signatures "
          f"byte-identical to hostcrypto.ed25519_sign")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 8")
    # -- phases 8 to 10: the in-process clusters -----------------------------------
    cluster_phases = (
        # (label, n, f, signature scheme, usig kind, bucket, clients, depth,
        #  requests, forged, the path's kernels)
        ("cluster_ecdsa", 7, 3, "ecdsa-p256", "ecdsa", 512, 100, 24,
         CLUSTER_A_REQUESTS, 0, ("K2", "K3")),
        ("cluster_hmac", 4, 1, "ecdsa-p256", "hmac", 512, 50, 24, 4000, 8,
         ("K2", "K3", "K6")),
        ("cluster_ed25519", 31, 15, "ed25519", "hmac", 1024, 50, 24,
         CLUSTER_C_REQUESTS, 8, ("K6", "K7", "K8")),
    )
    for (label, cn, cf, scheme, kind, bucket, ncl, depth, nreq, nforged,
         need) in cluster_phases:
        ckeys = make_test_keys(cn, ncl + (1 if nforged else 0), kind, rng=rng,
                               scheme=scheme)
        shared = BatchVerifier(max_batch=bucket, buckets=(bucket,))
        res = asyncio.run(run_cluster(
            ckeys, cf, shared, ncl, depth, nreq, (reset_counts, read_counts),
            forged=nforged,
        ))
        check_cluster(res, label)
        win = res["window"]
        check(all(win[k] > 0 for k in need),
              f"{label}: a kernel of the path was not launched {win}")
        path_launches[label] = win
        for line in check_engine(shared, label):
            print(line)
        # Kernel-busy share, estimated: each launch at its kernel's device
        # time from phases 3, 4, 6 and 7 at the engine's bucket (K6 at 512
        # in cluster C too: it was timed at 512 and 16,384 only, and a K6
        # launch is under 0.01 ms at either), over the drive's wall time.
        busy_s = sum(
            win[kid] * kernels[kid]["device_ms"] for kid in need
        ) / 1e3
        dropped = res["dropped"]
        print(f"{label}: n={cn} f={cf} scheme={scheme} usig={kind} bucket={bucket} "
              f"clients={ncl} depth={depth} requests={res['requests']}: "
              f"{res['wall_s']:.2f} s wall (kernel-busy estimate {busy_s:.3f} s, "
              f"{busy_s / res['wall_s']:.1%}; host CPU {res['host_cpu_s']:.2f} s, "
              f"{res['host_cpu_s'] / res['wall_s']:.2f} per wall s), "
              f"{res['committed_per_s']:,.1f} committed requests/s, latency p50 "
              f"{res['latency_p50_ms']:.1f} ms p99 {res['latency_p99_ms']:.1f} ms, "
              f"forged {nforged} (replies {res['replies_to_forged']}, dropped "
              f"{min(dropped)}-{max(dropped)} per replica), launches {win}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 11")
    # -- phase 11: K4 and the signing path through it -----------------------------
    k4 = {}
    k4_groups = {}
    ladder_window = {}
    for bsz in (512, 16384):
        # RFC 6979 nonces of bsz - 4 items, then k = 1, 2, n - 1 and one
        # random k < n (their (d, z, k) written into sign_finish's meta).
        items = [(keys[i % len(keys)][0], rng.bytes(32)) for i in range(bsz - 4)]
        k_np, meta_k = p256.sign_prepare(items, bsz)
        extra_k = [1, 2, p256.N - 1, rng.randbelow(p256.N - 1) + 1]
        k_np[bsz - 4:] = limbs.to_limbs_batch(extra_k)
        extra = [(keys[0][0], rng.bytes(32)) for _ in extra_k]
        all_items = items + extra
        meta_k = meta_k + [(d, int.from_bytes(dg, "big") % p256.N, k)
                           for (d, dg), k in zip(extra, extra_k)]
        reset_counts()
        # The signing path through K4: every count moves only from here ...
        k_d = torch.from_numpy(k_np).to(dev)
        xz4 = p256.ecdsa_kg_ladder_kernel(k_d).cpu().numpy()
        sigs4 = p256.sign_finish(all_items, meta_k, xz4)
        # ... to here.
        for kid, v in read_counts().items():
            ladder_window[kid] = ladder_window.get(kid, 0) + v
        check(bool((xz4[:, 1] != 0).any(axis=1).all()),
              f"K4 B={bsz}: a lane has Z = 0 (it would go to the host signer)")
        sigs3 = p256.sign_finish(all_items, meta_k, p256.ecdsa_kg_kernel(k_d).cpu().numpy())
        bad = [i for i in range(bsz) if sigs4[i] != sigs3[i]]
        check(not bad, f"K4 B={bsz}: signatures differ from K3's on lanes {bad[:8]}")
        host = range(0, bsz - 4, max(1, (bsz - 4) // 24))
        for i in host:
            check(sigs4[i] == hc.ecdsa_sign_py(*items[i]),
                  f"K4 B={bsz}: signature {i} != host")
        sub = sorted(set(range(0, bsz - 4, (bsz - 4) // 60)) | set(range(bsz - 4, bsz)))
        want = p256.kg_ladder_plain(k_d.to(torch.int64)[sub])
        err = int((torch.from_numpy(xz4.astype(np.int64))[sub].to(dev) - want).abs().max())
        check(err == 0, f"K4 B={bsz}: kernel != plain on {len(sub)} lanes (max |err| {err})")
        ms = cuda_ms(torch, lambda: p256.ecdsa_kg_ladder_kernel(k_d))
        dev_ms = graph_ms(torch, lambda: p256.ecdsa_kg_ladder_kernel(k_d), copies=5)
        imads = k4_imads(k_np)
        b_ms, b_by = bound(imads, bsz * (32 + 64))
        k4[bsz] = (ms, dev_ms, b_ms, b_by)
        print(f"K4 B={bsz}: (X, Z) equal plain on {len(sub)} lanes (k = 1, 2, n-1 "
              f"included), no Z = 0; signatures byte-identical to K3's on every lane "
              f"and to host on {len(host)}; {ms:.3f} ms per batch ({dev_ms:.3f} on the "
              f"device), bound {b_ms:.4f} ms by {b_by} ({imads / bsz:,.0f} IMAD issues "
              f"per lane)")
        k4_groups[bsz] = every_group(
            "K4", bsz, xz4, dev_ms, lambda g: p256._launch_kg_ladder(k_d, g),
            ptx["p256_kg_ladder"], "p256_kg_ladder_kernel")
        if bsz == 512:
            k4_plain_ms = cuda_ms(torch, lambda: p256.kg_ladder_plain(k_d), reps=1, warm=0)
    path_launches["sign_ladder"] = ladder_window
    check(ladder_window["K4"] > 0, f"sign_ladder: K4 was not launched {ladder_window}")
    every_group_picked("K4", k4_groups)
    kernels["K4"] = kernel_entry(k4, 512, k4_plain_ms, groups=k4_groups)
    print(f"K4 plain B=512: {k4_plain_ms:.1f} ms")
    print("K4 device ms before its redesign (one thread per lane; PERF.md) / after: "
          + before_after(kernels, K4_BEFORE_MS))

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 12")
    # -- phase 12: the multi-array forms on the packed phases' rows ----------------
    # Each form at its packed sibling's deployment bucket, a large batch
    # and the bench's batch (the shapes the bench launches it at).
    L = limbs.NLIMBS
    runs, arr_groups = {}, {}
    for bsz in (512, 16384, bench.BATCH):
        rows, packed_np, crafted = k2_runs[bsz]
        arrays = [rows[:, k * L : (k + 1) * L].astype(np.uint32) for k in range(6)]
        arrays += [rows[:, 6 * L] != 0, rows[:, 6 * L + 1] != 0]
        ta = limbs.arrays_to(arrays, dev)
        got = p256.ecdsa_verify_kernel(*ta)
        torch.cuda.synchronize()
        got_np = got.cpu().numpy()
        bad = np.nonzero(got_np != packed_np)[0]
        check(len(bad) == 0, f"K2' B={bsz}: lanes {bad[:8].tolist()} differ from K2")
        sub = spread(bsz, [0, 1, 2] + crafted[:8] + list(range(8, bsz, 16))[:24])
        want = p256.verify_plain(*(t[sub] for t in ta))
        mism = int((got[sub] != want).sum())
        check(mism == 0, f"K2' B={bsz}: {mism} of {len(sub)} lanes differ from plain")
        ms = cuda_ms(torch, lambda: p256.ecdsa_verify_kernel(*ta))
        dev_ms = graph_ms(torch, lambda: p256.ecdsa_verify_kernel(*ta), copies=5)
        b_ms, b_by = bound(k2_imads(rows), bsz * (6 * L * 4 + 2 + 1))
        runs[bsz] = (ms, dev_ms, b_ms, b_by)
        print(f"K2' B={bsz}: verdicts equal K2's on every lane and plain on {len(sub)} "
              f"(Q = G, -G, 2G, r2 and adversarial lanes included); {ms:.3f} ms per batch "
              f"({dev_ms:.3f} on the device), bound {b_ms:.4f} ms by {b_by}")
        arr_groups[bsz] = every_group(
            "K2'", bsz, got_np, dev_ms, lambda g: p256._launch_verify_arrays(ta, g),
            ptx["p256_verify"], "p256_verify_arrays_kernel")
        if bsz == 512:
            plain_ms = cuda_ms(torch, lambda: p256.verify_plain(*ta), reps=1, warm=0)
    every_group_picked("K2'", arr_groups)
    kernels["K2'"] = kernel_entry(runs, 512, plain_ms, groups=arr_groups)

    runs = {}
    for bsz in (1024, 16384, bench.BATCH):
        rows, packed_np = k7_runs[bsz]
        arrays = [rows[:, k * L : (k + 1) * L].astype(np.uint32) for k in range(5)]
        arrays += [rows[:, 5 * L].astype(np.uint32), rows[:, 5 * L + 1] != 0]
        te = limbs.arrays_to(arrays, dev)
        got = ed25519.ed25519_verify_kernel(*te)
        torch.cuda.synchronize()
        got_np = got.cpu().numpy()
        bad = np.nonzero(got_np != packed_np)[0]
        check(len(bad) == 0, f"K7' B={bsz}: lanes {bad[:8].tolist()} differ from K7")
        sub = spread(bsz, list(range(8, bsz - 8, 16))[:28] + list(range(bsz - 8, bsz)))
        want = ed25519.verify_plain(*(t[sub] for t in te))
        mism = int((got[sub] != want).sum())
        check(mism == 0, f"K7' B={bsz}: {mism} of {len(sub)} lanes differ from plain")
        ms = cuda_ms(torch, lambda: ed25519.ed25519_verify_kernel(*te))
        dev_ms = graph_ms(torch, lambda: ed25519.ed25519_verify_kernel(*te), copies=5)
        b_ms, b_by = bound(k7_imads(rows), bsz * (5 * L * 4 + 4 + 1 + 1))
        runs[bsz] = (ms, dev_ms, b_ms, b_by)
        print(f"K7' B={bsz}: verdicts equal K7's on every lane and plain on {len(sub)} "
              f"(adversarial and zero rows included); {ms:.3f} ms per batch ({dev_ms:.3f} "
              f"on the device), bound {b_ms:.4f} ms by {b_by}")
        if bsz == 1024:
            plain_ms = cuda_ms(torch, lambda: ed25519.verify_plain(*te), reps=1, warm=0)
    kernels["K7'"] = kernel_entry(runs, 1024, plain_ms)
    print("Ed25519 device ms before (one thread per lane on the generic field ops, "
          "PERF.md) / after: " + before_after(kernels, ED_BEFORE_MS))

    import hmac as py_hmac

    runs, sign_runs = {}, {}
    for bsz in (512, bench.HMAC_BATCH, 16384):
        rows, packed_np, forged_idx = k6_runs[bsz]
        kk, mm, mc = (sha256.as_i32(np.ascontiguousarray(rows[:, a : a + 8])).to(dev)
                      for a in (0, 8, 16))
        got = hmac_sha256.hmac_verify_kernel(kk, mm, mc)
        torch.cuda.synchronize()
        check(bool((got.cpu().numpy() == packed_np).all()), f"K6' B={bsz}: differs from K6")
        check(bool((got == hmac_sha256.hmac_verify_plain3(kk, mm, mc)).all()),
              f"K6' B={bsz}: differs from plain")
        macs = hmac_sha256.hmac_sign_kernel(kk, mm)
        torch.cuda.synchronize()
        want = np.stack([
            np.frombuffer(py_hmac.new(r[:8].astype(">u4").tobytes(),
                                      r[8:16].astype(">u4").tobytes(),
                                      hashlib.sha256).digest(), ">u4").astype(np.uint32)
            for r in rows
        ])
        check(np.array_equal(sha256.as_u32(macs), want), f"K6s B={bsz}: MACs != Python hmac")
        plain_macs = hmac_sha256.hmac_sign_plain(kk, mm)
        check(bool(((macs.to(torch.int64) & 0xFFFFFFFF) == plain_macs).all()),
              f"K6s B={bsz}: MACs != plain")
        for kid, fn, table, ops, nbytes in (
            ("K6'", lambda: hmac_sha256.hmac_verify_kernel(kk, mm, mc), runs,
             int_mix(HMAC_ALU_OPS, HMAC_ADD_OPS), 96 + 1),
            ("K6s", lambda: hmac_sha256.hmac_sign_kernel(kk, mm), sign_runs,
             int_mix(HMAC_SIGN_ALU_OPS, HMAC_ADD_OPS), 64 + 32),
        ):
            ms, dev_ms = cuda_ms(torch, fn), graph_ms(torch, fn)
            b_ms, b_by = bound(bsz * ops, bsz * nbytes)
            table[bsz] = (ms, dev_ms, b_ms, b_by)
            print(f"{kid} B={bsz}: {ms:.4f} ms per call, {dev_ms:.4f} ms on the device, "
                  f"bound {b_ms:.5f} ms by {b_by}")
        print(f"K6'/K6s B={bsz}: verdicts equal K6's and plain on every lane "
              f"({len(forged_idx)} forged, 8 zero rows); MACs equal Python hmac and "
              f"plain on every lane")
        if bsz == 512:
            k6v_plain = cuda_ms(torch, lambda: hmac_sha256.hmac_verify_plain3(kk, mm, mc),
                                reps=3, warm=1)
            k6s_plain = cuda_ms(torch, lambda: hmac_sha256.hmac_sign_plain(kk, mm),
                                reps=3, warm=1)
    kernels["K6'"] = kernel_entry(runs, 512, k6v_plain)
    kernels["K6s"] = kernel_entry(sign_runs, 512, k6s_plain)
    print("K6' and K6s device ms before their redesign (PERF.md) / after (B=16384: "
          "no path sends it): "
          + before_after(kernels, {k: SHA_BEFORE_MS[k] for k in ("K6'", "K6s")}))

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 13")
    # -- phase 13: the bench entry point, in-process ------------------------------
    os.environ["MINBFT_BENCH_RUNS"] = "1"
    for knob in ("MINBFT_BENCH_INGEST_REQUESTS", "MINBFT_BENCH_RO_READS"):
        os.environ.pop(knob, None)
    for section, n_req in BENCH_REQUESTS.items():
        os.environ[f"MINBFT_BENCH_{section.upper()}_REQUESTS"] = str(n_req)
    extras_path = os.path.join(bench.OUT_DIR, "extras.json")
    for section in BENCH_SECTIONS:
        path = f"bench_{section}"
        out = io.StringIO()
        t0 = time.time()
        with _ErrorRecords() as errors:
            reset_counts()
            # The bench's section: every count moves only from here ...
            try:
                with contextlib.redirect_stdout(out):
                    rc = bench.main([section])
            except Exception as e:  # the bench's own failure, reported
                fail(f"{path}: {type(e).__name__}: {e}")
            # ... to here.
            win = read_counts()
        path_launches[path] = win
        check(rc == 0, f"{path}: exit code {rc}")
        check(not errors, f"{path}: ERROR records {errors[:5]}")
        check(os.path.exists(extras_path) and os.path.getmtime(extras_path) >= t0,
              f"{path}: {extras_path} not written")
        with open(extras_path) as fh:
            extras = json.load(fh)
        printed = out.getvalue().strip().splitlines()
        head = json.loads(printed[-1])
        check(head["metric"] == "batched ECDSA-P256 verifies/sec/chip"
              and head["backend"] == "cuda", f"{path}: headline line {printed[-1]}")
        check("bench_extras" in json.loads(printed[-2]), f"{path}: no bench_extras line")
        missing = sorted(bench_expected_keys(section) - set(extras))
        check(not missing, f"{path}: keys missing {missing}")
        need = {"kernels": ("K2'", "K3", "K6'", "K6s", "K7'", "K8"),
                "mac": ("K6",), "cfg4": ("K2", "K3", "K6"),
                "ingest": ("K2", "K3", "K6"), "readonly": ()}[section]
        check(all(win[k] > 0 for k in need), f"{path}: a kernel of the path was not "
              f"launched {win}")
        if section == "readonly":
            # Host crypto, no engine, as in the reference: no launch.
            check(extras["ro_reads"] == RO_READS and extras["ro_clients"] == RO_CLIENTS
                  and extras["ro_fast_replies"] == 4 * RO_READS,
                  f"{path}: {extras['ro_reads']} reads, {extras['ro_fast_replies']} "
                  f"fast replies")
            print(f"{path}: n=4, {extras['ro_clients']} clients, {extras['ro_reads']} "
                  f"reads on the fast path, {extras['ro_reads_per_sec']} reads/s "
                  f"(host crypto); launches {win}")
            continue
        if section == "ingest":
            for p in INGEST_PREFIXES:
                check(extras[f"{p}_requests"] == INGEST_COMMITTED
                      and extras[f"{p}_dispatch_timeouts"] == 0
                      and extras.get(f"{p}_sign_fallback_items", 0) == 0,
                      f"{path} {p}: {extras[f'{p}_requests']} requests, "
                      f"{extras[f'{p}_dispatch_timeouts']} timeouts")
                print(f"{path} {p}: n=4, HMAC USIG, bucket 128, "
                      f"{extras[f'{p}_requests']} requests, committed "
                      f"{extras[f'{p}_committed_req_per_sec']} req/s, latency p50 "
                      f"{extras[f'{p}_request_latency_p50_ms']} ms p99 "
                      f"{extras[f'{p}_request_latency_p99_ms']} ms; ingest batch mean "
                      f"{extras[f'{p}_ingest_batch_mean']}, ticks/s "
                      f"{extras[f'{p}_ingest_ticks_per_sec']}; USIG queue mean batch "
                      f"{extras[f'{p}_mean_batch']}")
            print(f"{path}: launches {win}")
            continue
        if section == "kernels":
            print(f"{path}: ECDSA verifies/s {extras['ecdsa_verifies_per_sec']:,.0f} "
                  f"(B={extras['ecdsa_batch']}, {extras['ecdsa_ms_per_batch']} ms), "
                  f"Ed25519 {extras['ed25519_verifies_per_sec']:,.0f}, HMAC "
                  f"{extras['hmac_verifies_per_sec']:,.0f}; signs/s ECDSA "
                  f"{extras['ecdsa_signs_per_sec']:,.0f} (big "
                  f"{extras['ecdsa_sign_big_per_sec']:,.0f}), Ed25519 "
                  f"{extras['ed25519_signs_per_sec']:,.0f}; sign queues ECDSA "
                  f"{extras['ecdsa_device_signs_per_sec']:,.0f}, Ed25519 "
                  f"{extras['ed25519_device_signs_per_sec']:,.0f}; prep speedups "
                  f"{extras['ecdsa_prep_speedup']} / {extras['ed25519_prep_speedup']}; "
                  f"launches {win}")
            check(not extras["ecdsa_sign_queue_fallback"]
                  and not extras["ed25519_sign_queue_fallback"],
                  f"{path}: a sign queue signed on the host")
            continue
        p = section
        check(extras[f"{p}_dispatch_timeouts"] == 0, f"{path}: dispatch timeouts")
        check(extras[f"{p}_requests"] == BENCH_REQUESTS[section],
              f"{path}: {extras[f'{p}_requests']} requests")
        check(extras.get(f"{p}_sign_fallback_items", 0) == 0, f"{path}: host-signed lanes")
        for kind in ("stage", "critpath"):
            check(any(k.startswith(f"{p}_{kind}_") for k in extras),
                  f"{path}: no {p}_{kind}_* keys from the traced run")
        print(f"{path}: n={extras[f'{p}_n']} requests={extras[f'{p}_requests']} "
              f"committed {extras[f'{p}_committed_req_per_sec']} req/s, latency p50 "
              f"{extras[f'{p}_request_latency_p50_ms']} ms p99 "
              f"{extras[f'{p}_request_latency_p99_ms']} ms; at the 500 ms SLO "
              f"{extras[f'{p}_req_per_sec_at_p50_500ms']} req/s (depth "
              f"{extras[f'{p}_slo_depth']}, p50 {extras[f'{p}_slo_achieved_p50_ms']} ms); "
              f"USIG queue mean batch {extras[f'{p}_mean_batch']}, memo hits "
              f"{extras[f'{p}_memo_hits']}; util busy {extras[f'{p}_util_busy']} fill "
              f"{extras[f'{p}_util_fill']} useful {extras[f'{p}_util_useful']} against "
              f"{extras[f'{p}_util_ceiling_per_sec']:,.0f} lanes/s; launches {win}")
        stages = {k: v for k, v in extras.items() if k.startswith(f"{p}_stage_")
                  and k.endswith("_share")}
        print(f"{path} stage shares: {json.dumps(stages)}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14")
    # -- phase 14: the deployment path, one process per replica ------------------
    repo = os.path.dirname(os.path.abspath(__file__))
    dep = run_deployment(bench, repo)
    counts = {kid: 0 for kid in wrappers}
    counts.update({k: v for k, v in dep["launches"].items() if k in counts})
    path_launches["testnet_tcp"] = counts
    print(f"testnet_tcp (n={DEPLOY_N}, NATIVE_ECDSA, TCP, {DEPLOY_N} replica processes "
          f"and one client process, engines on cuda:0): {dep['requests']} requests "
          f"in {dep['seconds']} s, committed {dep['req_per_sec']} req/s, latency p50 "
          f"{dep['p50_ms']} ms p99 {dep['p99_ms']} ms; replicas up in "
          f"{dep['start_s']:.1f} s; launches {counts}")
    print(f"testnet_tcp host CPU s per wall s: replicas {dep['replica_cpu_per_wall']}, "
          f"client {dep['client_cpu_per_wall']}")
    print(f"testnet_tcp CUDA contexts on the card, as the processes report them: "
          f"{dep['contexts']} ({DEPLOY_N} replicas, 1 client process), "
          f"{dep['gpu_memory_mib']:.0f} MiB of device memory in all (peak in use less "
          f"the baseline), {dep['gpu_memory_mib'] / max(dep['contexts'], 1):.1f} MiB a "
          f"process; each process's allocator MiB {dep['cuda_reserved_mib']}")
    check(dep["contexts"] == DEPLOY_N + 1 and dep["gpu_memory_mib"] > 0,
          f"testnet_tcp: {dep['contexts']} processes report a CUDA context, "
          f"{dep['gpu_memory_mib']} MiB taken")
    for i, rep in enumerate(dep["engines"]):
        print(f"testnet_tcp replica {i} engine: verify "
              f"{ {k: (q['items'], q['batches']) for k, q in rep['verify'].items()} } "
              f"sign { {k: (q['items'], q['batches']) for k, q in rep['sign'].items()} } "
              f"(items, batches); launches {rep['launches']}")
    os.environ["MINBFT_BENCH_RUNS"] = "1"
    os.environ["MINBFT_BENCH_MP_REQUESTS"] = str(MPTCP_REQUESTS)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(["mptcp"])
    except Exception as e:  # the bench's own failure, reported
        fail(f"bench_mptcp: {type(e).__name__}: {e}")
    check(rc == 0, f"bench_mptcp: exit code {rc}")
    with open(os.path.join(bench.OUT_DIR, "extras.json")) as fh:
        extras = json.load(fh)
    missing = sorted(bench_expected_keys("mptcp") - set(extras))
    check(not missing, f"bench_mptcp: keys missing {missing}")
    check(extras["mptcp_requests"] == MPTCP_REQUESTS and extras["mptcp_n"] == 7,
          f"bench_mptcp: {extras['mptcp_requests']} requests at n={extras['mptcp_n']}")
    win = {kid: 0 for kid in wrappers}
    for side in ("mptcp_replica_launches", "mptcp_client_launches"):
        for kid, v in extras[side].items():
            win[kid] += v
    check(win["K2"] > 0 and win["K3"] > 0, f"bench_mptcp: launches {win}")
    path_launches["bench_mptcp"] = win
    print(f"bench_mptcp (n=7, f=3, TCP, 7 replica processes and one client process of "
          f"20 clients x depth {extras['mptcp_depth']}, engines on cuda:0): "
          f"{extras['mptcp_requests']} requests, committed "
          f"{extras['mptcp_committed_req_per_sec']} req/s, latency p50 "
          f"{extras['mptcp_request_latency_p50_ms']} ms p99 "
          f"{extras['mptcp_request_latency_p99_ms']} ms; at the 500 ms SLO "
          f"{extras['mptcp_req_per_sec_at_p50_500ms']} req/s (depth "
          f"{extras['mptcp_slo_depth']}, p50 {extras['mptcp_slo_achieved_p50_ms']} ms); "
          f"launches {win}")
    print(f"bench_mptcp host CPU s per wall s: replicas "
          f"{extras['mptcp_replica_cpu_per_wall']}, client "
          f"{extras['mptcp_client_cpu_per_wall']}; CUDA contexts "
          f"{extras['mptcp_cuda_contexts']} (as the processes report them), "
          f"{extras['mptcp_gpu_memory_mib']:.0f} MiB in all, "
          f"{extras['mptcp_context_mib']} MiB a process; each process's allocator MiB "
          f"{extras['mptcp_cuda_reserved_mib']}")
    check(extras["mptcp_cuda_contexts"] == 8 and extras["mptcp_gpu_memory_mib"] > 0,
          f"bench_mptcp: {extras['mptcp_cuda_contexts']} processes report a CUDA context, "
          f"{extras['mptcp_gpu_memory_mib']} MiB")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 15")
    # -- phase 15: the deployment path under chaos, with the metrics endpoint -----
    res = subprocess.run(
        [sys.executable, "-m", "minbft_tpu_torch.sample.peer", "selftest",
         "--chaos-seed", hex(CHAOS_SEED), "--chaos-profile", CHAOS_PLAN,
         "--device", "cuda:0"],
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")),
        capture_output=True, text=True, timeout=300)
    lines = [ln for ln in res.stderr.splitlines() if ln.startswith("chaos ")]
    check(res.returncode == 0 and len(lines) == 3 and "invariants green" in lines[2],
          f"peer selftest --chaos-seed: rc {res.returncode}: {res.stderr[-800:]}")
    st_rep = [json.loads(ln.split(" engine ", 1)[1]) for ln in res.stderr.splitlines()
              if ln.startswith("selftest engine ")]
    check(len(st_rep) == 1, f"peer selftest: no engine report: {res.stderr[-500:]}")
    faults = bench.engine_faults(st_rep[0], "cuda:0")
    check(not faults, f"peer selftest --chaos-seed: {'; '.join(faults)}")
    counts = {kid: 0 for kid in wrappers}
    counts.update({k: v for k, v in st_rep[0]["launches"].items() if k in counts})
    path_launches["selftest_chaos"] = counts
    print(f"selftest_chaos (in-process, one engine on cuda:0): {lines[1]}; {lines[2]}; "
          f"launches {counts}")
    chaos = run_deployment(bench, repo, n_requests=CHAOS_REQUESTS, chaos=True)
    counts = {kid: 0 for kid in wrappers}
    counts.update({k: v for k, v in chaos["launches"].items() if k in counts})
    check(counts["K2"] > 0 and counts["K3"] > 0, f"chaos_tcp: launches {counts}")
    path_launches["chaos_tcp"] = counts
    print(f"chaos_tcp (n={DEPLOY_N}, NATIVE_ECDSA, TCP, MINBFT_CHAOS_SEED={CHAOS_SEED:#x} "
          f"MINBFT_CHAOS_PLAN={CHAOS_PLAN}, --metrics-port 0, engines on cuda:0): "
          f"{chaos['requests']} requests in {chaos['seconds']} s, committed "
          f"{chaos['req_per_sec']} req/s, latency p50 {chaos['p50_ms']} ms p99 "
          f"{chaos['p99_ms']} ms; the clean testnet_tcp above: {dep['req_per_sec']} req/s, "
          f"p50 {dep['p50_ms']} ms p99 {dep['p99_ms']} ms; phase {chaos['phase_s']:.1f} s "
          f"of its {CHAOS_BUDGET_S:.0f} s budget; peer metrics' merged aggregate: "
          f"{chaos['merged_items']:.0f} verify items; launches {counts}")
    for i, row in enumerate(chaos["replicas"]):
        print(f"chaos_tcp replica {i} fault census {row['census']} over {row['frames']} "
              f"frames (= the replay of the seed)")
        print(f"chaos_tcp replica {i} engine rows (items, batches): scrape "
              f"{row['scrape']}, SIGTERM report {row['report']}")
    print("chaos_tcp peer top --once:")
    for ln in chaos["top"]:
        print(f"  {ln}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 16")
    # -- phase 16: multi-group consensus on one engine ---------------------------
    os.environ["MINBFT_BENCH_GROUPS_REQUESTS"] = str(GROUPS_SWEEP_REQUESTS)
    os.environ.pop("MINBFT_BENCH_GROUPS_RUNS", None)
    out = io.StringIO()
    with _ErrorRecords() as errors:
        reset_counts()
        # The bench's groups section: every count moves only from here ...
        try:
            with contextlib.redirect_stdout(out):
                rc = bench.main(["groups"])
        except Exception as e:  # the bench's own failure, reported
            fail(f"bench_groups: {type(e).__name__}: {e}")
        # ... to here.
        win = read_counts()
    path_launches["bench_groups"] = win
    check(rc == 0, f"bench_groups: exit code {rc}")
    check(not errors, f"bench_groups: ERROR records {errors[:5]}")
    with open(os.path.join(bench.OUT_DIR, "extras.json")) as fh:
        extras = json.load(fh)
    missing = sorted(bench_expected_keys("groups") - set(extras))
    check(not missing, f"bench_groups: keys missing {missing}")
    check(all(win[k] > 0 for k in ("K2", "K3", "K6")),
          f"bench_groups: a kernel of the path was not launched {win}")
    for G in extras["groups_sweep_Gs"]:
        p = f"groups{G}"
        check(extras[f"{p}_dispatch_timeouts"] == 0, f"bench_groups {p}: dispatch timeouts")
        print(f"bench_groups {p}: n=4, HMAC USIG, bucket 128, {G} groups x "
              f"{GROUPS_SWEEP_REQUESTS} requests ({extras[f'{p}_requests']} driven), "
              f"committed {extras[f'{p}_committed_req_per_sec']} req/s, latency p50 "
              f"{extras[f'{p}_request_latency_p50_ms']} ms p99 "
              f"{extras[f'{p}_request_latency_p99_ms']} ms; USIG queue (K6) mean batch "
              f"{extras[f'{p}_verify_mean_batch']} over {extras[f'{p}_verify_batches']} "
              f"batches, signature queue (K2) mean batch {extras[f'{p}_sig_mean_batch']}; "
              f"util busy {extras[f'{p}_util_busy']} fill {extras[f'{p}_util_fill']}")
    check(extras["groups16_verify_mean_batch"] > extras["groups1_verify_mean_batch"],
          f"bench_groups: the shared queue's fill did not rise with G: "
          f"{extras['groups1_verify_mean_batch']} at G=1, "
          f"{extras['groups16_verify_mean_batch']} at G=16")
    print(f"bench_groups: launches {win}")
    grp = run_deployment(bench, repo, n_requests=GROUPS_REQUESTS, groups=GROUPS_DEPLOY)
    counts = {kid: 0 for kid in wrappers}
    counts.update({k: v for k, v in grp["launches"].items() if k in counts})
    check(counts["K2"] > 0 and counts["K3"] > 0, f"groups_tcp: launches {counts}")
    path_launches["groups_tcp"] = counts
    print(f"groups_tcp (n={DEPLOY_N}, NATIVE_ECDSA, TCP, {GROUPS_DEPLOY} groups in each of "
          f"{DEPLOY_N} replica processes, one client process routing by key, "
          f"--metrics-port 0, engines on cuda:0): {grp['requests']} requests in "
          f"{grp['seconds']} s, committed {grp['req_per_sec']} req/s, latency p50 "
          f"{grp['p50_ms']} ms p99 {grp['p99_ms']} ms; executed by group (every replica "
          f"alike) {grp['executed_by_group'][0]}; phase {grp['phase_s']:.1f} s of its "
          f"{GROUPS_BUDGET_S:.0f} s budget; launches {counts}")
    print(f"groups_tcp ledgers (every replica's equal): "
          f"{[(g['group'], g['length'], g['digest'][:16]) for g in grp['ledgers'][0]]}")
    for i, rep in enumerate(grp["engines"]):
        print(f"groups_tcp replica {i} engine: verify "
              f"{ {k: (q['items'], q['batches']) for k, q in rep['verify'].items()} } "
              f"sign { {k: (q['items'], q['batches']) for k, q in rep['sign'].items()} } "
              f"(items, batches); launches {rep['launches']}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 17")
    # -- phase 17: the open-loop load harness -------------------------------------
    for n_groups in LOAD_GROUPS:
        path = f"load_g{n_groups}"
        rep = run_peer_load(repo, n_groups)
        counts = {kid: 0 for kid in wrappers}
        counts.update({k: v for k, v in rep["engine"]["launches"].items() if k in counts})
        path_launches[path] = counts
        cl = rep["cluster"]
        hq = rep["engine"]["verify"]["hmac_sha256"]
        print(f"{path} (peer load: n=4, MACs, HMAC USIG, {rep['n_clients']} clients over "
              f"{rep['pool_connections']} sockets, {n_groups} groups, one engine on cuda:0): "
              f"offered {rep['offered_per_sec']}/s for {rep['duration_s']} s, "
              f"{rep['arrivals']} arrivals, goodput {rep['goodput_per_sec']}/s "
              f"(sustained {rep['sustained_per_sec']}/s), latency from the scheduled "
              f"arrival p50 {rep['p50_ms']} ms p99 {rep['p99_ms']} ms (from the send p99 "
              f"{rep['send_p99_ms']} ms), timeouts {rep['timeouts']}, shed "
              f"{cl['admission_shed']}, busy sent {cl['admission_busy_sent']} received "
              f"{rep['busy_received']}; census = the seed's replay; HMAC queue (K6) "
              f"{hq['items']} items in {hq['batches']} batches; process "
              f"{rep['process_s']:.1f} s; launches {counts}")
    os.environ["MINBFT_LOAD_REQUESTS"] = str(LOAD_BENCH_REQUESTS)
    for knob in ("MINBFT_LOAD_SEED", "MINBFT_LOAD_CLIENTS", "MINBFT_LOAD_PROBE_RATE"):
        os.environ.pop(knob, None)
    out = io.StringIO()
    with _ErrorRecords() as errors:
        reset_counts()
        # The bench's load section: every count moves only from here ...
        try:
            with contextlib.redirect_stdout(out):
                rc = bench.main(["load"])
        except Exception as e:  # the bench's own failure, reported
            fail(f"bench_load: {type(e).__name__}: {e}")
        # ... to here.
        win = read_counts()
    path_launches["bench_load"] = win
    check(rc == 0, f"bench_load: exit code {rc}")
    check(not errors, f"bench_load: ERROR records {errors[:5]}")
    with open(os.path.join(bench.OUT_DIR, "extras.json")) as fh:
        extras = json.load(fh)
    missing = sorted(bench_expected_keys("load") - set(extras))
    check(not missing, f"bench_load: keys missing {missing}")
    check(win["K6"] > 0, f"bench_load: K6 was not launched {win}")
    check(extras["load_probe_census_ok"] and all(
        extras[f"load_{t}_census_ok"] for t in ("half", "sat", "over")),
        "bench_load: a census is not the seed's replay")
    check(all(extras[f"load_{t}_dispatch_timeouts"] == 0
              for t in ("probe", "half", "sat", "over")), "bench_load: dispatch timeouts")
    print(f"bench_load probe: offered {extras['load_probe_offered_per_sec']}/s, burst peak "
          f"{extras['load_burst_peak_per_sec']}/s, shed {extras['load_probe_shed']}, busy "
          f"sent {extras['load_probe_busy_sent']} received "
          f"{extras['load_probe_busy_received']}, timeouts {extras['load_probe_timeouts']}, "
          f"rx peak {extras['load_probe_rx_peak']}; HMAC queue mean batch "
          f"{extras['load_probe_verify_mean_batch']}")
    for t in ("half", "sat", "over"):
        print(f"bench_load {t}: offered {extras[f'load_{t}_offered_per_sec']}/s, goodput "
              f"{extras[f'load_{t}_goodput_per_sec']}/s, p50 {extras[f'load_{t}_p50_ms']} "
              f"ms p99 {extras[f'load_{t}_p99_ms']} ms, timeouts "
              f"{extras[f'load_{t}_timeouts']}, shed {extras[f'load_{t}_shed']}, busy "
              f"received {extras[f'load_{t}_busy_received']}; HMAC queue mean batch "
              f"{extras[f'load_{t}_verify_mean_batch']}")
    print(f"bench_load: peak {extras['load_peak_per_sec']}/s, 2x goodput fraction "
          f"{extras.get('load_over_goodput_fraction')}; launches {win}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 18")
    # -- phase 18: the crash-recovery soak on the card ---------------------------
    # Every count is the processes' own, from their engine reports (the
    # restarted replica's second instance; the killed one reports none).
    soak = run_soak(bench)
    counts = {kid: 0 for kid in wrappers}
    counts.update({k: v for k, v in soak["launches"].items() if k in counts})
    check(counts["K2"] > 0 and counts["K3"] > 0, f"recovery_soak: launches {counts}")
    path_launches["recovery_soak"] = counts
    print(f"recovery_soak (n=4, SOFT_ECDSA, TCP, 6 clients x depth 4, chaos seed "
          f"{bench.RECOVERY_SEED:#x} plan {soak['chaos_plan']}, kill -9 of replica 3, engines on "
          f"cuda:0): {soak['committed']} of {soak['requested']} requests committed, "
          f"goodput {soak['chaos_recovery_goodput_per_sec']} req/s; restored at count "
          f"{soak['restored_count']}; restart_to_listen_ms {soak['restart_to_listen_ms']}, "
          f"chaos_recovery_time_ms {soak['chaos_recovery_time_ms']}, wall_recovery_ms "
          f"{soak['wall_recovery_ms']}, drain_margin_ms {soak['drain_margin_ms']}; CUDA "
          f"contexts reported {soak['contexts']} (4 "
          f"replicas, the restarted one's second instance, and 1 client process; the "
          f"killed instance reports none); phase {soak['phase_s']:.1f} s of its "
          f"{SOAK_BUDGET_S:.0f} s budget; ERROR records of re-certified counts "
          f"{soak['view_change_errors']}; launches {counts}; on {name_power}")
    check(soak["contexts"] == 5, f"recovery_soak: {soak['contexts']} CUDA contexts reported")
    for who, eng in soak["engines"].items():
        print(f"recovery_soak {who} engine: verify "
              f"{ {k: (q['items'], q['batches']) for k, q in eng['verify'].items()} } "
              f"sign { {k: (q['items'], q['batches']) for k, q in eng['sign'].items()} } "
              f"(items, batches); launches {eng['launches']}")
    for i, census in sorted(soak["census"].items()):
        print(f"recovery_soak replica {i} fault census {census} (= the replay of the seed)")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 19")
    # -- phase 19: the batch split and the engine pool (parallel/) ----------------
    # Phases 3, 4, 6 and 7's rows at the deployment bucket (1,024 for
    # Ed25519), adversarial and padding lanes included.
    split_rows = {
        "K2": torch.from_numpy(k2_runs[512][0]).to(dev),
        "K3": k3_nonces,
        "K6": sha256.as_i32(k6_runs[512][0]).to(dev),
        "K7": torch.from_numpy(k7_runs[1024][0]).to(dev),
        "K8": k8_nonces,
    }
    h_rows, _expect, _forged_idx = hmac_rows(np.random.default_rng(19), 64)
    h_bytes = [row.astype(">u4").tobytes() for row in h_rows]
    work = (
        verify_items(hc, rng, keys, 64),
        [(b[:32], b[32:64], b[64:]) for b in h_bytes],
        ed25519_items(hc, rng, ed_seeds, 64),
        [(keys[i % len(keys)][0], rng.bytes(32)) for i in range(32)],
        [(ed_seeds[i % len(ed_seeds)], rng.bytes(32)) for i in range(32)],
    )
    verdicts = run_pool_phase(torch, bench, name_power, split_rows, work,
                              reset_counts, read_counts, path_launches)
    check(torch.equal(torch.from_numpy(k2_runs[512][1]), verdicts["K2"]),
          "K2 split: verdicts differ from phase 3's")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 20")
    # -- phase 20 ----------------------------------------------------------------
    meta = {
        "K1": ("field_op (csrc/field.cuh, p256_field.cuh and ed25519_field.cuh libraries)",
               "minbft_tpu_torch/csrc/field.cuh", "minbft_tpu/ops/limbs.py:335"),
        "K2": ("ecdsa_verify_kernel_packed", "minbft_tpu_torch/csrc/p256_verify.cu",
               "minbft_tpu/ops/p256.py:504"),
        "K3": ("ecdsa_kg_kernel", "minbft_tpu_torch/csrc/p256_kg.cu",
               "minbft_tpu/ops/p256.py:644"),
        "K5": ("sha256_compress (csrc/sha256.cuh device function)",
               "minbft_tpu_torch/csrc/sha256.cuh", "minbft_tpu/ops/sha256.py:65"),
        "K6": ("hmac_verify_kernel_packed", "minbft_tpu_torch/csrc/hmac_sha256.cu",
               "minbft_tpu/ops/hmac_sha256.py:68"),
        "K7": ("ed25519_verify_kernel_packed", "minbft_tpu_torch/csrc/ed25519_verify.cu",
               "minbft_tpu/ops/ed25519.py:400"),
        "K8": ("ed25519_rb_kernel", "minbft_tpu_torch/csrc/ed25519_rb.cu",
               "minbft_tpu/ops/ed25519.py:487"),
        "K4": ("ecdsa_kg_ladder_kernel", "minbft_tpu_torch/csrc/p256_kg_ladder.cu",
               "minbft_tpu/ops/p256.py:550"),
        "K2'": ("ecdsa_verify_kernel (_verify_batch, K2's eight-array form)",
                "minbft_tpu_torch/csrc/p256_verify.cu", "minbft_tpu/ops/p256.py:264"),
        "K6'": ("hmac_verify_kernel (K6's three-array form)",
                "minbft_tpu_torch/csrc/hmac_sha256.cu", "minbft_tpu/ops/hmac_sha256.py:62"),
        "K6s": ("hmac_sign_kernel", "minbft_tpu_torch/csrc/hmac_sha256.cu",
                "minbft_tpu/ops/hmac_sha256.py:78"),
        "K7'": ("ed25519_verify_kernel (K7's seven-array form)",
                "minbft_tpu_torch/csrc/ed25519_verify.cu", "minbft_tpu/ops/ed25519.py:191"),
    }
    line = []
    for kid, (name, src, replaces) in meta.items():
        k = kernels[kid]
        entry = {
            "name": f"{kid} {name}", "route": "cuda", "source": src,
            "replaces": replaces,
            # Each count is the wrapper's own, read around each path
            # (the flow, the cluster phases, the bench's sections) and
            # summed; the deployment paths' counts are the replica and
            # client processes' own, from their engine reports.
            # launches_by_path holds the reads.  K1 and K5 are __device__
            # functions inlined into K2/K3/K7/K8 and K6, so their arithmetic
            # runs inside those launches and their test kernels (phases 2
            # and 6 only) count 0 there.
            "launches": sum(p[kid] for p in path_launches.values()),
            "launches_by_path": {
                path: counts[kid] for path, counts in path_launches.items()
            },
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            # The kernel alone, without the wrapper's host overhead.
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
            "parity": "exact",
        }
        for key in ("group", "device_ms_by_group"):
            if key in k:
                entry[key] = k[key]
        if kid == "K1":
            entry["inlined_into"] = ["K2", "K2'", "K3", "K4", "K7", "K7'", "K8"]
        if kid == "K5":
            entry["inlined_into"] = ["K6", "K6'", "K6s"]
        for bsz, (ms, dev_ms, b_ms, _by) in sorted(k.get("other", {}).items()):
            entry[f"ms_b{bsz}"] = ms
            entry[f"device_ms_b{bsz}"] = dev_ms
            entry[f"bound_ms_b{bsz}"] = b_ms
        line.append(entry)
    print(f"total smoke time {time.perf_counter() - t_start:.1f} s on {name_power}")
    print(json.dumps({"kernels": line}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
