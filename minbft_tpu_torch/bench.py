"""Benchmark entry point of the port: ``python -m minbft_tpu_torch.bench``.

Counterpart of the reference's ``bench.py``, with its function names, its
output key names and its ``MINBFT_BENCH_*`` knobs wherever the reference
has them, so each number here has a named counterpart there.  Three
kinds of section:

- **kernels** — batched ECDSA-P256 verifies/s (K2', the eight-array
  form; the headline, as in ``BASELINE.json``), ECDSA signs/s
  (``sign_batch`` over K3), Ed25519 verifies/s (K7') and signs/s (K8),
  the engine's sign queues, host prep against the scalar oracles, and
  HMAC-SHA256 verifies/s (K6', its MACs made by K6s);
- **clusters** — the reference's in-process cluster configurations
  (``_bench_cluster``): ``e2e`` (BASELINE config 3: n = 7, ECDSA USIG,
  10,000 requests), ``nodedup``, ``nodedupref``, ``cfg1``, ``cfg2``,
  ``cfg4`` (n = 13, bucket 128), ``mac`` (n = 7, pairwise MACs, 8,000
  requests), ``cfg5`` (n = 31, Ed25519, bucket 1,024) and ``iso``, each
  emitting the reference's ``{prefix}_*`` keys: committed req/s mean ±
  stddev over ``MINBFT_BENCH_RUNS``, client latency p50/p99, the
  engine's batch, memo and prep keys, the ``_util_`` keys of
  :class:`~minbft_tpu_torch.obs.DeviceLedger`, and the ``_stage_`` and
  ``_critpath_`` keys of one traced run (every configuration gets one;
  the reference traces ``e2e`` and ``cfg5`` only); ``ingest``
  (``bench_ingest_sweep``: n = 4, HMAC USIGs, bucket 128, one run per
  bundle-ingest operating point, ``ingest_off``, ``ingest8``,
  ``ingest64``, ``ingest1024``) and ``readonly`` (``_bench_readonly``:
  the read-only fast path, host crypto, no engine, as in the reference);
- **multi-process** — ``mp`` (gRPC) and ``mptcp`` (TCP, depth 48 by
  ``MINBFT_BENCH_MPTCP_DEPTH``), the reference's ``_bench_mp_cluster``:
  n = 7, f = 3, one ``peer run`` process per replica and the 20 clients
  in one ``peer bench`` process, ``MINBFT_BENCH_MP_REQUESTS`` requests
  (default the e2e count), each process with its own engine on the
  device (the reference runs them ``--no-batch`` on the CPU), with the
  reference's ``{prefix}_*`` keys plus each replica's host CPU seconds
  per wall second, the kernel launches and, on the card, the CUDA
  contexts and their memory.

Every timing ends in ``torch.cuda.synchronize()`` (on the card) before
the clock stops.  Each ``*_compile_s`` key is the first call's time: on
the card it includes building the kernels at first use in the process.

Device rule: ``--device`` is ``cuda:0`` by default; ``--device cpu`` runs
the plain PyTorch versions of the kernels and clamps the sizes as the
reference's CPU mode does (batch 32, 500 requests; the configurations
past ``e2e`` only with ``MINBFT_BENCH_ALL_CONFIGS``).  CUDA asked for and
absent raises ``RuntimeError``.  A failed warm, traced or SLO run, a
failed self-check and a timed-out request fail the bench.

Output: the full extras go to ``build/torch_bench/extras.json`` beside
the package (never the reference's ``BENCH_extras.json``); stdout gets
one ``{"bench_extras": {...}}`` line of the headline-grade keys, then the
headline line ``{"metric": "batched ECDSA-P256 verifies/sec/chip", ...}``
stamped with the backend, the device and its power limit.

Multi-group and load (since ``groups/`` and ``loadgen/`` were ported):
``groups`` (``bench_groups``: n = 4, HMAC USIGs, bucket 128, G in 1, 2,
4, 8, 16 group cores per replica on one engine at a fixed per-group
load, ``MINBFT_BENCH_GROUPS_REQUESTS`` a group, the reference's
``groups{G}_*`` keys and ``groups_sweep_*`` meta) and ``load``
(``bench_load``: the open-loop curve through ``loadgen``, the
reference's ``load_*`` keys and ``MINBFT_LOAD_*`` knobs), each with its
engine on ``--device``; a failed point fails the section.  They join the
default run on the card only.

Crash recovery (since ``testing/recovery_soak.py`` was ported):
``recovery`` (``bench_recovery``: one kill -9 soak of real ``peer run``
processes, n = 4, SOFT_ECDSA USIGs, TCP, 6 clients x depth 4 under the
pinned chaos seed, every process's engine on ``--device``), the
reference's seven ``chaos_recovery_*`` keys,
``chaos_recovery_restart_to_listen_ms`` and
``chaos_recovery_drain_margin_ms``; it joins the default run on the
card only, and a failed soak fails the section.

Left out (ROADMAP.md queue 1, with the module they wait for):
``bench_groups_chips`` and ``use_mesh`` (the multi-GPU pool).  Dropped
as JAX- or TPU-only: the lowering modes and ``*_mode`` keys, the compile
cache keys, ``tpu_unavailable``, the ``last_tpu`` carry-forward, the TPU
ceiling and the ``vs_baseline`` ratio.

Placement differences from the reference's clusters: every signature
(REQUEST, REPLY) and MAC is checked on the device, in the engine's
verify queues, because the port has no host queues; and the clients share
the replicas' engine.
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import hashlib
import json
import os
import secrets
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import backend, limbs
from .testing.recovery_soak import read_engine_report
from .utils.netports import free_base_port as _free_base_port
from .utils.netports import wait_ports as _wait_ports

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_bench")

# Default sizes, the reference's: the kernel section's batches
# (MINBFT_BENCH_BATCH for the verify forms and the large sign batch) and
# cfg4's bucket.  chip_smoke.py checks the kernels at these shapes.
BATCH = 32768
HMAC_BATCH = 8192
SIGN_BATCH = 2048
ED_SIGN_BATCH = 8192
SIGN_QUEUE_BUCKET = 2048
CFG4_BUCKET = 128

SECTIONS = (
    "kernels", "e2e", "ingest", "readonly", "groups", "load", "recovery", "nodedup",
    "nodedupref", "cfg1", "cfg2", "cfg4", "mac", "cfg5", "iso", "mp", "mptcp",
)
# The in-process configurations past e2e, and the multi-process runs.
CONFIG_SECTIONS = ("cfg1", "cfg2", "cfg4", "mac", "cfg5", "iso")
MP_SECTIONS = ("mp", "mptcp")
# Per-request deadline of the cluster drives (the reference's).
REQUEST_TIMEOUT_S = 240.0
# Timed full-bucket dispatches of the ledger's ceiling probe.
PROBE_REPS = 5


class BenchError(RuntimeError):
    """A self-check or a run of the bench failed."""


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise BenchError(f"self-check failed: {what}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, n_iter: int, dev: torch.device):
    """Seconds per call of ``fn`` over ``n_iter`` calls, the device drained
    before and after; returns (seconds, last result)."""
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn()
    _sync(dev)
    return (time.perf_counter() - t0) / n_iter, out


def _iters(dev: torch.device, on_card: int) -> int:
    """Timed iterations: the reference's count on the card, one for the
    plain versions on the CPU (seconds per call)."""
    return on_card if dev.type == "cuda" else 1


def _first_and_timed(fn, n_iter: int, dev: torch.device):
    """(first call's seconds, seconds per timed call, last result).  On
    the card the first call builds the kernels at first use, so ``n_iter``
    timed calls follow it; the plain versions on the CPU have no first-use
    cost, and their first call is the timed one."""
    first_s, out = _timed(fn, 1, dev)
    if dev.type != "cuda":
        return first_s, first_s, out
    dt, out = _timed(fn, n_iter, dev)
    return first_s, dt, out


# ---------------------------------------------------------------------------
# Kernel section.


def bench_ecdsa(batch: int, device=None, prefix: str = "ecdsa") -> dict:
    """Batched ECDSA-P256 verify rate of K2' (the eight-array form, as
    the reference times ``ecdsa_verify_kernel``) on device-resident
    arrays, with the reference's corrupted-lane check through
    ``verify_batch``."""
    from .ops import p256
    from .utils import hostcrypto as hc

    dev = backend.resolve_device(device)
    d, q = hc.keygen()
    digest = hashlib.sha256(b"bench").digest()
    sig = hc.ecdsa_sign(d, digest)
    items = [(q, digest, sig)] * batch
    arrays = limbs.arrays_to(p256.prepare_batch(items), dev)
    compile_s, dt, out = _first_and_timed(
        lambda: p256.ecdsa_verify_kernel(*arrays), 20, dev
    )
    _check(bool(out.all()), "valid ECDSA batch rejected")
    bad = [(q, digest, sig)] * 4
    bad[2] = (q, digest, (sig[0], sig[1] ^ 2))
    res = p256.verify_batch(bad, device=dev)
    _check(list(res) == [True, True, False, True], "ECDSA corrupted lane")
    return {
        f"{prefix}_batch": batch,
        f"{prefix}_ms_per_batch": round(dt * 1e3, 2),
        f"{prefix}_verifies_per_sec": batch / dt,
        f"{prefix}_compile_s": round(compile_s, 1),
    }


def bench_ecdsa_sign(batch: int, device=None) -> dict:
    """Batched signing: K3 does k*G, the host finishes (r, s)
    (``ops/p256.py`` ``sign_batch``)."""
    from .ops import p256
    from .utils import hostcrypto as hc

    dev = backend.resolve_device(device)
    d, _ = hc.keygen()
    digest = hashlib.sha256(b"sign-bench").digest()
    items = [(d, digest)] * batch
    t0 = time.perf_counter()
    sigs = p256.sign_batch(items, device=dev)
    compile_s = time.perf_counter() - t0
    _check(all(s == sigs[0] for s in sigs), "ECDSA batch signatures differ")
    _check(sigs[0] == hc.ecdsa_sign_py(d, digest), "ECDSA signature != host signer")
    n_iter = _iters(dev, 3)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        sigs = p256.sign_batch(items, device=dev)
    dt = (time.perf_counter() - t0) / n_iter
    return {
        "ecdsa_sign_batch": batch,
        "ecdsa_signs_per_sec": batch / dt,
        "ecdsa_sign_compile_s": round(compile_s, 1),
    }


def bench_ed25519(batch: int, device=None) -> dict:
    """Batched Ed25519 verify rate of K7' (the seven-array form, as the
    reference times ``ed25519_verify_kernel``) on device-resident arrays;
    host prep stays off the clock."""
    from .ops import ed25519 as ed
    from .utils import hostcrypto as hc

    dev = backend.resolve_device(device)
    seed, pub = hc.ed25519_keygen(secrets.token_bytes(32))
    msg = hashlib.sha256(b"bench-ed").digest()
    sig = hc.ed25519_sign(seed, msg)
    batch = max(batch, 4)  # the corrupted-lane check slices 4 items
    items = [(pub, msg, sig)] * batch
    arrays = limbs.arrays_to(ed.prepare_batch(items, batch), dev)
    compile_s, dt, out = _first_and_timed(
        lambda: ed.ed25519_verify_kernel(*arrays), 20, dev
    )
    _check(bool(out.all()), "valid Ed25519 batch rejected")
    bad = items[:4]
    bad[2] = (pub, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:])
    res = ed.verify_batch(bad, device=dev)
    _check(list(res) == [True, True, False, True], "Ed25519 corrupted lane")
    return {
        "ed25519_batch": batch,
        "ed25519_ms_per_batch": round(dt * 1e3, 2),
        "ed25519_verifies_per_sec": batch / dt,
        "ed25519_compile_s": round(compile_s, 1),
    }


def bench_ed25519_sign(batch: int, device=None) -> dict:
    """Batched Ed25519 signing: K8 does r*B, the host derives the scalars
    and compresses (``ops/ed25519.py`` ``sign_batch``)."""
    from .ops import ed25519 as ed
    from .utils import hostcrypto as hc

    dev = backend.resolve_device(device)
    seed, _ = hc.ed25519_keygen(secrets.token_bytes(32))
    items = [(seed, b"ed-sign-bench")] * batch
    t0 = time.perf_counter()
    sigs = ed.sign_batch(items, device=dev)
    compile_s = time.perf_counter() - t0
    _check(sigs[0] == hc.ed25519_sign(seed, b"ed-sign-bench"),
           "Ed25519 signature != host signer")
    n_iter = _iters(dev, 3)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        ed.sign_batch(items, device=dev)
    dt = (time.perf_counter() - t0) / n_iter
    return {
        "ed25519_sign_batch": batch,
        "ed25519_signs_per_sec": batch / dt,
        "ed25519_sign_compile_s": round(compile_s, 1),
    }


async def _drive_sign_queue(eng, scheme: str, items, depth: int = 256) -> None:
    """Drive the engine's sign queue the way the protocol does: many
    concurrent awaiters, bounded in flight, each occupying its own lane
    (the queue is memo-free — every sign is unique)."""
    sem = asyncio.Semaphore(depth)
    sign = eng.sign_ecdsa_p256 if scheme == "ecdsa" else eng.sign_ed25519

    async def one(it):
        async with sem:
            await sign(*it)

    await asyncio.gather(*[one(it) for it in items])


def bench_sign_queue(n_items: int = 8192, bucket: int = SIGN_QUEUE_BUCKET,
                     device=None) -> dict:
    """Signing throughput through the engine's sign queues (not the raw
    kernels): concurrent submitters await individual lanes, the queue
    ships fixed-bucket batches to K3 / K8.  A CPU engine signs on the
    host; ``*_sign_queue_fallback`` then says so, so a CPU number never
    passes for the card's."""
    from .parallel import BatchVerifier
    from .parallel.engine import SignStats
    from .utils import hostcrypto as hc

    dev = backend.resolve_device(device)
    if dev.type == "cpu":
        n_items = min(n_items, 256)
        bucket = min(bucket, 64)
    out: dict = {}
    for scheme, qname in (("ecdsa", "ecdsa_p256"), ("ed25519", "ed25519")):
        eng = BatchVerifier(max_batch=bucket, buckets=(bucket,), device=dev)
        if scheme == "ecdsa":
            d, _ = hc.keygen()
            items = [(d, hashlib.sha256(b"sq-%d" % i).digest()) for i in range(n_items)]
        else:
            seed, _ = hc.ed25519_keygen(hashlib.sha256(b"sq").digest())
            items = [(seed, b"sq-%d" % i) for i in range(n_items)]
        # One full bucket through the queue first (the kernels' first
        # launch lands off the clock), then reset the counters.
        t0 = time.perf_counter()
        asyncio.run(_drive_sign_queue(eng, scheme, items[:bucket]))
        compile_s = time.perf_counter() - t0
        for q in eng._sign_queues.values():
            q.stats = SignStats()
        t0 = time.perf_counter()
        asyncio.run(_drive_sign_queue(eng, scheme, items))
        dt = time.perf_counter() - t0
        st = eng.sign_stats[qname]
        _check(st.items == n_items,
               f"{scheme} sign queue signed {st.items} of {n_items}")
        out[f"{scheme}_device_signs_per_sec"] = round(n_items / dt, 1)
        out[f"{scheme}_sign_queue_mean_batch"] = round(st.mean_batch, 1)
        out[f"{scheme}_sign_queue_compile_s"] = round(compile_s, 1)
        out[f"{scheme}_sign_queue_fallback"] = st.host_fallback_items > 0
        if st.host_fallback_items:
            out[f"{scheme}_sign_queue_host_fallback_items"] = st.host_fallback_items
    return out


def bench_prep(batch: int = 16384, ed_batch: int = 4096) -> dict:
    """Host batch-prep microbench: the vectorised ``prepare_batch`` (one
    Montgomery batch inversion per batch, whole-batch numpy packing and
    range checks) against the per-item scalar oracle on the same host,
    with a bit-identity check of the packed outputs.  Host work only, so
    it runs at full size on every device.  Items are synthetic but in
    range (distinct values keep the big-int work honest)."""
    import random

    from .ops import ed25519 as ed
    from .ops import p256
    from .utils import hostcrypto as hc

    rng = random.Random(0x5EED)
    items = [
        (
            (rng.randrange(p256.P), rng.randrange(p256.P)),
            rng.randbytes(32),
            (rng.randrange(1, p256.N), rng.randrange(1, p256.N)),
        )
        for _ in range(batch)
    ]
    vec = p256.pack_arrays(p256.prepare_batch(items))
    oracle = p256.pack_arrays(p256.prepare_batch_scalar(items))
    _check(np.array_equal(vec, oracle), "vectorised ECDSA prep != scalar oracle")

    def best_of(fn, n_iter=3):
        best = float("inf")
        for _ in range(n_iter):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    tv = best_of(lambda: p256.prepare_batch(items))
    ts = best_of(lambda: p256.prepare_batch_scalar(items))

    # Ed25519: one real key (the cache-hit production shape: a cluster's
    # key set is small), synthetic 64-byte signatures with s < L.
    _seed, pub = hc.ed25519_keygen(b"\x07" * 32)
    ed_items = [
        (pub, rng.randbytes(32),
         rng.randbytes(32) + rng.randrange(ed.L).to_bytes(32, "little"))
        for _ in range(ed_batch)
    ]
    ed_vec = ed.prepare_packed(ed_items, ed_batch)
    ed_oracle = ed.pack_arrays(ed.prepare_batch_scalar(ed_items, ed_batch))
    _check(np.array_equal(ed_vec, ed_oracle),
           "vectorised Ed25519 prep != scalar oracle")
    ed_tv = best_of(lambda: ed.prepare_batch(ed_items, ed_batch))
    ed_ts = best_of(lambda: ed.prepare_batch_scalar(ed_items, ed_batch))
    return {
        "prep_batch": batch,
        "ecdsa_prep_items_per_sec": round(batch / tv, 1),
        "ecdsa_prep_scalar_items_per_sec": round(batch / ts, 1),
        "ecdsa_prep_speedup": round(ts / tv, 2),
        "ed25519_prep_batch": ed_batch,
        "ed25519_prep_items_per_sec": round(ed_batch / ed_tv, 1),
        "ed25519_prep_scalar_items_per_sec": round(ed_batch / ed_ts, 1),
        "ed25519_prep_speedup": round(ed_ts / ed_tv, 2),
    }


def bench_hmac(batch: int = HMAC_BATCH, device=None) -> dict:
    """HMAC-SHA256 verify rate of K6' on device-resident arrays, the MACs
    made by K6s (lane 0 held against Python's ``hmac``)."""
    import hmac as py_hmac

    from .ops import sha256
    from .ops.hmac_sha256 import hmac_sign_kernel, hmac_verify_kernel

    dev = backend.resolve_device(device)
    rng = np.random.default_rng(0)
    keys_np = rng.integers(0, 2**32, (batch, 8), dtype=np.uint32)
    msgs_np = rng.integers(0, 2**32, (batch, 8), dtype=np.uint32)
    keys = sha256.as_i32(keys_np).to(dev)
    msgs = sha256.as_i32(msgs_np).to(dev)
    macs = hmac_sign_kernel(keys, msgs)
    mac0 = py_hmac.new(sha256.words_to_bytes(keys_np[0]),
                       sha256.words_to_bytes(msgs_np[0]), hashlib.sha256).digest()
    _check(sha256.words_to_bytes(sha256.as_u32(macs[0])) == mac0, "HMAC != Python hmac")
    macs = sha256.as_i32(sha256.as_u32(macs)).to(dev)  # int32 carriers on every device
    _check(bool(hmac_verify_kernel(keys, msgs, macs).all()),
           "valid HMAC batch rejected")
    dt, out = _timed(lambda: hmac_verify_kernel(keys, msgs, macs), _iters(dev, 50), dev)
    _check(bool(out.all()), "valid HMAC batch rejected (timed)")
    return {"hmac_batch": batch, "hmac_verifies_per_sec": batch / dt}


# ---------------------------------------------------------------------------
# Cluster section.


def _bench_cluster_repeated(*args, **kw) -> dict:
    """Run a cluster configuration MINBFT_BENCH_RUNS times (default 3)
    and report mean ± stddev of committed req/s; the other keys come from
    the last run.  ``warm_run`` adds one short untimed pass first,
    ``trace_run`` one short traced pass for the ``_stage_``/``_critpath_``
    keys, and, unless MINBFT_BENCH_SKIP_SLO or ``no_dedup``, one shorter
    run at the client depth that Little's law gives for a 500 ms p50
    (MINBFT_BENCH_SLO_P50_MS).  Any failed run, a request past its
    deadline included, fails the configuration."""
    runs = kw.pop("runs", None) or int(os.environ.get("MINBFT_BENCH_RUNS", "3"))
    prefix = kw.get("prefix", "e2e")
    trace_run = kw.pop("trace_run", False)
    out: dict = {}
    vals = []

    def run(run_args, run_kw):
        # Wedge forensics while the run is live: a stack dump to stderr
        # if it is still going after 180 s (the process keeps running).
        faulthandler.dump_traceback_later(180, exit=False, file=sys.stderr)
        try:
            return asyncio.run(_bench_cluster(*run_args, **run_kw))
        finally:
            faulthandler.cancel_dump_traceback_later()

    if kw.pop("warm_run", False):
        warm_args = list(args)
        if len(warm_args) >= 3:
            warm_args[2] = min(warm_args[2], 1500)
        run(warm_args, dict(kw, prefix="warm"))
    for _ in range(max(runs, 1)):
        out = run(args, kw)
        vals.append(out[f"{prefix}_committed_req_per_sec"])
    out[f"{prefix}_req_per_sec_runs"] = vals
    out[f"{prefix}_committed_req_per_sec"] = round(statistics.mean(vals), 1)
    out[f"{prefix}_req_per_sec_mean"] = out[f"{prefix}_committed_req_per_sec"]
    out[f"{prefix}_req_per_sec_stddev"] = (
        round(statistics.stdev(vals), 1) if len(vals) > 1 else 0.0
    )
    if trace_run:
        tr_args = list(args)
        if len(tr_args) >= 3:
            tr_args[2] = min(tr_args[2], max(tr_args[2] // 2, 300))
        traced = run(tr_args, dict(kw, trace=True))
        out.update({k: v for k, v in traced.items()
                    if "_stage_" in k or "_critpath_" in k})
    if os.environ.get("MINBFT_BENCH_SKIP_SLO") or kw.get("no_dedup"):
        return out
    target = float(os.environ.get("MINBFT_BENCH_SLO_P50_MS", "500"))
    depth = kw.get("depth") or int(os.environ.get("MINBFT_BENCH_DEPTH", "24"))
    p50 = out.get(f"{prefix}_request_latency_p50_ms", 0.0)
    slo_depth = max(1, min(depth, round(depth * target / max(p50, 1.0))))
    slo_args = list(args)
    if len(slo_args) >= 3:
        slo_args[2] = max(slo_args[2] // 4, 400)
    slo = run(slo_args, dict(kw, prefix="slo", depth=slo_depth))
    out[f"{prefix}_req_per_sec_at_p50_{int(target)}ms"] = (
        slo["slo_committed_req_per_sec"]
    )
    out[f"{prefix}_slo_depth"] = slo_depth
    out[f"{prefix}_slo_achieved_p50_ms"] = slo["slo_request_latency_p50_ms"]
    out[f"{prefix}_slo_achieved_p99_ms"] = slo["slo_request_latency_p99_ms"]
    return out


def _unique(engines) -> list:
    return list({id(e): e for e in engines}.values())


async def _bench_cluster(
    n: int,
    f: int,
    n_requests: int,
    n_clients: int = 64,
    usig_kind: str = "hmac",
    scheme: str = "ecdsa-p256",
    max_batch: int = 512,
    prefix: str = "e2e",
    isolated_engines: bool = False,
    depth: int = None,
    no_dedup: bool = False,
    batchsize_prepare: int = 256,
    trace: bool = False,
    device=None,
) -> dict:
    """Committed-request throughput through an in-process cluster of the
    port: n replicas (replica core, SimpleLedger) and ``n_clients``
    clients on in-process stubs, each client pipelining ``depth``
    requests (MINBFT_BENCH_DEPTH, 24) of its share.  One engine is shared
    by every replica and client (``isolated_engines``: one per replica,
    the clients on another); one bucket, ``max_batch``.  ``scheme`` is
    the CLIENT/REPLICA scheme (``ecdsa-p256``, ``ed25519`` or ``mac``),
    ``usig_kind`` the USIG's (``ecdsa`` or ``hmac``)."""
    from .client import new_client
    from .core import new_replica
    from .obs import CounterSampler, DeviceLedger, TimeSeries
    from .obs.timeseries import register_engine_series
    from .parallel import BatchVerifier
    from .parallel.engine import SignStats, VerifyStats
    from .sample.authentication import (
        new_test_authenticators,
        new_test_mac_authenticators,
    )
    from .sample.config import SimpleConfiger
    from .sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from .sample.requestconsumer import SimpleLedger
    from .utils.metrics import aggregate

    dev = backend.resolve_device(device)
    # Eager tasks: most protocol tasks complete without suspending (memo
    # hits, buffered sends), so running them at spawn saves loop turns.
    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)
    # ``no_dedup`` turns off the engine's memo (every verification takes a
    # lane) and the core's verified-message memo, as in the reference.
    shared = BatchVerifier(max_batch=max_batch, buckets=(max_batch,),
                           dedup=not no_dedup, device=dev)
    if isolated_engines:
        # One engine per replica, as separate hosts would have: nothing is
        # deduplicated across replicas.  The clients keep ``shared``.
        engines = [
            BatchVerifier(max_batch=max_batch, buckets=(max_batch,),
                          dedup=not no_dedup, device=dev)
            for _ in range(n)
        ]
    else:
        engines = [shared] * n
    configer = SimpleConfiger(
        n=n, f=f,
        # Above the per-request deadline: a stalled run fails at the
        # deadline instead of starting a view change.
        timeout_request=900.0, timeout_prepare=450.0,
        batchsize_prepare=batchsize_prepare,
    )
    if no_dedup:
        configer.dedup_verify = False
    if trace:
        configer.trace = True
    if scheme == "mac":
        replica_auths, client_auths = new_test_mac_authenticators(
            n, n_clients=n_clients, usig_kind=usig_kind, engines=engines,
            client_engine=shared,
        )
    else:
        replica_auths, client_auths = new_test_authenticators(
            n, n_clients=n_clients, scheme=scheme, usig_kind=usig_kind,
            engines=engines, client_engine=shared,
        )
    stubs = make_testnet_stubs(n)
    ledgers = [SimpleLedger() for _ in range(n)]
    replicas = []
    for i in range(n):
        r = new_replica(
            i, configer, replica_auths[i], InProcessPeerConnector(stubs), ledgers[i]
        )
        stubs[i].assign_replica(r)
        replicas.append(r)
    for r in replicas:
        await r.start()
    clients = []
    for c in range(n_clients):
        client = new_client(
            c, n, f, client_auths[c], InProcessClientConnector(stubs),
            seq_start=0, retransmit_interval=30.0, trace=trace,
        )
        await client.start()
        clients.append(client)

    # Warm the USIG's queue at every bucket, then calibrate the ledger's
    # ceiling with the fastest of PROBE_REPS timed full-bucket dispatches
    # on the warm queue, each on a worker thread as the queue's own
    # dispatches run.  One timed dispatch is not enough: just after the
    # cluster starts one can take tens of times the fastest (cfg5 on an
    # H100: 11.1 and 33.9 ms, then 1.1, 0.87 and 0.74 ms), and a ceiling
    # that low puts the fill factor above 1.
    warm_queue = {
        "hmac": ("hmac_sha256", shared._dispatch_hmac, (b"\x00" * 32,) * 3),
        "ecdsa": ("ecdsa_p256", shared._dispatch_ecdsa, ((0, 0), b"\x00" * 32, (0, 0))),
    }[usig_kind]
    qname, dispatch, pad_item = warm_queue
    shared._queue(qname, dispatch)
    for b in shared.buckets:
        await asyncio.to_thread(dispatch, [pad_item] * b)
    probe_s = []
    # (The CPU probe times the plain version: once is enough there.)
    for _ in range(PROBE_REPS if dev.type == "cuda" else 1):
        rate = await asyncio.to_thread(
            DeviceLedger.probe_ceiling, dispatch, pad_item, max_batch
        )
        probe_s.append(max_batch / rate)
    util_ceiling = (max_batch / min(probe_s), "cpu-probe" if dev.type == "cpu" else "probe")
    if scheme == "ed25519":
        shared._queue("ed25519", shared._dispatch_ed25519)
        for b in shared.buckets:
            await asyncio.to_thread(
                shared._dispatch_ed25519, [(b"\x00" * 32, b"", b"\x00" * 64)] * b
            )
    await asyncio.wait_for(clients[0].request(b"warmup"), timeout=600)
    # Warming put all-pad batches into the counters: reset them so the
    # stats are the protocol's traffic only.
    for e in _unique([shared, *engines]):
        for q in e._queues.values():
            q.stats = VerifyStats()
        for q in e._sign_queues.values():
            q.stats = SignStats()
        e.queue_depth_peaks(reset=True)

    # The ledger's window is the timed drive; the sampler ticks through it.
    usig_queue = "hmac_sha256" if usig_kind == "hmac" else "ecdsa_p256"
    # With isolated engines no one engine's clock carries the USIG queue,
    # so the run has no ``_util_`` keys, as in the reference.
    ledger = None if isolated_engines else DeviceLedger(shared)
    if ledger is not None:
        ledger.set_ceiling(usig_queue, util_ceiling[0], util_ceiling[1])
    tseries = TimeSeries()
    sampler = CounterSampler(tseries)
    register_engine_series(sampler, shared)
    sampler.add_rate(
        "committed",
        # Every replica executes every request: the minimum is what is
        # committed everywhere.
        lambda: min(
            (r.metrics.counters.get("requests_executed", 0) for r in replicas),
            default=0,
        ),
    )

    per_client = n_requests // n_clients
    n_requests = per_client * n_clients
    if depth is None:
        depth = int(os.environ.get("MINBFT_BENCH_DEPTH", "24"))
    latencies_ms: list = []

    async def timed_request(client, k: int) -> None:
        t = time.perf_counter()
        await asyncio.wait_for(client.request(b"op-%d" % k), timeout=REQUEST_TIMEOUT_S)
        latencies_ms.append((time.perf_counter() - t) * 1e3)

    async def drive(client) -> None:
        for k0 in range(0, per_client, depth):
            await asyncio.gather(
                *[timed_request(client, k)
                  for k in range(k0, min(k0 + depth, per_client))]
            )

    sampler_task = asyncio.get_running_loop().create_task(sampler.run())
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*[drive(c) for c in clients])
    finally:
        dt = time.perf_counter() - t0
        util_keys = ledger.util_keys(prefix, usig_queue) if ledger else {}
        sampler_task.cancel()
        try:
            await sampler_task
        except asyncio.CancelledError:
            pass

    batch_stats: dict = {}
    timeouts = 0
    sign_agg = {"items": 0, "fallback": 0, "prep_s": 0.0, "disp_s": 0.0}
    for e in _unique(engines):
        for name, st in e.stats.items():
            agg = batch_stats.setdefault(name, {
                "items": 0, "batches": 0, "memo_hits": 0,
                "host_prep_time_s": 0.0, "device_time_s": 0.0,
            })
            agg["items"] += st.items
            agg["batches"] += st.batches
            agg["memo_hits"] += st.memo_hits
            agg["host_prep_time_s"] += st.host_prep_time_s
            agg["device_time_s"] += st.device_time_s
            timeouts += st.dispatch_timeouts
        for st in e.sign_stats.values():
            sign_agg["items"] += st.items
            sign_agg["fallback"] += st.host_fallback_items
            sign_agg["prep_s"] += st.host_prep_time_s
            sign_agg["disp_s"] += st.device_time_s
            timeouts += st.dispatch_timeouts
    sig_stats = batch_stats.get("ed25519") if scheme == "ed25519" else None
    device_signs = sign_agg["items"] - sign_agg["fallback"]

    # Clients finish on f+1 matching replies; the other replicas may still
    # be draining.  Wait for them before the invariant check.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not all(
        lg.length >= n_requests + 1 for lg in ledgers
    ):
        await asyncio.sleep(0.05)
    for client in clients:
        await client.stop()
    for r in replicas:
        await r.stop()

    stage_keys: dict = {}
    if trace:
        stage_keys = _trace_tables(replicas, clients, _unique(engines), prefix)
    lengths = [lg.length for lg in ledgers]
    if not all(x >= n_requests + 1 for x in lengths):
        raise BenchError(f"{prefix}: ledgers {lengths} short of {n_requests + 1}")
    agg = aggregate(r.metrics.snapshot() for r in replicas)
    lat = np.asarray(sorted(latencies_ms))
    uq = batch_stats.get(usig_queue, {})
    return {
        f"{prefix}_request_latency_p50_ms": round(float(np.percentile(lat, 50)), 2),
        f"{prefix}_request_latency_p99_ms": round(float(np.percentile(lat, 99)), 2),
        f"{prefix}_exec_latency_p50_ms": agg.get("execute_latency_p50_ms", 0),
        f"{prefix}_exec_latency_p99_ms": agg.get("execute_latency_p99_ms", 0),
        f"{prefix}_messages_handled": agg.get("messages_handled", 0),
        f"{prefix}_messages_dropped": agg.get("messages_dropped", 0),
        f"{prefix}_n": n,
        f"{prefix}_f": f,
        f"{prefix}_clients": n_clients,
        f"{prefix}_requests": n_requests,
        f"{prefix}_committed_req_per_sec": round(n_requests / dt, 1),
        # The core's bundle-ingest runtime (core/message_handling.py
        # _BundleIngestor, on unless MINBFT_BUNDLE_INGEST=0) counts its
        # ticks and the frames each tick drains: the mean frames per tick
        # and the ticks per second over the timed run.
        f"{prefix}_ingest_batch_mean": round(
            agg.get("ingest_frames", 0) / max(agg.get("ingest_ticks", 0), 1), 2
        ),
        f"{prefix}_ingest_ticks_per_sec": round(agg.get("ingest_ticks", 0) / dt, 1),
        f"{prefix}_batched_verifies": uq.get("items", 0),
        f"{prefix}_batches": uq.get("batches", 0),
        f"{prefix}_mean_batch": round(
            uq.get("items", 0) / max(uq.get("batches", 0), 1), 1
        ),
        f"{prefix}_device_verifies_per_sec": round(uq.get("items", 0) / dt, 1),
        f"{prefix}_logical_verifies": uq.get("items", 0) + uq.get("memo_hits", 0),
        f"{prefix}_memo_hits": uq.get("memo_hits", 0),
        # Not a reference key: every failed-by-timeout dispatch of the
        # run, over all queues (the reference fell back to the host).
        f"{prefix}_dispatch_timeouts": timeouts,
        **(
            {
                f"{prefix}_sig_batched_verifies": sig_stats["items"],
                f"{prefix}_sig_batches": sig_stats["batches"],
            }
            if sig_stats
            else {}
        ),
        **{
            f"{prefix}_{name}_prep_share": round(
                s["host_prep_time_s"] / s["device_time_s"], 4
            )
            for name, s in batch_stats.items()
            if s["device_time_s"] > 0 and s["host_prep_time_s"] > 0
        },
        **(
            {
                f"{prefix}_device_signs_per_sec": round(device_signs / dt, 1),
                f"{prefix}_sign_share": round(device_signs / sign_agg["items"], 4),
                f"{prefix}_sign_fallback_items": sign_agg["fallback"],
                f"{prefix}_queue_signs": sign_agg["items"],
            }
            if sign_agg["items"]
            else {}
        ),
        **(
            {f"{prefix}_sign_prep_share": round(
                sign_agg["prep_s"] / sign_agg["disp_s"], 4
            )}
            if sign_agg["disp_s"] > 0 and sign_agg["prep_s"] > 0
            else {}
        ),
        **stage_keys,
        **util_keys,
        # Not a reference key: each of the ceiling probe's timed
        # dispatches, in ms (the ceiling is the bucket over the fastest).
        **({f"{prefix}_util_probe_ms": [round(t * 1e3, 4) for t in probe_s]}
           if util_keys else {}),
        f"{prefix}_queue_depth_peak": shared.queue_depth_peaks().get(usig_queue, 0),
        **_timeline_keys(prefix, tseries),
    }


def _timeline_keys(prefix: str, tseries) -> dict:
    """A run's saturation timeline (its sampler's committed, verify and
    queue-depth series) under ``{prefix}_timeline``, as the reference
    emits it; nothing when the sampler never ticked."""
    if not tseries.names():
        return {}
    series = {}
    for name in ("committed", "verify_items", "verify_fill", "queue_depth"):
        start, vals = tseries.timeline(name)
        if vals:
            series[name] = {"start_index": start, "values": [round(v, 2) for v in vals]}
    return {f"{prefix}_timeline": {"interval_s": tseries.interval_s, "series": series}}


def _trace_tables(replicas, clients, engines, prefix: str) -> dict:
    """The flight-recorder stage table and the cluster critical path of a
    traced run, from every recorder's dump document (the deployments'
    trace format, built in memory).  Each document holds every event its
    ring still has: with thousands of requests in flight, a dump's default
    newest 4,096 events leave no request with its whole path at a
    replica, and the critical path would come out empty."""
    from .obs import critpath as obs_critpath
    from .obs import trace as obs_trace

    def doc(rec, extra=None):
        d = rec.to_dict(max_events=rec.ring.capacity)
        d.update(extra or {})
        return d

    docs = [doc(r.handlers.trace, r.trace_dump_extra()) for r in replicas]
    docs += [doc(c._trace) for c in clients if c._trace is not None]
    docs += [obs_critpath.engine_queue_doc(e, ident=i) for i, e in enumerate(engines)]
    keys = obs_trace.stage_table(docs, prefix)
    keys.update(obs_critpath.critpath_table(docs, prefix))
    return keys


# ---------------------------------------------------------------------------
# Entry point.


# -- multi-process clusters (the reference's mp / mptcp runs) -------------

# Orphan protection: a timed-out or killed bench parent must not leave a
# cluster of replica and client processes running on the host and the
# card.  Each child is launched through a small -c bootstrap that sets
# PR_SET_PDEATHSIG=SIGKILL and then execs the real module (pdeathsig
# survives execve; no preexec_fn in a threaded parent).
_PDEATH_BOOTSTRAP = (
    "import ctypes,os,sys;"
    "ctypes.CDLL('libc.so.6',use_errno=True).prctl(1,9);"
    "os.execv(sys.executable,[sys.executable]+sys.argv[1:])"
)
# Seconds a replica may take to exit after SIGTERM (its engine's last
# dispatch, its dumps) before the bench fails it.
MP_STOP_TIMEOUT_S = 60.0


def _child_cmd(*module_args) -> list:
    """python -c <pdeathsig bootstrap> <module_args...> — the child kills
    itself when this process dies."""
    return [sys.executable, "-c", _PDEATH_BOOTSTRAP, *module_args]


def _proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of a live process (Linux /proc)."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def gpu_memory_used_mib() -> float:
    """Device memory in use on card 0, every process's context and
    allocations together (``nvidia-smi --query-gpu=memory.used``).  The
    per-process reading (``--query-compute-apps``) is no use here: the
    card's sandbox reports every process under one pid."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


class ProcessSampler:
    """Samples the CPU seconds of a set of processes (every ``period``
    seconds, on a thread) and, with ``gpu``, the peak device memory in use
    (``gpu_memory_used_mib``, every other sample); :meth:`cpu_per_wall`
    reads each process's CPU seconds per wall second over a window from
    the nearest samples around it (one is taken as the sampler starts and
    one as it stops)."""

    def __init__(self, pids, period: float = 0.5, gpu: bool = False):
        import threading

        self.pids = list(pids)
        self.period = period
        self.gpu = gpu
        self.samples: list = []  # (time.time(), {pid: cpu_s})
        self.gpu_peak_mib = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        self._sample()

    def _sample(self) -> None:
        now = time.time()
        cpu = {}
        for pid in self.pids:
            try:
                cpu[pid] = _proc_cpu_s(pid)
            except (OSError, IndexError, ValueError):
                pass  # the process has exited
        self.samples.append((now, cpu))

    def _loop(self) -> None:
        k = 0
        while not self._stop.is_set():
            self._sample()
            if self.gpu and k % 2 == 0:
                self.gpu_peak_mib = max(self.gpu_peak_mib, gpu_memory_used_mib())
            k += 1
            self._stop.wait(self.period)

    def cpu_per_wall(self, t0: float, t1: float) -> list:
        before = [s for s in self.samples if s[0] <= t0] or self.samples[:1]
        after = [s for s in self.samples if s[0] >= t1] or self.samples[-1:]
        (ta, a), (tb, b) = before[-1], after[0]
        if tb <= ta:
            raise BenchError(f"no CPU samples around the window {t0}..{t1}")
        return [round((b[p] - a[p]) / (tb - ta), 3) for p in self.pids
                if p in a and p in b]


def _error_lines(log_path: str, limit: int) -> list:
    """The ERROR records in the first ``limit`` bytes of a log."""
    with open(log_path, "rb") as fh:
        text = fh.read(limit).decode(errors="replace")
    return [ln.rstrip() for ln in text.splitlines() if " ERROR " in ln]


def engine_faults(rep: dict, device: str) -> list:
    """What is wrong with a process's engine report (``peer`` CLI
    ``engine_report``): an engine off ``device``, on the card a K2 or K3
    that never launched (the plain versions count no launch), no ECDSA
    verify or sign batch, a dispatch that timed out, a lane signed on the
    host.  Empty when the process ran the path on its engine."""
    faults = []
    if rep["device"] != device:
        faults.append(f"engine on {rep['device']}, not {device}")
    if device.startswith("cuda") and not all(rep["launches"][k] for k in ("K2", "K3")):
        faults.append(f"a kernel of the path was not launched: {rep['launches']}")
    if not (rep["verify"].get("ecdsa_p256", {}).get("batches", 0)
            and rep["sign"].get("ecdsa_p256", {}).get("batches", 0)):
        faults.append("no ECDSA verify or sign batch")
    timeouts = sum(q["dispatch_timeouts"] for side in ("verify", "sign")
                   for q in rep[side].values())
    if timeouts:
        faults.append(f"{timeouts} dispatches timed out")
    if any(q.get("host_fallback_items", 0) for q in rep["sign"].values()):
        faults.append(f"host-signed lanes: {rep['sign']}")
    return faults


def launch_totals(reports: list) -> dict:
    """K2, K3 and K6 launches summed over processes' engine reports."""
    return {kid: sum(rep["launches"][kid] for rep in reports)
            for kid in ("K2", "K3", "K6")}


def _bench_mp_cluster(
    n: int,
    f: int,
    n_requests: int,
    device: str,
    n_client_procs: int = 1,
    clients_per_proc: int = 20,
    depth: int = 32,
    prefix: str = "mp",
    run_tag: str = "r",
    transport: str = "grpc",
) -> dict:
    """Committed-request throughput through a multi-process cluster: one
    OS process per replica (``peer run``) over gRPC or TCP sockets, the
    clients in their own processes (``peer bench``) — the reference's
    deployment shape (reference sample/peer/main.go + cmd/run.go:91-159).

    Every replica and client process owns an engine on ``device`` (on the
    card, its own CUDA context): K2 checks its signatures and ECDSA USIG
    certificates, K3 makes its REQUEST/REPLY signatures.  The run fails
    on a client process that fails, a replica that logs an ERROR record
    before it is stopped, a replica that does not exit 0 within
    MP_STOP_TIMEOUT_S of SIGTERM, or an engine report with a fault
    (``engine_faults``).  Besides the reference's keys it reports each
    replica's host CPU seconds per wall second over the clients' drive,
    the kernel launches of the replicas and clients and, on the card, the
    CUDA contexts the processes opened (each reports whether it did), the
    MiB each one's PyTorch allocator held, and the device memory they
    took together."""
    import shutil
    import tempfile

    repo = os.path.dirname(_PKG_DIR)
    d = tempfile.mkdtemp(prefix="minbft-torch-mp-bench.")
    base_port = _free_base_port(n)
    env = dict(
        os.environ,
        PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        # Steady-state measurement: protocol timeouts sit above the
        # per-request deadline so a transient stall fails the request,
        # not the whole run via a view-change cascade.
        CONSENSUS_TIMEOUT_REQUEST="600s",
        CONSENSUS_TIMEOUT_PREPARE="300s",
        CONSENSUS_TIMEOUT_VIEWCHANGE="600s",
        # Request batching at the in-process configurations' setting.
        CONSENSUS_BATCHSIZE_PREPARE=os.environ.get(
            "MINBFT_BENCH_MP_BATCHSIZE", "256"
        ),
    )
    peer = ["-m", "minbft_tpu_torch.sample.peer", "--keys", f"{d}/keys.yaml",
            "--config", f"{d}/consensus.yaml", "--transport", transport]
    n_clients = n_client_procs * clients_per_proc
    on_card = device.startswith("cuda")
    replicas: list = []
    client_procs: list = []
    logs: list = []
    try:
        # Device memory in use before any process of the run starts (the
        # measuring process's own context included, if it has one).
        baseline_mib = gpu_memory_used_mib() if on_card else 0.0
        scaffold = subprocess.run(
            [sys.executable, "-m", "minbft_tpu_torch.sample.peer", "testnet",
             "-n", str(n), "-f", str(f), "-d", d,
             "--base-port", str(base_port), "--clients", str(n_clients),
             "--usig", "auto"],
            env=env, capture_output=True, text=True, timeout=300,
        )
        if scaffold.returncode != 0:
            raise BenchError(f"mp scaffold failed: {scaffold.stderr[-500:]}")
        for i in range(n):
            log = open(f"{d}/replica{i}.log", "wb")
            logs.append(log)
            replicas.append(subprocess.Popen(
                _child_cmd(*peer, "run", str(i), "--device", device),
                env=env, stdout=subprocess.DEVNULL, stderr=log,
            ))
        if not _wait_ports([base_port + i for i in range(n)]):
            raise BenchError("mp replicas never bound their ports")

        per_proc = n_requests // n_client_procs
        for p in range(n_client_procs):
            client_procs.append(subprocess.Popen(
                _child_cmd(
                    *peer, "bench",
                    "--clients", str(clients_per_proc),
                    "--client-base", str(p * clients_per_proc),
                    "--requests", str(per_proc),
                    "--depth", str(depth),
                    "--tag", f"{run_tag}p{p}",
                    "--timeout", str(int(REQUEST_TIMEOUT_S)),
                    "--device", device,
                ),
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ))
        reports = []
        with ProcessSampler([r.pid for r in replicas], gpu=on_card) as sampler:
            for p in client_procs:
                stdout, stderr = p.communicate(timeout=1200)
                if p.returncode != 0:
                    raise BenchError(f"mp client proc failed: {stderr[-500:]}")
                errs = [ln for ln in stderr.splitlines() if " ERROR " in ln]
                if errs:
                    raise BenchError(f"mp client proc logged ERROR: {errs[:3]}")
                reports.append(json.loads(stdout.strip().splitlines()[-1]))
            t_end = time.time()
        # The drive window of the longest-running client process.
        t_start = t_end - max(r["seconds"] for r in reports)
        cpu = sampler.cpu_per_wall(t_start, t_end)

        # Clean stop: every replica must exit 0 on SIGTERM.  What a
        # replica logs from here on is shutdown (over gRPC the survivors
        # log each stopped peer's failed stream at ERROR, as the
        # reference's core does), so the ERROR check reads each log only
        # up to this point.
        served = [os.path.getsize(f"{d}/replica{i}.log") for i in range(n)]
        for r in replicas:
            r.terminate()
        for i, r in enumerate(replicas):
            try:
                rc = r.wait(timeout=MP_STOP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise BenchError(
                    f"mp replica {i} still running {MP_STOP_TIMEOUT_S} s after SIGTERM"
                ) from None
            if rc != 0:
                raise BenchError(f"mp replica {i} exited {rc} after SIGTERM")
        engines = []
        for i in range(n):
            path = f"{d}/replica{i}.log"
            errs = _error_lines(path, served[i])
            if errs:
                raise BenchError(f"mp replica {i} logged ERROR: {errs[:3]}")
            rep = read_engine_report(path)
            if rep is None:
                raise BenchError(f"mp replica {i} printed no engine report")
            engines.append((f"replica {i}", rep))
        engines += [(f"client proc {p}", r["engine"]) for p, r in enumerate(reports)]
        for who, rep in engines:
            faults = engine_faults(rep, device)
            if faults:
                raise BenchError(f"mp {who}: {'; '.join(faults)}")

        committed = sum(r["committed"] for r in reports)
        # The procs drive concurrently (launched within ~1s); the longest
        # proc clock bounds the concurrent window without counting the
        # interpreters' startup.
        wall = max(r["seconds"] for r in reports)
        lat = np.asarray(sorted(v for r in reports for v in r["latencies_ms"]))
        out = {
            f"{prefix}_n": n,
            f"{prefix}_f": f,
            f"{prefix}_requests": committed,
            f"{prefix}_clients": n_clients,
            f"{prefix}_client_procs": n_client_procs,
            f"{prefix}_depth": depth,
            f"{prefix}_committed_req_per_sec": round(committed / wall, 1),
            f"{prefix}_request_latency_p50_ms": round(float(np.percentile(lat, 50)), 2),
            f"{prefix}_request_latency_p99_ms": round(float(np.percentile(lat, 99)), 2),
            f"{prefix}_replica_cpu_per_wall": cpu,
            f"{prefix}_client_cpu_per_wall": [r["cpu_per_wall"] for r in reports],
            f"{prefix}_replica_launches": launch_totals([rep for _, rep in engines[:n]]),
            f"{prefix}_client_launches": launch_totals([rep for _, rep in engines[n:]]),
        }
        if on_card:
            # The contexts are counted from the processes' own reports
            # (each says whether it initialised CUDA); the card's sandbox
            # lists every process under one pid, so the memory they took
            # together is the device's peak in use over the drive less
            # the baseline, and beside it each process's allocator holding.
            contexts = sum(bool(rep["cuda_context"]) for _, rep in engines)
            run_mib = sampler.gpu_peak_mib - baseline_mib
            out[f"{prefix}_cuda_contexts"] = contexts
            out[f"{prefix}_cuda_reserved_mib"] = [rep["cuda_reserved_mib"]
                                                  for _, rep in engines]
            out[f"{prefix}_gpu_memory_mib"] = run_mib
            out[f"{prefix}_context_mib"] = round(run_mib / max(contexts, 1), 1)
        return out
    finally:
        # Client procs FIRST (a failed run must not leave them
        # retransmitting into the next run's measurement window), then
        # replicas.
        for p in client_procs + replicas:
            if p.poll() is None:
                p.kill()
        for p in client_procs + replicas:
            p.wait(timeout=30)
        for log in logs:
            log.close()
        shutil.rmtree(d, ignore_errors=True)


def _bench_mp_repeated(n, f, n_requests, prefix="mp", depth=None, **kw) -> dict:
    """Mean ± stddev over MINBFT_BENCH_RUNS multi-process runs, then one
    latency-bounded run: depth re-tuned by Little's law to the 500 ms p50
    target (MINBFT_BENCH_SLO_P50_MS), reported as
    ``*_req_per_sec_at_p50_500ms``, unless MINBFT_BENCH_SKIP_SLO.  Any
    failed run fails the section (the reference logs it and goes on)."""
    runs = int(os.environ.get("MINBFT_BENCH_RUNS", "3"))
    if depth is None:
        depth = int(os.environ.get("MINBFT_BENCH_MP_DEPTH", "32"))
    out: dict = {}
    vals = []
    for i in range(max(runs, 1)):
        out = _bench_mp_cluster(n, f, n_requests, depth=depth, prefix=prefix,
                                run_tag=f"r{i}", **kw)
        vals.append(out[f"{prefix}_committed_req_per_sec"])
    out[f"{prefix}_req_per_sec_runs"] = vals
    out[f"{prefix}_committed_req_per_sec"] = round(statistics.mean(vals), 1)
    out[f"{prefix}_req_per_sec_mean"] = out[f"{prefix}_committed_req_per_sec"]
    out[f"{prefix}_req_per_sec_stddev"] = (
        round(statistics.stdev(vals), 1) if len(vals) > 1 else 0.0
    )
    if os.environ.get("MINBFT_BENCH_SKIP_SLO"):
        return out
    target = float(os.environ.get("MINBFT_BENCH_SLO_P50_MS", "500"))
    p50 = out[f"{prefix}_request_latency_p50_ms"]
    slo_depth = max(1, min(depth, round(depth * target / max(p50, 1.0))))
    slo = _bench_mp_cluster(n, f, max(n_requests // 4, 1000), depth=slo_depth,
                            prefix="slo", run_tag="slo", **kw)
    out[f"{prefix}_req_per_sec_at_p50_{int(target)}ms"] = slo[
        "slo_committed_req_per_sec"
    ]
    out[f"{prefix}_slo_depth"] = slo_depth
    out[f"{prefix}_slo_achieved_p50_ms"] = slo["slo_request_latency_p50_ms"]
    out[f"{prefix}_slo_achieved_p99_ms"] = slo["slo_request_latency_p99_ms"]
    return out


async def _bench_readonly(n=4, f=1, n_reads=4000, n_clients=16) -> dict:
    """Read-only fast-path throughput: reads skip consensus — one
    broadcast, n query replies, no PREPARE/COMMIT waves, no USIG — so
    read throughput shows what the ordering pipeline costs writes.
    Minimal in-process cluster with host crypto, as in the reference:
    reads never touch an engine, so this section launches no kernel.
    Unlike the reference, a failed run fails the section."""
    from .client import new_client
    from .core import new_replica
    from .sample.authentication import new_test_authenticators
    from .sample.config import SimpleConfiger
    from .sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from .sample.requestconsumer import SimpleLedger

    cfg = SimpleConfiger(n=n, f=f, timeout_request=900.0, timeout_prepare=450.0)
    r_auths, c_auths = new_test_authenticators(n, n_clients=n_clients)
    stubs = make_testnet_stubs(n)
    ledgers = [SimpleLedger() for _ in range(n)]
    replicas = []
    for i in range(n):
        r = new_replica(i, cfg, r_auths[i], InProcessPeerConnector(stubs), ledgers[i])
        stubs[i].assign_replica(r)
        replicas.append(r)
    for r in replicas:
        await r.start()
    clients = []
    for c in range(n_clients):
        # Heal rare losses instead of wedging the section (as
        # _bench_cluster): the ordered-read fallback has no per-request
        # deadline here.
        client = new_client(c, n, f, c_auths[c], InProcessClientConnector(stubs),
                            seq_start=0, retransmit_interval=30.0)
        await client.start()
        clients.append(client)
    try:
        await asyncio.wait_for(clients[0].request(b"write-1"), REQUEST_TIMEOUT_S)
        for _ in range(200):  # all n ledgers must agree before fast reads
            if all(lg.length == 1 for lg in ledgers):
                break
            await asyncio.sleep(0.02)
        if not all(lg.length == 1 for lg in ledgers):
            # Proceeding would turn every fast read into a 30 s all-n
            # timeout and fallback: fail the section fast instead.
            raise BenchError(f"readonly: the cluster never agreed on the seed "
                             f"write: {[lg.length for lg in ledgers]}")
        per = max(1, n_reads // n_clients)
        n_reads = per * n_clients

        async def reader(cl):
            for _ in range(per):
                await cl.request(b"head", read_only=True, read_timeout=30.0)

        t0 = time.monotonic()
        await asyncio.wait_for(asyncio.gather(*(reader(cl) for cl in clients)), 600)
        elapsed = time.monotonic() - t0
        fast_served = sum(
            r.handlers.metrics.counters.get("readonly_served", 0) for r in replicas
        )
        return {
            "ro_reads": n_reads,
            "ro_clients": n_clients,
            "ro_reads_per_sec": round(n_reads / elapsed, 1),
            # n * n_reads when every read took the fast path (no fallback)
            "ro_fast_replies": fast_served,
        }
    finally:
        for cl in clients:
            await cl.stop()
        for r in replicas:
            await r.stop()


INGEST_POINTS = (("ingest_off", None), ("ingest8", 8), ("ingest64", 64),
                 ("ingest1024", 1024))


def bench_ingest_sweep(n_requests: int = 600, n_clients: int = 16,
                       device=None) -> dict:
    """Ingest-batch-size sweep: one short in-process cluster run (n = 4,
    HMAC USIGs, one bucket of 128, the engine on ``device``) per
    operating point of the core's bundle-ingest runtime —

    - ``ingest_off``: MINBFT_BUNDLE_INGEST=0, the per-frame-task path;
    - ``ingest{K}``: bundle ingest with MINBFT_INGEST_MAX=K flat frames
      per tick.

    Each point emits the cluster keys under its prefix, so its committed
    req/s rides next to its ``*_ingest_batch_mean`` and
    ``*_ingest_ticks_per_sec``: how much bundle the drain collects at
    each cap, and what that buys.  HMAC USIGs keep the crypto cheap, so
    the host pipeline (what the sweep varies) dominates.  Unlike the
    reference, which prints a failed point and goes on, a failed point
    fails the section."""
    out: dict = {}
    for prefix, cap in INGEST_POINTS:
        env_before = {
            k: os.environ.get(k) for k in ("MINBFT_BUNDLE_INGEST", "MINBFT_INGEST_MAX")
        }
        if cap is None:
            os.environ["MINBFT_BUNDLE_INGEST"] = "0"
            os.environ.pop("MINBFT_INGEST_MAX", None)
        else:
            os.environ.pop("MINBFT_BUNDLE_INGEST", None)
            os.environ["MINBFT_INGEST_MAX"] = str(cap)
        try:
            out.update(asyncio.run(_bench_cluster(
                4, 1, n_requests, n_clients=n_clients, usig_kind="hmac",
                max_batch=128, prefix=prefix, device=device)))
        finally:
            for k, v in env_before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


async def _bench_groups_cluster(
    n_groups: int,
    per_group_requests: int,
    n: int = 4,
    f: int = 1,
    n_clients: int = 8,
    max_batch: int = 128,
    device=None,
) -> dict:
    """One multi-group in-process cluster (``groups/``): G group cores per
    replica over shared transport and ONE shared engine on ``device``,
    the client side a shard-routing MultiGroupClient per client id, the
    clients on the same engine.

    Per-group load is FIXED across the sweep (``per_group_requests``
    split over ``n_clients`` clients, round-robin-pinned across groups
    so every group gets exactly its share): aggregate committed req/s
    then scales with G until the crypto saturates, and the shared USIG
    verify queue's mean batch fill rises with G by construction — the
    DSig cross-flow amortization claim, measured.

    Placement differs from the reference, which checks REQUEST/REPLY
    signatures on its engine's host queue: here they go to K2 (verify)
    and K3 (REQUEST and REPLY signs), and the HMAC USIG certificates to
    K6, all in the one engine.  A short ledger or a request past its
    deadline raises :class:`BenchError`."""
    from .groups import GroupRuntime, MultiGroupClient
    from .obs import CounterSampler, DeviceLedger, TimeSeries
    from .obs.timeseries import register_engine_series
    from .parallel import BatchVerifier
    from .parallel.engine import SignStats, VerifyStats
    from .sample.authentication import new_test_authenticators
    from .sample.config import SimpleConfiger
    from .sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from .sample.requestconsumer import SimpleLedger

    dev = backend.resolve_device(device)
    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)
    shared = BatchVerifier(max_batch=max_batch, buckets=(max_batch,), device=dev)
    configer = SimpleConfiger(
        n=n, f=f, timeout_request=900.0, timeout_prepare=450.0,
        batchsize_prepare=256, groups=n_groups,
    )
    # One authenticator SET per group (own USIG counter spaces), all
    # landing on the one shared engine.
    per_group = [
        new_test_authenticators(
            n, n_clients=n_clients, usig_kind="hmac", engine=shared,
            client_engine=shared,
        )
        for _ in range(n_groups)
    ]
    stubs = make_testnet_stubs(n)
    ledgers = [[SimpleLedger() for _ in range(n_groups)] for _ in range(n)]
    runtimes = []
    for i in range(n):
        rt = GroupRuntime(
            i, configer,
            [per_group[g][0][i] for g in range(n_groups)],
            InProcessPeerConnector(stubs),
            ledgers[i],
        )
        stubs[i].assign_replica(rt)
        runtimes.append(rt)
    clients = []
    try:
        for rt in runtimes:
            await rt.start()
        for c in range(n_clients):
            mc = MultiGroupClient(
                c, n, f, n_groups,
                [per_group[g][1][c] for g in range(n_groups)],
                InProcessClientConnector(stubs),
                retransmit_interval=30.0,
            )
            await mc.start()
            clients.append(mc)

        # Warm the HMAC bucket off the clock, calibrate the ledger's
        # ceiling as _bench_cluster does, then one committed warmup per
        # group and a stats reset so reported batches are protocol
        # traffic.
        pad = (b"\x00" * 32,) * 3
        shared._queue("hmac_sha256", shared._dispatch_hmac)
        await asyncio.to_thread(shared._dispatch_hmac, [pad] * max_batch)
        probe_s = []
        for _ in range(PROBE_REPS if dev.type == "cuda" else 1):
            rate = await asyncio.to_thread(
                DeviceLedger.probe_ceiling, shared._dispatch_hmac, pad, max_batch
            )
            probe_s.append(max_batch / rate)
        await asyncio.gather(*[
            asyncio.wait_for(clients[0].request(b"warmup", group=g), 600)
            for g in range(n_groups)
        ])
        for q in shared._queues.values():
            q.stats = VerifyStats()
        for q in shared._sign_queues.values():
            q.stats = SignStats()
        shared.queue_depth_peaks(reset=True)
        ledger = DeviceLedger(shared)
        ledger.set_ceiling("hmac_sha256", max_batch / min(probe_s),
                           "cpu-probe" if dev.type == "cpu" else "probe")
        tseries = TimeSeries()
        sampler = CounterSampler(tseries)
        register_engine_series(sampler, shared)
        sampler.add_rate(
            "committed",
            # min over replica processes of the per-process cross-group
            # total: the aggregate committed everywhere
            lambda: min(
                (
                    sum(core.metrics.counters.get("requests_executed", 0)
                        for core in rt.cores)
                    for rt in runtimes
                ),
                default=0,
            ),
        )

        per_client = max(per_group_requests * n_groups // n_clients, 1)
        total = per_client * n_clients
        depth = int(os.environ.get("MINBFT_BENCH_DEPTH", "24"))
        latencies_ms: list = []

        async def timed(mc, k: int) -> None:
            t = time.perf_counter()
            # round-robin group pin: exact fixed per-group load at every G
            await asyncio.wait_for(
                mc.request(b"op-%d-%d" % (mc.client_id, k), group=k % n_groups),
                timeout=REQUEST_TIMEOUT_S,
            )
            latencies_ms.append((time.perf_counter() - t) * 1e3)

        async def drive(mc) -> None:
            for k0 in range(0, per_client, depth):
                await asyncio.gather(
                    *[timed(mc, k) for k in range(k0, min(k0 + depth, per_client))]
                )

        sampler_task = asyncio.get_running_loop().create_task(sampler.run())
        t0 = time.perf_counter()
        try:
            await asyncio.gather(*[drive(mc) for mc in clients])
        finally:
            dt = time.perf_counter() - t0
            util_keys = ledger.util_keys(f"groups{n_groups}", "hmac_sha256")
            sampler_task.cancel()
            try:
                await sampler_task
            except asyncio.CancelledError:
                pass
        # Every group's ledger on every replica converges to its share
        # plus its warmup: group g gets floor(per_client/G) (+1 when g <
        # per_client%G) requests per client.  Clients finish on f+1
        # replies, so wait (within a bound) for the others.
        want = [
            n_clients * (per_client // n_groups + (1 if g < per_client % n_groups else 0)) + 1
            for g in range(n_groups)
        ]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
            ledgers[i][g].length >= want[g] for i in range(n) for g in range(n_groups)
        ):
            await asyncio.sleep(0.05)
    finally:
        for mc in clients:
            await mc.stop()
        for rt in runtimes:
            await rt.stop()
    prefix = f"groups{n_groups}"
    for g in range(n_groups):
        lens = [ledgers[i][g].length for i in range(n)]
        digests = {ledgers[i][g].state_digest() for i in range(n)}
        if lens != [want[g]] * n or len(digests) != 1:
            raise BenchError(f"{prefix}: group {g} ledgers {lens} (want {want[g]}), "
                             f"{len(digests)} state digests")
    usig = shared.stats.get("hmac_sha256")
    sig = shared.stats.get("ecdsa_p256")
    timeouts = sum(st.dispatch_timeouts for st in shared.stats.values()) + sum(
        st.dispatch_timeouts for st in shared.sign_stats.values())
    lat = np.asarray(sorted(latencies_ms))
    return {
        f"{prefix}_n": n,
        f"{prefix}_f": f,
        f"{prefix}_requests": total,
        f"{prefix}_clients": n_clients,
        f"{prefix}_committed_req_per_sec": round(total / dt, 1),
        f"{prefix}_request_latency_p50_ms": round(float(np.percentile(lat, 50)), 2),
        # Not a reference key: the tail beside the median.
        f"{prefix}_request_latency_p99_ms": round(float(np.percentile(lat, 99)), 2),
        # THE sweep headline companion: the shared USIG queue's batch
        # fill, which rises with G at fixed per-group load because every
        # group's checks coalesce in the one engine.
        f"{prefix}_verify_mean_batch": round(usig.mean_batch if usig else 0.0, 2),
        f"{prefix}_verify_batches": usig.batches if usig else 0,
        f"{prefix}_device_verifies_per_sec": round((usig.items if usig else 0) / dt, 1),
        # Not reference keys: the signature queue (K2) beside it, and every
        # dispatch of the run that timed out.
        f"{prefix}_sig_mean_batch": round(sig.mean_batch if sig else 0.0, 2),
        f"{prefix}_sig_batches": sig.batches if sig else 0,
        f"{prefix}_dispatch_timeouts": timeouts,
        **util_keys,
        f"{prefix}_queue_depth_peak": shared.queue_depth_peaks().get("hmac_sha256", 0),
        **_timeline_keys(prefix, tseries),
    }


GROUPS_SWEEP = (1, 2, 4, 8, 16)


def bench_groups(per_group_requests: int = 400, device=None) -> dict:
    """Multi-group sharding sweep: G in ``GROUPS_SWEEP`` group cores on
    one process set and ONE shared engine, per-group load held fixed —
    emits ``groups{G}_committed_req_per_sec`` (aggregate) and
    ``groups{G}_verify_mean_batch`` (shared-queue fill) per point, plus
    the ``_req_per_sec_mean/_stddev/_runs`` triple over
    MINBFT_BENCH_GROUPS_RUNS (default 1), and the ``groups_sweep_*``
    meta.  Unlike the reference, which logs a failed point and goes on,
    a failed point fails the section."""
    out: dict = {}
    runs = int(os.environ.get("MINBFT_BENCH_GROUPS_RUNS", "1"))
    for G in GROUPS_SWEEP:
        prefix = f"groups{G}"
        vals = []
        for _ in range(max(runs, 1)):
            point = asyncio.run(_bench_groups_cluster(G, per_group_requests, device=device))
            vals.append(point[f"{prefix}_committed_req_per_sec"])
        out.update(point)
        out[f"{prefix}_req_per_sec_runs"] = vals
        out[f"{prefix}_committed_req_per_sec"] = round(statistics.mean(vals), 1)
        out[f"{prefix}_req_per_sec_mean"] = out[f"{prefix}_committed_req_per_sec"]
        out[f"{prefix}_req_per_sec_stddev"] = (
            round(statistics.stdev(vals), 1) if len(vals) > 1 else 0.0
        )
    out["groups_sweep_Gs"] = list(GROUPS_SWEEP)
    out["groups_sweep_per_group_requests"] = per_group_requests
    return out


def bench_load(device=None) -> dict:
    """Latency-vs-offered-load curves through the open-loop harness
    (``loadgen/``): a saturation probe finds the cluster's sustained
    commit rate, then three seeded open-loop points at 0.5x / 1x / 2x of
    it emit ``load_{half,sat,over}_goodput_per_sec`` and
    ``_p50_ms/_p99_ms`` (latency from SCHEDULED arrival time), with the
    reference's ``load_*`` keys and ``MINBFT_LOAD_*`` knobs (seed,
    requests a point, clients, probe rate).  The SAT point's sustained
    rate re-anchors ``load_peak_per_sec`` and the half/over multipliers;
    the deep-overload probe (two connection slots) is the shedding
    witness (``load_probe_shed``/``_busy_sent``/``_rx_peak``).

    Pairwise-MAC request auth, as in the reference; the n = 4 replicas
    share one engine on ``device`` (``run_local_load``), so every
    request MAC and HMAC USIG certificate is one K6 lane.  Not reference
    keys: each point's ``_dispatch_timeouts`` and ``_verify_mean_batch``
    (the engine's HMAC queue).  Unlike the reference, which swallows a
    failed point or probe, either fails the section, and so does a fired
    census that differs from the seed's replay."""
    from .loadgen import LoadSpec
    from .loadgen.runner import run_local_load

    dev = str(backend.resolve_device(device))
    seed = int(os.environ.get("MINBFT_LOAD_SEED", "0x10AD"), 0)
    n_req = int(os.environ.get("MINBFT_LOAD_REQUESTS", "1500"))
    n_clients = int(os.environ.get("MINBFT_LOAD_CLIENTS", "1000"))
    pool_slots = 4
    out: dict = {
        "load_seed": seed,
        "load_clients": n_clients,
        "load_requests_per_point": n_req,
    }

    def run(tag: str, spec, slots: int) -> dict:
        rep = asyncio.run(run_local_load(spec, pool_slots=slots, drain_s=60.0,
                                         device=dev))
        if not rep["census_ok"]:
            raise BenchError(f"load_{tag}: fired census {rep['census']} is not the "
                             f"replay of seed {spec.seed:#x}")
        eng = rep["engine"]
        hq = eng["verify"].get("hmac_sha256", {"items": 0, "batches": 0})
        out[f"load_{tag}_dispatch_timeouts"] = sum(
            q["dispatch_timeouts"] for side in ("verify", "sign")
            for q in eng[side].values())
        out[f"load_{tag}_verify_mean_batch"] = round(
            hq["items"] / max(hq["batches"], 1), 2)
        return rep

    # Saturation probe: offer far above any plausible capacity; the
    # wall-clock-honest sustained rate (resolved / span-to-last-resolve)
    # IS the closed-loop peak equivalent.  Two slots, not four: the
    # per-stream in-flight bound is what admission sheds against.
    probe_rate = float(os.environ.get("MINBFT_LOAD_PROBE_RATE", "3000"))
    probe = run("probe", LoadSpec(
        seed=seed, rate=probe_rate, duration_s=max(n_req / probe_rate, 1.0),
        n_clients=n_clients,
    ), 2)
    out["load_burst_peak_per_sec"] = probe["sustained_per_sec"]
    out["load_probe_offered_per_sec"] = probe_rate
    out["load_probe_census_ok"] = probe["census_ok"]
    out["load_probe_goodput_per_sec"] = probe["sustained_per_sec"]
    out["load_probe_shed"] = probe["cluster"]["admission_shed"]
    out["load_probe_busy_sent"] = probe["cluster"]["admission_busy_sent"]
    out["load_probe_busy_received"] = probe["busy_received"]
    out["load_probe_timeouts"] = probe["timeouts"]
    out["load_probe_rx_peak"] = probe["cluster"]["admission_rx_peak"]

    def point(tag: str, i: int, rate: float) -> dict:
        spec = LoadSpec(
            # Distinct deterministic seed per point.
            seed=seed + 1 + i,
            rate=max(rate, 1.0),
            duration_s=max(n_req / max(rate, 1.0), 2.0),
            n_clients=n_clients,
            read_fraction=0.1,
        )
        rep = run(tag, spec, pool_slots)
        p = f"load_{tag}"
        out[f"{p}_offered_per_sec"] = round(spec.rate, 1)
        out[f"{p}_goodput_per_sec"] = rep["sustained_per_sec"]
        out[f"{p}_p50_ms"] = rep["p50_ms"]
        out[f"{p}_p99_ms"] = rep["p99_ms"]
        out[f"{p}_send_p99_ms"] = rep["send_p99_ms"]
        out[f"{p}_finality_p99_ms"] = rep["finality_p99_ms"]
        out[f"{p}_slo_good_fraction"] = rep["slo_good_fraction"]
        out[f"{p}_timeouts"] = rep["timeouts"]
        out[f"{p}_census_ok"] = rep["census_ok"]
        out[f"{p}_busy_received"] = rep["busy_received"]
        out[f"{p}_shed"] = rep["cluster"]["admission_shed"]
        out[f"{p}_busy_sent"] = rep["cluster"]["admission_busy_sent"]
        out[f"{p}_rx_peak"] = rep["cluster"]["admission_rx_peak"]
        return rep

    # The burst probe overestimates steady capacity (buffers absorb a
    # short burst); the SAT point, offered at the burst peak, measures
    # the sustainable rate under the curve's mix.
    sat = point("sat", 1, out["load_burst_peak_per_sec"])
    peak = sat["sustained_per_sec"]
    out["load_peak_per_sec"] = peak
    point("half", 2, 0.5 * peak)
    point("over", 3, 2.0 * peak)
    if peak > 0:
        out["load_over_goodput_fraction"] = round(
            out["load_over_goodput_per_sec"] / peak, 3
        )
    return out


# The soak's shape, the reference's (its ``bench_recovery`` and its slow
# ``test_pinned_seed_recovery_soak``): n = 4, 6 clients x depth 4,
# checkpoint period 4, 2,048-byte chunks, a 0.5 s outage; shared with
# ``chip_smoke.py`` phase 18 and the tests.
RECOVERY_SOAK = dict(replicas=4, clients=6, depth=4, checkpoint_period=4,
                     chunk_bytes=2048, down_s=0.5)
RECOVERY_SEED = 0x2020C0FFEE
# Requests of the soak: the reference's 198 outlive a restart only at its
# host-crypto rate (~5.5 req/s); with every engine on the card the load
# must outlive the restarted process's CUDA context and engine, then its
# catch-up (PERF.md section 4 has the sizing and the runs behind it).
RECOVERY_REQUESTS_HOST = 198
RECOVERY_REQUESTS_CARD = 6_000


def bench_recovery(device=None) -> dict:
    """Crash-recovery soak headline: one
    :func:`~minbft_tpu_torch.testing.recovery_soak.run_recovery_soak`
    round of ``RECOVERY_SOAK`` under the seeded chaos wrap,
    ``MINBFT_BENCH_RECOVERY_SEED`` (default ``RECOVERY_SEED``) and
    ``MINBFT_BENCH_RECOVERY_REQUESTS`` (default ``RECOVERY_REQUESTS_CARD``
    on the card, the reference's 198 otherwise), every replica's and the
    client's engine on ``device`` (None: host crypto, ``--no-batch``).
    The soak raises on any acceptance miss, so a number here means the run
    passed; unlike the reference, which logs a failed soak and goes on,
    the failure fails the section."""
    import tempfile

    from .testing.recovery_soak import run_recovery_soak

    if device is not None:
        device = str(backend.resolve_device(device))
    on_card = device is not None and device.startswith("cuda")
    seed = int(os.environ.get("MINBFT_BENCH_RECOVERY_SEED", hex(RECOVERY_SEED)), 0)
    requests = _env_int("MINBFT_BENCH_RECOVERY_REQUESTS",
                        RECOVERY_REQUESTS_CARD if on_card else RECOVERY_REQUESTS_HOST)
    with tempfile.TemporaryDirectory(prefix="minbft-torch-recovery-") as wd:
        rep = run_recovery_soak(wd, requests=requests, chaos_seed=seed, device=device,
                                **RECOVERY_SOAK)
    return {
        "chaos_recovery_time_ms": rep["chaos_recovery_time_ms"],
        "chaos_recovery_goodput_per_sec": rep["chaos_recovery_goodput_per_sec"],
        "chaos_recovery_restored_count": rep["restored_count"],
        "chaos_recovery_wall_ms": rep["wall_recovery_ms"],
        "chaos_recovery_seed": hex(seed),
        "chaos_recovery_requests": rep["requested"],
        "chaos_recovery_census_ok": bool(rep.get("census")),
        "chaos_recovery_restart_to_listen_ms": rep["restart_to_listen_ms"],
        "chaos_recovery_drain_margin_ms": rep["drain_margin_ms"],
    }


def _device_stamp(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"backend": "cpu", "device": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index or 0]
    return {
        "backend": "cuda",
        "device": torch.cuda.get_device_name(dev),
        "power_limit": out.rsplit(",", 1)[-1].strip(),
        "nvidia_smi": out,
    }


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m minbft_tpu_torch.bench",
        description="The port's benchmark: kernel rates and in-process clusters.",
    )
    parser.add_argument("--device", default=None,
                        help="cuda:N (default cuda:0) or cpu (the plain PyTorch "
                             "versions)")
    parser.add_argument("sections", nargs="*", metavar="SECTION",
                        help=f"run only these of {', '.join(SECTIONS)} (default: all)")
    args = parser.parse_args(argv)
    unknown = set(args.sections) - set(SECTIONS)
    if unknown:
        parser.error(f"unknown sections {sorted(unknown)}; choose from {SECTIONS}")
    dev = backend.resolve_device(args.device)
    on_cpu = dev.type == "cpu"

    batch = _env_int("MINBFT_BENCH_BATCH", BATCH)
    n_requests = _env_int("MINBFT_BENCH_REQUESTS", 10000)
    n_clients = _env_int("MINBFT_BENCH_CLIENTS", 100)

    from .utils.loop import maybe_enable_uvloop

    extras: dict = _device_stamp(dev)
    extras["uvloop"] = maybe_enable_uvloop()
    if on_cpu:
        # The plain versions on the CPU: tiny shapes, so the bench ends.
        batch = min(batch, 32)
        n_requests = min(n_requests, 500)
    if args.sections:
        # Named sections run whole and exactly as named; the reference's
        # MINBFT_BENCH_SKIP_* and ALL_CONFIGS knobs shape only the default
        # run.
        want = set(args.sections)

        def skip(knob):
            return False
    else:
        def skip(knob):
            return bool(os.environ.get(f"MINBFT_BENCH_SKIP_{knob}"))

        all_configs = not on_cpu or bool(os.environ.get("MINBFT_BENCH_ALL_CONFIGS"))
        want = {"kernels"}
        if not skip("E2E"):
            want.add("e2e")
        # The ingest sweep and the read-only section are host-path work,
        # in the default run on every device (shorter on the CPU).
        if not skip("INGEST"):
            want.add("ingest")
        if not skip("RO"):
            want.add("readonly")
        if all_configs and not skip("NODEDUP"):
            want |= {"nodedup", "nodedupref"}
        # The multi-process runs, the groups sweep, the load curve and the
        # recovery soak join the default run on the card only: on the CPU
        # they would run the plain versions for minutes (seconds per K2
        # dispatch); named, they run there too.
        if not on_cpu and not skip("MP"):
            want |= set(MP_SECTIONS)
        if not on_cpu and not skip("GROUPS"):
            want.add("groups")
        if not on_cpu and not skip("LOAD"):
            want.add("load")
        if not on_cpu and not skip("RECOVERY"):
            want.add("recovery")
        if all_configs and not skip("CONFIGS"):
            want |= set(CONFIG_SECTIONS)
    produced: dict = {}

    def section(name, fn):
        if name in want:
            out = fn()
            produced[name] = len(out)
            extras.update(out)

    def cluster(name, *a, **kw):
        # Every configuration gets its traced run (the reference traces
        # e2e and cfg5 only): the stage and critical-path shares are each
        # cell's layer breakdown.
        section(name, lambda: _bench_cluster_repeated(
            *a, device=dev, trace_run=True, **kw))

    def kernels() -> dict:
        out = bench_hmac(min(HMAC_BATCH, batch) if on_cpu else HMAC_BATCH, device=dev)
        out.update(bench_prep())
        out.update(bench_ecdsa(batch, device=dev))
        if not skip("SIGN"):
            out.update(bench_ecdsa_sign(min(batch, SIGN_BATCH), device=dev))
            if batch >= 8192:
                big = bench_ecdsa_sign(batch, device=dev)
                out["ecdsa_sign_big_batch"] = big["ecdsa_sign_batch"]
                out["ecdsa_sign_big_per_sec"] = big["ecdsa_signs_per_sec"]
            out.update(bench_sign_queue(device=dev))
        if not skip("ED25519"):
            out.update(bench_ed25519(batch, device=dev))
            out.update(bench_ed25519_sign(min(batch, ED_SIGN_BATCH), device=dev))
        return out

    section("kernels", kernels)
    # The reference's deployment shape: n = 7, f = 3, one process per
    # replica, the clients in one process of their own, every process with
    # its engine on the card; over gRPC (mp) and the native TCP framing
    # (mptcp, depth MINBFT_BENCH_MPTCP_DEPTH).  The reference caps the
    # run at 400 requests on the CPU.
    mp_requests = _env_int("MINBFT_BENCH_MP_REQUESTS", n_requests)
    if on_cpu:
        mp_requests = min(mp_requests, 400)
    section("mp", lambda: _bench_mp_repeated(7, 3, mp_requests, device=str(dev)))
    section("mptcp", lambda: _bench_mp_repeated(
        7, 3, mp_requests, prefix="mptcp", transport="tcp",
        depth=_env_int("MINBFT_BENCH_MPTCP_DEPTH", 48), device=str(dev)))
    # BASELINE config 3: n = 7, f = 3, ECDSA-P256, 10k requests.
    cluster("e2e", 7, 3, n_requests, n_clients=n_clients, usig_kind="ecdsa",
            warm_run=True)
    # The bundle-ingest operating points: n = 4, HMAC USIGs, bucket 128.
    section("ingest", lambda: bench_ingest_sweep(
        _env_int("MINBFT_BENCH_INGEST_REQUESTS", 400 if on_cpu else 600), device=dev))
    ro_reads = _env_int("MINBFT_BENCH_RO_READS", 4000)
    if on_cpu and ro_reads > 400:
        print("bench: the CPU clamps ro_reads to 400", file=sys.stderr, flush=True)
        ro_reads = 400
    section("readonly", lambda: asyncio.run(_bench_readonly(n_reads=ro_reads)))
    # The multi-group sweep (n = 4, HMAC USIGs, bucket 128, G in 1..16 at a
    # fixed per-group load) and the open-loop load curve (n = 4, MACs).
    section("groups", lambda: bench_groups(
        _env_int("MINBFT_BENCH_GROUPS_REQUESTS", 8 if on_cpu else 400), device=dev))
    section("load", lambda: bench_load(device=dev))
    # The crash-recovery soak: n = 4 processes, one kill -9 mid-load.
    section("recovery", lambda: bench_recovery(device=dev))
    cluster("nodedup", 7, 3, _env_int("MINBFT_BENCH_NODEDUP_REQUESTS", 2000),
            n_clients=min(n_clients, 50), usig_kind="ecdsa", prefix="nodedup",
            no_dedup=True, runs=1)
    cluster("nodedupref", 7, 3, _env_int("MINBFT_BENCH_NODEDUPREF_REQUESTS", 1000),
            n_clients=min(n_clients, 50), usig_kind="ecdsa", prefix="nodedupref",
            no_dedup=True, batchsize_prepare=1, runs=1)
    # BASELINE configs 1, 2, 4 and 5, the pairwise-MAC configuration and
    # the isolated-engines topology, at the reference's lengths.
    cluster("cfg1", 4, 1, _env_int("MINBFT_BENCH_CFG1_REQUESTS", 4000),
            n_clients=min(n_clients, 50), usig_kind="hmac", prefix="cfg1")
    cluster("cfg2", 4, 1, _env_int("MINBFT_BENCH_CFG2_REQUESTS", 4000),
            n_clients=min(n_clients, 50), usig_kind="ecdsa", prefix="cfg2")
    cluster("cfg4", 13, 6, _env_int("MINBFT_BENCH_CFG4_REQUESTS", 3000),
            n_clients=min(n_clients, 50), usig_kind="hmac",
            max_batch=CFG4_BUCKET, prefix="cfg4")
    cluster("mac", 7, 3, _env_int("MINBFT_BENCH_MAC_REQUESTS", 8000),
            n_clients=n_clients, usig_kind="hmac", scheme="mac", prefix="mac")
    cluster("cfg5", 31, 15, _env_int("MINBFT_BENCH_CFG5_REQUESTS", 1000),
            n_clients=min(n_clients, 50), usig_kind="hmac", scheme="ed25519",
            max_batch=_env_int("MINBFT_BENCH_CFG5_BATCH", 1024), prefix="cfg5")
    cluster("iso", 7, 3, _env_int("MINBFT_BENCH_ISO_REQUESTS", 4000),
            n_clients=min(n_clients, 50), usig_kind="ecdsa", prefix="iso",
            isolated_engines=True)
    empty = sorted(name for name in want if not produced.get(name))
    if empty:
        raise BenchError(f"sections {empty} produced no keys")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "extras.json"), "w") as fh:
        json.dump(extras, fh, indent=1, sort_keys=True)
    keep = (
        "committed_req_per_sec", "req_per_sec_stddev", "req_per_sec_at_p50",
        "slo_achieved_p50_ms", "verifies_per_sec", "signs_per_sec",
        "sign_big_per_sec", "sign_share", "sign_queue_fallback",
        "request_latency_p50_ms", "request_latency_p99_ms", "_stage_",
        "_critpath_", "mean_batch", "logical_verifies", "memo_hits",
        "prep_share", "prep_speedup", "prep_items_per_sec", "backend", "device",
        "power_limit", "_util_", "queue_depth_peak", "dispatch_timeouts",
        "cpu_per_wall", "cuda_contexts", "cuda_reserved_mib", "context_mib",
        "gpu_memory_mib", "_launches", "reads_per_sec", "ingest_batch_mean",
        "verify_mean_batch", "goodput_per_sec", "peak_per_sec", "chaos_recovery_",
    )
    compact = {k: extras[k] for k in sorted(extras) if any(p in k for p in keep)}
    print(json.dumps({"bench_extras": compact}))
    value = extras.get("ecdsa_verifies_per_sec")
    print(json.dumps({
        "metric": "batched ECDSA-P256 verifies/sec/chip",
        "value": None if value is None else round(value, 1),
        "unit": "verifies/sec",
        "backend": extras["backend"],
        "device": extras["device"],
        "power_limit": extras["power_limit"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
