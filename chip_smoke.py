#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minbft_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the port's CUDA kernels from ``minbft_tpu_torch/csrc`` (into
``build/torch_ext/``), then runs, in order, failing at the first check
that does not hold:

1. the card's name and power limit (``nvidia-smi``), the build time and
   ``torch.version.cuda``;
2. K1 (field library, ``field_op`` test kernel) against the plain
   PyTorch field ops, every op, mod p and mod n, 4,096 random and edge
   elements, exact;
3. K2 (batched ECDSA-P256 verify) at B = 512 and 16,384, each batch of
   distinct rows signed afresh on the card, against the plain version on
   every lane and against ``hostcrypto.ecdsa_verify_py`` on every honest
   or plainly forged lane (B = 512) or on a sample of them (B = 16,384),
   adversarial lanes included;
4. K3 (fixed-base k·G) at B = 512 against the plain version, and
   ``sign_batch`` signatures against ``hostcrypto.ecdsa_sign_py``;
5. the authentication flow — the first slice's path — at n = 4, f = 1,
   4 clients, 512 requests: client REQUEST signing (K3), REQUEST, PREPARE
   and COMMIT verification (K2), REPLY signing (K3) and client REPLY
   verification (K2), one engine per replica and per client, one forged
   lane in 64 per phase; launch counters are zeroed just before it and
   read just after;
6. K5 (SHA-256 compression, ``sha256_compress`` test kernel) against the
   plain compression on 4,096 random (state, block) pairs, and K6
   (HMAC-SHA256 verify) at B = 512 and 16,384 distinct rows against the
   plain version and Python's ``hmac`` on every lane, with forged lanes
   (one flipped bit in the mac, the key or the message) and all-zero
   padding rows;
7. cluster A, the main path: an in-process MinBFT cluster (replica core,
   client, in-process transport) at n = 7, f = 3 with ECDSA-P256 client
   and replica signatures and ECDSA USIGs, one engine shared by the
   replicas and the clients, 100 clients pipelining 24 requests each,
   10,000 requests;
8. cluster B: the same layout at n = 4, f = 1 with HMAC-SHA256 USIGs
   (their certificates checked by K6), 50 clients, 4,000 requests, plus
   8 REQUESTs with a flipped signature bit injected over a client stream;
   in both cluster phases every request must return, every replica's
   ledger must hold exactly the honest requests with equal state digests,
   every queue must be free of dispatch timeouts, no ERROR record may come
   from the core or the client, and the launch counters, zeroed just
   before the timed drive and read just after, must show the path's
   kernels;
9. one JSON line of per-kernel numbers (launches, parity, times, bounds).

Kernel times are CUDA-event medians: ``ms`` brackets one wrapper call
(host launch overhead included), ``device_ms`` replays the kernel
captured in a CUDA graph (the kernel alone).

The last line of standard output is the device JSON.  Without CUDA, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import statistics
import subprocess
import sys
import time

# Published H100 SXM memory rate (NVIDIA data sheet), for the byte bound.
HBM_BYTES_PER_S = 3.35e12
# A 32x32->64 multiply-add counted as two 32-bit IMAD issues (low and
# high halves); a Montgomery multiply is 64 such products for a*b, 64 for
# u*m and one 32-bit multiply for u.
IMADS_PER_MONT_MUL = 2 * 128 + 1
# Instructions of one SHA-256 compression (csrc/sha256.cuh) on sm_90,
# counted as the least the function needs: per round 6 SHF (the rotates
# of Sigma0 and Sigma1), 4 LOP3 (each Sigma's 3-way XOR, Ch, Maj) and 4
# IADD3 (T1 = h + K + W + Sigma1 + Ch in two, e = d + T1, a = T1 +
# Sigma0 + Maj); per schedule word 6 SHF, 2 LOP3 and 2 IADD3; 8 final
# adds.  SHF and LOP3 issue only on the ALU pipe; an add may issue there
# or as an IMAD on the FMA pipe.
SHA256_ALU_OPS = 64 * (6 + 4) + 48 * (6 + 2)
SHA256_ADD_OPS = 64 * 4 + 48 * 2 + 8
# One K6 lane: four compressions, 16 LOP3 for the key pads, 8 LOP3 and
# one ISETP for the compare with the mac.
HMAC_ALU_OPS = 4 * SHA256_ALU_OPS + 16 + 8 + 1
HMAC_ADD_OPS = 4 * SHA256_ADD_OPS
# Requests of cluster phase A (the main path, n = 7).
CLUSTER_A_REQUESTS = 10_000
# How long each cluster request may take before its phase fails.
REQUEST_TIMEOUT_S = 120.0


def int_mix(alu_ops: float, add_ops: float) -> float:
    """Issue slots, at 64 lanes per SM per clock, of a 32-bit integer mix
    of ALU-only instructions (SHF, LOP3: the ALU pipe, 64 lanes per SM
    per clock on sm_90) and adds (the ALU pipe or IMAD on the FMA pipe):
    the ALU pipe's share, or the whole mix at the SM's dispatch rate of
    128 lanes per clock, whichever is longer."""
    return max(alu_ops, (alu_ops + add_ops) / 2)


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
# Phases 7-8: an in-process cluster committing requests (also driven on
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
# Phases 2-4: kernels against their plain versions.


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

    from minbft_tpu_torch.ops import backend, hmac_sha256, limbs, p256, sha256
    from minbft_tpu_torch.parallel import BatchVerifier
    from minbft_tpu_torch.sample.authentication import authenticators_from_keys
    from minbft_tpu_torch.sample.authentication.authenticator import (
        _pub_rows,
        make_test_keys,
    )
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
    for src, log in backend.EXTENSION.ptxas_log.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    def bound(ops: float, nbytes: float):
        """Least time for ``ops`` issues at 64 lanes per SM per clock
        and ``nbytes`` at the memory rate: (ms, which bounds it)."""
        t_ops = ops / imad_per_s * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    kernels = {}

    # -- phase 2: K1 -----------------------------------------------------------
    nk1 = 4096
    k1_err = 0
    for field, mod in (("p", p256.P), ("n", p256.N)):
        spec = p256.FIELD if field == "p" else p256.ORDER
        edges = [0, 1, 2, mod - 1, mod - 2, (1 << 256) - 1 - mod, mod >> 1, 1 << 255]
        va = edges + [rng.randbelow(mod) for _ in range(nk1 - len(edges))]
        vb = edges[::-1] + [rng.randbelow(mod) for _ in range(nk1 - len(edges))]
        a = torch.from_numpy(limbs.to_limbs_batch(va).astype(np.uint16)).to(dev)
        b = torch.from_numpy(limbs.to_limbs_batch(vb).astype(np.uint16)).to(dev)
        for op in limbs.FIELD_OPS:
            got = limbs.field_op(op, a, b, field).to(torch.int64)
            want = limbs.field_op_plain(op, spec, a.to(torch.int64), b.to(torch.int64))
            err = int((got - want).abs().max())
            k1_err = max(k1_err, err)
            check(err == 0, f"K1 {op} mod {field}: kernel != plain (max |err| {err})")
        print(f"K1 mod {field}: {len(limbs.FIELD_OPS)} ops x {nk1} elements exact")
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    k1_ms = cuda_ms(torch, lambda: limbs.field_op("mul", a, b, "n"))
    k1_dev_ms = graph_ms(torch, lambda: limbs.field_op("mul", a, b, "n"))
    k1_plain_ms = cuda_ms(torch, lambda: limbs.mont_mul(p256.ORDER, a64, b64), reps=5)
    k1_bound, k1_by = bound(nk1 * IMADS_PER_MONT_MUL, nk1 * 3 * 32)
    kernels["K1"] = dict(ms=k1_ms, device_ms=k1_dev_ms, plain_ms=k1_plain_ms,
                         bound_ms=k1_bound, bound_by=k1_by, max_abs_err=k1_err)
    print(f"K1 mont_mul B={nk1}: {k1_ms:.4f} ms per call, {k1_dev_ms:.4f} ms on the "
          f"device (plain {k1_plain_ms:.3f} ms, bound {k1_bound:.5f} ms by {k1_by})")

    # -- phase 3: K2 -----------------------------------------------------------
    keys = [hc.keygen(rng) for _ in range(8)]
    k2 = {}
    for bsz in (512, 16384):
        # Distinct rows at each size: fresh digests, signed on the card.
        items = verify_items(hc, rng, keys, bsz)
        crafted = set(range(12, bsz, 64))
        rows = craft_r2_rows(p256.prepare_packed(items, bsz), sorted(crafted))
        live = rows[rows[:, p256.PACKED_COLS - 1] != 0]  # invalid lanes are zeros
        check(len({r.tobytes() for r in live}) == len(live), f"K2 B={bsz}: rows repeat")
        rows_d = torch.from_numpy(rows).to(dev)
        got = p256.ecdsa_verify_kernel_packed(rows_d)
        torch.cuda.synchronize()
        want = p256.verify_packed_plain(rows_d)
        mism = int((got != want).sum())
        check(mism == 0, f"K2 B={bsz}: {mism} lanes differ from the plain version")
        got_np = got.cpu().numpy()
        # The host oracle is pure Python: every lane at 512, a spread
        # sample (a prime stride, so it meets every lane residue) at 16,384.
        # Lanes 0-2 (Q = G, -G, 2G) are left to the plain version: their
        # ladders can meet the incomplete add's exceptional case, which
        # the reference (and so the port) rejects even for an honest
        # signature.
        oracle = range(bsz) if bsz == 512 else range(5, bsz, 37)
        oracle = [i for i in oracle if i > 2 and i not in crafted]
        host = {i: hc.ecdsa_verify_py(*items[i]) for i in oracle}
        check(sum(host.values()) > len(host) // 2, f"K2 B={bsz}: too few honest lanes")
        for i, ok in host.items():
            if bool(got_np[i]) != ok:
                fail(f"K2 B={bsz} lane {i}: kernel {bool(got_np[i])} != host {ok}")
        ms = cuda_ms(torch, lambda: p256.ecdsa_verify_kernel_packed(rows_d))
        dev_ms = graph_ms(torch, lambda: p256.ecdsa_verify_kernel_packed(rows_d), copies=5)
        k2[bsz] = (ms, dev_ms)
        print(f"K2 B={bsz}: verdicts equal plain on every lane and host on "
              f"{len(host)} honest/forged lanes ({int(got_np.sum())} accepted); "
              f"{ms:.3f} ms per batch ({dev_ms:.3f} on the device), "
              f"{bsz / ms * 1e3:,.0f} verifies/s")
        if bsz == 512:
            plain_ms = cuda_ms(
                torch, lambda: p256.verify_packed_plain(rows_d), reps=1, warm=1
            )
    # Field multiplies per lane, from the kernel: 2 to_mont of Q, the G+Q
    # madd (11), the Fermat inversion (256 squarings + popcount(p-2)
    # multiplies), 4 to make G+Q affine, 256 ladder steps of dbl (8) +
    # madd (11), and 5 for the final check.
    inv_mults = 256 + bin(p256.P - 2).count("1")
    k2_mults = 2 + 11 + inv_mults + 4 + 256 * 19 + 5
    k2_bound, k2_by = bound(512 * k2_mults * IMADS_PER_MONT_MUL, 512 * (98 * 2 + 1))
    kernels["K2"] = dict(ms=k2[512][0], device_ms=k2[512][1], plain_ms=plain_ms,
                         bound_ms=k2_bound, bound_by=k2_by, max_abs_err=0,
                         ms_16384=k2[16384][0], device_ms_16384=k2[16384][1],
                         field_mults_per_lane=k2_mults)
    print(f"K2 bound B=512: {k2_bound:.4f} ms by {k2_by} "
          f"({k2_mults} field multiplies per lane); plain {plain_ms:.1f} ms")

    # -- phase 4: K3 -----------------------------------------------------------
    nonces = [rng.randbelow(p256.N - 1) + 1 for _ in range(512)]
    k_d = torch.from_numpy(limbs.to_limbs_batch(nonces).astype(np.uint16)).to(dev)
    got = p256.ecdsa_kg_kernel(k_d).to(torch.int64)
    want = p256.kg_plain(k_d, p256.comb_table("cpu").to(dev))
    err = int((got - want).abs().max())
    check(err == 0, f"K3: kernel != plain (max |err| {err})")
    sign_items = [(keys[i % len(keys)][0], rng.bytes(32)) for i in range(512)]
    sigs = p256.sign_batch(sign_items, bucket=512)
    for i in range(0, 512, 16):
        d, dg = sign_items[i]
        check(sigs[i] == hc.ecdsa_sign_py(d, dg), f"K3: signature {i} != host")
    k3_ms = cuda_ms(torch, lambda: p256.ecdsa_kg_kernel(k_d))
    k3_dev_ms = graph_ms(torch, lambda: p256.ecdsa_kg_kernel(k_d))
    table_d = p256.comb_table("cpu").to(dev)
    k3_plain_ms = cuda_ms(torch, lambda: p256.kg_plain(k_d, table_d), reps=2, warm=1)
    k3_bound, k3_by = bound(512 * 64 * 11 * IMADS_PER_MONT_MUL, 512 * (32 + 64) + 65536)
    kernels["K3"] = dict(ms=k3_ms, device_ms=k3_dev_ms, plain_ms=k3_plain_ms,
                         bound_ms=k3_bound, bound_by=k3_by, max_abs_err=err)
    print(f"K3 B=512: (X, Z) equal plain; 32 signatures byte-identical to host; "
          f"{k3_ms:.3f} ms per batch ({k3_dev_ms:.3f} on the device; plain "
          f"{k3_plain_ms:.1f} ms, bound {k3_bound:.4f} ms by {k3_by})")

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
          f"{k5_plain_ms:.3f} ms, bound {k5_bound:.5f} ms by {k5_by})")

    k6 = {}
    for bsz in (512, 16384):
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
    kernels["K6"] = dict(ms=k6[512][0], device_ms=k6[512][1], plain_ms=k6_plain_ms,
                         bound_ms=k6[512][2], bound_by=k6[512][3], max_abs_err=0,
                         ms_16384=k6[16384][0], device_ms_16384=k6[16384][1])
    print(f"K6 plain B=512: {k6_plain_ms:.1f} ms")

    # -- phases 7 and 8: the in-process cluster -----------------------------------
    cluster_phases = (
        # (label, n, f, usig kind, clients, depth, requests, forged)
        ("cluster_ecdsa", 7, 3, "ecdsa", 100, 24, CLUSTER_A_REQUESTS, 0),
        ("cluster_hmac", 4, 1, "hmac", 50, 24, 4000, 8),
    )
    for label, cn, cf, kind, ncl, depth, nreq, nforged in cluster_phases:
        ckeys = make_test_keys(cn, ncl + (1 if nforged else 0), kind, rng=rng)
        shared = BatchVerifier(max_batch=512, buckets=(512,))
        res = asyncio.run(run_cluster(
            ckeys, cf, shared, ncl, depth, nreq, (reset_counts, read_counts),
            forged=nforged,
        ))
        check_cluster(res, label)
        win = res["window"]
        need = ("K2", "K3", "K6") if kind == "hmac" else ("K2", "K3")
        check(all(win[k] > 0 for k in need),
              f"{label}: a kernel of the path was not launched {win}")
        path_launches[label] = win
        for line in check_engine(shared, label):
            print(line)
        # Kernel-busy share, estimated: each launch at its kernel's device
        # time from phases 3, 4 and 6 (all at the 512 bucket the engine
        # uses), over the drive's wall time.
        busy_s = sum(
            win[kid] * kernels[kid]["device_ms"] for kid in ("K2", "K3", "K6")
        ) / 1e3
        print(f"{label}: n={cn} f={cf} usig={kind} clients={ncl} depth={depth} "
              f"requests={res['requests']}: {res['wall_s']:.2f} s wall "
              f"(kernel-busy estimate {busy_s:.3f} s, "
              f"{busy_s / res['wall_s']:.1%}; host CPU {res['host_cpu_s']:.2f} s), "
              f"{res['committed_per_s']:,.1f} committed requests/s, latency p50 "
              f"{res['latency_p50_ms']:.1f} ms p99 {res['latency_p99_ms']:.1f} ms, "
              f"forged {nforged} (replies {res['replies_to_forged']}, dropped "
              f"{res['dropped']}), launches {win}")

    # -- phase 9 -----------------------------------------------------------------
    meta = {
        "K1": ("field_op (csrc/field.cuh library)", "minbft_tpu_torch/csrc/field.cuh",
               "minbft_tpu/ops/limbs.py:335"),
        "K2": ("ecdsa_verify_kernel_packed", "minbft_tpu_torch/csrc/p256_verify.cu",
               "minbft_tpu/ops/p256.py:504"),
        "K3": ("ecdsa_kg_kernel", "minbft_tpu_torch/csrc/p256_kg.cu",
               "minbft_tpu/ops/p256.py:644"),
        "K5": ("sha256_compress (csrc/sha256.cuh device function)",
               "minbft_tpu_torch/csrc/sha256.cuh", "minbft_tpu/ops/sha256.py:65"),
        "K6": ("hmac_verify_kernel_packed", "minbft_tpu_torch/csrc/hmac_sha256.cu",
               "minbft_tpu/ops/hmac_sha256.py:68"),
    }
    line = []
    for kid, (name, src, replaces) in meta.items():
        k = kernels[kid]
        entry = {
            "name": f"{kid} {name}", "route": "cuda", "source": src,
            "replaces": replaces,
            # Each count is the wrapper's own, read around each path
            # (the flow and the two cluster phases) and summed;
            # launches_by_path holds the reads.  K1 and K5 are __device__
            # functions inlined into K2/K3 and K6, so their arithmetic runs
            # inside those launches and their test kernels (phases 2 and 6
            # only) count 0 there.
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
        if kid == "K1":
            entry["inlined_into"] = ["K2", "K3"]
        if kid == "K5":
            entry["inlined_into"] = ["K6"]
        if kid in ("K2", "K6"):
            entry["ms_b16384"] = k["ms_16384"]
            entry["device_ms_b16384"] = k["device_ms_16384"]
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
