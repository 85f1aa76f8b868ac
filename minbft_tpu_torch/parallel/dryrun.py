"""Multi-device dry run of the port: the batch split and the engine pool
over a device list, with the protocol in the loop.

Counterpart of the reference's ``__graft_entry__.dryrun_multichip``.
:func:`dryrun_multichip` takes the device list itself (CPU devices, CUDA
devices, or one card named twice to rehearse two) and raises
``AssertionError`` at the first check that fails:

1. K2 and K6 split over the mesh (:mod:`.mesh`) give the expected verdict
   on every lane, a tampered lane rejected;
2. a ``BatchVerifier(mesh=)`` whose bucket is no multiple of the mesh
   size pads it up and still resolves every lane's future with its
   verdict;
3. an n = 4 in-process grouped cluster (pairwise MACs, HMAC USIGs,
   G = max(2, min(C, 4)) groups) whose replicas each hold an
   :class:`~minbft_tpu_torch.parallel.EnginePool` over the devices
   commits every request, with equal per-group ledgers on every replica;
   the placement spreads the groups over min(G, C) chips and every home
   chip's engine checked MACs and UIs;
4. an oversized explicit batch through a group's facade goes through the
   pool's striped (mesh) engine.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac as hmac_mod
import time
from typing import Optional, Sequence

import torch


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _hmac_items(tag: bytes, count: int, forged: int):
    """``count`` distinct (key, msg32, mac32) items, lane ``forged`` with
    a flipped MAC bit; returns (items, expected verdicts)."""
    items, want = [], []
    for i in range(count):
        key = hashlib.sha256(b"%s-key-%d" % (tag, i)).digest()
        msg = hashlib.sha256(b"%s-msg-%d" % (tag, i)).digest()
        mac = hmac_mod.new(key, msg, hashlib.sha256).digest()
        if i == forged:
            mac = bytes([mac[0] ^ 1]) + mac[1:]
        items.append((key, msg, mac))
        want.append(i != forged)
    return items, want


def _ecdsa_items(tag: bytes, count: int, d: int, q):
    from ..utils import hostcrypto as hc

    out = []
    for i in range(count):
        digest = hashlib.sha256(b"%s-%d" % (tag, i)).digest()
        out.append((q, digest, hc.ecdsa_sign(d, digest)))
    return out


def dryrun_multichip(
    devices: Sequence,
    batch: Optional[int] = None,
    requests_per_group: int = 1,
    n_clients: int = 1,
    timeout_s: float = 600.0,
) -> dict:
    """Run the dry run over ``devices`` (C = their count, repeats
    allowed); ``batch`` is the engines' one bucket (default 2·C, two
    lanes a device), ``requests_per_group`` the cluster's requests to
    each group, spread over ``n_clients`` clients.  Returns the pools of
    the four replicas (``pools``) and what was checked."""
    import numpy as np

    from ..groups import GroupRuntime, MultiGroupClient
    from ..ops import hmac_sha256, p256
    from ..sample.authentication import new_test_mac_authenticators
    from ..sample.config import SimpleConfiger
    from ..sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from ..sample.requestconsumer import SimpleLedger
    from ..utils import hostcrypto as hc
    from . import mesh as mesh_mod
    from .engine import BatchVerifier
    from .pool import EnginePool

    t0 = time.perf_counter()
    mesh = mesh_mod.make_mesh(devices)
    n_dev = mesh.size
    batch = mesh_mod.round_up_to_mesh(mesh, batch or 2 * n_dev)
    report: dict = {"devices": [str(d) for d in mesh.devices], "batch": batch}

    # 1. K2 and K6 split over the mesh.
    d, q = hc.keygen()
    items = _ecdsa_items(b"dryrun", batch, d, q)
    r, s = items[batch // 2][2]
    items[batch // 2] = (q, items[batch // 2][1], (r, s ^ 2))
    rows = torch.from_numpy(p256.prepare_packed(items, batch))
    got = mesh_mod.sharded_ecdsa_kernel(mesh)(rows).numpy()
    want = np.ones(batch, dtype=bool)
    want[batch // 2] = False
    _check((got == want).all(), f"sharded K2 verdicts {np.nonzero(got != want)[0].tolist()} wrong")
    h_items, h_want = _hmac_items(b"dryrun", batch, batch - 1)
    h_rows = torch.from_numpy(np.frombuffer(
        b"".join(k + m + t for k, m, t in h_items), dtype=">u4"
    ).astype(np.uint32).view(np.int32).reshape(batch, hmac_sha256.PACKED_COLS))
    got = mesh_mod.sharded_hmac_kernel(mesh)(h_rows).numpy().tolist()
    _check(got == h_want, "sharded K6 verdicts wrong")

    # 2. A bucket that is no multiple of the mesh size pads up to one.
    uneven = batch + 1
    eng = BatchVerifier(max_batch=uneven, buckets=(uneven,), mesh=mesh)
    if n_dev > 1:
        _check(all(b % n_dev == 0 for b in eng.buckets),
               f"bucket rounding failed: {eng.buckets}")
    u_items, u_want = _hmac_items(b"uneven", uneven, 3)

    async def _uneven():
        return await asyncio.gather(*[eng.verify_hmac_sha256(*it) for it in u_items])

    _check(list(asyncio.run(_uneven())) == u_want, "uneven-bucket verdicts wrong")
    st = eng.stats["hmac_sha256"]
    _check(eng.mesh.size == n_dev and st.batches > 0,
           "the mesh engine did not split its batches")
    if n_dev > 1:
        _check(st.padded_lanes > 0, "the uneven bucket was never padded")

    # 3. The protocol in the loop: every replica's checks go through its
    # pool, each group's through its home chip.  The stripe threshold is
    # half the bucket, so one explicit batch past it is one striped
    # dispatch.
    n_rep, f_rep = 4, 1
    n_groups = max(2, min(n_dev, 4))
    pools = [
        EnginePool(chips=n_dev, devices=list(mesh.devices), max_batch=batch,
                   buckets=(batch,), stripe_threshold=max(batch // 2, 1))
        for _ in range(n_rep)
    ]
    per_group = [
        new_test_mac_authenticators(n_rep, n_clients=n_clients, usig_kind="hmac")
        for _ in range(n_groups)
    ]
    configer = SimpleConfiger(n=n_rep, f=f_rep, timeout_request=900.0,
                              timeout_prepare=450.0, groups=n_groups)
    stubs = make_testnet_stubs(n_rep)
    ledgers = []
    runtimes = []
    for i in range(n_rep):
        led = [SimpleLedger() for _ in range(n_groups)]
        rt = GroupRuntime(
            i, configer, [per_group[g][0][i] for g in range(n_groups)],
            InProcessPeerConnector(stubs), led, engine_pool=pools[i],
        )
        stubs[i].assign_replica(rt)
        runtimes.append(rt)
        ledgers.append(led)
    ops = [(g, b"pool-dryrun-%d-%d" % (g, k))
           for k in range(requests_per_group) for g in range(n_groups)]

    async def _protocol():
        for rt in runtimes:
            await rt.start()
        clients = [
            MultiGroupClient(c, n_rep, f_rep, n_groups,
                             [per_group[g][1][c] for g in range(n_groups)],
                             InProcessClientConnector(stubs), retransmit_interval=30.0)
            for c in range(n_clients)
        ]
        for c in clients:
            await c.start()
        try:
            results = await asyncio.wait_for(asyncio.gather(*[
                clients[k % n_clients].request(op, group=g)
                for k, (g, op) in enumerate(ops)]), timeout_s)
            _check(all(results), "a request returned no result")
            # f + 1 replies prove f + 1 executions: wait for all four.
            deadline = time.monotonic() + timeout_s
            while any(led[g].length < requests_per_group
                      for led in ledgers for g in range(n_groups)):
                _check(time.monotonic() < deadline, "replicas did not all execute")
                await asyncio.sleep(0.05)
        finally:
            for c in clients:
                await c.stop()
            for rt in runtimes:
                await rt.stop()

    t_cluster = time.perf_counter()
    asyncio.run(_protocol())
    report["cluster_s"] = time.perf_counter() - t_cluster
    for g in range(n_groups):
        lens = [led[g].length for led in ledgers]
        _check(lens == [requests_per_group] * n_rep, f"group {g} ledger lengths {lens}")
        digests = {led[g].state_digest() for led in ledgers}
        _check(len(digests) == 1, f"group {g} ledgers differ across replicas")
    pool = pools[0]
    placed = pool.placement()
    want_homes = min(n_groups, n_dev)
    _check(len(placed) == n_groups and len(set(placed.values())) >= want_homes,
           f"pool placement degenerate: {placed}")
    for p in pools:
        for c in set(p.placement().values()):
            st = p.engines[c].stats.get("hmac_sha256")
            _check(st is not None and st.batches > 0,
                   f"home chip {c} served no MAC or UI check")

    # 4. An oversized explicit batch through a group's facade stripes.
    facade = pool.engine_for(0)
    over_n = pool.stripe_threshold + 1 if pool.stripe_threshold is not None else batch
    s_items = _ecdsa_items(b"stripe", over_n, d, q)
    k2_before = p256.ecdsa_verify_kernel_packed.launches
    _check(all(asyncio.run(facade.verify_ecdsa_p256_many(s_items))),
           "striped verify rejected valid signatures")
    if pool.striped_engine is not None:
        striped = pool.striped_engine
        st = striped.stats["ecdsa_p256"]
        _check(striped.mesh.size == n_dev and st.items == over_n,
               "the oversized batch did not go through the striped engine")
        if mesh.devices[0].type == "cuda":
            # One counted K2 launch per chunk (the CPU runs the plain
            # version, which counts none).
            k2 = p256.ecdsa_verify_kernel_packed.launches - k2_before
            _check(k2 == st.batches * n_dev,
                   f"{k2} K2 launches for {st.batches} striped batches over {n_dev}")
    report.update(
        pools=pools,
        groups=n_groups,
        requests=len(ops),
        placement=placed,
        ledgers=[[(led[g].length, led[g].state_digest().hex()) for g in range(n_groups)]
                 for led in ledgers],
        stripe_items=over_n,
        seconds=time.perf_counter() - t0,
    )
    return report
