"""The port's batching engine (minbft_tpu_torch/parallel/engine.py) on the
CPU, where its dispatchers run the plain versions of K2 and K3.

Mirrors the ECDSA-relevant cases of tests/test_engine.py and
tests/test_sign_queue.py: per-lane verdicts of mixed batches, the dedup
memo, bucket padding and the stats invariants, the memo-free sign queue,
the dispatch timeout, and the device rule (no device argument means CUDA,
which raises here rather than falling back to the CPU; nothing moves a
batch to the host).  Inputs are made
from a numpy seed."""

import asyncio
import hashlib
import threading

import numpy as np
import pytest
import torch

from minbft_tpu_torch.ops import backend
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.parallel.engine import _StagingPool
from minbft_tpu_torch.utils import hostcrypto as hc

_BUCKET = 8


class _SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def randbelow(self, n):
        return int.from_bytes(self._g.bytes(40), "little") % n


def _cpu_engine(**kw):
    return BatchVerifier(max_batch=_BUCKET, buckets=(_BUCKET,), device="cpu", **kw)


@pytest.fixture(scope="module")
def verify_run():
    """One engine, one dispatch: 4 valid and 2 forged items submitted
    concurrently (single submits and one many-call), then a second loop
    re-submitting a valid, a forged and a fresh duplicate pair."""
    rng = _SeededRng(1)
    keys = [hc.keygen(rng) for _ in range(2)]
    items = []
    for i in range(4):
        d, q = keys[i % 2]
        dg = hashlib.sha256(b"engine-%d" % i).digest()
        items.append((q, dg, hc.ecdsa_sign_py(d, dg)))
    q, dg, (r, s) = items[0]
    items.append((q, dg, (r, s ^ 1)))  # forged s
    items.append((keys[1][1], dg, (r, s)))  # wrong key
    expected = [True] * 4 + [False] * 2
    eng = _cpu_engine()
    eng.enable_obs_ring()

    async def first():
        singles = [eng.verify_ecdsa_p256(*it) for it in items[:3]]
        many = eng.verify_ecdsa_p256_many(items[3:])
        out = await asyncio.gather(*singles, many)
        return list(out[:3]) + list(out[3])

    verdicts = asyncio.run(first())
    snapshot = dict(vars(eng.stats["ecdsa_p256"]))

    async def second():
        return await asyncio.gather(
            eng.verify_ecdsa_p256(*items[1]), eng.verify_ecdsa_p256(*items[4])
        )

    again = asyncio.run(second())
    return eng, items, expected, verdicts, snapshot, again


def test_mixed_batch_resolves_per_lane(verify_run):
    _eng, _items, expected, verdicts, _snap, _again = verify_run
    assert verdicts == expected


def test_bucket_padding_and_stats_invariants(verify_run):
    _eng, items, _exp, _v, snap, _again = verify_run
    assert snap["items"] == len(items) and snap["batches"] == 1
    assert snap["max_batch_seen"] == len(items)
    assert snap["padded_lanes"] == _BUCKET - len(items)
    assert sum(snap["flush_reasons"].values()) == snap["batches"]
    assert sum(snap["occupancy"].values()) == snap["batches"]
    assert snap["queue_wait"].count == snap["queue_service"].count == len(items)
    assert 0.0 < snap["host_prep_time_s"] <= snap["device_time_s"]
    assert snap["dispatch_timeouts"] == 0


def test_dedup_memo_answers_repeats_without_a_dispatch(verify_run):
    eng, _items, _exp, _v, snap, again = verify_run
    assert again == [True, False]  # positive and negative memo
    st = eng.stats["ecdsa_p256"]
    assert st.batches == snap["batches"]
    assert st.memo_hits == snap["memo_hits"] + 2


def test_dispatch_span_events_recorded(verify_run):
    eng = verify_run[0]
    events = eng.drain_obs_events()
    assert [(name, pad) for name, pad, _p, _t in events] == [
        ("ecdsa_p256", _BUCKET - len(verify_run[1]))
    ]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        BatchVerifier()
    with pytest.raises(RuntimeError):
        BatchVerifier(device="cuda:0")
    assert BatchVerifier(device="cpu").device == torch.device("cpu")


def test_cuda_engine_refuses_host_signing(monkeypatch):
    """A CUDA engine always signs with K3: asking it for the host signer
    is an error, raised before anything is built."""
    monkeypatch.setattr(backend, "resolve_device", lambda d: torch.device("cuda:0"))
    with pytest.raises(ValueError, match="sign_on_device"):
        BatchVerifier(sign_on_device=False)


def test_mesh_is_not_ported_yet():
    """The name is kept from before the mesh was ported.  ``mesh=`` now
    splits batches (tests/test_torch_mesh.py); with ``device=`` and a mesh
    of more than one device it raises ValueError, and a 1-device mesh is
    the plain engine on its device."""
    from minbft_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="not both"):
        BatchVerifier(device="cpu", mesh=make_mesh(["cpu", "cpu"]))
    one = BatchVerifier(max_batch=_BUCKET, mesh=make_mesh(["cpu"]))
    assert one.mesh.size == 1 and one.device == torch.device("cpu")
    two = BatchVerifier(max_batch=6, buckets=(3, 6), mesh=make_mesh(["cpu", "cpu"]))
    assert two.buckets == (4, 6) and two.mesh.size == 2


def test_sign_queue_device_path_is_memo_free():
    """Duplicates each take a lane; signatures are RFC 6979, byte-identical
    to the host signer; no host fallback on the (plain) device path."""

    async def scenario():
        eng = _cpu_engine(sign_on_device=True)
        d, _q = hc.keygen(_SeededRng(2))
        dg = hashlib.sha256(b"dup").digest()
        uniq = [hashlib.sha256(b"uniq-%d" % i).digest() for i in range(3)]
        sigs = await asyncio.gather(
            *[eng.sign_ecdsa_p256(d, dg) for _ in range(3)],
            *[eng.sign_ecdsa_p256(d, u) for u in uniq],
        )
        assert sigs[:3] == [hc.ecdsa_sign_py(d, dg)] * 3
        assert sigs[3:] == [hc.ecdsa_sign_py(d, u) for u in uniq]
        sq = eng._sign_queues["ecdsa_p256"]
        st = sq.stats
        assert st.items == 6 and st.batches == 1
        assert st.host_fallback_items == 0
        assert st.padded_lanes == _BUCKET - 6
        for attr in ("_memo", "_neg_memo", "_inflight_futs"):
            assert not hasattr(sq, attr), attr
        assert st.host_prep_time_s > 0 and st.device_time_s > 0

    asyncio.run(scenario())


def test_sign_queue_on_cpu_device_defaults_to_host_and_records_it():
    async def scenario():
        eng = _cpu_engine()  # sign_on_device resolves from the device
        d, q = hc.keygen(_SeededRng(3))
        digests = [hashlib.sha256(b"fb-%d" % i).digest() for i in range(4)]
        sigs = await asyncio.gather(*[eng.sign_ecdsa_p256(d, g) for g in digests])
        assert all(hc.ecdsa_verify(q, g, s) for g, s in zip(digests, sigs))
        st = eng.sign_stats["ecdsa_p256"]
        assert st.items == 4 and st.host_fallback_items == 4

    asyncio.run(scenario())


def test_kernel_error_reaches_the_futures_not_the_host_path():
    async def scenario():
        eng = _cpu_engine()

        def broken_kernel(items):
            raise RuntimeError("p256_verify: CUDA error 700 (illegal address)")

        q = eng._queue("ecdsa_p256", broken_kernel)
        with pytest.raises(RuntimeError, match="CUDA error"):
            await asyncio.gather(q.submit(b"a"), q.submit(b"b"))
        assert q.stats.batches == 0 and q._host() is None

    asyncio.run(scenario())


def test_hung_dispatch_raises_into_the_futures():
    """A dispatch past the timeout fails its batch with TimeoutError; the
    next batch goes to the kernel again (no host re-run, no write-off)."""

    async def scenario():
        eng = BatchVerifier(max_batch=8, dispatch_timeout=0.2, device="cpu")
        hang = threading.Event()
        calls = []

        def hanging_once(items):
            calls.append(list(items))
            if len(calls) == 1:
                hang.wait(30)
                raise AssertionError("unreachable in test")
            return np.array([it == b"good" for it in items], dtype=bool)

        q = eng._queue("ecdsa_p256", hanging_once)
        outs = await asyncio.wait_for(
            asyncio.gather(q.submit(b"good"), q.submit(b"bad"),
                           return_exceptions=True), 10
        )
        assert all(isinstance(o, TimeoutError) for o in outs), outs
        assert q.stats.dispatch_timeouts == 1 and q.stats.batches == 0
        ok, nok = await asyncio.wait_for(
            asyncio.gather(q.submit(b"good"), q.submit(b"bad")), 10
        )
        assert ok is True and nok is False
        assert [sorted(c) for c in calls] == [[b"bad", b"good"]] * 2
        hang.set()

    asyncio.run(scenario())


def test_prep_accounting_is_thread_safe():
    eng = _cpu_engine()
    eng._queue("ecdsa_p256", eng._dispatch_ecdsa)
    n_threads, per_thread = 8, 500
    barrier = threading.Barrier(n_threads)

    def hammer():
        barrier.wait()
        for _ in range(per_thread):
            eng._note_prep("ecdsa_p256", 7, 0.0)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert eng.stats["ecdsa_p256"].padded_lanes == n_threads * per_thread * 7


def test_staging_pool_recycles_host_tensors():
    pool = _StagingPool(cap=2)
    a = pool.acquire((8, 98), torch.uint16)
    assert a.shape == (8, 98) and a.dtype == torch.uint16 and not a.is_pinned()
    pool.release(a)
    assert pool.acquire((8, 98), torch.uint16) is a
    assert pool.acquire((8, 98), torch.uint16) is not a
