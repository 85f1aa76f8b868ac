"""The port's utilization ledger, telemetry rings and event-loop knob
(minbft_tpu_torch/obs/ledger.py, obs/timeseries.py, utils/loop.py)
against their reference twins (minbft_tpu/obs/, minbft_tpu/utils/loop.py)
on pinned inputs, and the port engine's queue-depth gauges and peaks,
which the bench's sampler and ``{prefix}_queue_depth_peak`` read.

The inputs are the synthetic engine stats and counter sequences of
tests/test_ledger.py and tests/test_timeseries.py's kind, with fixed
clocks, so every reading is compared exactly."""

import asyncio

import numpy as np
import pytest

from minbft_tpu.obs import ledger as ref_ledger
from minbft_tpu.obs import timeseries as ref_ts
from minbft_tpu.utils import loop as ref_loop
from minbft_tpu_torch.obs import CounterSampler, DeviceLedger, TimeSeries
from minbft_tpu_torch.obs import ledger, timeseries
from minbft_tpu_torch.parallel import BatchVerifier
from minbft_tpu_torch.utils import loop


class _Stats:
    def __init__(self, **kw):
        self.items = kw.get("items", 0)
        self.batches = kw.get("batches", 0)
        self.padded_lanes = kw.get("padded_lanes", 0)
        self.memo_hits = kw.get("memo_hits", 0)
        self.host_fallback_items = kw.get("host_fallback_items", 0)
        self.device_time_s = kw.get("device_time_s", 0.0)


class _Engine:
    def __init__(self, verify, sign):
        self.stats = verify
        self.sign_stats = sign


def _engine(g):
    """Synthetic engine stats drawn from the numpy generator ``g``."""
    def stats(**extra):
        return _Stats(items=int(g.integers(0, 500)), batches=int(g.integers(1, 20)),
                      padded_lanes=int(g.integers(0, 200)),
                      device_time_s=float(g.uniform(0, 2)), **extra)

    return _Engine(
        {"hmac_sha256": stats(memo_hits=int(g.integers(0, 300))),
         "ecdsa_p256": stats(memo_hits=int(g.integers(0, 300)))},
        {"ecdsa_p256": stats(host_fallback_items=0)},
    )


def _advance(eng, g):
    for st in list(eng.stats.values()) + list(eng.sign_stats.values()):
        st.items += int(g.integers(1, 4000))
        st.batches += int(g.integers(1, 30))
        st.padded_lanes += int(g.integers(0, 900))
        st.memo_hits += int(g.integers(0, 900))
        st.device_time_s += float(g.uniform(0, 9))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_device_ledger_matches_reference(seed):
    g = np.random.default_rng(seed)
    eng = _engine(g)
    leds = [DeviceLedger(eng, now=100.0), ref_ledger.DeviceLedger(eng, now=100.0)]
    for led in leds:
        led.set_ceiling("hmac_sha256", 12345.5, "probe")
    _advance(eng, g)
    for queue in ("hmac_sha256", "ecdsa_p256"):
        got, want = (led.util_keys("cfg", queue, now=107.25) for led in leds)
        assert got == want and got
    got, want = (led.snapshot(now=107.25) for led in leds)
    assert {k: vars(w) for k, w in got.items()} == {k: vars(w) for k, w in want.items()}
    win = got["verify:ecdsa_p256"]
    assert vars(leds[0].decompose(win)) == vars(leds[1].decompose(want["verify:ecdsa_p256"]))
    assert ledger.QueueWindow is not ref_ledger.QueueWindow
    assert ledger.DeviceLedger.probe_ceiling(lambda items: None, 0, 64) > 0


def test_timeseries_and_sampler_match_reference():
    g = np.random.default_rng(7)
    rings = [TimeSeries(interval_s=0.5, capacity=6), ref_ts.TimeSeries(interval_s=0.5, capacity=6)]
    samplers = [CounterSampler(rings[0]), ref_ts.CounterSampler(rings[1])]
    counters = {"c": 0.0, "num": 0.0, "den": 0.0, "g": 0.0}
    for s in samplers:
        s.add_rate("rate", lambda: counters["c"])
        s.add_ratio("fill", lambda: counters["num"], lambda: counters["den"])
        s.add_gauge("depth", lambda: counters["g"])
    t = 1000.0
    for step in range(20):
        counters["c"] += float(g.integers(0, 50))
        if step == 9:
            counters["c"] = 3.0  # a reset reads as no data, never negative
        counters["num"] += float(g.integers(0, 100))
        counters["den"] += float(g.integers(0, 3))
        counters["g"] = float(g.integers(0, 9))
        for s in samplers:
            s.tick(t=t)
        t += float(g.uniform(0.1, 0.9))
    for ring in rings:
        ring.record("extra", 2.5, kind="gauge", t=t)
    assert rings[0].to_dict() == rings[1].to_dict()
    for name in ("rate", "fill", "depth", "extra"):
        assert rings[0].timeline(name) == rings[1].timeline(name)
        assert rings[0].timeline(name, last=3) == rings[1].timeline(name, last=3)
    assert rings[0].window(3.0, now=t) == rings[1].window(3.0, now=t)
    merged = TimeSeries.merged([rings[0], TimeSeries.from_dict(rings[1].to_dict())])
    ref_merged = ref_ts.TimeSeries.merged([rings[1], ref_ts.TimeSeries.from_dict(rings[1].to_dict())])
    assert merged.to_dict() == ref_merged.to_dict()
    with pytest.raises(ValueError):
        rings[0].record("depth", 1.0, kind="rate")
    assert timeseries.IncarnationMismatch is not ref_ts.IncarnationMismatch


def test_engine_series_read_the_port_engine_depths_and_peaks():
    async def run():
        engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu", max_inflight=1)
        ring = TimeSeries()
        sampler = CounterSampler(ring)
        timeseries.register_engine_series(sampler, engine)
        key, msg = b"k" * 32, b"m" * 32
        futs = [engine.verify_hmac_sha256(key, msg, bytes([i]) * 32) for i in range(20)]
        tasks = [asyncio.ensure_future(f) for f in futs]
        await asyncio.sleep(0)
        depth = engine.queue_depths()["hmac_sha256"]
        sampler.tick(t=50.0)
        await asyncio.gather(*tasks)
        sampler.tick(t=52.0)
        peaks = engine.queue_depth_peaks()
        return depth, peaks, engine, ring

    depth, peaks, engine, ring = asyncio.run(run())
    # 20 distinct lanes, 8 a batch, one dispatch in flight: the first 8
    # shipped as a full batch and the other 12 waited behind it.
    assert peaks == {"hmac_sha256": 12}
    assert engine.queue_depth_peaks() == {"hmac_sha256": 0}  # rearmed at 0
    assert depth == 12
    assert engine.sign_queue_depths() == {} and engine.sign_queue_depth_peaks() == {}
    assert ring.timeline("queue_depth")[1][0] == depth
    assert sum(ring.timeline("verify_items")[1]) == 20


@pytest.mark.parametrize("value", ["", "auto", "0", "no", "1", "yes"])
def test_uvloop_knob_matches_reference(monkeypatch, value):
    monkeypatch.setenv(loop.UVLOOP_ENV, value)
    assert loop.uvloop_requested() == ref_loop.uvloop_requested()
    if value in ("0", "no"):
        assert loop.maybe_enable_uvloop() is False
