"""The port's Prometheus exposition (minbft_tpu_torch/obs/prom.py) against
the reference's (minbft_tpu/obs/prom.py).

- ``render_families``, ``parse_exposition`` and ``merge_expositions``
  give byte-identical text and equal dicts from the same inputs:
  counters, gauges, label escaping, and log2 histograms filled with the
  same observations in each package's ``Log2Histogram``.
- ``collect_replica`` on a committing port cluster (n = 4, pairwise MACs,
  HMAC USIGs, one CPU engine: plain K6) renders the reference's family
  names, types and labels (the reference's collector, duck-typed, runs
  on the same port objects), with values equal to the port objects' own
  counters.
- The port's ``MetricsServer``, scraped over HTTP by the reference's
  ``scrape``, serves exactly what its ``render`` returns."""

import asyncio

import numpy as np
import pytest

from minbft_tpu.obs import hist as ref_hist
from minbft_tpu.obs import prom as ref
from minbft_tpu_torch.obs import hist as port_hist
from minbft_tpu_torch.obs import prom as port


def _hists(seed: int):
    """The same observations in a port and a reference histogram:
    seeded log-uniform seconds, a zero and a negative duration."""
    vals = 10.0 ** np.random.default_rng(seed).uniform(-7, 1, size=200)
    vals = list(vals) + [0.0, -3e-4]
    hp, hr = port_hist.Log2Histogram(), ref_hist.Log2Histogram()
    for v in vals:
        hp.observe(float(v))
        hr.observe(float(v))
    return hp, hr


def _families(hist, replica: str):
    return [
        ("m_total", "counter", "help text", [({"replica": replica}, 3),
                                             ({"replica": replica, "kind": "a"}, 7)]),
        ("g", "gauge", "a gauge", [({"replica": replica}, 1.5), ({}, 2)]),
        ("esc", "gauge", 'quotes " and \\ back', [({"path": 'a"b\\c'}, -0.25)]),
        ("empty", "counter", "skipped entirely", []),
        ("lat_seconds", "histogram", "latency", [({"stage": "s", "replica": replica},
                                                  hist)]),
    ]


@pytest.mark.parametrize("seed", [1, 2])
def test_render_parse_and_merge_are_byte_identical(seed):
    texts_p, texts_r = [], []
    for r in ("0", "1", "2"):
        hp, hr = _hists(seed + int(r))
        tp = port.render_families(_families(hp, r))
        tr = ref.render_families(_families(hr, r))
        assert tp == tr
        assert port.parse_exposition(tp) == ref.parse_exposition(tr)
        texts_p.append(tp)
        texts_r.append(tr)
    merged = port.merge_expositions(texts_p)
    assert merged == ref.merge_expositions(texts_r)
    assert port.parse_exposition(merged) == ref.parse_exposition(merged)
    # the replica label is stripped, so the three targets fold together
    assert 'm_total{kind="a"} 21' in merged
    assert port.merge_family_lists([_families(hp, "0"), _families(hp, "1")]) == \
        ref.merge_family_lists([_families(hp, "0"), _families(hp, "1")])


async def _committing_cluster(n_ops: int):
    from minbft_tpu_torch.client import new_client
    from minbft_tpu_torch.core import new_replica
    from minbft_tpu_torch.parallel import BatchVerifier
    from minbft_tpu_torch.sample.authentication.mac import new_test_mac_authenticators
    from minbft_tpu_torch.sample.config import SimpleConfiger
    from minbft_tpu_torch.sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from minbft_tpu_torch.sample.requestconsumer import SimpleLedger

    cfg = SimpleConfiger(n=4, f=1, timeout_request=60.0, timeout_prepare=30.0)
    cfg.trace = True  # the flight recorder: the stage families
    engine = BatchVerifier(max_batch=8, buckets=(8,), device="cpu")
    r_auths, c_auths = new_test_mac_authenticators(4, 1, engine=engine,
                                                   client_engine=engine)
    stubs = make_testnet_stubs(4)
    ledgers = [SimpleLedger() for _ in range(4)]
    replicas = []
    for i in range(4):
        r = new_replica(i, cfg, r_auths[i], InProcessPeerConnector(stubs), ledgers[i])
        stubs[i].assign_replica(r)
        replicas.append(r)
    for r in replicas:
        await r.start()
    client = new_client(0, 4, 1, c_auths[0], InProcessClientConnector(stubs), seq_start=0)
    await client.start()
    for k in range(n_ops):
        await asyncio.wait_for(client.request(b"prom-%d" % k), 60)
    for _ in range(500):  # f + 1 replies precede the last executions
        if all(lg.length == n_ops for lg in ledgers):
            break
        await asyncio.sleep(0.02)
    assert [lg.length for lg in ledgers] == [n_ops] * 4
    return client, replicas, engine


# Families whose values are clock readings.
CLOCKED = {"minbft_uptime_seconds"}


def test_collect_replica_on_a_committing_port_cluster_matches_the_reference():
    async def run():
        from minbft_tpu_torch.obs.timeseries import (
            CounterSampler,
            TimeSeries,
            register_engine_series,
            register_replica_series,
        )

        client, replicas, engine = await _committing_cluster(3)
        try:
            r0 = replicas[0]
            ts = TimeSeries()
            sampler = CounterSampler(ts)
            register_replica_series(sampler, r0.metrics)
            register_engine_series(sampler, engine)
            sampler.tick()
            sampler.tick()
            kw = dict(metrics=r0.metrics, recorder=r0.handlers.trace, engine=engine,
                      replica_id=0, timeseries=ts)
            peak = engine.queue_depth_peaks(reset=False)
            text_p = port.render_families(port.collect_replica(**kw))
            # the depth-peak gauges rearm on read: give the reference's
            # collector the same marks
            for name, q in engine._queues.items():
                q.peak_depth = peak[name]
            # The reference's collector on the same port objects (its
            # histograms are the port's, so the port renders both lists).
            text_r = port.render_families(ref.collect_replica(**kw))
            return text_p, text_r, r0, engine
        finally:
            await client.stop()
            for r in replicas:
                await r.stop()

    text_p, text_r, r0, engine = asyncio.run(run())
    fp, fr = port.parse_exposition(text_p), ref.parse_exposition(text_r)
    assert set(fp) == set(fr)
    timeouts = {f"minbft_{side}_queue_dispatch_timeouts_total" for side in ("verify", "sign")}
    for name in fp:
        assert fp[name]["type"] == fr[name]["type"], name
        if name == "minbft_build_info":
            # each package stamps its own run id on it: the same labels
            assert [sorted(dict(k)) for k in fp[name]["samples"]] == \
                [sorted(dict(k)) for k in fr[name]["samples"]]
            continue
        if name in CLOCKED:
            # read off the clock: the two collections ran moments apart
            assert fp[name]["samples"].keys() == fr[name]["samples"].keys()
            for k, v in fp[name]["samples"].items():
                assert abs(v - fr[name]["samples"][k]) < 5.0, name
        else:
            assert fp[name]["samples"] == fr[name]["samples"], name
        if name in timeouts:
            # the port says what a timed-out dispatch does there: it fails
            assert "failed with TimeoutError" in fp[name]["help"]
        else:
            assert fp[name]["help"] == fr[name]["help"], name
    # values are the port objects' own counters
    rl = (("replica", "0"),)
    for cname, v in r0.metrics.counters.items():
        assert fp[f"minbft_{cname}_total"]["samples"][rl] == v
    assert fp["minbft_requests_executed_total"]["samples"][rl] == 3
    st = engine.stats["hmac_sha256"]
    key = (("queue", "hmac_sha256"), ("replica", "0"))
    assert fp["minbft_verify_queue_items_total"]["samples"][key] == st.items > 0
    assert fp["minbft_verify_queue_batches_total"]["samples"][key] == st.batches > 0
    assert fp["minbft_verify_queue_padded_lanes_total"]["samples"][key] == st.padded_lanes
    assert fp["minbft_verify_queue_device_seconds_total"]["samples"][key] == \
        st.device_time_s
    info = dict(next(iter(fp["minbft_build_info"]["samples"])))
    assert info["backend"] == "cpu" and info["replica"] == "0"
    assert any(n.startswith("minbft_stage_latency_seconds") for n in fp)
    assert any(n.startswith("minbft_window_") for n in fp)


def test_metrics_server_scraped_by_the_reference_serves_render():
    calls = []
    hp, _ = _hists(5)

    def render():
        calls.append(1)
        return port.render_families(_families(hp, "0"))

    server = port.MetricsServer(render, host="127.0.0.1", port=0)
    p = server.start()
    try:
        assert p > 0
        text = ref.scrape(f"127.0.0.1:{p}", timeout=5)
        assert text == render()
        assert port.scrape(f"http://127.0.0.1:{p}/metrics", timeout=5) == text
        with pytest.raises(OSError):
            ref.scrape(f"127.0.0.1:{p}/nope", timeout=5)
    finally:
        server.stop()
    assert len(calls) >= 3
    with pytest.raises(OSError):
        ref.scrape(f"127.0.0.1:{p}", timeout=2)
