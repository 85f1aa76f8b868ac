"""The port's crash-recovery soak (minbft_tpu_torch/testing/recovery_soak.py)
against the reference's (minbft_tpu/testing/recovery_soak.py).

The soak's helpers read a replica's log and its scrape; the port's and
the reference's must give the same port, census and gauges on the same
text.  One cut soak runs in tier-1 under the pinned seed, without the
default plan's drops, with host crypto (``device=None``, every process
``--no-batch``); the reference's own
acceptance soak is behind ``-m slow`` and so is the port's copy at its
size.  ``device="cuda:0"`` without CUDA refuses before it spawns
anything.  Last, ``tools/benchgate`` refuses to compare the port's
``chaos_recovery_*`` extras with the reference's across backends."""

import os
import subprocess

import numpy as np
import pytest
import torch

from minbft_tpu.obs import prom as ref_prom
from minbft_tpu.testing import recovery_soak as ref_soak
from minbft_tpu_torch.obs import prom as port_prom
from minbft_tpu_torch.recovery import RecoveryManager
from minbft_tpu_torch.testing import recovery_soak as soak
from minbft_tpu_torch.testing.faultnet import SEEDED_KINDS, FaultCensus

# The reference's pinned soak seed (tests/test_recovery.py).
SOAK_SEED = 0x2020C0FFEE
# The bench's recovery keys: the reference's seven, then the port's
# restart time and drain margin.
PORT_KEYS = ("chaos_recovery_restart_to_listen_ms", "chaos_recovery_drain_margin_ms")
RECOVERY_KEYS = (
    "chaos_recovery_time_ms", "chaos_recovery_goodput_per_sec",
    "chaos_recovery_restored_count", "chaos_recovery_wall_ms", "chaos_recovery_seed",
    "chaos_recovery_requests", "chaos_recovery_census_ok",
) + PORT_KEYS


def _log_text(rng) -> tuple:
    """A replica log with two metrics announcements (a restart appends the
    second) among seeded noise; returns (bytes, offset of the restart)."""
    noise = [f"2026-10-18 12:00:{k:02d},000 [replica 3] INFO line {rng.integers(1 << 30)}"
             for k in range(20)]
    first = ["replica 3 serving on 127.0.0.1:41000 (engine: cuda:0)",
             "replica 3 metrics on http://127.0.0.1:45678/metrics"]
    second = ["replica 3 serving on 127.0.0.1:41000 (engine: cuda:0)",
              "replica 3 metrics on http://127.0.0.1:51234/metrics"]
    head = "\n".join(noise[:7] + first + noise[7:12]) + "\n"
    tail = "\n".join(noise[12:] + second) + "\n"
    return (head + tail).encode(), len(head.encode())


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_port_reads_the_announcement_past_the_offset_like_the_reference(
        tmp_path, seed):
    text, restart_at = _log_text(np.random.default_rng(seed))
    path = str(tmp_path / "replica3.log")
    with open(path, "wb") as fh:
        fh.write(text)
    for offset, want in ((0, 45678), (restart_at, 51234)):
        assert soak._metrics_port(path, offset, 1) == ref_soak._metrics_port(
            path, offset, 1) == want
    with open(path, "wb") as fh:
        fh.write(text[:restart_at])
    for mod in (soak, ref_soak):
        with pytest.raises(AssertionError, match="never announced"):
            mod._metrics_port(path, restart_at, 0.3)


def _exposition(seed: int) -> str:
    """Prometheus text of a seeded fault census (per-kind counts, per-link
    faults and frames, a kind the soak does not seed) and a restarted
    replica's recovery families, rendered by the port."""
    rng = np.random.default_rng(seed)
    census = FaultCensus()
    links = [(f"r{a}", f"r{b}") for a in range(4) for b in range(4) if a != b]
    for link in links:
        for _ in range(int(rng.integers(1, 400))):
            census.note_frame(link)
        for kind in (*SEEDED_KINDS, "crash"):
            for _ in range(int(rng.integers(0, 4))):
                census.inc(kind, link)
    rec = RecoveryManager()
    rec.restored_count = int(rng.integers(1, 5000))
    rec.arm()
    rec.note_executed()
    fams = port_prom.collect_faultnet(census, {"replica": "3"})
    fams += port_prom.collect_recovery([rec], {"replica": "3"})
    return port_prom.render_families(fams)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_census_and_gauges_from_a_scrape_equal_the_reference(seed):
    text = _exposition(seed)
    port_fams = port_prom.parse_exposition(text)
    ref_fams = ref_prom.parse_exposition(text)
    got = soak._census_from_scrape(port_fams)
    assert got == ref_soak._census_from_scrape(ref_fams)
    assert sum(got["frames"].values()) > 0 and len(got["frames"]) == 12
    for name in ("minbft_recovery_restored_count", "minbft_recovery_time_ms",
                 "minbft_no_such_family"):
        assert soak._gauge(port_fams, name) == ref_soak._gauge(ref_fams, name)
    assert soak._gauge(port_fams, "minbft_recovery_time_ms") is not None
    # an exposition without the chaos families: an all-zero census
    assert soak._census_from_scrape({}) == ref_soak._census_from_scrape({}) == {
        "seeded": {k: 0 for k in SEEDED_KINDS}, "frames": {}}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_soak_on_cuda_refuses_without_cuda_and_spawns_nothing(tmp_path, monkeypatch):
    spawned = []

    def no_spawn(*a, **kw):
        spawned.append(a)
        raise AssertionError("spawned a process")

    monkeypatch.setattr(subprocess, "run", no_spawn)
    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    with pytest.raises(RuntimeError, match="cuda"):
        soak.run_recovery_soak(str(tmp_path), device="cuda:0", chaos_seed=SOAK_SEED)
    assert spawned == [] and os.listdir(tmp_path) == []


def test_soak_past_its_budget_fails_naming_it_and_spawns_nothing(tmp_path, monkeypatch):
    """Every wait of the soak takes at most the budget's time left: a
    spent budget fails it before the next wait, with a message that names
    the budget."""
    spawned = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw: spawned.append(a))
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **kw: spawned.append(a))
    with pytest.raises(AssertionError, match="past its 0 s budget"):
        soak.run_recovery_soak(str(tmp_path), device=None, chaos_seed=SOAK_SEED, budget_s=0.0)
    assert spawned == []


def _check_report(report: dict, requests: int) -> None:
    assert report["committed"] == report["requested"] == requests
    assert report["chaos_recovery_time_ms"] > 0
    assert report["restored_count"] > 0
    assert report["restart_to_listen_ms"] > 0
    # the bench outlived the first execution, or exited within the grace
    assert report["drain_margin_ms"] > -soak.DRAIN_GRACE_S * 1e3
    assert report["stores"], "no store invariant summaries"
    assert report["census"], "census equality never checked"


# The cut soak: the default plan's delays and duplicates under the pinned
# seed, without its 1% drops.  A dropped frame leaves a capture gap that
# the transport heals by redialing after 8 s, and after the kill the
# cluster has three voters (the restarted replica's new USIG epoch is
# refused by design), so under drops its pace and the restarted replica's
# catch-up are set by those timers: with host crypto a soak's length then
# varies several-fold from run to run (minutes at 12,000 requests), and
# at 3,600 the load can drain before the catch-up.  Without drops, 3,600
# requests run a few seconds past the restart and the restarted replica
# executes within about a second.  The default plan, drops included, runs
# in the slow test below and on the card (chip_smoke.py phase 18).
CUT_SOAK_REQUESTS = 3_600
CUT_SOAK_PLAN = "delay=0.05,duplicate=0.01"


def test_cut_recovery_soak_with_host_crypto_under_the_pinned_seed(tmp_path):
    """One kill -9 of replica 3 mid-load, n = 4, ``--no-batch`` (the
    reference's form), the pinned seed: zero committed loss, a durable
    restore, green store invariants and each census equal to the seed's
    replay."""
    from minbft_tpu_torch import bench

    report = soak.run_recovery_soak(
        str(tmp_path), requests=CUT_SOAK_REQUESTS, chaos_seed=SOAK_SEED,
        chaos_plan=CUT_SOAK_PLAN, device=None, **bench.RECOVERY_SOAK,
    )
    _check_report(report, CUT_SOAK_REQUESTS)
    assert report["chaos_plan"] == CUT_SOAK_PLAN
    assert all(c["delay"] > 0 and c["drop"] == 0 for c in report["census"].values())
    assert "engines" not in report and report["device"] is None
    # the durable stores hold state the certificate vouches for: the
    # restarted replica's among them
    assert 3 in report["stores"]


@pytest.mark.slow
def test_pinned_seed_recovery_soak(tmp_path):
    """The reference's acceptance soak at its size, on the port, with host
    crypto: kill -9 a real ``peer run`` replica mid-load under a pinned
    chaos seed, restart it, and require zero committed loss, a durable
    restore (finite recovery_time_ms), green store invariants, and live
    census == seed-replayed census.  Its 198 requests outlive the restart
    only at the reference's ~5.5 req/s of pure-Python crypto; with OpenSSL
    they drain before the restarted replica executes, and this test and
    the reference's fail alike (ROADMAP.md queue 3)."""
    from minbft_tpu_torch import bench

    report = soak.run_recovery_soak(
        str(tmp_path), requests=bench.RECOVERY_REQUESTS_HOST, chaos_seed=SOAK_SEED,
        device=None, **bench.RECOVERY_SOAK,
    )
    _check_report(report, 198)


# ---------------------------------------------------------------------------
# tools/benchgate on the port's chaos_recovery_* extras


def _recovery_extras(backend: str, seed: int, **stamp) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "backend": backend, **stamp,
        "chaos_recovery_time_ms": float(rng.uniform(1e3, 4e4)),
        "chaos_recovery_goodput_per_sec": float(rng.uniform(50, 900)),
        "chaos_recovery_restart_to_listen_ms": float(rng.uniform(400, 9000)),
        "chaos_recovery_drain_margin_ms": float(rng.uniform(-9000, 60000)),
        "chaos_recovery_restored_count": int(rng.integers(1, 5000)),
        "chaos_recovery_seed": hex(SOAK_SEED),
        "chaos_recovery_census_ok": True,
    }


@pytest.mark.parametrize("port_backend,ref_stamp", [
    ("cuda", {"backend": "tpu"}),
    ("cpu", {"backend": "cpu", "tpu_unavailable": True}),
], ids=["cuda-vs-tpu", "cpu-vs-cpu-fallback"])
@pytest.mark.parametrize("port_is_baseline", [True, False], ids=["port-base", "ref-base"])
def test_benchgate_refuses_recovery_extras_across_backends(port_backend, ref_stamp,
                                                           port_is_baseline):
    from tools import benchgate

    stamp = dict(ref_stamp)
    port = _recovery_extras(port_backend, 1)
    ref = _recovery_extras(stamp.pop("backend"), 2, **stamp)
    base, cand = (port, ref) if port_is_baseline else (ref, port)
    with pytest.raises(benchgate.BackendMismatch):
        benchgate.compare(base, cand)
    # the same pair within one backend is gated on the two recovery keys
    rep = benchgate.compare(port, dict(port))
    assert {r.key for r in rep.results} == {"chaos_recovery_time", "chaos_recovery_goodput"}
    assert rep.ok


def test_recovery_extras_key_names_are_the_reference_bench_keys():
    """The keys the port's section must emit (the next test) are the
    reference's seven (read off its ``bench_recovery`` source) plus the
    port's restart time and drain margin."""
    import inspect

    import bench as ref_bench

    src = inspect.getsource(ref_bench.bench_recovery)
    ref_keys = {k for k in RECOVERY_KEYS if f'"{k}"' in src}
    assert ref_keys == set(RECOVERY_KEYS) - set(PORT_KEYS)
    assert len(ref_keys) == 7


def test_bench_recovery_section_reshapes_the_soak_and_fails_with_it(monkeypatch):
    """``bench recovery`` runs one soak at the reference's sizes on its
    device (the host count off the card, ``MINBFT_BENCH_RECOVERY_*``
    override) and emits the reference's seven keys plus the restart time
    and the drain margin;
    a soak that raises fails the section (the reference logs it and goes
    on)."""
    from minbft_tpu_torch import bench

    calls = []

    def fake_soak(workdir, **kw):
        calls.append(kw)
        return {"chaos_recovery_time_ms": 1234.5, "chaos_recovery_goodput_per_sec": 77.7,
                "restored_count": 41, "wall_recovery_ms": 4567.8,
                "requested": kw["requests"] // kw["clients"] * kw["clients"],
                "census": {0: {"drop": 1}}, "restart_to_listen_ms": 987.6,
                "drain_margin_ms": 23456.7}

    monkeypatch.setattr(soak, "run_recovery_soak", fake_soak)
    for knob in ("SEED", "REQUESTS"):
        monkeypatch.delenv(f"MINBFT_BENCH_RECOVERY_{knob}", raising=False)
    out = bench.bench_recovery(device="cpu")
    assert set(out) == set(RECOVERY_KEYS)
    assert out["chaos_recovery_requests"] == 198 and out["chaos_recovery_seed"] == hex(SOAK_SEED)
    assert out["chaos_recovery_census_ok"] is True
    assert out["chaos_recovery_restart_to_listen_ms"] == 987.6
    assert out["chaos_recovery_drain_margin_ms"] == 23456.7
    # the reference bench's sizes and seed
    assert calls[-1] == dict(replicas=4, requests=198, clients=6, depth=4, checkpoint_period=4,
                             chunk_bytes=2048, chaos_seed=SOAK_SEED, down_s=0.5, device="cpu")
    monkeypatch.setenv("MINBFT_BENCH_RECOVERY_REQUESTS", "60")
    monkeypatch.setenv("MINBFT_BENCH_RECOVERY_SEED", "0x5")
    out = bench.bench_recovery()
    assert calls[-1]["device"] is None and calls[-1]["requests"] == 60
    assert out["chaos_recovery_seed"] == "0x5"

    def failed_soak(workdir, **kw):
        raise AssertionError("the load drained before replica 3 caught up")

    monkeypatch.setattr(soak, "run_recovery_soak", failed_soak)
    with pytest.raises(AssertionError, match="drained"):
        bench.main(["--device", "cpu", "recovery"])
