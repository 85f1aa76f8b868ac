"""The port's bench entry point (minbft_tpu_torch/bench.py) on the CPU,
where its functions run the plain PyTorch versions of the kernels.

- each function of the kernel section at a tiny size returns the key
  names of its counterpart in the reference's bench.py (less the
  ``*_mode`` keys, which belong to the TPU's lowering modes), and its
  self-checks pass;
- ``_bench_cluster_repeated`` of a pairwise-MAC cluster at n = 4 on a CPU
  engine (one run and one traced run) commits every request and emits
  the reference's ``{prefix}_*`` keys, its ``_util_`` and ``_stage_``
  keys included, with no dispatch timed out;
- ``_bench_readonly`` (host crypto, no engine) runs for real and emits
  the reference's ``ro_*`` keys; ``bench_ingest_sweep`` drives one
  cluster run per bundle-ingest operating point under the reference's
  environment and arguments and emits the reference's prefixes (the
  cluster run itself is stubbed here: on the CPU each point's plain K2
  dispatches and ceiling probe cost about a minute, and its keys are the
  MAC cluster's above), fails on a failed point, and restores the
  environment;
- ``main`` refuses to run without CUDA unless asked for the CPU, writes
  its extras to build/torch_bench/extras.json and prints the headline
  line last; named sections run exactly as named, the reference's
  MINBFT_BENCH_* knobs shape only the default run, and a section that
  produces no keys fails the bench."""

import json
import os

import pytest
import torch

from minbft_tpu_torch import bench

# The reference's key names (bench.py: bench_ecdsa, bench_ecdsa_sign,
# bench_ed25519, bench_ed25519_sign, bench_sign_queue, bench_prep,
# bench_hmac), less ecdsa_mode and ed25519_mode.
KERNEL_KEYS = {
    "bench_ecdsa": (
        lambda: bench.bench_ecdsa(4, device="cpu"),
        {"ecdsa_batch", "ecdsa_ms_per_batch", "ecdsa_verifies_per_sec", "ecdsa_compile_s"},
    ),
    "bench_ecdsa_sign": (
        lambda: bench.bench_ecdsa_sign(4, device="cpu"),
        {"ecdsa_sign_batch", "ecdsa_signs_per_sec", "ecdsa_sign_compile_s"},
    ),
    "bench_ed25519": (
        lambda: bench.bench_ed25519(4, device="cpu"),
        {"ed25519_batch", "ed25519_ms_per_batch", "ed25519_verifies_per_sec",
         "ed25519_compile_s"},
    ),
    "bench_ed25519_sign": (
        lambda: bench.bench_ed25519_sign(4, device="cpu"),
        {"ed25519_sign_batch", "ed25519_signs_per_sec", "ed25519_sign_compile_s"},
    ),
    "bench_sign_queue": (
        lambda: bench.bench_sign_queue(n_items=16, bucket=8, device="cpu"),
        {f"{s}_{k}" for s in ("ecdsa", "ed25519") for k in (
            "device_signs_per_sec", "sign_queue_mean_batch", "sign_queue_compile_s",
            "sign_queue_fallback", "sign_queue_host_fallback_items")},
    ),
    "bench_prep": (
        lambda: bench.bench_prep(batch=64, ed_batch=32),
        {"prep_batch", "ecdsa_prep_items_per_sec", "ecdsa_prep_scalar_items_per_sec",
         "ecdsa_prep_speedup", "ed25519_prep_batch", "ed25519_prep_items_per_sec",
         "ed25519_prep_scalar_items_per_sec", "ed25519_prep_speedup"},
    ),
    "bench_hmac": (
        lambda: bench.bench_hmac(8, device="cpu"),
        {"hmac_batch", "hmac_verifies_per_sec"},
    ),
}


@pytest.mark.parametrize("name", sorted(KERNEL_KEYS))
def test_kernel_section_emits_the_reference_keys(name):
    run, keys = KERNEL_KEYS[name]
    out = run()
    assert set(out) == keys
    assert all(v > 0 for k, v in out.items() if k.endswith("_per_sec"))
    if name == "bench_sign_queue":
        # A CPU engine signs on the host and says so.
        assert out["ecdsa_sign_queue_fallback"] is True


# The reference's _bench_cluster / _bench_cluster_repeated keys that a
# MAC run with one timed run and a traced run emits (its SLO run is
# skipped here), as {prefix}_<suffix>.
CLUSTER_SUFFIXES = {
    "request_latency_p50_ms", "request_latency_p99_ms", "exec_latency_p50_ms",
    "exec_latency_p99_ms", "messages_handled", "messages_dropped", "n", "f",
    "clients", "requests", "committed_req_per_sec", "ingest_batch_mean",
    "ingest_ticks_per_sec", "batched_verifies", "batches", "mean_batch",
    "device_verifies_per_sec", "logical_verifies", "memo_hits",
    "hmac_sha256_prep_share", "queue_depth_peak", "timeline",
    "req_per_sec_runs", "req_per_sec_mean", "req_per_sec_stddev",
    "util_busy", "util_fill", "util_useful", "util_effective_per_sec",
    "util_per_device_per_sec", "util_ceiling_per_sec", "util_ceiling_source",
    "util_idle_s", "util_lanes_useful", "util_lanes_padding", "util_lanes_memo",
    "util_lanes_fallback",
}


def test_mac_cluster_commits_every_request_and_emits_the_reference_keys(monkeypatch):
    monkeypatch.setenv("MINBFT_BENCH_SKIP_SLO", "1")
    out = bench._bench_cluster_repeated(
        4, 1, 16, n_clients=4, usig_kind="hmac", scheme="mac", max_batch=16,
        prefix="mac", device="cpu", runs=1, trace_run=True, depth=4,
    )
    assert {f"mac_{s}" for s in CLUSTER_SUFFIXES} <= set(out)
    assert any(k.startswith("mac_stage_") for k in out)
    assert any(k.startswith("mac_critpath_") for k in out)
    assert out["mac_requests"] == 16 and out["mac_committed_req_per_sec"] > 0
    assert out["mac_dispatch_timeouts"] == 0
    assert out["mac_batched_verifies"] > 0
    assert out["mac_util_ceiling_source"] == "cpu-probe"
    assert out["mac_util_lanes_useful"] == out["mac_batched_verifies"]


def test_main_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench.main([])
    with pytest.raises(RuntimeError):
        bench.main(["--device", "cuda:0", "kernels"])
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "no-such-section"])


def _stub_kernel_section(monkeypatch, calls):
    """The kernel section's functions as stubs that log their batch (the
    tests above run the real ones)."""
    monkeypatch.setattr(bench, "bench_prep", lambda: {"prep_batch": 0})
    monkeypatch.setattr(bench, "bench_hmac", lambda batch, device: calls.append(
        ("hmac", batch)) or {"hmac_batch": batch})
    monkeypatch.setattr(bench, "bench_ecdsa", lambda batch, device: calls.append(
        ("ecdsa", batch)) or {"ecdsa_batch": batch, "ecdsa_verifies_per_sec": 123.25})
    for name in ("bench_ecdsa_sign", "bench_ed25519", "bench_ed25519_sign"):
        monkeypatch.setattr(bench, name, lambda batch, device, _n=name: calls.append(
            (_n, batch)) or {f"{_n}_batch": batch})
    monkeypatch.setattr(bench, "bench_sign_queue", lambda device: calls.append(
        ("bench_sign_queue", 0)) or {"sign_queue": 1})


def test_main_writes_extras_and_prints_the_headline_last(monkeypatch, capsys):
    """The kernel section's wiring on the CPU.  A named section runs
    whole: the reference's MINBFT_BENCH_SKIP_* knobs do not trim it."""
    for gate in ("E2E", "SIGN", "ED25519"):
        monkeypatch.setenv(f"MINBFT_BENCH_SKIP_{gate}", "1")
    calls = []
    _stub_kernel_section(monkeypatch, calls)
    ref_extras = os.path.join(os.path.dirname(bench._PKG_DIR), "BENCH_extras.json")
    before = os.stat(ref_extras).st_mtime_ns
    assert bench.main(["--device", "cpu", "kernels"]) == 0
    # The CPU clamps the batch to 32.
    assert calls == [("hmac", 32), ("ecdsa", 32), ("bench_ecdsa_sign", 32),
                     ("bench_sign_queue", 0), ("bench_ed25519", 32),
                     ("bench_ed25519_sign", 32)]
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[-1])
    assert head == {
        "metric": "batched ECDSA-P256 verifies/sec/chip", "value": 123.2,
        "unit": "verifies/sec", "backend": "cpu", "device": "cpu", "power_limit": None,
    }
    assert json.loads(lines[-2])["bench_extras"]["ecdsa_verifies_per_sec"] == 123.25
    with open(os.path.join(bench.OUT_DIR, "extras.json")) as fh:
        extras = json.load(fh)
    assert extras["ecdsa_batch"] == 32 and extras["backend"] == "cpu"
    assert os.stat(ref_extras).st_mtime_ns == before


def test_main_default_run_follows_the_reference_knobs(monkeypatch):
    """With no section named the reference's knobs decide: on the CPU the
    configurations past ``e2e`` run only with ALL_CONFIGS, and each
    SKIP_* gate drops its part.  A named configuration runs without
    ALL_CONFIGS."""
    calls, ran = [], []
    _stub_kernel_section(monkeypatch, calls)
    monkeypatch.setattr(bench, "_bench_cluster_repeated", lambda *a, prefix="e2e", **kw: (
        ran.append(prefix) or {f"{prefix}_committed_req_per_sec": 1.0}))
    # The ingest sweep and the read-only section are host-path work and
    # join the default run on every device, in the reference's order.
    monkeypatch.setattr(bench, "bench_ingest_sweep", lambda n, device: (
        ran.append(("ingest", n)) or {"ingest_off_requests": n}))

    async def readonly(n_reads):
        ran.append(("readonly", n_reads))
        return {"ro_reads": n_reads}

    monkeypatch.setattr(bench, "_bench_readonly", readonly)
    for knob in ("ALL_CONFIGS", "SKIP_E2E", "SKIP_SIGN", "SKIP_ED25519",
                 "SKIP_NODEDUP", "SKIP_CONFIGS", "SKIP_INGEST", "SKIP_RO",
                 "INGEST_REQUESTS", "RO_READS"):
        monkeypatch.delenv(f"MINBFT_BENCH_{knob}", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    # the CPU sizes: 400 requests a point, reads clamped to 400
    assert ran == ["e2e", ("ingest", 400), ("readonly", 400)] and len(calls) == 6
    monkeypatch.setenv("MINBFT_BENCH_ALL_CONFIGS", "1")
    monkeypatch.setenv("MINBFT_BENCH_SKIP_NODEDUP", "1")
    monkeypatch.setenv("MINBFT_BENCH_SKIP_SIGN", "1")
    monkeypatch.setenv("MINBFT_BENCH_SKIP_INGEST", "1")
    monkeypatch.setenv("MINBFT_BENCH_RO_READS", "64")
    ran.clear(), calls.clear()
    assert bench.main(["--device", "cpu"]) == 0
    assert ran == ["e2e", ("readonly", 64), "cfg1", "cfg2", "cfg4", "mac", "cfg5", "iso"]
    assert [c[0] for c in calls] == ["hmac", "ecdsa", "bench_ed25519", "bench_ed25519_sign"]
    monkeypatch.delenv("MINBFT_BENCH_ALL_CONFIGS")
    monkeypatch.setenv("MINBFT_BENCH_SKIP_CONFIGS", "1")
    monkeypatch.setenv("MINBFT_BENCH_SKIP_RO", "1")
    ran.clear(), calls.clear()
    assert bench.main(["--device", "cpu", "mac", "nodedup", "ingest"]) == 0
    assert ran == [("ingest", 400), "nodedup", "mac"] and calls == []


def test_main_fails_a_named_section_that_produced_no_keys(monkeypatch):
    monkeypatch.setattr(bench, "_bench_cluster_repeated", lambda *a, **kw: {})
    with pytest.raises(bench.BenchError, match="mac"):
        bench.main(["--device", "cpu", "mac"])


def test_isolated_engines_run_has_no_util_keys():
    """One engine per replica (the ``iso`` layout): every request commits
    and, as in the reference, no ``_util_`` keys (no one engine's clock
    carries the USIG queue)."""
    import asyncio

    out = asyncio.run(bench._bench_cluster(
        3, 1, 2, n_clients=2, usig_kind="hmac", scheme="mac", max_batch=8,
        prefix="iso", isolated_engines=True, device="cpu", depth=4,
    ))
    assert out["iso_requests"] == 2 and out["iso_dispatch_timeouts"] == 0
    assert out["iso_batched_verifies"] > 0
    assert not any("_util_" in k for k in out)


def test_nodedup_run_turns_the_engine_memo_off():
    """``no_dedup`` (the ``nodedup``/``nodedupref`` configurations), as in
    the reference: the engine's memo is off too, so no verification is
    answered from it and every one takes a device lane."""
    import asyncio

    out = asyncio.run(bench._bench_cluster(
        3, 1, 4, n_clients=2, usig_kind="hmac", scheme="mac", max_batch=8,
        prefix="nodedup", no_dedup=True, device="cpu", depth=4,
    ))
    assert out["nodedup_requests"] == 4 and out["nodedup_dispatch_timeouts"] == 0
    assert out["nodedup_memo_hits"] == 0 and out["nodedup_util_lanes_memo"] == 0
    assert out["nodedup_logical_verifies"] == out["nodedup_batched_verifies"] > 0


def test_mp_error_check_reads_a_replica_log_up_to_the_stop(tmp_path):
    """The multi-process runs fail on an ERROR record a replica logs while
    it serves, not on one it logs after SIGTERM (over gRPC the survivors
    log each stopped peer's failed stream at ERROR)."""
    log = tmp_path / "replica0.log"
    served = b"2026-01-01 00:00:00 minbft.replica0 INFO serving\n"
    log.write_bytes(served + b"2026-01-01 00:00:01 minbft.replica0 ERROR peer 1 failed\n")
    assert bench._error_lines(str(log), len(served)) == []
    assert bench._error_lines(str(log), log.stat().st_size) == [
        "2026-01-01 00:00:01 minbft.replica0 ERROR peer 1 failed"]


def _engine_report(device="cuda:0", launches=1, timeouts=0, host_signed=0):
    return {
        "device": device, "cuda_context": device.startswith("cuda"),
        "cuda_reserved_mib": 0.0,
        "launches": {"K2": launches, "K3": launches, "K6": 0, "K7": 0, "K8": 0},
        "verify": {"ecdsa_p256": {"items": 4, "batches": 2, "dispatch_timeouts": timeouts}},
        "sign": {"ecdsa_p256": {"items": 2, "batches": 1, "dispatch_timeouts": 0,
                                "host_fallback_items": host_signed}},
    }


@pytest.mark.parametrize("report, device, fault", [
    (_engine_report(), "cuda:0", None),
    (_engine_report("cpu", launches=0), "cpu", None),
    (_engine_report("cpu"), "cuda:0", "engine on cpu"),
    (_engine_report(launches=0), "cuda:0", "not launched"),
    (_engine_report(timeouts=2), "cuda:0", "2 dispatches timed out"),
    (_engine_report("cpu", launches=0, host_signed=3), "cpu", "host-signed"),
    ({**_engine_report(), "sign": {}}, "cuda:0", "no ECDSA verify or sign batch"),
])
def test_engine_faults_of_a_process_report(report, device, fault):
    """A process's engine report is held to its device: on the card K2
    and K3 launched (the plain versions on the CPU count none), ECDSA
    batches on both sides, no dispatch timed out, no lane host-signed."""
    faults = bench.engine_faults(report, device)
    if fault is None:
        assert faults == []
    else:
        assert len(faults) == 1 and fault in faults[0]


def test_launch_totals_sum_every_kernel_over_the_processes():
    reports = [_engine_report(launches=2), _engine_report(launches=3)]
    reports[1]["launches"]["K6"] = 4
    assert bench.launch_totals(reports) == {"K2": 5, "K3": 5, "K6": 4}


def test_readonly_section_emits_the_reference_keys():
    """The read-only fast path for real at a small size (host crypto, no
    engine, as in the reference): every read takes the fast path, n
    replies each, and the keys are the reference's."""
    import asyncio

    out = asyncio.run(bench._bench_readonly(n_reads=48, n_clients=4))
    assert set(out) == {"ro_reads", "ro_clients", "ro_reads_per_sec", "ro_fast_replies"}
    assert out["ro_reads"] == 48 and out["ro_clients"] == 4
    assert out["ro_fast_replies"] == 4 * 48 and out["ro_reads_per_sec"] > 0


# The reference's bench_ingest_sweep: each point's prefix and what it
# sets, MINBFT_BUNDLE_INGEST=0 for the per-frame path, else the cap.
REF_INGEST_POINTS = [("ingest_off", {"MINBFT_BUNDLE_INGEST": "0", "MINBFT_INGEST_MAX": None}),
                     ("ingest8", {"MINBFT_BUNDLE_INGEST": None, "MINBFT_INGEST_MAX": "8"}),
                     ("ingest64", {"MINBFT_BUNDLE_INGEST": None, "MINBFT_INGEST_MAX": "64"}),
                     ("ingest1024", {"MINBFT_BUNDLE_INGEST": None,
                                     "MINBFT_INGEST_MAX": "1024"})]


def test_ingest_sweep_runs_each_operating_point_as_the_reference(monkeypatch):
    seen = []

    async def cluster(n, f, n_requests, **kw):
        seen.append(((n, f, n_requests), kw, {
            k: os.environ.get(k) for k in ("MINBFT_BUNDLE_INGEST", "MINBFT_INGEST_MAX")}))
        return {f"{kw['prefix']}_{s}": 1 for s in CLUSTER_SUFFIXES}

    monkeypatch.setattr(bench, "_bench_cluster", cluster)
    monkeypatch.setenv("MINBFT_INGEST_MAX", "33")
    monkeypatch.delenv("MINBFT_BUNDLE_INGEST", raising=False)
    out = bench.bench_ingest_sweep(24, device="cpu")
    assert [kw["prefix"] for _, kw, _ in seen] == [p for p, _ in REF_INGEST_POINTS]
    for (args, kw, env), (prefix, want_env) in zip(seen, REF_INGEST_POINTS):
        assert args == (4, 1, 24) and env == want_env
        assert kw == {"n_clients": 16, "usig_kind": "hmac", "max_batch": 128,
                      "prefix": prefix, "device": "cpu"}
    assert set(out) == {f"{p}_{s}" for p, _ in REF_INGEST_POINTS for s in CLUSTER_SUFFIXES}
    assert {f"{p}_ingest_batch_mean" for p, _ in REF_INGEST_POINTS} <= set(out)
    # the environment is restored
    assert os.environ["MINBFT_INGEST_MAX"] == "33"
    assert "MINBFT_BUNDLE_INGEST" not in os.environ

    async def failing(n, f, n_requests, **kw):
        if kw["prefix"] == "ingest64":
            raise bench.BenchError("a request past its deadline")
        return await cluster(n, f, n_requests, **kw)

    monkeypatch.setattr(bench, "_bench_cluster", failing)
    with pytest.raises(bench.BenchError):  # the port's rule: a failed point fails
        bench.bench_ingest_sweep(24, device="cpu")
    assert os.environ["MINBFT_INGEST_MAX"] == "33"


# The reference's keys of one bench_groups point (_bench_groups_cluster:
# bench.py, the timeline only when its sampler ticked) and of bench_load.
GROUPS_POINT_SUFFIXES = {
    "n", "f", "requests", "clients", "committed_req_per_sec", "request_latency_p50_ms",
    "verify_mean_batch", "verify_batches", "device_verifies_per_sec", "queue_depth_peak",
    "util_busy", "util_fill", "util_useful", "util_effective_per_sec",
    "util_per_device_per_sec", "util_ceiling_per_sec", "util_ceiling_source", "util_idle_s",
    "util_lanes_useful", "util_lanes_padding", "util_lanes_memo", "util_lanes_fallback",
}
LOAD_POINT_SUFFIXES = {
    "offered_per_sec", "goodput_per_sec", "p50_ms", "p99_ms", "send_p99_ms",
    "finality_p99_ms", "slo_good_fraction", "timeouts", "census_ok", "busy_received",
    "shed", "busy_sent", "rx_peak",
}
LOAD_KEYS = {f"load_{t}_{s}" for t in ("half", "sat", "over") for s in LOAD_POINT_SUFFIXES} | {
    "load_seed", "load_clients", "load_requests_per_point", "load_burst_peak_per_sec",
    "load_probe_offered_per_sec", "load_probe_census_ok", "load_probe_goodput_per_sec",
    "load_probe_shed", "load_probe_busy_sent", "load_probe_busy_received",
    "load_probe_timeouts", "load_probe_rx_peak", "load_peak_per_sec",
    "load_over_goodput_fraction"}


def test_groups_point_on_a_cpu_engine_emits_the_reference_keys():
    """One ``_bench_groups_cluster`` point for real (G = 2, one request a
    group, two clients, one CPU engine: REQUEST and REPLY signatures
    through the plain K2 and K3, UIs through the plain K6): every group's
    ledger equal on every replica, the reference's keys, no dispatch
    timed out."""
    import asyncio

    out = asyncio.run(bench._bench_groups_cluster(2, 1, n_clients=2, max_batch=16,
                                                  device="cpu"))
    assert {f"groups2_{s}" for s in GROUPS_POINT_SUFFIXES} <= set(out)
    assert out["groups2_requests"] == 2 and out["groups2_dispatch_timeouts"] == 0
    assert out["groups2_verify_batches"] > 0 and out["groups2_sig_batches"] > 0


def test_groups_sweep_runs_every_g_and_fails_on_a_failed_point(monkeypatch):
    seen = []

    async def point(G, per_group, device=None):
        seen.append((G, per_group, device))
        if G == 8 and per_group == 3:
            raise bench.BenchError("a short ledger")
        return {f"groups{G}_{s}": 1.0 for s in GROUPS_POINT_SUFFIXES}

    monkeypatch.setattr(bench, "_bench_groups_cluster", point)
    monkeypatch.setenv("MINBFT_BENCH_GROUPS_RUNS", "2")
    out = bench.bench_groups(5, device="cpu")
    assert [g for g, _, _ in seen] == [1, 1, 2, 2, 4, 4, 8, 8, 16, 16]
    assert {p for _, p, _ in seen} == {5} and {d for _, _, d in seen} == {"cpu"}
    assert out["groups_sweep_Gs"] == [1, 2, 4, 8, 16]
    assert out["groups_sweep_per_group_requests"] == 5
    for G in (1, 2, 4, 8, 16):
        assert {f"groups{G}_{s}" for s in GROUPS_POINT_SUFFIXES} <= set(out)
        assert out[f"groups{G}_req_per_sec_runs"] == [1.0, 1.0]
        assert out[f"groups{G}_req_per_sec_stddev"] == 0.0
    with pytest.raises(bench.BenchError):  # the port's rule: a failed point fails
        bench.bench_groups(3, device="cpu")


def test_load_section_on_a_cpu_engine_emits_the_reference_keys(monkeypatch):
    """``bench_load`` for real at a tiny size (20 requests a point, 20
    clients, a probe at 40/s; the replicas' MACs and UIs through the plain
    K6 of one CPU engine)."""
    monkeypatch.setenv("MINBFT_LOAD_REQUESTS", "20")
    monkeypatch.setenv("MINBFT_LOAD_CLIENTS", "20")
    monkeypatch.setenv("MINBFT_LOAD_PROBE_RATE", "40")
    out = bench.bench_load(device="cpu")
    assert LOAD_KEYS <= set(out)
    assert out["load_requests_per_point"] == 20 and out["load_clients"] == 20
    assert all(out[f"load_{t}_census_ok"] for t in ("half", "sat", "over"))
    assert all(out[f"load_{t}_dispatch_timeouts"] == 0 for t in ("probe", "half", "sat", "over"))


def test_load_section_fails_on_a_census_that_is_not_the_seeds(monkeypatch):
    import minbft_tpu_torch.loadgen.runner as runner

    async def unfaithful(spec, **kw):
        return {"census_ok": False, "census": {}, "engine": {"verify": {}, "sign": {}}}

    monkeypatch.setattr(runner, "run_local_load", unfaithful)
    with pytest.raises(bench.BenchError, match="census"):
        bench.bench_load(device="cpu")


def test_main_runs_the_groups_and_load_sections_named(monkeypatch):
    ran = []
    monkeypatch.setattr(bench, "bench_groups", lambda n, device: (
        ran.append(("groups", n, str(device))) or {"groups1_n": 4}))
    monkeypatch.setattr(bench, "bench_load", lambda device: (
        ran.append(("load", str(device))) or {"load_seed": 1}))
    monkeypatch.delenv("MINBFT_BENCH_GROUPS_REQUESTS", raising=False)
    assert bench.main(["--device", "cpu", "load", "groups"]) == 0
    assert ran == [("groups", 8, "cpu"), ("load", "cpu")]
    monkeypatch.setenv("MINBFT_BENCH_GROUPS_REQUESTS", "3")
    ran.clear()
    assert bench.main(["--device", "cpu", "groups"]) == 0
    assert ran == [("groups", 3, "cpu")]
