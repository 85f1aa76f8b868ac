"""Crash-recovery soak over a REAL ``peer run`` process cluster (the
port's copy of :mod:`minbft_tpu.testing.recovery_soak`, same acceptance
checks).

The recovery subsystem's whole claim is about surviving SIGKILL — so its
acceptance harness runs actual OS processes, not an in-process cluster:
scaffold a testnet, run every replica with a durable ``--state-dir``
(and optionally under the seeded chaos wrap), drive pipelined client
load, ``kill -9`` one replica MID-LOAD, restart it against the same
store, and read the recovery clock off the restarted replica's own
``minbft_recovery_*`` Prometheus families.

What one soak run proves (``run_recovery_soak`` raises on any miss):

- **Zero committed loss** — every request the bench fired commits;
  a kill/restart cycle may slow the cluster, never un-commit it.
- **Durable restore happened** — the restarted replica reports
  ``minbft_recovery_restored_count`` (it resumed from its store, not a
  cold state fetch) and a finite ``minbft_recovery_time_ms``.
- **Store invariants** — every surviving store file decodes, its f+1
  certificate is structurally valid, and its snapshot recomputes to the
  certified digest (:class:`~minbft_tpu_torch.testing.invariants.RecoveryInvariantChecker`).
- **Census honesty** (chaos mode) — each replica's live injected-fault
  census equals the count replayed from the seed and its recorded
  per-link frame totals alone: the faults the soak survived were
  exactly the deterministic schedule, no more, no fewer.

The device seam: ``device`` ("cuda:0" by default) is the engine of every
replica process and of the ``peer bench`` client process, so on the card
the restarted replica opens a CUDA context and loads its kernels again
before it serves; ``None`` runs them all ``--no-batch`` (host crypto, the
reference's form).  Three report fields beyond the reference's:
``restart_to_listen_ms`` (restart to the replica's port bound: the
interpreter, the CUDA context and the engine, which
``minbft_recovery_time_ms`` leaves out because the replica arms its clock
only after its engine is built), ``drain_margin_ms`` (the load left after
the restarted replica's first execution was seen: how far ``requests``
outlived the outage and the catch-up) and ``engines`` (each process's
engine report, read after a clean SIGTERM stop).

The report dict feeds the bench's ``chaos_recovery_*`` keys, which
``tools/benchgate`` gates (recovery-time on INCREASE, under-recovery
goodput on DROP).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from .faultnet import SEEDED_KINDS, FaultNet, plan_from_spec
from .invariants import InvariantViolation, RecoveryInvariantChecker

#: Default chaos plan for the pinned soak: mild loss + delay so the
#: transfer/catch-up paths see real adversity without severing the
#: cluster (the soak asserts 100% commit).
DEFAULT_SOAK_PLAN = "drop=0.01,delay=0.05,duplicate=0.01"

#: Seconds the soak keeps reading the restarted replica's clock after the
#: bench has exited: a replica still replaying the peers' logs may yet
#: execute; past this the load has drained and its clock can never stop.
DRAIN_GRACE_S = 10.0

#: Seconds each replica may take to exit after SIGTERM (its engine's last
#: dispatch) at the clean stop that prints its engine report.
STOP_TIMEOUT_S = 60.0


def _peer_cmd(workdir: str, *tail: str) -> list:
    return [
        sys.executable, "-m", "minbft_tpu_torch.sample.peer",
        "--keys", f"{workdir}/keys.yaml",
        "--config", f"{workdir}/consensus.yaml",
        "--transport", "tcp", *tail,
    ]


def _metrics_port(log_path: str, offset: int, timeout: float) -> int:
    """Parse the ``--metrics-port 0`` announcement from a replica's
    stderr log, reading only bytes past ``offset`` (a restarted replica
    appends a SECOND announcement to the same file)."""
    import re

    deadline = time.time() + timeout
    while time.time() < deadline:
        with open(log_path, "rb") as fh:
            fh.seek(offset)
            m = re.search(rb"metrics on http://[^:]+:(\d+)/metrics", fh.read())
        if m:
            return int(m.group(1))
        time.sleep(0.25)
    raise AssertionError(f"{log_path} never announced its metrics endpoint")


def _scrape_families(addr: str, timeout: float = 5.0) -> dict:
    from ..obs.prom import parse_exposition, scrape

    return parse_exposition(scrape(addr, timeout=timeout))


def _gauge(fams: dict, name: str) -> Optional[float]:
    fam = fams.get(name)
    if not fam or not fam["samples"]:
        return None
    return next(iter(fam["samples"].values()))


def _census_from_scrape(fams: dict) -> dict:
    """Rebuild (seeded counts, per-link frames) from the faultnet
    exposition families."""
    seeded = {k: 0 for k in SEEDED_KINDS}
    fam = fams.get("minbft_faultnet_injected_total")
    for key, v in (fam["samples"] if fam else {}).items():
        kind = dict(key).get("kind")
        if kind in seeded:
            seeded[kind] = int(v)
    frames: Dict[tuple, int] = {}
    fam = fams.get("minbft_faultnet_frames_total")
    for key, v in (fam["samples"] if fam else {}).items():
        link = dict(key).get("link", "")
        src, _, dst = link.partition(">")
        if src and dst:
            frames[(src, dst)] = int(v)
    return {"seeded": seeded, "frames": frames}


def read_engine_report(log_path: str, offset: int = 0) -> Optional[dict]:
    """The ``replica <id> engine {json}`` report a replica prints at a
    clean stop, from the bytes of its log past ``offset``."""
    with open(log_path, "rb") as fh:
        fh.seek(offset)
        text = fh.read().decode(errors="replace")
    for line in text.splitlines():
        if line.startswith("replica ") and " engine {" in line:
            return json.loads(line.split(" engine ", 1)[1])
    return None


def run_recovery_soak(
    workdir: str,
    *,
    replicas: int = 4,
    requests: int = 200,
    clients: int = 8,
    depth: int = 4,
    kill_target: int = 3,
    checkpoint_period: int = 8,
    chunk_bytes: int = 4096,
    chaos_seed: Optional[int] = None,
    chaos_plan: str = "",
    down_s: float = 1.0,
    bench_timeout_s: float = 420.0,
    device: Optional[str] = "cuda:0",
    budget_s: Optional[float] = None,
) -> dict:
    """Run one kill-9-mid-load recovery soak; returns the report dict.

    Raises AssertionError/InvariantViolation on any acceptance miss —
    the caller (pytest, the bench phase, the smoke) only has to
    propagate.  ``chaos_seed=None`` runs without the network-fault wrap
    (process chaos only); a pinned seed makes the whole fault schedule
    replayable and turns on the census-equality check.

    ``device`` is every process's engine (``--device``): ``cuda:0`` by
    default, ``"cpu"`` for the kernels' plain versions, ``None`` for
    ``--no-batch`` host crypto.  CUDA asked for and absent raises
    ``RuntimeError`` before anything is scaffolded or spawned.

    ``budget_s`` bounds the whole run: every wait takes at most the time
    left, so a wedged soak fails inside it, and a wait that would start
    with none left fails with a message that names the budget (None:
    only each wait's own bound).

    Size ``requests`` so the load OUTLIVES the outage: the recovery
    clock stops at the restarted replica's first executed request.  A
    bench that drains while the replica is still restarting or catching
    up fails the soak, ``DRAIN_GRACE_S`` after the bench exits, with a
    message that says so.  Aim for at least three times the committed
    rate times (``restart_to_listen_ms`` + the catch-up).
    """
    from ..recovery import store_path
    from ..utils.netports import free_base_port, wait_ports
    from .faultnet import ProcessChaos

    t_end = time.monotonic() + budget_s if budget_s is not None else float("inf")

    def within(bound: float) -> float:
        left = t_end - time.monotonic()
        if left <= 0:
            raise AssertionError(f"the soak ran past its {budget_s:.0f} s budget")
        return min(bound, left)

    if device is not None:
        from ..ops import backend

        device = str(backend.resolve_device(device))
        dev_args = ["--device", device]
    else:
        dev_args = ["--no-batch"]

    f = (replicas - 1) // 2
    state_dir = os.path.join(workdir, "state")
    base_port = free_base_port(replicas)

    # The peer subprocesses must import this checkout regardless of the
    # caller's cwd.
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(
        os.environ,
        PYTHONPATH=repo_root
        + os.pathsep
        + os.environ.get("PYTHONPATH", ""),
        CONSENSUS_TIMEOUT_REQUEST="60s",
        CONSENSUS_TIMEOUT_PREPARE="30s",
        CONSENSUS_CHECKPOINT_PERIOD=str(checkpoint_period),
        MINBFT_STATE_DIR=state_dir,
        MINBFT_RECOVERY_CHUNK_BYTES=str(chunk_bytes),
    )
    env.pop("MINBFT_CHAOS_SEED", None)
    env.pop("MINBFT_CHAOS_PLAN", None)
    plan_spec = ""
    if chaos_seed is not None:
        plan_spec = chaos_plan or DEFAULT_SOAK_PLAN
        env["MINBFT_CHAOS_SEED"] = hex(chaos_seed)
        env["MINBFT_CHAOS_PLAN"] = plan_spec

    scaffold = subprocess.run(
        [sys.executable, "-m", "minbft_tpu_torch.sample.peer", "testnet",
         "-n", str(replicas), "-d", workdir, "--base-port", str(base_port),
         "--clients", str(clients), "--usig", "SOFT_ECDSA"],
        env=env, capture_output=True, text=True, timeout=within(120),
    )
    assert scaffold.returncode == 0, scaffold.stderr

    chaos = ProcessChaos()
    logs = []

    def start_replica(i: int):
        log = open(f"{workdir}/replica{i}.log", "ab")
        logs.append(log)
        return subprocess.Popen(
            _peer_cmd(workdir, "run", str(i), *dev_args,
                      "--metrics-port", "0"),
            env=env, stdout=subprocess.DEVNULL, stderr=log,
        )

    report: dict = {
        "requested": 0, "committed": 0, "chaos_seed": chaos_seed,
        "chaos_plan": plan_spec, "device": device,
    }
    bench = None
    bench_out = open(f"{workdir}/bench.out", "wb")
    bench_log = open(f"{workdir}/bench.log", "wb")
    try:
        for i in range(replicas):
            chaos.manage(f"r{i}", lambda i=i: start_replica(i))
        assert wait_ports(
            [base_port + i for i in range(replicas)], timeout=within(180)
        ), "replicas never bound"
        mports = {
            i: _metrics_port(f"{workdir}/replica{i}.log", 0, within(30))
            for i in range(replicas)
        }

        # The bench's stdout goes to a file: its one report line holds
        # every latency and can outgrow a pipe, and a bench blocked on a
        # full pipe would look alive to the drain check below.
        bench = subprocess.Popen(
            _peer_cmd(workdir, "bench", "--clients", str(clients),
                      "--requests", str(requests), "--depth", str(depth),
                      "--tag", "soak", *dev_args),
            env=env, stdout=bench_out, stderr=bench_log,
        )

        # Kill only once the target has something durable to lose: its
        # store file exists after the first stable checkpoint persists.
        target_store = store_path(state_dir, kill_target)
        deadline = time.time() + within(120)
        while time.time() < deadline and not os.path.exists(target_store):
            assert bench.poll() is None, "bench finished before any " \
                "stable checkpoint persisted — raise requests or lower " \
                "checkpoint_period"
            time.sleep(0.25)
        assert os.path.exists(target_store), (
            f"replica {kill_target} never persisted a stable checkpoint"
        )

        # THE event: SIGKILL mid-load, a short outage, restart against
        # the same store.  The restarted replica must restore, catch up,
        # and execute again — its own metrics are the recovery clock.
        target_log = f"{workdir}/replica{kill_target}.log"
        log_off = os.path.getsize(target_log)
        t_kill = time.monotonic()
        chaos.kill(f"r{kill_target}")
        time.sleep(down_s)
        t_restart = time.monotonic()
        chaos.restart(f"r{kill_target}")
        # wait_ports polls every ~0.5 s: the resolution of this time.
        assert wait_ports(
            [base_port + kill_target], timeout=within(180)
        ), "restarted replica never bound"
        report["restart_to_listen_ms"] = round(
            (time.monotonic() - t_restart) * 1e3, 2
        )
        mports[kill_target] = _metrics_port(target_log, log_off, within(30))

        addr = f"127.0.0.1:{mports[kill_target]}"
        restored = recovery_ms = drained_at = None
        deadline = time.time() + within(180)
        while time.time() < deadline:
            if drained_at is None and bench.poll() is not None:
                drained_at = time.monotonic()
            if drained_at is not None and time.monotonic() - drained_at > DRAIN_GRACE_S:
                break
            try:
                fams = _scrape_families(addr)
            except OSError:
                time.sleep(0.5)
                continue
            restored = _gauge(fams, "minbft_recovery_restored_count")
            recovery_ms = _gauge(fams, "minbft_recovery_time_ms")
            if recovery_ms is not None:
                break
            time.sleep(0.5)
        assert restored is not None, (
            "restarted replica never reported minbft_recovery_restored_count "
            "— it did not restore from its durable store"
        )
        assert recovery_ms is not None or drained_at is None, (
            f"the load drained before replica {kill_target} caught up: the "
            f"bench exited {(drained_at or 0.0) - t_restart:.1f} s after "
            f"the restart (restart to listen "
            f"{report['restart_to_listen_ms']:.0f} ms) and the replica "
            "executed no request after it — raise requests"
        )
        assert recovery_ms is not None, (
            "restarted replica never reported minbft_recovery_time_ms — "
            "it restored but never executed again (catch-up wedged)"
        )
        report["restored_count"] = int(restored)
        report["chaos_recovery_time_ms"] = round(float(recovery_ms), 2)
        t_seen = time.monotonic()
        report["wall_recovery_ms"] = round((t_seen - t_kill) * 1e3, 2)

        # Zero committed loss: the bench awaits EVERY request — a clean
        # exit with committed == requested is the loss proof.
        bench.wait(timeout=within(bench_timeout_s))
        # Negative: the bench had exited before the scrape saw the first
        # execution (within DRAIN_GRACE_S; at 0.5 s resolution).
        report["drain_margin_ms"] = round(
            ((drained_at or time.monotonic()) - t_seen) * 1e3, 2
        )
        assert bench.returncode == 0, "bench failed (request lost or wedged)"
        with open(f"{workdir}/bench.out") as fh:
            stats = json.loads(fh.read().strip().splitlines()[-1])
        report["requested"] = (max(requests // clients, 1)) * clients
        report["committed"] = stats["committed"]
        assert stats["committed"] == report["requested"], (
            f"committed {stats['committed']} != requested "
            f"{report['requested']}: a committed request was lost"
        )
        report["chaos_recovery_goodput_per_sec"] = stats["req_per_sec"]

        # Durable-store invariants across every replica that persisted.
        checker = RecoveryInvariantChecker(f)
        report["stores"] = checker.check_all(
            {i: store_path(state_dir, i) for i in range(replicas)}
        )
        if kill_target not in report["stores"]:
            raise InvariantViolation(
                f"replica {kill_target}'s durable store vanished after "
                "the kill/restart cycle"
            )

        # Census equality (chaos mode): the live per-replica census must
        # equal the seed-replay over its recorded frame counts.  Scrape
        # until quiescent (two identical reads) — the census mutates
        # while checkpoint traffic drains.
        if chaos_seed is not None:
            replayer = FaultNet(
                seed=chaos_seed, default_plan=plan_from_spec(plan_spec)
            )
            census_ok = {}
            for i in range(replicas):
                a = f"127.0.0.1:{mports[i]}"
                prev = None
                deadline = time.time() + within(60)
                while time.time() < deadline:
                    cur = _census_from_scrape(_scrape_families(a))
                    if prev == cur:
                        break
                    prev = cur
                    time.sleep(1.0)
                replayed = replayer.replay_counts(prev["frames"])
                assert prev["seeded"] == replayed, (
                    f"replica {i}: live census {prev['seeded']} != "
                    f"seed-replayed {replayed} "
                    f"(seed {chaos_seed:#x}, plan {plan_spec})"
                )
                census_ok[i] = prev["seeded"]
            report["census"] = census_ok

        # Clean stop: each replica prints its engine report at SIGTERM
        # (the restarted one from its second instance, past log_off).
        for i in range(replicas):
            chaos.proc(f"r{i}").terminate()
        for i in range(replicas):
            try:
                rc = chaos.proc(f"r{i}").wait(timeout=within(STOP_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"replica {i} still running {STOP_TIMEOUT_S:.0f} s "
                    "after SIGTERM"
                ) from None
            assert rc == 0, f"replica {i} exited {rc} after SIGTERM"
        if device is not None:
            engines: dict = {}
            for i in range(replicas):
                rep = read_engine_report(
                    f"{workdir}/replica{i}.log",
                    log_off if i == kill_target else 0,
                )
                assert rep is not None, f"replica {i} printed no engine report"
                engines[i] = rep
            engines["client"] = stats["engine"]
            report["engines"] = engines
        return report
    finally:
        if bench is not None and bench.poll() is None:
            bench.kill()
        chaos.terminate_all()
        for log in logs + [bench_out, bench_log]:
            log.close()
