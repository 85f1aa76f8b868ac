"""peer — run a replica or submit requests from the command line.

Port of :mod:`minbft_tpu.sample.peer.cli` (reference sample/peer):
``peer run <id>`` loads the keystore + consensus config, assembles the
stack (authenticator, ledger, TCP or gRPC connector), and serves
(run.go:91-159); ``peer request <args…>`` is the client-side equivalent,
reading operations from argv or stdin (request.go:87-134); flags layer
over ``PEER_*`` environment variables (root.go:73-82) and a per-node
``peer.yaml``.

    # shared flags (--keys/--config/--auth/--transport) go BEFORE the
    # subcommand; per-subcommand flags (--listen/--batch/--device) after:
    python -m minbft_tpu_torch.sample.peer testnet -n 4 -d net/ --usig NATIVE_ECDSA
    python -m minbft_tpu_torch.sample.peer --keys net/keys.yaml \\
        --config net/consensus.yaml --transport tcp run 0
    python -m minbft_tpu_torch.sample.peer ... request "op"
    python -m minbft_tpu_torch.sample.peer ... bench --clients 20 --depth 24
    python -m minbft_tpu_torch.sample.peer selftest   # in-process n=4 smoke test
    python -m minbft_tpu_torch.sample.peer load --rate 200 --duration 5
    python -m minbft_tpu_torch.sample.peer testnet -n 4 -d net/ --groups 4

Device rule (``run``, ``request``, ``bench``, ``selftest`` and ``load``):
each process owns one
:class:`~minbft_tpu_torch.parallel.BatchVerifier` on ``--device``
(default ``cuda:0``), which checks every signature, MAC and USIG
certificate on the card (K2, K6) and makes the process's own
REQUEST/REPLY signatures (K3).  ``--device cpu`` runs the kernels' plain
PyTorch versions; ``--no-batch`` asks for the reference's serial host
crypto.  Without CUDA, and with neither of those flags, the process exits
non-zero: nothing falls back to the host on its own.  The reference's CLI
clients sign and verify on the host; the port's use the engine.

Observability and chaos, as in the reference: ``run --metrics-port N``
serves the Prometheus exposition (``obs/prom.py``; port 0 picks a free
one and prints it to stderr) with the replica's counters, its engine's
queues, its telemetry rings, its SLO ledger and recovery store and, under
chaos, the fault census; ``peer metrics``, ``peer top`` and ``peer slo``
read such endpoints.  ``MINBFT_CHAOS_SEED`` (with ``MINBFT_CHAOS_PLAN``,
a profile name or inline probabilities, default ``lossy``) sends a
replica's outbound peer traffic through the seeded fault-injection
network (``testing/faultnet.py``), and ``selftest --chaos-seed/
--chaos-profile`` runs the in-process smoke through it.

    python -m minbft_tpu_torch.sample.peer ... run 0 --metrics-port 0
    python -m minbft_tpu_torch.sample.peer metrics 127.0.0.1:9464 127.0.0.1:9465
    python -m minbft_tpu_torch.sample.peer top --once 127.0.0.1:9464

Multi-group consensus (``groups/``): a config with ``protocol.groups``
G > 1 (``testnet --groups G``), or ``run --groups G``, hosts G group cores
in each replica process over one listener and the ONE engine, so every
group's checks coalesce into its batches; ``request`` and ``bench``
route each operation to its group by the hash of its bytes
(``MultiGroupClient``; ``request --group g`` pins one), and ``run
--metrics-port`` labels each group's series.  ``load`` (``loadgen/``)
runs a seeded open-loop schedule against a self-contained local cluster
whose replicas share one engine on ``--device``, and prints one JSON
report line; its exit code is 0 only when the fired census equals the
seed's replay (and any ``--expect-goodput`` / ``--slo-target-ms`` bar is
met).

``--chips`` other than 1 exits non-zero naming the ROADMAP.md item that
will lift it (item 7, ``parallel/pool.py``).

``MINBFT_TRACE_DUMP=base`` turns the flight recorder on: at shutdown a
replica writes its stage dump, its telemetry ring and
``{base}.engine{id}.json`` — the engine's queue histograms, per-queue
items, batches and dispatch timeouts, its device and the kernel launch
counts of the process.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys

from ...api import NotPortedError
from ..envflags import env_default


def _env(name: str, fallback, choices=None):
    return env_default("PEER", name, fallback, choices)


# Per-node options file (reference sample/peer/peer.yaml layered by viper
# under flags/env, root.go:54-82).  Same precedence here:
# flags > PEER_* env vars > options file > built-in defaults.
_PEER_OPTION_SCHEMA = {
    None: {"keys", "config", "log_level", "log_file", "auth", "transport"},
    "run": {"listen", "batch", "metrics_interval", "metrics_port",
            "metrics_host", "groups", "chips", "state_dir", "device"},
    "request": {"client_id", "timeout", "group", "device"},
}


def load_peer_options(path: str, explicit: bool) -> dict:
    """Load and validate a per-node ``peer.yaml``.  A missing DEFAULT path
    is fine (no file, no layering); a missing explicitly-requested one is
    an error.  Unknown keys fail loudly — a typo silently reverting an
    option to its default is how misconfigured replicas limp into
    clusters."""
    if not os.path.exists(path):
        if explicit:
            raise SystemExit(f"peer: options file {path!r} not found")
        return {}
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    if not isinstance(data, dict):
        raise SystemExit(f"peer: options file {path!r} must be a mapping")

    def check_scalar(name: str, v) -> None:
        # str() would happily stringify a YAML list/mapping into a bogus
        # "path" — reject non-scalars here, where the message can say so.
        if isinstance(v, (dict, list)):
            raise SystemExit(
                f"peer: option {name} in {path!r} must be a scalar, "
                f"got {type(v).__name__}"
            )

    for opt, val in data.items():
        if opt in _PEER_OPTION_SCHEMA[None]:
            check_scalar(opt, val)
            continue
        sub = _PEER_OPTION_SCHEMA.get(opt)
        if sub is None:
            raise SystemExit(f"peer: unknown option {opt!r} in {path!r}")
        if not isinstance(val, dict):
            raise SystemExit(
                f"peer: section {opt!r} in {path!r} must be a mapping"
            )
        for sub_opt, v in val.items():
            if sub_opt not in sub:
                raise SystemExit(
                    f"peer: unknown option {opt}.{sub_opt!r} in {path!r}"
                )
            check_scalar(f"{opt}.{sub_opt}", v)
    return data


def peek_options_path(argv=None):
    """Resolve the options-file path BEFORE full parsing (its values feed
    the parser's defaults): --options flag > PEER_OPTIONS env > peer.yaml."""
    argv = list(sys.argv[1:] if argv is None else argv)
    path = os.environ.get("PEER_OPTIONS", "peer.yaml")
    explicit = "PEER_OPTIONS" in os.environ
    for i, a in enumerate(argv):
        if a == "--options" and i + 1 < len(argv):
            path, explicit = argv[i + 1], True
        elif a.startswith("--options="):
            path, explicit = a.split("=", 1)[1], True
    return path, explicit


def build_parser(options: dict | None = None) -> argparse.ArgumentParser:
    options = options or {}

    def _opt(name: str, fallback, section=None, choices=None):
        src = options.get(section) if section else options
        v = (src or {}).get(name, fallback)
        if v is not fallback and v is not None:
            try:
                v = type(fallback)(v)
            except (TypeError, ValueError):
                raise SystemExit(
                    f"peer: invalid options-file value {name}={v!r} "
                    f"(expected {type(fallback).__name__})"
                )
            if choices is not None and v not in choices:
                raise SystemExit(
                    f"peer: invalid options-file value {name}={v!r} "
                    f"(choose from {', '.join(map(str, choices))})"
                )
        elif v is None:
            v = fallback
        return _env(name, v, choices)

    def engine_args(sp, section=None) -> None:
        # The port's device rule (module docstring): the engine's device,
        # or --no-batch for the reference's serial host crypto.
        sp.add_argument(
            "--device",
            default=_opt("device", "cuda:0", section=section),
            help="the engine's device: cuda:N (default cuda:0) or cpu (the "
            "kernels' plain PyTorch versions); without CUDA the process "
            "exits unless --device cpu or --no-batch is given",
        )
        sp.add_argument(
            "--no-batch",
            action="store_true",
            help="no engine: serial host crypto, as the reference's "
            "--no-batch",
        )

    p = argparse.ArgumentParser(prog="peer", description="minbft-tpu peer (PyTorch port)")
    p.add_argument(
        "--options",
        default=peek_options_path()[0],
        help="per-node options file layered under env vars and flags "
        "(default: peer.yaml if present)",
    )
    p.add_argument(
        "--keys", default=_opt("keys", "keys.yaml"), help="keystore path"
    )
    p.add_argument(
        "--config",
        default=_opt("config", "consensus.yaml"),
        help="consensus config path",
    )
    _levels = ("debug", "info", "warning", "error")
    p.add_argument(
        "--log-level",
        default=_opt("log_level", "info", choices=_levels),
        choices=_levels,
    )
    p.add_argument("--log-file", default=_opt("log_file", "") or None)
    _auths = ("signatures", "mac")
    p.add_argument(
        "--auth",
        choices=_auths,
        default=_opt("auth", "signatures", choices=_auths),
        help="message authentication: public-key signatures (default) or "
        "pairwise MACs (keys.yaml needs a macs section: keytool --macs)",
    )
    _transports = ("grpc", "tcp")
    p.add_argument(
        "--transport",
        choices=_transports,
        default=_opt("transport", "grpc", choices=_transports),
        help="wire transport: gRPC bidi streams (default) or the native "
        "length-prefixed TCP framing (lower per-frame cost; same "
        "authenticated protocol above it)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="run a replica")
    r.add_argument("id", type=int, help="replica id")
    r.add_argument(
        "--listen",
        default=_opt("listen", "", section="run"),
        help="listen address (default: this id's addr from the config)",
    )
    r.add_argument(
        "--batch",
        type=int,
        default=_opt("batch", 512, section="run"),
        help="max verification batch per kernel launch (the engine's one "
        "bucket)",
    )
    engine_args(r, section="run")
    r.add_argument(
        "--metrics-interval",
        type=float,
        default=_opt("metrics_interval", 0.0, section="run"),
        help="log the protocol counters every N seconds (0 = off)",
    )
    r.add_argument(
        "--metrics-port",
        type=int,
        default=_opt("metrics_port", -1, section="run"),
        help="serve Prometheus text on this port (0 = pick a free one, "
        "printed to stderr; -1 = off)",
    )
    r.add_argument(
        "--metrics-host",
        default=_opt("metrics_host", "127.0.0.1", section="run"),
        help="bind address for --metrics-port (default loopback: the "
        "endpoint is unauthenticated)",
    )
    r.add_argument(
        "--groups",
        type=int,
        default=_opt("groups", 0, section="run"),
        help="host this many independent consensus groups in one replica "
        "process over shared transport and the one engine (groups/).  0 "
        "(default) = the config's protocol.groups value; 1 = the plain "
        "ungrouped runtime.  Must be identical cluster-wide.",
    )
    r.add_argument(
        "--chips",
        type=int,
        default=_opt("chips", 1, section="run"),
        help="home chips of the multi-device engine pool: only 1 (the "
        "default, the one engine) is ported; any other value exits",
    )
    r.add_argument(
        "--peer-idle-timeout",
        type=float,
        default=_opt("peer_idle_timeout", 0.0, section="run"),
        help="TCP transport only: tear down a peer stream that delivers "
        "no frame for N seconds (a half-open link), so the redial loop "
        "can recover it; 0 = off (default)",
    )
    r.add_argument(
        "--state-dir",
        default=_opt("state_dir", "", section="run"),
        help="durable crash-recovery store directory (recovery/): every "
        "stable checkpoint is persisted atomically and reloaded at "
        "startup.  MINBFT_STATE_DIR is the env equivalent; empty "
        "(default) = no durability.  A corrupted committed store file is "
        "FATAL at startup (exit code 4).",
    )

    m = sub.add_parser(
        "metrics",
        help="one-shot Prometheus scrape of replica --metrics-port "
        "endpoints (one target: prints the exposition text; several: "
        "per-target sections plus ONE merged cluster aggregate — the "
        "log2 histograms merge exactly, counters sum)",
    )
    m.add_argument(
        "addr",
        nargs="+",
        help="host:port (or full URL) of each replica's metrics endpoint",
    )
    m.add_argument("--timeout", type=float, default=5.0)
    m.add_argument(
        "--merged-only",
        action="store_true",
        help="with several targets: print only the merged cluster "
        "aggregate, not the per-target sections",
    )

    tp = sub.add_parser(
        "top",
        help="live cluster console: watch replica --metrics-port "
        "endpoints and render per-replica req/s, batch fill, device "
        "utilization, queue depth, loop lag, view, and health flags "
        "(commit stall / stale group).  Watch mode diffs consecutive "
        "scrapes; --once renders a single frame from the "
        "minbft_window_* gauges (CI-friendly).",
    )
    tp.add_argument(
        "addr",
        nargs="+",
        help="host:port (or full URL) of each replica's metrics endpoint",
    )
    tp.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh period in watch mode (seconds)",
    )
    tp.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (rc=1 if any target is down)",
    )
    tp.add_argument("--timeout", type=float, default=5.0)
    tp.add_argument(
        "--no-clear", action="store_true",
        help="append frames instead of clearing the screen",
    )
    tp.add_argument(
        "--stall-flag", action="store_true",
        help="exit 3 when any replica reports a commit stall, a stale "
        "group, or a fast-window SLO burn at/over its threshold "
        "(alerting hook for scripts)",
    )

    sl = sub.add_parser(
        "slo",
        help="one-shot latency-SLO report from replica --metrics-port "
        "endpoints: per-group good/breached counts, remaining error "
        "budget, fast/slow burn rates, and breach-dump spool counters; "
        "--dumps additionally reads a trace-dump file set and prints the "
        "per-segment breach attribution",
    )
    sl.add_argument(
        "addr", nargs="+",
        help="host:port (or full URL) of each replica's metrics endpoint",
    )
    sl.add_argument("--timeout", type=float, default=5.0)
    sl.add_argument(
        "--json", action="store_true",
        help="machine-readable JSON instead of the table",
    )
    sl.add_argument(
        "--dumps", default="",
        help="MINBFT_TRACE_DUMP base path: load {base}.*.json and "
        "append the breach attribution (policy from MINBFT_SLO_* env)",
    )
    sl.add_argument(
        "--breach-flag", action="store_true",
        help="exit 3 when any group's fast-window burn is at/over its "
        "threshold (alerting hook for scripts)",
    )

    q = sub.add_parser("request", help="submit request(s) as a client")
    q.add_argument("ops", nargs="*", help="operations (default: stdin lines)")
    q.add_argument(
        "--client-id", type=int, default=_opt("client_id", 0, section="request")
    )
    q.add_argument(
        "--timeout", type=float, default=_opt("timeout", 30.0, section="request")
    )
    q.add_argument(
        "--group",
        type=int,
        default=_opt("group", -1, section="request"),
        help="pin requests to this consensus group instead of routing by "
        "the shard hash of the operation bytes (multi-group clusters; "
        "-1 = route by key).  The group count comes from the config's "
        "protocol.groups.",
    )
    q.add_argument(
        "--read-only",
        action="store_true",
        help="read from committed state: fast path on all-n agreement, "
        "ordered-read fallback otherwise (mutates nothing either way)",
    )
    q.add_argument(
        "--no-read-fallback",
        action="store_true",
        help="with --read-only: fail instead of falling back to an "
        "ordered read when the all-n fast quorum cannot form",
    )
    engine_args(q, section="request")

    ld = sub.add_parser(
        "load",
        help="open-loop load run against a self-contained local cluster "
        "(loadgen/): seeded arrival schedule at a FIXED offered rate over "
        "real loopback TCP, latency measured from scheduled arrival time, "
        "the replicas' checks on one engine on --device, one JSON report "
        "line",
    )
    ld.add_argument(
        "--rate", type=float, default=200.0,
        help="offered arrivals/sec (time-averaged for --process onoff)",
    )
    ld.add_argument("--duration", type=float, default=5.0, help="seconds")
    ld.add_argument(
        "--seed", type=lambda s: int(s, 0), default=1,
        help="schedule seed (same seed = byte-identical schedule)",
    )
    ld.add_argument(
        "--process", choices=("poisson", "onoff"), default="poisson",
        help="arrival process: memoryless (default) or bursty on/off",
    )
    ld.add_argument(
        "--clients", type=int, default=1000,
        help="distinct client identities (own keys + seq spaces)",
    )
    ld.add_argument(
        "--conns", type=int, default=4,
        help="connection-pool slots; total sockets = slots x replicas",
    )
    ld.add_argument(
        "--replicas", type=int, default=4, help="cluster size (f=(n-1)//3)"
    )
    ld.add_argument(
        "--groups", type=int, default=1,
        help="consensus groups (arrivals shard-routed by client key)",
    )
    ld.add_argument(
        "--read-fraction", type=float, default=0.0,
        help="fraction of arrivals on the read-only fast path",
    )
    ld.add_argument(
        "--large-fraction", type=float, default=0.0,
        help="fraction of arrivals carrying the large payload class",
    )
    ld.add_argument(
        "--scheme", choices=("mac", "ecdsa-p256"), default="mac",
        help="request auth: pairwise MACs (default — measures the "
        "ingest/admission path, not host public-key crypto) or ECDSA",
    )
    ld.add_argument(
        "--expect-goodput", type=float, default=0.0,
        help="rc=1 unless goodput_per_sec reaches this (CI gate); with "
        "0 (default) rc gates only on schedule faithfulness (census)",
    )
    ld.add_argument(
        "--drain", type=float, default=10.0,
        help="seconds past the last arrival to wait for stragglers",
    )
    ld.add_argument(
        "--slo-target-ms", type=float, default=0.0,
        help="finality-SLO bar: rc=1 unless the fraction "
        "of fired requests committing inside this budget reaches the "
        "objective (MINBFT_SLO_OBJECTIVE, default 0.99); 0 (default) = "
        "no SLO leg in the rc contract",
    )
    engine_args(ld)

    b = sub.add_parser(
        "bench",
        help="drive pipelined no-op requests from many clients and print "
        "one JSON line of throughput/latency stats (the multi-process "
        "bench's client process)",
    )
    b.add_argument("--clients", type=int, default=16, help="clients in this process")
    b.add_argument("--client-base", type=int, default=0, help="first client id")
    b.add_argument("--requests", type=int, default=1000, help="total across clients")
    b.add_argument("--depth", type=int, default=8, help="pipelined requests per client")
    b.add_argument("--timeout", type=float, default=240.0, help="per-request deadline")
    b.add_argument(
        "--read-only",
        action="store_true",
        help="drive read-only fast reads instead of ordered writes "
        "(one seed write, then reads — measures the no-consensus path)",
    )
    b.add_argument(
        "--tag", default="", help="payload tag (keeps concurrent procs' ops distinct)"
    )
    engine_args(b)

    st = sub.add_parser("selftest", help="in-process n=4 cluster smoke test")
    st.add_argument(
        "--chaos-seed",
        type=lambda s: int(s, 0),
        default=None,
        metavar="SEED",
        help="run the smoke workload through a seeded fault-injection "
        "network (testing/faultnet.py); MINBFT_CHAOS_SEED overrides, "
        "omitted = fresh random seed (printed for replay)",
    )
    st.add_argument(
        "--chaos-profile",
        choices=("lossy", "flaky", "slow"),
        default=None,
        help="fault plan applied to every link (default with --chaos-seed: "
        "lossy); implies chaos mode",
    )
    engine_args(st)

    t = sub.add_parser(
        "testnet", help="scaffold keys.yaml + consensus.yaml for a local cluster"
    )
    t.add_argument("-n", "--replicas", type=int, default=3)
    t.add_argument("-f", "--faults", type=int, default=None, help="default (n-1)//2")
    t.add_argument("--clients", type=int, default=1)
    t.add_argument("--base-port", type=int, default=42600)
    t.add_argument("--host", default="127.0.0.1")
    t.add_argument("-d", "--dir", default=".", help="output directory")
    t.add_argument(
        "--usig",
        choices=("auto", "NATIVE_ECDSA", "SOFT_ECDSA", "HMAC_SHA256"),
        default="auto",
    )
    t.add_argument(
        "--macs", action="store_true",
        default=bool(_env("macs", 0)),
        help="include pairwise-MAC material (enables run/request --auth mac)",
    )
    t.add_argument(
        "--groups", type=int, default=1,
        help="declare this many consensus groups in consensus.yaml "
        "(protocol.groups; `peer run` hosts them all per replica)",
    )
    return p


def _log_opts(args):
    from ...core.options import with_log_file, with_log_level

    opts = [with_log_level(getattr(logging, args.log_level.upper()))]
    if args.log_file:
        opts.append(with_log_file(args.log_file))
    return opts


def _engine_device(args):
    """The engine's device under the device rule (module docstring): None
    with ``--no-batch``, else ``--device``; CUDA asked for and absent
    exits non-zero."""
    if args.no_batch:
        return None
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"peer: --device {args.device} but torch.cuda.is_available() is "
            "False: pass --device cpu for the kernels' plain versions or "
            "--no-batch for serial host crypto"
        )
    return device


def _make_engine(args, max_batch: int, buckets=None):
    """The process's engine on :func:`_engine_device` (None with
    ``--no-batch``)."""
    device = _engine_device(args)
    if device is None:
        return None
    from ...parallel import BatchVerifier

    # On the CPU the sign queue runs the plain k*G too, so --device cpu
    # is the kernels' plain versions end to end.
    return BatchVerifier(
        max_batch=max_batch,
        buckets=buckets,
        device=device,
        sign_on_device=True if device.type == "cpu" else None,
    )


def engine_report(engine) -> dict:
    """What an engine did: its device, per queue the items, batches and
    dispatch timeouts (and host-signed items), the process's kernel
    launch counts (every engine of the process shares them), whether the
    process initialised CUDA (so holds a context on the card) and, on the
    card, the MiB its PyTorch allocator holds there (the CUDA context's
    own memory is not in it)."""
    import torch

    from ...ops import ed25519, hmac_sha256, p256

    wrappers = {
        "K2": p256.ecdsa_verify_kernel_packed,
        "K3": p256.ecdsa_kg_kernel,
        "K6": hmac_sha256.hmac_verify_kernel_packed,
        "K7": ed25519.ed25519_verify_kernel_packed,
        "K8": ed25519.ed25519_rb_kernel,
    }
    reserved = (torch.cuda.memory_reserved(engine.device) / 2**20
                if engine.device.type == "cuda" else 0.0)
    return {
        "device": str(engine.device),
        "cuda_context": torch.cuda.is_initialized(),
        "cuda_reserved_mib": reserved,
        "launches": {kid: w.launches for kid, w in wrappers.items()},
        "verify": {
            name: {"items": st.items, "batches": st.batches,
                   "dispatch_timeouts": st.dispatch_timeouts}
            for name, st in engine.stats.items()
        },
        "sign": {
            name: {"items": st.items, "batches": st.batches,
                   "dispatch_timeouts": st.dispatch_timeouts,
                   "host_fallback_items": st.host_fallback_items}
            for name, st in engine.sign_stats.items()
        },
    }


async def _run_replica(args) -> int:
    from ...core import new_replica
    from ...sample.authentication import KeyStore
    from ...sample.config import load_config

    if args.transport == "tcp":
        from ...sample.conn.tcp import (
            TcpReplicaConnector as GrpcReplicaConnector,
        )
        from ...sample.conn.tcp import TcpReplicaServer as ReplicaServer
    else:
        from ...sample.conn.grpc import GrpcReplicaConnector, ReplicaServer
    from ...sample.requestconsumer import SimpleLedger

    store = KeyStore.load(args.keys)
    cfg = load_config(args.config)
    if args.chips != 1:
        raise NotPortedError(f"--chips {args.chips} (parallel/pool.py)", "7")
    addrs = {p.id: p.addr for p in cfg.peers}
    if args.id not in addrs:
        raise SystemExit(f"peer: replica {args.id} not in {args.config} peers[]")

    # Eager tasks (3.12+): most protocol tasks complete without suspending
    # (memo hits, buffered sends) — running them synchronously at spawn
    # cuts event-loop scheduling overhead (same setting as the in-process
    # bench cluster).
    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)

    # One engine for this replica, one bucket (the reference's rule for
    # its device engine); the kernels build (or load from build/torch_ext/)
    # here, before the replica serves.
    engine = _make_engine(args, args.batch, buckets=(args.batch,))

    def make_auth():
        # One call = one authenticator instance = one fresh USIG epoch
        # (the keystore restores the sealed key per call), so construct
        # exactly as many as the runtime needs: one ungrouped, or one per
        # group below.  Every one checks and signs through ``engine``.
        if args.auth == "mac":
            return store.mac_replica_authenticator(args.id, engine=engine)
        return store.replica_authenticator(args.id, engine=engine)

    if args.transport == "tcp":
        # Half-open peer detection (read-idle teardown) is a property of
        # the native framing only; gRPC manages its own channel health.
        conn = GrpcReplicaConnector(
            "peer", idle_timeout=args.peer_idle_timeout
        )
    else:
        conn = GrpcReplicaConnector("peer")
    for rid, addr in addrs.items():
        if rid != args.id:
            conn.connect_replica(rid, addr)

    # Env-gated chaos wrap (MINBFT_CHAOS_SEED): this replica's OUTBOUND
    # peer traffic flows through the seeded fault-injection network.
    # Sender-side injection covers every directed link when all replicas
    # run with the seed (each owns its outgoing edges); the census rides
    # the /metrics exposition so a soak can check it against the replay
    # of the seed.  MINBFT_CHAOS_PLAN names a profile ("lossy") or inline
    # probabilities ("drop=0.02,reset=0.01").
    chaos_net = None
    if os.environ.get("MINBFT_CHAOS_SEED"):
        from ...testing import FaultNet, chaos_seed, plan_from_spec

        run_chaos_seed = chaos_seed()
        plan_spec = os.environ.get("MINBFT_CHAOS_PLAN", "lossy")
        chaos_net = FaultNet(
            seed=run_chaos_seed, default_plan=plan_from_spec(plan_spec)
        )
        conn = chaos_net.wrap(conn, f"r{args.id}")
        print(
            f"replica {args.id} chaos: seed={run_chaos_seed:#x} "
            f"plan={plan_spec} (outbound links)",
            file=sys.stderr,
        )

    # Durable crash-recovery store (recovery/): flag wins, then
    # MINBFT_STATE_DIR; empty = no durability.
    from ...recovery import CorruptStoreError, state_dir_from_env

    state_dir = getattr(args, "state_dir", "") or state_dir_from_env()

    n_groups = args.groups if args.groups > 0 else getattr(cfg, "groups", 1)
    grouped = n_groups > 1
    if grouped:
        # Multi-group runtime: G independent group cores over this one
        # listener and peer connection set, every core's verify and sign
        # traffic coalescing in the ONE engine above.  Each group needs its
        # own authenticator instance (its own USIG counter space);
        # GroupAuthenticator domain separation rides inside the runtime.
        from ...core.options import resolve as resolve_options
        from ...groups import new_group_runtime

        # Same log options as the ungrouped path: resolve() materialises
        # the minbft.replica{id} logger with its one owned handler, and
        # every group core's child logger (minbft.replica{id}.g{g})
        # delivers into it by propagation.
        ropts = resolve_options(args.id, _log_opts(args))
        ledgers = [SimpleLedger() for _ in range(n_groups)]
        replica = new_group_runtime(
            args.id, cfg, [make_auth() for _ in range(n_groups)], conn, ledgers,
            logger=ropts.logger, state_dir=state_dir or None,
        )
    else:
        ledgers = [SimpleLedger()]
        replica = new_replica(
            args.id, cfg, make_auth(), conn, ledgers[0], opts=_log_opts(args),
            state_dir=state_dir or None,
        )
    server = ReplicaServer(replica)
    listen = args.listen or addrs[args.id]
    bound = await server.start(listen)
    print(
        f"replica {args.id} serving on {bound} "
        f"(engine: {engine.device if engine is not None else 'none, host crypto'}"
        f"{f'; {n_groups} groups' if grouped else ''})",
        file=sys.stderr,
    )
    try:
        await replica.start()
    except CorruptStoreError as e:
        # A committed store file that fails its own integrity or
        # certificate check is a hard startup refusal, not a warning.
        print(
            f"peer: FATAL: replica {args.id} durable state store is "
            f"corrupt — refusing to serve: {e}\n"
            f"peer: clear or restore the --state-dir contents to recover",
            file=sys.stderr,
        )
        await server.stop()
        await conn.close()
        return 4

    from ...obs import trace as obs_trace

    # Engine dispatcher spans are exported by the MINBFT_TRACE_DUMP
    # shutdown dump, so recording is gated on exactly that knob.
    dump_base = os.environ.get(obs_trace.TRACE_DUMP_ENV)
    if engine is not None and dump_base:
        engine.enable_obs_ring()

    # Latency-SLO ledger (obs/slo.py): the Handlers built their own
    # BudgetLedger when the policy is enabled (MINBFT_SLO_* env or the
    # config's protocol.slo block).
    from ...obs import slo as obs_slo

    _handler_list = (
        [c.handlers for c in replica.cores] if grouped else [replica.handlers]
    )
    slo_ledgers = [
        h.slo for h in _handler_list if getattr(h, "slo", None) is not None
    ]
    slo_spool = obs_slo.BreachSpool.from_env() if slo_ledgers else None

    # Telemetry rings (obs/timeseries.py): sampled whenever anyone can
    # read them — the Prometheus endpoint (minbft_window_* gauges feed
    # `peer top --once`) or the trace-dump surface ({base}.rN.ts.json);
    # without either the sampler stays off.
    tseries = sampler = None
    if args.metrics_port >= 0 or dump_base:
        from ...obs import timeseries as obs_ts

        tseries = obs_ts.TimeSeries()
        sampler = obs_ts.CounterSampler(tseries)
        if grouped:
            for core in replica.cores:
                obs_ts.register_replica_series(
                    sampler, core.metrics, group=core.group
                )
        else:
            obs_ts.register_replica_series(sampler, replica.metrics)
        if engine is not None:
            # once per engine: the grouped cores share it
            obs_ts.register_engine_series(sampler, engine)
        for lg in slo_ledgers:
            obs_slo.register_slo_series(sampler, lg)

    metrics_server = None
    if args.metrics_port >= 0:
        from ...obs import prom as obs_prom

        def render() -> str:
            # Called on the server's thread: it only reads.  A grouped
            # runtime gives one family block per metric with samples
            # labelled per group, and the shared engine's families once.
            if grouped:
                fams = obs_prom.collect_group_runtime(
                    replica,
                    engine=engine,
                    replica_id=args.id,
                    timeseries=tseries,
                    slo_spool=slo_spool,
                )
            else:
                fams = obs_prom.collect_replica(
                    metrics=replica.metrics,
                    recorder=replica.handlers.trace,
                    engine=engine,
                    replica_id=args.id,
                    timeseries=tseries,
                    slo=slo_ledgers[0] if slo_ledgers else None,
                    slo_spool=slo_spool,
                    recovery=getattr(replica, "recovery", None),
                )
            if chaos_net is not None:
                fams.extend(obs_prom.collect_faultnet(
                    chaos_net.census, base={"replica": str(args.id)}
                ))
            return obs_prom.render_families(fams)

        metrics_server = obs_prom.MetricsServer(
            render, host=args.metrics_host, port=args.metrics_port
        )
        mport = metrics_server.start()
        print(
            f"replica {args.id} metrics on "
            f"http://{args.metrics_host}:{mport}/metrics",
            file=sys.stderr,
        )

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    # SIGINT and SIGTERM both route through the clean-stop path, so the
    # flight-recorder dump fires on ctrl-C exactly as on a managed stop.
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-Unix
            pass

    def dump_engine_obs() -> None:
        # Engine dispatcher spans + queue-wait histograms ride the
        # shutdown dump alongside the replica's stage dump; the port adds
        # the engine's report (device, per-queue counts, launches).
        if engine is None or not dump_base:
            return
        import json as _json

        from ...obs import critpath as obs_critpath

        doc = obs_critpath.engine_queue_doc(engine, ident=args.id)
        doc["engine"] = engine_report(engine)
        events = engine.drain_obs_events()
        if events:
            doc["events"] = [list(e) for e in events]
        # noqa: AH102 - one-shot crash/shutdown dump; forensics cannot rely on executors
        with open(f"{dump_base}.engine{args.id}.json", "w") as fh:
            _json.dump(doc, fh)

    def dump_ts() -> None:
        # The saturation timeline rides the same dump surface as the
        # trace files ({base}.r{id}.ts.json).
        if tseries is None or not dump_base:
            return
        from ...obs import timeseries as obs_ts

        obs_ts.dump_timeseries(
            tseries, f"{dump_base}.r{args.id}", extra={"id": args.id}
        )

    async def log_metrics() -> None:
        import json as _json

        while not stop.is_set():
            await asyncio.sleep(args.metrics_interval)
            if grouped:
                # Same schema as the ungrouped line: the one rate field is
                # the process's aggregate across its group cores.
                snap = replica.metrics_aggregate()
                snap["executed_per_sec"] = round(
                    sum(core.metrics.executed_per_sec() for core in replica.cores), 2
                )
            else:
                snap = replica.metrics.snapshot()
                snap["executed_per_sec"] = round(
                    replica.metrics.executed_per_sec(), 2
                )
            print(f"metrics: {_json.dumps(snap)}", file=sys.stderr)

    metrics_task = (
        loop.create_task(log_metrics()) if args.metrics_interval > 0 else None
    )
    sampler_task = (
        loop.create_task(sampler.run()) if sampler is not None else None
    )

    # Breach-forensics watch (obs/slo.py): needs the sampler — burn is a
    # ring reading, and without ticks the window is always empty.
    slo_watch_tasks = []
    if slo_spool is not None and sampler is not None:
        _slo_recorders = [
            h.trace for h in _handler_list if getattr(h, "trace", None) is not None
        ]

        def _slo_bundle(burn: dict) -> dict:
            return obs_slo.build_bundle(
                slo_ledgers[0].policy,
                burn,
                slo_ledgers,
                recorders=_slo_recorders,
                timeseries=tseries,
            )

        for lg in slo_ledgers:
            slo_watch_tasks.append(loop.create_task(obs_slo.watch(
                tseries, lg.policy, slo_spool, _slo_bundle, group=lg.group
            )))

    async def stop_sampler() -> None:
        # Cancel-and-await: the sampler's CancelledError handler flushes
        # the final partial interval before the ring is dumped.
        for t in slo_watch_tasks:
            t.cancel()
        for t in slo_watch_tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        if sampler_task is not None:
            sampler_task.cancel()
            try:
                await sampler_task
            except asyncio.CancelledError:
                pass

    try:
        await stop.wait()
    except BaseException:
        # Fatal error (or a cancellation unwinding the process): the
        # trace must not die with it.  Best-effort stop (which dumps) and
        # engine dump, then let the error propagate.
        print(f"replica {args.id} crashing: dumping trace", file=sys.stderr)
        try:
            await stop_sampler()
            if metrics_server is not None:
                metrics_server.stop()
            await replica.stop()
            dump_engine_obs()
            dump_ts()
        except Exception:  # noqa: BLE001 - forensics must not mask the
            pass  # original fatal error
        raise
    if metrics_task is not None:
        metrics_task.cancel()
        try:
            await metrics_task
        except asyncio.CancelledError:
            pass
    await stop_sampler()
    print(f"replica {args.id} shutting down", file=sys.stderr)
    if metrics_server is not None:
        metrics_server.stop()
    await replica.stop()  # writes the replica's MINBFT_TRACE_DUMP file
    dump_engine_obs()
    dump_ts()
    await server.stop()
    await conn.close()
    import json as _json

    # Lines a harness can read from the log: each group's ledger (its
    # length and state digest: replicas that agree print the same) and the
    # engine's report (bench.py's mp runs, chip_smoke.py).
    print(f"replica {args.id} ledgers " + _json.dumps([
        {"group": g, "length": lg.length, "digest": lg.state_digest().hex()}
        for g, lg in enumerate(ledgers)
    ]), file=sys.stderr, flush=True)
    if engine is not None:
        print(f"replica {args.id} engine {_json.dumps(engine_report(engine))}",
              file=sys.stderr, flush=True)
    return 0


def _client_auth(args, store, client_id: int, engine):
    if args.auth == "mac":
        return store.mac_client_authenticator(client_id, engine=engine)
    return store.client_authenticator(client_id, engine=engine)


def _new_cli_client(cfg, client_id: int, auth, conn, pin: int = -1, **kw):
    """The client of ``request`` and ``bench``: against a multi-group
    config a :class:`~minbft_tpu_torch.groups.MultiGroupClient` (each
    operation routed to its key-space shard by the hash of its bytes, or
    pinned with ``--group``), else a plain client."""
    from ...client import new_client

    n_groups = getattr(cfg, "groups", 1)
    if n_groups > 1:
        from ...groups import MultiGroupClient

        if pin >= n_groups:
            # validate the pin up front: a clean CLI error, not a
            # ValueError out of the router mid-request
            raise SystemExit(
                f"peer: --group {pin} out of range (config declares "
                f"{n_groups} groups: 0..{n_groups - 1})"
            )
        return MultiGroupClient(client_id, cfg.n, cfg.f, n_groups, auth, conn, **kw)
    if pin > 0:
        # --group 0 against an ungrouped config stays accepted: group 0
        # IS the ungrouped wire format by definition (bare frames).
        raise SystemExit(
            f"peer: --group {pin} but the config declares no groups"
        )
    return new_client(client_id, cfg.n, cfg.f, auth, conn, **kw)


async def _run_request(args) -> int:
    from ...sample.authentication import KeyStore
    from ...sample.config import load_config

    if args.transport == "tcp":
        from ...sample.conn.tcp import (
            connect_many_replicas_tcp as connect_many_replicas,
        )
    else:
        from ...sample.conn.grpc import connect_many_replicas

    store = KeyStore.load(args.keys)
    cfg = load_config(args.config)
    addrs = {p.id: p.addr for p in cfg.peers}
    if len(addrs) < cfg.n:
        raise SystemExit("peer: config peers[] does not cover all replicas")
    pin = getattr(args, "group", -1)
    # A client's batches are its own REQUEST signs and the f+1..n REPLYs
    # of each request: the engine's default ladder of buckets.
    engine = _make_engine(args, 512)

    ops = [op.encode() for op in args.ops]
    if not ops:
        ops = [line.rstrip("\n").encode() for line in sys.stdin if line.strip()]

    conn = connect_many_replicas(addrs, kind="client")
    client = _new_cli_client(
        cfg, args.client_id, _client_auth(args, store, args.client_id, engine),
        conn, pin,
    )
    kw = {"group": pin} if getattr(cfg, "groups", 1) > 1 and pin >= 0 else {}
    await client.start()
    rc = 0
    try:
        for op in ops:
            result = await asyncio.wait_for(
                client.request(
                    op,
                    read_only=getattr(args, "read_only", False),
                    read_fallback=not getattr(args, "no_read_fallback", False),
                    read_timeout=min(args.timeout, 30.0),
                    **kw,
                ),
                args.timeout,
            )
            print(result.hex())
    except asyncio.TimeoutError:
        print("peer: request timed out", file=sys.stderr)
        rc = 1
    finally:
        await client.stop()
        await conn.close()
    return rc


async def _run_bench_clients(args) -> int:
    """Client process of the multi-process bench: ``--clients`` pipelined
    clients drive ``--requests`` no-ops and print ONE JSON line —
    committed count, wall seconds, every request's latency (ms) so the
    harness can aggregate exact percentiles across processes, and (with
    an engine) the engine's report: its device, queue counts and kernel
    launches."""
    import faulthandler
    import json as _json
    import time as _time

    from ...sample.authentication import KeyStore
    from ...sample.config import load_config

    if args.transport == "tcp":
        from ...sample.conn.tcp import (
            connect_many_replicas_tcp as connect_many_replicas,
        )
    else:
        from ...sample.conn.grpc import connect_many_replicas

    # Wedge forensics: SIGUSR1 dumps every thread's stack to stderr.
    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError):
        pass

    store = KeyStore.load(args.keys)
    cfg = load_config(args.config)
    addrs = {p.id: p.addr for p in cfg.peers}
    n_groups = getattr(cfg, "groups", 1)
    # One engine for every client of this process: REQUEST signs (K3)
    # and REPLY verifies (K2) from all of them coalesce into its batches.
    engine = _make_engine(args, 512, buckets=(512,))

    if hasattr(asyncio, "eager_task_factory"):
        asyncio.get_running_loop().set_task_factory(asyncio.eager_task_factory)

    conn = connect_many_replicas(addrs, kind="client")
    clients = []
    for k in range(args.clients):
        cid = args.client_base + k
        # Against a multi-group config each client routes its operations
        # across the groups by their hash (the reference's bench drives
        # group 0 only).
        c = _new_cli_client(
            cfg, cid, _client_auth(args, store, cid, engine), conn,
            retransmit_interval=30.0,
        )
        await c.start()
        clients.append(c)

    per_client = max(args.requests // args.clients, 1)
    total = per_client * args.clients
    tag = (args.tag or "mp").encode()

    # settle the streams (and any cold server-side state) off the clock,
    # one request into each group
    for g in range(n_groups):
        kw = {"group": g} if n_groups > 1 else {}
        await asyncio.wait_for(clients[0].request(tag + b"-warmup", **kw),
                               args.timeout)

    latencies_ms: list = []

    read_only = getattr(args, "read_only", False)

    async def timed(client, k: int) -> None:
        t = _time.time()
        if read_only:
            # identical op bytes on purpose: reads have no dedup hazard,
            # and identical results are exactly what the all-n fast
            # quorum needs.  read_fallback=False: this mode MEASURES the
            # no-consensus path.
            await asyncio.wait_for(
                client.request(
                    b"head",
                    read_only=True,
                    read_timeout=min(args.timeout, 30.0),
                    read_fallback=False,
                ),
                args.timeout,
            )
        else:
            await asyncio.wait_for(
                client.request(tag + b"-%d-%d" % (client.client_id, k)),
                args.timeout,
            )
        latencies_ms.append(round((_time.time() - t) * 1e3, 2))

    async def drive(client) -> None:
        # Gather-windows, deliberately NOT a rolling semaphore window: the
        # window's burst of `depth` requests coalesces into few transport
        # frames and fills PREPARE batches.
        for k0 in range(0, per_client, args.depth):
            await asyncio.gather(
                *[
                    timed(client, k)
                    for k in range(k0, min(k0 + args.depth, per_client))
                ]
            )

    t0 = _time.time()
    cpu0 = _time.process_time()
    await asyncio.gather(*[drive(c) for c in clients])
    dt = _time.time() - t0
    cpu_s = _time.process_time() - cpu0

    async def teardown() -> None:
        for c in clients:
            await c.stop()
        await conn.close()

    # Best-effort teardown with a bound, then a HARD exit: grpc.aio's
    # channel/stream teardown can wedge asyncio.run's cancel-all in a
    # thread join.  This process exists only to emit one stats line —
    # once that's out, nothing it leaks matters.
    try:
        await asyncio.wait_for(teardown(), 10)
    except Exception:  # noqa: BLE001 - teardown is best-effort
        pass
    report = {
        "committed": total,
        "seconds": round(dt, 3),
        "req_per_sec": round(total / dt, 1),
        "cpu_per_wall": round(cpu_s / dt, 3),
        "groups": n_groups,
        "latencies_ms": latencies_ms,
    }
    if engine is not None:
        report["engine"] = engine_report(engine)
    print(_json.dumps(report), flush=True)
    sys.stderr.flush()
    os._exit(0)


async def _run_load(args) -> int:
    """Open-loop load run: self-contained — scaffolds its own keys and
    in-process cluster (client traffic over real loopback TCP, the
    replicas' checks on one engine on ``--device``), drives the seeded
    schedule, prints ONE JSON report line on stdout.

    rc contract (the CI load-smoke step's interface): 0 = schedule fired
    faithfully (live census == seed replay) and any --expect-goodput bar
    was met and any --slo-target-ms bar was met; 1 otherwise.  Progress
    notes go to stderr."""
    import json as _json

    from ...loadgen import LoadSpec
    from ...loadgen.runner import run_local_load

    device = _engine_device(args)
    n = args.replicas
    spec = LoadSpec(
        seed=args.seed,
        rate=args.rate,
        duration_s=args.duration,
        n_clients=args.clients,
        process=args.process,
        read_fraction=args.read_fraction,
        large_fraction=args.large_fraction,
        n_groups=args.groups,
    )
    spec.validate()
    print(
        # noqa: SH301 - a load-schedule seed is a PUBLIC replay token
        # (printed so a run can be reproduced, same as chaos seeds), not
        # key material.
        f"load: seed={spec.seed:#x} {spec.process} {spec.rate}/s x "  # noqa: SH301
        f"{spec.duration_s}s, {spec.n_clients} clients over "
        f"{args.conns * n} sockets, n={n}, engine "
        f"{device if device is not None else 'none, host crypto'}",
        file=sys.stderr,
    )
    report = await run_local_load(
        spec,
        n=n,
        f=(n - 1) // 3,
        pool_slots=args.conns,
        drain_s=args.drain,
        expect_goodput=args.expect_goodput,
        scheme=args.scheme,
        slo_target_ms=args.slo_target_ms if args.slo_target_ms > 0 else None,
        device=None if device is None else str(device),
    )
    print(_json.dumps(report), flush=True)
    ok = (
        report["census_ok"]
        and report.get("goodput_ok", True)
        and report.get("slo_ok", True)
    )
    if not report["census_ok"]:
        print("load: FAILED — generator diverged from the seeded "
              "schedule (census mismatch)", file=sys.stderr)
    if not report.get("goodput_ok", True):
        print(
            f"load: FAILED — goodput {report['goodput_per_sec']}/s below "
            f"the --expect-goodput {args.expect_goodput}/s bar",
            file=sys.stderr,
        )
    if not report.get("slo_ok", True):
        print(
            f"load: FAILED — slo_good_fraction "
            f"{report['slo_good_fraction']} below the "
            f"{report['slo_objective']} objective for the "
            f"{args.slo_target_ms}ms finality budget",
            file=sys.stderr,
        )
    # The report is out; a leaked replica task wedging interpreter
    # shutdown must not turn a green run red (the `peer bench` idiom).
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if ok else 1)


async def _run_selftest(args) -> int:
    """In-process n=4/f=1 commit through generated keys + the dummy
    connector — a deployment smoke test needing no files or sockets.  The
    four replicas and the client share one engine on ``--device`` (the
    device rule); at the end it prints ``selftest engine {json}`` on
    stderr, the engine's report."""
    engine = _make_engine(args, 512)
    rc = await _selftest(args, engine)
    if engine is not None:
        import json as _json

        print(f"selftest engine {_json.dumps(engine_report(engine))}",
              file=sys.stderr, flush=True)
    return rc


async def _selftest(args, engine) -> int:
    from ... import api
    from ...client import new_client
    from ...core import new_replica
    from ...sample.authentication import generate_testnet_keys
    from ...sample.config import SimpleConfiger
    from ...sample.conn.inprocess import (
        InProcessClientConnector,
        InProcessPeerConnector,
        make_testnet_stubs,
    )
    from ...sample.requestconsumer import SimpleLedger

    n, f = 4, 1
    store = generate_testnet_keys(n, n_clients=1)
    cfg = SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=30.0)
    stubs = make_testnet_stubs(n)

    # Chaos mode: the same smoke workload, but every link flows through a
    # seeded fault-injection network — the CLI face of the chaos tests
    # (deterministic replay via the printed seed / MINBFT_CHAOS_SEED).
    net = None
    if args.chaos_seed is not None or args.chaos_profile is not None:
        from ...testing import PROFILES, FaultNet, chaos_seed

        # The chaos seed is a PUBLIC replay token (printed so a failed
        # run can be reproduced) — identifiers carry the "chaos" word
        # so the secret-hygiene pass knows it is not key material.
        run_chaos_seed = chaos_seed(args.chaos_seed)
        profile = args.chaos_profile or "lossy"
        net = FaultNet(seed=run_chaos_seed, default_plan=PROFILES[profile])
        cfg = SimpleConfiger(
            n=n, f=f, timeout_request=2.0, timeout_prepare=1.0,
            timeout_viewchange=4.0,
        )
        print(
            f"chaos selftest: profile={profile} seed={run_chaos_seed:#x} "
            f"(replay: MINBFT_CHAOS_SEED={run_chaos_seed:#x})",
            file=sys.stderr,
        )

    def _wrap(conn, endpoint):
        return net.wrap(conn, endpoint) if net is not None else conn

    ledgers = [SimpleLedger() for _ in range(n)]
    replicas = []
    for i in range(n):
        r = new_replica(
            i,
            cfg,
            store.replica_authenticator(i, engine=engine),
            _wrap(InProcessPeerConnector(stubs), f"r{i}"),
            ledgers[i],
            opts=_log_opts(args),
        )
        stubs[i].assign_replica(r)
        replicas.append(r)
    for r in replicas:
        await r.start()
    client = new_client(
        0,
        n,
        f,
        store.client_authenticator(0, engine=engine),
        _wrap(InProcessClientConnector(stubs), "c0"),
        retransmit_interval=1.0 if net is not None else None,
    )
    await client.start()

    if net is not None:
        # The smoke request plus a short seeded soak: more ordered
        # traffic, then the cross-replica safety invariants.  The strict
        # fast-read check below is skipped — under a lossy plan the
        # no-fallback fast quorum is legitimately unavailable.  A
        # TimeoutError here is the chaos run's MOST LIKELY failure mode
        # (a wedged cluster) — it must fall through to the designed
        # report (census + replay seed + clean teardown), not escape as
        # a raw traceback that skips all three.
        from ...testing import InvariantChecker

        accepted = []
        ok = True
        try:
            result = await asyncio.wait_for(client.request(b"selftest"), 60)
            accepted.append((b"selftest", result))
            ops = [b"chaos-%d" % i for i in range(5)]
            results = await asyncio.wait_for(
                asyncio.gather(
                    *[client.request(op, timeout=90) for op in ops]
                ),
                120,
            )
            accepted.extend(zip(ops, results))
        except asyncio.TimeoutError:
            print("selftest: chaos workload wedged past its deadline",
                  file=sys.stderr)
            ok = False
        want = len(accepted)
        if ok:
            for _ in range(600):
                if all(lg.length >= want for lg in ledgers):
                    break
                await asyncio.sleep(0.05)
            ok = all(lg.length >= want for lg in ledgers)
        if ok:
            try:
                InvariantChecker(replicas, ledgers).check(accepted)
            except AssertionError as e:
                print(f"selftest FAILED: invariant violation: {e}",
                      file=sys.stderr)
                ok = False
        await client.stop()
        for r in replicas:
            await r.stop()
        census = net.census.snapshot()
        print(f"chaos census: {census['counters']} "
              f"({census['frames_total']} frames)", file=sys.stderr)
        if not ok:
            print("selftest FAILED: chaos workload did not commit on all "
                  f"replicas (replay: MINBFT_CHAOS_SEED={net.chaos_seed:#x})",
                  file=sys.stderr)
            return 1
        print(f"chaos selftest ok: {want} requests committed on all {n} "
              f"replicas under seed {net.chaos_seed:#x}, invariants green",
              file=sys.stderr)
        return 0

    result = await asyncio.wait_for(client.request(b"selftest"), 60)
    for _ in range(200):
        if all(lg.length == 1 for lg in ledgers):
            break
        await asyncio.sleep(0.02)
    ok = all(lg.length == 1 for lg in ledgers)
    read_ok = False
    if ok:
        # and the read-only fast path: strict (no ordered fallback) so a
        # fast-quorum regression fails the selftest loudly — as the
        # diagnostic line below, not an unhandled traceback
        try:
            head = await asyncio.wait_for(
                client.request(
                    b"head",
                    read_only=True,
                    read_fallback=False,
                    read_timeout=30.0,
                ),
                60,
            )
        except (asyncio.TimeoutError, api.ReadOnlyQueryError):
            head = b""
        read_ok = bool(head) and head.endswith(ledgers[0].state_digest())
        read_ok = read_ok and all(lg.length == 1 for lg in ledgers)
    await client.stop()
    for r in replicas:
        await r.stop()
    if not ok:
        print("selftest FAILED: not all ledgers committed", file=sys.stderr)
        return 1
    if not read_ok:
        print("selftest FAILED: read-only fast path", file=sys.stderr)
        return 1
    print(f"selftest ok: request committed on all {n} replicas, "
          f"fast read served "
          f"(usig={store.usig_spec}, result={result.hex()[:16]}…)", file=sys.stderr)
    return 0


def _run_testnet_scaffold(args) -> int:
    """Write keys.yaml + consensus.yaml for an n-replica local cluster
    (the docker-entrypoint key-generation step of the reference,
    sample/docker/docker-entrypoint.sh, as an explicit command)."""
    from ...sample.authentication import generate_testnet_keys

    f = args.faults if args.faults is not None else (args.replicas - 1) // 2
    if args.replicas < 2 * f + 1:
        raise SystemExit(f"peer: n={args.replicas} < 2f+1 with f={f}")
    os.makedirs(args.dir, exist_ok=True)
    store = generate_testnet_keys(
        args.replicas, n_clients=args.clients, usig_spec=args.usig,
        with_macs=args.macs,
    )
    keys_path = os.path.join(args.dir, "keys.yaml")
    store.save(keys_path)
    # Per-replica least-privilege copies: replica i gets only its own
    # private material (and only its rows of the MAC matrix).  The full
    # keys.yaml stays for the operator/client side.  All files are
    # written 0600 (KeyStore.save).
    for i in range(args.replicas):
        store.strip_private(keep_replica=i).save(
            os.path.join(args.dir, f"keys.replica{i}.yaml")
        )
    peers = [
        {"id": i, "addr": f"{args.host}:{args.base_port + i}"}
        for i in range(args.replicas)
    ]
    cfg = {
        "protocol": {
            "n": args.replicas,
            "f": f,
            # Checkpointing on by default: every 128 executions the
            # replicas certify state, GC their logs behind the stable
            # certificate, and serve state transfer (override with
            # CONSENSUS_CHECKPOINT_PERIOD; 0 disables).
            "checkpointPeriod": 128,
            "logsize": 0,
            "batchsizePrepare": 64,
            "groups": max(1, args.groups),
            "timeout": {"request": "8s", "prepare": "4s", "viewchange": "8s"},
        },
        "peers": peers,
    }
    import yaml

    cfg_path = os.path.join(args.dir, "consensus.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh, sort_keys=False)
    # Sample per-node options file (reference ships sample/peer/peer.yaml):
    # picked up automatically by `peer` run from this directory; every
    # value still overridable by PEER_* env vars and flags.
    peer_path = os.path.join(args.dir, "peer.yaml")
    if not os.path.exists(peer_path):
        with open(peer_path, "w") as fh:
            fh.write(
                "# Per-node peer options (layered under PEER_* env vars"
                " and flags)\n"
                "keys: keys.yaml\n"
                "config: consensus.yaml\n"
                "log_level: info\n"
                "#run:\n"
                "#  batch: 512\n"
                "#  device: cuda:0\n"
                "#  metrics_interval: 0\n"
                "#request:\n"
                "#  client_id: 0\n"
                "#  timeout: 30.0\n"
            )
    print(
        f"wrote {keys_path} (usig={store.usig_spec}), {cfg_path} "
        f"(n={args.replicas}, f={f}), and {peer_path}",
        file=sys.stderr,
    )
    return 0


def _run_metrics_scrape(args) -> int:
    """``peer metrics host:port [host:port ...]`` — fetch and print
    Prometheus expositions from running replicas (synchronous GETs, no
    event loop).

    One target prints its exposition verbatim (the original contract).
    Several targets print per-target sections and then ONE merged
    cluster aggregate: the log2 histograms are exactly mergeable by
    design (identical fixed bucket edges — obs/hist.py), counters sum,
    and the per-process ``replica`` label is stripped so the same
    logical series folds together.  A dead target costs its section
    (and rc=1), never the others'."""
    from ...obs.prom import merge_expositions, scrape

    scraped: list = []
    rc = 0
    for addr in args.addr:
        try:
            scraped.append((addr, scrape(addr, timeout=args.timeout)))
        except OSError as e:
            print(
                f"peer: metrics scrape of {addr} failed: {e}", file=sys.stderr
            )
            rc = 1
    if not scraped:
        return 1
    if len(args.addr) == 1:
        sys.stdout.write(scraped[0][1])
        return rc
    if not args.merged_only:
        for addr, text in scraped:
            print(f"# ==== target {addr} ====")
            sys.stdout.write(text)
    print(f"# ==== merged cluster aggregate ({len(scraped)} targets) ====")
    sys.stdout.write(merge_expositions(text for _, text in scraped))
    return rc


def _scrape_top_state(addr: str, timeout: float) -> dict:
    """One target's parsed state for the ``peer top`` console: per-
    (replica, group) identity rows plus process-level engine readings,
    all extracted from the standard exposition families."""
    import time as _time

    from ...obs.prom import parse_exposition, scrape

    fams = parse_exposition(scrape(addr, timeout=timeout))

    def samples(name: str) -> dict:
        fam = fams.get(name)
        return fam["samples"] if fam else {}

    def total(name: str) -> float:
        return float(sum(samples(name).values()))

    def by_identity(name: str) -> dict:
        out = {}
        for key, v in samples(name).items():
            lb = dict(key)
            out[(lb.get("replica", "?"), lb.get("group", "-"))] = v
        return out

    state = {
        "addr": addr,
        "mono": _time.monotonic(),
        "executed": by_identity("minbft_requests_executed_total"),
        "view": by_identity("minbft_health_view"),
        "stall": by_identity("minbft_health_commit_stall"),
        "stale": by_identity("minbft_health_stale_group"),
        "vchanges": by_identity("minbft_view_changes_completed_total"),
        # Crash-recovery phase (recovery/): absent on targets
        # running without a durable store — the console renders "-".
        "recov": by_identity("minbft_recovery_phase"),
        "build": {},
        "depth": total("minbft_verify_queue_depth")
        + total("minbft_sign_queue_depth"),
        "peak": total("minbft_verify_queue_depth_peak")
        + total("minbft_sign_queue_depth_peak"),
        "device_s": total("minbft_verify_queue_device_seconds_total")
        + total("minbft_sign_queue_device_seconds_total"),
        "items": total("minbft_verify_queue_items_total"),
        "batches": total("minbft_verify_queue_batches_total"),
        # Admission sheds: requests refused at the admission
        # boundary — a nonzero rate means offered load exceeds capacity.
        "shed": total("minbft_admission_shed_total"),
        "uptime": max(
            samples("minbft_uptime_seconds").values(), default=0.0
        ),
        "window": {},
    }
    for key, _v in samples("minbft_build_info").items():
        lb = dict(key)
        state["build"][(lb.get("replica", "?"), lb.get("group", "-"))] = lb
    # Engine-pool per-chip readings: keyed (replica, chip).
    # Absent families leave the dicts empty — a pool-less target renders
    # exactly as before.
    chips: dict = {}
    for fam_name, field in (
        ("minbft_engine_pool_chip_busy", "busy"),
        ("minbft_engine_pool_chip_fill", "fill"),
        ("minbft_engine_pool_chip_depth", "depth"),
        ("minbft_engine_pool_chip_up", "up"),
    ):
        for key, v in samples(fam_name).items():
            lb = dict(key)
            ident = (lb.get("replica", "?"), lb.get("chip", "?"))
            chips.setdefault(ident, {})[field] = v
    state["chips"] = chips
    state["home_chip"] = by_identity("minbft_engine_pool_home_chip")
    # SLO families (obs/slo.py): absent when the target runs without a
    # policy — the console renders "-" columns, never crashes.
    state["slo_budget"] = by_identity("minbft_slo_budget_remaining")
    state["slo_threshold"] = by_identity("minbft_slo_burn_threshold")
    burn: dict = {}
    for key, v in samples("minbft_slo_burn_rate").items():
        lb = dict(key)
        burn[(
            lb.get("replica", "?"), lb.get("group", "-"),
            lb.get("window", "fast"),
        )] = v
    state["slo_burn"] = burn
    for name, fam in fams.items():
        if name.startswith("minbft_window_"):
            state["window"][name[len("minbft_window_"):]] = next(
                iter(fam["samples"].values()), 0.0
            )
    return state


def _top_frame(states: dict, errors: dict, prev: dict) -> "tuple[list, bool]":
    """Render one console frame: header + one row per (replica, group)
    identity per target, DOWN rows for unreachable targets.  Returns
    ``(lines, unhealthy)`` — unhealthy when any row flags a commit
    stall or stale group (the --stall-flag exit hook)."""
    from ...recovery import PHASE_NAMES

    lines = [
        f"{'TARGET':<24}{'R':>3}{'G':>3}{'REQ/S':>9}{'SHED/S':>8}"
        f"{'FILL':>7}{'UTIL%':>7}{'DEPTH':>7}{'PEAK':>6}{'LAG_MS':>8}"
        f"{'BURN':>6}{'BUDG':>6}{'VIEW':>5}{'RECOV':>8}  HEALTH"
    ]
    unhealthy = False
    for addr in sorted(set(states) | set(errors)):
        if addr in errors:
            lines.append(f"{addr:<24}{'—':>3}{'—':>3}  DOWN: {errors[addr]}")
            continue
        st = states[addr]
        pv = prev.get(addr)
        dt = (st["mono"] - pv["mono"]) if pv else 0.0

        def rate(cur: float, last: float, window_key: str) -> float:
            # watch mode: counter delta over the scrape gap; first
            # frame / --once: the server-side window gauge, falling
            # back to the lifetime mean when rings are off.
            if pv is not None and dt > 0 and cur >= last:
                return (cur - last) / dt
            if window_key in st["window"]:
                return st["window"][window_key]
            return cur / st["uptime"] if st["uptime"] > 0 else 0.0

        # Process-level engine readings (shared across the target's rows).
        if pv is not None and dt > 0 and st["device_s"] >= pv["device_s"]:
            util = 100.0 * (st["device_s"] - pv["device_s"]) / dt
        else:
            util = (
                100.0 * st["device_s"] / st["uptime"]
                if st["uptime"] > 0
                else 0.0
            )
        if (
            pv is not None
            and st["batches"] > pv["batches"]
            and st["items"] >= pv["items"]
        ):
            fill = (st["items"] - pv["items"]) / (
                st["batches"] - pv["batches"]
            )
        elif "verify_fill" in st["window"]:
            fill = st["window"]["verify_fill"]
        else:
            fill = st["items"] / st["batches"] if st["batches"] else 0.0
        # Shed rate is target-level (admission counters sum across the
        # target's groups); shown on every row of the target.
        shed_rate = rate(
            st["shed"], pv["shed"] if pv else 0.0, "admission_shed"
        )
        identities = sorted(
            set(st["executed"]) | set(st["build"]) | set(st["view"])
        )
        if not identities:
            identities = [("?", "-")]
        for rid, grp in identities:
            ident = (rid, grp)
            executed = st["executed"].get(ident, 0.0)
            win_key = (
                f"committed_g{grp}" if grp != "-" else "committed"
            )
            rps = rate(
                executed,
                pv["executed"].get(ident, 0.0) if pv else 0.0,
                win_key,
            )
            lag_key = (
                f"loop_lag_p50_ms_g{grp}" if grp != "-"
                else "loop_lag_p50_ms"
            )
            lag = st["window"].get(lag_key, 0.0)
            flags = []
            if st["stall"].get(ident):
                flags.append("STALL")
                unhealthy = True
            if st["stale"].get(ident):
                flags.append("STALE")
                unhealthy = True
            # SLO columns (the reference's perf/SLO.md): fast-window burn multiple and
            # remaining error budget; crossing the policy's threshold
            # raises BREACH (and trips --stall-flag like a stall).
            fast_burn = st.get("slo_burn", {}).get((rid, grp, "fast"))
            budget = st.get("slo_budget", {}).get(ident)
            thr = st.get("slo_threshold", {}).get(ident)
            if (fast_burn is not None and thr is not None and thr > 0
                    and fast_burn >= thr):
                flags.append("BREACH")
                unhealthy = True
            burn_s = f"{fast_burn:.1f}" if fast_burn is not None else "-"
            budg_s = f"{budget:.2f}" if budget is not None else "-"
            vc = st["vchanges"].get(ident, 0)
            if vc:
                flags.append(f"vc={int(vc)}")
            view = int(st["view"].get(ident, 0))
            # RECOV: the durable-store recovery phase by short name; a
            # replica stuck in "fetch"/"install" long after restart is
            # the console's first visible symptom of a wedged transfer.
            ph = st.get("recov", {}).get(ident)
            if ph is None:
                recov_s = "-"
            else:
                pi = int(ph)
                recov_s = (
                    PHASE_NAMES[pi] if 0 <= pi < len(PHASE_NAMES) else str(pi)
                )
            lines.append(
                f"{addr:<24}{rid:>3}{grp:>3}{rps:>9.1f}{shed_rate:>8.1f}"
                f"{fill:>7.1f}{min(util, 999.0):>7.1f}{st['depth']:>7.0f}"
                f"{st['peak']:>6.0f}{lag:>8.2f}{burn_s:>6}{budg_s:>6}"
                f"{view:>5}{recov_s:>8}  {' '.join(flags) or 'ok'}"
            )
            # Engine-pool expansion: the group's home chip as a sub-row
            # (the reference's pool families; the port has no pool yet,
            # so its own targets never show one).  A chip the scrape knows nothing about (or one
            # whose every queue wrote its device off) renders DOWN with
            # zeroed readings — missing fields must never crash a frame.
            home = st.get("home_chip", {}).get(ident)
            if home is not None:
                chip = str(int(home))
                row = st.get("chips", {}).get((rid, chip), {})
                down = not row or not row.get("up", 0)
                lines.append(
                    f"{'':<24} └ chip {chip:<3}"
                    f" busy={row.get('busy', 0.0):<7.3f}"
                    f" fill={row.get('fill', 0.0):<7.3f}"
                    f" depth={row.get('depth', 0.0):<6.0f}"
                    f" {'DOWN' if down else 'up'}"
                )
        build = next(iter(st["build"].values()), None)
        if build is not None:
            lines.append(
                f"{'':<24} └ pid={build.get('pid', '?')} "
                f"backend={build.get('backend', '?')} "
                f"rev={build.get('git_rev', '?')} "
                f"run={str(build.get('run_id', '?'))[:18]}"
            )
    return lines, unhealthy


def _run_top(args) -> int:
    """``peer top`` — the live cluster console.  Watch mode
    clears and redraws every ``--interval`` seconds, computing rates
    from consecutive-scrape counter deltas; ``--once`` prints a single
    frame whose rates come from the replicas' own ``minbft_window_*``
    gauges (one scrape, no diffing — the CI/scripting mode)."""
    import time as _time

    prev: dict = {}
    while True:
        states: dict = {}
        errors: dict = {}
        for addr in args.addr:
            try:
                states[addr] = _scrape_top_state(addr, args.timeout)
            except OSError as e:
                errors[addr] = str(e)
        lines, unhealthy = _top_frame(states, errors, prev)
        if not args.once and not args.no_clear and sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H")
        print("\n".join(lines), flush=True)
        if args.once:
            if errors:
                return 1
            if args.stall_flag and unhealthy:
                return 3
            return 0
        prev = states
        try:
            _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _run_slo(args) -> int:
    """``peer slo`` — one-shot latency-SLO report (perf/SLO.md in the reference).

    Scrapes each target's ``minbft_slo_*`` families and prints one row
    per (target, group): lifetime good/breached counts, the policy's
    target/objective, remaining error budget, fast/slow burn multiples,
    and the breach-dump spool counters.  ``--dumps BASE`` additionally
    loads a trace-dump file set ({base}.*.json) and appends the
    per-segment breach attribution.  rc: 0 ok, 1 scrape failure, 3 with
    ``--breach-flag`` when any fast burn is at/over its threshold."""
    import json as _json

    from ...obs.prom import parse_exposition, scrape

    rc = 0
    breach = False
    report: dict = {"targets": []}
    for addr in args.addr:
        try:
            fams = parse_exposition(scrape(addr, timeout=args.timeout))
        except OSError as e:
            print(f"peer: slo scrape of {addr} failed: {e}",
                  file=sys.stderr)
            rc = 1
            continue

        def samples(name: str) -> dict:
            fam = fams.get(name)
            return fam["samples"] if fam else {}

        groups: dict = {}

        def fold(name: str, field: str) -> None:
            for key, v in samples(name).items():
                lb = dict(key)
                g = lb.get("group", "-")
                f = (
                    f"{field}_{lb['window']}" if "window" in lb else field
                )
                groups.setdefault(g, {})[f] = v

        fold("minbft_slo_good_total", "good")
        fold("minbft_slo_breached_total", "breached")
        fold("minbft_slo_target_ms", "target_ms")
        fold("minbft_slo_objective", "objective")
        fold("minbft_slo_budget_remaining", "budget_remaining")
        fold("minbft_slo_burn_threshold", "burn_threshold")
        fold("minbft_slo_burn_rate", "burn")
        spool = {
            "written": sum(
                samples("minbft_slo_breach_dumps_total").values()
            ),
            "suppressed": sum(
                samples(
                    "minbft_slo_breach_dumps_suppressed_total"
                ).values()
            ),
        }
        for g in groups.values():
            total = g.get("good", 0) + g.get("breached", 0)
            g["good_fraction"] = (
                round(g.get("good", 0) / total, 4) if total else 1.0
            )
            thr = g.get("burn_threshold", 0)
            if thr > 0 and g.get("burn_fast", 0.0) >= thr:
                g["breach"] = True
                breach = True
        report["targets"].append(
            {"addr": addr, "groups": groups, "spool": spool}
        )
    if args.dumps:
        from ...obs import slo as obs_slo
        from ...obs.trace import load_dumps

        docs = load_dumps(args.dumps)
        report["breach_report"] = obs_slo.breach_report(
            docs, obs_slo.SLOPolicy.from_env()
        )
    if args.json:
        print(_json.dumps(report, sort_keys=True), flush=True)
    else:
        print(
            f"{'TARGET':<24}{'G':>3}{'GOOD':>9}{'BREACHED':>9}"
            f"{'GOODFRAC':>9}{'TARGET_MS':>10}{'BUDGET':>8}"
            f"{'FAST':>7}{'SLOW':>7}  FLAG"
        )
        for tgt in report["targets"]:
            if not tgt["groups"]:
                print(f"{tgt['addr']:<24}  (no SLO policy — set "
                      "MINBFT_SLO_TARGET_MS or protocol.slo)")
                continue
            for g in sorted(tgt["groups"]):
                row = tgt["groups"][g]
                print(
                    f"{tgt['addr']:<24}{g:>3}"
                    f"{int(row.get('good', 0)):>9}"
                    f"{int(row.get('breached', 0)):>9}"
                    f"{row.get('good_fraction', 1.0):>9.4f}"
                    f"{row.get('target_ms', 0.0):>10.0f}"
                    f"{row.get('budget_remaining', 1.0):>8.2f}"
                    f"{row.get('burn_fast', 0.0):>7.1f}"
                    f"{row.get('burn_slow', 0.0):>7.1f}"
                    f"  {'BREACH' if row.get('breach') else 'ok'}"
                )
            if tgt["spool"]["written"] or tgt["spool"]["suppressed"]:
                print(
                    f"{'':<24} └ breach dumps: "
                    f"{int(tgt['spool']['written'])} written, "
                    f"{int(tgt['spool']['suppressed'])} suppressed"
                )
        br = report.get("breach_report")
        if br:
            print(
                f"breach attribution ({br['origin']}-origin, "
                f"{br['breached']}/{br['requests']} breached, "
                f"{br['breached_spend_ms']}ms spent):"
            )
            for seg, ms in sorted(
                br["attribution_ms"].items(), key=lambda kv: -kv[1]
            ):
                print(f"  {seg:<16}{ms:>12.3f} ms")
    if rc:
        return rc
    if args.breach_flag and breach:
        return 3
    return 0


def main(argv=None) -> int:
    path, explicit = peek_options_path(argv)
    args = build_parser(load_peer_options(path, explicit)).parse_args(argv)
    # Records from loggers other than the replica's own (which owns its
    # handler, core/options.py) carry their name and level: a log reader
    # can then tell an ERROR from the client or the engine apart.
    logging.basicConfig(format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.command == "run":
        # Optional uvloop (MINBFT_UVLOOP, auto-detected): must be
        # installed as the policy BEFORE asyncio.run creates the loop.
        from ...utils.loop import maybe_enable_uvloop

        if maybe_enable_uvloop():
            logging.getLogger("minbft.peer").info("event loop: uvloop")
        return asyncio.run(_run_replica(args))
    if args.command == "metrics":
        return _run_metrics_scrape(args)
    if args.command == "top":
        return _run_top(args)
    if args.command == "slo":
        return _run_slo(args)
    if args.command == "request":
        return asyncio.run(_run_request(args))
    if args.command == "bench":
        return asyncio.run(_run_bench_clients(args))
    if args.command == "load":
        return asyncio.run(_run_load(args))
    if args.command == "selftest":
        return asyncio.run(_run_selftest(args))
    if args.command == "testnet":
        return _run_testnet_scaffold(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
