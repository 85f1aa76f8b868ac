"""Functional options for replica construction (reference core/options.go:25-58).

The reference configures its logger through functional options passed to
``minbft.New`` (``WithLogLevel``, ``WithLogFile``; default DEBUG to
stdout).  Here options are callables applied to an :class:`Options` holder;
``new_replica(..., opts=[...])`` uses the result to build the per-replica
logger (and to inject a test timer provider).

    replica = new_replica(0, cfg, auth, conn, ledger,
                          opts=[with_log_level(logging.DEBUG),
                                with_log_file("replica0.log")])
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Callable, List, Optional

Option = Callable[["Options"], None]


@dataclasses.dataclass
class Options:
    log_level: int = logging.INFO
    log_file: Optional[str] = None
    log_stream: object = None  # defaults to stderr
    logger: Optional[logging.Logger] = None
    timer_provider: object = None


def with_log_level(level: int) -> Option:
    """Set the logging level (reference WithLogLevel, options.go:36-41)."""

    def apply(o: Options) -> None:
        o.log_level = level

    return apply


def with_log_file(path: str) -> Option:
    """Log to ``path`` instead of the console (reference WithLogFile,
    options.go:43-48)."""

    def apply(o: Options) -> None:
        o.log_file = path

    return apply


def with_log_stream(stream) -> Option:
    """Log to an open stream (stdout, a StringIO, ...)."""

    def apply(o: Options) -> None:
        o.log_stream = stream

    return apply


def with_logger(logger: logging.Logger) -> Option:
    """Use a fully caller-configured logger (bypasses the other log opts)."""

    def apply(o: Options) -> None:
        o.logger = logger

    return apply


def with_timer_provider(provider) -> Option:
    """Inject a timer provider (tests pass FakeTimerProvider,
    the reference's mock timer mechanism)."""

    def apply(o: Options) -> None:
        o.timer_provider = provider

    return apply


def resolve(
    replica_id: int,
    opts: Optional[List[Option]],
    materialize_logger: bool = True,
) -> Options:
    """Apply ``opts`` and (unless the caller already has a logger)
    materialize one — skipping materialization avoids side effects on the
    registry-global logger and stray open file handles."""
    o = Options()
    for opt in opts or ():
        opt(o)
    if o.logger is None and materialize_logger:
        logger = logging.getLogger(f"minbft.replica{replica_id}")
        logger.setLevel(o.log_level)
        # Attach exactly one handler owned by these options (repeat
        # construction in one process must not stack handlers).
        fmt = logging.Formatter(
            f"%(asctime)s [replica {replica_id}] %(levelname)s %(message)s"
        )
        for h in list(logger.handlers):
            if getattr(h, "_minbft_owned", False):
                logger.removeHandler(h)
                h.close()
        if o.log_file is not None:
            handler: logging.Handler = logging.FileHandler(o.log_file)
        else:
            handler = logging.StreamHandler(o.log_stream or sys.stderr)
        handler.setFormatter(fmt)
        handler._minbft_owned = True  # type: ignore[attr-defined]
        logger.addHandler(handler)
        logger.propagate = False
        o.logger = logger
    return o
