"""Replica assembly (reference core/replica.go:50-104).

``new_replica`` validates n >= 2f+1, builds the message log and per-peer
unicast logs, wires the handler graph, and returns an :class:`api.Replica`
whose ``start`` opens peer connections and launches the own-message loop.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from .. import api
from . import message_handling
from .internal.clientstate import ClientStates
from .internal.messagelog import MessageLog
from .internal.timer import TimerProvider
from .utils import make_logger


class Stack(api.Authenticator, api.ReplicaConnector, api.RequestConsumer):
    """The external-modules union the core consumes
    (reference core/replica.go:37-41)."""


class _Replica(api.Replica):
    def __init__(
        self,
        replica_id: int,
        configer: api.Configer,
        authenticator: api.Authenticator,
        connector: api.ReplicaConnector,
        consumer: api.RequestConsumer,
        timer_provider: Optional[TimerProvider] = None,
        logger: Optional[logging.Logger] = None,
        group: Optional[int] = None,
        state_dir: Optional[str] = None,
    ):
        n, f = configer.n, configer.f
        if n < 2 * f + 1:
            # reference core/replica.go:54-56
            raise ValueError(f"n must be at least 2f+1 (n={n}, f={f})")
        if not 0 <= replica_id < n:
            raise ValueError(f"replica id {replica_id} out of range for n={n}")
        self.id = replica_id
        self.n = n
        self.f = f
        self.group = group
        self._connector = connector
        self._done = asyncio.Event()
        self._tasks: list = []
        self._lag_sampler = None

        message_log = MessageLog()
        unicast_logs: Dict[int, MessageLog] = {
            p: MessageLog() for p in range(n) if p != replica_id
        }
        client_states = ClientStates(timer_provider)
        # Durable crash recovery (minbft_tpu_torch.recovery): a state dir gets
        # this replica a durable checkpoint store plus the recovery
        # telemetry manager; without one both stay off (recovery=None).
        recovery = None
        if state_dir:
            from ..recovery import DurableStore, RecoveryManager, store_path

            recovery = RecoveryManager(
                DurableStore(
                    store_path(state_dir, replica_id, group=group), replica_id
                ),
                group=group,
            )
        self.recovery = recovery
        self.handlers = message_handling.Handlers(
            replica_id,
            n,
            f,
            configer,
            authenticator,
            consumer,
            message_log,
            unicast_logs,
            client_states,
            logger or make_logger(replica_id),
            group=group,
            recovery=recovery,
        )

    @property
    def metrics(self):
        """Protocol counters + latency (minbft_tpu_torch.utils.metrics)."""
        return self.handlers.metrics

    @property
    def trace(self):
        """Flight recorder (minbft_tpu_torch.obs.trace), or None when off."""
        return self.handlers.trace

    def peer_message_stream_handler(self) -> api.MessageStreamHandler:
        return message_handling.PeerStreamHandler(self.handlers)

    def client_message_stream_handler(self) -> api.MessageStreamHandler:
        return message_handling.ClientStreamHandler(self.handlers)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        # Crash-consistent restore BEFORE any connection or replay: peers
        # must see the restored position in our HELLOs and LOG-BASE
        # handling, and the own-log replay must start from installed
        # state.  A corrupted store raises CorruptStoreError out of here
        # — deliberately fatal, never a silent fresh start.
        await self.handlers.restore_from_store()
        self._tasks.append(
            loop.create_task(
                message_handling.run_own_message_loop(self.handlers, self._done)
            )
        )
        for peer in range(self.n):
            if peer == self.id:
                continue
            sh = self._connector.replica_message_stream_handler(peer)
            if sh is None:
                raise ValueError(f"no connection for peer {peer}")
            self._tasks.append(
                loop.create_task(
                    message_handling.run_peer_connection(
                        self.handlers, peer, sh, self._done
                    )
                )
            )
        # Event-loop lag sampler (obs/looplag.py): scheduled-vs-actual
        # wakeup delta into metrics.loop_lag — GIL/loop saturation as a
        # scrapeable histogram and a trace-dump extra.
        from ..obs.looplag import maybe_sampler

        self._lag_sampler = maybe_sampler(self.handlers.metrics.loop_lag)
        if self._lag_sampler is not None:
            self._lag_sampler.start()
        # Crash forensics: a protocol task dying with an exception must
        # not take the flight-recorder trace with it — the dump fires on
        # the fatal error, not only on a clean stop() (a crashed soak
        # otherwise loses exactly the trace that explains it).
        for t in self._tasks:
            t.add_done_callback(self._on_task_done)

    def trace_dump_extra(self) -> dict:
        """Cluster-merge context carried in this replica's trace dump:
        n/f (the critpath quorum rank) and the sampled loop-lag
        histogram (the critpath loop_lag segment)."""
        extra = {
            "n": self.n,
            "f": self.f,
            "loop_lag": self.handlers.metrics.loop_lag.to_dict(),
        }
        if self.group is not None:
            extra["group"] = self.group
        return extra

    def dump_trace(self, base=None):
        """Write this replica's flight-recorder dump (None when tracing
        is off or no dump base is configured)."""
        if self.handlers.trace is None:
            return None
        from ..obs import trace as obs_trace

        return obs_trace.dump_recorder(
            self.handlers.trace, base=base, extra=self.trace_dump_extra()
        )

    def _on_task_done(self, task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        self.handlers.log.error(
            "replica %d task %s died: %r", self.id, task.get_name(), exc
        )
        try:
            self.dump_trace()
        except OSError:  # dump target gone — the crash itself still logs
            pass

    async def stop(self) -> None:
        self._done.set()
        if self._lag_sampler is not None:
            self._lag_sampler.stop()
            self._lag_sampler = None
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        # JSON trace dump on shutdown (no-op unless MINBFT_TRACE_DUMP is
        # set): one file per replica, bench.py ingests them.  A crash
        # dump may already exist — this overwrites it with the complete
        # ring (same path, fuller data).
        self.dump_trace()


def new_replica(
    replica_id: int,
    configer: api.Configer,
    authenticator: api.Authenticator,
    connector: api.ReplicaConnector,
    consumer: api.RequestConsumer,
    timer_provider: Optional[TimerProvider] = None,
    logger: Optional[logging.Logger] = None,
    opts=None,
    group: Optional[int] = None,
    state_dir: Optional[str] = None,
) -> api.Replica:
    """Create a replica (reference minbft.New, core/replica.go:50).

    ``opts`` takes functional options from :mod:`minbft_tpu_torch.core.options`
    (reference core/options.go); the explicit ``timer_provider``/``logger``
    keywords remain as shortcuts and win over options."""
    if opts:
        from . import options as options_mod

        resolved = options_mod.resolve(
            replica_id, opts, materialize_logger=logger is None
        )
        timer_provider = timer_provider or resolved.timer_provider
        logger = logger or resolved.logger
    return _Replica(
        replica_id, configer, authenticator, connector, consumer,
        timer_provider, logger, group=group, state_dir=state_dir,
    )
