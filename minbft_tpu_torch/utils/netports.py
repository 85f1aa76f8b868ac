"""Port helpers shared by the bench harness and the process-cluster tests
(port of :mod:`minbft_tpu.utils.netports`)."""

from __future__ import annotations

import socket
import time


def free_base_port(count: int) -> int:
    """Find ``count`` consecutive free ports (probes close just before
    use — imperfect, but beats a fixed port colliding with a prior run)."""
    while True:
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        if base + count < 65535:
            socks = []
            try:
                for i in range(count):
                    s = socket.socket()
                    socks.append(s)  # append first so it always gets closed
                    s.bind(("127.0.0.1", base + i))
                return base
            except OSError:
                continue
            finally:
                for s in socks:
                    s.close()


def wait_ports(ports, timeout: float = 180.0) -> bool:
    """Poll until every port accepts a connection (or timeout)."""
    deadline = time.time() + timeout
    pending = set(ports)
    while pending and time.time() < deadline:
        for port in list(pending):
            with socket.socket() as s:
                s.settimeout(0.2)
                try:
                    s.connect(("127.0.0.1", port))
                    pending.discard(port)
                except OSError:
                    pass
        if pending:
            time.sleep(0.3)
    return not pending
