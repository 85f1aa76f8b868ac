"""Client-side shard routing for the multi-group runtime (counterpart of
:mod:`minbft_tpu.groups.router`).

A request key deterministically names its consensus group
(:func:`group_for_key`: stable SHA-256 hash — same key, same group,
across restarts, processes, and languages that can compute SHA-256), and
:class:`MultiGroupClient` keeps one inner
:class:`~minbft_tpu_torch.client.client.Client` per group: each group gets its
own client sequence space and its own per-request reply-quorum tracking,
so groups never serialize each other and a replayed (cid, seq) can never
collide across shards.  All G inner clients share ONE physical stream
per replica (:class:`~minbft_tpu_torch.groups.runtime.SharedChannelMux`) —
the client side of the shared-transport design.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Union

from .. import api
from ..client.client import Client
from ..messages import GROUP_MAX
from .runtime import GroupAuthenticator, SharedChannelMux


def group_for_key(key: bytes, n_groups: int) -> int:
    """Stable key-space shard map: SHA-256 of the key, first 8 bytes as
    a big-endian integer, mod G.  Deliberately hash-based (not range-
    based): request keys are operator-chosen byte strings with unknown
    distribution, and a cryptographic hash spreads any of them evenly.
    Deterministic across restarts by construction — no state, no seed."""
    if not 0 < n_groups <= GROUP_MAX + 1:
        raise ValueError(
            f"n_groups must be in 1..{GROUP_MAX + 1}, got {n_groups}"
        )
    if n_groups == 1:
        return 0
    h = hashlib.sha256(key).digest()
    return int.from_bytes(h[:8], "big") % n_groups


class ShardRouter:
    """Key → group mapping for a G-group cluster.  Stateless beyond G;
    exists as an object so callers hold the shard count in one place
    (and so a future directory-based router can swap in behind the same
    two methods)."""

    def __init__(self, n_groups: int):
        if not 0 < n_groups <= GROUP_MAX + 1:
            raise ValueError(
                f"n_groups must be in 1..{GROUP_MAX + 1}, got {n_groups}"
            )
        self.n_groups = n_groups

    def group_for(self, key: bytes) -> int:
        return group_for_key(key, self.n_groups)


class MultiGroupClient:
    """Facade over G per-group clients with shard routing.

    ``authenticators`` is either ONE base client authenticator (shared
    key material — each group's view is domain-separated via
    :class:`GroupAuthenticator`; clients carry no USIG so sharing the
    base across groups is safe) or a list of G per-group instances
    (independent key material, still wrapped for symmetry with the
    replica side).  ``request(operation, key=...)`` routes by the shard
    key (default: the operation bytes themselves), or pin a group
    explicitly with ``group=``.
    """

    def __init__(
        self,
        client_id: int,
        n: int,
        f: int,
        n_groups: int,
        authenticators: Union[api.Authenticator, List[api.Authenticator]],
        connector: api.ReplicaConnector,
        seq_start: Optional[int] = None,
        max_inflight: Optional[int] = None,
        retransmit_interval: Optional[float] = None,
        trace: bool = False,
        domain_separation: bool = True,
    ):
        self.client_id = client_id
        self.router = ShardRouter(n_groups)
        if isinstance(authenticators, list):
            if len(authenticators) != n_groups:
                raise ValueError(
                    f"{len(authenticators)} authenticators for "
                    f"{n_groups} groups"
                )
            auths = list(authenticators)
        else:
            auths = [authenticators] * n_groups
        self._mux = SharedChannelMux(connector)
        self._clients: List[Client] = []
        for g in range(n_groups):
            auth = auths[g]
            if domain_separation:
                auth = GroupAuthenticator(auth, g)
            self._clients.append(
                Client(
                    client_id,
                    n,
                    f,
                    auth,
                    self._mux.group_connector(g),
                    seq_start=seq_start,
                    max_inflight=max_inflight,
                    retransmit_interval=retransmit_interval,
                    trace=trace,
                    group=g,
                )
            )

    @property
    def n_groups(self) -> int:
        return self.router.n_groups

    def client(self, gid: int) -> Client:
        """The inner per-group client (its pending map IS the per-group
        quorum tracking; its ``_seq`` the per-group sequence space)."""
        return self._clients[gid]

    def group_for(self, key: bytes) -> int:
        return self.router.group_for(key)

    async def start(self) -> None:
        for c in self._clients:
            await c.start()

    async def stop(self) -> None:
        self._mux.seal()
        for c in self._clients:
            await c.stop()
        await self._mux.close()

    async def request(
        self,
        operation: bytes,
        key: Optional[bytes] = None,
        group: Optional[int] = None,
        **kw,
    ) -> bytes:
        """Submit ``operation`` to its shard's group.  ``key`` is the
        shard key (default: the operation bytes); ``group`` pins a group
        outright (operator tooling, tests).  Everything else — timeouts,
        read_only, pipelining — is the inner client's contract."""
        if group is None:
            group = self.router.group_for(operation if key is None else key)
        elif not 0 <= group < self.n_groups:
            raise ValueError(f"group {group} out of range (G={self.n_groups})")
        return await self._clients[group].request(operation, **kw)
