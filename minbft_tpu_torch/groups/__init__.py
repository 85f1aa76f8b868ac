"""Multi-group consensus sharding of the port: one engine, G groups
(counterpart of :mod:`minbft_tpu.groups`).

One MinBFT group sends the card a few dozen checks a batch while a
kernel launch can take thousands of lanes; G independent groups — one
per key-space shard — send more, and the engine's verify/sign queues are
exactly the right place to coalesce batches ACROSS groups so the device
sees one big batch regardless of group count (the DSig amortization
argument, PAPERS.md).  Every group core of a process shares that
process's one :class:`~minbft_tpu_torch.parallel.BatchVerifier`, on the
card unless the caller asks for the CPU.

- :class:`GroupRuntime` — N replica processes each hosting G
  independent replica cores (own view/sequence/USIG-counter space, own
  message log and checkpoints) over SHARED transport and ONE shared
  ``parallel/engine``; frames carry a transport-level group tag
  (``messages.codec.pack_group``) and the grouped client stream runs
  one bundle-ingest drain whose tick bundles span groups.
- :class:`ShardRouter` / :class:`MultiGroupClient` — client-side
  key-space sharding: a stable hash maps request keys to groups, each
  group gets its own client sequence space and reply-quorum tracking.
- :class:`GroupAuthenticator` — per-group signature domain separation
  (the group tag is transport-level and unsigned; without domain
  separation a message signed for group g could replay into group g').
"""

from .router import MultiGroupClient, ShardRouter, group_for_key
from .runtime import (
    GroupAuthenticator,
    GroupRuntime,
    SharedChannelMux,
    new_group_runtime,
)

__all__ = [
    "GroupAuthenticator",
    "GroupRuntime",
    "MultiGroupClient",
    "ShardRouter",
    "SharedChannelMux",
    "group_for_key",
    "new_group_runtime",
]
