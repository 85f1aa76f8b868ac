"""Client protocol library.

Mirrors the reference ``client`` package (reference client/client.go:51-77):
construct and sign a REQUEST, broadcast it to all n replicas, accept the
result once **f+1 matching REPLYs** (keyed by the SHA-256 of the result)
arrive from distinct replicas.
"""

from .client import Client, new_client

__all__ = ["Client", "new_client"]
