"""Request consumers (replicated state machines)."""

from .simpleledger import SimpleLedger

__all__ = ["SimpleLedger"]
