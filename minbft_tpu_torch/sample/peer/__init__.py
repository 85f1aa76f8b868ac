"""peer CLI package (reference sample/peer/; port of
:mod:`minbft_tpu.sample.peer`)."""

from .cli import main

__all__ = ["main"]
