"""USIG interface and UI certificate structure.

Reference usig/usig.go:28-102: ``USIG`` {CreateUI, VerifyUI, ID} and
``UI`` {Counter, Cert} with big-endian binary marshalling.  The UI dataclass
is shared with the messages layer (:class:`minbft_tpu.messages.UI`) — the
wire form is the same object.
"""

from __future__ import annotations

import abc

from ..messages.message import UI

__all__ = ["UI", "USIG", "UsigError", "ui_to_bytes", "ui_from_bytes"]


class UsigError(Exception):
    """UI creation/verification failure."""


def ui_to_bytes(ui: UI) -> bytes:
    """Marshal a UI big-endian (reference usig/usig.go:84-102)."""
    return ui.to_bytes()


def ui_from_bytes(data: bytes) -> UI:
    return UI.from_bytes(data)


class USIG(abc.ABC):
    """The trusted component interface (reference usig/usig.go:28-41).

    Semantics every implementation must uphold (reference
    usig/sgx/enclave/usig.c:36-76):

    - ``create_ui`` assigns the *current* counter value and increments the
      counter only after the certificate is produced, so no counter value
      can ever certify two different messages (comment at usig.c:66-69).
    - Counters start at 1 and are strictly sequential per instance.
    - A fresh random 64-bit ``epoch`` is drawn per instance (usig.c:181);
      certificates from different epochs never verify against each other,
      so a restarted replica cannot equivocate using a reset counter.
    """

    @abc.abstractmethod
    def create_ui(self, message: bytes) -> UI:
        """Certify ``message`` with the next counter value."""

    @abc.abstractmethod
    def verify_ui(self, message: bytes, ui: UI, usig_id: bytes) -> None:
        """Verify ``ui`` over ``message`` against the instance identified by
        ``usig_id``; raises :class:`UsigError` on failure."""

    @abc.abstractmethod
    def id(self) -> bytes:
        """Opaque identity of this instance (epoch + public key material;
        reference usig/sgx/sgx-usig.go:105-122)."""
