"""USIG UI glue: verify, assign, and capture UIs on certified messages.

Reference core/usig-ui.go:37-91: the verifier rejects a zero counter then
delegates to the Authenticator with the marshalled UI as the tag; the
assigner calls GenerateMessageAuthenTag and attaches the UI; the capturer
enforces once-only in-counter-order processing via peerstate.

The verifier here is a coroutine — with the GPU authenticator, every
concurrently-validated PREPARE/COMMIT UI lands in the same batched kernel
dispatch (the north-star restructuring; the reference verifies these
serially under the processing goroutine).
"""

from __future__ import annotations

from typing import Awaitable, Callable

from .. import api
from ..messages import UI, Message, authen_bytes
from ..usig import ui_from_bytes, ui_to_bytes


def make_ui_verifier(
    authenticator: api.Authenticator,
) -> Callable[[Message], Awaitable[UI]]:
    """Verify a certified message's UI; returns the parsed UI
    (reference makeUIVerifier, core/usig-ui.go:55-77)."""

    async def verify_ui(msg) -> UI:
        ui = msg.ui
        if ui is None:
            raise api.AuthenticationError("missing UI")
        if ui.counter == 0:
            # reference core/usig-ui.go:65-67
            raise api.AuthenticationError("zero UI counter")
        await authenticator.verify_message_authen_tag(
            api.AuthenticationRole.USIG,
            msg.replica_id,
            authen_bytes(msg),
            ui_to_bytes(ui),
        )
        return ui

    return verify_ui


def make_ui_assigner(
    authenticator: api.Authenticator,
) -> Callable[[Message], None]:
    """Assign a fresh UI to an own certified message
    (reference makeUIAssigner, core/usig-ui.go:79-91)."""

    def assign_ui(msg) -> None:
        tag = authenticator.generate_message_authen_tag(
            api.AuthenticationRole.USIG, authen_bytes(msg)
        )
        msg.ui = ui_from_bytes(tag)

    return assign_ui


def make_ui_capturer(peer_states) -> Callable[[Message], Awaitable[bool]]:
    """Capture a peer's UI for exactly-once in-order processing
    (reference makeUICapturer, core/usig-ui.go:46-53 → peerstate.go:81-109)."""

    async def capture_ui(msg) -> bool:
        return await peer_states.peer(msg.replica_id).capture_ui(msg.ui.counter)

    return capture_ui
