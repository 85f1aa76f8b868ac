"""Internal state machines of the core protocol engine (reference
core/internal/): per-client request/reply state, per-peer UI sequencing,
view state, the replayable message log, the pending-request list, and an
injectable timer abstraction."""
