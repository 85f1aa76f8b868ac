"""The port's crash-recovery modules (minbft_tpu_torch/recovery/) against
the reference's (minbft_tpu/recovery/).

First the reference's own scenarios (tests/test_recovery.py: the durable
store's atomic save and paranoid load, chunking and the digest chain,
the handlers' serve/resume/failover/install paths, the durable save and
the startup restore through the f+1 certificate check, ProcessChaos) on
the port's classes.  Then the two packages side by side on the same
seeded inputs: a store file written by either restores in the other and
both write the same bytes; ``iter_chunks`` and the chain give the same
bytes; the assemblers give the same verdicts on the same chunk scripts;
the ``RecoveryInvariantChecker`` s give the same summaries (or the same
violation) on the same store files.  Last, what the recovery soak found:
overlapping saves on one store (the reference's race on its temp file),
the timers a state-transfer install leaves running, and a view change's
re-certification logged as a divergence.
"""

import asyncio
import hashlib
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

import minbft_tpu.messages as ref_messages
import minbft_tpu.recovery as ref_recovery
from minbft_tpu.core import checkpoint as ref_checkpoint
from minbft_tpu.recovery import store as ref_store
from minbft_tpu.recovery import transfer as ref_transfer
from minbft_tpu.testing import invariants as ref_invariants
import minbft_tpu_torch.messages as port_messages
import minbft_tpu_torch.recovery as port_recovery
from minbft_tpu_torch import api
from minbft_tpu_torch.core import checkpoint as port_checkpoint
from minbft_tpu_torch.core.checkpoint import checkpoint_digest
from minbft_tpu_torch.core.internal.clientstate import ClientStates
from minbft_tpu_torch.core.internal.messagelog import MessageLog
from minbft_tpu_torch.core.message_handling import Handlers
from minbft_tpu_torch.messages import (
    UI,
    Checkpoint,
    Request,
    StateChunk,
    StateDone,
    StateReq,
)
from minbft_tpu_torch.recovery import (
    CorruptStoreError,
    DurableStore,
    RecoveryManager,
    StableState,
)
from minbft_tpu_torch.recovery import manager as recovery_manager
from minbft_tpu_torch.recovery import store as recovery_store
from minbft_tpu_torch.recovery import transfer
from minbft_tpu_torch.sample.config import SimpleConfiger
from minbft_tpu_torch.testing import invariants as port_invariants
from minbft_tpu_torch.usig import ui_to_bytes

# Each package's classes under one set of names, for the side-by-side cases.
PKGS = {
    "port": types.SimpleNamespace(
        msgs=port_messages, rec=port_recovery, store=recovery_store,
        transfer=transfer, inv=port_invariants, ckpt=port_checkpoint,
        digest=port_checkpoint.checkpoint_digest),
    "ref": types.SimpleNamespace(
        msgs=ref_messages, rec=ref_recovery, store=ref_store,
        transfer=ref_transfer, inv=ref_invariants, ckpt=ref_checkpoint,
        digest=ref_checkpoint.checkpoint_digest),
}


# ---------------------------------------------------------------------------
# Fixtures / helpers (the reference's, over the port's classes)


def _cp(replica, count=8, view=0, cv=8, digest=b"d" * 32):
    return Checkpoint(
        replica_id=replica, count=count, view=view, cv=cv, digest=digest,
        signature=b"sig",
    )


def _state(count=8, view=0, cv=8, app=b"app-bytes", marks=((1, 2),),
           usig=5, digest=None):
    digest = digest if digest is not None else b"d" * 32
    cert = (_cp(1, count, view, cv, digest), _cp(2, count, view, cv, digest))
    return StableState(
        count=count, view=view, cv=cv, usig_counter=usig, app_state=app,
        watermarks=tuple(marks), cert=cert,
    )


class _Auth(api.Authenticator):
    def __init__(self):
        self.counter = 0

    def generate_message_authen_tag(self, role, data, audience=-1):
        if role is api.AuthenticationRole.USIG:
            self.counter += 1
            return ui_to_bytes(UI(counter=self.counter, cert=b"cert"))
        return b"sig"

    async def verify_message_authen_tag(self, role, peer_id, data, tag):
        return None


class _SnapConsumer(api.RequestConsumer):
    """A consumer with real snapshot support: digest = sha256(bytes)."""

    def __init__(self):
        self.installed = None

    async def deliver(self, operation: bytes) -> bytes:
        return b"ok:" + operation

    def state_digest(self) -> bytes:
        return b""

    def snapshot_digest(self, data: bytes) -> bytes:
        return hashlib.sha256(data).digest()

    def install_snapshot(self, data: bytes) -> None:
        self.installed = data


def _handlers(replica_id=0, n=4, f=1, consumer=None, recovery=None):
    unicast = {p: MessageLog() for p in range(n) if p != replica_id}
    return Handlers(
        replica_id,
        n,
        f,
        SimpleConfiger(n=n, f=f, timeout_request=60.0, timeout_prepare=60.0),
        _Auth(),
        consumer if consumer is not None else _SnapConsumer(),
        MessageLog(),
        unicast,
        ClientStates(),
        recovery=recovery,
    )


def _composite(app, count, view, cv, marks):
    return checkpoint_digest(
        hashlib.sha256(app).digest(), count, view, cv, marks
    )


def _chunks_for(app, count, size):
    """Honest responder's chunk stream for ``app`` (chain from byte 0)."""
    out = []
    chain = b""
    for off, piece in transfer.iter_chunks(app, size):
        chain = transfer.chain_extend(chain, piece)
        out.append(
            StateChunk(
                replica_id=1, count=count, offset=off, total=len(app),
                data=piece, chain=chain,
            )
        )
    return out


def _cancel_timer(h):
    if h._snapshot_timer is not None:
        h._snapshot_timer.cancel()


# ---------------------------------------------------------------------------
# Durable store: atomic save, paranoid load


def test_store_round_trip(tmp_path):
    path = str(tmp_path / "replica0.state")
    st = _state(count=8, view=1, cv=8, usig=17, marks=((1, 2), (9, 44)))
    store = DurableStore(path, 0)
    assert store.save(st) is True
    got = DurableStore(path, 0).load()
    assert got == st
    assert not os.path.exists(path + ".tmp")


def test_store_missing_file_is_fresh_start(tmp_path):
    assert DurableStore(str(tmp_path / "none.state"), 0).load() is None


def test_store_save_never_regresses(tmp_path):
    path = str(tmp_path / "replica0.state")
    store = DurableStore(path, 0)
    assert store.save(_state(count=10)) is True
    # equal and lower counts are refused without touching the file
    assert store.save(_state(count=10)) is False
    assert store.save(_state(count=4)) is False
    assert DurableStore(path, 0).load().count == 10
    assert store.save(_state(count=11)) is True
    assert DurableStore(path, 0).load().count == 11


def test_store_learns_incumbent_bound_across_restart(tmp_path):
    """A NEW DurableStore over an existing file (the restart case) must
    not clobber a newer persisted bound with a lagging save."""
    path = str(tmp_path / "replica0.state")
    DurableStore(path, 0).save(_state(count=16))
    fresh = DurableStore(path, 0)
    assert fresh.save(_state(count=8)) is False
    assert DurableStore(path, 0).load().count == 16
    assert fresh.save(_state(count=24)) is True


@pytest.mark.parametrize("committed", [True, False], ids=["beside-committed", "tmp-only"])
def test_store_torn_tmp_is_discarded_not_trusted(tmp_path, committed):
    """A torn temp file (a crash mid-save) is discarded unread: beside a
    committed file the committed state loads, alone it is a fresh start."""
    path = str(tmp_path / "replica0.state")
    if committed:
        DurableStore(path, 0).save(_state(count=8))
    with open(path + ".tmp", "wb") as fh:
        fh.write(b"half-written garbage")
    got = DurableStore(path, 0).load()
    assert (got.count if got else None) == (8 if committed else None)
    assert not os.path.exists(path + ".tmp"), "torn temp not discarded"


def _flip_middle(raw, _st):
    bad = bytearray(raw)
    bad[len(raw) // 2] ^= 0xFF
    return bytes(bad)


def _bad_magic(raw, _st):
    # re-seal a payload with wrong magic but a VALID digest trailer: only
    # the magic check can reject it
    payload = bytearray(raw[:-32])
    payload[:4] = b"XXXX"
    return bytes(payload) + hashlib.sha256(bytes(payload)).digest()


def _trailing_garbage(_raw, st):
    payload = recovery_store._encode(0, st)[:-32] + b"extra"
    return payload + hashlib.sha256(payload).digest()


def _non_checkpoint_cert(_raw, _st):
    req = Request(client_id=1, seq=1, operation=b"x")
    req.signature = b"sig"
    bad = StableState(
        count=8, view=0, cv=8, usig_counter=1, app_state=b"", watermarks=(),
        cert=(req,),  # type: ignore[arg-type]
    )
    return recovery_store._encode(0, bad)


@pytest.mark.parametrize("owner,mangle,match", [
    (0, _flip_middle, None),
    (0, lambda raw, _st: raw[:10], None),  # too short for the trailer
    (3, lambda raw, _st: raw, "belongs to replica 0"),
    (0, _bad_magic, "magic"),
    (0, _trailing_garbage, "trailing garbage"),
    (0, _non_checkpoint_cert, "not a CHECKPOINT"),
], ids=["flipped-byte", "truncated", "wrong-owner", "bad-magic", "trailing-garbage",
        "non-checkpoint-cert"])
def test_store_corrupt_committed_file_is_fatal(tmp_path, owner, mangle, match):
    path = str(tmp_path / "replica0.state")
    st = _state(count=8)
    DurableStore(path, 0).save(st)
    with open(path, "rb") as fh:
        raw = fh.read()
    with open(path, "wb") as fh:
        fh.write(mangle(raw, st))
    with pytest.raises(CorruptStoreError, match=match):
        DurableStore(path, owner).load()


# ---------------------------------------------------------------------------
# Chunking + chain (transfer module)


def test_iter_chunks_and_assembler_round_trip():
    app = np.random.default_rng(1).bytes(1000)
    asm = transfer.ChunkAssembler(count=8)
    chain = b""
    for off, piece in transfer.iter_chunks(app, 64):
        chain = transfer.chain_extend(chain, piece)
        assert asm.add(off, len(app), piece, chain) is True
    assert asm.complete and asm.bytes() == app
    assert list(transfer.iter_chunks(b"", 64)) == []


def test_assembler_stale_replay_and_gap_are_ignored():
    app = b"A" * 64 + b"B" * 64
    asm = transfer.ChunkAssembler(count=8)
    chunks = _chunks_for(app, 8, 64)
    assert asm.add(0, len(app), chunks[0].data, chunks[0].chain) is True
    # reconnect replay of the verified prefix: idempotent no-op
    assert asm.add(0, len(app), chunks[0].data, chunks[0].chain) is False
    assert asm.offset == 64
    # a gap above the verified prefix: wait for the in-order copy
    assert asm.add(128, len(app), b"C" * 64, b"x" * 32) is False
    assert asm.add(64, len(app), chunks[1].data, chunks[1].chain) is True
    assert asm.complete


def test_assembler_chain_mismatch_total_shift_and_overrun():
    app = b"A" * 64 + b"B" * 64
    chunks = _chunks_for(app, 8, 64)
    asm = transfer.ChunkAssembler(count=8)
    asm.add(0, len(app), chunks[0].data, chunks[0].chain)
    with pytest.raises(transfer.ChainMismatch, match="chain digest"):
        asm.add(64, len(app), b"EVIL" + chunks[1].data[4:], chunks[1].chain)
    with pytest.raises(transfer.ChainMismatch, match="length changed"):
        asm.add(64, len(app) + 1, chunks[1].data, chunks[1].chain)
    # overrun: a chunk whose bytes extend past the pinned total
    asm2 = transfer.ChunkAssembler(count=8)
    big = app + b"C" * 8
    chain = transfer.chain_extend(b"", big)
    with pytest.raises(transfer.ChainMismatch, match="overruns"):
        asm2.add(0, len(app), big, chain)


@pytest.mark.parametrize("value,want", [
    (None, "default"), ("4096", 4096), ("0", 1), (str(10**9), "max"), ("junk", "default"),
])
def test_chunk_bytes_env_knob_is_clamped(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv(transfer.CHUNK_BYTES_ENV, raising=False)
    else:
        monkeypatch.setenv(transfer.CHUNK_BYTES_ENV, value)
    want = {"default": transfer.DEFAULT_CHUNK_BYTES,
            "max": transfer.MAX_CHUNK_BYTES}.get(want, want)
    assert transfer.chunk_bytes() == want


# ---------------------------------------------------------------------------
# Handlers: serving, assembling, resume, failover, install


def test_state_req_serves_chunk_aligned_resume(monkeypatch):
    """The responder recomputes the chain from byte 0 but transmits only
    the missing tail; a fresh STATE-REQ prunes the superseded stream from
    the requester's unicast log first."""
    monkeypatch.setenv(transfer.CHUNK_BYTES_ENV, "4")

    async def scenario():
        h = _handlers(replica_id=0)
        app = b"0123456789AB"  # 3 chunks of 4
        h.checkpoint_emitter._snapshots[8] = (0, 8, app, ((1, 2),))

        assert await h._process_state_req(
            StateReq(replica_id=1, count=8, offset=0)
        ) is True
        msgs = h.unicast_logs[1].snapshot()
        chunks, done = msgs[:-1], msgs[-1]
        assert [c.offset for c in chunks] == [0, 4, 8]
        assert isinstance(done, StateDone) and done.total == len(app)
        assert b"".join(c.data for c in chunks) == app
        chain = b""
        for c in chunks:
            chain = transfer.chain_extend(chain, c.data)
            assert c.chain == chain

        assert await h._process_state_req(
            StateReq(replica_id=1, count=8, offset=8)
        ) is True
        msgs = h.unicast_logs[1].snapshot()
        assert [type(m).__name__ for m in msgs] == ["StateChunk", "StateDone"]
        assert msgs[0].offset == 8 and msgs[0].chain == chain
        assert h.metrics.counters["state_chunks_sent"] == 4
        return True

    assert asyncio.run(scenario())


def test_corrupt_chunk_fails_over_to_next_source():
    """A chain mismatch is Byzantine evidence: the stream is abandoned,
    the corrupt counter ticks, and a fresh STATE-REQ (offset 0) goes to
    the NEXT source in the rotation."""

    async def scenario():
        h = _handlers(replica_id=0)
        app = b"A" * 64 + b"B" * 64
        digest = _composite(app, 8, 0, 8, ())
        cert = (_cp(1, digest=digest), _cp(2, digest=digest))
        await h._request_state(cert, first_source=1)
        try:
            assert h._state_source == 1
            chunks = _chunks_for(app, 8, 64)
            assert await h._process_state_chunk(chunks[0]) is True
            evil = StateChunk(
                replica_id=1, count=8, offset=64, total=len(app),
                data=b"EVIL" + chunks[1].data[4:], chain=chunks[1].chain,
            )
            assert await h._process_state_chunk(evil) is False
            assert h.metrics.counters["state_transfer_corrupt"] == 1
            assert h.metrics.counters["state_transfer_failovers"] == 1
            assert h._state_asm is None
            assert h._state_source == 2, "did not rotate off the liar"
            req = h.unicast_logs[2].snapshot()[-1]
            assert isinstance(req, StateReq) and req.offset == 0
        finally:
            _cancel_timer(h)
        return True

    assert asyncio.run(scenario())


def test_resume_keeps_source_and_verified_offset():
    """The mid-transfer-reset path: resume re-asks the SAME source from
    the assembler's verified offset — nothing verified is re-downloaded."""

    async def scenario():
        h = _handlers(replica_id=0)
        app = b"A" * 64 + b"B" * 64
        digest = _composite(app, 8, 0, 8, ())
        cert = (_cp(1, digest=digest), _cp(2, digest=digest))
        await h._request_state(cert, first_source=1)
        try:
            chunks = _chunks_for(app, 8, 64)
            assert await h._process_state_chunk(chunks[0]) is True
            h._send_state_req(resume=True)
            assert h._state_source == 1, "resume must not rotate"
            req = h.unicast_logs[1].snapshot()[-1]
            assert isinstance(req, StateReq)
            assert req.offset == 64 and req.count == 8
            assert h.metrics.counters["state_transfer_resumes"] == 1
            assert "state_transfer_failovers" not in h.metrics.counters
            assert await h._process_state_chunk(chunks[0]) is False
            assert h.metrics.counters["state_chunks_received"] == 1
        finally:
            _cancel_timer(h)
        return True

    assert asyncio.run(scenario())


def test_done_with_incomplete_assembly_waits_for_retry():
    """A DONE replayed ahead of its chunks (reconnect reorder) must not
    fail the transfer over — the retry timer resumes from the verified
    offset."""

    async def scenario():
        h = _handlers(replica_id=0)
        app = b"A" * 64 + b"B" * 64
        digest = _composite(app, 8, 0, 8, ())
        cert = (_cp(1, digest=digest), _cp(2, digest=digest))
        await h._request_state(cert, first_source=1)
        try:
            chunks = _chunks_for(app, 8, 64)
            await h._process_state_chunk(chunks[0])
            done = StateDone(
                replica_id=1, count=8, view=0, cv=8, total=len(app),
                watermarks=(),
            )
            assert await h._process_state_done(done) is False
            assert "state_transfer_corrupt" not in h.metrics.counters
            assert h._state_asm is not None and h._state_asm.offset == 64
            assert h._state_source == 1
        finally:
            _cancel_timer(h)
        return True

    assert asyncio.run(scenario())


def test_chunked_transfer_installs_certified_state():
    """End-to-end happy path: chunks assemble, DONE resolves the target,
    the composite digest verifies against the f+1 certificate, and the
    snapshot installs (state, watermarks, execution position)."""

    async def scenario():
        consumer = _SnapConsumer()
        h = _handlers(replica_id=0, consumer=consumer)
        app = b"A" * 64 + b"B" * 32
        marks = ((1, 2), (5, 7))
        digest = _composite(app, 8, 0, 8, marks)
        cert = (_cp(1, digest=digest), _cp(2, digest=digest))
        await h._request_state(cert, first_source=1)
        for ck in _chunks_for(app, 8, 64):
            await h._process_state_chunk(ck)
        done = StateDone(
            replica_id=1, count=8, view=0, cv=8, total=len(app),
            watermarks=marks,
        )
        assert await h._process_state_done(done) is True
        assert consumer.installed == app
        assert h._snapshot_expect is None and h._snapshot_timer is None
        assert h.checkpoint_emitter.count == 8
        assert h._exec_pos == (0, 8)
        assert h.metrics.counters["state_transfers"] == 1
        return True

    assert asyncio.run(scenario())


def test_self_consistent_garbage_fails_certificate_and_fails_over():
    """A stream whose chain verifies but whose content does not match the
    f+1-certified composite digest is Byzantine garbage: refused, counted
    corrupt, failed over."""

    async def scenario():
        h = _handlers(replica_id=0)
        app = b"A" * 64
        cert = (_cp(1, digest=b"X" * 32), _cp(2, digest=b"X" * 32))
        await h._request_state(cert, first_source=1)
        try:
            for ck in _chunks_for(app, 8, 64):
                await h._process_state_chunk(ck)
            done = StateDone(
                replica_id=1, count=8, view=0, cv=8, total=len(app),
                watermarks=(),
            )
            assert await h._process_state_done(done) is False
            assert h.metrics.counters["state_transfer_corrupt"] == 1
            assert h._state_source == 2, "no failover after certified refusal"
        finally:
            _cancel_timer(h)
        return True

    assert asyncio.run(scenario())


# ---------------------------------------------------------------------------
# Handlers: durable save + startup restore


def test_stable_checkpoint_persists_verified_state(tmp_path):
    """_spawn_durable_save re-verifies the snapshot against the stable
    composite digest before persisting — the store only ever holds state
    the certificate vouches for."""

    async def scenario():
        path = str(tmp_path / "replica0.state")
        rec = RecoveryManager(store=DurableStore(path, 0))
        h = _handlers(replica_id=0, recovery=rec)
        app, marks = b"ledger-bytes", ((1, 2),)
        digest = _composite(app, 8, 0, 8, marks)
        coll = h.checkpoint_collector
        coll.stable_count, coll.stable_view, coll.stable_cv = 8, 0, 8
        coll.stable_digest = digest
        coll._stable_cert = {
            1: _cp(1, digest=digest), 2: _cp(2, digest=digest),
        }
        h.checkpoint_emitter._snapshots[8] = (0, 8, app, marks)
        h._spawn_durable_save()
        for _ in range(100):
            if rec.saves:
                break
            await asyncio.sleep(0.01)
        assert rec.saves == 1
        assert h.metrics.counters["recovery_saves"] == 1
        got = DurableStore(path, 0).load()
        assert (got.count, got.view, got.cv) == (8, 0, 8)
        assert got.app_state == app and got.watermarks == marks
        assert len(got.cert) == h.f + 1

        # divergence guard: a snapshot that no longer matches the stable
        # digest is NEVER persisted
        coll.stable_digest = b"Z" * 32
        coll.stable_count = 16
        h.checkpoint_emitter._snapshots[16] = (0, 16, app, marks)
        h._spawn_durable_save()
        await asyncio.sleep(0.05)
        assert rec.saves == 1 and DurableStore(path, 0).load().count == 8
        return True

    assert asyncio.run(scenario())


@pytest.mark.parametrize("certified_app,state", [(b"ledger-bytes", "the same"),
                                                 (b"forked-bytes", "another")])
def test_a_snapshot_certified_in_another_view_is_not_persisted_and_says_whose_state(
        tmp_path, certified_app, state):
    """A count executed here in view 0 and certified in view 1 never
    matches the stable digest (it covers the view), so the snapshot is
    not persisted; the ERROR record names both views and whether the
    state under the certified view matches, and only the same state
    passes ``chip_smoke.recertified`` (a fork never does)."""
    import logging

    import chip_smoke

    records = []
    # the replica's own logger (another test may have stopped it
    # propagating to the root)
    errors = logging.Handler(logging.ERROR)
    errors.emit = lambda r: records.append(r.getMessage())

    async def scenario():
        rec = RecoveryManager(store=DurableStore(str(tmp_path / "replica2.state"), 2))
        h = _handlers(replica_id=2, recovery=rec)
        marks = ((1, 2),)
        coll = h.checkpoint_collector
        coll.stable_count, coll.stable_view, coll.stable_cv = 8, 1, 9
        coll.stable_digest = _composite(certified_app, 8, 1, 9, marks)
        h.checkpoint_emitter._snapshots[8] = (0, 8, b"ledger-bytes", marks)
        h.log.addHandler(errors)
        try:
            h._spawn_durable_save()
            await asyncio.sleep(0.05)
        finally:
            h.log.removeHandler(errors)
        return rec.saves

    assert asyncio.run(scenario()) == 0
    assert not os.path.exists(tmp_path / "replica2.state")
    assert records == [
        "local snapshot at 8 diverges from the stable digest — not persisting "
        f"(executed in view 0 cv 8, certified in view 1 cv 9: {state} state)"]
    assert chip_smoke.recertified(f"ERROR {records[0]}") is (state == "the same")


def test_restore_from_store_round_trip(tmp_path):
    """Startup restore re-validates the f+1 certificate and recomputes
    the composite digest, then installs and arms the recovery clock."""

    async def scenario():
        path = str(tmp_path / "replica0.state")
        app, marks = b"ledger-bytes", ((7, 3),)
        digest = _composite(app, 8, 1, 8, marks)
        cert = (
            _cp(1, count=8, view=1, cv=8, digest=digest),
            _cp(2, count=8, view=1, cv=8, digest=digest),
        )
        DurableStore(path, 0).save(
            StableState(
                count=8, view=1, cv=8, usig_counter=5, app_state=app,
                watermarks=marks, cert=cert,
            )
        )
        consumer = _SnapConsumer()
        rec = RecoveryManager(store=DurableStore(path, 0))
        h = _handlers(replica_id=0, consumer=consumer, recovery=rec)
        await h.restore_from_store()
        assert consumer.installed == app
        assert rec.restored_count == 8
        assert rec.phase == recovery_manager.PHASE_CATCHUP
        assert rec.armed, "recovery clock not armed after restore"
        assert h._exec_pos == (1, 8)
        assert h.checkpoint_emitter.count == 8
        assert h.metrics.counters["recovery_restores"] == 1
        # first executed request stops the clock and completes the phases
        rec.note_executed()
        assert rec.recovery_time_ms is not None
        assert rec.phase == recovery_manager.PHASE_DONE
        return True

    assert asyncio.run(scenario())


def test_restore_empty_store_is_clean_fresh_start(tmp_path):
    async def scenario():
        rec = RecoveryManager(
            store=DurableStore(str(tmp_path / "none.state"), 0)
        )
        h = _handlers(replica_id=0, recovery=rec)
        await h.restore_from_store()
        assert rec.phase == recovery_manager.PHASE_IDLE
        assert not rec.armed and rec.restored_count is None
        return True

    assert asyncio.run(scenario())


def _digest_mismatch_state():
    # structurally valid cert, but its digest does not match the snapshot
    return _state(count=8, digest=b"Z" * 32)


def _undersized_cert_state():
    digest = _composite(b"x", 8, 0, 8, ())
    return StableState(
        count=8, view=0, cv=8, usig_counter=1, app_state=b"x",
        watermarks=(), cert=(_cp(1, digest=digest),),  # f claims
    )


@pytest.mark.parametrize("make,match", [
    (_digest_mismatch_state, "certificate"),
    (_undersized_cert_state, "certificate invalid"),
], ids=["digest-mismatch", "undersized-certificate"])
def test_restore_rejects_an_uncertified_store_as_corrupt(tmp_path, make, match):
    """A store whose snapshot fails the certified composite digest, or
    whose certificate is short of f + 1 claims, is CorruptStoreError — the
    file is a cache of certified state, never an authority."""

    async def scenario():
        path = str(tmp_path / "replica0.state")
        DurableStore(path, 0).save(make())
        rec = RecoveryManager(store=DurableStore(path, 0))
        h = _handlers(replica_id=0, recovery=rec)
        with pytest.raises(CorruptStoreError, match=match):
            await h.restore_from_store()
        return True

    assert asyncio.run(scenario())


def test_process_chaos_kill_restart_census():
    from minbft_tpu_torch.testing import ProcessChaos

    def spawn():
        return subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(60)"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    chaos = ProcessChaos()
    try:
        chaos.manage("r0", spawn)
        assert chaos.alive("r0")
        pid = chaos.proc("r0").pid
        chaos.kill("r0")
        assert not chaos.alive("r0")
        chaos.restart("r0")
        assert chaos.alive("r0") and chaos.proc("r0").pid != pid
        chaos.kill_restart("r0")
        assert chaos.alive("r0")
        assert chaos.census.snapshot()["counters"] == {"crash": 2, "restart": 2}
    finally:
        chaos.terminate_all()
    assert not chaos.alive("r0")


# ---------------------------------------------------------------------------
# The two packages side by side


def _pkg_state(pkg, seed: int, consistent: bool = True):
    """A seeded stable state built from ``pkg``'s classes: app bytes,
    watermarks and position from numpy, a certificate of f + 1 = 2
    claims whose digest is the composite over sha256(app) (or a wrong one
    unless ``consistent``)."""
    rng = np.random.default_rng(seed)
    app = rng.bytes(int(rng.integers(0, 3000)))
    count = int(rng.integers(1, 10_000))
    view = int(rng.integers(0, 4))
    cv = int(rng.integers(1, 2000))
    marks = tuple(sorted((int(c), int(s)) for c, s in rng.integers(0, 1 << 20, size=(3, 2))))
    digest = (pkg.digest(hashlib.sha256(app).digest(), count, view, cv, marks)
              if consistent else rng.bytes(32))
    cert = tuple(pkg.msgs.Checkpoint(replica_id=r, count=count, view=view, cv=cv,
                                     digest=digest, signature=rng.bytes(64))
                 for r in (1, 2))
    return pkg.rec.StableState(count=count, view=view, cv=cv,
                               usig_counter=int(rng.integers(0, 1 << 40)), app_state=app,
                               watermarks=marks, cert=cert)


def _fields(st) -> tuple:
    """A stable state as plain values (the certificate as its wire bytes)."""
    return (st.count, st.view, st.cv, st.usig_counter, st.app_state, st.watermarks,
            tuple((c.replica_id, c.count, c.view, c.cv, c.digest, c.signature)
                  for c in st.cert))


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_store_file_written_by_either_package_restores_in_the_other(
        tmp_path, writer, reader, seed):
    w, r = PKGS[writer], PKGS[reader]
    st = _pkg_state(w, seed)
    path = str(tmp_path / "replica2.state")
    assert w.rec.DurableStore(path, 2).save(st) is True
    got = r.rec.DurableStore(path, 2).load()
    assert type(got).__module__.startswith(r.rec.__name__)
    assert _fields(got) == _fields(st)
    # and both packages write the same bytes for the same state
    other = str(tmp_path / "other.state")
    assert r.rec.DurableStore(other, 2).save(got) is True
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    # a byte flipped in it is refused by both
    with open(path, "rb") as fh:
        raw = bytearray(fh.read())
    raw[len(raw) // 3] ^= 0x01
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
    for pkg in (w, r):
        with pytest.raises(pkg.rec.CorruptStoreError):
            pkg.rec.DurableStore(path, 2).load()


@pytest.mark.parametrize("length,size", [(0, 64), (1, 1), (1000, 64), (4096, 2048),
                                         (5000, 2048), (777, 7)])
def test_iter_chunks_and_chain_bytes_equal_the_reference(length, size):
    app = np.random.default_rng(length + size).bytes(length)
    out = {}
    for name, pkg in PKGS.items():
        chain, rows = b"", []
        for off, piece in pkg.transfer.iter_chunks(app, size):
            chain = pkg.transfer.chain_extend(chain, piece)
            rows.append((off, piece, chain))
        out[name] = rows
    assert out["port"] == out["ref"]
    assert b"".join(p for _, p, _ in out["port"]) == app


def _script(name, app, size):
    """(offset, total, data, chain) steps of one chunk script over an
    honest stream of ``app`` in ``size`` chunks."""
    honest, chain = [], b""
    for off, piece in ref_transfer.iter_chunks(app, size):
        chain = ref_transfer.chain_extend(chain, piece)
        honest.append((off, len(app), piece, chain))
    total = len(app)
    if name == "in-order":
        return honest
    if name == "stale-replay":
        return [honest[0], honest[0], honest[1], honest[0], *honest[2:]]
    if name == "gap":
        return [honest[0], honest[2], honest[1], honest[2], *honest[3:]]
    if name == "corrupt-data":
        off, tot, piece, ch = honest[1]
        return [honest[0], (off, tot, b"EVIL" + piece[4:], ch)]
    if name == "corrupt-chain":
        off, tot, piece, _ = honest[1]
        return [honest[0], (off, tot, piece, b"\x00" * 32)]
    if name == "total-shift":
        off, _, piece, ch = honest[1]
        return [honest[0], (off, total + 1, piece, ch)]
    if name == "overrun":
        big = app + b"C" * 8
        return [(0, total, big, ref_transfer.chain_extend(b"", big))]
    raise ValueError(name)


SCRIPTS = ("in-order", "stale-replay", "gap", "corrupt-data", "corrupt-chain",
           "total-shift", "overrun")


@pytest.mark.parametrize("name", SCRIPTS)
def test_assemblers_give_the_reference_verdicts(name):
    app = np.random.default_rng(11).bytes(300)
    steps = _script(name, app, 64)
    verdicts = {}
    for pkg_name, pkg in PKGS.items():
        asm = pkg.transfer.ChunkAssembler(count=8)
        out = []
        for off, total, piece, chain in steps:
            try:
                out.append(asm.add(off, total, piece, chain))
            except pkg.transfer.ChainMismatch as e:
                out.append(("ChainMismatch", str(e)))
                break
        out.append((asm.offset, asm.complete, asm.bytes() if asm.complete else None))
        verdicts[pkg_name] = out
    assert verdicts["port"] == verdicts["ref"]
    if name in ("in-order", "stale-replay", "gap"):
        assert verdicts["port"][-1] == (len(app), True, app)
    else:
        assert verdicts["port"][-2][0] == "ChainMismatch"


def _write_stores(pkg, d, case: str) -> dict:
    """{replica: path} of the store files for one checker case, written
    with ``pkg``'s classes (the same bytes either way)."""
    paths = {i: os.path.join(d, f"replica{i}.state") for i in range(3)}
    states = {i: _pkg_state(pkg, 20 + i) for i in range(3)}
    if case == "fork":
        # replica 1 claims replica 0's position with another digest
        s0, s1 = states[0], _pkg_state(pkg, 21, consistent=False)
        cert = tuple(pkg.msgs.Checkpoint(replica_id=c.replica_id, count=s0.count, view=s0.view,
                                         cv=s0.cv, digest=c.digest, signature=c.signature)
                     for c in s1.cert)
        states[1] = pkg.rec.StableState(count=s0.count, view=s0.view, cv=s0.cv,
                                        usig_counter=1, app_state=s1.app_state,
                                        watermarks=s1.watermarks, cert=cert)
    elif case == "digest-mismatch":
        states[2] = _pkg_state(pkg, 22, consistent=False)
    elif case == "undersized":
        st = states[1]
        states[1] = pkg.rec.StableState(**{**st.__dict__, "cert": st.cert[:1]})
    elif case == "duplicate-claimant":
        st = states[1]
        states[1] = pkg.rec.StableState(**{**st.__dict__, "cert": (st.cert[0], st.cert[0])})
    elif case == "position-mismatch":
        st = states[0]
        states[0] = pkg.rec.StableState(**{**st.__dict__, "cv": st.cv + 1})
    for i, st in states.items():
        if case == "missing" and i == 2:
            continue
        pkg.rec.DurableStore(paths[i], i).save(st)
    if case == "corrupt":
        with open(paths[0], "r+b") as fh:
            fh.seek(12)
            b = fh.read(1)
            fh.seek(12)
            fh.write(bytes([b[0] ^ 0x40]))
    return paths


@pytest.mark.parametrize("case", ["valid", "missing", "corrupt", "fork", "digest-mismatch",
                                  "undersized", "duplicate-claimant", "position-mismatch"])
def test_recovery_checkers_give_the_reference_summaries(tmp_path, case):
    d = str(tmp_path)
    paths = _write_stores(PKGS["ref"], d, case)
    results = {}
    for name, pkg in PKGS.items():
        checker = pkg.inv.RecoveryInvariantChecker(
            1, digest_fn=lambda b: hashlib.sha256(b).digest())
        try:
            results[name] = ("ok", checker.check_all(paths))
        except pkg.inv.InvariantViolation as e:
            results[name] = ("violation", str(e))
    assert results["port"] == results["ref"]
    assert results["port"][0] == ("ok" if case in ("valid", "missing") else "violation")
    if case == "missing":
        assert set(results["port"][1]) == {0, 1}


def test_recovery_checkers_agree_on_a_store_that_moves_backwards(tmp_path):
    """Across two checks (a kill/restart cycle), a stable count that falls
    is a violation in both packages; one that rises is not."""
    path = str(tmp_path / "replica0.state")
    hi, lo = _pkg_state(PKGS["ref"], 30), _pkg_state(PKGS["ref"], 31)
    if hi.count < lo.count:
        hi, lo = lo, hi
    out = {}
    for name, pkg in PKGS.items():
        checker = pkg.inv.RecoveryInvariantChecker(
            1, digest_fn=lambda b: hashlib.sha256(b).digest())
        steps = []
        for st in (lo, hi, lo):
            if os.path.exists(path):
                os.remove(path)
            ref_recovery.DurableStore(path, 0).save(st)
            try:
                steps.append(("ok", checker.check_all({0: path})))
            except pkg.inv.InvariantViolation as e:
                steps.append(("violation", str(e)))
        out[name] = steps
    assert out["port"] == out["ref"]
    assert [s[0] for s in out["port"]] == ["ok", "ok", "violation"]


# ---------------------------------------------------------------------------
# Overlapping saves: the fault the soak's logs showed


def _overlapping_saves(pkg, path: str) -> dict:
    """Two saves on ONE store from two threads, the lower count first,
    the second started while the first sits just before its
    ``os.replace`` (held there until the second has replaced, or for 2 s
    if the store makes the second wait).  Returns each save's outcome and
    the count the file holds after."""
    store = pkg.rec.DurableStore(path, 0)
    real_replace = os.replace
    first_at_replace, second_done = threading.Event(), threading.Event()
    hold = {"first": True}

    def replace(src, dst):
        if hold.pop("first", False):
            first_at_replace.set()
            second_done.wait(2.0)
            return real_replace(src, dst)
        try:
            return real_replace(src, dst)
        finally:
            second_done.set()

    outcome = {}

    def save(tag, count):
        try:
            outcome[tag] = store.save(_pkg_state_at(pkg, count))
        except OSError as e:
            outcome[tag] = type(e).__name__
        finally:
            if tag == "second":
                second_done.set()

    orig = pkg.store.os.replace
    pkg.store.os.replace = replace
    try:
        first = threading.Thread(target=save, args=("first", 8))
        first.start()
        assert first_at_replace.wait(5.0)
        second = threading.Thread(target=save, args=("second", 12))
        second.start()
        first.join(10)
        second.join(10)
    finally:
        pkg.store.os.replace = orig
    outcome["file_count"] = pkg.rec.DurableStore(path, 0).load().count
    return outcome


def _pkg_state_at(pkg, count: int):
    st = _pkg_state(pkg, 40)
    cert = tuple(pkg.msgs.Checkpoint(replica_id=c.replica_id, count=count, view=c.view,
                                     cv=c.cv, digest=c.digest, signature=c.signature)
                 for c in st.cert)
    return pkg.rec.StableState(**{**st.__dict__, "count": count, "cert": cert})


def test_overlapping_saves_race_on_the_reference_and_serialise_in_the_port(tmp_path):
    """A stable checkpoint that arrives while the previous one is still
    being saved starts a second save on another worker thread.  The
    reference's two saves share the temp file: the second replaces it
    first, and the first's ``os.replace`` then finds it gone
    (FileNotFoundError, logged at ERROR as "durable checkpoint save
    failed" by every replica of a soak on a fast host).  The port's saves
    take a lock: both succeed in turn and the file ends at the higher
    count."""
    ref = _overlapping_saves(PKGS["ref"], str(tmp_path / "ref.state"))
    port = _overlapping_saves(PKGS["port"], str(tmp_path / "port.state"))
    assert ref["first"] == "FileNotFoundError" and ref["second"] is True
    assert port == {"first": True, "second": True, "file_count": 12}


# ---------------------------------------------------------------------------
# A state-transfer install and the watchdogs of the seqs it retires


@pytest.mark.parametrize("pkg_name", ["port", "ref"])
def test_an_installed_retire_state_stops_the_watchdogs_of_retired_seqs(pkg_name):
    """A replica that catches up by state transfer adopts the certified
    retire watermarks.  The requests they retire were executed by the
    cluster, so their request and prepare timers are done: the port stops
    them at the install.  The reference leaves them running, and each one
    later fires as a request timeout (a view-change demand) for a request
    already served — the recovery soak's primary, lagging under the
    seed's dropped frames, installed state and demanded view changes ~60 s
    later, and the cluster wedged in the cascade."""
    if pkg_name == "port":
        from minbft_tpu_torch.core.internal.clientstate import ClientState
        from minbft_tpu_torch.core.internal.timer import FakeTimerProvider
    else:
        from minbft_tpu.core.internal.clientstate import ClientState
        from minbft_tpu.core.internal.timer import FakeTimerProvider

    async def scenario():
        timers = FakeTimerProvider()
        st = ClientState(timers)
        fired = []
        for seq in (5, 6, 8, 9):
            st.start_request_timer(seq, 60.0, lambda s=seq: fired.append(("request", s)))
            st.start_prepare_timer(seq, 30.0, lambda s=seq: fired.append(("prepare", s)))
        # certified: everything up to 6 and seq 8 executed
        st.install_retired(6, [8])
        timers.fire_all()
        return sorted(fired)

    fired = asyncio.run(scenario())
    live = [9] if pkg_name == "port" else [5, 6, 8, 9]
    assert fired == sorted([("prepare", s) for s in live] + [("request", s) for s in live])


@pytest.mark.parametrize("pkg_name", ["port", "ref"])
def test_one_state_recertified_in_a_new_view_is_logged_as_divergence(pkg_name, caplog):
    """The checkpoint digest covers (count, view, cv) beside the
    application digest, so a replica that re-executes up to an already
    stable count after a view change certifies the SAME application state
    under another digest, and the collector logs it at ERROR as a
    "checkpoint divergence" (both packages; the recovery soak's view
    changes on the card log these).  Equal ledgers are the state check."""
    import logging

    pkg = PKGS[pkg_name]
    log = logging.getLogger(f"test.recertified.{pkg_name}")
    coll = pkg.ckpt.CheckpointCollector(1, logger=log)
    app = hashlib.sha256(b"the same state").digest()
    marks = ((1, 2),)

    def claim(replica, view, cv):
        return pkg.msgs.Checkpoint(replica_id=replica, count=8, view=view, cv=cv,
                                   digest=pkg.digest(app, 8, view, cv, marks),
                                   signature=b"sig")

    with caplog.at_level(logging.ERROR, logger=log.name):
        assert coll.record(claim(1, 0, 8)) is False
        assert coll.record(claim(2, 0, 8)) is True  # f + 1: stable
        assert not caplog.records
        assert coll.record(claim(0, 1, 9)) is False  # the new view's claim
    assert [r.getMessage()[:40] for r in caplog.records] == [
        "checkpoint divergence at stable count 8:"]
    assert coll.stable_position[:2] == (8, 0)


def test_the_smokes_divergence_rule_excuses_only_a_claim_in_another_view(caplog):
    """``chip_smoke.recertified`` excuses a "checkpoint divergence" record
    only when every conflicting claim it names is in another view than
    the claim held against it (a view change's re-certification), in both
    of the collector's forms; a conflict inside one view (a fork), a mixed
    pre-stability record, and a record without views are never excused."""
    import logging

    import chip_smoke

    log = logging.getLogger("test.divergence_rule")
    app, fork = (hashlib.sha256(t).digest() for t in (b"state", b"forked state"))

    def claim(replica, count, view, cv, state=app):
        return port_messages.Checkpoint(
            replica_id=replica, count=count, view=view, cv=cv,
            digest=checkpoint_digest(state, count, view, cv, ((1, 2),)), signature=b"sig")

    def records(*claims):
        coll = port_checkpoint.CheckpointCollector(1, logger=log)
        caplog.clear()
        with caplog.at_level(logging.ERROR, logger=log.name):
            for c in claims:
                coll.record(c)
        return [f"2026-10-18 12:00:00,000 ERROR {r.getMessage()}" for r in caplog.records]

    stable = (claim(1, 8, 0, 8), claim(2, 8, 0, 8))
    # the stable form: re-certified in view 1, or forked in view 0
    recert = records(*stable, claim(0, 8, 1, 9))
    forked = records(*stable, claim(0, 8, 0, 8, fork))
    # the pre-stability form: one replica's claim against others' in view 0
    pre_recert = records(claim(1, 8, 0, 8), claim(0, 8, 1, 9))
    pre_forked = records(claim(1, 8, 0, 8), claim(0, 8, 0, 8, fork))
    # ... and a fork in view 0 beside a claim in view 1: the record names both
    pre_mixed = records(claim(1, 8, 0, 8), claim(2, 8, 1, 9), claim(0, 8, 0, 8, fork))
    for recs, excused in ((recert, [True]), (forked, [False]), (pre_recert, [True]),
                          (pre_forked, [False]), (pre_mixed, [True, False])):
        assert all("checkpoint divergence" in r for r in recs)
        assert [chip_smoke.recertified(r) for r in recs] == excused, recs
    assert not chip_smoke.recertified(
        "ERROR checkpoint divergence at count 8: 0123456789abcdef vs replicas [1]")
