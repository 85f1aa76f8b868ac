"""The port's fault-injection network (minbft_tpu_torch/testing/faultnet.py)
against the reference's (minbft_tpu/testing/faultnet.py).

The determinism contract is part of the port: the k-th frame on a
directed link gets the same decision in both packages, because both draw
from ``random.Random`` seeded by the same string.  So one seed and one
recorded frame sequence, pumped through both packages' ``FaultNet``, must
give the same frames out, step by step, the same census and the same
``replay_counts``, for every profile and an inline spec.  The reference's
own unit scenarios (tests/test_chaos.py: replay, stall, partition, reset)
run on the port's net, and ``plan_from_spec`` refuses the same specs."""

import asyncio

import numpy as np
import pytest

from minbft_tpu.testing import faultnet as ref
from minbft_tpu_torch.testing import faultnet as port

LINKS = (("r0", "r1"), ("r1", "r0"), ("r2", "r3"), ("c0", "r2"))
SPECS = ("lossy", "flaky", "slow", "drop=0.2,delay=0.1,duplicate=0.1,reorder=0.2,"
         "corrupt=0.15,reset=0.02")


def _frames(seed: int, n: int) -> list:
    """A recorded frame sequence: ``n`` frames of seeded lengths and bytes."""
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(k)) for k in rng.integers(1, 300, size=n)]


async def _pump(net, src, dst, frames) -> list:
    """Every frame out of the net's (src -> dst) pipe, in order; the
    stream ends early on a drawn reset, as a transport sees it."""
    async def gen():
        for fr in frames:
            yield fr

    return [fr async for fr in net.pipe(src, dst, gen())]


def _run(mod, seed: int, spec: str, per_link: dict) -> tuple:
    async def go():
        plan = mod.plan_from_spec(spec)
        # Keep the delays short: the decision, not the wait, is compared.
        plan = mod.FaultPlan(**{**plan.__dict__, "delay_s": (0.0, 0.0002)})
        net = mod.FaultNet(seed=seed, default_plan=plan)
        outs = {}
        for link, frames in per_link.items():
            outs[link] = await _pump(net, *link, frames)
        census = net.census
        return (outs, dict(census.counters), {k: dict(v) for k, v in census.links.items()},
                dict(census.frames), net.replay_counts(), net.replay_counts(
                    dict(census.frames), plan=plan))
    return asyncio.run(go())


@pytest.mark.parametrize("spec", SPECS)
def test_same_seed_same_frames_gives_the_same_decisions_in_both_packages(spec):
    per_link = {link: _frames(100 + k, 160) for k, link in enumerate(LINKS)}
    got = _run(port, 0x5EED15, spec, per_link)
    want = _run(ref, 0x5EED15, spec, per_link)
    outs, counters, links, frames, replay, replay_pinned = got
    # frame by frame: the same frames out, in the same order, per link
    for link in LINKS:
        assert outs[link] == want[0][link], link
    assert (counters, links, frames) == want[1:4]
    assert replay == replay_pinned == want[4] == want[5]
    seeded = {k: counters.get(k, 0) for k in port.SEEDED_KINDS}
    assert replay == seeded and sum(seeded.values()) > 0


def test_one_decision_at_a_time_matches_the_reference_draws():
    """The per-link decision stream itself, draw for draw."""
    for spec in SPECS:
        plan_p, plan_r = port.plan_from_spec(spec), ref.plan_from_spec(spec)
        assert plan_p.__dict__ == plan_r.__dict__
        a = port._LinkState(7, "r0", "r3")
        b = ref._LinkState(7, "r0", "r3")
        for _ in range(500):
            assert a.next_decision(plan_p) == b.next_decision(plan_r)
    assert port.SEEDED_KINDS == ref.SEEDED_KINDS
    assert port.SCRIPTED_KINDS == ref.SCRIPTED_KINDS
    assert {k: v.__dict__ for k, v in port.PROFILES.items()} == {
        k: v.__dict__ for k, v in ref.PROFILES.items()}
    assert (port.CHAOS_SEED_ENV, port.CHAOS_PLAN_ENV) == (
        ref.CHAOS_SEED_ENV, ref.CHAOS_PLAN_ENV)


@pytest.mark.parametrize("bad", ["nosuchprofile", "drop=x", "boom=0.1",
                                 "drop=0.1,,delay", "reset=1e"])
def test_plan_from_spec_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as ep:
        port.plan_from_spec(bad)
    with pytest.raises(ValueError) as er:
        ref.plan_from_spec(bad)
    assert str(ep.value) == str(er.value)


def test_chaos_seed_resolution_matches(monkeypatch):
    monkeypatch.setenv(port.CHAOS_SEED_ENV, "0x1f")
    assert port.chaos_seed(5) == ref.chaos_seed(5) == 0x1F
    monkeypatch.delenv(port.CHAOS_SEED_ENV)
    assert port.chaos_seed(5) == ref.chaos_seed(5) == 5


def test_stall_partition_reset_and_census_exposition_on_the_port():
    """The reference's scripted-fault scenarios on the port's net: a
    stalled link holds frames and releases them on unstall; a partition
    drops cross-group frames until healed; reset_all ends an idle
    stream; the census renders through the port's exposition, byte for
    byte as the reference renders the same census."""

    async def run():
        net = port.FaultNet(seed=5)

        async def gen():
            for i in range(6):
                yield b"f%d" % i

        got = []

        async def consume():
            async for fr in net.pipe("r0", "r1", gen()):
                got.append(fr)

        net.stall(src="r0")
        task = asyncio.ensure_future(consume())
        await asyncio.sleep(0.1)
        assert got == []  # held, stream still open
        net.unstall(src="r0")
        await asyncio.wait_for(task, 5)
        assert got == [b"f%d" % i for i in range(6)]
        assert net.census.counters.get("stall", 0) >= 1

        net.partition({"r0", "r1"}, {"r2", "r3"})
        assert await _pump(net, "r0", "r2", [b"x", b"y"]) == []
        assert await _pump(net, "r0", "r1", [b"z"]) == [b"z"]
        assert net.census.counters.get("partition", 0) == 2
        net.heal_partition()
        assert await _pump(net, "r0", "r2", [b"x2"]) == [b"x2"]

        started = asyncio.Event()

        async def endless():
            yield b"one"
            started.set()
            await asyncio.sleep(60)

        out = []

        async def consume_endless():
            async for fr in net.pipe("a", "b", endless()):
                out.append(fr)

        t = asyncio.ensure_future(consume_endless())
        await asyncio.wait_for(started.wait(), 5)
        net.reset_all()
        await asyncio.wait_for(t, 5)
        assert out == [b"one"] and net.census.counters.get("reset_all", 0) == 1
        return net.census

    census = asyncio.run(run())
    from minbft_tpu.obs import prom as ref_prom
    from minbft_tpu_torch.obs import collect_faultnet, render_families

    text = render_families(collect_faultnet(census, base={"replica": "0"}))
    assert 'minbft_faultnet_injected_total{kind="partition",replica="0"} 2' in text
    assert "minbft_faultnet_frames_total" in text
    assert text == ref_prom.render_families(
        ref_prom.collect_faultnet(census, base={"replica": "0"}))
