"""The port's scalar engine and its host layers against the JAX package's.

The records and messages (``models/``, ``utils/intervals.py``), the
transports (``transport/``, the native codec's C source) and the scalar
engine (``cluster/``) are pure Python in the JAX package, and the port
keeps its own copies: each must equal its JAX original line for line once
the package name is rewritten, with the deliberate differences listed
here. Then the copies' behaviour on the same inputs: the codecs' bytes
(every registered codec, the native and the pure-Python wire), the
membership records' override lattice, the interval set, the emulator's
seeded loss and delay draws, ``EmulatorChaosRunner`` replaying one
scenario onto both packages' emulators, and a three-member cluster over
the in-memory transport that converges as JAX's facade test does.
"""

from __future__ import annotations

import asyncio
import dataclasses
import pathlib
import random

import pytest
from hypothesis import given, seed, settings
from hypothesis import strategies as hs

import scalecube_cluster_tpu.chaos.engine as JCH
import scalecube_cluster_tpu.chaos.events as JEV
import scalecube_cluster_tpu.models as JM
import scalecube_cluster_tpu.transport as JT
import scalecube_cluster_tpu.transport.native_codec as JNC
import scalecube_cluster_tpu.utils.intervals as JI
import scalecube_cluster_tpu_torch.chaos.engine as TCH
import scalecube_cluster_tpu_torch.chaos.events as TEV
import scalecube_cluster_tpu_torch.models as TM
import scalecube_cluster_tpu_torch.transport as TT
import scalecube_cluster_tpu_torch.transport.native_codec as TNC
import scalecube_cluster_tpu_torch.utils.intervals as TI
from _helpers import await_until
from scalecube_cluster_tpu_torch.cluster import new_cluster
from scalecube_cluster_tpu_torch.config import ClusterConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "scalecube_cluster_tpu", "scalecube_cluster_tpu_torch"

#: Copies that equal their JAX original line for line once the package name
#: is rewritten (items 1-3 of the serving slice, and the sim transport, the
#: bridge and the monitor it serves through).
COPIES = (
    "utils/intervals.py", "models/__init__.py", "models/message.py", "models/record.py",
    "transport/__init__.py", "transport/api.py", "transport/codecs.py", "transport/native_codec.py",
    "transport/stream_base.py", "transport/tcp.py", "transport/websocket.py", "transport/local.py",
    "transport/emulator.py", "native/codec.c",
    "cluster/__init__.py", "cluster/metadata.py", "cluster/failure_detector.py", "cluster/gossip.py",
    "cluster/membership.py", "cluster/cluster.py",
    "sim/transport.py", "bridge/__init__.py", "bridge/transport.py", "bridge/loadgen.py",
)

#: Deliberate differences, each with its reason.
DIFFERENT = {
    # JAX builds _sc_codec.so beside its source; the port builds its copy of
    # codec.c into the checkout's build/native/ (a hash of source, flags and
    # ABI in the name: no stale-mtime check), commits no .so, and keeps the
    # pure-Python fallback where no cc exists.
    "native/__init__.py": "builds into build/native/",
    # a port driver on a member mesh holds its rank's rows of each leaf:
    # the row's epoch is read from the whole leaf (JAX's arrays are global)
    "monitor.py": "int(driver._whole(driver.state.epoch)[row])",
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_jax_original(rel):
    ref = (REPO / JAX_PKG / rel).read_text().replace(JAX_PKG, PORT_PKG)
    got = (REPO / PORT_PKG / rel).read_text()
    assert got.splitlines() == ref.splitlines(), rel


def test_emulator_runner_is_a_copy_and_the_listed_differences_hold():
    def runner_text(pkg):
        text = (REPO / pkg / "chaos/engine.py").read_text()
        return text[text.index("class EmulatorChaosRunner:"):]

    assert runner_text(PORT_PKG) == runner_text(JAX_PKG)
    ref = (REPO / JAX_PKG / "monitor.py").read_text().replace(JAX_PKG, PORT_PKG).splitlines()
    got = (REPO / PORT_PKG / "monitor.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(ref, got) if a != b]
    assert len(got) == len(ref) and diff == [("        epoch = int(driver.state.epoch[row])",
                                             "        epoch = " + DIFFERENT["monitor.py"])]
    from scalecube_cluster_tpu_torch import native

    assert native.BUILD_DIR.relative_to(REPO.resolve()).as_posix() == "build/native"
    assert native.library_path().parent == native.BUILD_DIR
    assert set(DIFFERENT) | set(COPIES) >= {
        p.relative_to(REPO / JAX_PKG).as_posix()
        for sub in ("transport", "cluster", "native", "bridge")
        for p in (REPO / JAX_PKG / sub).glob("*.[pc]*") if p.suffix in (".py", ".c")
    }


# -- codecs ----------------------------------------------------------------

_text = hs.text(alphabet=hs.characters(min_codepoint=32, max_codepoint=0x2FF), max_size=12)
_leaf = hs.one_of(hs.none(), hs.booleans(), hs.integers(-2**40, 2**40), _text)
_json = hs.recursive(_leaf, lambda c: hs.one_of(hs.lists(c, max_size=4), hs.dictionaries(_text, c, max_size=4)),
                     max_leaves=12)
_data = hs.one_of(_json, hs.binary(max_size=40))
_headers = hs.dictionaries(hs.text(alphabet="abcdefghij-/", min_size=1, max_size=8), _text, max_size=4)


def _pair_messages(headers, data, qualifier):
    return (JM.Message.with_data(data, qualifier=qualifier, **headers),
            TM.Message.with_data(data, qualifier=qualifier, **headers))


@seed(14)
@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(headers=_headers, data=_data, qualifier=hs.sampled_from(["q", "sc/gossip/req", "user/x"]))
def test_codecs_give_jax_bytes_and_messages(headers, data, qualifier):
    jmsg, tmsg = _pair_messages(headers, data, qualifier)
    names = ["jdk", "smile", "binary"] + (["json"] if not isinstance(data, bytes) else [])
    for name in names:
        jc, tc = JT.codecs.message_codec(name), TT.codecs.message_codec(name)
        jb, tb = jc.encode(jmsg), tc.encode(tmsg)
        assert tb == jb, name
        jd, td = jc.decode(jb), tc.decode(tb)
        assert (td.headers, td.data) == (jd.headers, jd.data), name
    for jwire, twire in ((JNC._PyWire, TNC._PyWire), (JNC._load_wire(), TNC._load_wire())):
        jc, tc = JNC.BinaryMessageCodec(jwire), TNC.BinaryMessageCodec(twire)
        jb, tb = jc.encode(jmsg), tc.encode(tmsg)
        assert tb == jb
        # the two packages' wires read each other's bytes
        assert (tc.decode(jb).headers, tc.decode(jb).data) == (jc.decode(tb).headers, jc.decode(tb).data)


def test_native_codec_builds_and_matches_the_python_wire():
    codec = TNC.BinaryMessageCodec()
    assert codec.is_native, "cc is on this machine: the native codec must build"
    msg = TM.Message.with_data({"k": [1, 2]}, qualifier="q", cid="7")
    assert codec.encode(msg) == TNC.BinaryMessageCodec(TNC._PyWire).encode(msg)


# -- records, intervals, the emulator -----------------------------------------

_status = hs.sampled_from(list(range(4)))


@seed(14)
@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(new=hs.tuples(_status, hs.integers(0, 3)), old=hs.one_of(hs.none(), hs.tuples(_status, hs.integers(0, 3))))
def test_membership_record_overrides_agree(new, old):
    def rec(mod, st_inc):
        if st_inc is None:
            return None
        m = mod.Member(id="m1", address="a:1")
        return mod.MembershipRecord(m, mod.MemberStatus(st_inc[0]), st_inc[1])

    assert rec(TM, new).overrides(rec(TM, old)) == rec(JM, new).overrides(rec(JM, old))
    if old is not None:
        assert TM.record.overrides_codes(*new, *old) == JM.record.overrides_codes(*new, *old)


def test_intervals_agree():
    rng = random.Random(14)
    j, t = JI.SequenceIdCollector(), TI.SequenceIdCollector()
    for _ in range(400):
        x = rng.randrange(120)
        assert t.add(x) == j.add(x)
        assert t.size() == j.size() and t.intervals() == j.intervals()
        y = rng.randrange(120)
        assert (y in t) == (y in j)
    t.clear(), j.clear()
    assert t.intervals() == j.intervals() == []


def test_emulator_seeded_loss_and_delay_draws_are_jax_sequence():
    for loss, delay in ((0.0, 0.0), (30.0, 0.05), (100.0, 0.0), (7.5, 1.0)):
        js, ts = JT.emulator.OutboundSettings(loss, delay), TT.emulator.OutboundSettings(loss, delay)
        jr, tr = random.Random(5), random.Random(5)
        got = [(ts.evaluate_loss(tr), ts.evaluate_delay(tr)) for _ in range(200)]
        assert got == [(js.evaluate_loss(jr), js.evaluate_delay(jr)) for _ in range(200)]

    async def drops(mod):
        emu = mod.NetworkEmulator("a", seed=9)
        emu.set_outbound_settings("b", 40.0)
        emu.block_outbound(["c"])
        out = []
        for dst in ["b", "c", "d"] * 40:
            try:
                await emu.try_fail_and_delay(dst)
                out.append(True)
            except mod.NetworkEmulatorError:
                out.append(False)
        return out, emu.total_message_sent_count, emu.total_message_lost_count

    assert asyncio.run(drops(TT)) == asyncio.run(drops(JT))


# -- EmulatorChaosRunner --------------------------------------------------------

def _emulator_scenario(ev):
    return ev.Scenario(name="emu", horizon=60, events=[
        ev.Partition(groups=[[0, 1], [2, 3]], at=2, heal_at=9),
        ev.LinkFlap(pairs=[(4, 5)], period=4, at=10, until=20),
        ev.SlowMember(rows=[6], mean_delay_ticks=3.0, at=21, until=27),
        ev.AsymmetricLoss(rows=[7], pct=40.0, direction="both", at=22, until=28),
        ev.ZoneOutage(rows=[1, 2], at=30, until=36),
        ev.LossStorm(pct=25.0, at=40, until=44),
        ev.Crash(rows=[5], at=46),
        ev.Restart(rows=[5], at=50, seed_rows=[0]),
        ev.SlowEpoch(mean_delay_ticks=2.0, at=54, until=58),
    ])


def _emu_state(emu):
    return (sorted((k, dataclasses.astuple(v)) for k, v in emu._outbound.items()),
            sorted((k, v.shall_pass) for k, v in emu._inbound.items()),
            dataclasses.astuple(emu._default_outbound), emu._default_inbound.shall_pass)


def test_emulator_chaos_runner_replays_jax_schedule():
    n = 8
    addrs = [f"mem://{i}" for i in range(n)]
    jemus = [JT.NetworkEmulator(a, seed=i) for i, a in enumerate(addrs)]
    temus = [TT.NetworkEmulator(a, seed=i) for i, a in enumerate(addrs)]
    jr = JCH.EmulatorChaosRunner(_emulator_scenario(JEV), jemus, addrs)
    tr = TCH.EmulatorChaosRunner(_emulator_scenario(TEV), temus, addrs)
    assert tr.next_tick() == jr.next_tick()
    for tick in range(0, 62, 3):
        assert tr.advance_to(tick) == jr.advance_to(tick), tick
        assert [_emu_state(e) for e in temus] == [_emu_state(e) for e in jemus], tick
        assert tr.next_tick() == jr.next_tick()
    assert tr.report() == jr.report() and tr.report()["pending"] == 0
    assert len(tr.events_applied) > 10
    for mod, ev in ((TCH, TEV), (JCH, JEV)):
        with pytest.raises(ev.ScenarioError, match="align"):
            mod.EmulatorChaosRunner(_emulator_scenario(ev), jemus, addrs[:3])


# -- the scalar engine ------------------------------------------------------------

def _test_config():
    return (ClusterConfig.default_local()
            .with_membership(lambda m: m.replace(sync_interval=0.5, sync_timeout=0.5))
            .with_failure_detector(lambda f: f.replace(ping_interval=0.2, ping_timeout=0.1, ping_req_members=2))
            .with_gossip(lambda g: g.replace(gossip_interval=0.05)))


def test_three_member_local_cluster_converges():
    """JAX's ``test_cluster_facade.py::test_alice_bob_carol_join`` on the
    port's copies: three members over the in-memory transport converge, and
    each sees the others' metadata."""
    TT.MemoryTransportRegistry.reset_default()

    async def start(seeds=(), name=None):
        cfg = _test_config().with_membership(lambda m: m.replace(seed_members=list(seeds)))
        cfg = cfg.replace(metadata={"name": name}, member_alias=name)
        return await new_cluster(cfg).start()

    async def run():
        alice = await start(name="Alice")
        bob = await start([alice.address], name="Bob")
        carol = await start([alice.address, bob.address], name="Carol")
        try:
            assert await await_until(lambda: all(len(c.members()) == 3 for c in (alice, bob, carol)))
            assert alice.metadata_of(alice.member_by_address(bob.address)) == {"name": "Bob"}
            assert bob.metadata_of(bob.member_by_address(carol.address)) == {"name": "Carol"}
            assert alice.member_by_id(bob.member().id) == bob.member()
        finally:
            await asyncio.gather(alice.shutdown(), bob.shutdown(), carol.shutdown())

    try:
        asyncio.run(run())
    finally:
        TT.MemoryTransportRegistry.reset_default()
