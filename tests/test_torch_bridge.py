"""The port's serving bridge (``bridge/``) and sim transport against the JAX
package's.

A port driver and a JAX driver start from the same params and seed (dense
N = 24, sparse N = 33 with dense links; the port fed the JAX driver's own
key chain), their state leaves equal. Each package's ``SimBridge`` then
takes the same messages straight into its handlers — ``_on_ping``,
``_on_ping_req``, ``_on_sync``, ``_on_metadata``, ``_on_gossip``,
``_fold_records`` — and the window-boundary fold (``_flush_events``,
``_sync_records``, ``_event_record``): the replies must be the same
messages and the state leaves stay bit-equal. A scripted bridged member
(join, a metadata bump, a severed and healed link, a leave) at fixed
ticks, with explicit ``step`` calls and no wall-clock waits, keeps the
drivers equal. Then ``sim/transport.py``'s send, request-response and a
blocked or lossy link (the driver's host generator), the ``tpusim``
factory, a duplicate endpoint, and one in-process bridged ``Cluster``
handed the whole table by its initial SYNC.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import functools
from types import SimpleNamespace

import pytest
import torch

import scalecube_cluster_tpu.bridge as JBR
import scalecube_cluster_tpu.cluster as JCL
import scalecube_cluster_tpu.models as JM
import scalecube_cluster_tpu.models.message as JMSG
import scalecube_cluster_tpu.ops.sparse as JSP
import scalecube_cluster_tpu.ops.state as JS
import scalecube_cluster_tpu_torch.bridge as TBR
import scalecube_cluster_tpu_torch.cluster as TCL
import scalecube_cluster_tpu_torch.models as TM
import scalecube_cluster_tpu_torch.models.message as TMSG
from scalecube_cluster_tpu.sim import SimCluster as JSimCluster
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.config import ClusterConfig, TransportConfig
from scalecube_cluster_tpu_torch.sim import SimCluster, SimDriver, SimTransport
from scalecube_cluster_tpu_torch.transport.api import TransportError, create_transport
from test_torch_dense import _KNOBS as DENSE_KNOBS
from test_torch_dense import _assert_state_equal as assert_dense_equal
from test_torch_dense_driver import DenseChain
from test_torch_driver import JaxChain
from test_torch_sparse import _KNOBS as SPARSE_KNOBS
from test_torch_sparse import _assert_state_equal as assert_sparse_equal

torch.set_num_threads(1)

SEED = 5
CASES = {  # engine: (JAX params, initial members, chain, driver kwargs, state check)
    "dense": (lambda: JS.SimParams(capacity=28, **DENSE_KNOBS), 24, DenseChain, {}, assert_dense_equal),
    "sparse": (lambda: JSP.SparseParams(capacity=40, mr_slots=32, announce_slots=16, **SPARSE_KNOBS), 33,
               JaxChain, {"dense_links": True}, assert_sparse_equal),
}


@functools.lru_cache(maxsize=None)
def _jparams(engine):
    return CASES[engine][0]()


def _pair(engine):
    _, n, chain_cls, kw, check = CASES[engine]
    jparams = _jparams(engine)
    jd = JSimDriver(jparams, n, seed=SEED, **kw)
    td = SimDriver(convert.params_from_dict(dataclasses.asdict(jparams)), n, seed=SEED, device="cpu",
                   draws=chain_cls(SEED, jparams), **kw)
    check(jd.state, td.state, f"{engine}: built")
    return jd, td, check


def _ns(pkg_models, pkg_msg, pkg_cluster):
    return SimpleNamespace(M=pkg_models, Q=pkg_msg, C=pkg_cluster)


J = _ns(JM, JMSG, JCL)
T = _ns(TM, TMSG, TCL)


def _norm(x):
    """A message, payload or record as plain values, so the two packages'
    classes compare."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _endpoint(bridge, name):
    """An attached endpoint whose deliveries are recorded (no event loop)."""
    ep = bridge.transport(name)
    bridge._attach(ep)
    ep._started = True
    out = []
    ep._deliver = out.append
    return ep, out


class Hybrid:
    """The same bridged member on a JAX driver and on the port's."""

    def __init__(self, engine, before_attach=None):
        self.engine = engine
        self.jd, self.td, self.check = _pair(engine)
        for d in (self.jd, self.td):
            if before_attach is not None:
                before_attach(d)
        self.jb, self.tb = JBR.SimBridge(self.jd, seed_rows=(0, 1)), TBR.SimBridge(self.td, seed_rows=(0, 1))
        self.sides = []
        for ns, d, b in ((J, self.jd, self.jb), (T, self.td, self.tb)):
            ep, out = _endpoint(b, "real-0")
            me = ns.M.Member(id="real-id-0", address=ep.address, alias="real")
            self.sides.append(SimpleNamespace(ns=ns, d=d, b=b, ep=ep, out=out, me=me))
        assert self.sides[0].ep.row == self.sides[1].ep.row

    def both(self, fn, label):
        """``fn(side)`` on each side; the results and the messages each
        endpoint received meanwhile must be the same, and so the states."""
        got = []
        for s in self.sides:
            s.out.clear()
            got.append((_norm(fn(s)), [_norm(m) for m in s.out]))
        assert got[1] == got[0], label
        self.compare(label)
        return got[1]

    def compare(self, label):
        jd, td = self.jd, self.td
        self.check(jd.state, td.state, f"{self.engine}: {label}")
        assert {r: (m.id, m.address) for r, m in td.members.items()} == {
            r: (m.id, m.address) for r, m in jd.members.items()}, label
        assert sorted(td._transports) == sorted(jd._transports), label
        assert _norm(td._rumor_payloads) == _norm(jd._rumor_payloads), label

    def step(self, n, label):
        for d in (self.jd, self.td):
            d.step(n)
        self.compare(label)


def _msg(ns, data, q, cid=None):
    return ns.Q.Message.with_data(data, qualifier=q, **({"cid": cid} if cid else {}))


@pytest.mark.parametrize("engine", sorted(CASES))
def test_handlers_answer_as_jax_and_keep_the_states_equal(engine):
    h = Hybrid(engine)
    row = h.sides[0].ep.row
    rec = lambda s, st, inc: s.ns.M.MembershipRecord(s.me, s.ns.M.MemberStatus[st], inc)  # noqa: E731

    # the initial SYNC: the member's own record is folded (its identity
    # adopted) and the whole table comes back in the SYNC_ACK
    _, replies = h.both(lambda s: s.b._on_sync(s.ep, 0, _msg(s.ns, s.ns.C.SyncData([rec(s, "ALIVE", 0)]),
                                                                 s.ns.Q.Q_MEMBERSHIP_SYNC, "c1")), "sync")
    assert len(replies) == 1 and len(replies[0][1]["data"][1]["membership"]) == CASES[engine][1]
    assert h.td.members[row].id == "real-id-0"
    for d in (h.jd, h.td):
        d.crash(5)
    h.compare("crash 5")

    def ping(s, target, to_id=None):
        to = s.d._member_handle(target) if to_id is None else s.ns.M.Member(id=to_id, address=f"sim://{target}")
        data = s.ns.C.PingData(s.me, to)
        return s.b._on_ping(s.ep, target, _msg(s.ns, data, s.ns.Q.Q_PING, f"p{target}"))

    _, acks = h.both(lambda s: ping(s, 3), "ping up row")
    assert acks[0][1]["data"][1]["ack_type"] == ("AckType", h.sides[1].ns.C.AckType.DEST_OK.value)
    _, acks = h.both(lambda s: ping(s, 4, "sim-999"), "ping re-occupied row")
    assert acks[0][1]["data"][1]["ack_type"][1] == h.sides[1].ns.C.AckType.DEST_GONE.value
    _, acks = h.both(lambda s: ping(s, 5), "ping down row")
    assert acks == []

    def ping_req(s, relay, to):
        data = s.ns.C.PingData(s.me, to)
        return s.b._on_ping_req(s.ep, relay, _msg(s.ns, data, s.ns.Q.Q_PING_REQ, f"r{relay}"))

    n_acks = []
    for label, to in (("sim target", lambda s: s.d._member_handle(3)),
                      ("down target", lambda s: s.d._member_handle(5)),
                      ("bridged target", lambda s: s.me),
                      ("bridged, another id", lambda s: s.ns.M.Member(id="x", address=s.ep.address)),
                      ("foreign address", lambda s: s.ns.M.Member(id="y", address="tcp://h:1"))):
        n_acks.append(len(h.both(lambda s: ping_req(s, 2, to(s)), f"ping-req {label}")[1]))
    assert n_acks == [1, 0, 1, 1, 0]
    assert h.both(lambda s: ping_req(s, 5, s.d._member_handle(3)), "ping-req via a down relay")[1] == []

    def metadata(s, target, mid=None):
        m = s.d._member_handle(target) if mid is None else s.ns.M.Member(id=mid, address=f"sim://{target}")
        return s.b._on_metadata(s.ep, target, _msg(s.ns, s.ns.C.GetMetadataRequest(m), s.ns.Q.Q_METADATA_REQ, "m"))

    assert len(h.both(lambda s: metadata(s, 7), "metadata")[1]) == 1
    assert h.both(lambda s: metadata(s, 7, "sim-0"), "metadata, another id")[1] == []
    assert h.both(lambda s: metadata(s, 5), "metadata, down row")[1] == []

    def gossip(s, seq, inner):
        g = s.ns.C.Gossip(gossiper_id="real-id-0", sequence_id=seq, message=inner)
        req = s.ns.C.GossipRequest(gossips=[g], from_id="real-id-0")
        return s.b._on_gossip(s.ep, 1, _msg(s.ns, req, s.ns.Q.Q_GOSSIP_REQ))

    h.both(lambda s: gossip(s, 1, _msg(s.ns, rec(s, "ALIVE", 1), s.ns.Q.Q_MEMBERSHIP_GOSSIP)), "gossip: inc bump")
    h.both(lambda s: gossip(s, 2, _msg(s.ns, "hello", "user/x")), "gossip: user rumor")
    h.both(lambda s: gossip(s, 2, _msg(s.ns, "hello", "user/x")), "gossip: duplicate id")
    assert len(h.td._rumor_payloads) == 1

    # the window-boundary fold: the watch's events since the attach become
    # one SYNC per burst, stamped from the post-window key snapshot
    h.step(4, "window after the handlers")
    h.step(4, "second window")
    _, synced = h.both(lambda s: s.b._flush_events(s.ep), "flush")
    assert len(synced) == 1 and synced[0][1]["headers"]["q"] == TMSG.Q_MEMBERSHIP_SYNC
    h.both(lambda s: [s.b._event_record(ev, s.d._watches[row].prev_key) for ev in s.d.events_of(row)],
           "event records")
    for r in (0, row, 5):
        h.both(lambda s: s.b._sync_records(r), f"sync records of row {r}")
    h.both(lambda s: s.b._sync_records(0, exclude=s.ep.address), "sync records without the member")
    # SYNC_ACK folds like a SYNC; a LEAVING record starts the leave
    h.both(lambda s: s.b._proxy(s.ep, 0, _msg(s.ns, s.ns.C.SyncData([rec(s, "ALIVE", 2)]),
                                             s.ns.Q.Q_MEMBERSHIP_SYNC_ACK)), "sync-ack fold")
    h.both(lambda s: s.b._fold_records(s.ep, [rec(s, "LEAVING", 3)]), "leaving record")
    h.step(4, "window after the leave")
    h.both(lambda s: s.b._detach(s.ep, crash=True), "detach")
    h.step(4, "window after the detach")


@pytest.mark.parametrize("engine", sorted(CASES))
def test_scripted_bridged_member_keeps_the_drivers_equal(engine):
    """Join at tick 4, a metadata bump, a severed link (the row crashed), a
    heal (re-joined on a fresh row, handed the forced SYNC), a leave and a
    stop, each between explicit windows."""
    h = Hybrid(engine, before_attach=lambda d: (d.watch(0), d.step(4)))
    h.compare("attached")
    rec = lambda s, st, inc: s.ns.M.MembershipRecord(s.me, s.ns.M.MemberStatus[st], inc)  # noqa: E731
    h.both(lambda s: s.b._fold_records(s.ep, [rec(s, "ALIVE", 0)]), "identity")
    h.step(4, "joined")
    h.both(lambda s: s.b._fold_records(s.ep, [rec(s, "ALIVE", 1)]), "metadata bump")
    h.step(4, "after the bump")
    first_row = h.sides[1].ep.row
    h.both(lambda s: s.b.fail_link(s.ep), "link severed")
    assert not h.td.is_up(first_row)
    h.step(4, "severed")
    _, forced = h.both(lambda s: s.b.heal_link(s.ep), "link healed")
    assert h.sides[1].ep.row != first_row and len(forced) == 1
    h.step(4, "healed")
    h.both(lambda s: s.b._fold_records(s.ep, [rec(s, "LEAVING", 2)]), "leave")
    h.step(4, "left")
    h.both(lambda s: asyncio.run(s.ep.stop()), "stopped")
    h.step(4, "after the stop")
    assert [(e.type.value, e.member.id) for e in h.td.events_of(0)] == [
        (e.type.value, e.member.id) for e in h.jd.events_of(0)]
    assert {"ADDED", "UPDATED", "LEAVING"} <= {e.type.name for e in h.td.events_of(0)}


def _transport_run(d, sim_cluster_cls, msg_mod, loss=None):
    """Send and request-response between two sim rows' transports; then the
    same over a lossy link (the driver's host generator decides)."""
    async def run():
        t1, t2 = sim_cluster_cls(d).node(1).transport(), sim_cluster_cls(d).node(2).transport()
        got = []

        def serve(m):
            got.append((m.qualifier, m.data, m.sender))
            if m.qualifier == "ask":
                reply = msg_mod.Message.with_data(f"re:{m.data}", qualifier="answer", cid=m.correlation_id)
                asyncio.ensure_future(t2.send(m.sender, reply))

        t2.listen().subscribe(serve)
        await t1.send("sim://2", msg_mod.Message.with_data("one", qualifier="tell"))
        await asyncio.sleep(0)
        answer = await t1.request_response("sim://2", msg_mod.Message.with_data("two", qualifier="ask"), 1.0)
        if loss is not None:
            d.set_link_loss([1], [2], loss)
        delivered = 0
        for i in range(40):
            before = len(got)
            await t1.send("sim://2", msg_mod.Message.with_data(i, qualifier="tell"))
            await asyncio.sleep(0)
            delivered += len(got) > before
        timed_out = False
        try:
            await t1.request_response("sim://2", msg_mod.Message.with_data("three", qualifier="ask"), 0.05)
        except asyncio.TimeoutError:
            timed_out = True
        return got[:2], answer.data, delivered, timed_out, t1.address

    return asyncio.run(run())


@pytest.mark.parametrize("loss", [0.5, 1.0])
def test_sim_transport_send_request_response_and_lossy_link_match_jax(loss):
    jd, td, _ = _pair("sparse")
    ref = _transport_run(jd, JSimCluster, JMSG, loss)
    got = _transport_run(td, SimCluster, TMSG, loss)
    assert got == ref
    assert got[1] == "re:two" and isinstance(td._transports[1], SimTransport)
    if loss == 1.0:
        assert got[2] == 0 and got[3]  # a blocked link: dropped sends, a timed-out request
    else:
        assert 0 < got[2] < 40  # the host generator's draws, the JAX driver's sequence
    td.crash(2)
    assert td._transports[2].is_stopped


def test_tpusim_factory_duplicate_endpoint_and_a_bridged_cluster():
    _, td, _ = _pair("sparse")
    bridge = TBR.SimBridge(td, seed_rows=(0, 1))
    saved = TBR.SimBridge._default
    TBR.SimBridge._default = None
    try:
        with pytest.raises(TransportError, match="default bridge"):
            create_transport(TransportConfig(transport_factory="tpusim"))
        bridge.set_default()
        ep = create_transport(TransportConfig(transport_factory="tpusim"))
        assert isinstance(ep, TBR.TpuSimTransport) and ep.name == "node-0"
    finally:
        TBR.SimBridge._default = saved
    cfg = (ClusterConfig.default_local()
           .with_membership(lambda m: m.replace(seed_members=["sim://0"], sync_interval=30.0, sync_timeout=1.0))
           .with_failure_detector(lambda f: f.replace(ping_interval=30.0))
           .with_gossip(lambda g: g.replace(gossip_interval=0.01)))

    async def run():
        a = await TCL.new_cluster(cfg).transport_factory(bridge.transport_factory("real")).start()
        try:
            with pytest.raises(TBR.BridgeError, match="already attached"):
                bridge.transport("real")
            ep = bridge._endpoints["real"]
            # the initial SYNC handed the member the whole sim table
            assert len(a.members()) == 33 + 1 and td._transports[ep.row] is ep
            assert td.members[ep.row].id == a.member().id
            return ep.row
        finally:
            await a.shutdown()

    row = asyncio.run(run())
    assert row not in td._transports  # detached on stop
    td.step(4)
    assert td.status_of(0, row) is not None
