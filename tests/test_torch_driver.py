"""The PyTorch port's SimDriver against the JAX package's.

Both drivers start from the same params and seed; the port is fed the JAX
driver's own key chain through its ``draws=`` seam, so both consume the
same uniforms. A script of windows of two lengths, rumor spreads, a crash,
a leave, a join, metadata bumps and a partition with its heal runs on both,
and after every step the two must agree in the last tick's metrics (and
every recorded tick), the watched rows' event logs, views, health counters,
rumor coverage, the health snapshot, the driver's readback counts and the
state. The two f32 metrics may differ by at most 2 ulp, as in
``tests/test_torch_pview_fused.py``. Port-only cases cover checkpoints, the
refused surfaces and the README's SimCluster flow.
"""

from __future__ import annotations

import dataclasses
import functools
import zipfile

import jax
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
from scalecube_cluster_tpu.sim import SimCluster as JSimCluster
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.chaos import EmulatorChaosRunner, Scenario
from scalecube_cluster_tpu_torch.ops import engine_api
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.sim import CheckpointError, SimCluster, SimDriver
from scalecube_cluster_tpu_torch.sim import driver as tdriver
from test_torch_pview_fused import FLOAT_METRICS, _assert_state_equal, _jax_draws, _params

torch.set_num_threads(1)

N, N_INITIAL, SEED = 64, 60, 3
WATCHED = (0, 33)  # row 33's table reaches across the partition below
HALVES = (list(range(0, N // 2)), list(range(N // 2, N)))


class JaxChain:
    """The JAX driver's per-window key chain, replayed as per-tick draws."""

    def __init__(self, seed: int, params):
        self.key = jax.random.PRNGKey(seed)
        self.params = params

    def __call__(self, n_ticks: int):
        self.key, draws = _jax_draws(self.key, n_ticks, self.params)
        return draws


@functools.lru_cache(maxsize=None)
def _jparams(kd: str = "i32"):
    return _params(N, kd)


def _pair(kd: str = "i32", record_metrics: bool = True):
    jparams = _jparams(kd)
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jd = JSimDriver(jparams, N_INITIAL, seed=SEED, record_metrics=record_metrics)
    chain = JaxChain(SEED, jparams)
    td = SimDriver(tparams, N_INITIAL, seed=SEED, record_metrics=record_metrics,
                   device="cpu", draws=chain)
    return jd, td, chain


def _equal_value(a, b, name, label):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{label}: {name} shape {b.shape} != {a.shape}"
    if name in FLOAT_METRICS:
        ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert ulp.max(initial=0) <= 2, f"{label}: {name} off by {ulp.max()} ulp"
    else:
        assert np.array_equal(a, b), f"{label}: {name} differs: {b} != {a}"


def _events(d, row):
    return [(e.type.value, e.member.id, e.member.address) for e in d.events_of(row)]


def _members(d):
    return {row: (m.id, m.address, m.namespace) for row, m in d.members.items()}


def _compare(jd, td, chain, label, last=None):
    """Everything the drivers expose, read in the same order from both (the
    reads that flush count as readbacks on both sides)."""
    if last is not None:
        jlast, tlast = last
        assert set(jlast) == set(tlast), label
        for k in jlast:
            _equal_value(jlast[k], tlast[k], k, f"{label}, last tick")
    assert np.array_equal(np.asarray(jd._key), np.asarray(chain.key)), f"{label}: key chains apart"
    assert td.tick == jd.tick
    assert len(td.metrics_history) == len(jd.metrics_history)
    for i, (jm, tm) in enumerate(zip(jd.metrics_history, td.metrics_history)):
        assert set(jm) == set(tm)
        for k in jm:
            _equal_value(jm[k], tm[k], k, f"{label}, recorded tick {i}")
    for row in WATCHED:
        assert _events(td, row) == _events(jd, row), f"{label}: events of row {row}"
    for row in (0, 7, 33, N - 1):
        for a, b in zip(jd.view_of(row), td.view_of(row)):
            assert np.array_equal(a, b), f"{label}: view_of({row})"
        for subj in (1, 6, 9, 40):
            assert td.status_of(row, subj) == jd.status_of(row, subj), f"{label}: status_of({row}, {subj})"
    assert td.is_up(6) == jd.is_up(6)
    assert td.health_counters == jd.health_counters, label
    assert td.pool_high_water == jd.pool_high_water, label
    assert td.segmentation_warnings == jd.segmentation_warnings, label
    for slot in sorted(jd._rumor_payloads):
        _equal_value(np.float32(jd.rumor_coverage(slot)), np.float32(td.rumor_coverage(slot)),
                     "rumor_coverage", f"{label}, slot {slot}")
        assert td.rumor_payload(slot) == jd.rumor_payload(slot)
    js, ts = jd.health_snapshot(), td.health_snapshot()
    jcov, tcov = js["rumors"].pop("coverage"), ts["rumors"].pop("coverage")
    assert (jcov is None) == (tcov is None), label
    for slot in jcov or {}:
        assert abs(jcov[slot] - tcov[slot]) <= 1e-4, f"{label}: snapshot coverage of slot {slot}"
    assert ts == js, f"{label}: health_snapshot"
    assert td.dispatch_snapshot() == jd.dispatch_snapshot(), f"{label}: dispatch"
    assert _members(td) == _members(jd), label
    _assert_state_equal(jd.state, td.state, label)


def test_driver_matches_jax_driver():
    jd, td, chain = _pair()
    for row in WATCHED:
        assert td.watch(row) is not None and jd.watch(row) is not None
    busy = {"events": 0, "accepts": 0, "syncs": 0, "announced": 0}

    def step(n, label):
        last = (jd.step(n), td.step(n))
        _compare(jd, td, chain, label, last)
        busy["accepts"] += sum(int(m["mr_accepts"]) for m in td.metrics_history[-n:])
        busy["syncs"] += sum(int(m["sync_roundtrips"]) for m in td.metrics_history[-n:])

    step(4, "warm window")
    for d in (jd, td):
        assert d.spread_rumor(3, "alpha") == 0
    step(7, "after the first spread")
    for d in (jd, td):
        assert d.spread_rumor(10, b"beta") == 1
        d.crash(6)
    step(4, "after a spread and a crash")
    for d in (jd, td):
        d.leave(9)
    step(7, "after a leave")
    rows = [d.join(seed_rows=(0, 1)) for d in (jd, td)]
    assert rows[0] == rows[1]
    for d in (jd, td):
        d.update_metadata(4)
        d.update_metadata_batch([4, 11, 12])
    step(4, "after a join and metadata bumps")
    for d in (jd, td):
        d.block_partition(*HALVES)
    for w in range(3):
        step(7, f"partitioned, window {w}")
    for d in (jd, td):
        d.heal_partition(*HALVES)
    step(7, "healed")
    step(4, "healed, later")
    busy["events"] = sum(len(td.events_of(r)) for r in WATCHED)
    busy["announced"] = td.health_counters["announced"]
    assert all(v > 0 for v in busy.values()), busy
    kinds = {e[0] for r in WATCHED for e in _events(td, r)}
    assert {"removed", "leaving", "updated"} <= kinds, kinds


def test_readme_flow_through_simcluster_matches_jax():
    """The README's SimCluster flow: spread a rumor, run to full coverage,
    crash a member, and read a node's members."""
    jd, td, chain = _pair(record_metrics=False)
    clusters = (JSimCluster(jd), SimCluster(td))
    slots = [c.node(7).spread_gossip("announcement") for c in clusters]
    assert slots[0] == slots[1]
    for d, s in zip((jd, td), slots):
        assert d.run_until(lambda d: d.rumor_coverage(s) >= 1.0, max_ticks=64)
    assert td.tick == jd.tick
    for c in clusters:
        c.node(40).crash()
        c.step(30)
    assert td.tick == jd.tick
    jm, tm = (sorted(m.id for m in c.node(3).members()) for c in clusters)
    assert tm == jm and "sim-40" not in tm
    assert [n.row for n in clusters[1].nodes()] == [n.row for n in clusters[0].nodes()]
    assert clusters[1].node(3).incarnation_of(4) == clusters[0].node(3).incarnation_of(4)
    _assert_state_equal(jd.state, td.state, "after the README flow")


def _generator_driver(n=48, kd="i32", **kw):
    params = TPV.PviewParams(capacity=n, key_dtype=kd, mr_slots=16, announce_slots=8,
                             **{**dict(fanout=2, ping_req_k=1, fd_every=3, sync_every=8,
                                       suspicion_mult=1, rumor_slots=4, seed_rows=(0, 1)), **kw})
    return SimDriver(params, n - 4, seed=5, device="cpu")


def test_checkpoint_round_trip_continues_identically(tmp_path):
    d = _generator_driver()
    d.watch(2)
    d.spread_rumor(3, {"payload": 1})
    d.crash(6)
    d.step(5)
    path = str(tmp_path / "ck.npz")
    d.checkpoint(path)
    at_checkpoint = len(_events(d, 2))
    d.join()
    d.step(10)
    first = (convert.state_to_numpy(d.state), d.health_counters, dict(d.members), _events(d, 2))
    d.restore(path)
    assert d.tick == 5
    at_restore = len(_events(d, 2))  # the watch re-baselines: no phantom events
    d.join()
    d.step(10)
    state = convert.state_to_numpy(d.state)
    for name, v in first[0].items():
        assert np.array_equal(state[name], v), f"state leaf {name} after restore"
    assert d.health_counters == first[1]
    assert d.members == first[2]
    assert _events(d, 2)[at_restore:] == first[3][at_checkpoint:]
    assert len(first[3]) > at_checkpoint
    assert d.rumor_payload(0) == {"payload": 1}


def _archive(tmp_path, d, name="ck.npz"):
    path = str(tmp_path / name)
    d.checkpoint(path)
    with np.load(path) as z:
        return path, dict(z)


def _write(tmp_path, name, members):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        np.savez(fh, **members)
    return path


def test_restore_refuses_bad_archives(tmp_path, monkeypatch):
    d = _generator_driver()
    d.step(3)
    path, members = _archive(tmp_path, d)
    # truncated
    raw = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.npz")
    open(trunc, "wb").write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointError, match="unreadable"):
        d.restore(trunc)
    # corrupt host section
    host = members["_host"].copy()
    host[len(host) // 2] ^= 0xFF
    with pytest.raises(CheckpointError, match="CRC32"):
        d.restore(_write(tmp_path, "crc.npz", {**members, "_host": host}))
    # another engine's archive
    with pytest.raises(CheckpointError, match="sparse engine"):
        d.restore(_write(tmp_path, "eng.npz", {**members, "_engine": np.bytes_(b"sparse")}))
    # a missing member
    with pytest.raises(CheckpointError, match="missing"):
        d.restore(_write(tmp_path, "gen.npz", {k: v for k, v in members.items() if k != "_gen"}))
    # a state plane short
    with pytest.raises(CheckpointError, match="state planes"):
        d.restore(_write(tmp_path, "plane.npz", {k: v for k, v in members.items() if k != "minf_age"}))
    # a key-dtype mismatch: an i16 archive into an i32 driver
    d16 = _generator_driver(kd="i16")
    path16, _ = _archive(tmp_path, d16, "i16.npz")
    with pytest.raises(CheckpointError, match="int16"):
        d.restore(path16)
    # the JAX driver's archive is refused before anything is unpickled
    jd = JSimDriver(_jparams(), N_INITIAL, seed=SEED)
    jpath = str(tmp_path / "jax.npz")
    jd.checkpoint(jpath)

    def no_unpickling(*a, **k):
        raise AssertionError("restore unpickled a foreign archive")

    monkeypatch.setattr(tdriver.pickle, "loads", no_unpickling)
    with pytest.raises(CheckpointError, match="not written by the PyTorch port"):
        d.restore(jpath)
    with zipfile.ZipFile(jpath) as z:
        assert "_framework.npy" not in z.namelist() and "_key.npy" in z.namelist()
    monkeypatch.undo()
    # every refusal left the driver as it was
    d.step(2)
    assert d.tick == 5


def test_checkpoint_refuses_a_caller_draws_source(tmp_path):
    jd, td, chain = _pair(record_metrics=False)
    with pytest.raises(ValueError, match="draws source"):
        td.checkpoint(str(tmp_path / "x.npz"))


def _idle_scenario():
    return Scenario(name="idle", events=(), horizon=4)


class _Mesh2d:
    """A stand-in for a 2-D scenarios x members device mesh."""

    ndim = 2
    mesh_dim_names = ("scenarios", "members")


def test_refused_surfaces_raise_not_implemented():
    d = _generator_driver()
    calls = {
        "jit_cache_audit": lambda: d.jit_cache_audit(),
        "EmulatorChaosRunner": lambda: EmulatorChaosRunner(_idle_scenario(), [], []),
        "transport": lambda: SimCluster(d).node(1).transport(),
        "compile_cache_dir": lambda: SimDriver(d.params, 8, compile_cache_dir="x", device="cpu"),
    }
    items = {"EmulatorChaosRunner": "A13", "jit_cache_audit": "A13", "transport": "A13",
             "compile_cache_dir": "A13"}
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=items[name]):
            call()
    # the member mesh and the 2-D scenarios x members mesh are ported
    # (tests/test_torch_sharding.py, tests/test_torch_mesh_delay.py); a
    # driver runs one cluster, so it takes the 1-D member mesh only
    with pytest.raises(ValueError, match="2-D"):
        SimDriver(d.params, 8, mesh=_Mesh2d(), device="cpu")
    # the telemetry plane and the sparse delay rings are ported
    # (tests/test_torch_telemetry.py, tests/test_torch_delay_rings.py)
    plane = d.arm_telemetry()
    assert d.telemetry is plane and d.arm_telemetry() is plane
    assert [r.kind for r in plane.bus.tail()] == ["telemetry_armed"]
    # and so are the trace plane, the live knobs and the control plane
    # (tests/test_torch_trace.py, tests/test_torch_control.py)
    tplane = d.arm_trace()
    assert d.trace is tplane and d.arm_trace() is tplane
    assert [r.kind for r in plane.bus.tail()] == ["telemetry_armed", "trace_armed"]
    assert d.run_scenario(_idle_scenario(), trace=True)["trace_spans"] == {}
    d.set_protocol_knobs(fanout=4)
    assert d.params.fanout == 4
    c = _generator_driver()
    assert c.arm_control() is c.control and c.control_snapshot()["armed"]
    assert TSP.SparseParams(capacity=8, delay_slots=2).delay_slots == 2
    with pytest.raises(ValueError, match="no \\[N, N\\] link plane"):
        SimDriver(d.params, 8, dense_links=True, device="cpu")
    with pytest.raises(ValueError, match="per-link delay"):
        d.set_link_delay([0], [1], 2.0)
    with pytest.raises(TypeError, match="selects no engine"):
        SimDriver(object(), 8, device="cpu")
    assert engine_api.engine("dense").name == "dense"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        SimDriver(TPV.PviewParams(capacity=33), 33)
    assert SimDriver.__init__.__defaults__[-2] == "cuda"
