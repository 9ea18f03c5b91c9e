"""The PyTorch port's SimDriver over the sparse engine against the JAX
package's.

Both drivers start from the same ``SparseParams`` and seed, with the dense
link plane; the port is fed the JAX driver's own key chain through its
``draws=`` seam. A script of windows of two lengths, rumor spreads, a
crash, a leave, a join, metadata bumps and a partition with its heal runs
on both, and after every step the two must agree in everything
``tests/test_torch_driver.py`` compares: the last tick's and every recorded
tick's metrics, the watched rows' event logs, views, health counters, rumor
coverage, the health snapshot (its pool block included), readback counts
and the state. Port-only cases cover ``link_loss`` on both link layouts,
the checkpoint round trip, the engine check of ``restore``, the default
device and the README's SimCluster flow.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu.sim import SimCluster as JSimCluster
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.sim import CheckpointError, SimCluster, SimDriver
from test_torch_driver import HALVES, N, N_INITIAL, SEED, WATCHED, JaxChain, _compare, _events
from test_torch_sparse import _KNOBS, _assert_state_equal

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jparams():
    return JSP.SparseParams(capacity=N, mr_slots=32, announce_slots=16, full_metrics=True, **_KNOBS)


def _pair(record_metrics: bool = True, dense_links: bool = True):
    jparams = _jparams()
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jd = JSimDriver(jparams, N_INITIAL, seed=SEED, record_metrics=record_metrics,
                    dense_links=dense_links)
    chain = JaxChain(SEED, jparams)
    td = SimDriver(tparams, N_INITIAL, seed=SEED, record_metrics=record_metrics,
                   dense_links=dense_links, device="cpu", draws=chain)
    return jd, td, chain


def test_sparse_driver_matches_jax_driver():
    jd, td, chain = _pair()
    assert td.engine == jd.engine == "sparse"
    for row in WATCHED:
        assert td.watch(row) is not None and jd.watch(row) is not None
    busy = {"events": 0, "accepts": 0, "syncs": 0, "announced": 0, "suspects": 0}

    def step(n, label):
        last = (jd.step(n), td.step(n))
        _compare(jd, td, chain, label, last)
        hist = td.metrics_history[-n:]
        busy["accepts"] += sum(int(m["mr_accepts"]) for m in hist)
        busy["syncs"] += sum(int(m["sync_roundtrips"]) for m in hist)
        busy["suspects"] += sum(int(m["fd_new_suspects"]) for m in hist)

    step(4, "warm window")
    for d in (jd, td):
        assert d.spread_rumor(3, "alpha") == 0
    step(7, "after the first spread")
    for d in (jd, td):
        assert d.spread_rumor(10, b"beta") == 1
        d.crash(6)
        d.crash(40)
    step(4, "after a spread and two crashes")
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
        assert d.link_loss(0, N - 1) == 1.0 and d.link_loss(0, 1) == 0.0
    for w in range(3):
        step(7, f"partitioned, window {w}")
    for d in (jd, td):
        d.heal_partition(*HALVES)
        d.set_link_loss([2], [3], 0.25)
    assert td.link_loss(2, 3) == jd.link_loss(2, 3) == np.float32(0.25)
    step(7, "healed")
    step(4, "healed, later")
    busy["events"] = sum(len(td.events_of(r)) for r in WATCHED)
    busy["announced"] = td.health_counters["announced"]
    assert all(v > 0 for v in busy.values()), busy
    kinds = {e[0] for r in WATCHED for e in _events(td, r)}
    assert {"removed", "leaving", "updated"} <= kinds, kinds
    assert td.health_snapshot()["pool"]["mr_slots"] == 32


def test_link_loss_on_scalar_links_matches_jax():
    jd, td, _ = _pair(record_metrics=False, dense_links=False)
    assert td.state.loss.dim() == 0
    assert td.link_loss(0, 5) == jd.link_loss(0, 5) == 0.0
    for d in (jd, td):
        with pytest.raises(ValueError, match="dense links"):
            d.set_link_loss([0], [1], 0.5)


def test_readme_flow_through_simcluster_matches_jax():
    """The README's SimCluster flow on sparse params: spread a rumor, run to
    full coverage, crash a member, and read a node's members."""
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


def _generator_driver(n=48, **kw):
    params = TSP.SparseParams(capacity=n, mr_slots=16, announce_slots=8, **_KNOBS)
    return SimDriver(params, n - 4, seed=5, device="cpu", **kw)


def test_checkpoint_round_trip_continues_identically(tmp_path):
    d = _generator_driver(dense_links=True)
    d.watch(2)
    d.spread_rumor(3, {"payload": 1})
    d.crash(6)
    d.block_partition([0, 1, 2], [20, 21])
    d.step(5)
    path = str(tmp_path / "ck.npz")
    d.checkpoint(path)
    at_checkpoint = len(_events(d, 2))
    d.join()
    d.step(10)
    first = (convert.state_to_numpy(d.state), d.health_counters, dict(d.members), _events(d, 2))
    d.restore(path)
    assert d.tick == 5 and d.link_loss(0, 20) == 1.0
    at_restore = len(_events(d, 2))
    d.join()
    d.step(10)
    state = convert.state_to_numpy(d.state)
    for name, v in first[0].items():
        assert np.array_equal(state[name], v), f"state leaf {name} after restore"
    assert d.health_counters == first[1]
    assert d.members == first[2]
    assert _events(d, 2)[at_restore:] == first[3][at_checkpoint:]
    assert d.rumor_payload(0) == {"payload": 1}


def test_restore_checks_the_engine(tmp_path):
    sparse = _generator_driver()
    sparse.step(2)
    pview = SimDriver(TPV.PviewParams(capacity=48, mr_slots=16, seed_rows=(0, 1)), 44, device="cpu")
    pview.step(2)
    sp_path, pv_path = str(tmp_path / "sparse.npz"), str(tmp_path / "pview.npz")
    sparse.checkpoint(sp_path)
    pview.checkpoint(pv_path)
    with pytest.raises(CheckpointError, match="pview engine"):
        sparse.restore(pv_path)
    with pytest.raises(CheckpointError, match="sparse engine"):
        pview.restore(sp_path)
    sparse.step(1)
    assert sparse.tick == 3


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        SimDriver(TSP.SparseParams(capacity=33), 33)


def test_refusals_name_their_items():
    params = TSP.SparseParams(capacity=33)
    # the sparse engine runs on a member mesh (tests/test_torch_sparse_mesh.py):
    # what it refuses is a mesh that is not a 1-D members mesh
    with pytest.raises(ValueError, match="1-D 'members' mesh"):
        SimDriver(params, 33, mesh=object(), device="cpu")
    d = SimDriver(params, 33, device="cpu")
    # the adaptive plane is ported: set_adaptive arms it
    d.set_adaptive(enabled=True)
    assert d.adaptive_state is not None and d.params.adaptive.enabled
    # the trace plane is ported (tests/test_torch_trace.py); it refuses an
    # adaptive driver, as in JAX
    with pytest.raises(ValueError, match="adaptive failure detection"):
        d.arm_trace()
    plane = SimDriver(params, 33, device="cpu").arm_trace()
    assert plane.spec.tracer_rows == (0, 1, 2, 3)
    with pytest.raises(ValueError, match="dense links"):
        d.set_link_delay([0], [1], 0.0)
