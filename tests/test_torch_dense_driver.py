"""The PyTorch port's SimDriver over the dense engine against the JAX
package's.

Both drivers start from the same ``SimParams`` (with the delay rings) and
seed; the port is fed the JAX driver's own key chain through its ``draws=``
seam. A script of windows of two lengths, rumor spreads, a crash, a leave,
a join, metadata bumps, link delays, a partition with its heal and a
per-link loss runs on both, and after every step the two must agree in
everything ``tests/test_torch_driver.py`` compares: the last tick's and
every recorded tick's metrics, the watched rows' event logs, views, health
counters, rumor coverage, the health snapshot (with no pool block),
readback counts and the state. Port-only cases cover ``link_loss``, the
checkpoint round trip, the engine check of ``restore``, the default device,
the refusals and the README's ``SimDriver(SimParams(capacity=1024,
seed_rows=(0,)), ...)`` flow at a small N.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.state as JS
from scalecube_cluster_tpu.sim import SimCluster as JSimCluster
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.sim import CheckpointError, SimCluster, SimDriver
from test_torch_dense import _KNOBS, _assert_state_equal, dense_draws
from test_torch_driver import HALVES, N, N_INITIAL, SEED, WATCHED, _compare, _events

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jparams(kd: str = "i32"):
    return JS.SimParams(capacity=N, key_dtype=kd, delay_slots=4, **_KNOBS)


class DenseChain:
    """The JAX driver's per-window key chain, replayed as dense draws."""

    def __init__(self, seed: int, params):
        self.key = jax.random.PRNGKey(seed)
        self.params = params

    def __call__(self, n_ticks: int):
        self.key, draws = dense_draws(self.key, n_ticks, self.params)
        return draws


def _pair(kd: str = "i32", record_metrics: bool = True):
    jparams = _jparams(kd)
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jd = JSimDriver(jparams, N_INITIAL, seed=SEED, record_metrics=record_metrics)
    chain = DenseChain(SEED, jparams)
    td = SimDriver(tparams, N_INITIAL, seed=SEED, record_metrics=record_metrics, device="cpu",
                   draws=chain)
    return jd, td, chain


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_dense_driver_matches_jax_driver(kd):
    jd, td, chain = _pair(kd)
    assert td.engine == jd.engine == "dense"
    for row in WATCHED:
        assert td.watch(row) is not None and jd.watch(row) is not None
    busy = {"events": 0, "syncs": 0, "suspects": 0, "deliveries": 0}

    def step(n, label):
        last = (jd.step(n), td.step(n))
        _compare(jd, td, chain, label, last)
        hist = td.metrics_history[-n:]
        busy["syncs"] += sum(int(m["sync_roundtrips"]) for m in hist)
        busy["suspects"] += sum(int(m["fd_new_suspects"]) for m in hist)
        busy["deliveries"] += sum(int(m["rumor_deliveries"]) for m in hist)

    step(4, "warm window")
    for d in (jd, td):
        assert d.spread_rumor(3, "alpha") == 0
        d.set_link_delay(list(range(8)), list(range(N)), 1.5)
    step(7, "after the first spread and link delays")
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
        d.set_link_delay([5], [6, 7], 0.0)
    assert td.link_loss(2, 3) == jd.link_loss(2, 3) == np.float32(0.25)
    step(7, "healed")
    step(4, "healed, later")
    busy["events"] = sum(len(td.events_of(r)) for r in WATCHED)
    assert all(v > 0 for v in busy.values()), busy
    kinds = {e[0] for r in WATCHED for e in _events(td, r)}
    assert {"removed", "leaving", "updated"} <= kinds, kinds
    snap = td.health_snapshot()
    assert "pool" not in snap and snap["engine"] == "dense"


def test_readme_flow_matches_jax():
    """The README's flow on dense params (``SimParams(capacity=...,
    seed_rows=(0,))`` at a small N) through SimCluster: spread a rumor, run
    to full coverage, crash a member, and read a node's members."""
    jparams = JS.SimParams(capacity=48, seed_rows=(0,))
    tparams = TS.SimParams(capacity=48, seed_rows=(0,))
    jd = JSimDriver(jparams, 40, seed=SEED)
    chain = DenseChain(SEED, jparams)
    td = SimDriver(tparams, 40, seed=SEED, device="cpu", draws=chain)
    clusters = (JSimCluster(jd), SimCluster(td))
    slots = [c.node(7).spread_gossip("announcement") for c in clusters]
    assert slots[0] == slots[1]
    for d, s in zip((jd, td), slots):
        assert d.run_until(lambda d: d.rumor_coverage(s) >= 1.0, max_ticks=64)
    assert td.tick == jd.tick
    for c in clusters:
        c.node(30).crash()
        # the default knobs: FD every 5 ticks, a 150-tick suspicion timeout
        c.step(200)
    assert td.tick == jd.tick
    jm, tm = (sorted(m.id for m in c.node(3).members()) for c in clusters)
    assert tm == jm and "sim-30" not in tm
    assert clusters[1].node(3).incarnation_of(4) == clusters[0].node(3).incarnation_of(4)
    _assert_state_equal(jd.state, td.state, "after the README flow")


def _generator_driver(n=48, **kw):
    params = TS.SimParams(capacity=n, delay_slots=3, **_KNOBS)
    return SimDriver(params, n - 4, seed=5, device="cpu", **kw)


def test_checkpoint_round_trip_continues_identically(tmp_path):
    d = _generator_driver()
    d.watch(2)
    d.spread_rumor(3, {"payload": 1})
    d.crash(6)
    d.set_link_delay([0, 1], [2, 3, 4], 2.0)
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


def test_restore_checks_the_engine_and_the_key_dtype(tmp_path):
    from scalecube_cluster_tpu_torch.ops.sparse import SparseParams

    dense = _generator_driver()
    dense.step(2)
    sparse = SimDriver(SparseParams(capacity=48, mr_slots=16, seed_rows=(0, 1)), 44, device="cpu")
    sparse.step(2)
    d16 = SimDriver(TS.SimParams(capacity=48, key_dtype="i16", delay_slots=3, **_KNOBS), 44, device="cpu")
    paths = {name: str(tmp_path / f"{name}.npz") for name in ("dense", "sparse", "d16")}
    for name, d in (("dense", dense), ("sparse", sparse), ("d16", d16)):
        d.checkpoint(paths[name])
    with pytest.raises(CheckpointError, match="sparse engine"):
        dense.restore(paths["sparse"])
    with pytest.raises(CheckpointError, match="dense engine"):
        sparse.restore(paths["dense"])
    with pytest.raises(CheckpointError, match="int16"):
        dense.restore(paths["d16"])
    dense.step(1)
    assert dense.tick == 3


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        SimDriver(TS.SimParams(capacity=33), 33)


def test_refusals_name_their_items():
    from scalecube_cluster_tpu_torch.ops.sparse import SparseParams

    params = TS.SimParams(capacity=33)
    # the dense and sparse engines run on a member mesh
    # (tests/test_torch_dense_mesh.py, tests/test_torch_sparse_mesh.py):
    # what they refuse is a mesh that is not a 1-D members mesh
    with pytest.raises(ValueError, match="1-D 'members' mesh"):
        SimDriver(params, 33, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="1-D 'members' mesh"):
        SimDriver(SparseParams(capacity=64), 64, mesh=object(), device="cpu")
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
    with pytest.raises(ValueError, match="delay_slots > 0"):
        d.set_link_delay([0], [1], 2.0)
    lean = SimDriver(params, 33, dense_links=False, device="cpu")
    assert lean.link_loss(0, 5) == 0.0
    with pytest.raises(ValueError, match="dense links"):
        lean.set_link_loss([0], [1], 0.5)
