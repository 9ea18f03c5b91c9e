"""The PyTorch port's dissemination plane against the JAX package's, piece by
piece: the spec and its validation (the same messages), the routing through
``ClusterConfig``, the chord sets of every topology, the peer selection of
every strategy x topology and the pipelined budget window (the same picks
from the same uniforms), the pull salts, the theory bounds of the
certification matrix, the interval statistics, ``cluster_math`` and
``suspicion_timeout_for``, and the refusals of what is not ported. The
engines' windows are held in ``tests/test_torch_dissem_engines.py``, the
driver and the spread measurement in ``tests/test_torch_dissem_driver.py``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.config as JC
import scalecube_cluster_tpu.dissemination.certify as JCert
import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.rand as JR
import scalecube_cluster_tpu.ops.sparse as JSP
import scalecube_cluster_tpu.ops.state as JS
import scalecube_cluster_tpu.utils.cluster_math as JM
from scalecube_cluster_tpu.dissemination import DissemSpec as JSpec
from scalecube_cluster_tpu.dissemination import strategies as jdz
from scalecube_cluster_tpu.dissemination import topology as jtopo
from scalecube_cluster_tpu_torch import config as TC
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.dissemination import DissemSpec as TSpec
from scalecube_cluster_tpu_torch.dissemination import certify as TCert
from scalecube_cluster_tpu_torch.dissemination import strategies as tdz
from scalecube_cluster_tpu_torch.dissemination import topology as ttopo
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import rand as TR
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.utils import cluster_math as TM

STRATEGIES = ("push", "push_pull", "pipelined", "accelerated", "tuneable")
TOPOLOGIES = ("full", "ring", "torus", "expander", "geo")


def _both(**kw):
    return JSpec(**kw), TSpec(**kw)


def _outcome(fn, *args):
    """``fn(*args)``'s value, or the type and text of what it raised."""
    try:
        return ("value", fn(*args))
    except ValueError as exc:
        return ("raised", type(exc).__name__, str(exc))


def test_catalog_and_switches_match_jax():
    from scalecube_cluster_tpu.dissemination import spec as jspec
    from scalecube_cluster_tpu_torch.dissemination import spec as tspec

    assert tspec.STRATEGIES == jspec.STRATEGIES and tspec.TOPOLOGIES == jspec.TOPOLOGIES
    assert dataclasses.asdict(tspec.DEFAULT) == dataclasses.asdict(jspec.DEFAULT)
    for strategy in STRATEGIES:
        for topology in TOPOLOGIES:
            j, t = _both(strategy=strategy, topology=topology)
            for prop in ("is_default", "uniform_selection", "deterministic", "wants_pull"):
                assert getattr(t, prop) == getattr(j, prop), (strategy, topology, prop)
            assert hash(t) == hash(TSpec(strategy=strategy, topology=topology))


@pytest.mark.parametrize("bad", [
    {"strategy": "flood"}, {"topology": "hypercube"}, {"degree": -1}, {"torus_rows": -2},
    {"geo_zones": 1}, {"geo_wan_delay_ticks": -1}, {"pipeline_budget": 0},
    {"strategy": "tuneable", "tuneable_mix": 1.5}, {"strategy": "tuneable", "tuneable_mix": -0.1},
])
def test_spec_validation_messages_match_jax(bad):
    msgs = []
    for cls in (JSpec, TSpec):
        with pytest.raises(ValueError) as exc:
            cls(**bad)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_config_routes_through_the_spec():
    """validate() and every params class's from_config go through
    ``DissemSpec.from_config``, as in JAX: the same spec, field for field."""
    knobs = dict(strategy="pipelined", topology="torus", torus_rows=8, pipeline_budget=3, degree=5,
                 geo_zones=8, geo_wan_delay_ticks=1, tuneable_mix=0.25)
    jcfg = JC.ClusterConfig.default_sim().with_dissemination(lambda d: d.replace(**knobs))
    tcfg = TC.ClusterConfig.default_sim().with_dissemination(lambda d: d.replace(**knobs))
    jcfg.validate()
    tcfg.validate()
    want = dataclasses.asdict(JSpec.from_config(jcfg))
    assert dataclasses.asdict(TSpec.from_config(tcfg)) == want
    for jcls, tcls in ((JS.SimParams, TS.SimParams), (JSP.SparseParams, TSP.SparseParams),
                       (JPV.PviewParams, TPV.PviewParams)):
        jp, tp = jcls.from_config(jcfg, capacity=64), tcls.from_config(tcfg, capacity=64)
        assert isinstance(tp.dissem, TSpec)
        assert dataclasses.asdict(tp.dissem) == dataclasses.asdict(jp.dissem) == want
    assert TSpec.from_config(object()) == TSpec()
    for bad in ({"strategy": "flood"}, {"topology": "mesh"}, {"pipeline_budget": 0}):
        msgs = []
        for cfg in (jcfg, tcfg):
            with pytest.raises(ValueError) as exc:
                cfg.with_dissemination(lambda d: d.replace(**bad)).validate()
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1], bad


def test_convert_carries_the_spec():
    for jparams in (JS.SimParams(capacity=33), JSP.SparseParams(capacity=33), JPV.PviewParams(capacity=33)):
        spec = JSpec(strategy="tuneable", topology="geo", geo_zones=3, tuneable_mix=0.7)
        got = convert.params_from_dict(dataclasses.asdict(dataclasses.replace(jparams, dissem=spec)))
        assert got.dissem == TSpec(strategy="tuneable", topology="geo", geo_zones=3, tuneable_mix=0.7)
        assert convert.params_from_dict(dataclasses.asdict(jparams)).dissem == TSpec()


@pytest.mark.parametrize("n", [12, 33, 256, 1000])
def test_chords_match_jax(n):
    """Every topology's chord set (or the refusal of it), with the automatic
    and explicit degree, torus rows and zone counts."""
    specs = [dict(strategy=s, topology=t) for s in ("push", "accelerated") for t in TOPOLOGIES]
    specs += [dict(strategy="accelerated", topology="expander", degree=3),
              dict(strategy="pipelined", topology="geo", geo_zones=3, degree=2),
              dict(strategy="pipelined", topology="torus", torus_rows=4),
              dict(strategy="accelerated", topology="torus", torus_rows=n)]
    seen = 0
    for kw in specs:
        j, t = _both(**kw)
        ref = _outcome(jtopo.chords, j, n)
        assert _outcome(ttopo.chords, t, n) == ref, (kw, n)
        if ref[0] == "value":
            seen += 1
            assert _outcome(ttopo.connectivity_ok, t, n) == _outcome(jtopo.connectivity_ok, j, n)
    assert seen >= 5
    for topology in ("torus", "geo"):
        j, t = _both(topology=topology, geo_zones=4)
        assert _outcome(ttopo.torus_dims, t, n) == _outcome(jtopo.torus_dims, j, n)
        assert _outcome(ttopo.zone_size, t, n) == _outcome(jtopo.zone_size, j, n)


_PEER_SPECS = [dict(strategy=s, topology=t) for s in STRATEGIES for t in TOPOLOGIES] + [
    dict(strategy="tuneable", topology="expander", tuneable_mix=m) for m in (0.0, 0.3, 1.0)
] + [dict(strategy="pipelined", topology="torus", torus_rows=4, pipeline_budget=3)]


@pytest.mark.parametrize("n,fanout", [(24, 3), (256, 3), (256, 5)])
def test_structured_peers_match_jax(n, fanout):
    """Every strategy x topology at several ticks (past the rumor slot count
    and the chord count): the same targets from the same uniforms, and the
    numpy row mirror agrees; ``u`` holds values at the f32 edges."""
    rng = np.random.default_rng(n + fanout)
    u = rng.random((n, fanout), np.float32)
    u[:4] = np.array([0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, 0.3], np.float32)[:, None]
    checked = 0
    for kw in _PEER_SPECS:
        j, t = _both(**kw)
        if j.uniform_selection:
            with pytest.raises(ValueError, match="no chord set"):
                tdz.structured_peers(t, n, 0, torch.from_numpy(u))
            continue
        for tick in (0, 1, 7, 13, 101):
            jp, jv = jdz.structured_peers(j, n, jnp.int32(tick), jnp.asarray(u))
            tp, tv = tdz.structured_peers(t, n, tick, torch.from_numpy(u))
            assert tp.dtype == torch.int32 and tv.dtype == torch.bool
            assert np.array_equal(tp.numpy(), np.asarray(jp)), (kw, tick)
            assert np.array_equal(tv.numpy(), np.asarray(jv)), (kw, tick)
            for i in (0, 3, n - 1):
                row, _ = tdz.structured_peer_row(t, n, tick, i, u[i])
                assert np.array_equal(row, tp[i].numpy()), (kw, tick, i)
            checked += 1
    assert checked >= 5 * 16


def test_try_stride_uniforms_and_pull_salts_match_jax():
    u = np.random.default_rng(3).random((40, 12), np.float32)
    assert np.array_equal(tdz.try_stride_uniforms(torch.from_numpy(u), 4).numpy(),
                          np.asarray(jdz.try_stride_uniforms(jnp.asarray(u), 4)))
    assert (TR.SALT_PULL, TR.SALT_PULL_STRIDE) == (JR.SALT_PULL, JR.SALT_PULL_STRIDE)
    assert [tdz.pull_salt(s) for s in range(8)] == [jdz.pull_salt(s) for s in range(8)]


@pytest.mark.parametrize("slots", [1, 3, 8])
def test_budget_mask_matches_jax(slots):
    """The rotating window for budgets below, at and past the slot count,
    over ticks past the slot count (the remainder of a negative operand),
    and no window for the other strategies."""
    for budget in (1, 2, 3, 9):
        j, t = _both(strategy="pipelined", topology="ring", pipeline_budget=budget)
        for tick in range(0, 3 * slots + 5):
            ref = np.asarray(jdz.rumor_budget_mask(j, slots, jnp.int32(tick)))
            got = tdz.rumor_budget_mask(t, slots, tick, "cpu")
            assert np.array_equal(got.numpy(), ref), (budget, tick)
            assert [tdz.budget_ok(t, s, tick, slots) for s in range(slots)] == ref.tolist()
    for strategy in ("push", "push_pull", "accelerated", "tuneable"):
        assert tdz.rumor_budget_mask(TSpec(strategy=strategy, topology="ring"), slots, 4, "cpu") is None


def _matrix_spec(cls, strategy, topology):
    # the spec spread_certifier builds for one matrix entry
    return cls(strategy=strategy, topology=topology, geo_wan_delay_ticks=2 if topology == "geo" else 0,
               pipeline_budget=2)


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_theory_bounds_match_jax(n):
    assert TCert.DEFAULT_MATRIX == JCert.DEFAULT_MATRIX
    for strategy, topology, _engine in TCert.DEFAULT_MATRIX:
        j, t = _matrix_spec(JSpec, strategy, topology), _matrix_spec(TSpec, strategy, topology)
        for fanout in (2, 3):
            for slots in (4, 8):
                assert TCert.theory_bound(t, n, fanout, slots) == JCert.theory_bound(j, n, fanout, slots)
            if strategy != "push" or topology != "full":
                assert _outcome(TCert.det_schedule_bound, t, n, fanout) == _outcome(
                    JCert.det_schedule_bound, j, n, fanout)


def test_interval_statistics_match_jax():
    for k, n in ((0, 10), (3, 10), (10, 10), (990, 1000), (0, 0)):
        for conf in (0.9, 0.95, 0.99):
            assert TCert.wilson_interval(k, n, conf) == JCert.wilson_interval(k, n, conf)
    xs = np.sort(np.random.default_rng(1).integers(5, 40, 1200))
    for q in (0.01, 0.5, 0.99):
        assert TCert.quantile_ci(xs, q) == JCert.quantile_ci(xs, q)
    assert TCert.quantile_ci([], 0.5) == JCert.quantile_ci([], 0.5)
    with pytest.raises(ValueError, match="confidence"):
        TCert.wilson_interval(1, 2, 1.5)


def test_cluster_math_and_suspicion_timeout_match_jax():
    for n in (0, 1, 2, 3, 7, 64, 255, 256, 1000, 1 << 20):
        assert TM.ceil_log2(n) == JM.ceil_log2(n)
        for mult in (1, 3):
            assert TM.gossip_periods_to_spread(mult, n) == JM.gossip_periods_to_spread(mult, n)
            assert TM.gossip_periods_to_sweep(mult, n) == JM.gossip_periods_to_sweep(mult, n)
            assert TM.gossip_dissemination_time(mult, n, 0.2) == JM.gossip_dissemination_time(mult, n, 0.2)
            assert TM.gossip_timeout_to_sweep(mult, n, 0.2) == JM.gossip_timeout_to_sweep(mult, n, 0.2)
            assert TM.suspicion_timeout(mult, n, 1.0) == JM.suspicion_timeout(mult, n, 1.0)
            for fanout in (1, 3):
                assert TM.max_messages_per_gossip_per_node(fanout, mult, n) == \
                    JM.max_messages_per_gossip_per_node(fanout, mult, n)
                assert TM.max_messages_per_gossip_total(fanout, mult, n) == \
                    JM.max_messages_per_gossip_total(fanout, mult, n)
                if n > 1:
                    assert TM.gossip_convergence_probability(fanout, mult, n, 0.1) == \
                        JM.gossip_convergence_probability(fanout, mult, n, 0.1)
                    assert TM.gossip_convergence_percent(fanout, mult, n, 10.0) == \
                        JM.gossip_convergence_percent(fanout, mult, n, 10.0)
    with pytest.raises(ValueError, match="num must be >= 0"):
        TM.ceil_log2(-1)
    for profile in ("default_lan", "default_wan", "default_local", "default_sim"):
        for n in (3, 64, 10_000):
            assert TC.suspicion_timeout_for(getattr(TC.ClusterConfig, profile)(), n) == \
                JC.suspicion_timeout_for(getattr(JC.ClusterConfig, profile)(), n)


def test_certifier_refuses_what_is_not_ported():
    # the telemetry bus is ported: each certified entry leaves its record
    # (tests/test_torch_telemetry.py holds the records against JAX's)
    from scalecube_cluster_tpu_torch.telemetry import TelemetryBus

    bus = TelemetryBus(16)
    rec = TCert.spread_certifier(matrix=[("push", "full", "dense")], n=32, seeds=(0,), bus=bus, device="cpu")
    got = [(r.source, r.kind, r.fields["certified"]) for r in bus.tail()]
    assert got == [("dissemination", "spread_certified", rec["entries"][0]["certified"])]
    with pytest.raises(ValueError, match="per-link delay"):
        TCert.measure_spread(TSpec(topology="geo", geo_wan_delay_ticks=2), n=64, engine="pview", device="cpu")
    with pytest.raises(ValueError, match="per-link delay"):
        TCert.measure_spread(TSpec(topology="geo", geo_wan_delay_ticks=2), n=64, engine="sparse", device="cpu")
    with pytest.raises(ValueError, match="pipelined"):
        TCert.measure_pipeline_steady_state(TSpec(), device="cpu")
    from scalecube_cluster_tpu_torch import dissemination

    assert dissemination.theory_bound is TCert.theory_bound and dissemination.certify is TCert
    assert dissemination.MC_MIN_SAMPLES == JCert.MC_MIN_SAMPLES
