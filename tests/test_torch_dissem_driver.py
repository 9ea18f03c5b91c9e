"""The PyTorch port's ``SimDriver.set_dissemination`` and spread
measurement against the JAX package's.

* ``set_dissemination``: a full spec, field overrides on top of the armed
  spec, and the no-op when nothing changes, as the JAX driver does them.
* A driver script on each engine (pview, sparse, dense) that swaps specs
  between windows — default, two armed specs, default again — against the
  JAX ``SimDriver`` fed the same key chain: after every step the two agree
  in everything ``tests/test_torch_driver.py`` compares (metrics of every
  recorded tick, event logs, views, counters, coverage, snapshots, state).
* ``measure_spread`` for three matrix entries at N = 64, one per engine,
  fed the JAX key chain: the same spread ticks for every seed, the same
  coverage curves, the same record.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.dissemination.certify as JCert
from scalecube_cluster_tpu.dissemination import DissemSpec as JSpec
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.chaos import Scenario
from scalecube_cluster_tpu_torch.dissemination import DissemSpec as TSpec
from scalecube_cluster_tpu_torch.dissemination import certify as TCert
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.sim import SimDriver
from test_torch_dense_driver import DenseChain
from test_torch_dense_driver import _jparams as dense_jparams
from test_torch_driver import N_INITIAL, SEED, WATCHED, JaxChain, _compare
from test_torch_driver import _jparams as pview_jparams
from test_torch_sparse_driver import _jparams as sparse_jparams

torch.set_num_threads(1)


def test_set_dissemination_swaps_and_noops_as_jax():
    params = TPV.PviewParams(capacity=33)
    d = SimDriver(params, 30, device="cpu")
    jd = JSimDriver(pview_jparams(), N_INITIAL, seed=SEED)
    before = d.params
    d.set_dissemination()  # nothing asked: a no-op
    d.set_dissemination(TSpec())  # the armed spec: a no-op
    d.set_dissemination(strategy="push", topology="full")
    assert d.params is before
    steps = [
        ((), dict(strategy="pipelined", topology="ring")),
        ((), dict(pipeline_budget=3)),  # on top of the armed spec
        ((), dict(topology="expander", degree=4)),
        (("spec",), dict(strategy="accelerated", topology="torus", torus_rows=3)),
        ((), dict(strategy="push", topology="full", degree=0, pipeline_budget=1, torus_rows=0)),
    ]
    for how, kw in steps:
        if how:
            d.set_dissemination(TSpec(**kw))
            jd.set_dissemination(JSpec(**kw))
        else:
            d.set_dissemination(**kw)
            jd.set_dissemination(**kw)
        assert dataclasses.asdict(d.params.dissem) == dataclasses.asdict(jd.params.dissem), kw
        # only the spec changes
        assert dataclasses.replace(d.params, dissem=TSpec()) == before
    armed = d.params
    d.set_dissemination(**dataclasses.asdict(armed.dissem))
    assert d.params is armed
    with pytest.raises(ValueError, match="unknown strategy"):
        d.set_dissemination(strategy="flood")
    assert d.params is armed
    # run_scenario arms the spec first, then (trace=True, ported) the trace
    # plane on the default tracers
    rep = d.run_scenario(Scenario(name="idle", events=(), horizon=4), strategy="push_pull", trace=True)
    assert d.params.dissem.strategy == "push_pull" and d.trace is not None
    assert rep["ok"] and rep["trace_spans"] == {} and "untraced_crash_rows" not in rep


def _swap_script(jd, td, chain, specs):
    """Windows of 5 ticks around spreads, a crash, a leave and a join, the
    spec swapped between them: ``specs`` in turn, then the default."""
    for row in WATCHED:
        assert td.watch(row) is not None and jd.watch(row) is not None
    busy = {"gossip_msgs": 0, "rumor_deliveries": 0}

    def step(label):
        last = (jd.step(5), td.step(5))
        _compare(jd, td, chain, label, last)
        for k in busy:
            busy[k] += sum(int(m[k]) for m in td.metrics_history[-5:])

    step("default, warm")
    for d in (jd, td):
        assert d.spread_rumor(3, "alpha") == 0
    step("default, after a spread")
    for i, kw in enumerate(specs):
        for d in (jd, td):
            d.set_dissemination(**kw)
        assert dataclasses.asdict(td.params.dissem) == dataclasses.asdict(jd.params.dissem)
        for d in (jd, td):
            d.spread_rumor(10 + i, f"rumor {i}")
            d.crash(6 + i)
        step(f"armed {kw}")
        step(f"armed {kw}, later")
    for d in (jd, td):
        d.leave(9)
        d.set_dissemination(strategy="push", topology="full", pipeline_budget=1)
        assert d.params.dissem.is_default
    rows = [d.join(seed_rows=(0, 1)) for d in (jd, td)]
    assert rows[0] == rows[1]
    step("default again, after a leave and a join")
    assert all(v > 0 for v in busy.values()), busy


def _pair(jparams, chain_cls, **kw):
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jd = JSimDriver(jparams, N_INITIAL, seed=SEED, record_metrics=True, **kw)
    chain = chain_cls(SEED, jparams)
    td = SimDriver(tparams, N_INITIAL, seed=SEED, record_metrics=True, device="cpu", draws=chain, **kw)
    return jd, td, chain


def test_pview_driver_swapping_specs_matches_jax():
    jd, td, chain = _pair(pview_jparams(), JaxChain)
    _swap_script(jd, td, chain, [dict(strategy="push_pull", topology="expander"),
                                 dict(strategy="accelerated", topology="torus")])


def test_sparse_driver_swapping_specs_matches_jax():
    jd, td, chain = _pair(sparse_jparams(), JaxChain, dense_links=True)
    _swap_script(jd, td, chain, [dict(strategy="pipelined", topology="ring", pipeline_budget=2),
                                 dict(strategy="push_pull", topology="expander")])


def test_dense_driver_swapping_specs_matches_jax():
    jd, td, chain = _pair(dense_jparams(), DenseChain)
    _swap_script(jd, td, chain, [dict(strategy="accelerated", topology="ring"),
                                 dict(strategy="push_pull", topology="full")])


class _SeedChains:
    """``draws=`` for the port's measure_spread: seed s replays the JAX
    harness's key chain from ``PRNGKey(base + s)``."""

    def __init__(self, chain_cls, params, base: int = 1000):
        self.chain_cls, self.params, self.base = chain_cls, params, base

    def __call__(self, seed: int):
        return self.chain_cls(self.base + seed, self.params)


@pytest.mark.parametrize("strategy,topology,engine", [
    ("push_pull", "expander", "dense"),
    ("accelerated", "expander", "pview"),
    ("pipelined", "ring", "sparse"),
])
def test_measure_spread_matches_jax(strategy, topology, engine):
    n, seeds = 64, (0, 1, 2)
    kw = dict(strategy=strategy, topology=topology, pipeline_budget=2)
    ref = JCert.measure_spread(JSpec(**kw), n=n, engine=engine, seeds=seeds)
    jparams = JCert._SETUPS[engine](JSpec(**kw), n, 3, 8)[0]
    chain_cls = DenseChain if engine == "dense" else JaxChain
    got = TCert.measure_spread(TSpec(**kw), n=n, engine=engine, seeds=seeds, device="cpu",
                               draws=_SeedChains(chain_cls, jparams))
    assert got["spread_ticks"] == ref["spread_ticks"] and None not in got["spread_ticks"]
    for a, b in zip(got.pop("coverage_curves"), ref.pop("coverage_curves")):
        assert len(a) == len(b) and np.allclose(a, b, rtol=0, atol=1e-4)
    assert got == ref
    assert TCert.certify_spread(got) == JCert.certify_spread(ref) and TCert.certify_spread(got)["certified"]


def test_pipeline_steady_state_matches_jax():
    spec = dict(strategy="pipelined", topology="expander", pipeline_budget=2)
    ref = JCert.measure_pipeline_steady_state(JSpec(**spec), n=64, seeds=(0,))
    jparams = JCert._dense_setup(JSpec(**spec), 64, 3, 8)[0]
    got = TCert.measure_pipeline_steady_state(TSpec(**spec), n=64, seeds=(0,), device="cpu",
                                              draws=_SeedChains(DenseChain, jparams, base=2000))
    assert got == ref and got["certified"]


def test_generator_windows_certify_on_the_host():
    """With no ``draws`` the harness draws from a generator per seed (the
    card's path, here on the host): a small matrix certifies and the
    record has the JAX harness's keys."""
    rec = TCert.spread_certifier(
        matrix=(("accelerated", "expander", "dense"), ("push", "expander", "pview"),
                ("pipelined", "ring", "dense")),
        n=64, seeds=(0, 1), device="cpu",
    )
    assert rec["ok"] and rec["n_certified"] == rec["n_entries"] == 3, rec
    assert rec["pipeline_steady_state"]["certified"]
    ref_keys = set(JCert.certify_spread(JCert.measure_spread(
        JSpec(strategy="accelerated", topology="expander"), n=32, seeds=(0,))))
    assert set(rec["entries"][0]) == ref_keys
