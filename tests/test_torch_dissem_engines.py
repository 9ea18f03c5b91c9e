"""The PyTorch port's three engines under every dissemination strategy,
against the JAX package's windows, tick by tick.

Same params (the JAX ``tests/test_dissemination.py`` knobs and scenarios),
same host mutations and the SAME uniform draws (the JAX window's own key
chain, handed to the port as numpy): every state leaf and every integer
metric equal after every tick, the two f32 metrics within 2 ulp.

* dense and pview: one spec per strategy on a non-trivial topology
  (``STRATEGY_SPECS``) at N = 33, and ``push_pull/expander`` (the reply
  leg) at N = 256;
* dense: the narrow i16 keys, the pull leg with the delay rings (D = 3),
  the ``geo`` topology with its WAN delay rings as the certifier builds
  it, and the pull leg over [N, N] row chunks of a few rows;
* sparse: the deterministic ``pipelined/ring`` and the ``push_pull``
  pair of JAX's ``test_sparse_lockstep_strategies``.

The full N = 256 matrix on both engines and both key layouts runs under
``-m slow``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.dissemination.certify as JCert
import scalecube_cluster_tpu.ops.kernel as JK
import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
import scalecube_cluster_tpu.ops.state as JS
from scalecube_cluster_tpu.dissemination import DissemSpec
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.dissemination import certify as TCert
from scalecube_cluster_tpu_torch.ops import _tensor
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from test_torch_dense import _assert_metrics_equal, dense_draws
from test_torch_dense import _assert_state_equal as _assert_dense_equal
from test_torch_pview_fused import _assert_state_equal, _jax_draws

torch.set_num_threads(1)

#: one representative per strategy, on a non-trivial topology each (the
#: JAX tests' ``STRATEGY_SPECS``)
STRATEGY_SPECS = [
    DissemSpec(strategy="push", topology="expander"),
    DissemSpec(strategy="push_pull", topology="expander"),
    DissemSpec(strategy="pipelined", topology="ring", pipeline_budget=2),
    DissemSpec(strategy="accelerated", topology="torus", torus_rows=3),
    DissemSpec(strategy="tuneable", topology="expander", tuneable_mix=0.5),
]
_IDS = [f"{s.strategy}-{s.topology}" for s in STRATEGY_SPECS]
PULL = DissemSpec(strategy="push_pull", topology="expander")


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


def _check_busy(totals, label):
    # the window must move rumors, or equality proves little
    for k in ("gossip_msgs", "rumor_deliveries"):
        assert totals.get(k, 0) > 0, (label, totals)


# -- dense ---------------------------------------------------------------------------


def _dense_params(n, spec, key_dtype="i32", **kw):
    base = dict(
        capacity=n, fanout=3, repeat_mult=2, ping_req_k=2, fd_every=2,
        sync_every=6, suspicion_mult=2, rumor_slots=6, seed_rows=(0,),
        key_dtype=key_dtype, dissem=spec,
    )
    base.update(kw)
    return JS.SimParams(**base)


@functools.lru_cache(maxsize=None)
def _dense_window(params):
    return JK.make_run(params, 1, donate=False)


def _dense_run(params, jst, events, ticks: int, seed: int):
    """``ticks`` one-tick windows of the port and the JAX ``make_run`` from
    ``jst`` (the port starts from its snapshot), ``events[t](mod, st)``
    applied to both before tick t. Returns the port's metric totals."""
    tparams = _tparams(params)
    tst = convert.state_from_numpy(JS.snapshot(jst), device="cpu")
    key = jax.random.PRNGKey(seed)
    run = TK.make_run(tparams, 1)
    totals: dict = {}
    for t in range(ticks):
        if t in events:
            jst, tst = events[t](JS, jst), events[t](TS, tst)
            _assert_dense_equal(jst, tst, f"after the host mutation at tick {t}")
        jst, key_after, jms, _ = _dense_window(params)(jst, key)
        key, draws = dense_draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _ = run(tst, draws)
        label = f"tick {t + 1} (n={params.capacity}, {params.key_dtype}, {params.dissem.strategy}/" \
                f"{params.dissem.topology}, D={params.delay_slots})"
        _assert_dense_equal(jst, tst, label)
        _assert_metrics_equal(jms, tms, label)
        for k, v in tms.items():
            if v.dtype != torch.float32:
                totals[k] = totals.get(k, 0) + int(v.sum())
    return totals


def _dense_lockstep(params, n0: int, seed: int, ticks: int):
    """JAX's ``_dense_lockstep`` scenario: a warm start over a random
    per-link loss plane (exact f32 sixty-fourths), rumors at ticks 1 and
    7, a crash at 3, a join at 12."""
    n = params.capacity
    st = JS.init_state(params, n0, warm=True)
    loss = np.random.default_rng(seed).integers(0, 16, size=(n, n)).astype(np.float32) / 64.0
    lj = jnp.asarray(loss)
    st = st.replace(loss=lj, fetch_rt=JS._roundtrip(lj))
    events = {
        1: lambda mod, s: mod.spread_rumor(s, 0, origin=3),
        3: lambda mod, s: mod.crash_row(s, 7),
        7: lambda mod, s: mod.spread_rumor(s, 1, origin=12),
        12: lambda mod, s: mod.join_row(s, n0, [0]),
    }
    totals = _dense_run(params, st, events, ticks, 100 + seed)
    _check_busy(totals, params.dissem)
    return totals


@pytest.mark.parametrize("spec", STRATEGY_SPECS, ids=_IDS)
def test_dense_window_matches_jax_n33(spec):
    _dense_lockstep(_dense_params(33, spec), 30, seed=3, ticks=16)


def test_dense_pull_window_matches_jax_n256():
    totals = _dense_lockstep(_dense_params(256, PULL), 250, seed=5, ticks=6)
    assert totals["sync_roundtrips"] > 0


def test_dense_narrow_keys_match_jax():
    """The i16 layout's packed sampler is bypassed by the structured peers;
    the pull leg gathers narrow rows."""
    for spec in (DissemSpec(strategy="accelerated", topology="expander"), PULL):
        _dense_lockstep(_dense_params(33, spec, key_dtype="i16"), 30, seed=7, ticks=16)


def test_dense_pull_with_delay_ring_matches_jax():
    """Pull replies ride undelayed contacts only (DZ-2), with the rings
    live (D = 3, mean delay 0.8 ticks)."""
    params = _dense_params(33, PULL, delay_slots=3)
    st = JS.init_state(params, 30, warm=True, uniform_delay=0.8)
    events = {1: lambda mod, s: mod.spread_rumor(s, 0, origin=3)}
    totals = _dense_run(params, st, events, 18, 21)
    _check_busy(totals, "pull with rings")


def test_dense_geo_with_wan_delay_matches_jax():
    """The certifier's geo cell: 4 zones of 16, cross-zone links at a mean
    delay of 2 ticks through the rings (D = 6) set by
    ``apply_geo_wan_delay``; the port builds its own base state."""
    spec = DissemSpec(strategy="push", topology="geo", geo_wan_delay_ticks=2)
    params, base, _ = JCert._dense_setup(spec, 64, 3, 4)
    tspec = _tparams(params).dissem
    tparams, tbase, _ = TCert._dense_setup(tspec, 64, 3, 4, device="cpu")
    assert tparams == _tparams(params) and tparams.delay_slots == 6
    jst = JS.spread_rumor(base(), 0, origin=5)
    _assert_dense_equal(jst, TS.spread_rumor(tbase(), 0, origin=5), "the geo base state")
    totals = _dense_run(params, jst, {9: lambda mod, s: mod.spread_rumor(s, 1, origin=40)}, 30, 2)
    _check_busy(totals, "geo")


@pytest.mark.parametrize("kd,cells", [("i32", 3000), ("i16", 777)])
def test_dense_pull_over_row_chunks_matches_jax(monkeypatch, kd, cells):
    """The pull leg's peer-row gathers and every other [N, N] pass over row
    chunks of 11 (i32) and 3 (i16) rows, the last one short."""
    monkeypatch.setattr(_tensor, "PLANE_CHUNK_CELLS", cells)
    _dense_lockstep(_dense_params(256, PULL, key_dtype=kd), 250, seed=5, ticks=6)


@pytest.mark.slow
@pytest.mark.parametrize("spec", STRATEGY_SPECS, ids=_IDS)
def test_dense_window_matches_jax_n256_full_matrix(spec):
    if spec.topology == "torus":
        spec = dataclasses.replace(spec, torus_rows=16)
    _dense_lockstep(_dense_params(256, spec), 250, seed=5, ticks=6)
    _dense_lockstep(_dense_params(256, spec, key_dtype="i16"), 250, seed=9, ticks=6)


# -- pview ---------------------------------------------------------------------------


def _pview_params(n, spec, key_dtype="i32", **kw):
    base = dict(
        capacity=n, view_slots=10, active_slots=4, fanout=2, repeat_mult=3,
        ping_req_k=2, fd_every=2, sync_every=5, suspicion_mult=2,
        sweep_every=2, sample_tries=4, rumor_slots=3, mr_slots=16,
        announce_slots=8, sync_announce=2, seed_rows=(0, 1), apply_slots=4,
        key_dtype=key_dtype, dissem=spec,
    )
    base.update(kw)
    return JPV.PviewParams(**base)


@functools.lru_cache(maxsize=None)
def _pview_window(params):
    return JPV.make_pview_fused_run(params, 1, donate=False)


@functools.lru_cache(maxsize=None)
def _sparse_window(params):
    return JSP.make_sparse_run(params, 1, donate=False)


def _record_run(jmod, tmod, jwindow, trun, params, jst, events, ticks: int, seed: int):
    """The pview/sparse lockstep: ``ticks`` one-tick windows of the port and
    of ``jwindow`` from ``jst``, ``events`` applied to both first."""
    tparams = _tparams(params)
    tst = convert.state_from_numpy(jmod.snapshot(jst), device="cpu")
    key = jax.random.PRNGKey(seed)
    totals: dict = {}
    for t in range(ticks):
        if t in events:
            jst, tst = events[t](jmod, jst), events[t](tmod, tst)
            _assert_state_equal(jst, tst, f"after the host mutation at tick {t}")
        jst, key_after, jms, _ = jwindow(params)(jst, key)
        key, draws = _jax_draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _ = trun(tst, draws, 1, tparams)
        label = f"tick {t + 1} (n={params.capacity}, {params.dissem.strategy}/{params.dissem.topology})"
        _assert_state_equal(jst, tst, label)
        _assert_metrics_equal(jms, tms, label)
        for k, v in tms.items():
            if v.dtype != torch.float32:
                totals[k] = totals.get(k, 0) + int(v.sum())
    return totals


_RECORD_EVENTS = {
    1: lambda mod, s: mod.spread_rumor(s, 0, origin=3),
    2: lambda mod, s: mod.set_uniform_loss(s, 0.25),
    4: lambda mod, s: mod.crash_row(s, 4),
}


def _pview_lockstep(params, n0: int, seed: int, ticks: int):
    """JAX's ``_pview_lockstep`` scenario: a warm start, a rumor at tick 1,
    loss 0.25 from tick 2, a crash at 4, a join at 10."""
    events = dict(_RECORD_EVENTS)
    events[10] = lambda mod, s: mod.join_row(s, params.capacity - 1, [0])
    jst = JPV.init_pview_state(params, n0, warm=True)
    totals = _record_run(JPV, TPV, _pview_window, TPV.run_pview_ticks, params, jst, events, ticks, 200 + seed)
    _check_busy(totals, params.dissem)
    return totals


@pytest.mark.parametrize("spec", STRATEGY_SPECS, ids=_IDS)
def test_pview_window_matches_jax_n33(spec):
    _pview_lockstep(_pview_params(33, spec), 28, seed=3, ticks=14)


def test_pview_pull_window_matches_jax_n256():
    totals = _pview_lockstep(_pview_params(256, PULL, mr_slots=32), 250, seed=5, ticks=6)
    assert totals["mr_deliveries"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("spec", STRATEGY_SPECS, ids=_IDS)
def test_pview_window_matches_jax_n256_full_matrix(spec):
    if spec.topology == "torus":
        spec = dataclasses.replace(spec, torus_rows=16)
    _pview_lockstep(_pview_params(256, spec, mr_slots=32), 250, seed=5, ticks=6)
    _pview_lockstep(_pview_params(256, spec, key_dtype="i16", mr_slots=32), 250, seed=9, ticks=6)


# -- sparse --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    DissemSpec(strategy="pipelined", topology="ring", pipeline_budget=2),
    PULL,
], ids=["pipelined-ring", "push_pull-expander"])
def test_sparse_window_matches_jax(spec):
    """JAX's ``test_sparse_lockstep_strategies`` pair on the lean layout."""
    params = JSP.SparseParams(
        capacity=33, fanout=2, repeat_mult=3, ping_req_k=2, fd_every=2,
        sync_every=5, suspicion_mult=2, sweep_every=2, sample_tries=4,
        rumor_slots=3, mr_slots=16, announce_slots=8, sync_announce=2,
        seed_rows=(0, 1), dissem=spec,
    )
    jst = JSP.init_sparse_state(params, 28, warm=True, dense_links=False)
    totals = _record_run(JSP, TSP, _sparse_window, TSP.run_sparse_ticks, params, jst, _RECORD_EVENTS, 12, 31)
    _check_busy(totals, spec)
