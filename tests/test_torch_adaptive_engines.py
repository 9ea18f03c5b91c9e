"""Each engine's adaptive window in the PyTorch port against the JAX
package's adaptive windows, after every tick.

The port's window (``make_adaptive_run`` on dense, sparse and pview) is fed
the JAX window's own key chain and held against BOTH JAX spellings — the
unfused ``make_*adaptive_run`` and the fused ``make_*fused_adaptive_run`` —
in every state leaf, the three adaptive planes (``lh``, ``conf_key``,
``conf``) and every per-tick metric (the two f32 metrics within 2 ulp, as
in ``tests/test_torch_pview_fused.py``), for 48 one-tick windows.

Each run has a degraded cohort: inbound asymmetric loss on three rows and a
flaky observer whose own sends mostly drop (dense, and sparse with dense
links), a crash at the start and another mid-run. The dense runs also have
the delay rings at D = 4 with a slow member, whose probes go through
``scaled_timely_rt``. Pview runs under a uniform loss floor and a crash
wave. One more run arms the ``pipelined`` strategy with a 2-slot budget and
shows a planted false suspicion's refutation still reaches every observer.
N = 33 with i32 and i16 keys run here; N = 256 goes under ``-m slow``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu import adaptive as JA
from scalecube_cluster_tpu.dissemination import DissemSpec as JSpec
from scalecube_cluster_tpu.ops import kernel as JK
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from test_torch_dense import _assert_metrics_equal, _assert_state_equal, dense_draws
from test_torch_pview_fused import _assert_state_equal as _assert_leaves_equal
from test_torch_pview_fused import _jax_draws

torch.set_num_threads(1)

TICKS, MID = 48, 20
SPEC = JA.AdaptiveSpec(enabled=True, lh_max=4, min_mult=2, max_mult=6, conf_target=3)
COHORT, FLAKY, SLOW = [5, 6, 7], 9, 11


def _dense_params(n: int, kd: str, D: int = 4, **over):
    return JS.SimParams(capacity=n, key_dtype=kd, fanout=2, ping_req_k=1, fd_every=1, sync_every=8,
                        suspicion_mult=2, rumor_slots=4, seed_rows=(0, 1), delay_slots=D, adaptive=SPEC,
                        **over)


def _sparse_params(n: int):
    return JSP.SparseParams(capacity=n, fanout=2, ping_req_k=1, fd_every=1, sync_every=8, suspicion_mult=2,
                            sweep_every=2, rumor_slots=4, mr_slots=32, announce_slots=16, seed_rows=(0, 1),
                            full_metrics=True, adaptive=SPEC)


def _pview_params(n: int, kd: str):
    return JPV.PviewParams(capacity=n, view_slots=12, active_slots=6, fanout=2, ping_req_k=1, fd_every=1,
                           sync_every=8, suspicion_mult=2, sweep_every=2, rumor_slots=4, mr_slots=16,
                           announce_slots=8, seed_rows=(0, 1), full_metrics=True, key_dtype=kd,
                           tombstone_ticks=16, adaptive=SPEC)


def _degrade(mod, st, n: int, delay: bool):
    """The degraded cohort: inbound loss on COHORT, a flaky observer whose
    sends mostly drop, with the rings a slow member, and a crash."""
    everyone = list(range(n))
    st = mod.set_link_loss(st, everyone, COHORT, 0.7)
    st = mod.set_link_loss(st, [FLAKY], everyone, 0.7)
    if delay:
        st = mod.set_link_delay(st, everyone, [SLOW], 2.0)
        st = mod.set_link_delay(st, [SLOW], everyone, 2.0)
    st = mod.spread_rumor(st, 0, 3)
    return mod.crash_rows(st, [12])


def _midrun(mod, st, n: int):
    """A second crash, and the flaky observer's links mend."""
    st = mod.crash_rows(st, [14])
    return mod.set_link_loss(st, [FLAKY], list(range(n)), 0.05)


def _ad_numpy(ad) -> dict:
    return {k: np.asarray(getattr(ad, k)) for k in ("lh", "conf_key", "conf")}


def _assert_ad_equal(jad, tad, label):
    for k, v in _ad_numpy(jad).items():
        g = getattr(tad, k)
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), v), f"{label}: adaptive plane {k} diverged"


@functools.lru_cache(maxsize=None)
def _jax_windows(make_pair, params):
    unfused, fused = make_pair
    return unfused(params, 1, donate=False), fused(params, 1, donate=False)


def _lockstep(make_pair, params, tmake, jst, tst, draws_of, assert_state, events, label):
    """``TICKS`` one-tick adaptive windows of the port against both JAX
    adaptive windows; ``events[t](mod, st)`` runs before tick t on all three
    states. Returns the port's (state, ad, stacked metrics)."""
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    assert tparams.adaptive.enabled and tparams.adaptive.lh_max == SPEC.lh_max
    n = params.capacity
    jad = JA.init_adaptive_state(n)
    tad = convert.adaptive_from_numpy(_ad_numpy(jad), device="cpu")
    runs = _jax_windows(make_pair, params)
    jstates = [(jst, jad), (jst, jad)]
    run = tmake(tparams, 1)
    key = jax.random.PRNGKey(7)
    per_tick = []
    for t in range(TICKS):
        if t in events:
            mods = events[t]
            jstates = [(mods("jax", s), a) for s, a in jstates]
            tst = mods("torch", tst)
            assert_state(jstates[0][0], tst, f"{label}: after the host mutation at tick {t}")
        outs = []
        for i, r in enumerate(runs):
            s, a, key_after, jms, _ = r(*jstates[i], key)
            jstates[i] = (s, a)
            outs.append((s, a, jms))
        key, draws = draws_of(key, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tad, tms, _ = run(tst, tad, draws)
        for kind, (s, a, jms) in zip(("unfused", "fused"), outs):
            where = f"{label}: tick {t + 1} against the JAX {kind} adaptive window"
            assert_state(s, tst, where)
            _assert_ad_equal(a, tad, where)
            _assert_metrics_equal(jms, tms, where)
        per_tick.append(tms)
    ms = {k: torch.cat([m[k] for m in per_tick]) for k in per_tick[0]}
    return tst, tad, ms


def _assert_busy(ms, label):
    gauges = TK.adaptive_gauges(ms)
    assert float(gauges["adaptive_lh_max"]) >= 1, f"{label}: local health never moved"
    assert float(gauges["adaptive_conf_max"]) >= 1, f"{label}: no suspicion was ever confirmed"
    assert int(ms["fd_failed_probes"].sum()) > 0 and int(ms["fd_new_suspects"].sum()) > 0, label


def _dense_case(n: int, kd: str, D: int):
    params = _dense_params(n, kd, D)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    mods = {"jax": JS, "torch": TS}

    def start(mod, p, kw):
        st = mod.init_state(p, n - 2, uniform_loss=0.05, uniform_delay=0.5 if D else 0.0, **kw)
        return _degrade(mod, st, n, delay=bool(D))

    jst = start(JS, params, {})
    tst = start(TS, tparams, {"device": "cpu"})
    _assert_state_equal(jst, tst, "scenario start")
    events = {MID: lambda which, st: _midrun(mods[which], st, n)}

    def draws_of(key, p):
        return dense_draws(key, 1, p)

    tst, tad, ms = _lockstep((JK.make_adaptive_run, JK.make_fused_adaptive_run), params, TK.make_adaptive_run,
                             jst, tst, draws_of, _assert_state_equal, events, f"dense n={n} {kd} D={D}")
    _assert_busy(ms, "dense")
    vk = tst.view_key
    assert int(((vk >= 0) & ((vk & 3) == 3)).sum()) > 0, "no suspicion ever expired"
    return ms


@pytest.mark.parametrize("kd,D", [("i32", 4), ("i16", 4), ("i32", 0)])
def test_dense_adaptive_window_matches_jax_n33(kd, D):
    _dense_case(33, kd, D)


@pytest.mark.slow
@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_dense_adaptive_window_matches_jax_n256(kd):
    _dense_case(256, kd, 4)


def _sparse_case(n: int):
    params = _sparse_params(n)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    mods = {"jax": JSP, "torch": TSP}
    jst = _degrade(JSP, JSP.init_sparse_state(params, n - 2, dense_links=True, uniform_loss=0.05), n, False)
    tst = _degrade(TSP, TSP.init_sparse_state(tparams, n - 2, dense_links=True, uniform_loss=0.05, device="cpu"),
                   n, False)
    _assert_leaves_equal(jst, tst, "scenario start")
    events = {MID: lambda which, st: _midrun(mods[which], st, n)}

    def draws_of(key, p):
        return _jax_draws(key, 1, p)

    _tst, _tad, ms = _lockstep((JSP.make_sparse_adaptive_run, JSP.make_sparse_fused_adaptive_run), params,
                               TSP.make_sparse_adaptive_run, jst, tst, draws_of, _assert_leaves_equal, events,
                               f"sparse n={n}")
    _assert_busy(ms, "sparse")


def test_sparse_adaptive_window_matches_jax_n33():
    _sparse_case(33)


@pytest.mark.slow
def test_sparse_adaptive_window_matches_jax_n256():
    _sparse_case(256)


def _pview_case(n: int, kd: str):
    params = _pview_params(n, kd)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    mods = {"jax": JPV, "torch": TPV}

    def start(mod, p, kw):
        st = mod.init_pview_state(p, n - 2, **kw)
        st = mod.set_uniform_loss(st, 0.15, floor=True)
        st = mod.spread_rumor(st, 0, 3)
        return mod.crash_rows(st, [12])

    jst = start(JPV, params, {})
    tst = start(TPV, tparams, {"device": "cpu"})
    _assert_leaves_equal(jst, tst, "scenario start")
    wave = [2, 3, 20, n - 5]
    events = {MID: lambda which, st: mods[which].crash_rows(st, wave)}

    def draws_of(key, p):
        return _jax_draws(key, 1, p)

    _tst, _tad, ms = _lockstep((JPV.make_pview_adaptive_run, JPV.make_pview_fused_adaptive_run), params,
                               TPV.make_pview_adaptive_run, jst, tst, draws_of, _assert_leaves_equal, events,
                               f"pview n={n} {kd}")
    _assert_busy(ms, "pview")


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_pview_adaptive_window_matches_jax_n33(kd):
    _pview_case(33, kd)


@pytest.mark.slow
@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_pview_adaptive_window_matches_jax_n256(kd):
    _pview_case(256, kd)


def test_refutation_disseminates_under_pipelined_budget():
    """A false suspicion planted at one observer is refuted by its subject
    (AD-5: membership records ride the unbudgeted class), and the bumped
    incarnation reaches every up observer under ``pipelined`` with a
    2-slot user-rumor budget — the same state as the JAX adaptive window
    after every tick."""
    n = 16
    params = _dense_params(n, "i32", D=0, dissem=JSpec(strategy="pipelined", topology="expander",
                                                          pipeline_budget=2))
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    assert tparams.dissem.strategy == "pipelined" and tparams.dissem.pipeline_budget == 2

    def plant(mod, st):
        # observer 3 holds row 8 SUSPECT at incarnation 0, suspected at tick 0
        if mod is JS:
            return st.replace(view_key=st.view_key.at[3, 8].set(2), changed_at=st.changed_at.at[3, 8].set(0))
        st.view_key[3, 8] = 2
        st.changed_at[3, 8] = 0
        return st

    jst = plant(JS, JS.init_state(params, n))
    tst = plant(TS, TS.init_state(tparams, n, device="cpu"))
    _assert_state_equal(jst, tst, "planted")
    jad = JA.init_adaptive_state(n)
    tad = convert.adaptive_from_numpy(_ad_numpy(jad), device="cpu")
    jrun = JK.make_adaptive_run(params, 1, donate=False)
    trun = TK.make_adaptive_run(tparams, 1)
    key = jax.random.PRNGKey(5)
    for t in range(3 * params.sync_every):
        jst, jad, _k, jms, _ = jrun(jst, jad, key)
        key, draws = dense_draws(key, 1, params)
        tst, tad, tms, _ = trun(tst, tad, draws)
        _assert_state_equal(jst, tst, f"tick {t + 1}")
        _assert_ad_equal(jad, tad, f"tick {t + 1}")
        _assert_metrics_equal(jms, tms, f"tick {t + 1}")
    assert int(tst.view_key[8, 8]) >> 2 >= 1, "the subject never refuted"
    col = tst.view_key[tst.up, 8]
    assert ((col & 3) == 0).all(), "the refutation did not reach every observer"
    assert ((col >> 2) >= 1).all(), "the incarnation bump was lost"
