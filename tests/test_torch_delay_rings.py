"""The pending delivery rings of the port's sparse and pview engines against
the JAX package's.

With ``delay_slots`` = D > 0 each gossip contact takes a geometric delay
and a late one lands through the [D, N, ·] rings ``pending_minf``,
``pending_inf`` and ``pending_src``; the FD probes and the SYNC round
trip are gated on their timeouts (the adaptive plane stretches the direct
probe's). Same params, same host mutations and the SAME uniform draws (the
JAX window's key chain) must give the same value in every state leaf, the
three rings included, after every tick, and in every integer metric,
against both JAX windows of each engine; the two f32 metrics may differ by
at most 2 ulp. The fleets, the driver, a ``SlowMember`` scenario on sparse
with dense links and the params plumbing are held on their own.
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
from scalecube_cluster_tpu import adaptive as JAD
from scalecube_cluster_tpu_torch import adaptive as TAD
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import _tensor
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from test_torch_pview_fused import _assert_state_equal, _jax_draws
from test_torch_sparse import _assert_metrics_equal

torch.set_num_threads(1)

TICKS = 40
MUTATE_AT, SLOW_AT, HEAL_AT = 12, 6, 28

_SPARSE_KNOBS = dict(fanout=2, ping_req_k=1, fd_every=2, sync_every=8, suspicion_mult=1,
                     sweep_every=4, rumor_slots=4, seed_rows=(0, 1), mr_slots=32,
                     announce_slots=16, full_metrics=True)
_PVIEW_KNOBS = dict(fanout=2, repeat_mult=3, ping_req_k=1, fd_every=2, sync_every=8,
                    suspicion_mult=1, sweep_every=4, rumor_slots=4, seed_rows=(0, 1),
                    mr_slots=16, announce_slots=8, full_metrics=True, delivery_kernel="xla")
_ADAPTIVE = dict(enabled=True, lh_max=3, conf_target=2, min_mult=2, max_mult=4)


def _sparse_params(n: int, D: int, **over):
    return JSP.SparseParams(capacity=n, delay_slots=D, **{**_SPARSE_KNOBS, **over})


def _pview_params(n: int, D: int, kd: str, **over):
    return JPV.PviewParams(capacity=n, delay_slots=D, key_dtype=kd,
                           **{**_PVIEW_KNOBS, "tombstone_ticks": 16, **over})


def _port_params(params):
    return convert.params_from_dict(dataclasses.asdict(params))


@functools.lru_cache(maxsize=None)
def _jax_windows(params):
    """Both JAX one-tick windows of the engine ``params`` select (the
    adaptive ones for an enabled spec)."""
    if isinstance(params, JPV.PviewParams):
        if params.adaptive.enabled:
            return (JPV.make_pview_adaptive_run(params, 1, donate=False),
                    JPV.make_pview_fused_adaptive_run(params, 1, donate=False))
        return JPV.make_pview_run(params, 1, donate=False), JPV.make_pview_fused_run(params, 1, donate=False)
    if params.adaptive.enabled:
        return (JSP.make_sparse_adaptive_run(params, 1, donate=False),
                JSP.make_sparse_fused_adaptive_run(params, 1, donate=False))
    return JSP.make_sparse_run(params, 1, donate=False), JSP.make_sparse_fused_run(params, 1, donate=False)


def _sparse_start(mod, params, n, dense_links, **kw):
    st = mod.init_sparse_state(params, n - 4, dense_links=dense_links, uniform_loss=0.05,
                               uniform_delay=1.5, **kw)
    st = mod.spread_rumor(st, 0, 3)
    st = mod.spread_rumor(st, 1, 7)
    st = mod.crash_rows(st, [6, 17])
    return mod.begin_leave(st, 9)


def _pview_start(mod, params, n, **kw):
    st = mod.init_pview_state(params, n - 4, uniform_loss=0.05, uniform_delay=1.5, **kw)
    st = mod.spread_rumor(st, 0, 3)
    st = mod.spread_rumor(st, 1, 7)
    st = mod.crash_rows(st, [6, 17])
    return mod.begin_leave(st, 9)


def _mutations(engine: str, params, n: int, dense_links: bool):
    """tick -> host mutation (mod, state) -> state: a churn batch with a
    rejoin; on dense links a slow member (rows 0-3 at 4.0 ticks outbound)
    and its heal."""
    def churn(mod, st):
        st = mod.crash_rows(st, [3])
        st = (mod.join_rows(st, [6, n - 3], params.seed_rows) if engine == "sparse"
              else mod.join_row(mod.join_row(st, 6, params.seed_rows), n - 3, params.seed_rows))
        st = mod.update_metadata(st, 4)
        st = mod.spread_rumor(st, 2, 12)
        return mod.begin_leave(st, 11)

    out = {MUTATE_AT: churn}
    if dense_links:
        rest = list(range(4, n))
        out[SLOW_AT] = lambda mod, st: mod.set_link_delay(st, [0, 1, 2, 3], rest, 4.0)
        out[HEAL_AT] = lambda mod, st: mod.set_link_delay(st, [0, 1, 2, 3], rest, 1.5)
    return out


def _run_both(engine: str, params, n: int, ticks: int = TICKS, dense_links: bool = False):
    """``ticks`` one-tick windows of the port and of both JAX windows from
    one scenario, every leaf compared after each tick and each mutation.
    Returns per-metric totals and the peak ring occupancy."""
    tparams = _port_params(params)
    if engine == "sparse":
        jst = _sparse_start(JSP, params, n, dense_links)
        t0 = _sparse_start(TSP, tparams, n, dense_links, device="cpu")
        mod_j, mod_t = JSP, TSP
    else:
        jst = _pview_start(JPV, params, n)
        t0 = _pview_start(TPV, tparams, n, device="cpu")
        mod_j, mod_t = JPV, TPV
    _assert_state_equal(jst, t0, f"{engine} start (n={n})")
    tst = convert.state_from_numpy({f.name: np.asarray(getattr(jst, f.name)) for f in dataclasses.fields(jst)},
                                   device="cpu")
    adaptive = params.adaptive.enabled
    jad = JAD.init_adaptive_state(n) if adaptive else None
    jfad = jad
    tad = TAD.init_adaptive_state(n, device="cpu") if adaptive else None
    jfst = jst
    slow, fast = _jax_windows(params)
    key = jax.random.PRNGKey(11)
    busy: dict = {}
    ring_peak = 0
    muts = _mutations(engine, params, n, dense_links)
    for t in range(ticks):
        if t in muts:
            step = muts[t]
            jst, jfst, tst = step(mod_j, jst), step(mod_j, jfst), step(mod_t, tst)
            _assert_state_equal(jst, tst, f"after the mutation at tick {t} (n={n})")
        if adaptive:
            jst, jad, key_after, jms, _ = slow(jst, jad, key)
            jfst, jfad, _, jfms, _ = fast(jfst, jfad, key)
        else:
            jst, key_after, jms, _ = slow(jst, key)
            jfst, _, jfms, _ = fast(jfst, key)
        key, draws = _jax_draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        if adaptive:
            run = mod_t.make_sparse_adaptive_run if engine == "sparse" else mod_t.make_pview_adaptive_run
            tst, tad, tms, _ = run(tparams, 1)(tst, tad, draws)
        else:
            run = mod_t.make_sparse_run if engine == "sparse" else mod_t.make_pview_run
            tst, tms, _ = run(tparams, 1)(tst, draws)
        for kind, js, jm, ja in (("unfused", jst, jms, jad), ("fused", jfst, jfms, jfad)):
            label = f"{engine} tick {t + 1} (n={n}) against the JAX {kind} window"
            _assert_state_equal(js, tst, label)
            _assert_metrics_equal(jm, tms, label)
            if adaptive:
                got = convert.adaptive_to_numpy(tad)
                for k in ("lh", "conf_key", "conf"):
                    assert np.array_equal(got[k], np.asarray(getattr(ja, k))), f"{label}: adaptive {k}"
        for k, v in jms.items():
            busy[k] = busy.get(k, 0) + float(np.asarray(v).sum())
        ring_peak = max(ring_peak, int(tst.pending_inf.sum()) + int(tst.pending_minf.sum()))
    return busy, ring_peak


_MUST_RUN = ("mr_accepts", "sync_roundtrips", "fd_new_suspects", "rumor_deliveries", "announced")


# tier-1: each D, each link layout and the N = 256 case; -m slow the rest
SLOW = pytest.mark.slow


@pytest.mark.parametrize("D,dense_links,n", [(4, False, 33), (6, True, 33), (6, False, 256),
                                             pytest.param(6, False, 33, marks=SLOW),
                                             pytest.param(4, True, 33, marks=SLOW)])
def test_sparse_window_with_rings_matches_jax(D, dense_links, n):
    busy, ring_peak = _run_both("sparse", _sparse_params(n, D), n, dense_links=dense_links)
    assert all(busy[k] > 0 for k in _MUST_RUN), busy
    assert ring_peak > 0, "no delivery went through the rings"


@pytest.mark.parametrize("D,kd,n", [(4, "i32", 33), (6, "i16", 33),
                                    pytest.param(6, "i32", 33, marks=SLOW),
                                    pytest.param(4, "i16", 33, marks=SLOW),
                                    pytest.param(6, "i32", 256, marks=SLOW)])
def test_pview_window_with_rings_matches_jax(D, kd, n):
    busy, ring_peak = _run_both("pview", _pview_params(n, D, kd), n)
    assert all(busy[k] > 0 for k in _MUST_RUN), busy
    assert ring_peak > 0, "no delivery went through the rings"


@pytest.mark.parametrize("engine,dense_links", [("sparse", True), ("pview", False),
                                                pytest.param("sparse", False, marks=SLOW)])
def test_adaptive_window_with_rings_matches_jax(engine, dense_links):
    """The adaptive windows with D = 4: the direct probe's timeout
    stretched by each prober's local health (``scaled_timely_rt``)."""
    n = 33
    spec = JAD.AdaptiveSpec(**_ADAPTIVE)
    params = (_sparse_params(n, 4, adaptive=spec) if engine == "sparse"
              else _pview_params(n, 4, "i32", adaptive=spec))
    busy, _ = _run_both(engine, params, n, ticks=32, dense_links=dense_links)
    assert busy["adaptive_lh_high"] > 0, busy


def test_params_and_state_plumbing():
    """``convert`` carries ``delay_slots`` on every engine; the states
    start with [D, N, ·] rings equal to JAX's; pview keeps refusing a
    per-link delay, and a sparse scalar-link state refuses one too."""
    for jp in (_sparse_params(33, 6), _pview_params(33, 6, "i16")):
        tp = _port_params(jp)
        assert tp.delay_slots == 6
    tp = _port_params(_sparse_params(33, 0))
    with pytest.raises(ValueError, match="delay_slots > 0"):
        TSP.init_sparse_state(tp, 33, uniform_delay=1.0, device="cpu")
    with pytest.raises(ValueError, match="delay_slots > 0"):
        TSP.set_link_delay(TSP.init_sparse_state(tp, 33, dense_links=True, device="cpu"), [0], [1], 2.0)
    tpv = _port_params(_pview_params(33, 6, "i32"))
    st = TPV.init_pview_state(tpv, 33, uniform_delay=1.5, device="cpu")
    assert tuple(st.pending_minf.shape) == (6, 33, tpv.mr_pool)
    with pytest.raises(ValueError, match="uniform delay only"):
        TPV.set_link_delay(st, [0], [1], 2.0)
    with pytest.raises(ValueError, match="dense links"):
        TSP.set_link_delay(TSP.init_sparse_state(_port_params(_sparse_params(33, 4)), 33, device="cpu"),
                           [0], [1], 2.0)


# -- the fleets over the rings -------------------------------------------------


@pytest.mark.parametrize("engine", ["sparse", "pview"])
def test_fleet_with_rings_matches_jax(engine):
    """A D = 4 fleet (S = 2, T = 8) fed the JAX fleet's per-row key chains
    equals JAX ``make_fleet_run`` in every leaf, the rings included: the
    late deliveries scatter into each scenario's ring under the vmap."""
    from scalecube_cluster_tpu.ops import fleet as JFL
    from scalecube_cluster_tpu_torch.ops import fleet as TFL
    from test_torch_fleet import FleetChain, _assert_fleet_equal, _jax_fleet, _to_port

    n, seeds, ticks = 33, (0, 7), 8
    knobs = dict(fanout=2, repeat_mult=3, ping_req_k=1, fd_every=2, sync_every=8, suspicion_mult=3,
                 rumor_slots=8, seed_rows=(0,), delay_slots=4)
    if engine == "sparse":
        jp = JSP.SparseParams(capacity=n, mr_slots=16, **knobs)
        jst = JSP.init_sparse_state(jp, n, warm=True, uniform_loss=0.1, uniform_delay=1.5)
        jmod, jmake, tmake = JSP, JSP.make_sparse_fleet_run, TSP.make_sparse_fleet_run
    else:
        jp = JPV.PviewParams(capacity=n, **knobs)
        jst = JPV.init_pview_state(jp, n, warm=True, uniform_loss=0.1, uniform_delay=1.5)
        jmod, jmake, tmake = JPV, JPV.make_pview_fleet_run, TPV.make_pview_fleet_run
    jst = jmod.crash_rows(jst, [5])
    origins = [(s * 37 + 1) % n for s in seeds]
    jfs = JFL.fleet_inject_rumor(jmod, JFL.fleet_broadcast(jst, len(seeds)), 0, origins)
    tfs = _to_port(jfs)
    keys = JFL.fleet_keys(seeds)
    chain = FleetChain(keys, jp, _jax_draws)
    jfs2, _, jms, _ = _jax_fleet(jmake, jp, ticks)(jfs, keys)
    tfs2, tms, _ = tmake(_port_params(jp), ticks)(tfs, chain(ticks))
    _assert_fleet_equal(jfs2, tfs2, f"{engine} D = 4 fleet after {ticks} ticks")
    _assert_metrics_equal(jms, tms, f"{engine} D = 4 fleet")
    assert int(tms["rumor_deliveries"].sum()) > 0
    assert TFL.fleet_size(tfs2) == len(seeds)


# -- the driver, a scenario and the engine policy over the rings ----------------


def _driver_pair(engine: str):
    """The JAX driver and the port's, fed the JAX key chain, on one engine
    with D = 4 rings and a uniform 1.5-tick delay on every link (sparse and
    dense through ``set_link_delay`` over the dense link plane; pview, whose
    delay is a scalar, from a delayed initial state)."""
    from scalecube_cluster_tpu.ops import state as JS
    from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from test_torch_dense_driver import DenseChain
    from test_torch_driver import N, N_INITIAL, SEED, JaxChain

    knobs = dict(fanout=2, ping_req_k=1, fd_every=3, sync_every=8, suspicion_mult=1, rumor_slots=4,
                 seed_rows=(0, 1), delay_slots=4)
    if engine == "dense":
        jp, chain_cls, kw = JS.SimParams(capacity=N, **knobs), DenseChain, {}
    elif engine == "sparse":
        jp, chain_cls, kw = JSP.SparseParams(capacity=N, mr_slots=32, announce_slots=16, **knobs), JaxChain, {
            "dense_links": True}
    else:
        jp, chain_cls, kw = JPV.PviewParams(capacity=N, mr_slots=16, announce_slots=8, **knobs), JaxChain, {}
    chain = chain_cls(SEED, jp)
    jd = JSimDriver(jp, N_INITIAL, seed=SEED, record_metrics=True, **kw)
    td = SimDriver(_port_params(jp), N_INITIAL, seed=SEED, record_metrics=True, device="cpu", draws=chain, **kw)
    if engine == "pview":
        jd.state = JPV.init_pview_state(jp, N_INITIAL, uniform_delay=1.5)
        td.state = convert.state_from_numpy(JPV.snapshot(jd.state), device="cpu")
    else:
        for d in (jd, td):
            d.set_link_delay(list(range(N)), list(range(N)), 1.5)
    return jd, td, chain


@pytest.mark.parametrize("engine", ["sparse", "pview", pytest.param("dense", marks=SLOW)])
def test_driver_with_uniform_delay_matches_jax(engine):
    from test_torch_driver import HALVES, WATCHED, _compare

    jd, td, chain = _driver_pair(engine)
    for row in WATCHED:
        jd.watch(row), td.watch(row)

    def step(n, label):
        _compare(jd, td, chain, f"{engine}: {label}", (jd.step(n), td.step(n)))

    step(4, "warm window")
    for d in (jd, td):
        d.spread_rumor(3, "alpha")
    step(6, "after a spread")
    for d in (jd, td):
        d.crash(6)
        d.leave(9)
    step(6, "after a crash and a leave")
    assert jd.join(seed_rows=(0, 1)) == td.join(seed_rows=(0, 1))
    for d in (jd, td):
        d.update_metadata(4)
        d.block_partition(*HALVES)
    step(6, "partitioned")
    for d in (jd, td):
        d.heal_partition(*HALVES)
    step(8, "healed")
    assert int(td.state.pending_inf.shape[0]) == 4


def test_slow_member_scenario_on_sparse_matches_jax():
    """A ``SlowMember`` (rows 0-3 at 4.0 ticks) writes the dense delay
    plane through ``set_link_delay``; with a crash in the run, the report
    and the final state equal the JAX driver's ``run_scenario``."""
    from scalecube_cluster_tpu.chaos import events as JEV
    from scalecube_cluster_tpu_torch.chaos import events as TEV
    from test_torch_chaos_driver import _assert_same_run, _pair
    from test_torch_driver import JaxChain

    n = 12
    jp = JSP.SparseParams(capacity=n, fanout=3, repeat_mult=2, ping_req_k=2, fd_every=2, sync_every=6,
                          suspicion_mult=2, sweep_every=2, rumor_slots=2, mr_slots=24, announce_slots=8,
                          seed_rows=(0, 6), delay_slots=4)

    def build(ev):
        return ev.Scenario(name="slow-cohort", events=[
            ev.SlowMember(rows=[0, 1, 2, 3], mean_delay_ticks=4.0, at=4, until=60),
            ev.Crash(rows=[9], at=20),
        ], horizon=120, check_interval=8)

    jd, td = _pair(jp, n, 0, JaxChain, dense_links=True)
    jrep = jd.run_scenario(build(JEV))
    trep = td.run_scenario(build(TEV))
    _assert_same_run(jd, td, jrep, trep, "sparse slow member")
    assert [e["event"].split("@")[0] for e in trep["events_applied"]][:1] == ["slow(4.0t)[0, 1, 2, 3]"]


@pytest.mark.parametrize("force", ["dense", "sparse", "pview"])
def test_auto_params_and_from_config_carry_delay_slots(force):
    """``auto_params(link_delay=True)`` and each ``from_config`` carry the
    config's ``delay_slots`` onto every engine, as JAX's do."""
    from scalecube_cluster_tpu.config import ClusterConfig as JConfig
    from scalecube_cluster_tpu.sim.driver import auto_params as jauto
    from scalecube_cluster_tpu_torch.config import ClusterConfig as TConfig
    from scalecube_cluster_tpu_torch.sim.driver import auto_params as tauto

    kw = {"dense": {}, "sparse": {"force_sparse": True}, "pview": {"force_pview": True}}[force]
    cfgs = []
    for cls in (JConfig, TConfig):
        cfgs.append(cls.default_sim().with_sim(lambda s: dataclasses.replace(s, delay_slots=6)))
    jp = jauto(20_000 if force != "dense" else 4096, link_delay=True, config=cfgs[0], **kw)
    tp = tauto(20_000 if force != "dense" else 4096, link_delay=True, config=cfgs[1], **kw)
    assert type(tp).__name__ == type(jp).__name__
    assert tp.delay_slots == jp.delay_slots == 6
    assert _port_params(jp) == tp
