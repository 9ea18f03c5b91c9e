"""The causal trace plane of the PyTorch port against the JAX package's.

Held here on the CPU, from the same seeds:

* each engine's traced window (``make_traced_run``, ``make_sparse_traced_
  run``, ``make_pview_traced_run``) fed the JAX window's own key chain,
  after EVERY tick against the JAX traced window: every trace-ring row
  (exact), every state leaf (exact), every stacked metric (exact; the two
  f32 metrics within 2 ulp). N = 33 and 256; i32 and i16 keys; the dense
  delay rings at D = 4; a crash wave of tracers, rumors, a partition and
  its heal, so FD, expiry, SYNC, refutation and rumor records all occur,
  and quiet ticks on which the port's host gates skip a phase;
* each engine's armed driver against an unarmed one (bit-equal state, no
  readback while stepping), its window-boundary summary rows against the
  JAX plane's on one script;
* ``decode_records``, the span trees and the Chrome export of the port's
  copies against JAX's on one ring;
* the ring wrap, ``on_restore``, the refusals;
* ``run_scenario(trace=True)`` against the JAX driver's report;
* ``profile_ticks`` / ``profile_driver``: the state equals the window's,
  the phase names equal JAX's, the coverage check holds.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.kernel as JK
import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
import scalecube_cluster_tpu.ops.state as JS
from scalecube_cluster_tpu.trace import export as JEX
from scalecube_cluster_tpu.trace import schema as JSCH
from scalecube_cluster_tpu.trace import spans as JSPANS
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.trace import export as TEX
from scalecube_cluster_tpu_torch.trace import schema as TSCH
from scalecube_cluster_tpu_torch.trace import spans as TSPANS
from scalecube_cluster_tpu_torch.trace.rings import TraceRing
from test_torch_dense import dense_draws
from test_torch_pview_fused import FLOAT_METRICS, _jax_draws

torch.set_num_threads(1)

TICKS = 24
TRACERS = (3, 6, 9, 17)
SLOTS = (0, 1)
RING_LEN = 64  # 24 ticks x 4 tracers = 96 records: the ring wraps
_KNOBS = dict(fanout=2, repeat_mult=3, ping_req_k=2, fd_every=1, sync_every=6, rumor_slots=4, seed_rows=(0, 1))


@dataclasses.dataclass(frozen=True)
class Engine:
    jmod: object  # JAX host-mutator module
    tmod: object  # port host-mutator module
    jrun: object  # JAX traced-window builder
    trun: object  # port traced-window builder
    draws: object  # (key, n_ticks, params) -> (key, [(fd, round), ...])
    jsnap: object  # JAX state -> numpy dict


ENGINES = {
    "dense": Engine(JS, TS, JK.make_traced_run, TK.make_traced_run, dense_draws, JS.snapshot),
    "sparse": Engine(JSP, TSP, JSP.make_sparse_traced_run, TSP.make_sparse_traced_run, _jax_draws, JSP.snapshot),
    "pview": Engine(JPV, TPV, JPV.make_pview_traced_run, TPV.make_pview_traced_run, _jax_draws, JPV.snapshot),
}


def _params(engine: str, n: int, kd: str = "i32", delay: int = 0):
    if engine == "dense":
        return JS.SimParams(capacity=n, key_dtype=kd, suspicion_mult=2, delay_slots=delay, **_KNOBS)
    if engine == "sparse":
        return JSP.SparseParams(capacity=n, mr_slots=16, suspicion_mult=2, sweep_every=2, delay_slots=delay,
                                **_KNOBS)
    return JPV.PviewParams(capacity=n, key_dtype=kd, mr_slots=16, announce_slots=8, suspicion_mult=1,
                           sweep_every=4, tombstone_ticks=12, delay_slots=delay, **_KNOBS)


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


def _init(engine: str, params, n_up: int):
    if engine == "dense":
        return JS.init_state(params, n_up, warm=True, uniform_loss=0.05)
    if engine == "sparse":
        return JSP.init_sparse_state(params, n_up, warm=True, dense_links=True, uniform_loss=0.05)
    return JPV.init_pview_state(params, n_up, warm=True, uniform_loss=0.05)


def _script(mod, st, t: int, n: int):
    """The host events before tick ``t``: rumors, a crash wave of tracers,
    a partition and its heal."""
    half = (list(range(n // 2)), list(range(n // 2, n)))
    if t == 0:
        st = mod.spread_rumor(st, 0, 3)
        st = mod.crash_rows(st, [6, 17])
    if t == 6:
        st = mod.spread_rumor(st, 1, 10)
    if t == 9:
        st = mod.block_partition(st, *half)
    if t == 15:
        st = mod.heal_partition(st, *half)
        st = mod.crash_row(st, 9)
    return st


def _assert_state_equal(jsnap, tst, label):
    got = convert.state_to_numpy(tst)
    for name, v in jsnap.items():
        g = got[name]
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        if g.dtype == np.uint32:
            g = g.view(np.int32)
        assert g.shape == v.shape, f"{label}: leaf {name} shape {g.shape} != {v.shape}"
        assert np.array_equal(g, v), f"{label}: state leaf {name} diverged"


def _assert_metrics_equal(jms, tms, label):
    assert set(jms) == set(tms), f"{label}: metric names differ: {set(jms) ^ set(tms)}"
    for name, v in jms.items():
        v = np.asarray(v)
        g = tms[name].numpy()
        assert g.shape == v.shape, f"{label}: metric {name} shape {g.shape} != {v.shape}"
        if name in FLOAT_METRICS:
            ulp = np.abs(g.view(np.int32).astype(np.int64) - v.view(np.int32).astype(np.int64))
            assert ulp.max(initial=0) <= 2, f"{label}: metric {name} off by {ulp.max()} ulp"
        else:
            assert np.array_equal(g, v), f"{label}: metric {name} diverged"


@functools.lru_cache(maxsize=None)
def _jax_traced(engine: str, params, jspec):
    return ENGINES[engine].jrun(params, 1, jspec, donate=False)


def _run_traced(engine: str, n: int, kd: str = "i32", delay: int = 0):
    """TICKS one-tick traced windows of both packages from one state and
    one key chain; ring, state and metrics compared after every tick.
    Returns the decoded JAX events and the per-tick sums of a few
    metrics (to show the script exercised the phases)."""
    e = ENGINES[engine]
    params = _params(engine, n, kd, delay)
    tparams = _tparams(params)
    jspec = JSCH.TraceSpec(tracer_rows=TRACERS, rumor_slots=SLOTS, ring_len=RING_LEN, ping_req_k=params.ping_req_k)
    tspec = TSCH.TraceSpec(tracer_rows=TRACERS, rumor_slots=SLOTS, ring_len=RING_LEN, ping_req_k=params.ping_req_k)
    jst = _init(engine, params, n - 3)
    tst = convert.state_from_numpy(e.jsnap(jst), device="cpu")
    jbuf = jnp.zeros((RING_LEN, jspec.n_fields), jnp.int32)
    ring = TraceRing(tspec, device="cpu")
    jrun = _jax_traced(engine, params, jspec)
    trun = e.trun(tparams, 1, tspec)
    key = jax.random.PRNGKey(5)
    busy = {"fd_new_suspects": 0, "sync_roundtrips": 0, "rumor_deliveries": 0}
    for t in range(TICKS):
        jst = _script(e.jmod, jst, t, n)
        tst = _script(e.tmod, tst, t, n)
        jst, key_after, jms, _w, jbuf = jrun(jst, key, jbuf, jnp.int32(ring.cursor))
        key, draws = e.draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _w = trun(tst, ring, draws)
        label = f"{engine}/{kd}/D={delay} n={n} tick {t + 1}"
        assert np.array_equal(ring.buf.numpy(), np.asarray(jbuf)), f"{label}: trace ring diverged"
        _assert_state_equal(e.jsnap(jst), tst, label)
        _assert_metrics_equal(jms, tms, label)
        for k in busy:
            busy[k] += int(np.asarray(jms[k]).sum())
    assert ring.records == TICKS * len(TRACERS) and ring.wraps == 1
    events = JSCH.decode_records(np.asarray(jbuf), jspec)
    return events, busy


WINDOW_CASES = [
    ("dense", 33, "i32", 0),
    ("dense", 33, "i16", 4),
    ("sparse", 33, "i32", 0),
    ("pview", 33, "i32", 0),
    ("pview", 33, "i16", 0),
    ("dense", 256, "i32", 0),
    ("sparse", 256, "i32", 0),
    ("pview", 256, "i32", 0),
]


@pytest.mark.parametrize("engine,n,kd,delay", WINDOW_CASES)
def test_traced_window_matches_jax_after_every_tick(engine, n, kd, delay):
    events, busy = _run_traced(engine, n, kd, delay)
    assert all(v > 0 for v in busy.values()), busy
    kinds = {e["kind"] for e in events}
    # the retained ring holds probe, SYNC and detection records
    assert {"probe", "sync", "suspect_raised"} <= kinds, kinds


# -- the driver-attached plane ---------------------------------------------------

from scalecube_cluster_tpu.sim import SimDriver as JSimDriver  # noqa: E402
from scalecube_cluster_tpu.trace import profile as JPROF  # noqa: E402
from scalecube_cluster_tpu_torch.config import TraceConfig  # noqa: E402
from scalecube_cluster_tpu_torch.ops import _tensor  # noqa: E402
from scalecube_cluster_tpu_torch.sim import SimDriver  # noqa: E402
from scalecube_cluster_tpu_torch.trace import profile as TPROF  # noqa: E402
from test_torch_dense_driver import DenseChain  # noqa: E402
from test_torch_driver import JaxChain  # noqa: E402

DRIVER_N = 24
DRIVER_CASES = {
    "dense": (lambda: _params("dense", DRIVER_N), DenseChain, {}),
    "sparse": (lambda: _params("sparse", DRIVER_N), JaxChain, {"dense_links": True}),
    "pview": (lambda: _params("pview", DRIVER_N), JaxChain, {}),
}


def _driver_pair(engine: str, seed: int = 4, armed_port: bool = True):
    make, chain_cls, kw = DRIVER_CASES[engine]
    jparams = make()
    tparams = _tparams(jparams)
    jd = JSimDriver(jparams, DRIVER_N - 2, warm=True, seed=seed, **kw)
    td = SimDriver(tparams, DRIVER_N - 2, warm=True, seed=seed, device="cpu", draws=chain_cls(seed, jparams), **kw)
    plain = SimDriver(tparams, DRIVER_N - 2, warm=True, seed=seed, device="cpu", draws=chain_cls(seed, jparams), **kw)
    return jd, td, plain


def _drive(drivers, windows=6):
    for d in drivers:
        d.spread_rumor(3, "alpha")
        d.crash(6)
        d.crash(17)
    for w in range(windows):
        for d in drivers:
            d.step(4)
        if w == 2:
            for d in drivers:
                d.spread_rumor(10, b"beta")


@pytest.mark.parametrize("engine", sorted(DRIVER_CASES))
def test_armed_driver_matches_jax_plane_and_unarmed_driver(engine):
    jd, td, plain = _driver_pair(engine)
    cfg = dict(tracer_rows=TRACERS, rumor_slots=SLOTS)
    jplane = jd.arm_trace(**cfg)
    tplane = td.arm_trace(**cfg)
    assert td.arm_trace() is tplane and td.trace is tplane
    base = td.dispatch_stats["readbacks"]
    flags_armed = _tensor.HOST_SYNCS.count
    _drive([jd, td])
    flags_armed = _tensor.HOST_SYNCS.count - flags_armed
    assert td.dispatch_stats["readbacks"] == base, "armed stepping read the device"
    flags_plain = _tensor.HOST_SYNCS.count
    _drive([plain])
    assert _tensor.HOST_SYNCS.count - flags_plain == flags_armed, "arming changed the host flag reads"
    # bit-equal to the unarmed driver and to the JAX armed driver
    sp, st = convert.state_to_numpy(plain.state), convert.state_to_numpy(td.state)
    assert all(np.array_equal(sp[k], st[k]) for k in sp)
    jsnap = ENGINES[engine].jsnap(jd.state)
    _assert_state_equal(jsnap, td.state, f"{engine} driver")
    # every ring row, per-tick and window-boundary summary alike
    assert tplane.stats() == jplane.stats()
    assert tplane.stats()["records"] == 6 * (4 + 1) * len(TRACERS)
    jrows = jplane.snapshot()["rows"]
    trows = tplane.snapshot()["rows"]
    assert td.dispatch_stats["readbacks"] == base + 1
    assert np.array_equal(trows, jrows)
    assert tplane.snapshot() is tplane.snapshot()  # the cached host copy
    # decode, span sewing, detection trees, the Chrome export, the flight
    # section: the port's copies against JAX's on the same rows
    assert tplane.events() == jplane.events()
    assert tplane.sew() == jplane.sew()
    assert tplane.detection_tree(6) == jplane.detection_tree(6) is not None
    assert tplane.rumor_trees() == jplane.rumor_trees()
    assert json.loads(json.dumps(tplane.perfetto())) == json.loads(json.dumps(jplane.perfetto()))
    assert tplane.otel_spans() == jplane.otel_spans()
    assert json.loads(json.dumps(tplane.flight_section([6, 17, 5]))) == json.loads(
        json.dumps(jplane.flight_section([6, 17, 5])))
    assert td.health_snapshot()["trace"] == jd.health_snapshot()["trace"]
    kinds = {e["kind"] for e in tplane.events()}
    assert {"probe", "suspect_raised", "dead", "suspect_spread", "dead_spread", "rumor_infection"} <= kinds, kinds


def test_decode_spans_and_export_copies_match_jax():
    """The copied modules on a ring the JAX traced window wrote (every
    record kind), and on a profiler timeline."""
    events, _busy = _run_traced("dense", 33)
    spec_kw = dict(tracer_rows=TRACERS, rumor_slots=SLOTS, ring_len=RING_LEN, ping_req_k=2)
    jspec, tspec = JSCH.TraceSpec(**spec_kw), TSCH.TraceSpec(**spec_kw)
    assert tspec.field_names() == jspec.field_names() and tspec.n_fields == jspec.n_fields
    rows = np.random.default_rng(0).integers(-1, 40, size=(64, jspec.n_fields)).astype(np.int32)
    rows[:, JSCH.F_FLAGS] = np.random.default_rng(1).integers(0, 256, size=64)
    assert TSCH.decode_records(rows, tspec) == JSCH.decode_records(rows, jspec)
    assert TSPANS.sew_trees(rows, tspec) == JSPANS.sew_trees(rows, jspec)
    trees = list(JSPANS.sew_trees(rows, jspec)["detections"].values())
    rumor = JSPANS.rumor_tree(0, 3, [3, 4, 5, 9], [0, 2, 3, 5], [-1, 3, 4, 4])
    assert TSPANS.rumor_tree(0, 3, [3, 4, 5, 9], [0, 2, 3, 5], [-1, 3, 4, 4]) == rumor
    prof = {"timeline": [{"phase": "fd", "tick": 0, "start_s": 0.0, "dur_s": 0.001},
                         {"phase": "gossip", "tick": 0, "start_s": 0.001, "dur_s": 0.002}]}
    assert TEX.chrome_trace(span_trees=trees, rumor_trees=[rumor], profile=prof, tick_us=500) == JEX.chrome_trace(
        span_trees=trees, rumor_trees=[rumor], profile=prof, tick_us=500)
    assert TEX.to_otel_spans(trees) == JEX.to_otel_spans(trees)
    assert events  # the traced window's own ring decoded (kinds checked above)


def test_ring_wrap_and_on_restore(tmp_path):
    params = _tparams(_params("dense", DRIVER_N))
    d = SimDriver(params, DRIVER_N - 2, warm=True, seed=2, device="cpu")
    plane = d.arm_trace(config=TraceConfig(ring_len=24), tracer_rows=(1, 2, 3), rumor_slots=(0,))
    d.spread_rumor(1, "x")
    d.step(3)
    path = str(tmp_path / "ckpt.npz")
    d.checkpoint(path)
    d.crash(2)
    for _ in range(3):
        d.step(3)
    # 4 windows of (3 ticks + 1 summary) x 3 tracers = 48 records: 2 laps
    assert plane.ring.records == 48 and plane.ring.wraps == 2 and plane.ring.cursor == 0
    rows = plane.snapshot()["rows"]
    assert rows.shape == (24, plane.spec.n_fields)
    ticks = rows[:, JSCH.F_TICK]
    assert list(ticks) == sorted(ticks) and ticks[-1] == d.tick  # oldest first, newest last
    d.restore(path)
    assert plane.ring.records == 0 and plane.ring.records_total == 48 and plane.ring.wraps_total == 2
    assert plane.snapshot()["rows"].shape == (0, plane.spec.n_fields)
    assert not plane.ring.buf.any()
    d.step(3)  # the restored timeline's first window, re-baselined
    assert plane.ring.records == 12 and plane.events() is not None
    summ = plane.snapshot()["rows"][-3:]
    assert (summ[:, JSCH.F_FLAGS] == JSCH.FLAG_SUMMARY).all()
    assert (summ[:, plane.spec.subject_field("new_dead")] == 0).all()  # no phantom lineage


def test_refusals():
    from scalecube_cluster_tpu_torch.adaptive import AdaptiveSpec, init_adaptive_state

    params = _tparams(_params("dense", DRIVER_N))
    d = SimDriver(params, DRIVER_N, device="cpu")
    d.set_adaptive(AdaptiveSpec(enabled=True))
    with pytest.raises(ValueError, match="adaptive"):
        d.arm_trace()
    d.set_adaptive(None)
    d.arm_trace()
    with pytest.raises(ValueError, match="adaptive"):
        d.set_adaptive(AdaptiveSpec(enabled=True))
    with pytest.raises(ValueError, match="control"):
        d.arm_control()
    ad_params = dataclasses.replace(params, adaptive=AdaptiveSpec(enabled=True))
    spec = TSCH.TraceSpec(tracer_rows=(1,))
    for mod, make in ((TK, TK.make_traced_run), (TSP, TSP.make_sparse_traced_run),
                      (TPV, TPV.make_pview_traced_run)):
        with pytest.raises(ValueError, match="trace-armed adaptive windows are not supported"):
            make(ad_params, 1, spec)
    st = TS.init_state(params, DRIVER_N, device="cpu")
    fd, rd = TK.draw_dense_tick(torch.Generator().manual_seed(0), params, True)
    with pytest.raises(ValueError, match="trace-armed adaptive windows are not supported"):
        TK.tick(st, fd, rd, ad_params, trace=spec, ad=init_adaptive_state(DRIVER_N, device="cpu"))
    with pytest.raises(ValueError, match="out of range"):
        SimDriver(params, DRIVER_N, device="cpu").arm_trace(tracer_rows=(DRIVER_N,))
    with pytest.raises(ValueError, match="rumor_slots out of range"):
        SimDriver(params, DRIVER_N, device="cpu").arm_trace(rumor_slots=(99,))


SCENARIO_CASES = {
    "dense": (lambda: _params("dense", 16), 16, DenseChain, {}),
    "pview": (lambda: _params("pview", 24), 24, JaxChain, {}),
}


@pytest.mark.parametrize("engine", sorted(SCENARIO_CASES))
def test_run_scenario_trace_matches_jax(engine):
    from scalecube_cluster_tpu.chaos import events as JEV
    from scalecube_cluster_tpu_torch.chaos import events as TEV

    make, n, chain_cls, kw = SCENARIO_CASES[engine]
    jparams = make()

    def scn(ev):
        # five crashed rows against the default 4-tracer budget: one is
        # named untraced
        return ev.Scenario(name="traced-crash", events=[ev.Crash(rows=[3, 5, 7, 9, 11], at=4)], horizon=64,
                           check_interval=8)

    jd = JSimDriver(jparams, n, warm=True, seed=1, **kw)
    td = SimDriver(_tparams(jparams), n, warm=True, seed=1, device="cpu", draws=chain_cls(1, jparams), **kw)
    jrep = jd.run_scenario(scn(JEV), trace=True)
    trep = td.run_scenario(scn(TEV), trace=True)
    assert trep.pop("backend") == "cpu"
    jrep.pop("backend")
    assert json.loads(json.dumps(trep)) == json.loads(json.dumps(jrep))
    assert trep["untraced_crash_rows"] == [11]
    assert sorted(trep["trace_spans"]) == [3, 5, 7, 9]
    assert all(det.get("span_tree") for det in trep["sentinels"]["detections"] if det["row"] != 11)


def test_flight_dump_carries_the_trace_section_like_jax(tmp_path):
    from scalecube_cluster_tpu.chaos import events as JEV
    from scalecube_cluster_tpu.config import TelemetryConfig as JTC
    from scalecube_cluster_tpu_torch.chaos import events as TEV
    from scalecube_cluster_tpu_torch.config import TelemetryConfig as TTC
    from scalecube_cluster_tpu_torch.telemetry.flight import load_flight_dump, replay_timeline

    jparams = _params("dense", 16)

    def scn(ev):  # an unmeetable detection budget: the violation dumps
        return ev.Scenario(name="traced-violation", events=[ev.Crash(rows=[3], at=4)], horizon=32,
                           detect_budget=1, check_interval=4)

    jd = JSimDriver(jparams, 16, warm=True, seed=1)
    td = SimDriver(_tparams(jparams), 16, warm=True, seed=1, device="cpu", draws=DenseChain(1, jparams))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jd.arm_telemetry(JTC(flight_dir=str(tmp_path / "j")))
    td.arm_telemetry(TTC(flight_dir=str(tmp_path / "t")))
    jrep = jd.run_scenario(scn(JEV), trace=True)
    trep = td.run_scenario(scn(TEV), trace=True)
    jdoc, tdoc = load_flight_dump(jrep["flight_dump"]), load_flight_dump(trep["flight_dump"])
    assert tdoc["trace"] == jdoc["trace"]
    assert "3" in tdoc["trace"]["span_trees"] and tdoc["trace"]["rows"]
    assert any(line.startswith("trace: ") for line in replay_timeline(tdoc))


@pytest.mark.parametrize("engine", ["dense", "sparse", "pview"])
def test_profile_ticks_state_equals_the_window(engine):
    params = _tparams(_params(engine, 64))
    e = ENGINES[engine]
    init = {"dense": lambda: TS.init_state(params, 60, device="cpu"),
            "sparse": lambda: TSP.init_sparse_state(params, 60, device="cpu"),
            "pview": lambda: TPV.init_pview_state(params, 60, device="cpu")}[engine]

    def start():
        st = init()
        st = e.tmod.spread_rumor(st, 0, 3)
        return e.tmod.crash_rows(st, [6, 17])

    run = {"dense": TK.make_run, "sparse": TSP.make_sparse_run, "pview": TPV.make_pview_run}[engine]
    ref, ref_ms, _ = run(params, 9)(start(), torch.Generator().manual_seed(9))
    st, res = TPROF.profile_ticks(params, start(), torch.Generator().manual_seed(9), 8, warmup_ticks=1)
    sr, sp = convert.state_to_numpy(ref), convert.state_to_numpy(st)
    assert all(np.array_equal(sr[k], sp[k]) for k in sr)
    phases = {"dense": JPROF.DENSE_PHASES, "sparse": JPROF.SPARSE_PHASES, "pview": JPROF.PVIEW_PHASES}[engine]
    assert sorted(res["phases_s"]) == sorted(phases)
    assert (TPROF.DENSE_PHASES, TPROF.SPARSE_PHASES, TPROF.PVIEW_PHASES) == (
        JPROF.DENSE_PHASES, JPROF.SPARSE_PHASES, JPROF.PVIEW_PHASES)
    assert set(res) == {"engine", "n", "mesh", "ticks", "warmup_ticks", "wall_s", "phase_sum_s", "phase_coverage",
                        "split_ticks_per_s", "phases_s", "phases_pct", "timeline"}
    assert res["engine"] == engine and res["ticks"] == 8
    assert abs(res["phase_coverage"] - 1.0) <= 0.2, res["phase_coverage"]
    assert len(res["timeline"]) == 8 * len(phases)
    assert TEX.profile_to_events(res) == JEX.profile_to_events(res)


def test_profile_driver_leaves_the_driver_alone_and_fleet_profile_matches_the_fleet():
    params = _tparams(_params("sparse", 64))
    d = SimDriver(params, 60, seed=5, device="cpu")
    d.step(2)
    before = convert.state_to_numpy(d.state)
    gen_before = d._gen.get_state()
    res = TPROF.profile_driver(d, n_ticks=6)
    after = convert.state_to_numpy(d.state)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert torch.equal(gen_before, d._gen.get_state())
    assert abs(res["phase_coverage"] - 1.0) <= 0.2 and res["engine"] == "sparse"
    with pytest.raises(ValueError, match="generator"):
        TPROF.profile_driver(SimDriver(params, 60, device="cpu", draws=lambda n: []), n_ticks=2)
    # the fleet profile: the state equals the fleet window's
    from scalecube_cluster_tpu_torch.ops import fleet as TFL

    base = TFL.fleet_broadcast(TSP.init_sparse_state(params, 60, device="cpu"), 2)
    ref, _ms, _w = TSP.make_sparse_fleet_run(params, 4)(
        TFL.fleet_inject_rumor(TSP, base, 0, [3, 9]), torch.Generator().manual_seed(1))
    base = TFL.fleet_broadcast(TSP.init_sparse_state(params, 60, device="cpu"), 2)
    got, res = TPROF.profile_fleet_ticks(params, TFL.fleet_inject_rumor(TSP, base, 0, [3, 9]),
                                         torch.Generator().manual_seed(1), 3, warmup_ticks=1)
    rr, gg = convert.fleet_to_numpy(ref), convert.fleet_to_numpy(got)
    assert all(np.array_equal(rr[k], gg[k]) for k in rr)
    assert res["engine"] == "sparse-fleet" and res["s"] == 2 and abs(res["phase_coverage"] - 1.0) <= 0.2
