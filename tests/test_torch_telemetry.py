"""The PyTorch port's telemetry plane against the JAX package's.

The JAX ``SimDriver`` and the port's run one script on each engine (the
port fed the JAX driver's key chain), both armed with the telemetry plane.
Held after the script:

* the metric ring's rows: every series equal, the four that JAX computes
  in f32 (the rumor coverage mean and minimum, the alive-view fraction and
  the convergence lag) within 2 ulp;
* the bus record sequence: sequence number, tick, source, kind and fields
  (the wall-clock stamp excepted);
* the OpenMetrics exposition's ring-derived samples;
* the flight dump's schema and sections.

Port-only cases hold the plane's neutrality (an armed driver's trajectory
equals the unarmed one's, bit for bit, and stepping reads nothing back), a
chaos scenario's records and flight dump on the bus, and ``certify``'s
``bus=`` against JAX's records.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import _tensor
from scalecube_cluster_tpu_torch.sim import SimDriver
from scalecube_cluster_tpu_torch.telemetry import TelemetryBus, load_flight_dump
from test_torch_dense_driver import DenseChain
from test_torch_driver import JaxChain
from test_torch_pview_fused import _assert_state_equal

torch.set_num_threads(1)

#: ring series JAX computes in f32 arithmetic (the others are counts and
#: maxima converted to f32, exact on both sides)
F32_SERIES = ("rumor_coverage_mean", "rumor_coverage_min", "alive_view_fraction", "convergence_lag")

_KNOBS = dict(fanout=2, ping_req_k=1, fd_every=3, sync_every=8, suspicion_mult=1, rumor_slots=4,
              seed_rows=(0, 1), full_metrics=True)
N = 40


def _jparams(engine: str):
    if engine == "dense":
        return JS.SimParams(capacity=N, **_KNOBS)
    if engine == "sparse":
        return JSP.SparseParams(capacity=N, mr_slots=32, announce_slots=16, **_KNOBS)
    return JPV.PviewParams(capacity=N, mr_slots=16, announce_slots=8, **_KNOBS)


def _pair(engine: str, seed: int = 2, **kw):
    jp = _jparams(engine)
    chain = (DenseChain if engine == "dense" else JaxChain)(seed, jp)
    jd = JSimDriver(jp, N - 4, seed=seed, **kw)
    td = SimDriver(convert.params_from_dict(dataclasses.asdict(jp)), N - 4, seed=seed, device="cpu", draws=chain,
                   **kw)
    return jd, td


def _script(drivers):
    """Windows around a spread, a crash, a leave, a join and a metadata bump;
    the same calls on every driver in turn."""
    def each(fn):
        return [fn(d) for d in drivers]

    each(lambda d: d.step(4))
    each(lambda d: d.spread_rumor(3, "alpha"))
    each(lambda d: d.step(6))
    each(lambda d: d.crash(6))
    each(lambda d: d.leave(9))
    each(lambda d: d.step(5))
    each(lambda d: d.join(seed_rows=(0, 1)))
    each(lambda d: d.update_metadata(4))
    each(lambda d: d.step(7))
    each(lambda d: d.spread_rumor(12, "beta"))
    each(lambda d: d.step(8))
    each(lambda d: d.flush())


def _assert_rows_equal(names, jrows, trows, label):
    jrows, trows = np.asarray(jrows, np.float32), np.asarray(trows, np.float32)
    assert jrows.shape == trows.shape, f"{label}: ring shape {trows.shape} != {jrows.shape}"
    for c, name in enumerate(names):
        a, b = jrows[:, c], trows[:, c]
        if name in F32_SERIES:
            ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
            assert ulp.max(initial=0) <= 2, f"{label}: series {name} off by {ulp.max()} ulp"
        else:
            assert np.array_equal(a, b), f"{label}: series {name} differs: {b} != {a}"


def _records(bus):
    return [{k: v for k, v in r.as_dict().items() if k != "ts"} for r in bus.tail()]


def _window_samples(fams):
    """The exposition's ring-derived samples: the newest-row gauges and the
    ring counters."""
    keep = {"scalecube_window", "scalecube_ring_windows_total", "scalecube_ring_cursor",
            "scalecube_ring_wraps_total"}
    return {f["name"]: sorted((s[0], tuple(sorted(s[1].items())), s[2]) for s in f["samples"])
            for f in fams if f["name"] in keep}


@pytest.mark.parametrize("engine", ["dense", "sparse", "pview"])
def test_plane_matches_jax(engine, tmp_path):
    jd, td = _pair(engine)
    jplane, tplane = jd.arm_telemetry(), td.arm_telemetry()
    assert tplane.names == jplane.names
    _script((jd, td))
    _assert_state_equal(jd.state, td.state, f"{engine}: final state")
    jsnap, tsnap = jplane.collect(), tplane.collect()
    assert tsnap["ring"]["names"] == jsnap["ring"]["names"]
    assert tsnap["ring"]["windows"] == jsnap["ring"]["windows"] == 5
    _assert_rows_equal(jplane.names, jsnap["ring"]["rows"], tsnap["ring"]["rows"], engine)
    assert _records(tplane.bus) == _records(jplane.bus), f"{engine}: bus records"
    assert tsnap["bus"] == jsnap["bus"]
    # the exposition: the newest row's gauges within the f32 rule
    jw, tw = _window_samples(jplane.families()), _window_samples(tplane.families())
    assert set(tw) == set(jw)
    for name in jw:
        assert [s[:2] for s in tw[name]] == [s[:2] for s in jw[name]], name
        vals = {dict(s[1]).get("series", ""): (s[2], t[2]) for s, t in zip(jw[name], tw[name])}
        for series, (a, b) in vals.items():
            if series in F32_SERIES:
                assert abs(a - b) <= 4 * np.spacing(np.float32(max(abs(a), 1e-30))), (series, a, b)
            else:
                assert a == b, (name, series, a, b)
    # the flight dump: same schema and sections, same ring and events
    jdoc = load_flight_dump(jplane.flight_record("operator", path=str(tmp_path / "j.json")))
    tdoc = load_flight_dump(tplane.flight_record("operator", path=str(tmp_path / "t.json")))
    assert set(tdoc) == set(jdoc), f"{engine}: dump sections"
    for key in ("_schema", "reason", "engine", "context", "tick_range", "reconstruction"):
        assert tdoc[key] == jdoc[key], key
    assert tdoc["backend"] == "cpu"
    assert tdoc["ring"]["names"] == jdoc["ring"]["names"]
    assert tdoc["ring"]["windows_total"] == jdoc["ring"]["windows_total"]
    _assert_rows_equal(jplane.names, jdoc["ring"]["rows"], tdoc["ring"]["rows"], f"{engine} dump")
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in jdoc["events"]]
    assert [{k: v for k, v in e.items() if k != "ts"} for e in tdoc["events"]] == strip


@pytest.mark.parametrize("engine", ["dense", "sparse", "pview"])
def test_armed_idle_stepping_equals_unarmed_and_reads_nothing(engine):
    """Two generator-driven drivers, one armed: the same script leaves the
    same state, bit for bit; the armed steps take no driver readback and no
    tick flag read beyond the unarmed driver's."""
    tp = convert.params_from_dict(dataclasses.asdict(_jparams(engine)))
    plain = SimDriver(tp, N - 4, seed=5, device="cpu")
    armed = SimDriver(tp, N - 4, seed=5, device="cpu")
    plane = armed.arm_telemetry()
    syncs = []
    for d in (plain, armed):
        before = _tensor.HOST_SYNCS.count
        reads = d.dispatch_stats["readbacks"]
        d.step(6)
        d.spread_rumor(3, "x")
        d.step(9)
        d.crash(7)
        d.step(5)
        assert d.dispatch_stats["readbacks"] == reads, "stepping read the device back"
        syncs.append(_tensor.HOST_SYNCS.count - before)
    assert syncs[0] == syncs[1], f"the armed steps read {syncs[1] - syncs[0]} more flags"
    got, ref = convert.state_to_numpy(armed.state), convert.state_to_numpy(plain.state)
    for name, v in ref.items():
        assert np.array_equal(got[name], v), f"{engine}: armed state leaf {name} diverged"
    assert plane.ring.windows == 3
    rows = plane.collect()["ring"]["rows"]
    assert armed.dispatch_stats["readbacks"] == 1 and len(rows) == 3
    assert rows[-1][plane.names.index("tick")] == 20.0


def test_chaos_scenario_records_and_flight_dump_match_jax(tmp_path):
    """A scenario on an armed driver: its lifecycle, applied events and
    outcome on the bus as JAX's, the sentinel columns of the ring read from
    the runner's device accumulators, and the reconstruction section of a
    dump written while it is armed."""
    from scalecube_cluster_tpu.chaos import events as JEV
    from scalecube_cluster_tpu_torch.chaos import events as TEV

    def build(ev):
        return ev.Scenario(name="crash-and-split", events=[
            ev.Crash(rows=[5], at=3),
            ev.Partition(groups=[range(0, 18), range(18, N - 4)], at=8, heal_at=24),
        ], horizon=48, check_interval=8)

    jd, td = _pair("sparse", dense_links=True)
    jplane, tplane = jd.arm_telemetry(), td.arm_telemetry()
    jrep = jd.run_scenario(build(JEV))
    trep = td.run_scenario(build(TEV))
    assert trep["ok"] == jrep["ok"] and trep["violations"] == jrep["violations"]
    _assert_state_equal(jd.state, td.state, "after the scenario")
    kinds = [r["kind"] for r in _records(tplane.bus)]
    assert kinds[1] == "scenario_armed" and kinds[-1] == "scenario_complete" and "event_applied" in kinds
    assert _records(tplane.bus) == _records(jplane.bus)
    jrows, trows = jplane.collect()["ring"]["rows"], tplane.collect()["ring"]["rows"]
    _assert_rows_equal(jplane.names, jrows, trows, "scenario ring")
    assert tplane.hist_detection.counts == jplane.hist_detection.counts
    jdoc = load_flight_dump(jplane.flight_record("operator", path=str(tmp_path / "j.json")))
    tdoc = load_flight_dump(tplane.flight_record("operator", path=str(tmp_path / "t.json")))
    jrec, trec = jdoc["reconstruction"], tdoc["reconstruction"]
    assert set(trec) == set(jrec)
    for key in set(jrec) - {"params"}:
        assert trec[key] == jrec[key], key
    assert convert.params_from_dict(jrec["params"]) == td.params
    assert tdoc["tick_range"] == jdoc["tick_range"]


def test_checkpoint_records_and_restore_failure_dump(tmp_path):
    """Checkpoint save and restore leave their records; a failed restore
    writes a flight dump before it raises."""
    from scalecube_cluster_tpu_torch.sim import CheckpointError
    from scalecube_cluster_tpu_torch.config import TelemetryConfig

    tp = convert.params_from_dict(dataclasses.asdict(_jparams("pview")))
    d = SimDriver(tp, N - 4, seed=1, device="cpu")
    plane = d.arm_telemetry(TelemetryConfig(flight_dir=str(tmp_path)))
    d.step(3)
    path = str(tmp_path / "ck.npz")
    d.checkpoint(path)
    d.step(2)
    d.restore(path)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(CheckpointError):
        d.restore(str(bad))
    recs = [(r["source"], r["kind"]) for r in _records(plane.bus)]
    assert recs == [("driver", "telemetry_armed"), ("checkpoint", "saved"), ("checkpoint", "restored"),
                    ("flight", "dump")]
    doc = load_flight_dump(plane.flight_dumps[-1])
    assert doc["reason"] == "checkpoint_error" and doc["ring"]["windows_total"] == 2
    assert doc["reconstruction"] == "partial"
    assert json.loads(json.dumps(doc["context"]))["path"] == str(bad)


def test_certifier_bus_records_match_jax():
    import scalecube_cluster_tpu.dissemination.certify as JCert
    from scalecube_cluster_tpu.telemetry import TelemetryBus as JBus
    from scalecube_cluster_tpu_torch.dissemination import certify as TCert

    matrix = [("push", "full", "dense"), ("pipelined", "expander", "dense")]
    jbus, tbus = JBus(32), TelemetryBus(32)
    JCert.spread_certifier(matrix=matrix, n=32, seeds=(0,), bus=jbus)
    TCert.spread_certifier(matrix=matrix, n=32, seeds=(0,), bus=tbus, device="cpu")
    jrec = [{k: v for k, v in r.as_dict().items() if k not in ("ts", "spread_ticks_max", "overhead")}
            for r in jbus.tail()]
    trec = [{k: v for k, v in r.as_dict().items() if k not in ("ts", "spread_ticks_max", "overhead")}
            for r in tbus.tail()]
    assert [r["kind"] for r in trec] == ["spread_certified", "spread_certified", "pipeline_steady_state"]
    assert trec == jrec
