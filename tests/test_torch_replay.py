"""Incident replay and the what-if service of the PyTorch port against the
JAX package's, on the CPU.

* a flight round trip: the port's own dump → incident → a serial replay on
  a fresh port driver reproduces the recorded verdict (also after
  pre-arm stepping);
* partial (pre-schema-2) and hand-edited dumps are refused with JAX's
  messages;
* a JAX-written dump and the port's own dump of the same script (the port
  driver fed the JAX driver's key chain) give the same ``Incident``, the
  same ``validate_incident`` result, and per arm the same ``whatif``
  record as JAX's ``whatif`` on the JAX dump (the port's fleets fed the
  JAX fleets' per-row key chains): green counts, Wilson intervals,
  failures by kind, detection latencies, separations — exactly;
* the ``FleetVary.delay_ticks`` and ``partition_assign`` arms of the
  batched timeline against JAX's, plane for plane;
* ``WhatifService.run`` / ``run_operator`` and the arm refusals.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.state as JS
from scalecube_cluster_tpu import replay as JR
from scalecube_cluster_tpu.chaos import events as JEV
from scalecube_cluster_tpu.config import TelemetryConfig as JTelemetryConfig
from scalecube_cluster_tpu.ops import fleet as JFL
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch import replay as TR
from scalecube_cluster_tpu_torch.chaos import events as TEV
from scalecube_cluster_tpu_torch.config import TelemetryConfig
from scalecube_cluster_tpu_torch.ops import fleet as TFL
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.sim import SimDriver
from scalecube_cluster_tpu_torch.telemetry import FlightRecorderError
from scalecube_cluster_tpu_torch.telemetry.flight import load_flight_dump
from test_torch_dense import dense_draws
from test_torch_dense_driver import DenseChain
from test_torch_fleet import FleetChain

torch.set_num_threads(1)

SEEDS = 32
ARMS = [
    {"name": "fast-fd", "fd_every": 1, "suspicion_mult": 2},
    {"name": "moderate-fd", "fd_every": 2, "suspicion_mult": 3},
    {"name": "wider-fanout", "fanout": 6},
]


def _params(mod, n=12, seeds=(0, 6), **kw):
    base = dict(capacity=n, fanout=3, repeat_mult=2, ping_req_k=2, fd_every=4, sync_every=6,
                suspicion_mult=5, rumor_slots=2, seed_rows=seeds)
    base.update(kw)
    return mod.SimParams(**base)


def _scenario(ev, horizon=48):
    """The config17 incident's shape at N = 12: a crash whose detection
    the slow FD cadence cannot meet inside the budget."""
    return ev.Scenario(name="slow-fd-missed-deadline", events=[ev.Crash(rows=[4], at=4)], horizon=horizon,
                       detect_budget=20, converge_budget=horizon, check_interval=4)


def _port_dump(tmp_path, pre_steps=0, chain=True):
    """The port driver's dump of the script (fed the JAX driver's key chain
    when ``chain``)."""
    jparams = _params(JS)
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    draws = DenseChain(5, jparams) if chain else None
    d = SimDriver(tparams, 12, warm=True, seed=5, device="cpu", draws=draws)
    d.arm_telemetry(TelemetryConfig(ring_len=64, flight_windows=32, flight_dir=str(tmp_path)))
    if pre_steps:
        d.step(pre_steps)
    rep = d.run_scenario(_scenario(TEV))
    assert not rep["ok"] and rep["violations"] >= 1
    return rep


def _jax_dump(tmp_path):
    d = JSimDriver(_params(JS), 12, warm=True, seed=5)
    d.arm_telemetry(JTelemetryConfig(ring_len=64, flight_windows=32, flight_dir=str(tmp_path)))
    rep = d.run_scenario(_scenario(JEV))
    assert not rep["ok"]
    return rep


def _incident_doc(inc) -> dict:
    doc = dataclasses.asdict(inc)
    doc["params"] = dataclasses.asdict(inc.params)
    doc["scenario"] = TEV.scenario_to_dict(inc.scenario) if hasattr(inc.scenario, "events") else None
    doc.pop("source")
    return doc


def test_flight_round_trip_reproduces_the_recorded_verdict(tmp_path):
    rep = _port_dump(tmp_path, chain=False)
    doc = load_flight_dump(rep["flight_dump"])
    assert doc["_schema"] == 2 and doc["backend"] == "cpu"
    rec = doc["reconstruction"]
    assert rec["engine"] == "dense" and rec["seed"] == 5
    assert TR.scenario_from_flight(rep["flight_dump"]).events == _scenario(TEV).events
    incident = TR.incident_from_flight(rep["flight_dump"])
    assert incident.engine == "dense" and incident.seed == 5 and incident.t0 == 0
    assert incident.verdict["ok"] is False and incident.verdict["violations"] == rep["violations"]
    validation = TR.validate_incident(incident, device="cpu")
    assert validation["replayed"]["ok"] is False
    assert validation["reproduced"] is True, validation


def test_round_trip_survives_pre_arm_stepping(tmp_path):
    rep = _port_dump(tmp_path, pre_steps=7, chain=False)
    incident = TR.incident_from_flight(rep["flight_dump"])
    assert incident.t0 == 7
    assert TR.validate_incident(incident, device="cpu")["reproduced"] is True


def test_partial_and_hand_edited_dumps_are_refused_like_jax(tmp_path):
    v1 = tmp_path / "old.json"
    v1.write_text(json.dumps({
        "_schema": 1, "reason": "sentinel_violation", "engine": "dense",
        "ring": {"names": ["tick"], "rows": []}, "events": [],
    }))
    assert load_flight_dump(str(v1))["reconstruction"] == "partial"
    for fn in ("scenario_from_flight", "incident_from_flight"):
        with pytest.raises(JR.ReplayError) as jerr:
            getattr(JR, fn)(str(v1))
        with pytest.raises(TR.ReplayError) as terr:
            getattr(TR, fn)(str(v1))
        assert str(terr.value) == str(jerr.value)
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"_schema": 99}))
    with pytest.raises(FlightRecorderError, match="newer"):
        TR.incident_from_flight(str(future))
    for engine, doc in (("dense", {"capacity": 8, "bogus_knob": 3}), ("quantum", {"capacity": 8})):
        with pytest.raises(JR.ReplayError) as jerr:
            JR.params_from_doc(engine, doc)
        with pytest.raises(TR.ReplayError) as terr:
            TR.params_from_doc(engine, doc)
        assert str(terr.value) == str(jerr.value)
    # a dump whose recorder had no seed stamp
    rep_doc = {"_schema": 2, "reason": "x", "engine": "dense", "ring": {}, "events": [],
               "reconstruction": {"engine": "dense", "seed": None}}
    with pytest.raises(JR.ReplayError) as jerr:
        JR.incident_from_flight(rep_doc)
    with pytest.raises(TR.ReplayError) as terr:
        TR.incident_from_flight(rep_doc)
    assert str(terr.value) == str(jerr.value)


def _fleet_chain_draws(name, params):
    return FleetChain(JFL.fleet_keys(1000 + np.arange(SEEDS)), params, dense_draws)


def test_jax_dump_and_port_dump_give_jax_incident_validation_and_whatif(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jrep = _jax_dump(str(jdir))
    trep = _port_dump(str(tdir))
    assert trep["violations"] == jrep["violations"]
    assert trep["sentinels"]["detections"] == jrep["sentinels"]["detections"]
    # the dump's backend stamp names its writer and changes nothing below
    assert load_flight_dump(jrep["flight_dump"])["backend"] == jax.default_backend()
    assert load_flight_dump(trep["flight_dump"])["backend"] == "cpu"
    inc_j = TR.incident_from_flight(jrep["flight_dump"])
    inc_t = TR.incident_from_flight(trep["flight_dump"])
    assert _incident_doc(inc_j) == _incident_doc(inc_t)
    ref_inc = JR.incident_from_flight(jrep["flight_dump"])
    assert dataclasses.asdict(ref_inc.params) == dataclasses.asdict(inc_j.params)
    assert ref_inc.verdict == inc_j.verdict and ref_inc.t0 == inc_j.t0 and ref_inc.seed == inc_j.seed

    # the serial replay: the port fed the JAX driver's key chain
    jval = JR.validate_incident(ref_inc)
    for inc in (inc_j, inc_t):
        tval = TR.validate_incident(inc, device="cpu", draws=DenseChain(inc.seed, ref_inc.params))
        for k in ("recorded", "replayed", "reproduced", "engine", "seed", "t0", "scenario"):
            assert tval[k] == jval[k], k
        assert tval["report"]["sentinels"] == jval["report"]["sentinels"]

    # the counterfactual arms, same seed vector, per-row JAX key chains
    ref = JR.whatif(ref_inc, ARMS, seeds_per_arm=SEEDS)
    for inc in (inc_j, inc_t):
        got = TR.whatif(inc, ARMS, seeds_per_arm=SEEDS, device="cpu", draws=_fleet_chain_draws)
        assert len(got["arms"]) == len(ref["arms"]) == 4
        for g, r in zip(got["arms"], ref["arms"]):
            assert g == r, g["arm"]
        for k in ("as_recorded_wilson", "n_separated", "any_arm_separated", "tick_range", "n_arms"):
            assert got[k] == ref[k], k
    assert got["backend"] == "cpu" and got["n_separated"] >= 1


def test_whatif_service_runs_and_refuses(tmp_path):
    rep = _port_dump(tmp_path, chain=False)
    inc = TR.incident_from_flight(rep["flight_dump"])
    svc = TR.WhatifService()
    assert svc.snapshot() == {"computed": False}
    rec = svc.run(inc, ARMS[:1], seeds_per_arm=16, device="cpu")
    assert rec["computed"] and svc.snapshot() is rec and svc.history == [rec]
    by_name = {a["arm"]: a for a in rec["arms"]}
    assert by_name["fast-fd"]["p_green"] > by_name["as-recorded"]["p_green"]
    with pytest.raises(TR.ReplayError, match="no live incident"):
        svc.run_operator({"arms": ARMS})
    svc.attach_incident(inc)
    for bad, match in (([{"name": "x", "bogus": 1}], "bogus"), ([{"name": "as-recorded"}], "reserved"),
                       ([{"name": "a"}, {"name": "a"}], "duplicate"), ([], "non-empty")):
        with pytest.raises(TR.ReplayError, match=match):
            svc.run_operator({"arms": bad, "seeds_per_arm": 4})
    with pytest.raises(JR.ReplayError, match="bogus"):
        JR.arm_params(JR.incident_from_flight(rep["flight_dump"]), {"name": "x", "bogus": 1})


def test_fleet_vary_delay_ticks_and_partition_assign_match_jax():
    n, s = 8, 3
    jparams = _params(JS, n=n, seeds=(0,), delay_slots=4)
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))

    def both(scn_of, vary_kw, ticks):
        jfs = JFL.fleet_broadcast(JS.init_state(jparams, n, warm=True), s)
        tfs = TFL.fleet_broadcast(TS.init_state(tparams, n, warm=True, device="cpu"), s)
        jtl = JFL.fleet_timeline(scn_of(JEV), JS, dense_links=True, horizon=12, vary=JFL.FleetVary(**vary_kw))
        ttl = TFL.fleet_timeline(scn_of(TEV), TS, dense_links=True, horizon=12, vary=TFL.FleetVary(**vary_kw))
        for t in ticks:
            jfs, jl = jtl.apply_due(jfs, t)
            tfs, tl = ttl.apply_due(tfs, t)
            assert jl == tl, t
            for leaf in ("loss", "fetch_rt", "delay_q"):
                assert np.array_equal(getattr(tfs, leaf).numpy(), np.asarray(getattr(jfs, leaf))), (leaf, t)
        return tfs

    tfs = both(lambda ev: ev.Scenario(name="varied-slow", events=[ev.SlowEpoch(mean_delay_ticks=2.0, at=2, until=8)],
                                      horizon=12),
               {"delay_ticks": np.asarray([1.0, 2.0, 4.0], np.float32)}, (0, 2, 5, 8))
    assert (tfs.delay_q == 0).all()
    assign = np.asarray([[0, 0, 1, 1, 1, 1, 1, 1], [0, 1, 0, 1, 0, 1, -1, -1], [0, 0, 0, 0, 1, 1, 1, 1]], np.int32)
    tfs = both(lambda ev: ev.Scenario(name="varied-split",
                                      events=[ev.Partition(groups=[range(0, 4), range(4, 8)], at=2, heal_at=6)],
                                      horizon=12),
               {"partition_assign": assign}, (0, 2, 4, 6))
    assert (tfs.loss == 0).all()
