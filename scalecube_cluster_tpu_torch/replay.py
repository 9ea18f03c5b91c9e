"""Incident replay + counterfactual what-if service (r18 tentpole).

A flight dump (telemetry/flight.py, schema 2) embeds a ``reconstruction``
section: everything needed to rebuild the dying run — engine, params doc,
construction seed, the armed scenario's event timeline, and the recorded
sentinel verdict. This module turns that artifact into three things:

1. **An incident** (:func:`incident_from_flight`): the reconstruction
   section decoded back into live objects — a params dataclass, a
   :class:`..chaos.Scenario`, the seed/t0/max_window the original run used.

2. **A validated replay** (:func:`validate_incident`): a fresh
   :class:`..sim.SimDriver` built from the incident, pre-stepped to the
   recorded ``t0``, re-running the scenario serially. The per-tick key
   chain depends only on the total tick count (``key, k = split(key)``
   once per tick inside the scan), so a replay from the same construction
   seed walks the same chain and must reproduce the recorded verdict —
   the round-trip check that certifies the reconstruction is faithful,
   not merely plausible. (Drivers whose pre-arm history was more than
   stepping — API joins, transport sends — replay the scenario from a
   different pre-state; the verdict comparison then reports
   ``reproduced: False`` rather than pretending.)

3. **A counterfactual benchmark** (:func:`whatif`): the incident replayed
   as a scenario-batched fleet (r15 engine) across alternative knob
   settings — fanout, suspicion multiplier, FD cadence, dissemination
   strategy/topology, adaptive-FD spec — ≥256 seeds per arm, the full
   on-device sentinel program vmapped over the fleet, per-arm Wilson
   intervals on P(all sentinels green) + zero-false-DEAD (the same
   discipline as ``control.certify_controller_mc``). Every arm runs the
   SAME seed vector, so interval separation is a paired comparison: an
   arm whose interval is disjoint from the as-recorded arm's is a
   certified "this knob change would have mattered", not noise. The
   monitor serves the newest record at ``GET /whatif``
   (:class:`WhatifService`); ``benchmarks/config17_replay.py`` writes it
   as REPLAY_BENCH_r18.json.

The port of the JAX package's ``replay.py``. It reads dumps of either
package: the reconstruction section is the same document, and the dump's
``backend`` stamp (``"cuda"``, ``"cpu"`` or a JAX backend) does not change
the incident. The validation driver and the what-if fleets run on
``device`` (the card by default); their draws come from torch generators,
or from a caller's ``draws=`` source (the parity tests replay the JAX key
chain through it). Each arm's sentinel checks run batched over the
scenario axis (:func:`.ops.fleet.fleet_sentinel_reduce`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .chaos.events import Scenario, ScenarioError, scenario_from_dict
from .telemetry.flight import load_flight_dump


class ReplayError(RuntimeError):
    """An artifact or arm spec the replay service refuses: a pre-r18 dump
    with no reconstruction section, a missing seed, an unknown knob."""


# ---------------------------------------------------------------------------
# incident reconstruction
# ---------------------------------------------------------------------------

#: arm-override keys that are NOT direct params fields (handled specially)
_SPEC_KNOBS = ("strategy", "topology", "dissem", "adaptive")


@dataclasses.dataclass
class Incident:
    """One reconstructed flight: live objects, ready to re-run."""

    engine: str
    params: object  # SimParams / SparseParams / PviewParams
    scenario: Scenario
    seed: int
    n_initial: int
    dense_links: bool
    warm: bool
    t0: int
    max_window: int
    sentinels_armed: bool
    verdict: Optional[dict]  # {"ok", "violations", "ticks_run"} or None
    reason: str = ""
    source: Optional[str] = None  # the dump path, when loaded from disk


def _params_class(engine: str):
    if engine == "dense":
        from .ops.state import SimParams

        return SimParams
    if engine == "sparse":
        from .ops.sparse import SparseParams

        return SparseParams
    if engine == "pview":
        from .ops.pview import PviewParams

        return PviewParams
    raise ReplayError(f"reconstruction names unknown engine {engine!r}")


def params_from_doc(engine: str, doc: dict):
    """Rebuild the params dataclass from its ``dataclasses.asdict`` JSON
    round-trip: nested dissem/adaptive specs become their dataclasses
    again, JSON lists become the tuples the frozen params expect, and
    fields this build does not know are dropped LOUDLY (a dump from a
    newer build is refused at the schema gate before we ever get here,
    so an unknown field means a hand-edited artifact)."""
    cls = _params_class(engine)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(doc) - known)
    if unknown:
        raise ReplayError(
            f"params doc carries fields {unknown} the {engine} engine's "
            f"{cls.__name__} does not have — refusing a partial rebuild"
        )
    kwargs = {}
    for k, v in doc.items():
        if k == "dissem" and isinstance(v, dict):
            from .dissemination.spec import DissemSpec

            kwargs[k] = DissemSpec(**v)
        elif k == "adaptive" and isinstance(v, dict):
            from .adaptive import AdaptiveSpec

            kwargs[k] = AdaptiveSpec(**v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _reconstruction_of(dump) -> tuple:
    """(reconstruction dict, source path or None, reason) from a dump path
    or an already-loaded document — with the loud pre-r18 refusal."""
    source = None
    if isinstance(dump, str):
        source = dump
        dump = load_flight_dump(dump)
    rec = dump.get("reconstruction", "partial")
    if not isinstance(rec, dict):
        raise ReplayError(
            "flight dump has reconstruction: 'partial' — it predates the "
            "r18 schema (or its writer had no armed chaos runner), so "
            "there is no event timeline to replay"
        )
    return rec, source, str(dump.get("reason", ""))


def scenario_from_flight(dump) -> Scenario:
    """Rebuild just the replayable :class:`..chaos.Scenario` from a dump
    (path or loaded doc). The full driver-rebuild inputs come via
    :func:`incident_from_flight`."""
    rec, _source, _reason = _reconstruction_of(dump)
    return scenario_from_dict(rec["scenario"])


def incident_from_flight(dump) -> Incident:
    """Decode a schema-2 dump's reconstruction section into an
    :class:`Incident`. Refuses partial dumps and seed-less recorders
    (a restored-from-pickle driver predating the r18 seed stamp)."""
    rec, source, reason = _reconstruction_of(dump)
    if rec.get("seed") is None:
        raise ReplayError(
            "reconstruction carries no construction seed — the recording "
            "driver predates the r18 seed stamp; the replay cannot walk "
            "the same PRNG chain"
        )
    engine = rec["engine"]
    return Incident(
        engine=engine,
        params=params_from_doc(engine, rec["params"]),
        scenario=scenario_from_dict(rec["scenario"]),
        seed=int(rec["seed"]),
        n_initial=int(rec["n_initial"]),
        dense_links=bool(rec.get("dense_links", True)),
        warm=bool(rec.get("warm", True)),
        t0=int(rec.get("t0", 0)),
        max_window=int(rec.get("max_window", 32)),
        sentinels_armed=bool(rec.get("sentinels_armed", True)),
        verdict=rec.get("verdict"),
        reason=reason,
        source=source,
    )


def validate_incident(incident: Incident, *, config=None, device="cuda", draws=None) -> dict:
    """Re-run the incident serially on a fresh driver and compare the
    sentinel verdict to the recorded one. Pre-steps the driver to the
    recorded ``t0`` first — the driver's generator is seeded with the
    construction seed and advances with the tick count, so a pure-stepping
    pre-arm history replays bit-identically. ``draws`` replaces the
    driver's generator (a ``SimDriver`` draws source)."""
    from .sim.driver import SimDriver

    d = SimDriver(
        incident.params,
        incident.n_initial,
        warm=incident.warm,
        seed=incident.seed,
        dense_links=incident.dense_links,
        device=device,
        draws=draws,
    )
    if incident.t0 > 0:
        d.step(incident.t0)
    report = d.run_scenario(
        incident.scenario,
        config=config,
        sentinels=incident.sentinels_armed,
        max_window=incident.max_window,
    )
    recorded = incident.verdict
    reproduced = None
    if recorded is not None:
        reproduced = (
            bool(report["ok"]) == bool(recorded["ok"])
            and int(report["violations"]) == int(recorded["violations"])
        )
    return {
        "scenario": incident.scenario.name,
        "engine": incident.engine,
        "seed": incident.seed,
        "t0": incident.t0,
        "recorded": recorded,
        "replayed": {
            "ok": bool(report["ok"]),
            "violations": int(report["violations"]),
            "ticks_run": int(report["ticks_run"]),
        },
        "reproduced": reproduced,
        "report": report,
    }


# ---------------------------------------------------------------------------
# counterfactual arms
# ---------------------------------------------------------------------------


def arm_params(incident: Incident, arm: dict):
    """Apply one arm's knob overrides to the incident's params.

    The arm grammar: ``{"name": ..., <overrides>}`` where overrides are
    direct params fields (``fanout``, ``suspicion_mult``, ``fd_every``, …),
    ``strategy``/``topology`` (merged into the dissem spec), ``dissem``
    (a dict of DissemSpec fields), or ``adaptive`` (AdaptiveSpec fields).
    Unknown knobs are refused — a typo'd arm must not silently benchmark
    the as-recorded configuration under a counterfactual name."""
    doc = {k: v for k, v in arm.items() if k != "name"}
    base = incident.params
    fields = {f.name for f in dataclasses.fields(base)}
    knobs: Dict[str, object] = {}
    if any(k in doc for k in ("strategy", "topology", "dissem")):
        if "dissem" not in fields:
            raise ReplayError(
                f"arm {arm.get('name')!r} overrides dissemination, but the "
                f"{incident.engine} engine's params carry no dissem spec"
            )
        from .dissemination.spec import DissemSpec

        dd = dataclasses.asdict(getattr(base, "dissem") or DissemSpec())
        dd.update(doc.pop("dissem", {}) or {})
        if "strategy" in doc:
            dd["strategy"] = doc.pop("strategy")
        if "topology" in doc:
            dd["topology"] = doc.pop("topology")
        knobs["dissem"] = DissemSpec(**dd)
    if "adaptive" in doc:
        if "adaptive" not in fields:
            raise ReplayError(
                f"arm {arm.get('name')!r} overrides adaptive FD, but the "
                f"{incident.engine} engine's params carry no adaptive spec"
            )
        from .adaptive import AdaptiveSpec

        ad = dataclasses.asdict(getattr(base, "adaptive") or AdaptiveSpec())
        ad.update(doc.pop("adaptive") or {})
        knobs["adaptive"] = AdaptiveSpec(**ad)
    for k, v in doc.items():
        if k not in fields:
            raise ReplayError(
                f"arm {arm.get('name')!r} overrides unknown knob {k!r} "
                f"(not a {type(base).__name__} field)"
            )
        knobs[k] = v
    return dataclasses.replace(base, **knobs)


def _run_arm_fleet(
    incident: Incident,
    params,
    *,
    n_seeds: int,
    base_seed: int,
    window: int,
    conf: float,
    device="cuda",
    draws=None,
) -> dict:
    """One arm: ``n_seeds`` fleet replays of the incident's scenario under
    ``params``, the engine's sentinel check batched over the scenario axis.
    All folds stay on the device; ONE readback of the [S]-shaped
    accumulators at the end, then the sentinel_report judgment rules
    (chaos/sentinels.py) applied vectorized per seed. ``draws`` is the
    fleet's draw source (a generator on ``device``, or an ``n_ticks ->
    [(fd, round), ...]`` callable with [S, ...] draws); by default a
    generator seeded ``base_seed``."""
    from .chaos.sentinels import build_spec
    from .ops import engine_api
    from .ops import fleet as FL

    eng = engine_api.resolve(params)
    n = incident.n_initial
    scenario = incident.scenario
    spec = build_spec(scenario, params)
    horizon = spec.horizon
    aspec = getattr(params, "adaptive", None)
    adaptive = aspec is not None and not aspec.is_default
    # the fleet discipline: fleet callers run the ungated spelling (quiet
    # gates are dispatch cost only, value-identical)
    if "quiet_gates" in {f.name for f in dataclasses.fields(params)}:
        params = dataclasses.replace(params, quiet_gates=False)

    st0 = eng.init_state(params, n, incident.warm, incident.dense_links, device)
    fs = FL.fleet_broadcast(st0, n_seeds)
    source = FL.fleet_generator(base_seed, device) if draws is None else draws
    ad = None
    if adaptive:
        from .adaptive import init_adaptive_state

        ad = FL.fleet_broadcast(init_adaptive_state(params.capacity, device=device), n_seeds)
    try:
        tl = FL.fleet_timeline(scenario, eng.ops, dense_links=incident.dense_links, horizon=horizon)
    except ScenarioError as exc:
        # engine-capability refusal (e.g. DroppedRefute off-dense), with the
        # incident's context
        raise ReplayError(
            f"incident {scenario.name!r} cannot replay on the "
            f"{incident.engine!r} engine: {exc}"
        ) from exc
    sent = FL.fleet_sentinel_init(eng, fs, spec)
    spec_dev = spec.device_arrays(0, device=device)
    progs: Dict[int, object] = {}

    def _prog(k_ticks: int):
        if k_ticks not in progs:
            progs[k_ticks] = (
                FL.make_fleet_adaptive_run(params, k_ticks) if adaptive
                else FL.make_fleet_run(params, k_ticks)
            )
        return progs[k_ticks]

    boundaries = set(tl.boundaries())
    check_every = spec.check_interval
    next_check = check_every
    t = 0
    while True:
        # events due at t apply BEFORE the sentinel sample at t (the
        # DriverChaosRunner ordering — a same-tick heal is judged healed)
        fs, _labels = tl.apply_due(fs, t)
        if t >= next_check or t >= horizon:
            sent = FL.fleet_sentinel_reduce(eng, fs, sent, spec_dev)
            next_check = t + check_every
        if t >= horizon:
            break
        stops = [horizon, t + window, next_check] + [b for b in boundaries if b > t]
        stop = min(s for s in stops if s > t)
        src = source if isinstance(source, torch.Generator) else source(stop - t)
        if adaptive:
            fs, ad, _ms, _w = _prog(stop - t)(fs, ad, src)
        else:
            fs, _ms, _w = _prog(stop - t)(fs, src)
        t = stop

    # THE readback: every accumulator comes to host as one [S]-leading batch
    sent_np = {k: v.cpu().numpy() for k, v in sent.items()}

    # sentinel_report's judgment rules, vectorized over the seed axis
    det = sent_np["detect_tick"].reshape(n_seeds, -1)  # [S, K]
    d_dl = spec.crash_deadline[None, :]
    d_judged = (horizon >= spec.crash_deadline) & (
        spec.crash_until >= spec.crash_deadline
    )
    ok_det = (((det >= 0) & (det <= d_dl)) | ~d_judged[None, :]).all(axis=1)
    conv = sent_np["conv_tick"].reshape(n_seeds, -1)  # [S, C]
    c_dl = spec.conv_deadline[None, :]
    c_judged = horizon >= spec.conv_deadline
    ok_conv = (((conv >= 0) & (conv <= c_dl)) | ~c_judged[None, :]).all(axis=1)
    false_dead = sent_np["false_dead_max"].reshape(n_seeds)
    regress = sent_np["key_regressions"].reshape(n_seeds)
    ok = ok_det & ok_conv & (false_dead == 0) & (regress == 0)
    fp = None
    if "fp_dead_max" in sent_np and spec.fp_enforce:
        fp = sent_np["fp_dead_max"].reshape(n_seeds)
        ok = ok & (fp == 0)
    for extra in ("n_live_drift", "view_invariant_breaks"):
        if extra in sent_np:
            ok = ok & (sent_np[extra].reshape(n_seeds) == 0)

    from .dissemination.certify import MC_MIN_SAMPLES, wilson_interval

    k_ok = int(ok.sum())
    wil = wilson_interval(k_ok, n_seeds, conf)
    lat = det - spec.crash_at[None, :]
    lat = np.sort(lat[(det >= 0) & d_judged[None, :]])
    return {
        "n_seeds": n_seeds,
        "sample_size": n_seeds,
        "verdict_kind": (
            "monte-carlo" if n_seeds >= MC_MIN_SAMPLES else "spot-check"
        ),
        "horizon": int(horizon),
        "detect_budget": int(spec.detect_budget),
        "converge_budget": int(spec.converge_budget),
        "check_interval": int(check_every),
        "green": k_ok,
        "p_green": round(k_ok / n_seeds, 6),
        "wilson": [round(wil[0], 6), round(wil[1], 6)],
        "interval_method": f"Wilson {conf:.0%} on P(all sentinels green)",
        "fail_detect": int((~ok_det).sum()),
        "fail_converge": int((~ok_conv).sum()),
        "false_dead_scenarios": int((false_dead > 0).sum()),
        "key_regression_scenarios": int((regress > 0).sum()),
        "false_positive_scenarios": (
            int((fp > 0).sum()) if fp is not None else None
        ),
        "zero_false_dead": bool((false_dead == 0).all()),
        "detect_latency_p50": float(np.median(lat)) if lat.size else None,
        "detect_latency_max": int(lat[-1]) if lat.size else None,
    }


def whatif(
    incident: Incident,
    arms: Sequence[dict] = (),
    *,
    seeds_per_arm: int = 256,
    base_seed: int = 1000,
    window: Optional[int] = None,
    conf: float = 0.95,
    log=None,
    device="cuda",
    draws=None,
) -> dict:
    """The counterfactual benchmark: replay the incident's scenario as a
    fleet under the as-recorded knobs AND every counterfactual arm, same
    seed vector throughout (paired comparison), per-arm Wilson intervals
    on P(all sentinels green). An arm whose interval is DISJOINT from the
    as-recorded arm's is CI-separated: a certified would-have-mattered.

    Returns the REPLAY_BENCH_r18.json record. ``device`` runs every arm's
    fleet; ``draws`` (a callable ``(arm name, params) -> draw source``)
    replaces each arm's generator — every arm otherwise draws from a
    generator seeded ``base_seed``, the same seed vector throughout."""
    import os

    if seeds_per_arm < 1:
        raise ReplayError("seeds_per_arm must be >= 1")
    window = window or incident.max_window
    named = set()
    for arm in arms:
        name = arm.get("name")
        if not name or name == "as-recorded":
            raise ReplayError(
                "every counterfactual arm needs a unique name (and "
                "'as-recorded' is reserved for the baseline arm)"
            )
        if name in named:
            raise ReplayError(f"duplicate arm name {name!r}")
        named.add(name)

    def _one(name: str, params, overrides) -> dict:
        rec = _run_arm_fleet(
            incident, params,
            n_seeds=seeds_per_arm, base_seed=base_seed,
            window=window, conf=conf, device=device,
            draws=None if draws is None else draws(name, params),
        )
        rec["arm"] = name
        rec["overrides"] = overrides
        if log:
            log(
                f"{incident.scenario.name}/{name}: P(green) "
                f"{rec['p_green']} wilson {rec['wilson']} "
                f"fp {rec['false_dead_scenarios']}"
            )
        return rec

    baseline = _one("as-recorded", incident.params, {})
    entries = [baseline]
    for arm in arms:
        overrides = {k: v for k, v in arm.items() if k != "name"}
        entries.append(_one(arm["name"], arm_params(incident, arm), overrides))

    lo0, hi0 = baseline["wilson"]
    n_separated = 0
    for rec in entries[1:]:
        lo, hi = rec["wilson"]
        if lo > hi0:
            rec["separated"] = "better"
        elif hi < lo0:
            rec["separated"] = "worse"
        else:
            rec["separated"] = None
        n_separated += rec["separated"] is not None
    baseline["separated"] = None

    return {
        "scenario": incident.scenario.name,
        "engine": incident.engine,
        "n": incident.n_initial,
        "incident": {
            "reason": incident.reason,
            "source": incident.source,
            "seed": incident.seed,
            "t0": incident.t0,
            "recorded_verdict": incident.verdict,
        },
        "n_arms": len(entries),
        "seeds_per_arm": seeds_per_arm,
        "window_ticks": window,
        "conf": conf,
        # provenance stamps (the r13 rule): backend + host CPUs + the
        # relative tick span every arm replayed
        "backend": torch.device(device).type,
        "host_cpus": os.cpu_count(),
        "tick_range": [0, int(entries[0]["horizon"])],
        "arms": entries,
        "as_recorded_wilson": baseline["wilson"],
        "n_separated": n_separated,
        "any_arm_separated": n_separated > 0,
    }


# ---------------------------------------------------------------------------
# the monitor-served service
# ---------------------------------------------------------------------------


class WhatifService:
    """Holds the newest what-if record for ``GET /whatif``.

    The MC computation is minutes of fleet windows — far outside an HTTP
    GET budget — so the monitor serves the LAST computed record (like
    ``/chaos`` serves the last report), and :meth:`run` is the explicit
    compute step an operator (or bench harness) invokes."""

    def __init__(self, incident: Optional[Incident] = None):
        self.record: dict = {"computed": False}
        self.history: List[dict] = []
        #: r19: the LIVE incident operator-submitted arm ladders run
        #: against (``POST /whatif``); None keeps the service GET-only
        self.incident = incident

    def attach_incident(self, incident: Incident) -> None:
        """Arm ``POST /whatif`` with a (new) live incident."""
        self.incident = incident

    def run(self, incident: Incident, arms: Sequence[dict] = (), **kw) -> dict:
        rec = whatif(incident, arms, **kw)
        rec["computed"] = True
        self.record = rec
        self.history.append(rec)
        return rec

    def run_operator(self, doc: dict) -> dict:
        """Operator entry behind ``POST /whatif``: an arm ladder document
        ``{"arms": [{"name": ..., <knob>: ...}, ...], "seeds_per_arm"?,
        "conf"?}`` validated EAGERLY with the existing refusal grammar —
        every arm passes through :func:`arm_params` (unknown-knob refusal)
        before a single MC seed is paid, and :func:`whatif` applies its own
        reserved-name / duplicate-name refusals — then run against the live
        incident."""
        if self.incident is None:
            raise ReplayError(
                "no live incident attached — construct "
                "WhatifService(incident=...) or call attach_incident() "
                "before POSTing arm ladders"
            )
        if not isinstance(doc, dict):
            raise ReplayError("POST /whatif body must be a JSON object")
        arms = doc.get("arms")
        if not isinstance(arms, list) or not arms:
            raise ReplayError(
                "POST /whatif needs a non-empty 'arms' list of "
                "{'name': ..., <knob>: ...} objects"
            )
        for arm in arms:
            if not isinstance(arm, dict):
                raise ReplayError(f"arm {arm!r} is not an object")
            if isinstance(arm.get("name"), str) and arm["name"]:
                # eager unknown-knob refusal: a typo'd knob must refuse
                # BEFORE the as-recorded baseline fleet runs
                arm_params(self.incident, arm)
        kw: dict = {}
        if "seeds_per_arm" in doc:
            kw["seeds_per_arm"] = int(doc["seeds_per_arm"])
        if "conf" in doc:
            kw["conf"] = float(doc["conf"])
        return self.run(self.incident, arms, **kw)

    def snapshot(self) -> dict:
        return self.record
