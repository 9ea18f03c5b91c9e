"""On-device SWIM invariant sentinels for chaos scenarios. A port of the
JAX package's ``chaos/sentinels.py``: the budgets, :class:`SentinelSpec`,
:func:`build_spec` and :func:`sentinel_report` are host-side numpy and
copied as they are; :meth:`SentinelSpec.device_arrays` and
:func:`init_sentinel_state` put the plan and the accumulators on the
engine state's torch device. The engines' reductions are
``ops/kernel.py: sentinel_core`` (dense and sparse) and
``ops/pview.py: sentinel_reduce``.

Four protocol guarantees, each checkable as a pure reduction over the
device-resident view planes (``view_key`` / ``up`` — shared by the dense and
sparse states, so ONE reduction serves both engines, mesh-sharded included):

1. **No false-DEAD** — a member no scenario event ever faulted must never be
   marked DEAD by any up observer (the fault-tolerant rumor-spreading
   guarantee: adversarial loss below the storm-immunity threshold must not
   kill healthy members).
2. **Bounded detection latency** — after ``Crash(rows, at)``, every up
   observer marks each crashed row DEAD (or never knew it) within the
   detection budget (suspicion math + dissemination slack).
3. **Re-convergence** — after a heal/restart/storm-end boundary, all up
   members see all up members ALIVE within the convergence budget (the
   anti-entropy guarantee; seed-row SYNC is what re-bridges full splits).
4. **Key/incarnation monotonicity** — each member's self record (packed
   ``epoch | incarnation | rank`` key) never regresses between checks: the
   lattice's monotone-merge contract, which all other guarantees build on.

Every sentinel fact is LATCHING or monotone (a DEAD tombstone persists until
rejoin, detection and convergence only ever become true, a key regression is
counted against a remembered previous value), so the checks are sound under
SAMPLING: the runner evaluates them every ``check_interval`` ticks — pure
tensor ops on the device, ZERO device→host transfers until a sync point
(``health_snapshot`` / ``chaos_snapshot`` / the final report) reads the
accumulators back.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .events import (
    ChurnStorm,
    Crash,
    DroppedRefute,
    LinkFlap,
    LossStorm,
    Partition,
    Restart,
    Scenario,
    SlowEpoch,
    ZoneOutage,
)


def _ceil_log2(n: int) -> int:
    return int(n).bit_length() if n > 0 else 0


def default_detect_budget(params) -> int:
    """Suspicion math + dissemination slack, in ticks: the suspicion window
    (``suspicion_mult * ceilLog2(N) * fd_every``) doubled (first-probe and
    expiry-sweep phase lag), plus two SYNC intervals for the DEAD record to
    reach every observer through anti-entropy even if gossip misses some."""
    return (
        2 * params.suspicion_mult * _ceil_log2(params.capacity) * params.fd_every
        + 2 * params.sync_every
    )


def default_converge_budget(params) -> int:
    """Post-heal re-convergence is anti-entropy-limited for the stragglers
    (nodes that must learn of their own premature death via a periodic
    seed-SYNC and refute — benchmarks/config4_partition.py budgets 8 sync
    intervals for the same reason), plus the detection slack for any death
    rumors still in flight at the heal. The raw budget is scaled by the
    armed dissemination strategy/topology (r13,
    :func:`dissemination_budget_scale`)."""
    raw = 8 * params.sync_every + default_detect_budget(params)
    return max(1, int(round(raw * dissemination_budget_scale(params))))


#: r13 strategy-aware re-convergence scaling. Deterministic schedules
#: (pipelined/accelerated) TIGHTEN the budget: their chord rotation
#: guarantees every overlay edge is exercised within one rotation, so the
#: gossip-driven share of re-convergence loses its coupon-collector tail.
#: Constrained topologies LOOSEN it by their diameter class (ring linear,
#: torus 2-D), and a WAN-delayed geo overlay loosens further with the
#: configured cross-zone delay (every inter-zone anti-entropy exchange
#: pays the delay both ways).
_STRATEGY_SCALE = {
    "push": 1.0, "push_pull": 1.0, "pipelined": 0.75, "accelerated": 0.75,
    # tuneable (r14): the deterministic share covers the rotation, the
    # random share keeps coupon-collector tails — neither tighten nor loosen
    "tuneable": 1.0,
}
_TOPOLOGY_SCALE = {
    "full": 1.0, "expander": 1.0, "ring": 1.5, "torus": 1.25, "geo": 2.0,
}


def scenario_budget_scale(scenario: Scenario) -> tuple:
    """(detect_scale, converge_scale) the r18 fault vocabulary applies on
    top of the protocol-math defaults — scenario-content-driven slack,
    multiplicative with the r13 dissemination scaling:

    * ``SlowEpoch`` inflates every gossip/anti-entropy hop by the scripted
      mean delay, so both budgets stretch with it (capped — a sentinel
      budget is generous by design, not a bound proof);
    * ``ChurnStorm`` leaves one wave's death rumors still in flight at the
      next wave's restart, so re-convergence stretches with the wave count;
    * ``DroppedRefute`` forces the squashed rows to out-gossip a fully
      disseminated suspicion (or DEAD tombstone) after the window ends.

    Explicit ``Scenario.detect_budget`` / ``converge_budget`` are never
    scaled — a scripted budget wins verbatim.
    """
    d_scale = c_scale = 1.0
    for ev in scenario.events:
        if isinstance(ev, SlowEpoch):
            s = min(3.0, 1.0 + ev.mean_delay_ticks / 8.0)
            d_scale = max(d_scale, s)
            c_scale = max(c_scale, s)
        elif isinstance(ev, ChurnStorm):
            c_scale = max(c_scale, 1.0 + 0.25 * (ev.waves - 1))
        elif isinstance(ev, DroppedRefute):
            c_scale = max(c_scale, 1.5)
    return d_scale, c_scale


def dissemination_budget_scale(params) -> float:
    """Multiplier the auto re-convergence budget applies for the armed
    dissemination spec (1.0 for the default push/full and for params
    objects that predate the spec)."""
    spec = getattr(params, "dissem", None)
    if spec is None or spec.is_default:
        return 1.0
    scale = _STRATEGY_SCALE[spec.strategy] * _TOPOLOGY_SCALE[spec.topology]
    if spec.topology == "geo" and spec.geo_wan_delay_ticks:
        scale *= 1.0 + spec.geo_wan_delay_ticks / 64.0
    return scale


@dataclass
class SentinelSpec:
    """Host-side compiled sentinel plan for one scenario (numpy arrays are
    uploaded once at arm time; the per-check work is all on device)."""

    capacity: int
    never_faulted: np.ndarray  # bool [N]
    crash_rows: np.ndarray  # i32 [K] — one entry per crashed row occurrence
    crash_at: np.ndarray  # i32 [K]
    crash_deadline: np.ndarray  # i32 [K]
    crash_until: np.ndarray  # i32 [K] — restart tick (or horizon)
    conv_from: np.ndarray  # i32 [C] — heal/restart/storm-end boundaries
    conv_deadline: np.ndarray  # i32 [C]
    conv_labels: List[str] = field(default_factory=list)
    detect_budget: int = 0
    converge_budget: int = 0
    check_interval: int = 32
    horizon: int = 0
    #: r14 false-positive watch cohort: degraded-but-alive rows (SlowMember/
    #: AsymmetricLoss/FlakyObserver targets + Scenario.fp_watch_rows). A
    #: watched row tombstoned by any up observer is a false positive;
    #: fp_enforce=False records without judging (the static control arm).
    fp_watch: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    fp_enforce: bool = True

    def device_arrays(self, t0: int = 0, device="cuda") -> Dict[str, object]:
        """Upload the spec once at arm time, onto ``device``. ``t0`` is the
        absolute tick the scenario was armed at (a host int, as the port's
        ``state.tick`` is); sentinel checks compare ``state.tick - t0``
        against the (relative) event ticks, so detect/conv stamps come back
        in scenario-relative ticks like every deadline in the report.
        The ``fp_watch`` plane ships only when the cohort is non-empty —
        legacy scenarios keep their exact legacy check."""
        import torch

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        out = {
            "t0": int(t0),
            "never_faulted": up(self.never_faulted),
            "crash_rows": up(self.crash_rows),
            "crash_at": up(self.crash_at),
            "crash_until": up(self.crash_until),
            "conv_from": up(self.conv_from),
        }
        if self.fp_watch.size and bool(self.fp_watch.any()):
            out["fp_watch"] = up(self.fp_watch)
        return out


def build_spec(
    scenario: Scenario, params, config=None, horizon: Optional[int] = None
) -> SentinelSpec:
    """Compile a scenario + engine params (``SimParams`` / ``SparseParams`` —
    only the shared protocol knobs are read) into a :class:`SentinelSpec`.
    ``config`` (a ClusterConfig) supplies ``chaos.*`` defaults; explicit
    scenario fields win."""
    n = params.capacity
    scenario.validate_rows(n)
    chaos_cfg = getattr(config, "chaos", None)
    immunity = getattr(chaos_cfg, "loss_storm_immunity_pct", 50.0)
    detect = scenario.detect_budget or getattr(
        chaos_cfg, "detect_budget_ticks", 0
    ) or default_detect_budget(params)
    converge = scenario.converge_budget or getattr(
        chaos_cfg, "converge_budget_ticks", 0
    ) or default_converge_budget(params)
    d_scale, c_scale = scenario_budget_scale(scenario)
    if not scenario.detect_budget:
        detect = max(1, int(round(detect * d_scale)))
    if not scenario.converge_budget:
        converge = max(1, int(round(converge * c_scale)))
    check = scenario.check_interval or getattr(
        chaos_cfg, "check_interval_ticks", 0
    ) or 32
    # sampling must be able to observe a detection/convergence before its
    # deadline passes; clamp the cadence well inside the tightest budget
    check = max(1, min(check, detect // 4 or 1, converge // 4 or 1))

    touched = scenario.fault_touched_rows(n, immunity)
    never = np.ones((n,), bool)
    never[sorted(touched)] = False

    # r14 false-positive cohort: degraded-but-alive rows plus explicit
    # fp_watch_rows (explicit rows are NOT crash-excluded — that is the
    # falsifiability hook: watch a row you then crash and the sentinel
    # must fire)
    fp = np.zeros((n,), bool)
    fp_rows = sorted(
        set(scenario.degraded_rows()) | set(scenario.fp_watch_rows)
    )
    fp[[r for r in fp_rows if 0 <= r < n]] = True

    crash_rows: List[int] = []
    crash_at: List[int] = []
    crash_until: List[int] = []
    conv_from: List[int] = []
    conv_labels: List[str] = []
    restarts: List[Restart] = [e for e in scenario.events if isinstance(e, Restart)]
    for ev in scenario.events:
        if isinstance(ev, Crash):
            for r in ev.rows:
                until = min(
                    (rs.at for rs in restarts if r in rs.rows and rs.at > ev.at),
                    default=np.iinfo(np.int32).max,
                )
                crash_rows.append(r)
                crash_at.append(ev.at)
                crash_until.append(until)
        elif isinstance(ev, Partition) and ev.heal_at is not None:
            conv_from.append(ev.heal_at)
            conv_labels.append(f"partition_heal@{ev.heal_at}")
        elif isinstance(ev, Restart):
            conv_from.append(ev.at)
            conv_labels.append(f"restart@{ev.at}")
        elif isinstance(ev, LossStorm) and ev.until is not None:
            conv_from.append(ev.until)
            conv_labels.append(f"storm_end@{ev.until}")
        elif isinstance(ev, LinkFlap) and ev.until is not None:
            conv_from.append(ev.until)
            conv_labels.append(f"flap_end@{ev.until}")
        elif isinstance(ev, ZoneOutage) and ev.until is not None:
            conv_from.append(ev.until)
            conv_labels.append(f"zone_up@{ev.until}")
        elif isinstance(ev, ChurnStorm):
            # each wave is a crash obligation (lapsing at its own restart,
            # like a Crash/Restart pair) and each restart a convergence point
            for w, (c_tick, r_tick, chunk) in enumerate(ev.wave_schedule()):
                for r in chunk:
                    crash_rows.append(r)
                    crash_at.append(c_tick)
                    crash_until.append(r_tick)
                conv_from.append(r_tick)
                conv_labels.append(f"churn_restart[w{w}]@{r_tick}")
        elif isinstance(ev, SlowEpoch):
            conv_from.append(ev.until)
            conv_labels.append(f"slow_epoch_end@{ev.until}")
        elif isinstance(ev, DroppedRefute):
            # after the drop window the rows must out-refute whatever
            # verdict accumulated and the cluster must re-converge
            conv_from.append(ev.until)
            conv_labels.append(f"refute_resume@{ev.until}")

    spec = SentinelSpec(
        capacity=n,
        never_faulted=never,
        crash_rows=np.asarray(crash_rows, np.int32),
        crash_at=np.asarray(crash_at, np.int32),
        crash_deadline=np.asarray([a + detect for a in crash_at], np.int32),
        crash_until=np.asarray(crash_until, np.int32),
        conv_from=np.asarray(conv_from, np.int32),
        conv_deadline=np.asarray([f + converge for f in conv_from], np.int32),
        conv_labels=conv_labels,
        detect_budget=detect,
        converge_budget=converge,
        check_interval=check,
        fp_watch=fp,
        fp_enforce=scenario.fp_enforce,
    )
    auto_horizon = max(
        scenario.last_event_tick() + 1,
        int(max(spec.crash_deadline, default=0)),
        int(max(spec.conv_deadline, default=0)),
        2 * check,
    )
    spec.horizon = horizon or scenario.horizon or auto_horizon
    return spec


def init_sentinel_state(
    view_key, spec: SentinelSpec, sparse: bool = False
) -> Dict[str, object]:
    """Fresh sentinel accumulators on ``view_key``'s device, baselined on a
    copy of the current self records (the engines update the plane in
    place; a device op, not a transfer). ``sparse`` adds the sparse
    engine's internal-consistency counter (``n_live`` drift)."""
    import torch

    dev = view_key.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    sent = {
        "prev_diag": view_key.diagonal().clone(),
        "key_regressions": z,
        "false_dead_max": z,
        "detect_tick": torch.full((len(spec.crash_rows),), -1, dtype=torch.int32, device=dev),
        "conv_tick": torch.full((len(spec.conv_from),), -1, dtype=torch.int32, device=dev),
    }
    if spec.fp_watch.size and bool(spec.fp_watch.any()):
        sent["fp_dead_max"] = z
    if sparse:
        sent["n_live_drift"] = z
    return sent


def sentinel_report(sent_host: Dict[str, np.ndarray], spec: SentinelSpec,
                    final_tick: int) -> dict:
    """Fold the read-back accumulators into the structured scenario report
    (the one host-side step; everything before it stayed on device)."""
    detections = []
    for k in range(len(spec.crash_rows)):
        det = int(sent_host["detect_tick"][k])
        deadline = int(spec.crash_deadline[k])
        # only judge deadlines the run actually reached, and only crashes
        # that PERSISTED through their whole budget — a quick-blip crash
        # restarted before the deadline lapses the obligation (detection
        # inside a window shorter than the suspicion math is impossible,
        # and the restart's own convergence point takes over)
        judged = (
            final_tick >= deadline and int(spec.crash_until[k]) >= deadline
        )
        ok = (det >= 0 and det <= deadline) or not judged
        detections.append({
            "row": int(spec.crash_rows[k]),
            "crashed_at": int(spec.crash_at[k]),
            "deadline": deadline,
            "detected_at": det if det >= 0 else None,
            "ok": bool(ok),
        })
    convergence = []
    for c in range(len(spec.conv_from)):
        conv = int(sent_host["conv_tick"][c])
        deadline = int(spec.conv_deadline[c])
        judged = final_tick >= deadline
        ok = (conv >= 0 and conv <= deadline) or not judged
        convergence.append({
            "label": spec.conv_labels[c],
            "from": int(spec.conv_from[c]),
            "deadline": deadline,
            "converged_at": conv if conv >= 0 else None,
            "ok": bool(ok),
        })
    false_dead = int(sent_host["false_dead_max"])
    regress = int(sent_host["key_regressions"])
    n_live_drift = int(sent_host.get("n_live_drift", 0))
    # pview's internal-consistency sentinel (duplicate/self table entries —
    # the partial-view analogue of the sparse n_live drift)
    view_breaks = int(sent_host.get("view_invariant_breaks", 0))
    # r14 false-positive sentinel: degraded-but-alive members tombstoned.
    # Judged only when the scenario enforces it — the static-timeout
    # control arm RECORDS its false positives without failing the run.
    fp_dead = int(sent_host.get("fp_dead_max", 0))
    fp_judged = "fp_dead_max" in sent_host and spec.fp_enforce
    violations = (
        (1 if false_dead else 0)
        + (1 if regress else 0)
        + (1 if n_live_drift else 0)
        + (1 if view_breaks else 0)
        + (1 if (fp_judged and fp_dead) else 0)
        + sum(1 for d in detections if not d["ok"])
        + sum(1 for c in convergence if not c["ok"])
    )
    report = {
        "false_dead_members_max": false_dead,
        "key_regressions": regress,
        "detections": detections,
        "convergence": convergence,
        "never_faulted_members": int(spec.never_faulted.sum()),
        "detect_budget": spec.detect_budget,
        "converge_budget": spec.converge_budget,
        "check_interval": spec.check_interval,
        "violations": violations,
        "ok": violations == 0,
    }
    if "fp_dead_max" in sent_host:
        report["false_positive_dead_max"] = fp_dead
        report["false_positive_enforced"] = bool(spec.fp_enforce)
        report["false_positive_watch_members"] = int(spec.fp_watch.sum())
    if "n_live_drift" in sent_host:
        report["n_live_drift"] = n_live_drift
    if "view_invariant_breaks" in sent_host:
        report["view_invariant_breaks"] = view_breaks
    return report
