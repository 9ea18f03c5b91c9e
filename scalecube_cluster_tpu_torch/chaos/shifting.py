"""Shifting-conditions scenario family (r16): chaos whose CONDITIONS move.
A copy of the JAX package's ``chaos/shifting.py`` (it imports no JAX).

Every scenario the chaos plane has certified so far holds its adversary
fixed for the whole run — one storm level, one degraded cohort, one
topology. A production cluster's faults SHIFT: a loss storm arrives
mid-run, a WAN zone degrades and recovers, asymmetric loss migrates
between regions as routing changes. Fault-tolerant rumor-spreading theory
(arXiv:1209.6158) gives per-condition optimal protocol settings, which is
exactly why shifting conditions are the closed-loop controller's
certification adversary (``control.py``): no static knob setting is right
for both phases, so the controller must TRACK the condition.

Each builder returns a :class:`ShiftingScenario` — a plain
:class:`.events.Scenario` (it runs on every existing runner: the driver
chaos runner, the emulator runner, the batched fleet timeline) plus the
phase metadata the controller certification needs: where the clean phase
ends, which row crashes when (the detection SLO's subject), which rows are
degraded-but-alive (the false-positive sentinel's watch cohort), and when
each certification rumor is injected (the spread SLO's subjects).

Timing convention: every event tick is a multiple of 8, so a fleet
harness stepping 8-tick windows replays the whole family with ONE
compiled window program per knob setting (window lengths never fragment
at event boundaries).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from .events import (
    AsymmetricLoss,
    Crash,
    FlakyObserver,
    LossStorm,
    Scenario,
    ScenarioError,
)


@dataclass(frozen=True)
class ShiftingScenario:
    """One shifting-conditions cell: the scenario + its SLO subjects.

    ``phases`` is the descriptive (start, end, label) list the artifact
    records; ``rumors`` maps rumor slot -> injection tick (the spread
    SLO measures ticks from injection to full coverage, per slot);
    ``crash_row``/``crash_at`` name the detection SLO's subject (a fleet
    run may vary the row per scenario via ``ops.fleet.FleetVary``);
    ``watch_rows`` is the degraded-but-alive cohort a DEAD verdict about
    which is by construction a false positive."""

    name: str
    scenario: Scenario
    crash_row: int
    crash_at: int
    watch_rows: Tuple[int, ...]
    rumors: Tuple[Tuple[int, int], ...]  # (slot, inject_tick)
    phases: Tuple[Tuple[int, int, str], ...]
    #: ticks after the clean-phase start at which conditions shift (the
    #: controller must react between here and the first false positive)
    shift_at: int

    def __post_init__(self):
        if self.crash_row in self.watch_rows:
            raise ScenarioError(
                "the detection subject cannot also be a false-positive "
                "watch row (a true crash is not a false positive)"
            )


#: the r14/r15 degraded-cohort layout, reused so the measured false-
#: positive physics (ADAPTIVE_BENCH_r14 / FLEET_BENCH_r15) carries over
_ASYM_ROWS = (5, 6, 7)
_FLAKY_ROWS = (9,)
_CRASH_ROW = 20


def _check(n: int, *rows_seqs) -> None:
    for rows in rows_seqs:
        for r in rows:
            if not 0 <= int(r) < n:
                raise ScenarioError(
                    f"shifting scenario needs capacity > {r}; got n={n}"
                )


def loss_storm_midrun(
    n: int = 48,
    clean_ticks: int = 112,
    storm_ticks: int = 120,
    relax_ticks: int = 48,
    storm_pct: float = 20.0,
    asym_pct: float = 70.0,
    crash_at: int = 32,
) -> ShiftingScenario:
    """A LossStorm ARRIVING mid-run: clean phase (a true crash to detect
    fast), then an ambient loss floor plus the r14 loss-adversarial cohort
    (AsymmetricLoss + FlakyObserver — the false-positive adversary), then
    a relax tail (the controller's down-dwell is visible there). One
    certification rumor per phase.

    The ambient floor arrives one beat BEFORE the degraded cohort (at
    ``t1`` vs ``t1 + 8``) and is strong enough (20% → ~0.07 post-rescue
    miss) that a condition-tracking controller has already raised
    protection when the false-positive adversary engages — the margin the
    certification measures. A floor much below ~18% hides under the
    crash-transient band (~1/n) and gives the controller no safe lead."""
    t1 = clean_ticks
    t2 = t1 + storm_ticks
    horizon = t2 + relax_ticks
    _check(n, _ASYM_ROWS, _FLAKY_ROWS, (_CRASH_ROW,))
    scen = Scenario(
        name="loss_storm_midrun",
        events=(
            Crash(rows=[_CRASH_ROW], at=crash_at),
            LossStorm(pct=storm_pct, at=t1, until=t2),
            AsymmetricLoss(rows=list(_ASYM_ROWS), pct=asym_pct,
                           at=t1 + 8, until=t2 - 8, direction="in"),
            FlakyObserver(rows=list(_FLAKY_ROWS), pct=asym_pct,
                          at=t1 + 8, until=t2 - 8),
        ),
        horizon=horizon,
        fp_enforce=False,  # arms are judged by the MC fold, not latching
    )
    return ShiftingScenario(
        name="loss_storm_midrun",
        scenario=scen,
        crash_row=_CRASH_ROW,
        crash_at=crash_at,
        watch_rows=_ASYM_ROWS + _FLAKY_ROWS,
        rumors=((0, 0), (1, t1 + 24)),
        phases=((0, t1, "clean"), (t1, t2, "storm"), (t2, horizon, "relax")),
        shift_at=t1,
    )


def wan_zone_degrade(
    n: int = 48,
    clean_ticks: int = 112,
    degrade_ticks: int = 120,
    relax_ticks: int = 32,
    zone_rows: Sequence[int] = (40, 41, 42, 43, 44, 45, 46, 47),
    pct: float = 55.0,
    crash_at: int = 32,
) -> ShiftingScenario:
    """A WAN zone's links degrading mid-run: every link to AND from the
    ``zone_rows`` cohort (the "remote region" behind one WAN path) gains a
    heavy loss floor — the whole zone looks half-partitioned while staying
    alive, the classic false-positive adversary of a geo deployment. The
    zone members are the watch cohort; the clean-phase crash and the
    per-phase rumors are the detection/spread SLO subjects."""
    t1 = clean_ticks
    t2 = t1 + degrade_ticks
    horizon = t2 + relax_ticks
    zone = tuple(int(r) for r in zone_rows)
    _check(n, zone, (_CRASH_ROW,))
    if _CRASH_ROW in zone:
        raise ScenarioError("crash row must lie outside the WAN zone")
    scen = Scenario(
        name="wan_zone_degrade",
        events=(
            Crash(rows=[_CRASH_ROW], at=crash_at),
            LossStorm(pct=20.0, at=t1, until=t2),
            AsymmetricLoss(rows=list(zone), pct=pct,
                           at=t1 + 8, until=t2 - 8, direction="both"),
        ),
        horizon=horizon,
        fp_enforce=False,
    )
    return ShiftingScenario(
        name="wan_zone_degrade",
        scenario=scen,
        crash_row=_CRASH_ROW,
        crash_at=crash_at,
        watch_rows=zone,
        rumors=((0, 0), (1, t1 + 24)),
        phases=((0, t1, "clean"), (t1, t2, "wan-degraded"),
                (t2, horizon, "relax")),
        shift_at=t1,
    )


def migrating_asym_loss(
    n: int = 48,
    clean_ticks: int = 112,
    phase_ticks: int = 64,
    relax_ticks: int = 32,
    cohort_a: Sequence[int] = (5, 6, 7),
    cohort_b: Sequence[int] = (33, 34, 35),
    pct: float = 70.0,
    crash_at: int = 32,
) -> ShiftingScenario:
    """Asymmetric loss MIGRATING between regions: cohort A degrades first,
    recovers, then cohort B degrades (staggered — the chaos composition
    validator refuses overlapping writes on shared links). The controller
    sees the pressure signal dip between the phases and must NOT relax
    early (the anti-flap dwell's certification case); both cohorts are
    watch rows for the whole run."""
    t1 = clean_ticks
    ta_end = t1 + phase_ticks
    tb_start = ta_end + 8
    tb_end = tb_start + phase_ticks
    horizon = tb_end + relax_ticks
    a = tuple(int(r) for r in cohort_a)
    b = tuple(int(r) for r in cohort_b)
    if set(a) & set(b):
        raise ScenarioError("migrating cohorts must be disjoint")
    _check(n, a, b, (_CRASH_ROW,))
    scen = Scenario(
        name="migrating_asym_loss",
        events=(
            Crash(rows=[_CRASH_ROW], at=crash_at),
            LossStorm(pct=20.0, at=t1, until=tb_end),
            AsymmetricLoss(rows=list(a), pct=pct, at=t1 + 8,
                           until=ta_end, direction="in"),
            AsymmetricLoss(rows=list(b), pct=pct, at=tb_start,
                           until=tb_end - 8, direction="in"),
        ),
        horizon=horizon,
        fp_enforce=False,
    )
    return ShiftingScenario(
        name="migrating_asym_loss",
        scenario=scen,
        crash_row=_CRASH_ROW,
        crash_at=crash_at,
        watch_rows=a + b,
        rumors=((0, 0), (1, t1 + 24)),
        phases=((0, t1, "clean"), (t1, ta_end, "region-A"),
                (tb_start, tb_end, "region-B"), (tb_end, horizon, "relax")),
        shift_at=t1,
    )


#: the default certification family (``control.certify_controller_mc``)
SHIFTING_FAMILY = (
    loss_storm_midrun,
    wan_zone_degrade,
    migrating_asym_loss,
)
