"""Chaos scenario engine: scripted fault timelines + SWIM invariant sentinels.

A port of the JAX package's ``chaos/`` package. A :class:`Scenario` is a
declarative timeline of fault events (partitions, loss storms, link flaps,
crashes, restarts, the loss-adversarial cohorts) that compiles into
between-window mutations of the device-resident link and status planes of
every engine (:class:`StateTimeline`), and runs on a driver through
:class:`DriverChaosRunner` / ``SimDriver.run_scenario``. Alongside
injection the invariant sentinels (:mod:`.sentinels`) check no false-DEAD
of a never-faulted member, bounded detection latency after a crash, view
re-convergence after a heal, key monotonicity and, for a degraded cohort,
no false positive; they accumulate on the device and are read at the
final report.

``run_scenario(trace=True)`` attaches the causal trace plane's detection
span trees to the report. :class:`EmulatorChaosRunner` replays a
scenario onto the scalar engine's network emulators.
"""

from .engine import (
    DriverChaosRunner,
    EmulatorChaosRunner,
    ScenarioError,
    StateTimeline,
    run_driver_scenario,
    schedule,
)
from .events import (
    AsymmetricLoss,
    ChurnStorm,
    Crash,
    DroppedRefute,
    FlakyObserver,
    LinkFlap,
    LossStorm,
    Partition,
    Restart,
    Scenario,
    SlowEpoch,
    SlowMember,
    ZoneOutage,
)
from .sentinels import (
    SentinelSpec,
    build_spec,
    dissemination_budget_scale,
    init_sentinel_state,
    sentinel_report,
)
from .shifting import (
    SHIFTING_FAMILY,
    ShiftingScenario,
    loss_storm_midrun,
    migrating_asym_loss,
    wan_zone_degrade,
)


def spread_certifier(*args, **kwargs):
    """The spread-time certification sweep (re-exported from
    :mod:`..dissemination.certify`)."""
    from ..dissemination.certify import spread_certifier as _sc

    return _sc(*args, **kwargs)


__all__ = [
    "Partition",
    "LossStorm",
    "LinkFlap",
    "Crash",
    "Restart",
    "SlowMember",
    "AsymmetricLoss",
    "FlakyObserver",
    "ChurnStorm",
    "DroppedRefute",
    "SlowEpoch",
    "ZoneOutage",
    "Scenario",
    "ScenarioError",
    "StateTimeline",
    "DriverChaosRunner",
    "EmulatorChaosRunner",
    "run_driver_scenario",
    "schedule",
    "SentinelSpec",
    "build_spec",
    "dissemination_budget_scale",
    "init_sentinel_state",
    "sentinel_report",
    "spread_certifier",
    "ShiftingScenario",
    "SHIFTING_FAMILY",
    "loss_storm_midrun",
    "wan_zone_degrade",
    "migrating_asym_loss",
]
