"""Closed-loop self-tuning control plane (r16, ROADMAP item 4).

Every sensor and actuator this module needs already exists: the telemetry
ring's per-window FD/coverage series (r8), the ``set_dissemination`` /
``set_adaptive`` live swaps (r13/r14), the tuneable gossip family's
continuous ``tuneable_mix`` knob (arXiv:1506.02288 — a family *designed*
to be tuned), and the adaptive local-health planes. What was missing is
the LOOP: a production operator of a million-member cluster cannot
hand-pick ``min_mult`` or fanout per network condition. Fault-tolerant
rumor-spreading theory (arXiv:1209.6158) gives per-condition optimal
settings; the controller's whole job is to TRACK the condition.

Design (the constraints the r6–r15 disciplines impose):

* **Pure-host policy.** The controller is a bounded hysteresis/step
  machine over host floats read from the telemetry ring at CONTROL-EPOCH
  cadence (a sync point of the same contract as a monitor poll — never
  window cadence). It adds no device code to the hot path: when it takes
  no action, an armed driver's trajectory is BIT-IDENTICAL to an unarmed
  one (pinned by tests/test_control.py), and a disarmed driver is
  untouched r15 behavior.
* **A ladder, not a continuum.** Actuation targets are discrete
  :class:`Rung`s — certified knob settings ordered from fast/cheap
  (clean network) to safe/robust (storm). The rungs' adaptive knobs are
  seeded from the OFFLINE knob map
  (``dissemination.certify.adaptive_knob_sweep`` — the r16 (min_mult ×
  conf_target × loss-floor) fp_rate_mc grid, recorded in
  CONTROL_BENCH_r16.json): per loss floor, the fastest knob whose
  false-DEAD Wilson upper bound stays within budget.
* **Bounded actuation.** One rung step per epoch at most (the clamp), a
  dwell of consecutive over-threshold epochs before moving (anti-flap;
  asymmetric — protection rises after ``dwell_up`` epochs, relaxes only
  after ``dwell_down``), and hysteresis on the way down (the condition
  must clear the rung's threshold by a margin before relaxing). The two
  FALSIFIABILITY controllers remove exactly these properties: the
  telemetry-blind controller never reads the sensors, the unclamped one
  actuates proportionally every window with no dwell, no hysteresis, and
  no rung bounds — and both must demonstrably FAIL certification
  (:func:`certify_controller_mc` records it).
* **The certification discipline applied to the controller itself.**
  :func:`certify_controller_mc` drives the controlled system through the
  r16 shifting-conditions chaos family (``chaos.shifting``: a LossStorm
  arriving mid-run, a WAN zone degrading, asymmetric loss migrating
  between regions) in scenario-batched fleet windows (``ops.fleet``),
  ≥512 seeds per cell, with per-scenario crash rows varied through the
  r16 ``FleetVary`` seam. Per scenario the SLO is joint: the clean-phase
  crash detected inside its deadline, both phase rumors spread inside
  theirs, ZERO false-DEAD of the degraded-but-alive watch cohort, and
  mean gossip cost inside the budget. The controlled arm must beat EVERY
  static rung with non-overlapping Wilson 95% intervals on P(SLO met)
  while its false-positive count is exactly zero.

Why a static setting cannot win (the physics the cells encode): fast
detection needs a low suspicion multiplier, which under ambient loss
false-kills degraded-but-alive members (the r14/r15 measured static
fp-rate of ~0.8); surviving the storm needs high multipliers and high
fanout, which blow the clean-phase detection deadline and the cost
budget. The condition SHIFTS mid-run, so only tracking it meets all four
SLOs at once.

The port of the JAX package's ``control.py``: the host policy (``Rung``,
``ControlSpec``, ``ControllerState``, ``sensors_from_window``,
``target_rung``, ``advance``, ``ControlSLO``, ``DEFAULT_LADDER``) is the
same code; :class:`ControlPlane` steers the port's driver, reading the
newest telemetry row once per control epoch; :func:`run_controlled_fleet`
drives the port's fleet windows (:mod:`.ops.fleet`), its folds plain
tensor calls on the fleet's device, and :func:`certify_controller_mc`
judges the arms with the port's ``wilson_interval``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .adaptive import AdaptiveSpec
from .dissemination.spec import DissemSpec

__all__ = [
    "Rung",
    "DEFAULT_LADDER",
    "ControlSpec",
    "ControllerState",
    "ControlSLO",
    "DEFAULT_SLO",
    "ControlPlane",
    "advance",
    "target_rung",
    "run_controlled_fleet",
    "certify_controller_mc",
]


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rung:
    """One certified knob setting of the protection ladder.

    ``enter_miss_rate`` is the observed probe-miss fraction at or above
    which this rung becomes the target (rungs are checked in order, the
    highest matching wins). ``adaptive=False`` rungs run the static
    failure detector at ``static_mult`` (the clean-network fast path:
    lowest time-to-DEAD, no adaptive machinery); ``adaptive=True`` rungs
    arm the r14 plane with the listed multipliers. ``tuneable_mix`` and
    ``fanout`` steer the dissemination side (the tuneable family's knob
    and the gossip width)."""

    name: str
    enter_miss_rate: float
    tuneable_mix: float
    fanout: int
    adaptive: bool
    min_mult: int = 0
    max_mult: int = 0
    conf_target: int = 4
    static_mult: int = 3

    def adaptive_spec(self) -> AdaptiveSpec:
        if not self.adaptive:
            return AdaptiveSpec()
        return AdaptiveSpec(
            enabled=True, min_mult=self.min_mult, max_mult=self.max_mult,
            conf_target=self.conf_target,
        )

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: The default protection ladder, fast/cheap -> safe/robust. The adaptive
#: knobs of the degraded/storm rungs are seeded from the r16 offline knob
#: map (``adaptive_knob_sweep``, recorded in CONTROL_BENCH_r16.json): at
#: a ~10% ambient floor the fastest knob within the 3% fp budget is
#: min_mult=5 (the r14/r15 certified setting); the storm rung doubles the
#: margin (min_mult=8 — the map's recommendation once the floor or the
#: degraded cohorts push past that band). Thresholds are POST-RESCUE miss fractions — the
#: failed-probe counter counts rounds the indirect relays could not save
#: either, so the signal is small but essentially noise-free in a clean
#: network (measured at n=48, fd_every=1, ping_req_k=2: clean 0.000, 10%
#: uniform floor ~0.007, 15% ~0.026, 20% ~0.07, 25% ~0.13). The degraded
#: threshold sits ABOVE the crash-transient band: a true crash makes
#: ~1/n of probes miss (~0.021 at n=48) until the tombstone spreads, and
#: reacting to one's own detection work as if it were ambient loss would
#: reset the very suspicion doing the detecting (the confounder
#: tests/test_control.py pins; dwell_up=2 covers the band's noise tail).
DEFAULT_LADDER: Tuple[Rung, ...] = (
    Rung("clean", 0.000, tuneable_mix=0.9, fanout=2, adaptive=False,
         static_mult=3),
    Rung("degraded", 0.040, tuneable_mix=0.6, fanout=3, adaptive=True,
         min_mult=5, max_mult=10, conf_target=4),
    Rung("storm", 0.050, tuneable_mix=0.3, fanout=5, adaptive=True,
         min_mult=8, max_mult=16, conf_target=4),
)


@dataclass(frozen=True)
class ControlSpec:
    """Hashable static controller spec: the ladder + the loop constants.

    ``epoch_windows`` — windows per control epoch (sensor reads and
    decisions happen at epoch cadence). ``dwell_up`` / ``dwell_down`` —
    consecutive epochs the target must persist before actuating up /
    down the ladder (anti-flap; down is slower by design: relaxing
    protection early is the expensive mistake). ``max_step`` — rungs per
    actuation (the clamp). ``hysteresis`` — relaxing below the current
    rung requires the miss rate to fall under ``enter_miss_rate *
    hysteresis``. ``blind`` / ``clamped`` select the falsifiability
    controllers (never set in production): blind ignores the sensors
    entirely; unclamped (``clamped=False``) actuates proportionally
    every epoch with no dwell, no hysteresis, and no ladder bounds.
    """

    ladder: Tuple[Rung, ...] = DEFAULT_LADDER
    epoch_windows: int = 4
    dwell_up: int = 2
    dwell_down: int = 4
    max_step: int = 1
    hysteresis: float = 0.6
    strategy: str = "tuneable"
    topology: str = "expander"
    log_keep: int = 128
    blind: bool = False
    clamped: bool = True
    #: r19: second ladder input — ``suspect_rate`` at or above this gate
    #: votes the target ONE rung up (through the ordinary dwell_up, so it
    #: cannot flap); 0.0 keeps the sensor passive (the r16-certified
    #: single-input policy, bit-for-bit).
    suspect_gate: float = 0.0
    #: r21: third ladder input (ROADMAP item 4) — ``spread_lag`` (view
    #: dissemination deficit, see :func:`sensors_from_window`) at or above
    #: this gate votes the target ONE rung up through the same dwell_up
    #: machinery as ``suspect_gate``. 0.0 keeps it passive/logged-only.
    spread_lag_gate: float = 0.0
    #: unclamped-controller proportional gains (fanout / mult per unit
    #: miss rate) — deliberately naive high-gain tuning ("react fast"),
    #: scaled to the post-rescue sensor: a ~0.05 storm signal targets
    #: fanout ~8; see the module docstring
    unclamped_fanout_gain: float = 120.0
    unclamped_mult_gain: float = 60.0

    def __post_init__(self):
        if len(self.ladder) < 2:
            raise ValueError("a control ladder needs >= 2 rungs")
        if any(
            self.ladder[i].enter_miss_rate >= self.ladder[i + 1].enter_miss_rate
            for i in range(len(self.ladder) - 1)
        ):
            raise ValueError("ladder enter_miss_rate must strictly increase")
        if self.ladder[0].enter_miss_rate != 0.0:
            raise ValueError("the base rung must have enter_miss_rate == 0")
        if self.epoch_windows < 1:
            raise ValueError("epoch_windows must be >= 1")
        if self.dwell_up < 1 or self.dwell_down < 1:
            raise ValueError("dwell epochs must be >= 1")
        if self.max_step < 1:
            raise ValueError("max_step must be >= 1")
        if not (0.0 < self.hysteresis <= 1.0):
            raise ValueError("hysteresis must be in (0, 1]")
        if self.suspect_gate < 0.0:
            raise ValueError("suspect_gate must be >= 0 (0 disables it)")
        if self.spread_lag_gate < 0.0:
            raise ValueError("spread_lag_gate must be >= 0 (0 disables it)")

    @staticmethod
    def from_config(config) -> "ControlSpec":
        """Map a ``ClusterConfig.control`` block (or an absent one)."""
        cc = getattr(config, "control", None)
        if cc is None:
            return ControlSpec()
        return ControlSpec(
            epoch_windows=cc.epoch_windows,
            dwell_up=cc.dwell_up,
            dwell_down=cc.dwell_down,
            max_step=cc.max_step,
            hysteresis=cc.hysteresis,
            suspect_gate=getattr(cc, "suspect_gate", 0.0),
            spread_lag_gate=getattr(cc, "spread_lag_gate", 0.0),
        )


# ---------------------------------------------------------------------------
# controller state + the decision rule (ONE spelling for the driver plane
# and the fleet certification harness)
# ---------------------------------------------------------------------------


@dataclass
class ControllerState:
    """Host-side controller memory (checkpointable — see ``state_dict``)."""

    rung: int = 0
    #: whether any actuation has happened yet (arming is knob-passive:
    #: the bit-identity contract — knobs change only on a decision)
    actuated: bool = False
    epoch: int = 0
    windows: int = 0
    pend_target: Optional[int] = None
    pend_count: int = 0
    actuations: int = 0
    stale_epochs: int = 0
    last_sensors: Optional[dict] = None
    log: List[dict] = field(default_factory=list)

    def state_dict(self) -> dict:
        return {
            "rung": self.rung,
            "actuated": self.actuated,
            "epoch": self.epoch,
            "windows": self.windows,
            "pend_target": self.pend_target,
            "pend_count": self.pend_count,
            "actuations": self.actuations,
            "stale_epochs": self.stale_epochs,
            "last_sensors": self.last_sensors,
            "log": list(self.log),
        }

    @staticmethod
    def from_state_dict(d: dict) -> "ControllerState":
        st = ControllerState()
        for k in ("rung", "actuated", "epoch", "windows", "pend_target",
                  "pend_count", "actuations", "stale_epochs", "last_sensors"):
            setattr(st, k, d[k])
        st.log = list(d.get("log", ()))
        return st


def sensors_from_window(ms_sums: dict) -> dict:
    """Host sensor vector from one epoch's summed window counters
    (``fd_probes``/``fd_failed_probes``/``fd_new_suspects`` — the exact
    names of the engines' shared metric series). ``miss_rate`` is the
    round-trip probe miss fraction — the ambient-loss proxy;
    ``suspect_rate`` is new suspicions per probe — the false-positive
    pressure proxy; ``spread_lag`` (r21, ROADMAP item 4) is the view
    dissemination deficit ``convergence_lag``, guarded by
    ``alive_view_fraction > 0``: engines running ``full_metrics=False``
    report that fraction as a constant 0 (the lag column is then a
    constant 1.0, not a measurement), so the sensor stays 0/passive there
    instead of tripping permanently."""
    probes = float(ms_sums.get("fd_probes", 0.0))
    failed = float(ms_sums.get("fd_failed_probes", 0.0))
    suspects = float(ms_sums.get("fd_new_suspects", 0.0))
    alive_frac = float(ms_sums.get("alive_view_fraction", 0.0))
    spread_lag = (
        float(ms_sums.get("convergence_lag", 0.0)) if alive_frac > 0.0 else 0.0
    )
    return {
        "miss_rate": failed / max(probes, 1.0),
        "suspect_rate": suspects / max(probes, 1.0),
        "spread_lag": spread_lag,
        "probes": probes,
    }


def target_rung(spec: ControlSpec, miss_rate: float, current: int) -> int:
    """The ladder rung the observed miss rate calls for, WITH hysteresis:
    stepping below ``current`` additionally requires the miss rate to
    clear ``current``'s threshold by the hysteresis margin."""
    t = 0
    for i, r in enumerate(spec.ladder):
        if miss_rate >= r.enter_miss_rate:
            t = i
    if t < current and miss_rate >= (
        spec.ladder[current].enter_miss_rate * spec.hysteresis
    ):
        t = current
    return t


def _proportional_rung(spec: ControlSpec, miss_rate: float) -> Rung:
    """The UNCLAMPED falsifiability controller's naive proportional law:
    no ladder, no bounds — fanout and suspicion multipliers scale
    linearly with the instantaneous miss rate. Overshoots the cost
    budget under a real storm and re-targets on every quantization
    wiggle; exists to PROVE the clamp/dwell matter (it must fail
    certification)."""
    fanout = 2 + int(round(spec.unclamped_fanout_gain * miss_rate))
    min_mult = 3 + int(round(spec.unclamped_mult_gain * miss_rate))
    adaptive = min_mult > 3
    return Rung(
        name=f"prop-f{fanout}-m{min_mult}",
        enter_miss_rate=0.0,
        tuneable_mix=max(0.0, round(0.9 - 2.5 * miss_rate, 2)),
        fanout=fanout,
        adaptive=adaptive,
        min_mult=min_mult,
        max_mult=2 * min_mult,
        conf_target=4,
        static_mult=min_mult if not adaptive else 3,
    )


def advance(
    spec: ControlSpec,
    st: ControllerState,
    sensors: Optional[dict],
    tick: Optional[int] = None,
) -> Optional[Rung]:
    """One control epoch of the decision rule — THE policy spelling,
    shared by the driver :class:`ControlPlane` and the fleet
    certification harness. Mutates ``st`` (epoch counters, dwell state,
    decision log) and returns the :class:`Rung` to actuate, or None.

    ``sensors=None`` is SENSOR DROPOUT (empty/stale telemetry ring): the
    controller holds the last safe setting and logs the dropout — it
    never acts on missing evidence."""
    st.epoch += 1

    def log(action: str, reason: str, **extra):
        st.log.append({
            "epoch": st.epoch, "tick": tick, "rung": st.rung,
            "rung_name": (
                spec.ladder[st.rung].name
                if st.rung < len(spec.ladder) else "proportional"
            ),
            "action": action, "reason": reason,
            "miss_rate": (
                round(sensors["miss_rate"], 4) if sensors else None
            ),
            "suspect_rate": (
                round(sensors.get("suspect_rate", 0.0), 4)
                if sensors else None
            ),
            "spread_lag": (
                round(sensors.get("spread_lag", 0.0), 4)
                if sensors else None
            ),
            **extra,
        })
        if len(st.log) > spec.log_keep:
            del st.log[: len(st.log) - spec.log_keep]

    if sensors is None:
        st.stale_epochs += 1
        st.pend_target, st.pend_count = None, 0
        log("hold", "sensors_stale")
        return None
    st.last_sensors = dict(sensors)
    miss = spec.ladder[0].enter_miss_rate if spec.blind else sensors["miss_rate"]

    if not spec.clamped:
        rung = _proportional_rung(spec, miss)
        prev = st.log[-1].get("knobs") if st.log else None
        knobs = rung.as_dict()
        if knobs != prev:
            st.actuated = True
            st.actuations += 1
            log("actuate", "proportional", knobs=knobs)
            return rung
        log("hold", "proportional_unchanged", knobs=knobs)
        return None

    target = target_rung(spec, miss, st.rung)
    if spec.blind:
        # never reads the ring: the target is forever the base rung
        target = 0 if not st.actuated else st.rung
    elif (
        spec.suspect_gate > 0.0
        and sensors.get("suspect_rate", 0.0) >= spec.suspect_gate
        and target <= st.rung
    ):
        # r19 second ladder input: false-positive pressure (suspect_rate)
        # votes the target ONE rung up. Up-only by construction — it can
        # never lower a miss-rate target — and the vote still rides the
        # ordinary dwell_up/pend machinery, so a transient suspicion burst
        # cannot flap a certified rung (test_control pins this).
        target = min(st.rung + 1, len(spec.ladder) - 1)
    elif (
        spec.spread_lag_gate > 0.0
        and sensors.get("spread_lag", 0.0) >= spec.spread_lag_gate
        and target <= st.rung
    ):
        # r21 third ladder input (ROADMAP item 4): dissemination spread
        # lag votes ONE rung up, same up-only + dwell_up construction as
        # the suspect gate (elif: the gates are votes for the SAME
        # one-rung step, never additive).
        target = min(st.rung + 1, len(spec.ladder) - 1)
    if target == st.rung:
        st.pend_target, st.pend_count = None, 0
        log("hold", "at_target")
        return None
    if st.pend_target == target:
        st.pend_count += 1
    else:
        st.pend_target, st.pend_count = target, 1
    need = spec.dwell_up if target > st.rung else spec.dwell_down
    if st.pend_count < need:
        log("dwell", "waiting", target=target, pending=st.pend_count,
            need=need)
        return None
    step = max(-spec.max_step, min(spec.max_step, target - st.rung))
    st.rung += step
    st.actuated = True
    st.actuations += 1
    if st.rung == target:
        st.pend_target, st.pend_count = None, 0
    else:
        # clamped mid-move: keep the dwell satisfied so the next epoch
        # continues the walk one rung at a time
        st.pend_count = need
    rung = spec.ladder[st.rung]
    log("actuate", "step", target=target, step=step, knobs=rung.as_dict())
    return rung


# ---------------------------------------------------------------------------
# the driver-attached plane
# ---------------------------------------------------------------------------


class ControlPlane:
    """The closed loop on one :class:`..sim.SimDriver`.

    Arming requires (and auto-arms) the telemetry plane — the ring is the
    sensor. Every ``epoch_windows`` windows the plane reads the newest
    ring row (ONE coalesced device readback at epoch cadence — the same
    sync-point contract as a monitor poll), runs :func:`advance`, and on
    a decision applies the target rung through the driver's live-swap
    actuators (``set_dissemination`` / ``set_protocol_knobs`` /
    ``set_adaptive``). With no decision the driver's trajectory is
    bit-identical to an unarmed one. ``snapshot()`` backs the monitor's
    ``GET /control``."""

    def __init__(self, driver, spec: Optional[ControlSpec] = None,
                 config=None):
        from .config import ClusterConfig

        if spec is None:
            spec = (
                ControlSpec.from_config(config)
                if isinstance(config, ClusterConfig) else ControlSpec()
            )
        if spec.blind or not spec.clamped:
            raise ValueError(
                "the blind/unclamped falsifiability controllers exist only "
                "for certification (certify_controller_mc) — refusing to "
                "arm one on a live driver"
            )
        self.driver = driver
        self.spec = spec
        self.state = ControllerState()
        self._ring_windows_seen = 0
        self._telemetry = driver.arm_telemetry(config=config)
        self._telemetry.bus.publish(
            "control", "control_armed", tick=driver._host_tick,
            ladder=[r.name for r in spec.ladder],
            epoch_windows=spec.epoch_windows,
        )

    # -- the loop ------------------------------------------------------------
    def on_window(self) -> None:
        """Called by the driver after each window (under the driver
        lock). Cheap counter bump except at epoch boundaries."""
        self.state.windows += 1
        if self.state.windows % self.spec.epoch_windows:
            return
        self._run_epoch()

    def _run_epoch(self) -> None:
        d = self.driver
        sensors = self._read_sensors()
        rung = advance(self.spec, self.state, sensors, tick=d._host_tick)
        if rung is not None:
            self._apply_rung(rung)
            self._telemetry.bus.publish(
                "control", "actuated", tick=d._host_tick,
                rung=rung.name, fanout=rung.fanout,
                tuneable_mix=rung.tuneable_mix,
                adaptive=rung.adaptive, min_mult=rung.min_mult,
            )

    def _read_sensors(self) -> Optional[dict]:
        """Newest ring row -> sensor vector; None on dropout (empty ring
        or no new window since the last epoch — the stale-sensor hold)."""
        ring = self._telemetry.ring
        if ring.windows == 0 or ring.windows == self._ring_windows_seen:
            return None
        self._ring_windows_seen = ring.windows
        vals = ring.latest_values()  # the one epoch-cadence readback
        self.driver._note_readback(1)
        if not vals:
            return None
        return sensors_from_window(vals)

    def _apply_rung(self, rung: Rung) -> None:
        d = self.driver
        d.set_dissemination(
            strategy=self.spec.strategy, topology=self.spec.topology,
            tuneable_mix=rung.tuneable_mix,
        )
        d.set_protocol_knobs(
            fanout=rung.fanout,
            suspicion_mult=None if rung.adaptive else rung.static_mult,
        )
        if rung.adaptive:
            d.set_adaptive(rung.adaptive_spec())
        else:
            d.set_adaptive(None)

    # -- surfaces ------------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``GET /control`` view: spec summary + controller state +
        the bounded decision log (newest last). Host values only."""
        st = self.state
        rung = (
            self.spec.ladder[st.rung]
            if st.rung < len(self.spec.ladder) else None
        )
        return {
            "armed": True,
            "epoch_windows": self.spec.epoch_windows,
            "dwell_up": self.spec.dwell_up,
            "dwell_down": self.spec.dwell_down,
            "max_step": self.spec.max_step,
            "hysteresis": self.spec.hysteresis,
            "ladder": [r.as_dict() for r in self.spec.ladder],
            "rung": st.rung,
            "rung_name": rung.name if rung else None,
            "actuated": st.actuated,
            "epoch": st.epoch,
            "windows": st.windows,
            "actuations": st.actuations,
            "stale_epochs": st.stale_epochs,
            "pending": {"target": st.pend_target, "count": st.pend_count},
            "last_sensors": st.last_sensors,
            "decision_log": list(st.log),
        }

    def state_dict(self) -> dict:
        return self.state.state_dict()

    def load_state_dict(self, d: dict) -> None:
        """Restore controller memory (the checkpoint/restore seam). An
        ACTUATED state re-applies its rung's knobs — the restored driver
        was constructed with its own params, not the actuated ones."""
        self.state = ControllerState.from_state_dict(d)
        self._ring_windows_seen = 0  # the restored ring is a new timeline
        if self.state.actuated and self.state.rung < len(self.spec.ladder):
            self._apply_rung(self.spec.ladder[self.state.rung])

    def reset_for_restore(self) -> None:
        """Restore from a checkpoint carrying NO controller state: the
        abandoned branch's memory (rung, dwell, decision log) must not
        survive the timeline switch — same invariant as every other
        plane's restore. If that branch had ACTUATED, the knobs re-base
        to the ladder's base rung so rung and params agree again
        (construction params are not recoverable once an actuation
        swapped them); a never-actuated plane stays knob-passive."""
        was_actuated = self.state.actuated
        self.state = ControllerState()
        self._ring_windows_seen = 0  # the restored ring is a new timeline
        if was_actuated:
            self._apply_rung(self.spec.ladder[0])


# ---------------------------------------------------------------------------
# fleet certification harness (the r15 MC service closed over the loop)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ControlSLO:
    """The joint per-scenario SLO of the controller certification.

    Deadlines are in ticks: detection from the crash, spread from each
    rumor's injection (clean phase / shifted phase separately — the
    shifted network is allowed more). ``cost_budget`` bounds the mean
    gossip messages per member-tick over the WHOLE run — the envelope
    that makes permanent max-protection (and the unclamped controller's
    overshoot) a certification failure, exactly as in production."""

    detect_deadline: int = 32
    spread_clean_deadline: int = 40
    spread_shift_deadline: int = 32
    cost_budget: float = 2.6


DEFAULT_SLO = ControlSLO()


def _fleet_params(n: int, rung: Rung, spec: ControlSpec):
    """The dense fleet-profile params of one knob setting (the static
    program a rung compiles to)."""
    from .ops.state import SimParams

    return SimParams(
        capacity=n, fanout=rung.fanout, fd_every=1, sync_every=40,
        suspicion_mult=rung.static_mult, rumor_slots=8, seed_rows=(0,),
        full_metrics=False, quiet_gates=False,
        dissem=DissemSpec(
            strategy=spec.strategy, topology=spec.topology,
            tuneable_mix=rung.tuneable_mix,
        ),
        adaptive=rung.adaptive_spec(),
    )


def run_controlled_fleet(
    shifting,
    arm: str = "controlled",
    *,
    n: int = 48,
    n_seeds: int = 512,
    window: int = 8,
    base_seed: int = 0,
    spec: Optional[ControlSpec] = None,
    slo: ControlSLO = DEFAULT_SLO,
    static_rung: Optional[int] = None,
    vary_storm_pct=None,
    conf: float = 0.95,
    device="cuda",
    draws=None,
) -> dict:
    """Drive ``n_seeds`` scenarios of one shifting-conditions cell
    (:class:`.chaos.shifting.ShiftingScenario`) through fleet windows
    with one of the certification arms at the wheel:

    * ``"controlled"`` — the clamped/dwelled ladder controller;
    * ``"static"`` — rung ``static_rung`` held for the whole run;
    * ``"blind"`` — the telemetry-blind falsifiability controller;
    * ``"unclamped"`` — the proportional falsifiability controller.

    The controller observes the FLEET-AGGREGATE sensors (knobs are
    properties of the params, shared across the scenario axis, so the
    shared policy acts on the fleet mean — one scalar readback per epoch).
    ``spec.epoch_windows`` is honored as by :class:`ControlPlane`: the
    decision rule runs every ``epoch_windows``-th fleet window on the
    newest window's sensors. A knob change swaps the fleet window for the
    new setting's and — as ``SimDriver.set_adaptive`` does — resets the
    adaptive evidence planes; engine state and rumor planes carry over.

    Per-scenario crash rows vary through :class:`.ops.fleet.FleetVary`
    (and optionally the storm floor, via ``vary_storm_pct``); rumor origins
    vary per scenario. ``draws`` is the fleet's draw source: a generator on
    ``device`` (default: one seeded ``1000 + base_seed``), or a callable
    ``(n_ticks, params) -> [(fd, round), ...]`` with [S, ...] draws — the
    params are the window's, whose fanout the rung sets. All SLO folds stay
    on the device; the [S] readbacks happen once at the end."""
    from .adaptive import init_adaptive_state
    from .ops import fleet as FL
    from .ops import state as S

    spec = spec or ControlSpec(epoch_windows=1)
    if arm == "blind":
        spec = dataclasses.replace(spec, blind=True)
    elif arm == "unclamped":
        spec = dataclasses.replace(spec, clamped=False)
    elif arm == "static":
        if static_rung is None or not 0 <= static_rung < len(spec.ladder):
            raise ValueError("static arm needs static_rung in the ladder")
    elif arm != "controlled":
        raise ValueError(f"unknown arm {arm!r}")

    scen = shifting.scenario
    horizon = scen.horizon
    crash_at = shifting.crash_at
    seeds = base_seed + np.arange(n_seeds)
    # per-scenario crash rows: a block disjoint from the watch cohort,
    # the seed row, and each other SLO subject
    forbidden = set(shifting.watch_rows) | {0}
    crash_pool = [r for r in range(12, n) if r not in forbidden][:8]
    crash_rows = np.asarray([crash_pool[s % len(crash_pool)] for s in range(n_seeds)])
    vary = FL.FleetVary(
        crash_rows=crash_rows,
        loss_pct=(
            np.asarray(vary_storm_pct, np.float32)[np.arange(n_seeds) % len(vary_storm_pct)]
            if vary_storm_pct is not None else None
        ),
    )

    init_rung = spec.ladder[static_rung if arm == "static" else 0]
    cur_rung = init_rung
    ctl = ControllerState(rung=(static_rung if arm == "static" else 0))

    # window and params caches, keyed on the knob setting
    progs: Dict[tuple, object] = {}
    params_cache: Dict[tuple, object] = {}

    def _key_of(r: Rung):
        return (r.tuneable_mix, r.fanout, r.adaptive, r.min_mult, r.max_mult, r.conf_target, r.static_mult)

    def _params(r: Rung):
        k = _key_of(r)
        if k not in params_cache:
            params_cache[k] = _fleet_params(n, r, spec)
        return params_cache[k]

    def _prog(r: Rung, k_ticks: int):
        k = (_key_of(r), k_ticks)
        if k not in progs:
            p = _params(r)
            progs[k] = FL.make_fleet_adaptive_run(p, k_ticks) if r.adaptive else FL.make_fleet_run(p, k_ticks)
        return progs[k]

    source = FL.fleet_generator(1000 + base_seed, device) if draws is None else draws

    def _window_draws(r: Rung, k_ticks: int):
        return source if isinstance(source, torch.Generator) else source(k_ticks, _params(r))

    st0 = S.init_state(_params(init_rung), n, warm=True, device=device)
    fs = FL.fleet_broadcast(st0, n_seeds)
    ad = FL.fleet_broadcast(init_adaptive_state(n, device=device), n_seeds) if init_rung.adaptive else None
    tl = FL.fleet_timeline(scen, S, dense_links=True, horizon=horizon, vary=vary)

    rumor_plan = dict((t, slot) for slot, t in shifting.rumors)
    origins = {slot: (seeds * 37 + 11 * (slot + 1)) % n for slot, _t in shifting.rumors}
    hits = {slot: torch.full((n_seeds,), -1, dtype=torch.int32, device=device) for slot, _t in shifting.rumors}
    fp_max = torch.zeros((n_seeds,), dtype=torch.int32, device=device)
    det_tick = torch.full((n_seeds,), -1, dtype=torch.int32, device=device)
    cost_sum = torch.zeros((n_seeds,), dtype=torch.float32, device=device)
    watch_mask = torch.zeros((n,), dtype=torch.bool, device=device)
    watch_mask[list(shifting.watch_rows)] = True
    crash_rows_dev = torch.as_tensor(crash_rows, dtype=torch.int64, device=device)

    boundaries = set(tl.boundaries()) | set(rumor_plan)
    knob_log: List[dict] = []
    t = 0
    windows_run = 0
    while t < horizon:
        fs, _labels = tl.apply_due(fs, t)
        if t in rumor_plan:
            slot = rumor_plan[t]
            fs = FL.fleet_inject_rumor(S, fs, slot, origins[slot])
        stop = min([horizon, t + window] + [b for b in boundaries if b > t])
        k_ticks = stop - t
        src = _window_draws(cur_rung, k_ticks)
        if cur_rung.adaptive:
            fs, ad, ms, _w = _prog(cur_rung, k_ticks)(fs, ad, src)
        else:
            fs, ms, _w = _prog(cur_rung, k_ticks)(fs, src)
        for slot in hits:
            hits[slot] = FL.fold_first_full_coverage(hits[slot], ms["rumor_coverage"][:, :, slot], t)
        # fleet-aggregate sensor sums and the per-scenario cost
        probes, failed, suspects = (ms[k].sum() for k in ("fd_probes", "fd_failed_probes", "fd_new_suspects"))
        cost_sum = cost_sum + ms["gossip_msgs"].sum(dim=1).to(torch.float32)
        t = stop
        fp_max = torch.maximum(fp_max, FL.fleet_false_dead(fs, watch_mask))
        if t > crash_at:
            det = FL.fleet_crash_detected_varied(fs, crash_rows_dev)
            det_tick = torch.where((det_tick < 0) & det, t, det_tick).to(torch.int32)
        windows_run += 1
        if arm != "static" and windows_run % spec.epoch_windows == 0:
            # the control epoch: fleet-mean sensors from the NEWEST window
            # (as ControlPlane reads only the newest ring row), the shared
            # decision rule, a window swap on actuation
            sensors = sensors_from_window({
                "fd_probes": float(probes),
                "fd_failed_probes": float(failed),
                "fd_new_suspects": float(suspects),
            })
            new_rung = advance(spec, ctl, sensors, tick=t)
            if new_rung is not None and _key_of(new_rung) != _key_of(cur_rung):
                knob_log.append({
                    "tick": t, "from": cur_rung.name, "to": new_rung.name,
                    "miss_rate": round(sensors["miss_rate"], 4),
                })
                was_adaptive = cur_rung.adaptive
                cur_rung = new_rung
                if cur_rung.adaptive:
                    # set_adaptive semantics: arming OR changing knobs
                    # starts fresh evidence
                    ad = FL.fleet_broadcast(init_adaptive_state(n, device=device), n_seeds)
                elif was_adaptive:
                    ad = None

    fs, _labels = tl.apply_due(fs, horizon)
    # THE readbacks: one [S] vector per fold
    fp_np = fp_max.cpu().numpy()
    det_np = det_tick.cpu().numpy()
    cost_np = cost_sum.cpu().numpy() / float(horizon * n)
    hit_np = {slot: v.cpu().numpy() for slot, v in hits.items()}

    inject = dict((slot, t) for slot, t in shifting.rumors)
    shift_at = shifting.shift_at
    ok_detect = (det_np >= 0) & (det_np - crash_at <= slo.detect_deadline)
    ok_fp = fp_np == 0
    ok_cost = cost_np <= slo.cost_budget
    ok_spread = np.ones((n_seeds,), bool)
    spread_stats = {}
    for slot, t0 in inject.items():
        deadline = (
            slo.spread_clean_deadline if t0 < shift_at
            else slo.spread_shift_deadline
        )
        h = hit_np[slot]
        ok = (h >= 0) & (h - t0 <= deadline)
        ok_spread &= ok
        lat = np.sort(h[h >= 0] - t0)
        spread_stats[str(slot)] = {
            "inject_tick": int(t0),
            "deadline": int(deadline),
            "finished": int((h >= 0).sum()),
            "met": int(ok.sum()),
            "p50": float(np.median(lat)) if lat.size else None,
            "max": int(lat[-1]) if lat.size else None,
        }
    ok_all = ok_detect & ok_fp & ok_cost & ok_spread
    k = int(ok_all.sum())
    from .dissemination.certify import MC_MIN_SAMPLES, wilson_interval

    wil = wilson_interval(k, n_seeds, conf)
    det_lat = np.sort(det_np[det_np >= 0] - crash_at)
    return {
        "arm": arm + (f"-{spec.ladder[static_rung].name}"
                      if arm == "static" else ""),
        "scenario": shifting.name,
        "n": n,
        "n_seeds": n_seeds,
        "sample_size": n_seeds,
        "verdict_kind": (
            "monte-carlo" if n_seeds >= MC_MIN_SAMPLES else "spot-check"
        ),
        "window_ticks": window,
        "epoch_windows": spec.epoch_windows,
        "epoch_ticks": spec.epoch_windows * window,
        "slo": dataclasses.asdict(slo),
        "slo_met": k,
        "p_slo": round(k / n_seeds, 6),
        "slo_wilson": [round(wil[0], 6), round(wil[1], 6)],
        "interval_method": f"Wilson {conf:.0%} on P(all SLOs met)",
        "fail_detect": int((~ok_detect).sum()),
        "fail_fp": int((~ok_fp).sum()),
        "fail_cost": int((~ok_cost).sum()),
        "fail_spread": int((~ok_spread).sum()),
        "false_dead_scenarios": int((fp_np > 0).sum()),
        "detect_latency_p50": (
            float(np.median(det_lat)) if det_lat.size else None
        ),
        "detect_latency_max": int(det_lat[-1]) if det_lat.size else None,
        "cost_mean": round(float(cost_np.mean()), 4),
        "cost_max": round(float(cost_np.max()), 4),
        "spread": spread_stats,
        "actuations": ctl.actuations,
        "stale_epochs": ctl.stale_epochs,
        "knob_changes": knob_log,
        "decision_log_tail": ctl.log[-16:],
        "crash_rows_varied": sorted(set(crash_rows.tolist())),
        "storm_pct_varied": (
            sorted({float(p) for p in np.asarray(vary_storm_pct)})
            if vary_storm_pct is not None else None
        ),
    }


def certify_controller_mc(
    cells: Optional[Sequence] = None,
    n: int = 48,
    n_seeds: int = 512,
    window: int = 8,
    base_seed: int = 0,
    spec: Optional[ControlSpec] = None,
    slo: ControlSLO = DEFAULT_SLO,
    vary_storm_pct=None,
    log=None,
    bus=None,
    device="cuda",
    draws=None,
) -> dict:
    """The r16 controller certification matrix: for every shifting-
    conditions cell, run the CONTROLLED arm, every STATIC rung of its own
    ladder, and both falsifiability controllers, ≥``n_seeds`` seeds each
    (one fleet program per arm per knob setting).

    A cell CERTIFIES when (a) the controlled arm's Wilson lower bound on
    P(all SLOs met) strictly exceeds every static arm's Wilson upper
    bound — the controller beats every setting it is allowed to pick,
    so the VALUE IS IN THE SWITCHING — (b) the controlled arm records
    zero false-DEAD, and (c) both falsifiability arms FAIL the same
    criteria (seeded falsifiability, the r12/r14 discipline: a
    certification that cannot fail proves nothing). Returns the record
    ``benchmarks/config15_control.py`` writes into
    CONTROL_BENCH_r16.json.

    The default certification spec pins ``epoch_windows=1``: one
    ``window``-tick fleet window per control epoch (the harness honors
    the knob; the record's ``epoch_ticks`` states the exercised
    cadence). A driver-attached :class:`ControlPlane` counts DRIVER
    windows instead, so its epoch duration is caller-dependent —
    certify at the cadence you deploy. ``device`` and ``draws`` go to
    every :func:`run_controlled_fleet` call (``draws`` then a callable
    ``(cell, arm, static_rung) -> draw source``)."""
    from .chaos import shifting as _shifting

    spec = spec or ControlSpec(epoch_windows=1)
    if cells is None:
        cells = [b(n=n) for b in _shifting.SHIFTING_FAMILY]
    entries = []
    for cell in cells:
        arms = {}

        def _run(arm, **kw):
            rec = run_controlled_fleet(
                cell, arm, n=n, n_seeds=n_seeds, window=window,
                base_seed=base_seed, spec=spec, slo=slo,
                vary_storm_pct=vary_storm_pct, device=device,
                draws=None if draws is None else draws(cell, arm, kw.get("static_rung")), **kw,
            )
            arms[rec["arm"]] = rec
            if log:
                log(
                    f"{cell.name}/{rec['arm']}: P(SLO) {rec['p_slo']} "
                    f"wilson {rec['slo_wilson']} fp {rec['false_dead_scenarios']} "
                    f"cost {rec['cost_mean']} "
                    f"fails d/f/c/s {rec['fail_detect']}/{rec['fail_fp']}/"
                    f"{rec['fail_cost']}/{rec['fail_spread']}"
                )
            return rec

        controlled = _run("controlled")
        statics = [
            _run("static", static_rung=i) for i in range(len(spec.ladder))
        ]
        blind = _run("blind")
        unclamped = _run("unclamped")

        max_static_hi = max(r["slo_wilson"][1] for r in statics)

        def _would_certify(rec):
            return (
                rec["slo_wilson"][0] > max_static_hi
                and rec["false_dead_scenarios"] == 0
            )

        certified = _would_certify(controlled)
        blind_fails = not _would_certify(blind)
        unclamped_fails = not _would_certify(unclamped)
        entry = {
            "cell": cell.name,
            "phases": list(map(list, cell.phases)),
            "arms": arms,
            "controlled_wilson": controlled["slo_wilson"],
            "best_static_wilson_hi": round(max_static_hi, 6),
            "separation": round(
                controlled["slo_wilson"][0] - max_static_hi, 6
            ),
            "controlled_false_dead": controlled["false_dead_scenarios"],
            "blind_fails_certification": blind_fails,
            "unclamped_fails_certification": unclamped_fails,
            "unclamped_actuations": unclamped["actuations"],
            "controlled_actuations": controlled["actuations"],
            "certified": bool(
                certified and blind_fails and unclamped_fails
            ),
        }
        entries.append(entry)
        if log:
            log(
                f"{cell.name}: separation {entry['separation']} "
                f"blind_fails={blind_fails} unclamped_fails={unclamped_fails} "
                f"{'CERTIFIED' if entry['certified'] else 'VIOLATION'}"
            )
        if bus is not None:
            bus.publish(
                "control", "controller_certified",
                cell=cell.name, certified=entry["certified"],
                controlled_wilson=entry["controlled_wilson"],
                best_static_wilson_hi=entry["best_static_wilson_hi"],
            )
    return {
        "n": n,
        "n_seeds": n_seeds,
        "window_ticks": window,
        "slo": dataclasses.asdict(slo),
        "ladder": [r.as_dict() for r in spec.ladder],
        "epoch_windows": spec.epoch_windows,
        "epoch_ticks": spec.epoch_windows * window,
        "dwell_up": spec.dwell_up,
        "dwell_down": spec.dwell_down,
        "hysteresis": spec.hysteresis,
        "entries": entries,
        "n_certified": sum(1 for e in entries if e["certified"]),
        "n_cells": len(entries),
        "ok": all(e["certified"] for e in entries),
    }
