"""Scenario compilation + the driver runner, over every engine. A port of
the JAX package's ``chaos/engine.py``:

* :func:`schedule` expands a :class:`.events.Scenario` into the ordered
  action list (copied as it is);
* :class:`StateTimeline` replays it onto a device-resident state through
  the engine's ops module (``ops.state``, ``ops.sparse`` or ``ops.pview``
  — the same mutator names). The port's mutators update the [N, N]
  planes in place, so the loss-storm stash is a ``clone()`` of the loss
  plane, and a scalar stash goes back through ``set_uniform_loss`` as a
  0-d tensor, never read to the host;
* :class:`DriverChaosRunner` / :func:`run_driver_scenario` drive a
  ``SimDriver`` through a scenario with the sentinels armed — zero
  device→host transfers while it steps; the final report (or a
  :meth:`DriverChaosRunner.snapshot`) is the one sync point. The report's
  ``backend`` names the torch device type (``"cuda"`` or ``"cpu"``).

With the driver's telemetry plane armed, the scenario's lifecycle and
applied events go onto its bus, and the final report feeds the plane
(detection latencies, the outcome record, a flight dump on a violation).

``run_driver_scenario(trace=True)`` arms the causal trace plane on the
scenario's crashed rows and attaches their detection span trees to the
report (``trace_spans``).

:class:`EmulatorChaosRunner` (copied as it is) replays the same schedule
onto the scalar engine's :class:`..transport.emulator.NetworkEmulator`
instances (crash = total network isolation, the reference testlib idiom
for killing a node without stopping its process).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

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
    ScenarioError,
    SlowEpoch,
    SlowMember,
    ZoneOutage,
)
from .sentinels import build_spec, sentinel_report


def _state_capacity(st) -> int:
    """Member capacity N of a serial OR fleet-stacked state: the up mask's
    LAST axis. ``st.capacity`` reads ``up.shape[0]``, which is the SCENARIO
    count S on an [S, N]-stacked fleet state — closures that enumerate
    "everyone" from it would silently touch only the first S rows (or, when
    S > N, mask the bug entirely behind clamped scatter writes)."""
    return st.up.shape[-1]


@dataclass(frozen=True)
class _Step:
    """One scheduled timeline action (engine-agnostic)."""

    tick: int
    seq: int
    kind: str
    label: str
    payload: tuple


def _window(ev, end_attr: str):
    end = getattr(ev, end_attr, None)
    return ev.at, (float("inf") if end is None else end)


def _validate_degraded_composition(scenario: Scenario) -> None:
    """The r14 degraded family's start/end handlers WRITE the loss/delay
    planes they touch; compositions whose teardown would clobber another
    active event's links are refused LOUDLY here (both runners route
    through :func:`schedule`) instead of silently mis-modelling:

    * two ``SlowMember`` events overlapping in time — each covers every
      link touching its cohort, so the earlier ``until`` zeroes delay on
      the cross-cohort links the later event still owns;
    * overlapping ``AsymmetricLoss``/``FlakyObserver`` events with
      intersecting cohorts — the shared links' loss is last-writer-wins;
    * a degraded event overlapping an active ``Partition`` or ``LinkFlap``
      window — the degraded writes would overwrite (and its teardown
      lift) the block plane on shared links. ``LossStorm`` composes on the
      device engines (the storm stash replays loss mutations) and is
      checked separately by the emulator runner, whose single
      default-settings slot cannot stash.
    """
    from .events import DEGRADED_EVENT_TYPES

    deg = [e for e in scenario.events if isinstance(e, DEGRADED_EVENT_TYPES)]
    for i in range(len(deg)):
        a0, a1 = _window(deg[i], "until")
        for j in range(i + 1, len(deg)):
            b0, b1 = _window(deg[j], "until")
            if not (a0 < b1 and b0 < a1):
                continue
            both_slow = isinstance(deg[i], SlowMember) and isinstance(
                deg[j], SlowMember
            )
            if both_slow or (set(deg[i].rows) & set(deg[j].rows)):
                raise ScenarioError(
                    f"{type(deg[i]).__name__}{list(deg[i].rows)} and "
                    f"{type(deg[j]).__name__}{list(deg[j].rows)} overlap in "
                    "time on shared links — the earlier teardown would "
                    "clobber the later event's plane; stagger the windows"
                )
    blocks = [
        (ev, _window(ev, "heal_at")) for ev in scenario.events
        if isinstance(ev, Partition)
    ] + [
        (ev, _window(ev, "until")) for ev in scenario.events
        if isinstance(ev, (LinkFlap, ZoneOutage))
    ]
    for d in deg:
        d0, d1 = _window(d, "until")
        for bev, (b0, b1) in blocks:
            if d0 < b1 and b0 < d1:
                raise ScenarioError(
                    f"{type(d).__name__}{list(d.rows)} overlaps an active "
                    f"{type(bev).__name__}: the degraded family's loss/delay "
                    "writes would overwrite (and its teardown lift) the "
                    "block plane on shared links — stagger the events"
                )
    # r18 SlowEpoch writes the WHOLE delay plane; any overlapping SlowMember
    # (or second SlowEpoch) shares links with it and the earlier teardown
    # zeroes delay the later event still owns — same refusal as above
    slows = [e for e in scenario.events
             if isinstance(e, (SlowEpoch, SlowMember))]
    for i in range(len(slows)):
        if not isinstance(slows[i], SlowEpoch):
            continue
        a0, a1 = _window(slows[i], "until")
        for j in range(len(slows)):
            if j == i:
                continue
            b0, b1 = _window(slows[j], "until")
            if a0 < b1 and b0 < a1:
                raise ScenarioError(
                    f"SlowEpoch@{slows[i].at} overlaps "
                    f"{type(slows[j]).__name__}@{slows[j].at} in time — both "
                    "write the delay plane and the earlier teardown would "
                    "zero the later event's links; stagger the windows"
                )


def _restart_actions(scenario: Scenario):
    """Every (tick, rows) restart action, whether from a ``Restart`` event
    or a ``ChurnStorm`` wave — shared by composition checks and budgets."""
    out = []
    for ev in scenario.events:
        if isinstance(ev, Restart):
            out.append((ev.at, ev.rows))
        elif isinstance(ev, ChurnStorm):
            for _, r_tick, chunk in ev.wave_schedule():
                out.append((r_tick, chunk))
    return out


def _validate_refute_composition(scenario: Scenario) -> None:
    """A restart inside an active ``DroppedRefute`` window on the same row
    would have its fresh-identity epoch bump squashed back by the drop (the
    drop cannot tell a refute's inc bump from a restart's epoch bump) —
    refuse the composition loudly instead of silently un-restarting."""
    drops = [e for e in scenario.events if isinstance(e, DroppedRefute)]
    if not drops:
        return
    for t, rows in _restart_actions(scenario):
        for d in drops:
            hit = set(rows) & set(d.rows)
            if hit and d.at <= t < d.until:
                raise ScenarioError(
                    f"restart of rows {sorted(hit)} at tick {t} lands inside "
                    f"DroppedRefute{list(d.rows)}@[{d.at},{d.until}) — the "
                    "drop would squash the fresh identity's epoch bump; "
                    "restart after the drop window ends"
                )


def schedule(scenario: Scenario, horizon: Optional[int] = None) -> List[_Step]:
    """Expand a scenario into the ordered (tick, seq) action list both the
    state and the emulator runners replay. Flap toggles materialize here;
    a flap always ends CLEAR (a trailing up-toggle at ``until``). Degraded
    events (r14) that would compose silently-wrong with block events are
    refused at compile time (:func:`_validate_degraded_composition`)."""
    _validate_degraded_composition(scenario)
    _validate_refute_composition(scenario)
    steps: List[_Step] = []
    seq = itertools.count()
    for ev in scenario.events:
        if isinstance(ev, Partition):
            steps.append(_Step(ev.at, next(seq), "partition_block",
                               f"partition@{ev.at}", (ev.groups,)))
            if ev.heal_at is not None:
                steps.append(_Step(ev.heal_at, next(seq), "partition_heal",
                                   f"heal@{ev.heal_at}", (ev.groups,)))
        elif isinstance(ev, LossStorm):
            steps.append(_Step(ev.at, next(seq), "storm_start",
                               f"storm({ev.pct}%)@{ev.at}", (ev.pct,)))
            if ev.until is not None:
                steps.append(_Step(ev.until, next(seq), "storm_end",
                                   f"storm_end@{ev.until}", ()))
        elif isinstance(ev, LinkFlap):
            until = ev.until if ev.until is not None else horizon
            if until is None:
                raise ScenarioError(
                    "LinkFlap without `until` needs a scenario horizon"
                )
            for k, t in enumerate(range(ev.at, until, ev.period)):
                kind = "flap_down" if k % 2 == 0 else "flap_up"
                steps.append(_Step(t, next(seq), kind, f"{kind}@{t}", (ev.pairs,)))
            steps.append(_Step(until, next(seq), "flap_up",
                               f"flap_end@{until}", (ev.pairs,)))
        elif isinstance(ev, SlowMember):
            steps.append(_Step(ev.at, next(seq), "slow_start",
                               f"slow({ev.mean_delay_ticks}t){list(ev.rows)}@{ev.at}",
                               (ev.rows, ev.mean_delay_ticks)))
            if ev.until is not None:
                steps.append(_Step(ev.until, next(seq), "slow_end",
                                   f"slow_end@{ev.until}", (ev.rows,)))
        elif isinstance(ev, (AsymmetricLoss, FlakyObserver)):
            direction = getattr(ev, "direction", "out")
            steps.append(_Step(ev.at, next(seq), "asym_start",
                               f"asym({ev.pct}%/{direction}){list(ev.rows)}@{ev.at}",
                               (ev.rows, ev.pct, direction)))
            if ev.until is not None:
                steps.append(_Step(ev.until, next(seq), "asym_end",
                                   f"asym_end@{ev.until}", (ev.rows, direction)))
        elif isinstance(ev, Crash):
            steps.append(_Step(ev.at, next(seq), "crash",
                               f"crash{list(ev.rows)}@{ev.at}", (ev.rows,)))
        elif isinstance(ev, Restart):
            steps.append(_Step(ev.at, next(seq), "restart",
                               f"restart{list(ev.rows)}@{ev.at}",
                               (ev.rows, ev.seed_rows)))
        elif isinstance(ev, ZoneOutage):
            steps.append(_Step(ev.at, next(seq), "zone_down",
                               f"zone_down{list(ev.rows)}@{ev.at}", (ev.rows,)))
            if ev.until is not None:
                steps.append(_Step(ev.until, next(seq), "zone_up",
                                   f"zone_up{list(ev.rows)}@{ev.until}",
                                   (ev.rows,)))
        elif isinstance(ev, ChurnStorm):
            # a churn storm compiles PURELY into the existing crash/restart
            # vocabulary — every runner (device timeline, driver identity
            # bookkeeping, emulator isolation) handles it with zero new kinds
            for w, (c_tick, r_tick, chunk) in enumerate(ev.wave_schedule()):
                steps.append(_Step(c_tick, next(seq), "crash",
                                   f"churn_crash[w{w}]{list(chunk)}@{c_tick}",
                                   (chunk,)))
                steps.append(_Step(r_tick, next(seq), "restart",
                                   f"churn_restart[w{w}]{list(chunk)}@{r_tick}",
                                   (chunk, ev.seed_rows)))
        elif isinstance(ev, SlowEpoch):
            steps.append(_Step(ev.at, next(seq), "slow_epoch_start",
                               f"slow_epoch({ev.mean_delay_ticks}t)@{ev.at}",
                               (ev.mean_delay_ticks,)))
            steps.append(_Step(ev.until, next(seq), "slow_epoch_end",
                               f"slow_epoch_end@{ev.until}", ()))
        elif isinstance(ev, DroppedRefute):
            # per-tick expansion (the LinkFlap precedent): a refute bumped
            # during tick t cannot spread before t+1 (the refute phase runs
            # AFTER gossip/sync inside a tick), so squashing at every
            # between-window seam in [at, until) suppresses every refute
            # before it disseminates
            for t in range(ev.at, ev.until):
                steps.append(_Step(t, next(seq), "refute_drop",
                                   f"refute_drop{list(ev.rows)}@{t}",
                                   (ev.rows,)))
    steps.sort(key=lambda s: (s.tick, s.seq))
    return steps


# ---------------------------------------------------------------------------
# device-state timeline (dense / sparse / sharded)
# ---------------------------------------------------------------------------


class StateTimeline:
    """Replays the schedule onto a device-resident state via the engine's ops
    module (``ops.state``, ``ops.sparse`` or ``ops.pview`` — the same
    mutator surface).

    Loss-storm semantics on dense links: the pre-storm loss matrix is
    stashed (an independent clone — the mutators and the tick write the
    live plane in place) and the storm applies a FLOOR (existing blocks
    stay blocked). Link mutations made while the storm is active are recorded
    and replayed on top of the restored matrix at storm end, so a partition
    that started mid-storm survives it and one healed mid-storm stays
    healed.

    ``on_restart(state, row, seed_rows) -> state`` lets a driver hook its
    member-identity bookkeeping into Restart events; default is the raw
    ``ops.join_row``.
    """

    def __init__(
        self,
        scenario: Scenario,
        ops,
        dense_links: bool,
        on_restart: Optional[Callable] = None,
        horizon: Optional[int] = None,
    ):
        self._ops = ops
        self._on_restart = on_restart
        self._steps = schedule(scenario, horizon=horizon)
        self._i = 0
        self._storm_stash = None  # pre-storm loss plane (an independent clone)
        self._storm_pct = 0.0  # active storm's floor, as a probability
        self._storm_replay: List[Callable] = []
        # group-partition-capable engines (pview's part_id/part_loss model)
        # run Partition events without an [N, N] link plane; per-PAIR flaps
        # still need one
        group_parts = getattr(ops, "GROUP_PARTITIONS", False)
        engine_label = {
            "state": "dense", "sparse": "sparse", "pview": "pview",
        }.get(getattr(ops, "__name__", "?").rsplit(".", 1)[-1],
              getattr(ops, "__name__", "?"))
        for s in self._steps:
            if s.kind == "refute_drop" and not hasattr(ops, "drop_refutes"):
                # name the offending event AND the engine: a multi-event
                # production dump that trips this (e.g. during whatif) must
                # point at the one step that can't run here, not issue a
                # bare capability error
                raise ScenarioError(
                    f"event {s.label!r} (DroppedRefute) needs the dense "
                    "[N, N] view/changed_at planes (ops.drop_refutes), "
                    f"which the {engine_label!r} engine does not expose — "
                    "run the scenario on the dense engine"
                )
        if not dense_links:
            for s in self._steps:
                if s.kind in ("partition_block", "partition_heal",
                              "zone_down", "zone_up") and not group_parts:
                    raise ScenarioError(
                        f"{s.kind} needs per-link (dense) links; this engine "
                        "runs scalar uniform loss — construct the driver "
                        "with dense_links=True"
                    )
                if s.kind in ("flap_down", "flap_up"):
                    raise ScenarioError(
                        f"{s.kind} needs per-link (dense) links; this engine "
                        "has no per-pair link plane"
                    )
                if s.kind in ("slow_start", "slow_end", "asym_start",
                              "asym_end", "slow_epoch_start",
                              "slow_epoch_end"):
                    raise ScenarioError(
                        f"{s.kind} (loss-adversarial family) needs "
                        "per-link (dense) links; this engine has no "
                        "per-pair link plane — run these scenarios on the "
                        "dense engine (dense_links=True)"
                    )

    def next_tick(self) -> Optional[int]:
        return self._steps[self._i].tick if self._i < len(self._steps) else None

    def boundaries(self) -> List[int]:
        return sorted({s.tick for s in self._steps})

    def apply_due(self, state, tick: int):
        """Apply every action scheduled at or before ``tick``; returns
        (state, labels). Pure device ops — nothing is read back."""
        labels: List[str] = []
        while self._i < len(self._steps) and self._steps[self._i].tick <= tick:
            step = self._steps[self._i]
            self._i += 1
            state = self._apply(state, step)
            labels.append(step.label)
        return state, labels

    # -- one action ----------------------------------------------------------
    def _apply(self, state, step: _Step):
        ops = self._ops
        if step.kind == "partition_block":
            (groups,) = step.payload

            def fn(st, groups=groups, clear=0.0):
                for a, b in itertools.combinations(groups, 2):
                    st = ops.block_partition(st, list(a), list(b))
                return st

        elif step.kind == "partition_heal":
            (groups,) = step.payload

            def fn(st, groups=groups, clear=0.0):
                for a, b in itertools.combinations(groups, 2):
                    st = self._heal_pair(st, list(a), list(b), clear)
                return st

        elif step.kind == "flap_down":
            (pairs,) = step.payload

            def fn(st, pairs=pairs, clear=0.0):
                for s, d in pairs:
                    st = ops.set_link_loss(st, [s], [d], 1.0)
                return st

        elif step.kind == "flap_up":
            (pairs,) = step.payload

            def fn(st, pairs=pairs, clear=0.0):
                for s, d in pairs:
                    st = ops.set_link_loss(st, [s], [d], clear)
                return st

        elif step.kind == "slow_start":
            rows, delay = step.payload

            def fn(st, rows=rows, delay=delay):
                # exponential-mean delay on every link touching the cohort
                # (both directions) — ops.set_link_delay validates that the
                # engine's delay rings are armed (params.delay_slots > 0)
                n = _state_capacity(st)
                everyone = list(range(n))
                st = ops.set_link_delay(st, everyone, list(rows), float(delay))
                return ops.set_link_delay(st, list(rows), everyone, float(delay))

        elif step.kind == "slow_end":
            (rows,) = step.payload

            def fn(st, rows=rows):
                n = _state_capacity(st)
                everyone = list(range(n))
                st = ops.set_link_delay(st, everyone, list(rows), 0.0)
                return ops.set_link_delay(st, list(rows), everyone, 0.0)

        elif step.kind == "asym_start":
            rows, pct, direction = step.payload

            def fn(st, rows=rows, p=pct / 100.0, d=direction, clear=None):
                # ``clear`` is the storm-replay convention's floor: an asym
                # write landing DURING a LossStorm must not punch a
                # below-floor hole in the uniform storm (the LossStorm
                # contract) — apply max(pct, floor); the clean variant
                # replays on the restored matrix at storm end
                eff = p if clear is None else max(p, clear)
                n = _state_capacity(st)
                everyone = list(range(n))
                if d in ("in", "both"):
                    st = ops.set_link_loss(st, everyone, list(rows), eff)
                if d in ("out", "both"):
                    st = ops.set_link_loss(st, list(rows), everyone, eff)
                return st

        elif step.kind == "asym_end":
            rows, direction = step.payload

            def fn(st, rows=rows, d=direction, clear=0.0):
                n = _state_capacity(st)
                everyone = list(range(n))
                if d in ("in", "both"):
                    st = ops.set_link_loss(st, everyone, list(rows), clear)
                if d in ("out", "both"):
                    st = ops.set_link_loss(st, list(rows), everyone, clear)
                return st

        elif step.kind == "crash":
            (rows,) = step.payload

            def fn(st, rows=rows):
                return ops.crash_rows(st, list(rows))

        elif step.kind == "restart":
            rows, seed_rows = step.payload

            def fn(st, rows=rows, seed_rows=seed_rows):
                for r in rows:
                    if self._on_restart is not None:
                        st = self._on_restart(st, r, list(seed_rows))
                    else:
                        st = ops.join_row(st, r, list(seed_rows))
                return st

        elif step.kind == "zone_down":
            (rows,) = step.payload

            def fn(st, rows=rows, clear=0.0):
                rest = [r for r in range(_state_capacity(st)) if r not in set(rows)]
                if not rest:
                    return st
                return ops.block_partition(st, list(rows), rest)

        elif step.kind == "zone_up":
            (rows,) = step.payload

            def fn(st, rows=rows, clear=0.0):
                rest = [r for r in range(_state_capacity(st)) if r not in set(rows)]
                if not rest:
                    return st
                return self._heal_pair(st, list(rows), rest, clear)

        elif step.kind == "slow_epoch_start":
            (delay,) = step.payload

            def fn(st, delay=delay):
                everyone = list(range(_state_capacity(st)))
                return ops.set_link_delay(st, everyone, everyone, float(delay))

        elif step.kind == "slow_epoch_end":

            def fn(st):
                everyone = list(range(_state_capacity(st)))
                return ops.set_link_delay(st, everyone, everyone, 0.0)

        elif step.kind == "refute_drop":
            (rows,) = step.payload

            def fn(st, rows=rows):
                return ops.drop_refutes(st, list(rows))

        elif step.kind == "storm_start":
            (pct,) = step.payload
            return self._storm_start(state, pct)
        elif step.kind == "storm_end":
            return self._storm_end(state)
        else:  # pragma: no cover - schedule() only emits the kinds above
            raise ScenarioError(f"unknown timeline action {step.kind!r}")

        if self._storm_stash is not None and step.kind in (
            "partition_block", "partition_heal", "flap_down", "flap_up",
            "asym_start", "asym_end", "zone_down", "zone_up",
        ):
            # the CLEAN variant replays on the restored matrix at storm end;
            # during the storm, links that clear only drop to the storm
            # FLOOR (a mid-storm heal must not punch a loss-0 hole in the
            # uniform storm the LossStorm contract promises)
            self._storm_replay.append(fn)
            return fn(state, clear=self._storm_pct)
        return fn(state)

    def _heal_pair(self, st, a, b, clear):
        """Heal the directed block between row groups ``a`` and ``b``. Routes
        through ``ops.heal_partition_pair`` when the ops module names the
        operation (the fleet layer intercepts it to vary per-scenario
        partition assignments); the fallback is the value-identical legacy
        spelling, two directed ``set_link_loss`` writes."""
        heal = getattr(self._ops, "heal_partition_pair", None)
        if heal is not None:
            return heal(st, list(a), list(b), clear)
        st = self._ops.set_link_loss(st, list(a), list(b), clear)
        return self._ops.set_link_loss(st, list(b), list(a), clear)

    def _storm_start(self, state, pct: float):
        if self._storm_stash is not None:
            raise ScenarioError("overlapping LossStorms are not supported")
        # an independent copy: the mutators and the tick write the live
        # plane in place, and the storm floors it right below
        self._storm_stash = state.loss.clone()
        self._storm_pct = pct / 100.0
        self._storm_replay = []
        return self._ops.set_uniform_loss(state, pct / 100.0, floor=True)

    def _storm_end(self, state):
        if self._storm_stash is None:
            raise ScenarioError("storm_end without an active storm")
        loss = self._storm_stash
        self._storm_stash = None
        if loss.dim() == 0:
            # pass the device scalar through (a float() here would be a
            # device→host transfer mid-scenario)
            state = self._ops.set_uniform_loss(state, loss)
        else:
            from ..ops.state import _roundtrip

            state = state.replace(loss=loss, fetch_rt=_roundtrip(loss))
        for fn in self._storm_replay:
            state = fn(state)
        self._storm_replay = []
        return state


# ---------------------------------------------------------------------------
# SimDriver runner (dense / sparse / mesh-sharded)
# ---------------------------------------------------------------------------


class DriverChaosRunner:
    """One scenario armed on one :class:`..sim.SimDriver`.

    Arming registers the runner on the driver (``driver._chaos``) so
    ``health_snapshot()`` and the monitor's ``GET /chaos`` can report live
    sentinel state; :meth:`run` drives the scenario to its horizon. The
    stepping loop performs NO device→host transfers: fault injection and
    sentinel checks are pure device ops, and the one readback happens in the
    final report (or whenever a monitor poll explicitly asks)."""

    def __init__(self, driver, scenario: Scenario, config=None,
                 sentinels: bool = True, trace: bool = False):
        self.driver = driver
        self.scenario = scenario
        self._untraced_crash_rows: List[int] = []
        if trace:
            crash_rows = []
            for ev in scenario.events:
                if isinstance(ev, (Crash, ChurnStorm)):
                    crash_rows.extend(int(r) for r in ev.rows)
            uniq = tuple(dict.fromkeys(crash_rows))
            if driver._trace is None:
                # the crashed rows are the members whose causal story the
                # report needs: trace them (up to TraceConfig.tracers) so
                # the sentinel outcomes resolve to span trees
                from ..config import ClusterConfig, TraceConfig

                tcfg = config if isinstance(config, (ClusterConfig, TraceConfig)) else None
                trace_cfg = tcfg.trace if isinstance(tcfg, ClusterConfig) else (tcfg or TraceConfig())
                driver.arm_trace(config=tcfg, tracer_rows=uniq[:trace_cfg.tracers] or None)
            # no silent caps: crashed rows the armed spec does not trace are
            # named in the report — a missing span tree reads "untraced",
            # never "no detection activity"
            self._untraced_crash_rows = [r for r in uniq if r not in driver._trace.spec.tracer_rows]
        with driver._lock:
            self.t0 = driver.state.tick  # a host int: no readback
            arm_state = driver.state
        self.spec = build_spec(scenario, driver.params, config=config)
        self.timeline = StateTimeline(
            scenario,
            driver._ops,
            dense_links=driver._dense_links,
            on_restart=self._restart,
            horizon=self.spec.horizon,
        )
        # sentinel init + reduce through the engine interface: dense/
        # sparse run the shared view-plane core, pview its table-edge twin
        eng = driver._eng
        # on a mesh each rank baselines its own rows
        with driver._mesh_ctx():
            self._sent = eng.sentinel_init(arm_state, self.spec) if sentinels else None
        self._spec_dev = self.spec.device_arrays(self.t0, device=driver.device)
        self._check = eng.sentinel_reduce
        self.events_applied: List[Tuple[int, str]] = []
        self.rel_tick = 0
        self.max_window = 32
        self.done = False
        self.last_report: Optional[dict] = None
        driver._chaos = self
        # armed telemetry (r8): scenario lifecycle + applied fault events
        # flow onto the unified event bus, and a violated final report
        # triggers a flight-recorder dump (see _publish / run)
        self._publish("scenario_armed", scenario=scenario.name,
                      horizon=self.spec.horizon)

    def _publish(self, kind: str, **fields) -> None:
        plane = getattr(self.driver, "_telemetry", None)
        if plane is not None:
            plane.bus.publish("chaos", kind, tick=self.driver._host_tick, **fields)

    # -- Restart with driver identity bookkeeping (no device reads) ----------
    def _restart(self, state, row: int, seed_rows):
        d = self.driver
        state = d._ops.join_row(state, row, seed_rows)
        from ..models.member import Member
        from ..sim.driver import row_address

        d.members[row] = Member(
            id=f"sim-{d._next_member_ordinal}", address=row_address(row)
        )
        d._next_member_ordinal += 1
        return state

    # -- the scenario loop ----------------------------------------------------
    def run(self, max_window: int = 32) -> dict:
        """Drive the scenario to its horizon; returns the structured report.
        Windows split at event boundaries and sentinel-check ticks, capped at
        ``max_window`` ticks each (the jit cache keys on window length, so a
        scenario reuses a handful of compiled window programs)."""
        d = self.driver
        self.max_window = max_window  # recorded for incident reconstruction
        horizon = self.spec.horizon
        check_every = self.spec.check_interval
        next_check = check_every if self._sent is not None else horizon + 1
        t = 0
        while True:
            # events due at t apply BEFORE the sentinel sample at t (a
            # restart's convergence obligation must be judged against the
            # post-restart view, and the same-tick heal against the healed
            # links)
            labels = self._apply_due(t)
            self.events_applied.extend((t, lab) for lab in labels)
            for lab in labels:
                self._publish("event_applied", event=lab, rel_tick=t)
            if self._sent is not None and (t >= next_check or t >= horizon):
                self._run_check()
                next_check = t + check_every
            if t >= horizon:
                break
            stops = [horizon, t + max_window, next_check]
            nt = self.timeline.next_tick()
            if nt is not None:
                stops.append(nt)
            stop = min(s for s in stops if s > t)
            d.step(stop - t)
            t = stop
            self.rel_tick = t
        self.done = True
        report = self.report()  # THE sync point: one coalesced readback
        self._attach_trace(report)
        self.last_report = report
        plane = getattr(d, "_telemetry", None)
        if plane is not None:
            # detection latencies -> histogram, completion -> bus; any
            # violation writes the flight-recorder post-mortem artifact
            dump = plane.ingest_chaos_report(report)
            if dump is not None:
                report["flight_dump"] = dump
        return report

    def _attach_trace(self, report: dict) -> None:
        """Resolve the sentinel outcomes to sewn span trees: every traced
        crash subject gets its probe-miss → suspect → DEAD lineage on its
        detection entry (a passing detection's tree explains its latency),
        and the report carries the map under ``trace_spans``. One ring
        readback, at the final report only."""
        tplane = getattr(self.driver, "_trace", None)
        if tplane is None:
            return
        from ..trace import spans as _spans

        events = tplane.events()
        trees = {}
        for det in (report.get("sentinels") or {}).get("detections", ()):
            row = det["row"]
            if row in tplane.spec.tracer_rows:
                tree = _spans.detection_tree(events, row)
                if tree is not None:
                    det["span_tree"] = tree
                    trees[int(row)] = tree
        report["trace_spans"] = trees
        if self._untraced_crash_rows:
            report["untraced_crash_rows"] = list(self._untraced_crash_rows)

    def _apply_due(self, t: int) -> list:
        """Apply the events due at ``t`` through the driver's host-mutation
        path (on a mesh: the gathered state, each rank keeping its rows);
        returns their labels. Nothing due, nothing touched."""
        d = self.driver
        nt = self.timeline.next_tick()
        if nt is None or nt > t:
            return []
        box = {}

        def fn(state):
            state, box["labels"] = self.timeline.apply_due(state, t)
            return state

        with d._lock:
            d._apply(fn)
        return box["labels"]

    def _run_check(self) -> None:
        d = self.driver
        # on a mesh each rank checks its rows and the check combines them
        with d._lock, d._mesh_ctx():
            self._sent = self._check(d.state, self._sent, self._spec_dev)

    # -- reporting (the readback sites) ---------------------------------------
    def report(self) -> dict:
        """Structured scenario report. Reading it is a sync point (the
        sentinel accumulators come to host here)."""
        import os

        events = list(self.events_applied)  # monitor thread vs sim appends
        rep = {
            "scenario": self.scenario.name,
            "armed": not self.done,
            "t0": self.t0,
            "horizon": self.spec.horizon,
            "ticks_run": self.rel_tick,
            # provenance stamps (the r13 backend-stamp rule, applied to the
            # chaos surface): which backend ran the scenario, on how many
            # host CPUs, over which absolute tick range
            "backend": self.driver.device.type,
            "host_cpus": os.cpu_count(),
            "tick_range": [self.t0, self.t0 + self.rel_tick],
            "events_applied": [{"tick": t, "event": lab} for t, lab in events],
        }
        if self._sent is not None:
            with self.driver._lock:
                sent_host = {k: v.cpu().numpy() for k, v in self._sent.items()}
            self.driver._note_readback(1)
            rep["sentinels"] = sentinel_report(
                sent_host, self.spec, final_tick=self.rel_tick
            )
            rep["violations"] = rep["sentinels"]["violations"]
            rep["ok"] = rep["sentinels"]["ok"]
        else:
            rep["sentinels"] = None
            rep["violations"] = 0
            rep["ok"] = True
        return rep

    def snapshot(self) -> dict:
        """Monitor-facing view (``GET /chaos`` / health_snapshot chaos
        section): the full report plus progress — safe to call from the
        monitor thread while the sim thread steps."""
        return self.report()


def run_driver_scenario(
    driver,
    scenario: Scenario,
    *,
    config=None,
    sentinels: bool = True,
    max_window: int = 32,
    trace: bool = False,
) -> dict:
    """Arm ``scenario`` on ``driver`` and run it to the horizon (the
    function behind ``SimDriver.run_scenario``). ``trace=True`` arms the
    causal trace plane on the crashed rows."""
    runner = DriverChaosRunner(
        driver, scenario, config=config, sentinels=sentinels, trace=trace
    )
    return runner.run(max_window=max_window)


class EmulatorChaosRunner:
    """Replays the same scenario schedule onto per-node
    :class:`..transport.emulator.NetworkEmulator` instances.

    ``emulators[i]`` and ``addresses[i]`` are row ``i``'s emulator and wire
    address (the scenario's integer rows index this list). The caller owns
    time: call :meth:`advance_to` with the current scenario-relative tick
    (``elapsed_seconds / tick_interval`` for wall-clock engines) and every
    due action is applied. Crash maps to total network isolation and
    Restart to unblocking — the reference testlib's member-kill idiom for a
    process that stays alive."""

    def __init__(self, scenario: Scenario, emulators: Sequence,
                 addresses: Sequence[str], horizon: Optional[int] = None):
        if len(emulators) != len(addresses):
            raise ScenarioError("emulators and addresses must align by row")
        scenario.validate_rows(len(emulators))  # groups/pairs/rows/seeds
        # r14: the emulator's ONE default-outbound-settings slot per node
        # cannot stash/restore the way the device StateTimeline's storm
        # stash does, so a LossStorm overlapping a degraded event would
        # clobber whichever wrote the slot last — refuse loudly (the device
        # engines compose these correctly; run composed scenarios there)
        from .events import DEGRADED_EVENT_TYPES

        for ev in scenario.events:
            if isinstance(ev, DroppedRefute):
                raise ScenarioError(
                    "DroppedRefute manipulates the device view planes "
                    "(refute squashing); the emulator runner's members own "
                    "their real gossip state — run the scenario on the "
                    "dense engine"
                )
        deg = [e for e in scenario.events
               if isinstance(e, (SlowEpoch,) + DEGRADED_EVENT_TYPES)]
        storms = [e for e in scenario.events if isinstance(e, LossStorm)]
        for d in deg:
            d0, d1 = _window(d, "until")
            for s in storms:
                s0, s1 = _window(s, "until")
                if d0 < s1 and s0 < d1:
                    raise ScenarioError(
                        f"{type(d).__name__}{list(getattr(d, 'rows', ()))} "
                        "overlaps a LossStorm: the emulator runner's single "
                        "default-outbound slot cannot hold both — stagger "
                        "them, or run the composed scenario on a device "
                        "engine"
                    )
        self.scenario = scenario
        self._emus = list(emulators)
        self._addrs = list(addresses)
        self._steps = schedule(scenario, horizon=horizon)
        self._i = 0
        self.events_applied: List[Tuple[int, str]] = []

    def next_tick(self) -> Optional[int]:
        return self._steps[self._i].tick if self._i < len(self._steps) else None

    def advance_to(self, tick: int) -> List[str]:
        labels: List[str] = []
        while self._i < len(self._steps) and self._steps[self._i].tick <= tick:
            step = self._steps[self._i]
            self._i += 1
            self._apply(step)
            self.events_applied.append((step.tick, step.label))
            labels.append(step.label)
        return labels

    def report(self) -> dict:
        return {
            "scenario": self.scenario.name,
            "engine": "emulator",
            "events_applied": [
                {"tick": t, "event": lab} for t, lab in self.events_applied
            ],
            "pending": len(self._steps) - self._i,
        }

    def _apply(self, step: _Step) -> None:
        if step.kind == "partition_block":
            (groups,) = step.payload
            for a, b in itertools.combinations(groups, 2):
                self._block(a, b)
        elif step.kind == "partition_heal":
            (groups,) = step.payload
            for a, b in itertools.combinations(groups, 2):
                self._unblock(a, b)
        elif step.kind == "storm_start":
            (pct,) = step.payload
            for emu in self._emus:
                emu.set_default_outbound_settings(pct, 0.0)
        elif step.kind == "storm_end":
            for emu in self._emus:
                emu.set_default_outbound_settings(0.0, 0.0)
        elif step.kind == "flap_down":
            (pairs,) = step.payload
            for s, d in pairs:
                self._emus[s].block_outbound([self._addrs[d]])
        elif step.kind == "flap_up":
            (pairs,) = step.payload
            for s, d in pairs:
                self._emus[s].unblock_outbound([self._addrs[d]])
        elif step.kind == "slow_start":
            # NOTE (r14): the emulator maps degraded events COARSELY — a
            # per-destination entry overrides the node's default settings
            # entirely (loss AND delay travel together), so a flaky
            # member's sends toward a concurrently slow member carry the
            # slow delay at full reliability. Intersecting-cohort overlaps
            # are refused by schedule(); disjoint-cohort residue is this
            # documented approximation. The device engines model the loss
            # and delay planes independently.
            rows, delay = step.payload
            for r in rows:
                self._emus[r].set_default_outbound_settings(0.0, delay)
            for i, emu in enumerate(self._emus):
                if i not in rows:
                    for r in rows:
                        emu.set_outbound_settings(self._addrs[r], 0.0, delay)
        elif step.kind == "slow_end":
            (rows,) = step.payload
            for r in rows:
                self._emus[r].set_default_outbound_settings(0.0, 0.0)
            for i, emu in enumerate(self._emus):
                if i not in rows:
                    for r in rows:
                        emu.unblock_outbound([self._addrs[r]])
        elif step.kind == "asym_start":
            rows, pct, direction = step.payload
            if direction in ("in", "both"):
                for i, emu in enumerate(self._emus):
                    if i not in rows:
                        for r in rows:
                            emu.set_outbound_settings(self._addrs[r], pct, 0.0)
            if direction in ("out", "both"):
                for r in rows:
                    self._emus[r].set_default_outbound_settings(pct, 0.0)
        elif step.kind == "asym_end":
            rows, direction = step.payload
            if direction in ("in", "both"):
                for i, emu in enumerate(self._emus):
                    if i not in rows:
                        for r in rows:
                            emu.unblock_outbound([self._addrs[r]])
            if direction in ("out", "both"):
                for r in rows:
                    self._emus[r].set_default_outbound_settings(0.0, 0.0)
        elif step.kind == "zone_down":
            (rows,) = step.payload
            rest = [i for i in range(len(self._emus)) if i not in set(rows)]
            if rest:
                self._block(list(rows), rest)
        elif step.kind == "zone_up":
            (rows,) = step.payload
            rest = [i for i in range(len(self._emus)) if i not in set(rows)]
            if rest:
                self._unblock(list(rows), rest)
        elif step.kind == "slow_epoch_start":
            (delay,) = step.payload
            for emu in self._emus:
                emu.set_default_outbound_settings(0.0, delay)
        elif step.kind == "slow_epoch_end":
            for emu in self._emus:
                emu.set_default_outbound_settings(0.0, 0.0)
        elif step.kind == "crash":
            (rows,) = step.payload
            for r in rows:
                self._emus[r].block_all_outbound()
                self._emus[r].block_all_inbound()
        elif step.kind == "restart":
            rows, _seeds = step.payload
            for r in rows:
                self._emus[r].unblock_all_outbound()
                self._emus[r].unblock_all_inbound()

    def _block(self, a, b) -> None:
        addrs_a = [self._addrs[r] for r in a]
        addrs_b = [self._addrs[r] for r in b]
        for r in a:
            self._emus[r].block_outbound(addrs_b)
            self._emus[r].block_inbound(addrs_b)
        for r in b:
            self._emus[r].block_outbound(addrs_a)
            self._emus[r].block_inbound(addrs_a)

    def _unblock(self, a, b) -> None:
        addrs_a = [self._addrs[r] for r in a]
        addrs_b = [self._addrs[r] for r in b]
        for r in a:
            self._emus[r].unblock_outbound(addrs_b)
            self._emus[r].unblock_inbound(addrs_b)
        for r in b:
            self._emus[r].unblock_outbound(addrs_a)
            self._emus[r].unblock_inbound(addrs_a)
