"""The chaos scenario DSL: declarative fault events on a tick timeline. A
copy of the JAX package's ``chaos/events.py`` (it imports no JAX), so that
the port's scenarios are its own.

Event ticks are RELATIVE to the tick at which the scenario is armed (so one
scenario file replays against any engine, at any point of a run). An event
with ``at=t`` is applied *between windows*, after the simulation has
completed tick ``t`` and before tick ``t+1`` runs — the same seam every host
mutator (``ops.state`` / ``ops.sparse`` / the ``NetworkEmulator`` controls)
already uses, so injection never perturbs an in-flight window.

The fault vocabulary mirrors the reference testlib's ``NetworkEmulator``
surface (loss percent, block/unblock, per-link settings) plus process-level
churn (crash = hard kill, restart = fresh identity on the same row — the
reference's restart-on-same-address-is-a-new-member rule).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


class ScenarioError(ValueError):
    """A scenario that cannot be compiled (bad timeline / engine mismatch)."""


def _rows(seq) -> Tuple[int, ...]:
    return tuple(int(r) for r in seq)


@dataclass(frozen=True)
class Partition:
    """Symmetric network partition between member groups.

    ``groups`` is a sequence of row groups; traffic between any two distinct
    groups is blocked from tick ``at`` until ``heal_at`` (None = never heals
    inside the scenario). Rows in no group keep all their links — they are
    the bridge/bystander cohort the false-DEAD sentinel watches.
    """

    groups: Sequence[Sequence[int]]
    at: int
    heal_at: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "groups", tuple(_rows(g) for g in self.groups))
        if len(self.groups) < 2 or any(not g for g in self.groups):
            raise ScenarioError("Partition needs >= 2 non-empty groups")
        if self.heal_at is not None and self.heal_at <= self.at:
            raise ScenarioError("Partition.heal_at must be > at")


@dataclass(frozen=True)
class LossStorm:
    """Uniform loss floor of ``pct`` percent on EVERY link in [at, until).

    On dense-link engines the storm raises each link to at least ``pct``
    (existing blocks stay blocked); at ``until`` the pre-storm link matrix is
    restored and any partition/flap mutations made during the storm are
    replayed on top. On scalar-loss (lean sparse) engines the storm swaps the
    uniform loss scalar. On the emulator engine it becomes the default
    outbound settings.
    """

    pct: float
    at: int
    until: Optional[int] = None

    def __post_init__(self):
        if not (0.0 <= self.pct <= 100.0):
            raise ScenarioError("LossStorm.pct must be in [0, 100]")
        if self.until is not None and self.until <= self.at:
            raise ScenarioError("LossStorm.until must be > at")


@dataclass(frozen=True)
class LinkFlap:
    """Directed links that toggle blocked/clear every ``period`` ticks.

    ``pairs`` are (src, dst) row pairs; the link is DOWN during even
    half-periods starting at ``at`` and restored to loss 0 during odd ones,
    until ``until`` (required bounded — an unbounded flap has no horizon),
    ending clear.
    """

    pairs: Sequence[Tuple[int, int]]
    period: int
    at: int = 0
    until: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "pairs", tuple((int(s), int(d)) for s, d in self.pairs)
        )
        if not self.pairs:
            raise ScenarioError("LinkFlap needs at least one (src, dst) pair")
        if self.period < 1:
            raise ScenarioError("LinkFlap.period must be >= 1")
        if self.until is not None and self.until <= self.at:
            raise ScenarioError("LinkFlap.until must be > at")


@dataclass(frozen=True)
class SlowMember:
    """Members that are SLOW but alive (r14): every link to/from ``rows``
    gains ``mean_delay_ticks`` of exponential-mean delay in [at, until).

    The Lifeguard false-positive archetype: a slow member's probe round
    trips start missing the static ping timeout, so a static detector
    declares it DEAD while it is still running. Needs the dense-link
    engine with ``params.delay_slots > 0`` (the delay model); ``until``
    clears the touched links back to zero delay."""

    rows: Sequence[int]
    mean_delay_ticks: float
    at: int
    until: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        if not self.rows:
            raise ScenarioError("SlowMember needs at least one row")
        if self.mean_delay_ticks <= 0:
            raise ScenarioError("SlowMember.mean_delay_ticks must be > 0")
        if self.until is not None and self.until <= self.at:
            raise ScenarioError("SlowMember.until must be > at")


@dataclass(frozen=True)
class AsymmetricLoss:
    """Lossy-but-alive members (r14): directed loss floor of ``pct``
    percent on the links INTO ``rows`` (``direction="in"``), OUT of them
    (``"out"``), or both, in [at, until).

    ``"in"`` starves the member of probes and ACK requests — observers'
    probes fail and the member looks dead from outside. ``"out"`` makes
    the member a degraded OBSERVER — its own probes fail, so a static
    detector lets it spray false suspicions of healthy peers. Dense-link
    engines only; ``until`` clears the touched links (to the active
    storm's floor while one is running, like every link mutation)."""

    rows: Sequence[int]
    pct: float
    at: int
    until: Optional[int] = None
    direction: str = "in"

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        if not self.rows:
            raise ScenarioError("AsymmetricLoss needs at least one row")
        if not (0.0 < self.pct <= 100.0):
            raise ScenarioError("AsymmetricLoss.pct must be in (0, 100]")
        if self.direction not in ("in", "out", "both"):
            raise ScenarioError(
                "AsymmetricLoss.direction must be 'in', 'out', or 'both'"
            )
        if self.until is not None and self.until <= self.at:
            raise ScenarioError("AsymmetricLoss.until must be > at")


@dataclass(frozen=True)
class FlakyObserver:
    """A degraded observer (r14): outbound loss floor of ``pct`` percent on
    every link OUT of ``rows`` in [at, until) — sugar for
    ``AsymmetricLoss(direction="out")``, named for the failure mode it
    exercises: the member whose own probes keep failing and who therefore
    accuses healthy peers. The adaptive plane's local-health score is the
    defense (its lh climbs, stretching the suspicions it ages)."""

    rows: Sequence[int]
    pct: float
    at: int
    until: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        if not self.rows:
            raise ScenarioError("FlakyObserver needs at least one row")
        if not (0.0 < self.pct <= 100.0):
            raise ScenarioError("FlakyObserver.pct must be in (0, 100]")
        if self.until is not None and self.until <= self.at:
            raise ScenarioError("FlakyObserver.until must be > at")


@dataclass(frozen=True)
class Crash:
    """Hard-kill ``rows`` at tick ``at`` (no goodbye; peers must detect)."""

    rows: Sequence[int]
    at: int

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        if not self.rows:
            raise ScenarioError("Crash needs at least one row")


@dataclass(frozen=True)
class Restart:
    """Re-activate ``rows`` at tick ``at`` as FRESH identities (epoch bump —
    the restart-is-a-new-member rule), bootstrapping via ``seed_rows``."""

    rows: Sequence[int]
    at: int
    seed_rows: Sequence[int] = (0,)

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        object.__setattr__(self, "seed_rows", _rows(self.seed_rows))
        if not self.rows:
            raise ScenarioError("Restart needs at least one row")


@dataclass(frozen=True)
class ZoneOutage:
    """Correlated group failure (r18): the whole ``rows`` zone loses
    connectivity to EVERY other member in [at, until) — a rack/AZ cut.

    Unlike :class:`Partition` the complement is implicit ("everyone else"),
    so the event compiles against any capacity without naming the rest of
    the cluster; there are no bystanders. Rides the dense link planes, and
    the pview ``GROUP_PARTITIONS`` capability on the 1M-member engine.
    ``until`` (None = never heals inside the scenario) restores the cut
    links to clear (or the active storm's floor, like every heal).
    """

    rows: Sequence[int]
    at: int
    until: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        if not self.rows:
            raise ScenarioError("ZoneOutage needs at least one row")
        if self.until is not None and self.until <= self.at:
            raise ScenarioError("ZoneOutage.until must be > at")


@dataclass(frozen=True)
class ChurnStorm:
    """Batched crash/restart waves (r18): ``rows`` split into ``waves``
    contiguous chunks; chunk ``k`` hard-crashes at ``at + k*period`` and
    restarts (fresh identity, epoch bump) ``down_for`` ticks later via
    ``seed_rows`` — the scalecube testlib rolling-churn archetype.

    Waves may overlap (``down_for > period`` keeps several chunks down at
    once), which is why ``seed_rows`` must be disjoint from ``rows``: the
    bootstrap contact has to stay up through the whole storm.
    """

    rows: Sequence[int]
    at: int
    waves: int = 2
    period: int = 8
    down_for: int = 4
    seed_rows: Sequence[int] = (0,)

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        object.__setattr__(self, "seed_rows", _rows(self.seed_rows))
        if not self.rows:
            raise ScenarioError("ChurnStorm needs at least one row")
        if self.waves < 1:
            raise ScenarioError("ChurnStorm.waves must be >= 1")
        if len(self.rows) < self.waves:
            raise ScenarioError(
                "ChurnStorm needs at least one row per wave "
                f"({len(self.rows)} rows < {self.waves} waves)"
            )
        if self.period < 1:
            raise ScenarioError("ChurnStorm.period must be >= 1")
        if self.down_for < 1:
            raise ScenarioError("ChurnStorm.down_for must be >= 1")
        if set(self.rows) & set(self.seed_rows):
            raise ScenarioError(
                "ChurnStorm.seed_rows must be disjoint from rows (the "
                "bootstrap contact must survive the storm)"
            )

    def wave_schedule(self) -> Tuple[Tuple[int, int, Tuple[int, ...]], ...]:
        """``(crash_tick, restart_tick, chunk_rows)`` per wave, in order."""
        n = len(self.rows)
        per = -(-n // self.waves)  # ceil division
        out = []
        for k in range(self.waves):
            chunk = self.rows[k * per:(k + 1) * per]
            if not chunk:
                break
            t = self.at + k * self.period
            out.append((t, t + self.down_for, chunk))
        return tuple(out)

    def last_tick(self) -> int:
        return max(r for _, r, _ in self.wave_schedule())


@dataclass(frozen=True)
class SlowEpoch:
    """Time-boxed slow-network epoch (r18): EVERY link gains
    ``mean_delay_ticks`` of exponential-mean delay in [at, until) — the
    cluster-wide analogue of :class:`SlowMember` (whole-fabric congestion,
    not one slow host). Needs the dense delay model (``delay_slots > 0``);
    ``until`` is required (an unbounded slow epoch has no horizon) and
    restores every link to zero delay.
    """

    mean_delay_ticks: float
    at: int
    until: int

    def __post_init__(self):
        if self.mean_delay_ticks <= 0:
            raise ScenarioError("SlowEpoch.mean_delay_ticks must be > 0")
        if self.until is None or self.until <= self.at:
            raise ScenarioError("SlowEpoch.until must be > at")


@dataclass(frozen=True)
class DroppedRefute:
    """Byzantine-adjacent refute suppression (r18): in [at, until) every
    self-refutation ``rows`` issue is squashed before it can disseminate —
    the member keeps running (it probes, acks, gossips other rumors) but
    its alive-again counter-evidence never leaves the host, as if an
    adversary dropped exactly those packets.

    Mechanically the timeline rewinds each row's OWN self-record to the
    strongest record the rest of the cluster holds whenever the row has
    refuted (inc-bumped over) a SUSPECT/DEAD verdict, every tick of the
    window — exercising the r14 suspicion/refutation race from the losing
    side. The rows stay alive, so any DEAD verdict about them inside the
    window is a *true* suppression casualty, not a detector bug: they join
    the false-positive watch cohort only via explicit ``fp_watch_rows``.
    ``until`` is required; after it, normal refutation resumes and the rows
    must converge back to ALIVE (the heal obligation the sentinels check).
    Dense engines only (needs the [N, N] view planes + changed_at).
    """

    rows: Sequence[int]
    at: int
    until: int

    def __post_init__(self):
        object.__setattr__(self, "rows", _rows(self.rows))
        if not self.rows:
            raise ScenarioError("DroppedRefute needs at least one row")
        if self.until is None or self.until <= self.at:
            raise ScenarioError("DroppedRefute.until must be > at")


EVENT_TYPES = (
    Partition, LossStorm, LinkFlap, Crash, Restart,
    SlowMember, AsymmetricLoss, FlakyObserver,
    ZoneOutage, ChurnStorm, SlowEpoch, DroppedRefute,
)

#: the r14 loss-adversarial family: events that DEGRADE members without
#: killing them — the false-positive sentinel's watch cohort
DEGRADED_EVENT_TYPES = (SlowMember, AsymmetricLoss, FlakyObserver)


@dataclass(frozen=True)
class Scenario:
    """A named, validated fault timeline + sentinel budgets.

    ``horizon`` is the total tick span the scenario runs for (None = derived:
    last event boundary plus the convergence budget). ``detect_budget`` /
    ``converge_budget`` override the protocol-math defaults (0/None = auto
    from the engine params — see :func:`.sentinels.build_spec`), and
    ``check_interval`` sets the sentinel sampling cadence in ticks (sentinel
    facts are latching/monotone, so sampling is sound — see sentinels.py).

    ``fp_watch_rows`` (r14) adds explicit rows to the FALSE-POSITIVE
    sentinel's watch cohort — by default it watches the degraded-but-alive
    rows of SlowMember / AsymmetricLoss / FlakyObserver events (minus any
    row a Crash also hits). A watched row tombstoned by any up observer is
    a false positive; ``fp_enforce=False`` records the count without
    counting it as a violation (the static-timeout CONTROL arm of the r14
    certification is expected to violate — documented, not hidden).
    """

    name: str
    events: Sequence
    horizon: Optional[int] = None
    detect_budget: Optional[int] = None
    converge_budget: Optional[int] = None
    check_interval: Optional[int] = None
    fp_watch_rows: Sequence[int] = ()
    fp_enforce: bool = True

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        object.__setattr__(self, "fp_watch_rows", _rows(self.fp_watch_rows))
        for ev in self.events:
            if not isinstance(ev, EVENT_TYPES):
                raise ScenarioError(f"unknown scenario event {ev!r}")
            if ev.at < 0:
                raise ScenarioError(f"event {ev} starts before the arm tick")
        if self.horizon is not None and self.horizon < 1:
            raise ScenarioError("Scenario.horizon must be >= 1")

    # -- derived views -------------------------------------------------------
    def referenced_rows(self) -> set:
        """Every row any event names: crash/restart targets + their seeds,
        partition group members, flap endpoints, degraded/fp-watch rows."""
        rows: set = set(self.fp_watch_rows)
        for ev in self.events:
            for attr in ("rows", "seed_rows"):
                rows.update(getattr(ev, attr, ()))
            for g in getattr(ev, "groups", ()):
                rows.update(g)
            for s, d in getattr(ev, "pairs", ()):
                rows.update((s, d))
        return rows

    def degraded_rows(self) -> set:
        """Rows the r14 loss-adversarial events degrade WITHOUT killing
        (SlowMember / AsymmetricLoss / FlakyObserver targets, minus rows a
        Crash also hits) — the false-positive sentinel's default watch
        cohort: these members stay alive the whole scenario, so a DEAD
        verdict about any of them is by construction a false positive."""
        deg: set = set()
        crashed: set = set()
        for ev in self.events:
            if isinstance(ev, DEGRADED_EVENT_TYPES):
                deg.update(ev.rows)
            elif isinstance(ev, Crash):
                crashed.update(ev.rows)
        return deg - crashed

    def validate_rows(self, capacity: int) -> None:
        """Fail FAST on rows outside ``[0, capacity)`` — a silent JAX
        clamp/no-op would otherwise inject nothing and make the sentinels
        watch the wrong (healthy) row."""
        bad = sorted(r for r in self.referenced_rows()
                     if not 0 <= r < capacity)
        if bad:
            raise ScenarioError(
                f"scenario {self.name!r} references rows {bad} outside the "
                f"{capacity}-row engine"
            )

    def last_event_tick(self) -> int:
        """Last tick at which any timeline action fires (0 when eventless)."""
        last = 0
        for ev in self.events:
            last = max(last, ev.at)
            for attr in ("heal_at", "until"):
                v = getattr(ev, attr, None)
                if v is not None:
                    last = max(last, v)
            if isinstance(ev, ChurnStorm):
                last = max(last, ev.last_tick())
        return last

    def fault_touched_rows(
        self, capacity: int, loss_storm_immunity_pct: float = 50.0
    ) -> set:
        """Rows any event may plausibly fault: crash/restart targets,
        partition group members, flap endpoints — and EVERY row while a
        ``LossStorm`` at or above ``loss_storm_immunity_pct`` is scripted
        (heavy uniform loss can legitimately suspect anyone; below the
        threshold the no-false-DEAD guarantee is expected to hold). The
        complement is the never-faulted cohort the false-DEAD sentinel
        protects."""
        touched: set = set()
        for ev in self.events:
            if isinstance(ev, (Crash, Restart, ChurnStorm, DroppedRefute)):
                # a DroppedRefute row can legitimately age to DEAD while its
                # refutes are suppressed — that is the fault, not a detector
                # bug, so the false-DEAD sentinel must not vouch for it
                touched.update(ev.rows)
            elif isinstance(ev, Partition):
                for g in ev.groups:
                    touched.update(g)
            elif isinstance(ev, (ZoneOutage, SlowEpoch)):
                # a zone cut severs links on BOTH sides (no bystanders), and
                # a slow epoch delays every link — nobody is vouched-for
                touched.update(range(capacity))
            elif isinstance(ev, LinkFlap):
                for s, d in ev.pairs:
                    touched.update((s, d))
            elif isinstance(ev, LossStorm) and ev.pct >= loss_storm_immunity_pct:
                touched.update(range(capacity))
            elif isinstance(ev, DEGRADED_EVENT_TYPES):
                # a degraded member is both suspectable (its links fail)
                # and a degraded OBSERVER (its own probes fail — it can
                # falsely suspect anyone), so the legacy no-false-DEAD
                # vouching covers nobody while these run; the r14
                # false-positive sentinel is the guarantee for this family
                touched.update(range(capacity))
        return {r for r in touched if 0 <= r < capacity}

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


# -- (de)serialization --------------------------------------------------------
# Flight dumps (telemetry/flight.py schema >= 2) embed the armed scenario so
# replay.py can rebuild it without inference. Events round-trip through plain
# dicts: {"type": <class name>, ...fields} — JSON-safe, no pickle.

_EVENT_BY_NAME = {cls.__name__: cls for cls in EVENT_TYPES}


def event_to_dict(ev) -> dict:
    """JSON-safe dict for one timeline event (round-trips via
    :func:`event_from_dict`)."""
    if not isinstance(ev, EVENT_TYPES):
        raise ScenarioError(f"cannot serialize unknown event {ev!r}")
    doc = dataclasses.asdict(ev)
    doc["type"] = type(ev).__name__
    return doc


def event_from_dict(doc: dict):
    """Inverse of :func:`event_to_dict`; raises ``ScenarioError`` on an
    unknown type name or bad fields (future-vocabulary dumps fail LOUDLY)."""
    if not isinstance(doc, dict) or "type" not in doc:
        raise ScenarioError(f"malformed event doc {doc!r}")
    cls = _EVENT_BY_NAME.get(doc["type"])
    if cls is None:
        raise ScenarioError(
            f"unknown event type {doc['type']!r} (from a newer fault "
            f"vocabulary?) — known: {sorted(_EVENT_BY_NAME)}"
        )
    kw = {k: v for k, v in doc.items() if k != "type"}
    try:
        return cls(**kw)
    except TypeError as e:
        raise ScenarioError(f"bad fields for {doc['type']}: {e}") from e


def scenario_to_dict(scenario: "Scenario") -> dict:
    """JSON-safe dict for a full scenario (events + budgets)."""
    return {
        "name": scenario.name,
        "events": [event_to_dict(ev) for ev in scenario.events],
        "horizon": scenario.horizon,
        "detect_budget": scenario.detect_budget,
        "converge_budget": scenario.converge_budget,
        "check_interval": scenario.check_interval,
        "fp_watch_rows": list(scenario.fp_watch_rows),
        "fp_enforce": scenario.fp_enforce,
    }


def scenario_from_dict(doc: dict) -> "Scenario":
    """Inverse of :func:`scenario_to_dict`."""
    if not isinstance(doc, dict) or "name" not in doc or "events" not in doc:
        raise ScenarioError(f"malformed scenario doc: {sorted(doc) if isinstance(doc, dict) else doc!r}")
    return Scenario(
        name=doc["name"],
        events=tuple(event_from_dict(e) for e in doc["events"]),
        horizon=doc.get("horizon"),
        detect_budget=doc.get("detect_budget"),
        converge_budget=doc.get("converge_budget"),
        check_interval=doc.get("check_interval"),
        fp_watch_rows=tuple(doc.get("fp_watch_rows", ())),
        fp_enforce=bool(doc.get("fp_enforce", True)),
    )
