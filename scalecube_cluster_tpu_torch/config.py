"""Immutable cluster configuration with LAN / WAN / local / sim profiles: a
copy of the JAX package's ``config.py`` (no JAX import there either), whose
docstring maps each block onto the reference's config classes. All times
are float seconds.

:func:`tick_units` is the mapping every engine's ``from_config`` shares: one
tick is one ``sim.tick_interval``, the FD round fires every
``ping_interval / tick_interval`` ticks, SYNC every ``sync_interval /
tick_interval``. ``validate`` checks what the JAX one checks except the
control knobs, whose validation lives in the control plane's module
(ROADMAP A11); the dissemination and adaptive blocks are validated
through :meth:`.dissemination.spec.DissemSpec.from_config` and
:meth:`.adaptive.AdaptiveSpec.from_config`, as in JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence

from .models.member import new_member_id
from .utils.namespaces import validate_namespace

DEFAULT_NAMESPACE = "default"


@dataclass(frozen=True)
class FailureDetectorConfig:
    """Random-probe failure detector knobs (reference FailureDetectorConfig.java)."""

    ping_interval: float = 1.0
    ping_timeout: float = 0.5
    ping_req_members: int = 3

    def replace(self, **kw) -> "FailureDetectorConfig":
        return replace(self, **kw)

    @staticmethod
    def default_lan() -> "FailureDetectorConfig":
        return FailureDetectorConfig()

    @staticmethod
    def default_wan() -> "FailureDetectorConfig":
        return FailureDetectorConfig(ping_interval=5.0, ping_timeout=3.0)

    @staticmethod
    def default_local() -> "FailureDetectorConfig":
        return FailureDetectorConfig(ping_interval=1.0, ping_timeout=0.2, ping_req_members=1)


@dataclass(frozen=True)
class GossipConfig:
    """Infection-style dissemination knobs (reference GossipConfig.java)."""

    gossip_interval: float = 0.2
    gossip_fanout: int = 3
    gossip_repeat_mult: int = 3
    gossip_segmentation_threshold: int = 1000

    def replace(self, **kw) -> "GossipConfig":
        return replace(self, **kw)

    @staticmethod
    def default_lan() -> "GossipConfig":
        return GossipConfig()

    @staticmethod
    def default_wan() -> "GossipConfig":
        return GossipConfig(gossip_fanout=4)

    @staticmethod
    def default_local() -> "GossipConfig":
        return GossipConfig(gossip_interval=0.1, gossip_repeat_mult=2)


@dataclass(frozen=True)
class MembershipConfig:
    """SWIM membership + suspicion + SYNC knobs (reference MembershipConfig.java)."""

    seed_members: Sequence[str] = ()
    sync_interval: float = 30.0
    sync_timeout: float = 3.0
    suspicion_mult: int = 5
    namespace: str = DEFAULT_NAMESPACE
    removed_members_history_size: int = 42

    def replace(self, **kw) -> "MembershipConfig":
        return replace(self, **kw)

    @staticmethod
    def default_lan() -> "MembershipConfig":
        return MembershipConfig()

    @staticmethod
    def default_wan() -> "MembershipConfig":
        return MembershipConfig(sync_interval=60.0, suspicion_mult=6)

    @staticmethod
    def default_local() -> "MembershipConfig":
        return MembershipConfig(sync_interval=15.0, suspicion_mult=3)


@dataclass(frozen=True)
class TransportConfig:
    """Transport knobs (reference TransportConfig.java:8-22)."""

    port: int = 0  # 0 = ephemeral
    host: str = "127.0.0.1"
    connect_timeout: float = 3.0
    max_frame_length: int = 2 * 1024 * 1024
    message_codec: str = "jdk"  # codec registry key, see transport/codecs.py
    transport_factory: Optional[str] = None  # factory registry key; None -> default
    # Bounded reconnect for the stream (TCP/WebSocket) outbound path: a
    # failed connect or mid-send connection drop retries up to
    # ``reconnect_max_retries`` extra times with exponential backoff
    # (base * 2^attempt, capped at max, +-50% jitter so a rebooting peer
    # isn't stampeded); the give-up surfaces as a "reconnect_giveup"
    # transport event. 0 retries restores the old fail-fast behavior.
    reconnect_max_retries: int = 2
    reconnect_base_delay: float = 0.05
    reconnect_max_delay: float = 1.0

    def replace(self, **kw) -> "TransportConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class SimConfig:
    """Vectorized-simulation knobs (new; no reference analogue).

    ``tick_interval`` is the wall-clock meaning of one kernel tick; by default
    equal to the gossip interval so one tick = one gossip period and FD /
    sync rounds fire every ``ping_interval / tick_interval`` ticks.
    """

    capacity: int = 0  # max member rows; 0 -> derived from initial cluster size
    tick_interval: float = 0.2
    rumor_slots: int = 64  # concurrent user-rumor capacity per cluster
    # reserved: bounded per-node piggyback ring for the sparse record-queue
    # tick (README §Roadmap); the dense kernel derives the piggyback set
    # from changed_at ages instead
    record_queue: int = 32
    dense_links: bool = True  # dense NxN loss/delay matrices (sim emulator)
    delay_slots: int = 0  # pending-delivery ring depth (max link delay + 1 ticks)
    # Precedence-key plane dtype (r9 bit-plane compaction): "i32" is the
    # r0-r8 wide layout (the oracle-lockstep default — incarnations to
    # 2^21, 256 row-reuse epochs); "i16" halves the dominant [N, N] key
    # plane and switches the dense kernel to word-parallel packed-mask
    # sweeps (ops/bitplane.py), under the narrow saturation rule
    # (incarnation cap 511 + epoch fold 16 — lattice.KeyLayout).
    plane_dtype: str = "i32"
    # Partial-view engine knobs (r11, ops/pview.py): ``view_slots`` is k,
    # the per-member neighbor-table width ([N, k] — the O(N·k) memory
    # budget); ``active_slots`` the HyParView-style active-view prefix
    # sampled for FD probes / gossip fanout / SYNC peers (the remainder is
    # the passive healing reservoir refreshed by the SYNC-folded shuffle).
    view_slots: int = 24
    active_slots: int = 8
    seed: int = 0
    # Build-cache directory (None = the checkout's build/; the
    # SCALECUBE_COMPILE_CACHE_DIR env var is the non-config fallback): the
    # port's CUDA kernels build into <dir>/torch_kernels/, keyed on their
    # source and flags (see scalecube_cluster_tpu_torch.compile_cache).
    compile_cache_dir: Optional[str] = None

    def replace(self, **kw) -> "SimConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class DisseminationConfig:
    """Dissemination strategy-zoo knobs (r13; no reference analogue — the
    reference ships uniform-random push only, ``GossipProtocolImpl``).

    ``strategy`` selects the gossip phase's peer-selection + payload
    policy (``push`` / ``push_pull`` / ``pipelined`` / ``accelerated``)
    and ``topology`` the overlay the fanout peers are drawn from
    (``full`` / ``ring`` / ``torus`` / ``expander`` / ``geo``) — see
    ``dissemination/spec.py`` for the catalog and docs/DISSEMINATION.md
    for the certified-bound table. The defaults reproduce the legacy
    program byte-for-byte. FD probes and SYNC anti-entropy always keep
    the reference's uniform semantics."""

    strategy: str = "push"
    topology: str = "full"
    degree: int = 0  # expander/geo chord budget (0 = auto ceil_log2)
    torus_rows: int = 0  # 0 = auto (largest divisor <= sqrt(N))
    geo_zones: int = 4
    geo_wan_delay_ticks: int = 0  # mean cross-zone delay, in ticks
    pipeline_budget: int = 1  # pipelined: rumor slots per message
    tuneable_mix: float = 0.5  # tuneable: P(deterministic chord) per send

    def replace(self, **kw) -> "DisseminationConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class AdaptiveConfig:
    """Adaptive failure-detection knobs (r14; Lifeguard-lineage — no
    reference analogue: scalecube-cluster ships static suspicion math).

    ``enabled=False`` (the default) keeps the byte-identical legacy window
    programs. Armed, each member tracks a local-health score (own
    probe-miss/refutation evidence, ``lh_max`` cap) scaling its direct
    probe timeout and the suspicion sweeps it runs, and suspicion
    time-to-DEAD interpolates log-scaled from ``max_mult`` (lone
    accusation) to ``min_mult`` (>= ``conf_target`` accepted
    confirmations). See ``adaptive.py`` / docs/ADAPTIVE_FD.md."""

    enabled: bool = False
    lh_max: int = 8
    min_mult: int = 5
    max_mult: int = 10
    conf_target: int = 4

    def replace(self, **kw) -> "AdaptiveConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ControlConfig:
    """Closed-loop control-plane knobs (r16; no reference analogue — the
    telemetry-driven knob-steering controller, see ``control.py`` /
    docs/CONTROL.md).

    The loop constants only: ``epoch_windows`` windows per control epoch
    (sensor reads + decisions run at epoch cadence), the asymmetric
    anti-flap dwell (``dwell_up`` epochs to raise protection,
    ``dwell_down`` to relax it), the per-epoch actuation clamp
    (``max_step`` ladder rungs), and the downward ``hysteresis`` margin.
    The rung LADDER itself is code (``control.DEFAULT_LADDER``, seeded
    from the offline adaptive-knob map) — pass a custom
    ``control.ControlSpec`` to ``SimDriver.arm_control`` to change it."""

    epoch_windows: int = 4
    dwell_up: int = 2
    dwell_down: int = 4
    max_step: int = 1
    hysteresis: float = 0.6
    #: r19: false-positive pressure gate — a ``suspect_rate`` (new
    #: suspicions per probe) at or above this votes the target ONE rung up
    #: through the normal dwell machinery. 0.0 (default) keeps the sensor
    #: passive/logged-only, the r16-certified behavior.
    suspect_gate: float = 0.0
    #: r21: spread-lag gate (ROADMAP item 4) — a view dissemination
    #: deficit (``convergence_lag``, measured only when
    #: ``alive_view_fraction`` is live) at or above this votes the target
    #: ONE rung up through the same dwell machinery. 0.0 keeps it passive.
    spread_lag_gate: float = 0.0

    def replace(self, **kw) -> "ControlConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ChaosConfig:
    """Chaos scenario-engine knobs (new; no reference analogue — the sim's
    fault-injection + invariant-sentinel subsystem, see ``chaos/``).

    ``check_interval_ticks`` is the sentinel sampling cadence (sentinel facts
    are latching/monotone, so sampling is sound and keeps an armed-but-idle
    engine within noise of the plain pipelined driver). The budgets default
    to protocol math when 0 (suspicion window + dissemination slack for
    detection; 8 sync intervals + detection slack for re-convergence).
    ``loss_storm_immunity_pct`` is the uniform-loss level at or above which
    the no-false-DEAD sentinel stops vouching for untouched members (heavy
    adversarial loss can legitimately suspect anyone)."""

    check_interval_ticks: int = 32
    detect_budget_ticks: int = 0  # 0 = auto from protocol math
    converge_budget_ticks: int = 0  # 0 = auto
    loss_storm_immunity_pct: float = 50.0

    def replace(self, **kw) -> "ChaosConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry-plane knobs (new; no reference analogue — the r8 on-device
    metric rings, unified event bus, OpenMetrics exporter, and crash flight
    recorder, see ``telemetry/``).

    ``ring_len`` is the number of per-window rows the device metric ring
    retains ([ring_len, n_metrics] f32, overwritten circularly — host reads
    happen only at flush()/scrape sync points, never per window).
    ``bus_capacity`` bounds the unified event bus (oldest records are
    evicted; evictions are counted, never silent). ``flight_windows`` is K,
    the ring-window depth a flight-recorder dump captures, and
    ``flight_dir`` is where dump artifacts land (None = current directory
    at dump time). ``latency_buckets`` are the histogram bucket upper
    bounds, in seconds, for the window-dispatch / tick-latency histograms
    the ``/metrics`` endpoint exports."""

    ring_len: int = 512
    bus_capacity: int = 4096
    flight_windows: int = 64
    flight_dir: Optional[str] = None
    latency_buckets: Sequence[float] = (
        0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    )

    def replace(self, **kw) -> "TelemetryConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class TraceConfig:
    """Causal-trace-plane knobs (new; no reference analogue — the r10
    on-device protocol span capture, see ``trace/``). The reference gets
    causal traces for free from per-message DEBUG logs; the lockstep
    tensor engine samples K "tracer" members + T traced rumor slots into a
    fixed-shape device ring instead.

    ``tracers`` — how many tracer members to sample when no explicit
    ``tracer_rows`` are given (the first K rows). ``tracer_rows`` —
    explicit tracer rows (wins over ``tracers``). ``rumor_slots`` — the
    traced user-rumor slots (their infection trees are sewable).
    ``ring_len`` — device trace-ring rows retained ([ring_len, n_fields]
    int32; K rows append per tick, so ring_len/K ticks of history).
    ``tick_us`` — microseconds one tick maps to in Perfetto exports
    (display scaling only; never touches the engine)."""

    tracers: int = 4
    tracer_rows: Sequence[int] = ()
    rumor_slots: Sequence[int] = ()
    ring_len: int = 8192
    tick_us: float = 1000.0

    def replace(self, **kw) -> "TraceConfig":
        return replace(self, **kw)


Lens = Callable


@dataclass(frozen=True)
class ClusterConfig:
    """Root config. Copy-on-write: every ``xxx()`` lens returns a new config
    (reference ClusterConfig fluent API, ClusterImpl.java:143-226)."""

    failure_detector: FailureDetectorConfig = field(default_factory=FailureDetectorConfig)
    gossip: GossipConfig = field(default_factory=GossipConfig)
    membership: MembershipConfig = field(default_factory=MembershipConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    dissemination: DisseminationConfig = field(default_factory=DisseminationConfig)
    adaptive: AdaptiveConfig = field(default_factory=AdaptiveConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)

    member_alias: Optional[str] = None
    external_host: Optional[str] = None  # container NAT mapping (ClusterConfig.java:236-300)
    external_port: Optional[int] = None
    metadata: Optional[bytes] = None
    metadata_timeout: float = 3.0
    metadata_codec: str = "jdk"
    member_id_generator: Callable[[], str] = field(default=new_member_id, compare=False)

    # -- profiles (reference ClusterConfig.java:54-93) ---------------------
    @staticmethod
    def default_lan() -> "ClusterConfig":
        return ClusterConfig()

    @staticmethod
    def default_wan() -> "ClusterConfig":
        return ClusterConfig(
            failure_detector=FailureDetectorConfig.default_wan(),
            gossip=GossipConfig.default_wan(),
            membership=MembershipConfig.default_wan(),
        )

    @staticmethod
    def default_local() -> "ClusterConfig":
        return ClusterConfig(
            failure_detector=FailureDetectorConfig.default_local(),
            gossip=GossipConfig.default_local(),
            membership=MembershipConfig.default_local(),
        )

    @staticmethod
    def default_sim() -> "ClusterConfig":
        """Profile for the vectorized simulation: local-ish timers, tick-aligned."""
        cfg = ClusterConfig.default_local()
        return dataclasses.replace(cfg, sim=SimConfig(tick_interval=cfg.gossip.gossip_interval))

    # -- functional lenses over sub-configs --------------------------------
    def with_failure_detector(self, op: Lens) -> "ClusterConfig":
        return replace(self, failure_detector=op(self.failure_detector))

    def with_gossip(self, op: Lens) -> "ClusterConfig":
        return replace(self, gossip=op(self.gossip))

    def with_membership(self, op: Lens) -> "ClusterConfig":
        return replace(self, membership=op(self.membership))

    def with_transport(self, op: Lens) -> "ClusterConfig":
        return replace(self, transport=op(self.transport))

    def with_sim(self, op: Lens) -> "ClusterConfig":
        return replace(self, sim=op(self.sim))

    def with_dissemination(self, op: Lens) -> "ClusterConfig":
        return replace(self, dissemination=op(self.dissemination))

    def with_adaptive(self, op: Lens) -> "ClusterConfig":
        return replace(self, adaptive=op(self.adaptive))

    def with_control(self, op: Lens) -> "ClusterConfig":
        return replace(self, control=op(self.control))

    def with_chaos(self, op: Lens) -> "ClusterConfig":
        return replace(self, chaos=op(self.chaos))

    def with_telemetry(self, op: Lens) -> "ClusterConfig":
        return replace(self, telemetry=op(self.telemetry))

    def with_trace(self, op: Lens) -> "ClusterConfig":
        return replace(self, trace=op(self.trace))

    def replace(self, **kw) -> "ClusterConfig":
        return replace(self, **kw)

    # -- validation (reference ClusterImpl.validateConfiguration :314-354) -
    def validate(self) -> "ClusterConfig":
        validate_namespace(self.membership.namespace)
        if self.failure_detector.ping_interval <= 0:
            raise ValueError("ping_interval must be > 0")
        if self.failure_detector.ping_timeout <= 0:
            raise ValueError("ping_timeout must be > 0")
        if self.failure_detector.ping_timeout >= self.failure_detector.ping_interval:
            raise ValueError("ping_timeout must be < ping_interval")
        if self.gossip.gossip_interval <= 0:
            raise ValueError("gossip_interval must be > 0")
        if self.gossip.gossip_fanout <= 0:
            raise ValueError("gossip_fanout must be > 0")
        if self.gossip.gossip_repeat_mult <= 0:
            raise ValueError("gossip_repeat_mult must be > 0")
        if self.membership.sync_interval <= 0:
            raise ValueError("sync_interval must be > 0")
        if self.membership.suspicion_mult <= 0:
            raise ValueError("suspicion_mult must be > 0")
        if self.metadata_timeout <= 0:
            raise ValueError("metadata_timeout must be > 0")
        if self.transport.reconnect_max_retries < 0:
            raise ValueError("reconnect_max_retries must be >= 0")
        if self.transport.reconnect_base_delay < 0:
            raise ValueError("reconnect_base_delay must be >= 0")
        if self.sim.plane_dtype not in ("i32", "i16"):
            raise ValueError("sim.plane_dtype must be 'i32' or 'i16'")
        if not (0 < self.sim.active_slots < self.sim.view_slots):
            raise ValueError(
                "need 0 < sim.active_slots < sim.view_slots (the pview "
                "passive reservoir must be non-empty)"
            )
        # the spec dataclass owns strategy/topology validation (one
        # spelling for config- and params-level construction)
        from .dissemination.spec import DissemSpec

        DissemSpec.from_config(self)
        # the adaptive spec dataclass owns its knob validation likewise
        from .adaptive import AdaptiveSpec

        AdaptiveSpec.from_config(self)
        if self.chaos.check_interval_ticks <= 0:
            raise ValueError("chaos.check_interval_ticks must be > 0")
        if not (0.0 <= self.chaos.loss_storm_immunity_pct <= 100.0):
            raise ValueError("chaos.loss_storm_immunity_pct must be in [0, 100]")
        if self.telemetry.ring_len <= 0:
            raise ValueError("telemetry.ring_len must be > 0")
        if self.telemetry.bus_capacity <= 0:
            raise ValueError("telemetry.bus_capacity must be > 0")
        if self.telemetry.flight_windows <= 0:
            raise ValueError("telemetry.flight_windows must be > 0")
        if list(self.telemetry.latency_buckets) != sorted(
            self.telemetry.latency_buckets
        ) or any(b <= 0 for b in self.telemetry.latency_buckets):
            raise ValueError(
                "telemetry.latency_buckets must be positive and ascending"
            )
        if self.trace.ring_len <= 0:
            raise ValueError("trace.ring_len must be > 0")
        if self.trace.tracers <= 0 and not self.trace.tracer_rows:
            raise ValueError(
                "trace.tracers must be > 0 (or set explicit trace.tracer_rows)"
            )
        if any(r < 0 for r in self.trace.tracer_rows):
            raise ValueError("trace.tracer_rows must be non-negative")
        if any(s < 0 for s in self.trace.rumor_slots):
            raise ValueError("trace.rumor_slots must be non-negative")
        if self.trace.tick_us <= 0:
            raise ValueError("trace.tick_us must be > 0")
        return self


def tick_units(config: ClusterConfig, capacity: int | None, initial_size: int | None,
               seed_rows: tuple) -> dict:
    """The params fields every engine derives alike from ``config``: the
    capacity (``capacity`` > ``config.sim.capacity`` > ``initial_size``),
    the protocol knobs in tick units, the delay timeouts."""
    sim = config.sim
    cap = capacity or sim.capacity or (initial_size or 0)
    if cap <= 1:
        raise ValueError(
            "sim capacity must be > 1 (set config.sim.capacity, or pass "
            "capacity= / initial_size=)"
        )
    dt = sim.tick_interval
    fd = config.failure_detector
    return dict(
        capacity=cap,
        fanout=config.gossip.gossip_fanout,
        repeat_mult=config.gossip.gossip_repeat_mult,
        ping_req_k=fd.ping_req_members,
        fd_every=max(1, round(fd.ping_interval / dt)),
        sync_every=max(1, round(config.membership.sync_interval / dt)),
        suspicion_mult=config.membership.suspicion_mult,
        rumor_slots=sim.rumor_slots,
        seed_rows=tuple(seed_rows),
        delay_slots=sim.delay_slots,
        fd_direct_timeout_ticks=max(0, int(fd.ping_timeout / dt)),
        fd_leg_timeout_ticks=max(0, int((fd.ping_interval - fd.ping_timeout) / dt / 2)),
        sync_timeout_ticks=max(0, int(config.membership.sync_timeout / dt)),
    )


def suspicion_timeout_for(config: ClusterConfig, cluster_size: int) -> float:
    """Suspicion timeout derived from config + cluster size (seconds)."""
    from .utils.cluster_math import suspicion_timeout

    return suspicion_timeout(
        config.membership.suspicion_mult, cluster_size, config.failure_detector.ping_interval
    )
