"""SimDriver: the host loop around the device-resident SWIM simulation.

A port of the JAX package's ``sim/driver.py`` over the dense, sparse and
partial-view engines on one device (the params type picks the engine,
:func:`..ops.engine_api.resolve`; :func:`auto_params` picks the params by
the JAX package's engine policy). The driver owns:

* the engine's window (:func:`..ops.kernel.make_run`,
  :func:`..ops.sparse.make_sparse_run`, :func:`..ops.pview.make_pview_run`)
  and its randomness: a ``torch.Generator`` on the driver's device,
  seeded with ``seed``, that each window draws its per-tick uniforms from
  (the JAX driver's key chain plays this part there);
* the id↔row mapping (``Member`` handles with ``sim://row`` addresses),
  the rows' transports (``_transports``: a :class:`.transport.SimTransport`
  or a bridged endpoint, :mod:`..bridge`) and the host generator their
  delivery draws from (``_rng``, seeded as the JAX driver seeds its own);
* membership-event extraction for *watched* rows — per-tick host diffs of
  those rows' synthesized views, emitting ADDED / LEAVING / REMOVED /
  UPDATED;
* the per-window health reductions (counter sums, pool high-water,
  segmentation warnings, end-of-window rumor coverage), kept ON DEVICE and
  read to the host only at a sync point: :meth:`flush`,
  :meth:`health_snapshot`, :meth:`checkpoint`, or the ``health_counters`` /
  ``pool_high_water`` / ``segmentation_warnings`` properties;
* checkpoint/resume of the full state, the generator included;
* the adaptive failure-detection plane (:mod:`..adaptive`): an enabled
  ``params.adaptive`` arms it, :meth:`SimDriver.set_adaptive` swaps it, and
  the driver threads the :class:`..adaptive.AdaptiveState` through the
  engine's adaptive window (``adaptive_state``; None when static);
* chaos scenarios (:meth:`SimDriver.run_scenario`, :mod:`..chaos`), whose
  runner applies the fault timeline between windows and checks the
  sentinels on the device; :meth:`SimDriver.chaos_snapshot` and the
  ``chaos`` section of :meth:`SimDriver.health_snapshot` read them;
* the telemetry plane (:meth:`SimDriver.arm_telemetry`, :mod:`..telemetry`):
  one ring row per window on the device, the lifecycle, chaos and
  checkpoint records on its bus, the ``/metrics`` exposition and the flight
  recorder;
* the causal trace plane (:meth:`SimDriver.arm_trace`, :mod:`..trace`):
  the engine's traced window appends K trace records per tick to a device
  ring, and a summary block per window boundary — the trajectory is the
  unarmed one, and stepping reads nothing back;
* the closed-loop control plane (:meth:`SimDriver.arm_control`,
  :mod:`..control`): once per control epoch it reads the newest telemetry
  row and may step a knob ladder through :meth:`SimDriver.set_dissemination`,
  :meth:`SimDriver.set_protocol_knobs` and :meth:`SimDriver.set_adaptive`.

``dispatch_stats`` counts the driver's own device→host readbacks as the
JAX driver does: a watch or ``record_metrics`` adds one per window, a flush
one per staged reduction. The tick itself reads one flag to the host per
data-keyed branch; :data:`..ops._tensor.HOST_SYNCS` counts those.

The driver builds its window from ``params`` at every step (a window is a
Python loop over the tick, not a compiled program), so it keeps no window
cache: a knob swap is a replacement of ``params``. :meth:`jit_cache_audit`
reports the window functions it ran, keyed as the JAX driver keys its
compiled programs, with the kernels' build directory
(:mod:`..compile_cache`; ``compile_cache_dir`` points it elsewhere).

On a member mesh (``mesh=``, :mod:`..ops.sharding`; the three engines)
the driver is SPMD: every rank runs the same script with the same
seed and holds its rows of the state; the windows are the sharded ones, a host
mutation runs on the whole state (gathered) and each rank keeps its rows,
and a host read (views, statuses, events, coverage) returns the same whole
value on every rank, with the readbacks of the unsharded driver.

The planes run on a sharded driver as on an unsharded one: the control
plane (its sensor is the telemetry ring, whole on every rank; its actuators
change the params, and the next step builds the sharded window from them),
``run_scenario`` (the scenario's host events through :meth:`_apply`, the
sentinels checked over each rank's rows and combined), the profiler
(:func:`..trace.profile.profile_driver`) and checkpoints: every rank
gathers the state, rank 0 writes the unsharded driver's archive, and a
restore keeps each rank's rows of it, so an archive moves between a
sharded and an unsharded driver either way.

On a dense or sparse mesh, as in JAX, the trace plane and the adaptive
plane are refused (those engines have no sharded traced or adaptive
window), and so is a control ladder whose rungs arm adaptive FD; a static
ladder arms.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.events import MembershipEvent
from ..models.member import Member, MemberStatus
from ..ops import engine_api
from ..ops.lattice import ALIVE, DEAD, LEAVING, SUSPECT, UNKNOWN, layout_for
from ..utils.streams import EventStream


def row_address(row: int) -> str:
    return f"sim://{row}"


class CheckpointError(RuntimeError):
    """A checkpoint file that cannot be restored (truncated, corrupt, schema
    from the future, written by another engine or by the JAX package) —
    raised instead of letting numpy/pickle fail deep in the load path."""


#: Checkpoint schema of the JAX package's driver (its layout: state planes,
#: ``_host`` pickle, ``_schema``, ``_crc32``, ``_engine``); the port's
#: archives add ``_framework`` and keep the generator state as ``_gen``.
CHECKPOINT_SCHEMA = 3
FRAMEWORK = "torch"

_RANK_TO_STATUS_NP = np.array([ALIVE, LEAVING, SUSPECT, DEAD], dtype=np.int8)


def _status_of_key(k: int) -> int:
    """Host-side decode of a packed table key (lattice.py layout)."""
    return UNKNOWN if k < 0 else int(_RANK_TO_STATUS_NP[k & 3])


def auto_params(
    capacity: int,
    *,
    per_link_fidelity: bool = False,
    link_delay: bool = False,
    dense_threshold: int = 8192,
    config=None,
    **overrides,
):
    """The JAX package's engine policy: the dense engine where per-link
    fidelity or link delay is asked for up to ``dense_threshold`` members,
    and for every cluster of at most 512 members; the sparse engine past
    that; the partial-view engine with ``force_pview=True``
    (``force_sparse=True`` overrides the dense choice).

    Returns a ``SimParams``, ``SparseParams`` or ``PviewParams``, which
    :class:`SimDriver` resolves to its engine. ``config`` (a
    :class:`..config.ClusterConfig`) goes through the class's
    ``from_config`` with the overrides it takes; the remaining overrides
    replace fields of the result. A configured compile-cache directory
    (``config`` or ``SCALECUBE_COMPILE_CACHE_DIR``) points the kernel builds
    at it (:func:`..compile_cache.enable_persistent_compile_cache`)."""
    import dataclasses
    import inspect

    from ..ops.pview import PviewParams
    from ..ops.sparse import SparseParams
    from ..ops.state import SimParams

    if config is not None:
        from .. import compile_cache

        compile_cache.enable_persistent_compile_cache(config=config)
    force_sparse = overrides.pop("force_sparse", False)
    force_pview = overrides.pop("force_pview", False)
    use_dense = ((per_link_fidelity or link_delay) and capacity <= dense_threshold) or capacity <= 512
    if force_sparse:
        use_dense = False
    if force_pview:
        cls = PviewParams
    else:
        cls = SimParams if use_dense else SparseParams
    if config is not None:
        names = set(inspect.signature(cls.from_config).parameters)
        fc_kw = {k: v for k, v in overrides.items() if k in names}
        rest = {k: v for k, v in overrides.items() if k not in names}
        params = cls.from_config(config, capacity=capacity, **fc_kw)
        return dataclasses.replace(params, **rest) if rest else params
    return cls(capacity=capacity, **overrides)


@dataclass
class _Watch:
    row: int
    prev_key: np.ndarray  # [N] int32 packed keys
    stream: EventStream = field(default_factory=EventStream)
    log: List[MembershipEvent] = field(default_factory=list)
    # Member handle captured when the observer first learned each row, so
    # later events name the identity the observer actually knew — a reused
    # row (crash + rejoin) must not retroactively relabel old records.
    known: Dict[int, Member] = field(default_factory=dict)


class SimDriver:
    """Drive one simulated cluster; all mutation goes through this object."""

    def __init__(
        self,
        params,
        n_initial: int,
        warm: bool = True,
        seed: int = 0,
        mesh=None,
        record_metrics: bool = False,
        dense_links: bool | None = None,
        compile_cache_dir: str | None = None,
        device="cuda",
        draws: Optional[Callable[[int], Sequence]] = None,
    ):
        """``params`` selects the engine (:func:`..ops.engine_api.resolve`).
        The state lives on ``device``: the default is the card, and a
        machine without one fails here rather than running on the CPU;
        ``device="cpu"`` runs the kernels' plain versions on the host.
        ``draws``, when given, replaces the generator as the windows' draw
        source: a callable that takes a window's tick count and returns that
        many per-tick ``(fd, round)`` draw pairs (the parity tests replay
        the JAX driver's own key chain through it). ``compile_cache_dir``
        points the kernel builds at ``<dir>/torch_kernels/``
        (:mod:`..compile_cache`)."""
        if compile_cache_dir:
            from .. import compile_cache

            compile_cache.enable_persistent_compile_cache(compile_cache_dir)
        self.params = params
        self._eng = engine_api.resolve(params)
        self.engine = self._eng.name
        self._ops = self._eng.ops
        self.mesh = mesh
        if mesh is not None:
            from ..ops import sharding

            sharding._check_member_mesh(mesh)
            self.device = sharding.mesh_device(mesh)
            if torch.device(device).type != self.device.type:
                raise ValueError(f"device={device!r} but the mesh is on {mesh.device_type}")
        else:
            self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SimDriver(device='cuda') needs a CUDA device; pass device='cpu' "
                "to run on the host"
            )
        self.record_metrics = record_metrics
        if dense_links is None:
            dense_links = self._eng.dense_links_default
        if mesh is None:
            self.state = self._eng.init_state(params, n_initial, warm, dense_links, self.device)
        else:
            # every rank builds the same init on the host and keeps its rows
            self.state = self._eng.shard_state(self._eng.init_state(params, n_initial, warm, dense_links, "cpu"),
                                               mesh)
        self._dense_links = self.state.loss.dim() != 0
        # an enabled AdaptiveSpec on params arms the adaptive plane; the
        # driver owns its state and threads it through the adaptive window
        self._ad = None
        if not params.adaptive.is_default:
            if mesh is not None and self._eng.make_sharded_adaptive_run is None:
                raise ValueError(
                    f"adaptive failure detection is single-device for the {self.engine} engine — construct "
                    "without mesh= or use the default AdaptiveSpec"
                )
            self._ad = self._init_adaptive()
        self._chaos = None  # the armed DriverChaosRunner, if any
        # the armed telemetry plane (a pure consumer: arming never changes
        # the trajectory nor adds a per-window transfer), or None
        self._telemetry = None
        self._trace = None  # the armed TracePlane, or None
        self._control = None  # the armed ControlPlane, or None
        self._init_warm = bool(warm)
        self._key_dtype = self._eng.key_plane(self.state).dtype
        self._lay = layout_for(self._key_dtype)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._rng = np.random.default_rng(self.seed ^ 0x5EED)  # host-side (transport) draws
        self._draws = draws
        # per-window-function stats for jit_cache_audit(): calls and the
        # first call's wall time, keyed as the JAX driver keys its programs
        self._step_stats: Dict[tuple, dict] = {}
        self.n_initial = n_initial
        self.members: Dict[int, Member] = {
            r: Member(id=f"sim-{r}", address=row_address(r)) for r in range(n_initial)
        }
        self.metrics_history: List[dict] = []
        # gossip-stream fragmentation warning threshold (the reference's
        # GossipConfig default)
        self.segmentation_threshold = 1000
        self._watches: Dict[int, _Watch] = {}
        self._rumor_payloads: Dict[int, object] = {}
        self._next_member_ordinal = n_initial
        self._transports: Dict[int, object] = {}  # row -> SimTransport / bridged endpoint
        # engine-health accumulators: per-window sums/maxima accumulate ON
        # DEVICE (the _win_* fields) and fold into these host values at a
        # flush() sync point — reading the public properties flushes
        self._health_counters: Dict[str, int] = {
            "announce_dropped": 0, "announce_dropped_fd": 0,
            "announce_dropped_expiry": 0, "announce_dropped_refute": 0,
            "announce_dropped_sync": 0, "pool_evicted": 0, "announced": 0,
            # host-path announce drops (a join's self-announce finding no
            # pool slot), probed in join() once a health consumer exists
            "announce_dropped_host": 0,
            # the sharded windows' delivery budget drops (always 0 here)
            "delivery_overflow": 0,
        }
        self._pool_high_water = 0
        self._segmentation_warnings = 0
        self._win_names: List[str] = []
        self._win_accum = None  # [len(_win_names)] summed counter deltas
        self._win_pool_hw = None  # scalar max of mr_active_count
        self._win_seg_warn = None  # scalar count of over-threshold windows
        self._join_probe = None  # scalar count of dropped host announces
        self._health_interest = False
        self.dispatch_stats: Dict[str, int] = {
            "windows_dispatched": 0, "ticks_dispatched": 0, "readbacks": 0,
            "flushes": 0, "queue_depth": 0, "queue_high_water": 0,
        }
        # a flush per this many unflushed ticks, as in the JAX driver (whose
        # accumulators are int32)
        self._ticks_since_flush = 0
        self.flush_ticks_cap = 100_000
        # one reentrant lock serializes a stepping thread against readers
        # (health snapshots, views) and keeps the read-modify-write of the
        # staged reductions whole
        self._lock = threading.RLock()
        self._recent_joins: List[tuple] = []  # (tick, row) of driver joins
        self._join_horizon = 300  # ticks a join stays in the lag cohorts
        # host-tracked free rumor slots: spread_rumor reads the device only
        # when the list runs dry
        self._free_rumor_slots = list(range(params.rumor_slots))
        # end-of-window rumor-coverage vector ([R], device), its flushed
        # host copy, and whether host mutations are newer than that copy
        self._win_rumor_cov = None
        self._rumor_cov_host = None
        self._rumor_cov_dirty = True
        # rumors awaiting full coverage, slot -> spread tick (the telemetry
        # plane's rumor-spread histogram reads them at flush time)
        self._rumor_spread_pending: Dict[int, int] = {}

    # -- the member mesh ------------------------------------------------------
    def _mesh_ctx(self):
        """The sharded tick's context for a host read of this rank's rows
        (a no-op off a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from ..ops.sharding import ragged_delivery_context

        return ragged_delivery_context(self.mesh, self.params.capacity)

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """All N rows of a member-axis tensor (gathered on a mesh)."""
        if self.mesh is None:
            return x
        from ..ops.sharding import MEMBER_AXIS, gather_rows

        return gather_rows(x, self.mesh.get_group(MEMBER_AXIS))

    def _whole_state(self, *names):
        """The state with the member-axis leaves ``names`` whole (on a mesh;
        the rest stay this rank's rows). A name the engine's state lacks is
        skipped: the callers name what either engine on a mesh reads."""
        if self.mesh is None:
            return self.state
        return self.state.replace(**{k: self._whole(getattr(self.state, k)) for k in names
                                     if hasattr(self.state, k)})

    def _apply(self, fn) -> None:
        """A host mutation ``fn(state) -> state``. On a mesh it runs on the
        whole state, the same on every rank, and each rank keeps its rows."""
        if self.mesh is None:
            self.state = fn(self.state)
        else:
            whole = self._eng.gather_state(self.state, self.mesh)
            self.state = self._eng.shard_state(fn(whole), self.mesh)

    def _init_adaptive(self):
        from ..adaptive import init_adaptive_state

        ad = init_adaptive_state(self.params.capacity, device=self.device)
        if self.mesh is not None:
            from ..ops.sharding import shard_adaptive_state

            ad = shard_adaptive_state(ad, self.mesh)
        return ad

    def _window(self, n_ticks: int):
        """The window this step runs: traced, adaptive or plain, sharded on
        a mesh."""
        eng, p, mesh = self._eng, self.params, self.mesh
        if self._trace is not None:
            if mesh is not None:
                return eng.make_sharded_traced_run(mesh, p, n_ticks, self._trace.spec)
            return eng.make_traced_run(p, n_ticks, self._trace.spec)
        if self._ad is not None:
            return eng.make_sharded_adaptive_run(mesh, p, n_ticks) if mesh is not None else eng.make_adaptive_run(
                p, n_ticks)
        return eng.make_sharded_run(mesh, p, n_ticks, self._dense_links) if mesh is not None else eng.make_run(
            p, n_ticks)

    # -- time ---------------------------------------------------------------
    @property
    def tick(self) -> int:
        with self._lock:
            return self.state.tick

    @property
    def _host_tick(self) -> int:
        """The tick bus records and flight dumps stamp: a host int here."""
        return self.state.tick

    # -- stepping -----------------------------------------------------------
    def step(self, n_ticks: int = 1) -> dict:
        """Advance the sim ``n_ticks`` periods; returns the last tick's
        metrics (device tensors — coercing them to Python numbers is the
        caller's explicit sync). The health reductions stay on the device
        (see :meth:`flush`); a watch or ``record_metrics=True`` reads the
        window back once, which ``dispatch_stats`` counts."""
        with self._lock:
            return self._step_locked(n_ticks)

    def _step_locked(self, n_ticks: int) -> dict:
        rows = sorted(self._watches)
        watch_arr = torch.tensor(rows, dtype=torch.int64, device=self.device) if rows else None
        source = self._gen if self._draws is None else self._draws(n_ticks)
        stats = self._step_stats.setdefault(
            (n_ticks, len(rows), self._trace is not None, self._ad is not None),
            {"calls": 0, "first_dispatch_s": None},
        )
        t0 = time.perf_counter()
        step = self._window(n_ticks)
        if self._trace is not None:
            # the traced window appends each tick's records to the ring in
            # place at its host cursor; the window-boundary summary follows
            self.state, ms, watched = step(self.state, self._trace.ring, source, watch_rows=watch_arr)
            self._trace.on_window(self.state)
        elif self._ad is not None:
            self.state, self._ad, ms, watched = step(self.state, self._ad, source, watch_rows=watch_arr)
        else:
            self.state, ms, watched = step(self.state, source, watch_rows=watch_arr)
        dispatch_s = time.perf_counter() - t0
        if stats["calls"] == 0:
            # the first call builds the window (and, on the card, loads or
            # compiles the kernel's library)
            stats["first_dispatch_s"] = round(dispatch_s, 4)
        stats["calls"] += 1
        ds = self.dispatch_stats
        ds["windows_dispatched"] += 1
        ds["ticks_dispatched"] += n_ticks
        ds["queue_depth"] += 1
        ds["queue_high_water"] = max(ds["queue_high_water"], ds["queue_depth"])
        self._accumulate_window(ms)
        if self._telemetry is not None:
            # one ring row on the device and the host's wall-clock
            # histograms: still no transfer
            self._telemetry.on_window(ms, self.state, n_ticks, dispatch_s)
        if self._control is not None:
            # a counter bump per window; at control-epoch boundaries the
            # plane reads the newest telemetry row (one readback per epoch)
            # and may swap knobs between windows
            self._control.on_window()
        self._ticks_since_flush += n_ticks
        if self._ticks_since_flush >= self.flush_ticks_cap:
            self.flush()
        if self.record_metrics:
            host_ms = {name: v.cpu().numpy() for name, v in ms.items()}
            self._note_readback(len(host_ms))
            for i in range(n_ticks):
                self.metrics_history.append({name: v[i] for name, v in host_ms.items()})
        if rows:
            keys = watched.cpu().numpy()  # [n_ticks, W, N]
            self._note_readback(1)
            for i in range(n_ticks):
                for w_idx, row in enumerate(rows):
                    w = self._watches[row]
                    self._diff_row(w, keys[i, w_idx])
                    w.prev_key = keys[i, w_idx]
        return {name: v[-1] for name, v in ms.items()}

    # -- deferred reductions ------------------------------------------------
    def _note_readback(self, n: int = 1) -> None:
        """Record ``n`` device→host transfers; a readback waits for every
        enqueued window, so the queue depth resets."""
        with self._lock:
            self.dispatch_stats["readbacks"] += n
            self.dispatch_stats["queue_depth"] = 0

    def _accumulate_window(self, ms: dict) -> None:
        """Fold one window's metrics into the device-side reductions (tensor
        ops, no transfer; the host sees them at the next flush())."""
        names = [n for n in self._health_counters if n in ms]
        if names:
            vec = torch.stack([ms[n].sum() for n in names])
            if self._win_accum is None:
                self._win_accum, self._win_names = vec, names
            else:
                self._win_accum = self._win_accum + vec
        if "mr_active_count" in ms:
            hw = ms["mr_active_count"].max()
            self._win_pool_hw = hw if self._win_pool_hw is None else torch.maximum(self._win_pool_hw, hw)
        if "gossip_segmentation" in ms:
            over = (ms["gossip_segmentation"].max() > self.segmentation_threshold).to(torch.int32)
            self._win_seg_warn = over if self._win_seg_warn is None else self._win_seg_warn + over
        if "rumor_coverage" in ms:
            # coverage is a gauge: the last tick's [R] vector supersedes any
            # earlier staged window
            self._win_rumor_cov = ms["rumor_coverage"][-1]
            self._rumor_cov_dirty = False

    def flush(self) -> None:
        """Read every staged reduction to the host — THE sync point of the
        driver."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        flushed = 0
        if self._win_accum is not None:
            for name, v in zip(self._win_names, self._win_accum.tolist()):
                self._health_counters[name] += int(v)
            self._win_accum = None
            flushed += 1
        if self._win_pool_hw is not None:
            self._pool_high_water = max(self._pool_high_water, int(self._win_pool_hw))
            self._win_pool_hw = None
            flushed += 1
        if self._win_seg_warn is not None:
            new = int(self._win_seg_warn)
            self._win_seg_warn = None
            if new:
                import logging

                logging.getLogger(__name__).warning(
                    "gossip stream fragmented past threshold %d in %d window(s) since the last flush",
                    self.segmentation_threshold, new,
                )
            self._segmentation_warnings += new
            flushed += 1
        if self._join_probe is not None:
            self._health_counters["announce_dropped_host"] += int(self._join_probe)
            self._join_probe = None
            flushed += 1
        if self._win_rumor_cov is not None:
            self._rumor_cov_host = self._win_rumor_cov.cpu().numpy()
            self._win_rumor_cov = None
            flushed += 1
            if self._rumor_spread_pending and self._telemetry is not None and not self._rumor_cov_dirty:
                # a rumor that reached every up member since its spread:
                # its window-granular spread time goes to the histogram
                # (not while host mutations postdate the staged vector: a
                # rumor spread into a reclaimed slot must not inherit the
                # previous occupant's coverage)
                for slot, t0 in list(self._rumor_spread_pending.items()):
                    if self._rumor_cov_host[slot] >= 1.0:
                        self._telemetry.hist_spread.observe(max(self._host_tick - t0, 1))
                        del self._rumor_spread_pending[slot]
        if flushed:
            self._note_readback(flushed)
            self.dispatch_stats["flushes"] += 1
        self._ticks_since_flush = 0

    def sync(self) -> None:
        """Block until every enqueued window has executed (no transfer)."""
        with self._lock:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.dispatch_stats["queue_depth"] = 0

    def dispatch_snapshot(self) -> dict:
        """Queue depth (windows enqueued since the last host sync),
        readbacks in all and per window, flushes, staged reductions."""
        with self._lock:
            ds = dict(self.dispatch_stats)
            ds["readbacks_per_window"] = round(ds["readbacks"] / max(ds["windows_dispatched"], 1), 4)
            ds["staged_reductions"] = sum(
                x is not None
                for x in (self._win_accum, self._win_pool_hw, self._win_seg_warn,
                          self._join_probe, self._win_rumor_cov)
            )
            return ds

    @property
    def health_counters(self) -> Dict[str, int]:
        self.flush()
        return self._health_counters

    @property
    def pool_high_water(self) -> int:
        self.flush()
        return self._pool_high_water

    @property
    def segmentation_warnings(self) -> int:
        self.flush()
        return self._segmentation_warnings

    def run_until(self, predicate: Callable[["SimDriver"], bool], max_ticks: int = 10_000) -> bool:
        for _ in range(max_ticks):
            if predicate(self):
                return True
            self.step()
        return predicate(self)

    # -- membership events (host-side diff of watched rows) ----------------
    def _view_row_host(self, row: int) -> np.ndarray:
        """A host copy of ``row``'s view keys (on the CPU the engine's row may
        be a view of the live plane, which the next window updates in place:
        a watch's baseline must not move with it)."""
        with self._mesh_ctx():
            return self._eng.view_row(self.state, row).cpu().numpy().copy()

    def watch(self, row: int) -> EventStream:
        """Start emitting MembershipEvents as observed by node ``row``."""
        with self._lock:
            if row not in self._watches:
                key = self._view_row_host(row)
                w = _Watch(row=row, prev_key=key)
                for j in np.nonzero(key >= 0)[0]:
                    w.known[int(j)] = self._member_handle(int(j))
                self._watches[row] = w
            return self._watches[row].stream

    def events_of(self, row: int) -> List[MembershipEvent]:
        self.watch(row)
        return self._watches[row].log

    def _member_handle(self, row: int) -> Member:
        if row not in self.members:
            self.members[row] = Member(id=f"sim-{row}", address=row_address(row))
        return self.members[row]

    def _diff_row(self, w: _Watch, key: np.ndarray) -> None:
        lay = self._lay
        for j in np.nonzero(key != w.prev_key)[0]:
            j = int(j)
            old_k, new_k = int(w.prev_key[j]), int(key[j])
            old_s, new_s = _status_of_key(old_k), _status_of_key(new_k)
            evs: List[MembershipEvent] = []
            old_e = (old_k >> lay.epoch_shift) & lay.epoch_mask if old_k >= 0 else -1
            new_e = (new_k >> lay.epoch_shift) & lay.epoch_mask if new_k >= 0 else -1
            if old_k >= 0 and new_k >= 0 and old_e != new_e:
                # identity epoch flip: the row was re-occupied by a FRESH
                # member; the old identity is gone and the new one, if
                # alive-ish, is a separate ADDED
                if old_s not in (UNKNOWN, DEAD):
                    evs.append(MembershipEvent.removed(w.known.pop(j, self._member_handle(j))))
                else:
                    w.known.pop(j, None)
                if new_s in (ALIVE, SUSPECT, LEAVING):
                    w.known[j] = self._member_handle(j)
                    evs.append(MembershipEvent.added(w.known[j]))
            # old DEAD counts as "not a member": REMOVED fired when the
            # record went DEAD; a later DEAD->ALIVE flip is a fresh ADDED
            elif old_s in (UNKNOWN, DEAD) and new_s in (ALIVE, SUSPECT, LEAVING):
                w.known[j] = self._member_handle(j)
                evs.append(MembershipEvent.added(w.known[j]))
            elif new_s == LEAVING and old_s != LEAVING:
                evs.append(MembershipEvent.leaving(w.known.get(j, self._member_handle(j))))
            elif new_s == DEAD and old_s != DEAD:
                # the later DEAD->UNKNOWN table cleanup is internal, not an event
                evs.append(MembershipEvent.removed(w.known.pop(j, self._member_handle(j))))
            elif (
                new_s == ALIVE
                and old_s in (ALIVE, SUSPECT)
                and ((new_k >> 2) & lay.inc_mask) > ((old_k >> 2) & lay.inc_mask)
            ):
                # incarnation bump while alive = metadata/refutation update
                evs.append(MembershipEvent.updated(w.known.get(j, self._member_handle(j)), None, None))
            for ev in evs:
                w.log.append(ev)
                w.stream.emit(ev)

    # -- lifecycle / churn --------------------------------------------------
    def join(self, seed_rows: Sequence[int] = (0,)) -> int:
        """Activate a free row as a fresh member; returns its row. Prefers a
        row no up member still has records about, so a row whose previous
        occupant is still SUSPECT/DEAD in peers' tables is reused last."""
        with self._lock:
            return self._join_locked(seed_rows)

    def _join_locked(self, seed_rows: Sequence[int]) -> int:
        whole = self._whole_state("up", "nbr_id", "view_key")
        up = whole.up.cpu().numpy()
        free = np.nonzero(~up)[0]
        if len(free) == 0:
            raise RuntimeError("no free rows (capacity exhausted)")
        remembered = self._eng.remembered_rows(whole).cpu().numpy()
        forgotten = free[~remembered[free]]
        row = int(forgotten[0]) if len(forgotten) else int(free[0])
        self._apply(lambda st: self._ops.join_row(st, row, tuple(seed_rows)))
        # a restart reuses the row but is a NEW member identity
        self.members[row] = Member(id=f"sim-{self._next_member_ordinal}", address=row_address(row))
        self._next_member_ordinal += 1
        # the joiner's self-announce can drop when the pool has no victim;
        # probed only for a registered health consumer, as a device scalar
        # read at the next flush()
        if self._eng.has_pool and self._health_interest:
            in_pool = ((self.state.mr_subject == row) & self.state.mr_active).any()
            miss = (~in_pool).to(torch.int32)
            self._join_probe = miss if self._join_probe is None else self._join_probe + miss
        tick = self.tick
        self._recent_joins = [
            (t, r) for (t, r) in self._recent_joins[-4096:]
            if tick - t <= self._join_horizon and r != row
        ]
        self._recent_joins.append((tick, row))
        self._rumor_cov_dirty = True  # the up set changed under the cache
        self._publish("driver", "join", row=row, member=self.members[row].id)
        return row

    def crash(self, row: int) -> None:
        with self._lock:
            self._apply(lambda st: self._ops.crash_row(st, row))
            self._rumor_cov_dirty = True
            self._publish("driver", "crash", row=row)

    def leave(self, row: int, crash_after_ticks: int = 0) -> None:
        with self._lock:
            self._apply(lambda st: self._ops.begin_leave(st, row))
            self._publish("driver", "leave", row=row)
        if crash_after_ticks:
            self.step(crash_after_ticks)
            self.crash(row)

    def update_metadata(self, row: int) -> None:
        with self._lock:
            self._apply(lambda st: self._ops.update_metadata(st, row))

    def update_metadata_batch(self, rows: Sequence[int]) -> None:
        """Metadata bumps for a batch of rows, in order."""
        with self._lock:
            def batch(st):
                for row in rows:
                    st = self._ops.update_metadata(st, int(row))
                return st

            self._apply(batch)

    # -- rumors (spreadGossip) ----------------------------------------------
    def spread_rumor(self, origin: int, payload: object) -> int:
        """Start a user rumor; returns its slot. Payloads live host-side;
        slots are tracked host-side, and only an exhausted free list pays
        one readback to reclaim slots the device sweep has freed."""
        with self._lock:
            slot = self._claim_rumor_slot_locked()
            self._apply(lambda st: self._ops.spread_rumor(st, slot, origin))
            self._rumor_payloads[slot] = payload
            self._rumor_cov_dirty = True  # the cached coverage predates this rumor
            self._rumor_spread_pending[slot] = self._host_tick
            self._publish("driver", "rumor_spread", slot=slot, origin=origin)
            return slot

    def _claim_rumor_slot_locked(self) -> int:
        if not self._free_rumor_slots:
            # None (unknown after a restore) or spent: read the state
            active = self.state.rumor_active.cpu().numpy()
            self._note_readback(1)
            self._free_rumor_slots = [int(s) for s in np.nonzero(~active)[0]]
        if not self._free_rumor_slots:
            raise RuntimeError("no free rumor slots")
        return self._free_rumor_slots.pop(0)

    def rumor_coverage(self, slot: int) -> float:
        """Fraction of up members infected with rumor ``slot`` at the last
        window boundary (the flushed end-of-window vector); when host
        mutations postdate it, one [R] reduce on the device refreshes it."""
        with self._lock:
            self._flush_locked()
            if self._rumor_cov_host is None or self._rumor_cov_dirty:
                whole = self._whole_state("up", "infected")
                up = whole.up
                # the dense engine stores the infection bits packed
                infected = getattr(whole, "infected_bool", whole.infected)
                cov = (infected & up[:, None]).sum(dim=0).to(torch.float32) / (
                    up.sum().clamp(min=1).to(torch.float32)
                )
                self._rumor_cov_host = cov.cpu().numpy()
                self._rumor_cov_dirty = False
                self._note_readback(1)
            return float(self._rumor_cov_host[slot])

    def rumor_payload(self, slot: int) -> object:
        return self._rumor_payloads.get(slot)

    # -- links (pview: group partitions; dense, sparse: the scalar or [N, N]
    # -- plane; link delay needs the dense engine's rings) ---------------------
    def set_link_loss(self, src, dst, loss: float) -> None:
        with self._lock:
            self._apply(lambda st: self._ops.set_link_loss(st, src, dst, loss))

    def set_link_delay(self, src, dst, mean_delay_ticks: float) -> None:
        """Outbound mean delay in ticks on the links src -> dst (the dense
        engine with ``params.delay_slots > 0``)."""
        with self._lock:
            self._apply(lambda st: self._ops.set_link_delay(st, src, dst, mean_delay_ticks))

    def block_partition(self, group_a, group_b) -> None:
        with self._lock:
            self._apply(lambda st: self._ops.block_partition(st, group_a, group_b))

    def heal_partition(self, group_a, group_b) -> None:
        with self._lock:
            self._apply(lambda st: self._ops.heal_partition(st, group_a, group_b))

    def link_loss(self, src: int, dst: int) -> float:
        """Loss on the link src -> dst: the uniform scalar where the engine
        keeps no per-link plane (pview; sparse without ``dense_links``)."""
        with self._lock:
            loss = self.state.loss
            return float(loss) if loss.dim() == 0 else float(loss[src, dst])

    # -- views --------------------------------------------------------------
    def view_of(self, row: int) -> tuple[np.ndarray, np.ndarray]:
        """(status, incarnation) of node ``row``'s synthesized view."""
        with self._lock:
            key = self._view_row_host(row)
        status = np.where(key < 0, np.int8(UNKNOWN), _RANK_TO_STATUS_NP[key & 3])
        inc = np.where(key < 0, 0, (key >> 2) & self._lay.inc_mask).astype(np.int32)
        return status, inc

    def status_of(self, observer: int, subject: int) -> MemberStatus | None:
        with self._lock, self._mesh_ctx():
            s = _status_of_key(int(self._eng.view_row(self.state, observer)[subject]))
        return None if s == UNKNOWN else MemberStatus(s)

    def is_up(self, row: int) -> bool:
        with self._lock:
            return bool(self._whole(self.state.up)[row])

    # -- engine health ------------------------------------------------------
    def health_snapshot(self) -> dict:
        """Protocol health: rumor-pool backpressure (occupancy, high-water,
        per-source announce drops, evictions; the ``pool`` block only on
        the engines with a pool), identity-dissemination
        staleness (per-subject counts of up observers holding a stale
        record, and lag cohorts of recent joins), per-slot rumor coverage.
        A sync point: it flushes every staged reduction, and registers
        health interest (the join() pool probe)."""
        with self._lock:
            return self._health_snapshot_locked()

    def _health_snapshot_locked(self) -> dict:
        self._health_interest = True
        self._flush_locked()
        whole = self._whole_state("up", "nbr_id", "nbr_key", "self_key", "view_key")
        stale, n_up = self._eng.staleness(whole)
        stale = stale.cpu().numpy()
        n_up = int(n_up)
        observers = max(n_up - 1, 1)
        tick = self.tick
        self._recent_joins = [
            (t, r) for (t, r) in self._recent_joins if 0 <= tick - t <= self._join_horizon
        ]
        cohorts = [
            {"row": r, "age_ticks": tick - t, "coverage": round(1.0 - float(stale[r]) / observers, 4)}
            for (t, r) in self._recent_joins
            if bool(whole.up[r])
        ]
        cov = self._rumor_cov_host
        out = {
            "engine": self.engine,
            "tick": tick,
            "n_up": n_up,
            "announce": dict(self._health_counters),
            "dispatch": self.dispatch_snapshot(),
            "staleness": {
                "stale_subjects": int((stale > 0).sum()),
                "worst_subject_stale_observers": int(stale.max()) if stale.size else 0,
                "recent_join_cohorts": cohorts,
                "worst_recent_join_coverage": min(c["coverage"] for c in cohorts) if cohorts else None,
            },
            "rumors": {
                "tracked_slots": sorted(self._rumor_payloads),
                "coverage": (
                    {int(s): round(float(cov[s]), 4) for s in sorted(self._rumor_payloads) if s < len(cov)}
                    if cov is not None else None
                ),
                "stale": bool(self._rumor_cov_dirty),
            },
        }
        if self._eng.has_pool:
            out["pool"] = {
                "mr_slots": self._eng.pool_slots(self.params),
                "active_now": int(self.state.mr_active.sum()),
                "high_water": self._pool_high_water,
            }
        if self._chaos is not None:
            out["chaos"] = self._chaos.snapshot()
        if self._trace is not None:
            # host-only counters (cursor arithmetic): the ring itself is not
            # read here
            out["trace"] = self._trace.stats()
        if self._control is not None:
            snap = self._control.snapshot()
            out["control"] = {
                k: snap[k]
                for k in ("rung", "rung_name", "actuated", "epoch", "actuations", "stale_epochs", "last_sensors")
            }
        return out

    def enable_health_probes(self) -> None:
        """Register health interest without taking a snapshot: turns on the
        join() pool probe."""
        self._health_interest = True

    def jit_cache_audit(self) -> dict:
        """The window functions this driver ran and the kernels' build
        cache: one line per (ticks, watched rows, traced, adaptive) — the
        JAX driver's program key — with its engine, calls and the first
        call's wall time, and :func:`..compile_cache.compile_cache_report`."""
        from .. import compile_cache

        with self._lock:  # _step_stats mutates under the lock in step()
            programs = [
                {
                    "n_ticks": k[0], "n_watch": k[1], "traced": k[2], "adaptive": k[3],
                    "engine": self.engine, "calls": v["calls"],
                    "first_dispatch_s": v["first_dispatch_s"],
                }
                for k, v in sorted(self._step_stats.items())
            ]
        return {"programs": programs, "persistent_cache": compile_cache.compile_cache_report()}

    def arm_telemetry(self, config=None, bus=None):
        """Arm the telemetry plane on this driver; returns the
        :class:`..telemetry.TelemetryPlane` (the armed one, if any).
        ``config`` is a :class:`..config.ClusterConfig` or a
        :class:`..config.TelemetryConfig` (None: the defaults); ``bus`` an
        existing :class:`..telemetry.TelemetryBus` to merge into.

        Arming is a pure consumer: each window appends ONE f32 row to the
        device metric ring, reduced from the window's metric outputs, so
        stepping stays free of transfers and the trajectory is the unarmed
        driver's, bit for bit."""
        from ..config import ClusterConfig
        from ..telemetry.plane import TelemetryPlane

        with self._lock:
            if self._telemetry is not None:
                return self._telemetry
            if isinstance(config, ClusterConfig):
                config = config.telemetry
            self._telemetry = TelemetryPlane(self, config=config, bus=bus)
            self._telemetry.bus.publish(
                "driver", "telemetry_armed", tick=self._host_tick,
                engine=self.engine, capacity=self.params.capacity,
            )
            return self._telemetry

    @property
    def telemetry(self):
        """The armed :class:`..telemetry.TelemetryPlane`, or None."""
        return self._telemetry

    def _publish(self, source: str, kind: str, **fields) -> None:
        """One host-side lifecycle record onto the armed telemetry bus (a
        no-op when unarmed; never touches the device)."""
        if self._telemetry is not None:
            self._telemetry.bus.publish(source, kind, tick=self._host_tick, **fields)

    def arm_trace(self, config=None, tracer_rows=None, rumor_slots=None):
        """Arm the causal trace plane; returns the :class:`..trace.TracePlane`
        (the armed one, if any). ``config`` is a :class:`..config.ClusterConfig`
        or a :class:`..config.TraceConfig` (None: the defaults, the first
        ``TraceConfig.tracers`` rows); ``tracer_rows`` / ``rumor_slots``
        override its sampling.

        Arming swaps the window for the engine's traced window: every tick
        appends one [K, n_fields] int32 record block to the device trace
        ring in place, and each window boundary one summary block. The
        trajectory stays the unarmed driver's, bit for bit, and stepping
        reads nothing back; the ring is read only at sync points
        (:meth:`..trace.TracePlane.snapshot`, a flight dump, a chaos
        report). Refused with the adaptive plane or the control plane
        armed (the controller may arm adaptive FD, which the traced tick
        does not support)."""
        from ..config import ClusterConfig
        from ..trace.plane import TracePlane

        with self._lock:
            if self._trace is not None:
                return self._trace
            if self._ad is not None:
                raise ValueError(
                    "trace capture and adaptive failure detection cannot share a driver yet — "
                    "use set_adaptive(None) first, or trace a static-FD driver"
                )
            if self._control is not None:
                raise ValueError(
                    "trace capture and the control plane cannot share a driver (the controller "
                    "may arm adaptive FD)"
                )
            if self.mesh is not None and self._eng.make_sharded_traced_run is None:
                raise ValueError(
                    f"trace capture is single-device for the {self.engine} engine — arm on an unsharded "
                    "driver (the ring append is row-global)"
                )
            if isinstance(config, ClusterConfig):
                config = config.trace
            self._trace = TracePlane(self, config=config, tracer_rows=tracer_rows, rumor_slots=rumor_slots)
            self._publish(
                "driver", "trace_armed",
                tracers=list(self._trace.spec.tracer_rows),
                rumor_slots=list(self._trace.spec.rumor_slots),
            )
            return self._trace

    @property
    def trace(self):
        """The armed :class:`..trace.TracePlane`, or None."""
        return self._trace

    def set_dissemination(self, spec=None, *, strategy=None, topology=None, **spec_kw) -> None:
        """Swap the dissemination strategy/topology on a live driver.

        Pass a full :class:`..dissemination.DissemSpec`, or field overrides
        (``strategy=``/``topology=``/any other spec field) applied on top
        of the current spec. The spec is a static property of the params:
        the next window runs the new gossip phase (the state itself is
        spec-independent, so no state migration happens and checkpoints
        stay compatible). The driver builds its window from ``params`` at
        every step and caches nothing per params, so replacing them is the
        whole swap. A no-op when the requested spec equals the armed one."""
        import dataclasses

        with self._lock:
            cur = self.params.dissem
            if spec is None:
                overrides = {
                    k: v
                    for k, v in dict(strategy=strategy, topology=topology, **spec_kw).items()
                    if v is not None
                }
                spec = dataclasses.replace(cur, **overrides) if overrides else cur
            if spec == cur:
                return
            self.params = dataclasses.replace(self.params, dissem=spec)

    def set_adaptive(self, spec=None, *, enabled: bool | None = None, **spec_kw) -> None:
        """Swap the adaptive-FD spec on a live driver.

        Pass a full :class:`..adaptive.AdaptiveSpec`, or ``None`` plus field
        overrides applied to the current spec; ``set_adaptive(None)`` with
        no overrides disarms. Like :meth:`set_dissemination` the spec is a
        static property of the params; arming or disarming also creates or
        drops the adaptive planes, and a changed spec starts them fresh
        (scores are evidence about the current conditions; a knob change
        is a new experiment). A no-op when the spec and the armed state
        already agree."""
        import dataclasses

        from ..adaptive import AdaptiveSpec

        with self._lock:
            cur = self.params.adaptive
            if spec is None:
                overrides = {k: v for k, v in dict(enabled=enabled, **spec_kw).items() if v is not None}
                spec = dataclasses.replace(cur, **overrides) if overrides else AdaptiveSpec()
            if spec == cur and (self._ad is not None) == (not spec.is_default):
                return
            if not spec.is_default and self.mesh is not None and self._eng.make_sharded_adaptive_run is None:
                raise ValueError(f"adaptive failure detection is single-device for the {self.engine} engine")
            if not spec.is_default and self._trace is not None:
                raise ValueError("trace capture and adaptive failure detection cannot share a driver yet")
            self.params = dataclasses.replace(self.params, adaptive=spec)
            self._ad = None if spec.is_default else self._init_adaptive()

    @property
    def adaptive_state(self):
        """The armed :class:`..adaptive.AdaptiveState`, or None (static FD)."""
        return self._ad

    def set_protocol_knobs(self, *, fanout: int | None = None, suspicion_mult: int | None = None) -> None:
        """Live-swap the gossip ``fanout`` and/or the static
        ``suspicion_mult`` (the control plane's actuator). Like the
        dissemination and adaptive swaps these are properties of the params,
        not of the state: the next window runs with them, the state is left
        untouched and checkpoints stay compatible. A no-op when nothing
        changes."""
        import dataclasses

        with self._lock:
            updates = {}
            if fanout is not None and fanout != self.params.fanout:
                if fanout < 1:
                    raise ValueError("fanout must be >= 1")
                updates["fanout"] = int(fanout)
            if suspicion_mult is not None and suspicion_mult != self.params.suspicion_mult:
                if suspicion_mult < 1:
                    raise ValueError("suspicion_mult must be >= 1")
                updates["suspicion_mult"] = int(suspicion_mult)
            if updates:
                self.params = dataclasses.replace(self.params, **updates)

    def arm_control(self, spec=None, config=None):
        """Arm the closed-loop control plane; returns the
        :class:`..control.ControlPlane` (the armed one, if any). ``spec`` is
        a :class:`..control.ControlSpec` (None: the defaults, or derived
        from ``config``, a :class:`..config.ClusterConfig`). It arms the
        telemetry plane too: the metric ring is the sensor.

        Arming is knob-passive: no knob changes until the decision rule
        fires, so an armed but idle driver's trajectory is the unarmed
        one's. Sensor reads happen once per control epoch. Refused with the
        trace plane armed, and for the blind and unclamped controllers
        (certification arms only)."""
        from ..control import ControlPlane

        with self._lock:
            if self._control is not None:
                return self._control
            if self._trace is not None:
                raise ValueError(
                    "trace capture and the control plane cannot share a driver (the controller may "
                    "arm adaptive FD, which traced windows do not support yet)"
                )
            if self.mesh is not None and self._eng.make_sharded_adaptive_run is None:
                from ..config import ClusterConfig
                from ..control import ControlSpec

                resolved = spec
                if resolved is None:
                    resolved = ControlSpec.from_config(config) if isinstance(config, ClusterConfig) else ControlSpec()
                if any(r.adaptive for r in resolved.ladder):
                    raise ValueError(
                        "this ladder's rungs arm adaptive FD, and the "
                        f"{self.engine} engine has no sharded adaptive "
                        "window builder (make_sharded_adaptive_run) — use "
                        "a static-rung ladder or an unsharded driver"
                    )
            self._control = ControlPlane(self, spec=spec, config=config)
            return self._control

    @property
    def control(self):
        """The armed :class:`..control.ControlPlane`, or None."""
        return self._control

    def control_snapshot(self) -> dict:
        """The controller's view: spec, rung and the bounded decision log,
        or ``{"armed": False}``. Host values only — never a device read."""
        plane = self._control
        if plane is None:
            return {"armed": False}
        return plane.snapshot()

    def run_scenario(
        self,
        scenario,
        *,
        config=None,
        sentinels: bool = True,
        max_window: int = 32,
        trace: bool = False,
        strategy: str | None = None,
        topology: str | None = None,
        dissem=None,
        adaptive=None,
    ) -> dict:
        """Run a :class:`..chaos.Scenario` against this driver: its fault
        events applied between windows, the SWIM invariant sentinels
        checked on the device, windows of at most ``max_window`` ticks.
        Stepping reads nothing back; the returned report is the one sync
        point. ``strategy=`` / ``topology=`` / ``dissem=`` arm a
        dissemination spec (:meth:`set_dissemination`) and ``adaptive=`` an
        adaptive spec (:meth:`set_adaptive`) first. ``trace=True`` arms
        the trace plane on the scenario's crashed rows (up to
        ``TraceConfig.tracers``) and attaches each traced crash subject's
        detection tree to the report (``trace_spans``; crashed rows left
        untraced are named in ``untraced_crash_rows``)."""
        from ..chaos.engine import run_driver_scenario

        if dissem is not None or strategy is not None or topology is not None:
            self.set_dissemination(dissem, strategy=strategy, topology=topology)
        if adaptive is not None:
            self.set_adaptive(adaptive)
        return run_driver_scenario(
            self, scenario, config=config, sentinels=sentinels, max_window=max_window, trace=trace,
        )

    def chaos_snapshot(self) -> dict:
        """The armed scenario's progress and sentinel report, or ``{"armed":
        False}`` when none was ever armed. A sync point, like every other
        snapshot."""
        runner = self._chaos
        if runner is None:
            return {"armed": False}
        return runner.snapshot()

    # -- checkpoint/resume ---------------------------------------------------
    def checkpoint(self, path: str) -> None:
        """Full resumable snapshot: the state planes, the generator's state
        and the host-side identity map, payloads and health counters.

        Crash-safe: written to a temp file beside ``path``, fsynced, and
        moved into place. The archive keeps the JAX driver's layout (state
        planes, ``_host`` pickle, ``_schema``, ``_crc32``, ``_engine``) and
        adds ``_framework``; :meth:`restore` checks them all. A driver fed
        by a caller's ``draws`` source cannot be checkpointed: that source's
        position is not the driver's to save."""
        from ..ops.sharding import MEMBER_AXIS

        if self._draws is not None:
            raise ValueError("a driver with a caller-supplied draws source cannot be checkpointed")
        with self._lock:
            payload = self._checkpoint_payload_locked()
        target = os.path.abspath(path)
        if self.mesh is None or self.mesh.get_local_rank(MEMBER_AXIS) == 0:  # one writer
            fd, tmp = tempfile.mkstemp(prefix=os.path.basename(target) + ".tmp-", dir=os.path.dirname(target))
            try:
                with os.fdopen(fd, "wb") as fh:
                    np.savez_compressed(fh, **payload)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        if self.mesh is not None:
            # no rank returns (or restores) before the archive is whole
            import torch.distributed as dist

            dist.barrier(group=self.mesh.get_group(MEMBER_AXIS))
        self._publish("checkpoint", "saved", path=target)

    def _checkpoint_payload_locked(self) -> dict:
        self._flush_locked()  # fold staged device reductions into host counters
        host = {
            "members": dict(self.members),
            "rumor_payloads": dict(self._rumor_payloads),
            "next_member_ordinal": self._next_member_ordinal,
            "metrics_len": len(self.metrics_history),
            # health accumulators belong to the checkpointed timeline
            "health_counters": dict(self._health_counters),
            "pool_high_water": self._pool_high_water,
            "segmentation_warnings": self._segmentation_warnings,
            "recent_joins": list(self._recent_joins),
            "free_rumor_slots": (
                list(self._free_rumor_slots) if self._free_rumor_slots is not None else None
            ),
            "rng": self._rng.bit_generator.state,
        }
        if self._control is not None:
            # controller memory (rung, dwell, decision log) follows the
            # timeline; an optional key, so control-less archives still load
            host["control_state"] = self._control.state_dict()
        host_bytes = pickle.dumps(host)
        # the unsharded driver's archive: on a mesh every rank gathers the
        # whole state (the same on every rank)
        whole = self.state if self.mesh is None else self._eng.gather_state(self.state, self.mesh)
        payload = dict(
            self._ops.snapshot(whole),
            _gen=self._gen.get_state().numpy(),
            _host=np.frombuffer(host_bytes, dtype=np.uint8),
            _schema=np.int32(CHECKPOINT_SCHEMA),
            _crc32=np.uint32(zlib.crc32(host_bytes) & 0xFFFFFFFF),
            _engine=np.bytes_(self.engine.encode()),
            _framework=np.bytes_(FRAMEWORK.encode()),
        )
        if self._ad is not None:
            # the adaptive planes follow the timeline (optional members; a
            # static driver's restore ignores them)
            from ..adaptive import AdaptiveState, adaptive_state_arrays

            ad = self._ad if self.mesh is None else AdaptiveState(
                *(self._whole(getattr(self._ad, k)) for k in ("lh", "conf_key", "conf")))
            payload.update(adaptive_state_arrays(ad))
        return payload

    def restore(self, path: str) -> None:
        """Load a :meth:`checkpoint` archive. Every check runs before the
        driver changes: an archive without ``_framework = "torch"`` (the
        JAX driver's, whose pickle would import the JAX package) is refused
        before anything is unpickled; so are a newer schema, another engine,
        a failed CRC, missing members, state planes of another shape and a
        key dtype other than this driver's. On a mesh every rank reads the
        archive and keeps its rows."""
        try:
            with self._lock:
                self._restore_locked(path)
        except CheckpointError as exc:
            # a failed restore is a post-mortem moment: the flight recorder
            # keeps the last windows and the bus tail before the error
            if self._telemetry is not None:
                self._telemetry.flight_record("checkpoint_error", context={"path": path, "error": str(exc)})
            raise
        self._publish("checkpoint", "restored", path=path)

    def _restore_locked(self, path: str) -> None:
        try:
            with np.load(path) as npz:
                data = dict(npz)
        except FileNotFoundError:
            raise
        except Exception as exc:  # zipfile/npy deep failures -> one clear error
            raise CheckpointError(f"checkpoint {path!r} is unreadable (truncated or corrupt): {exc}") from exc

        def text(name):
            raw = data.pop(name, None)
            return None if raw is None else bytes(raw.tobytes()).rstrip(b"\x00").decode()

        framework = text("_framework")
        if framework != FRAMEWORK:
            raise CheckpointError(
                f"checkpoint {path!r} was not written by the PyTorch port "
                f"(framework {framework!r}); a JAX driver's archive restores into the JAX driver"
            )
        schema = int(data.pop("_schema", 1))
        if schema > CHECKPOINT_SCHEMA:
            raise CheckpointError(
                f"checkpoint {path!r} has schema {schema}, newer than this build's "
                f"{CHECKPOINT_SCHEMA} — refusing a partial decode"
            )
        engine = text("_engine")
        if engine is not None and engine != self.engine:
            raise CheckpointError(
                f"checkpoint {path!r} was written by the {engine} engine; this driver runs the {self.engine} engine"
            )
        crc_expect = data.pop("_crc32", None)
        if "_gen" not in data or "_host" not in data:
            raise CheckpointError(f"checkpoint {path!r} is missing required members (truncated?)")
        host_bytes = data.pop("_host").tobytes()
        if crc_expect is not None and (zlib.crc32(host_bytes) & 0xFFFFFFFF) != int(crc_expect):
            raise CheckpointError(f"checkpoint {path!r} failed its CRC32 check (corrupt)")
        gen_state = torch.from_numpy(data.pop("_gen").copy())
        try:
            host = pickle.loads(host_bytes)
        except Exception as exc:
            raise CheckpointError(f"checkpoint {path!r} host section does not unpickle: {exc}") from exc
        # the adaptive planes are optional members, not engine state planes
        ad_arrays = {k: data.pop(k) for k in ("_ad_lh", "_ad_conf_key", "_ad_conf") if k in data}
        try:
            # the archive holds the whole state; a rank of a mesh keeps its rows
            state = self._ops.restore(data, device=self.device if self.mesh is None else "cpu")
        except TypeError as exc:  # missing/extra planes: foreign or truncated
            raise CheckpointError(f"checkpoint {path!r} state planes do not match this engine: {exc}") from exc
        have = self._eng.key_plane(state).dtype
        if have != self._key_dtype:
            raise CheckpointError(
                f"checkpoint {path!r} stores {have} keys but this driver runs "
                f"{self._key_dtype} keys — restore into a driver configured for the stored layout"
            )
        gen = torch.Generator(device=self.device)
        try:
            gen.set_state(gen_state)
        except RuntimeError as exc:
            raise CheckpointError(f"checkpoint {path!r} holds another device's generator state: {exc}") from exc

        if self.mesh is not None:
            state = self._eng.shard_state(state, self.mesh)
        self.state = state
        self._gen = gen
        if self._control is not None:
            # before the adaptive planes restore: re-applying the rung's
            # knobs (set_adaptive starts fresh planes) must not discard the
            # evidence the checkpoint carries
            if "control_state" in host:
                self._control.load_state_dict(host["control_state"])
            else:
                self._control.reset_for_restore()
        if self._ad is not None:
            # an adaptive driver restoring a static checkpoint starts fresh
            from ..adaptive import init_adaptive_state, restore_adaptive_state

            if len(ad_arrays) == 3:
                self._ad = restore_adaptive_state(ad_arrays, device=self.device if self.mesh is None else "cpu")
                if self.mesh is not None:
                    from ..ops.sharding import shard_adaptive_state

                    self._ad = shard_adaptive_state(self._ad, self.mesh)
            else:
                self._ad = self._init_adaptive()
        self.members = host["members"]
        self._rumor_payloads = host["rumor_payloads"]
        self._next_member_ordinal = host["next_member_ordinal"]
        del self.metrics_history[host["metrics_len"]:]  # drop the abandoned timeline
        # staged reductions belong to the abandoned timeline
        self._win_accum = self._win_pool_hw = self._win_seg_warn = None
        self._join_probe = None
        self._win_rumor_cov = None
        self._rumor_cov_host = None
        self._rumor_cov_dirty = True
        self._rumor_spread_pending = {}
        self._free_rumor_slots = host.get("free_rumor_slots")
        self._health_counters = dict(host["health_counters"])
        self._pool_high_water = host["pool_high_water"]
        self._segmentation_warnings = host["segmentation_warnings"]
        self._recent_joins = [tuple(j) for j in host["recent_joins"]]
        if "rng" in host:  # archives written before the sim transport lack it
            self._rng = np.random.default_rng()
            self._rng.bit_generator.state = host["rng"]
        if self._trace is not None:
            # clear the ring (records of the abandoned timeline would sew
            # into the restored one) and re-baseline the column mirror
            self._trace.on_restore(state)
        # re-baseline watches so a restore emits no phantom events
        for w in self._watches.values():
            w.prev_key = self._view_row_host(w.row)
            w.known = {
                int(j): self.members.get(int(j), self._member_handle(int(j)))
                for j in np.nonzero(w.prev_key >= 0)[0]
            }
