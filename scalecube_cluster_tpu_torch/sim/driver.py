"""SimDriver: the host loop around the device-resident SWIM simulation.

A port of the JAX package's ``sim/driver.py`` over the partial-view and
sparse engines on one device (the params type picks the engine,
:func:`..ops.engine_api.resolve`). The driver owns:

* the engine's window (:func:`..ops.pview.make_pview_run`,
  :func:`..ops.sparse.make_sparse_run`) and its randomness: a ``torch.Generator`` on the driver's device,
  seeded with ``seed``, that each window draws its per-tick uniforms from
  (the JAX driver's key chain plays this part there);
* the id↔row mapping (``Member`` handles with ``sim://row`` addresses);
* membership-event extraction for *watched* rows — per-tick host diffs of
  those rows' synthesized views, emitting ADDED / LEAVING / REMOVED /
  UPDATED;
* the per-window health reductions (counter sums, pool high-water,
  segmentation warnings, end-of-window rumor coverage), kept ON DEVICE and
  read to the host only at a sync point: :meth:`flush`,
  :meth:`health_snapshot`, :meth:`checkpoint`, or the ``health_counters`` /
  ``pool_high_water`` / ``segmentation_warnings`` properties;
* checkpoint/resume of the full state, the generator included.

``dispatch_stats`` counts the driver's own device→host readbacks as the
JAX driver does: a watch or ``record_metrics`` adds one per window, a flush
one per staged reduction. The tick itself reads one flag to the host per
data-keyed branch; :data:`..ops._tensor.HOST_SYNCS` counts those.

Not ported yet, and refused by name: meshes (ROADMAP A12), the telemetry,
trace and chaos planes (A10), dissemination and adaptive knobs (A8),
protocol knobs and the control plane (A11), the compile-cache audit (A13).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
        the JAX driver's own key chain through it)."""
        if mesh is not None:
            _not_ported("a sharded driver (mesh=)", "A12")
        if compile_cache_dir:
            _not_ported("the compile-cache directory", "A13")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SimDriver(device='cuda') needs a CUDA device; pass device='cpu' "
                "to run on the host"
            )
        self.params = params
        self._eng = engine_api.resolve(params)
        self.engine = self._eng.name
        self._ops = self._eng.ops
        self.record_metrics = record_metrics
        if dense_links is None:
            dense_links = self._eng.dense_links_default
        self.state = self._eng.init_state(params, n_initial, warm, dense_links, self.device)
        self._key_dtype = self._eng.key_plane(self.state).dtype
        self._lay = layout_for(self._key_dtype)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._draws = draws
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

    # -- time ---------------------------------------------------------------
    @property
    def tick(self) -> int:
        with self._lock:
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
        step = self._eng.make_run(self.params, n_ticks)
        source = self._gen if self._draws is None else self._draws(n_ticks)
        self.state, ms, watched = step(self.state, source, watch_rows=watch_arr)
        ds = self.dispatch_stats
        ds["windows_dispatched"] += 1
        ds["ticks_dispatched"] += n_ticks
        ds["queue_depth"] += 1
        ds["queue_high_water"] = max(ds["queue_high_water"], ds["queue_depth"])
        self._accumulate_window(ms)
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
        return self._eng.view_row(self.state, row).cpu().numpy()

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
        up = self.state.up.cpu().numpy()
        free = np.nonzero(~up)[0]
        if len(free) == 0:
            raise RuntimeError("no free rows (capacity exhausted)")
        remembered = self._eng.remembered_rows(self.state).cpu().numpy()
        forgotten = free[~remembered[free]]
        row = int(forgotten[0]) if len(forgotten) else int(free[0])
        self.state = self._ops.join_row(self.state, row, tuple(seed_rows))
        # a restart reuses the row but is a NEW member identity
        self.members[row] = Member(id=f"sim-{self._next_member_ordinal}", address=row_address(row))
        self._next_member_ordinal += 1
        # the joiner's self-announce can drop when the pool has no victim;
        # probed only for a registered health consumer, as a device scalar
        # read at the next flush()
        if self._health_interest:
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
        return row

    def crash(self, row: int) -> None:
        with self._lock:
            self.state = self._ops.crash_row(self.state, row)
            self._rumor_cov_dirty = True

    def leave(self, row: int, crash_after_ticks: int = 0) -> None:
        with self._lock:
            self.state = self._ops.begin_leave(self.state, row)
        if crash_after_ticks:
            self.step(crash_after_ticks)
            self.crash(row)

    def update_metadata(self, row: int) -> None:
        with self._lock:
            self.state = self._ops.update_metadata(self.state, row)

    def update_metadata_batch(self, rows: Sequence[int]) -> None:
        """Metadata bumps for a batch of rows, in order."""
        with self._lock:
            for row in rows:
                self.state = self._ops.update_metadata(self.state, int(row))

    # -- rumors (spreadGossip) ----------------------------------------------
    def spread_rumor(self, origin: int, payload: object) -> int:
        """Start a user rumor; returns its slot. Payloads live host-side;
        slots are tracked host-side, and only an exhausted free list pays
        one readback to reclaim slots the device sweep has freed."""
        with self._lock:
            slot = self._claim_rumor_slot_locked()
            self.state = self._ops.spread_rumor(self.state, slot, origin)
            self._rumor_payloads[slot] = payload
            self._rumor_cov_dirty = True  # the cached coverage predates this rumor
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
                up = self.state.up
                cov = (self.state.infected & up[:, None]).sum(dim=0).to(torch.float32) / (
                    up.sum().clamp(min=1).to(torch.float32)
                )
                self._rumor_cov_host = cov.cpu().numpy()
                self._rumor_cov_dirty = False
                self._note_readback(1)
            return float(self._rumor_cov_host[slot])

    def rumor_payload(self, slot: int) -> object:
        return self._rumor_payloads.get(slot)

    # -- links (pview: group partitions; sparse: the scalar or [N, N] plane) --
    def set_link_loss(self, src, dst, loss: float) -> None:
        with self._lock:
            self.state = self._ops.set_link_loss(self.state, src, dst, loss)

    def set_link_delay(self, src, dst, mean_delay_ticks: float) -> None:
        with self._lock:
            self.state = self._ops.set_link_delay(self.state, src, dst, mean_delay_ticks)

    def block_partition(self, group_a, group_b) -> None:
        with self._lock:
            self.state = self._ops.block_partition(self.state, group_a, group_b)

    def heal_partition(self, group_a, group_b) -> None:
        with self._lock:
            self.state = self._ops.heal_partition(self.state, group_a, group_b)

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
        with self._lock:
            s = _status_of_key(int(self._eng.view_row(self.state, observer)[subject]))
        return None if s == UNKNOWN else MemberStatus(s)

    def is_up(self, row: int) -> bool:
        with self._lock:
            return bool(self.state.up[row])

    # -- engine health ------------------------------------------------------
    def health_snapshot(self) -> dict:
        """Protocol health: rumor-pool backpressure (occupancy, high-water,
        per-source announce drops, evictions), identity-dissemination
        staleness (per-subject counts of up observers holding a stale
        record, and lag cohorts of recent joins), per-slot rumor coverage.
        A sync point: it flushes every staged reduction, and registers
        health interest (the join() pool probe)."""
        with self._lock:
            return self._health_snapshot_locked()

    def _health_snapshot_locked(self) -> dict:
        self._health_interest = True
        self._flush_locked()
        stale, n_up = self._eng.staleness(self.state)
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
            if bool(self.state.up[r])
        ]
        cov = self._rumor_cov_host
        return {
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
            "pool": {
                "mr_slots": self._eng.pool_slots(self.params),
                "active_now": int(self.state.mr_active.sum()),
                "high_water": self._pool_high_water,
            },
        }

    def enable_health_probes(self) -> None:
        """Register health interest without taking a snapshot: turns on the
        join() pool probe."""
        self._health_interest = True

    # -- surfaces still to port ---------------------------------------------
    def jit_cache_audit(self) -> dict:
        _not_ported("the compile-cache audit", "A13")

    def arm_telemetry(self, config=None, bus=None):
        _not_ported("the telemetry plane", "A10")

    def arm_trace(self, config=None, tracer_rows=None, rumor_slots=None):
        _not_ported("the trace plane", "A10")

    def set_dissemination(self, spec=None, *, strategy=None, topology=None, **knobs):
        _not_ported("a non-default dissemination strategy", "A8")

    def set_adaptive(self, spec=None, *, enabled=None, **knobs):
        _not_ported("adaptive failure detection", "A8")

    def set_protocol_knobs(self, **knobs):
        _not_ported("live protocol knobs", "A11")

    def arm_control(self, spec=None, config=None):
        _not_ported("the control plane", "A11")

    def run_scenario(self, scenario, *args, **kwargs):
        _not_ported("chaos scenarios", "A10")

    def chaos_snapshot(self) -> dict:
        _not_ported("chaos scenarios", "A10")

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
        if self._draws is not None:
            raise ValueError("a driver with a caller-supplied draws source cannot be checkpointed")
        with self._lock:
            payload = self._checkpoint_payload_locked()
        target = os.path.abspath(path)
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
        }
        host_bytes = pickle.dumps(host)
        return dict(
            self._ops.snapshot(self.state),
            _gen=self._gen.get_state().numpy(),
            _host=np.frombuffer(host_bytes, dtype=np.uint8),
            _schema=np.int32(CHECKPOINT_SCHEMA),
            _crc32=np.uint32(zlib.crc32(host_bytes) & 0xFFFFFFFF),
            _engine=np.bytes_(self.engine.encode()),
            _framework=np.bytes_(FRAMEWORK.encode()),
        )

    def restore(self, path: str) -> None:
        """Load a :meth:`checkpoint` archive. Every check runs before the
        driver changes: an archive without ``_framework = "torch"`` (the
        JAX driver's, whose pickle would import the JAX package) is refused
        before anything is unpickled; so are a newer schema, another engine,
        a failed CRC, missing members, state planes of another shape and a
        key dtype other than this driver's."""
        with self._lock:
            self._restore_locked(path)

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
        try:
            state = self._ops.restore(data, device=self.device)
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

        self.state = state
        self._gen = gen
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
        self._free_rumor_slots = host.get("free_rumor_slots")
        self._health_counters = dict(host["health_counters"])
        self._pool_high_water = host["pool_high_water"]
        self._segmentation_warnings = host["segmentation_warnings"]
        self._recent_joins = [tuple(j) for j in host["recent_joins"]]
        # re-baseline watches so a restore emits no phantom events
        for w in self._watches.values():
            w.prev_key = self._view_row_host(w.row)
            w.known = {
                int(j): self.members.get(int(j), self._member_handle(int(j)))
                for j in np.nonzero(w.prev_key >= 0)[0]
            }
