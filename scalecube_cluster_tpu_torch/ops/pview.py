"""The partial-view ("pview") SWIM engine in PyTorch: O(N·k) state, no
[N, N] plane. A port of the JAX package's ``ops/pview.py`` — its fused tick
(``pview_tick_fused``), the window runner, and the host seams the driver
calls — held against it bit for bit (``tests/test_torch_pview_*.py``). The
JAX module's docstring carries the protocol account and deviations P1-P8;
this file keeps its function names so each counterpart is easy to find.

The JAX package has two spellings of the tick: ``pview_tick`` (the driver's
window, ``make_pview_run``) and ``pview_tick_fused``, its drop-in fast
spelling with the same trajectory. The port has one: ``pview_tick``,
``run_pview_ticks`` and ``make_pview_run`` run the fused tick, and are held
against the JAX unfused window and driver (``tests/test_torch_pview_unfused.py``,
``tests/test_torch_driver.py``).

What differs from the JAX spelling, and why:

* ``tick`` is a host int, so every tick-keyed branch (FD round, sweep,
  purge) is decided on the host with no device read.
* Branches keyed on data (the JAX ``lax.cond``\\ s on ``work``, ``mr_any``,
  ``has_suspects``, ``mr_active.any()``, ``valid.any()``, ``need.any()``)
  read one flag to the host each; :data:`._tensor.HOST_SYNCS` counts them.
* Uniform draws are an input of the tick (:mod:`.rand`), not derived from a
  key inside it.
* Packed words are int32 (see :mod:`.bitplane`); scatters with duplicate
  indices are ``scatter_reduce_`` amax/amin elections or integer
  ``index_add_``; fixed-size ``nonzero`` is a cumsum compaction;
  ``lax.scan`` loops are Python loops.
* Wide [N, M] reductions (the early-free cover test, the membership
  segmentation metric) run over row chunks, so no [N, M] int32 temporary
  exists at 1M members.

The adaptive plane (``pview_tick(ad=...)``, :func:`make_pview_adaptive_run`)
threads an :class:`..adaptive.AdaptiveState` through the window, as on the
dense engine; :func:`sentinel_init` / :func:`sentinel_reduce` are the chaos
sentinels' table-edge twins of the dense check.

``delay_slots`` = D > 0 arms the pending delivery rings
(:mod:`._tick`) under the uniform delay ``delay_q``: late gossip contacts
land D - 1 ticks ahead at most, the FD probes and the SYNC round trip are
gated on their timeouts, and the adaptive plane stretches the direct
probe's (``scaled_timely_rt``). A per-link delay stays refused, as in JAX.
:func:`telemetry_window_vector` is the telemetry plane's per-window row.

The causal trace capture (``pview_tick(trace=...)``,
:func:`make_pview_traced_run`, :func:`tracer_view_cols`) runs on the fused
tick: JAX's traced tick is its unfused one, whose phases compute the same
state, and the records need only the per-row accept counts the compact
SYNC merge returns. On a member mesh (:mod:`.sharding`) the tick runs on
each rank's rows: the seams below (``_grows``, ``_full``, ``_mine``,
``_reduce``, ``_capped``) are the identity on one device and the site's
collective on a mesh, the delivery takes the ragged record exchange, and
SYNC runs over the gathered tables (:func:`_sync_phase_sharded`). The
delay rings' late contacts and the push-pull leg's peer rows cross in
exact exchanges (:mod:`.ragged_a2a`); a rumor with a delivery in flight on
any rank keeps its column on every rank; the chaos sentinels combine the
ranks' per-subject tables and counts. The fleet windows (``make_pview_fleet_run``, its fused name,
``make_pview_fleet_adaptive_run``) run the fused tick under
``torch.func.vmap`` (:mod:`.fleet`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import adaptive as _adp
from ..adaptive import AdaptiveSpec
from ..dissemination import strategies as dz
from ..dissemination.spec import DissemSpec
from . import delivery
from ._tick import announce, covered_columns, crash_row, crash_rows, rumor_metrics, run_window, spread_rumor  # noqa: F401
from ._tick import (  # the pending delivery rings
    clear_pending_now_,
    clear_pending_rows_,
    delay_ticks,
    late_deliveries_,
    origin_words_here,
    pending_now_flags,
    receive_pending,
)
from ._tick import count_i32 as _i32
from ._tick import fd_trace as _fd_trace
from ._tick import no_props as _no_props
from ._tick import phase as _phase
from ._tick import pull_replies
from ._tick import register_sus as _register_sus
from ._tick import row_index as _row_index
from ._tick import rows_of as _rows
from ._tick import seed_rows_tensor as _seed_rows_tensor
from ._tick import set_at as _set
from ._tick import sync_trace as _sync_trace
from ._tensor import first_true, host_flags, keep_columns_, nonzero_fixed, put_drop_, row_chunks, scatter_, scatter_reduce_1d
from .kernel import _f32, _fold_evidence, _no_evidence, _timely_rt, telemetry_window_core
from .sparse import _trace_rows as _sparse_trace_rows
from .sparse import TELEMETRY_SERIES as _SPARSE_TELEMETRY_SERIES
from .sparse import pool_telemetry
from .bitplane import MASK32, or_rows, pack_bits, popcount, to_i32, to_u32, unpack_bits, words_for
from .lattice import (
    ALIVE,
    RANK_ALIVE,
    RANK_DEAD,
    RANK_LEAVING,
    RANK_SUSPECT,
    UNKNOWN_KEY,
    bump_inc,
    key_dtype,
    precedence_key,
)
from .pool import alloc_phase, allocate
from .sharding import active as _shard
from .sharding import unsharded as _unsharded
from .rand import (
    SALT_GOSSIP,
    SALT_SYNC_ACK,
    SALT_SYNC_REQ,
    SparseFdRandoms,
    SparseRoundRandoms,
    draw_sparse_tick,
    fetch_uniform,
)
from .state import NEVER, NO_CANDIDATE_I32, delay_mean_to_q

NO_CANDIDATE = NO_CANDIDATE_I32

#: partitions run on the group model (``part_id``/``part_loss``), without
#: an [N, N] link plane (the chaos timeline reads this)
GROUP_PARTITIONS = True


def _ceil_log2_static(n: int) -> int:
    return int(n).bit_length() if n > 0 else 0


@dataclasses.dataclass(frozen=True)
class PviewParams:
    """Static parameters of the partial-view tick — the JAX package's
    ``PviewParams`` without ``delivery_kernel`` (the port runs the
    delivery combine through :mod:`.delivery` on any device); ``dissem``
    is the dissemination strategy/topology (:mod:`..dissemination`),
    ``adaptive`` the adaptive failure-detection spec (:mod:`..adaptive`)."""

    capacity: int
    view_slots: int = 24
    active_slots: int = 8
    fanout: int = 3
    repeat_mult: int = 3
    ping_req_k: int = 3
    fd_every: int = 5
    sync_every: int = 150
    sync_stagger: int = 1
    suspicion_mult: int = 5
    sweep_every: int = 8
    sample_tries: int = 4
    rumor_slots: int = 16
    mr_slots: int = 0  # 0 = auto: min(2048, max(256, capacity // 32))
    announce_slots: int = 256
    sync_slots: int = 0
    sync_announce: int = 2
    seed_sync_every: int = 4
    tombstone_ticks: int = 0
    apply_slots: int = 8
    partition_groups: int = 4
    fd_accept_slots: int = 0
    refute_slots: int = 0
    delay_slots: int = 0
    fd_direct_timeout_ticks: int = 2
    fd_leg_timeout_ticks: int = 1
    sync_timeout_ticks: int = 15
    seed_rows: tuple = ()
    early_free: bool = True
    full_metrics: bool = False
    key_dtype: str = "i32"
    dissem: DissemSpec = DissemSpec()
    adaptive: AdaptiveSpec = AdaptiveSpec()

    @staticmethod
    def from_config(config, capacity: int | None = None, initial_size: int | None = None,
                    seed_rows: tuple = (0,), mr_slots: int | None = None,
                    view_slots: int | None = None) -> "PviewParams":
        """Pview params from a ``ClusterConfig``: the shared tick mapping
        (:func:`..config.tick_units`) plus the table sizing."""
        from ..config import tick_units

        sim = config.sim
        return PviewParams(
            view_slots=view_slots or sim.view_slots, active_slots=sim.active_slots,
            mr_slots=mr_slots or 0, key_dtype=sim.plane_dtype, dissem=DissemSpec.from_config(config),
            adaptive=AdaptiveSpec.from_config(config),
            **tick_units(config, capacity, initial_size, seed_rows),
        )

    def __post_init__(self):
        if not (0 < self.active_slots < self.view_slots):
            raise ValueError(
                "need 0 < active_slots < view_slots (the passive reservoir "
                f"must be non-empty): got ka={self.active_slots}, k={self.view_slots}"
            )
        key_dtype(self.key_dtype)  # validates the spelling
        if self.partition_groups < 3:
            raise ValueError(f"partition_groups must be >= 3: got G={self.partition_groups}")

    @property
    def mr_pool(self) -> int:
        return self.mr_slots or min(2048, max(256, self.capacity // 32))

    @property
    def log2n(self) -> int:
        return _ceil_log2_static(self.capacity)

    @property
    def spread_ticks(self) -> int:
        return self.repeat_mult * self.log2n

    @property
    def sweep_ticks(self) -> int:
        return 2 * (self.repeat_mult * self.log2n + 1)

    @property
    def suspicion_timeout_ticks(self) -> int:
        return self.suspicion_mult * self.log2n * self.fd_every

    @property
    def purge_sweeps(self) -> int:
        tt = self.tombstone_ticks or self.sweep_ticks
        return max(1, -(-tt // self.sweep_every))


@dataclasses.dataclass
class PviewState:
    """Partial-view simulation state: the JAX ``PviewState``'s leaves as
    tensors on one device (same names and dtypes), with ``tick`` a host int.
    Only ``nbr_key`` uses the narrow key dtype; every other key carrier is
    int32 holding a value packed under the same layout."""

    tick: int
    up: torch.Tensor  # bool [N]
    epoch: torch.Tensor  # i32 [N]
    joined_at: torch.Tensor  # i32 [N]
    self_key: torch.Tensor  # i32 [N]
    nbr_id: torch.Tensor  # i32 [N, k]
    nbr_key: torch.Tensor  # kdt [N, k]
    sus_key: torch.Tensor  # i32 [N]
    sus_since: torch.Tensor  # i32 [N]
    force_sync: torch.Tensor  # bool [N]
    leaving: torch.Tensor  # bool [N]
    mr_active: torch.Tensor  # bool [M]
    mr_subject: torch.Tensor  # i32 [M]
    mr_key: torch.Tensor  # i32 [M]
    mr_created: torch.Tensor  # i32 [M]
    mr_origin: torch.Tensor  # i32 [M]
    minf_age: torch.Tensor  # u8 [N, M]
    rumor_active: torch.Tensor  # bool [R]
    rumor_origin: torch.Tensor  # i32 [R]
    rumor_created: torch.Tensor  # i32 [R]
    infected: torch.Tensor  # bool [N, R]
    infected_at: torch.Tensor  # i32 [N, R]
    infected_from: torch.Tensor  # i32 [N, R]
    loss: torch.Tensor  # f32 scalar
    delay_q: torch.Tensor  # f32 scalar
    part_id: torch.Tensor  # i32 [N]
    part_loss: torch.Tensor  # f32 [G, G]
    pending_minf: torch.Tensor  # bool [D, N, M]
    pending_inf: torch.Tensor  # bool [D, N, R]
    pending_src: torch.Tensor  # i32 [D, N, R]

    @property
    def capacity(self) -> int:
        return self.up.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.up.device

    def replace(self, **changes) -> "PviewState":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# construction + host mutators
# ---------------------------------------------------------------------------


def init_pview_state(
    params: PviewParams,
    n_initial: int,
    warm: bool = True,
    uniform_loss: float = 0.0,
    uniform_delay: float = 0.0,
    device="cuda",
) -> PviewState:
    """Fresh partial-view sim on ``device``; rows ``0..n_initial-1`` up.
    A warm start fills each table with the JAX package's scattered
    binary-dissemination overlay (odd geometric chords in the active slots,
    small offsets in the passive tail); a cold start knows only the seeds.
    ``uniform_delay`` (mean ticks) needs ``params.delay_slots`` (D) > 0,
    which sizes the pending delivery rings."""
    if uniform_delay > 0 and params.delay_slots <= 0:
        raise ValueError("uniform_delay > 0 requires params.delay_slots > 0")
    n, k, m, r = params.capacity, params.view_slots, params.mr_pool, params.rumor_slots
    n_rings = max(0, params.delay_slots)
    g = params.partition_groups
    kdt = key_dtype(params.key_dtype)
    rows = np.arange(n)
    if warm and n_initial > 1:
        offs: list = []
        step = n_initial // 2
        while len(offs) < k and step > 1:
            c = step | 1
            if c < n_initial and c not in offs:
                offs.append(c)
            step //= 2
        d = 1
        while len(offs) < k and len(offs) < n_initial - 1:
            c = d % n_initial
            if c and c not in offs:
                offs.append(c)
            d += 1
        while len(offs) < k:
            offs.append(n_initial + len(offs))  # invalid -> empty slot
        offs_a = np.asarray(offs, np.int64)
        ids = (rows[:, None] + offs_a[None, :]) % max(n_initial, 1)
        valid = (rows[:, None] < n_initial) & (offs_a[None, :] < n_initial)
        ids = np.where(valid, ids, -1).astype(np.int32)
    else:
        ids = np.full((n, k), -1, np.int32)
        seeds = [s for s in params.seed_rows if s < n_initial]
        for i in range(n_initial):
            s_i = [s for s in seeds if s != i][:k]
            ids[i, : len(s_i)] = s_i

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    up = torch.arange(n, device=device) < n_initial
    nbr_id = t(ids, torch.int32)
    i32 = torch.int32
    return PviewState(
        tick=0,
        up=up,
        epoch=torch.zeros((n,), dtype=i32, device=device),
        joined_at=torch.zeros((n,), dtype=i32, device=device),
        self_key=torch.where(up, 0, UNKNOWN_KEY).to(i32),
        nbr_id=nbr_id,
        nbr_key=torch.where(nbr_id >= 0, 0, UNKNOWN_KEY).to(kdt),
        sus_key=torch.full((n,), NO_CANDIDATE, dtype=i32, device=device),
        sus_since=torch.full((n,), NEVER, dtype=i32, device=device),
        force_sync=torch.zeros((n,), dtype=torch.bool, device=device),
        leaving=torch.zeros((n,), dtype=torch.bool, device=device),
        mr_active=torch.zeros((m,), dtype=torch.bool, device=device),
        mr_subject=torch.full((m,), -1, dtype=i32, device=device),
        mr_key=torch.zeros((m,), dtype=i32, device=device),
        mr_created=torch.zeros((m,), dtype=i32, device=device),
        mr_origin=torch.zeros((m,), dtype=i32, device=device),
        minf_age=torch.zeros((n, m), dtype=torch.uint8, device=device),
        rumor_active=torch.zeros((r,), dtype=torch.bool, device=device),
        rumor_origin=torch.zeros((r,), dtype=i32, device=device),
        rumor_created=torch.zeros((r,), dtype=i32, device=device),
        infected=torch.zeros((n, r), dtype=torch.bool, device=device),
        infected_at=torch.zeros((n, r), dtype=i32, device=device),
        infected_from=torch.full((n, r), -1, dtype=i32, device=device),
        loss=t(np.float32(uniform_loss), torch.float32),
        delay_q=t(np.float32(delay_mean_to_q(uniform_delay)), torch.float32),
        part_id=torch.zeros((n,), dtype=i32, device=device),
        part_loss=torch.zeros((g, g), dtype=torch.float32, device=device),
        pending_minf=torch.zeros((n_rings, n, m), dtype=torch.bool, device=device),
        pending_inf=torch.zeros((n_rings, n, r), dtype=torch.bool, device=device),
        pending_src=torch.full((n_rings, n, r), -1, dtype=i32, device=device),
    )


def _kdt(state: PviewState) -> torch.dtype:
    return state.nbr_key.dtype


def _keys_i32(state: PviewState) -> torch.Tensor:
    """The neighbor-key plane widened to int32 (sign extension keeps the
    narrow layout's values, -1 included)."""
    return state.nbr_key.to(torch.int32)


def _pack_self(kdt, status, inc, epoch) -> torch.Tensor:
    """Pack under the layout of ``kdt``, carried as int32."""
    return precedence_key(status, inc, epoch, dtype=kdt).to(torch.int32)


def _insert_rows_table(state: PviewState, rows, seed_rows):
    """Fresh table for joining ``rows``: seeds in ascending slots."""
    k = state.nbr_id.shape[1]
    dev = state.device
    rows = torch.as_tensor(rows, dtype=torch.int32, device=dev).reshape(-1)
    seed_rows = torch.as_tensor(list(seed_rows), dtype=torch.int32, device=dev)[:k]
    nk = rows.shape[0]
    s_cnt = seed_rows.shape[0]
    slots = torch.arange(k, device=dev)
    if s_cnt:
        ids = torch.where(slots < s_cnt, seed_rows[slots.clamp(max=s_cnt - 1)], -1)
    else:
        ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
    ids = ids[None, :].expand(nk, k)
    ids = torch.where(ids == rows[:, None], -1, ids)  # a joiner never tables itself
    kdt = _kdt(state)
    seed_keys = _pack_self(
        kdt,
        torch.full((nk, k), ALIVE, device=dev),
        torch.zeros((nk, k), device=dev),
        state.epoch[ids.clamp(min=0)],
    )
    keys = torch.where(ids >= 0, seed_keys, UNKNOWN_KEY).to(kdt)
    return ids.to(torch.int32), keys


def join_row(state: PviewState, row: int, seed_rows) -> PviewState:
    """Activate ``row`` as a fresh member knowing the seeds (restart = new
    identity via the epoch bits) and self-announce it."""
    was_used = state.self_key[row] >= 0
    new_epoch = torch.where(was_used, (state.epoch[row] + 1) & 0xFF, state.epoch[row])
    self_key = _pack_self(_kdt(state), ALIVE, 0, new_epoch)
    ids, keys = _insert_rows_table(state, [row], seed_rows)
    state = state.replace(
        up=_set(state.up, row, True),
        epoch=_set(state.epoch, row, new_epoch),
        joined_at=_set(state.joined_at, row, state.tick),
        self_key=_set(state.self_key, row, self_key),
        nbr_id=_set(state.nbr_id, row, ids[0]),
        nbr_key=_set(state.nbr_key, row, keys[0]),
        force_sync=_set(state.force_sync, row, True),
        leaving=_set(state.leaving, row, False),
        minf_age=_set(state.minf_age, row, 0),
        infected=_set(state.infected, row, False),
        infected_from=_set(state.infected_from, row, -1),
    )
    clear_pending_rows_(state, row)
    return announce(state, row, self_key, row)


def join_rows(state: PviewState, rows, seed_rows) -> PviewState:
    """Vectorized churn-burst join (distinct ``rows``)."""
    dev = state.device
    rows = torch.as_tensor(rows, dtype=torch.int32, device=dev).reshape(-1)
    nk = rows.shape[0]
    ridx = rows.long()
    was_used = state.self_key[ridx] >= 0
    new_epoch = torch.where(was_used, (state.epoch[ridx] + 1) & 0xFF, state.epoch[ridx])
    self_keys = _pack_self(
        _kdt(state), torch.full((nk,), ALIVE, device=dev), torch.zeros((nk,), device=dev), new_epoch
    )
    st = state.replace(epoch=_set(state.epoch, ridx, new_epoch))
    ids, keys = _insert_rows_table(st, rows, seed_rows)
    state = st.replace(
        up=_set(state.up, ridx, True),
        joined_at=_set(state.joined_at, ridx, state.tick),
        self_key=_set(state.self_key, ridx, self_keys),
        nbr_id=_set(state.nbr_id, ridx, ids),
        nbr_key=_set(state.nbr_key, ridx, keys),
        force_sync=_set(state.force_sync, ridx, True),
        leaving=_set(state.leaving, ridx, False),
        minf_age=_set(state.minf_age, ridx, 0),
        infected=_set(state.infected, ridx, False),
        infected_from=_set(state.infected_from, ridx, -1),
    )
    clear_pending_rows_(state, ridx)
    ones = torch.ones((nk,), dtype=torch.bool, device=dev)
    state, _a, _d, _e = allocate(state, rows, self_keys, rows, ones, prio=ones)
    return state


def begin_leave(state: PviewState, row: int) -> PviewState:
    own = state.self_key[row]
    leaving_key = ((own >> 2) << 2) | RANK_LEAVING
    state = state.replace(
        self_key=_set(state.self_key, row, leaving_key),
        leaving=_set(state.leaving, row, True),
    )
    return announce(state, row, leaving_key, row)


def update_metadata(state: PviewState, row: int) -> PviewState:
    """Metadata update = own-incarnation bump re-announced ALIVE (the narrow
    layout saturates, see :func:`.lattice.bump_inc`)."""
    new_key = bump_inc(state.self_key[row].to(_kdt(state)), RANK_ALIVE).to(torch.int32)
    state = state.replace(self_key=_set(state.self_key, row, new_key))
    return announce(state, row, new_key, row)


def set_uniform_loss(state: PviewState, loss, floor: bool = False) -> PviewState:
    new = torch.as_tensor(loss, dtype=torch.float32, device=state.device)
    if floor:
        new = torch.maximum(state.loss, new)
    return state.replace(loss=new.reshape(()))


def _part_cell(rows) -> int:
    """Deterministic partition-cell id for a host-side row group: cells are
    hashed from the group's minimum row into [1, G). Two simultaneous
    partitions whose groups hash to the same cell merge (documented bound;
    G is ``PviewParams.partition_groups``)."""
    return int(min(int(r) for r in rows))


def _cells_for(state: PviewState, group_a, group_b) -> tuple[int, int]:
    g = state.part_loss.shape[0]
    ra, rb = _part_cell(group_a), _part_cell(group_b)
    ca = 1 + (ra % (g - 1))
    cb = 1 + (rb % (g - 1))
    if ca == cb:
        # order-independent collision remap: bump the group with the LARGER
        # raw min row, so (a, b) and (b, a) resolve to the same cell pair
        # and the heal path reaches both directions
        if ra <= rb:
            cb = 1 + (cb % (g - 1))
        else:
            ca = 1 + (ca % (g - 1))
    return ca, cb


def block_partition(state: PviewState, group_a, group_b) -> PviewState:
    ca, cb = _cells_for(state, group_a, group_b)
    part = state.part_id.clone()
    part[_row_index(group_a, state.device)] = ca
    part[_row_index(group_b, state.device)] = cb
    pl = state.part_loss.clone()
    pl[ca, cb] = 1.0
    pl[cb, ca] = 1.0
    return state.replace(part_id=part, part_loss=pl)


def set_link_loss(state: PviewState, src, dst, loss) -> PviewState:
    """Group-pair loss only (the partition heal path): ``src``/``dst`` must
    be the row groups of an earlier :func:`block_partition`. Arbitrary
    per-link loss needs an [N, N] plane, which this engine bans."""
    src = list(np.atleast_1d(np.asarray(src)))
    dst = list(np.atleast_1d(np.asarray(dst)))
    ca, cb = _cells_for(state, src, dst)
    return state.replace(part_loss=_set(state.part_loss, (ca, cb), float(np.float32(loss))))


def heal_partition(state: PviewState, group_a, group_b) -> PviewState:
    s = set_link_loss(state, group_a, group_b, 0.0)
    return set_link_loss(s, group_b, group_a, 0.0)


def set_link_delay(state: PviewState, src, dst, mean_delay_ticks: float):
    raise ValueError(
        "per-link delay needs an [N, N] plane; the pview engine supports "
        "uniform delay only (init_pview_state(uniform_delay=...))"
    )


def snapshot(state: PviewState) -> dict:
    """Every state leaf as a numpy array (``tick`` a 0-d int32), keyed by
    name: the checkpoint layout of the JAX package's ``snapshot``."""
    from .. import convert

    return convert.state_to_numpy(state)


def restore(arrays: dict, device="cuda") -> PviewState:
    """The inverse of :func:`snapshot`, onto ``device``; the leaves are
    copied, never aliased to the caller's buffers. A set of names that is
    not exactly the state's raises ``TypeError``, as constructing the JAX
    state from them does."""
    from .. import convert

    names = {f.name for f in dataclasses.fields(PviewState)}
    if set(arrays) != names:
        raise TypeError(
            f"state planes do not match PviewState: missing {sorted(names - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - names)}"
        )
    return convert.state_from_numpy(arrays, device=device)


def remembered_rows(state: PviewState) -> torch.Tensor:
    """[N] bool — rows some up member still holds a record about (tables
    only; the driver's prefer-forgotten-rows join policy)."""
    n = state.capacity
    held = state.up[:, None] & (state.nbr_id >= 0)
    idx = torch.where(held, state.nbr_id, n).reshape(-1)
    return scatter_reduce_1d(n, idx, held.reshape(-1), "amax", 0, torch.int32) > 0


def staleness(state: PviewState):
    """Per-subject count of up observers holding a STALE record (identity/
    incarnation below the subject's own) — table edges only (unknown
    observers are not counted stale: a partial view is not staleness).
    Returns (int32 [N], the up count)."""
    n = state.capacity
    keys = _keys_i32(state)
    sid = state.nbr_id
    sidc = sid.clamp(min=0)
    stale_edge = (
        (sid >= 0)
        & state.up[:, None]
        & state.up[sidc]
        & ((keys >> 2) < (state.self_key[sidc] >> 2))
    )
    # integer addition is exact in any order, duplicates included
    stale = torch.zeros((n + 1,), dtype=torch.int32, device=state.device)
    stale.index_add_(0, torch.where(stale_edge, sid, n).reshape(-1), stale_edge.reshape(-1).to(torch.int32))
    return stale[:n], state.up.sum()


def view_rows(state: PviewState, rows) -> torch.Tensor:
    """Full-width [W, N] int32 key rows for ``rows``: each row's table
    scattered by subject (-1 where untabled) plus its self record on the
    diagonal."""
    n = _gcap(state)
    rows = torch.as_tensor(rows, dtype=torch.int64, device=state.device).reshape(-1)
    ctx = _shard()
    local = rows if ctx is None else (rows - ctx.lo).clamp(0, ctx.L - 1)
    ids = state.nbr_id[local]
    keys = _keys_i32(state)[local]
    full = torch.full((rows.shape[0], n + 1), UNKNOWN_KEY, dtype=torch.int32, device=state.device)
    full.scatter_reduce_(1, torch.where(ids >= 0, ids, n).long(), keys, "amax", include_self=True)
    full = full[:, :n].clone()
    full[torch.arange(rows.shape[0], device=state.device), rows] = state.self_key[local]
    if ctx is not None:
        # each row from the rank that holds it
        mine = (rows >= ctx.lo) & (rows < ctx.hi)
        full = ctx.reduce(torch.where(mine[:, None], full, torch.iinfo(torch.int32).min), "max")
    return full


# ---------------------------------------------------------------------------
# in-tick helpers
# ---------------------------------------------------------------------------


# -- the member-sharded tick's seams (:mod:`.sharding`): each is the identity
# -- on one device, and on a mesh the collective its site needs -------------


def _grows(state: PviewState) -> torch.Tensor:
    """int32 global row ids of the state's rows."""
    ctx = _shard()
    return _rows(state) if ctx is None else ctx.rows(state.device)


def _gcap(state: PviewState) -> int:
    """N, the global capacity (the state holds L = N / W rows on a mesh)."""
    ctx = _shard()
    return state.capacity if ctx is None else ctx.n


def _full(x: torch.Tensor) -> torch.Tensor:
    """All N rows of a member-axis tensor (read at other members' rows)."""
    ctx = _shard()
    return x if ctx is None else ctx.full(x)


def _reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """A value reduced over the ranks (max, min or sum)."""
    ctx = _shard()
    return x if ctx is None else ctx.reduce(x, op)


def _mine(x: torch.Tensor, op: str) -> torch.Tensor:
    """A global [N, ...] table written at other members' rows, combined over
    the ranks; this rank's rows of it."""
    ctx = _shard()
    return x if ctx is None else ctx.reduce_mine(x, op)


def _capped(mask: torch.Tensor, V: int) -> torch.Tensor:
    """``mask`` less the entries past the first V in global row order."""
    pos = torch.cumsum(mask, 0) - 1
    ctx = _shard()
    if ctx is not None:
        pos = pos + ctx.offset(mask.sum())
    return mask & (pos < V)


def _global_props(props):
    """A phase's re-gossip proposals over all N rows, in global row order
    (the pool allocation is replicated)."""
    ctx = _shard()
    return props if ctx is None else tuple(ctx.full(p) for p in props)


def _loss_at(state: PviewState, i, j) -> torch.Tensor:
    part_id = _full(state.part_id)
    part = state.part_loss[part_id[i].long(), part_id[j].long()]
    return torch.maximum(state.loss, part)


def _rt_at(state: PviewState, i, j) -> torch.Tensor:
    return (1.0 - _loss_at(state, i, j)) * (1.0 - _loss_at(state, j, i))


def _rt_timely(state: PviewState, i, j, t: int) -> torch.Tensor:
    """The round trip i <-> j delivered within ``t`` ticks under the
    uniform delay (the rings' runs)."""
    return _rt_at(state, i, j) * _timely_rt(state.delay_q, state.delay_q, t)


def _sample_slots(state: PviewState, u, n_picks: int, tries: int, ka: int):
    """Per-row ``n_picks`` distinct ACTIVE-SLOT draws by bounded rejection:
    each pick takes the first of ``tries`` slot draws that holds a non-DEAD
    neighbor and differs from the earlier picks.

    Returns (slot [N, P] clamped, member [N, P] clamped, valid [N, P])."""
    slots = (u * float(ka)).to(torch.int32).clamp(max=ka - 1)
    sid = torch.gather(state.nbr_id, 1, slots.long())
    skey = torch.gather(state.nbr_key, 1, slots.long()).to(torch.int32)
    ok_base = (sid >= 0) & ((skey & 3) != RANK_DEAD)
    picks = []
    for p in range(n_picks):
        sel = torch.full((u.shape[0],), -1, dtype=torch.int32, device=u.device)
        for t in range(tries):
            c = slots[:, p * tries + t]
            ok = ok_base[:, p * tries + t]
            for q in picks:
                ok = ok & (c != q)
            sel = torch.where((sel < 0) & ok, c, sel)
        picks.append(sel)
    slot = torch.stack(picks, 1)
    valid = slot >= 0
    slot_c = slot.clamp(min=0)
    member = torch.gather(state.nbr_id, 1, slot_c.long())
    return slot_c, member.clamp(min=0), valid


def _accept_and_place(tick, up_state, rows, sub_id, sub_key, sub_self, subj, cand, valid, salt, ka):
    """The ONE accept-and-place step of every delivery path, over the rows
    ``rows`` whose tables are ``sub_id``/``sub_key`` (int32) and self
    records ``sub_self``:

    * accept gates: ``cand > own``; unknown subjects admit ALIVE/LEAVING
      only; ALIVE candidates pass the metadata-fetch gate (salt-keyed
      stateless hash against the round-trip delivery probability);
    * placement: subject == row goes to the self record; a tabled subject
      updates in place; an unknown one inserts at the first empty slot,
      else evicts the minimum-key passive entry (deviation P3).

    Returns (new ids, new self records, accept, onehot of the written
    slot); the caller writes the key plane in its own dtype."""
    n = _gcap(up_state)
    k = sub_id.shape[1]
    subj_c = subj.clamp(0, n - 1)
    to_self = valid & (subj == rows)
    to_tab = valid & ~to_self & (subj >= 0)
    match = sub_id == subj[:, None]
    present = (match & to_tab[:, None]).any(dim=1)
    slot_p = first_true(match, 1)
    own_tab = torch.where(present, torch.gather(sub_key, 1, slot_p[:, None])[:, 0], UNKNOWN_KEY)
    own = torch.where(to_self, sub_self, own_tab)
    needs_fetch = (cand & 3) == RANK_ALIVE
    u = fetch_uniform(tick, salt, rows, subj_c)
    fetch_ok = ~needs_fetch | (_full(up_state.up)[subj_c] & (u < _rt_at(up_state, rows, subj_c)))
    accept = (
        (to_self | to_tab)
        & (cand > own)
        & ((own >= 0) | ((cand & 3) <= RANK_LEAVING))
        & fetch_ok
    )
    new_self = torch.where(accept & to_self, cand, sub_self)
    acc_t = accept & to_tab
    empty = sub_id < 0
    has_empty = empty.any(dim=1)
    slot_e = first_true(empty, 1)
    slot_v = ka + torch.argmin(sub_key[:, ka:], dim=1)
    slot_w = torch.where(present, slot_p, torch.where(has_empty, slot_e, slot_v))
    onehot = acc_t[:, None] & (torch.arange(k, device=sub_id.device)[None, :] == slot_w[:, None])
    new_id = torch.where(onehot, subj[:, None], sub_id)
    return new_id, new_self, accept, onehot


def _sus_election(n: int, accept, subj, cand) -> torch.Tensor:
    """Per-subject max accepted SUSPECT key (NO_CANDIDATE elsewhere)."""
    sus_in = torch.where(accept & ((cand & 3) == RANK_SUSPECT), cand, NO_CANDIDATE)
    return scatter_reduce_1d(
        n, torch.where(accept, subj.clamp(0, n - 1), n), sus_in, "amax", NO_CANDIDATE, torch.int32
    )


def _apply_records(state: PviewState, subj, cand, valid, salt: int, ka: int):
    """Merge one record per row (``subj``/``cand`` [N] int32, ``valid``
    [N]) into every row's world. Returns (state, accepted, sus_cand);
    ``sus_cand`` is the global [N] election, not yet combined over the
    ranks of a mesh."""
    kdt = _kdt(state)
    rows = _grows(state)
    new_id, new_self, accept, onehot = _accept_and_place(
        state.tick, state, rows, state.nbr_id, _keys_i32(state), state.self_key,
        subj, cand, valid, salt, ka,
    )
    new_key = torch.where(onehot, cand[:, None].to(kdt), state.nbr_key)
    sus_cand = _sus_election(_gcap(state), accept, subj, cand)
    state = state.replace(self_key=new_self, nbr_id=new_id, nbr_key=new_key)
    return state, accept, sus_cand


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _fd_phase(state: PviewState, r: SparseFdRandoms, params: PviewParams, ad=None, trace: bool = False):
    """FD round over the active view: slot-space target/relay selection,
    direct + indirect probes, the self-record ACK. Also returns the
    post-verdict int32 key plane for the maintenance sweep. With ``ad`` the
    metrics carry the adaptive evidence (``_ad_*``), with ``trace`` the
    probe internals (``trace_fd``)."""
    n = state.capacity
    N = _gcap(state)
    rows = _grows(state)
    up_all = _full(state.up)
    ka = params.active_slots
    kdt = _kdt(state)
    keys = _keys_i32(state)
    tgt_slot_all, tgt_all, valid = _sample_slots(
        state, r.fd_try, 1 + params.ping_req_k, params.sample_tries, ka
    )
    tgt_slot = tgt_slot_all[:, 0]
    tgt = tgt_all[:, 0]
    has_tgt = valid[:, 0] & state.up
    if params.delay_slots and ad is not None:
        # the prober's own direct timeout stretches to t_base * (1 + lh)
        q = state.delay_q.expand(n)
        p_direct = _rt_at(state, rows, tgt) * _adp.scaled_timely_rt(
            q, q, params.fd_direct_timeout_ticks, ad.lh, params.adaptive.lh_max
        )
    elif params.delay_slots:
        p_direct = _rt_timely(state, rows, tgt, params.fd_direct_timeout_ticks)
    else:
        p_direct = _rt_at(state, rows, tgt)
    direct_ok = has_tgt & up_all[tgt] & (r.fd_direct < p_direct)

    relays = tgt_all[:, 1:]
    relay_valid = valid[:, 1:]
    tgt_b = tgt[:, None]
    p_relay = _rt_at(state, rows[:, None], relays) * _rt_at(state, relays, tgt_b)
    if params.delay_slots:
        leg = _timely_rt(state.delay_q, state.delay_q, params.fd_leg_timeout_ticks)
        p_relay = p_relay * leg
        p_relay = p_relay * leg
    relay_ok = relay_valid & up_all[relays] & up_all[tgt_b] & (r.fd_relay < p_relay)
    ack = direct_ok | relay_ok.any(dim=1)

    own_key = torch.gather(keys, 1, tgt_slot[:, None].long())[:, 0]
    alive_key = (_full(state.self_key)[tgt] >> 2) << 2
    suspect_key = ((own_key >> 2) << 2) | RANK_SUSPECT
    cand = torch.where(ack, alive_key, suspect_key)
    accept = has_tgt & (cand > own_key)
    V = min(N, params.fd_accept_slots or max(64, N // 16))
    eff = _capped(accept, V)

    k = state.nbr_id.shape[1]
    onehot = eff[:, None] & (torch.arange(k, device=state.device)[None, :] == tgt_slot[:, None])
    st = state.replace(nbr_key=torch.where(onehot, cand[:, None].to(kdt), state.nbr_key))
    sus_cand = _mine(scatter_reduce_1d(
        N, tgt, torch.where(eff & ~ack, cand, NO_CANDIDATE), "amax", NO_CANDIDATE, torch.int32
    ), "max")
    st = _register_sus(st, sus_cand)
    metrics = {
        "fd_probes": _i32(has_tgt),
        "fd_failed_probes": _i32(has_tgt & ~ack),
        "fd_new_suspects": _i32(eff & ~ack),
    }
    if ad is not None:
        metrics["_ad_miss"] = has_tgt & ~ack
        metrics["_ad_succ"] = has_tgt & ack
        metrics["_ad_cnt"] = _mine(torch.zeros((N,), dtype=torch.int32, device=state.device).index_add_(
            0, tgt.long(), (eff & ~ack).to(torch.int32)
        ), "sum")
        metrics["_ad_key"] = sus_cand
    if trace:
        metrics["trace_fd"] = _fd_trace(tgt, has_tgt, ack, direct_ok, eff & ~ack, relays, relay_valid, relay_ok)
    cand_rt = cand.to(kdt).to(torch.int32)
    keys_after = torch.where(onehot, cand_rt[:, None], keys)
    return st, (tgt, cand, rows, eff), metrics, keys_after


def _maintenance_sweep(state: PviewState, params: PviewParams, keys_i32=None, ad=None, trace=None):
    """Every ``sweep_every`` ticks: suspicion expiry over the tables and
    self records with per-subject announcer election; the tombstone purge
    (P8) every ``purge_sweeps``-th sweep; the active-view promotion.
    ``keys_i32`` is the FD phase's post-verdict key plane when it ran;
    ``ad`` scales the static timeout (P2) by the subject's confirmations
    and the observer's local health. ``trace`` (a TraceSpec) adds the
    tracers' expiry export as a third item (zeros when the expiry pass is
    skipped)."""
    sus_tr = None
    if state.tick % params.sweep_every:
        st, props = state, _no_props(state)
    else:
        (has_suspects,) = host_flags((state.sus_since > NEVER).any())
        if has_suspects:
            st, props, sus_tr = _expire(state, params, keys_i32, ad, trace)
        else:
            st, props = state, _no_props(state)
        st = _promote(_purge(st, params), params)
    if trace is None:
        return st, props
    if sus_tr is None:
        from ..trace import capture as _tc

        sus_tr = _tc.zero_sus_trace(trace, state.device)
    return st, props, sus_tr


def _expire(st: PviewState, params: PviewParams, keys_i32, ad=None, trace=None):
    n = _gcap(st)
    rows = _grows(st)
    k = st.nbr_id.shape[1]
    keys = _keys_i32(st) if keys_i32 is None else keys_i32
    sid = st.nbr_id
    sidc = sid.clamp(min=0).long()
    if ad is not None:
        aspec = params.adaptive
        L = aspec.levels
        base0 = params.log2n * params.fd_every
        num_conf = _adp.conf_mult_num(aspec, ad.conf)  # [N]
        num = torch.where(keys <= _full(ad.conf_key)[sidc], _full(num_conf)[sidc], aspec.max_mult * L)
        timeout = torch.div(base0 * num * (1 + ad.lh)[:, None], L, rounding_mode="floor")  # [N, k]
        num_s = torch.where(st.self_key <= ad.conf_key, num_conf, aspec.max_mult * L)
        timeout_s = torch.div(base0 * num_s * (1 + ad.lh), L, rounding_mode="floor")  # [N]
    else:
        timeout = timeout_s = params.suspicion_timeout_ticks
    is_sus = (keys & 3) == RANK_SUSPECT
    expired = (
        is_sus
        & st.up[:, None]
        & ((st.tick - _full(st.sus_since)[sidc]) >= timeout)
        & (keys <= _full(st.sus_key)[sidc])
    )
    new_keys = torch.where(expired, keys + 1, keys)
    self_expired = (
        st.up
        & ((st.self_key & 3) == RANK_SUSPECT)
        & ((st.tick - st.sus_since) >= timeout_s)
        & (st.self_key <= st.sus_key)
    )
    new_self = torch.where(self_expired, st.self_key + 1, st.self_key)
    any_suspect_left = _reduce((
        ((new_keys & 3) == RANK_SUSPECT) & st.up[:, None] & (sid >= 0)
    ).any() | (((new_self & 3) == RANK_SUSPECT) & st.up).any(), "max")
    sus_key = torch.where(any_suspect_left, st.sus_key, NO_CANDIDATE).to(torch.int32)
    sus_since = torch.where(any_suspect_left, st.sus_since, NEVER).to(torch.int32)
    # per-subject announcer election: the lowest expiring observer row
    first_row = _reduce(scatter_reduce_1d(
        n, torch.where(expired, sid, n).reshape(-1), rows[:, None].expand(rows.shape[0], k).reshape(-1),
        "amin", n, torch.int32,
    ), "min")
    mine = expired & (first_row[sidc] == rows[:, None])
    any_exp = mine.any(dim=1)
    col = first_true(mine, 1)[:, None]
    subj = torch.gather(sid, 1, col)[:, 0]
    key = torch.gather(new_keys, 1, col)[:, 0]
    sus_tr = None
    if trace is not None:
        from ..trace import capture as _tc

        # the tracer subjects' expiring table cells (self expiry excluded)
        exp_cols = _full(torch.stack([(expired & (sid == t)).any(dim=1) for t in trace.tracer_rows], dim=1))
        sus_tr = {"count": exp_cols.sum(dim=0, dtype=torch.int32), "by": _tc._exemplar(exp_cols)}
    st = st.replace(
        nbr_key=new_keys.to(_kdt(st)), self_key=new_self, sus_key=sus_key, sus_since=sus_since
    )
    return st, (subj.clamp(min=0), key, rows, any_exp), sus_tr


def _purge(st: PviewState, params: PviewParams) -> PviewState:
    """Tombstone purge (P8): forget every DEAD table entry, on the sweeps
    whose index is a multiple of ``purge_sweeps``."""
    if (st.tick // params.sweep_every) % params.purge_sweeps:
        return st
    keys = _keys_i32(st)
    drop = (st.nbr_id >= 0) & ((keys & 3) == RANK_DEAD)
    return st.replace(
        nbr_id=torch.where(drop, -1, st.nbr_id),
        nbr_key=torch.where(drop, UNKNOWN_KEY, keys).to(_kdt(st)),
    )


def _promote(st: PviewState, params: PviewParams) -> PviewState:
    """Active-view repair: each empty/DEAD active slot, ascending, swaps in
    the best (max-key) live passive entry."""
    ka = params.active_slots
    nbr_id, nbr_key = st.nbr_id, st.nbr_key
    k = nbr_id.shape[1]
    kr = torch.arange(k, device=st.device)[None, :]
    for a in range(ka):
        keys = nbr_key.to(torch.int32)
        a_id = nbr_id[:, a]
        a_key = keys[:, a]
        bad = (a_id < 0) | ((a_key & 3) == RANK_DEAD)
        p_ids = nbr_id[:, ka:]
        p_keys = keys[:, ka:]
        ok_p = (p_ids >= 0) & ((p_keys & 3) != RANK_DEAD)
        score = torch.where(ok_p, p_keys, NO_CANDIDATE)
        j = torch.argmax(score, dim=1)
        has = torch.gather(score, 1, j[:, None])[:, 0] > NO_CANDIDATE
        do = (bad & has)[:, None]
        src = (ka + j)[:, None]
        sel_a = kr == a
        sel_p = kr == src
        id_a = torch.gather(nbr_id, 1, src)
        key_a = torch.gather(nbr_key, 1, src)
        nbr_id = torch.where(do & sel_a, id_a, torch.where(do & sel_p, a_id[:, None], nbr_id))
        nbr_key = torch.where(
            do & sel_a, key_a, torch.where(do & sel_p, nbr_key[:, a : a + 1], nbr_key)
        )
    return st.replace(nbr_id=nbr_id, nbr_key=nbr_key)


def _mr_apply_packed(state: PviewState, recv_m_p, zero_p, params: PviewParams, adaptive: bool = False):
    """A sequential apply passes over the packed eligibility words: per
    pass and row, the lowest still-eligible pool column is the lowest set
    bit of the first non-zero word. ``state.minf_age`` must be the plane the
    gossip phase's aging pass just made (it is updated in place).

    Returns (state, delivered, accepts, packed bits extracted this tick),
    and with ``adaptive`` the confirmation evidence (accepted SUSPECT
    records per subject, and their max key)."""
    n = _gcap(state)
    W = recv_m_p.shape[1]
    dev = state.device
    ka = params.active_slots

    # origin-row exclusion: column c's bit lands in row mr_origin[c] (on a
    # mesh, at its local row on the rank that holds it)
    excl_p = origin_words_here(state, W)
    active_p = pack_bits(state.mr_active[None, :])[0]
    rem0 = recv_m_p & zero_p & ~excl_p & active_p[None, :]
    rem0 = torch.where(state.up[:, None], rem0, 0)

    minf = state.minf_age
    rem_p = rem0.clone()
    sus_acc = torch.full((n,), NO_CANDIDATE, dtype=torch.int32, device=dev)
    ad_cnt = torch.zeros((n + 1,), dtype=torch.int32, device=dev) if adaptive else None
    delivered = torch.zeros((), dtype=torch.int32, device=dev)
    accepts = torch.zeros((), dtype=torch.int32, device=dev)
    st = state
    for _ in range(params.apply_slots):
        nz = rem_p != 0
        got = nz.any(dim=1)
        w = first_true(nz, 1)[:, None]
        v = to_u32(torch.gather(rem_p, 1, w))
        lsb = v & -v
        b = popcount((lsb - 1) & MASK32)
        col = torch.where(got[:, None], w * 32 + b, 0)
        scatter_(rem_p, 1, w, to_i32(v & (v - 1)))
        cur = torch.gather(minf, 1, col)
        scatter_(minf, 1, col, torch.maximum(cur, got[:, None].to(torch.uint8)))
        col = col[:, 0]
        subj = st.mr_subject[col]
        cand = st.mr_key[col]
        st, acc, sus_cand = _apply_records(st, subj, cand, got, SALT_GOSSIP, ka)
        sus_acc = torch.maximum(sus_acc, sus_cand)
        if adaptive:
            _count_confirmations(ad_cnt, acc, subj, cand)
        delivered = delivered + _i32(got)
        accepts = accepts + _i32(acc)
    sus_acc = _mine(sus_acc, "max")
    state = _register_sus(st.replace(minf_age=minf), sus_acc)
    if adaptive:
        return state, delivered, accepts, rem0 ^ rem_p, {"_ad_cnt": _mine(ad_cnt[:n], "sum"), "_ad_key": sus_acc}
    return state, delivered, accepts, rem0 ^ rem_p


def _count_confirmations(ad_cnt, accept, subj, cand) -> None:
    """Add one confirmation per accepted SUSPECT record to its subject
    (AD-1), in place into the [N + 1] ``ad_cnt`` (slot N takes the rest)."""
    n = ad_cnt.shape[0] - 1
    acc_sus = accept & ((cand & 3) == RANK_SUSPECT)
    ad_cnt.index_add_(0, torch.where(acc_sus, subj.clamp(min=0), n).long(), acc_sus.to(torch.int32))


_GOSSIP_METRICS = ("gossip_msgs", "rumor_sends", "rumor_deliveries", "mr_deliveries", "mr_accepts")


def _gossip_phase_fused(state: PviewState, r: SparseRoundRandoms, params: PviewParams,
                        adaptive: bool = False):
    """Infection-style dissemination, fused: aging + packing of the
    membership planes, active-view peer sampling, the per-fanout-slot
    inverse-sender election, the delivery combine (:mod:`.delivery` — the
    CUDA kernel on the card), the user-rumor infection, and the packed
    A-pass membership apply. Quiescent clusters skip the phase.
    ``params.dissem`` swaps in the strategy's circulant peers, its user-
    rumor budget and, for ``push_pull``, the reply leg
    (:func:`._tick.pull_replies`); the kernel sees only their ``inv``.
    ``adaptive`` adds the membership apply's confirmation evidence.

    On a mesh the delivery is the ragged record exchange
    (:mod:`.ragged_a2a`; no kernel launch), and the metrics carry its
    ``delivery_overflow``.

    Returns ``(state, metrics, fwd_post_p)``."""
    n = state.capacity
    m = params.mr_pool
    F = params.fanout
    spread = params.spread_ticks
    W = words_for(m)
    dev = state.device
    rows = _grows(state)
    ctx = _shard()

    D = params.delay_slots
    # one read: the pools, and with the rings their slot due this tick
    u_any, m_any, pu, pm = host_flags(
        state.rumor_active.any(), state.mr_active.any(), *pending_now_flags(state, D)
    )
    mr_any = m_any or pm
    if not (u_any or mr_any or pu):
        z = torch.zeros((), dtype=torch.int32, device=dev)
        mets = {k: z for k in _GOSSIP_METRICS}
        if ctx is not None:
            mets["delivery_overflow"] = z
        if adaptive:
            mets.update(_no_evidence(n, dev))
        return state, mets, torch.zeros((n, W), dtype=torch.int32, device=dev)

    young_u = (
        state.infected
        & state.rumor_active[None, :]
        & ((state.tick - state.infected_at) < spread)
    )
    # the strategy's payload budget (DZ-3; None for every strategy but
    # pipelined) masks the user rumors before sender_has reads them
    spec = params.dissem
    bmask = dz.rumor_budget_mask(spec, young_u.shape[1], state.tick, dev)
    if bmask is not None:
        young_u &= bmask[None, :]
    if mr_any:
        # [N, M] u8 planes are 2 GiB each at a million rows: age a fresh
        # copy in place, and pack the forwarding plane once
        age = state.minf_age.clamp(max=254)
        age += age > 0
        # 0 < age <= spread in one uint8 compare: age 0 wraps to 255
        fwd = (age - 1) < min(spread, 255)
        fwd_p = pack_bits(fwd)
        del fwd
        ym_p = fwd_p & pack_bits(state.mr_active[None, :])
        zero_p = pack_bits(age == 0)
        state = state.replace(minf_age=age)
    else:
        ym_p = zero_p = fwd_p = torch.zeros((n, W), dtype=torch.int32, device=dev)

    if spec.uniform_selection:
        _slots, peers, peer_valid = _sample_slots(
            state, r.gossip_try, F, params.sample_tries, params.active_slots
        )
    else:
        # circulant targets (DZ-1); the random strategies read the first
        # try of each pick's rejection block (on a mesh: every row's, and
        # each rank keeps its rows)
        u_try = r.gossip_try if ctx is None else ctx.draws[1].gossip_try
        peers, peer_valid = dz.structured_peers(
            spec, _gcap(state), state.tick, dz.try_stride_uniforms(u_try, params.sample_tries)
        )
        if ctx is not None:
            peers, peer_valid = ctx.mine(peers), ctx.mine(peer_valid)
    yu_p = pack_bits(young_u)

    sender_has = young_u.any(dim=1) | (ym_p != 0).any(dim=1)
    p_all = peers.T.contiguous()  # [F, N]
    rows_b = rows[None, :].expand(F, n)
    ok_all = (
        peer_valid.T
        & sender_has[None, :]
        & state.up[None, :]
        & _full(state.up)[p_all]
        & (r.gossip_edge.T < (1.0 - _loss_at(state, rows_b, p_all)))
    )
    sent = _i32(ok_all)
    if D:
        # each edge's delay: only the undelayed contacts deliver now
        d_all = delay_ticks(r.gossip_delay.T, state.delay_q, D)
        ok_now_all = ok_all & (d_all == 0)
    else:
        ok_now_all = ok_all
    if ctx is not None:
        from .ragged_a2a import ragged_delivery_combine

        payload = torch.cat([ym_p, yu_p, state.infected_from], dim=1)
        recv_u, recv_src, recv_m_p, rumor_sent, overflow = ragged_delivery_combine(
            payload, p_all, ok_now_all, state.rumor_origin, W, state.infected_from.shape[1],
            mesh=ctx.mesh, capacity=ctx.n, budget=ctx.budget,
        )
        del payload
    else:
        inv = torch.full((F, n), -1, dtype=torch.int32, device=dev)
        inv.scatter_reduce_(
            1, p_all.long(), torch.where(ok_now_all, rows_b, -1), "amax", include_self=True
        )
        # the kernel reads the three sender planes in place: no payload copy
        recv_u, recv_src, recv_m_p, rumor_sent = delivery.delivery_combine(
            ym_p, yu_p, state.infected_from, inv, state.rumor_origin.contiguous()
        )
    if D:
        recv_u, recv_src, recv_m_p = receive_pending(state, D, pu, pm, recv_u, recv_src, recv_m_p)
    if spec.wants_pull:
        pulled, rumor_pulled = pull_replies(state, ok_now_all, p_all, ym_p, yu_p, _loss_at, recv_u, recv_src, recv_m_p)
        sent = sent + pulled
        # on a mesh the exchange's rumor count is global already
        rumor_sent = rumor_sent + _reduce(rumor_pulled, "sum")
    if D:
        late_deliveries_(state, D, ok_all, d_all, p_all, ym_p, yu_p, u_any, m_any)

    newly_u = recv_u & ~state.infected & state.up[:, None] & state.rumor_active[None, :]
    state = state.replace(
        infected=state.infected | newly_u,
        infected_at=torch.where(newly_u, state.tick, state.infected_at).to(torch.int32),
        infected_from=torch.where(newly_u, recv_src, state.infected_from),
    )
    ev = _no_evidence(n, dev) if adaptive else {}
    if mr_any:
        state, n_mr_deliveries, n_mr_accepts, extracted, *rest = _mr_apply_packed(
            state, recv_m_p, zero_p, params, adaptive
        )
        if adaptive:
            ev = rest[0]
        fwd_post_p = fwd_p | extracted
    else:
        n_mr_deliveries = n_mr_accepts = torch.zeros((), dtype=torch.int32, device=dev)
        fwd_post_p = fwd_p
    if D:
        clear_pending_now_(state, D, pu, pm)
    mets = {
        "gossip_msgs": sent,
        "rumor_sends": rumor_sent,
        "rumor_deliveries": _i32(newly_u),
        "mr_deliveries": n_mr_deliveries,
        "mr_accepts": n_mr_accepts,
        **ev,
    }
    if ctx is not None:
        mets["delivery_overflow"] = overflow
    return state, mets, fwd_post_p


def _merge_entries_compact(state, src_rows, pre_id, pre_key_i32, pre_self, salt, params, K,
                           adaptive: bool = False):
    """The k + 1 accept-and-place steps of a SYNC direction, run over the
    ≤ K participating rows (``src_rows >= 0``) only: each merges its
    source's pre-exchange table and self record. Returns (state,
    accepted-count [N], top-P accepted subjects [N, P], their keys [N, P]),
    and with ``adaptive`` the confirmation evidence."""
    n = state.capacity
    dev = state.device
    kdt = _kdt(state)
    P = params.sync_announce
    ka = params.active_slots
    pidx = nonzero_fixed(src_rows >= 0, K, n)
    ridx = pidx.clamp(max=n - 1)
    has = (pidx < n) & (src_rows[ridx] >= 0)
    src = src_rows[ridx].clamp(min=0).long()
    subj_steps = torch.cat([pre_id[src].T, src[None, :].to(torch.int32)], dim=0)
    cand_steps = torch.cat([pre_key_i32[src].T, pre_self[src][None, :]], dim=0)
    sub_id = state.nbr_id[ridx]
    sub_key = _keys_i32(state)[ridx]
    sub_self = state.self_key[ridx]
    ridx32 = ridx.to(torch.int32)
    acc_cnt = torch.zeros((K,), dtype=torch.int32, device=dev)
    best_key = torch.full((K, P), NO_CANDIDATE, dtype=torch.int32, device=dev)
    best_subj = torch.zeros((K, P), dtype=torch.int32, device=dev)
    sus_acc = torch.full((n,), NO_CANDIDATE, dtype=torch.int32, device=dev)
    ad_cnt = torch.zeros((n + 1,), dtype=torch.int32, device=dev) if adaptive else None
    for subj, cand in zip(subj_steps, cand_steps):
        valid = has & (subj >= 0)
        sub_id, sub_self, accept, onehot = _accept_and_place(
            state.tick, state, ridx32, sub_id, sub_key, sub_self, subj, cand, valid, salt, ka
        )
        # round trip through the storage dtype, as a write to nbr_key does
        cand_rt = cand.to(kdt).to(torch.int32)
        sub_key = torch.where(onehot, cand_rt[:, None], sub_key)
        sus_acc = torch.maximum(sus_acc, _sus_election(n, accept, subj, cand))
        if adaptive:
            _count_confirmations(ad_cnt, accept, subj, cand)
        acc_cnt = acc_cnt + accept.to(torch.int32)
        ins_k = torch.where(accept, cand, NO_CANDIDATE)
        ins_s = subj
        for p in range(P):
            old_k, old_s = best_key[:, p].clone(), best_subj[:, p].clone()
            take = ins_k > old_k
            best_key[:, p] = torch.where(take, ins_k, old_k)
            best_subj[:, p] = torch.where(take, ins_s, old_s)
            ins_k = torch.where(take, old_k, ins_k)
            ins_s = torch.where(take, old_s, ins_s)

    ok = pidx < n

    def _scatter_back(base, vals):
        return put_drop_(base, (pidx,), vals, ok)

    state = state.replace(
        nbr_id=_scatter_back(state.nbr_id.clone(), sub_id),
        nbr_key=_scatter_back(state.nbr_key.clone(), sub_key.to(kdt)),
        self_key=_scatter_back(state.self_key.clone(), sub_self),
    )
    state = _register_sus(state, sus_acc)
    acc_full = _scatter_back(torch.zeros((n,), dtype=torch.int32, device=dev), acc_cnt)
    subj_full = _scatter_back(torch.zeros((n, P), dtype=torch.int32, device=dev), best_subj)
    key_full = _scatter_back(torch.full((n, P), NO_CANDIDATE, dtype=torch.int32, device=dev), best_key)
    if adaptive:
        return state, acc_full, subj_full, key_full, {"_ad_cnt": ad_cnt[:n], "_ad_key": sus_acc}
    return state, acc_full, subj_full, key_full


def _sync_phase(state: PviewState, r: SparseRoundRandoms, params: PviewParams, adaptive: bool = False,
                trace: bool = False):
    """Anti-entropy + shuffle: each due caller (forced first, then periodic,
    compacted to K) exchanges its table and self record with one peer drawn
    from ``active slots ∪ seeds`` (every ``seed_sync_every``-th periodic
    round deterministically to a seed); both directions merge the other's
    PRE-exchange entries (P4); several callers on one peer collapse to the
    highest slot (P6). ``adaptive`` adds both directions' confirmation
    evidence, ``trace`` the compacted callers' outcomes (``trace_sync``:
    a caller's request-side accepts are its peer's when it won the peer)."""
    n = state.capacity
    dev = state.device
    rows = _rows(state)
    P = params.sync_announce
    K = min(n, params.sync_slots or (n // params.sync_every + 32))
    karange = torch.arange(K, device=dev)
    due_p = ((state.tick + rows * params.sync_stagger) % params.sync_every) == 0
    due_f = state.force_sync & state.up
    due_p = due_p & state.up & ~due_f
    cf = nonzero_fixed(due_f, K, n)
    nf = (cf < n).sum()
    cp = nonzero_fixed(due_p, K, n)
    buf = torch.cat([cf, cf.new_full((1,), n)])
    pos = karange + nf
    scatter_(buf, 0, torch.where(pos < K, pos, K), cp)
    caller = buf[:K]
    valid_c = caller < n
    caller = caller.clamp(max=n - 1).to(torch.int32)

    ka = params.active_slots
    S = len(params.seed_rows)
    pool = ka + S
    u_try = r.sync_try[caller]
    tries = (u_try * float(pool)).to(torch.int32).clamp(max=pool - 1)
    is_seed = tries >= ka
    slot_c = tries.clamp(max=ka - 1).long()
    sid = torch.gather(state.nbr_id[caller], 1, slot_c)
    skey = torch.gather(state.nbr_key[caller], 1, slot_c).to(torch.int32)
    tab_ok = ~is_seed & (sid >= 0) & ((skey & 3) != RANK_DEAD)
    if S:
        seeds_arr = _seed_rows_tensor(params.seed_rows, dev)
        seed_pick = seeds_arr[(tries - ka).clamp(0, S - 1)]
        member_try = torch.where(is_seed, seed_pick, sid.clamp(min=0))
        ok_try = tab_ok | (is_seed & (seed_pick != caller[:, None]))
    else:
        member_try = sid.clamp(min=0)
        ok_try = tab_ok
    peer = torch.full((K,), -1, dtype=torch.int32, device=dev)
    for t_i in range(params.sample_tries):
        peer = torch.where((peer < 0) & ok_try[:, t_i], member_try[:, t_i], peer)
    valid_pick = peer >= 0
    peer = peer.clamp(min=0)
    if S:
        fb = seeds_arr[(r.sync_fb[caller] * float(S)).to(torch.int32).clamp(max=S - 1)]
        use_fb = ~valid_pick & (fb != caller)
        peer = torch.where(use_fb, fb, peer)
        valid_pick = valid_pick | use_fb
        Q = params.seed_sync_every
        round_ = (state.tick + caller * params.sync_stagger) // params.sync_every
        sidx = (caller + round_ // Q) % S
        sp = seeds_arr[sidx]
        sp = torch.where(sp == caller, seeds_arr[(sidx + 1) % S], sp)
        is_periodic = karange >= nf
        use_seed = ((round_ % Q) == 0) & (sp != caller) & is_periodic & valid_c
        peer = torch.where(use_seed, sp, peer)
        valid_pick = valid_pick | use_seed
    p_rt = (_rt_timely(state, caller, peer, params.sync_timeout_ticks) if params.delay_slots
            else _rt_at(state, caller, peer))
    ok = valid_c & valid_pick & state.up[peer] & (r.sync_edge[caller] < p_rt)

    pre_id = state.nbr_id
    pre_key = _keys_i32(state)
    pre_self = state.self_key

    # REQ direction: the highest-slot caller wins each peer (P6)
    inv_slot = scatter_reduce_1d(n, peer, torch.where(ok, karange, -1), "amax", -1, torch.int32)
    req_src = torch.where(inv_slot >= 0, caller[inv_slot.clamp(min=0)], -1)
    st, req_acc_n, req_subj, req_key, *req_ev = _merge_entries_compact(
        state, req_src, pre_id, pre_key, pre_self, SALT_SYNC_REQ, params, K, adaptive
    )
    # ACK direction: distinct callers each merge their peer's pre-entries
    ack_src = scatter_reduce_1d(n, caller, torch.where(ok, peer, -1), "amax", -1, torch.int32)
    st, ack_acc_n, ack_subj, ack_key, *ack_ev = _merge_entries_compact(
        st, ack_src, pre_id, pre_key, pre_self, SALT_SYNC_ACK, params, K, adaptive
    )
    ok_full = scatter_reduce_1d(n, caller, ok, "amax", 0, torch.int32) > 0
    st = st.replace(force_sync=st.force_sync & ~ok_full)

    # re-gossip proposals: top-P accepted per participant, REQ receivers
    # first then ACK receivers — [N·P] each direction
    def _props(subj2, key2, part_mask):
        return (
            torch.cat([subj2[:, p] for p in range(P)]),
            torch.cat([key2[:, p] for p in range(P)]),
            torch.cat([rows] * P),
            torch.cat([part_mask & (key2[:, p] > NO_CANDIDATE) for p in range(P)]),
        )

    props = tuple(
        torch.cat([a, b])
        for a, b in zip(_props(req_subj, req_key, req_src >= 0), _props(ack_subj, ack_key, ack_src >= 0))
    )
    metrics = {"sync_roundtrips": _i32(ok)}
    if adaptive:
        (req_ev,), (ack_ev,) = req_ev, ack_ev
        metrics["_ad_cnt"] = req_ev["_ad_cnt"] + ack_ev["_ad_cnt"]
        metrics["_ad_key"] = torch.maximum(req_ev["_ad_key"], ack_ev["_ad_key"])
    if trace:
        winner = ok & (inv_slot[peer.long()] == karange)
        metrics["trace_sync"] = _sync_trace(
            caller, valid_c, peer, ok,
            torch.where(winner, req_acc_n[peer.long()], 0), torch.where(ok, ack_acc_n[caller.long()], 0),
        )
    return st, props, metrics


#: the leaves SYNC reads at other members' rows, and those it writes
_SYNC_READS = ("up", "part_id", "nbr_id", "nbr_key", "self_key", "force_sync", "sus_key", "sus_since")
_SYNC_WRITES = ("nbr_id", "nbr_key", "self_key", "force_sync", "sus_key", "sus_since")


def _sync_phase_sharded(state: PviewState, params: PviewParams, adaptive: bool = False, trace: bool = False):
    """:func:`_sync_phase` on a mesh. Its K callers are compacted over all N
    rows, their peers and merge partners are anywhere, so every rank runs
    the phase over the gathered tables it reads and the full draws, and
    keeps its rows of what it wrote. The proposals, the round-trip count
    and the trace export come out whole, the same on every rank."""
    ctx = _shard()
    full = state.replace(**{k: ctx.full(getattr(state, k)) for k in _SYNC_READS})
    with _unsharded():
        st, props, metrics = _sync_phase(full, ctx.draws[1], params, adaptive=adaptive, trace=trace)
    state = state.replace(**{k: ctx.mine(getattr(st, k)).clone() for k in _SYNC_WRITES})
    if adaptive:
        metrics["_ad_cnt"] = ctx.mine(metrics["_ad_cnt"])
        metrics["_ad_key"] = ctx.mine(metrics["_ad_key"])
    return state, props, metrics


def _refute_phase(state: PviewState, params: PviewParams):
    """Self-record refutation (bump through :func:`.lattice.bump_inc`)."""
    n = _gcap(state)
    rows = _grows(state)
    kdt = _kdt(state)
    diag = state.self_key
    rank = diag & 3
    need = state.up & (
        (rank == RANK_SUSPECT) | (rank == RANK_DEAD) | (state.leaving & (rank != RANK_LEAVING))
    )
    V = min(n, params.refute_slots or max(64, n // 16))
    eff = _capped(need, V)
    announce_rank = torch.where(state.leaving, RANK_LEAVING, RANK_ALIVE).to(kdt)
    bumped = bump_inc(diag.to(kdt), announce_rank).to(torch.int32)
    new_diag = torch.where(eff, bumped, diag)
    return state.replace(self_key=new_diag), (rows, new_diag, rows, eff)


def _rumor_sweeps_fused(state: PviewState, params: PviewParams, fwd_post_p) -> PviewState:
    """Slot reclamation with the static windows (P2). The membership
    forwarding test reads the packed forwarding plane the gossip phase
    handed over, OR-reduced over the up rows."""
    sweep = params.sweep_ticks
    m = params.mr_pool
    keep_u = (state.tick - state.rumor_created) <= sweep
    forwarding_u = _reduce((
        state.infected
        & state.up[:, None]
        & ((state.tick - state.infected_at) < params.spread_ticks)
    ).any(dim=0), "max")
    keep_u = keep_u | forwarding_u
    D = params.delay_slots
    if D:
        # a rumor in flight on any rank stays on every rank (the pools are
        # replicated)
        keep_u = keep_u | _reduce(state.pending_inf.flatten(0, 1).any(dim=0), "max")
    state = state.replace(rumor_active=state.rumor_active & keep_u)

    (mr_any,) = host_flags(state.mr_active.any())
    if not mr_any:
        return state
    fwd_words = or_rows(torch.where(state.up[:, None], fwd_post_p, 0))
    forwarding_m = _reduce(unpack_bits(fwd_words[None, :], m)[0], "max")
    keep_m = ((state.tick - state.mr_created) <= sweep) | forwarding_m
    # a rumor with deliveries in flight stays, and is not freed as covered
    pending_m = _reduce(state.pending_minf.flatten(0, 1).any(dim=0), "max") if D else None
    if D:
        keep_m = keep_m | pending_m
    if params.early_free:
        covered = _reduce(covered_columns(state), "min")
        keep_m = keep_m & ~(covered & ~pending_m) if D else keep_m & ~covered
    keep_m = keep_m & state.mr_active
    freed = state.mr_active & ~keep_m
    if D:
        keep_columns_(state.pending_minf, keep_m)
    return state.replace(
        mr_active=keep_m,
        mr_subject=torch.where(freed, -1, state.mr_subject),
        minf_age=state.minf_age.masked_fill(freed[None, :], 0),
    )


def state_metrics(state: PviewState, params: PviewParams) -> dict:
    """State-derived health metrics over the table edges."""
    dev = state.device
    n_up = _reduce(state.up.sum(), "sum").to(torch.int32)
    metrics = rumor_metrics(state, params, n_up, reduce=_reduce)
    if params.full_metrics:
        keys = _keys_i32(state)
        sid = state.nbr_id
        rank = keys & 3
        edges = (sid >= 0) & state.up[:, None] & _full(state.up)[sid.clamp(min=0)]
        n_edges = _reduce(edges.sum(), "sum").clamp(min=1).to(torch.float32)
        n_alive = _reduce((edges & (rank == RANK_ALIVE)).sum(), "sum")
        metrics["alive_view_fraction"] = n_alive.to(torch.float32) / n_edges
        metrics["false_suspect_pairs"] = _reduce((edges & (rank == RANK_SUSPECT)).sum(), "sum").to(torch.int32)
    else:
        metrics["alive_view_fraction"] = torch.zeros((), dtype=torch.float32, device=dev)
        metrics["false_suspect_pairs"] = torch.zeros((), dtype=torch.int32, device=dev)
    return metrics


# ---------------------------------------------------------------------------
# tick + window
# ---------------------------------------------------------------------------


_FD_METRICS = ("fd_probes", "fd_failed_probes", "fd_new_suspects")
#: the metrics that count this rank's rows on a mesh (the others come out
#: whole: reduced where they are made, or from replicated leaves)
_ROW_SUMS = _FD_METRICS + ("gossip_msgs", "rumor_deliveries", "mr_deliveries", "mr_accepts")


def pview_tick_fused(state: PviewState, fd_r, round_r: SparseRoundRandoms, params: PviewParams,
                     ad=None, trace=None, timer=None):
    """One gossip period for all N members (the JAX ``pview_tick_fused``):
    FD → maintenance sweep → gossip → SYNC → refute → rumor sweeps → pool
    allocation → metrics. ``fd_r`` is read only on FD ticks
    (``tick % fd_every == 0`` after the increment) and may be None
    otherwise. Returns ``(state, metrics)``, or with ``ad`` (the adaptive
    plane, as in the dense ``tick``) ``(state, ad', metrics)``. ``trace``
    (a TraceSpec) adds the ``_trace_rows`` record block the JAX unfused
    tick builds (the fused phases compute the same state, and the records
    need only the per-row accept counts the compact SYNC merge returns);
    ``timer`` scopes each phase for the phase-split profiler."""
    armed = ad is not None
    traced = trace is not None
    if armed and traced:
        raise ValueError("trace-armed adaptive windows are not supported")
    if armed and params.adaptive.is_default:
        raise ValueError("adaptive tick needs an enabled AdaptiveSpec on params")
    state = state.replace(tick=state.tick + 1)
    n = state.capacity
    fd_ran = state.tick % params.fd_every == 0
    with _phase(timer, "fd"):
        if fd_ran:
            if fd_r is None:
                raise ValueError(f"tick {state.tick} runs the FD round and needs FD draws")
            state, props_fd, fd_m, keys_h = _fd_phase(state, fd_r, params, ad=ad, trace=traced)
        else:
            z = torch.zeros((), dtype=torch.int32, device=state.device)
            props_fd, fd_m, keys_h = _no_props(state), {k: z for k in _FD_METRICS}, None
            if armed:
                fd_m.update(_no_evidence(n, state.device, probes=True))
            if traced:
                from ..trace import capture as _tc

                fd_m["trace_fd"] = _tc.zero_fd_trace(n, params.ping_req_k, state.device)
    with _phase(timer, "suspicion"):
        if traced:
            state, props_exp, trace_sus = _maintenance_sweep(state, params, keys_h, trace=trace)
        else:
            state, props_exp = _maintenance_sweep(state, params, keys_h, ad=ad)
    with _phase(timer, "gossip"):
        state, g_m, fwd_post_p = _gossip_phase_fused(state, round_r, params, adaptive=armed)
    ctx = _shard()
    with _phase(timer, "sync"):
        if ctx is None:
            state, props_sync, s_m = _sync_phase(state, round_r, params, adaptive=armed, trace=traced)
        else:
            state, props_sync, s_m = _sync_phase_sharded(state, params, adaptive=armed, trace=traced)
    with _phase(timer, "refute"):
        state, props_ref = _refute_phase(state, params)
    with _phase(timer, "sweep"):
        state = _rumor_sweeps_fused(state, params, fwd_post_p)
    with _phase(timer, "alloc"):
        state, a_m = alloc_phase(state, (*map(_global_props, (props_fd, props_exp, props_ref)), props_sync),
                                 params)
    trace_fd = fd_m.pop("trace_fd", None)
    trace_sync = s_m.pop("trace_sync", None)
    with _phase(timer, "telemetry"):
        if armed:
            ad = _fold_evidence(params, ad, fd_m, g_m, s_m, props_ref[3], state.up)
        metrics = {**fd_m, **g_m, **s_m, **a_m, **state_metrics(state, params)}
        if ctx is not None:
            # the rows' counts, summed over the ranks in one collective
            total = _reduce(torch.stack([metrics[k].to(torch.int64) for k in _ROW_SUMS]), "sum")
            metrics.update(zip(_ROW_SUMS, total.to(torch.int32).unbind(0)))
        if armed:
            metrics["adaptive_lh_high"] = _reduce(ad.lh.max(), "max")
            metrics["adaptive_conf_high"] = _reduce(ad.conf.max(), "max")
            return state, ad, metrics
        if traced:
            refuted = props_ref[3]
            if ctx is not None:
                # the ring is whole on every rank: its records come from
                # every row
                trace_fd = {k: ctx.full(v) for k, v in trace_fd.items()}
                refuted = ctx.full(refuted)
                state_t = state.replace(**{k: ctx.full(getattr(state, k))
                                           for k in ("up", "infected", "infected_at", "infected_from")})
            else:
                state_t = state
            metrics["_trace_rows"] = _sparse_trace_rows(
                state_t, trace, fd_ran, trace_fd, trace_sus, refuted, trace_sync
            )
    return state, metrics


def run_pview_ticks_fused(state: PviewState, draws, n_ticks: int, params: PviewParams,
                          watch_rows=None):
    """Run ``n_ticks`` fused ticks (:func:`._tick.run_window`: ``draws`` is
    a ``torch.Generator`` on the state's device or ``n_ticks`` ``(fd,
    round)`` draw pairs). Returns ``(state, metrics stacked to [n_ticks],
    watched)``; ``watched`` is the [n_ticks, W, N] synthesized key rows of
    ``watch_rows`` after each tick, or None."""
    return run_window(pview_tick_fused, view_rows, draw_sparse_tick, state, draws, n_ticks, params, watch_rows)


def make_pview_fused_run(params: PviewParams, n_ticks: int):
    """The window as a callable ``run(state, draws, watch_rows=None)`` —
    the counterpart of the JAX function of the same name."""

    def run(state: PviewState, draws, watch_rows=None):
        return run_pview_ticks_fused(state, draws, n_ticks, params, watch_rows)

    return run


def pview_tick(state: PviewState, fd_r, round_r: SparseRoundRandoms, params: PviewParams,
               trace=None, ad=None, timer=None):
    """One gossip period (the JAX ``pview_tick``): the fused tick, whose
    state and metrics are the unfused tick's, with the unfused tick's trace
    records when ``trace`` is armed. Returns ``(state, metrics)``, or
    ``(state, ad', metrics)`` with ``ad``."""
    return pview_tick_fused(state, fd_r, round_r, params, ad=ad, trace=trace, timer=timer)


def run_pview_ticks_traced(state: PviewState, ring, draws, n_ticks: int, params: PviewParams, trace,
                           watch_rows=None):
    """Trace-armed :func:`run_pview_ticks`: each tick's record block is
    appended in place to ``ring`` at its host cursor; the trajectory is the
    unarmed window's. Returns ``(state, metrics, watched)``."""
    return run_window(pview_tick_fused, view_rows, draw_sparse_tick, state, draws, n_ticks, params, watch_rows,
                      trace=trace, ring=ring)


def make_pview_traced_run(params: PviewParams, n_ticks: int, trace):
    """The traced window as a callable ``run(state, ring, draws,
    watch_rows=None)``; refuses an armed adaptive spec."""
    if not params.adaptive.is_default:
        raise ValueError("trace-armed adaptive windows are not supported")
    def run(state: PviewState, ring, draws, watch_rows=None):
        return run_pview_ticks_traced(state, ring, draws, n_ticks, params, trace, watch_rows)

    return run


def tracer_view_cols(state: PviewState, tracer_rows) -> torch.Tensor:
    """The tracers' [N, K] int32 view-key columns synthesized from the
    [N, k] tables: observer i's record about tracer t (-1 unknown; the
    tracer's own row carries its self record) — the trace plane's
    window-boundary diff feed. One [N, k] pass per tracer."""
    from ..trace.capture import tracer_index

    keys = _keys_i32(state)
    sid = state.nbr_id
    cols = _full(torch.stack(
        [torch.where(sid == int(t), keys, UNKNOWN_KEY).amax(dim=1) for t in tracer_rows], dim=1
    ))
    tr = tracer_index(tracer_rows, state.device)
    cols[tr, torch.arange(tr.shape[0], device=state.device)] = _full(state.self_key)[tr]
    return cols


def run_pview_ticks_adaptive(state: PviewState, ad, draws, n_ticks: int, params: PviewParams,
                             watch_rows=None):
    """:func:`run_pview_ticks_fused` with the adaptive plane ``ad`` threaded
    through the window. Returns ``(state, ad, metrics, watched)``."""
    return run_window(pview_tick_fused, view_rows, draw_sparse_tick, state, draws, n_ticks, params,
                      watch_rows, ad=ad)


def make_pview_adaptive_run(params: PviewParams, n_ticks: int):
    """The adaptive window as a callable ``run(state, ad, draws,
    watch_rows=None)`` — the fused tick, held against both JAX adaptive
    windows. Refuses a default spec."""
    if params.adaptive.is_default:
        raise ValueError(
            "make_pview_adaptive_run needs an enabled AdaptiveSpec on params — the default "
            "spec's window is make_pview_run's"
        )

    def run(state: PviewState, ad, draws, watch_rows=None):
        return run_pview_ticks_adaptive(state, ad, draws, n_ticks, params, watch_rows)

    return run


# pview telemetry ring layout: the sparse series plus the two mesh
# columns. ``delivery_overflow`` (the sharded delivery's drop count) is 0 on
# one device; ``shard_peak_mem_mb`` is the whole state's footprint,
# reckoned once when the plane is armed (``telemetry/plane.py``).
TELEMETRY_SERIES = _SPARSE_TELEMETRY_SERIES + (
    "delivery_overflow",
    "shard_peak_mem_mb",
)


def telemetry_window_vector(ms: dict, state: PviewState, *, shard_mem_mb: float = 0.0) -> torch.Tensor:
    """pview telemetry row: the sparse series and the two mesh columns, one
    [len(TELEMETRY_SERIES)] f32 vector (device ops only)."""
    dev = state.device
    overflow = ms["delivery_overflow"].sum().to(torch.float32) if "delivery_overflow" in ms else _f32(0.0, dev)
    return torch.stack(
        telemetry_window_core(ms, state) + pool_telemetry(ms) + [overflow, _f32(shard_mem_mb, dev)]
    )


def sentinel_reduce(state: PviewState, sent: dict, spec: dict) -> dict:
    """Pview chaos-sentinel check over the [N, k] tables and self records
    (the table-edge twin of :func:`.kernel.sentinel_core`): self-key
    regressions; never-faulted (and watched degraded) up subjects some up
    observer tables DEAD; a crashed row is detected once no up observer
    tables it non-DEAD; convergence once no up observer tables an up
    subject non-ALIVE; the view invariant (no duplicate subject and no
    self entry in a row's table), counted per check. Tensor reductions, no
    transfer. On a member mesh each rank checks its observer rows: the
    per-subject tables are combined with MAX, the counts summed in int64,
    and ``prev_diag`` holds the rank's own rows."""
    n = _gcap(state)
    dev = state.device
    keys = _keys_i32(state)
    sid = state.nbr_id
    sidc = sid.clamp(min=0).long()
    valid = sid >= 0
    rank = keys & 3
    rel = state.tick - spec["t0"]
    up_all = _full(state.up)

    def total(x) -> torch.Tensor:
        """A count over the ranks' rows."""
        return _reduce(x.sum(dtype=torch.int64), "sum").to(torch.int32)

    sent = dict(sent)
    sent["key_regressions"] = sent["key_regressions"] + total(state.self_key < sent["prev_diag"])
    sent["prev_diag"] = state.self_key.clone()

    def subjects_of(edge) -> torch.Tensor:
        """[N] bool: the subjects of the ``edge`` [N, k] table entries."""
        return _reduce(scatter_reduce_1d(n, torch.where(edge, sid, n).reshape(-1), edge.reshape(-1), "amax", 0,
                                         torch.int32), "max") > 0

    tomb = valid & state.up[:, None] & (rank == RANK_DEAD)
    nf_up = spec["never_faulted"] & up_all
    sent["false_dead_max"] = torch.maximum(
        sent["false_dead_max"], subjects_of(tomb & nf_up[sidc]).sum(dtype=torch.int32)
    )
    if "fp_watch" in spec:
        fp_up = spec["fp_watch"] & up_all
        sent["fp_dead_max"] = torch.maximum(
            sent["fp_dead_max"], subjects_of(tomb & fp_up[sidc]).sum(dtype=torch.int32)
        )
    crash_rows_ = spec["crash_rows"]
    if crash_rows_.shape[0]:
        held = subjects_of(valid & state.up[:, None] & (rank != RANK_DEAD))
        detected = ~held[crash_rows_.long()]
        active = (rel >= spec["crash_at"]) & (rel <= spec["crash_until"]) & (sent["detect_tick"] < 0)
        sent["detect_tick"] = torch.where(active & detected, rel, sent["detect_tick"]).to(torch.int32)
    if spec["conv_from"].shape[0]:
        converged = ~_reduce((valid & state.up[:, None] & up_all[sidc] & (rank != RANK_ALIVE)).any(), "max")
        active = (rel >= spec["conv_from"]) & (sent["conv_tick"] < 0)
        sent["conv_tick"] = torch.where(active & converged, rel, sent["conv_tick"]).to(torch.int32)

    k = sid.shape[1]
    off_diag = ~torch.eye(k, dtype=torch.bool, device=dev)
    rows = _grows(state)
    breaks = torch.zeros((), dtype=torch.int64, device=dev)
    for lo, hi in row_chunks(state.capacity):
        s, v = sid[lo:hi], valid[lo:hi]
        dup = (v[:, :, None] & v[:, None, :] & (s[:, :, None] == s[:, None, :]) & off_diag[None]).any(dim=(1, 2))
        self_entry = (v & (s == rows[lo:hi, None])).any(dim=1)
        breaks += (dup | self_entry).sum(dtype=torch.int64)
    sent["view_invariant_breaks"] = sent["view_invariant_breaks"] + _reduce(breaks, "sum").to(torch.int32)
    return sent


def sentinel_init(state: PviewState, spec) -> dict:
    """Fresh sentinel accumulators on the state's device, baselined on a
    copy of the current self records."""
    dev = state.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    sent = {
        "prev_diag": state.self_key.clone(),
        "key_regressions": z,
        "false_dead_max": z,
        "detect_tick": torch.full((len(spec.crash_rows),), -1, dtype=torch.int32, device=dev),
        "conv_tick": torch.full((len(spec.conv_from),), -1, dtype=torch.int32, device=dev),
        "view_invariant_breaks": z,
    }
    if spec.fp_watch.size and bool(spec.fp_watch.any()):
        sent["fp_dead_max"] = z
    return sent


def make_pview_fleet_run(params, n_ticks: int):
    """The fleet window (:mod:`.fleet`): ``run(fleet_state, draws,
    watch_rows=None) -> (fleet_state, metrics [S, T], watched)``, every
    scenario's tick one vmapped call per tick (the kernel: one launch of its
    scenario-axis variant per gossip tick)."""
    from .fleet import make_fleet_window

    return make_fleet_window(pview_tick_fused, view_rows, draw_sparse_tick, params, n_ticks)


def make_pview_fleet_adaptive_run(params, n_ticks: int):
    """The adaptive fleet window, ``ad`` stacked to [S, N]. Refuses a
    default spec."""
    from .fleet import make_fleet_window

    return make_fleet_window(pview_tick_fused, view_rows, draw_sparse_tick, params, n_ticks, adaptive=True)


# The JAX names of the driver's window: the same runners as the fused ones.
run_pview_ticks = run_pview_ticks_fused
make_pview_run = make_pview_fused_run
run_pview_ticks_fused_adaptive = run_pview_ticks_adaptive
make_pview_fused_adaptive_run = make_pview_adaptive_run
make_pview_fused_fleet_run = make_pview_fleet_run
