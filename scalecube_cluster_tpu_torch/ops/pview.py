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

Not ported yet, and refused: ``delay_slots > 0`` (the pending rings,
ROADMAP A2; with them the adaptive direct-probe stretch), mesh/ragged
delivery (A12), trace capture and telemetry (A10, second half). The fleet
windows (``make_pview_fleet_run``, its fused name,
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
from ._tick import count_i32 as _i32
from ._tick import no_props as _no_props
from ._tick import pull_replies
from ._tick import register_sus as _register_sus
from ._tick import row_index as _row_index
from ._tick import rows_of as _rows
from ._tick import seed_rows_tensor as _seed_rows_tensor
from ._tick import set_at as _set
from ._tensor import first_true, host_flags, nonzero_fixed, put_drop_, row_chunks, scatter_, scatter_reduce_1d
from .kernel import _fold_evidence, _no_evidence
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
        if self.delay_slots:
            raise NotImplementedError(
                "delay_slots > 0 (the pending delivery rings) is not ported yet (ROADMAP A2)"
            )

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
    small offsets in the passive tail); a cold start knows only the seeds."""
    if uniform_delay > 0:
        raise NotImplementedError("uniform_delay needs the delay rings (delay_slots > 0), not ported yet")
    n, k, m, r = params.capacity, params.view_slots, params.mr_pool, params.rumor_slots
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
        pending_minf=torch.zeros((0, n, m), dtype=torch.bool, device=device),
        pending_inf=torch.zeros((0, n, r), dtype=torch.bool, device=device),
        pending_src=torch.full((0, n, r), -1, dtype=i32, device=device),
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
    n = state.capacity
    rows = torch.as_tensor(rows, dtype=torch.int64, device=state.device).reshape(-1)
    ids = state.nbr_id[rows]
    keys = _keys_i32(state)[rows]
    full = torch.full((rows.shape[0], n + 1), UNKNOWN_KEY, dtype=torch.int32, device=state.device)
    full.scatter_reduce_(1, torch.where(ids >= 0, ids, n).long(), keys, "amax", include_self=True)
    full = full[:, :n].clone()
    full[torch.arange(rows.shape[0], device=state.device), rows] = state.self_key[rows]
    return full


# ---------------------------------------------------------------------------
# in-tick helpers
# ---------------------------------------------------------------------------


def _loss_at(state: PviewState, i, j) -> torch.Tensor:
    part = state.part_loss[state.part_id[i].long(), state.part_id[j].long()]
    return torch.maximum(state.loss, part)


def _rt_at(state: PviewState, i, j) -> torch.Tensor:
    return (1.0 - _loss_at(state, i, j)) * (1.0 - _loss_at(state, j, i))


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
    n = up_state.capacity
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
    fetch_ok = ~needs_fetch | (up_state.up[subj_c] & (u < _rt_at(up_state, rows, subj_c)))
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
    [N]) into every row's world. Returns (state, accepted, sus_cand)."""
    kdt = _kdt(state)
    rows = _rows(state)
    new_id, new_self, accept, onehot = _accept_and_place(
        state.tick, state, rows, state.nbr_id, _keys_i32(state), state.self_key,
        subj, cand, valid, salt, ka,
    )
    new_key = torch.where(onehot, cand[:, None].to(kdt), state.nbr_key)
    sus_cand = _sus_election(state.capacity, accept, subj, cand)
    state = state.replace(self_key=new_self, nbr_id=new_id, nbr_key=new_key)
    return state, accept, sus_cand


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _fd_phase(state: PviewState, r: SparseFdRandoms, params: PviewParams, ad=None):
    """FD round over the active view: slot-space target/relay selection,
    direct + indirect probes, the self-record ACK. Also returns the
    post-verdict int32 key plane for the maintenance sweep. With ``ad`` the
    metrics carry the adaptive evidence (``_ad_*``)."""
    n = state.capacity
    rows = _rows(state)
    ka = params.active_slots
    kdt = _kdt(state)
    keys = _keys_i32(state)
    tgt_slot_all, tgt_all, valid = _sample_slots(
        state, r.fd_try, 1 + params.ping_req_k, params.sample_tries, ka
    )
    tgt_slot = tgt_slot_all[:, 0]
    tgt = tgt_all[:, 0]
    has_tgt = valid[:, 0] & state.up
    direct_ok = has_tgt & state.up[tgt] & (r.fd_direct < _rt_at(state, rows, tgt))

    relays = tgt_all[:, 1:]
    relay_valid = valid[:, 1:]
    tgt_b = tgt[:, None]
    p_relay = _rt_at(state, rows[:, None], relays) * _rt_at(state, relays, tgt_b)
    relay_ok = relay_valid & state.up[relays] & state.up[tgt_b] & (r.fd_relay < p_relay)
    ack = direct_ok | relay_ok.any(dim=1)

    own_key = torch.gather(keys, 1, tgt_slot[:, None].long())[:, 0]
    alive_key = (state.self_key[tgt] >> 2) << 2
    suspect_key = ((own_key >> 2) << 2) | RANK_SUSPECT
    cand = torch.where(ack, alive_key, suspect_key)
    accept = has_tgt & (cand > own_key)
    V = min(n, params.fd_accept_slots or max(64, n // 16))
    eff = accept & (torch.cumsum(accept, 0) - 1 < V)

    k = state.nbr_id.shape[1]
    onehot = eff[:, None] & (torch.arange(k, device=state.device)[None, :] == tgt_slot[:, None])
    st = state.replace(nbr_key=torch.where(onehot, cand[:, None].to(kdt), state.nbr_key))
    sus_cand = scatter_reduce_1d(
        n, tgt, torch.where(eff & ~ack, cand, NO_CANDIDATE), "amax", NO_CANDIDATE, torch.int32
    )
    st = _register_sus(st, sus_cand)
    metrics = {
        "fd_probes": _i32(has_tgt),
        "fd_failed_probes": _i32(has_tgt & ~ack),
        "fd_new_suspects": _i32(eff & ~ack),
    }
    if ad is not None:
        metrics["_ad_miss"] = has_tgt & ~ack
        metrics["_ad_succ"] = has_tgt & ack
        metrics["_ad_cnt"] = torch.zeros((n,), dtype=torch.int32, device=state.device).index_add_(
            0, tgt.long(), (eff & ~ack).to(torch.int32)
        )
        metrics["_ad_key"] = sus_cand
    cand_rt = cand.to(kdt).to(torch.int32)
    keys_after = torch.where(onehot, cand_rt[:, None], keys)
    return st, (tgt, cand, rows, eff), metrics, keys_after


def _maintenance_sweep(state: PviewState, params: PviewParams, keys_i32=None, ad=None):
    """Every ``sweep_every`` ticks: suspicion expiry over the tables and
    self records with per-subject announcer election; the tombstone purge
    (P8) every ``purge_sweeps``-th sweep; the active-view promotion.
    ``keys_i32`` is the FD phase's post-verdict key plane when it ran;
    ``ad`` scales the static timeout (P2) by the subject's confirmations
    and the observer's local health."""
    if state.tick % params.sweep_every:
        return state, _no_props(state)
    (has_suspects,) = host_flags((state.sus_since > NEVER).any())
    if has_suspects:
        st, props = _expire(state, params, keys_i32, ad)
    else:
        st, props = state, _no_props(state)
    return _promote(_purge(st, params), params), props


def _expire(st: PviewState, params: PviewParams, keys_i32, ad=None):
    n = st.capacity
    rows = _rows(st)
    k = st.nbr_id.shape[1]
    keys = _keys_i32(st) if keys_i32 is None else keys_i32
    sid = st.nbr_id
    sidc = sid.clamp(min=0).long()
    if ad is not None:
        aspec = params.adaptive
        L = aspec.levels
        base0 = params.log2n * params.fd_every
        num_conf = _adp.conf_mult_num(aspec, ad.conf)  # [N]
        num = torch.where(keys <= ad.conf_key[sidc], num_conf[sidc], aspec.max_mult * L)
        timeout = torch.div(base0 * num * (1 + ad.lh)[:, None], L, rounding_mode="floor")  # [N, k]
        num_s = torch.where(st.self_key <= ad.conf_key, num_conf, aspec.max_mult * L)
        timeout_s = torch.div(base0 * num_s * (1 + ad.lh), L, rounding_mode="floor")  # [N]
    else:
        timeout = timeout_s = params.suspicion_timeout_ticks
    is_sus = (keys & 3) == RANK_SUSPECT
    expired = (
        is_sus
        & st.up[:, None]
        & ((st.tick - st.sus_since[sidc]) >= timeout)
        & (keys <= st.sus_key[sidc])
    )
    new_keys = torch.where(expired, keys + 1, keys)
    self_expired = (
        st.up
        & ((st.self_key & 3) == RANK_SUSPECT)
        & ((st.tick - st.sus_since) >= timeout_s)
        & (st.self_key <= st.sus_key)
    )
    new_self = torch.where(self_expired, st.self_key + 1, st.self_key)
    any_suspect_left = (
        ((new_keys & 3) == RANK_SUSPECT) & st.up[:, None] & (sid >= 0)
    ).any() | (((new_self & 3) == RANK_SUSPECT) & st.up).any()
    sus_key = torch.where(any_suspect_left, st.sus_key, NO_CANDIDATE).to(torch.int32)
    sus_since = torch.where(any_suspect_left, st.sus_since, NEVER).to(torch.int32)
    # per-subject announcer election: the lowest expiring observer row
    first_row = scatter_reduce_1d(
        n, torch.where(expired, sid, n).reshape(-1), rows[:, None].expand(n, k).reshape(-1),
        "amin", n, torch.int32,
    )
    mine = expired & (first_row[sidc] == rows[:, None])
    any_exp = mine.any(dim=1)
    col = first_true(mine, 1)[:, None]
    subj = torch.gather(sid, 1, col)[:, 0]
    key = torch.gather(new_keys, 1, col)[:, 0]
    st = st.replace(
        nbr_key=new_keys.to(_kdt(st)), self_key=new_self, sus_key=sus_key, sus_since=sus_since
    )
    return st, (subj.clamp(min=0), key, rows, any_exp)


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
    n = state.capacity
    m = params.mr_pool
    W = recv_m_p.shape[1]
    dev = state.device
    cols = torch.arange(m, device=dev)
    ka = params.active_slots

    # origin-row exclusion: column c's bit lands in row mr_origin[c]; the
    # bits of one (row, word) are distinct, so adding them is OR-ing them
    vo = (state.mr_origin >= 0) & (state.mr_origin < n)
    flat = torch.zeros(((n + 1) * W,), dtype=torch.int32, device=dev)
    flat.index_add_(
        0,
        torch.where(vo, state.mr_origin, n).long() * W + cols // 32,
        torch.ones((m,), dtype=torch.int32, device=dev) << (cols % 32).to(torch.int32),
    )
    excl_p = flat.view(n + 1, W)[:n]
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
    state = _register_sus(st.replace(minf_age=minf), sus_acc)
    if adaptive:
        return state, delivered, accepts, rem0 ^ rem_p, {"_ad_cnt": ad_cnt[:n], "_ad_key": sus_acc}
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

    Returns ``(state, metrics, fwd_post_p)``."""
    n = state.capacity
    m = params.mr_pool
    F = params.fanout
    spread = params.spread_ticks
    W = words_for(m)
    dev = state.device
    rows = _rows(state)

    u_any, mr_any = host_flags(state.rumor_active.any(), state.mr_active.any())
    if not (u_any or mr_any):
        z = torch.zeros((), dtype=torch.int32, device=dev)
        mets = {k: z for k in _GOSSIP_METRICS}
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
        # try of each pick's rejection block
        peers, peer_valid = dz.structured_peers(
            spec, n, state.tick, dz.try_stride_uniforms(r.gossip_try, params.sample_tries)
        )
    yu_p = pack_bits(young_u)

    sender_has = young_u.any(dim=1) | (ym_p != 0).any(dim=1)
    p_all = peers.T.contiguous()  # [F, N]
    rows_b = rows[None, :].expand(F, n)
    ok_all = (
        peer_valid.T
        & sender_has[None, :]
        & state.up[None, :]
        & state.up[p_all]
        & (r.gossip_edge.T < (1.0 - _loss_at(state, rows_b, p_all)))
    )
    sent = _i32(ok_all)
    inv = torch.full((F, n), -1, dtype=torch.int32, device=dev)
    inv.scatter_reduce_(
        1, p_all.long(), torch.where(ok_all, rows_b, -1), "amax", include_self=True
    )
    # the kernel reads the three sender planes in place: no payload copy
    recv_u, recv_src, recv_m_p, rumor_sent = delivery.delivery_combine(
        ym_p, yu_p, state.infected_from, inv, state.rumor_origin.contiguous()
    )
    if spec.wants_pull:
        pulled, rumor_pulled = pull_replies(state, ok_all, p_all, ym_p, yu_p, _loss_at, recv_u, recv_src, recv_m_p)
        sent = sent + pulled
        rumor_sent = rumor_sent + rumor_pulled

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
    mets = {
        "gossip_msgs": sent,
        "rumor_sends": rumor_sent,
        "rumor_deliveries": _i32(newly_u),
        "mr_deliveries": n_mr_deliveries,
        "mr_accepts": n_mr_accepts,
        **ev,
    }
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


def _sync_phase(state: PviewState, r: SparseRoundRandoms, params: PviewParams, adaptive: bool = False):
    """Anti-entropy + shuffle: each due caller (forced first, then periodic,
    compacted to K) exchanges its table and self record with one peer drawn
    from ``active slots ∪ seeds`` (every ``seed_sync_every``-th periodic
    round deterministically to a seed); both directions merge the other's
    PRE-exchange entries (P4); several callers on one peer collapse to the
    highest slot (P6). ``adaptive`` adds both directions' confirmation
    evidence."""
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
    ok = valid_c & valid_pick & state.up[peer] & (r.sync_edge[caller] < _rt_at(state, caller, peer))

    pre_id = state.nbr_id
    pre_key = _keys_i32(state)
    pre_self = state.self_key

    # REQ direction: the highest-slot caller wins each peer (P6)
    inv_slot = scatter_reduce_1d(n, peer, torch.where(ok, karange, -1), "amax", -1, torch.int32)
    req_src = torch.where(inv_slot >= 0, caller[inv_slot.clamp(min=0)], -1)
    st, _req_acc, req_subj, req_key, *req_ev = _merge_entries_compact(
        state, req_src, pre_id, pre_key, pre_self, SALT_SYNC_REQ, params, K, adaptive
    )
    # ACK direction: distinct callers each merge their peer's pre-entries
    ack_src = scatter_reduce_1d(n, caller, torch.where(ok, peer, -1), "amax", -1, torch.int32)
    st, _ack_acc, ack_subj, ack_key, *ack_ev = _merge_entries_compact(
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
    return st, props, metrics


def _refute_phase(state: PviewState, params: PviewParams):
    """Self-record refutation (bump through :func:`.lattice.bump_inc`)."""
    n = state.capacity
    rows = _rows(state)
    kdt = _kdt(state)
    diag = state.self_key
    rank = diag & 3
    need = state.up & (
        (rank == RANK_SUSPECT) | (rank == RANK_DEAD) | (state.leaving & (rank != RANK_LEAVING))
    )
    V = min(n, params.refute_slots or max(64, n // 16))
    eff = need & (torch.cumsum(need, 0) - 1 < V)
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
    forwarding_u = (
        state.infected
        & state.up[:, None]
        & ((state.tick - state.infected_at) < params.spread_ticks)
    ).any(dim=0)
    state = state.replace(rumor_active=state.rumor_active & (keep_u | forwarding_u))

    (mr_any,) = host_flags(state.mr_active.any())
    if not mr_any:
        return state
    fwd_words = or_rows(torch.where(state.up[:, None], fwd_post_p, 0))
    forwarding_m = unpack_bits(fwd_words[None, :], m)[0]
    keep_m = ((state.tick - state.mr_created) <= sweep) | forwarding_m
    if params.early_free:
        keep_m = keep_m & ~covered_columns(state)
    keep_m = keep_m & state.mr_active
    freed = state.mr_active & ~keep_m
    return state.replace(
        mr_active=keep_m,
        mr_subject=torch.where(freed, -1, state.mr_subject),
        minf_age=state.minf_age.masked_fill(freed[None, :], 0),
    )


def state_metrics(state: PviewState, params: PviewParams) -> dict:
    """State-derived health metrics over the table edges."""
    dev = state.device
    metrics = rumor_metrics(state, params, _i32(state.up))
    if params.full_metrics:
        keys = _keys_i32(state)
        sid = state.nbr_id
        rank = keys & 3
        edges = (sid >= 0) & state.up[:, None] & state.up[sid.clamp(min=0)]
        n_edges = edges.sum().clamp(min=1).to(torch.float32)
        metrics["alive_view_fraction"] = (edges & (rank == RANK_ALIVE)).sum().to(torch.float32) / n_edges
        metrics["false_suspect_pairs"] = _i32(edges & (rank == RANK_SUSPECT))
    else:
        metrics["alive_view_fraction"] = torch.zeros((), dtype=torch.float32, device=dev)
        metrics["false_suspect_pairs"] = torch.zeros((), dtype=torch.int32, device=dev)
    return metrics


# ---------------------------------------------------------------------------
# tick + window
# ---------------------------------------------------------------------------


_FD_METRICS = ("fd_probes", "fd_failed_probes", "fd_new_suspects")


def pview_tick_fused(state: PviewState, fd_r, round_r: SparseRoundRandoms, params: PviewParams,
                     ad=None):
    """One gossip period for all N members (the JAX ``pview_tick_fused``):
    FD → maintenance sweep → gossip → SYNC → refute → rumor sweeps → pool
    allocation → metrics. ``fd_r`` is read only on FD ticks
    (``tick % fd_every == 0`` after the increment) and may be None
    otherwise. Returns ``(state, metrics)``, or with ``ad`` (the adaptive
    plane, as in the dense ``tick``) ``(state, ad', metrics)``."""
    armed = ad is not None
    if armed and params.adaptive.is_default:
        raise ValueError("adaptive tick needs an enabled AdaptiveSpec on params")
    state = state.replace(tick=state.tick + 1)
    n = state.capacity
    if state.tick % params.fd_every == 0:
        if fd_r is None:
            raise ValueError(f"tick {state.tick} runs the FD round and needs FD draws")
        state, props_fd, fd_m, keys_h = _fd_phase(state, fd_r, params, ad=ad)
    else:
        z = torch.zeros((), dtype=torch.int32, device=state.device)
        props_fd, fd_m, keys_h = _no_props(state), {k: z for k in _FD_METRICS}, None
        if armed:
            fd_m.update(_no_evidence(n, state.device, probes=True))
    state, props_exp = _maintenance_sweep(state, params, keys_h, ad=ad)
    state, g_m, fwd_post_p = _gossip_phase_fused(state, round_r, params, adaptive=armed)
    state, props_sync, s_m = _sync_phase(state, round_r, params, adaptive=armed)
    state, props_ref = _refute_phase(state, params)
    state = _rumor_sweeps_fused(state, params, fwd_post_p)
    state, a_m = alloc_phase(state, (props_fd, props_exp, props_ref, props_sync), params)
    if armed:
        ad = _fold_evidence(params, ad, fd_m, g_m, s_m, props_ref[3], state.up)
    metrics = {**fd_m, **g_m, **s_m, **a_m, **state_metrics(state, params)}
    if armed:
        metrics["adaptive_lh_high"] = ad.lh.max()
        metrics["adaptive_conf_high"] = ad.conf.max()
        return state, ad, metrics
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
               trace=None, ad=None):
    """One gossip period (the JAX ``pview_tick``): the fused tick, whose
    state and metrics are the unfused tick's. ``trace`` is refused until
    the trace plane is ported. Returns ``(state, metrics)``, or ``(state,
    ad', metrics)`` with ``ad``."""
    if trace is not None:
        raise NotImplementedError("trace capture on the pview tick is not ported yet (ROADMAP A10)")
    return pview_tick_fused(state, fd_r, round_r, params, ad=ad)


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


def sentinel_reduce(state: PviewState, sent: dict, spec: dict) -> dict:
    """Pview chaos-sentinel check over the [N, k] tables and self records
    (the table-edge twin of :func:`.kernel.sentinel_core`): self-key
    regressions; never-faulted (and watched degraded) up subjects some up
    observer tables DEAD; a crashed row is detected once no up observer
    tables it non-DEAD; convergence once no up observer tables an up
    subject non-ALIVE; the view invariant (no duplicate subject and no
    self entry in a row's table), counted per check. Tensor reductions, no
    transfer."""
    n = state.capacity
    dev = state.device
    keys = _keys_i32(state)
    sid = state.nbr_id
    sidc = sid.clamp(min=0).long()
    valid = sid >= 0
    rank = keys & 3
    rel = state.tick - spec["t0"]

    sent = dict(sent)
    sent["key_regressions"] = sent["key_regressions"] + (state.self_key < sent["prev_diag"]).sum(dtype=torch.int32)
    sent["prev_diag"] = state.self_key.clone()

    def subjects_of(edge) -> torch.Tensor:
        """[N] bool: the subjects of the ``edge`` [N, k] table entries."""
        return scatter_reduce_1d(n, torch.where(edge, sid, n).reshape(-1), edge.reshape(-1), "amax", 0,
                                 torch.int32) > 0

    tomb = valid & state.up[:, None] & (rank == RANK_DEAD)
    nf_up = spec["never_faulted"] & state.up
    sent["false_dead_max"] = torch.maximum(
        sent["false_dead_max"], subjects_of(tomb & nf_up[sidc]).sum(dtype=torch.int32)
    )
    if "fp_watch" in spec:
        fp_up = spec["fp_watch"] & state.up
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
        converged = ~(valid & state.up[:, None] & state.up[sidc] & (rank != RANK_ALIVE)).any()
        active = (rel >= spec["conv_from"]) & (sent["conv_tick"] < 0)
        sent["conv_tick"] = torch.where(active & converged, rel, sent["conv_tick"]).to(torch.int32)

    k = sid.shape[1]
    off_diag = ~torch.eye(k, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    breaks = torch.zeros((), dtype=torch.int32, device=dev)
    for lo, hi in row_chunks(n):
        s, v = sid[lo:hi], valid[lo:hi]
        dup = (v[:, :, None] & v[:, None, :] & (s[:, :, None] == s[:, None, :]) & off_diag[None]).any(dim=(1, 2))
        self_entry = (v & (s == rows[lo:hi, None])).any(dim=1)
        breaks += (dup | self_entry).sum(dtype=torch.int32)
    sent["view_invariant_breaks"] = sent["view_invariant_breaks"] + breaks
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
