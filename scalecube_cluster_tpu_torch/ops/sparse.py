"""The sparse ("record-queue") SWIM engine in PyTorch: one [N, N] view plane,
membership changes spread as rumors through a bounded pool. A port of the
JAX package's ``ops/sparse.py`` — its fused tick (``sparse_tick(...,
fused=True)``), the window runner, and the host seams the driver calls —
held against it bit for bit (``tests/test_torch_sparse*.py``). The JAX
module's docstring carries the protocol account and deviations 1-6; this
file keeps its function names so each counterpart is easy to find.

The JAX package has two spellings of the tick: the unfused one (the
driver's window, ``make_sparse_run``) and the fused one
(``make_sparse_fused_run``), which hands the gossip phase's pool coverage to
the rumor sweep and shares one up-count, with the same trajectory. The
port has one: ``sparse_tick``, ``run_sparse_ticks`` and ``make_sparse_run``
run the fused tick, and the ``*_fused`` names are aliases.

What differs from the JAX spelling, and why:

* The [N, N] ``view_key`` plane is updated IN PLACE by the tick and by the
  host mutators: a state handed to either is consumed, as the JAX driver's
  donated windows and mutators consume theirs. A second copy of the plane
  is 9.66 GB at 49,152 members.
* Passes over the view plane (the suspicion sweep, ``full_metrics``, the
  driver's remembered-rows and staleness seams, which live in
  :mod:`.engine_api` for dense and sparse alike) run over row chunks of at
  most :data:`._tensor.PLANE_CHUNK_CELLS` cells, counting in int32: a whole
  [N, N] temporary, or a bool sum widened to int64, would not fit beside
  the plane at that size. The sweep's announcer election (the lowest
  expiring row of each subject) carries the subjects already claimed from
  chunk to chunk.
* Point writes (the FD verdicts, the refuted diagonal) are point writes:
  the JAX one-hot elementwise passes exist only to keep a TPU layout.
* The membership apply runs in slot space — each (observer, active pool
  slot) cell at column ``mr_subject`` — in row chunks, instead of the JAX
  transposed bitmap and column blocks, which exist only to dodge an XLA
  relayout. The per-cell expressions are the JAX ones; the pool invariant
  (active slots carry unique subjects) makes each slot's cells distinct.
  ``apply_block`` is checked as the JAX window checks it, and otherwise
  unused.
* ``tick`` is a host int, so tick-keyed branches cost nothing; branches
  keyed on data read one flag to the host each
  (:data:`._tensor.HOST_SYNCS`): the gossip phase's work/pool gate (which
  the rumor sweep reuses), the sweep's has-suspects gate, the pool
  allocation's valid/eviction gates, the membership segmentation metric's
  gate on sweep ticks. Writes the JAX tick guards with a data-keyed
  ``lax.cond`` (the FD verdicts, the refutations) run unconditionally:
  they are no-ops when nothing is written.
* Uniform draws are an input of the tick (:mod:`.rand`); duplicate-index
  scatters are ``scatter_reduce_`` amax elections or integer
  ``index_add_``; fixed-size ``nonzero`` is a cumsum compaction.

The adaptive plane (``sparse_tick(ad=...)``,
:func:`make_sparse_adaptive_run`) threads an
:class:`..adaptive.AdaptiveState` through the window, as on the dense
engine; :func:`sentinel_reduce` is the chaos sentinels' check.

Not ported yet, and refused: ``delay_slots > 0`` and ``uniform_delay > 0``
(the pending rings, ROADMAP A2; with them the adaptive direct-probe
stretch), trace capture and telemetry (A10, second half), meshes (A12).
The fleet windows (``make_sparse_fleet_run``, its fused name,
``make_sparse_fleet_adaptive_run``) run the fused tick under
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
from ._tensor import first_true, host_flags, nonzero_fixed, plane_chunks, put_drop_, row_chunks, scatter_, scatter_reduce_1d
from ._tick import announce, covered_columns, crash_row, crash_rows, rumor_metrics, run_window, spread_rumor  # noqa: F401
from ._tick import count_i32 as _i32
from ._tick import no_props as _no_props
from ._tick import pull_replies
from ._tick import register_sus as _register_sus
from ._tick import row_index as _row_index
from ._tick import rows_of as _rows
from ._tick import seed_rows_tensor as _seed_rows_tensor
from ._tick import set_at as _set
from .bitplane import pack_bits, unpack_bits, words_for
from .engine_api import plane_view_rows as view_rows
from .kernel import _fold_evidence, _no_evidence, ceil_log2, sentinel_core
from .lattice import ALIVE, RANK_ALIVE, RANK_DEAD, RANK_LEAVING, RANK_SUSPECT, UNKNOWN_KEY, precedence_key
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
from .state import ALIVE0_KEY, NEVER, NO_CANDIDATE_I32, _loss_scalar, build_namespace_tables, delay_mean_to_q

NO_CANDIDATE = NO_CANDIDATE_I32


@dataclasses.dataclass(frozen=True)
class SparseParams:
    """Static parameters of the sparse tick — the JAX package's
    ``SparseParams``; ``dissem`` is the dissemination strategy/topology
    (:mod:`..dissemination`), ``adaptive`` the adaptive failure-detection
    spec (:mod:`..adaptive`). ``mr_slots`` (M) sizes
    the membership-rumor pool, ``announce_slots`` (E) the new rumors per
    tick, ``sample_tries`` (T) the rejection draws per pick,
    ``sweep_every`` (B) the suspicion expiry period, ``sync_announce`` (P)
    the re-gossip cap per SYNC participant."""

    capacity: int
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
    mr_slots: int = 1024
    announce_slots: int = 256
    sync_slots: int = 0
    sync_announce: int = 2
    fd_accept_slots: int = 0
    refute_slots: int = 0
    delay_slots: int = 0
    apply_block: int = 0
    fd_direct_timeout_ticks: int = 2
    fd_leg_timeout_ticks: int = 1
    sync_timeout_ticks: int = 15
    seed_rows: tuple = ()
    early_free: bool = True
    full_metrics: bool = False
    namespace_gate: bool = False
    dissem: DissemSpec = DissemSpec()
    adaptive: AdaptiveSpec = AdaptiveSpec()

    @staticmethod
    def from_config(config, capacity: int | None = None, initial_size: int | None = None,
                    seed_rows: tuple = (0,), mr_slots: int | None = None) -> "SparseParams":
        """Sparse params from a ``ClusterConfig``: the shared tick mapping
        (:func:`..config.tick_units`) plus the pool, ``capacity // 16``
        slots (256 at least) unless ``mr_slots`` is given."""
        from ..config import tick_units

        units = tick_units(config, capacity, initial_size, seed_rows)
        return SparseParams(mr_slots=mr_slots or max(256, units["capacity"] // 16),
                            dissem=DissemSpec.from_config(config),
                            adaptive=AdaptiveSpec.from_config(config), **units)

    def __post_init__(self):
        if self.delay_slots:
            raise NotImplementedError(
                "delay_slots > 0 (the pending delivery rings) is not ported yet (ROADMAP A2)"
            )
        # the JAX window's check of an explicit apply block (its column
        # block width); the port's apply does not block by columns
        if self.apply_block and (self.apply_block < 0 or self.capacity % self.apply_block):
            raise ValueError(
                f"block {self.apply_block} must be positive and divide {self.capacity}"
            )


@dataclasses.dataclass
class SparseState:
    """Sparse simulation state: the JAX ``SparseState``'s leaves as tensors
    on one device (same names and dtypes), with ``tick`` a host int.

    ``view_key[i, j]`` is node i's record of j as the packed precedence key
    (-1 unknown), the one [N, N] plane; ``n_live[i]`` counts row i's
    non-DEAD columns; ``sus_key``/``sus_since`` are the per-subject
    suspicion episodes; ``mr_*``/``minf_age`` the membership-rumor pool;
    ``rumor_*``/``infected*`` the user-rumor pool; ``loss``/``fetch_rt``/
    ``delay_q`` are scalars or [N, N] planes (``dense_links``)."""

    tick: int
    up: torch.Tensor  # bool [N]
    epoch: torch.Tensor  # i32 [N]
    joined_at: torch.Tensor  # i32 [N]
    view_key: torch.Tensor  # i32 [N, N]
    n_live: torch.Tensor  # i32 [N]
    sus_key: torch.Tensor  # i32 [N]
    sus_since: torch.Tensor  # i32 [N]
    force_sync: torch.Tensor  # bool [N]
    leaving: torch.Tensor  # bool [N]
    ns_id: torch.Tensor  # i32 [N]
    ns_rel: torch.Tensor  # bool [G, G]
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
    loss: torch.Tensor  # f32 scalar or [N, N]
    fetch_rt: torch.Tensor  # f32 scalar or [N, N]
    delay_q: torch.Tensor  # f32 scalar or [N, N]
    pending_minf: torch.Tensor  # bool [D, N, M]
    pending_inf: torch.Tensor  # bool [D, N, R]
    pending_src: torch.Tensor  # i32 [D, N, R]

    @property
    def capacity(self) -> int:
        return self.up.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.up.device

    def replace(self, **changes) -> "SparseState":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# construction + host mutators
# ---------------------------------------------------------------------------


def _roundtrip(loss: torch.Tensor) -> torch.Tensor:
    if loss.dim() < 2:
        return (1.0 - loss) * (1.0 - loss)
    return (1.0 - loss) * (1.0 - loss.transpose(-1, -2))


def init_sparse_state(
    params: SparseParams,
    n_initial: int,
    warm: bool = True,
    dense_links: bool = False,
    uniform_loss: float = 0.0,
    uniform_delay: float = 0.0,
    namespaces=None,
    device="cuda",
) -> SparseState:
    """Fresh sparse-mode simulation on ``device``; rows ``0..n_initial-1``
    up. A warm start has every up row know every up row ALIVE (within its
    namespace hierarchy when ``namespaces`` is given); a cold one knows
    only itself. ``dense_links`` keeps per-link loss/delay as [N, N]
    planes (emulator runs at moderate N) instead of one scalar each."""
    if uniform_delay > 0:
        raise NotImplementedError(
            "uniform_delay > 0 needs the pending delivery rings (delay_slots > 0), "
            "not ported yet (ROADMAP A2)"
        )
    n, m, r = params.capacity, params.mr_slots, params.rumor_slots
    i32 = torch.int32
    up = torch.arange(n, device=device) < n_initial
    view_key = torch.full((n, n), UNKNOWN_KEY, dtype=i32, device=device)
    if namespaces is not None:
        ids_np, rel_np = build_namespace_tables(list(namespaces))
        ns_id = torch.as_tensor(ids_np, device=device)
        ns_rel = torch.as_tensor(rel_np, device=device)
    else:
        ns_id = torch.zeros((n,), dtype=i32, device=device)
        ns_rel = torch.ones((1, 1), dtype=torch.bool, device=device)
    if warm and namespaces is not None:
        n_live = torch.zeros((n,), dtype=i32, device=device)
        cols = torch.arange(n, device=device)
        for lo, hi in plane_chunks(n, n):
            related = ns_rel[ns_id[lo:hi, None].long(), ns_id[None, :].long()] | (
                cols[lo:hi, None] == cols[None, :]
            )
            known = up[lo:hi, None] & up[None, :] & related
            view_key[lo:hi].masked_fill_(known, ALIVE0_KEY)
            n_live[lo:hi] = known.sum(dim=1, dtype=i32)
    elif warm:
        view_key[:n_initial, :n_initial] = ALIVE0_KEY
        n_live = torch.where(up, n_initial, 0).to(i32)
    else:
        diag = torch.arange(n_initial, device=device)
        view_key[diag, diag] = ALIVE0_KEY
        n_live = up.to(i32)
    f32 = torch.float32
    q = float(np.float32(delay_mean_to_q(uniform_delay)))
    if dense_links:
        loss = torch.full((n, n), float(np.float32(uniform_loss)), dtype=f32, device=device)
        delay_q = torch.full((n, n), q, dtype=f32, device=device)
    else:
        loss = torch.tensor(np.float32(uniform_loss), dtype=f32, device=device)
        delay_q = torch.tensor(q, dtype=f32, device=device)
    return SparseState(
        tick=0,
        up=up,
        epoch=torch.zeros((n,), dtype=i32, device=device),
        joined_at=torch.zeros((n,), dtype=i32, device=device),
        view_key=view_key,
        n_live=n_live,
        sus_key=torch.full((n,), NO_CANDIDATE, dtype=i32, device=device),
        sus_since=torch.full((n,), NEVER, dtype=i32, device=device),
        force_sync=torch.zeros((n,), dtype=torch.bool, device=device),
        leaving=torch.zeros((n,), dtype=torch.bool, device=device),
        ns_id=ns_id,
        ns_rel=ns_rel,
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
        loss=loss,
        fetch_rt=_roundtrip(loss),
        delay_q=delay_q,
        pending_minf=torch.zeros((0, n, m), dtype=torch.bool, device=device),
        pending_inf=torch.zeros((0, n, r), dtype=torch.bool, device=device),
        pending_src=torch.full((0, n, r), -1, dtype=i32, device=device),
    )


def join_rows(state: SparseState, rows, seed_rows) -> SparseState:
    """Vectorized churn-burst join of the distinct ``rows``: each knows
    itself and the seeds (at their post-burst epochs); a reused row is a
    new identity through the epoch bits. Consumes ``state``."""
    dev = state.device
    n = state.capacity
    rows = _row_index(rows, dev)
    k = rows.shape[0]
    seeds = _seed_rows_tensor(tuple(int(s) for s in seed_rows), dev).long()
    was_used = state.view_key[rows, rows] >= 0
    new_epoch = torch.where(was_used, (state.epoch[rows] + 1) & 0xFF, state.epoch[rows])
    self_keys = precedence_key(
        torch.full((k,), ALIVE, device=dev), torch.zeros((k,), device=dev), new_epoch
    )
    epoch_after = _set(state.epoch, rows, new_epoch)
    seed_keys = precedence_key(
        torch.full(seeds.shape, ALIVE, device=dev), torch.zeros(seeds.shape, device=dev),
        epoch_after[seeds],
    )
    row_key = torch.full((k, n), UNKNOWN_KEY, dtype=torch.int32, device=dev)
    row_key[:, seeds] = seed_keys[None, :]
    row_key[torch.arange(k, device=dev), rows] = self_keys
    n_live_rows = ((row_key & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
    state.view_key[rows] = row_key
    state = state.replace(
        up=_set(state.up, rows, True),
        epoch=epoch_after,
        joined_at=_set(state.joined_at, rows, state.tick),
        n_live=_set(state.n_live, rows, n_live_rows),
        force_sync=_set(state.force_sync, rows, True),
        leaving=_set(state.leaving, rows, False),
        minf_age=_set(state.minf_age, rows, 0),
        infected=_set(state.infected, rows, False),
        infected_from=_set(state.infected_from, rows, -1),
    )
    # self-announces: a full pool EVICTS the most-covered rumor rather than
    # dropping a joiner's identity (priority eviction, deviation 3)
    ones = torch.ones((k,), dtype=torch.bool, device=dev)
    r32 = rows.to(torch.int32)
    state, _a, _d, _e = allocate(state, r32, self_keys, r32, ones, prio=ones)
    return state


def join_row(state: SparseState, row: int, seed_rows) -> SparseState:
    """Activate ``row`` as a fresh member knowing itself and the seeds, and
    self-announce it (:func:`join_rows` of one row). Consumes ``state``."""
    return join_rows(state, [row], seed_rows)


def begin_leave(state: SparseState, row: int) -> SparseState:
    """Graceful leave: LEAVING self-record (written in place) and its
    announcement rumor. Consumes ``state``."""
    vk = state.view_key
    vk[row, row] = ((vk[row, row] >> 2) << 2) | RANK_LEAVING
    state = state.replace(leaving=_set(state.leaving, row, True))
    return announce(state, row, vk[row, row].clone(), row)


def update_metadata(state: SparseState, row: int) -> SparseState:
    """Metadata update = own-incarnation bump (in place) re-announced ALIVE.
    Consumes ``state``."""
    vk = state.view_key
    vk[row, row] += 4
    return announce(state, row, vk[row, row].clone(), row)


def set_link_loss(state: SparseState, src, dst, loss: float) -> SparseState:
    """Loss on every link src -> dst (dense links only); the round-trip
    planes of both directions follow."""
    if state.loss.dim() == 0:
        raise ValueError("per-link loss needs dense links; init_sparse_state(dense_links=True)")
    src = _row_index(src, state.device)
    dst = _row_index(dst, state.device)
    new_loss = _set(state.loss, (src[:, None], dst[None, :]), float(np.float32(loss)))
    g = new_loss[dst[:, None], src[None, :]]
    fwd = (1.0 - torch.tensor(np.float32(loss), device=state.device)) * (1.0 - g)
    new_rt = _set(state.fetch_rt, (src[:, None], dst[None, :]), fwd.T)
    new_rt[dst[:, None], src[None, :]] = fwd
    return state.replace(loss=new_loss, fetch_rt=new_rt)


def set_link_delay(state: SparseState, src, dst, mean_delay_ticks: float) -> SparseState:
    """Per-link delay (dense links only). A positive delay needs the
    pending delivery rings, which are not ported: it raises, as the JAX
    engine does without ``delay_slots``."""
    if state.delay_q.dim() == 0:
        raise ValueError("per-link delay needs dense links; init_sparse_state(dense_links=True)")
    if mean_delay_ticks > 0:
        raise ValueError(
            "link delay requires params.delay_slots > 0 (the pending delivery rings, ROADMAP A2)"
        )
    src = _row_index(src, state.device)
    dst = _row_index(dst, state.device)
    q = float(np.float32(delay_mean_to_q(mean_delay_ticks)))
    return state.replace(delay_q=_set(state.delay_q, (src[:, None], dst[None, :]), q))


def block_partition(state: SparseState, group_a, group_b) -> SparseState:
    s = set_link_loss(state, group_a, group_b, 1.0)
    return set_link_loss(s, group_b, group_a, 1.0)


def heal_partition(state: SparseState, group_a, group_b) -> SparseState:
    s = set_link_loss(state, group_a, group_b, 0.0)
    return set_link_loss(s, group_b, group_a, 0.0)


def set_uniform_loss(state: SparseState, loss, floor: bool = False) -> SparseState:
    """Uniform loss on every link; with ``floor`` existing losses only
    rise (partition blocks survive a storm). ``fetch_rt`` follows. ``loss``
    may be a 0-d tensor, which is not read to the host."""
    new = _loss_scalar(loss, state.device)
    if floor:
        new_loss = torch.maximum(state.loss, new)
    else:
        new_loss = new.expand(state.loss.shape).clone()
    return state.replace(loss=new_loss, fetch_rt=_roundtrip(new_loss))


def snapshot(state: SparseState) -> dict:
    """Every state leaf as a numpy array (``tick`` a 0-d int32), keyed by
    name: the checkpoint layout of the JAX package's ``snapshot``."""
    from .. import convert

    return convert.state_to_numpy(state)


def restore(arrays: dict, device="cuda") -> SparseState:
    """The inverse of :func:`snapshot`, onto ``device``; the leaves are
    copied, never aliased to the caller's buffers. A set of names that is
    not exactly the state's raises ``TypeError``."""
    from .. import convert

    names = {f.name for f in dataclasses.fields(SparseState)}
    if set(arrays) != names:
        raise TypeError(
            f"state planes do not match SparseState: missing {sorted(names - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - names)}"
        )
    return convert.state_from_numpy(arrays, device=device)


# ---------------------------------------------------------------------------
# in-tick helpers
# ---------------------------------------------------------------------------


def _loss_at(state: SparseState, i, j) -> torch.Tensor:
    """Link loss i -> j; the scalar broadcasts."""
    return state.loss if state.loss.dim() == 0 else state.loss[i, j]


def _rt_at(state: SparseState, i, j) -> torch.Tensor:
    """Round-trip delivery probability i <-> j; the scalar broadcasts."""
    return state.fetch_rt if state.fetch_rt.dim() == 0 else state.fetch_rt[i, j]


def _fetch_gate(state: SparseState, salt: int, i, j, cand_key, p_fetch) -> torch.Tensor:
    """ALIVE-rank candidates gated on the metadata-fetch round trip (the
    same stateless hash draw as the other engines)."""
    needs = (cand_key & 3) == RANK_ALIVE
    u = fetch_uniform(state.tick, salt, i, j)
    ok = state.up[j] & (u < p_fetch)
    return ~needs | ok


def _sample_rejection(state: SparseState, rows, u, n_picks: int, tries: int, extra_mask=None):
    """Per-row ``n_picks`` distinct draws from the live view by bounded
    rejection: each pick takes the first of ``tries`` uniform column draws
    that is not self, not DEAD/unknown in the row's view, or allowed by
    ``extra_mask``, and differs from the earlier picks (deviation 4).

    Returns (idx [R, n_picks] clamped, valid [R, n_picks])."""
    n = state.capacity
    cols = (u * float(n)).to(torch.int32).clamp(max=n - 1)  # [R, P*T]
    live = (state.view_key[rows[:, None].long(), cols.long()] & 3) != RANK_DEAD
    if extra_mask is not None:
        live = live | extra_mask[cols]
    ok_base = (cols != rows[:, None]) & live
    picks = []
    for p in range(n_picks):
        sel = torch.full(rows.shape, -1, dtype=torch.int32, device=u.device)
        for t in range(tries):
            c = cols[:, p * tries + t]
            ok = ok_base[:, p * tries + t]
            for q in picks:
                ok = ok & (c != q)  # q == -1 never collides
            sel = torch.where((sel < 0) & ok, c, sel)
        picks.append(sel)
    idx = torch.stack(picks, 1)
    return idx.clamp(min=0), idx >= 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _fd_phase(state: SparseState, r: SparseFdRandoms, params: SparseParams, ad=None):
    """FD round with rejection-sampled target and relays: direct probe,
    indirect probes, the verdict written for the first V accepting rows
    (the rest retry next round), the suspicion-episode registration.
    With ``ad`` the metrics carry the adaptive evidence: the probe outcomes
    unthrottled, the WRITTEN suspect verdicts as confirmations. Returns
    (state, proposals, metrics)."""
    n = state.capacity
    rows = _rows(state)
    vk = state.view_key
    sel, valid = _sample_rejection(state, rows, r.fd_try, 1 + params.ping_req_k, params.sample_tries)
    tgt = sel[:, 0]
    has_tgt = valid[:, 0] & state.up
    direct_ok = has_tgt & state.up[tgt] & (r.fd_direct < _rt_at(state, rows, tgt))

    relays = sel[:, 1:]
    relay_valid = valid[:, 1:]
    tgt_b = tgt[:, None]
    p_relay = _rt_at(state, rows[:, None], relays) * _rt_at(state, relays, tgt_b)
    relay_ok = relay_valid & state.up[relays] & state.up[tgt_b] & (r.fd_relay < p_relay)
    ack = direct_ok | relay_ok.any(dim=1)

    own_key = vk[rows.long(), tgt.long()]
    alive_key = (vk[tgt.long(), tgt.long()] >> 2) << 2
    suspect_key = ((own_key >> 2) << 2) | RANK_SUSPECT
    cand = torch.where(ack, alive_key, suspect_key)
    accept = has_tgt & (cand > own_key)
    V = min(n, params.fd_accept_slots or max(64, n // 16))
    eff = accept & (torch.cumsum(accept, 0) - 1 < V)
    # each row writes at most its own cell (i, tgt[i]): distinct targets
    put_drop_(vk, (rows, tgt), cand, eff)
    sus_cand = scatter_reduce_1d(
        n, tgt, torch.where(eff & ~ack, cand, NO_CANDIDATE), "amax", NO_CANDIDATE, torch.int32
    )
    st = _register_sus(state, sus_cand)
    # verdicts flip between non-DEAD ranks only: n_live is unchanged
    metrics = {
        "fd_probes": _i32(has_tgt),
        "fd_failed_probes": _i32(has_tgt & ~ack),
        "fd_new_suspects": _i32(eff & ~ack),
    }
    if ad is not None:
        sus_w = eff & ~ack
        metrics["_ad_miss"] = has_tgt & ~ack
        metrics["_ad_succ"] = has_tgt & ack
        metrics["_ad_cnt"] = torch.zeros((n,), dtype=torch.int32, device=state.device).index_add_(
            0, tgt.long(), sus_w.to(torch.int32)
        )
        metrics["_ad_key"] = sus_cand
    return st, (tgt, cand, rows, eff), metrics


def _suspicion_sweep(state: SparseState, params: SparseParams, ad=None):
    """Every ``sweep_every`` ticks, while an episode is registered: SUSPECT
    cells whose subject's episode stamp is older than the observer's
    suspicion timeout become DEAD at the same incarnation (rank + 1), in
    place over row chunks. Each expiring subject is proposed once, by its
    lowest expiring row (deviation 3); when no up observer holds a
    SUSPECT cell afterwards, every episode is over. With ``ad`` the timeout
    is the dense engine's confirmation- and health-scaled one. Returns
    (state, proposals)."""
    if state.tick % params.sweep_every:
        return state, _no_props(state)
    (has_suspects,) = host_flags((state.sus_since > NEVER).any())
    if not has_suspects:
        return state, _no_props(state)
    n = state.capacity
    dev = state.device
    rows = _rows(state)
    vk = state.view_key
    if ad is not None:
        aspec = params.adaptive
        L = aspec.levels
        base = ceil_log2(state.n_live) * params.fd_every  # [N]
        num_conf = _adp.conf_mult_num(aspec, ad.conf)  # [N]
        factor = base * (1 + ad.lh)  # [N]: observer scaling (AD-3)
    else:
        timeout = params.suspicion_mult * ceil_log2(state.n_live) * params.fd_every  # [N]
    waited = state.tick - state.sus_since  # [N] per subject
    expired_cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    left = torch.zeros((), dtype=torch.bool, device=dev)
    claimed = torch.zeros((n,), dtype=torch.bool, device=dev)  # subjects with an announcer
    col = torch.zeros((n,), dtype=torch.int64, device=dev)
    any_exp = torch.zeros((n,), dtype=torch.bool, device=dev)
    key = torch.zeros((n,), dtype=torch.int32, device=dev)
    for lo, hi in plane_chunks(n, n):
        blk = vk[lo:hi]
        if ad is not None:
            num = torch.where(blk <= ad.conf_key[None, :], num_conf[None, :], aspec.max_mult * L)
            overdue = waited[None, :] >= torch.div(factor[lo:hi, None] * num, L, rounding_mode="floor")
            del num
        else:
            overdue = waited[None, :] >= timeout[lo:hi, None]
        expired = (
            ((blk & 3) == RANK_SUSPECT)
            & state.up[lo:hi, None]
            & overdue
            & (blk <= state.sus_key[None, :])
        )
        blk += expired  # in place: SUSPECT rank 2 -> DEAD rank 3
        expired_cnt[lo:hi] = expired.sum(dim=1, dtype=torch.int32)
        left |= (((blk & 3) == RANK_SUSPECT) & state.up[lo:hi, None]).any()
        # the lowest expiring row of each subject not claimed by an
        # earlier chunk announces it
        first = first_true(expired, 0) + lo
        mine = expired & (first[None, :] == rows[lo:hi, None]) & ~claimed[None, :]
        claimed |= expired.any(dim=0)
        c = first_true(mine, 1)
        col[lo:hi] = c
        any_exp[lo:hi] = mine.any(dim=1)
        key[lo:hi] = blk.gather(1, c[:, None])[:, 0]
    state = state.replace(
        n_live=state.n_live - expired_cnt,
        sus_key=torch.where(left, state.sus_key, NO_CANDIDATE).to(torch.int32),
        sus_since=torch.where(left, state.sus_since, NEVER).to(torch.int32),
    )
    return state, (col.to(torch.int32), key, rows, any_exp)


def _mr_apply(state: SparseState, recv_m_p, params: SparseParams, adaptive: bool = False):
    """Membership-rumor infection and one-shot record application: each
    receiver newly infected with an active slot merges its record
    (subject ``mr_subject``, key ``mr_key``) once, in slot space over row
    chunks, gated as every merge is (higher key; unknown subjects admit
    ALIVE/LEAVING only; ALIVE needs the metadata fetch; the namespace gate).
    ``state.minf_age`` must be the plane the gossip phase's aging pass just
    made (it is updated in place). Returns (state, deliveries, accepts),
    and with ``adaptive`` the confirmation evidence (accepted SUSPECT
    records per subject, and their max key)."""
    n = state.capacity
    m = params.mr_slots
    dev = state.device
    rows = _rows(state)
    recv_m = unpack_bits(recv_m_p, m) & (state.mr_origin[None, :] != rows[:, None])
    newly = recv_m & (state.minf_age == 0) & state.up[:, None] & state.mr_active[None, :]
    del recv_m
    minf = state.minf_age.masked_fill_(newly, 1)

    subj = state.mr_subject.clamp(0, n - 1)
    cand = state.mr_key
    rank = cand & 3
    needs_fetch = (rank == RANK_ALIVE)[None, :]
    admit_unknown = (rank <= RANK_LEAVING)[None, :]
    up_subj = state.up[subj][None, :]
    ns_subj = state.ns_id[subj][None, :].long()
    dense_rt = state.fetch_rt.dim() != 0
    vk = state.view_key
    delta = torch.zeros((n,), dtype=torch.int32, device=dev)
    accepts = torch.zeros((), dtype=torch.int32, device=dev)
    acc_slot = torch.zeros((m,), dtype=torch.bool, device=dev)
    acc_per_slot = torch.zeros((m,), dtype=torch.int32, device=dev)
    subj_l = subj.long()
    for lo, hi in plane_chunks(n, m):
        idx = subj_l[None, :].expand(hi - lo, m)
        own = vk[lo:hi].gather(1, idx)
        u = fetch_uniform(state.tick, SALT_GOSSIP, rows[lo:hi, None], subj[None, :])
        p_fetch = state.fetch_rt[lo:hi].gather(1, idx) if dense_rt else state.fetch_rt
        fetch_ok = ~needs_fetch | (up_subj & (u < p_fetch))
        del u
        accept = newly[lo:hi] & (cand[None, :] > own) & ((own >= 0) | admit_unknown) & fetch_ok
        if params.namespace_gate:
            accept &= state.ns_rel[state.ns_id[lo:hi, None].long(), ns_subj]
        # an accepted record is a higher key: the cell's max is the write
        # (inactive slots, whose subjects may repeat, write nothing)
        vk[lo:hi].scatter_reduce_(
            1, idx, torch.where(accept, cand[None, :], NO_CANDIDATE), "amax", include_self=True
        )
        delta[lo:hi] = (accept & (rank != RANK_DEAD)[None, :]).sum(dim=1, dtype=torch.int32) - (
            accept & ((own & 3) != RANK_DEAD)
        ).sum(dim=1, dtype=torch.int32)
        accepts += accept.sum(dtype=torch.int32)
        acc_slot |= accept.any(dim=0)
        if adaptive:
            acc_per_slot += accept.sum(dim=0, dtype=torch.int32)
    # episode registration for accepted SUSPECT records, per subject
    sus_slot = state.mr_active & acc_slot & (rank == RANK_SUSPECT)
    sus_cand = scatter_reduce_1d(
        n, torch.where(sus_slot, subj, n), cand, "amax", NO_CANDIDATE, torch.int32
    )
    state = _register_sus(state.replace(minf_age=minf, n_live=state.n_live + delta), sus_cand)
    if not adaptive:
        return state, newly.sum(dtype=torch.int32), accepts
    # active slots carry distinct subjects; the others accepted nothing
    sus_cnt = torch.where(rank == RANK_SUSPECT, acc_per_slot, 0)
    ad_cnt = torch.zeros((n + 1,), dtype=torch.int32, device=dev).index_add_(
        0, torch.where(state.mr_active, subj_l, n), sus_cnt
    )[:n]
    return state, newly.sum(dtype=torch.int32), accepts, {"_ad_cnt": ad_cnt, "_ad_key": sus_cand}


_GOSSIP_METRICS = ("gossip_msgs", "rumor_sends", "rumor_deliveries", "mr_deliveries", "mr_accepts")


def _gossip_phase_fused(state: SparseState, r: SparseRoundRandoms, params: SparseParams,
                        adaptive: bool = False):
    """Infection-style dissemination of the user rumors ([N, R], full
    known-infected filter) and the membership rumors ([N, M], origin filter
    — deviation 2) in one message per edge: aging and packing of the pool's
    forwarding plane, rejection-sampled peers, the per-fanout-slot
    inverse-sender election, the delivery combine (:mod:`.delivery` — the
    CUDA kernel on the card), the user-rumor infection, and the membership
    apply. Quiescent clusters skip the phase. ``params.dissem`` swaps in
    the strategy's circulant peers, its user-rumor budget and, for
    ``push_pull``, the reply leg (:func:`._tick.pull_replies`).
    ``adaptive`` adds the membership apply's confirmation evidence.

    Returns ``(state, metrics, covered, mr_any)``: the early-free coverage
    of the post-apply pool (the gossip→sweep hand-off) and whether the pool
    held an active slot, which the rumor sweep reads instead of asking the
    device again (nothing in between changes ``mr_active``)."""
    n = state.capacity
    m = params.mr_slots
    F = params.fanout
    dev = state.device
    rows = _rows(state)

    u_any, mr_any = host_flags(state.rumor_active.any(), state.mr_active.any())
    covered = torch.zeros((m,), dtype=torch.bool, device=dev)
    if not (u_any or mr_any):
        z = torch.zeros((), dtype=torch.int32, device=dev)
        mets = {k: z for k in _GOSSIP_METRICS}
        if adaptive:
            mets.update(_no_evidence(n, dev))
        return state, mets, covered, False

    spread = params.repeat_mult * ceil_log2(state.n_live)  # [N]
    young_u = (
        state.infected
        & state.rumor_active[None, :]
        & ((state.tick - state.infected_at) < spread[:, None])
    )
    # the strategy's payload budget (DZ-3; None for every strategy but
    # pipelined) masks the user rumors before sender_has reads them
    spec = params.dissem
    bmask = dz.rumor_budget_mask(spec, young_u.shape[1], state.tick, dev)
    if bmask is not None:
        young_u &= bmask[None, :]
    if mr_any:
        # age = tick - infection_tick + 1 after this increment (saturating
        # at 255), so the forwarding window age <= spread is one uint8
        # compare: age 0 wraps to 255, and spread < 255
        age = state.minf_age.clamp(max=254)
        age += age > 0
        young_m = ((age - 1) < spread.clamp(max=255).to(torch.uint8)[:, None]) & state.mr_active[None, :]
        ym_p = pack_bits(young_m)
        del young_m
        state = state.replace(minf_age=age)
    else:
        ym_p = torch.zeros((n, words_for(m)), dtype=torch.int32, device=dev)

    if spec.uniform_selection:
        peers, peer_valid = _sample_rejection(state, rows, r.gossip_try, F, params.sample_tries)
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
    # receiver-pulled delivery (deviation 6): per slot, the highest-row
    # sender that reached each receiver
    inv = torch.full((F, n), -1, dtype=torch.int32, device=dev)
    inv.scatter_reduce_(1, p_all.long(), torch.where(ok_all, rows_b, -1), "amax", include_self=True)
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
        state, n_mr_deliveries, n_mr_accepts, *rest = _mr_apply(state, recv_m_p, params, adaptive)
        if adaptive:
            ev = rest[0]
        if params.early_free:
            covered = covered_columns(state)
    else:
        n_mr_deliveries = n_mr_accepts = torch.zeros((), dtype=torch.int32, device=dev)
    mets = {
        "gossip_msgs": sent,
        "rumor_sends": rumor_sent,
        "rumor_deliveries": _i32(newly_u),
        "mr_deliveries": n_mr_deliveries,
        "mr_accepts": n_mr_accepts,
        **ev,
    }
    return state, mets, covered, mr_any


def _top_props(acc_mask, cand_vals, owner_rows, owner_valid, P: int):
    """Capped re-gossip: the top-P accepted keys of each participant row,
    largest first (ties to the lowest column)."""
    subs, keys, origs, vals = [], [], [], []
    remaining = torch.where(acc_mask, cand_vals, NO_CANDIDATE)
    for _ in range(P):
        col = torch.argmax(remaining, dim=1, keepdim=True)
        val = remaining.gather(1, col)[:, 0]
        subs.append(col[:, 0].to(torch.int32))
        keys.append(val)
        origs.append(owner_rows.to(torch.int32))
        vals.append((val > NO_CANDIDATE) & owner_valid)
        scatter_(remaining, 1, col, NO_CANDIDATE)
    return tuple(torch.cat(x) for x in (subs, keys, origs, vals))


def _sync_phase(state: SparseState, r: SparseRoundRandoms, params: SparseParams, adaptive: bool = False):
    """Anti-entropy full-table exchange over ≤ K compacted callers (forced
    first, then periodic): each caller's row goes to one peer drawn from
    its live view (seeds admitted; a seed fallback when the view is too
    sparse), the peer merges it (callers on one peer merge together),
    and the peer's post-merge row comes back. Liveness deltas, episode
    registration and capped re-gossip proposals (deviation 3). ``adaptive``
    adds the accepted SUSPECT records of both directions as confirmation
    evidence (the first slot per peer on the request side)."""
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
    caller = caller.clamp(max=n - 1)

    seed_mask = None
    if params.seed_rows:
        seeds_arr = _seed_rows_tensor(tuple(params.seed_rows), dev)
        seed_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        seed_mask[seeds_arr.long()] = True
    peer_idx, peer_valid = _sample_rejection(
        state, caller, r.sync_try[caller], 1, params.sample_tries, extra_mask=seed_mask
    )
    peer = peer_idx[:, 0].long()
    valid_pick = peer_valid[:, 0]
    if params.seed_rows:
        S = len(params.seed_rows)
        fb = seeds_arr[(r.sync_fb[caller] * float(S)).to(torch.int32).clamp(max=S - 1)].long()
        use_fb = ~valid_pick & (fb != caller)
        peer = torch.where(use_fb, fb, peer)
        valid_pick = valid_pick | use_fb
    ok = valid_c & valid_pick & state.up[peer] & (r.sync_edge[caller] < _rt_at(state, caller, peer))

    vk = state.view_key
    dense_rt = state.fetch_rt.dim() != 0
    # both gathers read the pre-SYNC plane
    caller_tables = vk[caller]  # [K, N]
    own_p = vk[peer]  # [K, N]
    # callers on one peer merge together: dup_to_first[k] is the first
    # slot with slot k's peer (invalid slots are singletons)
    peer_eff = torch.where(ok, peer, -1 - karange)
    dup_to_first = first_true(peer_eff[:, None] == peer_eff[None, :], 1)
    first_p = ok & (dup_to_first == karange)
    cand_k = torch.where(ok[:, None], caller_tables, NO_CANDIDATE)
    merged = torch.full((K, n), NO_CANDIDATE, dtype=torch.int32, device=dev)
    merged.scatter_reduce_(0, dup_to_first[:, None].expand(K, n), cand_k, "amax", include_self=True)
    buf_p = torch.maximum(own_p, merged[dup_to_first])
    del merged, cand_k
    acc = (
        (buf_p > own_p)
        & ((own_p >= 0) | ((buf_p & 3) <= RANK_LEAVING))
        & state.up[peer][:, None]
        & _fetch_gate(state, SALT_SYNC_REQ, peer[:, None], rows[None, :], buf_p,
                      state.fetch_rt[peer] if dense_rt else state.fetch_rt)
    )
    if params.namespace_gate:
        acc &= state.ns_rel[state.ns_id[peer][:, None].long(), state.ns_id[None, :].long()]
    new_p = torch.where(acc, buf_p, own_p)
    # duplicate peer slots recompute the same merged row; the liveness
    # delta counts each distinct peer once
    delta_p = (
        ((new_p & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
        - ((own_p & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
    ) * first_p
    vk.scatter_reduce_(0, peer[:, None].expand(K, n), new_p, "amax", include_self=True)
    n_live = state.n_live.clone()
    n_live.index_add_(0, peer, delta_p.to(torch.int32))
    sus_req = torch.where(acc & ((buf_p & 3) == RANK_SUSPECT), buf_p, NO_CANDIDATE).amax(dim=0)

    # SYNC_ACK: the peer's post-merge row back to the caller; a caller row
    # after the request merge is its own row maxed with the row its
    # dup-group merged into, if the caller was itself a peer
    ack_cand = torch.where(ok[:, None], new_p, NO_CANDIDATE)
    match = (caller[:, None] == peer[None, :]) & ok[None, :]
    has_m = match.any(dim=1)
    contrib = torch.where(has_m[:, None], new_p[first_true(match, 1)], NO_CANDIDATE)
    own_rows = torch.maximum(caller_tables, contrib)
    del contrib, caller_tables
    accept = (
        (ack_cand > own_rows)
        & ((own_rows >= 0) | ((ack_cand & 3) <= RANK_LEAVING))
        & state.up[caller][:, None]
        & _fetch_gate(state, SALT_SYNC_ACK, caller[:, None], rows[None, :], ack_cand,
                      state.fetch_rt[caller] if dense_rt else state.fetch_rt)
    )
    if params.namespace_gate:
        accept &= state.ns_rel[state.ns_id[caller][:, None].long(), state.ns_id[None, :].long()]
    new_c = torch.where(accept, ack_cand, own_rows)
    delta_c = (
        ((new_c & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
        - ((own_rows & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
    ) * valid_c
    vk.scatter_reduce_(0, caller[:, None].expand(K, n), new_c, "amax", include_self=True)
    n_live.index_add_(0, caller, delta_c.to(torch.int32))
    sus_ack = torch.where(accept & ((ack_cand & 3) == RANK_SUSPECT), ack_cand, NO_CANDIDATE).amax(dim=0)
    sus_cand = torch.maximum(sus_req, sus_ack)
    st = _register_sus(state.replace(n_live=n_live), sus_cand)
    ok_full = scatter_reduce_1d(n, caller, ok, "amax", 0, torch.int32) > 0
    st = st.replace(force_sync=st.force_sync & ~ok_full)

    props_p = _top_props(acc & first_p[:, None], buf_p, peer, ok & first_p, P)
    props_c = _top_props(accept, ack_cand, caller, ok, P)
    proposals = tuple(torch.cat([a, b]) for a, b in zip(props_p, props_c))
    metrics = {"sync_roundtrips": _i32(ok)}
    if adaptive:
        m_req = acc & first_p[:, None] & ((buf_p & 3) == RANK_SUSPECT)
        m_ack = accept & ((ack_cand & 3) == RANK_SUSPECT)
        metrics["_ad_cnt"] = m_req.sum(dim=0, dtype=torch.int32) + m_ack.sum(dim=0, dtype=torch.int32)
        metrics["_ad_key"] = sus_cand
    return st, proposals, metrics


def _refute_phase(state: SparseState, params: SparseParams):
    """Self-record refutation (SUSPECT/DEAD diagonal, or an overwritten
    leave intent): the first V needing rows bump their incarnation and
    re-announce ALIVE (or LEAVING), written on the diagonal in place; a
    DEAD diagonal was counted out of the row's own live view, hence the
    regain."""
    n = state.capacity
    rows = _rows(state)
    diag_view = state.view_key.diagonal()
    diag = diag_view.clone()
    rank = diag & 3
    need = state.up & (
        (rank == RANK_SUSPECT) | (rank == RANK_DEAD) | (state.leaving & (rank != RANK_LEAVING))
    )
    V = min(n, params.refute_slots or max(64, n // 16))
    eff = need & (torch.cumsum(need, 0) - 1 < V)
    announce_rank = torch.where(state.leaving, RANK_LEAVING, RANK_ALIVE)
    new_diag = torch.where(eff, (((diag >> 2) + 1) << 2) | announce_rank, diag).to(torch.int32)
    diag_view.copy_(new_diag)
    regain = (eff & (rank == RANK_DEAD)).to(torch.int32)
    return state.replace(n_live=state.n_live + regain), (rows, new_diag, rows, eff)


def _rumor_sweeps_fused(state: SparseState, params: SparseParams, covered, mr_any: bool, n_up):
    """Slot reclamation. User rumors: kept while young or while an up
    member still forwards them. Membership rumors: the same age/forwarder
    rules on the u8 plane, plus the early full-coverage free (deviation 5)
    from the gossip phase's ``covered``."""
    sweep = 2 * (params.repeat_mult * ceil_log2(n_up) + 1)
    spread = params.repeat_mult * ceil_log2(state.n_live)  # [N]
    keep_u = (state.tick - state.rumor_created) <= sweep
    forwarding_u = (
        state.infected
        & state.up[:, None]
        & ((state.tick - state.infected_at) < spread[:, None])
    ).any(dim=0)
    state = state.replace(rumor_active=state.rumor_active & (keep_u | forwarding_u))
    if not mr_any:
        return state
    spread8 = spread.clamp(max=255).to(torch.uint8)
    forwarding_m = torch.zeros(state.mr_active.shape, dtype=torch.bool, device=state.device)
    for lo, hi in row_chunks(state.capacity):
        forwarding_m |= (
            ((state.minf_age[lo:hi] - 1) < spread8[lo:hi, None]) & state.up[lo:hi, None]
        ).any(dim=0)
    keep_m = ((state.tick - state.mr_created) <= sweep) | forwarding_m
    if params.early_free:
        keep_m = keep_m & ~covered
    keep_m = keep_m & state.mr_active
    freed = state.mr_active & ~keep_m
    # in place: with a live pool, the gossip phase's aging made this plane
    # this tick
    return state.replace(
        mr_active=keep_m,
        mr_subject=torch.where(freed, -1, state.mr_subject).to(torch.int32),
        minf_age=state.minf_age.masked_fill_(freed[None, :], 0),
    )


def state_metrics(state: SparseState, params: SparseParams, n_up) -> dict:
    """The tick's state-derived health metrics (``n_up``: the tick's shared
    up-count); ``full_metrics`` adds the view-plane counts, over row
    chunks."""
    n = state.capacity
    dev = state.device
    metrics = rumor_metrics(state, params, n_up)
    if params.full_metrics:
        cols = torch.arange(n, device=dev)
        alive = torch.zeros((), dtype=torch.int64, device=dev)
        suspect = torch.zeros((), dtype=torch.int64, device=dev)
        for lo, hi in plane_chunks(n, n):
            rank = state.view_key[lo:hi] & 3
            pair = state.up[lo:hi, None] & state.up[None, :] & (cols[lo:hi, None] != cols[None, :])
            alive += (pair & (rank == RANK_ALIVE)).sum()
            suspect += (pair & (rank == RANK_SUSPECT)).sum()
        n_up64 = n_up.to(torch.int64)
        pairs = (n_up64 * n_up64 - n_up64).clamp(min=1)
        metrics["alive_view_fraction"] = alive.to(torch.float32) / pairs.to(torch.float32)
        metrics["false_suspect_pairs"] = suspect.to(torch.int32)
    else:
        metrics["alive_view_fraction"] = torch.zeros((), dtype=torch.float32, device=dev)
        metrics["false_suspect_pairs"] = torch.zeros((), dtype=torch.int32, device=dev)
    return metrics


# ---------------------------------------------------------------------------
# tick + window
# ---------------------------------------------------------------------------


_FD_METRICS = ("fd_probes", "fd_failed_probes", "fd_new_suspects")


def sparse_tick_fused(state: SparseState, fd_r, round_r: SparseRoundRandoms, params: SparseParams,
                      ad=None):
    """One gossip period for all N members (the JAX ``sparse_tick(...,
    fused=True)``): FD → suspicion sweep → gossip → SYNC → refute → rumor
    sweeps → pool allocation → metrics. ``fd_r`` is read only on FD ticks
    (``tick % fd_every == 0`` after the increment) and may be None
    otherwise. Consumes ``state``; returns ``(state, metrics)``, or with
    ``ad`` (the adaptive plane, as in the dense ``tick``) ``(state, ad',
    metrics)``."""
    armed = ad is not None
    if armed and params.adaptive.is_default:
        raise ValueError("adaptive tick needs an enabled AdaptiveSpec on params")
    state = state.replace(tick=state.tick + 1)
    n = state.capacity
    if state.tick % params.fd_every == 0:
        if fd_r is None:
            raise ValueError(f"tick {state.tick} runs the FD round and needs FD draws")
        state, props_fd, fd_m = _fd_phase(state, fd_r, params, ad=ad)
    else:
        z = torch.zeros((), dtype=torch.int32, device=state.device)
        props_fd, fd_m = _no_props(state), {k: z for k in _FD_METRICS}
        if armed:
            fd_m.update(_no_evidence(n, state.device, probes=True))
    state, props_exp = _suspicion_sweep(state, params, ad=ad)
    state, g_m, covered, mr_any = _gossip_phase_fused(state, round_r, params, adaptive=armed)
    state, props_sync, s_m = _sync_phase(state, round_r, params, adaptive=armed)
    state, props_ref = _refute_phase(state, params)
    n_up = _i32(state.up)
    state = _rumor_sweeps_fused(state, params, covered, mr_any, n_up)
    # the allocation takes the first E valid proposals in this order:
    # refutations rank before the sync re-gossip flood
    state, a_m = alloc_phase(state, (props_fd, props_exp, props_ref, props_sync), params)
    if armed:
        ad = _fold_evidence(params, ad, fd_m, g_m, s_m, props_ref[3], state.up)
    metrics = {**fd_m, **g_m, **s_m, **a_m, **state_metrics(state, params, n_up)}
    if armed:
        metrics["adaptive_lh_high"] = ad.lh.max()
        metrics["adaptive_conf_high"] = ad.conf.max()
        return state, ad, metrics
    return state, metrics


def run_sparse_ticks_fused(state: SparseState, draws, n_ticks: int, params: SparseParams,
                           watch_rows=None):
    """Run ``n_ticks`` fused ticks; consumes ``state``
    (:func:`._tick.run_window`: ``draws`` is a ``torch.Generator`` on the
    state's device or ``n_ticks`` ``(fd, round)`` draw pairs). Returns
    ``(state, metrics stacked to [n_ticks], watched)``; ``watched`` is the
    [n_ticks, W, N] view rows of ``watch_rows`` after each tick, or None."""
    return run_window(sparse_tick_fused, view_rows, draw_sparse_tick, state, draws, n_ticks, params, watch_rows)


def make_sparse_fused_run(params: SparseParams, n_ticks: int):
    """The window as a callable ``run(state, draws, watch_rows=None)`` —
    the counterpart of the JAX function of the same name."""

    def run(state: SparseState, draws, watch_rows=None):
        return run_sparse_ticks_fused(state, draws, n_ticks, params, watch_rows)

    return run


def sparse_tick(state: SparseState, fd_r, round_r: SparseRoundRandoms, params: SparseParams,
                trace=None, ad=None):
    """One gossip period (the JAX ``sparse_tick``): the fused tick, whose
    state and metrics are the unfused tick's. ``trace`` is refused until
    the trace plane is ported. Returns ``(state, metrics)``, or ``(state,
    ad', metrics)`` with ``ad``."""
    if trace is not None:
        raise NotImplementedError("trace capture on the sparse tick is not ported yet (ROADMAP A10)")
    return sparse_tick_fused(state, fd_r, round_r, params, ad=ad)


def run_sparse_ticks_adaptive(state: SparseState, ad, draws, n_ticks: int, params: SparseParams,
                              watch_rows=None):
    """:func:`run_sparse_ticks_fused` with the adaptive plane ``ad`` threaded
    through the window. Returns ``(state, ad, metrics, watched)``."""
    return run_window(sparse_tick_fused, view_rows, draw_sparse_tick, state, draws, n_ticks, params,
                      watch_rows, ad=ad)


def make_sparse_adaptive_run(params: SparseParams, n_ticks: int):
    """The adaptive window as a callable ``run(state, ad, draws,
    watch_rows=None)``. Refuses a default spec."""
    if params.adaptive.is_default:
        raise ValueError(
            "make_sparse_adaptive_run needs an enabled AdaptiveSpec on params — the default "
            "spec's window is make_sparse_run's"
        )

    def run(state: SparseState, ad, draws, watch_rows=None):
        return run_sparse_ticks_adaptive(state, ad, draws, n_ticks, params, watch_rows)

    return run


def sentinel_reduce(state: SparseState, sent: dict, spec: dict) -> dict:
    """Sparse-engine chaos sentinel check: the shared view-plane core
    (:func:`.kernel.sentinel_core`) plus ``n_live_drift``, the up rows whose
    incrementally kept live count differs from a recount (row chunks)."""
    sent = sentinel_core(state.view_key, state.up, state.tick, sent, spec)
    n = state.capacity
    drift = torch.zeros((), dtype=torch.int32, device=state.device)
    for lo, hi in plane_chunks(n, n):
        recount = ((state.view_key[lo:hi] & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
        drift += (state.up[lo:hi] & (recount != state.n_live[lo:hi])).sum(dtype=torch.int32)
    sent["n_live_drift"] = sent["n_live_drift"] + drift
    return sent


def make_sparse_fleet_run(params, n_ticks: int):
    """The fleet window (:mod:`.fleet`): ``run(fleet_state, draws,
    watch_rows=None) -> (fleet_state, metrics [S, T], watched)``, every
    scenario's tick one vmapped call per tick (the kernel: one launch of its
    scenario-axis variant per gossip tick)."""
    from .fleet import make_fleet_window

    return make_fleet_window(sparse_tick_fused, view_rows, draw_sparse_tick, params, n_ticks)


def make_sparse_fleet_adaptive_run(params, n_ticks: int):
    """The adaptive fleet window, ``ad`` stacked to [S, N]. Refuses a
    default spec."""
    from .fleet import make_fleet_window

    return make_fleet_window(sparse_tick_fused, view_rows, draw_sparse_tick, params, n_ticks, adaptive=True)


# The JAX names of the driver's window: the same runners as the fused ones.
run_sparse_ticks = run_sparse_ticks_fused
make_sparse_run = make_sparse_fused_run
run_sparse_ticks_fused_adaptive = run_sparse_ticks_adaptive
make_sparse_fused_adaptive_run = make_sparse_adaptive_run
make_sparse_fused_fleet_run = make_sparse_fleet_run
