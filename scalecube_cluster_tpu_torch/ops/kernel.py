"""The dense SWIM tick in PyTorch: every member's full [N, N] view, FD,
suspicion, gossip with the delayed-delivery rings, SYNC, refutation and
the rumor sweep. A port of the JAX package's ``ops/kernel.py`` — its
``tick``, the window runner and the helpers they call — held against it
bit for bit (``tests/test_torch_dense*.py``). The JAX module's docstring
carries the protocol account; this file keeps its function names.

The JAX package has two spellings of the tick: the unfused one (the
driver's window, ``make_run``) and the fused one (``make_fused_run``),
which differs only in sharing one unpack of the infection words and one
up-count between the rumor sweep and the metrics. The port has one tick,
under both names: ``run_ticks_fused`` and ``make_fused_run`` are aliases.

What differs from the JAX spelling, and why:

* The [N, N] planes and the pending rings are updated IN PLACE: a state
  handed to :func:`tick` is consumed, as the JAX driver's donated windows
  consume theirs.
* Passes over the view plane (the suspicion sweep, the gossip accept with
  its metadata-fetch hash, the cluster sizes, ``full_metrics``) run over
  row chunks of at most :data:`._tensor.PLANE_CHUNK_CELLS` cells, counting
  in int32: a bool sum over [N, N] would widen to int64, and the fetch
  hash's int64 arithmetic over the whole plane is 800 MB a temporary at
  10,000 members.
* Point writes are point writes: the FD verdicts (one cell per row at
  distinct rows) and the refuted diagonal, where JAX streams one-hot
  selects to keep a TPU layout.
* Duplicate-index row scatters (the gossip deliveries into ``buf``, the
  pending rings, the SYNC merges) are ``index_reduce_`` amax, which gives
  the same cells whatever the order. Rows that deliver nothing are
  redirected to a spare row of ``buf`` or to the ring's current slot,
  which the same tick clears, instead of contributing a masked copy of
  their whole row.
* SYNC builds no second [N, N] plane: the per-peer max of its callers'
  rows is a [K, N] merge, written back to the K peer rows in place. The
  JAX i32 and i16 spellings give the same cells.
* ``tick`` is a host int, so the FD gate costs nothing. The JAX tick
  keys three more gates on data (``lax.cond``); each skipped branch is a
  no-op when its gate is closed, as ``quiet_gates=False`` proves in JAX,
  so a gate may also be opened when it need not be. While
  ``params.quiet_gates`` holds, the suspicion sweep's has-suspect gate
  and the gossip phase's work gate are read together, as two flags in
  ONE device-to-host read per tick (:func:`_gate_flags`,
  :data:`._tensor.HOST_SYNCS`), taken before the sweep: the work flag
  bounds every row's forwarding window by the largest one, and a tick
  with suspects runs the gossip phase (a sweep that expires a cell makes
  it young). The refutation's diagonal write runs ungated: an N-cell
  write costs less than a read.
* Uniform draws are an input of the tick (:mod:`.rand`).

The adaptive plane (``tick(ad=...)``, :func:`make_adaptive_run`) threads
an :class:`..adaptive.AdaptiveState` through the window: the phases export
their evidence (own-probe outcomes, accepted SUSPECT records per subject,
self-refutations) and the tick folds it at its end; with the default spec
none of it runs. :func:`sentinel_core` is the chaos sentinels' check over
the [N, N] view plane, in row chunks.

:func:`telemetry_window_vector` is the telemetry plane's per-window row.

The causal trace capture (``tick(trace=...)``, :func:`make_traced_run`)
exports each phase's own internals into one [K, n_fields] record block per
tick, appended to the trace ring in place (:mod:`..trace`); armed together
with the adaptive plane it is refused, as in JAX. ``tick(timer=...)``
scopes each phase for the phase-split profiler (:mod:`..trace.profile`).
The fleet windows (``make_fleet_run``, its fused name,
``make_fleet_adaptive_run``) run this tick under ``torch.func.vmap``
(:mod:`.fleet`).
"""

from __future__ import annotations

import torch

from .. import adaptive as _adp
from ..dissemination import strategies as dz
from . import bitplane as bp
from . import sharding
from ._tensor import first_true, host_flags, index_amax_, maximum_into_, nonzero_fixed, plane_chunks, scatter_reduce_1d
from ._tick import count_i32 as _i32
from ._tick import fd_trace as _fd_trace
from ._tick import phase as _phase
from ._tick import seed_rows_tensor as _seed_rows_tensor
from ._tick import sync_trace as _sync_trace
from .engine_api import plane_tracer_view_cols as tracer_view_cols  # noqa: F401
from .engine_api import plane_view_rows as view_rows
from .lattice import RANK_ALIVE, RANK_DEAD, RANK_LEAVING, RANK_SUSPECT, bump_inc, key_dtype, no_candidate
from .rand import SALT_GOSSIP, SALT_SYNC_ACK, SALT_SYNC_REQ, FdRandoms, RoundRandoms, draw_dense_tick, fetch_uniform
from .state import NEVER, NO_CANDIDATE_I32, SimParams, SimState


def ceil_log2(n: torch.Tensor) -> torch.Tensor:
    """Reference ``ClusterMath.ceilLog2 = 32 - numberOfLeadingZeros(n)``,
    exactly, by integer compare-and-count (int32)."""
    n = n.to(torch.int32)
    powers = torch.ones((), dtype=torch.int32, device=n.device) << torch.arange(
        31, dtype=torch.int32, device=n.device
    )
    return (n[..., None] >= powers).sum(dim=-1, dtype=torch.int32)


def _packed(params: SimParams) -> bool:
    """The packed mode (narrow i16 keys, word-parallel samplers and counts)
    or the wide one; both give the same picks, counts and records."""
    return params.key_dtype == "i16"


def _noc(params: SimParams) -> int:
    """Scatter-max identity of the configured key dtype."""
    return no_candidate(key_dtype(params.key_dtype))


def _rows(state: SimState) -> torch.Tensor:
    """int64 local row indices of the state's rows."""
    return torch.arange(state.capacity, device=state.device)


# -- the member-mesh seams (identities off a mesh; ops/sharding.py) ------------


def _gcap(state: SimState) -> int:
    """N, the global capacity (a shard holds L = N / W rows, each [N] wide)."""
    return state.view_key.shape[-1]


def _grows(state: SimState) -> torch.Tensor:
    """int64 global row ids of the state's rows."""
    ctx = sharding.active()
    return _rows(state) if ctx is None else _rows(state) + ctx.lo


def _full(x: torch.Tensor) -> torch.Tensor:
    """All N rows of a member-axis vector (read at other members' rows)."""
    ctx = sharding.active()
    return x if ctx is None else ctx.full(x)


def _reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """A value reduced over the ranks (max, min or sum)."""
    ctx = sharding.active()
    return x if ctx is None else ctx.reduce(x, op)


def _mine(x: torch.Tensor) -> torch.Tensor:
    """The state's rows of a member-axis vector computed over all N rows."""
    ctx = sharding.active()
    return x if ctx is None else ctx.mine(x)


def _capped(mask: torch.Tensor, V: int) -> torch.Tensor:
    """``mask`` less the entries past the first V in global row order."""
    pos = torch.cumsum(mask, 0) - 1
    ctx = sharding.active()
    if ctx is not None:
        pos = pos + ctx.offset(mask.sum())
    return mask & (pos < V)


def _full_draws(r):
    """The tick's round draws over all N rows (read at other members' rows):
    on a mesh the full block every rank draws alike."""
    ctx = sharding.active()
    return r if ctx is None else ctx.draws[1]


def _diag(plane: torch.Tensor) -> torch.Tensor:
    """The cells (i, i) of the state's rows of an [N, N] plane (a view)."""
    ctx = sharding.active()
    return plane.diagonal() if ctx is None else ctx.diagonal(plane)


def _link_at_rows(plane: torch.Tensor, i, j) -> torch.Tensor:
    """``plane[i, j]`` at global rows ``i`` of any rank (a scalar link
    broadcasts); on a mesh the cells are point reads
    (:func:`.ragged_a2a.fetch_points`)."""
    if plane.dim() == 0:
        return plane
    ctx = sharding.active()
    return plane[i, j] if ctx is None else ctx.points(plane, i, j)


def _words(x: torch.Tensor) -> torch.Tensor:
    """A key plane as collective-safe words (i16 keys pair into int32)."""
    return x.view(torch.int32) if x.dtype == torch.int16 else x


def _rows_at(plane: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Rows ``plane[want]`` at global row ids; on a mesh fetched from their
    ranks in request order (:func:`.ragged_a2a.fetch_rows`)."""
    ctx = sharding.active()
    return plane[want] if ctx is None else ctx.fetch_rows(plane, want)


def _write_rows_amax_(plane: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, none) -> None:
    """``plane`` cellwise max ``vals`` at global ``rows`` (a row scatter-max);
    on a mesh each rank writes the rows it holds, the rest redirected to
    its first row as ``none``, the max's identity."""
    ctx = sharding.active()
    if ctx is not None:
        here = (rows >= ctx.lo) & (rows < ctx.hi)
        rows = torch.where(here, rows - ctx.lo, 0)
        vals = torch.where(here[:, None], vals, none)
    index_amax_(plane, rows, vals)


def _live_view_mask(state: SimState) -> torch.Tensor:
    """bool [N, N]: j is in i's member list (known, not DEAD, not self).
    The unknown key -1 reads rank 3 too."""
    live = (state.view_key & 3) != RANK_DEAD
    _diag(live).fill_(False)
    return live


def _diag_words(state: SimState) -> torch.Tensor:
    """The packed self bits of the state's rows (:func:`.bitplane.diag_words`)."""
    n = _gcap(state)
    words = bp.diag_words(n, state.device)
    ctx = sharding.active()
    return words if ctx is None else words[ctx.lo:ctx.hi]


def _known_live_words(state: SimState) -> torch.Tensor:
    """The packed ``rank != DEAD`` plane, self bits included."""
    return bp.pack_bits((state.view_key & 3) != RANK_DEAD)


def _cluster_size(state: SimState) -> torch.Tensor:
    """int32 [N]: node i's view of the cluster size (itself included),
    over row chunks."""
    n = state.capacity
    out = state.view_key.new_empty((n,), dtype=torch.int32)
    for lo, hi in plane_chunks(n, _gcap(state)):
        out[lo:hi] = ((state.view_key[lo:hi] & 3) != RANK_DEAD).sum(dim=1, dtype=torch.int32)
    return out


def _sizes(state: SimState, params: SimParams) -> torch.Tensor:
    """Cluster sizes by the mode's spelling: popcounts of the packed live
    plane, or the row sums (the same values)."""
    return bp.popcount_rows(_known_live_words(state)) if _packed(params) else _cluster_size(state)


# -- selection samplers ----------------------------------------------------------


def _sample_distinct(mask: torch.Tensor, u: torch.Tensor):
    """Per-row k distinct uniform picks from the candidate set ``mask[i]``,
    one uniform per pick (``u`` [N, k]): rank insertion, ranks mapped to
    columns through the mask's int32 cumsum by a row-batched binary
    search. Returns (idx int32 [N, k], valid [N, k]); invalid slots hold a
    clamped index the caller masks."""
    k = u.shape[1]
    c = mask.sum(dim=1, dtype=torch.int32)
    cs = torch.cumsum(mask, dim=1, dtype=torch.int32)
    targets = _insertion_ranks(c, u) + 1
    idx = torch.searchsorted(cs, targets, side="left")
    idx = idx.clamp(max=mask.shape[1] - 1).to(torch.int32)
    valid = torch.arange(k, dtype=torch.int32, device=u.device)[None, :] < c[:, None]
    return idx, valid


def _insertion_ranks(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The samplers' shared rank-insertion draw: pick s draws a rank in
    ``[0, c - s)`` (the f32 product truncated toward zero) and is shifted
    up past the ranks already taken, in ascending order."""
    ranks = []
    for s in range(u.shape[1]):
        avail = (c - s).clamp(min=1)
        x = (u[:, s] * avail.to(torch.float32)).to(torch.int32)
        x = torch.minimum(x, avail - 1)
        if ranks:
            prev = torch.sort(torch.stack(ranks, 0), dim=0).values
            for t in range(len(ranks)):
                x = x + (x >= prev[t]).to(torch.int32)
        ranks.append(x)
    return torch.stack(ranks, 1)


def _sample_distinct_words(mask_w: torch.Tensor, n: int, u: torch.Tensor):
    """:func:`_sample_distinct` over a packed mask: cumulative popcounts per
    word, a binary search over words, then the bit's rank inside its word
    (:func:`.bitplane.select_bit`). The same picks as the wide sampler."""
    k = u.shape[1]
    cs = torch.cumsum(bp.popcount(mask_w), dim=1, dtype=torch.int32)
    c = cs[:, -1].contiguous()
    targets = _insertion_ranks(c, u) + 1
    wi = torch.searchsorted(cs, targets, side="left").clamp(max=mask_w.shape[1] - 1)
    prior = torch.where(wi > 0, cs.gather(1, (wi - 1).clamp(min=0)), 0)
    bit = bp.select_bit(mask_w.gather(1, wi), targets - prior)
    idx = (wi * bp.WORD + bit).clamp(max=n - 1).to(torch.int32)
    valid = torch.arange(k, dtype=torch.int32, device=u.device)[None, :] < c[:, None]
    return idx, valid


# -- link helpers --------------------------------------------------------------------


def _loss_at(state: SimState, i, j) -> torch.Tensor:
    """Loss of the directed link i -> j; a scalar broadcasts."""
    return state.loss if state.loss.dim() == 0 else state.loss[i, j]


def _rt_at(state: SimState, i, j) -> torch.Tensor:
    """Round-trip success probability i -> j -> i (the derived plane)."""
    return state.fetch_rt if state.fetch_rt.dim() == 0 else state.fetch_rt[i, j]


def _delay_q_at(state: SimState, i, j) -> torch.Tensor:
    """Geometric delay parameter of the directed link i -> j (0: none)."""
    return state.delay_q if state.delay_q.dim() == 0 else state.delay_q[i, j]


def _timely_rt(q1: torch.Tensor, q2: torch.Tensor, t: int) -> torch.Tensor:
    """P(two independent geometric legs with parameters q1, q2 sum to at
    most t ticks), by the recurrence h_s = q1·h_{s-1} + q2^s. Each product
    and sum is its own f32 operation, in the JAX order (no fused
    multiply-add): exactly 1.0 at q = 0."""
    h = torch.ones_like(q1)
    acc = h
    q2p = torch.ones_like(q2)
    for _ in range(t):
        q2p = q2p * q2
        h = q1 * h
        h = h + q2p
        acc = acc + h
    return (1.0 - q1) * (1.0 - q2) * acc


def _edge_ok(state: SimState, src, dst, draw, up_all) -> torch.Tensor:
    """Delivery of a message from the state's rows ``src`` to ``dst``
    (global): both up (``up_all``: every member's flag), one Bernoulli draw
    on the outbound loss."""
    return state.up[src] & up_all[dst] & (draw < (1.0 - _loss_at(state, src, dst)))


def _fetch_gate(state: SimState, salt: int, i, j, cand_key, p_fetch, up_all) -> torch.Tensor:
    """ALIVE-rank candidates about subject j are applied at receiver i only
    if the metadata-fetch round trip succeeds (subject up, one hashed draw
    against ``p_fetch``); other ranks pass. ``up_all``: every member's up
    flag (on a mesh, gathered)."""
    needs = (cand_key & 3) == RANK_ALIVE
    u = fetch_uniform(state.tick, salt, i, j)
    return ~needs | (up_all[j] & (u < p_fetch))


# -- phases ----------------------------------------------------------------------


def _fd_phase(state: SimState, r: FdRandoms, params: SimParams, ad=None, trace: bool = False):
    """FD round: each up row probes one target from its live view directly
    and through k relays (each leg's round trip under loss and, with the
    rings, its timeliness); the verdict (ALIVE at the target's own key, or
    SUSPECT at the known one) is written where it overrides. With ``ad``
    the direct leg's timeout stretches to ``t_base * (1 + lh)`` (AD-4) and
    the metrics carry the adaptive evidence (``_ad_*``); with ``trace``
    they carry the probe internals the trace ring records
    (``trace_fd``: values the phase computed anyway)."""
    n = state.capacity
    rows = _rows(state)
    grows = _grows(state)
    if _packed(params):
        selw = bp.word_andnot(_known_live_words(state), _diag_words(state))
        sel_idx, sel_valid = _sample_distinct_words(selw, _gcap(state), r.fd_sel)
    else:
        sel_idx, sel_valid = _sample_distinct(_live_view_mask(state), r.fd_sel)
    sel_idx = sel_idx.long()
    tgt = sel_idx[:, 0]
    has_tgt = sel_valid[:, 0] & state.up
    up_all = _full(state.up)
    # the link cells at other members' rows (point reads on a mesh)
    dq = state.delay_q

    p_direct = _rt_at(state, rows, tgt)
    if params.delay_slots and ad is not None:
        p_direct = p_direct * _adp.scaled_timely_rt(
            _delay_q_at(state, rows, tgt), _link_at_rows(dq, tgt, grows),
            params.fd_direct_timeout_ticks, ad.lh, params.adaptive.lh_max,
        )
    elif params.delay_slots:
        p_direct = p_direct * _timely_rt(_delay_q_at(state, rows, tgt), _link_at_rows(dq, tgt, grows),
                                         params.fd_direct_timeout_ticks)
    direct_ok = has_tgt & up_all[tgt] & (r.fd_direct < p_direct)

    relays = sel_idx[:, 1:]
    relay_valid = sel_valid[:, 1:]
    tgt_b = tgt[:, None]
    rows_b = rows[:, None]
    p_relay = _rt_at(state, rows_b, relays) * _link_at_rows(state.fetch_rt, relays, tgt_b)
    if params.delay_slots:
        leg = params.fd_leg_timeout_ticks
        p_relay = p_relay * _timely_rt(_delay_q_at(state, rows_b, relays),
                                       _link_at_rows(dq, relays, grows[:, None]), leg)
        p_relay = p_relay * _timely_rt(_link_at_rows(dq, relays, tgt_b), _link_at_rows(dq, tgt_b, relays), leg)
    relay_ok = relay_valid & up_all[relays] & up_all[tgt_b] & (r.fd_relay < p_relay)
    ack = direct_ok | relay_ok.any(dim=1)

    vk = state.view_key
    own_key = vk[rows, tgt]
    # the target's own record: its diagonal cell (gathered on a mesh)
    alive_key = (_full(_diag(vk).contiguous())[tgt] >> 2) << 2
    suspect_key = ((own_key >> 2) << 2) | RANK_SUSPECT
    cand = torch.where(ack, alive_key, suspect_key)
    accept = has_tgt & (cand > own_key)
    # one cell (i, tgt[i]) per row: distinct rows, so no write collides
    vk[rows, tgt] = torch.where(accept, cand, own_key)
    ca = state.changed_at
    ca[rows, tgt] = torch.where(accept, state.tick, ca[rows, tgt]).to(torch.int32)
    metrics = {
        "fd_probes": _i32(has_tgt),
        "fd_failed_probes": _i32(has_tgt & ~ack),
        "fd_new_suspects": _i32(accept & ~ack),
    }
    if ad is not None:
        # own-probe outcomes feed lh; new SUSPECT verdicts are the
        # episode's origin confirmations (AD-1)
        sus_w = accept & ~ack
        metrics["_ad_miss"] = has_tgt & ~ack
        metrics["_ad_succ"] = has_tgt & ack
        metrics["_ad_cnt"] = sus_w.new_zeros((n,), dtype=torch.int32).index_add_(
            0, tgt, sus_w.to(torch.int32)
        )
        metrics["_ad_key"] = scatter_reduce_1d(
            n, tgt, torch.where(sus_w, cand.to(torch.int32), NO_CANDIDATE_I32), "amax",
            NO_CANDIDATE_I32, torch.int32,
        )
    if trace:
        metrics["trace_fd"] = _fd_trace(tgt, has_tgt, ack, direct_ok, accept & ~ack, relays, relay_valid, relay_ok)
    return state, metrics


def _no_evidence(n: int, device, probes: bool = False) -> dict:
    """The adaptive evidence of a phase that accepted nothing (``probes``:
    and of an FD phase that did not run)."""
    ev = {
        "_ad_cnt": torch.zeros((n,), dtype=torch.int32, device=device),
        "_ad_key": torch.full((n,), NO_CANDIDATE_I32, dtype=torch.int32, device=device),
    }
    if probes:
        ev["_ad_miss"] = ev["_ad_succ"] = torch.zeros((n,), dtype=torch.bool, device=device)
    return ev


def _gate_flags(state: SimState, params: SimParams):
    """The two data-keyed gates, as device flags: (a SUSPECT cell exists,
    the gossip phase may have work). The second over-approximates: a known
    cell changed within the largest forwarding window any row can have
    (``repeat_mult * ceil_log2(N)``), a live rumor infection as recent,
    or a message arriving from the rings."""
    vk, ca = state.view_key, state.changed_at
    n = _gcap(state)
    dev = state.device
    horizon = state.tick - params.repeat_mult * int(n).bit_length()
    sus = torch.zeros((), dtype=torch.bool, device=dev)
    young = torch.zeros((), dtype=torch.bool, device=dev)
    for lo, hi in plane_chunks(state.capacity, n):
        blk = vk[lo:hi]
        sus = sus | ((blk & 3) == RANK_SUSPECT).any()
        young = young | ((blk >= 0) & (ca[lo:hi] > horizon)).any()
    inf_b = bp.unpack_bits(state.infected, params.rumor_slots)
    young = young | (inf_b & state.rumor_active[None, :] & (state.infected_at > horizon)).any()
    if params.delay_slots:
        slot_now = state.tick % params.delay_slots
        young = young | (state.pending_key[slot_now] > _noc(params)).any() | (state.pending_inf[slot_now] != 0).any()
    return sus, young


def _suspicion_phase(state: SimState, params: SimParams, has_suspect: bool = True, ad=None, trace=None):
    """SUSPECT cells whose suspicion window (``changed_at`` is its start)
    has expired become DEAD at the same incarnation (key + 1), in place over
    row chunks; skipped when no SUSPECT cell exists (``has_suspect``
    False). With ``ad`` the window is ``base_i * mult(conf_j) * (1 + lh_i)
    // L``: the subject's confirmations shorten it for cells within its
    episode (AD-1), the observer's local health stretches it (AD-3).
    ``trace`` (a :class:`..trace.schema.TraceSpec`) makes the return
    ``(state, sus_tr)``: the tracers' expiry transitions, read off each
    chunk's own ``expired`` mask."""
    trace_acc = None
    if trace is not None:
        from ..trace import capture as _tc

        trace_acc = _tc.ExpiryTrace(trace, state.device)
    if has_suspect:
        _expire_chunks(state, params, ad, trace_acc)
    return state if trace is None else (state, trace_acc.result())


def _expire_chunks(state: SimState, params: SimParams, ad, trace_acc) -> None:
    """The suspicion sweep's in-place pass over the row chunks."""
    vk, ca = state.view_key, state.changed_at
    n = state.capacity
    if ad is not None:
        aspec = params.adaptive
        L = aspec.levels
        num_conf = _adp.conf_mult_num(aspec, ad.conf)  # [N]
    for lo, hi in plane_chunks(n, _gcap(state)):
        blk = vk[lo:hi]
        rank = blk & 3
        # the row's cluster size before any of its cells expire
        size = (rank != RANK_DEAD).sum(dim=1, dtype=torch.int32)
        if ad is not None:
            base = ceil_log2(size) * params.fd_every
            in_ep = blk.to(torch.int32) <= ad.conf_key[None, :]
            num = torch.where(in_ep, num_conf[None, :], aspec.max_mult * L)
            factor = base * (1 + ad.lh[lo:hi])
            timeout = torch.div(factor[:, None] * num, L, rounding_mode="floor")
            overdue = (state.tick - ca[lo:hi]) >= timeout
        else:
            timeout = params.suspicion_mult * ceil_log2(size) * params.fd_every
            overdue = (state.tick - ca[lo:hi]) >= timeout[:, None]
        expired = (rank == RANK_SUSPECT) & overdue & state.up[lo:hi, None]
        if trace_acc is not None:
            trace_acc.add_plane(expired, lo)
        blk += expired
        ca[lo:hi].masked_fill_(expired, state.tick)


_GOSSIP_METRICS = ("gossip_msgs", "rumor_sends", "rumor_deliveries")


def _gossip_phase(state: SimState, r: RoundRandoms, params: SimParams, busy: bool = True,
                  adaptive: bool = False):
    """Infection-style dissemination: each up row sends ``fanout`` distinct
    live peers one message holding its young records (changed within
    ``repeat_mult * ceil_log2(size)`` ticks) and its young rumors less
    those the peer is known to hold; each message lands now or, drawn
    geometric on the link's delay, up to D - 1 ticks later through the
    pending rings. Receivers fold records in by scatter-max and the
    override, null-record, up and metadata-fetch gates; rumor infections
    are OR-ed in. A tick with nothing to send and nothing arriving
    (``busy`` False) skips the phase.

    ``params.dissem`` picks the peers (the live-view sampler, or the
    strategy's circulant chords, :mod:`..dissemination.strategies`), the
    user rumors a message may carry (the pipelined budget window; the
    work flag and ``rumor_young`` stay unbudgeted, so a rumor outside the
    window is still pending work) and, for ``push_pull``, the reply leg:
    each undelayed contact answers with the peer's young records and
    rumors, the peer's rows gathered in row chunks. ``adaptive`` adds the
    confirmation evidence: every accepted SUSPECT record counts one
    believer of its subject (AD-1, AD-2).

    On a member mesh each message's row crosses to its receiver's rank
    (:func:`_deliver_rows`), where it folds into ``buf`` or the rings as the
    one-device scatter folds it, and the reply leg fetches the peers' rows
    (:func:`_pull_reply`)."""
    n = state.capacity
    N = _gcap(state)
    R = params.rumor_slots
    F = params.fanout
    D = params.delay_slots
    NOC = _noc(params)
    dev = state.device
    ctx = sharding.active()
    if not busy:
        z = torch.zeros((), dtype=torch.int32, device=dev)
        m = {k: z for k in _GOSSIP_METRICS}
        if adaptive:
            m.update(_no_evidence(n, dev))
        return state, m
    rows = _rows(state)
    grows = _grows(state)
    grows32 = grows.to(torch.int32)
    up_all = _full(state.up)
    vk, ca = state.view_key, state.changed_at
    klw = _known_live_words(state) if _packed(params) else None
    sizes = bp.popcount_rows(klw) if klw is not None else _cluster_size(state)
    spread = params.repeat_mult * ceil_log2(sizes)
    young = (vk >= 0) & ((state.tick - ca) < spread[:, None])
    young_any = young.any(dim=1)
    inf_b = bp.unpack_bits(state.infected, R)
    rumor_young = inf_b & state.rumor_active[None, :] & ((state.tick - state.infected_at) < spread[:, None])
    spec = params.dissem
    bmask = dz.rumor_budget_mask(spec, R, state.tick, dev)
    rumor_pay = rumor_young if bmask is None else rumor_young & bmask[None, :]
    if D:
        slot_now = state.tick % D
        arriving_key = state.pending_key[slot_now]
        arriving_inf = bp.unpack_bits(state.pending_inf[slot_now], R)
    if not spec.uniform_selection:
        # the strategy's circulant targets (DZ-1: sends gate on up[src] &
        # up[dst], not on the sender's view of the neighbor); on a mesh
        # every row's, and each rank keeps its rows
        peers, peer_valid = dz.structured_peers(spec, N, state.tick, _full_draws(r).gossip_sel)
        peers, peer_valid = _mine(peers), _mine(peer_valid)
    elif klw is not None:
        peers, peer_valid = _sample_distinct_words(bp.word_andnot(klw, _diag_words(state)), N, r.gossip_sel)
    else:
        peers, peer_valid = _sample_distinct(_live_view_mask(state), r.gossip_sel)
    del klw
    piggyback = vk.masked_fill(~young, NOC)
    del young
    # buf = max(every delivered candidate) cellwise, NOC where none: a cell
    # is accepted only where its candidate beats the own record, so buf
    # never holds a copy of the view plane; row n is a spare that takes the
    # rows delivering nothing now
    buf = vk.new_empty((n + 1, N))
    buf[n] = NOC
    recv_inf = vk.new_zeros((n + 1, R), dtype=torch.uint8)
    recv_src = vk.new_full((n + 1, R), -1, dtype=torch.int32)
    pend = None
    if D:
        buf[:n] = arriving_key
        recv_inf[:n] = arriving_inf
        recv_src[:n] = state.pending_src[slot_now]
        pend = (
            state.pending_key.view(D * n, N),
            bp.unpack_bits(state.pending_inf, R).to(torch.uint8).view(D * n, R),
            state.pending_src.view(D * n, R),
        )
    else:
        buf[:n] = NOC
    sent = torch.zeros((), dtype=torch.int32, device=dev)
    rumor_sent = torch.zeros((), dtype=torch.int32, device=dev)
    for s in range(F):
        p = peers[:, s].long()
        # the known-infected filter: not back to the peer that delivered a
        # rumor here, nor to its origin
        payload_r = rumor_pay & (state.infected_from != p[:, None]) & (state.rumor_origin[None, :] != p[:, None])
        ok = peer_valid[:, s] & (young_any | payload_r.any(dim=1)) & _edge_ok(state, rows, p, r.gossip_edge[:, s],
                                                                              up_all)
        sent = sent + _i32(ok)
        send_r = payload_r & ok[:, None]
        rumor_sent = rumor_sent + _i32(send_r)
        src_r = torch.where(send_r, grows32[:, None], -1)
        d = None
        if D:
            # per-edge delay d, P(d >= k) = q^k, capped at D - 1: sequential
            # f32 powers, no transcendental
            qd = _delay_q_at(state, rows, p)
            d = torch.zeros((n,), dtype=torch.int32, device=dev)
            qpow = qd
            for _ in range(1, D):
                d = d + (r.gossip_delay[:, s] < qpow)
                qpow = qpow * qd
            ok_now = ok & (d == 0)
        else:
            ok_now = ok
        if ctx is None:
            # the unsent rows fold into the spare row and the current slot
            dd = torch.where(ok, 0 if d is None else d, -1)
            _fold_rows(state, p, dd, piggyback, send_r.to(torch.uint8), src_r, buf, recv_inf, recv_src, pend)
        else:
            _deliver_rows(ctx, state, ok, p, d, piggyback, send_r, src_r, buf, recv_inf, recv_src, pend)
        if spec.wants_pull:
            s_m, r_m = _pull_reply(state, s, p, ok_now, piggyback, rumor_pay, buf, recv_inf, recv_src, NOC)
            sent = sent + s_m
            rumor_sent = rumor_sent + r_m
    del piggyback

    cols = torch.arange(N, device=dev)[None, :]
    dense_rt = state.fetch_rt.dim() != 0
    ns_all = _full(state.ns_id) if params.namespace_gate else None
    if adaptive:
        ev = _no_evidence(n, dev)
    for lo, hi in plane_chunks(n, N):
        own = vk[lo:hi]
        b = buf[lo:hi]
        accept = (b > own) & ((own >= 0) | ((b & 3) <= RANK_LEAVING)) & state.up[lo:hi, None]
        accept &= _fetch_gate(state, SALT_GOSSIP, grows[lo:hi, None], cols, b,
                              state.fetch_rt[lo:hi] if dense_rt else state.fetch_rt, up_all)
        if params.namespace_gate:
            accept &= state.ns_rel[state.ns_id[lo:hi, None].long(), ns_all[None, :].long()]
        if adaptive:
            sus_acc = accept & ((b & 3) == RANK_SUSPECT)
            ev["_ad_cnt"] = ev["_ad_cnt"] + sus_acc.sum(dim=0, dtype=torch.int32)
            ev["_ad_key"] = torch.maximum(
                ev["_ad_key"], torch.where(sus_acc, b.to(torch.int32), NO_CANDIDATE_I32).amax(dim=0))
            del sus_acc
        own.copy_(torch.where(accept, b, own))
        ca[lo:hi].masked_fill_(accept, state.tick)
    del buf

    newly = recv_inf[:n].bool() & ~inf_b & state.up[:, None] & state.rumor_active[None, :]
    state = state.replace(
        infected=bp.word_or(state.infected, bp.pack_bits(newly)),
        infected_at=torch.where(newly, state.tick, state.infected_at).to(torch.int32),
        # the highest delivering row: the compact known-infected set
        infected_from=torch.where(newly, recv_src[:n], state.infected_from),
    )
    if D:
        # the current slot is consumed
        state.pending_key[slot_now] = NOC
        pend_inf = pend[1]
        pend_inf.view(D, n, R)[slot_now] = 0
        state.pending_src[slot_now] = -1
        state.pending_inf.copy_(bp.pack_bits(pend_inf.view(D, n, R).bool()))
    m = {"gossip_msgs": sent, "rumor_sends": rumor_sent, "rumor_deliveries": _i32(newly)}
    if adaptive:
        m.update(ev)
    return state, m


def _deliver_rows(ctx, state: SimState, ok, p, d, piggyback, send_r, src_r, buf, recv_inf, recv_src, pend) -> None:
    """One fanout slot's messages on a member mesh: each sending row's record
    (its delay, ``piggyback`` row, rumor bits and sources) crosses to its
    receiver's rank in a row exchange per row chunk
    (:func:`.ragged_a2a.row_exchange`) and folds in there as on one device
    (:func:`_fold_rows`)."""
    n, N = state.capacity, _gcap(state)
    R = send_r.shape[1]
    keys = _words(piggyback)
    nw = keys.shape[1]
    delay = torch.zeros((n,), dtype=torch.int32, device=state.device) if d is None else d
    for lo, hi in plane_chunks(n, N):
        rec = torch.cat([delay[lo:hi, None], keys[lo:hi], send_r[lo:hi].to(torch.int32), src_r[lo:hi]], dim=1)
        row, got = ctx.row_exchange(rec, torch.where(ok[lo:hi], p[lo:hi], -1))
        del rec
        dd = got[:, 0]
        cand = got[:, 1:1 + nw].contiguous().view(piggyback.dtype)
        inf = got[:, 1 + nw:1 + nw + R].to(torch.uint8)
        src = got[:, 1 + nw + R:].contiguous()
        del got
        _fold_rows(state, row, dd, cand, inf, src, buf, recv_inf, recv_src, pend)


def _fold_rows(state: SimState, row, dd, cand, inf, src, buf, recv_inf, recv_src, pend) -> None:
    """Messages into their receivers' ``row`` by scatter-max: an on-time one
    (``dd`` 0) into ``buf`` / ``recv_inf`` / ``recv_src``, a late one into the
    rings' slot ``(tick + dd) % D``, never the current one. The other rows
    take ``buf``'s spare row n and the current slot, cleared after."""
    n = state.capacity
    now_idx = torch.where(dd == 0, row, n)
    index_amax_(buf, now_idx, cand)
    index_amax_(recv_inf, now_idx, inf)
    index_amax_(recv_src, now_idx, src)
    if pend is not None:
        D = pend[0].shape[0] // n
        late_idx = torch.where(dd > 0, ((state.tick + dd) % D) * n + row, (state.tick % D) * n + row)
        index_amax_(pend[0], late_idx, cand)
        index_amax_(pend[1], late_idx, inf)
        index_amax_(pend[2], late_idx, src)


def _pull_reply(state: SimState, s: int, p, ok_now, piggyback, rumor_pay, buf, recv_inf, recv_src, NOC: int):
    """The push-pull reply of fanout slot ``s`` (DZ-2): each undelayed
    contact (``ok_now``) answers over the same round trip, gated on one
    hashed draw on the reverse link, with the peer's young records (its
    ``piggyback`` row, gathered over row chunks; on a mesh fetched from the
    peer's rank) and its budgeted young rumors less those the sender is
    known to hold. Folded into ``buf``, ``recv_inf`` and ``recv_src`` in
    place, as the forward deliveries are (cellwise max and OR, so the order
    is moot). Returns (replies sent, rumor replies sent)."""
    n = state.capacity
    grows = _grows(state)
    grows32 = grows.to(torch.int32)
    rev_u = fetch_uniform(state.tick, dz.pull_salt(s), grows, p)
    rev_ok = ok_now & (rev_u < (1.0 - _link_at_rows(state.loss, p, grows)))
    # the rows without a reply ask for none (-1; on one device the last
    # row), and what they get is masked out
    want = torch.where(rev_ok, p, -1)
    for lo, hi in plane_chunks(n, _gcap(state)):
        got = _rows_at(piggyback, want[lo:hi])
        got.masked_fill_(~rev_ok[lo:hi, None], NOC)
        maximum_into_(buf[lo:hi], buf[lo:hi], got)
        del got
    R = rumor_pay.shape[1]
    small = _rows_at(torch.cat([rumor_pay.to(torch.int32), state.infected_from], dim=1), want)
    pay_p, from_p = small[:, :R].bool(), small[:, R:]
    reply_r = (
        pay_p
        & (from_p != grows32[:, None])
        & (state.rumor_origin[None, :] != grows32[:, None])
        & rev_ok[:, None]
    )
    recv_inf[:n] |= reply_r.to(torch.uint8)
    maximum_into_(recv_src[:n], recv_src[:n], torch.where(reply_r, p.to(torch.int32)[:, None], -1))
    return _i32(rev_ok), _i32(reply_r)


def _sync_phase(state: SimState, r: RoundRandoms, params: SimParams, adaptive: bool = False,
                trace: bool = False):
    """Anti-entropy: the ≤ K due callers (stagger slot or ``force_sync``, in
    ascending row order; the rest wait) each pick one peer from their live
    view plus the seeds; over a surviving (and, with the rings, timely)
    round trip the caller's row is merged into the peer's (callers on one
    peer merge together) and the peer's merged row back into the
    caller's. ``adaptive`` adds the accepted SUSPECT records of both
    directions as confirmation evidence; slots naming one peer recompute
    the same row, so the request side counts the first slot per peer.
    ``trace`` adds the compacted callers' outcomes (``trace_sync``).

    On a member mesh the callers are compacted over all N rows (the
    gathered ``due`` flags), so every rank runs the same K slots: the
    callers' and peers' [K, N] rows are fetched from their ranks (never the
    whole plane), the link cells are point reads, the draws the full
    blocks' callers' rows, and each rank writes the merged rows it holds.
    The K slots are the same on every rank, so the count is global."""
    N = _gcap(state)
    dev = state.device
    NOC = _noc(params)
    cols = torch.arange(N, device=dev)[None, :]
    rf = _full_draws(r)
    K = min(N, params.sync_slots or (N // params.sync_every + 32))
    due = ((state.tick + _grows(state) * params.sync_stagger) % params.sync_every) == 0
    due = _full((due | state.force_sync) & state.up)
    caller = nonzero_fixed(due, K, N)
    valid_c = caller < N
    caller = caller.clamp(max=N - 1)
    up_all = _full(state.up)

    vk, ca = state.view_key, state.changed_at
    caller_tables = _rows_at(vk, caller)  # [K, N]
    cand = (caller_tables & 3) != RANK_DEAD
    if params.seed_rows:
        seeds = _seed_rows_tensor(tuple(params.seed_rows), dev).long()
        cand |= torch.zeros((N,), dtype=torch.bool, device=dev).index_fill_(0, seeds, True)[None, :]
    cand &= cols != caller[:, None]
    u = rf.sync_sel[caller][:, None]
    if _packed(params):
        peer_idx, peer_valid = _sample_distinct_words(bp.pack_bits(cand), N, u)
    else:
        peer_idx, peer_valid = _sample_distinct(cand, u)
    peer = peer_idx[:, 0].long()
    p_rt = _link_at_rows(state.fetch_rt, caller, peer)
    if params.delay_slots:
        p_rt = p_rt * _timely_rt(_link_at_rows(state.delay_q, caller, peer), _link_at_rows(state.delay_q, peer, caller),
                                 params.sync_timeout_ticks)
    ok = valid_c & peer_valid[:, 0] & up_all[peer] & (rf.sync_edge[caller] < p_rt)
    dense_rt = state.fetch_rt.dim() != 0
    rt_rows = _rows_at(state.fetch_rt, torch.cat([peer, caller])) if dense_rt else None
    ns_all = _full(state.ns_id) if params.namespace_gate else None

    # SYNC request: each peer row merges the max of its callers' rows; slots
    # naming one peer compute the same row, so the row write is exact
    own_p = _rows_at(vk, peer)
    dup_to_first = first_true(peer[:, None] == peer[None, :], 1)
    merged = caller_tables.new_full((K, N), NOC)
    index_amax_(merged, dup_to_first, caller_tables.masked_fill(~ok[:, None], NOC))
    del caller_tables
    buf_p = torch.maximum(own_p, merged[dup_to_first])
    del merged
    acc = (
        (buf_p > own_p)
        & ((own_p >= 0) | ((buf_p & 3) <= RANK_LEAVING))
        & up_all[peer][:, None]
        & _fetch_gate(state, SALT_SYNC_REQ, peer[:, None], cols, buf_p,
                      rt_rows[:K] if dense_rt else state.fetch_rt, up_all)
    )
    if params.namespace_gate:
        acc &= state.ns_rel[ns_all[peer][:, None].long(), ns_all[None, :].long()]
    _write_rows_amax_(vk, peer, torch.where(acc, buf_p, own_p), NOC)
    _write_rows_amax_(ca, peer, torch.where(acc, state.tick, NEVER).to(torch.int32), NEVER)
    if adaptive:
        karange = torch.arange(K, device=dev)
        peer_eff = torch.where(ok, peer, -1 - karange)
        first_p = ok & (first_true(peer_eff[:, None] == peer_eff[None, :], 1) == karange)
        m_req = acc & first_p[:, None] & ((buf_p & 3) == RANK_SUSPECT)
        req_key = torch.where(m_req, buf_p.to(torch.int32), NO_CANDIDATE_I32).amax(dim=0)
        ad_cnt = m_req.sum(dim=0, dtype=torch.int32)
        del m_req
    req_n = acc.sum(dim=1, dtype=torch.int32) if trace else None
    del buf_p, own_p, acc

    # SYNC_ACK: the peer's merged row back into the caller's
    both = _rows_at(vk, torch.cat([peer, caller]))
    ack_cand = both[:K].masked_fill(~ok[:, None], NOC)
    own_rows = both[K:]
    del both
    accept = (
        (ack_cand > own_rows)
        & ((own_rows >= 0) | ((ack_cand & 3) <= RANK_LEAVING))
        & up_all[caller][:, None]
        & _fetch_gate(state, SALT_SYNC_ACK, caller[:, None], cols, ack_cand,
                      rt_rows[K:] if dense_rt else state.fetch_rt, up_all)
    )
    if params.namespace_gate:
        accept &= state.ns_rel[ns_all[caller][:, None].long(), ns_all[None, :].long()]
    _write_rows_amax_(vk, caller, torch.where(accept, ack_cand, own_rows), NOC)
    _write_rows_amax_(ca, caller, torch.where(accept, state.tick, NEVER).to(torch.int32), NEVER)

    # a joiner's bootstrap SYNC retries every tick until a round trip lands
    ok_full = scatter_reduce_1d(N, caller, ok, "amax", 0, torch.int32) > 0
    state = state.replace(force_sync=state.force_sync & ~_mine(ok_full))
    metrics = {"sync_roundtrips": _i32(ok)}
    if adaptive:
        m_ack = accept & ((ack_cand & 3) == RANK_SUSPECT)
        metrics["_ad_cnt"] = ad_cnt + m_ack.sum(dim=0, dtype=torch.int32)
        metrics["_ad_key"] = torch.maximum(
            req_key, torch.where(m_ack, ack_cand.to(torch.int32), NO_CANDIDATE_I32).amax(dim=0)
        )
    if trace:
        metrics["trace_sync"] = _sync_trace(caller, valid_c, peer, ok, req_n, accept.sum(dim=1, dtype=torch.int32))
    return state, metrics


def _refute_phase(state: SimState):
    """An up node that finds itself SUSPECT or DEAD (or whose leave intent
    was overwritten) re-announces ALIVE (LEAVING for a leaver) at the next
    incarnation, saturating in the narrow layout; written on the diagonal
    in place, re-stamped. Returns (state, the refuting rows) — the
    adaptive plane's lh evidence."""
    diag_view = _diag(state.view_key)
    diag = diag_view.clone()
    rank = diag & 3
    need = state.up & (
        (rank == RANK_SUSPECT) | (rank == RANK_DEAD) | (state.leaving & (rank != RANK_LEAVING))
    )
    announce_rank = torch.where(state.leaving, RANK_LEAVING, RANK_ALIVE)
    diag_view.copy_(torch.where(need, bump_inc(diag, announce_rank), diag))
    stamp = _diag(state.changed_at)
    stamp.copy_(torch.where(need, state.tick, stamp))
    return state, need


def _rumor_sweep(state: SimState, params: SimParams, inf_b: torch.Tensor, n_up: torch.Tensor) -> SimState:
    """Reclaim a rumor slot once its creation window has passed, no copy is
    in flight in the rings, and no up receiver is inside its own forwarding
    window. ``inf_b``/``n_up``: the infection bits and up-count the metrics
    share (the JAX fused tick's hand-off)."""
    sweep = 2 * (params.repeat_mult * ceil_log2(n_up) + 1)
    keep = (state.tick - state.rumor_created) <= sweep
    spread = params.repeat_mult * ceil_log2(_sizes(state, params))
    # on a mesh a rumor some rank still forwards, or holds in flight, stays
    # on every rank (the slots are replicated)
    keep |= _reduce((inf_b & state.up[:, None] & ((state.tick - state.infected_at) < spread[:, None])).any(dim=0),
                    "max")
    if params.delay_slots:
        keep |= _reduce(bp.unpack_bits(state.pending_inf, params.rumor_slots).flatten(0, 1).any(dim=0), "max")
    return state.replace(rumor_active=state.rumor_active & keep)


def state_metrics(state: SimState, params: SimParams, inf_b: torch.Tensor, n_up: torch.Tensor) -> dict:
    """The tick's health metrics: up count, the alive-view fraction and
    false-suspect pairs over up pairs (``full_metrics``; over row chunks,
    int32), per-rumor coverage, the worst gossip segmentation."""
    n = state.capacity
    N = _gcap(state)
    dev = state.device
    if params.full_metrics:
        cols = torch.arange(N, device=dev)
        grows = _grows(state)
        up_all = _full(state.up)
        alive = torch.zeros((), dtype=torch.int32, device=dev)
        suspect = torch.zeros((), dtype=torch.int32, device=dev)
        for lo, hi in plane_chunks(n, N):
            rank = state.view_key[lo:hi] & 3
            pair = state.up[lo:hi, None] & up_all[None, :] & (grows[lo:hi, None] != cols[None, :])
            alive = alive + (pair & (rank == RANK_ALIVE)).sum(dtype=torch.int32)
            suspect = suspect + (pair & (rank == RANK_SUSPECT)).sum(dtype=torch.int32)
        if sharding.active() is not None:
            alive, suspect = _reduce(torch.stack([alive, suspect]).to(torch.int64), "sum").to(torch.int32).unbind(0)
        pairs = (n_up * n_up - n_up).clamp(min=1)
        alive_frac = alive.to(torch.float32) / pairs.to(torch.float32)
    else:
        alive_frac = torch.zeros((), dtype=torch.float32, device=dev)
        suspect = torch.zeros((), dtype=torch.int32, device=dev)
    coverage = _reduce((inf_b & state.up[:, None]).sum(dim=0, dtype=torch.int32), "sum").to(torch.float32) / (
        n_up.clamp(min=1).to(torch.float32)
    )
    newest = torch.where(inf_b, state.rumor_created[None, :], NEVER).amax(dim=1)
    seg = (
        state.rumor_active[None, :]
        & ~inf_b
        & (state.rumor_created[None, :] < newest[:, None])
        & state.up[:, None]
    ).sum(dim=1, dtype=torch.int32)
    return {
        "n_up": n_up,
        "alive_view_fraction": alive_frac,
        "false_suspect_pairs": suspect,
        "rumor_coverage": coverage,
        "gossip_segmentation": _reduce(seg.max(), "max"),
    }


# -- tick + window -------------------------------------------------------------------


_FD_METRICS = ("fd_probes", "fd_failed_probes", "fd_new_suspects")

#: the per-row counts a member mesh sums over its ranks
_ROW_SUMS = _FD_METRICS + _GOSSIP_METRICS


def tick(state: SimState, fd_r, round_r: RoundRandoms, params: SimParams, trace=None, ad=None, timer=None):
    """One gossip period for all N members: FD (every ``fd_every`` ticks)
    → suspicion sweep → gossip → SYNC → refute → rumor sweep → metrics.
    ``fd_r`` is read only on FD ticks (``tick % fd_every == 0`` after the
    increment) and may be None otherwise. Consumes ``state``; returns
    ``(state, metrics)``.

    ``ad`` (an :class:`..adaptive.AdaptiveState`, with an enabled
    ``params.adaptive``) arms the adaptive plane: the phases run their
    adaptive spellings, the evidence folds into the plane at the end of
    the tick, the metrics gain the ``adaptive_lh_high`` /
    ``adaptive_conf_high`` gauges, and the return is ``(state, ad',
    metrics)``.

    ``trace`` (a :class:`..trace.schema.TraceSpec`) arms the causal trace
    capture: the metrics gain a ``_trace_rows`` [K, n_fields] int32 block
    built from the phases' own [N]-sized internals, which never feed back
    into the state, so the trajectory is the unarmed one, bit for bit. A
    skipped phase yields the zero record the JAX tick's skip branch does.
    ``timer`` (the phase-split profiler's, :mod:`..trace.profile`) scopes
    each phase."""
    armed = ad is not None
    ctx = sharding.active()
    if ctx is not None and (armed or trace is not None):
        raise ValueError("the dense engine's sharded tick runs unarmed: JAX has no sharded adaptive or traced "
                         "dense window (make_sharded_adaptive_run, make_sharded_traced_run)")
    if armed and trace is not None:
        raise ValueError(
            "trace-armed adaptive windows are not supported — run the trace plane on a "
            "static-FD driver, or drop arm_trace"
        )
    if armed and params.adaptive.is_default:
        raise ValueError(
            "adaptive tick needs an enabled AdaptiveSpec on params "
            "(params.adaptive = AdaptiveSpec(enabled=True, ...))"
        )
    traced = trace is not None
    state = state.replace(tick=state.tick + 1)
    n = state.capacity
    fd_ran = state.tick % params.fd_every == 0
    with _phase(timer, "fd"):
        if fd_ran:
            if fd_r is None:
                raise ValueError(f"tick {state.tick} runs the FD round and needs FD draws")
            state, fd_m = _fd_phase(state, fd_r, params, ad=ad, trace=traced)
        else:
            z = torch.zeros((), dtype=torch.int32, device=state.device)
            fd_m = {k: z for k in _FD_METRICS}
            if armed:
                fd_m.update(_no_evidence(n, state.device, probes=True))
            if traced:
                from ..trace import capture as _tc

                fd_m["trace_fd"] = _tc.zero_fd_trace(n, params.ping_req_k, state.device)
    with _phase(timer, "suspicion"):
        if params.quiet_gates:
            has_suspect, busy = host_flags(*_gate_flags(state, params))
            busy = busy or has_suspect
        else:
            has_suspect = busy = True
        if traced:
            state, trace_sus = _suspicion_phase(state, params, has_suspect, trace=trace)
        else:
            state = _suspicion_phase(state, params, has_suspect, ad=ad)
    with _phase(timer, "gossip"):
        state, g_m = _gossip_phase(state, round_r, params, busy, adaptive=armed)
    with _phase(timer, "sync"):
        state, s_m = _sync_phase(state, round_r, params, adaptive=armed, trace=traced)
    with _phase(timer, "refute"):
        state, refuted = _refute_phase(state)
    with _phase(timer, "sweep"):
        inf_b = bp.unpack_bits(state.infected, params.rumor_slots)
        n_up = _i32(state.up) if ctx is None else _reduce(state.up.sum(), "sum").to(torch.int32)
        state = _rumor_sweep(state, params, inf_b, n_up)
    trace_fd = fd_m.pop("trace_fd", None)
    trace_sync = s_m.pop("trace_sync", None)
    with _phase(timer, "telemetry"):
        if armed:
            ad = _fold_evidence(params, ad, fd_m, g_m, s_m, refuted, state.up)
        metrics = {**fd_m, **g_m, **s_m, **state_metrics(state, params, inf_b, n_up)}
        if ctx is not None:
            # the rows' counts, summed over the ranks in one collective
            total = _reduce(torch.stack([metrics[k].to(torch.int64) for k in _ROW_SUMS]), "sum")
            metrics.update(zip(_ROW_SUMS, total.to(torch.int32).unbind(0)))
        if armed:
            metrics["adaptive_lh_high"] = ad.lh.max()
            metrics["adaptive_conf_high"] = ad.conf.max()
            return state, ad, metrics
        if traced:
            from ..trace import capture as _tc

            metrics["_trace_rows"] = _tc.build_trace_rows(
                trace, tick=state.tick, up=state.up, fd_ran=fd_ran,
                trace_fd=trace_fd, trace_sus=trace_sus,
                trace_ref=refuted[_tc.tracer_index(trace, state.device)], trace_sync=trace_sync,
                infected_b=inf_b, infected_at=state.infected_at, infected_from=state.infected_from,
            )
    return state, metrics


def _fold_evidence(params, ad, fd_m: dict, g_m: dict, s_m: dict, refuted, up):
    """Pop the phases' ``_ad_*`` evidence out of their metrics and fold it
    into the adaptive plane (:func:`..adaptive.fold`) — shared by the three
    engines' ticks."""
    acc_cnt = fd_m.pop("_ad_cnt") + g_m.pop("_ad_cnt") + s_m.pop("_ad_cnt")
    acc_key = torch.maximum(torch.maximum(fd_m.pop("_ad_key"), g_m.pop("_ad_key")), s_m.pop("_ad_key"))
    lh, conf_key, conf = _adp.fold(
        params.adaptive, ad.lh, ad.conf_key, ad.conf,
        acc_key=acc_key, acc_cnt=acc_cnt, miss=fd_m.pop("_ad_miss"), succ=fd_m.pop("_ad_succ"),
        refuted=refuted, up=up,
    )
    return _adp.AdaptiveState(lh=lh, conf_key=conf_key, conf=conf)


def run_ticks(state: SimState, draws, n_ticks: int, params: SimParams, watch_rows=None):
    """Run ``n_ticks`` ticks; consumes ``state`` (:func:`._tick.run_window`:
    ``draws`` is a ``torch.Generator`` on the state's device or ``n_ticks``
    ``(fd, round)`` draw pairs). Returns ``(state, metrics stacked to
    [n_ticks], watched)``; ``watched`` is the [n_ticks, W, N] view rows of
    ``watch_rows`` after each tick, or None."""
    from ._tick import run_window

    return run_window(tick, view_rows, draw_dense_tick, state, draws, n_ticks, params, watch_rows)


def make_run(params: SimParams, n_ticks: int):
    """The window as a callable ``run(state, draws, watch_rows=None)`` — the
    counterpart of the JAX function of the same name."""

    def run(state: SimState, draws, watch_rows=None):
        return run_ticks(state, draws, n_ticks, params, watch_rows)

    return run


def run_ticks_adaptive(state: SimState, ad, draws, n_ticks: int, params: SimParams, watch_rows=None):
    """:func:`run_ticks` with the adaptive plane ``ad`` threaded through the
    window; the same draws. Returns ``(state, ad, metrics, watched)``."""
    from ._tick import run_window

    return run_window(tick, view_rows, draw_dense_tick, state, draws, n_ticks, params, watch_rows, ad=ad)


def make_adaptive_run(params: SimParams, n_ticks: int):
    """The adaptive window as a callable ``run(state, ad, draws,
    watch_rows=None)``. Refuses a default spec: :func:`make_run` is that
    window."""
    if params.adaptive.is_default:
        raise ValueError(
            "make_adaptive_run needs an enabled AdaptiveSpec on params — the default spec's "
            "window is make_run's"
        )

    def run(state: SimState, ad, draws, watch_rows=None):
        return run_ticks_adaptive(state, ad, draws, n_ticks, params, watch_rows)

    return run


def run_ticks_traced(state: SimState, ring, draws, n_ticks: int, params: SimParams, trace, watch_rows=None):
    """Trace-armed :func:`run_ticks`: the same window with each tick's
    [K, n_fields] record block appended in place to ``ring`` (a
    :class:`..trace.rings.TraceRing`) at its host cursor. The draws and
    every state op are the unarmed window's, so the trajectory is too.
    Returns ``(state, metrics, watched)``."""
    from ._tick import run_window

    return run_window(tick, view_rows, draw_dense_tick, state, draws, n_ticks, params, watch_rows,
                      trace=trace, ring=ring)


def make_traced_run(params: SimParams, n_ticks: int, trace):
    """The traced window as a callable ``run(state, ring, draws,
    watch_rows=None)``; refuses an armed adaptive spec (the JAX traced
    tick's refusal)."""
    if not params.adaptive.is_default:
        raise ValueError("trace-armed adaptive windows are not supported")
    def run(state: SimState, ring, draws, watch_rows=None):
        return run_ticks_traced(state, ring, draws, n_ticks, params, trace, watch_rows)

    return run


def make_fleet_run(params: SimParams, n_ticks: int):
    """The fleet window (:mod:`.fleet`): ``run(fleet_state, draws,
    watch_rows=None) -> (fleet_state, metrics [S, T], watched)``, every
    scenario's tick one vmapped call per tick."""
    from .fleet import make_fleet_window

    return make_fleet_window(tick, view_rows, draw_dense_tick, params, n_ticks)


def make_fleet_adaptive_run(params: SimParams, n_ticks: int):
    """The adaptive fleet window: ``run(fleet_state, ad, draws,
    watch_rows=None) -> (fleet_state, ad, metrics, watched)``, ``ad`` the
    adaptive state stacked to [S, N]. Refuses a default spec."""
    from .fleet import make_fleet_window

    return make_fleet_window(tick, view_rows, draw_dense_tick, params, n_ticks, adaptive=True)


# The JAX names of the fused windows: the same runners.
run_ticks_fused = run_ticks
make_fused_run = make_run
run_ticks_fused_adaptive = run_ticks_adaptive
make_fused_adaptive_run = make_adaptive_run
make_fused_fleet_run = make_fleet_run


#: the adaptive plane's window gauges, under the JAX telemetry series' names
ADAPTIVE_GAUGES = ("adaptive_lh_max", "adaptive_conf_max")


def adaptive_gauges(ms: dict) -> dict:
    """The worst local-health score and the deepest confirmation count of a
    window's stacked metrics, as float32 scalars (0 for a static window):
    the last two columns of the JAX package's telemetry series."""
    out = {}
    for name, key in zip(ADAPTIVE_GAUGES, ("adaptive_lh_high", "adaptive_conf_high")):
        out[name] = ms[key].max().to(torch.float32) if key in ms else torch.zeros((), dtype=torch.float32)
    return out


# -- chaos sentinels -------------------------------------------------------------------


# Per-window telemetry series (the metric ring's column layout, the
# ``/metrics`` contract): reductions over a window's stacked metrics and the
# post-window state, on the device, with no transfer.
TELEMETRY_SERIES = (
    "tick",  # window-end tick
    "window_ticks",
    "n_up",
    "fd_probes",
    "fd_failed_probes",
    "fd_new_suspects",
    "gossip_msgs",
    "rumor_sends",
    "rumor_deliveries",
    "sync_roundtrips",
    "gossip_segmentation_max",
    "rumor_coverage_mean",  # over ACTIVE slots, at window end
    "rumor_coverage_min",
    "rumor_active_slots",
    "alive_view_fraction",  # 0 when params.full_metrics is off
    "false_suspect_pairs_max",
    "convergence_lag",  # 1 - alive_view_fraction (meaningful iff full_metrics)
    "adaptive_lh_max",  # 0 on static-FD windows
    "adaptive_conf_max",
)

#: window metrics reduced by SUM into the telemetry vector (counters);
#: everything else is a max or an end-of-window gauge.
_TELEM_SUMS = (
    "fd_probes", "fd_failed_probes", "fd_new_suspects", "gossip_msgs",
    "rumor_sends", "rumor_deliveries", "sync_roundtrips",
)


def _f32(value: float, device) -> torch.Tensor:
    """A 0-d f32 device scalar made by a fill (a Python number copied onto
    the card would wait for it)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def telemetry_window_core(ms: dict, state) -> list:
    """The engine-shared prefix of the telemetry window vector (every
    series of :data:`TELEMETRY_SERIES`) as a list of 0-d f32 tensors.
    ``ms`` is a window's stacked per-tick metrics (each leaf ``[n_ticks,
    ...]``), ``state`` the post-window state; the host tick enters by a
    fill, everything else is a reduction on the device."""
    f32 = torch.float32
    dev = state.up.device
    n_ticks = next(iter(ms.values())).shape[0]
    cov = ms["rumor_coverage"][-1]  # [R], end of window
    active = state.rumor_active
    n_active = active.sum().clamp(min=1)
    alive_frac = ms["alive_view_fraction"][-1].to(f32)
    zero = _f32(0.0, dev)
    return [
        _f32(float(state.tick), dev),
        _f32(float(n_ticks), dev),
        ms["n_up"][-1].to(f32),
        *(ms[name].sum().to(f32) for name in _TELEM_SUMS),
        ms["gossip_segmentation"].max().to(f32),
        (torch.where(active, cov, 0.0).sum() / n_active).to(f32),
        torch.where(active.any(), torch.where(active, cov, float("inf")).min(), 0.0).to(f32),
        active.sum().to(f32),
        alive_frac,
        ms["false_suspect_pairs"].max().to(f32),
        (1.0 - alive_frac).to(f32),
        ms["adaptive_lh_high"].max().to(f32) if "adaptive_lh_high" in ms else zero,
        ms["adaptive_conf_high"].max().to(f32) if "adaptive_conf_high" in ms else zero,
    ]


def telemetry_window_vector(ms: dict, state: SimState) -> torch.Tensor:
    """Dense-engine telemetry row: one [len(TELEMETRY_SERIES)] f32 vector
    per window, appended to the device metric ring by the telemetry
    plane."""
    return torch.stack(telemetry_window_core(ms, state))


def sentinel_core(view_key: torch.Tensor, up: torch.Tensor, tick: int, sent: dict, spec: dict) -> dict:
    """One chaos-sentinel check over the [N, N] view plane (the dense and
    sparse engines share it; :mod:`..chaos.sentinels` has the semantics):
    self-key regressions, the largest count of never-faulted (and of
    watched degraded) up subjects some up observer holds DEAD, each
    crashed row's first tick seen DEAD by every up observer, each recovery
    boundary's first tick with every up pair ALIVE. Tensor reductions over
    row chunks, no transfer; ``tick`` is the state's host int. Returns the
    updated accumulators (a new dict). On a member mesh each rank checks
    its observer rows and the checks combine over the ranks (per-subject
    tables by MAX, the all-of tests by MIN, the counts summed); ``prev_diag``
    holds the rank's own rows."""
    ctx = sharding.active()
    rows, n = view_key.shape
    dev = view_key.device
    rel = tick - spec["t0"]  # scenario-relative (a host int or a 0-d tensor)
    diag = _diag(view_key).clone()
    sent = dict(sent)
    sent["key_regressions"] = sent["key_regressions"] + _reduce(
        (diag < sent["prev_diag"]).sum(dtype=torch.int32), "sum")
    sent["prev_diag"] = diag

    up_all = _full(up)
    watch = {"false_dead_max": spec["never_faulted"] & up_all}
    if "fp_watch" in spec:
        watch["fp_dead_max"] = spec["fp_watch"] & up_all
    dead_of = {k: torch.zeros((n,), dtype=torch.bool, device=dev) for k in watch}
    crash_rows = spec["crash_rows"]
    has_crash = crash_rows.shape[0] > 0
    has_conv = spec["conv_from"].shape[0] > 0
    ids = torch.arange(n, device=dev)
    gids = ids[:rows] if ctx is None else ids[ctx.lo:ctx.hi]
    if has_crash:
        crash_l = crash_rows.long()
        detected = torch.ones(crash_rows.shape, dtype=torch.bool, device=dev)
    if has_conv:
        converged = torch.ones((), dtype=torch.bool, device=dev)
    for lo, hi in plane_chunks(rows, n):
        blk = view_key[lo:hi]
        rank = blk & 3  # UNKNOWN (-1) reads rank 3
        up_r = up[lo:hi, None]
        tomb = (blk >= 0) & (rank == RANK_DEAD) & up_r
        for k, w in watch.items():
            dead_of[k] |= (tomb & w[None, :]).any(dim=0)
        del tomb
        if has_crash:
            others_up = up_r & (gids[lo:hi, None] != crash_l[None, :])
            detected &= (~others_up | (rank[:, crash_l] == RANK_DEAD)).all(dim=0)
        if has_conv:
            up2 = up_r & up_all[None, :] & (gids[lo:hi, None] != ids[None, :])
            converged &= (~up2 | (rank == RANK_ALIVE)).all()
    if has_crash:
        detected = _reduce(detected, "min")
    if has_conv:
        converged = _reduce(converged, "min")
    for k in watch:
        sent[k] = torch.maximum(sent[k], _reduce(dead_of[k], "max").sum(dtype=torch.int32))
    if has_crash:
        active = (rel >= spec["crash_at"]) & (rel <= spec["crash_until"]) & (sent["detect_tick"] < 0)
        sent["detect_tick"] = torch.where(active & detected, rel, sent["detect_tick"]).to(torch.int32)
    if has_conv:
        active = (rel >= spec["conv_from"]) & (sent["conv_tick"] < 0)
        sent["conv_tick"] = torch.where(active & converged, rel, sent["conv_tick"]).to(torch.int32)
    return sent


def sentinel_reduce(state: SimState, sent: dict, spec: dict) -> dict:
    """Dense-engine chaos sentinel check (see :func:`sentinel_core`)."""
    return sentinel_core(state.view_key, state.up, state.tick, sent, spec)
