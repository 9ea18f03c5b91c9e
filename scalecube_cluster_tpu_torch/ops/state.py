"""The dense engine's parameters, state, initial state and host mutators,
and the constants, delay conversion and namespace tables every engine
shares. A port of the JAX package's ``ops/state.py``; the JAX module's
docstrings carry the protocol account (the packed-key view plane, the
derived ``fetch_rt``, the geometric link-delay model and its rings).

What differs from the JAX spelling, and why:

* ``tick`` is a host int, the other leaves are tensors on one device.
* The [N, N] planes (``view_key``, ``changed_at``, ``loss``, ``fetch_rt``,
  ``delay_q``) and the [D, N, ·] pending rings are updated IN PLACE by the
  host mutators and by the tick: a state handed to either is consumed, as
  the JAX driver's donated windows consume theirs. The small leaves are
  replaced, as in JAX.
* The packed infection words (``infected``, ``pending_inf``) are the JAX
  uint32 words stored as int32, same bits (:mod:`.bitplane`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..adaptive import AdaptiveSpec
from ..dissemination.spec import DissemSpec
from ._tensor import in_fleet, maximum_into_, plane_chunks
from .bitplane import clear_col, set_bit, unpack_bits, words_for
from .lattice import (
    ALIVE,
    RANK_DEAD,
    RANK_LEAVING,
    RANK_SUSPECT,
    UNKNOWN_KEY,
    bump_inc,
    key_dtype,
    key_inc,
    key_status,
    no_candidate,
    precedence_key,
)

ALIVE0_KEY = 0  # precedence key of ALIVE, incarnation 0, epoch 0
NEVER = -(1 << 30)  # "changed long ago" sentinel for *_since / *_at leaves
NO_CANDIDATE_I32 = int(np.iinfo(np.int32).min)  # scatter-max identity


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static parameters of the dense tick — the JAX package's
    ``SimParams``. ``dissem`` is the dissemination strategy/topology
    (:mod:`..dissemination`; the default is push over the full topology,
    the engine's own sampler); ``adaptive`` the adaptive failure-detection
    spec (:mod:`..adaptive`; the default is the static program). ``delay_slots`` (D) is
    the pending-delivery ring depth (0: no delay, no rings); the
    ``*_timeout_ticks`` budgets feed the delay model's timeliness factors;
    ``sync_slots`` caps the SYNC callers per tick (0: N / sync_every + 32);
    ``key_dtype`` "i16" stores the narrow key plane and runs the
    word-packed samplers and counts; ``quiet_gates`` lets the tick skip
    work that would change nothing."""

    capacity: int
    fanout: int = 3
    repeat_mult: int = 3
    ping_req_k: int = 3
    fd_every: int = 5
    sync_every: int = 150
    sync_stagger: int = 1
    delay_slots: int = 0
    fd_direct_timeout_ticks: int = 2
    fd_leg_timeout_ticks: int = 1
    sync_timeout_ticks: int = 15
    sync_slots: int = 0
    suspicion_mult: int = 5
    rumor_slots: int = 64
    full_metrics: bool = True
    namespace_gate: bool = False
    seed_rows: tuple = ()
    key_dtype: str = "i32"
    quiet_gates: bool = True
    dissem: DissemSpec = DissemSpec()
    adaptive: AdaptiveSpec = AdaptiveSpec()

    @staticmethod
    def from_config(config, capacity: int | None = None, initial_size: int | None = None,
                    seed_rows: tuple = (0,)) -> "SimParams":
        """Kernel params from a ``ClusterConfig`` (one tick = one
        ``sim.tick_interval``). Capacity: ``capacity`` > ``config.sim
        .capacity`` > ``initial_size``."""
        from ..config import tick_units

        return SimParams(key_dtype=config.sim.plane_dtype, dissem=DissemSpec.from_config(config),
                         adaptive=AdaptiveSpec.from_config(config),
                         **tick_units(config, capacity, initial_size, seed_rows))


@dataclasses.dataclass
class SimState:
    """Dense simulation state: the JAX ``SimState``'s leaves as tensors on
    one device (same names; the packed infection words as int32), with
    ``tick`` a host int.

    ``view_key[i, j]`` is node i's record of j as the packed precedence key
    (-1 unknown); ``changed_at[i, j]`` the tick it last changed (the
    gossip age, and the suspicion start of a SUSPECT cell);
    ``loss``/``fetch_rt``/``delay_q`` are [N, N] planes (``dense_links``)
    or scalars; ``pending_*`` the [D, N, ·] delayed-delivery rings."""

    tick: int
    up: torch.Tensor  # bool [N]
    epoch: torch.Tensor  # i32 [N]
    view_key: torch.Tensor  # i32/i16 [N, N]
    changed_at: torch.Tensor  # i32 [N, N]
    force_sync: torch.Tensor  # bool [N]
    leaving: torch.Tensor  # bool [N]
    ns_id: torch.Tensor  # i32 [N]
    ns_rel: torch.Tensor  # bool [G, G]
    rumor_active: torch.Tensor  # bool [R]
    rumor_origin: torch.Tensor  # i32 [R]
    rumor_created: torch.Tensor  # i32 [R]
    infected: torch.Tensor  # i32 [N, ceil(R/32)] packed words
    infected_at: torch.Tensor  # i32 [N, R]
    infected_from: torch.Tensor  # i32 [N, R]
    loss: torch.Tensor  # f32 [N, N] or scalar
    fetch_rt: torch.Tensor  # f32 [N, N] or scalar
    delay_q: torch.Tensor  # f32 [N, N] or scalar
    pending_key: torch.Tensor  # i32/i16 [D, N, N]
    pending_inf: torch.Tensor  # i32 [D, N, ceil(R/32)] packed words
    pending_src: torch.Tensor  # i32 [D, N, R]

    #: leaves the JAX package stores as uint32 words (same bits)
    U32_LEAVES = ("infected", "pending_inf")

    @property
    def capacity(self) -> int:
        return self.up.shape[-1]

    @property
    def rumor_slots(self) -> int:
        return self.rumor_origin.shape[0]

    @property
    def device(self) -> torch.device:
        return self.up.device

    @property
    def infected_bool(self) -> torch.Tensor:
        """bool [N, R] view of the packed infection words."""
        return unpack_bits(self.infected, self.rumor_slots)

    @property
    def pending_inf_bool(self) -> torch.Tensor:
        """bool [D, N, R] view of the packed pending-infection ring."""
        return unpack_bits(self.pending_inf, self.rumor_slots)

    @property
    def view_status(self) -> torch.Tensor:
        """Decoded int8 status plane (UNKNOWN where no record)."""
        return key_status(self.view_key)

    @property
    def view_inc(self) -> torch.Tensor:
        """Decoded int32 incarnation plane (0 where no record)."""
        return key_inc(self.view_key)

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


def delay_mean_to_q(mean_delay_ticks: float) -> float:
    """Exponential mean delay (in ticks) -> geometric parameter q (f32),
    computed on the host: the delay model's one transcendental."""
    if mean_delay_ticks <= 0:
        return 0.0
    return float(np.float32(np.exp(np.float32(-1.0 / mean_delay_ticks))))


def build_namespace_tables(namespaces):
    """Per-row namespace strings -> (ns_id [N] int32, ns_rel [G, G] bool),
    numpy, by the reference's prefix-hierarchy relatedness."""
    from ..utils.namespaces import are_namespaces_related

    uniq = sorted(set(namespaces))
    gid = {ns: g for g, ns in enumerate(uniq)}
    ids = np.asarray([gid[ns] for ns in namespaces], np.int32)
    g = len(uniq)
    rel = np.zeros((g, g), bool)
    for a in uniq:
        for b in uniq:
            rel[gid[a], gid[b]] = are_namespaces_related(a, b)
    return ids, rel


def init_state(
    params: SimParams,
    n_initial: int,
    warm: bool = True,
    dense_links: bool = True,
    uniform_loss: float = 0.0,
    uniform_delay: float = 0.0,
    namespaces=None,
    device="cuda",
) -> SimState:
    """Fresh dense simulation on ``device`` with rows ``0..n_initial-1``
    up. ``warm``: every up row knows every up row ALIVE (within its
    namespace hierarchy when ``namespaces`` is given); cold rows know only
    themselves. ``dense_links=False`` keeps loss and delay as one scalar
    each. ``uniform_delay`` is the mean link delay in ticks and needs
    ``params.delay_slots > 0``, which in turn needs ``dense_links``."""
    n, r = params.capacity, params.rumor_slots
    kd = key_dtype(params.key_dtype)
    i32, f32 = torch.int32, torch.float32
    if uniform_delay > 0 and params.delay_slots <= 0:
        raise ValueError("uniform_delay > 0 requires params.delay_slots > 0")
    if params.delay_slots > 0 and not dense_links:
        raise ValueError(
            "delay_slots > 0 allocates [D, N, N] pending rings, which defeats "
            "the lean dense_links=False mode — use the dense regime for the "
            "delay emulator, or delay_slots=0 at large N"
        )
    up = torch.arange(n, device=device) < n_initial
    view_key = torch.full((n, n), UNKNOWN_KEY, dtype=kd, device=device)
    if namespaces is not None:
        ids_np, rel_np = build_namespace_tables(list(namespaces))
        ns_id = torch.as_tensor(ids_np, device=device)
        ns_rel = torch.as_tensor(rel_np, device=device)
    else:
        ns_id = torch.zeros((n,), dtype=i32, device=device)
        ns_rel = torch.ones((1, 1), dtype=torch.bool, device=device)
    diag = torch.arange(n_initial, device=device)
    if warm and namespaces is not None:
        cols = torch.arange(n, device=device)
        for lo, hi in plane_chunks(n, n):
            related = ns_rel[ns_id[lo:hi, None].long(), ns_id[None, :].long()] | (
                cols[lo:hi, None] == cols[None, :]
            )
            view_key[lo:hi].masked_fill_(up[lo:hi, None] & up[None, :] & related, ALIVE0_KEY)
    elif warm:
        view_key[:n_initial, :n_initial] = ALIVE0_KEY
    else:
        view_key[diag, diag] = ALIVE0_KEY
    q = delay_mean_to_q(uniform_delay)
    if dense_links:
        loss = torch.full((n, n), float(np.float32(uniform_loss)), dtype=f32, device=device)
        delay_q = torch.full((n, n), q, dtype=f32, device=device)
    else:
        loss = torch.tensor(np.float32(uniform_loss), dtype=f32, device=device)
        delay_q = torch.tensor(q, dtype=f32, device=device)
    d = max(0, params.delay_slots)
    wr = words_for(r)
    return SimState(
        tick=0,
        up=up,
        epoch=torch.zeros((n,), dtype=i32, device=device),
        view_key=view_key,
        changed_at=torch.full((n, n), NEVER, dtype=i32, device=device),
        force_sync=torch.zeros((n,), dtype=torch.bool, device=device),
        leaving=torch.zeros((n,), dtype=torch.bool, device=device),
        ns_id=ns_id,
        ns_rel=ns_rel,
        rumor_active=torch.zeros((r,), dtype=torch.bool, device=device),
        rumor_origin=torch.zeros((r,), dtype=i32, device=device),
        rumor_created=torch.zeros((r,), dtype=i32, device=device),
        infected=torch.zeros((n, wr), dtype=i32, device=device),
        infected_at=torch.zeros((n, r), dtype=i32, device=device),
        infected_from=torch.full((n, r), -1, dtype=i32, device=device),
        loss=loss,
        fetch_rt=_roundtrip(loss),
        delay_q=delay_q,
        pending_key=torch.full((d, n, n), no_candidate(kd), dtype=kd, device=device),
        pending_inf=torch.zeros((d, n, wr), dtype=i32, device=device),
        pending_src=torch.full((d, n, r), -1, dtype=i32, device=device),
    )


def _roundtrip(loss: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(1-loss)·(1-lossᵀ): the derived round-trip plane (``out``: written
    in place); a scalar loss gives the scalar. The transpose is over the
    last two axes and anything below rank 2 is a uniform loss, so a
    fleet's [S, N, N] planes and [S] scalars derive per scenario."""
    if loss.dim() < 2:
        return (1.0 - loss) * (1.0 - loss)
    if out is not None and in_fleet():
        return out.copy_((1.0 - loss) * (1.0 - loss.transpose(-1, -2)))
    return torch.mul(1.0 - loss, 1.0 - loss.transpose(-1, -2), out=out)


# ---------------------------------------------------------------------------
# host mutators: state -> state between ticks; the [N, N] planes and the
# rings are written in place (the state passed in is consumed)
# ---------------------------------------------------------------------------


def join_rows(state: SimState, rows, seed_rows) -> SimState:
    """Activate the DISTINCT ``rows`` as fresh members, each knowing itself
    and the seeds (at their post-burst epochs); a reused row is a new
    identity through its epoch bits. Messages still in flight to a row are
    dropped with its old identity. Consumes ``state``."""
    from ._tick import row_index, seed_rows_tensor, set_at

    dev = state.device
    n = state.capacity
    kd = state.view_key.dtype
    rows = row_index(rows, dev)
    k = rows.shape[0]
    seeds = seed_rows_tensor(tuple(int(s) for s in seed_rows), dev).long()
    was_used = state.view_key[rows, rows] >= 0
    new_epoch = torch.where(was_used, (state.epoch[rows] + 1) & 0xFF, state.epoch[rows])
    self_keys = precedence_key(
        torch.full((k,), ALIVE, device=dev), torch.zeros((k,), device=dev), new_epoch, dtype=kd
    )
    epoch_after = set_at(state.epoch, rows, new_epoch)
    seed_keys = precedence_key(
        torch.full(seeds.shape, ALIVE, device=dev), torch.zeros(seeds.shape, device=dev),
        epoch_after[seeds], dtype=kd,
    )
    row_key = torch.full((k, n), UNKNOWN_KEY, dtype=kd, device=dev)
    row_key[:, seeds] = seed_keys[None, :]
    row_key[torch.arange(k, device=dev), rows] = self_keys
    state.view_key[rows] = row_key
    state.changed_at[rows] = NEVER
    state.changed_at[rows, rows] = state.tick
    state.pending_key[:, rows] = no_candidate(kd)
    state.pending_inf[:, rows] = 0
    state.pending_src[:, rows] = -1
    return state.replace(
        up=set_at(state.up, rows, True),
        epoch=epoch_after,
        force_sync=set_at(state.force_sync, rows, True),
        leaving=set_at(state.leaving, rows, False),
        infected=set_at(state.infected, rows, 0),
        infected_from=set_at(state.infected_from, rows, -1),
    )


def join_row(state: SimState, row: int, seed_rows) -> SimState:
    """Activate ``row`` as a fresh member knowing itself and the seeds
    (:func:`join_rows` of one row). Consumes ``state``."""
    return join_rows(state, [row], seed_rows)


def begin_leave(state: SimState, row: int) -> SimState:
    """Graceful leave: the LEAVING self record at the same incarnation,
    re-stamped, and the leave intent. Consumes ``state``."""
    from ._tick import set_at

    vk = state.view_key
    vk[row, row] = ((vk[row, row] >> 2) << 2) | RANK_LEAVING
    state.changed_at[row, row] = state.tick
    return state.replace(leaving=set_at(state.leaving, row, True))


def update_metadata(state: SimState, row: int) -> SimState:
    """Metadata update: own incarnation + 1 at the same rank (saturating in
    the narrow layout), re-stamped. Consumes ``state``."""
    vk = state.view_key
    own = vk[row, row]
    vk[row, row] = bump_inc(own, own & 3)
    state.changed_at[row, row] = state.tick
    return state


def spread_rumor(state: SimState, slot: int, origin: int) -> SimState:
    """Start user rumor ``slot`` from ``origin``: clear the slot's bit
    column of the packed words and set the origin's bit."""
    from ._tick import set_at

    return state.replace(
        rumor_active=set_at(state.rumor_active, slot, True),
        rumor_origin=set_at(state.rumor_origin, slot, origin),
        rumor_created=set_at(state.rumor_created, slot, state.tick),
        infected=set_bit(clear_col(state.infected, slot), origin, slot),
        infected_at=set_at(state.infected_at, (origin, slot), state.tick),
        infected_from=set_at(state.infected_from, (slice(None), slot), -1),
    )


def _need_dense(plane: torch.Tensor, what: str) -> None:
    if plane.dim() == 0:
        raise ValueError(f"per-link {what} needs dense links; init_state(dense_links=True)")


def set_link_loss(state: SimState, src, dst, loss: float) -> SimState:
    """Loss on every directed link src -> dst; the round-trip plane's
    [src, dst] and [dst, src] blocks follow. Consumes ``state``."""
    from ._tick import row_index

    _need_dense(state.loss, "loss")
    src = row_index(src, state.device)
    dst = row_index(dst, state.device)
    state.loss[src[:, None], dst[None, :]] = float(np.float32(loss))
    g = state.loss[dst[:, None], src[None, :]]
    fwd = (1.0 - torch.tensor(np.float32(loss), device=state.device)) * (1.0 - g)
    state.fetch_rt[src[:, None], dst[None, :]] = fwd.T
    state.fetch_rt[dst[:, None], src[None, :]] = fwd
    return state


def set_link_delay(state: SimState, src, dst, mean_delay_ticks: float) -> SimState:
    """Mean delay (in ticks) on every directed link src -> dst, converted to
    the geometric q here. A positive delay needs the rings. Consumes
    ``state``."""
    _need_dense(state.delay_q, "delay")
    if mean_delay_ticks > 0 and state.pending_key.shape[0] == 0:
        raise ValueError("link delay requires params.delay_slots > 0")
    return _put_delay_q(state, src, dst, delay_mean_to_q(mean_delay_ticks))


def set_link_delay_q(state: SimState, src, dst, q) -> SimState:
    """:func:`set_link_delay` with an already converted geometric ``q``.
    Consumes ``state``."""
    _need_dense(state.delay_q, "delay")
    if state.pending_key.shape[0] == 0:
        raise ValueError("link delay requires params.delay_slots > 0")
    return _put_delay_q(state, src, dst, q if isinstance(q, torch.Tensor) else float(np.float32(q)))


def _put_delay_q(state: SimState, src, dst, q) -> SimState:
    from ._tick import row_index

    src = row_index(src, state.device)
    dst = row_index(dst, state.device)
    state.delay_q[src[:, None], dst[None, :]] = q
    return state


def set_uniform_loss(state: SimState, loss, floor: bool = False) -> SimState:
    """Uniform loss on every link; with ``floor`` existing losses only rise
    (partition blocks survive a storm). ``fetch_rt`` is re-derived.
    ``loss`` may be a 0-d tensor, which is not read to the host. Consumes
    ``state``."""
    new = _loss_scalar(loss, state.device)
    if state.loss.dim() == 0:
        new_loss = torch.maximum(state.loss, new) if floor else new
        return state.replace(loss=new_loss, fetch_rt=_roundtrip(new_loss))
    if floor:
        maximum_into_(state.loss, state.loss, new)
    else:
        state.loss.copy_(new.expand_as(state.loss))
    _roundtrip(state.loss, out=state.fetch_rt)
    return state


def _loss_scalar(loss, device) -> torch.Tensor:
    """A loss probability as a 0-d float32 tensor on ``device``: a Python
    number rounds to float32 first, a tensor is moved as it is."""
    if isinstance(loss, torch.Tensor):
        return loss.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(np.float32(loss)), dtype=torch.float32, device=device)


def crash_row(state: SimState, row: int) -> SimState:
    """Hard-kill ``row`` (no goodbye: peers detect it by FD and suspicion)."""
    from ._tick import crash_row as crash

    return crash(state, row)


def crash_rows(state: SimState, rows) -> SimState:
    """Hard-kill of a whole crash cohort."""
    from ._tick import crash_rows as crash

    return crash(state, rows)


def block_partition(state: SimState, group_a, group_b) -> SimState:
    """Symmetric partition: drop all traffic between the two groups."""
    return set_link_loss(set_link_loss(state, group_a, group_b, 1.0), group_b, group_a, 1.0)


def heal_partition(state: SimState, group_a, group_b) -> SimState:
    return heal_partition_pair(state, group_a, group_b)


def heal_partition_pair(state: SimState, group_a, group_b, clear: float = 0.0) -> SimState:
    """Heal the block between two groups down to ``clear`` (a storm's floor,
    else 0)."""
    return set_link_loss(set_link_loss(state, group_a, group_b, clear), group_b, group_a, clear)


def _cross(state: SimState, assign) -> torch.Tensor:
    """[N, N] bool: the links between two different groups of ``assign``
    (``-1``: a bystander in no group)."""
    a = torch.as_tensor(assign, device=state.device).to(torch.int32)
    return (a[:, None] != a[None, :]) & (a[:, None] >= 0) & (a[None, :] >= 0)


def block_partition_assign(state: SimState, assign) -> SimState:
    """Partition by a per-row group vector (``-1``: a bystander that keeps
    every link): every cross-group link drops everything. Consumes
    ``state``."""
    return heal_partition_assign(state, assign, clear=1.0)


def heal_partition_assign(state: SimState, assign, clear: float = 0.0) -> SimState:
    """Every cross-group link of ``assign`` drops to ``clear``. Consumes
    ``state``."""
    _need_dense(state.loss, "loss")
    state.loss.masked_fill_(_cross(state, assign), float(np.float32(clear)))
    _roundtrip(state.loss, out=state.fetch_rt)
    return state


def drop_refutes(state: SimState, rows) -> SimState:
    """Refute suppression: each row in ``rows`` whose own record has
    refuted past the strongest SUSPECT/DEAD record the rest of the cluster
    holds for it is rewound to that record, re-stamped. Consumes
    ``state``."""
    from ._tick import row_index

    rows = row_index(rows, state.device)
    vk = state.view_key
    col = vk[:, rows]  # [N, K]
    is_self = torch.arange(state.capacity, device=state.device)[:, None] == rows[None, :]
    ext = col.masked_fill(is_self, no_candidate(vk.dtype)).amax(dim=0)  # [K]
    diag = vk[rows, rows]
    ext_rank = ext & 3
    squash = (diag > ext) & (ext >= 0) & ((ext_rank == RANK_SUSPECT) | (ext_rank == RANK_DEAD))
    stamp = state.changed_at[rows, rows]
    vk[rows, rows] = torch.where(squash, ext, diag)
    state.changed_at[rows, rows] = torch.where(squash, state.tick, stamp).to(torch.int32)
    return state


def snapshot(state: SimState) -> dict:
    """Every state leaf as a numpy array (``tick`` a 0-d int32; the packed
    words as uint32), keyed by name: the JAX package's checkpoint layout."""
    from .. import convert

    return convert.state_to_numpy(state)


def restore(arrays: dict, device="cuda") -> SimState:
    """The inverse of :func:`snapshot`, onto ``device``; the leaves are
    copied, never aliased to the caller's buffers. A set of names that is
    not exactly the state's raises ``TypeError``."""
    from .. import convert

    names = {f.name for f in dataclasses.fields(SimState)}
    if set(arrays) != names:
        raise TypeError(
            f"state planes do not match SimState: missing {sorted(names - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - names)}"
        )
    return convert.state_from_numpy(arrays, device=device)

