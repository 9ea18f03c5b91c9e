"""Strategy resolution helpers the three gossip phases share (r13), in
PyTorch: a port of the JAX package's ``dissemination/strategies.py``, held
against it bit for bit (``tests/test_torch_dissemination.py``).

The seam is deliberately tiny: a strategy is (a) a PEER-SELECTION rule —
which ``fanout`` targets each sender contacts this tick — plus (b) a
PAYLOAD-BUDGET rule — which user-rumor slots ride the message — plus (c)
an optional PULL REPLY leg. Everything is elementwise integer/f32 math on
tensors of the caller's device; the scalar mirrors
(:func:`structured_peer_row`, :func:`budget_ok`) stay numpy. The f32
products and the residual rescale are separate operations in the JAX
order, so the picks are the same numbers.

Deviations from the cited papers, stated once:

* **DZ-1 (overlay vs view).** On a structured topology, sends are gated
  on the PHYSICAL liveness of both endpoints (``up[src] & up[dst]`` —
  the same edge gate as always) but NOT on the sender's membership view
  of the target: the overlay is configured wiring, and a member does not
  stop using a static link because it currently suspects the neighbor.
  Membership semantics are unaffected — every record still enters
  through the same monotone merge gates.
* **DZ-2 (pull replies ride the contact).** A ``push_pull`` reply is
  sent by a peer that a payload-bearing message REACHED this tick
  (undelayed contacts only) and lands immediately: the reply shares the
  round trip the push established, like the reference's request/response
  exchanges. Its delivery draw is an independent hashed uniform on the
  reverse link (``SALT_PULL`` family, ops/rand.py).
* **DZ-3 (budget throttles user rumors only).** The pipelined budget
  rotates over USER-rumor slots; membership records (failure-detection
  plumbing) are never throttled — safety traffic is not subject to the
  bandwidth experiment.
* **DZ-4 (duplicate chords).** When ``fanout`` exceeds the chord count,
  deterministic schedules revisit chords within a tick (distinct edge
  draws, idempotent merges) rather than refusing the configuration.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops._tensor import host_constant
from ..ops.rand import SALT_PULL, SALT_PULL_STRIDE
from . import topology


def pull_salt(s: int) -> int:
    """Per-fanout-slot salt of the pull-reply delivery draw (slots must
    not share draws; see the salt-spacing rule in ops/rand.py)."""
    return SALT_PULL + s * SALT_PULL_STRIDE


@functools.lru_cache(maxsize=None)
def _chords_tensor(ch: tuple, device: torch.device) -> torch.Tensor:
    """The chord offsets as an int32 tensor on ``device``, made once per
    (chords, device) and copied without a wait: a copy from the host each
    tick waits for the device."""
    return host_constant(ch, torch.int32, device)


def structured_peers(spec, n: int, tick: int, u_sel: torch.Tensor):
    """Closed-form circulant peer selection on ``u_sel``'s device: ``peers
    [N, F] i32`` + ``valid [N, F]`` (always true — DZ-1/DZ-4). ``u_sel``
    is the [N, F] uniform block the engine's sampler would have consumed
    (only the random strategies read it; the deterministic schedules
    ignore it, but the draw stream is generated either way so arming a
    strategy never perturbs the other phases' randomness). ``tick`` is a
    host int."""
    ch = topology.chords(spec, n)
    C = len(ch)
    F = u_sel.shape[1]
    dev = u_sel.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    ch_arr = _chords_tensor(tuple(int(c) for c in ch), dev)
    cols = []
    for s in range(F):
        if spec.strategy in ("push", "push_pull"):
            ci = torch.clamp((u_sel[:, s] * float(C)).to(torch.int32), max=C - 1)
        elif spec.strategy == "pipelined":
            ci = (tick * F + s) % C
        elif spec.strategy == "tuneable":
            # robust/tuneable family (arXiv:1506.02288): deterministic
            # doubling-walk chord with probability ``mix``, else a uniform
            # chord from the SAME per-slot uniform's residual
            ci = _tuneable_chord(spec, C, tick, s, u_sel[:, s])
        else:  # accelerated — the doubling walk
            ci = (tick + s) % C
        chord = ch[ci] if isinstance(ci, int) else ch_arr[ci.long()]
        cols.append((rows + chord) % n)
    peers = torch.stack(cols, 1).to(torch.int32)
    valid = torch.ones((n, F), dtype=torch.bool, device=dev)
    return peers, valid


def _tuneable_chord(spec, C: int, tick: int, s: int, u: torch.Tensor) -> torch.Tensor:
    """The tuneable family's per-slot chord index (elementwise f32, the
    JAX order: ``u < mix`` follows the deterministic walk; otherwise the
    residual ``(u - mix) / (1 - mix)`` rescales into a uniform chord
    draw)."""
    mix = np.float32(spec.tuneable_mix)
    det = (tick + s) % C
    if spec.tuneable_mix >= 1.0:
        return torch.full(u.shape, det, dtype=torch.int32, device=u.device)
    if spec.tuneable_mix <= 0.0:
        return torch.clamp((u * float(C)).to(torch.int32), max=C - 1)
    # f32 scalars as Python floats: each operand is exactly representable,
    # and torch computes every product and quotient in f32
    u2 = (u - float(mix)) / float(np.float32(1.0 - mix))
    rand = torch.clamp((u2 * float(C)).to(torch.int32), 0, C - 1)
    return torch.where(u < float(mix), det, rand).to(torch.int32)


def _tuneable_chord_row(spec, C: int, tick: int, s: int, u: np.float32) -> int:
    """:func:`_tuneable_chord` for one numpy f32 uniform (the row mirror)."""
    mix = np.float32(spec.tuneable_mix)
    det = (tick + s) % C
    if spec.tuneable_mix >= 1.0:
        return det
    if spec.tuneable_mix <= 0.0:
        return min(int(u * np.float32(C)), C - 1)
    u2 = np.float32((u - mix) / np.float32(1.0 - mix))
    rand = int(np.clip(int(np.float32(u2 * np.float32(C))), 0, C - 1))
    return det if u < mix else rand


def structured_peer_row(spec, n: int, tick: int, i: int, u_row):
    """Scalar mirror of :func:`structured_peers` for one sender row —
    identical f32 trunc-multiply and modular arithmetic, in numpy."""
    ch = topology.chords(spec, n)
    C = len(ch)
    F = len(u_row)
    peers = np.zeros(F, np.int32)
    for s in range(F):
        if spec.strategy in ("push", "push_pull"):
            ci = min(int(np.float32(u_row[s]) * np.float32(C)), C - 1)
        elif spec.strategy == "pipelined":
            ci = (tick * F + s) % C
        elif spec.strategy == "tuneable":
            ci = _tuneable_chord_row(spec, C, tick, s, np.float32(u_row[s]))
        else:
            ci = (tick + s) % C
        peers[s] = (i + ch[ci]) % n
    return peers, np.ones(F, bool)


def try_stride_uniforms(u_try: torch.Tensor, tries: int) -> torch.Tensor:
    """The [N, F] uniform block a rejection-sampling engine (sparse/pview)
    hands to the random structured selection: the FIRST try column of each
    pick (one uniform per pick, the rest of the try block unread)."""
    return u_try[:, ::tries]


def rumor_budget_mask(spec, n_slots: int, tick: int, device="cuda"):
    """Pipelined payload budget: the [R] bool window of user-rumor slots a
    message may carry this tick (rotating, ``pipeline_budget`` wide), or
    ``None`` for the unthrottled strategies (DZ-3). The remainder of a
    negative left operand follows Python's floor rule, as torch's ``%``
    does."""
    if spec.strategy != "pipelined":
        return None
    b = min(spec.pipeline_budget, n_slots)
    idx = torch.arange(n_slots, dtype=torch.int32, device=device)
    return ((idx - tick) % n_slots) < b


def budget_ok(spec, slot: int, tick: int, n_slots: int) -> bool:
    """Scalar mirror of :func:`rumor_budget_mask` for one slot."""
    if spec.strategy != "pipelined":
        return True
    b = min(spec.pipeline_budget, n_slots)
    return ((slot - tick) % n_slots) < b
