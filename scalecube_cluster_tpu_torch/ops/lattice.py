"""The membership-record precedence lattice as a packed monotone key.

Each ``(epoch, status, incarnation)`` packs into one integer whose order is
the reference's override order (``MembershipRecord.java:67-90``, with the
three documented deviations of the JAX package's ``ops/lattice.py``)::

    key = epoch << epoch_shift | incarnation << 2 | rank
    rank: ALIVE -> 0, LEAVING -> 1, SUSPECT -> 2, DEAD -> 3

so a merge is a scatter-max. Unknown entries carry ``UNKNOWN_KEY`` (-1).
Two layouts: the wide int32 one and the narrow int16 one, whose incarnation
saturates at 511 (:func:`bump_inc`) and whose epoch folds mod 16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Status codes (match models.member.MemberStatus + the kernel-internal UNKNOWN).
ALIVE = 0
SUSPECT = 1
LEAVING = 2
DEAD = 3
UNKNOWN = 4

UNKNOWN_KEY = -1
#: wide-layout scatter-max identity
NO_CANDIDATE = int(np.iinfo(np.int32).min)

RANK_ALIVE = 0
RANK_LEAVING = 1
RANK_SUSPECT = 2
RANK_DEAD = 3

INC_BITS = 21


@dataclasses.dataclass(frozen=True)
class KeyLayout:
    """Bit layout of one packed-key dtype: rank [0:2), incarnation
    [2:2+inc_bits), epoch above it."""

    inc_bits: int
    epoch_bits: int

    @property
    def epoch_shift(self) -> int:
        return 2 + self.inc_bits

    @property
    def inc_mask(self) -> int:
        return (1 << self.inc_bits) - 1

    @property
    def epoch_mask(self) -> int:
        return (1 << self.epoch_bits) - 1


LAYOUT_I32 = KeyLayout(inc_bits=INC_BITS, epoch_bits=8)
LAYOUT_I16 = KeyLayout(inc_bits=9, epoch_bits=4)

#: ``key_dtype`` spellings -> torch dtype
KEY_DTYPES = {"i32": torch.int32, "i16": torch.int16}


def layout_for(dtype) -> KeyLayout:
    """KeyLayout for a key dtype (int16 -> narrow, anything else wide)."""
    return LAYOUT_I16 if dtype == torch.int16 else LAYOUT_I32


def key_dtype(name: str) -> torch.dtype:
    """torch dtype for a ``key_dtype`` spelling ("i32" / "i16")."""
    if name not in KEY_DTYPES:
        raise ValueError(f"key dtype must be one of {sorted(KEY_DTYPES)}, got {name!r}")
    return KEY_DTYPES[name]


# rank by status code: ALIVE->0, SUSPECT->2, LEAVING->1, DEAD->3 (UNKNOWN->0,
# masked below)
_RANK = (0, 2, 1, 3, 0)


def precedence_key(status, incarnation, epoch=0, dtype=torch.int32) -> torch.Tensor:
    """Pack (status, incarnation[, epoch]) into the key of ``dtype``; the
    incarnation saturates at the layout's cap and the epoch is masked to its
    bits. UNKNOWN entries map to ``UNKNOWN_KEY``."""
    lay = layout_for(dtype)
    dev = next((x.device for x in (status, incarnation, epoch) if isinstance(x, torch.Tensor)), None)
    status = torch.as_tensor(status, device=dev).to(torch.int32)
    inc = torch.as_tensor(incarnation, device=dev).to(torch.int32).clamp(max=lay.inc_mask)
    epoch = torch.as_tensor(epoch, device=dev).to(torch.int32)
    rank = torch.tensor(_RANK, dtype=torch.int32, device=dev)[status.long()]
    key = ((epoch & lay.epoch_mask) << lay.epoch_shift) | (inc << 2) | rank
    return torch.where(status == UNKNOWN, UNKNOWN_KEY, key).to(dtype)


def bump_inc(key: torch.Tensor, rank) -> torch.Tensor:
    """Incarnation + 1 at the same epoch with ``rank``, saturating at the
    layout's cap so a narrow key never carries into its epoch bits. Runs in
    ``key``'s own dtype, as the JAX spelling does."""
    lay = layout_for(key.dtype)
    inc = (((key >> 2) & lay.inc_mask) + 1).clamp(max=lay.inc_mask)
    epoch_bits = (key >> lay.epoch_shift) << lay.epoch_shift
    rank = torch.as_tensor(rank, device=key.device).to(key.dtype)
    return (epoch_bits | (inc << 2) | rank).to(key.dtype)
