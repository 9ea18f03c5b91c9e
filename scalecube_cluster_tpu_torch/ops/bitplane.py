"""Word-packed bit planes: bits pack along the LAST axis, little-endian
within a 32-bit word::

    packed[..., w] bit b  <=>  bool_plane[..., w * 32 + b]

``bool [..., L]  <->  int32 [..., ceil(L/32)]`` with the tail word's unused
high bits always zero. The words are the JAX package's uint32 words stored
as int32 (same bits): PyTorch has no usable uint32 arithmetic on the CPU, so
anything that needs unsigned semantics (a logical shift, a borrow) widens
to int64 and masks to 32 bits.

Packing goes through bytes: each group of 8 bools becomes one byte, and
four consecutive bytes are read as one little-endian int32 word. No [..., L]
temporary wider than one byte per bit is made, which matters at the pview
engine's [N, 2048] planes.
"""

from __future__ import annotations

import torch

WORD = 32
MASK32 = 0xFFFFFFFF


def words_for(length: int) -> int:
    """Packed words needed for ``length`` bits (ceil division)."""
    return (int(length) + WORD - 1) // WORD


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2**32) (the uint32 value of the bits)."""
    return x.to(torch.int64) & MASK32


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """bool [..., L] -> int32 [..., ceil(L/32)] words; tail bits zero."""
    *lead, L = x.shape
    w = words_for(L)
    pad = w * WORD - L
    if pad:
        x = torch.cat([x, x.new_zeros((*lead, pad))], dim=-1)
    bits = x.reshape(*lead, w, 4, 8).view(torch.uint8)  # a bool is one byte, 0 or 1
    byte = bits[..., 0].clone()
    for b in range(1, 8):
        byte |= bits[..., b] << b
    return byte.contiguous().view(torch.int32).reshape(*lead, w)


def unpack_bits(p: torch.Tensor, length: int) -> torch.Tensor:
    """int32 [..., W] words -> bool [..., length]."""
    *lead, w = p.shape
    byte = p.contiguous().view(torch.uint8).reshape(*lead, w * 4)
    bits = torch.stack([(byte >> b) & 1 for b in range(8)], dim=-1)
    return bits.reshape(*lead, w * WORD)[..., :length].to(torch.bool)


def popcount(w: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts of int32 words (their uint32 bits) -> int32,
    by the SWAR reduction on the widened value."""
    v = to_u32(w)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)


def or_rows(p: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of the rows of an [N, W] word plane -> [W], by halving:
    each step ORs the top half onto the bottom half, so the plane is read
    about twice in all."""
    if p.shape[0] == 0:
        return torch.zeros(p.shape[1:], dtype=p.dtype, device=p.device)
    x = p
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        folded = x[:h] | x[h : 2 * h]
        x = folded if x.shape[0] % 2 == 0 else torch.cat([folded, x[2 * h :]])
    return x[0]


def tail_mask(length: int, device=None) -> torch.Tensor:
    """int32 [W] mask of the valid bits of each word: all ones but the tail
    word, whose bits past ``length % 32`` are zero (a packed plane always
    equals itself AND this mask)."""
    w = words_for(length)
    full = torch.full((w,), -1, dtype=torch.int32, device=device)
    rem = int(length) % WORD
    if rem:
        full[-1] = (1 << rem) - 1
    return full


def word_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def word_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def word_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a & ~b (e.g. a live-view plane minus its self bits)."""
    return a & ~b


def popcount_rows(p: torch.Tensor) -> torch.Tensor:
    """int32 [..., W] words -> int32 [...]: the set bits along the packed
    axis (a bool plane's row sum, never widened to int64)."""
    return popcount(p).sum(dim=-1, dtype=torch.int32)


def popcount_total(p: torch.Tensor) -> torch.Tensor:
    """The whole plane's set-bit count as an int32 scalar."""
    return popcount(p).sum(dtype=torch.int32)


def row_gather(p: torch.Tensor, idx) -> torch.Tensor:
    """Packed rows ``p[idx]``: W words per row instead of L bools."""
    return p[idx]


def diag_words(n: int, device=None) -> torch.Tensor:
    """int32 [N, W]: row i holds the single bit of column i (the packed
    identity, for clearing self bits of an [N, N] mask)."""
    rows = torch.arange(n, device=device)
    out = torch.zeros((n, words_for(n)), dtype=torch.int32, device=device)
    out[rows, rows // WORD] = to_i32(torch.ones((), dtype=torch.int64, device=device) << (rows % WORD))
    return out


def select_bit(word: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Index of the ``r``-th (1-indexed) set bit of each int32 ``word`` (its
    uint32 bits), by a 32-step sweep; ranks below 1 or above the word's
    popcount give 0 (the callers mask those slots)."""
    r = r.to(torch.int32)
    cnt = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    out = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    for b in range(WORD):
        bit = ((word >> b) & 1).to(torch.int32)
        cnt += bit
        out = torch.where((bit == 1) & (cnt == r), b, out)
    return out


def _word_value(v: int) -> int:
    """A uint32 value as the int32 of the same bits."""
    return v - (1 << 32) if v >= (1 << 31) else v


def set_bit(p: torch.Tensor, row: int, col: int) -> torch.Tensor:
    """Copy of the packed plane with bit ``col`` of row ``row`` set."""
    w, b = int(col) // WORD, int(col) % WORD
    out = p.clone()
    out[row, w] |= _word_value(1 << b)
    return out


def clear_col(p: torch.Tensor, col: int) -> torch.Tensor:
    """Copy of a packed [N, W] plane with bit ``col`` cleared in every row."""
    w, b = int(col) // WORD, int(col) % WORD
    out = p.clone()
    out[:, w] &= _word_value(~(1 << b) & MASK32)
    return out


def col_bits(p: torch.Tensor, col: int) -> torch.Tensor:
    """bool [...]: bit ``col`` of every packed row (one word per row)."""
    w, b = int(col) // WORD, int(col) % WORD
    return ((p[..., w] >> b) & 1) == 1
