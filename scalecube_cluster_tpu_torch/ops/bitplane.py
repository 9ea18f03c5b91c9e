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
