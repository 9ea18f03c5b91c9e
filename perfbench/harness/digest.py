"""Row digests of a state's leaves, so that two whole states can be compared
exactly without holding both: each leaf reduces to two int64 words per row
(dim 0; a 0-d leaf is one row), computed on the leaf's device in row
blocks. Both sides are digested by this one function on one device, so
equal leaves give equal digests; a leaf that differs in one cell always
differs in its first word (odd weights, a nonzero difference below 2**33)."""

from __future__ import annotations

import torch

BLOCK_CELLS = 1 << 26


def _weights(width: int, salt: int, device) -> torch.Tensor:
    """Odd int64 column weights, the same on every device."""
    x = torch.arange(width, dtype=torch.int64, device=device) * (0x9E3779B97F4A7C15 - (1 << 64)) + salt
    x = x ^ (x >> 31)
    x = x * 0x2545F4914F6CDD1D
    return (x ^ (x >> 29)) | 1


def _as_int64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32).to(torch.int64)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.to(torch.int64)


def leaf_digest(x) -> torch.Tensor:
    """int64 [rows, 2] digest of a tensor (or a host int) by its first
    dimension."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor([[int(x), int(x)]], dtype=torch.int64)
    rows = 1 if x.dim() == 0 else x.shape[0]
    out = torch.zeros((rows, 2), dtype=torch.int64, device=x.device)
    if x.numel() == 0:
        return out.cpu()
    t = x.reshape(rows, -1)
    width = t.shape[1]
    w1, w2 = _weights(width, 1, t.device), _weights(width, 7, t.device)
    step = max(1, BLOCK_CELLS // width)
    for lo in range(0, rows, step):
        v = _as_int64(t[lo : lo + step])
        out[lo : lo + step, 0] = (v * w1).sum(dim=1)
        out[lo : lo + step, 1] = ((v ^ 0x5BD1E995) * w2).sum(dim=1)
    return out.cpu()


def state_digest(leaves: dict) -> dict:
    """{leaf name: (shape, dtype name, [rows, 2] digest)}."""
    return {
        k: (tuple(v.shape) if isinstance(v, torch.Tensor) else (), str(v.dtype) if isinstance(v, torch.Tensor)
            else "int", leaf_digest(v))
        for k, v in leaves.items()
    }


def differing_rows(a: dict, b: dict) -> dict:
    """{leaf name: rows whose digests differ} for every leaf that differs
    (a leaf on one side only, or of another shape or dtype, counts all its
    rows)."""
    out = {}
    for k in sorted(set(a) | set(b)):
        if k not in a or k not in b or a[k][:2] != b[k][:2]:
            out[k] = max(x[2].shape[0] for x in (a.get(k), b.get(k)) if x is not None) or 1
            continue
        bad = int((a[k][2] != b[k][2]).any(dim=1).sum())
        if bad:
            out[k] = bad
    return out
