"""The gossip delivery combine: each receiver folds the payload rows of its
per-fanout-slot inverse-elected senders into its rumor accumulators.

* :func:`delivery_combine_ref` — the plain PyTorch version, a straight port
  of the JAX package's ``delivery_combine_xla``
  (``ops/pallas_delivery.py``). It materializes the [F, N, Wt] gathered
  payload. The CPU path and the on-card comparison use it.
* :func:`delivery_combine` — the wrapper of the CUDA kernel
  ``csrc/delivery_combine.cu``, which replaces the TPU kernel of the same
  name (both its row-block and its column-split bodies). A CPU tensor goes
  to the plain version; a CUDA tensor goes to the kernel, or the call
  raises. ``delivery_combine.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .bitplane import unpack_bits, words_for


def delivery_combine_ref(payload, inv, rumor_origin, Wm: int, R: int):
    """Plain spelling of the combine.

    Args:
      payload: int32 [N, Wt] — ``Wm`` membership-rumor words, ``Wu`` packed
        user-rumor words, then R infected-from lanes.
      inv: int32 [F, N] — per-slot inverse sender index (< 0: no sender).
      rumor_origin: int32 [R].

    Returns ``(u_or bool [N, R], src_max int32 [N, R], m_or int32 [N, Wm],
    cnt int32 scalar)``.
    """
    F, n = inv.shape
    Wt = payload.shape[1]
    Wu = Wt - Wm - R
    rows = torch.arange(n, device=inv.device, dtype=torch.int32)
    j_all = inv.clamp(min=0)
    has_all = (inv >= 0)[:, :, None]
    pl_all = payload[j_all.long()]
    yu_all = unpack_bits(pl_all[:, :, Wm : Wm + Wu], R)
    from_all = pl_all[:, :, Wm + Wu :]
    deliver = (
        yu_all
        & has_all
        & (from_all != rows[None, :, None])
        & (rumor_origin[None, None, :] != rows[None, :, None])
    )
    u_or = deliver.any(dim=0)
    src_max = torch.where(deliver, j_all[:, :, None], -1).amax(dim=0).to(torch.int32)
    m_or = torch.zeros((n, Wm), dtype=torch.int32, device=payload.device)
    for s in range(F):
        m_or |= torch.where(has_all[s], pl_all[s, :, :Wm], 0)
    cnt = deliver.sum().to(torch.int32)
    return u_or, src_max, m_or, cnt


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel():
    lib = _build.library("delivery_combine")
    fn = lib.delivery_combine_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def delivery_combine(payload, inv, rumor_origin, Wm: int, R: int):
    """:func:`delivery_combine_ref`'s function; on CUDA tensors through the
    hand-written kernel (bit-equal outputs), on CPU tensors through the
    plain version."""
    if payload.device.type == "cpu":
        return delivery_combine_ref(payload, inv, rumor_origin, Wm, R)
    if payload.device.type != "cuda":
        raise ValueError(f"delivery_combine: unsupported device {payload.device}")
    F, n = inv.shape
    Wt = payload.shape[1]
    for name, t, dtype, shape in (
        ("payload", payload, torch.int32, (n, Wm + words_for(R) + R)),
        ("inv", inv, torch.int32, (F, n)),
        ("rumor_origin", rumor_origin, torch.int32, (R,)),
    ):
        if t.device != payload.device:
            raise ValueError(f"delivery_combine: {name} on {t.device}, payload on {payload.device}")
        if t.dtype != dtype:
            raise ValueError(f"delivery_combine: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"delivery_combine: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"delivery_combine: {name} must be contiguous")
    dev = payload.device
    u_or = torch.empty((n, R), dtype=torch.uint8, device=dev)
    src_max = torch.empty((n, R), dtype=torch.int32, device=dev)
    m_or = torch.empty((n, Wm), dtype=torch.int32, device=dev)
    cnt_rows = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel()(
            payload.data_ptr(), inv.data_ptr(), rumor_origin.data_ptr(),
            u_or.data_ptr(), src_max.data_ptr(), m_or.data_ptr(), cnt_rows.data_ptr(),
            n, F, Wt, Wm, R, stream,
        )
    if err != 0:
        raise RuntimeError(f"delivery_combine kernel launch failed: cudaError {err}")
    delivery_combine.launches += 1
    return u_or.view(torch.bool), src_max, m_or, cnt_rows.sum(dtype=torch.int32)


delivery_combine.launches = 0
