"""The gossip delivery combine: each receiver folds the sender rows of its
per-fanout-slot inverse-elected senders into its rumor accumulators.

* :func:`delivery_combine_ref` — the plain PyTorch version, a straight port
  of the JAX package's ``delivery_combine_xla``
  (``ops/pallas_delivery.py``), with its signature: one concatenated
  payload. It materializes the [F, N, Wt] gathered payload. The CPU path and
  the on-card comparison use it.
* :func:`delivery_combine` — the wrapper of the CUDA kernel
  ``csrc/delivery_combine.cu``, which replaces the TPU kernel of the same
  name (both its row-block and its column-split bodies). It takes the
  gossip phase's three sender planes as they are, so no payload is built on
  the card. A CPU tensor goes to the plain version (the one place the
  planes are concatenated); a CUDA tensor goes to the kernel, or the call
  raises. ``delivery_combine.launches`` counts kernel launches.
* :func:`delivery_combine_fleet` — the scenario axis: S clusters' planes
  ``[S, ...]`` folded by ONE launch of the same kernel, counts ``[S]``; on
  CPU tensors :func:`delivery_combine_fleet_ref`, the plain version over
  the scenario axis. ``delivery_combine_fleet.launches`` counts its
  launches. Both wrappers launch through the kernel's one entry
  (``delivery_combine_launch``); the serial call is the launch with S = 1.
* :func:`delivery_combine` is a ``torch.library.custom_op``: under
  ``torch.func.vmap`` (the fleet tick, :mod:`.fleet`) its vmap rule calls
  :func:`delivery_combine_fleet`, so a fleet gossip tick launches the kernel
  once, not once per scenario.
* :func:`instantiation` — which compiled variant of the kernel a call
  takes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._tensor import fleet_scope
from .bitplane import unpack_bits, words_for

VECTOR_ALIGN = 16  # bytes of one vector load of a membership chunk
MAX_F_TEMPLATE = 4  # fanouts compiled as a template parameter; larger F is a runtime loop


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


def instantiation(Wm: int, F: int, ym_ptr: int, ym_row_stride: int) -> tuple[str, int]:
    """The kernel variant for these inputs: ``("vector" | "scalar",
    f_template)``. The vector path (16 lanes per receiver, one 16-byte
    membership chunk each) needs whole 16-byte chunks: ``Wm % 4 == 0``, the
    ``ym`` plane's base and row stride (in words) 16-byte aligned; anything
    else takes the scalar path (32 lanes striding words). ``f_template`` is
    F where it is compiled as a template parameter (1..4), else 0, the
    runtime-F instantiation."""
    vec = Wm % 4 == 0 and ym_ptr % VECTOR_ALIGN == 0 and (4 * ym_row_stride) % VECTOR_ALIGN == 0
    return ("vector" if vec else "scalar"), (F if 1 <= F <= MAX_F_TEMPLATE else 0)


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]
)


def _kernel():
    fn = _build.library("delivery_combine").delivery_combine_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device, rows_only=False):
    if t.device != device:
        raise ValueError(f"delivery_combine: {name} on {t.device}, ym_p on {device}")
    if t.dtype != dtype:
        raise ValueError(f"delivery_combine: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"delivery_combine: {name} shape {tuple(t.shape)} != {shape}")
    # a plane may be a row slice of a wider tensor (its own row stride); its
    # words within a row must be adjacent
    ok = (t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)) if rows_only else t.is_contiguous()
    if not ok:
        raise ValueError(f"delivery_combine: {name} must be "
                         f"{'contiguous within each row' if rows_only else 'contiguous'}")


def delivery_combine(ym_p, yu_p, infected_from, inv, rumor_origin):
    """:func:`delivery_combine_ref`'s function over the payload
    ``cat([ym_p, yu_p, infected_from], 1)``, read as three planes: on CUDA
    tensors through the hand-written kernel (bit-equal outputs), on CPU
    tensors through the plain version.

    Args:
      ym_p: int32 [N, Wm] — packed forwarding & active membership bits.
      yu_p: int32 [N, ceil(R / 32)] — packed young user-rumor bits.
      infected_from: int32 [N, R].
      inv: int32 [F, N]; rumor_origin: int32 [R].
    """
    dev = ym_p.device
    F, n = inv.shape
    Wm = ym_p.shape[1] if ym_p.dim() == 2 else -1
    R = infected_from.shape[1] if infected_from.dim() == 2 else -1
    for name, t, shape, rows_only in (
        ("ym_p", ym_p, (n, Wm), True),
        ("yu_p", yu_p, (n, words_for(R)), True),
        ("infected_from", infected_from, (n, R), True),
        ("inv", inv, (F, n), False),
        ("rumor_origin", rumor_origin, (R,), False),
    ):
        _check(name, t, torch.int32, shape, dev, rows_only)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"delivery_combine: unsupported device {dev}")
    return _delivery_op(ym_p, yu_p, infected_from, inv, rumor_origin)


@torch.library.custom_op("scalecube_port::delivery_combine", mutates_args=())
def _delivery_op(ym_p: torch.Tensor, yu_p: torch.Tensor, infected_from: torch.Tensor,
                 inv: torch.Tensor, rumor_origin: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The combine on checked planes: the plain version on CPU, the kernel
    on CUDA. An operator, so that ``torch.func.vmap`` takes its vmap rule."""
    dev = ym_p.device
    F, n = inv.shape
    Wm, R = ym_p.shape[1], infected_from.shape[1]
    if dev.type == "cpu":
        payload = torch.cat([ym_p, yu_p, infected_from], dim=1)
        return delivery_combine_ref(payload, inv, rumor_origin, Wm, R)
    if dev.type != "cuda":
        raise ValueError(f"delivery_combine: unsupported device {dev}")
    u_or, src_max, m_or, cnt = _launch(ym_p[None], yu_p[None], infected_from[None],
                                       inv[None], rumor_origin[None])
    delivery_combine.launches += 1
    return u_or[0], src_max[0], m_or[0], cnt[0]


def delivery_combine_fleet_ref(ym_p, yu_p, infected_from, inv, rumor_origin):
    """The plain version over a scenario axis, :func:`delivery_combine_ref`'s
    spelling with a leading [S] on every operand (each scenario's senders
    gathered from its own planes): ``(u_or [S, N, R], src_max [S, N, R],
    m_or [S, N, Wm], cnt [S])``."""
    S, F, n = inv.shape
    Wm, R = ym_p.shape[-1], infected_from.shape[-1]
    payload = torch.cat([ym_p, yu_p, infected_from], dim=2)  # [S, N, Wt]
    Wt = payload.shape[2]
    Wu = Wt - Wm - R
    rows = torch.arange(n, device=inv.device, dtype=torch.int32)
    j_all = inv.clamp(min=0)
    has_all = (inv >= 0)[..., None]
    idx = j_all.long().reshape(S, F * n, 1).expand(S, F * n, Wt)
    pl_all = payload.gather(1, idx).view(S, F, n, Wt)
    yu_all = unpack_bits(pl_all[..., Wm : Wm + Wu], R)
    from_all = pl_all[..., Wm + Wu :]
    deliver = (
        yu_all
        & has_all
        & (from_all != rows[None, None, :, None])
        & (rumor_origin[:, None, None, :] != rows[None, None, :, None])
    )
    u_or = deliver.any(dim=1)
    src_max = torch.where(deliver, j_all[..., None], -1).amax(dim=1).to(torch.int32)
    m_or = torch.zeros((S, n, Wm), dtype=torch.int32, device=payload.device)
    for f in range(F):
        m_or |= torch.where(has_all[:, f], pl_all[:, f, :, :Wm], 0)
    cnt = deliver.sum(dim=(1, 2, 3)).to(torch.int32)
    return u_or, src_max, m_or, cnt


def delivery_combine_fleet(ym_p, yu_p, infected_from, inv, rumor_origin):
    """:func:`delivery_combine` over a leading scenario axis, in ONE launch:
    ``ym_p`` [S, N, Wm], ``yu_p`` [S, N, ceil(R / 32)], ``infected_from``
    [S, N, R] (each with its words adjacent within a row, any row and
    scenario strides), ``inv`` [S, F, N], ``rumor_origin`` [S, R] (int32).
    Returns ``(u_or [S, N, R], src_max [S, N, R], m_or [S, N, Wm], cnt
    [S])``. CPU tensors take :func:`delivery_combine_fleet_ref`."""
    dev = ym_p.device
    S, F, n = inv.shape
    Wm = ym_p.shape[-1] if ym_p.dim() == 3 else -1
    R = infected_from.shape[-1] if infected_from.dim() == 3 else -1
    inv = inv.contiguous()
    rumor_origin = rumor_origin.contiguous()
    for name, t, shape in (
        ("ym_p", ym_p, (S, n, Wm)),
        ("yu_p", yu_p, (S, n, words_for(R))),
        ("infected_from", infected_from, (S, n, R)),
        ("inv", inv, (S, F, n)),
        ("rumor_origin", rumor_origin, (S, R)),
    ):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"delivery_combine_fleet: {name} {t.dtype}{tuple(t.shape)} on {t.device}, "
                             f"expected int32{shape} on {dev}")
    planes = []
    for t in (ym_p, yu_p, infected_from):
        planes.append(t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous())
    ym_p, yu_p, infected_from = planes
    if dev.type == "cpu":
        return delivery_combine_fleet_ref(ym_p, yu_p, infected_from, inv, rumor_origin)
    if dev.type != "cuda":
        raise ValueError(f"delivery_combine_fleet: unsupported device {dev}")
    out = _fleet_op(ym_p, yu_p, infected_from, inv, rumor_origin)
    delivery_combine_fleet.launches += 1
    return out


@torch.library.custom_op("scalecube_port::delivery_combine_fleet", mutates_args=())
def _fleet_op(ym_p: torch.Tensor, yu_p: torch.Tensor, infected_from: torch.Tensor, inv: torch.Tensor,
              rumor_origin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scenario-axis launch on checked CUDA planes, as an operator: the
    kernel writes its outputs through raw pointers, so only an operator
    shows a dispatch-level observer (the audit's recorder) that they are
    computed from its inputs."""
    return _launch(ym_p, yu_p, infected_from, inv, rumor_origin)


def _launch(ym_p, yu_p, infected_from, inv, rumor_origin):
    """One launch of the kernel on checked CUDA planes with a leading [S]
    (S = 1 for the serial wrapper; a lone scenario's strides are 0)."""
    dev = ym_p.device
    S, F, n = inv.shape
    Wm, R = ym_p.shape[-1], infected_from.shape[-1]
    sstrides = [0 if S == 1 else t.stride(0) for t in (ym_p, yu_p, infected_from)]
    path, f_template = instantiation(Wm, F, ym_p.data_ptr(), ym_p.stride(1))
    if sstrides[0] % 4:
        path = "scalar"
    u_or = torch.empty((S, n, R), dtype=torch.uint8, device=dev)
    src_max = torch.empty((S, n, R), dtype=torch.int32, device=dev)
    m_or = torch.empty((S, n, Wm), dtype=torch.int32, device=dev)
    cnt = torch.zeros((S,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel()(
            ym_p.data_ptr(), ym_p.stride(1), yu_p.data_ptr(), yu_p.stride(1),
            infected_from.data_ptr(), infected_from.stride(1), *sstrides,
            inv.data_ptr(), rumor_origin.data_ptr(),
            u_or.data_ptr(), src_max.data_ptr(), m_or.data_ptr(), cnt.data_ptr(),
            S, n, F, Wm, R, int(path == "vector"), f_template, stream,
        )
    if err != 0:
        raise RuntimeError(f"delivery_combine kernel launch failed: cudaError {err}")
    return u_or.view(torch.bool), src_max, m_or, cnt


@_delivery_op.register_vmap
def _delivery_combine_vmap(info, in_dims, ym_p, yu_p, infected_from, inv, rumor_origin):
    """Under the fleet's vmap: every operand with its scenario axis first
    (an unbatched one broadcast), one :func:`delivery_combine_fleet` call."""
    s = info.batch_size

    def lead(t, d):
        return t.expand((s,) + tuple(t.shape)) if d is None else t.movedim(d, 0)

    args = [lead(t, d) for t, d in zip((ym_p, yu_p, infected_from, inv, rumor_origin), in_dims)]
    with fleet_scope(0):
        return delivery_combine_fleet(*args), (0, 0, 0, 0)


delivery_combine.launches = 0
delivery_combine_fleet.launches = 0
