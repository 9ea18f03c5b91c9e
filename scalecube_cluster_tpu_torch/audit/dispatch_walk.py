"""The dispatch recorder of the audit plane: what a window really ran.

The port's counterpart of the JAX package's ``audit/jaxpr_walk.py``. JAX
walks the closed jaxpr of a window program; eager PyTorch builds no
program to walk, so the port witnesses the operations a window actually
dispatches on concrete inputs at audit shapes. :class:`Recorder` runs a
window under two modes at once:

* a ``TorchDispatchMode`` logs every aten (or custom) operation: its name,
  the shapes, dtypes and storages of its tensor inputs and outputs, and
  its provenance (the innermost frame outside ``torch``, this package and
  any mode's handler: in the port's own code, the line of the tick that
  issued it). Beside the log it keeps the window's dataflow over storage
  versions (:class:`Node`): an output in fresh storage, or an in-place
  write (the schema's mutable arguments), is a new version that depends
  on every input the operation read; a view is the same version.
  Under ``torch.func.vmap`` (the fleets) the mode sees the physical
  ``[S, ...]`` tensors, and a ``torch.library.custom_op`` (the delivery
  kernel, the mesh collectives) is one operation;
* a ``TorchFunctionMode`` logs every host read: ``Tensor.item``,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``tolist``,
  ``numpy`` and ``__array__``. On a CPU tensor ``tolist()`` never reaches
  the aten dispatcher, so the dispatch mode alone would miss these. It
  logs host data put on a device too (``torch.tensor(..., device=)`` and
  its kin: on a card a copy out of pageable memory, which waits; on the
  CPU a no-op, logged all the same). The dispatch mode adds the
  operations that wait for the device without being a read
  (:data:`SYNC_OPS`, an index by a bool mask, a blocking copy between the
  host and the device), and one read of its splits for each exact
  exchange (:data:`EXCHANGE_OPS`), which reads them inside the op.

Every read carries the chain of the port's functions it ran under, so
:mod:`.contracts` can tell the sanctioned, counted sites from the rest.
The recorder keeps no reference to a tensor: it would change the memory
it is meant not to see.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AUDIT_DIR = os.path.dirname(os.path.abspath(__file__))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
_STDLIB_SKIP = ("contextlib.py", "functools.py")

#: tensor methods that read a value to the host
HOST_READS = frozenset({"item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy", "__array__"})

#: constructors that copy host data onto the ``device=`` they are given
_FROM_HOST = (torch.tensor, torch.as_tensor, torch.asarray)

#: operations whose result shape or value the host must wait for (on a CUDA
#: tensor each one synchronises the stream)
SYNC_OPS = frozenset({
    "aten::nonzero", "aten::masked_select", "aten::_local_scalar_dense", "aten::is_nonzero",
    "aten::bincount", "aten::_unique2", "aten::unique_consecutive", "aten::unique_dim", "aten::equal",
})

#: operations that read part of a tensor into fresh storage (a gather)
GATHER_OPS = frozenset({
    "aten::index", "aten::_unsafe_index", "aten::gather", "aten::index_select", "aten::take",
    "aten::masked_select",
})

#: operations that copy a tensor into fresh or existing storage
COPY_OPS = frozenset({"aten::clone", "aten::_to_copy", "aten::copy_"})


class TensorInfo(NamedTuple):
    """One tensor an operation read or wrote: its storage (the data pointer,
    0 for an empty one), the storage's version node, its shape and dtype."""

    storage: int
    node: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    numel: int


class OpRecord(NamedTuple):
    """One dispatched operation; ``site`` is the code object and line that
    issued it (:attr:`where` formats it)."""

    index: int
    name: str  # "aten::index", "scalecube_port::delivery_combine", ...
    inputs: Tuple[TensorInfo, ...]
    outputs: Tuple[TensorInfo, ...]
    site: tuple

    @property
    def where(self) -> str:
        return format_site(self.site)


@dataclasses.dataclass(frozen=True)
class HostRead:
    """One read to the host (or device wait): what, where, and the port
    functions it ran under (``(file relative to the package, function)``,
    innermost first)."""

    kind: str
    where: str
    chain: Tuple[Tuple[str, str], ...]


class Node(NamedTuple):
    """One version of one storage: made by operation ``op`` (-1: it existed
    before the window, an input or a captured constant) from ``deps``."""

    op: int
    deps: Tuple[int, ...]
    shape: Tuple[int, ...]  # the shape of the tensor that made this version


def _rel(path: str) -> str:
    path = os.path.abspath(path)
    return os.path.relpath(path, _REPO_DIR) if path.startswith(_REPO_DIR + os.sep) else path


_SKIP: Dict[object, bool] = {}


def _skipped(code) -> bool:
    f = os.path.abspath(code.co_filename)
    hit = (f.startswith(_TORCH_DIR + os.sep) or f.startswith(_AUDIT_DIR + os.sep)
           or f.endswith(_STDLIB_SKIP) or code.co_filename.startswith("<")
           or code.co_name in ("__torch_function__", "__torch_dispatch__"))
    _SKIP[code] = hit
    return hit


def issuing_site(depth: int = 1) -> tuple:
    """``(code, line)`` of the innermost frame outside ``torch``, this
    package's audit plane, ``contextlib``/``functools`` and any mode's
    handler (the fleet's factory mode): the line that issued the
    operation."""
    f = sys._getframe(depth)
    skip = _SKIP
    while f is not None:
        hit = skip.get(f.f_code)
        if hit is None:
            hit = _skipped(f.f_code)
        if not hit:
            return (f.f_code, f.f_lineno)
        f = f.f_back
    return (None, 0)


def format_site(site: tuple) -> str:
    """``file:line (function)`` of an :func:`issuing_site`."""
    code, line = site
    if code is None:
        return "<unknown>"
    return f"{_rel(code.co_filename)}:{line} ({code.co_name})"


def provenance(depth: int = 1) -> str:
    """:func:`issuing_site`, formatted."""
    return format_site(issuing_site(depth + 1))


def port_chain(depth: int = 1) -> Tuple[Tuple[str, str], ...]:
    """The port functions on the stack, innermost first, as ``(path inside
    the package, function name)``."""
    out = []
    f = sys._getframe(depth)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG_DIR + os.sep) and not path.startswith(_AUDIT_DIR + os.sep):
            out.append((os.path.relpath(path, _PKG_DIR).replace(os.sep, "/"), f.f_code.co_name))
        f = f.f_back
    return tuple(out)


def storage_of(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its data pointer; 0 when empty)."""
    return t.untyped_storage().data_ptr()


def count_wide_dims(shape, threshold: int) -> int:
    """How many dims of ``shape`` are >= ``threshold`` (the capacity-scaled
    width test: audit params keep every other dim below capacity)."""
    return sum(1 for d in shape if d >= threshold)


def is_wide(shape, threshold: int) -> bool:
    """A capacity²-proportional shape: >= 2 dims each >= capacity."""
    return count_wide_dims(shape, threshold) >= 2


_WRITES: Dict[object, tuple] = {}


def _written_args(func) -> tuple:
    """``(position, name)`` of the arguments ``func``'s schema writes."""
    hit = _WRITES.get(func)
    if hit is None:
        hit = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
        _WRITES[func] = hit
    return hit


def _tensors(values, out: list) -> list:
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            _tensors(v, out)
    return out


_SYNC_KIND: Dict[object, int] = {}
#: the exact exchanges (``ops/ragged_a2a.py``): custom ops that each read
#: their splits to the host once (``_splits``)
EXCHANGE_OPS = frozenset({"scalecube_port::late_exchange", "scalecube_port::fetch_rows",
                          "scalecube_port::row_exchange", "scalecube_port::fetch_points"})
_INDEX_OPS = frozenset({"aten::index", "aten::index_put_", "aten::index_put", "aten::_index_put_impl_"})


def _sync_kind(name: str) -> int:
    """0: never waits; 1: always waits (:data:`SYNC_OPS`); 2: waits when
    indexed by a bool mask; 3: waits when it copies across the host-device
    line."""
    if name in SYNC_OPS:
        return 1
    if name in _INDEX_OPS:
        return 2
    return 3 if name in ("aten::_to_copy", "aten::copy_") else 0


def _waits(kind: int, ins, outs, args, kwargs) -> bool:
    if kind == 1:
        return True
    if kind == 2:
        idx = args[1] if len(args) > 1 else kwargs.get("indices")
        return any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8) for t in (idx or ()))
    if ins and outs and ins[-1].device != outs[0].device:
        src = ins[-1]
        non_blocking = kwargs.get("non_blocking", args[2] if len(args) > 2 else False)
        if non_blocking and src.device.type == "cpu" and src.is_pinned():
            return False  # an asynchronous copy out of pinned memory
        return "cpu" in (src.device.type, outs[0].device.type)
    return False


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if rec._reading:
            # the operation a host read dispatches: the read is logged once
            return func(*args, **kwargs)
        written = []
        for i, name in _written_args(func):
            _tensors((args[i] if i < len(args) else kwargs.get(name),), written)
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        in_infos = tuple(rec._info(t) for t in ins)
        out = func(*args, **kwargs)
        outs = _tensors((out,), [])
        rec._op(func, ins, in_infos, written, outs, args, kwargs)
        return out


class _Functions(TorchFunctionMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if func in _FROM_HOST and kwargs.get("device") is not None and not isinstance(
                args[0] if args else None, torch.Tensor):
            # host data put on a device: on a card, a copy out of pageable
            # memory that waits for the stream (on the CPU a no-op, seen here
            # all the same)
            self.rec._read(f"torch.{name}(host data, device=...)")
        if name in HOST_READS and self.rec._reading == 0:
            self.rec._read(f"Tensor.{name}")
            self.rec._reading += 1
            try:
                return func(*args, **kwargs)
            finally:
                self.rec._reading -= 1
        return func(*args, **kwargs)


class Recorder:
    """The record of one window run (see the module docstring). Use as a
    context manager around the call; then read :attr:`ops`, :attr:`reads`,
    :attr:`nodes` and :meth:`current`."""

    def __init__(self):
        self.ops: List[OpRecord] = []
        self.reads: List[HostRead] = []
        self.nodes: List[Node] = []
        self._cur: Dict[int, int] = {}
        #: storage -> the operation whose output first lived in it
        self.born: Dict[int, int] = {}
        self._reading = 0
        self._modes = (_Functions(self), _Dispatch(self))

    # -- dataflow ------------------------------------------------------------
    def current(self, t: torch.Tensor) -> int:
        """The current version node of ``t``'s storage (a fresh external node
        for a storage the window has not touched yet)."""
        sid = storage_of(t)
        node = self._cur.get(sid)
        if node is None:
            node = self._new(sid, -1, (), tuple(t.shape))
        return node

    def _new(self, sid: int, op: int, deps, shape) -> int:
        self.nodes.append(Node(op, tuple(deps), tuple(shape)))
        self._cur[sid] = len(self.nodes) - 1
        return len(self.nodes) - 1

    def _info(self, t: torch.Tensor) -> TensorInfo:
        sid = t.untyped_storage().data_ptr()
        node = self._cur.get(sid)
        if node is None:
            node = self._new(sid, -1, (), tuple(t.shape))
        return TensorInfo(sid, node, tuple(t.shape), t.dtype, t.numel())

    def _op(self, func, ins, in_infos, written, outs, args, kwargs) -> None:
        index = len(self.ops)
        name = func._schema.name
        site = issuing_site()
        deps = tuple({i.node for i in in_infos})
        in_sids = {i.storage for i in in_infos}
        for t in written:
            if t.untyped_storage().data_ptr():
                self._new(t.untyped_storage().data_ptr(), index, deps, self.nodes[self.current(t)].shape)
        out_infos = []
        for t in outs:
            sid = t.untyped_storage().data_ptr()
            if sid and sid not in in_sids:
                self._new(sid, index, deps, tuple(t.shape))
                self.born[sid] = index
            out_infos.append(self._info(t))
        self.ops.append(OpRecord(index, name, in_infos, tuple(out_infos), site))
        kind = _SYNC_KIND.get(func)
        if kind is None:
            kind = _sync_kind(name)
            _SYNC_KIND[func] = kind
        if kind and _waits(kind, ins, outs, args, kwargs):
            self.reads.append(HostRead(name, format_site(site), port_chain()))
        if name in EXCHANGE_OPS:
            # the op's one host read of its splits, made inside the op where
            # no mode sees it
            self.reads.append(HostRead(f"{name} splits", format_site(site),
                                       (("ops/ragged_a2a.py", "_splits"),) + port_chain()))

    # -- host reads -------------------------------------------------------------
    def _read(self, kind: str) -> None:
        self.reads.append(HostRead(kind, provenance(), port_chain()))

    # -- context -------------------------------------------------------------------
    def __enter__(self) -> "Recorder":
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)

    # -- queries -------------------------------------------------------------------
    def reach(self, roots) -> set:
        """The nodes ``roots`` were computed from, themselves included."""
        seen: set = set()
        stack = list(roots)
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.nodes[n].deps)
        return seen

    def touched(self) -> set:
        """Every storage an operation of the window read or wrote."""
        out = set()
        for op in self.ops:
            out.update(i.storage for i in op.inputs)
            out.update(i.storage for i in op.outputs)
        return out

    def base_shape(self, info: TensorInfo) -> Tuple[int, ...]:
        """The shape of the tensor that made the version ``info`` reads (for
        a view, the whole plane it is a view of)."""
        return self.nodes[info.node].shape


def first_wide_input(op: OpRecord, rec: Recorder, threshold: int) -> Optional[TensorInfo]:
    """The first input of ``op`` that is, or is a view of, a wide plane."""
    for i in op.inputs:
        if is_wide(i.shape, threshold) or is_wide(rec.base_shape(i), threshold):
            return i
    return None
