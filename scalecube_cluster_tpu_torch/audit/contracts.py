"""The contract checkers: each JAX audit invariant, witnessed in torch.

The port's counterpart of the JAX package's ``audit/contracts.py``, with
its names and signatures. JAX proves each invariant over a window's
closed jaxpr and compiled HLO; eager PyTorch compiles nothing, so each
checker here reads what one run of the window at audit shapes actually
dispatched (:meth:`.programs.AuditProgram.record`) and returns a list of
:class:`Violation` — empty means WITNESSED over that run, not proved for
every input:

* :func:`check_donation_alias` — JAX's donation becomes in place: (a) each
  in-place leaf of non-zero size keeps its storage across the window; (a′)
  no operation copies that leaf whole (a ``clone``, ``_to_copy`` or
  ``copy_`` of its full size fed from it); an in-place leaf that no
  operation reads or writes is flagged as vacuous (JAX's unused donated
  leaf); (b) no non-state output (a metric, the watched rows) shares
  storage with an in-place leaf — the caller's next window would write
  into it (JAX's use-after-free shape).
* :func:`check_transfer_free` — every host read of the window comes from a
  sanctioned, counted site (:data:`SANCTIONED_SITES`: ``_tensor.host_flags``,
  counted in ``HOST_SYNCS``, and the exact exchanges' one split read); any
  other read, or operation that waits for the device, is reported with its
  source line. On a card the sync-debug mode's waits must also equal the
  sanctioned reads.
* :func:`check_no_plane_materialization` — no gather (or partial copy) of
  a wide ([N, N]-scaled) plane whose value reaches only the window's
  non-state outputs and never the state it returns. In eager torch such a
  gather costs a W x N copy per tick rather than XLA's extra plane
  materialization; the contract is JAX's either way (the r10 lesson:
  capture it as a window-boundary diff).
* :func:`check_forbid_wide_values` — pview: no operation's input or output
  anywhere in the window (a program input, an intermediate or a captured
  constant) has two capacity-scaled dims.
* :func:`check_memory_budget` — the window's peak live bytes (its inputs
  plus the peak above the pre-window baseline) stay within ``factor x``
  the budget basis ``+ overhead``.
* :func:`check_restore_seams` — the restore lint (:mod:`.restore_lint`)
  over each engine's registered ``restore_module``.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Callable, Dict, List, Optional

from . import dispatch_walk as W
from .programs import MIB, AuditProgram, budget_bytes

#: the host reads a window may take: ``(file inside the package, function)``
#: -> why it is counted
SANCTIONED_SITES = {
    ("ops/_tensor.py", "host_flags"): "a data-keyed branch's flags, one read counted in _tensor.HOST_SYNCS",
    ("ops/ragged_a2a.py", "_splits"): "an exact exchange's one host read of its splits",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract, with an actionable pointer."""

    contract: str  # "donation_alias" | "transfer_free" | ...
    program: str  # AuditProgram.name
    message: str
    where: str = ""  # source provenance (file:line (fn)) when known

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.program}: {self.contract}: {self.message}{loc}"


def _sanctioned(read: W.HostRead) -> bool:
    return any(site in SANCTIONED_SITES for site in read.chain)


# -- 1. in place (JAX: donation aliasing) ---------------------------------------------


def check_donation_alias(prog: AuditProgram, use_compiled: bool = False) -> List[Violation]:
    """See the module docstring. ``use_compiled`` is JAX's signature; the
    port has one form of a window."""
    rec = prog.record()
    if not rec.inplace:
        return []  # the window updates nothing in place; no claim to check
    r = rec.rec
    touched = r.touched()
    violations: List[Violation] = []
    leaf_of, leaf_bytes = {}, {}
    for pos, path, before, after, nbytes in rec.inplace:
        if nbytes == 0:
            continue
        leaf_of[before], leaf_bytes[path] = path, nbytes
        if before not in touched:
            violations.append(Violation(
                "donation_alias", prog.name,
                f"in-place leaf {path} ({nbytes} B) is UNUSED by the window: no operation reads or writes it, "
                "so its in-place claim is vacuous (every declared in-place leaf must be threaded through the "
                "window)",
            ))
        if after != before:
            maker = r.born.get(after, -1)
            violations.append(Violation(
                "donation_alias", prog.name,
                f"in-place leaf {path} ({nbytes} B) comes back in NEW storage: the window rebinds it instead of "
                "updating it in place, so every window holds two copies of it (the donation dropped)",
                where=r.ops[maker].where if maker >= 0 else "",
            ))
    for op in r.ops:
        if op.name not in W.COPY_OPS:
            continue
        srcs = op.inputs[1:] if op.name == "aten::copy_" else op.inputs
        for i in srcs:
            path = leaf_of.get(i.storage)
            if path is not None and i.numel * i.dtype.itemsize == leaf_bytes[path]:
                violations.append(Violation(
                    "donation_alias", prog.name,
                    f"{op.name} copies in-place leaf {path} WHOLE ({i.shape}): a second copy of the leaf every "
                    "window (the donation dropped)",
                    where=op.where,
                ))
    for label, sid, _ in rec.extras:
        path = leaf_of.get(sid) or next((p for _, p, _, a, n in rec.inplace if n and a == sid), None)
        if path is not None:
            violations.append(Violation(
                "donation_alias", prog.name,
                f"non-state output {label!r} shares storage with in-place leaf {path}: it escapes the window "
                "UNCHANGED alongside the leaf's in-place update, and the next window overwrites what the caller "
                "holds (the use-after-free shape); return a copy or a reduction",
            ))
    return _dedupe(violations)


# -- 2. transfer-freeness ---------------------------------------------------------------


def check_transfer_free(prog: AuditProgram) -> List[Violation]:
    rec = prog.record()
    violations: List[Violation] = []
    counts: Dict[tuple, int] = {}
    for read in rec.rec.reads:
        if not _sanctioned(read):
            counts[(read.kind, read.where)] = counts.get((read.kind, read.where), 0) + 1
    for (kind, where), n in counts.items():
        violations.append(Violation(
            "transfer_free", prog.name,
            f"{kind} moves data between the host and the device {n} time(s) in the window outside the "
            f"sanctioned, counted sites ({', '.join(f'{f}: {fn}' for f, fn in SANCTIONED_SITES)}): on a card "
            "each one stalls the host on the stream",
            where=where,
        ))
    mem = prog._memory
    if mem is not None and "device_waits" in mem:
        sanctioned = sum(1 for read in rec.rec.reads if _sanctioned(read))
        if mem["device_waits"] != sanctioned:
            violations.append(Violation(
                "transfer_free", prog.name,
                f"the sync-debug mode counted {mem['device_waits']} device wait(s) in the window against "
                f"{sanctioned} sanctioned read(s) (wait sites: {', '.join(mem['wait_sites']) or 'none'})",
            ))
    return violations


# -- 3. no wide-plane gather that only the outputs see ----------------------------------


def check_no_plane_materialization(prog: AuditProgram) -> List[Violation]:
    if not prog.is_window:
        return []
    rec = prog.record()
    r = rec.rec
    feeds_carry = r.reach(rec.carry_nodes)
    feeds_ys = r.reach(rec.ys_nodes)
    violations: List[Violation] = []
    for op in r.ops:
        gather = op.name in W.GATHER_OPS
        if not gather and op.name not in W.COPY_OPS:
            continue
        src = W.first_wide_input(op, r, prog.wide_threshold)
        if src is None or (not gather and src.numel >= _base_numel(r, src)):
            continue  # a copy of a whole plane is the donation contract's
        outs = {o.node for o in op.outputs}
        if outs and outs <= feeds_ys and not outs & feeds_carry:
            violations.append(Violation(
                "no_plane_materialization", prog.name,
                f"{op.name} of wide plane {r.base_shape(src)} feeds ONLY the window's non-state outputs: an "
                "extra copy out of the plane every tick that the next state never reads (the r10 "
                "materialization pattern); capture it as a window-boundary diff instead",
                where=op.where,
            ))
    return _dedupe(violations)


def _base_numel(r: W.Recorder, info: W.TensorInfo) -> int:
    n = 1
    for d in r.base_shape(info):
        n *= d
    return n


# -- 4. pview: no [N, N]-scaled value anywhere -----------------------------------------------


def check_forbid_wide_values(prog: AuditProgram) -> List[Violation]:
    if not prog.contracts.forbid_wide_values:
        return []
    rec = prog.record()
    r = rec.rec
    violations: List[Violation] = []
    seen: set = set()
    for op in r.ops:
        for role, infos in (("input", op.inputs), ("output", op.outputs)):
            for i in infos:
                if not W.is_wide(i.shape, prog.wide_threshold) or i.shape in seen:
                    continue
                seen.add(i.shape)
                if role == "output":
                    how = f"built by '{op.name}'"
                elif i.storage in rec.arg_storages:
                    how = f"a program INPUT read by '{op.name}'"
                elif r.nodes[i.node].op < 0:
                    how = f"a CAPTURED CONSTANT read by '{op.name}'"
                else:
                    how = f"read by '{op.name}'"
                violations.append(Violation(
                    "forbid_wide_values", prog.name,
                    f"value of capacity-squared shape {i.shape}, {how} — the partial-view engine admits no "
                    "[N, N]-proportional value anywhere (the O(N·k) contract)",
                    where=op.where,
                ))
    return violations


# -- 5. the memory budget ------------------------------------------------------------------


def check_memory_budget(prog: AuditProgram) -> List[Violation]:
    mem = prog.memory()
    peak = mem["peak_live_bytes"]
    budget = budget_bytes(prog)
    if peak > budget:
        return [Violation(
            "memory_budget", prog.name,
            f"peak {peak} B ({peak / MIB:.2f} MiB) exceeds the declared budget {budget} B = "
            f"{prog.contracts.memory_factor} x basis {prog.budget_basis_bytes} B + "
            f"{prog.contracts.memory_overhead_mib} MiB overhead (inputs {mem['argument_size_in_bytes']} B + "
            f"peak above the baseline {mem['peak_above_baseline_bytes']} B, {mem['instrument']})",
        )]
    return []


# -- 6. the restore seams ---------------------------------------------------------------------


def check_restore_seams(engine_names=None, modules: Optional[Dict[str, str]] = None) -> List[Violation]:
    """The restore lint (:mod:`.restore_lint`) over every engine's registered
    ``restore_module`` — the one contract no window run can witness (the
    alias happens on the host, before any window). ``modules`` overrides
    the registry with ``{name: module or file path}``."""
    from .restore_lint import lint_file

    if modules is None:
        from ..ops import engine_api

        modules = {name: engine_api.engine(name).contracts.restore_module
                   for name in engine_names or ("dense", "sparse", "pview")}
    violations: List[Violation] = []
    for name, module in modules.items():
        if not module:
            violations.append(Violation(
                "restore_seam", name,
                "engine registers no restore_module — the restore copy rule is unverifiable for it; set "
                "EngineContracts.restore_module",
            ))
            continue
        path = module if os.path.exists(module) else importlib.import_module(module).__file__
        for f in lint_file(path):
            violations.append(Violation("restore_seam", name, f"{f.message} (in {f.function})",
                                        where=f"{W._rel(f.path)}:{f.line}"))
    return violations


def _dedupe(violations: List[Violation]) -> List[Violation]:
    out, seen = [], set()
    for v in violations:
        if (v.message, v.where) not in seen:
            seen.add((v.message, v.where))
            out.append(v)
    return out


# -- dispatch ---------------------------------------------------------------------------------

#: contract name -> checker
CHECKERS: Dict[str, Callable[[AuditProgram], List[Violation]]] = {
    "donation_alias": check_donation_alias,
    "transfer_free": check_transfer_free,
    "no_plane_materialization": check_no_plane_materialization,
    "forbid_wide_values": check_forbid_wide_values,
    "memory_budget": check_memory_budget,
}


def applicable_contracts(prog: AuditProgram, compile_programs: bool = True):
    """The contracts that apply to ``prog`` (JAX's rule; ``compile_programs``
    adds the memory budget, which needs the measured run)."""
    c = prog.contracts
    names = []
    if c.donation_alias:
        names.append("donation_alias")
    if c.transfer_free:
        names.append("transfer_free")
    if c.no_plane_materialization and prog.is_window:
        names.append("no_plane_materialization")
    if c.forbid_wide_values:
        names.append("forbid_wide_values")
    if compile_programs:
        names.append("memory_budget")
    return names


def run_contracts(prog: AuditProgram, compile_programs: bool = True) -> Dict[str, List[Violation]]:
    """Every applicable contract for one program. ``compile_programs`` keeps
    JAX's name: here it is the measured run (the memory budget, and on a
    card the waits and launches), which the fast mode skips."""
    if compile_programs:
        prog.memory()  # before transfer_free: on a card it reads the waits
    return {name: CHECKERS[name](prog) for name in applicable_contracts(prog, compile_programs)}
