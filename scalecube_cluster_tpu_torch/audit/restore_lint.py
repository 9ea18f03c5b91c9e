"""The restore-copy lint: no zero-copy host alias enters a state.

The port's own copy of the rules of the JAX package's
``tools/lint_donation_safety.py``, written for torch. The bug class: a
checkpoint restore that wraps the archive's numpy arrays without copying
them. On the CPU ``torch.from_numpy``, ``torch.as_tensor`` and
``torch.asarray`` alias the numpy buffer, and ``.to("cpu")`` then copies
nothing, so the restored state shares memory with the archive: the next
window, which updates its planes in place, writes into the caller's
arrays, and the archive's owner freeing them leaves the state on freed
memory. The copy must be explicit: ``np.array(..., copy=True)``,
``np.copy``, ``.copy()`` of the array, ``.clone()`` of the tensor, or
``torch.tensor`` (which always copies).

Rules (AST only; the linted module is never imported):

1. In a restore path — a function whose name contains ``restore`` or
   ``from_numpy`` (the port's engines restore through
   ``convert.state_from_numpy``) — every ``torch.from_numpy`` /
   ``torch.as_tensor`` / ``torch.asarray`` must wrap an explicit copy or be
   cloned.
2. In a function that calls ``np.load`` (it deserializes an archive): the
   same.
3. In ``ops/engine_api.py`` (the module whose closures build each engine's
   state): every such call, in a function or at module level.

A line may opt out with a ``# lint: allow-zero-copy`` comment that states
its reason. A module in which no rule applies anywhere holds no restore
path the lint can check: :func:`lint_file` reports that too, so a
registered restore module never passes vacuously.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

SUPPRESS = "lint: allow-zero-copy"

#: the torch spellings that may alias a numpy buffer
_ALIAS_CHAINS = {("torch", "from_numpy"), ("torch", "as_tensor"), ("torch", "asarray")}
_NPLOAD_CHAINS = {("np", "load"), ("numpy", "load")}
#: calls whose result is a copy of their argument
_COPY_CHAINS = {("np", "copy"), ("numpy", "copy")}
_ARRAY_CHAINS = {("np", "array"), ("numpy", "array")}
_SEAM_BASENAMES = {"engine_api.py"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    function: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: in {self.function}: {self.message}"


def attr_chain(node: ast.AST) -> Optional[tuple]:
    """``torch.from_numpy`` -> ("torch", "from_numpy"); None for a callee
    that is not a plain attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _calls(root: ast.AST) -> Iterator[Tuple[ast.Call, tuple]]:
    for node in ast.walk(root):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain is not None:
                yield node, chain


def _is_copy(expr: ast.AST) -> bool:
    """Whether ``expr`` evaluates to a fresh copy of an array."""
    if not isinstance(expr, ast.Call):
        return False
    chain = attr_chain(expr.func)
    if chain in _COPY_CHAINS:
        return True
    if chain in _ARRAY_CHAINS:
        return any(kw.arg == "copy" and isinstance(kw.value, ast.Constant) and kw.value.value is True
                   for kw in expr.keywords)
    return isinstance(expr.func, ast.Attribute) and expr.func.attr == "copy" and not expr.args


def _copies(call: ast.Call, parents: dict) -> bool:
    """Whether the aliasing ``call`` is made safe by an explicit copy: of its
    argument, by ``copy=True`` (``torch.asarray``), or by a ``.clone()`` of
    its result."""
    if call.args and _is_copy(call.args[0]):
        return True
    if any(kw.arg == "copy" and isinstance(kw.value, ast.Constant) and kw.value.value is True
           for kw in call.keywords):
        return True
    up = parents.get(id(call))
    while isinstance(up, ast.Attribute):
        if up.attr == "clone":
            return True
        call_up = parents.get(id(up))
        if not isinstance(call_up, ast.Call):
            return False
        up = parents.get(id(call_up))
    return False


def _suppressed(lines: List[str], lineno: int) -> bool:
    return 0 < lineno <= len(lines) and SUPPRESS in lines[lineno - 1]


def lint_file(path: str) -> List[Finding]:
    """The findings of the three rules in one file (see the module
    docstring), plus one when no rule applies anywhere in it."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "<module>", f"cannot parse: {e.msg}")]
    lines = source.splitlines()
    parents = {id(child): node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    seam = os.path.basename(path) in _SEAM_BASENAMES
    functions = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # the module first, then each function outer to inner (ast.walk's
    # order): the innermost qualifying scope names a call site
    scopes = [(tree, "<module>", "the engine_api state seam")] if seam else []
    for fn in functions:
        name = fn.name.lower()
        is_restore = "restore" in name or "from_numpy" in name
        loads = any(chain in _NPLOAD_CHAINS for _, chain in _calls(fn))
        if is_restore or loads or seam:
            why = ("a restore path" if is_restore else "a function that deserializes numpy archives" if loads
                   else "the engine_api state seam")
            scopes.append((fn, fn.name, why))
    by_site: dict = {}
    for scope, owner, why in scopes:
        for call, chain in _calls(scope):
            if chain in _ALIAS_CHAINS and not _suppressed(lines, call.lineno) and not _copies(call, parents):
                by_site[(call.lineno, call.col_offset)] = Finding(
                    path, call.lineno, owner,
                    f"{'.'.join(chain)} in {why} can zero-copy the archive's host buffer into a state that "
                    "windows update in place; copy it explicitly (np.array(..., copy=True), .clone(), "
                    "torch.tensor)",
                )
    out = [by_site[k] for k in sorted(by_site)]
    if not scopes:
        out.append(Finding(path, 1, "<module>",
                           "no restore path here: no function named *restore* or *from_numpy* and no np.load "
                           "call, so the restore rule would pass vacuously; register the module where the "
                           "engine's restore copies the archive's arrays"))
    return out
