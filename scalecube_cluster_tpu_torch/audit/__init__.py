"""The program-audit plane of the port: runtime contracts over every window.

The port's counterpart of the JAX package's ``audit/`` (JAX r12). JAX
proves its load-bearing invariants over each engine's compiled window
programs. PyTorch runs eagerly and has no program to prove anything over,
so the port witnesses the same invariants over the operations each window
actually dispatches, on concrete inputs at JAX's audit shapes (capacity
128, sharded 256, 4 ticks, S = 4), on the CPU and on the card:

* in place (JAX: donation aliasing): in-place leaves keep their storage,
  are never copied whole, are really used, and no output aliases them;
* transfer-freeness: every host read is a sanctioned, counted one (on a
  card, the sync-debug waits equal them);
* no gather of a wide plane that feeds only a window's outputs;
* pview's no-[N, N]-value guarantee, over every tensor of the window;
* the per-engine memory budgets, from the allocator's own peak;
* the restore copy rule, by the port's own AST lint over each engine's
  registered ``restore_module``.

Each engine declares its contracts on
:class:`..ops.engine_api.EngineContracts` (JAX's values) and its in-place
leaves on its ``EngineOps``. ``python -m scalecube_cluster_tpu_torch.audit``
is the CLI; ``tests/test_torch_audit.py`` holds the matrix against JAX's
and seeds one violation per contract.
"""

from .contracts import (
    CHECKERS,
    SANCTIONED_SITES,
    Violation,
    applicable_contracts,
    check_donation_alias,
    check_forbid_wide_values,
    check_memory_budget,
    check_no_plane_materialization,
    check_restore_seams,
    check_transfer_free,
    run_contracts,
)
from .programs import (
    DEFAULT_CAPACITY,
    DEFAULT_FLEET_SCENARIOS,
    DEFAULT_N_TICKS,
    DEFAULT_SHARDED_CAPACITY,
    AuditProgram,
    build_engine_programs,
    build_matrix,
)
from .report import audit_all, audit_programs, format_text

__all__ = [
    "AuditProgram",
    "CHECKERS",
    "DEFAULT_CAPACITY",
    "DEFAULT_FLEET_SCENARIOS",
    "DEFAULT_N_TICKS",
    "DEFAULT_SHARDED_CAPACITY",
    "SANCTIONED_SITES",
    "Violation",
    "applicable_contracts",
    "audit_all",
    "audit_programs",
    "build_engine_programs",
    "build_matrix",
    "check_donation_alias",
    "check_forbid_wide_values",
    "check_memory_budget",
    "check_no_plane_materialization",
    "check_restore_seams",
    "check_transfer_free",
    "format_text",
    "run_contracts",
]
