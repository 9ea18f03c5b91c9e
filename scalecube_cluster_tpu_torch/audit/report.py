"""Verdict assembly: one machine-readable dict per audit run.

The port's counterpart of the JAX package's ``audit/report.py``, with its
keys (a flat program list with per-contract verdicts), plus ``device`` (per
program and for the run: a CPU run says it is one).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from . import contracts as C
from .programs import AuditProgram, build_matrix, check_instruments

SCHEMA = 1


def audit_programs(
    programs: Sequence[AuditProgram],
    compile_programs: bool = True,
    engine_names: Optional[Sequence[str]] = None,
    restore_seams: bool = True,
    device=None,
) -> Dict:
    """Run every applicable contract over ``programs`` and assemble the
    verdict dict. ``compile_programs=False`` skips the measured run (no
    memory figures, no waits) — the fast mode."""
    t0 = time.perf_counter()
    dev = str(device if device is not None else (programs[0].device if programs else "cpu"))
    instrument = check_instruments(dev) if compile_programs else None
    entries: List[Dict] = []
    n_violations = 0
    for prog in programs:
        per_contract = C.run_contracts(prog, compile_programs)
        entry = {
            "program": prog.name,
            "engine": prog.engine,
            "variant": prog.variant,
            "key_dtype": prog.key_dtype,
            "capacity": prog.capacity,
            "n_ticks": prog.n_ticks,
            "mesh_size": prog.mesh_size,
            "donated_leaves": len(prog.donated_leaf_info()),
            "budget_basis_bytes": prog.budget_basis_bytes,
            "device": prog.device,
            "contracts": {},
        }
        for name, violations in per_contract.items():
            entry["contracts"][name] = {
                "ok": not violations,
                "violations": [{"message": v.message, "where": v.where} for v in violations],
            }
            n_violations += len(violations)
        if compile_programs:
            entry["memory"] = dict(prog.memory())
        entries.append(entry)

    seam_violations: List[C.Violation] = []
    if restore_seams:
        seam_violations = C.check_restore_seams(engine_names)
        n_violations += len(seam_violations)

    return {
        "schema": SCHEMA,
        "generated_by": "scalecube_cluster_tpu_torch.audit",
        "torch_version": torch.__version__,
        "device": dev,
        "device_name": torch.cuda.get_device_name(torch.device(dev)) if torch.device(dev).type == "cuda" else "cpu",
        "instrument": instrument,
        "compiled": compile_programs,
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "n_programs": len(entries),
        "n_violations": n_violations,
        "ok": n_violations == 0,
        "programs": entries,
        "restore_seams": {
            "checked": restore_seams,
            "ok": not seam_violations,
            "violations": [{"engine": v.program, "message": v.message, "where": v.where} for v in seam_violations],
        },
    }


@contextlib.contextmanager
def process_group(device):
    """A member mesh over the process group, starting a one-rank group (gloo
    on the CPU, NCCL on a card) when none is up and ending it after; yields
    the mesh."""
    import torch.distributed as dist

    from ..ops import dcn
    from ..ops.sharding import make_mesh

    kind = torch.device(device).type
    if dist.is_initialized():
        yield make_mesh(kind)
        return
    with tempfile.TemporaryDirectory(prefix="audit-pg-") as tmp:
        dcn.initialize(f"file://{os.path.join(tmp, 'init')}", 1, 0, device=device)
        try:
            yield make_mesh(kind)
        finally:
            dist.destroy_process_group()


def audit_all(
    engines: Optional[Sequence[str]] = None,
    capacity: int = 128,
    n_ticks: int = 4,
    variants: Optional[Sequence[str]] = None,
    sharded_capacity: int = 256,
    compile_programs: bool = True,
    device="cuda",
) -> Dict:
    """Build the matrix on ``device`` and audit it — the CLI's and the
    tests' entry point. The sharded programs run on the process group's
    member mesh (a one-rank group when none is up)."""
    engines = list(engines or ("dense", "sparse", "pview"))
    from ..ops import engine_api

    meshed = (variants is None or "sharded" in variants) and any(engine_api.engine(e).supports_mesh for e in engines)
    scope = process_group(device) if meshed else contextlib.nullcontext()
    with scope as mesh:
        programs = build_matrix(engines, capacity=capacity, n_ticks=n_ticks, variants=variants,
                                sharded_capacity=sharded_capacity, device=device, mesh=mesh)
        return audit_programs(programs, compile_programs=compile_programs, engine_names=engines, device=device)


def format_text(verdict: Dict) -> str:
    """Human rendering of one verdict dict (the CLI's default output)."""
    lines: List[str] = []
    ok = "PASS" if verdict["ok"] else "FAIL"
    lines.append(
        f"program audit: {ok} — {verdict['n_programs']} program(s), {verdict['n_violations']} violation(s), "
        f"{verdict['elapsed_s']}s on {verdict['device']} ({verdict['device_name']}; torch "
        f"{verdict['torch_version']}, {verdict['instrument'] or 'not measured'})"
    )
    for entry in verdict["programs"]:
        marks = [f"{c}={'ok' if v['ok'] else 'VIOLATED'}" for c, v in entry["contracts"].items()]
        mem = entry.get("memory")
        memtxt = f" peak={mem['peak_live_bytes']}B/budget={mem['budget_bytes']}B" if mem else ""
        if mem and "device_waits" in mem:
            memtxt += f" waits={mem['device_waits']} launches={mem['kernel_launches']}"
        lines.append(f"  {entry['program']}: {' '.join(marks)}{memtxt}")
        for cname, c in entry["contracts"].items():
            for v in c["violations"]:
                where = f" [{v['where']}]" if v["where"] else ""
                lines.append(f"    ! {cname}: {v['message']}{where}")
    seams = verdict["restore_seams"]
    if seams["checked"]:
        lines.append(f"  restore seams: {'ok' if seams['ok'] else 'VIOLATED'}")
        for v in seams["violations"]:
            lines.append(f"    ! {v['engine']}: {v['message']} [{v['where']}]")
    return "\n".join(lines)
