"""The program-audit CLI: every contract over every window the port runs.

The port's counterpart of the JAX package's ``tools/audit_programs.py``,
with its flags and ``--device``::

    python -m scalecube_cluster_tpu_torch.audit --all --device cpu
    python -m scalecube_cluster_tpu_torch.audit --all --json --out audit.json
    python -m scalecube_cluster_tpu_torch.audit --engine pview --variants unarmed,traced

``--device`` defaults to ``cuda``, as every entry point of the port. The
sharded programs run on a one-rank process group that the CLI starts
(gloo on the CPU, NCCL on a card). Exit status 0 when every contract
holds, 1 on any violation.
"""

from __future__ import annotations

import argparse
import json
import sys

from .programs import VARIANTS

ENGINES = ("dense", "sparse", "pview")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m scalecube_cluster_tpu_torch.audit",
                                 description="runtime program audit over the port's engine windows")
    ap.add_argument("--all", action="store_true", help="audit every engine (default when no --engine)")
    ap.add_argument("--engine", action="append", choices=ENGINES, help="audit one engine (repeatable)")
    ap.add_argument("--variants", default=None, help=f"comma list from {VARIANTS} (default: all)")
    ap.add_argument("--capacity", type=int, default=128, help="member capacity of the one-device audit shapes")
    ap.add_argument("--sharded-capacity", type=int, default=256,
                    help="capacity of the member-mesh shapes (capacity %% (32 * ranks) == 0)")
    ap.add_argument("--n-ticks", type=int, default=4, help="ticks per audited window")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the measured run: no memory budget, no device waits (the fast mode)")
    ap.add_argument("--device", default="cuda", help="the device the windows run on (default: cuda)")
    ap.add_argument("--json", action="store_true", help="print the machine-readable verdict")
    ap.add_argument("--out", default=None, help="also write the JSON verdict to this path")
    args = ap.parse_args(argv)

    engines = args.engine if args.engine else list(ENGINES)
    variants = args.variants.split(",") if args.variants else None
    if variants:
        bad = set(variants) - set(VARIANTS)
        if bad:
            ap.error(f"unknown variants {sorted(bad)}; pick from {VARIANTS}")

    from .report import audit_all, format_text

    verdict = audit_all(engines=engines, capacity=args.capacity, n_ticks=args.n_ticks, variants=variants,
                        sharded_capacity=args.sharded_capacity, compile_programs=not args.no_compile,
                        device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(verdict) if args.json else format_text(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
