"""A second witness for config15's zero-false-DEAD rule.

config15 certifies a shifting-conditions cell only when its controlled arm
records no false-DEAD scenario in 512. This script runs
``certify_controller_mc`` over one cell at another seed set, with the JAX
package or with the port on its own torch generator, on the CPU, so that a
cell's verdict can be read on several disjoint seed sets of either package.
``--base-seed`` shifts every scenario's draws (JAX: ``PRNGKey(1000 +
base + s)``; the port: its generator seeded ``1000 + base``), crash row
and storm floor, as ``certify_controller_mc(base_seed=)`` does.

Run from the repo root (about 4 minutes per JAX run and 6 per port run on
8 CPU cores):

    JAX_PLATFORMS=cpu python reference/config15_witness.py --package jax --base-seed 4000
    python reference/config15_witness.py --package torch --base-seed 8000

Prints one line per arm, then ``RESULT`` with the verdict and the
controlled arm's false-DEAD scenarios.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--base-seed", type=int, required=True)
    ap.add_argument("--cell", default="migrating_asym_loss")
    ap.add_argument("--seeds", type=int, default=512)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    kw = dict(n=48, n_seeds=args.seeds, window=8, base_seed=args.base_seed, vary_storm_pct=(20.0, 24.0, 28.0),
              log=print)
    if args.package == "jax":
        from scalecube_cluster_tpu.chaos import shifting as SH
        from scalecube_cluster_tpu.control import certify_controller_mc
    else:
        from scalecube_cluster_tpu_torch.chaos import shifting as SH
        from scalecube_cluster_tpu_torch.control import certify_controller_mc

        kw["device"] = "cpu"
    t0 = time.perf_counter()
    cert = certify_controller_mc(cells=[getattr(SH, args.cell)(n=48)], **kw)
    e = cert["entries"][0]
    print(f"RESULT {args.package} {args.cell} base seed {args.base_seed}: certified {e['certified']}, controlled "
          f"false-DEAD {e['controlled_false_dead']} of {args.seeds}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
