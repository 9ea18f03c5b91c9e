"""The JAX package's records behind chip_smoke.py's phases 43 and 44.

chip_smoke.py runs config15's controller certification and config17's
incident replay on the card with the JAX package's own key chains
(``scalecube_cluster_tpu_torch/ops/keychain.py``) and holds every count it
gets against the JAX package's record of the same run. The records
committed beside the benchmarks (``CONTROL_BENCH_r16.json``,
``REPLAY_BENCH_r18.json``) were written by earlier versions of the JAX
code; this script reruns the same two workloads with the JAX package as it
is now, on the CPU, and writes:

* ``reference/config15_certification.jax.json`` — ``certify_controller_mc``
  as ``benchmarks/config15_control.py: run_certification`` publishes it
  (N = 48, 512 seeds per cell, 8-tick windows, storm floors 20/24/28%);
* ``reference/config17_replay.jax.json`` — ``benchmarks/config17_replay.py``
  at its defaults (N = 24, 256 seeds, detect budget 60, horizon 96).

Run from the repo root (about 15 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python reference/jax_records.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    sys.path.insert(0, ROOT)
    out17 = os.path.join(ROOT, "reference", "config17_replay.jax.json")
    subprocess.run([sys.executable, os.path.join(ROOT, "benchmarks", "config17_replay.py"), "--out", out17],
                   check=True, cwd=os.path.join(ROOT, "benchmarks"))
    from config15_control import run_certification

    cert = run_certification(48, 512)
    with open(os.path.join(ROOT, "reference", "config15_certification.jax.json"), "w") as fh:
        json.dump({"config": "config15_control", "certification": cert}, fh, indent=1)
    return 0 if cert["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
