"""Nothing the benchmark loads on the chip path has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``scalecube_cluster_tpu`` (names compared
whole: the port's own name begins with the last)."""

import json
import subprocess
import sys

from benchhelp import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.run  # the entry point's own imports
from perfbench.harness import cell
from benchhelp import SMALL, config, spec, traffic
for c in spec()["workloads"]:
    cfg = config(c["config"], **SMALL[c["config"]])
    cell.run_cell(cfg, traffic(c["traffic"], warm_ticks=4), 3, 0.3, False, "cpu", lambda: 0.0)
print(json.dumps({{"forbidden": cell.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_chip_path_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True, text=True,
                         cwd=str(ROOT / "perfbench" / "tests"), timeout=600, env={"PYTHONPATH": str(ROOT / "perfbench" / "tests"),
                                                                                "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "scalecube_cluster_tpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "scalecube_cluster_tpu"} & set(got["top"])
