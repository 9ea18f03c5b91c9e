"""The comparison's control: the plain reference put in the program's place
with one guarantee of the configuration broken (the last fanout slot's
gossip deliveries left out: fanout 2 where the configuration states 3),
compared with the true reference exactly as a run compares the program,
at the cell's own configuration on the first CUDA card.

    python3 perfbench/control.py --workload <cell> --requests <r> --seeds <n> [<n> ...]

from the root of a checkout. ``--requests`` is the number of timed
requests a run of the cell completes (its result's ``attempted``): the
control compares the warm requests and that many more, as a run does.
Prints, for each seed, the two numbers a run compares
(``state_rows_differing``, ``metric_values_differing``) as one JSON line.
A limit of 0 on both holds only where the control reads more than 0 on at
least one of them, on every seed.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_readings(cfg: dict, mix: dict, seed: int, device, requests: int) -> dict:
    """The control against the true reference on one seed, over the warm
    requests and ``requests`` timed ones."""
    import torch

    from perfbench.harness import cell, digest, traffic

    total = traffic.warm_requests(mix) + requests
    t0 = time.perf_counter()
    true_dig, true_ms = cell.run_reference(cfg, mix, seed, device, total)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ctl_dig, ctl_ms = cell.run_reference(cfg, mix, seed, device, total, drop_slot=True)
    rows = digest.differing_rows(ctl_dig, true_dig)
    vals, names = cell.differing_values(ctl_ms, true_ms)
    return {"seed": seed, "requests": total, "state_rows_differing": sum(rows.values()),
            "metric_values_differing": vals, "leaves": rows, "metrics": names,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cellspec = next(w for w in spec["workloads"] if w["name"] == args.workload)
    conf = next(c for c in spec["configs"] if c["name"] == cellspec["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((ROOT / "perfbench" / "traffic" / f"{cellspec['traffic']}.json").read_text())
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **control_readings(cfg, mix, seed, "cuda:0", args.requests)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
