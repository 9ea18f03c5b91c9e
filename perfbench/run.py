"""The benchmark of the PyTorch and CUDA port (``scalecube_cluster_tpu_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Runs one cell of ``BENCHMARK.json`` once and prints one JSON line as the
last line of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``limits``: each number compared with the plain
reference beside its limit, which also close standard error. Exits with a
non-zero code and prints no result when no CUDA card is present, when the
cell asks for more cards than there are, or when a JAX module is loaded.

A cell is found by its name in ``BENCHMARK.json``; its configuration
(``perfbench/configs/<config>.json``), traffic mix
(``perfbench/traffic/<traffic>.json``) and per-layer metric readers
(``perfbench/metrics/<metric>.py``, by the part of the metric's name
before its first dot) are files of their own, the traffic's mutation
sources (``perfbench/sources/<kind>.py``) too, and the
configuration's ``engine`` names the adapter of the system under test
(``perfbench/engines/<engine>.py``) and its plain reference
(``perfbench/reference/<engine>.py``).
"""

import os
import time

_P0 = time.perf_counter()


def _proc_age() -> float:
    """Seconds since this process started (the kernel's record)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


_AGE0 = _proc_age()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = pathlib.Path(__file__).resolve().parent
# every build and kernel cache at a fixed place inside the checkout
CACHE = ROOT / "build" / "perfbench"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def since_start() -> float:
    return _AGE0 + (time.perf_counter() - _P0)


def find(spec: dict, key: str, name: str) -> dict:
    for entry in spec[key]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {key} entry named {name!r} in BENCHMARK.json")


def base(name: str) -> str:
    """The quantity a metric's name measures: the part before its first
    dot (``member_ticks_per_s.sparse`` is ``member_ticks_per_s`` in the
    sparse cells), which also names its reader under ``perfbench/metrics/``."""
    return name.split(".")[0]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def breakdown(trace: dict, window_us: float) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps of the device, each named by the innermost benchmark range open
    on the host when it began."""
    from perfbench.harness import stats

    ops = sorted(trace["ops_us"].items(), key=lambda kv: -kv[1])[:10]
    busy = trace["busy"]
    if not busy:
        return {"device_ops": [], "idle_gaps": []}
    lo = min(a for a, _ in busy)
    gaps = sorted(stats.gaps(busy, lo, lo + window_us), key=lambda g: g[0] - g[1])[:10]
    ranges = trace["ranges"]

    def label(t):
        open_ = [(b - a, name) for a, b, name in ranges if a <= t < b]
        return min(open_)[1] if open_ else "host outside the benchmark's ranges"

    return {"device_ops": [[name, us / 1e6] for name, us in ops],
            "idle_gaps": [[label(a), (b - a) / 1e6] for a, b in gaps]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find(spec, "workloads", args.workload)
    cfg = json.loads((ROOT / find(spec, "configs", cell["config"])["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    import torch

    # one process with one host thread: the tick's host work is one
    # Python thread, and the card's neighbours share the host's cores
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"this cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from perfbench.harness import cell as harness
    from scalecube_cluster_tpu_torch import compile_cache

    # the port's nvcc builds go to the benchmark's cache, not the port's
    # default directory
    compile_cache.enable_persistent_compile_cache(str(CACHE))
    res = harness.run_cell(cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda:0", since_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    cmp_ = res["compare"]
    limits = {"state_rows_differing": {"value": cmp_["state_rows_differing"], "limit": 0},
              "metric_values_differing": {"value": cmp_["metric_values_differing"], "limit": 0}}
    correct = all(v["value"] <= v["limit"] for v in limits.values())
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
              "memory_peak_bytes": int(res["window"]["peak_bytes"])}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    w = res["window"]
    print(f"{args.workload} seed {args.seed}: {w['requests']} requests, {w['ticks']} ticks in "
          f"{w['window_s']:.3f} s; set-up {w['setup_s']:.3f} s ({w['warm_requests']} warm requests "
          f"{w['warm_s']:.3f} s, the first {', '.join(f'{x:.3f}' for x in w['first_requests_s'])}); "
          f"reference {w['reference_s']:.3f} s over {w['warm_requests'] + w['requests']} requests; "
          f"pool occupancy by fifths {[round(x, 4) for x in w['pool']]}", file=sys.stderr)
    if args.trace:
        ctx = res["layer_ctx"]
        trace = ctx["trace"]
        from perfbench.harness import stats

        busy_us = stats.union_length(trace["busy"])
        ctx["busy_us"] = busy_us
        metrics = {}
        for m in spec["per_layer"]:
            if not applies(m, args.workload):
                continue
            value = importlib.import_module(f"perfbench.metrics.{base(m['name'])}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = busy_us / 1e6
        device["window_s"] = ctx["window_s"]
        out["metrics"] = metrics
        out["device"] = device
        out["breakdown"] = breakdown(trace, ctx["window_s"] * 1e6)
        print(f"card: {power_limit()} (beside delivery_combine_roofline)", file=sys.stderr)
    else:
        out["metrics"] = {m["name"]: {"value": res["e2e"][base(m["name"])], "unit": units[m["name"]]}
                          for m in spec["end_to_end"] if applies(m, args.workload)}
        out["device"] = device
    if cmp_["leaves"] or cmp_["metrics"]:
        print(f"differs from the reference in leaves {cmp_['leaves']} and metrics {cmp_['metrics']}",
              file=sys.stderr)
    # what the window did, for a reader of the result
    out["window"] = {"ticks": w["ticks"], "request_ms_min_median_max": w["request_ms"],
                     "warm_requests": w["warm_requests"], "reference_s": w["reference_s"],
                     "pool_occupancy_by_fifths": w["pool"], "metric_totals": w["totals"]}
    out["limits"] = limits
    for name, v in limits.items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
