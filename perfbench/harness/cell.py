"""One run of one cell: set-up, the warm requests, the timed window, the
comparison with the plain reference, the result line.

Order of a run:

1. the system under test is loaded and its start state made on the device
   from the seed-made inputs (the configuration's sizes, the traffic's
   schedule);
2. the warm requests: the first ``warm_ticks`` ticks of the cell's own
   traffic go through the window's own call (the same requests the window
   makes, which also warm up every shape the window uses) and bring the
   cluster to the state the window measures; their metrics are kept;
3. the timed window: requests, one after another, until ``--seconds``
   have passed; each request applies the mutations due, runs its ticks and
   reads its metrics back to the host;
4. the peak memory is read, the state at the window's close digested leaf
   by leaf and the system's state freed; the plain reference, given the
   same seed-made inputs, steps every request the program ran (warm and
   timed) from its own start state; the digests and every tick's metrics
   are compared.

The end-to-end metrics come from a run with ``--trace 0``; ``--trace 1``
runs the same requests under the profiler, with the benchmark's ranges
around the layers, and reports the per-layer metrics.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import digest, stats, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "scalecube_cluster_tpu")


def generator(seed: int, device) -> torch.Generator:
    """The draw generator of a run (the seed-made input of every tick's
    uniforms), the same on both sides of the comparison."""
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + 0x5EED) % (1 << 63))


def read_metrics(ms: dict) -> dict:
    """A request's metrics on the host: one transfer, each value exact in
    float64; {name: [ticks, ...] array}."""
    names = list(ms)
    flat = [ms[k].reshape(ms[k].shape[0], -1).to(torch.float64) for k in names]
    host = torch.cat(flat, 1).cpu().numpy()
    out, col = {}, 0
    for k, f in zip(names, flat):
        out[k] = host[:, col : col + f.shape[1]]
        col += f.shape[1]
    return out


def metric_rows(reqs: list) -> list:
    """Per-tick {name: float64 array} from the requests' readings."""
    rows = []
    for r in reqs:
        for t in range(next(iter(r.values())).shape[0]):
            rows.append({k: v[t] for k, v in r.items()})
    return rows


def ref_metric_rows(ref_ms: list) -> list:
    return [{k: np.atleast_1d(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float64))
             for k, v in m.items()} for m in ref_ms]


def differing_values(prog: list, ref: list) -> tuple:
    """Count of metric values that differ (a metric on one side only
    counts all its values); the first few names."""
    bad, names = 0, []
    if len(prog) != len(ref):
        return max(len(prog), len(ref)), ["tick count"]
    for a, b in zip(prog, ref):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b or a[k].shape != b[k].shape:
                bad += max(np.size(a.get(k, 0)), np.size(b.get(k, 0)))
                names.append(k)
                continue
            d = int((a[k] != b[k]).sum())
            if d:
                bad += d
                names.append(k)
    return bad, sorted(set(names))


def run_reference(cfg: dict, mix: dict, seed: int, device, requests: int, drop_slot: bool = False) -> tuple:
    """The plain reference over the cell's first ``requests`` requests from
    the same seed-made inputs: (state digest, per-tick metrics). Each
    action goes to the reference's ``apply``, each tick's draws come from
    its ``draws``."""
    ref = importlib.import_module(f"perfbench.reference.{cfg['engine']}")
    sched = schedule(cfg, mix, seed)
    st = ref.init_state(cfg, sched.n_up, device)
    gen = generator(seed, device)
    out = []
    for i in range(requests):
        for act in sched.actions(i):
            ref.apply(st, act, cfg)
        for _ in range(sched.tpr):
            fd, rd = ref.draws(gen, st, cfg)
            out.append(ref.tick(st, fd, rd, cfg, drop_slot=drop_slot))
    dig = digest.state_digest(dict(vars(st)))
    del st
    return dig, ref_metric_rows(out)


def schedule(cfg: dict, mix: dict, seed: int) -> traffic.Schedule:
    return traffic.Schedule(mix, cfg["capacity"], cfg["seed_rows"], cfg["rumor_slots"], seed)


class Run:
    """The program's side of a run: its start state, the requests, and the
    readings of the window."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.engine = importlib.import_module(f"perfbench.engines.{cfg['engine']}")
        self.program = self.engine.Program(cfg, self.device)
        self.sched = schedule(cfg, mix, seed)
        self.gen = generator(seed, self.device)
        self.tpr = int(mix["ticks_per_request"])
        self.actions = []
        self.next = 0
        self.mutation_s = []

    def prepare(self, upto: int) -> None:
        while len(self.actions) < upto:
            self.actions.append([self.program.prepare(a) for a in self.sched.actions(len(self.actions))])

    def request(self, timed_mutation: bool = False) -> dict:
        """One request: the mutations due, ``ticks_per_request`` ticks, the
        metrics read back."""
        self.prepare(self.next + 1)
        acts = self.actions[self.next]
        self.next += 1
        if acts:
            with record_function("bench:mutation"):
                if timed_mutation:
                    _drain(self.device)
                    m0 = time.perf_counter()
                for act in acts:
                    self.program.apply(act)
                if timed_mutation:
                    _drain(self.device)
                    self.mutation_s.append(time.perf_counter() - m0)
        with record_function("bench:step"):
            ms = self.program.step(self.gen, self.tpr)
        with record_function("bench:read"):
            return read_metrics(ms)


def _drain(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool, device, since_start) -> dict:
    """One run; ``since_start()`` gives the seconds since the process
    started. Returns the result (without the device check)."""
    cuda = torch.device(device).type == "cuda"
    run = Run(cfg, mix, seed, device)
    run.program.start(run.sched.n_up)
    from scalecube_cluster_tpu_torch.ops import _tensor

    k = traffic.warm_requests(mix)
    warm, warm_req_s = [], []
    t_warm = time.perf_counter()
    for _ in range(k):
        r0 = time.perf_counter()
        warm.append(run.request())
        warm_req_s.append(time.perf_counter() - r0)
    warm_s = time.perf_counter() - t_warm
    # the window's mutations, on the device before it opens: enough for
    # twice as many requests as the fastest warm request's pace would fit
    pace = min(warm_req_s[1:] or warm_req_s)
    run.prepare(k + int(2 * seconds / max(pace, 1e-3)) + 50)
    tracer = None
    if traced:
        from .trace import Tracer

        tracer = Tracer(run.engine.module(), run.engine.PHASES)
    syncs0 = _tensor.HOST_SYNCS.count
    req_s, readings = [], []
    with (tracer.window() if traced else contextlib.nullcontext()):
        if cuda:
            torch.cuda.synchronize()
        setup_s = since_start()
        w0 = time.perf_counter()
        while True:
            r0 = time.perf_counter()
            readings.append(run.request(timed_mutation=traced))
            r1 = time.perf_counter()
            req_s.append(r1 - r0)
            # two requests at the least, so that a tail is defined
            if r1 - w0 >= seconds and len(req_s) >= 2:
                break
        window_s = r1 - w0
    flag_reads = _tensor.HOST_SYNCS.count - syncs0
    totals = {name: float(sum(r[name].sum() for r in readings)) for name in readings[0]}
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    state_bytes = run.program.state_bytes()
    ticks = len(req_s) * run.tpr
    prog_digest = digest.state_digest(run.program.leaves())
    run.program.free()
    n = cfg["capacity"]
    result = {
        "attempted": len(req_s),
        "failed": 0,
        "window": {"requests": len(req_s), "ticks": ticks, "window_s": window_s, "setup_s": setup_s,
                   "warm_s": warm_s, "warm_requests": k, "first_requests_s": warm_req_s[:3],
                   "peak_bytes": peak, "totals": totals, "pool": pool_course(readings, cfg),
                   "request_ms": [1e3 * q for q in (min(req_s), statistics.median(req_s), max(req_s))]},
        "e2e": {
            "member_ticks_per_s": stats.rate(n * ticks, window_s),
            "step_ms_p90": stats.p90(req_s) * 1e3,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        },
    }
    if traced:
        result["layer_ctx"] = {
            "ticks": ticks, "flag_reads": flag_reads, "requests_s": req_s,
            "mutations_s": run.mutation_s, "window_s": window_s, "peak_bytes": peak,
            "state_bytes": state_bytes, "trace": tracer.reduce(), "kernel_launches": tracer.launches,
            "gossip_phases": run.engine.GOSSIP_PHASES, "sync_phase": run.engine.SYNC_PHASE,
            "totals": totals, "cfg": cfg,
        }
    del run
    if cuda:
        torch.cuda.empty_cache()
    # the reference, after the window and the program's state are gone,
    # over every request the program ran
    r0 = time.perf_counter()
    ref_digest, ref_ms = run_reference(cfg, mix, seed, device, k + len(req_s))
    result["window"]["reference_s"] = time.perf_counter() - r0
    rows = digest.differing_rows(prog_digest, ref_digest)
    bad_vals, bad_names = differing_values(metric_rows(warm + readings), ref_ms)
    result["compare"] = {
        "state_rows_differing": sum(rows.values()),
        "metric_values_differing": bad_vals,
        "leaves": rows,
        "metrics": bad_names,
    }
    return result


def pool_course(readings: list, cfg: dict) -> list:
    """The membership-record pool's mean occupancy (share of its slots) in
    each fifth of the window, so a reader sees whether it still fills."""
    if "mr_active_count" not in readings[0] or not cfg.get("mr_slots"):
        return []
    occ = np.concatenate([r["mr_active_count"].reshape(-1) for r in readings])
    return [float(part.mean()) / cfg["mr_slots"] for part in np.array_split(occ, 5) if part.size]
