"""Spread-time certification harness (r13): theory vs measured curves — the
deterministic half of the JAX package's ``dissemination/certify.py``, on
the port's engines.

For every (strategy x topology) the harness measures the rumor spread-time
distribution — inject one user rumor into a warm, loss-free cluster and
count ticks until EVERY up member is infected, across seeds — and checks
the worst measured time against a closed-form bound derived from the
cited result with explicit engineering constants:

==============  ==========  =======================================  ==========================
strategy        topology    bound (ticks; L=ceil_log2 N, F=fanout)   source of the asymptotic
==============  ==========  =======================================  ==========================
push            full        3L + 8                                   Pittel '87 (log2 N + ln N + o(log N)); via arXiv:1311.2839 §1
push_pull       full        3L + 8 (and <= push's measured median)   Karp et al. FOCS'00 push-pull O(log N); via arXiv:1504.03277 §1
push            expander    4L + 8                                   conductance-bounded spreading (arXiv:1311.2839 refs)
push_pull       expander    4L + 8                                   same
push            ring        N  (and >= (N/2)/(2F): certified LINEAR) wavefront diameter argument (the comparative baseline)
push            torus       3(r + c) + 8                             2-D wavefront diameter
push            geo         4*ceil_log2(zs) + 2Z(1+W) + 16           intra-zone spreading + Z WAN hops of delay W
accelerated     any         deterministic schedule bound, below      doubling-chord schedule (arXiv:1311.2839 randomness-efficient spreading; structure-exploiting iteration in the spirit of arXiv:1805.08531)
pipelined       any         accelerated bound * ceil(R/B) + R + 8    budget-rotation stretch; steady-state rate per arXiv:1504.03277
==============  ==========  =======================================  ==========================

Deterministic-schedule bound D(T): ring ceil(N / min(F, 2)) + 4 (each
tick extends the interval by one per scheduled direction); torus
ceil(4 / min(F, 4)) * (r + c) + 8; doubling chord sets (full / expander
/ geo-local) 4 * ceil(C / F) + 8 — two full rotations apply the
ascending chords in order from any cyclic start, doubling the infected
interval per chord; geo adds Z * (1 + W) + 8 for the inter-zone ring.

These are ENGINEERING bounds: the asymptotic shape comes from the cited
theory, the constants are chosen with explicit safety margin and are
part of the recorded artifact. Measurements run the FULL SWIM tick (FD,
suspicion, SYNC all live) at zero link loss, so the curve is the
strategy's: user rumors spread ONLY through the gossip phase (SYNC
anti-entropy carries membership records, not rumor infections).

The windows run on ``device`` (the card by default) and draw their
uniforms from a CUDA generator seeded per seed (the JAX harness's key
chain plays this part there); ``draws=`` replaces that source, which is
how the parity tests feed the port the JAX key chain. ``bus=`` (the
telemetry bus) is refused until the telemetry plane is ported (ROADMAP
A10).

The Monte Carlo half (``certify_spread_mc``, ``mc_spread_certifier``,
``fp_rate_mc``, ``adaptive_knob_sweep``) runs S seeds as one fleet
(:mod:`..ops.fleet`): folds on device, one [S] readback per cell. Its
draw source is one generator drawing every scenario's block per site
(``draws=`` replaces it with an ``n_ticks -> [(fd, round), ...]``
callable of [S, ...] draws, which is how the parity tests feed the JAX
fleet's per-row key chains).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import topology as topo
from .spec import DissemSpec

#: minimum seeds for a verdict to count as Monte Carlo rather than a
#: spot check — every bound record carries it (``mc_min_samples``) so
#: artifacts can never silently mix single-seed and MC verdicts
MC_MIN_SAMPLES = 1000

# ONE ceil_log2 spelling with the topology generators (true ceiling —
# ceil_log2(256) = 8): the bound formulas and the chord-set caps must
# agree on what "log2 N" means or the recorded formula strings lie
_ceil_log2 = topo._ceil_log2


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def det_schedule_bound(spec: DissemSpec, n: int, fanout: int) -> int:
    """Deterministic rotation bound D(T) for the accelerated schedule."""
    if spec.topology == "ring":
        return -(-n // min(fanout, 2)) + 4
    if spec.topology == "torus":
        r, c = topo.torus_dims(spec, n)
        return -(-4 // min(fanout, 4)) * (r + c) + 8
    ch = topo.chords(spec, n)
    base = 4 * -(-len(ch) // fanout) + 8
    if spec.topology == "geo":
        base += spec.geo_zones * (1 + spec.geo_wan_delay_ticks) + 8
    return base


def theory_bound(spec: DissemSpec, n: int, fanout: int, rumor_slots: int = 8) -> dict:
    """Closed-form spread-time bound for one (strategy, topology) at size
    ``n`` — see the module-docstring table. Returns ``{bound_ticks,
    lower_bound_ticks, formula, citation, mc_min_samples}``
    (``lower_bound_ticks`` is 0 except where the certification also
    asserts slowness — the ring's linear-diameter class)."""
    L = _ceil_log2(n)
    s, t = spec.strategy, spec.topology
    lower = 0
    if s == "accelerated":
        bound = det_schedule_bound(spec, n, fanout)
        formula = "det_schedule_bound(T)"
        citation = "arXiv:1311.2839 (doubling schedule); arXiv:1805.08531 (structure-exploiting iteration)"
    elif s == "tuneable":
        # the mixed walk covers the deterministic rotation in expected
        # 1/mix rotations; the randomized complement spreads push-like on
        # the same chords — take the stretched deterministic bound plus
        # the randomized log term as a (generous, certifiable) ceiling
        mix = max(float(spec.tuneable_mix), 0.1)
        bound = int(round(det_schedule_bound(spec, n, fanout) / mix)) + 3 * L + 8
        formula = f"det_schedule_bound(T)/max(mix,0.1)={mix:g} + 3*ceil_log2(N) + 8"
        citation = "arXiv:1506.02288 (robust and tuneable gossiping family)"
    elif s == "pipelined":
        stretch = -(-rumor_slots // min(spec.pipeline_budget, rumor_slots))
        bound = det_schedule_bound(spec, n, fanout) * stretch + rumor_slots + 8
        formula = f"det_schedule_bound(T) * ceil(R/B)={stretch} + R + 8"
        citation = "arXiv:1504.03277 (pipelined gossiping)"
    elif t in ("full", "expander"):
        c = 3 if t == "full" else 4
        bound = c * L + 8
        formula = f"{c}*ceil_log2(N) + 8"
        citation = (
            "Pittel '87 via arXiv:1311.2839"
            if t == "full"
            else "conductance-bounded spreading, arXiv:1311.2839 refs"
        )
        if s == "push_pull":
            citation = "Karp et al. FOCS'00 push-pull; " + citation
    elif t == "ring":
        bound = n
        lower = (n // 2) // (2 * fanout)
        formula = "N (upper); (N/2)/(2F) (lower: certified linear)"
        citation = "wavefront diameter argument"
    elif t == "torus":
        r, c = topo.torus_dims(spec, n)
        bound = 3 * (r + c) + 8
        formula = "3*(rows + cols) + 8"
        citation = "2-D wavefront diameter"
    else:  # geo
        zs = topo.zone_size(spec, n)
        Z, W = spec.geo_zones, spec.geo_wan_delay_ticks
        bound = 4 * _ceil_log2(zs) + 2 * Z * (1 + W) + 16
        formula = "4*ceil_log2(zone) + 2*Z*(1+W) + 16"
        citation = "intra-zone spreading + inter-zone delay ring"
    return {
        "bound_ticks": int(bound),
        "lower_bound_ticks": int(lower),
        "formula": formula,
        "citation": citation,
        # the sample-size floor below which a verdict against this bound
        # is a SPOT CHECK, not a Monte Carlo certification
        "mc_min_samples": MC_MIN_SAMPLES,
    }


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _dense_setup(spec: DissemSpec, n: int, fanout: int, rumor_slots: int, device="cuda"):
    """(params, base_state_fn, ops_module) for one dense certification
    cell: the protocol knobs of every cell, a warm loss-free start, and
    for ``geo`` with WAN delay the delay rings and the cross-zone delays."""
    from ..ops import state as S

    delay_slots = 0
    if spec.topology == "geo" and spec.geo_wan_delay_ticks > 0:
        delay_slots = min(2 * spec.geo_wan_delay_ticks + 2, 8)
    params = S.SimParams(
        capacity=n, fanout=fanout, repeat_mult=3, ping_req_k=2, fd_every=5,
        sync_every=64, suspicion_mult=5, rumor_slots=rumor_slots,
        seed_rows=(0,), full_metrics=False, dissem=spec,
        delay_slots=delay_slots,
    )

    def base():
        st = S.init_state(params, n, warm=True, device=device)
        return topo.apply_geo_wan_delay(st, spec, S, n)

    return params, base, S


def _sparse_setup(spec: DissemSpec, n: int, fanout: int, rumor_slots: int, device="cuda"):
    """(params, base_state_fn, ops_module) for one sparse certification
    cell: the same protocol knobs, the lean scalar-loss layout (the spread
    measurement runs loss-free anyway)."""
    from ..ops import sparse as SP

    if spec.topology == "geo" and spec.geo_wan_delay_ticks > 0:
        raise ValueError(
            "the lean sparse layout has no per-link delay plane — certify "
            "geo WAN delay on the dense engine"
        )
    params = SP.SparseParams(
        capacity=n, fanout=fanout, repeat_mult=3, ping_req_k=2, fd_every=5,
        sync_every=64, suspicion_mult=5, rumor_slots=rumor_slots,
        mr_slots=max(64, n * 4), announce_slots=max(32, n // 2),
        seed_rows=(0,), dissem=spec,
    )

    def base():
        return SP.init_sparse_state(params, n, warm=True, device=device)

    return params, base, SP


def _pview_setup(spec: DissemSpec, n: int, fanout: int, rumor_slots: int, device="cuda"):
    from ..ops import pview as PV

    if spec.topology == "geo" and spec.geo_wan_delay_ticks > 0:
        raise ValueError(
            "the pview engine has no per-link delay plane — certify geo "
            "WAN delay on the dense engine"
        )
    params = PV.PviewParams(
        capacity=n, fanout=fanout, repeat_mult=3, ping_req_k=2, fd_every=5,
        sync_every=64, suspicion_mult=5, rumor_slots=rumor_slots,
        seed_rows=(0,), dissem=spec,
    )

    def base():
        return PV.init_pview_state(params, n, warm=True, device=device)

    return params, base, PV


_SETUPS = {
    "dense": _dense_setup,
    "pview": _pview_setup,
    "sparse": _sparse_setup,
}

def _make_window(engine: str, params, window: int):
    """The engine's ``window``-tick window (the JAX harness's
    ``make_run`` / ``make_pview_run`` / ``make_sparse_run``)."""
    if engine == "dense":
        from ..ops.kernel import make_run

        return make_run(params, window)
    if engine == "pview":
        from ..ops.pview import make_pview_run

        return make_pview_run(params, window)
    from ..ops.sparse import make_sparse_run

    return make_sparse_run(params, window)


def _runner(engine: str, spec: DissemSpec, n: int, fanout: int, rumor_slots: int, window: int,
            device="cuda"):
    """(params, step, fresh, inject) of one cell: ``step`` is the engine's
    ``window``-tick window, ``fresh(origin)`` a base state with rumor 0
    spread from ``origin``, ``inject(state, slot, origin)`` one more."""
    params, base, ops = _SETUPS[engine](spec, n, fanout, rumor_slots, device)
    step = _make_window(engine, params, window)

    def fresh(origin: int):
        return ops.spread_rumor(base(), 0, origin=origin)

    def inject(st, slot: int, origin: int):
        return ops.spread_rumor(st, slot, origin=origin)

    return params, step, fresh, inject


def _window_source(source, window: int):
    """What one window draws from: the generator itself, or the next
    ``window`` draw pairs of a caller's ``n_ticks -> pairs`` callable."""
    return source if isinstance(source, torch.Generator) else source(window)


def _seed_source(draws, seed: int, base_seed: int, device):
    """The per-seed draw source: ``draws(seed)`` when given, else a
    generator on ``device`` seeded ``base_seed + seed``."""
    if draws is not None:
        return draws(seed)
    return torch.Generator(device=device).manual_seed(base_seed + seed)


def measure_spread(
    spec: DissemSpec,
    n: int = 256,
    engine: str = "dense",
    seeds: Sequence[int] = (0, 1, 2, 3, 4),
    fanout: int = 3,
    rumor_slots: int = 8,
    max_ticks: Optional[int] = None,
    window: int = 32,
    device="cuda",
    draws: Optional[Callable] = None,
) -> dict:
    """Measure the single-rumor spread-time distribution of one spec:
    ticks from injection to 100% up-member coverage, per seed (seed
    varies both the origin row and the draw stream). Returns the raw
    measurement record; ``None`` in ``spread_ticks`` marks a seed that
    never reached full coverage within ``max_ticks``.

    ``draws(seed)`` returns a seed's draw source, a ``torch.Generator`` or
    an ``n_ticks -> [(fd, round), ...]`` callable; by default each seed
    draws from a generator on ``device`` seeded ``1000 + seed``."""
    bound = theory_bound(spec, n, fanout, rumor_slots)
    if max_ticks is None:
        max_ticks = 4 * bound["bound_ticks"] + 4 * window
    _params, step, fresh, _inject = _runner(engine, spec, n, fanout, rumor_slots, window, device)
    ticks: list = []
    curves: list = []
    for seed in seeds:
        st = fresh(origin=(seed * 37 + 1) % n)
        source = _seed_source(draws, seed, 1000, device)
        cov_curve: list = []
        hit = None
        for w0 in range(0, max_ticks, window):
            st, ms, _w = step(st, _window_source(source, window))
            cov = ms["rumor_coverage"][:, 0].cpu().numpy()
            cov_curve.extend(float(c) for c in cov)
            full = np.nonzero(cov >= 1.0)[0]
            if full.size:
                hit = w0 + int(full[0]) + 1
                break
        ticks.append(hit)
        if len(cov_curve) > 512:  # artifact size: stride long curves
            stride = -(-len(cov_curve) // 512)
            cov_curve = cov_curve[::stride]
        curves.append([round(c, 4) for c in cov_curve])
    good = [t for t in ticks if t is not None]
    return {
        "strategy": spec.strategy,
        "topology": spec.topology,
        "engine": engine,
        "n": n,
        "fanout": fanout,
        "rumor_slots": rumor_slots,
        "seeds": list(seeds),
        # a handful of serial seeds is a spot check, never a Monte Carlo
        # verdict — the label travels with the record
        "sample_size": len(seeds),
        "verdict_kind": (
            "spot-check" if len(seeds) < bound["mc_min_samples"]
            else "monte-carlo"
        ),
        "spread_ticks": ticks,
        "spread_ticks_median": float(np.median(good)) if good else None,
        "spread_ticks_max": max(good) if good else None,
        "coverage_curves": curves,
        **{k: v for k, v in bound.items()},
    }


def certify_spread(record: dict) -> dict:
    """Fold the bound check into a measurement record: every seed must
    reach full coverage, the worst seed must beat ``bound_ticks``, and a
    nonzero ``lower_bound_ticks`` (the ring's linear class) must also be
    EXCEEDED by the best seed — certifying the topology is genuinely
    slow, which is the curve's comparative content."""
    ticks = record["spread_ticks"]
    ok = all(t is not None for t in ticks)
    if ok:
        ok = max(ticks) <= record["bound_ticks"]
        if record["lower_bound_ticks"]:
            ok = ok and min(ticks) >= record["lower_bound_ticks"]
    return {**record, "certified": bool(ok)}


def measure_pipeline_steady_state(
    spec: DissemSpec,
    n: int = 256,
    n_rumors: int = 4,
    seeds: Sequence[int] = (0,),
    fanout: int = 3,
    rumor_slots: int = 8,
    window: int = 32,
    device="cuda",
    draws: Optional[Callable] = None,
) -> dict:
    """The pipelined strategy's multi-rumor claim (arXiv:1504.03277):
    ``n_rumors`` rumors injected TOGETHER must each individually meet the
    stretched single-rumor bound — concurrent rumors share the budget
    rotation as a pipeline instead of multiplying each other's completion
    time. Records per-rumor completions + the pipelining overhead (last
    vs first completion). On the dense engine; ``draws`` as in
    :func:`measure_spread`, the default generators seeded ``2000 + seed``."""
    if spec.strategy != "pipelined":
        raise ValueError(f"the steady-state claim is the pipelined strategy's, not {spec.strategy!r}'s")
    bound = theory_bound(spec, n, fanout, rumor_slots)["bound_ticks"]
    max_ticks = 4 * bound + 4 * window
    _params, step, fresh, inject = _runner("dense", spec, n, fanout, rumor_slots, window, device)
    runs = []
    for seed in seeds:
        st = fresh(origin=(seed * 37 + 1) % n)
        for k in range(1, n_rumors):
            st = inject(st, k, origin=(seed * 37 + 1 + k * 11) % n)
        source = _seed_source(draws, seed, 2000, device)
        done = [None] * n_rumors
        for w0 in range(0, max_ticks, window):
            st, ms, _w = step(st, _window_source(source, window))
            cov = ms["rumor_coverage"][:, :n_rumors].cpu().numpy()
            for k in range(n_rumors):
                if done[k] is None:
                    full = np.nonzero(cov[:, k] >= 1.0)[0]
                    if full.size:
                        done[k] = w0 + int(full[0]) + 1
            if all(d is not None for d in done):
                break
        runs.append(done)
    flat = [d for run in runs for d in run]
    ok = all(d is not None and d <= bound for d in flat)
    return {
        "strategy": spec.strategy,
        "topology": spec.topology,
        "n": n,
        "n_rumors": n_rumors,
        "sample_size": len(list(seeds)),
        "verdict_kind": (
            "spot-check" if len(list(seeds)) < MC_MIN_SAMPLES
            else "monte-carlo"
        ),
        "completions": runs,
        "single_rumor_bound_ticks": bound,
        "pipelining_overhead_ticks": (
            max(d for d in flat) - min(d for d in flat)
            if flat and all(d is not None for d in flat)
            else None
        ),
        "certified": bool(ok),
    }


# ---------------------------------------------------------------------------
# the certification entry point
# ---------------------------------------------------------------------------

#: the default certification matrix (>= 3 strategies x >= 3 topologies,
#: plus the comparative extras) — benchmarks/config12_strategies.py's
DEFAULT_MATRIX = (
    ("push", "full", "dense"),
    ("push", "ring", "dense"),
    ("push", "torus", "dense"),
    ("push", "expander", "dense"),
    ("push", "geo", "dense"),
    ("push_pull", "full", "dense"),
    ("push_pull", "expander", "dense"),
    ("pipelined", "ring", "dense"),
    ("pipelined", "expander", "dense"),
    ("pipelined", "full", "dense"),
    ("accelerated", "ring", "dense"),
    ("accelerated", "torus", "dense"),
    ("accelerated", "expander", "dense"),
    ("push", "expander", "pview"),
    ("accelerated", "expander", "pview"),
    # the fifth strategy: the robust/tuneable family, certified on the
    # expander (the ring's linear class is pinned by the pure strategies)
    ("tuneable", "expander", "dense"),
    ("tuneable", "full", "dense"),
)


def spread_certifier(
    matrix=None,
    n: int = 256,
    seeds: Sequence[int] = (0, 1, 2, 3, 4),
    fanout: int = 3,
    rumor_slots: int = 8,
    geo_wan_delay_ticks: int = 2,
    pipeline_budget: int = 2,
    bus=None,
    log=None,
    device="cuda",
) -> dict:
    """Run the certification matrix on ``device`` and return the artifact
    record (the JAX harness's, entry for entry). ``log`` is an optional
    ``print``-like progress sink; ``bus`` (a telemetry bus) is refused
    until the telemetry plane is ported (ROADMAP A10)."""
    if bus is not None:
        _not_ported("publishing certification events on a telemetry bus (bus=)", "A10")
    entries = []
    matrix = tuple(matrix or DEFAULT_MATRIX)
    for strat, topol, engine in matrix:
        spec = DissemSpec(
            strategy=strat,
            topology=topol,
            geo_wan_delay_ticks=geo_wan_delay_ticks if topol == "geo" else 0,
            pipeline_budget=pipeline_budget,
        )
        rec = certify_spread(
            measure_spread(
                spec, n=n, engine=engine, seeds=seeds, fanout=fanout,
                rumor_slots=rumor_slots, device=device,
            )
        )
        entries.append(rec)
        if log:
            log(
                f"{engine}/{strat}/{topol}: spread {rec['spread_ticks']} "
                f"<= bound {rec['bound_ticks']} "
                f"{'OK' if rec['certified'] else 'VIOLATION'}"
            )
    # the steady-state claim belongs to the pipelined strategy: it runs
    # (and gates the verdict) only when the matrix certifies pipelined
    pipeline = None
    if any(strat == "pipelined" for strat, _t, _e in matrix):
        pipeline = measure_pipeline_steady_state(
            DissemSpec(strategy="pipelined", topology="expander",
                       pipeline_budget=pipeline_budget),
            n=n, seeds=tuple(seeds)[:1], fanout=fanout,
            rumor_slots=rumor_slots, device=device,
        )
        if log:
            log(
                f"pipelined steady-state: completions "
                f"{pipeline['completions']} "
                f"<= {pipeline['single_rumor_bound_ticks']} "
                f"{'OK' if pipeline['certified'] else 'VIOLATION'}"
            )
    strategies = sorted({e["strategy"] for e in entries if e["certified"]})
    topologies = sorted({e["topology"] for e in entries if e["certified"]})
    return {
        "n": n,
        "seeds": list(seeds),
        "fanout": fanout,
        "rumor_slots": rumor_slots,
        "entries": entries,
        "pipeline_steady_state": pipeline,
        "certified_strategies": strategies,
        "certified_topologies": topologies,
        "n_certified": sum(1 for e in entries if e["certified"]),
        "n_entries": len(entries),
        "ok": all(e["certified"] for e in entries)
        and (pipeline is None or pipeline["certified"]),
    }


# ---------------------------------------------------------------------------
# interval statistics (the Monte Carlo service's; ported on their own)
# ---------------------------------------------------------------------------


def _z_for(conf: float) -> float:
    """Two-sided normal quantile for a confidence level — exact via the
    stdlib inverse CDF, so a non-standard ``conf`` yields intervals at
    the confidence the artifact claims (never a silent 95% fallback)."""
    if not 0.0 < conf < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {conf}")
    from statistics import NormalDist

    return NormalDist().inv_cdf(0.5 + conf / 2.0)


def wilson_interval(k: int, n: int, conf: float = 0.95) -> tuple:
    """Wilson score interval for a binomial proportion k/n. Well-behaved
    at the boundaries (k=0 / k=n), unlike the Wald interval, which is why
    it is the recorded method."""
    if n <= 0:
        return 0.0, 1.0
    z = _z_for(conf)
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def quantile_ci(sorted_samples, q: float, conf: float = 0.95) -> tuple:
    """(point, (lo, hi)): the empirical q-quantile with a distribution-free
    order-statistic confidence interval — the CI endpoints are the order
    statistics at ranks ``n·q ± z·sqrt(n·q(1-q))`` (the binomial rank
    bracket, normal-approximated). ``sorted_samples`` must be ascending."""
    xs = np.asarray(sorted_samples)
    n = xs.shape[0]
    if n == 0:
        return None, (None, None)
    z = _z_for(conf)
    mu = n * q
    sd = math.sqrt(max(n * q * (1 - q), 0.0))
    point = float(xs[min(max(math.ceil(mu) - 1, 0), n - 1)])
    lo = int(np.clip(math.floor(mu - z * sd) - 1, 0, n - 1))
    hi = int(np.clip(math.ceil(mu + z * sd), 0, n - 1))
    return point, (float(xs[lo]), float(xs[hi]))


# ---------------------------------------------------------------------------
# the Monte Carlo half: fleet windows, on-device folds, one readback
# ---------------------------------------------------------------------------


def _fleet_source(draws, seed: int, device):
    """A fleet's draw source: ``draws`` itself (a generator, or an
    ``n_ticks -> [(fd, round), ...]`` callable with [S, ...] leaves) when
    given, else one generator on ``device`` seeded ``seed``
    (:func:`..ops.fleet.fleet_generator`)."""
    if draws is not None:
        return draws
    from ..ops.fleet import fleet_generator

    return fleet_generator(seed, device)


def certify_spread_mc(
    spec: DissemSpec,
    n: int = 64,
    n_seeds: int = MC_MIN_SAMPLES,
    engine: str = "dense",
    fanout: int = 3,
    rumor_slots: int = 8,
    window: int = 32,
    base_seed: int = 0,
    max_ticks: Optional[int] = None,
    conf: float = 0.95,
    device="cuda",
    draws=None,
) -> dict:
    """Monte Carlo spread-time certification of one (strategy, topology)
    cell: ``n_seeds`` clusters advance together in fleet windows
    (:mod:`..ops.fleet`), the per-scenario ticks-to-full-coverage fold stays
    on device across windows (one scalar read per window says whether every
    scenario finished), and ONE [S] readback at the end feeds the interval
    statistics. Scenario ``s`` starts its rumor at row ``(seed * 37 + 1) %
    n`` with ``seed = base_seed + s``. ``draws`` is the fleet's draw source
    (a generator on ``device``, or an ``n_ticks -> [(fd, round), ...]``
    callable with [S, ...] draws); by default one generator on ``device``
    seeded ``1000 + base_seed`` draws every scenario's block. The record
    also carries ``per_seed_ticks`` (-1: never covered)."""
    import dataclasses as _dc

    from ..ops import fleet as FL

    bound = theory_bound(spec, n, fanout, rumor_slots)
    if max_ticks is None:
        max_ticks = 4 * bound["bound_ticks"] + 4 * window
    params, base, ops_mod = _SETUPS[engine](spec, n, fanout, rumor_slots, device)
    if hasattr(params, "quiet_gates"):
        # the fleet profile: the dense gates are value-identical no-ops
        # when closed, so the fleet runs them open
        params = _dc.replace(params, quiet_gates=False)
    step = FL.make_fleet_run(params, window)
    seeds = np.arange(n_seeds) + base_seed
    origins = (seeds * 37 + 1) % n
    fs = FL.fleet_inject_rumor(ops_mod, FL.fleet_broadcast(base(), n_seeds), 0, origins)
    source = _fleet_source(draws, 1000 + base_seed, device)
    hit = torch.full((n_seeds,), -1, dtype=torch.int32, device=device)
    windows = 0
    for w0 in range(0, max_ticks, window):
        fs, ms, _w = step(fs, _window_source(source, window))
        hit = FL.fold_first_full_coverage(hit, ms["rumor_coverage"][:, :, 0], w0)
        windows += 1
        # one scalar read per window (bounded by windows, never by seeds)
        if bool((hit >= 0).all()):
            break
    ticks = hit.cpu().numpy()  # THE per-cell [S] readback
    finished = int((ticks >= 0).sum())
    good = np.sort(ticks[ticks >= 0])
    within = int(((ticks >= 0) & (ticks <= bound["bound_ticks"])).sum())
    wil = wilson_interval(within, n_seeds, conf)
    med, med_ci = quantile_ci(good, 0.5, conf)
    p99, p99_ci = quantile_ci(good, 0.99, conf)
    p01, p01_ci = quantile_ci(good, 0.01, conf)
    certified = (
        finished == n_seeds
        and p99_ci[1] is not None
        and p99_ci[1] <= bound["bound_ticks"]
        and wil[0] >= 0.99
    )
    if bound["lower_bound_ticks"]:
        # the ring's linear class: even the fast tail must exceed the
        # linear lower bound
        certified = certified and (p01_ci[0] is not None and p01_ci[0] >= bound["lower_bound_ticks"])
    hist = {}
    if good.size:
        vals, counts = np.unique(good, return_counts=True)
        hist = {int(v): int(c) for v, c in zip(vals, counts)}
    return {
        "strategy": spec.strategy,
        "topology": spec.topology,
        "engine": engine,
        "n": n,
        "fanout": fanout,
        "rumor_slots": rumor_slots,
        "n_seeds": n_seeds,
        "sample_size": n_seeds,
        "base_seed": base_seed,
        "verdict_kind": "monte-carlo" if n_seeds >= MC_MIN_SAMPLES else "spot-check",
        "interval_method": (
            f"Wilson {conf:.0%} on P(spread<=bound); distribution-free "
            f"order-statistic {conf:.0%} CIs on quantiles (binomial rank "
            "bracket, normal-approx ranks)"
        ),
        "confidence": conf,
        "finished": finished,
        "spread_ticks_min": int(good[0]) if good.size else None,
        "spread_ticks_median": med,
        "median_ci": list(med_ci),
        "spread_ticks_p99": p99,
        "p99_ci": list(p99_ci),
        "p01_ci": list(p01_ci),
        "spread_ticks_max": int(good[-1]) if good.size else None,
        "within_bound": within,
        "p_within_bound": round(within / n_seeds, 6),
        "wilson": [round(wil[0], 6), round(wil[1], 6)],
        "spread_histogram": hist,
        "windows_dispatched": windows,
        "window_ticks": window,
        "fleet_devices": 1,
        "per_seed_ticks": [int(t) for t in ticks],
        **bound,
        "certified": bool(certified),
    }


#: the default MC matrix: 12 (strategy x topology x engine) cells, the
#: pview and sparse engines with cells of their own
DEFAULT_MC_MATRIX = (
    ("push", "full", "dense"),
    ("push", "expander", "dense"),
    ("push_pull", "full", "dense"),
    ("push_pull", "expander", "dense"),
    ("accelerated", "expander", "dense"),
    ("accelerated", "ring", "dense"),
    ("tuneable", "expander", "dense"),
    ("pipelined", "expander", "dense"),
    ("push", "expander", "pview"),
    ("accelerated", "expander", "pview"),
    ("push", "full", "sparse"),
    ("push", "expander", "sparse"),
)


def mc_spread_certifier(
    matrix=None,
    n: int = 64,
    n_seeds: int = MC_MIN_SAMPLES,
    fanout: int = 3,
    rumor_slots: int = 8,
    window: int = 32,
    pipeline_budget: int = 2,
    geo_wan_delay_ticks: int = 2,
    base_seed: int = 0,
    bus=None,
    log=None,
    device="cuda",
    draws: Optional[Callable] = None,
) -> dict:
    """Run the Monte Carlo certification matrix: one fleet per cell,
    ``n_seeds`` scenarios each, Wilson and order-statistic intervals
    recorded per entry. ``draws(strategy, topology, engine)``, when given,
    returns a cell's draw source. ``bus`` is refused until the telemetry
    plane is ported (ROADMAP A10)."""
    if bus is not None:
        _not_ported("publishing certification events on a telemetry bus (bus=)", "A10")
    entries = []
    for strat, topol, engine in tuple(matrix or DEFAULT_MC_MATRIX):
        spec = DissemSpec(
            strategy=strat,
            topology=topol,
            geo_wan_delay_ticks=geo_wan_delay_ticks if topol == "geo" else 0,
            pipeline_budget=pipeline_budget,
        )
        rec = certify_spread_mc(
            spec, n=n, n_seeds=n_seeds, engine=engine, fanout=fanout,
            rumor_slots=rumor_slots, window=window, base_seed=base_seed, device=device,
            draws=None if draws is None else draws(strat, topol, engine),
        )
        entries.append(rec)
        if log:
            log(
                f"MC {engine}/{strat}/{topol}: {rec['finished']}/{n_seeds} "
                f"finished, median {rec['spread_ticks_median']} "
                f"p99 {rec['spread_ticks_p99']} "
                f"(CI {rec['p99_ci']}) <= bound {rec['bound_ticks']}; "
                f"P(within) wilson {rec['wilson']} "
                f"{'OK' if rec['certified'] else 'VIOLATION'}"
            )
    return {
        "n": n,
        "n_seeds": n_seeds,
        "fanout": fanout,
        "rumor_slots": rumor_slots,
        "window_ticks": window,
        "entries": entries,
        "certified_strategies": sorted({e["strategy"] for e in entries if e["certified"]}),
        "certified_topologies": sorted({e["topology"] for e in entries if e["certified"]}),
        "n_certified": sum(1 for e in entries if e["certified"]),
        "n_entries": len(entries),
        "total_trajectories": n_seeds * len(entries),
        "ok": all(e["certified"] for e in entries),
    }


# -- Monte Carlo false-positive certification (the chaos sentinel, S-wide) ---

#: the loss-adversarial cohort layout fp_rate_mc drives (config13's
#: scenario without the delay-ring SlowMember)
FP_MC_COHORT = dict(asym_rows=(5, 6, 7), flaky_rows=(9,), crash_row=20)


def fp_rate_mc(
    n: int = 48,
    n_seeds: int = 512,
    loss_floor=0.10,
    adaptive: bool = False,
    window: int = 16,
    until: int = 200,
    horizon: int = 240,
    crash_at: int = 30,
    base_seed: int = 0,
    static_suspicion_mult: int = 3,
    adaptive_knobs: Optional[dict] = None,
    conf: float = 0.95,
    device="cuda",
    draws=None,
) -> dict:
    """Monte Carlo false-positive certification (the chaos sentinel's
    check, S-wide): ``n_seeds`` clusters run the loss-adversarial scenario
    (an AsymmetricLoss cohort, a FlakyObserver, one true Crash) over an
    ambient uniform-loss floor through the batched timeline
    (:func:`..ops.fleet.fleet_timeline`); per-scenario false-DEAD maxima
    and crash-detection ticks latch on device at window boundaries and are
    read back ONCE. Reports the Wilson interval on P(any false-DEAD) and
    the detection latencies against the static detection budget.

    ``loss_floor``: a scalar runs every scenario at one floor; an array
    splits the fleet over a condition grid (scenario ``s`` at
    ``loss_floor[s % len]``) and adds a ``per_floor`` breakdown. ``draws``
    is the fleet's draw source (a generator on ``device``, or an ``n_ticks
    -> [(fd, round), ...]`` callable with [S, ...] draws, consumed window
    after window); by default one generator on ``device`` seeded
    ``base_seed``. The record also carries ``per_seed_fp_max`` and
    ``per_seed_det_tick``."""
    from ..adaptive import AdaptiveSpec, init_adaptive_state
    from ..chaos import events as ev
    from ..chaos.sentinels import default_detect_budget
    from ..ops import fleet as FL
    from ..ops import state as S

    knobs = adaptive_knobs or dict(min_mult=5, max_mult=10, conf_target=4, lh_max=8)
    spec = AdaptiveSpec(enabled=True, **knobs) if adaptive else AdaptiveSpec()
    params = S.SimParams(
        capacity=n, fd_every=1, sync_every=40,
        suspicion_mult=static_suspicion_mult, rumor_slots=8, seed_rows=(0,),
        full_metrics=False, adaptive=spec,
        quiet_gates=False,  # the fleet profile (see certify_spread_mc)
    )
    cohort = FP_MC_COHORT
    watch_rows = tuple(cohort["asym_rows"]) + tuple(cohort["flaky_rows"])
    crash_row = cohort["crash_row"]
    scen = ev.Scenario(
        name="loss_adversarial_mc_r15",
        events=(
            ev.AsymmetricLoss(rows=list(cohort["asym_rows"]), pct=70.0, at=4, until=until, direction="in"),
            ev.FlakyObserver(rows=list(cohort["flaky_rows"]), pct=70.0, at=4, until=until),
            ev.Crash(rows=[crash_row], at=crash_at),
        ),
        horizon=horizon,
    )
    floor_is_grid = np.ndim(loss_floor) > 0
    floor_grid = np.atleast_1d(np.asarray(loss_floor, np.float32))
    floors_s = floor_grid[np.arange(n_seeds) % floor_grid.size]
    fs = FL.fleet_broadcast(S.init_state(params, n, warm=True, device=device), n_seeds)
    if floor_grid.max() > 0:
        fs = FL.fleet_uniform_loss(S, fs, floors_s)
    source = _fleet_source(draws, base_seed, device)
    ad = FL.fleet_broadcast(init_adaptive_state(n, device=device), n_seeds) if adaptive else None
    tl = FL.fleet_timeline(scen, S, dense_links=True, horizon=horizon)
    watch_mask = torch.zeros((n,), dtype=torch.bool, device=device)
    watch_mask[list(watch_rows)] = True

    steps: dict = {}  # window length -> fleet window

    def _step(k: int):
        if k not in steps:
            steps[k] = FL.make_fleet_adaptive_run(params, k) if adaptive else FL.make_fleet_run(params, k)
        return steps[k]

    fp_max = torch.zeros((n_seeds,), dtype=torch.int32, device=device)
    det_tick = torch.full((n_seeds,), -1, dtype=torch.int32, device=device)
    boundaries = set(tl.boundaries())
    t = 0
    while t < horizon:
        fs, _labels = tl.apply_due(fs, t)
        stops = [horizon, t + window] + [b for b in boundaries if b > t]
        stop = min(x for x in stops if x > t)
        src = _window_source(source, stop - t)
        if adaptive:
            fs, ad, _ms, _w = _step(stop - t)(fs, ad, src)
        else:
            fs, _ms, _w = _step(stop - t)(fs, src)
        t = stop
        fp_max = torch.maximum(fp_max, FL.fleet_false_dead(fs, watch_mask))
        if t > crash_at:
            det = FL.fleet_crash_detected(fs, crash_row)
            det_tick = torch.where((det_tick < 0) & det, t, det_tick).to(torch.int32)
    fs, _labels = tl.apply_due(fs, horizon)
    fp_np = fp_max.cpu().numpy()  # the one [S] readback pair
    det_np = det_tick.cpu().numpy()
    k_fp = int((fp_np > 0).sum())
    wil = wilson_interval(k_fp, n_seeds, conf)
    deadline = crash_at + default_detect_budget(params)
    detected = det_np[det_np >= 0]
    _p99d, p99d_ci = quantile_ci(np.sort(detected), 0.99, conf)
    det_ok = int((det_np >= 0).sum()) == n_seeds and int(det_np.max()) <= deadline
    per_floor = None
    if floor_is_grid:
        per_floor = []
        for f in floor_grid:
            m = floors_s == f
            kf, nf = int((fp_np[m] > 0).sum()), int(m.sum())
            wf = wilson_interval(kf, nf, conf)
            df = det_np[m]
            per_floor.append({
                "loss_floor_pct": round(float(f) * 100, 2),
                "n_seeds": nf,
                "false_dead_scenarios": kf,
                "fp_rate": round(kf / max(nf, 1), 6),
                "fp_rate_wilson": [round(wf[0], 6), round(wf[1], 6)],
                "crash_detected": int((df >= 0).sum()),
                "crash_detect_max": int(df.max()) if (df >= 0).any() else None,
            })
    return {
        "arm": "adaptive" if adaptive else "static",
        "n": n,
        "n_seeds": n_seeds,
        "sample_size": n_seeds,
        "verdict_kind": "monte-carlo" if n_seeds >= MC_MIN_SAMPLES else "spot-check",
        "loss_floor_pct": (
            [round(float(f) * 100, 2) for f in floor_grid] if floor_is_grid
            else round(float(floor_grid[0]) * 100, 2)
        ),
        "per_floor": per_floor,
        "scenario": scen.name,
        "fp_watch_rows": list(watch_rows),
        "false_dead_scenarios": k_fp,
        "fp_rate": round(k_fp / n_seeds, 6),
        "fp_rate_wilson": [round(wil[0], 6), round(wil[1], 6)],
        "interval_method": f"Wilson {conf:.0%} on P(false-DEAD > 0)",
        "crash_detected": int((det_np >= 0).sum()),
        "crash_detect_deadline": int(deadline),
        "crash_detect_max": int(det_np.max()) if detected.size else None,
        "crash_detect_p99_ci": list(p99d_ci),
        "crash_detect_window_ticks": window,
        "detections_ok": bool(det_ok),
        "static_suspicion_mult": static_suspicion_mult,
        "adaptive_knobs": knobs if adaptive else None,
        "per_seed_fp_max": [int(x) for x in fp_np],
        "per_seed_det_tick": [int(x) for x in det_np],
    }


def adaptive_knob_sweep(
    min_mults: Sequence[int] = (3, 5, 8),
    conf_targets: Sequence[int] = (2, 4),
    loss_floors: Sequence[float] = (0.0, 0.10, 0.20),
    n: int = 48,
    n_seeds_per_floor: int = 171,
    window: int = 16,
    horizon: int = 240,
    base_seed: int = 0,
    fp_budget: float = 0.03,
    conf: float = 0.95,
    log=None,
    device="cuda",
    draws: Optional[Callable] = None,
) -> dict:
    """The offline adaptive-knob map: :func:`fp_rate_mc` over a (min_mult x
    conf_target x loss-floor) grid, one fleet per knob pair sweeping every
    floor (``n_seeds_per_floor`` scenarios each; ``max_mult`` is ``2 *
    min_mult``). Per floor, ``recommended`` is the fastest knob (lowest
    ``min_mult``) whose false-DEAD Wilson upper bound stays within
    ``fp_budget``. ``draws(knobs)``, when given, returns a cell's draw
    source."""
    floors = [float(f) for f in loss_floors]
    n_seeds = n_seeds_per_floor * len(floors)
    cells = []
    for mm in min_mults:
        for ct in conf_targets:
            knobs = dict(min_mult=int(mm), max_mult=int(2 * mm), conf_target=int(ct), lh_max=8)
            rec = fp_rate_mc(
                n=n, n_seeds=n_seeds, loss_floor=np.asarray(floors),
                adaptive=True, window=window, horizon=horizon,
                base_seed=base_seed, adaptive_knobs=knobs, conf=conf, device=device,
                draws=None if draws is None else draws(knobs),
            )
            cells.append(rec)
            if log:
                log(
                    f"knob map min_mult={mm} conf_target={ct}: fp/floor "
                    + " ".join(f"{p['loss_floor_pct']}%:{p['fp_rate']:.3f}" for p in rec["per_floor"])
                    + f" detect_max={rec['crash_detect_max']}"
                )
    recommended = {}
    for i, f in enumerate(floors):
        best = None
        for rec in cells:
            p = rec["per_floor"][i]
            if p["fp_rate_wilson"][1] <= fp_budget:
                k = rec["adaptive_knobs"]
                if best is None or k["min_mult"] < best["min_mult"]:
                    best = dict(k, fp_rate=p["fp_rate"], fp_rate_wilson=p["fp_rate_wilson"],
                                crash_detect_max=p["crash_detect_max"])
        recommended[str(round(f * 100, 2))] = best
    return {
        "n": n,
        "n_seeds_per_floor": n_seeds_per_floor,
        "min_mults": [int(m) for m in min_mults],
        "conf_targets": [int(c) for c in conf_targets],
        "loss_floor_pcts": [round(f * 100, 2) for f in floors],
        "fp_budget": fp_budget,
        "sample_size": n_seeds,
        "verdict_kind": "monte-carlo" if n_seeds >= MC_MIN_SAMPLES else "spot-check",
        "cells": cells,
        "recommended": recommended,
    }
