"""The fleet engine in the PyTorch port against the JAX package's.

A port fleet window runs the engine's serial tick under ``torch.func.vmap``
over S scenarios (``scalecube_cluster_tpu_torch/ops/fleet.py``). Held here,
at N = 33 (a packed word boundary straddled), S = 2-3, T = 8 and the JAX
fleet tests' knobs (``tests/test_fleet.py``):

* each engine's fleet window (dense i32 and i16, sparse i32, pview i32 and
  i16), fed the JAX fleet's per-row key chains, against JAX
  ``make_fleet_run``: every leaf and every stacked metric (the two f32
  metrics within 2 ulp);
* each row of a port fleet (rows with different crashes, so the gates open
  in some rows only) against the port's serial window fed the same draws;
* the adaptive fleet (dense, delay rings at D = 4, a degraded cohort)
  against JAX ``make_fleet_adaptive_run``;
* ``fleet_timeline`` (a storm on scalar loss; ``FleetVary`` crash rows and
  loss floors) against JAX's, after every action and every tick;
* the four Monte Carlo folds against JAX's;
* the refusals, and the scenario-axis plain kernel against the serial one.

Each JAX program is compiled once per case and reused (``lru_cache``).
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu import adaptive as JA
from scalecube_cluster_tpu.chaos import events as JEV
from scalecube_cluster_tpu.ops import fleet as JFL
from scalecube_cluster_tpu.ops import kernel as JK
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.adaptive import init_adaptive_state
from scalecube_cluster_tpu_torch.chaos import events as TEV
from scalecube_cluster_tpu_torch.ops import delivery as TD
from scalecube_cluster_tpu_torch.ops import fleet as TFL
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import rand as TR
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from test_torch_dense import dense_draws
from test_torch_pview_fused import FLOAT_METRICS, _jax_draws

torch.set_num_threads(1)

N = 33
T = 8
SEEDS = (0, 7)
_KNOBS = dict(fanout=2, repeat_mult=3, ping_req_k=1, fd_every=2, sync_every=8, suspicion_mult=3,
              rumor_slots=8, seed_rows=(0,))
ENGINE_CASES = [("dense", "i32"), ("dense", "i16"), ("sparse", "i32"), ("pview", "i32"), ("pview", "i16")]


@dataclasses.dataclass(frozen=True)
class Case:
    jparams: object
    jmod: object
    tmod: object
    jinit: object  # () -> JAX state
    tinit: object  # () -> port state on the CPU
    jmake: object  # JAX fleet builder
    tmake: object  # port fleet builder
    tserial: object  # port serial window builder
    draws: object  # (key, n_ticks, params) -> (key, [(fd, round), ...]) of one row
    tdraw: object  # the port's per-tick draw function


@functools.lru_cache(maxsize=None)
def _case(engine: str, kd: str) -> Case:
    if engine == "dense":
        p = JS.SimParams(capacity=N, key_dtype=kd, full_metrics=False, **_KNOBS)
        tp = _tparams(p)
        return Case(p, JS, TS, lambda: JS.init_state(p, N, warm=True, uniform_loss=0.15),
                    lambda: TS.init_state(tp, N, warm=True, uniform_loss=0.15, device="cpu"),
                    JK.make_fleet_run, TK.make_fleet_run, TK.make_run, dense_draws, TR.draw_dense_tick)
    if engine == "sparse":
        p = JSP.SparseParams(capacity=N, mr_slots=16, **_KNOBS)
        tp = _tparams(p)
        return Case(p, JSP, TSP, lambda: JSP.init_sparse_state(p, N, warm=True),
                    lambda: TSP.init_sparse_state(tp, N, warm=True, device="cpu"),
                    JSP.make_sparse_fleet_run, TSP.make_sparse_fleet_run, TSP.make_sparse_run, _jax_draws,
                    TR.draw_sparse_tick)
    p = JPV.PviewParams(capacity=N, key_dtype=kd, **_KNOBS)
    tp = _tparams(p)
    return Case(p, JPV, TPV, lambda: JPV.init_pview_state(p, N, warm=True),
                lambda: TPV.init_pview_state(tp, N, warm=True, device="cpu"),
                JPV.make_pview_fleet_run, TPV.make_pview_fleet_run, TPV.make_pview_run, _jax_draws,
                TR.draw_sparse_tick)


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


@functools.lru_cache(maxsize=None)
def _jax_fleet(make, params, n_ticks: int):
    return make(params, n_ticks, False)


def _stack_draws(rows: list) -> list:
    """Per-row lists of ``(fd, round)`` draws -> per-tick pairs with [S, ...]
    leaves."""
    out = []
    for per_row in zip(*rows):
        fd0, rd0 = per_row[0]

        def stack(xs):
            return type(xs[0])(*(torch.stack([getattr(x, f.name) for x in xs]) for f in dataclasses.fields(xs[0])))

        out.append((None if fd0 is None else stack([fd for fd, _ in per_row]), stack([rd for _, rd in per_row])))
    return out


class FleetChain:
    """The JAX fleet's per-row key chains as a port draw source: ``(n_ticks)
    -> [(fd, round), ...]`` with [S, ...] draws, each call continuing every
    row's chain."""

    def __init__(self, keys, params, draws):
        self.keys = [keys[i] for i in range(keys.shape[0])]
        self.params, self.draws = params, draws

    def __call__(self, n_ticks: int) -> list:
        rows = []
        for i, key in enumerate(self.keys):
            self.keys[i], d = self.draws(key, n_ticks, self.params)
            rows.append(d)
        return _stack_draws(rows)


def _jax_arrays(fs) -> dict:
    return {f.name: np.asarray(getattr(fs, f.name)) for f in dataclasses.fields(fs)}


def _assert_fleet_equal(jfs, tfs, label):
    ref = _jax_arrays(jfs)
    got = convert.fleet_to_numpy(tfs)
    assert set(ref) == set(got), f"{label}: leaves differ: {set(ref) ^ set(got)}"
    for name, v in ref.items():
        g = got[name]
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        if g.dtype == np.uint32:
            g = g.view(np.int32)
        assert g.shape == v.shape, f"{label}: leaf {name} shape {g.shape} != {v.shape}"
        assert np.array_equal(g, v), f"{label}: fleet leaf {name} diverged"


def _assert_metrics_equal(jms, tms, label):
    assert set(jms) == set(tms), f"{label}: metric names differ: {set(jms) ^ set(tms)}"
    for name, v in jms.items():
        v = np.asarray(v)
        g = tms[name].numpy()
        assert g.shape == v.shape, f"{label}: metric {name} shape {g.shape} != {v.shape}"
        if name in FLOAT_METRICS:
            ulp = np.abs(g.view(np.int32).astype(np.int64) - v.view(np.int32).astype(np.int64))
            assert ulp.max(initial=0) <= 2, f"{label}: metric {name} off by {ulp.max()} ulp"
        else:
            assert np.array_equal(g, v), f"{label}: stacked metric {name} diverged"


def _to_port(jfs):
    return convert.fleet_from_numpy(_jax_arrays(jfs), device="cpu")


# -- 1. the fleet window against JAX make_fleet_run ---------------------------


@pytest.mark.parametrize("engine,kd", ENGINE_CASES)
def test_fleet_window_matches_jax(engine, kd):
    """The port fleet fed the JAX fleet's per-row key chains equals JAX
    ``make_fleet_run`` in every leaf and every stacked metric."""
    c = _case(engine, kd)
    origins = [(s * 37 + 1) % N for s in SEEDS]
    jfs = JFL.fleet_inject_rumor(c.jmod, JFL.fleet_broadcast(c.jinit(), len(SEEDS)), 0, origins)
    tfs = TFL.fleet_inject_rumor(c.tmod, TFL.fleet_broadcast(c.tinit(), len(SEEDS)), 0, origins)
    _assert_fleet_equal(jfs, tfs, f"{engine}/{kd} fleet start")
    tfs = _to_port(jfs)  # the JAX fleet carried across runs the same
    keys = JFL.fleet_keys(SEEDS)
    chain = FleetChain(keys, c.jparams, c.draws)
    jfs2, jkeys, jms, _ = _jax_fleet(c.jmake, c.jparams, T)(jfs, keys)
    tfs2, tms, _ = c.tmake(_tparams(c.jparams), T)(tfs, chain(T))
    for i, k in enumerate(chain.keys):
        assert np.array_equal(np.asarray(k), np.asarray(jkeys[i])), "the key chains were consumed differently"
    _assert_fleet_equal(jfs2, tfs2, f"{engine}/{kd} after {T} fleet ticks")
    _assert_metrics_equal(jms, tms, f"{engine}/{kd}")
    assert int(tms["rumor_deliveries"].sum()) > 0


# -- 2. each row against the port's serial window ------------------------------


def _row_draws(draws: list, s: int) -> list:
    """Row ``s`` of per-tick ``(fd, round)`` draws with [S, ...] leaves."""

    def row(x):
        return None if x is None else type(x)(*(getattr(x, f.name)[s] for f in dataclasses.fields(x)))

    return [(row(fd), row(rd)) for fd, rd in draws]


def _gen_draws(c: Case, tp, tick: int, ticks: int, s: int, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in range(tick, tick + ticks):
        out.append(c.tdraw(gen, tp, (t + 1) % tp.fd_every == 0, lead=(s,)))
    return out

CRASHES = ([], [5], [9, 12])


@pytest.mark.parametrize("engine,kd", ENGINE_CASES)
def test_fleet_rows_match_serial_window(engine, kd):
    """Rows with different crashes (a quiet-tick gate open in some rows
    only) over 24 ticks of generator draws: each row equals the port's
    serial window fed that row's draws, its watched view rows included."""
    c = _case(engine, kd)
    tp = _tparams(c.jparams)
    ticks = 24

    def start(s):
        st = c.tmod.spread_rumor(c.tinit(), 0, (s * 11 + 2) % N)
        return c.tmod.crash_rows(st, CRASHES[s]) if CRASHES[s] else st

    fs = TFL.fleet_stack([start(s) for s in range(len(CRASHES))])
    gen = torch.Generator().manual_seed(4)
    draws, tick = [], fs.tick
    for _ in range(ticks):
        draws.append(c.tdraw(gen, tp, (tick + 1) % tp.fd_every == 0, lead=(len(CRASHES),)))
        tick += 1
    watch = torch.tensor([5, 20])
    fs, fms, fwatched = c.tmake(tp, ticks)(fs, draws, watch_rows=watch)
    serial = c.tserial(tp, ticks)
    for s in range(len(CRASHES)):
        st, ms, watched = serial(start(s), _row_draws(draws, s), watch_rows=watch)
        assert torch.equal(fwatched[s], watched), f"{engine}/{kd} row {s}: watched rows"
        row = TFL.fleet_row(fs, s)
        assert row.tick == st.tick
        for name in TFL._leaf_names(st):
            assert torch.equal(getattr(row, name), getattr(st, name)), f"{engine}/{kd} row {s}: leaf {name}"
        for k, v in ms.items():
            assert torch.equal(fms[k][s], v), f"{engine}/{kd} row {s}: metric {k}"
    assert int(fms["fd_new_suspects"].sum()) > 0


#: each quiet-tick gate of the sparse and pview ticks, as (the function
#: that reads it, the flag's place in its host read)
GATES = {
    "sparse": {("_suspicion_sweep", 0), ("_gossip_phase_fused", 0), ("_gossip_phase_fused", 1),
               ("allocate", 0), ("alloc_phase", 0), ("rumor_metrics", 0)},
    "pview": {("_maintenance_sweep", 0), ("_gossip_phase_fused", 0), ("_gossip_phase_fused", 1),
              ("_rumor_sweeps_fused", 0), ("allocate", 0), ("alloc_phase", 0), ("rumor_metrics", 0)},
}


@pytest.mark.parametrize("engine", ["sparse", "pview"])
def test_fleet_gate_open_in_one_row_is_a_no_op_in_the_other(engine, monkeypatch):
    """Each sparse and pview gate seen open in one row and closed in the
    other: a gate's branch then runs for both rows, and the row whose own
    flag is clear must still equal its serial window, where that branch is
    skipped. Two rows over three 16-tick windows: both quiet; row 0 busy
    (six crashes and a rumor, so a pool of 4 records must evict) while row
    1 stays quiet; row 1 busy while row 0's records and rumor retire. Every
    host read is recorded per row, and every gate must have seen the rows'
    flags differ. pview runs with SYNC rare, so that its quiet row holds no
    record."""
    from scalecube_cluster_tpu_torch.ops import _tick as TT
    from scalecube_cluster_tpu_torch.ops import pool as TPO
    from torch._C import _functorch

    c = _case(engine, "i32")
    knobs = dict(_KNOBS, sync_every=1000) if engine == "pview" else _KNOBS
    tp = _tparams(dataclasses.replace(c.jparams, mr_slots=4, **knobs))
    reads = []
    real = c.tmod.host_flags

    def recorded(*flags):
        if all(_functorch.is_batchedtensor(f) for f in flags):
            rows = [_functorch.get_unwrapped(f).tolist() for f in flags]
            reads.append((sys._getframe(1).f_code.co_name, rows))
        return real(*flags)

    for mod in (c.tmod, TT, TPO):
        monkeypatch.setattr(mod, "host_flags", recorded)

    ticks = 16
    make, serial = c.tmake(tp, ticks), c.tserial(tp, ticks)
    init = {"sparse": lambda: TSP.init_sparse_state(tp, N, warm=True, device="cpu"),
            "pview": lambda: TPV.init_pview_state(tp, N, warm=True, device="cpu")}[engine]
    busy = {1: (0, [5, 6, 7, 8, 9, 10]), 2: (1, [20, 21, 22, 23])}
    rows = [init(), init()]
    for w in range(3):
        if w in busy:
            s, crashed = busy[w]
            rows[s] = c.tmod.crash_rows(c.tmod.spread_rumor(rows[s], 0, 3), crashed)
        draws = _gen_draws(c, tp, rows[0].tick, ticks, 2, seed=10 + w)
        fs, fms, _ = make(TFL.fleet_stack(rows), draws)
        for s in range(2):
            st, ms, _ = serial(rows[s], _row_draws(draws, s))
            row = TFL.fleet_row(fs, s)
            assert row.tick == st.tick
            for name in TFL._leaf_names(st):
                assert torch.equal(getattr(row, name), getattr(st, name)), f"{engine} window {w} row {s}: leaf {name}"
            for k, v in ms.items():
                assert torch.equal(fms[k][s], v), f"{engine} window {w} row {s}: metric {k}"
            rows[s] = row
    differed = {(site, i) for site, flags in reads for i, per_row in enumerate(flags) if len(set(per_row)) > 1}
    assert GATES[engine] <= differed, f"{engine}: gates never seen open in one row only: {GATES[engine] - differed}"


# -- 3. the adaptive fleet against JAX make_fleet_adaptive_run ---------------

SPEC = JA.AdaptiveSpec(enabled=True, lh_max=4, min_mult=2, max_mult=6, conf_target=3)


def test_adaptive_fleet_matches_jax():
    """Dense with the delay rings at D = 4, a degraded cohort (inbound
    loss, a flaky observer, a slow member, a crash), under the adaptive
    plane: the port fleet equals JAX ``make_fleet_adaptive_run`` in every
    leaf, the three adaptive planes and every stacked metric."""
    p = JS.SimParams(capacity=N, full_metrics=True, delay_slots=4, adaptive=SPEC,
                     **{**_KNOBS, "fd_every": 1})
    tp = _tparams(p)
    everyone = list(range(N))

    def start(mod, st):
        st = mod.set_link_loss(st, everyone, [5, 6, 7], 0.7)
        st = mod.set_link_loss(st, [9], everyone, 0.7)
        st = mod.set_link_delay(st, everyone, [11], 2.0)
        st = mod.spread_rumor(st, 0, 3)
        return mod.crash_rows(st, [12])

    j0 = start(JS, JS.init_state(p, N, uniform_loss=0.05, uniform_delay=0.5))
    t0 = start(TS, TS.init_state(tp, N, uniform_loss=0.05, uniform_delay=0.5, device="cpu"))
    jfs, tfs = JFL.fleet_broadcast(j0, 2), TFL.fleet_broadcast(t0, 2)
    jad = JFL.fleet_broadcast(JA.init_adaptive_state(N), 2)
    tad = TFL.fleet_broadcast(init_adaptive_state(N, device="cpu"), 2)
    keys = JFL.fleet_keys((3, 11))
    chain = FleetChain(keys, p, dense_draws)
    ticks = 16
    jfs, jad, _k, jms, _ = _jax_fleet(JFL.make_fleet_adaptive_run, p, ticks)(jfs, jad, keys)
    tfs, tad, tms, _ = TK.make_fleet_adaptive_run(tp, ticks)(tfs, tad, chain(ticks))
    _assert_fleet_equal(jfs, tfs, "adaptive fleet")
    for k in ("lh", "conf_key", "conf"):
        assert np.array_equal(getattr(tad, k).numpy(), np.asarray(getattr(jad, k))), f"adaptive plane {k}"
    _assert_metrics_equal(jms, tms, "adaptive fleet")
    assert int(tms["adaptive_lh_high"].max()) >= 1


# -- 4. the batched timeline against JAX's -------------------------------------


def _timeline_case(kind: str):
    """(JAX params, scenario pair, start states, vary pair, dense_links)."""
    if kind == "storm_scalar":
        p = JS.SimParams(capacity=N, full_metrics=False, **_KNOBS)
        mk = [(mod.Scenario("storm", events=(mod.LossStorm(pct=30.0, at=1, until=5), mod.Crash(rows=[4], at=2)),
                            horizon=T)) for mod in (JEV, TEV)]
        starts = (lambda: JS.init_state(p, N, dense_links=False, uniform_loss=0.05),
                  lambda: TS.init_state(_tparams(p), N, dense_links=False, uniform_loss=0.05, device="cpu"))
        return p, mk, starts, (None, None), False
    p = JS.SimParams(capacity=N, full_metrics=False, **_KNOBS)
    mk = [(mod.Scenario("vary", events=(mod.LossStorm(pct=20.0, at=1, until=6), mod.Crash(rows=[3], at=2)),
                        horizon=T)) for mod in (JEV, TEV)]
    starts = (lambda: JS.init_state(p, N, uniform_loss=0.05),
              lambda: TS.init_state(_tparams(p), N, uniform_loss=0.05, device="cpu"))
    vary = (JFL.FleetVary(crash_rows=[3, 11], loss_pct=[10.0, 30.0]),
            TFL.FleetVary(crash_rows=[3, 11], loss_pct=[10.0, 30.0]))
    return p, mk, starts, vary, True


@pytest.mark.parametrize("kind", ["storm_scalar", "vary"])
def test_fleet_timeline_matches_jax(kind):
    """One schedule replayed onto a 2-scenario fleet through one-tick fleet
    windows: the port's states equal JAX's after every action and every
    tick (the storm stash restores each scenario's own loss)."""
    p, (jscen, tscen), (jstart, tstart), (jvary, tvary), dense = _timeline_case(kind)
    tp = _tparams(p)
    jfs = JFL.fleet_inject_rumor(JS, JFL.fleet_broadcast(jstart(), 2), 0, [1, 2])
    tfs = TFL.fleet_inject_rumor(TS, TFL.fleet_broadcast(tstart(), 2), 0, [1, 2])
    jtl = JFL.fleet_timeline(jscen, JS, dense_links=dense, horizon=T, vary=jvary)
    ttl = TFL.fleet_timeline(tscen, TS, dense_links=dense, horizon=T, vary=tvary)
    keys = JFL.fleet_keys((5, 6))
    chain = FleetChain(keys, p, dense_draws)
    jrun, trun = _jax_fleet(JK.make_fleet_run, p, 1), TK.make_fleet_run(tp, 1)
    for t in range(T):
        jfs, jl = jtl.apply_due(jfs, t)
        tfs, tl = ttl.apply_due(tfs, t)
        assert jl == tl
        _assert_fleet_equal(jfs, tfs, f"{kind}: after the actions due at {t}")
        jfs, keys, jms, _ = jrun(jfs, keys)
        tfs, tms, _ = trun(tfs, chain(1))
        _assert_fleet_equal(jfs, tfs, f"{kind}: tick {t + 1}")
        _assert_metrics_equal(jms, tms, f"{kind}: tick {t + 1}")
    if tvary is not None:
        got = TFL.fleet_crash_detected_varied(tfs, tvary.crash_rows)
        ref = JFL.fleet_crash_detected_varied(jfs, jvary.crash_rows)
        assert np.array_equal(got.numpy(), np.asarray(ref))


# -- 5. the Monte Carlo folds --------------------------------------------------


def test_fleet_folds_match_jax():
    """fold_first_full_coverage, fleet_false_dead, fleet_crash_detected and
    its varied twin on random fleets (keys of every rank, unknown cells, down
    rows) equal JAX's."""
    rng = np.random.default_rng(3)
    s, n = 4, 33
    vk = rng.integers(-1, 64, (s, n, n)).astype(np.int32)
    vk[:, :, 6] = np.where(rng.random((s, n)) < 0.8, 3, vk[:, :, 6])
    up = rng.random((s, n)) < 0.85
    jst = JS.SimState(**{**{f.name: None for f in dataclasses.fields(JS.SimState)},
                         "view_key": jnp.asarray(vk), "up": jnp.asarray(up)})
    tst = TS.SimState(**{**{f.name: None for f in dataclasses.fields(TS.SimState)}, "tick": 0,
                         "view_key": torch.from_numpy(vk), "up": torch.from_numpy(up)})
    watch = np.zeros(n, bool)
    watch[[5, 6, 7, 9]] = True
    assert np.array_equal(TFL.fleet_false_dead(tst, torch.from_numpy(watch)).numpy(),
                          np.asarray(JFL.fleet_false_dead(jst, jnp.asarray(watch))))
    for r in (6, 20):
        assert np.array_equal(TFL.fleet_crash_detected(tst, r).numpy(),
                              np.asarray(JFL.fleet_crash_detected(jst, r)))
    rows = [6, 2, 6, 30]
    assert np.array_equal(TFL.fleet_crash_detected_varied(tst, rows).numpy(),
                          np.asarray(JFL.fleet_crash_detected_varied(jst, rows)))
    cov = (rng.random((s, 7)) < 0.3).astype(np.float32) + rng.random((s, 7)).astype(np.float32) * 0.5
    cov = np.minimum(cov, 1.0)
    hit = np.array([-1, 5, -1, -1], np.int32)
    got = TFL.fold_first_full_coverage(torch.from_numpy(hit), torch.from_numpy(cov), 40)
    ref = JFL.fold_first_full_coverage(jnp.asarray(hit), jnp.asarray(cov), 40)
    assert np.array_equal(got.numpy(), np.asarray(ref))


# -- 6. refusals, plumbing and the plain kernel -------------------------------


def test_fleet_refusals_by_name():
    """Unequal ticks do not stack; a fleet shards only on a 2-D scenarios x
    members mesh, made in a process group; a default adaptive spec is
    refused by name; a bus takes the Monte Carlo records."""
    from scalecube_cluster_tpu_torch.dissemination import certify as TC

    p = TS.SimParams(capacity=8, rumor_slots=4)
    a = TS.init_state(p, 8, device="cpu")
    b = a.replace(tick=3)
    with pytest.raises(ValueError, match="ticks differ"):
        TFL.fleet_stack([a, b])
    # the scenario mesh and the 2-D scenarios x members mesh are ported
    # (tests/test_torch_sharding.py, tests/test_torch_mesh_delay.py): a
    # fleet shards on a 2-D mesh only, and the mesh needs a process group
    from scalecube_cluster_tpu_torch.ops import sharding as TSH

    with pytest.raises(ValueError, match="2-D"):
        TSH.shard_pview_fleet(TFL.fleet_broadcast(a, 2), None)
    with pytest.raises(RuntimeError, match="process group"):
        TSH.make_pview_mesh2d(2)
    # the telemetry bus is ported: each Monte Carlo cell leaves its record
    from scalecube_cluster_tpu_torch.telemetry import TelemetryBus

    bus = TelemetryBus(8)
    rec = TC.mc_spread_certifier(matrix=[("push", "full", "dense")], n=16, n_seeds=8, window=16, bus=bus,
                                 device="cpu")
    got = [(r.kind, r.fields["engine"], r.fields["n_seeds"], r.fields["certified"]) for r in bus.tail()]
    assert got == [("spread_certified_mc", "dense", 8, rec["entries"][0]["certified"])]
    with pytest.raises(ValueError, match="enabled AdaptiveSpec"):
        TFL.make_fleet_adaptive_run(p, 4)
    fs = TFL.fleet_broadcast(a, 3)
    assert TFL.fleet_size(fs) == 3 and fs.capacity == 8
    row = TFL.fleet_row(fs, 1)
    assert all(torch.equal(getattr(row, k), getattr(a, k)) for k in TFL._leaf_names(a))
    from scalecube_cluster_tpu.ops import engine_api as JEA
    from scalecube_cluster_tpu_torch.ops import engine_api as TEA

    for name in ("dense", "sparse", "pview"):
        assert TEA.engine(name).fleet_memory_factor == JEA.engine(name).contracts.fleet_memory_factor


def test_fleet_scope_batching_rules():
    """What the fleet seams need of torch's private functorch calls: under
    ``fleet_scope`` a factory's result is one tensor per scenario, a host
    flag is set when any scenario's is, and ``fleet_scope(0)`` inside makes
    whole-plane tensors again."""
    from torch._C import _functorch

    from scalecube_cluster_tpu_torch.ops import _tensor as TT

    x = torch.tensor([[1, 0, 0], [0, 0, 0], [0, 2, 0]])
    seen = {}

    def tick(row):
        acc = torch.zeros((3,), dtype=torch.int64)
        seen["batched"] = _functorch.is_batchedtensor(acc)
        acc += row  # an in-place update of a batched value lands per scenario
        seen["flags"] = TT.host_flags(row[0] > 0, row[1] > 0, row[2] > 5)
        with TT.fleet_scope(0):
            seen["plain"] = _functorch.is_batchedtensor(torch.zeros((4,)))
        return acc

    before = TT.HOST_SYNCS.count
    with TT.fleet_scope(3):
        out = torch.func.vmap(tick)(x)
    assert torch.equal(out, x)
    assert seen["flags"] == [True, True, False]
    assert seen["batched"] and not seen["plain"]
    assert TT.HOST_SYNCS.count == before + 1
    assert not TT.in_fleet()
    assert torch.zeros((2,)).shape == (2,)


def test_fleet_kernel_plain_version_matches_serial():
    """The scenario-axis plain version (and the kernel wrapper under the
    fleet's vmap, which takes it on the CPU) equals the serial plain version
    row by row."""
    g = torch.Generator().manual_seed(2)
    s, n, F, R, Wm = 3, 33, 3, 8, 5

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=g, dtype=torch.int64).to(torch.int32)

    ym, yu = words(s, n, Wm), words(s, n, 1)
    frm = torch.randint(-1, n, (s, n, R), generator=g, dtype=torch.int32)
    inv = torch.randint(-1, n, (s, F, n), generator=g, dtype=torch.int32)
    org = torch.randint(-1, n, (s, R), generator=g, dtype=torch.int32)
    fleet = TD.delivery_combine_fleet(ym, yu, frm, inv, org)
    vmapped = torch.func.vmap(TD.delivery_combine)(ym, yu, frm, inv, org)
    for i in range(s):
        ref = TD.delivery_combine_ref(torch.cat([ym[i], yu[i], frm[i]], 1), inv[i], org[i], Wm, R)
        for a, b, c in zip(fleet, vmapped, ref):
            assert torch.equal(a[i], c) and torch.equal(b[i], c)
    assert fleet[3].shape == (s,)
