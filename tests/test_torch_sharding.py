"""The port's member-sharded pview engine through a real gloo lane.

Two and four spawned processes (``ops/dcn.py: LocalWorld``, one module-
scoped group each, one thread per rank) run the sharded windows of
``ops/sharding.py``; every rank returns the whole state (gathered), the
stacked metrics, the watched rows, the adaptive planes and the trace ring.
Each must equal, bit for bit, the one-process port window on the same
draws, and the JAX single-device window fed the same key chain (the two
f32 metrics against JAX within 2 ulp, as every pview parity test holds
them). The JAX key chain gives the draws (``test_torch_pview_fused``). The
scenario puts its rumors, crashes, a join and a leave on the rank
boundaries. A starved exchange budget is held against JAX's sharded fused
window at the same budget on two virtual devices; the sharded driver
(adaptive, telemetry and trace armed) against the unsharded driver; the
fleet on a 2-rank scenario mesh against the one-process fleet; and every
part still to port is refused by name (the delay rings, the pull leg, the
2-D mesh and the driver's planes on a mesh are held in
``test_torch_mesh_delay.py`` and ``test_torch_mesh_planes.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as RK
import scalecube_cluster_tpu.ops.pview as JPV
from scalecube_cluster_tpu import adaptive as JA
from scalecube_cluster_tpu.ops import sharding as JSH
from scalecube_cluster_tpu.trace import schema as JSCH
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.adaptive import AdaptiveSpec, init_adaptive_state
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import fleet as TFL
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import rand as TR
from scalecube_cluster_tpu_torch.ops import sharding as TSH
from scalecube_cluster_tpu_torch.sim import SimDriver
from scalecube_cluster_tpu_torch.trace.rings import TraceRing
from scalecube_cluster_tpu_torch.trace.schema import TraceSpec
from test_torch_pview_fused import FLOAT_METRICS, _jax_draws

torch.set_num_threads(1)

N, T, WINDOWS = 256, 4, 2  # 8 ticks: two windows, the mutations between them
TRACERS = (0, 1, 127, 128)
# JAX tests/test_sharding.py's pview knobs, with a short suspicion timeout, a
# 4-tick sweep and a tombstone period so that expiry and the purge happen
_KNOBS = dict(capacity=N, view_slots=8, active_slots=4, fanout=2, ping_req_k=2, fd_every=3, sync_every=16,
              rumor_slots=4, seed_rows=(0, 1), mr_slots=16, announce_slots=8, full_metrics=True,
              suspicion_mult=1, sweep_every=4, tombstone_ticks=8)
AD_SPEC = dict(enabled=True, lh_max=4, min_mult=2, max_mult=6, conf_target=3)


@pytest.fixture(scope="module")
def lane2():
    with dcn.LocalWorld(2, "cpu") as lw:
        yield lw


def _params(kind: str = "fused", **over):
    kw = dict(_KNOBS, **over)
    if kind == "adaptive":
        kw["adaptive"] = JA.AdaptiveSpec(**AD_SPEC)
    return JPV.PviewParams(**kw)


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


def _scenario(mod, params, **kw):
    """Rumors from rows on both sides of the 2- and 4-rank boundaries,
    crashes and a leave there too."""
    st = mod.init_pview_state(params, N - 8, uniform_loss=0.05, **kw)
    st = mod.spread_rumor(st, 0, 127)
    st = mod.spread_rumor(st, 1, 64)
    st = mod.crash_rows(st, [128, 191])
    return mod.begin_leave(st, 129)


#: before window 1: a crash, a join, a rumor and a leave on the boundaries
MUTATE = {1: [("crash_rows", ([63, 192],)), ("join_row", (128, (0, 1))), ("spread_rumor", (2, 192)),
              ("begin_leave", (64,))]}


def _mutate(mod, st, w):
    for name, args in MUTATE.get(w, ()):
        st = getattr(mod, name)(st, *args)
    return st


@functools.lru_cache(maxsize=None)
def _jax_run(kind: str, params):
    if kind == "run":
        return JPV.make_pview_run(params, T, donate=False)
    if kind == "adaptive":
        return JPV.make_pview_adaptive_run(params, T, donate=False)
    if kind == "traced":
        return JPV.make_pview_traced_run(params, T, _jax_spec(params), donate=False)
    return JPV.make_pview_fused_run(params, T, donate=False)


def _jax_spec(params):
    return JSCH.TraceSpec(tracer_rows=TRACERS, rumor_slots=(0, 1), ring_len=256, ping_req_k=params.ping_req_k)


@functools.lru_cache(maxsize=None)
def _jax_windows(kind: str, params):
    """The JAX single-device windows and the draws of their key chain."""
    st = _scenario(JPV, params)
    snap0 = {k: np.asarray(v) for k, v in JPV.snapshot(st).items()}
    run = _jax_run(kind, params)
    key = jax.random.PRNGKey(3)
    ad = JA.init_adaptive_state(N) if kind == "adaptive" else None
    buf = jnp.zeros((256, _jax_spec(params).n_fields), jnp.int32) if kind == "traced" else None
    out, draws = [], []
    for w in range(WINDOWS):
        st = _mutate(JPV, st, w)
        if kind == "adaptive":
            st, ad, key_after, ms, _ = run(st, ad, key)
        elif kind == "traced":
            st, key_after, ms, _, buf = run(st, key, buf, jnp.int32(w * T * len(TRACERS)))
        else:
            st, key_after, ms, _ = run(st, key)
        key, dr = _jax_draws(key, T, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        draws.append(dr)
        rec = {"state": {k: np.asarray(v) for k, v in JPV.snapshot(st).items()},
               "metrics": {k: np.asarray(v) for k, v in ms.items()}}
        if ad is not None:
            rec["ad"] = {k: np.asarray(getattr(ad, k)) for k in ("lh", "conf_key", "conf")}
        if buf is not None:
            rec["ring"] = np.asarray(buf)
        out.append(rec)
    return snap0, draws, out


def _port_windows(kind: str, tparams, snap0, draws, watch):
    """The one-process port window on the same draws."""
    st = convert.state_from_numpy(snap0, device="cpu")
    ad = init_adaptive_state(N, device="cpu") if kind == "adaptive" else None
    ring = None
    if kind == "traced":
        ring = TraceRing(TraceSpec(tracer_rows=TRACERS, rumor_slots=(0, 1), ring_len=256,
                                   ping_req_k=tparams.ping_req_k), device="cpu")
    out = []
    for w in range(WINDOWS):
        st = _mutate(TPV, st, w)
        wr = torch.tensor(watch)
        if kind == "adaptive":
            st, ad, ms, watched = TPV.run_pview_ticks_adaptive(st, ad, draws[w], T, tparams, wr)
        elif kind == "traced":
            st, ms, watched = TPV.run_pview_ticks_traced(st, ring, draws[w], T, tparams, ring.spec, wr)
        else:
            st, ms, watched = TPV.run_pview_ticks_fused(st, draws[w], T, tparams, wr)
        rec = {"state": convert.state_to_numpy(st), "metrics": {k: v.numpy() for k, v in ms.items()},
               "watched": watched.numpy()}
        if ad is not None:
            rec["ad"] = {k: getattr(ad, k).numpy() for k in ("lh", "conf_key", "conf")}
        if ring is not None:
            rec["ring"] = ring.buf.numpy().copy()
        out.append(rec)
    return out


def _equal_to_jax(jrec, trec, label):
    for name, v in jrec["state"].items():
        g = trec["state"][name]
        v = v.view(np.int32) if v.dtype == np.uint32 else v
        assert np.array_equal(g, v), f"{label}: state leaf {name} diverged from JAX"
    assert set(jrec["metrics"]) == set(trec["metrics"]) - {"delivery_overflow"}, label
    for name, v in jrec["metrics"].items():
        g = trec["metrics"][name]
        if name in FLOAT_METRICS:
            ulp = np.abs(g.view(np.int32).astype(np.int64) - v.view(np.int32).astype(np.int64))
            assert ulp.max(initial=0) <= 2, f"{label}: metric {name} off by {ulp.max()} ulp"
        else:
            assert np.array_equal(g, v), f"{label}: metric {name} diverged from JAX"
    for part in ("ad", "ring"):
        if part in jrec:
            for k, v in (jrec[part].items() if part == "ad" else [("buf", jrec[part])]):
                g = trec[part][k] if part == "ad" else trec[part]
                assert np.array_equal(g, v), f"{label}: {part} {k} diverged from JAX"


def _equal_to_port(prec, srec, label):
    """The sharded window equals the one-process port bit for bit (the f32
    metrics too), with delivery_overflow added and 0."""
    for name, v in prec["state"].items():
        assert np.array_equal(srec["state"][name], v), f"{label}: state leaf {name} diverged"
    assert set(srec["metrics"]) == set(prec["metrics"]) | {"delivery_overflow"}, label
    for name, v in prec["metrics"].items():
        assert np.array_equal(srec["metrics"][name], v), f"{label}: metric {name} diverged"
    assert not srec["metrics"]["delivery_overflow"].any(), f"{label}: the lossless budget dropped records"
    assert np.array_equal(srec["watched"], prec["watched"]), f"{label}: watched rows diverged"
    for part in ("ad", "ring"):
        if part in prec:
            a, b = prec[part], srec[part]
            for k in (a if part == "ad" else [None]):
                assert np.array_equal(b[k] if k else b, a[k] if k else a), f"{label}: {part} {k} diverged"


def _check_windows(lane, kind: str, params):
    snap0, draws, jax_out = _jax_windows(kind, params)
    tparams = _tparams(params)
    watch = [0, 127, 128, N - 1]
    port = _port_windows(kind, tparams, snap0, draws, watch)
    res = lane.run(RK.window, kind, tparams, snap0, draws, T, None, watch, WINDOWS,
                   {w: m for w, m in MUTATE.items()})
    for w in range(WINDOWS):
        label = f"{kind}, W={lane.world}, window {w}"
        _equal_to_jax(jax_out[w], port[w], label + " (one process)")
        for r, rank in enumerate(res):
            _equal_to_port(port[w], rank["windows"][w], f"{label}, rank {r}")
    assert all(rank["launches"] == 0 for rank in res), "the delivery kernel ran on a mesh"
    ms = jax_out[-1]["metrics"]
    return {k: int(np.asarray(ms[k]).sum()) for k in ("mr_accepts", "sync_roundtrips", "fd_new_suspects",
                                                      "rumor_deliveries")}


@pytest.mark.parametrize("kind", ["run", "fused", "adaptive", "traced"])
def test_sharded_window_w2_equals_port_and_jax(lane2, kind):
    busy = _check_windows(lane2, kind, _params(kind))
    assert all(v > 0 for v in busy.values()), busy


def test_sharded_fused_window_w4_equals_port_and_jax():
    with dcn.LocalWorld(4, "cpu") as lane4:
        busy = _check_windows(lane4, "fused", _params())
    assert all(v > 0 for v in busy.values()), busy


def test_starved_budget_equals_jax_sharded_run(lane2):
    """Budget 12 of a lossless 256 per (src, dst): JAX's sharded fused
    window on two virtual devices and the gloo lane drop the same records,
    end in the same state and count the same overflow."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    params, budget = _params(), 12
    mesh = JSH.make_mesh(jax.devices()[:2])
    run = JSH.make_sharded_pview_fused_run(mesh, params, 2 * T, a2a_budget=budget)
    jst = JSH.shard_pview_state(_scenario(JPV, params), mesh)
    snap0 = {k: np.asarray(v) for k, v in JPV.snapshot(_scenario(JPV, params)).items()}
    key = jax.random.PRNGKey(3)
    jst, key_after, jms, _ = run(jst, key)
    _, draws = _jax_draws(key, 2 * T, params)
    res = lane2.run(RK.window, "fused", _tparams(params), snap0, [draws], 2 * T, budget)
    jref = {k: np.asarray(v) for k, v in JPV.snapshot(jst).items()}
    overflow = np.asarray(jms["delivery_overflow"])
    assert overflow.sum() > 0, "the starved budget dropped nothing"
    for rank in res:
        got = rank["windows"][0]
        for name, v in jref.items():
            v = v.view(np.int32) if v.dtype == np.uint32 else v
            assert np.array_equal(got["state"][name], v), f"starved budget: state leaf {name} diverged"
        assert np.array_equal(got["metrics"]["delivery_overflow"], overflow)
        for name in ("rumor_sends", "rumor_deliveries", "mr_deliveries", "gossip_msgs"):
            assert np.array_equal(got["metrics"][name], np.asarray(jms[name])), name


@pytest.mark.parametrize("armed", ["adaptive", "trace"])
def test_sharded_driver_equals_unsharded_driver(lane2, armed):
    """The driver script (boundary mutations, watched rows, a partition)
    with telemetry and ``armed`` armed: state, events, views, statuses,
    coverage, health, the telemetry ring (but for the per-rank
    shard_peak_mem_mb), the trace ring and the readback count equal."""
    kw = dict(_KNOBS)
    if armed == "adaptive":
        kw["adaptive"] = AdaptiveSpec(**AD_SPEC)
    params = TPV.PviewParams(**kw)
    res = lane2.run(RK.sharded_driver, params, N, armed)
    d = SimDriver(params, N - 8, seed=3, device="cpu")
    d.arm_telemetry()
    if armed == "trace":
        d.arm_trace(tracer_rows=(0, N // 2 - 1, N // 2, N - 1), rumor_slots=(0, 1))
    RK.driver_script(d, N)
    ref = RK.driver_record(d, N)

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), path
        else:
            assert a == b, path

    for r, rank in enumerate(res):
        assert rank.pop("launches") == 0
        same(ref, rank, f"rank {r}")
    assert sum(len(v) for v in ref["events"].values()) > 0


def test_fleet_on_a_scenario_mesh_equals_one_process_fleet(lane2):
    """Each rank runs 2 of 4 pview scenarios, the one-process fleet's
    draws; the rows and the Monte Carlo folds equal."""
    params = TPV.PviewParams(capacity=33, fanout=2, ping_req_k=1, fd_every=3, sync_every=8, rumor_slots=4,
                             seed_rows=(0, 1), mr_slots=16, announce_slots=8)
    st = TPV.init_pview_state(params, 32, uniform_loss=0.05, device="cpu")
    fs = TFL.fleet_inject_rumor(TPV, TFL.fleet_broadcast(st, 4), 0, [1, 5, 9, 20])
    fnp = convert.fleet_to_numpy(fs)
    res = lane2.run(RK.fleet_window, params, fnp, 7, 8)
    ref, ms, _ = TFL.make_fleet_run(params, 8)(convert.fleet_from_numpy(fnp, device="cpu"),
                                               TFL.fleet_generator(7, device="cpu"))
    hit = TFL.fold_first_full_coverage(torch.full((4,), -1, dtype=torch.int32), ms["rumor_coverage"][:, :, 0], 0)
    rn = convert.fleet_to_numpy(ref)
    for rank in res:
        assert rank["rows"] == 2
        for k, v in rn.items():
            assert np.array_equal(rank["fleet"][k], v), f"fleet leaf {k} diverged"
        for k, v in ms.items():
            assert np.array_equal(rank["metrics"][k], v.numpy()), f"fleet metric {k} diverged"
        assert np.array_equal(rank["hit"], hit.numpy())
        assert rank["covered"] == int((hit >= 0).sum())


def test_refusals_by_name(lane2):
    """What a mesh still refuses: nothing by name. The sparse engine's
    sharded windows, states, drivers and profile (A12 item 5(b)) and the
    dense engine's (A12 item 5(a)) go through, and a dense or sparse
    sharded driver refuses the trace plane and an adaptive ladder with
    JAX's ValueErrors; the compile cache, the audit, the sim transport and
    the emulator runner (once refused as A13) go through on a sharded
    driver; the alignment, fleet-size and 2-D mesh rules raise JAX's
    ValueErrors (a 2-D mesh runs only the fleet)."""
    got = lane2.run(RK.refusals)
    value_errors = {"misaligned capacity", "fleet of 3", "2-D mesh driver", "2-D mesh window", "2-D factoring",
                    "2-D fleet on a 1-D mesh", "dense trace capture", "dense adaptive ladder",
                    "sparse trace capture", "sparse adaptive ladder"}
    through = {"compile cache", "cache audit", "sim transport", "emulator chaos", "dense driver", "dense window",
               "dense tick", "dense state", "sparse driver", "sparse window", "sparse tick", "sparse state",
               "sparse profile"}
    for rank in got:
        assert set(rank) == value_errors | through
        for what, (kind, msg) in rank.items():
            assert kind == ("ValueError" if what in value_errors else "none"), (what, kind, msg)
        assert "factor" in rank["2-D factoring"][1] and "2-D" in rank["2-D fleet on a 1-D mesh"][1]
        for engine in ("dense", "sparse"):
            assert f"trace capture is single-device for the {engine} engine" in rank[f"{engine} trace capture"][1]
            assert "make_sharded_adaptive_run" in rank[f"{engine} adaptive ladder"][1]
    for fn in (lambda: TSH.make_sharded_run(None, None, 1), lambda: TSH.make_sharded_tick(None, None),
               lambda: TSH.make_sharded_sparse_run(None, None, 1), lambda: TSH.make_sharded_sparse_tick(None, None)):
        with pytest.raises(ValueError, match="1-D 'members' mesh"):
            fn()


def test_draws_every_rank_shares():
    """The rule the sharded windows rest on: a generator seeded the same
    draws the same full blocks on every rank, and a rank's rows of them are
    its slice."""
    params = _tparams(_params())
    a = TR.draw_sparse_tick(torch.Generator().manual_seed(9), params, True)
    b = TR.draw_sparse_tick(torch.Generator().manual_seed(9), params, True)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name))
            assert getattr(x, f.name).shape[0] == N


@pytest.mark.parametrize("engine", ["dense", "pview", "sparse"])
@pytest.mark.parametrize("dense_links", [True, False])
@pytest.mark.parametrize("delay_slots", [0, 4])
def test_engine_state_shardings_match_jax(engine, dense_links, delay_slots):
    """Each engine descriptor's ``state_shardings`` tags every leaf as JAX's
    places it: a spec led by the member axis is a row split, one with the
    member axis second a ring split on dim 1, an empty one replicated;
    what JAX refuses, the port refuses."""
    from scalecube_cluster_tpu.ops import engine_api as JEA
    from scalecube_cluster_tpu_torch.ops import engine_api as TEA

    mesh = JSH.make_mesh(jax.devices()[:1])
    try:
        ref = JEA.engine(engine).state_shardings(mesh, dense_links, delay_slots)
    except ValueError as exc:
        # pview has no dense link planes: both refuse them alike
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            TEA.engine(engine).state_shardings(None, dense_links, delay_slots)
        return
    got = TEA.engine(engine).state_shardings(None, dense_links, delay_slots)
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        spec = tuple(getattr(ref, name).spec)
        want = (TSH.ROW if spec[:1] == (TSH.MEMBER_AXIS,) else
                TSH.RING if spec[1:2] == (TSH.MEMBER_AXIS,) else TSH.REPLICATED)
        assert getattr(got, name) == want, (engine, name, spec)
