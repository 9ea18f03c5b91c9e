"""The port's member-sharded pview engine with the delay rings and the
push-pull leg, and its fleet on a 2-D scenarios x members mesh, through a
real gloo lane.

Spawned processes (``ops/dcn.py: LocalWorld(W, "cpu")``, one module-scoped
group of 2 and one of 4) run the sharded windows of ``ops/sharding.py``
with ``delay_slots`` = 4 and ``strategy="push_pull"``: the late contacts
and the pulled peer rows cross in the exact exchanges of
``ops/ragged_a2a.py``. Every rank's whole state (every leaf and ring row),
metrics, watched rows, adaptive planes and trace ring must equal, bit for
bit, the one-process port on the same draws, which equals the JAX
single-device window fed the same key chain (the two f32 metrics within 2
ulp). A starved exchange budget is held against JAX's sharded fused window
on two virtual devices: only on-time records drop. The 2-D fleet (2 x 2) is
held against the one-process fleet, each scenario's serial window and JAX's
2 x 4 sharded fleet run, with as many collectives a fleet tick as a serial
tick; and the 2-D mesh's two refusals.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as RK
import scalecube_cluster_tpu.ops.pview as JPV
from scalecube_cluster_tpu import adaptive as JA
from scalecube_cluster_tpu.dissemination.spec import DissemSpec as JDissemSpec
from scalecube_cluster_tpu.ops import fleet as JFL
from scalecube_cluster_tpu.ops import sharding as JSH
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.adaptive import init_adaptive_state
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import fleet as TFL
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.trace.rings import TraceRing
from scalecube_cluster_tpu_torch.trace.schema import TraceSpec
from test_torch_pview_fused import FLOAT_METRICS, _jax_draws
from test_torch_sharding import AD_SPEC, MUTATE, TRACERS, _equal_to_jax, _equal_to_port, _jax_spec, _mutate

torch.set_num_threads(1)

N, T, WINDOWS, D = 256, 4, 2, 4
# test_torch_sharding's knobs, with the rings (a mean delay of 1.5 ticks,
# so that d runs 0..3) and the pull leg
_KNOBS = dict(capacity=N, view_slots=8, active_slots=4, fanout=2, ping_req_k=2, fd_every=3, sync_every=16,
              rumor_slots=4, seed_rows=(0, 1), mr_slots=16, announce_slots=8, full_metrics=True,
              suspicion_mult=1, sweep_every=4, tombstone_ticks=8, delay_slots=D)


@pytest.fixture(scope="module")
def lane2():
    with dcn.LocalWorld(2, "cpu") as lw:
        yield lw


@pytest.fixture(scope="module")
def lane4():
    with dcn.LocalWorld(4, "cpu") as lw:
        yield lw


def _params(kind: str = "fused", **over):
    kw = dict(_KNOBS, dissem=JDissemSpec(strategy="push_pull"), **over)
    if kind == "adaptive":
        kw["adaptive"] = JA.AdaptiveSpec(**AD_SPEC)
    return JPV.PviewParams(**kw)


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


def _scenario(mod, params, **kw):
    """test_torch_sharding's boundary scenario under the uniform delay."""
    st = mod.init_pview_state(params, N - 8, uniform_loss=0.05, uniform_delay=1.5, **kw)
    st = mod.spread_rumor(st, 0, 127)
    st = mod.spread_rumor(st, 1, 64)
    st = mod.crash_rows(st, [128, 191])
    return mod.begin_leave(st, 129)


@functools.lru_cache(maxsize=None)
def _jax_windows(kind: str, params):
    """The JAX single-device windows (fused; adaptive; traced, whose tick
    is the unfused one) and the draws of their key chain."""
    st = _scenario(JPV, params)
    snap0 = {k: np.asarray(v) for k, v in JPV.snapshot(st).items()}
    if kind == "adaptive":
        run = JPV.make_pview_fused_adaptive_run(params, T, donate=False)
    elif kind == "traced":
        run = JPV.make_pview_traced_run(params, T, _jax_spec(params), donate=False)
    else:
        run = JPV.make_pview_fused_run(params, T, donate=False)
    key = jax.random.PRNGKey(3)
    ad = JA.init_adaptive_state(N) if kind == "adaptive" else None
    buf = jax.numpy.zeros((256, _jax_spec(params).n_fields), jax.numpy.int32) if kind == "traced" else None
    out, draws = [], []
    for w in range(WINDOWS):
        st = _mutate(JPV, st, w)
        if kind == "adaptive":
            st, ad, key_after, ms, _ = run(st, ad, key)
        elif kind == "traced":
            st, key_after, ms, _, buf = run(st, key, buf, jax.numpy.int32(w * T * len(TRACERS)))
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
        # copies: the next window writes the rings in place
        rec = {"state": {k: v.copy() for k, v in convert.state_to_numpy(st).items()},
               "metrics": {k: v.numpy() for k, v in ms.items()}, "watched": watched.numpy()}
        if ad is not None:
            rec["ad"] = {k: getattr(ad, k).numpy() for k in ("lh", "conf_key", "conf")}
        if ring is not None:
            rec["ring"] = ring.buf.numpy().copy()
        out.append(rec)
    return out


def _check(lane, kind: str):
    params = _params(kind)
    snap0, draws, jax_out = _jax_windows(kind, params)
    tparams = _tparams(params)
    watch = [0, 127, 128, N - 1]
    port = _port_windows(kind, tparams, snap0, draws, watch)
    res = lane.run(RK.window, kind, tparams, snap0, draws, T, None, watch, WINDOWS, dict(MUTATE))
    for w in range(WINDOWS):
        label = f"{kind} D={D} push_pull, W={lane.world}, window {w}"
        _equal_to_jax(jax_out[w], port[w], label + " (one process)")
        for r, rank in enumerate(res):
            _equal_to_port(port[w], rank["windows"][w], f"{label}, rank {r}")
    assert all(rank["launches"] == 0 for rank in res), "the delivery kernel ran on a mesh"
    # the rings carried deliveries and the pull leg answered
    assert any(port[w]["state"]["pending_inf"].any() or port[w]["state"]["pending_minf"].any()
               for w in range(WINDOWS))
    ms = jax_out[-1]["metrics"]
    return {k: int(np.asarray(ms[k]).sum()) for k in ("mr_accepts", "rumor_sends", "rumor_deliveries",
                                                      "gossip_msgs", "fd_new_suspects")}


@pytest.mark.parametrize("kind", ["fused", "adaptive", "traced"])
def test_sharded_delay_pull_window_w2_equals_port_and_jax(lane2, kind):
    busy = _check(lane2, kind)
    assert all(v > 0 for v in busy.values()), busy


def test_sharded_delay_pull_fused_window_w4_equals_port_and_jax(lane4):
    busy = _check(lane4, "fused")
    assert all(v > 0 for v in busy.values()), busy


def test_starved_budget_under_delay_and_pull_equals_jax_sharded_run(lane2):
    """Budget 12 of a lossless 256 per (src, dst) with the rings and the
    pull leg: JAX's sharded fused window on two virtual devices (whose late
    and pull paths are global gathers) and the gloo lane (exact exchanges)
    drop the same on-time records, end in the same state, rings included,
    and count the same overflow."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    params, budget = _params(), 12
    mesh = JSH.make_mesh(jax.devices()[:2])
    run = JSH.make_sharded_pview_fused_run(mesh, params, 2 * T, a2a_budget=budget)
    snap0 = {k: np.asarray(v) for k, v in JPV.snapshot(_scenario(JPV, params)).items()}
    key = jax.random.PRNGKey(3)
    jst, _key, jms, _ = run(JSH.shard_pview_state(_scenario(JPV, params), mesh), key)
    _, draws = _jax_draws(key, 2 * T, params)
    res = lane2.run(RK.window, "fused", _tparams(params), snap0, [draws], 2 * T, budget)
    jref = {k: np.asarray(v) for k, v in JPV.snapshot(jst).items()}
    overflow = np.asarray(jms["delivery_overflow"])
    assert overflow.sum() > 0, "the starved budget dropped nothing"
    assert jref["pending_inf"].any() and jref["pending_minf"].any(), "nothing in flight"
    for rank in res:
        got = rank["windows"][0]
        for name, v in jref.items():
            v = v.view(np.int32) if v.dtype == np.uint32 else v
            assert np.array_equal(got["state"][name], v), f"starved budget: state leaf {name} diverged"
        assert np.array_equal(got["metrics"]["delivery_overflow"], overflow)
        for name in ("rumor_sends", "rumor_deliveries", "mr_deliveries", "gossip_msgs"):
            assert np.array_equal(got["metrics"][name], np.asarray(jms[name])), name


# -- the 2-D scenarios x members mesh -----------------------------------------------


def _fleet_params(**over):
    """JAX tests/test_sharding.py's pview knobs (its 2-D fleet case)."""
    kw = dict(capacity=256, view_slots=8, active_slots=4, fanout=2, ping_req_k=2, fd_every=3, sync_every=16,
              rumor_slots=4, seed_rows=(0, 1))
    kw.update(over)
    return JPV.PviewParams(**kw)


def _fleet_state(mod, params, **kw):
    st = mod.init_pview_state(params, 200, uniform_loss=0.05, **kw)
    st = mod.spread_rumor(st, 0, 5)
    return mod.crash_rows(st, [6, 17])


FLEET_T = 5
FLEET_SEEDS = (7, 9, 11, 13)
FLEET_ORIGINS = (44, 130, 200, 3)  # a second rumor per scenario, on both member halves


def _fleet_case():
    """The fleet start (S = 4: scenario s adds a rumor at FLEET_ORIGINS[s])
    and the JAX key chains of FLEET_SEEDS as per-tick [S, ...] draws."""
    params = _fleet_params()
    tparams = _tparams(params)
    base = _fleet_state(TPV, tparams, device="cpu")
    fs = TFL.fleet_inject_rumor(TPV, TFL.fleet_broadcast(base, len(FLEET_SEEDS)), 1, FLEET_ORIGINS)
    per = [_jax_draws(jax.random.PRNGKey(s), FLEET_T, params)[1] for s in FLEET_SEEDS]
    draws = [tuple(_stack([per[s][t][i] for s in range(len(per))]) for i in range(2)) for t in range(FLEET_T)]
    return params, tparams, convert.fleet_to_numpy(fs), draws, per


def _stack(blocks):
    """Per-scenario draw blocks stacked to one with [S, ...] leaves."""
    if blocks[0] is None:
        return None
    cls = type(blocks[0])
    return cls(*(torch.stack([getattr(b, f.name) for b in blocks]) for f in dataclasses.fields(cls)))


def test_fleet_on_2d_mesh_equals_one_process_fleet_serial_and_jax(lane4):
    """A 2 x 2 scenarios x members mesh: each rank holds 2 scenarios' 128
    member rows. The gathered fleet and its metrics equal the one-process
    fleet's; each scenario equals its serial window and JAX's single
    window on its key chain, and JAX's own 2 x 4 sharded fleet run of the
    first two scenarios (tests/test_sharding.py's 2-D case)."""
    params, tparams, fnp, draws, per = _fleet_case()
    res = lane4.run(RK.fleet2d, tparams, fnp, draws, 2, FLEET_T)
    ref, ms, _ = TFL.make_fleet_run(tparams, FLEET_T)(convert.fleet_from_numpy(fnp, device="cpu"), draws)
    rn = convert.fleet_to_numpy(ref)
    assert [r["rows"] for r in res] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    assert all(r["block"] == (2, N // 2, 8) for r in res)
    for r, rank in enumerate(res):
        assert rank["launches"] == 0, "the delivery kernel ran on a mesh"
        for k, v in rn.items():
            assert np.array_equal(rank["fleet"][k], v), f"rank {r}: fleet leaf {k} diverged"
        assert set(rank["metrics"]) == set(ms) | {"delivery_overflow"}
        assert not rank["metrics"]["delivery_overflow"].any()
        for k, v in ms.items():
            assert np.array_equal(rank["metrics"][k], v.numpy()), f"rank {r}: fleet metric {k} diverged"
    # each scenario: its serial port window and JAX's single window
    single = JPV.make_pview_run(params, FLEET_T, donate=False)
    jst0 = _fleet_state(JPV, params)
    for s, seed in enumerate(FLEET_SEEDS):
        row = TFL.fleet_row(ref, s)
        st, sms, _ = TPV.run_pview_ticks_fused(TFL.fleet_row(convert.fleet_from_numpy(fnp, device="cpu"), s),
                                               per[s], FLEET_T, tparams)
        assert all(np.array_equal(a, b) for a, b in zip(convert.state_to_numpy(st).values(),
                                                        convert.state_to_numpy(row).values())), s
        jref, _, jms, _ = single(JPV.spread_rumor(jst0, 1, FLEET_ORIGINS[s]), jax.random.PRNGKey(seed))
        for k, v in JPV.snapshot(jref).items():
            v = np.asarray(v)
            v = v.view(np.int32) if v.dtype == np.uint32 else v
            assert np.array_equal(res[0]["fleet"][k][s], v), (s, k)
        for k, v in jms.items():
            v = np.asarray(v)
            if k in FLOAT_METRICS:
                ulp = np.abs(res[0]["metrics"][k][s].view(np.int32).astype(np.int64) - v.view(np.int32))
                assert ulp.max(initial=0) <= 2, (s, k)
            else:
                assert np.array_equal(res[0]["metrics"][k][s], v), (s, k)
    if len(jax.devices()) >= 8:
        mesh2d = JSH.make_pview_mesh2d(2, jax.devices()[:8])
        fleet0 = JFL.fleet_stack([JPV.spread_rumor(jst0, 1, o) for o in FLEET_ORIGINS[:2]])
        run = JSH.make_sharded_pview_fleet_run(mesh2d, params, FLEET_T)
        out, _, ms_f, _ = run(JSH.shard_pview_fleet(fleet0, mesh2d), JFL.fleet_keys(list(FLEET_SEEDS[:2])))
        for k, v in JPV.snapshot(out).items():
            v = np.asarray(v)
            v = v.view(np.int32) if v.dtype == np.uint32 else v
            assert np.array_equal(res[0]["fleet"][k][:2], v), f"JAX 2 x 4 fleet: leaf {k}"
        assert np.array_equal(res[0]["metrics"]["delivery_overflow"][:2], np.asarray(ms_f["delivery_overflow"]))


def test_fleet_tick_makes_as_many_collectives_as_a_serial_tick(lane4):
    """The collectives' vmap rules carry a rank's whole scenario block at
    once: a fleet window of 2 scenarios per rank on the 2 x 2 mesh, with
    the rings and the pull leg, calls each collective as often as the
    serial sharded window of one of them on the 1-D mesh."""
    params = _tparams(_params())
    st = _scenario(TPV, params, device="cpu")
    gen = torch.Generator().manual_seed(4)
    from scalecube_cluster_tpu_torch.ops import rand as TR

    draws = [TR.draw_sparse_tick(gen, params, (t + 1) % params.fd_every == 0) for t in range(T)]
    fs = TFL.fleet_broadcast(st, 4)
    fdraws = [tuple(_stack([b] * 4) for b in d) for d in draws]
    res = lane4.run(RK.collectives, params, convert.state_to_numpy(st), draws, convert.fleet_to_numpy(fs),
                    fdraws, 2, T)
    for rank in res:
        assert rank["scenarios"] == 2
        assert rank["fleet"] == rank["serial"], rank
        assert rank["serial"]["all_to_all_single"] > 0 and rank["serial"]["all_gather"] > 0, rank


def test_profile_fleet_ticks_on_2d_mesh_equals_the_sharded_fleet_window(lane4):
    """``profile_fleet_ticks(mesh=)``: the phase-split fleet ticks on the 2 x 2
    mesh end where the sharded fleet window and the one-process fleet end,
    with rank 0's times and the maxima over the four ranks."""
    params, tparams, fnp, _draws, _per = _fleet_case()
    res = lane4.run(RK.profile_fleet2d, tparams, fnp, 5, 2, 2, 1)
    one, _, _ = TFL.make_fleet_run(tparams, 3)(convert.fleet_from_numpy(fnp, device="cpu"),
                                              TFL.fleet_generator(5, device="cpu"))
    want = convert.fleet_to_numpy(one)
    for rank in res:
        for k, v in want.items():
            assert np.array_equal(rank["profiled"][k], v), k
            assert np.array_equal(rank["window"][k], v), k
        r = rank["result"]
        assert r["engine"] == "pview-fleet" and r["s"] == 2 and r["mesh"] == {"scenarios": 2, "members": 2}
        assert set(r["phases_s"]) == {"rand", "fd", "suspicion", "gossip", "sync", "refute", "sweep", "alloc",
                                      "telemetry"}
        assert all(r["phases_s_max_over_ranks"][k] >= v for k, v in r["phases_s"].items())
    assert all(rank["result"]["phases_s"] == res[0]["result"]["phases_s"] for rank in res)


def test_2d_mesh_refusals(lane4):
    """JAX's two refusals: 4 ranks do not factor into 3 scenario rows, and a
    fleet window needs the 2-D mesh; JAX raises the same on 8 devices."""
    for rank in lane4.run(RK.mesh2d_refusals):
        assert rank["factor"][0] == "ValueError" and "factor" in rank["factor"][1], rank
        assert rank["2-D"][0] == "ValueError" and "2-D" in rank["2-D"][1], rank
    if len(jax.devices()) >= 8:
        with pytest.raises(ValueError, match="factor"):
            JSH.make_pview_mesh2d(3, jax.devices()[:8])
        with pytest.raises(ValueError, match="2-D"):
            JSH.make_sharded_pview_fleet_run(JSH.make_mesh(jax.devices()[:8]), _fleet_params(), 2)
