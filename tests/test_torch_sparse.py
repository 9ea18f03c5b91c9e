"""The PyTorch port's sparse (record-queue) engine against the JAX package's.

Same params, same host mutations and the SAME uniform draws (the JAX
window's own per-tick key chain, handed to the port as numpy) must give the
same value in every state leaf after every tick and in every integer
metric, against both JAX windows (``make_sparse_run`` and its fused twin
``make_sparse_fused_run``); the two f32 metrics may differ by at most 2 ulp
(XLA may lower an f32 division as a reciprocal-multiply, PyTorch divides).
Each scenario runs 64 one-tick windows: a crash wave, user rumors, a
``join_rows`` churn batch with a rejoin that bumps an epoch, a graceful
leave, metadata bumps, a partition of the dense link plane and its heal,
and a uniform-loss storm; then tight pool caps (priority eviction, drops,
throttled verdicts and refutations) over several row chunks, and the
namespace gate with ``apply_block``. The host mutators, the pool
allocation, the driver's seams and the refusals are held on their own.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu.ops import engine_api as jengine_api
from scalecube_cluster_tpu.ops.kernel import ceil_log2 as jceil_log2
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import _tensor, engine_api, pool
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from test_torch_pview_fused import FLOAT_METRICS, _jax_draws

torch.set_num_threads(1)

TICKS = 64
PARTITION_AT, MUTATE_AT, HEAL_AT, STORM_AT = 8, 20, 40, 48

# the JAX package's sparse-test knobs, with a short suspicion timeout and a
# 4-tick sweep so that expiry happens inside the window
_KNOBS = dict(fanout=2, ping_req_k=1, fd_every=3, sync_every=8, suspicion_mult=1,
              sweep_every=4, rumor_slots=4, seed_rows=(0, 1))


def _params(n: int, **over):
    knobs = dict(mr_slots=32, announce_slots=16, full_metrics=True, **_KNOBS)
    return JSP.SparseParams(capacity=n, **{**knobs, **over})


@functools.lru_cache(maxsize=None)
def _jax_window(params, fused: bool):
    make = JSP.make_sparse_fused_run if fused else JSP.make_sparse_run
    return make(params, 1, donate=False)


def _halves(n: int):
    return list(range(0, n // 2)), list(range(n // 2, n))


def _scenario(mod, params, n: int, dense_links=True, namespaces=None, **kw):
    st = mod.init_sparse_state(params, n - 4, dense_links=dense_links, uniform_loss=0.05,
                               namespaces=namespaces, **kw)
    st = mod.spread_rumor(st, 0, 3)
    st = mod.spread_rumor(st, 1, 7)
    st = mod.crash_rows(st, [6, 17, n // 2 + 1])  # the crash wave
    return mod.begin_leave(st, 9)


def _mutate(mod, st, params, n: int):
    """The churn batch: a crashed row rejoins (a new identity: its epoch
    bumps) with two never-used rows, a leave, metadata bumps, a spread."""
    st = mod.crash_rows(st, [3])
    st = mod.join_rows(st, [6, n - 3, n - 2], params.seed_rows)
    st = mod.update_metadata(mod.update_metadata(st, 4), 4)
    st = mod.spread_rumor(st, 2, 12)
    return mod.begin_leave(st, 11)


def _assert_state_equal(jst, tst, label):
    ref = JSP.snapshot(jst)
    got = convert.state_to_numpy(tst)
    assert set(ref) == set(got), f"{label}: leaves differ: {set(ref) ^ set(got)}"
    for name, v in ref.items():
        g = got[name]
        assert g.shape == v.shape, f"{label}: leaf {name} shape {g.shape} != {v.shape}"
        assert np.array_equal(g, v), f"{label}: state leaf {name} diverged"


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
            assert np.array_equal(g, v), f"{label}: metric {name} diverged"


def _run_both(n: int, dense_links=True, namespaces=None, storm=True, **over):
    """64 one-tick windows of the port and of both JAX windows, from one
    scenario; the states are compared after every tick and every host
    mutation. Returns per-metric totals (the scenario must be busy)."""
    params = _params(n, **over)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = _scenario(JSP, params, n, dense_links, namespaces)
    jfst = jst
    tst = convert.state_from_numpy(JSP.snapshot(jst), device="cpu")
    _assert_state_equal(jst, _scenario(TSP, tparams, n, dense_links, namespaces, device="cpu"),
                        f"scenario start (n={n})")
    key = jax.random.PRNGKey(5)
    busy: dict = {}
    a, b = _halves(n)
    for t in range(TICKS):
        steps = []
        if dense_links and t == PARTITION_AT:
            steps.append(lambda mod, st: mod.block_partition(st, a, b))
        if t == MUTATE_AT:
            steps.append(lambda mod, st: _mutate(mod, st, params, n))
        if dense_links and t == HEAL_AT:
            steps.append(lambda mod, st: mod.heal_partition(st, a, b))
        if storm and t == STORM_AT:
            steps.append(lambda mod, st: mod.set_uniform_loss(mod.set_uniform_loss(st, 0.3), 0.1, floor=True))
        for step in steps:
            jst, jfst, tst = step(JSP, jst), step(JSP, jfst), step(TSP, tst)
        if steps:
            _assert_state_equal(jst, tst, f"after the host mutation at tick {t} (n={n})")
        jst, key_after, jms, _ = _jax_window(params, False)(jst, key)
        jfst, _, jfms, _ = _jax_window(params, True)(jfst, key)
        key, draws = _jax_draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _ = TSP.run_sparse_ticks(tst, draws, 1, tparams)
        for kind, js, jm in (("make_sparse_run", jst, jms), ("make_sparse_fused_run", jfst, jfms)):
            label = f"tick {t + 1} (n={n}) against {kind}"
            _assert_state_equal(js, tst, label)
            _assert_metrics_equal(jm, tms, label)
        for k, v in jms.items():
            busy[k] = busy.get(k, 0) + float(np.asarray(v).sum())
    return busy


_MUST_RUN = ("mr_accepts", "sync_roundtrips", "fd_new_suspects", "rumor_deliveries",
             "announced", "false_suspect_pairs")


@pytest.mark.parametrize("n", [33, 256])
def test_window_matches_jax(n):
    busy = _run_both(n)
    # the scenario must exercise every phase, or equality proves little
    assert all(busy[k] > 0 for k in _MUST_RUN), busy


def test_window_matches_jax_at_tight_caps(monkeypatch):
    """Caps that bind: a 16-slot pool that evicts and drops, 8 announcements
    a tick, 4 FD verdicts and 4 refutations a round; scalar links; the
    [N, M] reductions over several row chunks and the [N, N] and [N, M]
    per-cell passes over chunks of a few rows, the last one short."""
    monkeypatch.setattr(_tensor, "ROW_CHUNK", 48)
    monkeypatch.setattr(_tensor, "PLANE_CHUNK_CELLS", 1000)
    busy = _run_both(256, dense_links=False, mr_slots=16, announce_slots=8,
                     fd_accept_slots=4, refute_slots=4)
    assert all(busy[k] > 0 for k in _MUST_RUN + ("pool_evicted", "announce_dropped")), busy


_NAMESPACES = ("a", "a/b", "a/c", "d", "a/b/e")


def test_window_matches_jax_with_namespaces_and_apply_block():
    """The namespace gate on every merge, with a namespace per row, and an
    explicit ``apply_block`` (JAX walks the apply in four column blocks)."""
    n = 256
    namespaces = [_NAMESPACES[i % len(_NAMESPACES)] for i in range(n)]
    busy = _run_both(n, namespaces=namespaces, namespace_gate=True, apply_block=64)
    assert all(busy[k] > 0 for k in _MUST_RUN), busy


def _busy_pair(ticks: int = 12, dense_links=True):
    """A JAX state after some ticks of the first scenario, and its port."""
    n = 33
    params = _params(n)
    jst = _scenario(JSP, params, n, dense_links)
    key = jax.random.PRNGKey(2)
    if dense_links:
        for _ in range(ticks):
            jst, key, _, _ = _jax_window(params, False)(jst, key)
    return params, jst, convert.state_from_numpy(JSP.snapshot(jst), device="cpu")


_MUTATIONS = {
    "join_row": lambda mod, st, p: mod.join_row(st, 31, p.seed_rows),
    # a restart on a used row: a new identity through the epoch bits
    "join_row_restart": lambda mod, st, p: mod.join_row(mod.crash_row(st, 5), 5, p.seed_rows),
    "join_rows": lambda mod, st, p: mod.join_rows(mod.crash_rows(st, [2, 8]), [2, 8, 30, 31], p.seed_rows),
    "crash_row": lambda mod, st, p: mod.crash_row(st, 4),
    "crash_rows": lambda mod, st, p: mod.crash_rows(st, [1, 4, 5]),
    "begin_leave": lambda mod, st, p: mod.begin_leave(st, 12),
    "update_metadata": lambda mod, st, p: mod.update_metadata(mod.update_metadata(st, 4), 4),
    "spread_rumor": lambda mod, st, p: mod.spread_rumor(st, 3, 14),
    "announce": lambda mod, st, p: mod.announce(st, 10, 8, 10),
    "set_link_loss": lambda mod, st, p: mod.set_link_loss(st, [0, 3], [1, 2, 3], 0.25),
    "block_partition": lambda mod, st, p: mod.block_partition(st, [0, 1, 2], [5, 6]),
    "heal_partition": lambda mod, st, p: mod.heal_partition(mod.block_partition(st, [0, 1], [4]), [0, 1], [4]),
    "set_link_delay_zero": lambda mod, st, p: mod.set_link_delay(st, [0, 1], [2], 0.0),
    "set_uniform_loss": lambda mod, st, p: mod.set_uniform_loss(st, 0.2),
    "set_uniform_loss_floor": lambda mod, st, p: mod.set_uniform_loss(
        mod.block_partition(st, [0], [1]), 0.1, floor=True),
}


# per-link mutators need dense links (their refusal on scalar links is
# tested below)
_PER_LINK = ("set_link_loss", "block_partition", "heal_partition", "set_link_delay_zero",
             "set_uniform_loss_floor")


@pytest.mark.parametrize("name,dense_links", [(m, True) for m in sorted(_MUTATIONS)] + [
    (m, False) for m in sorted(_MUTATIONS) if m not in _PER_LINK])
def test_host_mutators_match_jax(name, dense_links):
    """Each host mutator against JAX on its own, on a busy state (dense
    links) or a fresh one (scalar links)."""
    params, jst, tst = _busy_pair(dense_links=dense_links)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    mutate = _MUTATIONS[name]
    _assert_state_equal(mutate(JSP, jst, params), mutate(TSP, tst, tparams), f"{name}")


def test_init_matches_jax():
    """Warm, cold, namespaced and dense-link starts."""
    n = 40
    params = _params(n)
    for kw in (dict(), dict(warm=False), dict(dense_links=True, uniform_loss=0.125),
               dict(namespaces=[_NAMESPACES[i % 5] for i in range(n)]),
               dict(warm=False, namespaces=[_NAMESPACES[i % 5] for i in range(n)])):
        _assert_state_equal(JSP.init_sparse_state(params, n - 3, **kw),
                            TSP.init_sparse_state(params, n - 3, device="cpu", **kw), str(kw))


def test_pool_allocate_matches_the_sparse_allocate():
    """The port's shared pool allocation (``ops/pool.py``) against the JAX
    sparse engine's own ``_allocate``, with no delay rings: supersedes,
    fresh slots, batch duplicates, the 7/8 backpressure on non-priority
    entries, and priority eviction from a full pool whose older rumors
    most members hold."""
    n = 33
    params = _params(n, mr_slots=8)
    jst = _scenario(JSP, params, n)
    rng = np.random.default_rng(0)
    evicted = 0
    for trial in range(8):
        if trial == 3:
            # most members hold the first four rumors: they are evictable
            jst = jst.replace(minf_age=jst.minf_age.at[: n - 6, :4].set(3))
        e = 12
        subj = rng.integers(0, n, e).astype(np.int32)
        keyv = (rng.integers(0, 4, e) * 4 + rng.integers(0, 4, e)).astype(np.int32)
        orig = rng.integers(0, n, e).astype(np.int32)
        got = rng.random(e) < 0.8
        prio = got & (rng.random(e) < 0.6)
        jout = JSP._allocate(jst, jnp.asarray(subj), jnp.asarray(keyv), jnp.asarray(orig),
                             jnp.asarray(got), prio=jnp.asarray(prio))
        tst = convert.state_from_numpy(JSP.snapshot(jst), device="cpu")
        tout = pool.allocate(tst, torch.from_numpy(subj), torch.from_numpy(keyv),
                             torch.from_numpy(orig), torch.from_numpy(got), prio=torch.from_numpy(prio))
        _assert_state_equal(jout[0], tout[0], f"allocate trial {trial}")
        for a, b, what in zip(jout[1:], tout[1:], ("allocated", "no-slot mask", "evicted")):
            assert np.array_equal(np.asarray(a), b.numpy()), f"trial {trial}: {what}"
        evicted += int(jout[3])
        jst = jout[0]
    assert evicted > 0


def test_driver_seams_match_jax():
    params, jst, tst = _busy_pair(ticks=20)
    eng = engine_api.engine("sparse")
    assert np.array_equal(np.asarray(jengine_api._plane_remembered_rows(jst)),
                          eng.remembered_rows(tst).numpy())
    jstale, jup = jengine_api._plane_staleness(jst)
    tstale, tup = eng.staleness(tst)
    assert np.array_equal(np.asarray(jstale), tstale.numpy()) and int(jup) == int(tup)
    for row in (0, 9, 32):
        assert np.array_equal(np.asarray(jengine_api._plane_view_row(jst, row)),
                              engine_api.engine("sparse").view_row(tst, row).numpy())


def test_snapshot_restore_round_trip():
    params, jst, tst = _busy_pair()
    snap = TSP.snapshot(tst)
    back = TSP.restore(snap, device="cpu")
    _assert_state_equal(jst, back, "restored")
    back.view_key[0, 0] = 99  # the restored leaves own their buffers
    assert snap["view_key"][0, 0] != 99
    with pytest.raises(TypeError, match="do not match SparseState"):
        TSP.restore({k: v for k, v in snap.items() if k != "minf_age"}, device="cpu")


def test_ceil_log2_matches_jax():
    x = np.concatenate([np.arange(0, 300), [1023, 1024, 1025, 49_151, 49_152, (1 << 30) + 7]]).astype(np.int32)
    assert np.array_equal(np.asarray(jceil_log2(jnp.asarray(x))), TSP.ceil_log2(torch.from_numpy(x)).numpy())


def test_window_split_does_not_change_the_trajectory():
    """The driver cuts its ticks into windows of any length: 12 + 20 ticks
    from one generator give the state, metrics and watched rows of one
    32-tick window."""
    n = 64
    params = convert.params_from_dict(dataclasses.asdict(_params(n)))
    runs = []
    for lengths in ((12, 20), (32,)):
        st = TSP.block_partition(_scenario(TSP, params, n, device="cpu"), *_halves(n))
        gen = torch.Generator(device="cpu").manual_seed(9)
        parts = []
        for length in lengths:
            st, ms, watched = TSP.make_sparse_run(params, length)(st, gen, watch_rows=[0, 40])
            parts.append((ms, watched))
        ms = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
        runs.append((convert.state_to_numpy(st), ms, torch.cat([p[1] for p in parts])))
    (s_a, ms_a, w_a), (s_b, ms_b, w_b) = runs
    for name in s_a:
        assert np.array_equal(s_a[name], s_b[name]), f"state leaf {name} differs"
    for k in ms_a:
        assert torch.equal(ms_a[k], ms_b[k]), f"metric {k} differs"
    assert torch.equal(w_a, w_b)
    assert w_a.shape == (32, 2, n)
    assert int(ms_a["mr_accepts"].sum()) > 0 and int(ms_a["sync_roundtrips"].sum()) > 0
    # n_live is the incrementally kept count of each row's non-DEAD columns
    st = TSP.restore(s_a, device="cpu")
    recount = ((st.view_key & 3) != 3).sum(dim=1).to(torch.int32)
    assert torch.equal(torch.where(st.up, recount, 0), torch.where(st.up, st.n_live, 0))


def test_port_refuses_what_it_does_not_run():
    base = dataclasses.asdict(_params(33))
    # the dissemination and adaptive specs are carried across (ported)
    armed = convert.params_from_dict({**base, "dissem": {**base["dissem"], "strategy": "push_pull"}})
    assert armed.dissem.strategy == "push_pull" and isinstance(armed, TSP.SparseParams)
    adaptive = convert.params_from_dict({**base, "adaptive": {**base["adaptive"], "enabled": True}})
    assert adaptive.adaptive.enabled and isinstance(adaptive, TSP.SparseParams)
    # the delay rings are ported: delay_slots is carried across, and a
    # delay without rings is refused as JAX refuses it
    assert convert.params_from_dict({**base, "delay_slots": 2}).delay_slots == 2
    assert TSP.SparseParams(capacity=33, delay_slots=2).delay_slots == 2
    params = TSP.SparseParams(capacity=33)
    with pytest.raises(ValueError, match="delay_slots > 0"):
        TSP.init_sparse_state(params, 33, uniform_delay=1.0, device="cpu")
    st = TSP.init_sparse_state(params, 33, device="cpu")
    rd = None
    # the trace capture is ported (tests/test_torch_trace.py); armed with
    # the adaptive plane it is refused, as in JAX
    with pytest.raises(ValueError, match="trace-armed adaptive windows are not supported"):
        TSP.sparse_tick(st, None, rd, params, trace=object(), ad=object())
    # the adaptive plane is ported: it needs an enabled spec on the params
    with pytest.raises(ValueError, match="enabled AdaptiveSpec"):
        TSP.sparse_tick(st, None, rd, params, ad=object())
    with pytest.raises(ValueError, match="dense links"):
        TSP.set_link_loss(st, [0], [1], 0.5)
    with pytest.raises(ValueError, match="dense links"):
        TSP.set_link_delay(st, [0], [1], 0.0)
    dense = TSP.init_sparse_state(params, 33, dense_links=True, device="cpu")
    with pytest.raises(ValueError, match="delay_slots"):
        TSP.set_link_delay(dense, [0], [1], 2.0)
    with pytest.raises(ValueError, match="must be positive and divide 33"):
        TSP.SparseParams(capacity=33, apply_block=5)
    with pytest.raises(ValueError, match="must be positive and divide 256"):
        convert.params_from_dict({**dataclasses.asdict(_params(256)), "apply_block": 48})
    assert engine_api.engine("dense").name == "dense"
    assert engine_api.resolve(params).name == "sparse"
