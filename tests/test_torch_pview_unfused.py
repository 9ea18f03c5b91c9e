"""The PyTorch port's pview window (the driver's window, ``run_pview_ticks``)
against the JAX package's unfused ``make_pview_run``.

Same params, same host mutations and the SAME uniform draws (the JAX
window's own per-tick key chain, handed to the port as numpy) must give the
same value in every state leaf after every tick and in every integer
metric; the two f32 metrics may differ by at most 2 ulp (XLA may lower an
f32 division as a reciprocal-multiply, PyTorch divides). The scenario runs
64 ticks with uniform loss, a group partition and its heal, and a batch of
crashes, joins, leaves and rumor spreads partway through. The host seams the
driver calls (partition cells, snapshot/restore, remembered rows,
staleness) are held against JAX on their own.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import _tensor
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import rand as TR
from test_torch_pview_fused import (
    _assert_metrics_equal,
    _assert_state_equal,
    _dead_entries,
    _jax_draws,
    _mutate,
    _params,
    _scenario,
)

torch.set_num_threads(1)

TICKS = 64
PARTITION_AT, MUTATE_AT, HEAL_AT = 8, 24, 40


def _halves(n: int):
    return list(range(0, n // 2)), list(range(n // 2, n))


@functools.lru_cache(maxsize=None)
def _jax_window(params, n_ticks: int):
    return JPV.make_pview_run(params, n_ticks, donate=False)


def _run_both(n: int, kd: str, **over):
    """64 one-tick windows of both engines; the state is compared after
    every tick, the stacked metrics of each."""
    params = _params(n, kd, **over)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = _scenario(JPV, params, n)
    tst = convert.state_from_numpy(JPV.snapshot(jst), device="cpu")
    key = jax.random.PRNGKey(5)
    busy = {"mr": 0, "sync": 0, "fd": 0, "delivered": 0, "dead": 0, "purged": 0,
            "partitioned_drops": 0}
    dead_before = 0
    a, b = _halves(n)
    for t in range(TICKS):
        if t == PARTITION_AT:
            jst, tst = JPV.block_partition(jst, a, b), TPV.block_partition(tst, a, b)
        if t == MUTATE_AT:
            jst, tst = _mutate(JPV, jst, params, n), _mutate(TPV, tst, tparams, n)
        if t == HEAL_AT:
            jst, tst = JPV.heal_partition(jst, a, b), TPV.heal_partition(tst, a, b)
        if t in (PARTITION_AT, MUTATE_AT, HEAL_AT):
            _assert_state_equal(jst, tst, f"after the host mutation at tick {t} (n={n}, {kd})")
        jst, key_after, jms, _ = _jax_window(params, 1)(jst, key)
        key, draws = _jax_draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _ = TPV.run_pview_ticks(tst, draws, 1, tparams)
        label = f"tick {t + 1} (n={n}, {kd})"
        _assert_state_equal(jst, tst, label)
        _assert_metrics_equal(jms, tms, label)
        for k, metric in (("mr", "mr_accepts"), ("sync", "sync_roundtrips"),
                          ("fd", "fd_new_suspects"), ("delivered", "rumor_deliveries")):
            busy[k] += int(np.asarray(jms[metric]).sum())
        if PARTITION_AT <= t < HEAL_AT:
            busy["partitioned_drops"] += int(np.asarray(jms["fd_failed_probes"]).sum())
        dead = _dead_entries(jst)
        busy["dead"] = max(busy["dead"], dead)
        busy["purged"] += int(dead < dead_before)
        dead_before = dead
    return busy


@pytest.mark.parametrize("n,kd", [(33, "i32"), (33, "i16"), (256, "i32"), (256, "i16")])
def test_unfused_window_matches_jax(n, kd):
    busy = _run_both(n, kd)
    # the scenario must exercise every phase, or equality proves little
    assert all(v > 0 for v in busy.values()), busy


def test_unfused_window_matches_jax_at_tight_caps(monkeypatch):
    """Caps that bind (FD accepts, refutations, SYNC callers), and the
    [N, M] reductions over several row chunks, the last one short."""
    monkeypatch.setattr(_tensor, "ROW_CHUNK", 48)
    busy = _run_both(256, "i16", fd_accept_slots=3, refute_slots=2, sync_slots=6)
    assert all(v > 0 for v in busy.values()), busy


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_window_split_does_not_change_the_trajectory(kd):
    """The driver cuts its ticks into windows of any length: 12 + 20 ticks
    from one generator give the state, metrics and watched rows of one
    32-tick window."""
    n = 128
    params = convert.params_from_dict(dataclasses.asdict(_params(n, kd)))
    runs = []
    for lengths in ((12, 20), (32,)):
        st = TPV.block_partition(_scenario(TPV, params, n, device="cpu"), *_halves(n))
        gen = torch.Generator(device="cpu").manual_seed(9)
        parts = []
        for length in lengths:
            st, ms, watched = TPV.run_pview_ticks(st, gen, length, params, watch_rows=[0, 40])
            parts.append((ms, watched))
        ms = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
        runs.append((convert.state_to_numpy(st), ms, torch.cat([p[1] for p in parts])))
    (s_a, ms_a, w_a), (s_b, ms_b, w_b) = runs
    for name in s_a:
        assert np.array_equal(s_a[name], s_b[name]), f"state leaf {name} differs ({kd})"
    assert set(ms_a) == set(ms_b)
    for k in ms_a:
        assert torch.equal(ms_a[k], ms_b[k]), f"metric {k} differs ({kd})"
    assert torch.equal(w_a, w_b), f"watched rows differ ({kd})"
    assert int(ms_a["mr_accepts"].sum()) > 0 and int(ms_a["sync_roundtrips"].sum()) > 0


def _busy_pair(kd: str = "i32", ticks: int = 12):
    """A JAX state after some ticks with crashes and a partition, and its
    port (the one-tick windows above, compiled once per layout)."""
    n = 33
    params = _params(n, kd)
    jst = JPV.block_partition(_scenario(JPV, params, n), *_halves(n))
    key = jax.random.PRNGKey(2)
    for _ in range(ticks):
        jst, key, _, _ = _jax_window(params, 1)(jst, key)
    return params, jst, convert.state_from_numpy(JPV.snapshot(jst), device="cpu")


@pytest.mark.parametrize("groups", [
    ([0, 1, 2], [5, 6]),      # distinct cells
    ([0, 1], [3, 4]),         # min rows 0 and 3 share a cell at G = 4
    ([3, 4], [0, 1]),         # the same collision, the other order
    ([7, 8, 9], [1, 13]),     # 7 % 3 == 13 % 3 == 1 % 3: collision, min row 1
])
def test_partition_cells_match_jax(groups):
    params, jst, tst = _busy_pair()
    a, b = groups
    assert TPV._cells_for(tst, a, b) == JPV._cells_for(jst, a, b)
    assert TPV._cells_for(tst, b, a) == tuple(reversed(TPV._cells_for(tst, a, b)))
    for fn in ("block_partition", "heal_partition"):
        _assert_state_equal(getattr(JPV, fn)(jst, a, b), getattr(TPV, fn)(tst, a, b), fn)
    j = JPV.set_link_loss(jst, b, a, 0.375)
    t = TPV.set_link_loss(tst, b, a, 0.375)
    _assert_state_equal(j, t, "set_link_loss")
    with pytest.raises(ValueError, match="per-link delay"):
        TPV.set_link_delay(tst, a, b, 2.0)


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_remembered_rows_and_staleness_match_jax(kd):
    params, jst, tst = _busy_pair(kd=kd)
    # make some records stale: bumps and a restart the others have not seen
    jst = JPV.join_row(JPV.crash_row(JPV.update_metadata(jst, 4), 9), 9, params.seed_rows)
    tst = TPV.join_row(TPV.crash_row(TPV.update_metadata(tst, 4), 9), 9, params.seed_rows)
    rem = TPV.remembered_rows(tst)
    assert rem.dtype == torch.bool
    assert np.array_equal(rem.numpy(), np.asarray(JPV.remembered_rows(jst)))
    stale, n_up = TPV.staleness(tst)
    j_stale, j_up = JPV.staleness(jst)
    assert stale.dtype == torch.int32
    assert np.array_equal(stale.numpy(), np.asarray(j_stale))
    assert int(n_up) == int(j_up)
    assert int(stale.sum()) > 0


def test_snapshot_restore_round_trip():
    params, jst, tst = _busy_pair(kd="i16")
    snap = TPV.snapshot(tst)
    ref = JPV.snapshot(jst)
    assert set(snap) == set(ref)
    for name, v in ref.items():
        got = snap[name]
        assert got.dtype == (np.dtype(np.int32) if v.dtype == np.uint32 else v.dtype), name
        assert np.array_equal(got, v.view(np.int32) if v.dtype == np.uint32 else v), name
    back = TPV.restore(snap, device="cpu")
    snap["up"][:] = False  # the restored state owns its buffers
    assert bool(back.up.any())
    _assert_state_equal(jst, back, "restore(snapshot(state))")
    with pytest.raises(TypeError, match="missing"):
        TPV.restore({k: v for k, v in snap.items() if k != "minf_age"}, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        TPV.restore({**snap, "view_key": snap["nbr_key"]}, device="cpu")


def test_unfused_tick_refuses_what_it_does_not_run():
    params = TPV.PviewParams(capacity=33)
    st = TPV.init_pview_state(params, 33, device="cpu")
    # the trace capture is ported (tests/test_torch_trace.py); armed with
    # the adaptive plane it is refused, as in JAX
    with pytest.raises(ValueError, match="trace-armed adaptive windows are not supported"):
        TPV.pview_tick(st, None, None, params, trace=object(), ad=object())
    # the adaptive plane is ported: it needs an enabled spec on the params
    with pytest.raises(ValueError, match="enabled AdaptiveSpec"):
        TPV.pview_tick(st, None, None, params, ad=object())
    # the delay rings are ported: a D = 2 tick runs and keeps its rings
    # (tests/test_torch_delay_rings.py holds them against JAX)
    dparams = TPV.PviewParams(capacity=33, delay_slots=2)
    dst = TPV.init_pview_state(dparams, 33, uniform_delay=1.0, device="cpu")
    fd, rd = TR.draw_sparse_tick(torch.Generator().manual_seed(0), dparams, True)
    dst, _ms = TPV.pview_tick(dst, fd, rd, dparams)
    assert dst.tick == 1 and tuple(dst.pending_inf.shape) == (2, 33, dparams.rumor_slots)
