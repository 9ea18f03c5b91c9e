"""The PyTorch port's dense engine against the JAX package's.

Same params, same host mutations and the SAME uniform draws (the JAX
window's own per-tick key chain, handed to the port as numpy) must give the
same value in every state leaf after every tick and in every integer
metric, against both JAX windows (``make_run`` and its fused twin
``make_fused_run``); the two f32 metrics may differ by at most 2 ulp.

The lifecycle script runs 64 one-tick windows at N = 33 and 256 with i32
and i16 keys, over lossy links with the delay rings: a crash wave
(SUSPECT, then DEAD), user rumors to full coverage and their sweep, a
member whose links drop most packets (its ALIVE records wait on the
metadata fetch) and its metadata bump, a graceful leave, per-link delays,
a partition, a churn batch with a cold join through the seeds and a
restart of a crashed row at a new epoch, metadata bumps, refute
suppression, the heal (DEAD records refuted by their zombies), a partition
by group assignment with bystanders and its heal to a floor, a loss storm.
The lifecycle script runs again with the [N, N] passes over row chunks of
a few rows (``_tensor.PLANE_CHUNK_CELLS`` patched small), once armed with
``push_pull/expander`` so that the pull leg's row gathers are chunked too.
Two more scripts cover heavy delay without loss (a delayed rumor
outliving its sweep window), and namespaces with the namespace gate,
``full_metrics`` off, ``quiet_gates=False`` and a 4-caller SYNC cap.
``tests/test_torch_dense_pieces.py`` holds the parts on their own.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.dissemination import DissemSpec
from scalecube_cluster_tpu.ops import kernel as JK
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu.ops.rand import draw_fd_randoms, draw_round_randoms, split_tick_key
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import _tensor
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import rand as TR
from scalecube_cluster_tpu_torch.ops import state as TS
from test_torch_pview_fused import FLOAT_METRICS

torch.set_num_threads(1)

TICKS = 64

# the JAX dense tests' knobs: a 2-tick FD period, a one-period suspicion
# timeout and an 8-tick SYNC period, so that detection, expiry and
# anti-entropy all happen inside the window
_KNOBS = dict(fanout=2, ping_req_k=1, fd_every=2, sync_every=8, suspicion_mult=1, rumor_slots=4,
              seed_rows=(0, 1))


def _params(n: int, kd: str = "i32", **over):
    return JS.SimParams(capacity=n, key_dtype=kd, **{**_KNOBS, **over})


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


@functools.lru_cache(maxsize=None)
def _jax_window(params, fused: bool):
    make = JK.make_fused_run if fused else JK.make_run
    return make(params, 1, donate=False)


@functools.lru_cache(maxsize=None)
def _jax_tick_draws(n: int, ping_req_k: int, fanout: int):
    """One tick of the JAX window's key chain as one compiled program:
    key -> (next key, FD draws, round draws)."""

    def draw(key):
        key, tick_key = jax.random.split(key)
        fd_key, round_key = split_tick_key(tick_key)
        return key, draw_fd_randoms(fd_key, n, ping_req_k), draw_round_randoms(round_key, n, fanout)

    return jax.jit(draw)


def dense_draws(key, n_ticks: int, params):
    """The per-tick draws of the JAX dense window's key chain."""
    draws = []
    draw = _jax_tick_draws(params.capacity, params.ping_req_k, params.fanout)
    for _ in range(n_ticks):
        key, fd, rd = draw(key)
        draws.append((
            TR.FdRandoms(*(torch.from_numpy(np.array(x)) for x in fd)),
            TR.RoundRandoms(*(torch.from_numpy(np.array(x)) for x in rd)),
        ))
    return key, draws


def _assert_state_equal(jst, tst, label):
    ref = JS.snapshot(jst)
    got = convert.state_to_numpy(tst)
    assert set(ref) == set(got), f"{label}: leaves differ: {set(ref) ^ set(got)}"
    for name, v in ref.items():
        g = got[name]
        assert g.shape == v.shape and g.dtype == v.dtype, f"{label}: leaf {name} {g.dtype}{g.shape}"
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


def _run_both(params, start, events, seed: int = 5):
    """64 one-tick windows of the port and of both JAX windows from
    ``start(mod, params, device_kw)``, with ``events[t](mod, st)`` applied
    before tick t; states are compared after every tick and every host
    mutation. Returns per-metric totals, the largest count of DEAD records
    seen, each rumor slot's highest coverage, and the last state."""
    tparams = _tparams(params)
    jst = start(JS, params, {})
    jfst = start(JS, params, {})
    tst = start(TS, tparams, {"device": "cpu"})
    _assert_state_equal(jst, tst, "scenario start")
    key = jax.random.PRNGKey(seed)
    totals: dict = {}
    dead_max = 0
    cov_max = np.zeros(params.rumor_slots, np.float32)
    run = TK.make_run(tparams, 1)
    for t in range(TICKS):
        if t in events:
            step = events[t]
            # one compiled program per JAX-side mutation, run on both states
            jstep = jax.jit(functools.partial(step, JS))
            jst, jfst, tst = jstep(jst), jstep(jfst), step(TS, tst)
            _assert_state_equal(jst, tst, f"after the host mutation at tick {t}")
        jst, key_after, jms, _ = _jax_window(params, False)(jst, key)
        jfst, _, jfms, _ = _jax_window(params, True)(jfst, key)
        key, draws = dense_draws(key, 1, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _ = run(tst, draws)
        for kind, js, jm in (("make_run", jst, jms), ("make_fused_run", jfst, jfms)):
            label = f"tick {t + 1} (n={params.capacity}, {params.key_dtype}) against {kind}"
            _assert_state_equal(js, tst, label)
            _assert_metrics_equal(jm, tms, label)
        for k, v in tms.items():
            if k not in FLOAT_METRICS:
                totals[k] = totals.get(k, 0) + int(v.sum())
        vk = tst.view_key
        dead_max = max(dead_max, int(((vk >= 0) & ((vk & 3) == 3)).sum()))
        cov_max = np.maximum(cov_max, tms["rumor_coverage"][-1].numpy())
    return totals, dead_max, cov_max, tst


def _halves(n: int):
    return list(range(0, n // 2)), list(range(n // 2, n))


def _lifecycle_start(mod, params, kw):
    n = params.capacity
    st = mod.init_state(params, n - 4, uniform_loss=0.05, uniform_delay=1.0, **kw)
    st = mod.spread_rumor(st, 0, 3)
    st = mod.spread_rumor(st, 1, 7)
    st = mod.crash_rows(st, [6, 17])
    return mod.begin_leave(st, 9)


def _lifecycle_events(n: int, seeds):
    a, b = _halves(n)
    assign = [-1 if r % 5 == 0 else r % 3 for r in range(n)]

    def churn(mod, st):
        # a crashed row restarts (a new epoch), two never-used rows join
        # cold through the seeds, metadata bumps, a spread, a leave
        st = mod.crash_rows(st, [3])
        st = mod.join_rows(st, [6, n - 3, n - 2], seeds)
        st = mod.update_metadata(mod.update_metadata(st, 4), 4)
        st = mod.spread_rumor(st, 2, 12)
        return mod.begin_leave(st, 11)

    others = [r for r in range(n) if r != 2]

    def lossy_row(mod, st):
        # row 2's links drop most packets: ALIVE records about it wait on
        # the metadata fetch
        return mod.set_link_loss(mod.set_link_loss(st, [2], others, 0.8), others, [2], 0.6)

    return {
        1: lossy_row,
        3: lambda mod, st: mod.update_metadata(st, 2),
        4: lambda mod, st: mod.set_link_delay(st, [2, 3], [4, 5, n // 2], 2.5),
        8: lambda mod, st: mod.block_partition(st, a, b),
        14: churn,
        18: lambda mod, st: mod.drop_refutes(st, list(range(0, n, 3))),
        21: lambda mod, st: mod.set_link_loss(st, [2], list(range(n)), 0.05),
        24: lambda mod, st: mod.heal_partition(st, a, b),
        26: lambda mod, st: mod.join_row(st, n - 1, seeds),
        30: lambda mod, st: mod.drop_refutes(st, list(range(1, n, 2))),
        36: lambda mod, st: mod.block_partition_assign(st, assign),
        44: lambda mod, st: mod.heal_partition_assign(st, assign, clear=0.02),
        48: lambda mod, st: mod.set_uniform_loss(mod.set_uniform_loss(st, 0.3), 0.1, floor=True),
        52: lambda mod, st: mod.set_link_delay_q(mod.heal_partition_pair(
            mod.block_partition(st, a[:4], b[:4]), a[:4], b[:4], clear=0.05), [1], [2], 0.5),
        56: lambda mod, st: mod.set_uniform_loss(mod.crash_row(st, 5), 0.05),
    }


@pytest.mark.parametrize("n", [33, 256])
@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_lifecycle_window_matches_jax(n, kd):
    params = _params(n, kd, delay_slots=4)
    totals, dead_max, cov_max, st = _run_both(params, _lifecycle_start, _lifecycle_events(n, params.seed_rows))
    for k in ("fd_new_suspects", "fd_failed_probes", "rumor_deliveries", "rumor_sends", "sync_roundtrips",
              "gossip_msgs", "false_suspect_pairs"):
        assert totals[k] > 0, (k, totals)
    assert dead_max > 0
    # a rumor reached every up member and its slot was swept
    assert any(c >= 1.0 and not bool(st.rumor_active[s]) for s, c in enumerate(cov_max)), cov_max
    # refutations bumped incarnations, the restart bumped an epoch
    assert int((st.view_inc.diagonal() > 0).sum()) > 0
    assert int(st.epoch[6]) == 1


@pytest.mark.parametrize("n,kd,cells,dissem", [
    (33, "i32", 1000, None),
    (256, "i32", 3000, None),
    (256, "i16", 777, None),
    (256, "i32", 3000, ("push_pull", "expander")),
], ids=["33-i32-1000", "256-i32-3000", "256-i16-777", "256-i32-3000-push_pull-expander"])
def test_lifecycle_window_over_row_chunks_matches_jax(monkeypatch, n, kd, cells, dissem):
    """The lifecycle script with every [N, N] pass (the suspicion sweep, the
    gossip accept and its fetch hash, the cluster sizes, the gate flags,
    the metrics; the pull leg's peer-row gathers when armed) over row
    chunks of ``cells`` cells — 30, 11 and 3 rows, the last chunk short —
    against both JAX windows after every tick."""
    monkeypatch.setattr(_tensor, "PLANE_CHUNK_CELLS", cells)
    over = {} if dissem is None else {"dissem": DissemSpec(strategy=dissem[0], topology=dissem[1])}
    params = _params(n, kd, delay_slots=4, **over)
    assert len(list(_tensor.plane_chunks(n, n))) >= 2
    totals, dead_max, _, _ = _run_both(params, _lifecycle_start, _lifecycle_events(n, params.seed_rows))
    assert totals["rumor_deliveries"] > 0 and totals["sync_roundtrips"] > 0 and dead_max > 0


def _heavy_delay_start(mod, params, kw):
    n = params.capacity
    st = mod.init_state(params, n, uniform_delay=3.0, **kw)
    return mod.crash_rows(st, [5])


@pytest.mark.parametrize("kd", [pytest.param("i32", marks=pytest.mark.slow), "i16"])
def test_heavy_delay_without_loss_matches_jax(kd):
    """Mean delay 3 ticks, six ring slots, no loss: pings time out, and a
    rumor spread at tick 10 is still in flight after its 12-tick sweep
    window (repeat_mult 1)."""
    params = _params(33, kd, delay_slots=6, repeat_mult=1)
    events = {10: lambda mod, st: mod.spread_rumor(st, 3, 20),
              30: lambda mod, st: mod.set_link_delay(st, [0, 1], list(range(33)), 0.0)}
    totals, _, _, _ = _run_both(params, _heavy_delay_start, events, seed=11)
    assert totals["fd_failed_probes"] > 0 and totals["rumor_deliveries"] > 0


_NAMESPACES = ["a", "a/x", "a/y", "b"]


def _namespace_start(mod, params, kw):
    n = params.capacity
    st = mod.init_state(params, n - 2, uniform_loss=0.02,
                        namespaces=[_NAMESPACES[r % 4] for r in range(n)], **kw)
    st = mod.spread_rumor(mod.crash_rows(st, [9]), 0, 4)
    return mod.join_rows(st, [n - 2], params.seed_rows)


@pytest.mark.parametrize("n", [33, pytest.param(256, marks=pytest.mark.slow)])
def test_namespaces_ungated_lite_window_matches_jax(n):
    """The namespace gate, no full metrics, every quiet gate off and SYNC
    capped at 4 callers a tick (the rest wait)."""
    params = _params(n, namespace_gate=True, full_metrics=False, quiet_gates=False, sync_slots=4)
    a, b = _halves(n)
    events = {6: lambda mod, st: mod.block_partition(st, a, b),
              20: lambda mod, st: mod.heal_partition(st, a, b),
              24: lambda mod, st: mod.begin_leave(st, 14)}
    totals, _, _, _ = _run_both(params, _namespace_start, events, seed=7)
    assert totals["sync_roundtrips"] > 0 and totals["fd_new_suspects"] > 0
