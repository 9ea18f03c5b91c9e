"""The PyTorch port's fused pview window against the JAX package's.

Same params, same host mutations and the SAME uniform draws (the JAX
window's own per-tick key chain, handed to the port as numpy) must give the
same value in every state leaf and every stacked integer metric, tick for
tick, across both key layouts and both JAX delivery spellings (the XLA
sequence and the interpreted Pallas kernel). The two float metrics may
differ by at most 2 ulp: XLA may lower an f32 division as a
reciprocal-multiply, PyTorch divides.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import scalecube_cluster_tpu.ops.pview as JPV  # noqa: E402
from scalecube_cluster_tpu.ops.rand import (  # noqa: E402
    draw_sparse_fd,
    draw_sparse_round,
    split_tick_key,
)
from scalecube_cluster_tpu_torch import convert  # noqa: E402
from scalecube_cluster_tpu_torch.ops import _tensor  # noqa: E402
from scalecube_cluster_tpu_torch.ops import pview as TPV  # noqa: E402
from scalecube_cluster_tpu_torch.ops import rand as TR  # noqa: E402

torch.set_num_threads(1)

T_WIN, N_WIN, MUTATE_AT = 4, 10, 4  # 40 ticks; the mutation batch at tick 16
FLOAT_METRICS = ("rumor_coverage", "alive_view_fraction")

# the fused-window knobs of tests/test_fused.py, without the delay rings
_KNOBS = dict(fanout=2, repeat_mult=3, ping_req_k=1, fd_every=3,
              sync_every=8, suspicion_mult=3, rumor_slots=4,
              seed_rows=(0, 1))


def _params(n: int, kd: str, kernel: str = "xla", **over):
    """The knobs above, with a shorter suspicion timeout, a 4-tick sweep and
    a tombstone period chosen so that suspicion expiry and the tombstone
    purge both happen, visibly at window ends, inside the 40 ticks."""
    return JPV.PviewParams(capacity=n, key_dtype=kd, mr_slots=16, announce_slots=8,
                           full_metrics=True, delivery_kernel=kernel,
                           **{**_KNOBS, "suspicion_mult": 1, "sweep_every": 4,
                              "tombstone_ticks": 16 if n < 64 else 12, **over})


def _scenario(mod, params, n: int, device=None):
    kw = {} if device is None else {"device": device}
    st = mod.init_pview_state(params, n - 4, uniform_loss=0.05, **kw)
    st = mod.spread_rumor(st, 0, 3)
    st = mod.spread_rumor(st, 1, 7)
    st = mod.crash_rows(st, [6, 17])
    return mod.begin_leave(st, 9)


def _mutate(mod, st, params, n: int):
    st = mod.crash_rows(st, [3])
    st = mod.join_row(st, n - 3, params.seed_rows)
    st = mod.spread_rumor(st, 2, 12)
    return mod.begin_leave(st, 11)


def _jax_draws(key, n_ticks: int, params):
    """The per-tick draws of the JAX fused window's key chain."""
    draws = []
    for _ in range(n_ticks):
        key, tick_key = jax.random.split(key)
        fd_key, round_key = split_tick_key(tick_key)
        fd = draw_sparse_fd(fd_key, params.capacity, params.ping_req_k, params.sample_tries)
        rd = draw_sparse_round(round_key, params.capacity, params.fanout, params.sample_tries)
        draws.append((
            TR.SparseFdRandoms(*(torch.from_numpy(np.array(x)) for x in fd)),
            TR.SparseRoundRandoms(*(torch.from_numpy(np.array(x)) for x in rd)),
        ))
    return key, draws


@functools.lru_cache(maxsize=None)
def _jax_window(params, n_ticks: int):
    return JPV.make_pview_fused_run(params, n_ticks, donate=False)


def _assert_state_equal(jst, tst, label):
    """Every leaf of a JAX engine state (either engine's) equals the port's."""
    ref = {f.name: np.asarray(getattr(jst, f.name)) for f in dataclasses.fields(jst)}
    got = convert.state_to_numpy(tst)
    for name, v in ref.items():
        g = got[name]
        if v.dtype == np.uint32:
            v = v.view(np.int32)
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
            assert np.array_equal(g, v), f"{label}: stacked metric {name} diverged"


def _dead_entries(st) -> int:
    keys = np.asarray(st.nbr_key).astype(np.int32)
    return int((((keys & 3) == 3) & (np.asarray(st.nbr_id) >= 0)).sum())


def _run_both(n: int, kd: str, kernel: str, **over):
    params = _params(n, kd, kernel, **over)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = _scenario(JPV, params, n)
    tst = convert.state_from_numpy(JPV.snapshot(jst), device="cpu")
    key = jax.random.PRNGKey(11)
    busy = {"mr": 0, "sync": 0, "fd": 0, "delivered": 0, "dead": 0, "purged": 0}
    dead_before = 0
    for w in range(N_WIN):
        if w == MUTATE_AT:
            jst = _mutate(JPV, jst, params, n)
            tst = _mutate(TPV, tst, tparams, n)
            _assert_state_equal(jst, tst, f"after mutation batch (n={n}, {kd})")
        jst, key_after, jms, _ = _jax_window(params, T_WIN)(jst, key)
        key, draws = _jax_draws(key, T_WIN, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_after))
        tst, tms, _ = TPV.run_pview_ticks_fused(tst, draws, T_WIN, tparams)
        label = f"window {w} (n={n}, {kd}, jax delivery {kernel})"
        _assert_state_equal(jst, tst, label)
        _assert_metrics_equal(jms, tms, label)
        for k, metric in (("mr", "mr_accepts"), ("sync", "sync_roundtrips"),
                          ("fd", "fd_new_suspects"), ("delivered", "rumor_deliveries")):
            busy[k] += int(np.asarray(jms[metric]).sum())
        dead = _dead_entries(jst)
        busy["dead"] = max(busy["dead"], dead)
        busy["purged"] += int(dead < dead_before)
        dead_before = dead
    return busy


@pytest.mark.parametrize("n,kd", [(33, "i32"), (33, "i16"), (256, "i32"), (256, "i16")])
def test_fused_window_matches_jax_xla_delivery(n, kd):
    busy = _run_both(n, kd, "xla")
    # the scenario must exercise every phase, or equality proves little
    assert all(v > 0 for v in busy.values()), busy


def test_fused_window_matches_jax_pallas_delivery():
    """Against the JAX window whose delivery goes through the Pallas kernel
    (interpreted on the CPU, as the JAX package's own tests run it)."""
    busy = _run_both(33, "i32", "pallas")
    assert all(v > 0 for v in busy.values()), busy


def test_fused_window_matches_jax_at_tight_caps(monkeypatch):
    """Caps that bind: FD accepts, refutations and SYNC callers beyond their
    slots are dropped in order, as in the JAX tick; and the [N, M]
    reductions run over several row chunks, the last one short."""
    monkeypatch.setattr(_tensor, "ROW_CHUNK", 48)
    busy = _run_both(256, "i16", "xla", fd_accept_slots=3, refute_slots=2, sync_slots=6)
    assert all(v > 0 for v in busy.values()), busy


def test_generator_window_runs_and_watches_rows():
    """The main-path draw source (a torch.Generator) drives the same tick,
    keeps the table invariants, and returns the watched rows' views."""
    params = TPV.PviewParams(capacity=64, mr_slots=16, announce_slots=8, **_KNOBS)
    st = _scenario(TPV, params, 64, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(3)
    st, ms, watched = TPV.run_pview_ticks_fused(st, gen, 10, params, watch_rows=[0, 5])
    assert ms["n_up"].shape == (10,)
    assert watched.shape == (10, 2, 64)
    assert torch.equal(watched[-1], TPV.view_rows(st, [0, 5]))
    ids = st.nbr_id
    rows = torch.arange(64)[:, None]
    assert not ((ids >= 0) & (ids == rows)).any()
    srt = ids.sort(dim=1).values
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()


_MUTATIONS = {
    "join_rows": lambda mod, st, p, n: mod.join_rows(st, [n - 2, n - 1], p.seed_rows),
    # a restart on a used row: a new identity through the epoch bits
    "join_row_restart": lambda mod, st, p, n: mod.join_row(mod.crash_row(st, 5), 5, p.seed_rows),
    "update_metadata": lambda mod, st, p, n: mod.update_metadata(mod.update_metadata(st, 4), 4),
    "set_uniform_loss": lambda mod, st, p, n: mod.set_uniform_loss(
        mod.set_uniform_loss(st, 0.2), 0.1, floor=True),
}


@pytest.mark.parametrize("kd", ["i32", "i16"])
@pytest.mark.parametrize("name", sorted(_MUTATIONS))
def test_host_mutators_match_jax(name, kd):
    """The host mutators the windows above do not reach, on the same state."""
    n = 33
    params = _params(n, kd)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = _scenario(JPV, params, n)
    tst = convert.state_from_numpy(JPV.snapshot(jst), device="cpu")
    mutate = _MUTATIONS[name]
    _assert_state_equal(mutate(JPV, jst, params, n), mutate(TPV, tst, tparams, n), f"{name} ({kd})")


def test_port_refuses_what_it_does_not_run():
    base = dataclasses.asdict(_params(33, "i32"))
    # the dissemination and adaptive specs are carried across (ported)
    armed = convert.params_from_dict({**base, "dissem": {**base["dissem"], "strategy": "push_pull"}})
    assert armed.dissem.strategy == "push_pull" and isinstance(armed, TPV.PviewParams)
    adaptive = convert.params_from_dict({**base, "adaptive": {**base["adaptive"], "enabled": True}})
    assert adaptive.adaptive.enabled and isinstance(adaptive, TPV.PviewParams)
    # the delay rings are ported: delay_slots is carried across; a delay
    # without rings, and any per-link delay, stay refused as in JAX
    assert convert.params_from_dict({**base, "delay_slots": 2}).delay_slots == 2
    assert TPV.PviewParams(capacity=33, delay_slots=2).delay_slots == 2
    with pytest.raises(ValueError, match="delay_slots > 0"):
        TPV.init_pview_state(TPV.PviewParams(capacity=33), 33, uniform_delay=1.0, device="cpu")
    with pytest.raises(ValueError, match="uniform delay only"):
        TPV.set_link_delay(TPV.init_pview_state(TPV.PviewParams(capacity=33, delay_slots=2), 33, device="cpu"),
                           [0], [1], 2.0)


def test_fused_window_peak_within_the_declared_memory_factor(monkeypatch):
    """The fused window at a width where the [N, 2,048] ``minf_age`` plane
    dominates the state (config16's knobs, a 2,048-slot pool): its peak live
    bytes over its state, the audit's CPU instrument (``torch.profiler``
    memory events), stay within the engine's declared ``memory_factor``
    (4.5, JAX's ``EngineContracts``), and the window stays bit-equal to the
    JAX package's. The row chunks are set to the fractions of the plane
    they are at 1,048,576 members (``ROW_CHUNK`` 1/16 of the rows,
    ``PLANE_CHUNK_CELLS`` 1/32 of the plane), so the temporaries scale as
    on the card."""
    from scalecube_cluster_tpu_torch.audit import programs as AP
    from scalecube_cluster_tpu_torch.ops import engine_api

    n, ticks = 4096, 5
    monkeypatch.setattr(_tensor, "ROW_CHUNK", n // 16)
    monkeypatch.setattr(_tensor, "PLANE_CHUNK_CELLS", n * 2048 // 32)
    params = JPV.PviewParams(
        capacity=n, view_slots=24, active_slots=8, fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5,
        sync_every=150, suspicion_mult=5, rumor_slots=8, seed_rows=(0,), key_dtype="i16", mr_slots=2048,
    )
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = JPV.init_pview_state(params, n, warm=True)
    for s in range(params.rumor_slots):
        jst = JPV.spread_rumor(jst, s, (s * 997) % n)
    jst = JPV.crash_rows(jst, list(range(n // 2, n // 2 + 4)))
    tst = convert.state_from_numpy(JPV.snapshot(jst), device="cpu")
    key = jax.random.PRNGKey(11)
    for w in range(2):
        jst, key_after, jms, _ = _jax_window(params, ticks)(jst, key)
        key, draws = _jax_draws(key, ticks, params)
        if w == 0:
            tst, tms, _ = TPV.run_pview_ticks_fused(tst, draws, ticks, tparams)
            continue
        # the measured window, from a busy state (an active pool ages)
        assert bool(tst.mr_active.any())
        state_bytes = AP.tree_bytes(tst)
        prof = AP._cpu_memory_profile()
        with prof:
            tst, tms, _ = TPV.run_pview_ticks_fused(tst, draws, ticks, tparams)
        ratio = (state_bytes + AP._cpu_peak(prof)) / state_bytes
        factor = engine_api.engine("pview").contracts.memory_factor
        assert ratio <= factor, f"peak over state {ratio:.3f} above the declared memory_factor {factor}"
    _assert_state_equal(jst, tst, "the measured window")
    _assert_metrics_equal(jms, tms, "the measured window")
