"""The PyTorch port's dense engine in parts, against the JAX package's: the
host mutators, the snapshot layout, the two selection samplers (the packed
one picks the wide one's columns), the delay model's ``_timely_rt`` bit for
bit, the packed-plane helpers, the refusals, the window over a
``torch.Generator``, the engine policy ``auto_params`` and each params
class's ``from_config``. The windows themselves are held in
``tests/test_torch_dense.py``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu import config as JC
from scalecube_cluster_tpu.ops import kernel as JK
from scalecube_cluster_tpu.ops import pview as JPV
from scalecube_cluster_tpu.ops import sparse as JSP
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu.sim.driver import auto_params as jauto_params
from scalecube_cluster_tpu_torch import config as TC
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import _tensor, engine_api
from scalecube_cluster_tpu_torch.ops import bitplane as TB
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.sim.driver import SimDriver, auto_params
from test_torch_dense import _assert_state_equal, _params

torch.set_num_threads(1)


# -- pieces on their own -------------------------------------------------------------


def _busy_pair(n=40, kd="i32", rumor_slots=40):
    """A JAX state with two rumors (one in the second packed word), a crash,
    a leave, a partition, a metadata bump and a per-link delay."""
    params = _params(n, kd, delay_slots=3, rumor_slots=rumor_slots)
    jst = JS.init_state(params, n - 3, uniform_loss=0.1, uniform_delay=1.5)
    jst = JS.spread_rumor(JS.spread_rumor(jst, 0, 3), 35, 7)
    jst = JS.begin_leave(JS.crash_row(jst, 8), 12)
    jst = JS.block_partition(JS.update_metadata(jst, 2), [0, 1], [20, 21, 22])
    return params, JS.set_link_delay(jst, [3], [4, 5], 2.0)


def _port_of(jst):
    return convert.state_from_numpy(JS.snapshot(jst), device="cpu")


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_mutators_match_jax(kd):
    params, jst = _busy_pair(kd=kd)
    n = params.capacity
    seeds = params.seed_rows
    muts = {
        "join_row": lambda m, s: m.join_row(s, n - 1, seeds),
        "join_rows": lambda m, s: m.join_rows(m.crash_rows(s, [4, 0]), [4, n - 2, 0], seeds),
        "crash_row": lambda m, s: m.crash_row(s, 3),
        "begin_leave": lambda m, s: m.begin_leave(s, 5),
        "update_metadata": lambda m, s: m.update_metadata(m.update_metadata(s, 6), 6),
        "spread_rumor": lambda m, s: m.spread_rumor(m.spread_rumor(s, 33, 8), 0, 9),
        "set_link_loss": lambda m, s: m.set_link_loss(s, [1, 2, 1], [3, 4], 0.25),
        "set_link_delay": lambda m, s: m.set_link_delay(s, [1], [2, 3], 4.0),
        "set_link_delay_q": lambda m, s: m.set_link_delay_q(s, [5, 6], [7], 0.75),
        "set_uniform_loss": lambda m, s: m.set_uniform_loss(s, 0.2),
        "set_uniform_loss_floor": lambda m, s: m.set_uniform_loss(m.block_partition(s, [0, 1], [2]), 0.3,
                                                                  floor=True),
        "block_partition": lambda m, s: m.block_partition(s, [0, 1, 2], [10, 11]),
        "heal_partition": lambda m, s: m.heal_partition(m.block_partition(s, [0, 1], [9]), [0, 1], [9]),
        "heal_partition_pair": lambda m, s: m.heal_partition_pair(m.block_partition(s, [0], [9]), [0], [9],
                                                                  clear=0.1),
        "block_partition_assign": lambda m, s: m.block_partition_assign(s, [r % 3 - 1 for r in range(n)]),
        "heal_partition_assign": lambda m, s: m.heal_partition_assign(
            m.block_partition_assign(s, [r % 2 for r in range(n)]), [r % 2 for r in range(n)], 0.05),
        "drop_refutes": lambda m, s: m.drop_refutes(s, list(range(n))),
    }
    for name, mut in muts.items():
        _assert_state_equal(mut(JS, jst), mut(TS, _port_of(jst)), name)


def test_narrow_incarnation_saturates_and_drop_refutes_squashes():
    """An i16 self record at the incarnation cap stays there (no carry into
    the epoch); a refuted row whose peers hold it SUSPECT is rewound."""
    params = _params(33, "i16")
    jst = JS.init_state(params, 33)
    cap_key = (511 << 2)
    jst = jst.replace(view_key=jst.view_key.at[4, 4].set(cap_key - 4))
    jst = jst.replace(view_key=jst.view_key.at[7, 8].set((1 << 2) | 2).at[8, 8].set(2 << 2))
    for m, s in ((JS, jst), (TS, _port_of(jst))):
        s = m.update_metadata(m.update_metadata(m.update_metadata(s, 4), 4), 4)
        s = m.drop_refutes(s, [8, 4])
        if m is JS:
            ref = s
        else:
            _assert_state_equal(ref, s, "saturation and squash")
            assert int(s.view_key[4, 4]) == cap_key and int(s.view_key[8, 8]) == (1 << 2) | 2


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_snapshot_restore_round_trip(kd):
    params, jst = _busy_pair(kd=kd)
    snap = JS.snapshot(jst)
    tst = TS.restore(snap, device="cpu")
    _assert_state_equal(jst, tst, "restore")
    assert tst.infected.dtype == torch.int32 and snap["infected"].dtype == np.uint32
    again = TS.snapshot(tst)
    for k, v in snap.items():
        assert np.array_equal(again[k], v) and again[k].dtype == v.dtype, k
    # the JAX engine runs on from the port's snapshot
    JS.restore(again)
    with pytest.raises(TypeError, match="unexpected"):
        TS.restore({**snap, "n_live": snap["up"]}, device="cpu")


def _random_masks(n=70, k=4, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < rng.random((n, 1))
    mask[0] = False
    mask[1] = True
    mask[2, :] = False
    mask[2, 69] = True
    mask[3, :3] = True
    mask[3, 3:] = False
    u = rng.random((n, k)).astype(np.float32)
    u[:4] = [0.0, 0.9999999, 0.5, 0.25]
    return mask, u


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_samplers_match_jax(seed):
    mask, u = _random_masks(seed=seed)
    n = mask.shape[0]
    j_idx, j_valid = JK._sample_distinct(jnp.asarray(mask), jnp.asarray(u))
    t_idx, t_valid = TK._sample_distinct(torch.from_numpy(mask), torch.from_numpy(u))
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx)) and np.array_equal(t_valid.numpy(), np.asarray(j_valid))
    jw = JK.bp.pack_bits(jnp.asarray(mask))
    jw_idx, jw_valid = JK._sample_distinct_words(jw, n, jnp.asarray(u))
    tw_idx, tw_valid = TK._sample_distinct_words(TB.pack_bits(torch.from_numpy(mask)), n, torch.from_numpy(u))
    assert np.array_equal(tw_idx.numpy(), np.asarray(jw_idx)) and np.array_equal(tw_valid.numpy(), np.asarray(jw_valid))
    # the packed sampler picks the wide sampler's columns
    v = t_valid.numpy()
    assert np.array_equal(tw_idx.numpy()[v], t_idx.numpy()[v])
    picks = t_idx.numpy()
    for i in range(n):
        row = picks[i][v[i]]
        assert len(set(row.tolist())) == len(row) and mask[i, row].all()
    assert not v[0].any() and v[1].all() and v[2].tolist() == [True, False, False, False]


def test_timely_rt_is_bit_exact():
    q = np.asarray([0.0, 1e-6, 0.1, 0.25, 0.5, 0.6065307, 0.7165313, 0.9, 0.99, 0.999999], np.float32)
    q1, q2 = (a.ravel() for a in np.meshgrid(q, q))
    for t in range(0, 16):
        ref = np.asarray(JK._timely_rt(jnp.asarray(q1), jnp.asarray(q2), t))
        got = TK._timely_rt(torch.from_numpy(q1), torch.from_numpy(q2), t).numpy()
        assert np.array_equal(got.view(np.int32), ref.view(np.int32)), t
    assert float(TK._timely_rt(torch.zeros(()), torch.zeros(()), 15)) == 1.0


def test_delay_mean_to_q_and_ceil_log2_match_jax():
    for mean in (0.0, -1.0, 0.5, 1.0, 1.5, 3.0, 1e6):
        assert TS.delay_mean_to_q(mean) == JS.delay_mean_to_q(mean)
    x = np.asarray([0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 10_000, (1 << 30) + 1], np.int32)
    assert np.array_equal(TK.ceil_log2(torch.from_numpy(x)).numpy(), np.asarray(JK.ceil_log2(jnp.asarray(x))))


def test_bitplane_helpers_match_jax():
    rng = np.random.default_rng(5)
    for length in (1, 31, 32, 33, 70):
        assert np.array_equal(TB.tail_mask(length).numpy(), np.asarray(JK.bp.tail_mask(length)).view(np.int32))
        assert np.array_equal(TB.diag_words(length).numpy(), np.asarray(JK.bp.diag_words(length)).view(np.int32))
    words = rng.integers(0, 1 << 32, (9, 3), dtype=np.uint64).astype(np.uint32)
    words[0] = [0, 0xFFFFFFFF, 0x80000001]
    tw = torch.from_numpy(words.view(np.int32))
    assert np.array_equal(TB.popcount_rows(tw).numpy(), np.asarray(JK.bp.popcount_rows(jnp.asarray(words))))
    assert int(TB.popcount_total(tw)) == int(JK.bp.popcount_total(jnp.asarray(words)))
    r = rng.integers(-1, 34, words.shape).astype(np.int32)
    assert np.array_equal(TB.select_bit(tw, torch.from_numpy(r)).numpy(),
                          np.asarray(JK.bp.select_bit(jnp.asarray(words), jnp.asarray(r))))
    for col in (0, 31, 33, 69):
        ref = JK.bp.set_bit(JK.bp.clear_col(jnp.asarray(words), col), 2, col)
        got = TB.set_bit(TB.clear_col(tw, col), 2, col)
        assert np.array_equal(got.numpy(), np.asarray(ref).view(np.int32))
        assert np.array_equal(TB.col_bits(got, col).numpy(), np.asarray(JK.bp.col_bits(ref, col)))
    assert torch.equal(TB.row_gather(tw, [2, 0]), tw[[2, 0]])
    assert torch.equal(TB.word_andnot(tw, tw), torch.zeros_like(tw))


def test_tick_refuses_unported_planes():
    params = TS.SimParams(capacity=33)
    st = TS.init_state(params, 33, device="cpu")
    # the trace capture is ported (tests/test_torch_trace.py); armed with
    # the adaptive plane it is refused, as in JAX
    with pytest.raises(ValueError, match="trace-armed adaptive windows are not supported"):
        TK.tick(st, None, None, params, trace=object(), ad=object())
    # the adaptive plane is ported: it needs an enabled spec on the params
    with pytest.raises(ValueError, match="enabled AdaptiveSpec"):
        TK.tick(st, None, None, params, ad=object())
    with pytest.raises(ValueError, match="delay_slots > 0"):
        TS.init_state(params, 33, uniform_delay=1.0, device="cpu")
    with pytest.raises(ValueError, match="lean"):
        TS.init_state(TS.SimParams(capacity=33, delay_slots=2), 33, dense_links=False, device="cpu")
    with pytest.raises(ValueError, match="delay_slots > 0"):
        TS.set_link_delay(st, [0], [1], 2.0)
    lean = TS.init_state(params, 33, dense_links=False, device="cpu")
    with pytest.raises(ValueError, match="dense links"):
        TS.set_link_loss(lean, [0], [1], 0.5)
    base = dataclasses.asdict(_params(33))
    # the dissemination and adaptive specs are carried across (ported)
    armed = convert.params_from_dict({**base, "dissem": {**base["dissem"], "strategy": "push_pull"}})
    assert armed.dissem.strategy == "push_pull" and isinstance(armed, TS.SimParams)
    adaptive = convert.params_from_dict({**base, "adaptive": {**base["adaptive"], "enabled": True}})
    assert adaptive.adaptive.enabled and not adaptive.adaptive.is_default
    assert isinstance(convert.params_from_dict({**base, "delay_slots": 4}), TS.SimParams)
    assert engine_api.resolve(params).name == "dense" and not engine_api.engine("dense").has_pool


def test_window_draws_from_a_generator_and_watches():
    """The main path's spelling: draws from a ``torch.Generator`` (FD draws
    on FD ticks only), the watched rows after every tick, ``quiet_gates``
    reading its flags."""
    params = TS.SimParams(capacity=48, fanout=2, fd_every=3, sync_every=8, suspicion_mult=1, rumor_slots=2,
                          seed_rows=(0,), delay_slots=3)
    st = TS.init_state(params, 46, uniform_delay=1.0, device="cpu")
    st = TS.crash_row(TS.spread_rumor(st, 0, 1), 5)
    gen = torch.Generator().manual_seed(3)
    _tensor.HOST_SYNCS.count = 0
    st, ms, watched = TK.make_fused_run(params, 12)(st, gen, watch_rows=torch.tensor([0, 7]))
    assert watched.shape == (12, 2, 48) and torch.equal(watched[-1], st.view_key[[0, 7]])
    assert ms["fd_probes"].shape == (12,) and int((ms["fd_probes"] > 0).sum()) == 4
    # the suspicion and gossip gates' two flags, in one read per tick
    assert _tensor.HOST_SYNCS.count == 12


# -- engine policy and configuration ---------------------------------------------------


def test_small_fidelity_runs_dense():
    assert isinstance(auto_params(256, per_link_fidelity=True), TS.SimParams)
    assert isinstance(auto_params(4096, link_delay=True), TS.SimParams)
    assert isinstance(auto_params(100), TS.SimParams)


def test_scale_runs_sparse():
    assert isinstance(auto_params(16384), TSP.SparseParams)
    assert isinstance(auto_params(16384, per_link_fidelity=True), TSP.SparseParams)


def test_force_sparse_always_wins():
    assert isinstance(auto_params(1024, per_link_fidelity=True, force_sparse=True), TSP.SparseParams)
    assert isinstance(auto_params(100, force_pview=True), TPV.PviewParams)


def test_config_path_with_overrides():
    cfg = TC.ClusterConfig.default_local()
    p = auto_params(20000, config=cfg, sync_stagger=2, mr_slots=4096)
    assert isinstance(p, TSP.SparseParams)
    assert p.sync_stagger == 2 and p.mr_slots == 4096
    d = auto_params(1024, per_link_fidelity=True, config=cfg)
    assert isinstance(d, TS.SimParams)
    jcfg = JC.ClusterConfig.default_local()
    for args, kw in (((20000,), dict(sync_stagger=2, mr_slots=4096)), ((1024,), dict(per_link_fidelity=True)),
                     ((8192,), dict(link_delay=True, delay_slots=6, fd_every=1)),
                     ((300,), dict(force_pview=True, view_slots=16))):
        ref = dataclasses.asdict(jauto_params(*args, config=jcfg, **kw))
        got = dataclasses.asdict(auto_params(*args, config=cfg, **kw))
        ref.pop("delivery_kernel", None)  # the adaptive spec rides the params and is compared
        assert got == ref, (args, kw)
    # a configured compile-cache directory points the kernel builds there
    # (tests/test_torch_monitor.py holds the redirection)
    from scalecube_cluster_tpu_torch import compile_cache
    from scalecube_cluster_tpu_torch.ops import _build

    keep = _build.BUILD_DIR, compile_cache._enabled_dir
    try:
        with tempfile.TemporaryDirectory() as tmp:
            p = auto_params(64, config=cfg.with_sim(lambda s: s.replace(compile_cache_dir=tmp)))
            assert isinstance(p, TS.SimParams) and _build.BUILD_DIR == pathlib.Path(tmp) / "torch_kernels"
    finally:
        _build.BUILD_DIR, compile_cache._enabled_dir = keep


def test_driver_selects_engine_from_auto_params():
    assert SimDriver(auto_params(2048), 64, device="cpu").engine == "sparse"
    assert SimDriver(auto_params(256, per_link_fidelity=True), 64, device="cpu").engine == "dense"


@pytest.mark.parametrize("profile", ["default_lan", "default_wan", "default_local"])
def test_from_config_matches_jax(profile):
    jcfg = getattr(JC.ClusterConfig, profile)().with_sim(lambda s: s.replace(capacity=300, rumor_slots=8))
    tcfg = getattr(TC.ClusterConfig, profile)().with_sim(lambda s: s.replace(capacity=300, rumor_slots=8))
    tcfg.validate()
    for jcls, tcls, kw in ((JS.SimParams, TS.SimParams, {}), (JSP.SparseParams, TSP.SparseParams, {}),
                           (JPV.PviewParams, TPV.PviewParams, {"mr_slots": 64})):
        for extra in ({}, {"capacity": 500, "seed_rows": (0, 3)}):
            ref = dataclasses.asdict(jcls.from_config(jcfg, **kw, **extra))
            got = dataclasses.asdict(tcls.from_config(tcfg, **kw, **extra))
            ref.pop("delivery_kernel", None)  # the adaptive spec rides the params and is compared
            assert got == ref, (profile, tcls.__name__, extra)
    i16 = TS.SimParams.from_config(tcfg.with_sim(lambda s: s.replace(plane_dtype="i16", delay_slots=4)))
    assert i16.key_dtype == "i16" and i16.delay_slots == 4


def test_from_config_refuses_unported_planes():
    cfg = TC.ClusterConfig.default_lan().with_sim(lambda s: s.replace(capacity=64))
    for cls in (TS.SimParams, TSP.SparseParams, TPV.PviewParams):
        # a dissemination block is ported now: it rides the params
        armed = cls.from_config(cfg.with_dissemination(lambda d: d.replace(strategy="push_pull")))
        assert armed.dissem.strategy == "push_pull"
        # so is the adaptive block
        on = cls.from_config(cfg.with_adaptive(lambda a: a.replace(enabled=True, lh_max=5)))
        assert on.adaptive.enabled and on.adaptive.lh_max == 5
    with pytest.raises(ValueError, match="capacity must be > 1"):
        TS.SimParams.from_config(TC.ClusterConfig.default_lan())
    with pytest.raises(ValueError, match="namespace"):
        cfg.with_membership(lambda m: m.replace(namespace="-bad")).validate()
