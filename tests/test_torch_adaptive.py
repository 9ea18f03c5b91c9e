"""The PyTorch port's adaptive plane (``adaptive.py``) against the JAX
package's, piece by piece: ``bit_length``, ``conf_mult_num`` (both
endpoints), ``fold`` (supersede and saturate), ``scaled_timely_rt``
(``t_base = 0``, ``lh`` across ``0..lh_max``, loss-free and near-one f32
delays), the spec's validation and config seam, the checkpoint views and
the converters, the seams of every engine (a default spec refuses the
adaptive window and the adaptive tick), and the window gauges. Inputs come
from numpy seeds; every comparison is bit-exact.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu import adaptive as JA
from scalecube_cluster_tpu import config as JC
from scalecube_cluster_tpu.ops import kernel as JK
from scalecube_cluster_tpu_torch import adaptive as TA
from scalecube_cluster_tpu_torch import config as TC
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import engine_api
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS

torch.set_num_threads(1)

SPECS = (
    dict(enabled=True),
    dict(enabled=True, lh_max=4, min_mult=2, max_mult=6, conf_target=3),
    dict(enabled=True, lh_max=0, min_mult=1, max_mult=1, conf_target=1),
    dict(enabled=True, lh_max=8, min_mult=5, max_mult=10, conf_target=4),
    dict(enabled=True, lh_max=2, min_mult=3, max_mult=9, conf_target=7),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bit_length_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.arange(70), rng.integers(0, 1 << 30, 500), [(1 << 31) - 1]]).astype(np.int32)
    got = TA.bit_length(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(JA.bit_length(jnp.asarray(x))))
    assert np.array_equal(got, np.array([int(v).bit_length() for v in x], np.int32))
    # any shape
    x2 = x[:64].reshape(8, 8)
    assert np.array_equal(TA.bit_length(_t(x2)).numpy(), np.asarray(JA.bit_length(jnp.asarray(x2))))


@pytest.mark.parametrize("kw", SPECS)
def test_conf_mult_num_matches_jax_at_both_endpoints(kw):
    jspec, tspec = JA.AdaptiveSpec(**kw), TA.AdaptiveSpec(**kw)
    assert tspec.levels == jspec.levels and tspec.is_default == jspec.is_default
    conf = np.arange(0, 3 * tspec.conf_target + 2, dtype=np.int32)
    got = TA.conf_mult_num(tspec, _t(conf))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JA.conf_mult_num(jspec, jnp.asarray(conf))))
    L = tspec.levels
    # a lone accusation: max_mult; fully corroborated: exactly min_mult
    assert int(got[0]) == tspec.max_mult * L
    assert int(got[tspec.conf_target]) == tspec.min_mult * L
    assert (got[tspec.conf_target:] == tspec.min_mult * L).all()
    for c in conf:
        assert TA.conf_mult_num_scalar(tspec, int(c)) == JA.conf_mult_num_scalar(jspec, int(c))


def _fold_inputs(seed: int, n: int, spec):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-8, 60, n).astype(np.int32) * 4 + 2  # SUSPECT-rank keys
    no = np.iinfo(np.int32).min
    return dict(
        lh=rng.integers(0, spec.lh_max + 1, n).astype(np.int32),
        conf_key=np.where(rng.random(n) < 0.3, no, keys).astype(np.int32),
        conf=rng.integers(0, spec.conf_target + 1, n).astype(np.int32),
        acc_key=np.where(rng.random(n) < 0.4, no, keys + 4 * rng.integers(-2, 3, n)).astype(np.int32),
        acc_cnt=rng.integers(0, 2 * spec.conf_target + 1, n).astype(np.int32),
        miss=rng.random(n) < 0.4,
        succ=rng.random(n) < 0.4,
        refuted=rng.random(n) < 0.2,
        up=rng.random(n) < 0.85,
    )


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kw", SPECS[1:4])
def test_fold_matches_jax_with_supersede_and_saturate(kw, seed):
    jspec, tspec = JA.AdaptiveSpec(**kw), TA.AdaptiveSpec(**kw)
    inp = _fold_inputs(seed, 257, tspec)
    ref = JA.fold(jspec, inp["lh"], inp["conf_key"], inp["conf"],
                  **{k: jnp.asarray(v) for k, v in inp.items() if k not in ("lh", "conf_key", "conf")})
    got = TA.fold(tspec, _t(inp["lh"]), _t(inp["conf_key"]), _t(inp["conf"]),
                  **{k: _t(v) for k, v in inp.items() if k not in ("lh", "conf_key", "conf")})
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(r))
    lh2, ck2, cf2 = (g.numpy() for g in got)
    supersede = inp["acc_key"] > inp["conf_key"]
    # both paths of the episode fold are exercised
    assert supersede.any() and (~supersede).any()
    assert (cf2[supersede] == np.minimum(inp["acc_cnt"][supersede], tspec.conf_target)).all()
    assert (cf2 == tspec.conf_target).any() and (cf2 <= tspec.conf_target).all()
    assert (lh2[~inp["up"]] == 0).all() and (lh2 <= tspec.lh_max).all() and (lh2 >= 0).all()
    assert (ck2 >= inp["conf_key"]).all()


@pytest.mark.parametrize("t_base", [0, 1, 2, 3])
@pytest.mark.parametrize("lh_max", [0, 3, 8])
def test_scaled_timely_rt_matches_jax(t_base, lh_max):
    rng = np.random.default_rng(10 * t_base + lh_max)
    n = 300
    q1 = rng.random(n, dtype=np.float32) * np.float32(0.9)
    q2 = rng.random(n, dtype=np.float32)
    # no delay, the tiniest delays, and delays one ulp below certainty
    special = np.array([0.0, 0.0, 1e-7, np.float32(1) - np.float32(2 ** -24), 0.5, 0.99], np.float32)
    q1[: special.size] = special
    q2[: special.size] = special[::-1]
    q2[0] = 0.0
    lh = (np.arange(n) % (lh_max + 3)).astype(np.int32) - 1  # clamped ends included
    ref = np.asarray(JA.scaled_timely_rt(jnp.asarray(q1), jnp.asarray(q2), t_base, jnp.asarray(lh), lh_max))
    got = TA.scaled_timely_rt(_t(q1), _t(q2), t_base, _t(lh), lh_max)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    if t_base:
        # each row's capture is the static recurrence at t_base * (1 + lh)
        for i in (0, 5, 7, 11):
            steps = t_base * (1 + min(max(int(lh[i]), 0), lh_max))
            one = TK._timely_rt(_t(q1[i : i + 1]), _t(q2[i : i + 1]), steps)
            assert one.numpy().view(np.int32)[0] == ref.view(np.int32)[i]
        assert got[0] == 1.0  # no delay: always timely


def test_spec_validation_and_config_seam():
    for bad in (dict(lh_max=-1), dict(min_mult=0), dict(min_mult=6, max_mult=5), dict(conf_target=0)):
        with pytest.raises(ValueError):
            TA.AdaptiveSpec(**bad)
        with pytest.raises(ValueError):
            JA.AdaptiveSpec(**bad)
    assert TA.DEFAULT.is_default and TA.AdaptiveSpec(enabled=True).levels == 3
    assert hash(TA.AdaptiveSpec(enabled=True)) == hash(TA.AdaptiveSpec(enabled=True))
    for profile in ("default_lan", "default_wan", "default_local"):
        tcfg = getattr(TC.ClusterConfig, profile)().with_adaptive(
            lambda a: a.replace(enabled=True, lh_max=6, conf_target=5))
        jcfg = getattr(JC.ClusterConfig, profile)().with_adaptive(
            lambda a: a.replace(enabled=True, lh_max=6, conf_target=5))
        assert dataclasses.asdict(TA.AdaptiveSpec.from_config(tcfg)) == \
            dataclasses.asdict(JA.AdaptiveSpec.from_config(jcfg))
        assert TA.AdaptiveSpec.from_config(getattr(TC.ClusterConfig, profile)()).is_default
    assert TA.AdaptiveSpec.from_config(object()).is_default
    bad_cfg = TC.ClusterConfig.default_lan().with_adaptive(lambda a: a.replace(min_mult=0))
    with pytest.raises(ValueError):
        bad_cfg.validate()


def test_state_views_and_converters():
    n = 37
    rng = np.random.default_rng(4)
    arrays = {k: rng.integers(-5, 50, n).astype(np.int32) for k in ("lh", "conf_key", "conf")}
    ad = convert.adaptive_from_numpy(arrays, device="cpu")
    back = convert.adaptive_to_numpy(ad)
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)
    arrays["lh"][0] = 99  # the plane is a copy, not an alias
    assert int(ad.lh[0]) != 99
    ck = TA.adaptive_state_arrays(ad)
    assert set(ck) == {"_ad_lh", "_ad_conf_key", "_ad_conf"}
    again = TA.restore_adaptive_state(ck, device="cpu")
    assert all(torch.equal(getattr(again, k), getattr(ad, k)) for k in ("lh", "conf_key", "conf"))
    fresh, jfresh = TA.init_adaptive_state(n, device="cpu"), JA.init_adaptive_state(n)
    for k in ("lh", "conf_key", "conf"):
        v = getattr(fresh, k)
        assert v.dtype == torch.int32 and np.array_equal(v.numpy(), np.asarray(getattr(jfresh, k)))


@pytest.mark.parametrize("engine", ["dense", "sparse", "pview"])
def test_default_spec_keeps_the_static_window(engine):
    cls = {"dense": TS.SimParams, "sparse": TSP.SparseParams, "pview": TPV.PviewParams}[engine]
    params = cls(capacity=40)
    eng = engine_api.resolve(params)
    assert params.adaptive.is_default
    with pytest.raises(ValueError, match="default"):
        eng.make_adaptive_run(params, 1)
    with pytest.raises(ValueError, match="default"):
        eng.make_fused_adaptive_run(params, 1)
    armed = dataclasses.replace(params, adaptive=TA.AdaptiveSpec(enabled=True))
    assert callable(eng.make_adaptive_run(armed, 1))
    # the static window takes no adaptive plane and returns no gauges
    st = eng.init_state(params, 40, True, False, "cpu")
    gen = torch.Generator().manual_seed(0)
    st, ms, _ = eng.make_run(params, 3)(st, gen)
    assert "adaptive_lh_high" not in ms and not any(k.startswith("_ad_") for k in ms)
    ad = TA.init_adaptive_state(40, device="cpu")
    st, ad, ms, _ = eng.make_adaptive_run(armed, 3)(st, ad, gen)
    assert ms["adaptive_lh_high"].shape == (3,) and not any(k.startswith("_ad_") for k in ms)


def test_adaptive_gauges_match_the_jax_series():
    rng = np.random.default_rng(1)
    ms = {"adaptive_lh_high": rng.integers(0, 9, 7).astype(np.int32),
          "adaptive_conf_high": rng.integers(0, 5, 7).astype(np.int32)}
    got = TK.adaptive_gauges({k: _t(v) for k, v in ms.items()})
    names = JK.TELEMETRY_SERIES
    assert tuple(got) == names[-2:]
    for name, k in zip(names[-2:], ms):
        assert got[name].dtype == torch.float32 and float(got[name]) == float(ms[k].max())
    # a static window's gauges read 0, as the JAX series does
    assert all(float(v) == 0.0 for v in TK.adaptive_gauges({}).values())
