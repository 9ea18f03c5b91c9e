"""The Monte Carlo half of the port's certifier against the JAX package's.

``certify_spread_mc`` and ``fp_rate_mc`` run S seeds as one fleet
(``scalecube_cluster_tpu_torch/dissemination/certify.py``). Fed the JAX
fleet's per-row key chains through ``draws=``, the port's record equals the
JAX record (every key the two share: the histogram, the quantiles and their
intervals, the Wilson interval, the verdict), and its per-seed results equal
those of the JAX fleet loop the JAX service runs:

* ``certify_spread_mc``: the per-seed ticks to full coverage, for one dense
  cell (push/full) and one pview cell (push/expander), 3 seeds at N = 33;
* ``fp_rate_mc``: the per-seed false-DEAD maxima and detection ticks, both
  arms, 3 seeds at N = 48 over a shortened horizon.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.dissemination.certify as JC
from scalecube_cluster_tpu.dissemination.spec import DissemSpec as JSpec
from scalecube_cluster_tpu.ops import fleet as JFL
from scalecube_cluster_tpu_torch.dissemination import certify as TC
from scalecube_cluster_tpu_torch.dissemination.spec import DissemSpec as TSpec
from test_torch_dense import dense_draws
from test_torch_fleet import FleetChain
from test_torch_pview_fused import _jax_draws

torch.set_num_threads(1)

N_SPREAD = 33
N_SEEDS = 3  # below the 8 virtual devices: the JAX service runs its unsharded fleet


def _jax_spread_ticks(spec, engine: str, n: int, n_seeds: int, window: int = 32) -> list:
    """The JAX service's fleet loop (``certify_spread_mc``), per-seed."""
    import dataclasses

    bound = JC.theory_bound(spec, n, 3, 8)
    max_ticks = 4 * bound["bound_ticks"] + 4 * window
    params, base, ops_mod = JC._SETUPS[engine](spec, n, 3, 8)
    if hasattr(params, "quiet_gates"):
        params = dataclasses.replace(params, quiet_gates=False)
    step = JFL.make_fleet_run(params, window)
    seeds = np.arange(n_seeds)
    fs = JFL.fleet_inject_rumor(ops_mod, JFL.fleet_broadcast(base(), n_seeds), 0, (seeds * 37 + 1) % n)
    keys = JFL.fleet_keys(1000 + seeds)
    hit = jnp.full((n_seeds,), -1, jnp.int32)
    for w0 in range(0, max_ticks, window):
        fs, keys, ms, _w = step(fs, keys)
        hit = JFL.fold_first_full_coverage(hit, ms["rumor_coverage"][:, :, 0], w0)
        if bool((hit >= 0).all()):
            break
    return [int(t) for t in np.asarray(hit)]


def _assert_records_equal(jrec: dict, trec: dict, label: str):
    shared = set(jrec) & set(trec)
    assert len(shared) >= len(jrec) - 1, f"{label}: keys missing from the port's record: {set(jrec) - set(trec)}"
    for k in sorted(shared):
        assert jrec[k] == trec[k], f"{label}: {k}: JAX {jrec[k]!r}, port {trec[k]!r}"


@pytest.mark.parametrize("strategy,topology,engine", [("push", "full", "dense"), ("push", "expander", "pview")])
def test_certify_spread_mc_matches_jax(strategy, topology, engine):
    jspec = JSpec(strategy=strategy, topology=topology)
    tspec = TSpec(strategy=strategy, topology=topology)
    params, _base, _ops = JC._SETUPS[engine](jspec, N_SPREAD, 3, 8)
    chain = FleetChain(JFL.fleet_keys(1000 + np.arange(N_SEEDS)), params,
                       dense_draws if engine == "dense" else _jax_draws)
    trec = TC.certify_spread_mc(tspec, n=N_SPREAD, n_seeds=N_SEEDS, engine=engine, device="cpu", draws=chain)
    jrec = JC.certify_spread_mc(jspec, n=N_SPREAD, n_seeds=N_SEEDS, engine=engine)
    assert jrec["fleet_devices"] == 1
    _assert_records_equal(jrec, trec, f"{engine}/{strategy}/{topology}")
    assert trec["per_seed_ticks"] == _jax_spread_ticks(jspec, engine, N_SPREAD, N_SEEDS)
    assert trec["finished"] == N_SEEDS and trec["verdict_kind"] == "spot-check"


FP_KW = dict(n=48, n_seeds=N_SEEDS, window=8, until=36, horizon=48, crash_at=20, loss_floor=0.10)


def _jax_fp_per_seed(adaptive: bool) -> tuple:
    """The JAX service's fleet loop (``fp_rate_mc``), per-seed."""
    from scalecube_cluster_tpu.adaptive import AdaptiveSpec, init_adaptive_state
    from scalecube_cluster_tpu.chaos import events as ev
    from scalecube_cluster_tpu.ops import state as S

    kw = FP_KW
    knobs = dict(min_mult=5, max_mult=10, conf_target=4, lh_max=8)
    spec = AdaptiveSpec(enabled=True, **knobs) if adaptive else AdaptiveSpec()
    params = S.SimParams(capacity=kw["n"], fd_every=1, sync_every=40, suspicion_mult=3, rumor_slots=8,
                         seed_rows=(0,), full_metrics=False, adaptive=spec, quiet_gates=False)
    c = JC.FP_MC_COHORT
    scen = ev.Scenario(name="loss_adversarial_mc_r15", events=(
        ev.AsymmetricLoss(rows=list(c["asym_rows"]), pct=70.0, at=4, until=kw["until"], direction="in"),
        ev.FlakyObserver(rows=list(c["flaky_rows"]), pct=70.0, at=4, until=kw["until"]),
        ev.Crash(rows=[c["crash_row"]], at=kw["crash_at"]),
    ), horizon=kw["horizon"])
    s = kw["n_seeds"]
    fs = JFL.fleet_uniform_loss(S, JFL.fleet_broadcast(S.init_state(params, kw["n"], warm=True), s),
                                np.full(s, kw["loss_floor"], np.float32))
    keys = JFL.fleet_keys(np.arange(s))
    ad = JFL.fleet_broadcast(init_adaptive_state(kw["n"]), s) if adaptive else None
    tl = JFL.fleet_timeline(scen, S, dense_links=True, horizon=kw["horizon"])
    watch = np.zeros(kw["n"], bool)
    watch[list(c["asym_rows"]) + list(c["flaky_rows"])] = True
    fp_max = jnp.zeros((s,), jnp.int32)
    det_tick = jnp.full((s,), -1, jnp.int32)
    bounds = set(tl.boundaries())
    t = 0
    while t < kw["horizon"]:
        fs, _ = tl.apply_due(fs, t)
        stop = min(x for x in [kw["horizon"], t + kw["window"]] + [b for b in bounds if b > t] if x > t)
        if adaptive:
            fs, ad, keys, _m, _w = JFL.make_fleet_adaptive_run(params, stop - t)(fs, ad, keys)
        else:
            fs, keys, _m, _w = JFL.make_fleet_run(params, stop - t)(fs, keys)
        t = stop
        fp_max = jnp.maximum(fp_max, JFL.fleet_false_dead(fs, jnp.asarray(watch)))
        if t > kw["crash_at"]:
            det = JFL.fleet_crash_detected(fs, c["crash_row"])
            det_tick = jnp.where((det_tick < 0) & det, jnp.int32(t), det_tick)
    return [int(x) for x in np.asarray(fp_max)], [int(x) for x in np.asarray(det_tick)], params


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_fp_rate_mc_matches_jax(adaptive):
    fp_ref, det_ref, params = _jax_fp_per_seed(adaptive)
    chain = FleetChain(JFL.fleet_keys(np.arange(N_SEEDS)), params, dense_draws)
    trec = TC.fp_rate_mc(adaptive=adaptive, device="cpu", draws=chain, **FP_KW)
    assert trec["per_seed_fp_max"] == fp_ref
    assert trec["per_seed_det_tick"] == det_ref
    jrec = JC.fp_rate_mc(adaptive=adaptive, **FP_KW)
    _assert_records_equal(jrec, trec, f"fp_rate_mc {'adaptive' if adaptive else 'static'}")
    assert trec["arm"] == ("adaptive" if adaptive else "static")
