"""The port's sparse engine on a member mesh, through a real gloo lane.

Two and four spawned processes (``ops/dcn.py: LocalWorld``, one module-
scoped group each, one thread per rank) run the sparse sharded tick,
window and driver of ``ops/sharding.py``. Each case's trajectory is made
once: the JAX package's single-device window (``make_sparse_run`` or its
fused twin) one tick at a time on its key chain, and the one-process port
on the same draws, held leaf for leaf after every tick. Every rank of the
sharded window must then hold its shard of the one-process port's state
after every tick (by digest, no gather) and JAX's metrics (the two f32 metrics within 2
ulp, as every sparse parity test holds them), with no delivery kernel
launched: with the delay rings, dense links and a partition, the push-pull
leg, a structured strategy, the namespace gate, and small row chunks. The
scenario puts its rumors, crashes, a join and a leave on the rank
boundaries. Held against JAX's ``tests/test_sparse_kernel.py`` (sharded =
one device with churn, rumors and delay), ``test_sparse_chunked.py``
(the blocked apply on a mesh), ``test_dispatch_pipeline.py`` (the word
rule), ``test_telemetry.py`` (the sharded driver's ring) and
``test_obs_mesh.py`` (a static control ladder arms, an adaptive one is
refused).
"""

from __future__ import annotations

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

import _torch_dense_mesh_ranks as DR
import _torch_mesh_ranks as RK
import _torch_sparse_mesh_ranks as SR
import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu.dissemination import DissemSpec
from scalecube_cluster_tpu.ops import sharding as JSH
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import rand as TR
from scalecube_cluster_tpu_torch.ops import sharding as TSH
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from test_torch_dense_mesh import _assert_np_equal
from test_torch_pview_fused import _jax_draws
from test_torch_sparse import _assert_state_equal, _jax_window

torch.set_num_threads(1)

N, N_INITIAL, T, WINDOWS = 256, 248, 6, 3
WATCH = (0, 63, 64, 127, 128, 255)
# the sparse parity tests' knobs, with a 2-tick FD round and a 2-tick sweep
# so that the crashed rows' suspicions expire inside the 18 ticks
_KNOBS = dict(capacity=N, fanout=2, ping_req_k=1, fd_every=2, sync_every=8, suspicion_mult=1, sweep_every=2,
              rumor_slots=4, seed_rows=(0, 1), mr_slots=32, announce_slots=16, full_metrics=True)
_NAMESPACES = ("a", "a/x", "a/y", "b")
# what each case changes: the params, whether the links are [N, N] planes,
# the start's uniform delay, whether JAX's fused window is the reference,
# the case whose trajectory it shares (None: its own) and the row chunks'
# size in the sharded run
CASES = {
    # JAX test_sparse_kernel.py's sharded case (churn, rumors, the delay
    # rings) with [N, N] link planes: their cells at other members' rows,
    # a partition and its heal
    "delay": (dict(delay_slots=3), True, 0.7, False, None, None),
    "push_pull": (dict(dissem=DissemSpec(strategy="push_pull")), True, 0.0, True, None, None),
    # structured peer selection over all N rows, each rank keeping its rows'
    # picks (the deterministic chords), on scalar links
    "ring": (dict(dissem=DissemSpec(strategy="accelerated", topology="ring")), False, 0.0, False, None, None),
    # the membership apply's and SYNC's gates on the gathered namespace ids,
    # with JAX's blocked apply
    "namespaces": (dict(namespace_gate=True, apply_block=64), True, 0.0, True, None, None),
    # JAX test_sparse_chunked.py's blocked run on a mesh: the delay case's
    # trajectory over row chunks of 16 rows
    "chunks": (dict(delay_slots=3), True, 0.7, False, "delay", 16 * N),
}
_MUST_RUN = ("mr_accepts", "sync_roundtrips", "fd_new_suspects", "rumor_deliveries", "announced")


@pytest.fixture(scope="module")
def lane2():
    with dcn.LocalWorld(2, "cpu") as lw:
        yield lw


@pytest.fixture(scope="module")
def lane4():
    with dcn.LocalWorld(4, "cpu") as lw:
        yield lw


def _lane(request, world: int):
    return request.getfixturevalue(f"lane{world}")


def _start(mod, params, dense_links: bool, delay: float, **kw):
    if params.namespace_gate:
        kw["namespaces"] = [_NAMESPACES[r % 4] for r in range(params.capacity)]
    st = mod.init_sparse_state(params, N_INITIAL, warm=True, dense_links=dense_links, uniform_loss=0.05,
                               uniform_delay=delay, **kw)
    st = mod.spread_rumor(st, 0, 127)
    st = mod.spread_rumor(st, 1, 128)
    st = mod.crash_rows(st, [63, 64, 191])
    return mod.begin_leave(st, 129)


def _mutations(params, dense_links: bool) -> dict:
    """The host mutations before each window, on the 2- and 4-rank
    boundaries: the churn batch (a crashed row rejoins as a new identity
    with two fresh rows, a leave, metadata bumps, a rumor) and, with link
    planes, a partition of the halves healed a window later."""
    out = {1: [("crash_rows", ([127],)), ("join_rows", ([63, N - 3, N - 2], params.seed_rows)),
               ("begin_leave", (192,)), ("update_metadata", (65,)), ("update_metadata", (65,)),
               ("spread_rumor", (2, 190))]}
    if dense_links:
        halves = (list(range(0, N // 2)), list(range(N // 2, N)))
        out[1].append(("block_partition", halves))
        out[2] = [("heal_partition", halves)]
    return out


@functools.lru_cache(maxsize=None)
def _trajectory(case: str):
    """The case's JAX window, one tick at a time on its key chain, and the
    one-process port on the same draws, held leaf for leaf after every tick
    and every host mutation. Returns the port's params, its start, the
    mutations, the per-window draws, the digests of each rank's shard of
    the port's state after every tick (``{world: [rank digests]}``), its
    watched rows, and JAX's per-window metrics."""
    over, dense_links, delay, fused, _shared, _cells = CASES[case]
    params = JSP.SparseParams(**{**_KNOBS, **over})
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = _start(JSP, params, dense_links, delay)
    tst = _start(TSP, tparams, dense_links, delay, device="cpu")
    _assert_state_equal(jst, tst, f"{case}: the start")
    start_np = {k: v.copy() for k, v in convert.state_to_numpy(tst).items()}
    mutate = _mutations(params, dense_links)
    key = jax.random.PRNGKey(7)
    watch = torch.tensor(WATCH)
    draws, digests, watched, jax_metrics = [], [], [], []
    for w in range(WINDOWS):
        for name, args in mutate.get(w, ()):
            jst, tst = getattr(JSP, name)(jst, *args), getattr(TSP, name)(tst, *args)
        _assert_state_equal(jst, tst, f"{case}: the mutations before window {w}")
        w_draws, w_dig, w_seen, w_ms = [], [], [], []
        for t in range(T):
            jst, key_after, jm, _ = _jax_window(params, fused)(jst, key)
            key, dr = _jax_draws(key, 1, params)
            assert np.array_equal(np.asarray(key), np.asarray(key_after))
            tst, _, seen = TSP.run_sparse_ticks(tst, dr, 1, tparams, watch)
            _assert_state_equal(jst, tst, f"{case}: window {w}, tick {t + 1}, one process against JAX")
            w_draws.append(dr[0])
            w_dig.append(_rank_digests(convert.state_to_numpy(tst)))
            w_seen.append(seen.numpy())
            w_ms.append(jm)
        draws.append(w_draws)
        digests.append(w_dig)
        watched.append(np.concatenate(w_seen))
        jax_metrics.append({k: np.concatenate([np.asarray(m[k]) for m in w_ms]) for k in w_ms[0]})
    vk = np.asarray(jst.view_key)
    return types.SimpleNamespace(params=tparams, start=start_np, mutate=mutate, draws=draws, digests=digests,
                                 watched=watched, metrics=jax_metrics, dead=int(((vk >= 0) & (vk & 3 == 3)).sum()))


def _rank_digests(state_np: dict) -> dict:
    """``{world: [digest of rank r's shard]}`` for W = 2 and 4: each rank's
    rows of the member-axis leaves (the rings' on dim 1), the rest whole,
    as ``sparse_state_shardings`` places them."""
    tags = TSH.sparse_state_shardings(None, state_np["loss"].ndim != 0, state_np["pending_minf"].shape[0])
    out = {}
    for world in (2, 4):
        L = N // world
        out[world] = []
        for lo in range(0, N, L):
            out[world].append(SR.digest({
                k: v if getattr(tags, k) is TSH.REPLICATED else v[lo:lo + L] if getattr(tags, k) == TSH.ROW
                else v[:, lo:lo + L] for k, v in state_np.items()}))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_window_matches_one_process_and_jax(lane2, lane4, case):
    """Three sharded windows of 6 ticks at W = 2 and at W = 4, the churn
    batch (and the partition) before the second: after every tick each
    rank's shard equals its rows of the one-process port's state (by
    digest), which equals JAX's single-device window's on the key chain
    that drew it (made once for both worlds); every rank's metrics equal
    JAX's, its watched rows the one-process port's; no delivery kernel
    launches."""
    shared, cells = CASES[case][4:]
    ref = _trajectory(shared or case)
    for world, lane in ((2, lane2), (4, lane4)):
        _hold_ranks(case, world, ref, lane.run(SR.window, ref.params, ref.start, ref.draws, T, WATCH, ref.mutate,
                                               cells))
    busy = {k: sum(int(m[k].sum()) for m in ref.metrics) for k in _MUST_RUN}
    assert all(v > 0 for v in busy.values()) and ref.dead > 0, (busy, ref.dead)


def _hold_ranks(case: str, world: int, ref, got: list) -> None:
    for r, rank in enumerate(got):
        assert rank["rows"] == (N // world, N) and rank["launches"] == 0, (r, rank["rows"], rank["launches"])
        for w in range(WINDOWS):
            label = f"{case}, W = {world}, rank {r}, window {w}"
            rw = rank["windows"][w]
            for t in range(T):
                for k, want in ref.digests[w][t][world][r].items():
                    assert rw["digests"][t][k] == want, f"{label}, tick {t + 1}: {k} diverged"
            _assert_np_equal(ref.metrics[w], rw["metrics"], f"{label}: metrics against JAX", ulp_floats=True)
            assert np.array_equal(ref.watched[w], rw["watched"]), f"{label}: watched rows"


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_tick_matches_one_process(request, world):
    """``make_sharded_sparse_tick`` stepped tick by tick (JAX's sharded tick
    test): each rank holds [L, N] rows, and every state and metric equals
    the one-process tick's on the same draws."""
    params = TSP.SparseParams(capacity=128, fd_every=1, sweep_every=2, sync_every=4, suspicion_mult=1,
                              rumor_slots=2, mr_slots=16, announce_slots=8, seed_rows=(0,), full_metrics=True)
    st = TSP.crash_row(TSP.spread_rumor(TSP.init_sparse_state(params, 120, device="cpu"), 0, 64), 63)
    start_np = {k: v.copy() for k, v in convert.state_to_numpy(st).items()}
    gen = torch.Generator().manual_seed(1)
    draws = [TR.draw_sparse_tick(gen, params, True) for _ in range(8)]
    got = _lane(request, world).run(SR.ticks, params, start_np, draws)
    for t, (fd, rd) in enumerate(draws):
        st, ms = TSP.sparse_tick(st, fd, rd, params)
        ref, ref_ms = convert.state_to_numpy(st), {k: v.numpy() for k, v in ms.items()}
        for r, rank in enumerate(got):
            for k, v in ref.items():
                assert np.array_equal(v, rank["ticks"][t]["state"][k]), (t + 1, r, k)
            for k, v in ref_ms.items():
                assert np.array_equal(v, rank["ticks"][t]["metrics"][k]), (t + 1, r, k)
    assert st.tick == 8 and all(rank["rows"] == (128 // world, 128) for rank in got)


def test_alignment_rules_raise_jax_value_errors(lane4):
    """The capacity rule (capacity % W) and the word rule (capacity %
    32·W) raise JAX's own ValueErrors (its ``_check_sparse_word_alignment``
    asked with a 4-device mesh's size); an aligned capacity builds."""
    cases = [("rows", TSP.SparseParams(capacity=30)), ("words", TSP.SparseParams(capacity=64)),
             ("aligned", TSP.SparseParams(capacity=128))]
    want = {}
    for label, params in cases:
        try:
            JSH._check_sparse_word_alignment(types.SimpleNamespace(size=4), params)
            want[label] = ("none", "")
        except ValueError as exc:
            want[label] = ("ValueError", str(exc))
    assert want["rows"][0] == want["words"][0] == "ValueError" and want["aligned"] == ("none", "")
    for rank in lane4.run(SR.alignment, cases):
        for label, _ in cases:
            for what in ("run", "tick"):
                assert rank[(label, what)] == want[label], (label, what, rank[(label, what)])


_DRIVER_PARAMS = TSP.SparseParams(capacity=128, fd_every=2, sync_every=8, suspicion_mult=2, sweep_every=4,
                                  rumor_slots=2, mr_slots=16, announce_slots=8, seed_rows=(0, 1))
_DRIVER_WORLDS = [2, pytest.param(4, marks=pytest.mark.slow)]


@pytest.mark.parametrize("world", _DRIVER_WORLDS)
def test_sharded_driver_matches_unsharded(request, world):
    """The driver script (rumors, a crash wave, a join, a leave, a metadata
    bump, a partition healed, watched rows) on a sharded sparse driver with
    [N, N] link planes and the telemetry plane armed: the whole state, events, views, statuses,
    coverage, health, readbacks and the telemetry ring equal the unsharded
    driver's; no delivery kernel is launched."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    n = _DRIVER_PARAMS.capacity
    got = _lane(request, world).run(RK.sharded_driver, _DRIVER_PARAMS, n, "none", dense_links=True)
    d = SimDriver(_DRIVER_PARAMS, n - 8, seed=3, device="cpu", dense_links=True)
    d.arm_telemetry()
    RK.driver_script(d, n)
    ref = RK.driver_record(d, n)
    assert len(ref["telemetry"]) == 5
    for r, rank in enumerate(got):
        assert rank.pop("launches") == 0
        for k, v in ref["state"].items():
            assert np.array_equal(v, rank["state"][k]), (r, k)
        for k in ref:
            if k != "state":
                assert rank[k] == ref[k], (r, k)


@pytest.mark.parametrize("world", _DRIVER_WORLDS)
def test_sharded_driver_scenario_checkpoint_profile_control(request, world, tmp_path):
    """On a sharded sparse driver: ``run_scenario`` (a crash on a rank
    boundary and a partition healed) gives the unsharded driver's report,
    telemetry ring and final state; a checkpoint round trip (and a restore
    of the unsharded driver's archive) continues as the unsharded driver
    does; ``profile_ticks(mesh=)`` times the sparse tick's phases and ends
    on the sharded window's state; a static control ladder arms and steps
    as on the unsharded driver."""
    from scalecube_cluster_tpu_torch.chaos.events import Crash, Partition, Scenario
    from scalecube_cluster_tpu_torch.control import ControlSpec
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.trace import profile as PR

    lane = _lane(request, world)
    p, n = _DRIVER_PARAMS, _DRIVER_PARAMS.capacity
    scenario = Scenario(name="mesh-sparse", horizon=24, check_interval=4, events=[
        Crash(rows=[n // 2 - 1, n // 4], at=2),
        Partition(groups=[range(0, n // 2), range(n // 2, n - 8)], at=4, heal_at=12)])
    # [N, N] link planes: the partition writes them
    ref = DR.scenario_report(p, n - 8, 5, scenario, sharded=False, dense_links=True)
    for r, rank in enumerate(lane.run(DR.scenario_report, p, n - 8, 5, scenario, dense_links=True)):
        assert rank["report"] == ref["report"], r
        assert rank["ring"] == ref["ring"] and rank["windows"] == ref["windows"] >= 2, r
        for k, v in ref["state"].items():
            assert np.array_equal(v, rank["state"][k]), (r, k)

    foreign = str(tmp_path / "unsharded.npz")
    u = SimDriver(p, n - 8, seed=4, device="cpu")
    u.step(3)
    u.checkpoint(foreign)
    path = str(tmp_path / "sharded.npz")
    got = lane.run(RK.checkpoint_run, p, n - 8, 4, path, foreign, 3)
    u.step(3)
    for r, rank in enumerate(got):
        for k, v in rank["ahead"].items():
            assert np.array_equal(v, rank["again"][k]), (r, k, "the restore continues as before")
        for k, v in convert.state_to_numpy(u.state).items():
            assert np.array_equal(v, rank["foreign"][k]), (r, k, "the unsharded archive")

    st = TSP.spread_rumor(TSP.init_sparse_state(p, n - 8, device="cpu"), 0, n // 2)
    start_np = {k: v.copy() for k, v in convert.state_to_numpy(st).items()}
    _, unsharded = PR.profile_ticks(p, st, torch.Generator().manual_seed(9), 3, warmup_ticks=1)
    assert {"fd", "suspicion", "gossip", "sync", "refute", "sweep", "alloc"} <= set(unsharded["phases_s"])
    for rank in lane.run(DR.profile_window, p, start_np, 9, 3, 1):
        assert rank["engine"] == "sparse" and rank["ticks"] == 3 and rank["mesh"] == {"members": world}
        assert rank["phases"] == sorted(unsharded["phases_s"])
        for k, v in rank["window"].items():
            assert np.array_equal(v, rank["profiled"][k]), (k, "the profiled ticks against the sharded window")

    # JAX test_obs_mesh.py: a static-rung ladder arms on a sparse mesh
    spec = ControlSpec(epoch_windows=1)
    spec = dataclasses.replace(spec, ladder=tuple(dataclasses.replace(r, adaptive=False) for r in spec.ladder))
    ref = RK.control_run(p, n - 8, 6, spec, 4, 3, sharded=False)
    for r, rank in enumerate(lane.run(RK.control_run, p, n - 8, 6, spec, 4, 3)):
        assert rank["history"] == ref["history"] and rank["params"] == ref["params"], r
        assert rank["log"] == ref["log"] and rank["rung"] == ref["rung"], r
        for k, v in ref["state"].items():
            assert np.array_equal(v, rank["state"][k]), (r, k, "control state")


def test_sharded_sparse_flight_dump_carries_mesh_axes_and_replays(lane2, tmp_path):
    """A sharded sparse driver's flight dump after a scenario: every rank
    writes the same reconstruction, stamped with the mesh, and it rebuilds
    an unsharded incident that replays to the recorded verdict."""
    from scalecube_cluster_tpu_torch.chaos.events import Crash, Scenario
    from scalecube_cluster_tpu_torch.replay import incident_from_flight
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.telemetry.flight import load_flight_dump

    p, n = _DRIVER_PARAMS, _DRIVER_PARAMS.capacity
    scenario = Scenario(name="mesh-sparse-crash", events=[Crash(rows=[n // 2], at=4)], horizon=24,
                        check_interval=8)
    docs = [load_flight_dump(rank["armed"]) for rank in lane2.run(RK.flight_run, p, n - 8, 21, str(tmp_path),
                                                                  scenario)]
    for dump in docs:
        assert dump["reconstruction"]["mesh_axes"] == {"members": 2}
        inc = incident_from_flight(dump)
        assert inc.engine == "sparse" and inc.seed == 21 and inc.params == p
    assert docs[0]["reconstruction"] == docs[1]["reconstruction"]
    inc = incident_from_flight(docs[0])
    rep = SimDriver(inc.params, n - 8, seed=inc.seed, device="cpu").run_scenario(scenario, max_window=8)
    assert docs[0]["reconstruction"]["verdict"]["ok"] == rep["ok"]


def test_sharded_driver_refuses_what_jax_refuses(lane2):
    """JAX's sparse engine registers no sharded adaptive or traced window:
    on a sparse mesh an adaptive spec, ``set_adaptive``, the trace plane and
    an adaptive control ladder raise JAX's ValueErrors."""
    for rank in lane2.run(SR.refusals, _DRIVER_PARAMS):
        assert rank["adaptive spec"][0] == "ValueError"
        assert "adaptive failure detection is single-device for the sparse engine" in rank["adaptive spec"][1]
        assert rank["set_adaptive"] == ("ValueError",
                                        "adaptive failure detection is single-device for the sparse engine")
        assert rank["trace capture"][0] == "ValueError"
        assert "trace capture is single-device for the sparse engine" in rank["trace capture"][1]
        assert rank["adaptive ladder"][0] == "ValueError" and "make_sharded_adaptive_run" in rank[
            "adaptive ladder"][1]


def test_audit_sparse_sharded_programs_clean(lane2):
    """The audit's three sparse member-mesh programs (JAX's names) on two
    gloo ranks: every contract clean on every rank."""
    from _torch_audit_ranks import sharded_verdict

    names = {"sparse/i32/sharded", "sparse/i32/sharded-telemetry-row", "sparse/i32/sharded-telemetry-append"}
    for verdict in lane2.run(sharded_verdict, None, ("i32",), "sparse"):
        assert verdict["ok"], verdict
        assert {e["program"] for e in verdict["programs"]} == names
        assert all(e["mesh_size"] == 2 for e in verdict["programs"])
