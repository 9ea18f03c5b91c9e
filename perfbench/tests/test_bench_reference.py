"""The plain references against the port on the CPU, at test size: every
state leaf and every per-tick metric equal after each cell's own traffic
(its mutation periods shortened so slot reuse, expiry and sweeps fall
inside the ticks compared), on several seeds; the control differs."""

import pytest

from benchhelp import SMALL, config, spec, traffic
from perfbench.harness import cell, digest
from perfbench.harness import traffic as traffic_mod

#: every cell, and the mixes kept for the cells that wait under the open
#: questions (their configuration and traffic files are in place)
CELLS = spec()["workloads"] + [
    {"name": "sparse-100k.steady", "config": "sparse-100k", "traffic": "steady"},
    {"name": "pview-1m.quiet", "config": "pview-1m", "traffic": "quiet"},
]
MIX = {"churn": {"churn": {"per_second": 0.05}}, "steady": {"rumors": {"every": 7}},
       "rumors": {"crash_wave": {"share": 0.05}, "rumors": {"every": 3}}, "quiet": {}}


def run_program(cfg, mix, seed):
    run = cell.Run(cfg, mix, seed, "cpu")
    run.program.start(run.sched.n_up)
    reqs = [run.request() for _ in range(traffic_mod.warm_requests(mix))]
    return digest.state_digest(run.program.leaves()), cell.metric_rows(reqs)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
@pytest.mark.parametrize("c", CELLS, ids=lambda c: c["name"])
def test_reference_equals_the_port(c, seed):
    cfg = config(c["config"], **SMALL[c["config"]])
    mix = traffic(c["traffic"], MIX[c["traffic"]], warm_ticks=40)
    prog_dig, prog_ms = run_program(cfg, mix, seed)
    ref_dig, ref_ms = cell.run_reference(cfg, mix, seed, "cpu", 40)
    assert digest.differing_rows(prog_dig, ref_dig) == {}
    assert cell.differing_values(prog_ms, ref_ms) == (0, [])
    # the check ticks did the work the cell's why names
    tot = {k: sum(float(m[k].sum()) for m in prog_ms) for k in prog_ms[0]}
    assert tot["sync_roundtrips"] > 0 and tot["gossip_msgs"] > 0 and tot["fd_probes"] > 0
    if c["traffic"] in ("churn", "rumors"):
        assert tot["mr_accepts"] > 0 and tot["announced"] > 0 and tot["fd_new_suspects"] > 0
    if c["traffic"] in ("steady", "rumors"):
        assert tot["rumor_deliveries"] > 0


@pytest.mark.parametrize("c", CELLS, ids=lambda c: c["name"])
def test_control_differs(c):
    cfg = config(c["config"], **SMALL[c["config"]])
    mix = traffic(c["traffic"], MIX[c["traffic"]])
    true_dig, true_ms = cell.run_reference(cfg, mix, 5, "cpu", 20)
    ctl_dig, ctl_ms = cell.run_reference(cfg, mix, 5, "cpu", 20, drop_slot=True)
    assert sum(digest.differing_rows(ctl_dig, true_dig).values()) > 0
    assert cell.differing_values(ctl_ms, true_ms)[0] > 0


def test_sparse_reference_under_loss_and_a_small_pool():
    """Refutations, evictions and drops: paths the lossless cells reach
    rarely at test size."""
    cfg = config("sparse-100k", **{**SMALL["sparse-100k"], "loss": 0.2, "mr_slots": 16, "announce_slots": 8})
    mix = traffic("churn", {"churn": {"per_second": 0.03}}, warm_ticks=60)
    prog_dig, prog_ms = run_program(cfg, mix, 9)
    ref_dig, ref_ms = cell.run_reference(cfg, mix, 9, "cpu", 60)
    assert digest.differing_rows(prog_dig, ref_dig) == {}
    assert cell.differing_values(prog_ms, ref_ms) == (0, [])
    tot = {k: sum(float(m[k].sum()) for m in prog_ms) for k in prog_ms[0]}
    assert tot["pool_evicted"] > 0 and tot["announce_dropped"] > 0 and tot["fd_failed_probes"] > 0


@pytest.mark.parametrize("engine", ["sparse", "pview"])
def test_unknown_action_is_refused(engine):
    import importlib

    ref = importlib.import_module(f"perfbench.reference.{engine}")
    with pytest.raises(ValueError):
        ref.apply(None, ("partition", [1, 2]), {})
