"""A run with the timed path broken underneath reads ``correct`` false:
the whole run's flow on the CPU at test size (the look for a card
skipped), the port's window function swapped for a faulty one. The cells
run on one card, so no exchange between cards can be left out."""

import copy

import pytest
import torch

from benchhelp import SMALL, config, spec, traffic
from perfbench.harness import cell

CELLS = spec()["workloads"]
WINDOW = {"sparse": "run_sparse_ticks_fused", "pview": "run_pview_ticks_fused"}
PLANE = {"sparse": "view_key", "pview": "nbr_key"}


def unchanged(real):
    """The step returns its state as it came (the metrics of a real step on
    a copy)."""
    def step(state, draws, n, params, *a, **k):
        _, ms, w = real(copy.deepcopy(state), draws, n, params, *a, **k)
        return state, ms, w
    return step


def half_left_out(real):
    """The step leaves the upper half of the members as they were."""
    def step(state, draws, n, params, *a, **k):
        cap = state.capacity
        keep = {f: getattr(state, f)[cap // 2 :].clone() for f in vars(state)
                if isinstance(getattr(state, f), torch.Tensor) and getattr(state, f).dim() >= 1
                and getattr(state, f).shape[0] == cap}
        state, ms, w = real(state, draws, n, params, *a, **k)
        for f, v in keep.items():
            getattr(state, f)[cap // 2 :] = v
        return state, ms, w
    return step


def state_altered(engine):
    def wrap(real):
        def step(state, draws, n, params, *a, **k):
            state, ms, w = real(state, draws, n, params, *a, **k)
            plane = getattr(state, PLANE[engine])
            plane[1, 2] = plane[1, 2] + 4
            return state, ms, w
        return step
    return wrap


def answer_altered(real):
    def step(state, draws, n, params, *a, **k):
        state, ms, w = real(state, draws, n, params, *a, **k)
        ms = dict(ms, fd_probes=ms["fd_probes"] + 1)
        return state, ms, w
    return step


FAULTS = {"unchanged": lambda e: unchanged, "half_left_out": lambda e: half_left_out,
          "state_altered": state_altered, "answer_altered": lambda e: answer_altered}


def run(c, monkeypatch=None, fault=None):
    cfg = config(c["config"], **SMALL[c["config"]])
    mix = traffic(c["traffic"], warm_ticks=6)
    if fault:
        from perfbench.engines import pview, sparse

        mod = {"sparse": sparse, "pview": pview}[cfg["engine"]].module()
        name = WINDOW[cfg["engine"]]
        monkeypatch.setattr(mod, name, FAULTS[fault](cfg["engine"])(getattr(mod, name)))
    res = cell.run_cell(cfg, mix, 77, 0.3, False, "cpu", lambda: 0.0)
    return res["compare"]["state_rows_differing"] + res["compare"]["metric_values_differing"]


@pytest.mark.parametrize("c", CELLS, ids=lambda c: c["name"])
def test_sound_run_is_correct(c):
    assert run(c) == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("c", CELLS, ids=lambda c: c["name"])
def test_fault_makes_the_run_incorrect(c, fault, monkeypatch):
    assert run(c, monkeypatch, fault) > 0
