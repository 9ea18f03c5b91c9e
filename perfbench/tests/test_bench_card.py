"""On the card: the control at each cell's own configuration and traffic
(its warm requests and a short window of 20 more) reads above the limit 0
on every seed (so a limit of 0 separates it from sound runs)."""

import pytest

from benchhelp import config, spec, traffic
from perfbench.control import control_readings

CELLS = spec()["workloads"]


@pytest.mark.card
@pytest.mark.parametrize("c", CELLS, ids=lambda c: c["name"])
def test_control_fails_at_the_cells_size(c, card):
    for seed in (11, 2**31 + 7, 424242):
        r = control_readings(config(c["config"]), traffic(c["traffic"]), seed, card, 20)
        assert r["state_rows_differing"] + r["metric_values_differing"] > 0
