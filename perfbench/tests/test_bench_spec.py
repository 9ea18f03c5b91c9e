"""BENCHMARK.json against the benchmark's contract: every cell resolves to
its configuration, traffic and metric files; names, units and limits."""

import json
import re

import pytest

from benchhelp import ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["perfbench"]
    assert (ROOT / s["command"][1]).is_file()
    assert 1 <= s["run_seconds"] <= 51


@pytest.mark.parametrize("cell", spec()["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_to_its_files(cell):
    s = spec()
    conf = next(c for c in s["configs"] if c["name"] == cell["config"])
    cfg_file = ROOT / conf["file"]
    assert cfg_file.is_file() and conf["file"].startswith("perfbench/configs/")
    mix_file = ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json"
    assert mix_file.is_file()
    for src in json.loads(mix_file.read_text()).get("sources", []):
        assert (ROOT / "perfbench" / "sources" / f"{src['kind']}.py").is_file()
    engine = json.loads(cfg_file.read_text())["engine"]
    assert (ROOT / "perfbench" / "engines" / f"{engine}.py").is_file()
    assert (ROOT / "perfbench" / "reference" / f"{engine}.py").is_file()
    for m in s["per_layer"]:
        if "workloads" not in m or cell["name"] in m["workloads"]:
            assert (ROOT / "perfbench" / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200


def test_names_units_and_bounds():
    s = spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in s["end_to_end"] + s["per_layer"])) == len(s["end_to_end"]) + len(s["per_layer"])
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for m in s["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in s["configs"]} == {w["config"] for w in s["workloads"]}
