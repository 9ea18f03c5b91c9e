"""The port's ``monitor.py``, its build cache and the driver's audit against
the JAX package's.

A port driver and a JAX driver run the same script from the same seed (the
sparse engine with dense links, telemetry and trace armed; the port fed the
JAX driver's key chain), and a ``MonitorServer`` of each package serves
its driver: every GET route answers with the same JSON — ``/metrics`` the
same samples (the ring's four f32 series within the telemetry tests' ulp
rule; the window wall-clock histograms excepted: they time this host),
``/events`` the same records but their wall-clock stamps, ``/dispatch``
the same counts and JAX's audit keys — and ``POST /whatif`` gives JAX's
verdicts, refusals and a live incident's arms alike. One in-process HTTP
round trip on 127.0.0.1. Then ``jit_cache_audit`` and the build-cache
report (JAX's keys; the libraries listed), ``compile_cache_dir`` pointing
``ops/_build.py`` elsewhere on the CPU without building anything, and the
refusals this slice lifted.
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import re

import numpy as np
import torch

import scalecube_cluster_tpu.monitor as JMON
from scalecube_cluster_tpu import replay as JR
from scalecube_cluster_tpu.config import TelemetryConfig as JTelemetryConfig
from scalecube_cluster_tpu_torch import compile_cache
from scalecube_cluster_tpu_torch import monitor as TMON
from scalecube_cluster_tpu_torch import replay as TR
from scalecube_cluster_tpu_torch.config import ClusterConfig, TelemetryConfig
from scalecube_cluster_tpu_torch.ops import _build
from scalecube_cluster_tpu_torch.sim.driver import SimDriver, auto_params
from test_torch_replay import ARMS, SEEDS, _fleet_chain_draws, _jax_dump
from test_torch_telemetry import F32_SERIES
from test_torch_trace import SLOTS, TRACERS, _drive, _driver_pair

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
GET_ROUTES = ("/", "/metrics", "/metrics/federated", "/events", "/trace", "/trace/perfetto", "/chaos", "/control",
              "/whatif", "/health", "/dispatch", "/nodes", "/nodes/sim-5", "/nodes/nobody", "/nowhere")
#: the window wall-clock histograms: they time this host's windows
WALL_FAMILIES = ("scalecube_window_dispatch_seconds", "scalecube_tick_latency_seconds")
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def _served_pair():
    jd, td, _ = _driver_pair("sparse")
    jd.arm_telemetry(JTelemetryConfig(ring_len=16))
    td.arm_telemetry(TelemetryConfig(ring_len=16))
    for d in (jd, td):
        d.arm_trace(tracer_rows=TRACERS, rumor_slots=SLOTS)
    _drive([jd, td], windows=3)
    fed = "# TYPE w_total counter\nw_total 3\n"
    mons = []
    for mod, d, svc in ((JMON, jd, JR.WhatifService()), (TMON, td, TR.WhatifService())):
        m = mod.MonitorServer()
        m.register_telemetry(d)
        m.register_whatif(svc)
        m.register_sim(d, [0, 5])
        m.register_federation({"w0": lambda: fed})
        mons.append(m)
    return jd, td, mons


def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name, labels, value = _SAMPLE.match(line).groups()
        out[(name, labels or "")] = float(value)
    return out


def _assert_metrics_equal(jtext: str, ttext: str) -> None:
    jtypes = [ln for ln in jtext.splitlines() if ln.startswith("#")]
    assert [ln for ln in ttext.splitlines() if ln.startswith("#")] == jtypes
    js, ts = _samples(jtext), _samples(ttext)
    assert list(ts) == list(js)
    for key, a in js.items():
        b = ts[key]
        if key[0].startswith(WALL_FAMILIES) and not key[0].endswith("_count"):
            continue
        series = re.search(r'series="([^"]+)"', key[1])
        if series and series.group(1) in F32_SERIES:
            assert abs(a - b) <= 4 * np.spacing(np.float32(max(abs(a), 1e-30))), (key, a, b)
        else:
            assert a == b, (key, a, b)


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_get_routes_serve_jax_json():
    jd, td, (jm, tm) = _served_pair()
    got = {}
    for path in GET_ROUTES:
        (js, jb), (ts, tb) = jm._route(path), tm._route(path)
        assert ts == js, path
        got[path] = (jb, tb)
    for path in ("/metrics", "/metrics/federated"):
        jb, tb = got.pop(path)
        _assert_metrics_equal(jb.decode(), tb.decode())
    jb, tb = got.pop("/events")
    assert _strip_ts(tb["events"]) == _strip_ts(jb["events"])
    jb, tb = got.pop("/health")
    jcov, tcov = jb["rumors"].pop("coverage"), tb["rumors"].pop("coverage")
    assert set(tcov) == set(jcov) and all(abs(jcov[s] - tcov[s]) <= 1e-4 for s in jcov)
    assert tb == jb
    jb, tb = got.pop("/dispatch")
    jaudit, taudit = jb.pop("jit_cache"), tb.pop("jit_cache")
    assert tb == jb
    assert set(taudit) == set(jaudit) == {"programs", "persistent_cache"}
    assert set(taudit["persistent_cache"]) >= set(jaudit["persistent_cache"])
    strip = lambda p: {k: v for k, v in p.items() if k != "first_dispatch_s"}  # noqa: E731
    assert [set(p) for p in taudit["programs"]] == [set(p) | {"adaptive", "engine"} for p in jaudit["programs"]]
    assert [{k: v for k, v in strip(p).items() if k in strip(q)} for p, q in zip(taudit["programs"],
                                                                            jaudit["programs"])] == [
        strip(q) for q in jaudit["programs"]]
    for path, (jb, tb) in got.items():
        assert json.loads(json.dumps(tb)) == json.loads(json.dumps(jb)), path
    assert got["/trace"][1]["records"] > 0 and got["/trace/perfetto"][1]["traceEvents"]
    assert set(got["/nodes"][1]) == {"sim-0", "sim-5"} and got["/nodes/sim-5"][1]["config"]["capacity"] == 24


def test_whatif_post_gives_jax_verdicts(tmp_path):
    jm, tm = JMON.MonitorServer(), TMON.MonitorServer()
    jsvc, tsvc = JR.WhatifService(), TR.WhatifService()
    jm.register_whatif(jsvc)
    tm.register_whatif(tsvc)
    bodies = [b"not json", b"[1]", b'{"arms": []}', b'{"arms": [{"name": "x", "bogus": 1}]}',
              b'{"arms": [{"name": "as-recorded"}]}', json.dumps({"arms": ARMS[:1]}).encode()]
    # no live incident: every body is refused alike
    for body in bodies:
        assert tm._route_post("/whatif", body) == jm._route_post("/whatif", body), body
    assert tm._route_post("/nowhere", b"{}") == jm._route_post("/nowhere", b"{}")
    jdir = tmp_path / "jax"
    jdir.mkdir()
    dump = _jax_dump(str(jdir))["flight_dump"]
    jsvc.attach_incident(JR.incident_from_flight(dump))
    tsvc.attach_incident(TR.incident_from_flight(dump))
    # the port's service runs its fleets on the CPU from the JAX fleets'
    # per-row key chains (an HTTP body names no device and no draws)
    run = tsvc.run
    tsvc.run = lambda inc, arms, **kw: run(inc, arms, device="cpu", draws=_fleet_chain_draws, **kw)
    for body in bodies[1:-1]:
        assert tm._route_post("/whatif", body) == jm._route_post("/whatif", body), body
    body = json.dumps({"arms": ARMS[:1], "seeds_per_arm": SEEDS}).encode()
    (js, jrec), (ts, trec) = jm._route_post("/whatif", body), tm._route_post("/whatif", body)
    assert ts == js == b"200 OK"
    assert trec["arms"] == jrec["arms"]
    for k in ("as_recorded_wilson", "n_separated", "any_arm_separated", "tick_range", "n_arms", "computed"):
        assert trec[k] == jrec[k], k
    assert tm._route("/whatif") == (b"200 OK", trec)


def test_http_round_trip_on_loopback():
    async def run():
        d = SimDriver(auto_params(64), 40, device="cpu")
        m = TMON.MonitorServer()
        m.register_telemetry(d)
        m.register_whatif(TR.WhatifService())
        await m.start()
        try:
            assert m.host == "127.0.0.1" and m.url == f"http://127.0.0.1:{m.port}"
            out = {}
            for method, path, body in (("GET", "/whatif", b""), ("GET", "/metrics", b""),
                                       ("POST", "/whatif", b'{"arms": []}')):
                reader, writer = await asyncio.open_connection(m.host, m.port)
                writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n\r\n".encode()
                             + body)
                await writer.drain()
                payload = await reader.read(-1)
                writer.close()
                head, _, content = payload.partition(b"\r\n\r\n")
                out[(method, path)] = (head.split(b"\r\n")[0], content)
            return out, m
        finally:
            await m.stop()

    out, m = asyncio.run(run())
    assert out[("GET", "/whatif")] == (b"HTTP/1.1 200 OK", b'{"computed": false}')
    assert out[("GET", "/metrics")][0] == b"HTTP/1.1 200 OK" and b"# TYPE" in out[("GET", "/metrics")][1]
    status, content = out[("POST", "/whatif")]
    assert status == b"HTTP/1.1 400 Bad Request" and b"no live incident" in content


def _fake_library(build_dir: pathlib.Path, name: str, digest: str, log: bool) -> None:
    build_dir.mkdir(parents=True, exist_ok=True)
    (build_dir / f"lib{name}-{digest}.so").write_bytes(b"\0" * 100)
    if log:
        (build_dir / f"lib{name}-{digest}.log").write_text("ptxas info")


def test_audit_and_build_cache_report_have_jax_keys(tmp_path, monkeypatch):
    import scalecube_cluster_tpu.compile_cache as JCC

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "default")
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    assert set(compile_cache.compile_cache_report()) >= set(JCC.compile_cache_report(str(tmp_path / "none")))
    _fake_library(tmp_path / "default", "delivery_combine", "0123456789ab", log=True)
    _fake_library(tmp_path / "default", "other", "ba9876543210", log=False)
    rep = compile_cache.compile_cache_report()
    assert set(rep) >= {"enabled", "dir", "entries", "total_bytes", "newest_entry_age_s"}
    assert rep["enabled"] is False and rep["entries"] == 2 and rep["total_bytes"] == 200
    assert rep["libraries"] == [
        {"name": "delivery_combine", "source_hash": "0123456789ab", "bytes": 100, "ptxas_log": True},
        {"name": "other", "source_hash": "ba9876543210", "bytes": 100, "ptxas_log": False}]
    d = SimDriver(auto_params(64), 40, device="cpu")
    d.watch(0)
    d.step(2)
    d.step(2)
    d.step(3)
    audit = d.jit_cache_audit()
    assert [(p["n_ticks"], p["n_watch"], p["traced"], p["adaptive"], p["engine"], p["calls"])
            for p in audit["programs"]] == [(2, 1, False, False, "dense", 2), (3, 1, False, False, "dense", 1)]
    assert all(p["first_dispatch_s"] > 0 for p in audit["programs"])
    assert audit["persistent_cache"]["entries"] == 2


def test_compile_cache_dir_points_the_builds_elsewhere_without_building(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    built = []
    monkeypatch.setattr(_build, "build", lambda name: built.append(name))
    cfg = ClusterConfig.default_local()
    # nothing configured: nothing moves
    assert compile_cache.enable_persistent_compile_cache(config=cfg) is None
    # the JAX package's precedence: argument > config > environment
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "env"))
    with_dir = cfg.with_sim(lambda s: s.replace(compile_cache_dir=str(tmp_path / "cfg")))
    assert compile_cache.resolve_cache_dir(str(tmp_path / "arg"), with_dir) == str(tmp_path / "arg")
    assert compile_cache.resolve_cache_dir(None, with_dir) == str(tmp_path / "cfg")
    assert compile_cache.resolve_cache_dir(None, cfg) == str(tmp_path / "env")
    auto_params(64, config=cfg)
    assert _build.BUILD_DIR == tmp_path / "env" / "torch_kernels"
    auto_params(64, config=with_dir)
    assert _build.BUILD_DIR == tmp_path / "cfg" / "torch_kernels"
    SimDriver(auto_params(64), 40, device="cpu", compile_cache_dir=str(tmp_path / "arg"))
    assert _build.BUILD_DIR == tmp_path / "arg" / "torch_kernels" and _build.BUILD_DIR.is_dir()
    assert _build.library_path("delivery_combine").parent == tmp_path / "arg" / "torch_kernels"
    rep = compile_cache.compile_cache_report()
    assert rep["enabled"] is True and rep["dir"] == str(tmp_path / "arg" / "torch_kernels")
    assert rep["entries"] == 0 and list(_build.BUILD_DIR.iterdir()) == [] and built == []


def test_refusals_lifted_by_this_slice_are_gone():
    """The sim transport, the compile-cache directory and audit, the
    emulator runner: no source of the port refuses them any more, and no
    refusal by a ROADMAP item is left (the sparse engine on a mesh, A12
    item 5, was the last)."""
    texts = {p.relative_to(REPO).as_posix(): p.read_text()
             for p in (REPO / "scalecube_cluster_tpu_torch").rglob("*.py")}
    assert [p for p, t in texts.items() if "ROADMAP A13" in t] == []
    flat = [re.sub(r"\s+", " ", re.sub(r'"\s+f?"', "", t)) for t in texts.values()]
    left = {m for t in flat for m in re.findall(r"not ported yet \(ROADMAP (A[^)]+)\)", t)}
    left |= {m for t in flat for m in re.findall(r'_not_ported\([^;]*?, "(A[^"]+)"\)', t)}
    assert left == set(), left
    assert [p for p, t in texts.items() if "_not_ported" in t or "NotImplementedError" in t] == []
