"""Cluster introspection endpoint — the JMX monitor analogue.

The reference registers a per-node MBean ``io.scalecube.cluster:name=<id>``
exposing config, cluster size, incarnation, and alive/suspected/removed
member lists (``ClusterMonitorMBean.java:3``, ``ClusterMonitorModel.java:10``,
wired in ``ClusterImpl.startJmxMonitor:363-375``). The TPU-native equivalents
(SURVEY.md §2.2 Monitor row):

* :func:`cluster_snapshot` / :func:`sim_snapshot` — the MBean attribute set
  as a plain dict (JSON-ready), pulled from the scalar engine's state or
  from the device arrays in one gather.
* :class:`MonitorServer` — an optional stdlib asyncio HTTP endpoint serving
  those snapshots at ``/nodes`` and ``/nodes/<i>`` (JMX's remote access
  analogue; JSON instead of RMI).
* :class:`TickLogger` — structured per-tick event log (SURVEY.md §5.1: the
  reference's ``[localMember][period]`` DEBUG trace, as JSON lines).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
from typing import Any, Callable, Dict, List, Optional

_log = logging.getLogger(__name__)


# -- snapshots ---------------------------------------------------------------


def cluster_snapshot(cluster) -> Dict[str, Any]:
    """MBean attribute set for one scalar-engine Cluster instance."""
    mp = cluster.membership_protocol
    member = cluster.member()
    return {
        "member": {"id": member.id, "alias": member.alias, "address": member.address,
                   "namespace": member.namespace},
        "cluster_size": len(mp.members()),
        "incarnation": mp.incarnation,
        "alive_members": [m.id for m in mp.alive_members()],
        "suspected_members": [m.id for m in mp.suspected_members()],
        "removed_members": [m.id for m in mp.removed_members()],
        "config": {
            "namespace": cluster._config.membership.namespace,
            "sync_interval": cluster._config.membership.sync_interval,
            "suspicion_mult": cluster._config.membership.suspicion_mult,
            "ping_interval": cluster._config.failure_detector.ping_interval,
            "gossip_interval": cluster._config.gossip.gossip_interval,
            "gossip_fanout": cluster._config.gossip.gossip_fanout,
        },
    }


def sim_snapshot(driver, row: int) -> Dict[str, Any]:
    """MBean attribute set for one simulated member (one device gather)."""
    import numpy as np

    from .ops.lattice import ALIVE, DEAD, LEAVING, SUSPECT

    # one lock hold for every device read: this runs on the monitor thread
    # and must not interleave with the sim thread's donating step (the
    # driver lock is reentrant, so the accessors below nest fine)
    with driver._lock:
        status, inc = driver.view_of(row)
        up = driver.is_up(row)
        tick = driver.tick
        epoch = int(driver._whole(driver.state.epoch)[row])
    member = driver._member_handle(row)

    def ids(mask: "np.ndarray") -> List[str]:
        return [driver._member_handle(int(j)).id for j in np.nonzero(mask)[0]]

    return {
        "member": {"id": member.id, "address": member.address},
        "row": row,
        "up": up,
        "tick": tick,
        "cluster_size": int((status <= LEAVING).sum()),
        "incarnation": int(inc[row]),
        # identity generation of this row (bumps on crash+reuse — the
        # restart-is-a-new-member rule; see ops.lattice epoch bits)
        "epoch": epoch,
        "alive_members": ids(status == ALIVE),
        "suspected_members": ids(status == SUSPECT),
        # DEAD tombstones ARE the removed set (reference removedMembersHistory)
        "removed_members": ids(status == DEAD),
        "config": dataclasses.asdict(driver.params),
    }


def dispatch_snapshot(driver) -> Dict[str, Any]:
    """Dispatch-pipeline view of one driver (r6): queue depth (windows
    enqueued since the last host sync), total and per-window device→host
    readback counts, flush count, plus the jit-program / persistent-cache
    audit. This is what makes the pipelined engine's overlap OBSERVABLE —
    a healthy unmonitored driver shows readbacks_per_window == 0.0 and a
    growing queue_high_water; a consumer-attached driver shows the
    readbacks it opted into."""
    return {
        **driver.dispatch_snapshot(),
        "jit_cache": driver.jit_cache_audit(),
    }


# -- HTTP endpoint -----------------------------------------------------------


class MonitorServer:
    """Minimal JSON-over-HTTP introspection server (stdlib asyncio only).

    ``providers`` maps a name to a zero-arg callable returning a JSON-able
    snapshot. Routes: ``/`` (name list), ``/nodes`` (all snapshots),
    ``/nodes/<name>`` (one).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._providers: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._health: Optional[Callable[[], Dict[str, Any]]] = None
        self._dispatch: Optional[Callable[[], Dict[str, Any]]] = None
        self._chaos: Optional[Callable[[], Dict[str, Any]]] = None
        # r16 closed-loop controller snapshot provider for /control
        self._control: Optional[Callable[[], Dict[str, Any]]] = None
        # r18 incident-replay what-if provider for /whatif (serves the
        # NEWEST computed counterfactual record — the MC itself is a
        # bench-cadence compute step, never an HTTP-GET one)
        self._whatif: Optional[Callable[[], Dict[str, Any]]] = None
        # r19 operator entry: POST /whatif runs an operator-supplied arm
        # ladder against the service's LIVE incident (the compute is
        # synchronous and minutes-scale at production seed counts — the
        # operator owns the wait; refusals come back as 400s)
        self._whatif_post: Optional[Callable[[dict], Dict[str, Any]]] = None
        # OpenMetrics family providers, concatenated at /metrics scrape
        # time (r8 telemetry plane); each returns a list of family dicts
        self._metric_providers: List[Callable[[], List[Dict[str, Any]]]] = []
        # unified event-bus tail provider for /events
        self._events: Optional[Callable[[], List[Dict[str, Any]]]] = None
        # causal trace providers (r10): GET /trace (decoded events + sewn
        # span trees) and GET /trace/perfetto (Chrome-trace JSON)
        self._trace: Optional[Callable[[], Dict[str, Any]]] = None
        self._trace_perfetto: Optional[Callable[[], Dict[str, Any]]] = None
        # r21 federation: shard label -> zero-arg fetch returning a worker's
        # /metrics exposition text; folded at /metrics/federated scrape time
        self._federation: Optional[Dict[str, Callable[[], str]]] = None
        self._federation_errors = 0  # lifetime-monotone scrape failures
        self._server: Optional[asyncio.AbstractServer] = None

    def register(self, name: str, provider: Callable[[], Dict[str, Any]]) -> None:
        self._providers[name] = provider

    def register_whatif(self, service) -> None:
        """Serve the r18 counterfactual what-if service at ``GET /whatif``:
        the newest :func:`.replay.whatif` record (arms, Wilson intervals,
        CI-separation verdicts). ``service`` is a
        :class:`.replay.WhatifService` (or any object with ``snapshot()``).
        When the service also exposes ``run_operator`` (r19), ``POST
        /whatif`` accepts an operator-supplied arm ladder against the
        service's live incident — validated with the same unknown-knob /
        reserved-name refusals as :func:`.replay.whatif`."""
        self._whatif = service.snapshot
        self._whatif_post = getattr(service, "run_operator", None)

    def register_cluster(self, cluster) -> None:
        self.register(cluster.member().id, lambda: cluster_snapshot(cluster))

    def register_sim(self, driver, rows) -> None:
        for row in rows:
            self.register(
                driver._member_handle(row).id,
                lambda r=row: sim_snapshot(driver, r),
            )

    def register_health(self, driver) -> None:
        """Expose the driver's engine-health snapshot at ``/health``: rumor-
        pool occupancy/high-water, per-source announce drops + priority
        evictions, and identity-staleness lag cohorts (VERDICT r4 item 8 —
        the sparse engine's known backpressure failure mode, live).

        Registering IS the consumer contract of the pipelined driver (r6):
        it turns on the join() in-pool probe, and every ``/health`` poll is
        the coalesced sync point for the deferred per-window readbacks.
        ``/dispatch`` additionally serves the pipeline's own vitals (queue
        depth, readback counts, jit/persistent-cache audit) WITHOUT forcing
        a flush — safe to poll at high frequency."""
        driver.enable_health_probes()
        self._health = lambda: driver.health_snapshot()
        self._dispatch = lambda: dispatch_snapshot(driver)
        # ``/chaos``: the armed scenario's progress + sentinel report (r7).
        # Registered alongside health because reading sentinel accumulators
        # is a sync point of exactly the same cadence contract.
        self._chaos = lambda: driver.chaos_snapshot()
        # ``/control`` (r16): the closed-loop controller's rung, spec, and
        # decision log. Resolved at REQUEST time (like /trace) so a plane
        # armed after registration is served; an unarmed driver answers
        # {"armed": false} — host values only, never a device read.
        self._control = lambda: driver.control_snapshot()

    def register_telemetry(self, driver, plane=None) -> None:
        """Serve the r8 telemetry plane: ``GET /metrics`` (OpenMetrics text
        for this driver — counters, gauges, histograms) and ``GET /events``
        (the unified event-bus tail as JSON). Arms the plane if the driver
        has none yet, and registers the health/dispatch/chaos providers too
        (a telemetry consumer wants all of them). Every scrape is a sync
        point of the same contract as ``/health`` — poll cadence, never
        window cadence; an unscraped driver stays transfer-free."""
        if plane is None:
            plane = driver.arm_telemetry()
        elif driver._telemetry is None:
            # an explicitly constructed plane must still be ATTACHED, or
            # step() never appends and the ring stays empty forever
            driver._telemetry = plane
        self.register_health(driver)
        # plane.families is THE scrape path (lock-guarded ring read +
        # readback bookkeeping live there, one spelling)
        self._metric_providers.append(plane.families)
        bus = plane.bus
        self._events = lambda: [r.as_dict() for r in bus.tail(256)]
        # the trace routes ride along (a telemetry consumer wants the why
        # as much as the how-much); late-bound so a plane armed AFTER
        # registration (e.g. run_scenario(trace=True) auto-attach) is
        # served without re-registering
        self.register_trace(driver, required=False)

    def register_trace(self, driver, plane=None, required: bool = True) -> None:
        """Serve the r10 causal trace plane: ``GET /trace`` (ring stats +
        decoded protocol events + sewn detection span trees, JSON) and
        ``GET /trace/perfetto`` (a Chrome-trace/Perfetto document of the
        span trees + rumor infection trees). The plane is resolved at
        REQUEST time, so arming after registration (the chaos runner's
        auto-attach) just works; ``required=True`` (the explicit-call
        default) still fails fast on a driver nobody armed — the monitor
        must never arm one itself (arming swaps compiled window programs,
        which cannot happen behind the sim thread's back). Every poll is a
        trace-ring sync point — poll cadence, never window cadence."""
        if required and plane is None and getattr(driver, "_trace", None) is None:
            raise ValueError(
                "driver has no armed trace plane — call arm_trace() first"
            )

        def _resolve():
            return plane if plane is not None else getattr(driver, "_trace", None)

        def _snapshot():
            p = _resolve()
            return p.trace_snapshot() if p is not None else {"armed": False}

        def _perfetto():
            p = _resolve()
            if p is not None:
                return p.perfetto()
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "metadata": {"armed": False}}

        self._trace = _snapshot
        self._trace_perfetto = _perfetto

    def register_federation(self, sources: Dict[str, Callable[[], str]]) -> None:
        """Serve ``GET /metrics/federated`` (r21): fold multiple workers'
        ``/metrics`` expositions into one, each sample re-labelled with its
        ``shard``. ``sources`` maps a shard label to a zero-arg callable
        returning the worker's exposition TEXT — callables, not URLs, so
        in-process planes federate without sockets; use
        :func:`scrape_metrics` to wrap a worker URL. Values pass through
        verbatim (per-shard series keep the source counters' lifetime
        monotonicity); fetch failures are skipped, counted by the monotone
        ``scalecube_federation_scrape_errors_total``."""
        self._federation = dict(sources)

    def register_federation_urls(self, urls: Dict[str, str],
                                 timeout: float = 5.0) -> None:
        """URL convenience over :meth:`register_federation` — the 2-process
        gloo lane's shape: shard label -> ``http://host:port`` of a worker
        monitor (its ``/metrics`` route is scraped on each federated poll)."""
        self.register_federation({
            label: (lambda u=url: scrape_metrics(u + "/metrics", timeout))
            for label, url in urls.items()
        })

    def register_cluster_metrics(self, cluster, bus=None) -> None:
        """Serve OpenMetrics for one scalar-engine Cluster node at
        ``/metrics`` (appended to any sim families already registered)."""
        from .telemetry.openmetrics import cluster_families

        self._metric_providers.append(lambda: cluster_families(cluster, bus))
        if bus is not None and self._events is None:
            self._events = lambda: [r.as_dict() for r in bus.tail(256)]

    async def start(self) -> "MonitorServer":
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            request = await reader.readline()
            content_length = 0
            while True:  # drain headers, keeping Content-Length (r19: POST)
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                if line.lower().startswith(b"content-length:"):
                    try:
                        content_length = int(line.split(b":", 1)[1])
                    except ValueError:
                        content_length = 0
            parts = request.split()
            method = parts[0].decode().upper() if parts else "GET"
            path = (parts[1].decode() if len(parts) > 1 else "/").split("?", 1)[0]
            payload_in = (
                await reader.readexactly(content_length)
                if content_length > 0 else b""
            )
            if method == "POST":
                status, body = self._route_post(path, payload_in)
            else:
                status, body = self._route(path)
            if isinstance(body, bytes):  # pre-rendered (OpenMetrics text)
                ctype, payload = self._text_content_type, body
            else:
                ctype, payload = b"application/json", json.dumps(body).encode()
            writer.write(
                b"HTTP/1.1 " + status + b"\r\nContent-Type: " + ctype
                + f"\r\nContent-Length: {len(payload)}\r\n\r\n".encode()
                + payload
            )
            await writer.drain()
        except Exception:  # noqa: BLE001 - monitor must never take a node down
            _log.exception("monitor request failed")
        finally:
            writer.close()

    #: content type of bytes bodies (the OpenMetrics exposition)
    _text_content_type = b"text/plain; version=0.0.4; charset=utf-8"

    def _route(self, path: str) -> tuple[bytes, Any]:
        if path == "/":
            return b"200 OK", {
                "nodes": sorted(self._providers),
                "health": self._health is not None,
                "dispatch": self._dispatch is not None,
                "chaos": self._chaos is not None,
                "control": self._control is not None,
                "whatif": self._whatif is not None,
                "metrics": bool(self._metric_providers),
                "federated": self._federation is not None,
                "events": self._events is not None,
                "trace": self._trace is not None,
            }
        if path == "/metrics":
            if not self._metric_providers:
                return b"404 Not Found", {"error": "no metrics provider registered"}
            from .telemetry.openmetrics import render

            families = [f for p in self._metric_providers for f in p()]
            return b"200 OK", render(families).encode()
        if path == "/metrics/federated":
            if self._federation is None:
                return b"404 Not Found", {"error": "no federation registered"}
            from .telemetry.openmetrics import (
                PREFIX, family, federated_families, render,
            )

            texts: Dict[str, str] = {}
            for label, fetch in self._federation.items():
                try:
                    texts[label] = fetch()
                except Exception:  # noqa: BLE001 - a down worker must not 500 the fold
                    _log.exception("federated scrape of shard %r failed", label)
                    self._federation_errors += 1
            fams = federated_families(texts)
            fams.append(family(
                f"{PREFIX}_federation_workers", "gauge",
                "Workers successfully scraped into this federated exposition.",
                [(f"{PREFIX}_federation_workers", {}, len(texts))],
            ))
            fams.append(family(
                f"{PREFIX}_federation_scrape_errors_total", "counter",
                "Federated worker scrapes that failed (lifetime).",
                [(f"{PREFIX}_federation_scrape_errors_total", {},
                  self._federation_errors)],
            ))
            return b"200 OK", render(fams).encode()
        if path == "/events":
            if self._events is None:
                return b"404 Not Found", {"error": "no event bus registered"}
            return b"200 OK", {"events": self._events()}
        if path == "/trace":
            if self._trace is None:
                return b"404 Not Found", {"error": "no trace provider registered"}
            return b"200 OK", self._trace()
        if path == "/trace/perfetto":
            if self._trace_perfetto is None:
                return b"404 Not Found", {"error": "no trace provider registered"}
            return b"200 OK", self._trace_perfetto()
        if path == "/chaos":
            if self._chaos is None:
                return b"404 Not Found", {"error": "no chaos provider registered"}
            return b"200 OK", self._chaos()
        if path == "/control":
            if self._control is None:
                return b"404 Not Found", {"error": "no control provider registered"}
            return b"200 OK", self._control()
        if path == "/whatif":
            if self._whatif is None:
                return b"404 Not Found", {"error": "no whatif service registered"}
            return b"200 OK", self._whatif()
        if path == "/health":
            if self._health is None:
                return b"404 Not Found", {"error": "no health provider registered"}
            return b"200 OK", self._health()
        if path == "/dispatch":
            if self._dispatch is None:
                return b"404 Not Found", {"error": "no dispatch provider registered"}
            return b"200 OK", self._dispatch()
        if path == "/nodes":
            return b"200 OK", {n: p() for n, p in self._providers.items()}
        if path.startswith("/nodes/"):
            name = path[len("/nodes/") :]
            if name in self._providers:
                return b"200 OK", self._providers[name]()
            return b"404 Not Found", {"error": f"unknown node {name!r}"}
        return b"404 Not Found", {"error": f"no route {path!r}"}

    def _route_post(self, path: str, body: bytes) -> tuple[bytes, Any]:
        """POST routes (r19). ``/whatif`` runs an operator arm ladder
        against the registered service's live incident; replay-grammar
        refusals (unknown knob, reserved/duplicate arm name, no incident)
        surface as 400s that quote the refusal verbatim."""
        if path != "/whatif":
            return b"404 Not Found", {"error": f"no POST route {path!r}"}
        if self._whatif_post is None:
            return b"404 Not Found", {
                "error": "whatif service accepts no operator arms — "
                         "register a replay.WhatifService(incident=...)"
            }
        try:
            doc = json.loads(body.decode("utf-8") or "null")
        except (UnicodeDecodeError, ValueError):
            return b"400 Bad Request", {"error": "body is not valid JSON"}
        from .replay import ReplayError

        try:
            return b"200 OK", self._whatif_post(doc)
        except ReplayError as exc:
            return b"400 Bad Request", {"error": str(exc)}


def scrape_metrics(url: str, timeout: float = 5.0) -> str:
    """Fetch one worker's exposition text (stdlib urllib — the repo rule).
    The federation route calls these synchronously; workers are expected
    on the local network (the gloo lane scrapes loopback)."""
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


# -- structured per-tick log -------------------------------------------------


class TickLogger:
    """JSON-lines log of per-tick metrics + host interventions, the
    structured analogue of the reference's causally ordered
    ``[localMember][period]`` DEBUG trace (SURVEY.md §5.1)."""

    def __init__(self, path: str):
        self._fh = open(path, "a", buffering=1)

    def log_tick(self, tick: int, metrics: Dict[str, Any]) -> None:
        record = {"t": tick, "ts": time.time()}
        for name, v in metrics.items():
            try:
                record[name] = v.item() if hasattr(v, "item") and getattr(v, "ndim", 1) == 0 else (
                    [float(x) for x in v] if hasattr(v, "__iter__") else v
                )
            except Exception:  # noqa: BLE001
                record[name] = str(v)
        self._fh.write(json.dumps(record) + "\n")

    def log_event(self, tick: int, kind: str, **fields: Any) -> None:
        self._fh.write(json.dumps({"t": tick, "event": kind, **fields}) + "\n")

    def close(self) -> None:
        self._fh.close()
