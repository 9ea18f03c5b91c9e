"""Operator load generator for the hybrid serving stack (r19).

Drives two traffic planes concurrently against a live hybrid cluster:

* **member-facing churn** — sustained ``join`` / ``leave`` /
  ``update_metadata`` / ``spread_rumor`` host mutations through the
  driver's public seam (the same calls the bridge proxy folds real-member
  traffic into), each op individually wall-clocked;
* **scrape traffic** — concurrent ``/metrics`` + ``/trace`` + ``/whatif``
  HTTP GETs against a live :class:`~scalecube_cluster_tpu_torch.monitor.MonitorServer`
  over raw asyncio sockets (no client library), each scrape wall-clocked.

A stepping task keeps the simulated windows advancing at a fixed cadence
while the load runs, so ops land in real windows and scrapes observe a
moving membership — serving and simulation contend exactly as they would
in production. Latency histograms (p50/p90/p99/max) are computed per op
kind and per scrape path; when the driver's telemetry bus is armed the
summary is also published as a ``("loadgen", "summary")`` bus record, so
the existing `/metrics`-adjacent tooling sees the run without a side
channel.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def _percentiles(samples: List[float]) -> Dict[str, float]:
    if not samples:
        return {"count": 0}
    arr = np.asarray(samples) * 1e3  # ms
    return {
        "count": len(samples),
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p90_ms": round(float(np.percentile(arr, 90)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


@dataclass
class LoadReport:
    """Outcome of one :meth:`LoadGenerator.run` — JSON-able as-is."""

    duration_s: float = 0.0
    ops: int = 0
    ops_per_s: float = 0.0
    op_latency: Dict[str, Dict[str, float]] = field(default_factory=dict)
    scrapes: Dict[str, Dict[str, float]] = field(default_factory=dict)
    scrape_errors: int = 0
    op_errors: int = 0
    windows_stepped: int = 0

    def as_dict(self) -> dict:
        return {
            "duration_s": round(self.duration_s, 3),
            "ops": self.ops,
            "ops_per_s": round(self.ops_per_s, 1),
            "op_latency": self.op_latency,
            "scrapes": self.scrapes,
            "scrape_errors": self.scrape_errors,
            "op_errors": self.op_errors,
            "windows_stepped": self.windows_stepped,
        }


class LoadGenerator:
    """Churn + scrape load against a driver (and optionally a monitor)."""

    def __init__(
        self,
        driver,
        *,
        monitor_url: Optional[str] = None,
        seed: int = 0,
        seed_rows: Sequence[int] = (0,),
        max_churn_pool: int = 32,
    ) -> None:
        self._d = driver
        self._monitor_url = monitor_url
        self._rng = random.Random(seed)
        self._seed_rows = tuple(seed_rows)
        self._max_pool = max_churn_pool
        self._pool: List[int] = []  # rows this generator joined and may leave
        # churn ops run on executor threads (a driver mutator may wait out
        # a whole in-flight window on the driver lock — parking that wait
        # on the event loop would starve the scrape lanes); the pool list
        # needs its own lock there
        self._pool_lock = threading.Lock()

    # -- churn ---------------------------------------------------------------
    #: metadata bumps arrive batched (operator consoles coalesce them into
    #: one dispatch); the fori_loop batch is launch-dominated, so a wide
    #: batch serves ~linearly more member ops per dispatch slot. Rumors are
    #: broadcasts — rare relative to the rest of the mix, so the bounded
    #: slot pool recycles instead of thrashing
    METADATA_BATCH = 32

    def _one_op(self, lat: Dict[str, List[float]]) -> int:
        """One member-facing dispatch; returns how many member ops it
        served (a metadata batch counts each row), 0 on a refusal."""
        d = self._d
        with self._pool_lock:
            kind = self._rng.choices(
                ("metadata", "rumor", "join", "leave"),
                weights=(0.70, 0.05, 0.125, 0.125),
            )[0]
            if kind == "leave" and not self._pool:
                kind = "join"
            if kind == "join" and len(self._pool) >= self._max_pool:
                kind = "leave"
            pick = tuple(self._pool) if self._pool else self._seed_rows
            leave_row = (
                self._pool.pop(self._rng.randrange(len(self._pool)))
                if kind == "leave" else -1
            )
            rows = [
                self._rng.choice(pick) for _ in range(self.METADATA_BATCH)
            ] if kind == "metadata" else ()
        served = 1
        t0 = time.perf_counter()
        try:
            if kind == "metadata":
                d.update_metadata_batch(rows)
                served = len(rows)
            elif kind == "rumor":
                d.spread_rumor(self._rng.choice(pick), {"loadgen": True})
            elif kind == "join":
                joined = d.join(self._seed_rows)
                with self._pool_lock:
                    self._pool.append(joined)
            else:
                d.leave(leave_row)
        except RuntimeError:
            # capacity / rumor-slot exhaustion under extreme churn is a
            # refusal, not a crash — counted, never fatal
            return 0
        lat.setdefault(kind, []).append(time.perf_counter() - t0)
        return served

    async def _churn_worker(self, deadline: float, report: LoadReport,
                            lat: Dict[str, List[float]]) -> None:
        loop = asyncio.get_running_loop()
        while time.perf_counter() < deadline:
            # executor thread: the op may park on the driver lock behind a
            # stepping window; the event loop keeps serving scrapes
            served = await loop.run_in_executor(None, self._one_op, lat)
            if served:
                report.ops += served
            else:
                report.op_errors += 1

    # -- scrapes -------------------------------------------------------------
    async def _scrape_once(self, path: str) -> float:
        assert self._monitor_url is not None
        hostport = self._monitor_url.split("://", 1)[1]
        host, _, port = hostport.rpartition(":")
        t0 = time.perf_counter()
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        await writer.drain()
        payload = await reader.read(-1)
        writer.close()
        if b" 200 " not in payload.split(b"\r\n", 1)[0]:
            raise RuntimeError(f"scrape {path}: non-200")
        return time.perf_counter() - t0

    async def _scrape_worker(self, deadline: float, paths: Sequence[str],
                             report: LoadReport,
                             lat: Dict[str, List[float]]) -> None:
        i = 0
        while time.perf_counter() < deadline:
            path = paths[i % len(paths)]
            i += 1
            try:
                lat.setdefault(path, []).append(await self._scrape_once(path))
            except (OSError, RuntimeError, asyncio.IncompleteReadError):
                report.scrape_errors += 1
            await asyncio.sleep(0)

    # -- warmup --------------------------------------------------------------
    async def warmup(
        self,
        scrape_paths: Sequence[str] = ("/metrics", "/trace", "/whatif"),
        step_window: int = 2,
    ) -> None:
        """One untimed pass over every lane before the clock starts.

        Each op kind fires once, one window steps, and each scrape path is
        hit once — so first-call jit compiles (the driver caches one jitted
        program per mutator and per window size) and connection setup land
        here instead of inside the measured run. Skipping this is valid but
        measures cold-start, not steady-state serving.
        """
        d = self._d
        d.update_metadata(self._seed_rows[0])
        d.update_metadata_batch([self._seed_rows[0]] * self.METADATA_BATCH)
        d.spread_rumor(self._seed_rows[0], {"warmup": True})
        d.leave(d.join(self._seed_rows))
        d.step(step_window)
        if self._monitor_url is not None:
            for path in scrape_paths:
                try:
                    await self._scrape_once(path)
                except (OSError, RuntimeError, asyncio.IncompleteReadError):
                    pass  # timed run will surface real scrape failures

    # -- stepping ------------------------------------------------------------
    async def _stepper(self, deadline: float, report: LoadReport,
                       window: int, interval_s: float) -> None:
        loop = asyncio.get_running_loop()
        while time.perf_counter() < deadline:
            # executor thread: the window holds the driver lock for its
            # whole compute — ops queue behind it (real contention, kept),
            # but the event loop stays free to serve scrapes
            await loop.run_in_executor(None, self._d.step, window)
            report.windows_stepped += 1
            await asyncio.sleep(interval_s)

    # -- entry ---------------------------------------------------------------
    async def run(
        self,
        duration_s: float = 2.0,
        *,
        churn_workers: int = 2,
        scrape_workers: int = 2,
        scrape_paths: Sequence[str] = ("/metrics", "/trace", "/whatif"),
        step_window: int = 2,
        step_interval_s: float = 0.2,
    ) -> LoadReport:
        report = LoadReport()
        op_lat: Dict[str, List[float]] = {}
        scrape_lat: Dict[str, List[float]] = {}
        t0 = time.perf_counter()
        deadline = t0 + duration_s
        tasks = [
            self._churn_worker(deadline, report, op_lat)
            for _ in range(churn_workers)
        ]
        tasks.append(self._stepper(deadline, report, step_window, step_interval_s))
        if self._monitor_url is not None and scrape_workers > 0:
            tasks.extend(
                self._scrape_worker(deadline, scrape_paths, report, scrape_lat)
                for _ in range(scrape_workers)
            )
        await asyncio.gather(*tasks)
        report.duration_s = time.perf_counter() - t0
        report.ops_per_s = report.ops / max(report.duration_s, 1e-9)
        report.op_latency = {k: _percentiles(v) for k, v in op_lat.items()}
        report.scrapes = {k: _percentiles(v) for k, v in scrape_lat.items()}
        # surface through the armed telemetry plane (bus record), if any
        try:
            self._d._publish(
                "loadgen", "summary", ops=report.ops,
                ops_per_s=round(report.ops_per_s, 1),
                scrape_errors=report.scrape_errors,
            )
        except Exception:
            pass  # bus not armed — the returned report is the artifact
        return report
