"""Crash flight recorder: the post-mortem artifact for a mid-soak failure.

When a sentinel fires, a checkpoint fails to restore, or an operator asks,
the telemetry plane dumps the last K metric-ring windows plus the tail of
the event bus to ONE crash-safe JSON artifact — the same
mkstemp+fsync+``os.replace`` machinery the r7 checkpoints use, so a crash
mid-dump can never leave a torn file where the post-mortem should be.

:func:`load_flight_dump` validates schema + engine fields and
:func:`replay_timeline` merges the ring rows and bus records into one
tick-ordered human-readable timeline — "what the cluster was doing in the
K windows before it died", without a debugger or a rerun.

The JAX package's ``telemetry/flight.py`` in the port: the backend stamp is
the driver's torch device type (``"cuda"`` / ``"cpu"``), the rest is the
same code. The reconstruction section is written as there and read back by
the replay service (:mod:`..replay`), which takes dumps of either package.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional

FLIGHT_SCHEMA = 2


class FlightRecorderError(RuntimeError):
    """A flight dump that cannot be loaded (truncated, corrupt, or from a
    future schema) — the checkpoint-error analogue for post-mortems."""


def _backend_name() -> str:
    """The torch device type a driver would run on here (``"cuda"`` or
    ``"cpu"``), for a dump whose writer names none."""
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "unknown"


def write_flight_dump(
    path: str,
    *,
    reason: str,
    engine: str,
    ring_snapshot: dict,
    bus_tail: List[dict],
    context: Optional[dict] = None,
    trace: Optional[dict] = None,
    reconstruction: Optional[dict] = None,
    tick_range: Optional[List[int]] = None,
    backend: Optional[str] = None,
) -> str:
    """Atomically write one flight artifact; returns the final path.

    Crash-safe exactly like ``SimDriver.checkpoint``: mkstemp in the target
    directory (concurrent dumps never truncate each other), fsync, then one
    ``os.replace`` — the artifact either fully exists or not at all.

    ``trace`` (r10) is the causal-trace section an armed trace plane
    contributes (``TracePlane.flight_section``): the trace-ring tail plus
    the sewn span tree for each violating member — post-mortems carry
    causality, not just the how-much series. Optional, so pre-r10 dumps
    and unarmed drivers keep the schema (readers treat it as absent).

    ``reconstruction`` (r18, schema 2) embeds everything
    :func:`..replay.scenario_from_flight` needs to rebuild and RE-RUN the
    incident: engine + params doc + seed + the armed scenario's event
    timeline + the recorded verdict. When the writer has no armed chaos
    runner to describe, pass ``None`` — the loader then marks the dump
    ``reconstruction: "partial"`` (same as every pre-r18 artifact).
    ``backend`` is the writer's torch device type (default: the machine's)."""
    rows = ring_snapshot["rows"]
    doc = {
        "_schema": FLIGHT_SCHEMA,
        "ts": time.time(),
        "reason": reason,
        "engine": engine,
        # provenance stamps (the r13 backend-stamp rule, applied to the
        # post-mortem surface): which backend the dying sim ran on, how
        # many host CPUs, and the absolute tick span the artifact covers
        "backend": backend or _backend_name(),
        "host_cpus": os.cpu_count(),
        "ring": {
            "names": list(ring_snapshot["names"]),
            "windows_total": int(ring_snapshot["windows"]),
            "rows": [[float(v) for v in row] for row in rows],
        },
        "events": list(bus_tail),
        "context": context or {},
    }
    if tick_range is not None:
        doc["tick_range"] = [int(tick_range[0]), int(tick_range[1])]
    if reconstruction is not None:
        doc["reconstruction"] = reconstruction
    if trace is not None:
        doc["trace"] = trace
    target = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(target) + ".tmp-",
        dir=os.path.dirname(target),
    )
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_flight_dump(path: str) -> dict:
    """Load + validate one artifact; raises :class:`FlightRecorderError` on
    anything that isn't a complete dump this build understands."""
    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        raise
    except Exception as exc:  # json/unicode deep failures -> one clear error
        raise FlightRecorderError(
            f"flight dump {path!r} is unreadable (truncated or corrupt): {exc}"
        ) from exc
    schema = int(doc.get("_schema", 0))
    if schema > FLIGHT_SCHEMA:
        raise FlightRecorderError(
            f"flight dump {path!r} has schema {schema}, newer than this "
            f"build's {FLIGHT_SCHEMA} — refusing a partial decode"
        )
    for key in ("reason", "engine", "ring", "events"):
        if key not in doc:
            raise FlightRecorderError(
                f"flight dump {path!r} is missing {key!r} (truncated?)"
            )
    # versioned upgrade (r18): schema-1 artifacts — and schema-2 dumps whose
    # writer had no armed chaos runner to describe — carry no reconstruction
    # inputs. Mark that EXPLICITLY so replay tooling refuses with "this dump
    # predates/lacks reconstruction" instead of a KeyError.
    if "reconstruction" not in doc:
        doc["reconstruction"] = "partial"
    return doc


def replay_timeline(dump: dict) -> List[str]:
    """Merge ring windows + bus events into one tick-ordered, human-readable
    timeline (the loader's whole point: a post-mortem someone can READ)."""
    names = dump["ring"]["names"]
    try:
        tick_col = names.index("tick")
    except ValueError:
        tick_col = None
    entries: List[tuple] = []  # (tick, order, line)
    for row in dump["ring"]["rows"]:
        tick = int(row[tick_col]) if tick_col is not None else -1
        interesting = {
            n: v
            for n, v in zip(names, row)
            if n not in ("tick", "window_ticks") and v
        }
        detail = ", ".join(
            f"{n}={v:g}" for n, v in sorted(interesting.items())
        ) or "quiet"
        entries.append((tick, 0, f"[tick {tick:>8}] window  {detail}"))
    for ev in dump["events"]:
        tick = int(ev.get("tick", -1))
        detail = ", ".join(
            f"{k}={v}" for k, v in sorted(ev.items())
            if k not in ("tick", "ts", "seq", "source", "kind") and v != ""
        )
        line = (
            f"[tick {tick:>8}] event   {ev.get('source', '?')}:"
            f"{ev.get('kind', '?')}" + (f" ({detail})" if detail else "")
        )
        entries.append((tick, 1 + int(ev.get("seq", 0)), line))
    header = [
        f"flight dump: reason={dump['reason']} engine={dump['engine']} "
        f"ts={time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime(dump.get('ts', 0)))}",
        f"ring: {len(dump['ring']['rows'])} window(s) of "
        f"{len(names)} series; {len(dump['events'])} bus event(s)",
    ]
    if dump.get("trace"):
        tr = dump["trace"]
        header.append(
            f"trace: {len(tr.get('rows', []))} ring record(s), span trees "
            f"for {sorted(tr.get('span_trees', {}))}"
        )
    if dump.get("context"):
        header.append(f"context: {json.dumps(dump['context'], sort_keys=True)}")
    return header + [line for _, _, line in sorted(entries, key=lambda e: (e[0], e[1]))]


def default_dump_path(directory: Optional[str], reason: str) -> str:
    """flight-<utc-stamp>-<reason>.json under ``directory`` (or cwd)."""
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)
    name = f"flight-{stamp}-{safe}-{os.getpid()}.json"
    return os.path.join(directory or ".", name)
