"""The benchmark's files as the tests read them, and each configuration cut
to a CPU test's size."""

import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str, **over) -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


def traffic(name: str, sources: dict = None, **over) -> dict:
    """A traffic mix with top-level parameters replaced by ``over`` and
    each source's by ``sources[kind]``."""
    mix = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
    mix.update(over)
    for src in mix.get("sources", []):
        src.update((sources or {}).get(src["kind"], {}))
    return mix


#: each configuration cut to a CPU test's size: the engine's code paths
#: kept, the periods shortened so expiry, sweeps and SYNC fall in a few
#: tens of ticks
SMALL = {
    "sparse-100k": dict(capacity=128, mr_slots=32, announce_slots=16, fd_every=2, sync_every=10,
                        suspicion_mult=1, sweep_every=4),
    "pview-1m": dict(capacity=256, mr_slots=0, announce_slots=64, fd_every=2, sync_every=10,
                     suspicion_mult=1, sweep_every=4),
}

