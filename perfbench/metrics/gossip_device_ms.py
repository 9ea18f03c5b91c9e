"""Device span of the gossip phase per tick: the span on the device of the
work launched inside the benchmark's range around the engine's gossip
phase (with the membership apply, which runs inside it), in ms. A tick
that skips the phase's work adds nothing. Layer: the tick's gossip
phase."""


def read(ctx: dict):
    spans = ctx["trace"]["span_us"]
    hosts = ctx["trace"]["host_us"]
    names = [f"phase:{p.strip('_')}" for p in ctx["gossip_phases"]]
    if not any(n in hosts for n in names) or not ctx["ticks"]:
        return None
    return sum(spans.get(n, 0.0) for n in names) / ctx["ticks"] / 1e3
