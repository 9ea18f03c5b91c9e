"""Host time of the SYNC phase per tick: the benchmark's range around the
engine's SYNC phase function, on the host, in ms. Layer: the tick's SYNC
phase."""


def read(ctx: dict):
    us = ctx["trace"]["host_us"].get(f"phase:{ctx['sync_phase'].strip('_')}")
    return us / ctx["ticks"] / 1e3 if us is not None and ctx["ticks"] else None
