"""The membership-record pool's mean occupancy over the traced window: the
program's own per-tick count of active pool slots (``mr_active_count``)
averaged over the window's ticks, as a share of the pool's slots, in %.
Nothing to read where the configuration has no pool. Layer: the
membership-record pool (``ops/pool.py``)."""


def read(ctx: dict):
    slots = ctx["cfg"].get("mr_slots", 0)
    total = ctx["totals"].get("mr_active_count")
    if not slots or total is None or not ctx["ticks"]:
        return None
    return 100.0 * total / ctx["ticks"] / slots
