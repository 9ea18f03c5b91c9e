"""Branch-flag reads per tick: the port's own counter of its device-to-host
flag reads (``ops/_tensor.py: HOST_SYNCS``) over the traced window, per
tick. Layer: the window runner."""


def read(ctx: dict):
    return ctx["flag_reads"] / ctx["ticks"] if ctx["ticks"] else None
