"""Peak device memory over the bytes of the engine's live state (every
tensor leaf, at the window's close). Layer: the engine's state."""


def read(ctx: dict):
    return ctx["peak_bytes"] / ctx["state_bytes"] if ctx["state_bytes"] else None
