"""Host mutation time per mutating request: the benchmark's span around
each request's crash and join batch (the port's ``crash_rows`` and
``join_rows``), the device drained at both ends, in ms. Nothing to read in
a cell without mutations. Layer: the host mutators."""


def read(ctx: dict):
    spans = ctx["mutations_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
