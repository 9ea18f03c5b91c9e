"""The device's idle share of the traced window: one minus the union of
the device's activity intervals (kernels, copies, fills) over the window's
wall time, in %. Layer: the device."""

from perfbench.harness import stats


def read(ctx: dict):
    return 100.0 * stats.idle_share(ctx["busy_us"] / 1e6, ctx["window_s"])
