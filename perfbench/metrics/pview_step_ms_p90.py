"""The 90th percentile of the traced window's request times, in ms: the
host's pacing of a partial-view request. Layer: host pacing."""

from perfbench.harness import stats


def read(ctx: dict):
    return stats.p90(ctx["requests_s"]) * 1e3 if len(ctx["requests_s"]) > 1 else None
