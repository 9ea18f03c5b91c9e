"""The delivery kernel's share of its memory roofline: the least time the
card's HBM (3.35 TB/s) takes to move the bytes each traced launch needs
(``perfbench/harness/roofline.py``), summed, over the kernel's device time
in the trace, in %. Where the profiler recorded fewer launches than the
window made, the needed bytes are scaled to the recorded count. Nothing to
read where the window launched no kernel. Layer: the kernel
``csrc/delivery_combine.cu``."""

from perfbench.harness import roofline


def read(ctx: dict):
    launches = ctx["kernel_launches"]
    device_us = ctx["trace"]["kernel_us"]
    if not launches or device_us <= 0:
        return None
    bound = sum(roofline.bound_seconds(roofline.delivery_combine_bytes(wm, wu, r, f, n, int(senders)))
                for wm, wu, r, f, n, senders in launches)
    bound *= ctx["trace"]["kernel_events"] / len(launches)
    return 100.0 * bound / (device_us / 1e6)
