"""The traced run: ``torch.profiler`` over the window, with the benchmark's
own labelled ranges around the calls into each layer, reduced to what the
per-layer metric readers read.

Ranges: ``phase:<name>`` around each tick phase function of the engine
module (the module attribute is swapped for a wrapper while the window
runs, and put back), ``bench:mutation``, ``bench:step`` and ``bench:read``
around each request's parts. A range shows twice in the profiler's
record: on the host, and on the device as the span of the work launched
inside it. The kernel's launches are observed by wrapping the port's
operator ``ops/delivery.py: _delivery_op``, which keeps each launch's
widths and, as a 0-d tensor on the device (no wait), its count of distinct
senders: what its needed bytes are counted from after the window."""

from __future__ import annotations

import contextlib

import torch

ANNOTATION_PREFIXES = ("phase:", "bench:")
KERNEL = "delivery_combine_kernel"


class Tracer:
    def __init__(self, engine_module, phases):
        self.mod = engine_module
        self.phases = phases
        self.launches = []  # (Wm, Wu, R, F, N, distinct senders as a 0-d tensor)
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        from scalecube_cluster_tpu_torch.ops import delivery

        def labelled(name, fn):
            def run(*args, **kwargs):
                with record_function(f"phase:{name.strip('_')}"):
                    return fn(*args, **kwargs)
            return run

        launches = self.launches
        op = delivery._delivery_op

        def observed(ym_p, yu_p, infected_from, inv, rumor_origin):
            F, n = inv.shape
            seen = torch.zeros((n + 1,), dtype=torch.bool, device=inv.device)
            seen.index_fill_(0, torch.where(inv >= 0, inv, n).reshape(-1).long(), True)
            launches.append((ym_p.shape[1], yu_p.shape[1], infected_from.shape[1], F, n, seen[:n].sum()))
            return op(ym_p, yu_p, infected_from, inv, rumor_origin)

        saved = {name: getattr(self.mod, name) for name in self.phases}
        try:
            for name, fn in saved.items():
                setattr(self.mod, name, labelled(name, fn))
            delivery._delivery_op = observed
            cuda = torch.cuda.is_available()
            if cuda:
                torch.cuda.synchronize()
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                yield
                if cuda:
                    torch.cuda.synchronize()
            self.prof = prof
        finally:
            delivery._delivery_op = op
            for name, fn in saved.items():
                setattr(self.mod, name, fn)

    def reduce(self) -> dict:
        """What the readers read, in microseconds: per-phase host time and
        device span, the device's activity intervals and its top
        operations, the kernel's device time, the host ranges (to label
        idle gaps)."""
        cuda = torch.autograd.DeviceType.CUDA
        host, span, ops, busy, ranges = {}, {}, {}, [], []
        kernel_us, kernel_n = 0.0, 0
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            on_dev = e.device_type() == cuda
            if name.startswith(ANNOTATION_PREFIXES):
                if on_dev:
                    span[name] = span.get(name, 0.0) + dur
                else:
                    host[name] = host.get(name, 0.0) + dur
                    ranges.append((start, start + dur, name))
            elif on_dev:
                busy.append((start, start + dur))
                ops[name] = ops.get(name, 0.0) + dur
                if KERNEL in name:
                    kernel_us += dur
                    kernel_n += 1
        return {"host_us": host, "span_us": span, "ops_us": ops, "busy": busy, "ranges": ranges,
                "kernel_us": kernel_us, "kernel_events": kernel_n}
