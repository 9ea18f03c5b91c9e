"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the partial-view engine's tick window and
``SimDriver`` over it, both at 1,048,576 members, and the sparse engine's
window and ``SimDriver`` over it at 49,152 members — on the card, and fails
(non-zero exit, no result line) unless every phase passes:

1. device   — a CUDA device is present; prints its name and power limit;
2. build    — builds the port's CUDA kernel with nvcc; prints ptxas's
   registers, stack and spills for each compiled variant;
3. kernels  — each kernel against its plain PyTorch version on random
   inputs at the main path's shapes, and at shapes that reach its other
   compiled variants: bit-equal outputs, timed beside the byte bound;
4. window   — a 4,096-member, 40-tick fused window on the CPU (plain
   versions) and on the card (kernels) from the same draws: equal state
   and metrics;
5. main path — the 1M-member scenario (warm start, 8 live rumors, a crash
   wave of 1,024 rows): one warm-up window, then a timed 10-tick fused
   window with draws from a CUDA generator; launch counts are zeroed just
   before it and read just after, and the window's invariants are checked;
   two more ticks count the operations that wait for the device;
6. profile  — three more fused ticks under ``torch.profiler``: the
   device's busy share, each phase's device and host time, and the
   kernel's own device time per tick;
7. driver-window — a 4,096-member ``SimDriver`` script (spreads, a crash,
   a join, a leave, metadata bumps, a partition and its heal, two watched
   rows) on the CPU and on the card from the same draws: equal state,
   per-tick metrics and event logs;
8. driver   — the driver main path: ``SimDriver`` on the card at 1M (the
   config11 widths; warm start, 8 rumors through ``spread_rumor``, a crash
   wave of 1,024 rows through ``crash``, a ``join``, a ``leave``, two
   watched rows), a 5-tick warm-up, then three timed ``step(10)`` windows
   and ``sync()``, with the launch counts zeroed just before and read just
   after; then three ticks profiled by phase, as in phase 6;
9. checkpoint — a 65,536-member driver: ``step(5)``, ``checkpoint``,
   ``step(10)``, ``restore``, ``step(10)``: both trajectories bit-equal;
10. sparse-window — a 4,096-member, 40-tick sparse window with dense links
   (a crash wave, user rumors, a ``join_rows`` batch with rejoins, a
   partition and its heal) on the CPU and on the card from the same draws:
   equal state and metrics;
11. sparse-main — the sparse main path: config5's churn run at 49,152
   members (``benchmarks/config5_churn.py:sparse_main``: 1% of the members
   crash and as many join every simulated second of 5 ticks), 2 simulated
   seconds of warm-up, then 6 timed seconds (30 ticks) with draws from a
   CUDA generator, launch counts zeroed just before and read just after;
   ms/tick, the realtime factor, peak memory, flag reads, launches, and the
   invariants (``n_live`` against a recount, unique pool subjects);
12. sparse-profile — 5 more ticks, an FD tick and a sweep tick among them,
   under ``torch.profiler``, as in phase 6;
13. sparse-driver-window — phase 7's driver script on sparse params with
   dense links, on the CPU and on the card: equal;
14. sparse-driver — ``SimDriver`` on the card at 49,152 (config5's widths;
   2 rumors through ``spread_rumor``, a crash wave of 491 rows through
   ``crash``, 8 joins, two watched rows): a 5-tick warm-up, then three
   timed ``step(10)`` windows, launch counts zeroed before and read after.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

N_MAIN = 1 << 20
KERNEL_SHAPES = (65_536, 100_003, N_MAIN)  # the slice's N, one with N % 32 != 0
# (N, F, R, Wm, ym_offset, variant): the main path's widths at each N, then
# inputs that reach the kernel's other compiled variants; ``variant`` is
# what delivery.instantiation must pick (f_template 0: runtime F), and
# ym_offset > 0 starts ym_p that many words into its rows
N_SPARSE = 49_152
SPARSE_CASE = (N_SPARSE, 3, 2, 96, 0)  # the sparse path: 2 rumors, a 3,072-slot pool
KERNEL_CASES = tuple((n, 3, 8, 64, 0, ("vector", 3)) for n in KERNEL_SHAPES) + (
    SPARSE_CASE + (("vector", 3),),
    (100_003, 1, 33, 5, 0, ("scalar", 1)),  # Wm % 4 != 0, R > 32
    (65_536, 6, 8, 64, 0, ("vector", 0)),   # F above the templates
    (65_536, 3, 8, 64, 1, ("scalar", 3)),   # ym_p's base off 16 bytes
)
TICKS_PER_SECOND = 5  # config5's simulated second
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_cuda(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, kernel: str, reps: int = 20, warmup: int = 3) -> float:
    """Median device time in ms of the kernel named ``kernel`` over ``reps``
    calls of ``fn``, from the profiler's record of the device: a call's own
    host work (checks, allocation) does not count, as it would between two
    CUDA events around one call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if len(times) != reps:
        raise AssertionError(f"profiler saw {len(times)} launches of {kernel}, expected {reps}")
    return statistics.median(times) / 1e3


def config16_params(n: int, key_dtype: str = "i16"):
    """The fused benchmark's 1M-wall configuration (benchmarks/config16_fused.py)."""
    from scalecube_cluster_tpu_torch.ops.pview import PviewParams

    return PviewParams(
        capacity=n, view_slots=24, active_slots=8, fanout=3, repeat_mult=3,
        ping_req_k=3, fd_every=5, sync_every=150, suspicion_mult=5,
        rumor_slots=8, seed_rows=(0,), key_dtype=key_dtype,
    )


def busy_state(params, n: int, device):
    """Warm cluster, a live rumor in every slot, a crash wave of n/1024 rows."""
    from scalecube_cluster_tpu_torch.ops import pview as PV

    st = PV.init_pview_state(params, n, warm=True, device=device)
    for s in range(params.rumor_slots):
        st = PV.spread_rumor(st, s, origin=(s * 997) % n)
    return PV.crash_rows(st, list(range(n // 2, n // 2 + max(2, n // 1024))))


def delivery_inputs(n: int, gen: torch.Generator, F: int = 3, R: int = 8, Wm: int = 64,
                    ym_offset: int = 0):
    """Random sender planes (ym_p, yu_p, infected_from), and inv with -1s and
    duplicate senders. ``ym_offset`` > 0 makes ym_p a column slice of a
    wider tensor, so its base is ``4 * ym_offset`` bytes past an allocation."""
    dev = gen.device
    Wu = -(-R // 32)

    def words(rows, cols):
        return torch.randint(-(1 << 31), 1 << 31, (rows, cols), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    ym_p = words(n, Wm + ym_offset)[:, ym_offset:]
    yu_p = words(n, Wu)
    infected_from = torch.randint(-1, n, (n, R), generator=gen, device=dev, dtype=torch.int32)
    inv = torch.randint(-1, n, (F, n), generator=gen, device=dev, dtype=torch.int32)
    inv[:, : n // 4] = -1
    inv[:, n // 4 : n // 2] = torch.randint(0, 3, (F, n // 2 - n // 4), generator=gen,
                                            device=dev, dtype=torch.int32)
    origin = torch.randint(-1, n, (R,), generator=gen, device=dev, dtype=torch.int32)
    return ym_p, yu_p, infected_from, inv.contiguous(), origin


def delivery_bytes(ym_p, yu_p, infected_from, inv, reuse: bool) -> int:
    """Bytes the combine moves: inv and the origins read once, the outputs
    (u_or as bytes, src_max, m_or, the count) written once, and a sender row
    (Wm + Wu + R words) per distinct valid sender with ``reuse`` (a row that
    several slots name is fetched once: the bound), else per valid slot
    (what a pull kernel moves when no row is found in cache)."""
    F, n = inv.shape
    Wm, R = ym_p.shape[1], infected_from.shape[1]
    Wt = Wm + yu_p.shape[1] + R
    valid = inv[inv >= 0]
    rows = torch.unique(valid).numel() if reuse else valid.numel()
    return 4 * F * n + 4 * R + 4 * Wt * rows + n * (R + 4 * R + 4 * Wm) + 4


def bytes_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def ptxas_report(log: str) -> list:
    """One line per compiled kernel variant from ptxas's -v output:
    template arguments (lanes per receiver, vector path, F or 0 for
    runtime F), registers, stack and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"ILi(\d+)ELb([01])ELi(\d+)EE", name)
            name = f"G={t.group(1)} vec={t.group(2)} F={t.group(3)}" if t else name
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            stack, st, ld = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, stack {stack} B, "
                       f"spill stores {st} B, spill loads {ld} B")
            name = None
    return out


def check_kernels(device) -> dict:
    from scalecube_cluster_tpu_torch.ops import delivery

    gen = torch.Generator(device=device).manual_seed(1)
    rows = {}
    for n, F, R, Wm, ym_offset, want in KERNEL_CASES:
        planes = delivery_inputs(n, gen, F, R, Wm, ym_offset)
        ym_p, yu_p, infected_from, inv, origin = planes
        variant = delivery.instantiation(Wm, F, ym_p.data_ptr(), ym_p.stride(0))
        label = f"N={n} F={F} R={R} Wm={Wm}, ym offset {ym_offset}: {variant[0]} path, " + (
            f"F template {variant[1]}" if variant[1] else "runtime F")
        if variant != want:
            raise AssertionError(f"{label}; expected {want}")
        got = delivery.delivery_combine(*planes)
        payload = torch.cat([ym_p, yu_p, infected_from], dim=1)
        ref_args = (payload, inv, origin, Wm, R)
        ref = delivery.delivery_combine_ref(*ref_args)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, ref))
        if err != 0:
            raise AssertionError(f"delivery_combine differs from its plain version at {label}: "
                                 f"max abs err {err}")
        valid = int((inv >= 0).sum())
        senders = torch.unique(inv[inv >= 0]).numel()
        ms = kernel_ms(lambda: delivery.delivery_combine(*planes), "delivery_combine_kernel")
        call_ms = time_cuda(lambda: delivery.delivery_combine(*planes), reps=20)
        plain_ms = time_cuda(lambda: delivery.delivery_combine_ref(*ref_args), reps=5, warmup=1)
        bound = bytes_ms(delivery_bytes(*planes[:4], reuse=True))
        slot_bytes = delivery_bytes(*planes[:4], reuse=False)
        rows[(n, F, R, Wm, ym_offset)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)
        phase("kernels", f"delivery_combine {label}: bit-equal, kernel {ms:.4f} ms "
                         f"(wrapper call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                         f"{bound:.4f} ms (roofline share {bound / ms:.3f}), no-reuse slot traffic "
                         f"{bytes_ms(slot_bytes):.4f} ms ({slot_bytes / ms / 1e9:.2f} TB/s at that "
                         f"traffic), valid slots {valid} of {inv.numel()}, distinct senders {senders}")
        if n == N_MAIN:
            cat_ms = time_cuda(lambda: torch.cat([ym_p, yu_p, infected_from], dim=1), reps=20)
            phase("kernels", f"N={n}: the payload copy the gossip phase no longer makes "
                             f"(torch.cat of the three planes) {cat_ms:.4f} ms")
        del planes, ym_p, yu_p, infected_from, inv, origin, payload, ref, got
    return rows


def check_cross_device(device) -> None:
    """40 ticks at N = 4,096 on the CPU and on the card from the same draws."""
    from scalecube_cluster_tpu_torch import convert
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import rand as PR

    n, ticks = 4096, 40
    params = config16_params(n)
    gen = torch.Generator(device="cpu").manual_seed(7)
    draws = [
        (PR.draw_sparse_fd(gen, n, params.ping_req_k, params.sample_tries),
         PR.draw_sparse_round(gen, n, params.fanout, params.sample_tries))
        for _ in range(ticks)
    ]
    cpu_st, cpu_ms, _ = PV.run_pview_ticks_fused(busy_state(params, n, "cpu"), draws, ticks, params)
    dev_st, dev_ms, _ = PV.run_pview_ticks_fused(busy_state(params, n, device), draws, ticks, params)
    a, b = convert.state_to_numpy(cpu_st), convert.state_to_numpy(dev_st)
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    for k, v in cpu_ms.items():
        va, vb = v.numpy(), dev_ms[k].cpu().numpy()
        if va.dtype == np.float32:
            # f32 division on the two devices: both IEEE, allow 2 ulp anyway
            if np.abs(va.view(np.int32).astype(np.int64) - vb.view(np.int32).astype(np.int64)).max() > 2:
                bad.append(f"metric {k}")
        elif not np.array_equal(va, vb):
            bad.append(f"metric {k}")
    if bad:
        raise AssertionError(f"CPU and card windows differ in: {bad}")
    phase("window", f"N={n}, {ticks} ticks: every state leaf and metric equal on CPU and {device}; "
                    f"mr_accepts {int(cpu_ms['mr_accepts'].sum())}, sync_roundtrips "
                    f"{int(cpu_ms['sync_roundtrips'].sum())}, rumor_deliveries {int(cpu_ms['rumor_deliveries'].sum())}")


def run_main_path(device) -> dict:
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery
    from scalecube_cluster_tpu_torch.ops import pview as PV

    n = N_MAIN
    params = config16_params(n)
    t0 = time.perf_counter()
    st = busy_state(params, n, device)
    torch.cuda.synchronize()
    phase("main", f"N={n} state built in {time.perf_counter() - t0:.2f} s "
                  f"(minf_age {tuple(st.minf_age.shape)} {st.minf_age.dtype})")
    gen = torch.Generator(device=device).manual_seed(11)
    t0 = time.perf_counter()
    st, _, _ = PV.run_pview_ticks_fused(st, gen, 5, params)
    torch.cuda.synchronize()
    phase("main", f"warm-up window of 5 ticks: {time.perf_counter() - t0:.2f} s")

    ticks = 10
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    st, ms, _ = PV.run_pview_ticks_fused(st, gen, ticks, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = delivery.delivery_combine.launches
    syncs = _tensor.HOST_SYNCS.count
    peak = torch.cuda.max_memory_allocated()

    # two more ticks in the mode where every operation that waits for the
    # device warns: the count shows whether the branch flags are the only
    # syncs (the mode is kept out of the timed window, which it perturbs)
    _tensor.HOST_SYNCS.count = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st, _, _ = PV.run_pview_ticks_fused(st, gen, 2, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    device_waits = sum("synchroniz" in str(w.message) for w in caught)
    flag_reads = _tensor.HOST_SYNCS.count

    n_crash = n // 1024
    n_up = ms["n_up"].cpu()
    if not bool((n_up == n - n_crash).all()):
        raise AssertionError(f"n_up {n_up.tolist()} != {n - n_crash}")
    ids = st.nbr_id
    rows = torch.arange(n, device=ids.device, dtype=ids.dtype)[:, None]
    if bool(((ids >= 0) & (ids == rows)).any()):
        raise AssertionError("a row tables itself")
    srt = ids.sort(dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError("a row tables one member twice")
    cov = ms["rumor_coverage"]
    if not bool(torch.isfinite(cov).all()) or bool((cov[1:] < cov[:-1]).any()):
        raise AssertionError(f"rumor coverage fell or is not finite: {cov.cpu().tolist()}")
    if launches <= 0:
        raise AssertionError("the main path launched no delivery_combine kernel")
    for k, v in ms.items():
        if v.shape[0] != ticks:
            raise AssertionError(f"metric {k} has {v.shape[0]} ticks, expected {ticks}")
    phase("main", f"N={n}, {ticks} ticks: {wall / ticks * 1e3:.2f} ms/tick, peak allocated "
                  f"{peak / 2 ** 30:.2f} GiB, delivery_combine launches {launches}, host syncs {syncs} "
                  f"({syncs / ticks:.1f}/tick), final coverage {cov[-1].cpu().tolist()}")
    phase("main", f"2 more ticks: {flag_reads} branch-flag reads, {device_waits} operations "
                  "waited for the device")
    return {"launches": launches, "state": st, "gen": gen, "params": params}


PHASES = ("_fd_phase", "_maintenance_sweep", "_gossip_phase_fused", "_sync_phase",
          "_refute_phase", "_rumor_sweeps_fused", "alloc_phase", "state_metrics")


def profile_phases(run, phases, ticks: int = 3, label: str = "profile", module=None) -> None:
    """Where a tick's time goes: ``torch.profiler`` over ``run()``, which
    runs ``ticks`` more ticks of a main path, each function of ``phases``
    (in ``module``, by default ``ops/pview.py``) inside a labelled range.
    Prints the wall time per tick, the device's busy share, each phase's
    device and host time, and the kernels that took the most device
    time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from scalecube_cluster_tpu_torch.ops import pview

    PV = module or pview

    def labelled(name, fn):
        def run_labelled(*args, **kwargs):
            with record_function(f"phase:{name.strip('_')}"):
                return fn(*args, **kwargs)
        return run_labelled

    saved = {name: getattr(PV, name) for name in phases}
    try:
        for name, fn in saved.items():
            setattr(PV, name, labelled(name, fn))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for name, fn in saved.items():
            setattr(PV, name, fn)
    cuda = torch.autograd.DeviceType.CUDA
    host, span, busy = {}, {}, []
    for e in prof.events():
        if e.name.startswith("phase:"):
            # a labelled range shows twice: on the host, and as the span of
            # its kernels on the device
            book = span if e.device_type == cuda else host
            book[e.name[6:]] = book.get(e.name[6:], 0) + e.time_range.elapsed_us()
        elif e.device_type == cuda:
            busy.append((e.time_range.start, e.time_range.end))
    device_us, reach = 0, float("-inf")
    for a, b in sorted(busy):  # the union of the device's activity intervals
        device_us += max(0, b - max(a, reach))
        reach = max(reach, b)
    if device_us == 0:
        phase(label, f"{ticks} ticks: {wall_us / ticks / 1e3:.2f} ms/tick wall; device time "
                     "not measured (the profiler recorded no device activity)")
        return
    phase(label, f"{ticks} ticks: {wall_us / ticks / 1e3:.2f} ms/tick wall, device busy "
                 f"{device_us / ticks / 1e3:.2f} ms/tick, idle share {1 - device_us / wall_us:.3f}")
    for name in sorted(host, key=lambda k: -host[k]):
        phase(label, f"{name}: host {host[name] / ticks / 1e3:.3f} ms/tick, device span "
                     f"{span.get(name, 0) / ticks / 1e3:.3f} ms/tick")
    kernels = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                      if e.self_device_time_total > 0 and not e.key.startswith(("phase:", "aten::"))),
                     reverse=True)
    for us, key, count in kernels[:8]:
        phase(label, f"top kernel {key[:90]}: {us / ticks / 1e3:.3f} ms/tick ({count} launches)")
    ours = [(us, count) for us, key, count in kernels if "delivery_combine_kernel" in key]
    phase(label, f"delivery_combine_kernel: {sum(u for u, _ in ours) / ticks / 1e3:.4f} "
                 f"ms/tick device time ({sum(c for _, c in ours)} launches in {ticks} ticks)")


def state_differences(a, b) -> list:
    """Names of the state leaves in which two states differ."""
    from scalecube_cluster_tpu_torch import convert

    a, b = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return [k for k in a if not np.array_equal(a[k], b[k])]


class DrawList:
    """A driver's ``draws`` source over a fixed list of per-tick draws, made
    on the CPU: each window takes the next ticks' pairs."""

    def __init__(self, draws):
        self.draws, self.pos = draws, 0

    def __call__(self, n_ticks: int):
        out = self.draws[self.pos:self.pos + n_ticks]
        self.pos += n_ticks
        return out


def cpu_draws(params, ticks: int, seed: int) -> list:
    from scalecube_cluster_tpu_torch.ops import rand as PR

    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [(PR.draw_sparse_fd(gen, params.capacity, params.ping_req_k, params.sample_tries),
             PR.draw_sparse_round(gen, params.capacity, params.fanout, params.sample_tries))
            for _ in range(ticks)]


def driver_script(d, n: int) -> None:
    """The driver-window script: two watched rows, spreads, a crash, a
    join, a leave, metadata bumps, a partition and its heal (40 ticks)."""
    for row in (0, n // 3):
        d.watch(row)
    for s in range(d.params.rumor_slots):
        d.spread_rumor((s * 997) % n, f"rumor {s}")
    for r in range(n // 2, n // 2 + max(2, n // 1024)):
        d.crash(r)
    d.step(10)
    d.join()
    d.leave(7)
    d.update_metadata(11)
    d.update_metadata_batch([11, 12, 13])
    d.step(13)
    halves = (list(range(n // 2)), list(range(n // 2, n)))
    d.block_partition(*halves)
    d.step(10)
    d.heal_partition(*halves)
    d.step(7)


def check_driver_window(device, n: int = 4096, params=None, label: str = "driver-window",
                        dense_links=None) -> None:
    """The ``n``-member driver script on the CPU and on the card from the
    same draws (``params``: the pview 1M configuration's widths by
    default)."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    ticks = 40
    params = params or config16_params(n)
    draws = cpu_draws(params, ticks, seed=13)
    drivers = []
    for dev in ("cpu", device):
        d = SimDriver(params, n, seed=0, record_metrics=True, device=dev, draws=DrawList(draws),
                      dense_links=dense_links)
        driver_script(d, n)
        drivers.append(d)
    a, b = drivers
    bad = state_differences(a.state, b.state)
    if len(a.metrics_history) != ticks or len(b.metrics_history) != ticks:
        bad.append("metrics history length")
    for i, (ma, mb) in enumerate(zip(a.metrics_history, b.metrics_history)):
        for k, va in ma.items():
            vb = mb[k]
            if va.dtype == np.float32:
                if np.abs(va.view(np.int32).astype(np.int64) - vb.view(np.int32).astype(np.int64)).max() > 2:
                    bad.append(f"metric {k} at tick {i}")
            elif not np.array_equal(va, vb):
                bad.append(f"metric {k} at tick {i}")
    events = {}
    for row in a._watches:
        ea = [(e.type.value, e.member.id) for e in a.events_of(row)]
        eb = [(e.type.value, e.member.id) for e in b.events_of(row)]
        if ea != eb:
            bad.append(f"events of row {row}")
        events[row] = len(ea)
    if a.health_counters != b.health_counters:
        bad.append("health counters")
    if bad:
        raise AssertionError(f"CPU and card drivers differ in: {sorted(set(bad))}")
    hist = a.metrics_history
    phase(label, f"N={n}, {ticks} ticks through SimDriver: every state leaf, per-tick metric "
                           f"and event log equal on CPU and {device}; events per watched row {events}, "
                           f"mr_accepts {sum(int(m['mr_accepts']) for m in hist)}, sync_roundtrips "
                           f"{sum(int(m['sync_roundtrips']) for m in hist)}, rumor_deliveries "
                           f"{sum(int(m['rumor_deliveries']) for m in hist)}")


def main_path_driver(device):
    """The driver main path's scenario at N_MAIN: the config11 widths
    (benchmarks/config11_pview.py), a warm start, 8 rumors through
    ``spread_rumor``, a crash wave of N/1024 rows through ``crash``, one
    ``join``, one ``leave``, two watched rows. Returns (driver, rumor
    slots, watched rows)."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    n = N_MAIN
    params = config16_params(n)
    d = SimDriver(params, n, warm=True, seed=0, device=device)
    slots = [d.spread_rumor((s * 997) % n, f"rumor {s}") for s in range(params.rumor_slots)]
    for r in range(n // 2, n // 2 + n // 1024):
        d.crash(r)
    d.join()
    d.leave(777)
    watched = (0, n // 3)
    for row in watched:
        d.watch(row)
    return d, slots, watched


def run_driver_path(device) -> dict:
    """SimDriver at 1M on the card: the driver main path."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery

    n = N_MAIN
    n_crash = n // 1024
    t0 = time.perf_counter()
    d, slots, watched = main_path_driver(device)
    torch.cuda.synchronize()
    phase("driver", f"N={n} driver built, 8 rumors spread, {n_crash} rows crashed, a row joined, "
                    f"row 777 leaving, rows {watched} watched: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    d.step(5)
    d.sync()
    phase("driver", f"warm-up step(5): {time.perf_counter() - t0:.2f} s")

    windows, per = 3, 10
    ticks = windows * per
    readbacks = d.dispatch_stats["readbacks"]
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    for _ in range(windows):
        last = d.step(per)
    d.sync()
    wall = time.perf_counter() - t0
    launches = delivery.delivery_combine.launches
    flags = _tensor.HOST_SYNCS.count
    peak = torch.cuda.max_memory_allocated()
    readbacks = d.dispatch_stats["readbacks"] - readbacks

    if launches != ticks:
        raise AssertionError(f"{launches} delivery_combine launches in {ticks} driver ticks, expected {ticks}")
    n_up = int(last["n_up"])
    if n_up != n - n_crash + 1:
        raise AssertionError(f"n_up {n_up} != {n - n_crash + 1}")
    ids = d.state.nbr_id
    rows = torch.arange(n, device=ids.device, dtype=ids.dtype)[:, None]
    if bool(((ids >= 0) & (ids == rows)).any()):
        raise AssertionError("a row tables itself")
    srt = ids.sort(dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError("a row tables one member twice")
    cov = [d.rumor_coverage(s) for s in slots]
    if not all(np.isfinite(c) and 0.0 < c <= 1.0 for c in cov):
        raise AssertionError(f"rumor coverage out of range: {cov}")
    events = {row: len(d.events_of(row)) for row in watched}
    kinds = sorted({e.type.value for row in watched for e in d.events_of(row)})
    snap = d.health_snapshot()
    phase("driver", f"N={n}, {windows} x step({per}): {wall / ticks * 1e3:.2f} ms/tick, peak allocated "
                    f"{peak / 2 ** 30:.2f} GiB, delivery_combine launches {launches} in {ticks} ticks, "
                    f"branch-flag reads {flags} ({flags / ticks:.1f}/tick), driver readbacks {readbacks}")
    phase("driver", f"events per watched row {events} ({kinds}), rumor_coverage "
                    f"{[round(c, 4) for c in cov]}")
    phase("driver", f"health_snapshot: tick {snap['tick']}, n_up {snap['n_up']}, announce "
                    f"{snap['announce']}, pool {snap['pool']}, stale subjects "
                    f"{snap['staleness']['stale_subjects']}, worst recent-join coverage "
                    f"{snap['staleness']['worst_recent_join_coverage']}, dispatch {snap['dispatch']}")
    return {"launches": launches, "driver": d}


def check_checkpoint(device, n: int = 65_536) -> None:
    """step(5), checkpoint, step(10), restore, step(10) on an ``n``-member
    driver on the card: both trajectories end bit-equal, events included."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    params = config16_params(n)
    d = SimDriver(params, n, seed=0, device=device)
    for s in range(params.rumor_slots):
        d.spread_rumor((s * 997) % n, f"rumor {s}")
    for r in range(n // 2, n // 2 + n // 1024):
        d.crash(r)
    d.watch(0)
    d.step(5)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "driver.npz")
        t0 = time.perf_counter()
        d.checkpoint(path)
        ck_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        at = len(d.events_of(0))
        d.step(10)
        first, first_events = d.state, [(e.type, e.member.id) for e in d.events_of(0)[at:]]
        t0 = time.perf_counter()
        d.restore(path)
        torch.cuda.synchronize()
        rs_s = time.perf_counter() - t0
    at = len(d.events_of(0))
    d.step(10)
    bad = state_differences(first, d.state)
    if [(e.type, e.member.id) for e in d.events_of(0)[at:]] != first_events:
        bad.append("events of row 0")
    if bad:
        raise AssertionError(f"checkpoint round trip at N={n} differs in: {bad}")
    phase("checkpoint", f"N={n}: step(5), checkpoint ({size} bytes, {ck_s:.2f} s), step(10), restore "
                        f"({rs_s:.2f} s), step(10): both trajectories bit-equal, "
                        f"{len(first_events)} events each (tick {d.tick})")

# -- the sparse engine -----------------------------------------------------------


def config5_params(n: int, **over):
    """config5's churn configuration (benchmarks/config5_churn.py:sparse_main)
    at ``n`` members: pool of max(1024, n / 16) slots."""
    from scalecube_cluster_tpu_torch.ops.sparse import SparseParams

    knobs = dict(fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5, sync_every=150,
                 suspicion_mult=5, rumor_slots=2, mr_slots=max(1024, n // 16),
                 announce_slots=1024, seed_rows=(0, 1, 2, 3))
    return SparseParams(capacity=n, **{**knobs, **over})


def churn_schedule(n: int, seconds: int, seed_rows):
    """config5's host-side churn schedule at its default 1% per simulated
    second: that many members (``churn``) crash — up rows other than the
    seeds, drawn by ``np.random.default_rng(0)`` — and as many free rows
    join. The run starts with ``n - churn`` members up. Returns (churn,
    crash rows per second, join rows per second)."""
    churn = max(1, n // 100)
    rng = np.random.default_rng(0)
    up = np.arange(n) < n - churn
    free = [int(r) for r in np.nonzero(~up)[0]]
    seeds = set(int(s) for s in seed_rows)
    crash, join = [], []
    for _ in range(seconds):
        up_rows = np.asarray([r for r in np.nonzero(up)[0] if int(r) not in seeds], np.int32)
        c = rng.choice(up_rows, size=churn, replace=False)
        j = np.asarray(free[:churn], np.int32)
        free = free[churn:]
        crash.append(c)
        join.append(j)
        up[c] = False
        up[j] = True
        free.extend(int(r) for r in c)
    return churn, crash, join


def churn_second(st, params, crash, join, draws):
    """One simulated second of config5: the second's crashes, its joins,
    then 5 ticks. Returns (state, stacked metrics)."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    st = SP.join_rows(SP.crash_rows(st, crash), join, params.seed_rows)
    st, ms, _ = SP.run_sparse_ticks(st, draws, TICKS_PER_SECOND, params)
    return st, ms


def sparse_invariants(st) -> None:
    """``n_live`` equals a recount of every up row's non-DEAD columns (row
    chunks, int32); active pool slots carry unique subjects."""
    from scalecube_cluster_tpu_torch.ops import _tensor

    n = st.capacity
    for lo, hi in _tensor.plane_chunks(n, n):
        recount = ((st.view_key[lo:hi] & 3) != 3).sum(dim=1, dtype=torch.int32)
        bad = st.up[lo:hi] & (recount != st.n_live[lo:hi])
        if bool(bad.any()):
            raise AssertionError(f"n_live drifts from a recount on {int(bad.sum())} up rows in [{lo}, {hi})")
    subjects = st.mr_subject[st.mr_active]
    if torch.unique(subjects).numel() != subjects.numel():
        raise AssertionError("two active pool slots carry one subject")


def check_sparse_window(device, n: int = 4096) -> None:
    """40 sparse ticks at N = 4,096 with dense links on the CPU and on the
    card from the same draws: config5's widths, with a 2-tick FD period, a
    one-period suspicion timeout and a 20-tick SYNC period so that expiry
    and anti-entropy happen inside the window."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    ticks = 40
    params = config5_params(n, fd_every=2, suspicion_mult=1, sync_every=20)
    draws = cpu_draws(params, ticks, seed=17)
    halves = (list(range(n // 2)), list(range(n // 2, n)))
    crashed = list(range(n // 2, n // 2 + 16))

    def run(dev):
        st = SP.init_sparse_state(params, n - 8, dense_links=True, device=dev)
        st = SP.crash_rows(SP.spread_rumor(st, 0, 5), crashed)
        st, ms_a, _ = SP.run_sparse_ticks(st, draws[:10], 10, params)
        st = SP.join_rows(st, [n - 8, n - 7] + crashed[:2], params.seed_rows)  # two rejoins
        st = SP.block_partition(SP.spread_rumor(st, 1, 77), *halves)
        st, ms_b, _ = SP.run_sparse_ticks(st, draws[10:25], 15, params)
        st = SP.heal_partition(st, *halves)
        st, ms_c, _ = SP.run_sparse_ticks(st, draws[25:], 15, params)
        return st, {k: torch.cat([ms_a[k], ms_b[k], ms_c[k]]).cpu() for k in ms_a}

    cpu_st, cpu_ms = run("cpu")
    dev_st, dev_ms = run(device)
    bad = state_differences(cpu_st, dev_st)
    for k, va in cpu_ms.items():
        va, vb = va.numpy(), dev_ms[k].numpy()
        if va.dtype == np.float32:
            if np.abs(va.view(np.int32).astype(np.int64) - vb.view(np.int32).astype(np.int64)).max() > 2:
                bad.append(f"metric {k}")
        elif not np.array_equal(va, vb):
            bad.append(f"metric {k}")
    if bad:
        raise AssertionError(f"CPU and card sparse windows differ in: {bad}")
    sums = {k: int(cpu_ms[k].sum()) for k in ("mr_accepts", "sync_roundtrips", "fd_new_suspects",
                                               "rumor_deliveries", "announced", "pool_evicted")}
    phase("sparse-window", f"N={n}, {ticks} ticks, dense links: every state leaf and metric equal on "
                           f"CPU and {device}; {sums}")


def run_sparse_main_path(device) -> dict:
    """The sparse main path: config5's churn run at N_SPARSE."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    n = N_SPARSE
    params = config5_params(n)
    warm_s, timed_s = 2, 6
    churn, crash, join = churn_schedule(n, warm_s + timed_s, params.seed_rows)
    t0 = time.perf_counter()
    st = SP.init_sparse_state(params, n - churn, warm=True, device=device)
    torch.cuda.synchronize()
    phase("sparse-main", f"N={n} state built in {time.perf_counter() - t0:.2f} s: view_key "
                         f"{tuple(st.view_key.shape)} {st.view_key.dtype}, minf_age {tuple(st.minf_age.shape)}, "
                         f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; churn {churn} "
                         f"crashes and {churn} joins per simulated second")
    gen = torch.Generator(device=device).manual_seed(11)
    t0 = time.perf_counter()
    for sec in range(warm_s):
        st, _ = churn_second(st, params, crash[sec], join[sec], gen)
    torch.cuda.synchronize()
    phase("sparse-main", f"warm-up, {warm_s} simulated seconds ({warm_s * TICKS_PER_SECOND} ticks): "
                         f"{time.perf_counter() - t0:.2f} s")

    ticks = timed_s * TICKS_PER_SECOND
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    per_s = []
    for sec in range(warm_s, warm_s + timed_s):
        st, ms = churn_second(st, params, crash[sec], join[sec], gen)
        per_s.append(ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = delivery.delivery_combine.launches
    flags = _tensor.HOST_SYNCS.count
    peak = torch.cuda.max_memory_allocated()
    ms = {k: torch.cat([m[k] for m in per_s]).cpu() for k in per_s[0]}

    if launches <= 0:
        raise AssertionError("the sparse main path launched no delivery_combine kernel")
    if not bool((ms["n_up"] == n - churn).all()):
        raise AssertionError(f"n_up {ms['n_up'].tolist()} != {n - churn}")
    for k in ("fd_probes", "mr_accepts", "announced", "sync_roundtrips"):
        if int(ms[k].sum()) <= 0:
            raise AssertionError(f"the churn window never ran {k}")
    sparse_invariants(st)
    ms_tick = wall / ticks * 1e3
    phase("sparse-main", f"N={n}, {timed_s} simulated seconds ({ticks} ticks, churn included): "
                         f"{ms_tick:.2f} ms/tick, realtime factor {1000 / (TICKS_PER_SECOND * ms_tick):.3f}, "
                         f"peak allocated {peak / 2 ** 30:.2f} GiB, delivery_combine launches {launches}, "
                         f"branch-flag reads {flags} ({flags / ticks:.1f}/tick); invariants held")
    phase("sparse-main", f"pool high-water {int(ms['mr_active_count'].max())} of {params.mr_slots}, announced "
                         f"{int(ms['announced'].sum())}, dropped {int(ms['announce_dropped'].sum())} (fd "
                         f"{int(ms['announce_dropped_fd'].sum())}, expiry {int(ms['announce_dropped_expiry'].sum())}, "
                         f"refute {int(ms['announce_dropped_refute'].sum())}, sync "
                         f"{int(ms['announce_dropped_sync'].sum())}), evicted {int(ms['pool_evicted'].sum())}, "
                         f"new suspects {int(ms['fd_new_suspects'].sum())}, mr_accepts {int(ms['mr_accepts'].sum())}")
    return {"launches": launches, "state": st, "gen": gen, "params": params}


SPARSE_PHASES = ("_fd_phase", "_suspicion_sweep", "_gossip_phase_fused", "_mr_apply", "_sync_phase",
                 "_refute_phase", "_rumor_sweeps_fused", "alloc_phase", "state_metrics")


def profile_sparse(run) -> None:
    """5 sparse ticks under the profiler, ending on a sweep tick (an FD tick
    falls in any 5)."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    st, gen, params = run["state"], run["gen"], run["params"]
    ahead = (-(st.tick + 5)) % params.sweep_every
    if ahead:
        st, _, _ = SP.run_sparse_ticks(st, gen, ahead, params)
    phase("sparse-profile", f"ticks {st.tick + 1}-{st.tick + 5}")
    profile_phases(lambda: SP.run_sparse_ticks(st, gen, 5, params), SPARSE_PHASES, ticks=5,
                   label="sparse-profile", module=SP)


def run_sparse_driver_path(device) -> dict:
    """SimDriver at N_SPARSE on the card: the sparse driver main path."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery
    from scalecube_cluster_tpu_torch.sim import SimDriver

    n = N_SPARSE
    params = config5_params(n)
    churn = max(1, n // 100)
    t0 = time.perf_counter()
    d = SimDriver(params, n, warm=True, seed=0, device=device)
    slots = [d.spread_rumor((s * 997) % n, f"rumor {s}") for s in range(params.rumor_slots)]
    for r in range(n // 2, n // 2 + churn):
        d.crash(r)
    joined = [d.join(seed_rows=params.seed_rows) for _ in range(8)]
    watched = (0, n // 3)
    for row in watched:
        d.watch(row)
    torch.cuda.synchronize()
    phase("sparse-driver", f"N={n} driver built, {len(slots)} rumors spread, {churn} rows crashed, rows "
                           f"{joined} joined, rows {watched} watched: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    d.step(5)
    d.sync()
    phase("sparse-driver", f"warm-up step(5): {time.perf_counter() - t0:.2f} s")

    windows, per = 3, 10
    ticks = windows * per
    readbacks = d.dispatch_stats["readbacks"]
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    for _ in range(windows):
        last = d.step(per)
    d.sync()
    wall = time.perf_counter() - t0
    launches = delivery.delivery_combine.launches
    flags = _tensor.HOST_SYNCS.count
    peak = torch.cuda.max_memory_allocated()
    readbacks = d.dispatch_stats["readbacks"] - readbacks

    if launches <= 0:
        raise AssertionError("the sparse driver path launched no delivery_combine kernel")
    n_up = int(last["n_up"])
    if n_up != n - churn + len(joined):
        raise AssertionError(f"n_up {n_up} != {n - churn + len(joined)}")
    sparse_invariants(d.state)
    cov = [d.rumor_coverage(s) for s in slots]
    if not all(np.isfinite(c) and 0.0 < c <= 1.0 for c in cov):
        raise AssertionError(f"rumor coverage out of range: {cov}")
    events = {row: len(d.events_of(row)) for row in watched}
    kinds = sorted({e.type.value for row in watched for e in d.events_of(row)})
    snap = d.health_snapshot()
    ms_tick = wall / ticks * 1e3
    phase("sparse-driver", f"N={n}, {windows} x step({per}): {ms_tick:.2f} ms/tick (realtime factor "
                           f"{1000 / (TICKS_PER_SECOND * ms_tick):.3f}), peak allocated {peak / 2 ** 30:.2f} GiB, "
                           f"delivery_combine launches {launches} in {ticks} ticks, branch-flag reads {flags} "
                           f"({flags / ticks:.1f}/tick), driver readbacks {readbacks}; invariants held")
    phase("sparse-driver", f"events per watched row {events} ({kinds}), rumor_coverage "
                           f"{[round(c, 4) for c in cov]}")
    phase("sparse-driver", f"health_snapshot: tick {snap['tick']}, n_up {snap['n_up']}, announce "
                           f"{snap['announce']}, pool {snap['pool']}, stale subjects "
                           f"{snap['staleness']['stale_subjects']}, worst recent-join coverage "
                           f"{snap['staleness']['worst_recent_join_coverage']}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(nvidia_smi(), flush=True)

    from scalecube_cluster_tpu_torch.ops import _build
    from scalecube_cluster_tpu_torch.ops import pview as PV

    t0 = time.perf_counter()
    _build.build("delivery_combine")
    phase("build", f"delivery_combine built in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_log("delivery_combine")):
        phase("build", f"ptxas delivery_combine_kernel {line}")

    kern = check_kernels(device)
    check_cross_device(device)
    main_run = run_main_path(device)
    st, gen, params = main_run["state"], main_run["gen"], main_run["params"]
    profile_phases(lambda: PV.run_pview_ticks_fused(st, gen, 3, params), PHASES)
    del main_run["state"], st
    torch.cuda.empty_cache()

    check_driver_window(device)
    driver_run = run_driver_path(device)
    profile_phases(lambda: driver_run["driver"].step(3), PHASES, label="driver-profile")
    del driver_run["driver"]
    torch.cuda.empty_cache()
    check_checkpoint(device)

    check_sparse_window(device)
    sparse_run = run_sparse_main_path(device)
    profile_sparse(sparse_run)
    sparse_run.pop("state")
    torch.cuda.empty_cache()
    check_driver_window(device, params=config5_params(4096, fd_every=2, suspicion_mult=1, sync_every=20),
                        label="sparse-driver-window", dense_links=True)
    sparse_driver_run = run_sparse_driver_path(device)

    k1m = kern[(N_MAIN, 3, 8, 64, 0)]
    ksp = kern[SPARSE_CASE]
    launches = {"window": main_run["launches"], "driver": driver_run["launches"],
                "sparse-window": sparse_run["launches"], "sparse-driver": sparse_driver_run["launches"]}
    print(json.dumps({"kernels": [{
        "name": "delivery_combine",
        "route": "cuda",
        "source": "scalecube_cluster_tpu_torch/csrc/delivery_combine.cu",
        "replaces": "scalecube_cluster_tpu/ops/pallas_delivery.py:251 and :282",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": k1m["ms"],
        "plain_ms": k1m["plain_ms"],
        "bound_ms": k1m["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "at_sparse_widths": {"n": N_SPARSE, "ms": ksp["ms"], "plain_ms": ksp["plain_ms"],
                             "bound_ms": ksp["bound_ms"], "max_abs_err": ksp["max_abs_err"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1,  # the one card the run used
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
