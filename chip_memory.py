"""Device memory of the port's main paths, phase by phase, on one NVIDIA GPU.

    python3 chip_memory.py [--ticks 12] [--sparse-seconds 2] [--path all|pview|sparse]

The pview path (``--path pview``):

Builds chip_smoke's 1M-member scenario from the same seeds, runs the same
5-tick warm-up, then ``--ticks`` more ticks (chip_smoke's timed window and
the two ticks after it) with every phase of the fused tick bracketed: the
allocator's peak is reset when the phase begins and read when it ends.
Four variants run in turn, each from a fresh state:

* the pool's need/cover count (``ops/pool.py: _need_and_cover``) over row
  chunks, as the package does it, or over the whole [N, M] plane in one sum
  (a bool sum, which PyTorch widens to int64);
* the window in the default mode, or with every operation that waits for
  the device warning (``torch.cuda.set_sync_debug_mode("warn")``), the mode
  chip_smoke counts device waits in.

For each variant it prints the window's peak and the phase and tick that
set it, each phase's largest rise above the memory live when it began, and
the ticks on which the pool's eviction branch counted need and cover.

The sparse path (``--path sparse``): chip_smoke's sparse main path
(config5's churn run at 49,152 members) from the same seeds, its 2-second
warm-up, then ``--sparse-seconds`` more simulated seconds (5 ticks each,
the second's crashes and ``join_rows`` first) with every phase of the tick
and both churn mutators bracketed the same way. Two variants: the passes
over the [N, N] view plane and the per-cell [N, M] apply in row chunks of
at most ``PLANE_CHUNK_CELLS`` cells, as the package runs them, or each in
one chunk (the whole plane at once).
"""

from __future__ import annotations

import argparse
import sys
import time
import warnings

import torch

import chip_smoke as CS

GIB = 2 ** 30


def whole_plane_need_and_cover(state):
    """The pool's need/cover count as one sum over the whole [N, M] plane."""
    needs = state.up[:, None] & (state.joined_at[:, None] <= state.mr_created[None, :])
    return needs.sum(dim=0), (needs & (state.minf_age > 0)).sum(dim=0)


def run_variant(device, ticks: int, chunked: bool, sync_debug: bool) -> None:
    from scalecube_cluster_tpu_torch.ops import pool
    from scalecube_cluster_tpu_torch.ops import pview as PV

    n = CS.N_MAIN
    params = CS.config16_params(n)
    st = CS.busy_state(params, n, device)
    gen = torch.Generator(device=device).manual_seed(11)
    st, _, _ = PV.run_pview_ticks_fused(st, gen, 5, params)
    torch.cuda.synchronize()
    start_live = torch.cuda.memory_allocated()

    rise = {}  # phase -> (largest rise above its start, tick)
    top = {"peak": 0, "phase": None, "tick": None}
    evict_ticks = []

    def bracket(name, fn):
        def run(state, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn(state, *args, **kwargs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            if peak - base > rise.get(name, (-1, None))[0]:
                rise[name] = (peak - base, state.tick)
            if peak > top["peak"]:
                top.update(peak=peak, phase=name, tick=state.tick)
            return out
        return run

    cover = pool._need_and_cover if chunked else whole_plane_need_and_cover

    def counted_cover(state):
        evict_ticks.append(state.tick)
        return cover(state)

    saved = {name: getattr(PV, name) for name in CS.PHASES}
    saved_cover = pool._need_and_cover
    caught = []
    t0 = time.perf_counter()
    try:
        for name, fn in saved.items():
            setattr(PV, name, bracket(name, fn))
        pool._need_and_cover = counted_cover
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if sync_debug:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                st, ms, _ = PV.run_pview_ticks_fused(st, gen, ticks, params)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for name, fn in saved.items():
            setattr(PV, name, fn)
        pool._need_and_cover = saved_cover
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    waits = sum("synchroniz" in str(w.message) for w in caught)

    label = (f"{'row-chunked' if chunked else 'whole-plane'} need/cover count, "
             f"{'sync-debug warn' if sync_debug else 'default'} mode")
    print(f"[memory] {label}: ticks {st.tick - ticks + 1}-{st.tick}, live at start "
          f"{start_live / GIB:.2f} GiB, window peak {top['peak'] / GIB:.2f} GiB in {top['phase']} at tick "
          f"{top['tick']}; eviction branch on ticks {evict_ticks}; {waits} operations waited for the "
          f"device; {wall / ticks * 1e3:.2f} ms/tick with every phase synchronized", flush=True)
    print(f"[memory]   mr_active_count {ms['mr_active_count'].tolist()}, announced "
          f"{ms['announced'].tolist()}, pool_evicted {ms['pool_evicted'].tolist()}", flush=True)
    for name in sorted(rise, key=lambda k: -rise[k][0]):
        print(f"[memory]   {name}: largest rise {rise[name][0] / GIB:.2f} GiB above its start "
              f"(tick {rise[name][1]})", flush=True)


def run_sparse_variant(device, seconds: int, chunked: bool) -> None:
    from scalecube_cluster_tpu_torch.ops import _tensor
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    n = CS.N_SPARSE
    params = CS.config5_params(n)
    churn, crash, join = CS.churn_schedule(n, 2 + seconds, params.seed_rows)
    st = SP.init_sparse_state(params, n - churn, warm=True, device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    for sec in range(2):
        st, _ = CS.churn_second(st, params, crash[sec], join[sec], gen)
    torch.cuda.synchronize()
    start_live = torch.cuda.memory_allocated()
    rise = {}
    top = {"peak": 0, "phase": None, "tick": None}

    def bracket(name, fn):
        def run(state, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn(state, *args, **kwargs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            if peak - base > rise.get(name, (-1, None))[0]:
                rise[name] = (peak - base, state.tick)
            if peak > top["peak"]:
                top.update(peak=peak, phase=name, tick=state.tick)
            return out
        return run

    names = CS.SPARSE_PHASES + ("join_rows", "crash_rows")
    saved = {name: getattr(SP, name) for name in names}
    saved_cells = _tensor.PLANE_CHUNK_CELLS
    t0 = time.perf_counter()
    try:
        for name, fn in saved.items():
            setattr(SP, name, bracket(name, fn))
        if not chunked:
            _tensor.PLANE_CHUNK_CELLS = n * n
        for sec in range(2, 2 + seconds):
            st, ms = CS.churn_second(st, params, crash[sec], join[sec], gen)
    finally:
        for name, fn in saved.items():
            setattr(SP, name, fn)
        _tensor.PLANE_CHUNK_CELLS = saved_cells
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = seconds * CS.TICKS_PER_SECOND
    label = "row-chunked" if chunked else "whole-plane"
    print(f"[memory] sparse N={n}, {label} view-plane and apply passes: ticks {st.tick - ticks + 1}-{st.tick}, "
          f"live at start {start_live / GIB:.2f} GiB, window peak {top['peak'] / GIB:.2f} GiB in {top['phase']} "
          f"at tick {top['tick']}; {wall / ticks * 1e3:.2f} ms/tick with every phase synchronized", flush=True)
    for name in sorted(rise, key=lambda k: -rise[k][0]):
        print(f"[memory]   {name}: largest rise {rise[name][0] / GIB:.2f} GiB above its start "
              f"(tick {rise[name][1]})", flush=True)
    del st
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--sparse-seconds", type=int, default=2)
    ap.add_argument("--path", choices=("all", "pview", "sparse"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_memory: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    print(CS.nvidia_smi(), flush=True)
    if args.path in ("all", "pview"):
        for chunked in (True, False):
            for sync_debug in (False, True):
                run_variant(device, args.ticks, chunked, sync_debug)
    if args.path in ("all", "sparse"):
        for chunked in (True, False):
            run_sparse_variant(device, args.sparse_seconds, chunked)
    return 0


if __name__ == "__main__":
    sys.exit(main())
