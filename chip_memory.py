"""Device memory of the port's main paths, phase by phase, on one NVIDIA GPU.

    python3 chip_memory.py [--ticks 12] [--sparse-seconds 2] [--dense-ticks 10]
                           [--path all|pview|sparse|dense]

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

The dense path (``--path dense``): chip_smoke's two dense configurations
from its seeds — config4's partition at 10,000 members (partitioned, 30
ticks in, when the suspicion sweep and the gossip of suspicions are busy)
and config3's delay regime at 8,192 (loss 0.05 and a mean delay of 1.5
ticks on every link, 5 ticks in) — each ``--dense-ticks`` ticks with every
phase of the tick and the host mutators that set them up bracketed, with
the passes over the [N, N] planes (the sweep, the gossip accept and its
fetch hash, the cluster sizes, the health metrics) in row chunks, as the
package runs them, or in one chunk.
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
    evict_ticks = []
    cover = pool._need_and_cover if chunked else whole_plane_need_and_cover

    def counted_cover(state):
        evict_ticks.append(state.tick)
        return cover(state)

    saved_cover = pool._need_and_cover
    caught = []
    t0 = time.perf_counter()
    try:
        pool._need_and_cover = counted_cover
        with PhasePeaks(PV, CS.PHASES) as peaks, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if sync_debug:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                st, ms, _ = PV.run_pview_ticks_fused(st, gen, ticks, params)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        pool._need_and_cover = saved_cover
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    waits = sum("synchroniz" in str(w.message) for w in caught)

    label = (f"{'row-chunked' if chunked else 'whole-plane'} need/cover count, "
             f"{'sync-debug warn' if sync_debug else 'default'} mode")
    top = peaks.top
    print(f"[memory] {label}: ticks {st.tick - ticks + 1}-{st.tick}, live at start "
          f"{start_live / GIB:.2f} GiB, window peak {top['peak'] / GIB:.2f} GiB in {top['phase']} at tick "
          f"{top['tick']}; eviction branch on ticks {evict_ticks}; {waits} operations waited for the "
          f"device; {wall / ticks * 1e3:.2f} ms/tick with every phase synchronized", flush=True)
    print(f"[memory]   mr_active_count {ms['mr_active_count'].tolist()}, announced "
          f"{ms['announced'].tolist()}, pool_evicted {ms['pool_evicted'].tolist()}", flush=True)
    peaks.report()


class PhasePeaks:
    """Brackets named functions of a module: the allocator's peak is reset
    when one begins and read when it ends. Records each one's largest rise
    above the memory live at its start, and the phase and tick that set the
    overall peak."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.rise = {}
        self.top = {"peak": 0, "phase": None, "tick": None}

    def _bracket(self, name, fn):
        def run(state, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn(state, *args, **kwargs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            if peak - base > self.rise.get(name, (-1, None))[0]:
                self.rise[name] = (peak - base, state.tick)
            if peak > self.top["peak"]:
                self.top.update(peak=peak, phase=name, tick=state.tick)
            return out
        return run

    def __enter__(self):
        self.saved = {name: getattr(self.module, name) for name in self.names}
        for name, fn in self.saved.items():
            setattr(self.module, name, self._bracket(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def report(self) -> None:
        for name in sorted(self.rise, key=lambda k: -self.rise[k][0]):
            print(f"[memory]   {name}: largest rise {self.rise[name][0] / GIB:.2f} GiB above its start "
                  f"(tick {self.rise[name][1]})", flush=True)


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
    saved_cells = _tensor.PLANE_CHUNK_CELLS
    t0 = time.perf_counter()
    try:
        with PhasePeaks(SP, CS.SPARSE_PHASES + ("join_rows", "crash_rows")) as peaks:
            if not chunked:
                _tensor.PLANE_CHUNK_CELLS = n * n
            for sec in range(2, 2 + seconds):
                st, ms = CS.churn_second(st, params, crash[sec], join[sec], gen)
    finally:
        _tensor.PLANE_CHUNK_CELLS = saved_cells
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = seconds * CS.TICKS_PER_SECOND
    label = "row-chunked" if chunked else "whole-plane"
    top = peaks.top
    print(f"[memory] sparse N={n}, {label} view-plane and apply passes: ticks {st.tick - ticks + 1}-{st.tick}, "
          f"live at start {start_live / GIB:.2f} GiB, window peak {top['peak'] / GIB:.2f} GiB in {top['phase']} "
          f"at tick {top['tick']}; {wall / ticks * 1e3:.2f} ms/tick with every phase synchronized", flush=True)
    peaks.report()
    del st
    torch.cuda.empty_cache()


def run_dense_variant(device, config: str, ticks: int, chunked: bool) -> None:
    """One dense configuration (``partition`` or ``delay``), its set-up
    mutators and ``ticks`` ticks bracketed, the [N, N] passes row-chunked
    or in one chunk."""
    from scalecube_cluster_tpu_torch.ops import _tensor
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import state as S

    saved_cells = _tensor.PLANE_CHUNK_CELLS
    gen = torch.Generator(device=device).manual_seed(0)
    try:
        with PhasePeaks(S, ("block_partition", "set_uniform_loss", "set_link_delay")) as setup:
            if config == "partition":
                n = CS.N_DENSE
                params = CS.config4_params(n)
                if not chunked:
                    _tensor.PLANE_CHUNK_CELLS = n * n
                st = S.init_state(params, n, warm=True, dense_links=True, device=device)
                st = S.block_partition(st, list(range(n // 10)), list(range(n // 10, n)))
                warm = 30
            else:
                n = CS.N_DELAY
                params = CS.config4_params(n, **CS.CONFIG3_KNOBS)
                if not chunked:
                    _tensor.PLANE_CHUNK_CELLS = n * n
                st = S.init_state(params, n, warm=True, dense_links=True, device=device)
                st = S.set_link_delay(S.set_uniform_loss(st, CS.CONFIG3_LOSS), range(n), range(n),
                                      CS.CONFIG3_DELAY_MEAN)
                warm = 5
        st, _, _ = K.run_ticks(st, gen, warm, params)
        torch.cuda.synchronize()
        start_live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with PhasePeaks(K, CS.DENSE_PHASES) as peaks:
            st, _, _ = K.run_ticks(st, gen, ticks, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        _tensor.PLANE_CHUNK_CELLS = saved_cells
    label = "row-chunked" if chunked else "whole-plane"
    top = peaks.top
    print(f"[memory] dense {config} N={n}, {label} [N, N] passes: set-up peak {setup.top['peak'] / GIB:.2f} GiB in "
          f"{setup.top['phase']}; ticks {st.tick - ticks + 1}-{st.tick}, live at start {start_live / GIB:.2f} GiB, "
          f"window peak {top['peak'] / GIB:.2f} GiB in {top['phase']} at tick {top['tick']}; "
          f"{wall / ticks * 1e3:.2f} ms/tick with every phase synchronized", flush=True)
    setup.report()
    peaks.report()
    del st
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--sparse-seconds", type=int, default=2)
    ap.add_argument("--dense-ticks", type=int, default=10)
    ap.add_argument("--path", choices=("all", "pview", "sparse", "dense"), default="all")
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
    if args.path in ("all", "dense"):
        for config in ("partition", "delay"):
            for chunked in (True, False):
                run_dense_variant(device, config, args.dense_ticks, chunked)
    return 0


if __name__ == "__main__":
    sys.exit(main())
