"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the partial-view engine's tick window and
``SimDriver`` over it, both at 1,048,576 members, the sparse engine's
window and ``SimDriver`` over it at 49,152 members, the dense engine's
window and ``SimDriver`` over it at 10,000 members and its delay regime at
8,192, each engine's window again under a dissemination strategy, with
the strategies' certification matrix, and again armed with the adaptive
failure-detection plane and through chaos scenarios, with config13's
certification sweep and config7's armed-idle overhead, and the fleet engine
(S clusters per window: its kernel, its windows, config14's Monte Carlo
workload and its full-width path), the delay rings of the sparse and
partial-view engines (their windows, config3's published delay run, both
main paths under delay) and the telemetry plane on every engine's driver —
on the card, and fails (non-zero exit, no result line) unless every phase
passes:

1. device   — a CUDA device is present; prints its name and power limit;
2. build    — builds the port's CUDA kernel with nvcc; prints ptxas's
   registers, stack and spills for each compiled variant;
3. kernels  — each kernel against its plain PyTorch version on random
   inputs at the main path's shapes, and at shapes that reach its other
   compiled variants, and on the ``inv`` that ``accelerated/expander``
   peers build at 1M (every receiver one sender per slot): bit-equal
   outputs, timed beside the byte bound;
4. window   — a 4,096-member, 8-tick (40, 24, 16, then 12 before phase 46) fused window on the CPU (plain
   versions) and on the card (kernels) from the same draws: equal state
   and metrics;
5. main path — the 1M-member scenario (warm start, 8 live rumors, a crash
   wave of 1,024 rows): one warm-up window, then a timed 10-tick fused
   window with draws from a CUDA generator; launch counts are zeroed just
   before it and read just after, and the window's invariants are checked;
   two more ticks count the operations that wait for the device;
6. profile  — ``PROFILE_TICKS`` (2; 3 before the mesh phases) more fused ticks under ``torch.profiler``: the
   device's busy share, each phase's device and host time, and the
   kernel's own device time per tick;
7. driver-window — a 4,096-member, 10-tick (20, then 13 before the trace phases) ``SimDriver``
   script (spreads, a crash, a join, a leave, metadata bumps, a partition
   and its heal, two watched rows) on the CPU and on the card from the same
   draws: equal state, per-tick metrics and event logs;
8. driver   — the driver main path: ``SimDriver`` on the card at 1M (the
   config11 widths; warm start, 8 rumors through ``spread_rumor``, a crash
   wave of 1,024 rows through ``crash``, a ``join``, a ``leave``, two
   watched rows), a 5-tick warm-up, then a timed ``step(10)`` window (three
   through PR 7) and ``sync()``, with the launch counts zeroed just before
   and read just after; then ``PROFILE_TICKS`` ticks profiled by phase, as in phase 6;
9. checkpoint — a 65,536-member driver: ``step(5)``, ``checkpoint``,
   ``step(10)``, ``restore``, ``step(10)``: both trajectories bit-equal;
10. sparse-window — a 4,096-member, 8-tick (40, 24, 16, then 12 before phase 46) sparse window with dense links
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
   ``crash``, 8 joins, two watched rows): a 5-tick warm-up, then a timed
   ``step(10)`` window (three through PR 7), launch counts zeroed before
   and read after;
15. dense-window — a 4,096-member, 9-tick (20, then 12 before the trace phases) dense window at config9's i16
   widths with dense links (a crash wave, rumors, a ``join_rows`` batch
   with rejoins, a partition and its heal) on the CPU and on the card from
   the same draws: equal state and metrics;
16. dense-delay-window — a 2,048-member, 8-tick (40, 24, 16, then 12 before phase 46) dense window in config3's
   delay regime (loss 0.05, mean delay 1.5 ticks, six ring slots, a group
   of slower links through ``set_link_delay``): CPU = card;
17. dense-main — config4's partition at 10,000 members
   (``benchmarks/config4_partition.py``) through 25-tick ``make_run``
   windows watching the majority observer: detection, bulk and full
   recovery ticks beside the JAX package's, ms/tick partitioned and
   healed, peak memory, flag reads per tick, device waits; config4's
   ``ok`` or the phase fails;
18. dense-profile — 5 partitioned ticks (an FD tick among them) under the
   profiler with the quiet gates on, then 5 with them off; the same in
   the healed steady state;
19. dense-driver-window — phase 7's driver script on config9's dense
   params: CPU = card;
20. dense-driver — ``SimDriver`` on the card at 10,000: the partition, two
   watched rows, three timed ``step(10)``, the heal and a timed
   ``step(10)``;
21. dense-delay — ``SimDriver(auto_params(8192, link_delay=True, ...))``
   in config3's delay regime, 200 FD rounds: the raw FD failure rate
   against config3's analytic rate (fails beyond 5σ);
22. dissem-windows — armed windows on the CPU and on the card from the
   same draws: pview at 4,096 under ``push_pull/expander`` (phase 4's
   scenario), sparse at 4,096 under ``pipelined/ring`` (budget 2, phase
   10's), dense at 2,048 under ``push_pull/full`` with the delay rings at
   D = 3 (phase 16's), and phase 7's driver script on config9's dense
   params with ``set_dissemination(strategy="accelerated",
   topology="ring")`` in the middle: equal state, metrics and events;
23. dissem-certify — ``spread_certifier`` over config12's matrix
   (``dissemination/certify.py: DEFAULT_MATRIX``, 15 dense and 2 pview
   entries, N = 256, seeds 0-4, fanout 3, 8 rumor slots, geo WAN delay 2,
   pipeline budget 2; the entries run in one pool of worker processes on
   the card with the Monte Carlo tasks of phases 29, 33 and 43, the longest
   first) and the
   pipelined steady state: every entry certified, each
   entry's spread ticks printed beside its bound; then
   config12's default-spec control (dense N = 4,096, 8 rumor slots, one
   80-tick sweep window) beside two armed spellings of it;
24. dissem-main — one armed spec on each engine at its main path's full
   width: pview at 1M under ``push_pull/expander`` (phase 5's scenario, 10
   timed ticks, one launch per tick, then ``PROFILE_TICKS`` ticks profiled as in
   phase 6), sparse at 49,152 under ``pipelined/expander`` (phase 11's
   churn run), dense at 10,000 under ``push_pull/full`` (phase 17's
   partition with phase 18's profiles): ms/tick, peak, launches and each
   engine's invariants, beside that engine's unarmed ms/tick from the
   same call;
25. adaptive-windows — adaptive windows (config13's knobs: min_mult 5,
   max_mult 10, conf_target 4, lh_max 8) on the CPU and on the card from
   the same draws: pview at 4,096 (phase 4's scenario under a 10% uniform
   loss floor), sparse at 4,096 with dense links and 32 rows taking 70%
   inbound loss (phase 10's), dense at 2,048 with the rings at D = 4, a
   slow group of links and a flaky observer (phase 16's): equal state,
   adaptive planes and metrics, and both gauges moved;
26. adaptive-main — each engine's main path armed with config13's knobs at
   full width: pview at 1M (phase 5's scenario), sparse at 49,152 (phase
   11's churn), dense at 10,000 (phase 17's partition, no profiles):
   ms/tick beside the unarmed run of this call, peak, flag reads per
   tick, launches, the ``adaptive_lh_max`` / ``adaptive_conf_max`` gauges
   (the phase fails where one stays 0), dense detection and recovery;
27. chaos-windows — ``SimDriver.run_scenario`` on the CPU and on the card
   from the same draws at 4,096 (32 ticks past the last event, 40 before
   the trace phases, but dense): pview (a crash and a partition healed),
   dense at config9's widths (20 ticks, 40 through PR 7), sparse with dense links (a crash wave, a
   partition healed, restarts); dense at 2,048 with a loss storm over a
   partition healed inside it: equal reports (but the backend stamp) and
   state;
28. chaos-main — one scenario per engine at full width, each ``ok`` with 0
   violations and no readback while it steps: pview at 1M (its crash wave
   and a partition healed, 40 ticks: PVIEW_SCENARIO_HORIZON), sparse at 49,152 (a crash, a loss
   storm on scalar links, a restart, 60 ticks), dense at 10,000 (config4's
   1,000 / 9,000 split healed after detection, 600 ticks past the heal (800 before the trace phases); the
   automatic horizon through PR 7):
   ms/tick against the unarmed runs, flag reads, launches;
29. config13 — ``benchmarks/config13_adaptive.py``'s sweep at its published
   widths (N = 48, seeds 0-2, loss floors 0/10/20%, both arms: 18 entries,
   run in phase 23's worker pool on the card), each entry beside
   ``ADAPTIVE_BENCH_r14.json``'s; fails unless config13's ``certified``
   holds;
30. config7 — the armed-but-idle chaos overhead at dense N = 4,096 (24
   one-tick windows, plain loop against an armed event-free scenario,
   interleaved median of 5) beside config7's 2% gate; fails only on a
   readback while the armed loop steps.

31. fleet-kernel — the scenario-axis variant of the delivery kernel (one
   launch for S clusters) bit-equal to its plain version at MC widths
   (S = 1,024, N = 64, F = 3, R = 8; the vector and the scalar path), at a
   full-width batch (S = 256 x N = 4,096, pview widths) and at S = 65,600
   (past the 65,535 grid limit of a y axis), timed (20 launches, the
   profiler) beside its byte bound, its plain version and S serial launches
   of the serial kernel on the same inputs;
32. fleet-windows — one fleet window per engine (S = 8, 12 ticks, pview 4
   (16, then 8 before the trace phases); dense N = 256 i32 and i16, sparse N = 1,024, pview N =
   4,096 at config16's widths; every third scenario with crashes of its own) and the adaptive
   dense fleet (config13's knobs, rings at D = 4, a degraded cohort) on the
   CPU and on the card from the same draws: equal; each card row equal to
   the serial window fed that row's draws;
33. config14 — ``benchmarks/config14_fleet.py`` at its published widths:
   batched against serial at S = 256 x N = 64 and S = 64 x N = 256 (32-tick
   windows, interleaved median of 3 (5 before the trace phases), aggregate
   member-ticks/s; the serial arm loops over 4 of the S clusters (16,
   then 8 before); readbacks in each timed span
   counted under sync-debug; fails below 3x or on a readback at S = 256 x N
   = 64); ``mc_spread_certifier``'s matrix (12 cells at n = 64, 1,024 seeds
   each; every cell certified, the pview and sparse cells at most one
   kernel launch per fleet tick); ``fp_rate_mc`` static and adaptive (N =
   48, 512 seeds, 10% floor; config14's rule); ``adaptive_knob_sweep`` at
   its default grid, 86 seeds per floor (config14's 171 before) — these
   three in phase 23's worker pool; the one-window ladder (S doubled at N = 64 and 256 until an 8-tick window's peak passes 16 GiB);
34. fleet-main — the fleet's full-width path: the dense fleet at S = 4,096
   x N = 256 (1,048,576 member rows) and the pview fleet at S = 256 x N =
   4,096 (config11's widths), 8 rumors and a crash wave each, a warm-up and
   a timed 16-tick window: ms per window, member-ticks/s, peak (< 80 GB),
   flag reads per fleet tick, kernel launches (one per pview fleet tick;
   counts zeroed just before the timed window, read just after);
35. delay-windows — the pending delivery rings at D = 6 (config3's delay
   regime: loss 0.05, mean delay 1.5 ticks) on the CPU and on the card from
   the same draws, 8 ticks each (12 before the trace phases) at N = 4,096: sparse with scalar links,
   sparse with dense links and a SlowMember (rows 0-7 at 4.0 ticks on every
   link touching them), pview at config16's i16 widths; each again armed
   with the adaptive plane (config13's knobs: the direct probe's timeout
   stretched by local health); then a sparse and a pview fleet with D = 4
   (S = 4, N = 256, 8 ticks), CPU = card and each row = the serial
   window. Every state leaf, the three rings included, and every metric
   equal;
36. config3-delay — ``benchmarks/config3_fd_loss.py:delay_main`` as
   published: the sparse lean layout at N = 1,024, fanout 3, ping_req_k 3,
   fd_every 1, D = 6, loss 0.05, mean 1.5, 200 FD rounds in windows of 50;
   the raw FD failure rate against the analytic rate, failing outside
   config3's 3-sigma rule;
37. delay-main — phase 5's pview path at 1M and phase 11's sparse churn
   run at 49,152 under the same delay (D = 6, mean 1.5): ms/tick beside the
   unarmed runs of this call, peak (< 80 GB), flag reads per tick, one
   launch per gossip tick (counts zeroed just before, read just after), the
   engines' invariants; two more pview ticks profiled by phase, as in
   phase 6, with the ring helpers labelled;
38. telemetry — the telemetry plane on each engine's driver at full width
   (pview 1M, sparse 49,152 and dense 10,000: a warm-up and one timed
   ``step(10)``; pview two before the trace phases), against an unarmed driver of the same seed: states
   bit-equal, no readback while stepping, the same device waits under the
   sync-debug mode, ms/tick armed beside unarmed; then one ``flush()`` and
   one ring read;
39. trace-windows — each engine's traced window (``make_traced_run``) on
   the CPU and on the card from the same draws, 12 ticks at 4,096 (24, then 16 before phase 46): pview
   at config16's i16 widths, sparse at config5's with dense links, dense
   at config9's i16 widths, then pview again with the delay rings at D =
   6 over 16 ticks (its first suspicion is raised at tick 15); a crash wave whose first rows are tracers, every rumor slot live, a
   partition and its heal. Every state leaf, metric and trace-ring row
   equal;
40. trace-main — a trace-armed driver (4 tracers, rumor slots 0 and 1)
   against an unarmed one from one seed at full width: pview 1M, sparse
   49,152, dense 10,000 partitioned (one timed ``step(10)`` each):
   states bit-equal, no readback while stepping, the same device waits,
   ms/tick beside the unarmed, the same launches (one per gossip tick on
   pview and sparse); one ring read holding K records per tick plus K per
   window boundary;
41. trace-scenario — ``run_scenario(trace=True)`` on phase 28's pview 1M
   crash scenario (PVIEW_SCENARIO_HORIZON ticks; 60 before phase 46) with the telemetry plane armed: ``ok``, 0 violations, no
   readback while stepping, every traced crashed row with a sewn
   detection tree, the Perfetto document written under ``chiprun_out/``;
   then a forced violation whose flight dump carries the trace section;
42. config10 — ``benchmarks/config10_trace.py`` as published (dense N =
   4,096, 24 one-tick windows, 5 interleaved reps): the armed overhead
   beside config10's 2% gate (fails only on a readback), and the phase
   split of ``trace/profile.py`` (CUDA events per phase) with the 20%
   coverage check;
43. config15 — ``certify_controller_mc`` as config15 publishes it (N = 48,
   the three shifting cells, 512 seeds each, storm floors 20/24/28%): every
   cell certified, 0 false-DEAD, the blind and unclamped controllers
   failing (the cells run in phase 23's worker pool); then a control-armed sparse driver at 49,152 under clean
   conditions against an unarmed one: 0 actuations, one readback per
   epoch, state bit-equal, ms/tick beside;
44. config17 — ``benchmarks/config17_replay.py`` as published (N = 24, 256
   seeds, detect budget 60, horizon 96): the incident made on the card,
   its flight dump round-tripped by ``validate_incident``, ``whatif`` over
   the as-recorded and three counterfactual arms (at least one
   CI-separated), and the card's dump replayed on the CPU to the same
   verdict;
45. mesh — the member mesh (``ops/sharding.py``) on a world-size-1 NCCL
   group (one card: no multi-GPU time exists, and none is claimed): the
   sharded fused pview window at 1,048,576 members against the unsharded
   one from a copy of the same start state with the same draws (every leaf
   and metric bit-equal, overflow 0, the delivery kernel launched 0 times,
   counted; the exchange's bytes, ms/tick sharded and unsharded, peak); a
   starved exchange budget at 4,096 members on the card against the CPU
   (gloo) with the same overflow > 0; the sharded ``SimDriver`` at 1M with
   the adaptive and telemetry planes armed, and with the trace and
   telemetry planes, against the unsharded drivers (state, planes, rings,
   events and readbacks equal); the pview fleet on a 1-rank scenario mesh
   against the one-process fleet;
46. mesh-2 — the pview engine whole on the same world-size-1 group:
   ``[mesh-delay]`` config16's 1M window under config3's delay regime (D =
   6) with ``push_pull`` (the late and pull exchanges), ``MESH_TICKS``
   ticks, sharded against unsharded from one start state (every leaf and
   ring row bit-equal, overflow 0, 0 kernel launches sharded and one a
   gossip tick unsharded; ms/tick both, peak); ``[mesh-delay-starved]``
   the same at 4,096 with a starved budget, card against CPU (gloo), equal
   with overflow > 0; ``[mesh-fleet2d]`` the pview fleet at 256 x 4,096 on
   a 1 x 1 scenarios x members mesh against the one-process fleet (rows
   equal, 0 launches against its 4); ``[mesh-scenario]`` phase 28's 1M
   scenario on the sharded driver, its report equal to phase 28's (run
   here when phase 28 did not run), readbacks and host-mutation ms;
   ``[mesh-control]`` and ``[mesh-profile]`` two sharded 1M drivers, one
   control-armed and idle, the other profiled by ``profile_driver``
   between its windows: bit-equal, one ring read per control epoch, phase
   coverage within 20%; ``[mesh-checkpoint]`` the checkpoint script on a
   sharded 65,536-member driver, its archive also restored into an
   unsharded driver; then the group is destroyed. ``python3 chip_smoke.py
   --mesh-only`` runs the build and phases 45 and 46 alone.

The dense paths launch no hand-written kernel; their launch counts
stand in the kernels line as measured. Every path's count is zeroed just
before it runs and read just after, in the worker processes too.
The worker pool's processes end with phase 23. The line before the last is a JSON object with one entry per kernel; the
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
# Depth cut for the fleet phases' time (each listed in PERF.md section 4):
DRIVER_WINDOWS = 1  # timed step(10) windows of the 1M and the sparse driver (3 through PR 7)
DRIVER_SCRIPT_STEPS = (2, 4, 2, 2)  # the CPU-vs-card driver script's steps (5, 7, 5, 3, then 3, 5, 3, 2 before the trace phases)
DENSE_WINDOW_STEPS = (2, 3, 2)  # the CPU-vs-card dense window's (5, 8, 7, 3, 5, 4, then 2, 4, 3 before)
CHAOS_DENSE_AFTER_HEAL = 600  # the full-width dense scenario's horizon past its heal (800 before the trace phases; automatic at first)
# Depth cut for the delay and telemetry phases' time:
WINDOW_TICKS = 8  # the CPU-vs-card windows of phases 4, 10, 16, 22 and 25 (40, 24, 16, then 12 before)
FLEET_PVIEW_TICKS = 4  # phase 32's pview fleet window (16, then 8 before)
# Depth cut for the trace, control and replay phases' time:
MAIN_PVIEW_WINDOWS = 1  # timed step(10) windows of the 1M pview drivers of phases 38 and 40 (2 before)
CHAOS_WINDOW_HORIZON = 32  # phase 27's 40-tick CPU-vs-card scenarios, cut past their last event (40 before)
C14_THROUGHPUT_REPS = 3  # config14's batched-vs-serial medians (of 5 before)
C14_SERIAL_SAMPLE = 4  # scenarios the serial arm loops over (16, then 8 before; its rate per member-tick does not depend on S)
C14_SWEEP_SEEDS = 86  # adaptive_knob_sweep's seeds per floor (config14's 171 before)
C13_KNOBS = dict(min_mult=5, max_mult=10, conf_target=4, lh_max=8)  # config13's ADAPTIVE_KNOBS
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# Depth of the mesh phases (PERF.md section 4):
MESH_TICKS = 5  # ticks of the 1M sharded window and of its unsharded twin
MESH_DRIVER_STEP = 6  # the 1M sharded drivers' timed step (10 before phase 46)
MESH_SMALL_N = 4096  # the starved-budget window, card against CPU
MESH_STARVED_BUDGET = 4096  # records per (src, dst); the lossless budget is F * N = 12,288
MESH_FLEET = (8, 4096, 8)  # S x N pview fleet on the scenario mesh, ticks
# Depth of phase 46 (PERF.md section 4):
MESH_DELAY_SLOTS = 6  # config3's delay regime (CONFIG3_KNOBS, CONFIG3_DELAY_MEAN) on the 1M sharded window
MESH_FLEET2D = (256, 4096, 3)  # S x N pview fleet on the 1 x 1 scenarios x members mesh, ticks (4 before)
MESH_CONTROL = (2, 3)  # control epochs (one window each) x ticks per window of the armed-idle pair ((3, 5) before)
MESH_PROFILE_TICKS = 2  # profile_driver's ticks on the sharded 1M driver, one warm-up tick besides (3 before)
# Depth cut for phase 46's time (PERF.md section 4):
PVIEW_SCENARIO_HORIZON = 40  # phase 28's 1M pview scenario, rerun sharded by phase 46 (60 before; heal at 30)
PROFILE_TICKS = 2  # ticks of the 1M pview window, driver and dissem profiles of phases 5, 7 and 24 (3 before)
FLEET_WINDOW_TICKS = 12  # phase 32's CPU-vs-card fleet windows but the pview one (16 before)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


_T0 = time.perf_counter()


def phase(name: str, msg: str) -> None:
    """One report line, stamped with the seconds since the script started."""
    print(f"[{name}] {msg} (+{time.perf_counter() - _T0:.1f} s)", flush=True)


def dissem_label(params) -> str:
    """The text ' under strategy/topology' for params armed with a
    dissemination spec, '' for the default (push over the full topology)."""
    spec = params.dissem
    return "" if spec.is_default else f" under {spec.strategy}/{spec.topology}"


def armed(params, **spec):
    """``params`` with the dissemination spec ``spec``."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.dissemination import DissemSpec

    return dc.replace(params, dissem=DissemSpec(**spec))


def with_adaptive(params, **knobs):
    """``params`` with the adaptive plane armed: config13's knobs
    (``benchmarks/config13_adaptive.py: ADAPTIVE_KNOBS``), ``knobs``
    replacing them."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.adaptive import AdaptiveSpec

    return dc.replace(params, adaptive=AdaptiveSpec(enabled=True, **{**C13_KNOBS, **knobs}))


def adaptive_label(params) -> str:
    return "" if params.adaptive.is_default else ", adaptive"


class Window:
    """An engine's window runner over ``params``: ``run(state, draws,
    ticks, params, watch_rows)``, or, when ``params.adaptive`` is enabled,
    ``run_adaptive`` with the adaptive plane (``.ad``, fresh on
    ``device``) threaded through. Called as ``(state, draws, ticks,
    watch_rows=None) -> (state, stacked metrics, watched)``."""

    def __init__(self, run, run_adaptive, params, device):
        from scalecube_cluster_tpu_torch.adaptive import init_adaptive_state

        self.run, self.run_adaptive, self.params = run, run_adaptive, params
        self.ad = None if params.adaptive.is_default else init_adaptive_state(params.capacity, device=device)

    def __call__(self, st, draws, ticks: int, watch_rows=None):
        if self.ad is None:
            return self.run(st, draws, ticks, self.params, watch_rows)
        st, self.ad, ms, watched = self.run_adaptive(st, self.ad, draws, ticks, self.params, watch_rows)
        return st, ms, watched

    def planes(self) -> dict:
        """The adaptive planes as [1, N] pseudo-metrics (for the CPU-card
        comparisons), or nothing."""
        if self.ad is None:
            return {}
        return {f"adaptive plane {k}": getattr(self.ad, k)[None].cpu() for k in ("lh", "conf_key", "conf")}


def pview_window(params, device) -> Window:
    from scalecube_cluster_tpu_torch.ops import pview as PV

    return Window(PV.run_pview_ticks_fused, PV.run_pview_ticks_adaptive, params, device)


def sparse_window(params, device) -> Window:
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    return Window(SP.run_sparse_ticks, SP.run_sparse_ticks_adaptive, params, device)


def dense_window(params, device) -> Window:
    from scalecube_cluster_tpu_torch.ops import kernel as K

    return Window(K.run_ticks, K.run_ticks_adaptive, params, device)


def gauges_line(ms) -> str:
    """The adaptive gauges of a window's metrics (``ops/kernel.py:
    adaptive_gauges``) as text; fails when one stayed 0 (the plane was not
    exercised)."""
    from scalecube_cluster_tpu_torch.ops.kernel import adaptive_gauges

    g = {k: float(v) for k, v in adaptive_gauges(ms).items()}
    if min(g.values()) <= 0:
        raise AssertionError(f"an adaptive gauge stayed 0: {g}")
    return ", ".join(f"{k} {v:g}" for k, v in g.items())


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


def count_waits(fn) -> int:
    """The operations of ``fn()`` that wait for the device, under the
    sync-debug mode (its notice on first use is not a wait)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def kernel_ms(fn, kernel: str, reps: int = 20, warmup: int = 3) -> float:
    """Median device time in ms of the kernel named ``kernel`` over ``reps``
    calls of ``fn``, from the profiler's record of the device: a call's own
    host work (checks, allocation) does not count, as it would between two
    CUDA events around one call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        # a session after earlier ones in the process can miss a launch;
        # such a session is taken again, never read short
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) == reps:
            return statistics.median(times) / 1e3
    raise AssertionError(f"profiler saw {len(times)} launches of {kernel}, expected {reps}")


def config16_params(n: int, key_dtype: str = "i16"):
    """The fused benchmark's 1M-wall configuration (benchmarks/config16_fused.py)."""
    from scalecube_cluster_tpu_torch.ops.pview import PviewParams

    return PviewParams(
        capacity=n, view_slots=24, active_slots=8, fanout=3, repeat_mult=3,
        ping_req_k=3, fd_every=5, sync_every=150, suspicion_mult=5,
        rumor_slots=8, seed_rows=(0,), key_dtype=key_dtype,
    )


def busy_state(params, n: int, device, delay: float = 0.0):
    """Warm cluster, a live rumor in every slot, a crash wave of n/1024 rows;
    ``delay``: a uniform mean link delay in ticks (the delay rings)."""
    from scalecube_cluster_tpu_torch.ops import pview as PV

    st = PV.init_pview_state(params, n, warm=True, uniform_delay=delay, device=device)
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


def check_cross_device(device, params=None, label: str = "window", floor: float = 0.0) -> dict:
    """``WINDOW_TICKS`` ticks at N = 4,096 on the CPU and on the card from the same draws
    (``params``: config16's widths by default; ``floor``: a uniform loss
    floor over the scenario). Returns the CPU run's metrics."""
    from scalecube_cluster_tpu_torch import convert
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import rand as PR

    n, ticks = 4096, WINDOW_TICKS
    params = params or config16_params(n)
    gen = torch.Generator(device="cpu").manual_seed(7)
    draws = [
        (PR.draw_sparse_fd(gen, n, params.ping_req_k, params.sample_tries),
         PR.draw_sparse_round(gen, n, params.fanout, params.sample_tries))
        for _ in range(ticks)
    ]
    runs = []
    for dev in ("cpu", device):
        win = pview_window(params, dev)
        st = PV.set_uniform_loss(busy_state(params, n, dev), floor, floor=True)
        st, ms, _ = win(st, draws, ticks)
        runs.append((st, {**{k: v.cpu() for k, v in ms.items()}, **win.planes()}))
    (cpu_st, cpu_ms), (dev_st, dev_ms) = runs
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
    phase(label, f"N={n}, {ticks} ticks{dissem_label(params)}{adaptive_label(params)}"
                 f"{f', loss floor {floor}' if floor else ''}: every state leaf, metric and adaptive plane equal on "
                 f"CPU and {device}; mr_accepts {int(cpu_ms['mr_accepts'].sum())}, sync_roundtrips "
                 f"{int(cpu_ms['sync_roundtrips'].sum())}, rumor_deliveries {int(cpu_ms['rumor_deliveries'].sum())}")
    return cpu_ms


def run_main_path(device, params=None, label: str = "main", delay: float = 0.0) -> dict:
    """The pview main path at N_MAIN (``params``: config16's widths by
    default; ``delay``: a uniform mean link delay): a warm-up window, a
    timed 10-tick window with the launch counts zeroed just before and read
    just after, its invariants."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery
    from scalecube_cluster_tpu_torch.ops import pview as PV

    n = N_MAIN
    params = params or config16_params(n)
    t0 = time.perf_counter()
    st = busy_state(params, n, device, delay)
    torch.cuda.synchronize()
    phase(label, f"N={n} state built in {time.perf_counter() - t0:.2f} s "
                  f"(minf_age {tuple(st.minf_age.shape)} {st.minf_age.dtype})")
    gen = torch.Generator(device=device).manual_seed(11)
    win = pview_window(params, device)
    t0 = time.perf_counter()
    st, _, _ = win(st, gen, 5)
    torch.cuda.synchronize()
    phase(label, f"warm-up window of 5 ticks: {time.perf_counter() - t0:.2f} s")

    ticks = 10
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    st, ms, _ = win(st, gen, ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = delivery.delivery_combine.launches
    syncs = _tensor.HOST_SYNCS.count
    peak = torch.cuda.max_memory_allocated()

    # two more ticks in the mode where every operation that waits for the
    # device warns: the count shows whether the branch flags are the only
    # syncs (the mode is kept out of the timed window, which it perturbs)
    _tensor.HOST_SYNCS.count = 0

    def two_more():
        nonlocal st
        st, _, _ = win(st, gen, 2)

    device_waits = count_waits(two_more)
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
    phase(label, f"N={n}, {ticks} ticks{dissem_label(params)}{adaptive_label(params)}: {wall / ticks * 1e3:.2f} "
                  f"ms/tick, peak allocated {peak / 2 ** 30:.2f} GiB, delivery_combine launches {launches}, host "
                  f"syncs {syncs} ({syncs / ticks:.1f}/tick), final coverage {cov[-1].cpu().tolist()}")
    phase(label, f"2 more ticks: {flag_reads} branch-flag reads, {device_waits} operations "
                  "waited for the device")
    return {"launches": launches, "state": st, "gen": gen, "params": params, "ms_tick": wall / ticks * 1e3,
            "peak": peak, "flags": syncs / ticks, "ms": ms}


PHASES = ("_fd_phase", "_maintenance_sweep", "_gossip_phase_fused", "_sync_phase",
          "_refute_phase", "_rumor_sweeps_fused", "alloc_phase", "state_metrics")


def profile_phases(run, phases, ticks: int = PROFILE_TICKS, label: str = "profile", module=None) -> None:
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
    host, span, busy, by_kernel = {}, {}, [], {}
    # the profiler's raw records, in ns: prof.events() would first build a
    # Python event tree over them, some seconds for each 1M tick
    for e in prof.profiler.kineto_results.events():
        name, us = e.name(), e.duration_ns() / 1e3
        if name.startswith("phase:"):
            # a labelled range shows twice: on the host, and as the span of
            # its kernels on the device
            book = span if e.device_type() == cuda else host
            book[name[6:]] = book.get(name[6:], 0) + us
        elif e.device_type() == cuda:
            busy.append((e.start_ns() / 1e3, e.start_ns() / 1e3 + us))
            # the device's own records: kernels, copies and fills, by name
            agg = by_kernel.setdefault(name, [0, 0])
            agg[0] += us
            agg[1] += 1
    device_us, reach = 0, float("-inf")
    for a, b in sorted(busy):  # the union of the device's activity intervals
        device_us += max(0, b - max(a, reach))
        reach = max(reach, b)
    if device_us == 0:
        phase(label, f"{ticks} ticks: {wall_us / ticks / 1e3:.2f} ms/tick wall; device time "
                     "not measured (the profiler recorded no device activity)")
        return None
    phase(label, f"{ticks} ticks: {wall_us / ticks / 1e3:.2f} ms/tick wall, device busy "
                 f"{device_us / ticks / 1e3:.2f} ms/tick, idle share {1 - device_us / wall_us:.3f}")
    for name in sorted(host, key=lambda k: -host[k]):
        phase(label, f"{name}: host {host[name] / ticks / 1e3:.3f} ms/tick, device span "
                     f"{span.get(name, 0) / ticks / 1e3:.3f} ms/tick")
    kernels = sorted(((us, key, count) for key, (us, count) in by_kernel.items() if us > 0), reverse=True)
    for us, key, count in kernels[:8]:
        phase(label, f"top kernel {key[:90]}: {us / ticks / 1e3:.3f} ms/tick ({count} launches)")
    ours = [(us, count) for us, key, count in kernels if "delivery_combine_kernel" in key]
    phase(label, f"delivery_combine_kernel: {sum(u for u, _ in ours) / ticks / 1e3:.4f} "
                 f"ms/tick device time ({sum(c for _, c in ours)} launches in {ticks} ticks)")
    return {"wall_ms": wall_us / ticks / 1e3, "busy_ms": device_us / ticks / 1e3,
            "idle": 1 - device_us / wall_us,
            "host_ms": {k: v / ticks / 1e3 for k, v in host.items()},
            "span_ms": {k: v / ticks / 1e3 for k, v in span.items()}}


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
    """``ticks`` per-tick (fd, round) draw pairs from a CPU generator, by
    the params' engine (the dense samplers' rank draws, or rejection
    tries)."""
    from scalecube_cluster_tpu_torch.ops import rand as PR
    from scalecube_cluster_tpu_torch.ops.state import SimParams

    draw = PR.draw_dense_tick if isinstance(params, SimParams) else PR.draw_sparse_tick
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [draw(gen, params, True) for _ in range(ticks)]


def driver_script(d, n: int, swap=None) -> None:
    """The driver-window script: two watched rows, spreads, a crash, a
    join, a leave, metadata bumps, a partition and its heal
    (``DRIVER_SCRIPT_STEPS``, 10 ticks); ``swap`` (``set_dissemination``'s
    keywords) arms a strategy in the middle, before the partition."""
    first, second, parted, healed = DRIVER_SCRIPT_STEPS
    for row in (0, n // 3):
        d.watch(row)
    for s in range(d.params.rumor_slots):
        d.spread_rumor((s * 997) % n, f"rumor {s}")
    for r in range(n // 2, n // 2 + max(2, n // 1024)):
        d.crash(r)
    d.step(first)
    d.join()
    d.leave(7)
    d.update_metadata(11)
    d.update_metadata_batch([11, 12, 13])
    d.step(second)
    if swap:
        d.set_dissemination(**swap)
    halves = (list(range(n // 2)), list(range(n // 2, n)))
    d.block_partition(*halves)
    d.step(parted)
    d.heal_partition(*halves)
    d.step(healed)


def check_driver_window(device, n: int = 4096, params=None, label: str = "driver-window",
                        dense_links=None, swap=None) -> None:
    """The ``n``-member driver script on the CPU and on the card from the
    same draws (``params``: the pview 1M configuration's widths by
    default)."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    ticks = sum(DRIVER_SCRIPT_STEPS)
    params = params or config16_params(n)
    draws = cpu_draws(params, ticks, seed=13)
    drivers = []
    for dev in ("cpu", device):
        d = SimDriver(params, n, seed=0, record_metrics=True, device=dev, draws=DrawList(draws),
                      dense_links=dense_links)
        driver_script(d, n, swap)
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
    sums = {k: sum(int(m[k]) for m in hist)
            for k in ("mr_accepts", "sync_roundtrips", "rumor_deliveries", "fd_new_suspects") if k in hist[0]}
    swapped = f", set_dissemination({swap}) after tick {sum(DRIVER_SCRIPT_STEPS[:2])}" if swap else ""
    phase(label, f"N={n}, {ticks} ticks through SimDriver{swapped}: every state leaf, per-tick metric "
                 f"and event log equal on CPU and {device}; events per watched row {events}, {sums}")


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

    windows, per = DRIVER_WINDOWS, 10
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


def check_checkpoint(device, n: int = 65_536, mesh=None) -> None:
    """step(5), checkpoint, step(10), restore, step(10) on an ``n``-member
    driver on the card: both trajectories end bit-equal, events included.
    With ``mesh`` the driver is sharded, and its archive is also restored
    into an unsharded driver, whose step(10) must end where the sharded
    one's did."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    from scalecube_cluster_tpu_torch.ops import delivery

    label = "checkpoint" if mesh is None else "mesh-checkpoint"
    params = config16_params(n)
    d = SimDriver(params, n, seed=0, device=device, mesh=mesh)
    launches = [0]
    step = d.step

    def counted_step(n_ticks):
        """The checked driver's own launches (an unsharded twin's are not
        its path's)."""
        before = delivery.delivery_combine.launches
        step(n_ticks)
        launches[0] += delivery.delivery_combine.launches - before

    d.step = counted_step
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
        if mesh is not None:
            first = d._eng.gather_state(first, mesh)
            u = SimDriver(params, n, seed=0, device=device)
            u.restore(path)
            u.step(10)
            unsharded = u.state
            del u
        t0 = time.perf_counter()
        d.restore(path)
        torch.cuda.synchronize()
        rs_s = time.perf_counter() - t0
    at = len(d.events_of(0))
    d.step(10)
    again = d.state if mesh is None else d._eng.gather_state(d.state, mesh)
    bad = state_differences(first, again)
    if [(e.type, e.member.id) for e in d.events_of(0)[at:]] != first_events:
        bad.append("events of row 0")
    if mesh is not None:
        bad += [f"unsharded restore: {k}" for k in state_differences(first, unsharded)]
    if bad:
        raise AssertionError(f"[{label}] checkpoint round trip at N={n} differs in: {bad}")
    phase(label, f"N={n}{' sharded' if mesh is not None else ''}: step(5), checkpoint ({size} bytes, {ck_s:.2f} s), "
                 f"step(10), restore ({rs_s:.2f} s), step(10): both trajectories bit-equal, "
                 f"{len(first_events)} events each (tick {d.tick})"
                 + ("; the archive restored into an unsharded driver ends there too; delivery_combine launches "
                    f"{launches[0]} sharded" if mesh is not None else ""))
    if mesh is not None and launches[0]:
        raise AssertionError(f"[{label}] the sharded driver launched delivery_combine {launches[0]} times")
    return launches[0]

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


def churn_second(st, params, crash, join, draws, win=None):
    """One simulated second of config5: the second's crashes, its joins,
    then 5 ticks (through ``win``, the params' window by default). Returns
    (state, stacked metrics)."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    st = SP.join_rows(SP.crash_rows(st, crash), join, params.seed_rows)
    win = win or sparse_window(params, st.device)
    st, ms, _ = win(st, draws, TICKS_PER_SECOND)
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


def run_cpu_and_card(run, device, what: str) -> dict:
    """``run(dev)`` -> (state, stacked metrics on the host) on the CPU and on
    ``device``: every state leaf equal, every metric equal (the f32 ones
    within 2 ulp). Returns the CPU run's metrics."""
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
        raise AssertionError(f"CPU and card {what} differ in: {bad}")
    return cpu_ms


def check_sparse_window(device, n: int = 4096, params=None, label: str = "sparse-window",
                        cohort=None) -> dict:
    """``WINDOW_TICKS`` sparse ticks at N = 4,096 with dense links on the CPU and on the
    card from the same draws: config5's widths, with a 2-tick FD period, a
    one-period suspicion timeout and a 20-tick SYNC period so that expiry
    and anti-entropy happen inside the window (``params`` replaces them).
    ``cohort`` (rows) takes 70% inbound loss from the start. Returns the
    CPU run's metrics."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    ticks = WINDOW_TICKS
    params = params or config5_params(n, fd_every=2, suspicion_mult=1, sync_every=20)
    draws = cpu_draws(params, ticks, seed=17)
    # a quarter before the joins and the partition, the heal at five eighths
    t1, t2 = ticks // 4, ticks * 5 // 8
    halves = (list(range(n // 2)), list(range(n // 2, n)))
    crashed = list(range(n // 2, n // 2 + 16))

    def run(dev):
        win = sparse_window(params, dev)
        st = SP.init_sparse_state(params, n - 8, dense_links=True, device=dev)
        if cohort:
            st = SP.set_link_loss(st, list(range(n)), list(cohort), 0.7)
        st = SP.crash_rows(SP.spread_rumor(st, 0, 5), crashed)
        st, ms_a, _ = win(st, draws[:t1], t1)
        st = SP.join_rows(st, [n - 8, n - 7] + crashed[:2], params.seed_rows)  # two rejoins
        st = SP.block_partition(SP.spread_rumor(st, 1, 77), *halves)
        st, ms_b, _ = win(st, draws[t1:t2], t2 - t1)
        st = SP.heal_partition(st, *halves)
        st, ms_c, _ = win(st, draws[t2:], ticks - t2)
        return st, {**{k: torch.cat([ms_a[k], ms_b[k], ms_c[k]]).cpu() for k in ms_a}, **win.planes()}

    cpu_ms = run_cpu_and_card(run, device, "sparse windows")
    sums = {k: int(cpu_ms[k].sum()) for k in ("mr_accepts", "sync_roundtrips", "fd_new_suspects",
                                               "rumor_deliveries", "announced", "pool_evicted")}
    phase(label, f"N={n}, {ticks} ticks, dense links{dissem_label(params)}{adaptive_label(params)}"
                 f"{f', 70% inbound loss on {len(cohort)} rows' if cohort else ''}: every state leaf, metric and "
                 f"adaptive plane equal on CPU and {device}; {sums}")
    return cpu_ms


def run_sparse_main_path(device, params=None, label: str = "sparse-main", delay: float = 0.0) -> dict:
    """The sparse main path: config5's churn run at N_SPARSE (``params``:
    config5's by default; ``delay``: a uniform mean link delay)."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    n = N_SPARSE
    params = params or config5_params(n)
    warm_s, timed_s = 2, 6
    churn, crash, join = churn_schedule(n, warm_s + timed_s, params.seed_rows)
    t0 = time.perf_counter()
    st = SP.init_sparse_state(params, n - churn, warm=True, uniform_delay=delay, device=device)
    torch.cuda.synchronize()
    phase(label, f"N={n} state built in {time.perf_counter() - t0:.2f} s: view_key "
                         f"{tuple(st.view_key.shape)} {st.view_key.dtype}, minf_age {tuple(st.minf_age.shape)}, "
                         f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; churn {churn} "
                         f"crashes and {churn} joins per simulated second")
    gen = torch.Generator(device=device).manual_seed(11)
    win = sparse_window(params, device)
    t0 = time.perf_counter()
    for sec in range(warm_s):
        st, _ = churn_second(st, params, crash[sec], join[sec], gen, win)
    torch.cuda.synchronize()
    phase(label, f"warm-up, {warm_s} simulated seconds ({warm_s * TICKS_PER_SECOND} ticks): "
                         f"{time.perf_counter() - t0:.2f} s")

    ticks = timed_s * TICKS_PER_SECOND
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    per_s = []
    for sec in range(warm_s, warm_s + timed_s):
        st, ms = churn_second(st, params, crash[sec], join[sec], gen, win)
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
    phase(label, f"N={n}, {timed_s} simulated seconds ({ticks} ticks, churn included){dissem_label(params)}"
                         f"{adaptive_label(params)}: "
                         f"{ms_tick:.2f} ms/tick, realtime factor {1000 / (TICKS_PER_SECOND * ms_tick):.3f}, "
                         f"peak allocated {peak / 2 ** 30:.2f} GiB, delivery_combine launches {launches}, "
                         f"branch-flag reads {flags} ({flags / ticks:.1f}/tick); invariants held")
    phase(label, f"pool high-water {int(ms['mr_active_count'].max())} of {params.mr_slots}, announced "
                         f"{int(ms['announced'].sum())}, dropped {int(ms['announce_dropped'].sum())} (fd "
                         f"{int(ms['announce_dropped_fd'].sum())}, expiry {int(ms['announce_dropped_expiry'].sum())}, "
                         f"refute {int(ms['announce_dropped_refute'].sum())}, sync "
                         f"{int(ms['announce_dropped_sync'].sum())}), evicted {int(ms['pool_evicted'].sum())}, "
                         f"new suspects {int(ms['fd_new_suspects'].sum())}, mr_accepts {int(ms['mr_accepts'].sum())}")
    return {"launches": launches, "state": st, "gen": gen, "params": params, "ms_tick": ms_tick, "peak": peak,
            "flags": flags / ticks, "ms": ms}


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

    windows, per = DRIVER_WINDOWS, 10
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


# -- the dense engine --------------------------------------------------------------

N_DENSE = 10_000  # config4's cluster
N_DELAY = 8192  # auto_params' dense_threshold: the policy's delay regime
DENSE_PHASES = ("_fd_phase", "_gate_flags", "_suspicion_phase", "_gossip_phase", "_sync_phase",
                "_refute_phase", "_rumor_sweep", "state_metrics")
# benchmarks/config3_fd_loss.py:delay_main's SparseParams knobs, less the
# sparse-only pool sizes (mr_slots, announce_slots)
CONFIG3_KNOBS = dict(fanout=3, repeat_mult=3, ping_req_k=3, fd_every=1, sync_every=300, suspicion_mult=5,
                     rumor_slots=2, seed_rows=(0,), delay_slots=6, fd_direct_timeout_ticks=2,
                     fd_leg_timeout_ticks=1)
CONFIG3_LOSS, CONFIG3_DELAY_MEAN, CONFIG3_ROUNDS = 0.05, 1.5, 200


def config4_params(n: int = N_DENSE, **over):
    """config4's partition configuration (benchmarks/config4_partition.py:30-99)."""
    from scalecube_cluster_tpu_torch.ops.state import SimParams

    knobs = dict(fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5, sync_every=150, suspicion_mult=5,
                 rumor_slots=2, seed_rows=(0, 1))
    return SimParams(capacity=n, **{**knobs, **over})


def config9_dense_params(n: int, key_dtype: str = "i16"):
    """config9's dense params (benchmarks/config9_bitplane.py:60-64), with the
    full health metrics on."""
    from scalecube_cluster_tpu_torch.ops.state import SimParams

    return SimParams(capacity=n, fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5, sync_every=150,
                     suspicion_mult=5, rumor_slots=8, seed_rows=(0,), full_metrics=True, key_dtype=key_dtype)


def dense_launch_count() -> int:
    """delivery_combine launches so far (the dense paths must add none)."""
    from scalecube_cluster_tpu_torch.ops import delivery

    return delivery.delivery_combine.launches


def check_dense_window(device, n: int = 4096) -> None:
    """``DENSE_WINDOW_STEPS`` dense ticks at N = 4,096 with config9's i16 widths and dense links
    on the CPU and on the card from the same draws: a crash wave, a rumor,
    a ``join_rows`` batch with two rejoins, a partition and its heal."""
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import state as S

    a, b, c = DENSE_WINDOW_STEPS
    ticks = a + b + c
    params = config9_dense_params(n)
    draws = cpu_draws(params, ticks, seed=19)
    halves = (list(range(n // 2)), list(range(n // 2, n)))
    crashed = list(range(n // 2, n // 2 + 16))

    def run(dev):
        st = S.init_state(params, n - 8, dense_links=True, device=dev)
        st = S.crash_rows(S.spread_rumor(st, 0, 5), crashed)
        st, ms_a, _ = K.run_ticks(st, draws[:a], a, params)
        st = S.join_rows(st, [n - 8, n - 7] + crashed[:2], params.seed_rows)
        st = S.block_partition(S.spread_rumor(st, 1, 77), *halves)
        st, ms_b, _ = K.run_ticks(st, draws[a:a + b], b, params)
        st = S.heal_partition(st, *halves)
        st, ms_c, _ = K.run_ticks(st, draws[a + b:], c, params)
        return st, {k: torch.cat([ms_a[k], ms_b[k], ms_c[k]]).cpu() for k in ms_a}

    cpu_ms = run_cpu_and_card(run, device, "dense windows")
    sums = {k: int(cpu_ms[k].sum()) for k in ("fd_new_suspects", "gossip_msgs", "sync_roundtrips",
                                               "rumor_deliveries")}
    phase("dense-window", f"N={n}, {ticks} ticks, i16 keys, dense links: every state leaf and metric "
                          f"equal on CPU and {device}; {sums}")


def check_dense_delay_window(device, n: int = 2048, params=None, label: str = "dense-delay-window",
                             flaky=None) -> dict:
    """``WINDOW_TICKS`` dense ticks at N = 2,048 with config3's delay configuration (i32,
    loss 0.05, mean delay 1.5 ticks, 6 ring slots; ``params`` replaces it)
    and a slower group of links through ``set_link_delay``, on the CPU and
    on the card. ``flaky`` (a row) becomes an observer whose sends mostly
    drop. Returns the CPU run's metrics."""
    from scalecube_cluster_tpu_torch.ops import state as S

    ticks = WINDOW_TICKS
    params = params or config4_params(n, **CONFIG3_KNOBS)
    draws = cpu_draws(params, ticks, seed=23)

    def run(dev):
        win = dense_window(params, dev)
        st = S.init_state(params, n - 2, uniform_loss=CONFIG3_LOSS, uniform_delay=CONFIG3_DELAY_MEAN,
                          device=dev)
        st = S.set_link_delay(S.spread_rumor(st, 0, 9), list(range(8)), list(range(n)), 4.0)
        if flaky is not None:
            st = S.set_link_loss(st, [flaky], list(range(n)), 0.7)
        st = S.crash_rows(st, [40, 41])
        st, ms, _ = win(st, draws, ticks)
        return st, {**{k: v.cpu() for k, v in ms.items()}, **win.planes()}

    cpu_ms = run_cpu_and_card(run, device, "dense delay windows")
    sums = {k: int(cpu_ms[k].sum()) for k in ("fd_probes", "fd_failed_probes", "gossip_msgs",
                                               "rumor_deliveries")}
    phase(label, f"N={n}, {ticks} ticks, delay rings (D = {params.delay_slots}, mean 1.5 ticks, rows 0-7 at "
                 f"4.0){dissem_label(params)}{adaptive_label(params)}"
                 f"{f', row {flaky} a flaky observer' if flaky is not None else ''}: every state leaf, metric and "
                 f"adaptive plane equal on CPU and {device}; {sums}")
    return cpu_ms


def copy_state(st, device):
    """A deep copy of a dense state (or of an adaptive plane) on ``device``
    (the tick consumes the state it is given)."""
    import dataclasses as dc

    return dc.replace(st, **{f.name: getattr(st, f.name).to(device, copy=True)
                             for f in dc.fields(st) if f.name != "tick"})


class WindowStart:
    """The start of a dense window kept on the host for a rerun, so the
    card's peak is the tick's: the leaves the tick writes, copied into
    pinned host buffers reused from window to window; the link planes
    (``loss``, ``fetch_rt``, ``delay_q``), which a tick only reads, kept
    by reference."""

    READ_ONLY = ("loss", "fetch_rt", "delay_q")

    def __init__(self):
        self.buf, self.kept = {}, None

    def save(self, st) -> None:
        import dataclasses as dc

        for f in dc.fields(st):
            if f.name == "tick" or f.name in self.READ_ONLY:
                continue
            src = getattr(st, f.name)
            b = self.buf.get(f.name)
            if b is None or b.shape != src.shape or b.dtype != src.dtype:
                b = self.buf[f.name] = torch.empty(src.shape, dtype=src.dtype,
                                                 pin_memory=torch.cuda.is_available())
            b.copy_(src, non_blocking=True)  # ordered before the window's ticks on the stream
        self.kept = st.replace(**{k: None for k in self.buf})

    def restore(self, device):
        return self.kept.replace(**{k: b.to(device, copy=True) for k, b in self.buf.items()})


def minority_detected(watched, split: int) -> torch.Tensor:
    """[T] bool: the watched majority observer holds every minority row at
    status >= 3 (DEAD, or no record: both read rank 3) after each tick."""
    return ((watched[:, 0, :split] & 3) == 3).all(dim=1)


def profile_dense(st, gen, params, ticks: int, label: str, watch=None):
    """``ticks`` dense ticks under the profiler with quiet_gates on (the
    flag reads), then as many with every gate open (quiet_gates off, the
    same values): per-phase host and device time for each. Returns (state,
    watched rows of the two runs, the gated run's numbers, the ungated
    run's)."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.ops import kernel as K

    out, watched = {}, []
    for gated in (True, False):
        p = params if gated else dc.replace(params, quiet_gates=False)
        box = {}

        def run(p=p, box=box, st=st):
            box["r"] = K.run_ticks(st, gen, ticks, p, watch_rows=watch)

        phase(label, f"ticks {st.tick + 1}-{st.tick + ticks}, quiet_gates={gated}")
        out[gated] = profile_phases(run, DENSE_PHASES, ticks=ticks, label=label, module=K)
        st, _, w = box["r"]
        watched.append(w)
    return st, watched, out[True], out[False]


def report_gates(label: str, gated, ungated) -> None:
    """The gate choice's evidence: wall and per-phase time, flag reads vs
    ungated work."""
    if gated is None or ungated is None:
        phase(label, "gate comparison not measured (no device time recorded)")
        return
    phase(label, f"quiet_gates on / off: wall {gated['wall_ms']:.3f} / {ungated['wall_ms']:.3f} ms/tick, "
                 f"device busy {gated['busy_ms']:.3f} / {ungated['busy_ms']:.3f}, idle share "
                 f"{gated['idle']:.3f} / {ungated['idle']:.3f}")
    for name in ("gate_flags", "suspicion_phase", "gossip_phase", "refute_phase"):
        phase(label, f"{name}: host {gated['host_ms'].get(name, 0):.3f} / {ungated['host_ms'].get(name, 0):.3f}, "
                     f"device span {gated['span_ms'].get(name, 0):.3f} / {ungated['span_ms'].get(name, 0):.3f} "
                     "ms/tick (gated / ungated)")


def run_dense_main(device, n: int = N_DENSE, window: int = 25, profile_at: int = 200, settle: int = 60,
                   params=None, label: str = "dense-main", profile_label: str = "dense-profile",
                   profile: bool = True) -> dict:
    """The dense main path: config4's partition run at ``n`` members through
    ``make_run`` windows of ``window`` ticks watching the majority observer
    (row n - 1). A window in which the minority is detected is run again
    from a copy of its start, up to the detection tick, so the heal lands
    on that tick, as config4's loop heals (the copy is kept on the host).
    ``profile_at`` partitioned ticks
    in, 5 ticks run under the profiler with the gates on and 5 with them
    off (in the trajectory, out of the timing); after the recovery, 2
    ticks count the operations that wait for the device, and ``settle``
    ticks later (the forwarding windows of the last changes closed) 5 + 5
    more are profiled. ``params`` (config4's by default) and ``label`` name
    another run of the same script, ``profile_label`` its profiles;
    ``profile=False`` leaves the profiles out. An adaptive ``params`` runs
    the adaptive window (the rerun restores its planes too) and returns its
    gauges."""
    from scalecube_cluster_tpu_torch.ops import _tensor
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import state as S

    params = params or config4_params(n)
    split = n // 10
    minority, majority = list(range(split)), list(range(split, n))
    math_ticks = params.suspicion_mult * n.bit_length() * params.fd_every
    detect_budget, recover_budget = int(math_ticks * 2.5), params.sync_every * 8
    t0 = time.perf_counter()
    st = S.block_partition(S.init_state(params, n, warm=True, dense_links=True, device=device),
                           minority, majority)
    torch.cuda.synchronize()
    phase(label, f"N={n} state built and partitioned {split}/{n - split} in "
                        f"{time.perf_counter() - t0:.2f} s: view_key {tuple(st.view_key.shape)} "
                        f"{st.view_key.dtype}, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated; "
                        f"detection budget {detect_budget} ticks (2.5 x the suspicion math {math_ticks}), "
                        f"recovery budget {recover_budget}")
    gen = torch.Generator(device=device).manual_seed(0)
    win = dense_window(params, device)
    highs = []  # the adaptive gauges' per-tick metrics of every window
    watch = torch.tensor([n - 1], device=device)
    launches0 = dense_launch_count()
    torch.cuda.reset_peak_memory_stats()
    _tensor.HOST_SYNCS.count = 0
    timed = {"part": [0, 0.0], "heal": [0, 0.0]}  # ticks, seconds (the first window is warm-up)
    flags_timed = 0
    detected = None
    done = 0
    prof_part = None
    start = WindowStart()
    while detected is None and done < detect_budget:
        if profile and done == profile_at:
            st, ws, g, u = profile_dense(st, gen, params, 5, profile_label, watch=watch)
            prof_part = (g, u)
            det = minority_detected(torch.cat(ws), split)
            if bool(det.any()):
                raise AssertionError("the minority was detected inside the profiled ticks")
            done += 10
            continue
        w = min(window, detect_budget - done, profile_at - done if profile and done < profile_at else window)
        # the window's start, kept on the host so the card's peak is the tick's
        start.save(st)
        saved = (gen.get_state(), copy_state(win.ad, "cpu") if win.ad is not None else None)
        syncs = _tensor.HOST_SYNCS.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ms_w, watched = win(st, gen, w, watch_rows=watch)
        highs.append(ms_w)
        det = minority_detected(watched, split)
        hit = bool(det.any())  # the one read per window (it waits for the window)
        wall = time.perf_counter() - t0
        if done:
            timed["part"][0] += w
            timed["part"][1] += wall
            flags_timed += _tensor.HOST_SYNCS.count - syncs
        if hit:
            k = int(torch.nonzero(det)[0])
            detected = done + k + 1
            if k + 1 < w:
                # back to the window's start, then up to the detection tick
                st = start.restore(device)
                gen.set_state(saved[0])
                if win.ad is not None:
                    win.ad = copy_state(saved[1], device)
                st, _, _ = win(st, gen, k + 1)
        done += w
        del saved
    if detected is None:
        raise AssertionError(f"the majority observer did not detect the minority within {detect_budget} ticks")
    part_ticks = detected
    st = S.heal_partition(st, minority, majority)
    bulk = full = None
    done = 0
    last_frac = None
    while full is None and done < recover_budget:
        w = min(window, recover_budget - done)
        syncs = _tensor.HOST_SYNCS.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ms, _ = win(st, gen, w)
        highs.append(ms)
        frac = ms["alive_view_fraction"].cpu()
        wall = time.perf_counter() - t0
        timed["heal"][0] += w
        timed["heal"][1] += wall
        flags_timed += _tensor.HOST_SYNCS.count - syncs
        for i, f in enumerate(frac.tolist()):
            if bulk is None and f >= 0.99:
                bulk = done + i + 1
            if full is None and f >= 0.9999:
                full = done + i + 1
        last_frac = float(frac[-1])
        done += w
    peak = torch.cuda.max_memory_allocated()
    launches = dense_launch_count() - launches0
    ok = detected is not None and bulk is not None
    ticks_t = timed["part"][0] + timed["heal"][0]
    ms_all = (timed["part"][1] + timed["heal"][1]) / ticks_t * 1e3
    ms_part = timed["part"][1] / max(timed["part"][0], 1) * 1e3
    ms_heal = timed["heal"][1] / max(timed["heal"][0], 1) * 1e3
    phase(label, f"N={n}{dissem_label(params)}{adaptive_label(params)}: detected at tick {detected}, bulk (0.99) "
                        f"recovery {bulk}, full (0.9999) "
                        f"recovery {full} ticks after the heal (final alive_view_fraction {last_frac}); the JAX "
                        f"package recorded 392 / 329 / 444 (BENCH_RESULTS_r05.json, config 4); config4 ok {ok}")
    phase(label, f"ms/tick {ms_all:.2f} over {ticks_t} timed ticks (partitioned {ms_part:.2f} over "
                        f"{timed['part'][0]}, healed {ms_heal:.2f} over {timed['heal'][0]}; the first window, the "
                        f"rerun of the detection window and the profiled ticks untimed), peak allocated "
                        f"{peak / 2 ** 30:.2f} GiB, branch-flag reads {flags_timed} "
                        f"({flags_timed / ticks_t:.2f}/tick), delivery_combine launches {launches}")
    if launches:
        raise AssertionError(f"the dense main path launched delivery_combine {launches} times")
    if not ok:
        raise AssertionError(f"config4's ok failed: detected {detected}, bulk recovery {bulk}")
    # two more ticks in the mode where every operation that waits for the
    # device warns (kept out of the timed run, which it perturbs)
    _tensor.HOST_SYNCS.count = 0

    def two_more():
        nonlocal st
        st, _, _ = win(st, gen, 2)

    waits = count_waits(two_more)
    phase(label, f"2 more ticks: {_tensor.HOST_SYNCS.count} branch-flag reads, {waits} operations "
                        "waited for the device")
    st, ms, _ = win(st, gen, settle)
    quiet = int((ms["gossip_msgs"] == 0).sum())
    phase(label, f"{settle} settling ticks: {quiet} with no gossip message sent")
    if profile:
        st, _, g, u = profile_dense(st, gen, params, 5, f"{profile_label}-healed")
        if prof_part is not None:
            report_gates(profile_label, *prof_part)
        report_gates(f"{profile_label}-healed", g, u)
    out = {"launches": launches, "ms_part": ms_part, "ms_heal": ms_heal, "peak": peak, "part_ticks": part_ticks,
           "detected": detected, "bulk": bulk, "full": full, "budgets": (detect_budget, recover_budget),
           "flags": flags_timed / ticks_t}
    if win.ad is not None:
        out["ms"] = {k: torch.cat([m[k] for m in highs]) for k in ("adaptive_lh_high", "adaptive_conf_high")}
    return out


def run_dense_driver(device, n: int = N_DENSE) -> dict:
    """SimDriver on the card at ``n`` over config4's params: the partition,
    two watched rows, a 5-tick warm-up, three timed ``step(10)``, then the
    heal and one timed ``step(10)``."""
    from scalecube_cluster_tpu_torch.ops import _tensor
    from scalecube_cluster_tpu_torch.sim import SimDriver

    params = config4_params(n)
    split = n // 10
    minority, majority = list(range(split)), list(range(split, n))
    d = SimDriver(params, n, warm=True, seed=0, device=device)
    d.block_partition(minority, majority)
    watched = (0, n - 1)
    for row in watched:
        d.watch(row)
    d.step(5)
    d.sync()
    launches0 = dense_launch_count()
    readbacks = d.dispatch_stats["readbacks"]
    torch.cuda.reset_peak_memory_stats()
    _tensor.HOST_SYNCS.count = 0
    t0 = time.perf_counter()
    for _ in range(3):
        last = d.step(10)
    d.sync()
    wall = time.perf_counter() - t0
    flags = _tensor.HOST_SYNCS.count
    d.heal_partition(minority, majority)
    t1 = time.perf_counter()
    d.step(10)
    d.sync()
    wall_heal = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    readbacks = d.dispatch_stats["readbacks"] - readbacks
    launches = dense_launch_count() - launches0
    if launches:
        raise AssertionError(f"the dense driver launched delivery_combine {launches} times")
    if int(last["n_up"]) != n:
        raise AssertionError(f"n_up {int(last['n_up'])} != {n}")
    events = {row: len(d.events_of(row)) for row in watched}
    snap = d.health_snapshot()
    if "pool" in snap:
        raise AssertionError("the dense engine's health snapshot has a pool block")
    ms_tick = wall / 30 * 1e3
    phase("dense-driver", f"N={n}, partitioned, 3 x step(10): {ms_tick:.2f} ms/tick; healed step(10): "
                          f"{wall_heal / 10 * 1e3:.2f} ms/tick; peak allocated {peak / 2 ** 30:.2f} GiB, "
                          f"branch-flag reads {flags} ({flags / 30:.2f}/tick), driver readbacks {readbacks}, "
                          f"delivery_combine launches {launches}; events per watched row {events}; "
                          f"health_snapshot tick {snap['tick']}, stale subjects {snap['staleness']['stale_subjects']}")
    return {"launches": launches, "ms_tick": ms_tick}


def timely(q: float, t: int) -> float:
    """Host mirror (f64) of the kernel's P(two geometric(q) legs <= t)
    (benchmarks/config3_fd_loss.py:_timely)."""
    h, acc, qp = 1.0, 1.0, 1.0
    for _ in range(t):
        qp *= q
        h = q * h + qp
        acc += h
    return (1.0 - q) * (1.0 - q) * acc


def run_dense_delay(device, n: int = N_DELAY, rounds: int = CONFIG3_ROUNDS, window: int = 50) -> dict:
    """The policy's delay regime: ``SimDriver(auto_params(n, link_delay=True,
    **config3's knobs), n)``, loss 0.05 on every link (``set_uniform_loss``)
    and a mean delay of 1.5 ticks on every link (``set_link_delay``), 200
    FD rounds in windows of 50. The raw FD failure rate against config3's
    analytic rate with its timeliness factors."""
    from scalecube_cluster_tpu_torch.ops import state as S
    from scalecube_cluster_tpu_torch.sim.driver import SimDriver, auto_params

    params = auto_params(n, link_delay=True, **CONFIG3_KNOBS)
    if not isinstance(params, S.SimParams):
        raise AssertionError(f"auto_params({n}, link_delay=True) chose {type(params).__name__}")
    d = SimDriver(params, n, warm=True, seed=0, record_metrics=True, device=device)
    d.state = S.set_uniform_loss(d.state, CONFIG3_LOSS)
    d.set_link_delay(range(n), range(n), CONFIG3_DELAY_MEAN)
    launches0 = dense_launch_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(rounds // window):
        d.step(window)
    d.sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dense_launch_count() - launches0
    hist = d.metrics_history
    probes = sum(int(m["fd_probes"]) for m in hist)
    failed = sum(int(m["fd_failed_probes"]) for m in hist)
    q = S.delay_mean_to_q(CONFIG3_DELAY_MEAN)
    p_direct = (1 - CONFIG3_LOSS) ** 2 * timely(q, params.fd_direct_timeout_ticks)
    p_relay = (1 - CONFIG3_LOSS) ** 4 * timely(q, params.fd_leg_timeout_ticks) ** 2
    analytic = (1 - p_direct) * (1 - p_relay) ** params.ping_req_k
    observed = failed / max(probes, 1)
    sigma = (analytic * (1 - analytic) / max(probes, 1)) ** 0.5
    z = (observed - analytic) / sigma
    phase("dense-delay", f"N={n}, {rounds} FD rounds: raw FD failure rate {observed:.6f} against analytic "
                         f"{analytic:.6f} (sigma {sigma:.6f} over {probes} probes, z = {z:.2f}); config3's 3-sigma "
                         f"within_tolerance {abs(z) < 3}; {wall / rounds * 1e3:.2f} ms/tick, peak allocated "
                         f"{peak / 2 ** 30:.2f} GiB, delivery_combine launches {launches}")
    if launches:
        raise AssertionError(f"the dense delay path launched delivery_combine {launches} times")
    if abs(z) > 5:
        raise AssertionError(f"the FD failure rate is {z:.2f} sigma from config3's analytic rate")
    return {"launches": launches, "z": z}



# -- the dissemination strategies -----------------------------------------------------

STRUCTURED_SPEC = dict(strategy="accelerated", topology="expander")


def check_structured_kernel(device, n: int = N_MAIN, F: int = 3, R: int = 8, Wm: int = 64, tick: int = 7) -> dict:
    """The kernel on the ``inv`` the gossip phase builds from
    ``accelerated/expander`` peers at the main path's widths, every sender
    up with payload: each fanout slot is a circulant permutation, so every
    receiver has exactly one sender per slot. Bit-equal to the plain
    version, timed beside the byte bound recomputed for this ``inv`` (one
    sender row per distinct valid sender)."""
    from scalecube_cluster_tpu_torch.dissemination import DissemSpec
    from scalecube_cluster_tpu_torch.dissemination import strategies as dz
    from scalecube_cluster_tpu_torch.ops import delivery

    gen = torch.Generator(device=device).manual_seed(3)
    ym_p, yu_p, infected_from, _, origin = delivery_inputs(n, gen, F, R, Wm)
    u = torch.rand((n, F), generator=gen, device=device)
    peers, _ = dz.structured_peers(DissemSpec(**STRUCTURED_SPEC), n, tick, u)
    p_all = peers.T.contiguous().long()
    rows = torch.arange(n, dtype=torch.int32, device=device)[None, :].expand(F, n)
    inv = torch.full((F, n), -1, dtype=torch.int32, device=device)
    inv.scatter_reduce_(1, p_all, rows, "amax", include_self=True)
    if bool((inv < 0).any()):
        raise AssertionError("a receiver has no sender on the circulant inv")
    planes = (ym_p, yu_p, infected_from, inv, origin)
    got = delivery.delivery_combine(*planes)
    ref_args = (torch.cat([ym_p, yu_p, infected_from], dim=1), inv, origin, Wm, R)
    ref = delivery.delivery_combine_ref(*ref_args)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, ref))
    if err != 0:
        raise AssertionError(f"delivery_combine differs from its plain version on the circulant inv: max abs err {err}")
    ms = kernel_ms(lambda: delivery.delivery_combine(*planes), "delivery_combine_kernel")
    plain_ms = time_cuda(lambda: delivery.delivery_combine_ref(*ref_args), reps=5, warmup=1)
    bound = bytes_ms(delivery_bytes(*planes[:4], reuse=True))
    senders = torch.unique(inv).numel()
    phase("kernels", f"delivery_combine on the {STRUCTURED_SPEC['strategy']}/{STRUCTURED_SPEC['topology']} inv "
                     f"(N={n} F={F} R={R} Wm={Wm}, tick {tick}): bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"bound {bound:.4f} ms (roofline share {bound / ms:.3f}), valid slots {int((inv >= 0).sum())} "
                     f"of {inv.numel()}, distinct senders {senders}")
    return dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)


def count_launches(fn):
    """``fn()``'s result and the delivery_combine launches it made (the
    count zeroed just before, read just after)."""
    from scalecube_cluster_tpu_torch.ops import delivery

    saved = delivery.delivery_combine.launches
    delivery.delivery_combine.launches = 0
    try:
        out = fn()
        return out, delivery.delivery_combine.launches
    finally:
        delivery.delivery_combine.launches += saved


def count_kernel_launches(fn):
    """``fn()``'s result and the launches of both kernel wrappers it made,
    (result, delivery_combine launches, delivery_combine_fleet launches):
    each count zeroed just before, read just after."""
    from scalecube_cluster_tpu_torch.ops import delivery

    saved = delivery.delivery_combine_fleet.launches
    delivery.delivery_combine_fleet.launches = 0
    try:
        out, serial = count_launches(fn)
        return out, serial, delivery.delivery_combine_fleet.launches
    finally:
        delivery.delivery_combine_fleet.launches += saved


def check_dissem_windows(device) -> dict:
    """Armed windows on the CPU and on the card from the same draws: pview
    at 4,096 under push_pull/expander, sparse at 4,096 under
    pipelined/ring (budget 2), dense at 2,048 under push_pull/full with the
    delay rings (D = 3), and the driver script on config9's dense params
    with a swap to accelerated/ring in the middle. Returns the card's
    launches per window."""
    launches = {}
    _, launches["dissem-pview-window"] = count_launches(lambda: check_cross_device(
        device, params=armed(config16_params(4096), strategy="push_pull", topology="expander"),
        label="dissem-windows"))
    _, launches["dissem-sparse-window"] = count_launches(lambda: check_sparse_window(
        device, params=armed(config5_params(4096, fd_every=2, suspicion_mult=1, sync_every=20),
                             strategy="pipelined", topology="ring", pipeline_budget=2),
        label="dissem-windows"))
    check_dense_delay_window(device, params=armed(config4_params(2048, **{**CONFIG3_KNOBS, "delay_slots": 3}),
                                                  strategy="push_pull", topology="full"),
                             label="dissem-windows")
    check_driver_window(device, params=config9_dense_params(4096), label="dissem-windows", dense_links=True,
                        swap=dict(strategy="accelerated", topology="ring"))
    return launches


def config12_control(device, n: int = 4096, spec=None) -> float:
    """config12's default-spec control (benchmarks/config12_strategies.py:55-88):
    dense at ``n`` members, 8 rumor slots, one sweep budget of ticks per
    window; a warm-up window, then one timed window after a fresh spread.
    ``spec`` arms the same run. Returns ms/tick."""
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import state as S
    from scalecube_cluster_tpu_torch.ops.state import SimParams
    from scalecube_cluster_tpu_torch.utils.cluster_math import gossip_periods_to_sweep

    params = SimParams(capacity=n, fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5, sync_every=150,
                       suspicion_mult=5, rumor_slots=8, seed_rows=(0,), full_metrics=False)
    if spec:
        params = armed(params, **spec)
    budget = gossip_periods_to_sweep(params.repeat_mult, n)
    step = K.make_run(params, budget)
    gen = torch.Generator(device=device).manual_seed(0)
    st = S.spread_rumor(S.init_state(params, n, warm=True, device=device), 0, origin=0)
    st, _, _ = step(st, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = S.spread_rumor(st, 0, origin=97)
    st, ms, _ = step(st, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cov = ms["rumor_coverage"][:, 0].cpu()
    if not bool((cov >= 1.0).any()):
        raise AssertionError(f"config12 control N={n} {spec}: no full coverage in {budget} ticks")
    return wall / budget * 1e3


CERTIFY_KW = dict(n=256, seeds=(0, 1, 2, 3, 4), fanout=3, rumor_slots=8, geo_wan_delay_ticks=2, pipeline_budget=2)


def certify_entry(task) -> tuple:
    """One entry of the certification matrix in a worker process:
    ``spread_certifier`` over that entry alone (with the pipelined steady
    state when the entry is pipelined) on ``device``. ``task`` is (entry,
    device, the certifier's keywords). Returns (record, its log lines)."""
    from scalecube_cluster_tpu_torch.dissemination.certify import spread_certifier

    entry, device, kw = task
    lines = []
    rec = spread_certifier((entry,), device=device, log=lines.append, **kw)
    return rec, lines


POOL_WORKERS = 8  # the one-card machine's CPU cores


def pool_task(task) -> tuple:
    """One task of the shared worker pool, in a worker process: ``task`` is
    (kind, argument), kind one of "config15", "c14-sweep", "certify",
    "c14-fp", "c14-mc" and "config13". Returns (kind, result, the
    delivery_combine launches and the delivery_combine_fleet launches the
    task made, both counts zeroed just before it, its wall seconds)."""
    from scalecube_cluster_tpu_torch.ops import delivery

    torch.set_num_threads(1)  # a worker's tensors live on the card; its host work is one thread
    kind, arg = task
    delivery.delivery_combine.launches = 0
    delivery.delivery_combine_fleet.launches = 0
    t0 = time.perf_counter()
    out = {"certify": certify_entry, "config13": config13_entry, "config15": config15_cell, "c14-mc": c14_mc_cell,
           "c14-fp": c14_fp_arm, "c14-sweep": c14_sweep}[kind](arg)
    return (kind, out, delivery.delivery_combine.launches, delivery.delivery_combine_fleet.launches,
            time.perf_counter() - t0)


def run_worker_pool(device) -> dict:
    """The Monte Carlo tasks of phases 23, 29, 33 and 43 in one pool of
    POOL_WORKERS processes on the one card, the longest first: config15's
    three certification cells, config14's ``adaptive_knob_sweep``,
    config12's certification matrix (entries by their bounds), config14's
    ``fp_rate_mc`` arms and Monte Carlo cells, config13's 18 entries. Their
    ticks are small (N = 48 to 256; S up to 1,024) and bound by the host's
    dispatch, so one pool keeps every core busy where running them in turn
    left most idle. The main process waits for the pool: no timed phase
    runs beside it. Returns, per kind, the (result, launches, fleet
    launches) of each task in submission order, and the pool's wall
    time."""
    import multiprocessing

    from scalecube_cluster_tpu_torch.chaos import shifting as SH
    from scalecube_cluster_tpu_torch.dissemination import DissemSpec
    from scalecube_cluster_tpu_torch.dissemination.certify import DEFAULT_MATRIX, DEFAULT_MC_MATRIX, theory_bound

    def cost(entry):
        strategy, topology, engine = entry
        spec = DissemSpec(strategy=strategy, topology=topology, pipeline_budget=CERTIFY_KW["pipeline_budget"])
        return theory_bound(spec, CERTIFY_KW["n"], CERTIFY_KW["fanout"], CERTIFY_KW["rumor_slots"])["bound_ticks"]

    dev = str(device)
    order = sorted(range(len(DEFAULT_MATRIX)), key=lambda i: -cost(DEFAULT_MATRIX[i]))
    tasks = [("config15", (i, C15_N, C15_SEEDS, dev)) for i in range(len(SH.SHIFTING_FAMILY))]
    tasks += [("c14-sweep", (C14_SWEEP_SEEDS, dev))]
    tasks += [("certify", (DEFAULT_MATRIX[i], dev, CERTIFY_KW)) for i in order]
    tasks += [("c14-fp", (arm, dev)) for arm in ("static", "adaptive")]
    tasks += [("c14-mc", (strat, topol, engine, dev)) for strat, topol, engine in DEFAULT_MC_MATRIX]
    tasks += [("config13", (seed, floor, adaptive, dev)) for floor in C13_FLOORS for seed in C13_SEEDS
              for adaptive in (False, True)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(POOL_WORKERS) as pool:
        done = pool.map(pool_task, tasks, chunksize=1)
    wall = time.perf_counter() - t0
    out = {"wall": wall, "n_tasks": len(tasks), "certify_order": order}
    walls = {}
    for kind, res, serial, fleet, task_s in done:
        out.setdefault(kind, []).append((res, serial, fleet))
        walls[kind] = walls.get(kind, 0.0) + task_s
    phase("worker-pool", f"{len(tasks)} tasks in {POOL_WORKERS} worker processes on {device}: {wall:.1f} s; "
                         f"task seconds by kind {({k: round(v, 1) for k, v in walls.items()})} "
                         f"({sum(walls.values()) / (POOL_WORKERS * wall):.2f} of the pool's process-seconds); "
                         "their verdicts are printed by phases 23, 29, 33 and 43")
    return out


def run_dissem_certify(device, pooled: dict) -> dict:
    """config12's certification matrix on the card (DEFAULT_MATRIX at the
    published N = 256, seeds 0-4, fanout 3, 8 rumor slots, geo WAN delay 2,
    pipeline budget 2), run by ``run_worker_pool``: every entry and the
    pipelined steady state must be certified. Then config12's default-spec
    control at dense N = 4,096 beside two armed spellings of it."""
    order = pooled["certify_order"]
    results = [None] * len(order)
    for i, ((rec, lines), serial, _fleet) in zip(order, pooled["certify"]):
        results[i] = (rec, serial, lines)
    launches = sum(n for _, n, _ in results)
    # each pipelined entry's worker measured the (same) steady state too
    logged = [line for _, _, lines in results for line in lines]
    for line in [x for x in logged if not x.startswith("pipelined steady-state")] + \
            [x for x in logged if x.startswith("pipelined steady-state")][:1]:
        phase("dissem-certify", line)
    entries = [rec["entries"][0] for rec, _, _ in results]
    steady = [rec["pipeline_steady_state"] for rec, _, _ in results if rec["pipeline_steady_state"]]
    if any(s != steady[0] for s in steady):
        raise AssertionError("the pipelined steady state differs between workers")
    n_ok = sum(e["certified"] for e in entries)
    phase("dissem-certify", f"{n_ok} of {len(entries)} entries certified ({sum(e['engine'] == 'dense' for e in entries)} "
                            f"dense, {sum(e['engine'] == 'pview' for e in entries)} pview), pipelined steady state "
                            f"{steady[0]['certified']} (overhead {steady[0]['pipelining_overhead_ticks']} ticks); "
                            f"run in the shared worker pool, delivery_combine launches {launches} (the pview entries)")
    if n_ok != len(entries) or not steady[0]["certified"]:
        bad = [(e["engine"], e["strategy"], e["topology"], e["spread_ticks"], e["bound_ticks"])
               for e in entries if not e["certified"]]
        raise AssertionError(f"certification failed: {bad}, steady state {steady[0]}")
    control = {"default": config12_control(device)}
    for spec in (dict(STRUCTURED_SPEC), dict(strategy="push_pull", topology="full")):
        control[f"{spec['strategy']}/{spec['topology']}"] = config12_control(device, spec=spec)
    phase("dissem-certify", "config12 control, dense N=4096, 8 rumor slots, one 80-tick sweep window: "
                            + ", ".join(f"{k} {v:.2f} ms/tick" for k, v in control.items()))
    return {"launches": launches, "control": control}


def run_dissem_main(device, unarmed: dict) -> dict:
    """One armed spec on each engine at the full width of its main path:
    pview at 1M under push_pull/expander (phase 5's scenario), sparse at
    49,152 under pipelined/expander (config5's churn), dense at 10,000 under
    push_pull/full (config4's partition, its detection and recovery against
    config4's budgets), each beside the engine's unarmed ms/tick from this
    call. Returns the launches of each path."""
    from scalecube_cluster_tpu_torch.ops import pview as PV

    out = {}
    run = run_main_path(device, params=armed(config16_params(N_MAIN), strategy="push_pull", topology="expander"),
                        label="dissem-main")
    st, gen, params = run.pop("state"), run["gen"], run["params"]
    profile_phases(lambda: PV.run_pview_ticks_fused(st, gen, PROFILE_TICKS, params), PHASES, label="dissem-profile")
    del st
    torch.cuda.empty_cache()
    if run["launches"] != 10:
        raise AssertionError(f"the armed pview window launched delivery_combine {run['launches']} times in 10 ticks")
    out["dissem-main-pview"] = run["launches"]
    phase("dissem-main", f"pview push_pull/expander {run['ms_tick']:.2f} ms/tick against the unarmed window's "
                         f"{unarmed['pview']:.2f} ({run['ms_tick'] / unarmed['pview'] - 1:+.1%}), peak "
                         f"{run['peak'] / 2 ** 30:.2f} GiB, {run['flags']:.1f} flag reads/tick")
    run = run_sparse_main_path(device, params=armed(config5_params(N_SPARSE), strategy="pipelined",
                                                    topology="expander"), label="dissem-main")
    run.pop("state")
    torch.cuda.empty_cache()
    out["dissem-main-sparse"] = run["launches"]
    phase("dissem-main", f"sparse pipelined/expander {run['ms_tick']:.2f} ms/tick against the unarmed churn run's "
                         f"{unarmed['sparse']:.2f} ({run['ms_tick'] / unarmed['sparse'] - 1:+.1%}), realtime factor "
                         f"{1000 / (TICKS_PER_SECOND * run['ms_tick']):.3f}, peak {run['peak'] / 2 ** 30:.2f} GiB")
    run = run_dense_main(device, n=N_DENSE, params=armed(config4_params(N_DENSE), strategy="push_pull", topology="full"),
                         label="dissem-main", profile_label="dissem-profile-dense")
    torch.cuda.empty_cache()
    out["dissem-main-dense"] = run["launches"]
    phase("dissem-main", f"dense push_pull/full partitioned {run['ms_part']:.2f} / healed {run['ms_heal']:.2f} ms/tick "
                         f"against the unarmed {unarmed['dense_part']:.2f} / {unarmed['dense_heal']:.2f} "
                         f"({run['ms_part'] / unarmed['dense_part'] - 1:+.1%} / "
                         f"{run['ms_heal'] / unarmed['dense_heal'] - 1:+.1%}), peak {run['peak'] / 2 ** 30:.2f} GiB; "
                         f"detected {run['detected']} (budget {run['budgets'][0]}, unarmed {unarmed['dense_ticks'][0]}), "
                         f"bulk / full recovery {run['bulk']} / {run['full']} (budget {run['budgets'][1]}, unarmed "
                         f"{unarmed['dense_ticks'][1]} / {unarmed['dense_ticks'][2]})")
    return out


# -- the adaptive plane and the chaos plane (phases 25-30) -----------------------------


C13_N, C13_SEEDS, C13_FLOORS = 48, (0, 1, 2), (0.0, 0.1, 0.2)
C13_STATIC_MULT = 3  # benchmarks/config13_adaptive.py: STATIC_SUSPICION_MULT


def check_adaptive_windows(device) -> dict:
    """Adaptive windows (config13's knobs) on the CPU and on the card from the
    same draws: pview at 4,096 in phase 4's scenario under a 10% uniform
    loss floor, sparse at 4,096 with dense links and 32 rows taking 70%
    inbound loss (phase 10's script), dense at 2,048 with the rings at D =
    4, a slow group of links and a flaky observer (phase 16's). State,
    adaptive planes and metrics equal; every gauge moved. Returns the
    card's launches per window."""
    launches = {}
    ms, launches["adaptive-pview-window"] = count_launches(lambda: check_cross_device(
        device, params=with_adaptive(config16_params(4096)), label="adaptive-windows", floor=0.1))
    phase("adaptive-windows", f"pview gauges: {gauges_line(ms)}")
    ms, launches["adaptive-sparse-window"] = count_launches(lambda: check_sparse_window(
        device, params=with_adaptive(config5_params(4096, fd_every=2, suspicion_mult=1, sync_every=20)),
        label="adaptive-windows", cohort=range(100, 132)))
    phase("adaptive-windows", f"sparse gauges: {gauges_line(ms)}")
    ms = check_dense_delay_window(device, params=with_adaptive(config4_params(2048, **{**CONFIG3_KNOBS,
                                                                                       "delay_slots": 4})),
                                  label="adaptive-windows", flaky=9)
    phase("adaptive-windows", f"dense gauges: {gauges_line(ms)}")
    return launches


def beside(ms: float, ref: float) -> str:
    """``ms`` beside the unarmed ms/tick of this call."""
    return f"{ms:.2f} ms/tick against the unarmed {ref:.2f} ({ms / ref - 1:+.1%})"


def run_adaptive_main(device, unarmed: dict) -> dict:
    """Each engine's main path at its full width armed with config13's
    adaptive knobs (min_mult 5, max_mult 10, conf_target 4, lh_max 8):
    pview at 1M (phase 5's scenario), sparse at 49,152 (config5's churn),
    dense at 10,000 (config4's partition, no profiles), beside the unarmed
    runs of this call. Fails where a gauge stays 0. Returns the launches
    of each path."""
    out = {}
    run = run_main_path(device, params=with_adaptive(config16_params(N_MAIN)), label="adaptive-main")
    run.pop("state")
    torch.cuda.empty_cache()
    if run["launches"] != 10:
        raise AssertionError(f"the adaptive pview window launched delivery_combine {run['launches']} times in 10 ticks")
    out["adaptive-main-pview"] = run["launches"]
    phase("adaptive-main", f"pview 1M {beside(run['ms_tick'], unarmed['pview'])}, peak "
                           f"{run['peak'] / 2 ** 30:.2f} GiB, {run['flags']:.1f} flag reads/tick (unarmed "
                           f"{unarmed['pview_flags']:.1f}), launches {run['launches']}; "
                           f"{gauges_line(run['ms'])}")
    run = run_sparse_main_path(device, params=with_adaptive(config5_params(N_SPARSE)), label="adaptive-main")
    run.pop("state")
    torch.cuda.empty_cache()
    out["adaptive-main-sparse"] = run["launches"]
    phase("adaptive-main", f"sparse 49,152 {beside(run['ms_tick'], unarmed['sparse'])}, realtime factor "
                           f"{1000 / (TICKS_PER_SECOND * run['ms_tick']):.3f}, peak {run['peak'] / 2 ** 30:.2f} GiB, "
                           f"{run['flags']:.1f} flag reads/tick (unarmed {unarmed['sparse_flags']:.1f}), "
                           f"launches {run['launches']}; {gauges_line(run['ms'])}")
    run = run_dense_main(device, n=N_DENSE, params=with_adaptive(config4_params(N_DENSE)), label="adaptive-main",
                         profile=False)
    torch.cuda.empty_cache()
    out["adaptive-main-dense"] = run["launches"]
    ticks = unarmed["dense_ticks"]
    phase("adaptive-main", f"dense 10,000 partitioned {beside(run['ms_part'], unarmed['dense_part'])}, healed "
                           f"{beside(run['ms_heal'], unarmed['dense_heal'])}, peak {run['peak'] / 2 ** 30:.2f} GiB, "
                           f"{run['flags']:.2f} flag reads/tick; detected {run['detected']} (unarmed {ticks[0]}), bulk / "
                           f"full recovery {run['bulk']} / {run['full']} (unarmed {ticks[1]} / {ticks[2]}); "
                           f"{gauges_line(run['ms'])}")
    return out


def scenario_cpu_and_card(device, params, n: int, build, label: str, dense_links=None, setup=None) -> dict:
    """``run_scenario(build())`` on a ``SimDriver`` on the CPU and on the card
    from the same draws (``setup(driver)`` first): equal reports but the
    backend stamp, equal state and adaptive planes. Returns the CPU
    report."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    horizon = build().horizon
    draws = cpu_draws(params, horizon, seed=29)
    reports, drivers = [], []
    for dev in ("cpu", device):
        d = SimDriver(params, n, seed=0, device=dev, draws=DrawList(draws), dense_links=dense_links)
        if setup:
            setup(d)
        rep = d.run_scenario(build())
        reports.append({k: v for k, v in rep.items() if k != "backend"})
        drivers.append(d)
    a, b = drivers
    bad = state_differences(a.state, b.state)
    if reports[0] != reports[1]:
        bad.append("report")
    if a.adaptive_state is not None:
        bad += [f"adaptive plane {k}" for k in ("lh", "conf_key", "conf")
                if not torch.equal(getattr(a.adaptive_state, k), getattr(b.adaptive_state, k).cpu())]
    if bad:
        raise AssertionError(f"{label}: CPU and card scenario runs differ in: {bad}")
    rep = reports[0]
    if not rep["ok"]:
        raise AssertionError(f"{label}: the scenario report is not ok: {rep}")
    s = rep["sentinels"]
    phase("chaos-windows", f"{label}, N={n}, {rep['ticks_run']} ticks, events {events_text(rep)}: "
                           f"report, state{' and adaptive planes' if a.adaptive_state is not None else ''} equal on "
                           f"CPU and {device}; violations {rep['violations']}, detections "
                           f"{[d['detected_at'] for d in s['detections']]}, convergence "
                           f"{[c['converged_at'] for c in s['convergence']]}")
    return rep


def check_chaos_windows(device) -> dict:
    """``run_scenario`` on the CPU and on the card from the same draws at
    4,096: pview (a crash and a group partition healed), dense at config9's
    i16 widths (a crash, a partition healed), sparse with dense links (a
    crash wave, a partition healed, two restarts); and dense at 2,048 with
    a loss storm over a partition healed inside it. Returns the card's
    launches."""
    from scalecube_cluster_tpu_torch.chaos import events as EV

    n = 4096
    halves = [range(0, n // 2), range(n // 2, n)]
    launches = {}
    _, launches["chaos-pview-window"] = count_launches(lambda: scenario_cpu_and_card(
        device, config16_params(n), n, lambda: EV.Scenario(name="pview-split", events=[
            EV.Crash(rows=list(range(n // 2, n // 2 + 4)), at=2),
            EV.Partition(groups=halves, at=5, heal_at=25)], horizon=CHAOS_WINDOW_HORIZON, check_interval=8), "pview",
        setup=lambda d: [d.spread_rumor((s * 997) % n, s) for s in range(d.params.rumor_slots)]))
    scenario_cpu_and_card(
        device, config9_dense_params(n), n, lambda: EV.Scenario(name="dense-split", events=[
            EV.Crash(rows=[40, 41], at=2), EV.Partition(groups=halves, at=5, heal_at=12)],
            horizon=20, check_interval=8), "dense", dense_links=True)
    crashed = list(range(n // 2, n // 2 + 16))
    _, launches["chaos-sparse-window"] = count_launches(lambda: scenario_cpu_and_card(
        device, config5_params(n, fd_every=2, suspicion_mult=1, sync_every=20), n, lambda: EV.Scenario(
            name="sparse-split", events=[
                EV.Crash(rows=crashed, at=2), EV.Partition(groups=halves, at=5, heal_at=20),
                EV.Restart(rows=crashed[:2], at=30, seed_rows=(0, 1))], horizon=CHAOS_WINDOW_HORIZON, check_interval=8),
        "sparse, dense links", dense_links=True))
    scenario_cpu_and_card(
        device, config4_params(n // 2, fd_every=2, sync_every=20), n // 2, lambda: EV.Scenario(name="dense-storm", events=[
            EV.LossStorm(pct=30.0, at=3, until=20), EV.Crash(rows=[50], at=4),
            EV.Partition(groups=[range(0, 100), range(100, 200)], at=8, heal_at=15)], horizon=CHAOS_WINDOW_HORIZON,
            check_interval=8), "dense, loss storm", dense_links=True)
    return launches


def events_text(rep) -> list:
    """The report's applied events, each label cut to 40 characters (a
    crash wave's label lists every row)."""
    return [e["event"] if len(e["event"]) <= 40 else e["event"][:37] + "..." for e in rep["events_applied"]]


def run_armed(d, scenario, label: str) -> tuple:
    """Arm ``scenario`` on ``d`` and run it: the report must be ok with no
    violation, and the only readback between arming and the report is the
    report's own. Returns (report, ms/tick, launches, the ticks' flag reads
    per tick, the flag reads of the mutations between windows — a
    restart's pool allocation reads its own)."""
    from scalecube_cluster_tpu_torch.chaos.engine import DriverChaosRunner
    from scalecube_cluster_tpu_torch.ops import _tensor

    in_steps = [0]
    step = d.step

    def counted_step(n_ticks):
        before = _tensor.HOST_SYNCS.count
        out = step(n_ticks)
        in_steps[0] += _tensor.HOST_SYNCS.count - before
        return out

    def go():
        runner = DriverChaosRunner(d, scenario)
        base = d.dispatch_stats["readbacks"]
        flags = _tensor.HOST_SYNCS.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if d.dispatch_stats["readbacks"] != base + 1:
            raise AssertionError(f"{label}: {d.dispatch_stats['readbacks'] - base - 1} readbacks while the scenario "
                                 "stepped")
        return rep, wall, _tensor.HOST_SYNCS.count - flags

    d.step = counted_step
    try:
        (rep, wall, flags), launches = count_launches(go)
    finally:
        del d.step
    if not rep["ok"] or rep["violations"]:
        raise AssertionError(f"{label}: report not ok: {rep}")
    return rep, wall / rep["ticks_run"] * 1e3, launches, in_steps[0] / rep["ticks_run"], flags - in_steps[0]


#: phase 28's 1M pview scenario report (seed 0, PVIEW_SCENARIO_HORIZON ticks), for phase 46
PVIEW_SCENARIO_REPORT: dict = {}


def pview_scenario(n: int):
    """Phase 28's pview scenario at ``n``: its 1,024-row crash wave at 2 and a
    partition between two 65,536-row groups at 5, healed at 30;
    ``PVIEW_SCENARIO_HORIZON`` ticks."""
    from scalecube_cluster_tpu_torch.chaos import events as EV

    g = min(1 << 16, n // 8)  # the partition's group size
    return EV.Scenario(name="pview-wave-split", events=[
        EV.Crash(rows=list(range(n // 2, n // 2 + n // 1024)), at=2),
        EV.Partition(groups=[range(0, g), range(g, 2 * g)], at=5, heal_at=30)], horizon=PVIEW_SCENARIO_HORIZON)


def run_chaos_main(device, unarmed: dict) -> dict:
    """One scenario per engine at its main path's full width, each ``ok``
    with no violation and no readback while it steps: pview at 1M (phase
    5's widths and rumors; its 1,024-row crash wave and a partition between
    two 65,536-row groups, healed), sparse at 49,152 (config5's widths,
    scalar links: a crash of 491 rows, a 20% loss storm, their restart),
    cut to a ``PVIEW_SCENARIO_HORIZON``- and a 60-tick horizon (the
    automatic one, printed beside it, would take minutes at these widths),
    and dense at 10,000 (config4's
    1,000 / 9,000 split as a ``Partition``, healed 5 ticks after the
    unarmed run's detection, ``CHAOS_DENSE_AFTER_HEAL`` ticks past the
    heal). Returns the
    launches of each path."""
    from scalecube_cluster_tpu_torch.chaos import events as EV
    from scalecube_cluster_tpu_torch.chaos.sentinels import build_spec
    from scalecube_cluster_tpu_torch.sim import SimDriver

    out = {}
    n = N_MAIN
    d = SimDriver(config16_params(n), n, warm=True, seed=0, device=device)
    for s in range(d.params.rumor_slots):
        d.spread_rumor((s * 997) % n, f"rumor {s}")
    scn = pview_scenario(n)
    auto = build_spec(scn.replace(horizon=None), d.params).horizon
    d.step(2)
    rep, ms, launches, flags, mut_flags = run_armed(d, scn, "pview")
    if launches <= 0:
        raise AssertionError("the pview scenario launched no delivery_combine kernel")
    out["chaos-main-pview"] = launches
    PVIEW_SCENARIO_REPORT.update(report=rep, ms_tick=ms)  # phase 46 holds the sharded run against it
    phase("chaos-main", f"pview 1M, {rep['ticks_run']} ticks (horizon cut from the automatic {auto} to "
                        f"{PVIEW_SCENARIO_HORIZON}), events "
                        f"{events_text(rep)}: ok, 0 violations, no readback while stepping; "
                        f"{beside(ms, unarmed['pview'])}, {flags:.1f} flag reads/tick in the ticks (+{mut_flags} in the "
                        f"mutations), launches {launches} in "
                        f"{rep['ticks_run']} ticks")
    del d
    torch.cuda.empty_cache()

    n = N_SPARSE
    params = config5_params(n)
    churn = n // 100
    d = SimDriver(params, n, warm=True, seed=0, device=device)
    rows = list(range(1000, 1000 + churn))
    scn = EV.Scenario(name="sparse-crash-storm-restart", events=[
        EV.Crash(rows=rows, at=2), EV.LossStorm(pct=20.0, at=5, until=30),
        EV.Restart(rows=rows, at=40, seed_rows=params.seed_rows)], horizon=60)
    auto = build_spec(scn.replace(horizon=None), d.params).horizon
    d.step(2)
    rep, ms, launches, flags, mut_flags = run_armed(d, scn, "sparse")
    if launches <= 0:
        raise AssertionError("the sparse scenario launched no delivery_combine kernel")
    out["chaos-main-sparse"] = launches
    phase("chaos-main", f"sparse 49,152, {rep['ticks_run']} ticks (horizon cut from the automatic {auto} to 60), "
                        f"events {events_text(rep)}: ok, 0 violations, no readback while stepping; "
                        f"{beside(ms, unarmed['sparse'])}, {flags:.1f} flag reads/tick in the ticks (+{mut_flags} in the "
                        f"mutations), launches {launches} in "
                        f"{rep['ticks_run']} ticks (a quiet tick skips the gossip phase)")
    del d
    torch.cuda.empty_cache()

    n = N_DENSE
    heal = unarmed["dense_ticks"][0] + 5
    d = SimDriver(config4_params(n), n, warm=True, seed=0, device=device, dense_links=True)
    scn = EV.Scenario(name="config4-split", events=[
        EV.Partition(groups=[range(0, n // 10), range(n // 10, n)], at=0, heal_at=heal)],
        horizon=heal + CHAOS_DENSE_AFTER_HEAL)
    auto = build_spec(scn.replace(horizon=None), d.params).horizon
    rep, ms, launches, flags, mut_flags = run_armed(d, scn, "dense")
    out["chaos-main-dense"] = launches
    conv = rep["sentinels"]["convergence"][0]
    phase("chaos-main", f"dense 10,000, {rep['horizon']} ticks (horizon cut from the automatic {auto}), "
                        f"partition at 0, heal at {heal}: "
                        f"ok, 0 violations, no readback while stepping; converged at {conv['converged_at']} (deadline "
                        f"{conv['deadline']}); {ms:.2f} ms/tick over the whole run (unarmed partitioned "
                        f"{unarmed['dense_part']:.2f}), {flags:.2f} flag reads/tick in the ticks (+{mut_flags} in "
                        f"the mutations), launches {launches}")
    if launches:
        raise AssertionError(f"the dense scenario launched delivery_combine {launches} times")
    return out


def config13_scenario(until: int = 220, horizon: int = 260):
    """``benchmarks/config13_adaptive.py: _scenario``."""
    from scalecube_cluster_tpu_torch.chaos import events as EV

    return EV.Scenario(name="loss_adversarial_r14", events=(
        EV.AsymmetricLoss(rows=[5, 6, 7], pct=70.0, at=4, until=until, direction="in"),
        EV.FlakyObserver(rows=[9], pct=70.0, at=4, until=until),
        EV.SlowMember(rows=[11], mean_delay_ticks=2.0, at=4, until=until),
        EV.Crash(rows=[20], at=30),
    ), horizon=horizon)


def config13_entry(task) -> dict:
    """One config13 entry in a worker process (``benchmarks/config13_adaptive.py:
    run_entry``): ``task`` is (seed, loss floor, adaptive, device)."""
    from scalecube_cluster_tpu_torch.adaptive import AdaptiveSpec
    from scalecube_cluster_tpu_torch.ops.state import SimParams
    from scalecube_cluster_tpu_torch.sim import SimDriver

    seed, floor, adaptive, device = task
    spec = AdaptiveSpec(enabled=True, **C13_KNOBS) if adaptive else AdaptiveSpec()
    params = SimParams(capacity=C13_N, fd_every=1, sync_every=40, suspicion_mult=C13_STATIC_MULT, rumor_slots=8,
                       seed_rows=(0,), delay_slots=4, adaptive=spec)
    d = SimDriver(params, C13_N, warm=True, seed=seed, device=device)
    if floor > 0:
        d.state = d._ops.set_uniform_loss(d.state, floor, floor=True)
    scn = config13_scenario()
    if not adaptive:
        scn = scn.replace(fp_enforce=False)  # the control arm records, it is not judged
    t0 = time.perf_counter()
    rep = d.run_scenario(scn)
    wall = time.perf_counter() - t0
    s = rep["sentinels"]
    det = s["detections"][0]
    return {
        "arm": "adaptive" if adaptive else "static", "seed": seed, "loss_floor_pct": round(floor * 100),
        "false_positive_dead_max": s.get("false_positive_dead_max"),
        "fp_watch_members": s.get("false_positive_watch_members"), "crash_detected_at": det["detected_at"],
        "crash_deadline": det["deadline"], "crash_ok": det["ok"], "violations": rep["violations"],
        "wall_seconds": wall, "ticks": rep["ticks_run"],
    }


def run_config13(pooled: dict) -> dict:
    """config13's full sweep at its published widths (N = 48, seeds 0-2,
    loss floors 0/10/20%, both arms: 18 entries), run by
    ``run_worker_pool`` on the card, each entry beside
    ``ADAPTIVE_BENCH_r14.json``'s (the JAX package's run: protocol
    outcomes, compared by verdict — the port draws from torch's
    generator). Fails unless config13's own ``certified`` holds. Returns
    the entries and the launches the workers made."""
    entries = [e for e, _, _ in pooled["config13"]]
    launches = sum(n for _, n, _ in pooled["config13"])
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ADAPTIVE_BENCH_r14.json")
    ref = {}
    if os.path.exists(ref_path):
        with open(ref_path) as fh:
            for e in json.load(fh)["result"]["entries"]:
                ref[(e["arm"], e["seed"], e["loss_floor_pct"])] = e
    for e in entries:
        r = ref.get((e["arm"], e["seed"], e["loss_floor_pct"]))
        jax_txt = (f"JAX fp_dead {r['false_positive_dead_max']}, crash@{r['crash_detected_at']}, violations "
                   f"{r['violations']}") if r else "JAX: no entry"
        phase("config13", f"loss {e['loss_floor_pct']}% seed {e['seed']} {e['arm']}: fp_dead "
                          f"{e['false_positive_dead_max']} of {e['fp_watch_members']} watched, crash@"
                          f"{e['crash_detected_at']} <= {e['crash_deadline']}, violations {e['violations']}, "
                          f"{e['wall_seconds'] / e['ticks'] * 1e3:.2f} ms/tick | {jax_txt}")
    ad = [e for e in entries if e["arm"] == "adaptive"]
    st = [e for e in entries if e["arm"] == "static"]
    ad_fp = sum(e["false_positive_dead_max"] or 0 for e in ad)
    st_fp = sum(e["false_positive_dead_max"] or 0 for e in st)
    certified = (ad_fp == 0 and st_fp > 0 and all(e["crash_ok"] for e in ad) and all(e["violations"] == 0 for e in ad))
    phase("config13", f"{len(entries)} entries (the shared worker pool): adaptive false-DEAD "
                      f"total {ad_fp}, static {st_fp} (JAX, ADAPTIVE_BENCH_r14.json: 0 and 9); adaptive detections "
                      f"ok {all(e['crash_ok'] for e in ad)}; certified {certified}")
    if not certified:
        raise AssertionError("config13 is not certified")
    return {"entries": entries, "adaptive_fp": ad_fp, "static_fp": st_fp, "launches": launches}


def run_config7(device, n: int = 4096, windows: int = 24, reps: int = 5) -> dict:
    """config7 (``benchmarks/config7_chaos.py``): the tick-rate overhead of an
    armed-but-idle chaos runner at dense N = 4,096, ``windows`` one-tick
    windows per span, the plain driver loop against the same loop with an
    event-free scenario armed (its timeline consulted every window, the
    sentinels checked at their cadence), interleaved, median of ``reps``.
    Fails only on a readback while the armed loop steps."""
    from scalecube_cluster_tpu_torch.chaos import Scenario
    from scalecube_cluster_tpu_torch.chaos.engine import DriverChaosRunner
    from scalecube_cluster_tpu_torch.ops.state import SimParams
    from scalecube_cluster_tpu_torch.sim import SimDriver

    params = SimParams(capacity=n, fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5, sync_every=150,
                       suspicion_mult=5, rumor_slots=8, seed_rows=(0,), full_metrics=False)
    pipe = SimDriver(params, n, warm=True, seed=0, device=device)
    pipe.step(1)
    pipe.sync()
    arm = SimDriver(params, n, warm=True, seed=0, device=device)
    runner = DriverChaosRunner(arm, Scenario(name="armed-idle", events=[], horizon=1 << 30))
    check_every = runner.spec.check_interval
    clock = {"t": 1}
    arm.step(1)
    runner._run_check()
    arm.sync()

    def span_pipe() -> float:
        t0 = time.perf_counter()
        for _ in range(windows):
            pipe.step(1)
        pipe.sync()
        return time.perf_counter() - t0

    def span_armed() -> float:
        base = arm.dispatch_stats["readbacks"]
        next_check = clock["t"] + check_every
        t0 = time.perf_counter()
        for _ in range(windows):
            arm.state, _labels = runner.timeline.apply_due(arm.state, clock["t"])
            arm.step(1)
            clock["t"] += 1
            if clock["t"] >= next_check:
                runner._run_check()
                next_check = clock["t"] + check_every
        arm.sync()
        dt = time.perf_counter() - t0
        if arm.dispatch_stats["readbacks"] != base:
            raise AssertionError("the armed-idle chaos loop read the device back")
        return dt

    pipe_s, armed_s = [], []
    for _ in range(reps):
        pipe_s.append(span_pipe())
        armed_s.append(span_armed())
    p, a = statistics.median(pipe_s), statistics.median(armed_s)
    overhead = (a / p - 1.0) * 100.0
    phase("config7", f"dense N={n}, {reps} x {windows} one-tick windows, sentinel check every {check_every} ticks: "
                     f"pipelined {windows / p:.1f} ticks/s, chaos-armed {windows / a:.1f} ticks/s, idle overhead "
                     f"{overhead:+.2f}% beside config7's 2% gate (within {overhead <= 2.0}); spans pipelined "
                     f"{[round(x, 4) for x in pipe_s]} s, armed {[round(x, 4) for x in armed_s]} s; no readback")
    return {"overhead_pct": overhead, "pipelined_ticks_s": windows / p, "armed_ticks_s": windows / a}


# -- the fleet engine (phases 31-34) ----------------------------------------------

FLEET_KERNEL_CASES = (  # (label, S, N, F, R, Wm, ym_offset, path)
    ("MC widths", 1024, 64, 3, 8, 4, 0, "vector"),
    ("MC widths, scalar path", 1024, 64, 3, 8, 5, 0, "scalar"),
    ("full width (pview 4,096)", 256, 4096, 3, 8, 64, 0, "vector"),
    ("S past 65,535", 65_600, 64, 3, 8, 4, 0, "vector"),
)
C14_CELLS = ((256, 64), (64, 256))  # config14's THROUGHPUT_CELLS; the first is the 3x gate
C14_WINDOW = 32  # config14's WINDOW_TICKS
C14_MC_N, C14_MC_SEEDS = 64, 1024  # config14's MC matrix as published
C14_FP_N, C14_FP_SEEDS = 48, 512  # config14's fp_rate_mc and adaptive_knob_sweep as published
C14_LADDER_GIB = 16  # config14's LADDER_BUDGET_GIB
C14_LADDER_START = {64: 8192, 256: 1024}  # config14's ladder starts
FLEET_MAIN = ((4096, 256), (256, 4096))  # dense S x N, pview S x N


def c14_params(n: int, **over):
    """config14's dense widths (``benchmarks/config14_fleet.py: _params``),
    the fleet profile (quiet gates off) unless ``over`` says otherwise."""
    from scalecube_cluster_tpu_torch.ops.state import SimParams

    return SimParams(**{**dict(capacity=n, fanout=3, repeat_mult=3, ping_req_k=2, fd_every=5, sync_every=64,
                               suspicion_mult=5, rumor_slots=8, seed_rows=(0,), full_metrics=False,
                               quiet_gates=False), **over})


def fleet_kernel_inputs(s: int, n: int, gen, F: int, R: int, Wm: int, ym_offset: int = 0):
    """Random [S, ...] sender planes and inv (-1s, duplicate senders), each
    scenario's indices inside its own N rows."""
    dev = gen.device
    Wu = -(-R // 32)

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    ym_p = words(s, n, Wm + ym_offset)[:, :, ym_offset:]
    yu_p = words(s, n, Wu)
    infected_from = torch.randint(-1, n, (s, n, R), generator=gen, device=dev, dtype=torch.int32)
    inv = torch.randint(-1, n, (s, F, n), generator=gen, device=dev, dtype=torch.int32)
    inv[:, :, : n // 4] = -1
    inv[:, :, n // 4 : n // 2] = torch.randint(0, 3, (s, F, n // 2 - n // 4), generator=gen, device=dev,
                                               dtype=torch.int32)
    origin = torch.randint(-1, n, (s, R), generator=gen, device=dev, dtype=torch.int32)
    return ym_p, yu_p, infected_from, inv, origin


def fleet_kernel_bytes(ym_p, yu_p, infected_from, inv) -> int:
    """The serial byte bound summed over scenarios: inv and the origins read
    once, a sender row per distinct valid sender of each scenario, the
    outputs and the counts written once."""
    s, F, n = inv.shape
    Wm, R = ym_p.shape[-1], infected_from.shape[-1]
    Wt = Wm + yu_p.shape[-1] + R
    scen = torch.arange(s, device=inv.device, dtype=torch.int64)[:, None, None].expand(s, F, n)
    ok = inv >= 0
    senders = torch.unique(scen[ok] * n + inv[ok].to(torch.int64)).numel()
    return s * (4 * F * n + 4 * R + n * (R + 4 * R + 4 * Wm) + 4) + 4 * Wt * senders


def check_fleet_kernel(device) -> dict:
    """Phase 31: the scenario-axis kernel bit-equal to its plain version at
    MC widths (vector and scalar path), at a full-width batch and at an S
    past 65,535; its median device time over 20 launches beside its byte
    bound, its plain version, and S serial launches of the serial kernel on
    the same inputs."""
    from scalecube_cluster_tpu_torch.ops import delivery

    gen = torch.Generator(device=device).manual_seed(31)
    rows = {}
    for label, s, n, F, R, Wm, off, want in FLEET_KERNEL_CASES:
        planes = fleet_kernel_inputs(s, n, gen, F, R, Wm, off)
        path = delivery.instantiation(Wm, F, planes[0].data_ptr(), planes[0].stride(1))[0]
        if path != want:
            raise AssertionError(f"[fleet-kernel] {label}: {path} path, expected {want}")
        before = delivery.delivery_combine_fleet.launches
        got = delivery.delivery_combine_fleet(*planes)
        ref = delivery.delivery_combine_fleet_ref(*planes)
        torch.cuda.synchronize()
        if delivery.delivery_combine_fleet.launches != before + 1:
            raise AssertionError("[fleet-kernel] one call did not make exactly one launch")
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, ref))
        if err != 0:
            raise AssertionError(f"[fleet-kernel] {label}: differs from its plain version, max abs err {err}")
        ms = kernel_ms(lambda: delivery.delivery_combine_fleet(*planes), "delivery_combine_kernel")
        plain_ms = time_cuda(lambda: delivery.delivery_combine_fleet_ref(*planes), reps=5, warmup=1)
        bound = bytes_ms(fleet_kernel_bytes(*planes[:4]))
        per_s = [tuple(t[i] for t in planes) for i in range(s)]

        def serial_loop():
            for args in per_s:
                delivery.delivery_combine(*args)

        reps, warm = (3, 1) if s <= 4096 else (1, 0)
        serial_ms = time_cuda(serial_loop, reps=reps, warmup=warm)
        delivery.delivery_combine.launches -= (reps + warm) * s
        delivery.delivery_combine_fleet.launches = before
        rows[label] = dict(s=s, n=n, F=F, R=R, Wm=Wm, path=path, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, serial_launches_ms=serial_ms)
        phase("fleet-kernel", f"{label}: S={s} N={n} F={F} R={R} Wm={Wm}, {path} path: bit-equal, kernel "
                              f"{ms:.4f} ms (one launch), bound {bound:.4f} ms (roofline share "
                              f"{bound / ms:.3f}), plain {plain_ms:.4f} ms, {s} serial launches {serial_ms:.4f} "
                              f"ms ({serial_ms / ms:.1f}x the one launch)")
        del planes, per_s, got, ref
        torch.cuda.empty_cache()
    return rows


def fleet_start(mod, init, s: int, n: int, crash: bool = True):
    """A fleet of ``s`` scenarios from ``init()``: scenario i spreads rumor 0
    from its own row, and every third scenario has a crash of its own (so
    the quiet-tick gates open in some scenarios only)."""
    from scalecube_cluster_tpu_torch.ops import fleet as FL

    rows = []
    for i in range(s):
        st = mod.spread_rumor(init(), 0, (i * 37 + 1) % n)
        if crash and i % 3 == 1:
            st = mod.crash_rows(st, [(i * 13 + 5) % n, (i * 7 + 9) % n])
        rows.append(st)
    return FL.fleet_stack(rows)


def fleet_cpu_draws(params, draw, s: int, ticks: int, tick0: int, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    out, tick = [], tick0
    for _ in range(ticks):
        out.append(draw(gen, params, (tick + 1) % params.fd_every == 0, lead=(s,)))
        tick += 1
    return out


def row_draws(draws, i: int) -> list:
    import dataclasses as dc

    def row(x):
        return None if x is None else type(x)(*(getattr(x, f.name)[i] for f in dc.fields(x)))

    return [(row(fd), row(rd)) for fd, rd in draws]


def check_fleet_window(device, label: str, mod, init, make_fleet, make_serial, params, draw, s: int = 8,
                       ticks: int = FLEET_WINDOW_TICKS, adaptive: bool = False, tag: str = "fleet-windows") -> dict:
    """One fleet window on the CPU and on the card from the same draws (every
    leaf, every metric), then each row on the card against the serial
    window fed that row's draws. Returns the card's launch counts."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.adaptive import init_adaptive_state
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import fleet as FL

    n = params.capacity

    def start(dev):
        return fleet_start(mod, lambda: init(dev), s, n)

    draws = fleet_cpu_draws(params, draw, s, ticks, start("cpu").tick, 14)

    def run(dev):
        fs = start(dev)
        dd = [(None if fd is None else fd.to(dev), rd.to(dev)) for fd, rd in draws]
        if adaptive:
            ad = FL.fleet_broadcast(init_adaptive_state(n, device=dev), s)
            fs, ad, ms, _ = make_fleet(params, ticks)(fs, ad, dd)
            ms = {**ms, **{f"adaptive plane {k}": getattr(ad, k) for k in ("lh", "conf_key", "conf")}}
        else:
            fs, ms, _ = make_fleet(params, ticks)(fs, dd)
        return fs, {k: v.cpu() for k, v in ms.items()}

    delivery.delivery_combine_fleet.launches = 0
    cpu_fs, cpu_ms = run("cpu")
    dev_fs, dev_ms = run(device)
    fleet_launches = delivery.delivery_combine_fleet.launches
    bad = state_differences(cpu_fs, dev_fs)
    for k, va in cpu_ms.items():
        va, vb = va.numpy(), dev_ms[k].numpy()
        if va.dtype == np.float32:
            if np.abs(va.view(np.int32).astype(np.int64) - vb.view(np.int32).astype(np.int64)).max() > 2:
                bad.append(f"metric {k}")
        elif not np.array_equal(va, vb):
            bad.append(f"metric {k}")
    if bad:
        raise AssertionError(f"[{tag}] {label}: CPU and card fleets differ in {bad}")
    serial_launches = delivery.delivery_combine.launches
    for i in range(s):
        st = FL.fleet_row(start(device), i)
        dd = [(None if fd is None else fd.to(device), rd.to(device)) for fd, rd in row_draws(draws, i)]
        if adaptive:
            st, ad, ms, _ = make_serial(params, ticks)(st, init_adaptive_state(n, device=device), dd)
            ms = {**ms, **{f"adaptive plane {k}": getattr(ad, k) for k in ("lh", "conf_key", "conf")}}
        else:
            st, ms, _ = make_serial(params, ticks)(st, dd)
        row = FL.fleet_row(dev_fs, i)
        diff = state_differences(row, st) + [k for k, v in ms.items() if not torch.equal(v.cpu(), dev_ms[k][i])]
        if diff:
            raise AssertionError(f"[{tag}] {label}: card fleet row {i} differs from the serial window "
                                 f"in {diff}")
    serial_launches = delivery.delivery_combine.launches - serial_launches
    delivery.delivery_combine.launches -= serial_launches
    phase(tag, f"{label}: S={s} N={n}, {ticks} ticks: CPU = card (every leaf, every metric"
                           f"{', the adaptive planes' if adaptive else ''}); every card row = the serial window "
                           f"fed its draws; fleet kernel launches on the card {fleet_launches} in {ticks} ticks "
                           f"(the {s} serial rows: {serial_launches})")
    return {"launches": fleet_launches, "ms": {k: v for k, v in dev_ms.items()}}


def check_fleet_windows(device) -> dict:
    """Phase 32: a fleet window per engine (S = 8, 12 ticks; dense N = 256
    i32 and i16, sparse N = 1,024, pview N = 4,096) and the adaptive dense
    fleet (config13's knobs, rings at D = 4, a degraded cohort), CPU = card
    and each card row = the serial window. Returns launches per window."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import rand as PR
    from scalecube_cluster_tpu_torch.ops import sparse as SP
    from scalecube_cluster_tpu_torch.ops import state as S

    out = {}
    for kd in ("i32", "i16"):
        p = c14_params(256, key_dtype=kd, quiet_gates=True)
        out[f"fleet-dense-{kd}"] = check_fleet_window(
            device, f"dense {kd}", S, lambda d, p=p: S.init_state(p, 256, warm=True, uniform_loss=0.1, device=d),
            K.make_fleet_run, K.make_run, p, PR.draw_dense_tick)["launches"]
    sp = config5_params(1024, fd_every=2, suspicion_mult=1, sync_every=20)
    out["fleet-sparse"] = check_fleet_window(
        device, "sparse", SP, lambda d: SP.init_sparse_state(sp, 1024, warm=True, device=d),
        SP.make_sparse_fleet_run, SP.make_sparse_run, sp, PR.draw_sparse_tick)["launches"]
    pp = config16_params(4096)
    out["fleet-pview"] = check_fleet_window(
        device, "pview", PV, lambda d: PV.init_pview_state(pp, 4096, warm=True, device=d),
        PV.make_pview_fleet_run, PV.make_pview_run, pp, PR.draw_sparse_tick, ticks=FLEET_PVIEW_TICKS)["launches"]
    ap = with_adaptive(c14_params(256, fd_every=1, delay_slots=4, quiet_gates=True))

    def adaptive_init(d):
        st = S.init_state(ap, 256, warm=True, uniform_loss=0.05, uniform_delay=0.5, device=d)
        everyone = list(range(256))
        st = S.set_link_loss(st, everyone, [5, 6, 7], 0.7)
        st = S.set_link_loss(st, [9], everyone, 0.7)
        return S.set_link_delay(st, everyone, [11], 2.0)

    rec = check_fleet_window(device, "dense adaptive (config13's knobs, D = 4)", S, adaptive_init,
                             K.make_fleet_adaptive_run, K.make_adaptive_run, ap, PR.draw_dense_tick, adaptive=True)
    phase("fleet-windows", f"adaptive fleet gauges: {gauges_line(rec['ms'])}")
    out["fleet-dense-adaptive"] = rec["launches"]
    return out


def c14_throughput_cell(device, s: int, n: int, reps: int = 5, window: int = C14_WINDOW) -> dict:
    """config14's batched-vs-serial cell: the fleet of ``s`` clusters against
    a loop of serial windows over a fixed sample of ``C14_SERIAL_SAMPLE`` of
    them (the same params, the same tick), interleaved median of ``reps``,
    aggregate member-ticks/s; a fresh rumor into every cluster before each
    rep; readbacks in each timed span counted under sync-debug."""
    from scalecube_cluster_tpu_torch.ops import _tensor
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import state as S

    params = c14_params(n)
    fleet_step, serial_step = K.make_fleet_run(params, window), K.make_run(params, window)
    origins = np.arange(s) * 37 % n
    st0 = S.init_state(params, n, warm=True, device=device)
    fs = FL.fleet_inject_rumor(S, FL.fleet_broadcast(st0, s), 0, origins)
    k = min(s, C14_SERIAL_SAMPLE)
    serial = [FL.fleet_row(fs, i) for i in range(k)]
    fgen = FL.fleet_generator(0, device)
    sgens = [torch.Generator(device=device).manual_seed(i) for i in range(k)]
    fs, _ms, _ = fleet_step(fs, fgen)
    serial[0], _m, _ = serial_step(serial[0], sgens[0])
    torch.cuda.synchronize()

    def timed(fn):
        _tensor.HOST_SYNCS.count = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        # the mode's own notice on first use is not a wait
        waits = [w for w in caught if "called a synchronizing" in str(w.message)]
        for w in waits:
            where.add(f"{w.filename}:{w.lineno}: {str(w.message)[:120]}")
        return dt, len(waits) + _tensor.HOST_SYNCS.count

    bt, st_, waits, where = [], [], {"batched": 0, "serial": 0}, set()
    for rep in range(reps):
        slot = (rep + 1) % params.rumor_slots
        fs = FL.fleet_inject_rumor(S, fs, slot, (origins + rep) % n)
        serial = [S.spread_rumor(x, slot, int((origins[i] + rep) % n)) for i, x in enumerate(serial)]
        torch.cuda.synchronize()
        box = {}

        def batched():
            box["fs"] = fleet_step(fs, fgen)[0]

        def loop():
            for i in range(k):
                serial[i] = serial_step(serial[i], sgens[i])[0]

        dt, w = timed(batched)
        fs = box["fs"]
        bt.append(dt)
        waits["batched"] += w
        dt, w = timed(loop)
        st_.append(dt)
        waits["serial"] += w
    b, sr = statistics.median(bt), statistics.median(st_)
    b_rate, s_rate = s * n * window / b, k * n * window / sr
    rec = dict(s=s, n=n, serial_sample=k, window=window, batched_s=bt, serial_s=st_, batched_rate=b_rate,
               serial_rate=s_rate, speedup=b_rate / s_rate, readbacks=waits)
    for w in sorted(where):
        phase("config14", f"S={s} N={n}: a wait for the device in a timed span: {w}")
    phase("config14", f"S={s} N={n}, {window}-tick windows, median of {reps} interleaved: batched {b * 1e3:.1f} "
                      f"ms/window, {b_rate:,.0f} member-ticks/s; serial (a loop over {k} of the {s} clusters) "
                      f"{sr * 1e3:.1f} ms, {s_rate:,.0f} member-ticks/s; speedup {b_rate / s_rate:.2f}x; readbacks "
                      f"in the timed spans {waits}; spans batched {[round(x, 4) for x in bt]} s, serial "
                      f"{[round(x, 4) for x in st_]} s")
    return rec


def c14_ladder(device, n: int, start_s: int, ticks: int = 8, budget_gib: float = C14_LADDER_GIB) -> dict:
    """config14's one-window ladder, measured: double S from ``start_s`` at
    N = ``n`` until an 8-tick fleet window's peak allocation passes the
    budget; the largest S under it."""
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import state as S

    params = c14_params(n)
    st0 = S.init_state(params, n, warm=True, device=device)
    fit, steps, s = None, [], start_s
    while True:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fs = FL.fleet_inject_rumor(S, FL.fleet_broadcast(st0, s), 0, np.arange(s) * 37 % n)
        t0 = time.perf_counter()
        fs, _ms, _ = K.make_fleet_run(params, ticks)(fs, FL.fleet_generator(s, device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps.append((s, peak, wall))
        phase("config14", f"ladder N={n} S={s}: peak {peak:.2f} GiB, {ticks}-tick window {wall:.2f} s")
        del fs
        if peak > budget_gib:
            break
        fit, s = s, 2 * s
    torch.cuda.empty_cache()
    return {"n": n, "max_s": fit, "steps": steps}


def c14_mc_cell(task) -> tuple:
    """One cell of config14's Monte Carlo matrix in a worker process:
    ``task`` is (strategy, topology, engine, device); ``certify_spread_mc``
    at n = 64, 1,024 seeds. Returns (record, wall seconds)."""
    from scalecube_cluster_tpu_torch.dissemination import certify as C
    from scalecube_cluster_tpu_torch.dissemination.spec import DissemSpec

    strat, topol, engine, device = task
    t0 = time.perf_counter()
    rec = C.certify_spread_mc(DissemSpec(strategy=strat, topology=topol, pipeline_budget=2), n=C14_MC_N,
                              n_seeds=C14_MC_SEEDS, engine=engine, device=device)
    return rec, time.perf_counter() - t0


def c14_fp_arm(task) -> tuple:
    """One arm of config14's ``fp_rate_mc`` in a worker process: ``task`` is
    (arm, device); N = 48, 512 seeds, a 10% loss floor. Returns (record,
    wall seconds)."""
    from scalecube_cluster_tpu_torch.dissemination import certify as C

    arm, device = task
    t0 = time.perf_counter()
    rec = C.fp_rate_mc(n=C14_FP_N, n_seeds=C14_FP_SEEDS, loss_floor=0.10, adaptive=arm == "adaptive", device=device)
    return rec, time.perf_counter() - t0


def c14_sweep(task) -> tuple:
    """config14's ``adaptive_knob_sweep`` in a worker process: ``task`` is
    (seeds per floor, device). Returns (record, its log lines, wall
    seconds)."""
    from scalecube_cluster_tpu_torch.dissemination import certify as C

    seeds, device = task
    lines = []
    t0 = time.perf_counter()
    sweep = C.adaptive_knob_sweep(n=C14_FP_N, n_seeds_per_floor=seeds, device=device, log=lines.append)
    return sweep, lines, time.perf_counter() - t0


def run_config14(device, pooled: dict, ladder_start=C14_LADDER_START,
                 throughput_reps: int = C14_THROUGHPUT_REPS, cells=C14_CELLS,
                 ladder_gib: float = C14_LADDER_GIB) -> dict:
    """Phase 33: config14 (``benchmarks/config14_fleet.py``) at its published
    widths: the batched-vs-serial cells (timed here), then from
    ``run_worker_pool`` ``mc_spread_certifier``'s cells over
    ``DEFAULT_MC_MATRIX`` (n = 64, 1,024 seeds, every cell certified; the
    pview and sparse cells launch the kernel at most once per tick),
    ``fp_rate_mc`` both arms (config14's rule) and ``adaptive_knob_sweep``;
    and the one-window ladder (here: it reads this process's peak)."""
    from scalecube_cluster_tpu_torch.dissemination import certify as C

    mc_seeds, fp_seeds, sweep_seeds = C14_MC_SEEDS, C14_FP_SEEDS, C14_SWEEP_SEEDS
    out = {"throughput": [c14_throughput_cell(device, s, n, reps=throughput_reps) for s, n in cells]}
    failures = []  # each check is judged when the whole phase has run and printed
    gate = out["throughput"][0]
    if gate["speedup"] < 3.0 or gate["readbacks"]["batched"] or gate["readbacks"]["serial"]:
        failures.append(f"S={gate['s']} N={gate['n']}: speedup {gate['speedup']:.2f}x (gate 3x), readbacks "
                        f"{gate['readbacks']}")

    entries, launches = [], {}
    for (strat, topol, engine), ((rec, wall), _serial, lc) in zip(C.DEFAULT_MC_MATRIX, pooled["c14-mc"]):
        ticks = rec["windows_dispatched"] * rec["window_ticks"]
        if engine != "dense":
            launches[f"mc-{engine}-{strat}-{topol}"] = lc
            if not 0 < lc <= ticks:
                failures.append(f"MC {engine}/{strat}/{topol}: {lc} fleet kernel launches in {ticks} fleet ticks")
        elif lc:
            failures.append(f"MC dense cell launched the kernel {lc} times")
        phase("config14", f"MC {engine}/{strat}/{topol}: {rec['finished']}/{mc_seeds} finished, median "
                          f"{rec['spread_ticks_median']} p99 {rec['spread_ticks_p99']} (CI {rec['p99_ci']}) <= bound "
                          f"{rec['bound_ticks']}; wilson {rec['wilson']}; {rec['windows_dispatched']} windows, "
                          f"fleet kernel launches {lc} in {ticks} ticks; {wall:.1f} s in the worker pool; "
                          f"{'certified' if rec['certified'] else 'NOT CERTIFIED'}")
        entries.append(rec)
    n_ok = sum(e["certified"] for e in entries)
    phase("config14", f"MC matrix: {n_ok}/{len(entries)} cells certified, {mc_seeds} seeds each "
                      f"(JAX, FLEET_BENCH_r15.json: 8 of 8 at 1,024 seeds)")
    if n_ok != len(entries):
        failures.append("a Monte Carlo cell is not certified")
    out["mc"], out["launches"] = entries, launches

    fp = {arm: rec for arm, ((rec, _wall), _s, _f) in zip(("static", "adaptive"), pooled["c14-fp"])}
    st, ad = fp["static"], fp["adaptive"]
    fp_ok = (ad["fp_rate_wilson"][1] <= 0.02 and ad["fp_rate_wilson"][1] < st["fp_rate_wilson"][0]
             and ad["detections_ok"])
    for arm, rec in fp.items():
        phase("config14", f"fp_rate_mc {arm}: false-DEAD {rec['false_dead_scenarios']}/{fp_seeds}, wilson "
                          f"{rec['fp_rate_wilson']}, crash detected {rec['crash_detected']}/{fp_seeds}, max "
                          f"{rec['crash_detect_max']} <= deadline {rec['crash_detect_deadline']}, detections_ok "
                          f"{rec['detections_ok']}")
    fp_wall = max(wall for (_rec, wall), _s, _f in pooled["c14-fp"])
    phase("config14", f"fp_rate_mc: adaptive upper bound {ad['fp_rate_wilson'][1]} <= 0.02 and below the static "
                      f"lower bound {st['fp_rate_wilson'][0]}, detections ok: certified {fp_ok} (JAX, "
                      f"FLEET_BENCH_r15.json: 409/512 static, 1/512 adaptive, upper bound 0.011); "
                      f"{fp_wall:.1f} s in the worker pool")
    if not fp_ok:
        failures.append("fp_rate_mc does not meet config14's rule")
    out["fp"] = fp

    (sweep, lines, sweep_wall), _s, _f = pooled["c14-sweep"][0]
    for line in lines:
        phase("config14", line)
    phase("config14", f"adaptive_knob_sweep ({sweep_seeds} seeds per floor): recommended "
                      f"{ {k: (v and {x: v[x] for x in ('min_mult', 'conf_target', 'fp_rate')}) for k, v in sweep['recommended'].items()} }; "
                      f"{sweep_wall:.1f} s in the worker pool")
    out["sweep"] = sweep["recommended"]

    out["ladder"] = {}
    for n, s0 in ladder_start.items():
        rec = c14_ladder(device, n, s0, budget_gib=ladder_gib)
        out["ladder"][n] = rec
        phase("config14", f"ladder N={n}: largest S under {ladder_gib} GiB {rec['max_s']} "
                          f"({(rec['max_s'] or 0) * n:,} members in one window; JAX's compiled ladder: "
                          f"{ {64: 65536, 256: 4096}.get(n) })")
    if failures:
        raise AssertionError("[config14] " + "; ".join(failures))
    return out


def run_fleet_main(device, ticks: int = 16, cells=FLEET_MAIN) -> dict:
    """Phase 34: the fleet's full-width path, one warm-up window and one
    timed ``ticks``-tick window each: the dense fleet at config14's N = 256
    (S = 4,096: 1,048,576 member rows) and the pview fleet at config11's
    widths (S = 256 x N = 4,096): ms/window, member-ticks/s, peak, flag
    reads per fleet tick, kernel launches (one per pview gossip tick)."""
    from scalecube_cluster_tpu_torch.ops import _tensor
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import state as S

    out = {}
    (sd, nd), (sp, npv) = cells
    for label, s, n, make_state, step in (
        ("dense", sd, nd, lambda p: S.init_state(p, nd, warm=True, device=device), K.make_fleet_run),
        ("pview", sp, npv, lambda p: PV.init_pview_state(p, npv, warm=True, device=device),
         PV.make_pview_fleet_run),
    ):
        params = c14_params(n) if label == "dense" else config16_params(n)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fs = FL.fleet_broadcast(make_state(params), s)
        for slot in range(params.rumor_slots):
            fs = FL.fleet_inject_rumor(S if label == "dense" else PV, fs, slot, (np.arange(s) * 37 + slot * 997) % n)
        fs = FL.FleetOps(S if label == "dense" else PV).crash_rows(fs, list(range(n // 2, n // 2 + max(2, n // 128))))
        run = step(params, ticks)
        gen = FL.fleet_generator(34, device)
        fs, _ms, _ = run(fs, gen)
        torch.cuda.synchronize()
        delivery.delivery_combine_fleet.launches = 0
        _tensor.HOST_SYNCS.count = 0
        t0 = time.perf_counter()
        fs, ms, _ = run(fs, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = delivery.delivery_combine_fleet.launches
        flags = _tensor.HOST_SYNCS.count
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_up = ms["n_up"]
        if not bool((n_up == n - max(2, n // 128)).all()):
            raise AssertionError(f"[fleet-main] {label}: n_up {n_up.unique().tolist()}")
        if label == "pview" and launches != ticks:
            raise AssertionError(f"[fleet-main] pview: {launches} fleet kernel launches in {ticks} ticks")
        if peak >= 80:
            raise AssertionError(f"[fleet-main] {label}: peak {peak:.2f} GiB")
        rate = s * n * ticks / wall
        out[label] = dict(s=s, n=n, ms_window=wall * 1e3, rate=rate, peak=peak, flags=flags / ticks,
                          launches=launches)
        phase("fleet-main", f"{label} fleet S={s} x N={n} ({s * n:,} member rows), {ticks}-tick window: "
                            f"{wall * 1e3:.1f} ms ({wall * 1e3 / ticks:.2f} ms per fleet tick), {rate:,.0f} "
                            f"member-ticks/s, peak allocated {peak:.2f} GiB, {flags / ticks:.2f} flag reads per "
                            f"fleet tick, fleet kernel launches {launches} in {ticks} ticks")
        del fs, ms, run
        torch.cuda.empty_cache()
    return out


# -- the delay rings on sparse and pview, and the telemetry plane ---------------------

CONFIG3_N = 1024  # config3's lean sparse delay run (benchmarks/config3_fd_loss.py:delay_main)
DELAY_WINDOW_TICKS = 8  # ticks of each CPU-vs-card delay window, past the D = 6 ring's wrap (12 before)
SLOW_ROWS, SLOW_MEAN = tuple(range(8)), 4.0  # the SlowMember of the dense-link window


def device_state_differences(a, b) -> list:
    """Names of the leaves in which two states on one device differ,
    compared there (a host copy of a 9.66 GB view plane is not needed)."""
    import dataclasses as dc

    out = []
    for f in dc.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        if not same:
            out.append(f.name)
    return out


def delay_sparse_run(params, n: int, draws, dense_links: bool):
    """The sparse delay window: ``n - 8`` members up at loss 0.05 and a mean
    delay of 1.5 ticks, scalar links or dense links with a SlowMember (rows
    0-7 at 4.0 ticks on every link touching them, as the chaos event writes
    it); a rumor, a crash wave, a ``join_rows`` batch with rejoins halfway."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    ticks = len(draws)
    crashed = list(range(n // 2, n // 2 + 16))

    def run(dev):
        win = sparse_window(params, dev)
        st = SP.init_sparse_state(params, n - 8, dense_links=dense_links, uniform_loss=CONFIG3_LOSS,
                                  uniform_delay=CONFIG3_DELAY_MEAN, device=dev)
        if dense_links:
            everyone = list(range(n))
            st = SP.set_link_delay(st, everyone, list(SLOW_ROWS), SLOW_MEAN)
            st = SP.set_link_delay(st, list(SLOW_ROWS), everyone, SLOW_MEAN)
        st = SP.crash_rows(SP.spread_rumor(st, 0, 5), crashed)
        st, ms_a, _ = win(st, draws[: ticks // 2], ticks // 2)
        st = SP.join_rows(SP.spread_rumor(st, 1, 77), [n - 8, n - 7] + crashed[:2], params.seed_rows)
        st, ms_b, _ = win(st, draws[ticks // 2:], ticks - ticks // 2)
        return st, {**{k: torch.cat([ms_a[k], ms_b[k]]).cpu() for k in ms_a}, **win.planes()}

    return run


def delay_pview_run(params, n: int, draws):
    """The pview delay window: phase 4's scenario under a uniform mean
    delay of 1.5 ticks."""
    def run(dev):
        win = pview_window(params, dev)
        st, ms, _ = win(busy_state(params, n, dev, CONFIG3_DELAY_MEAN), draws, len(draws))
        return st, {**{k: v.cpu() for k, v in ms.items()}, **win.planes()}

    return run


def check_delay_windows(device, n: int = 4096, ticks: int = DELAY_WINDOW_TICKS) -> dict:
    """Phase 35: windows with the delay rings at D = 6 on the CPU (plain
    versions) and on the card (the kernel) from the same draws — sparse with
    scalar links, sparse with dense links and a SlowMember, pview at
    config16's i16 widths; each again armed with the adaptive plane
    (config13's knobs; the direct-probe stretch) — then a sparse and a pview
    fleet with D = 4 rings (S = 4, N = 256), CPU = card and each row = the
    serial window. Every leaf, the rings included, and every metric equal.
    Returns the card's launches per window."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import rand as PR
    from scalecube_cluster_tpu_torch.ops import sparse as SP

    sp = config5_params(n, fd_every=2, suspicion_mult=1, sync_every=20, delay_slots=CONFIG3_KNOBS["delay_slots"])
    pv = dc.replace(config16_params(n), delay_slots=CONFIG3_KNOBS["delay_slots"])
    out = {}
    for adaptive in (False, True):
        for key, label, params, make in (
            ("sparse", "sparse, scalar links", sp, lambda p, d: delay_sparse_run(p, n, d, False)),
            ("sparse-slow", f"sparse, dense links, rows {SLOW_ROWS[0]}-{SLOW_ROWS[-1]} at {SLOW_MEAN}", sp,
             lambda p, d: delay_sparse_run(p, n, d, True)),
            ("pview", "pview i16", pv, lambda p, d: delay_pview_run(p, n, d)),
        ):
            p = with_adaptive(params) if adaptive else params
            draws = cpu_draws(p, ticks, seed=23)
            cpu_ms, launches = count_launches(lambda: run_cpu_and_card(make(p, draws), device, f"{label} windows"))
            name = f"delay-{key}{'-adaptive' if adaptive else ''}-window"
            out[name] = launches
            sums = {k: int(cpu_ms[k].sum()) for k in ("fd_failed_probes", "rumor_deliveries", "mr_accepts",
                                                        "sync_roundtrips")}
            extra = f", adaptive_lh_high max {int(cpu_ms['adaptive_lh_high'].max())}" if adaptive else ""
            phase("delay-windows", f"{label}, N={n}, {ticks} ticks, D = {p.delay_slots}, mean "
                                   f"{CONFIG3_DELAY_MEAN}{adaptive_label(p)}: every state leaf (the three rings "
                                   f"included), metric and adaptive plane equal on CPU and {device}; {sums}{extra}; "
                                   f"delivery_combine launches on the card {launches} in {ticks} ticks")
    fsp = config5_params(256, fd_every=2, suspicion_mult=1, sync_every=20, mr_slots=64, delay_slots=4)
    out["delay-fleet-sparse"] = check_fleet_window(
        device, "sparse, D = 4", SP,
        lambda d: SP.init_sparse_state(fsp, 256, warm=True, uniform_loss=0.1, uniform_delay=1.5, device=d),
        SP.make_sparse_fleet_run, SP.make_sparse_run, fsp, PR.draw_sparse_tick, s=4, ticks=ticks,
        tag="delay-windows")["launches"]
    fpv = dc.replace(config16_params(256), delay_slots=4)
    out["delay-fleet-pview"] = check_fleet_window(
        device, "pview i16, D = 4", PV,
        lambda d: PV.init_pview_state(fpv, 256, warm=True, uniform_loss=0.1, uniform_delay=1.5, device=d),
        PV.make_pview_fleet_run, PV.make_pview_run, fpv, PR.draw_sparse_tick, s=4, ticks=ticks,
        tag="delay-windows")["launches"]
    return out


def run_config3_delay(device, n: int = CONFIG3_N, rounds: int = CONFIG3_ROUNDS, window: int = 50) -> dict:
    """Phase 36: ``benchmarks/config3_fd_loss.py:delay_main`` as published —
    the sparse lean layout (scalar links) at N = 1,024, fanout 3,
    ping_req_k 3, fd_every 1, D = 6, loss 0.05, mean delay 1.5 ticks, 200
    FD rounds in windows of 50 — the raw FD failure rate against the
    analytic rate; fails outside config3's 3-sigma rule."""
    from scalecube_cluster_tpu_torch.ops import sparse as SP
    from scalecube_cluster_tpu_torch.ops.state import delay_mean_to_q

    params = SP.SparseParams(
        capacity=n, fanout=3, repeat_mult=3, ping_req_k=3, fd_every=1, sync_every=300, suspicion_mult=5,
        rumor_slots=2, mr_slots=512, announce_slots=256, seed_rows=(0,), delay_slots=6,
        fd_direct_timeout_ticks=2, fd_leg_timeout_ticks=1,
    )
    st = SP.init_sparse_state(params, n, warm=True, dense_links=False, uniform_loss=CONFIG3_LOSS,
                              uniform_delay=CONFIG3_DELAY_MEAN, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    probes = failed = suspects = 0

    def go():
        nonlocal st, probes, failed, suspects
        for _ in range(rounds // window):
            st, ms, _ = SP.run_sparse_ticks(st, gen, window, params)
            probes += int(ms["fd_probes"].sum())
            failed += int(ms["fd_failed_probes"].sum())
            suspects += int(ms["fd_new_suspects"].sum())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = count_launches(go)
    wall = time.perf_counter() - t0
    q = delay_mean_to_q(CONFIG3_DELAY_MEAN)
    p_direct = (1 - CONFIG3_LOSS) ** 2 * timely(q, params.fd_direct_timeout_ticks)
    p_relay = (1 - CONFIG3_LOSS) ** 4 * timely(q, params.fd_leg_timeout_ticks) ** 2
    analytic = (1 - p_direct) * (1 - p_relay) ** params.ping_req_k
    observed = failed / max(probes, 1)
    sigma = (analytic * (1 - analytic) / max(probes, 1)) ** 0.5
    z = (observed - analytic) / sigma
    sparse_invariants(st)
    ring = int(st.pending_minf.sum()) + int(st.pending_inf.sum())
    phase("config3-delay", f"sparse lean, N={n}, D = {params.delay_slots}, {rounds} FD rounds: raw FD failure rate "
                           f"{observed:.6f} against analytic {analytic:.6f} (sigma {sigma:.6f} over {probes} probes, "
                           f"z = {z:.2f}); config3's 3-sigma within_tolerance {abs(z) < 3}; new-suspect rate "
                           f"{suspects / max(probes, 1):.6f}; {wall / rounds * 1e3:.2f} ms/tick (the loop reads its "
                           f"counters each window), delivery_combine launches {launches}, ring cells in flight at "
                           f"the end {ring}; invariants held")
    if abs(z) >= 3:
        raise AssertionError(f"config3's delay run is {z:.2f} sigma from its analytic rate (its rule: < 3)")
    return {"launches": launches, "z": z}


#: the ring helpers the gossip phase and the sweeps call, labelled in the
#: delay path's profile
RING_PHASES = ("late_deliveries_", "receive_pending", "clear_pending_now_", "keep_columns_")


def run_delay_main(device, unarmed: dict) -> dict:
    """Phase 37: each engine's full-width main path under config3's delay
    regime (D = 6, mean 1.5 ticks): pview at 1M (phase 5's scenario, then
    two ticks profiled by phase with the ring helpers labelled) and
    sparse at 49,152 (phase 11's churn run), beside their unarmed runs of
    this call; peak below 80 GB, one launch per gossip tick."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.ops import pview as PV

    d = CONFIG3_KNOBS["delay_slots"]
    pv = run_main_path(device, params=dc.replace(config16_params(N_MAIN), delay_slots=d), label="delay-main",
                       delay=CONFIG3_DELAY_MEAN)
    st, gen, params = pv.pop("state"), pv["gen"], pv["params"]
    profile_phases(lambda: PV.run_pview_ticks_fused(st, gen, 2, params), PHASES + RING_PHASES, ticks=2,
                   label="delay-profile")
    ring_gib = (st.pending_minf.numel() + st.pending_inf.numel() + 4 * st.pending_src.numel()) / 2 ** 30
    del st
    torch.cuda.empty_cache()
    sp = run_sparse_main_path(device, params=config5_params(N_SPARSE, delay_slots=d), label="delay-main",
                              delay=CONFIG3_DELAY_MEAN)
    sst = sp.pop("state")
    sring = (sst.pending_minf.numel() + sst.pending_inf.numel() + 4 * sst.pending_src.numel()) / 2 ** 30
    del sst
    torch.cuda.empty_cache()
    for label, run, ticks, ref, ring in (("pview 1M", pv, 10, unarmed["pview"], ring_gib),
                                         (f"sparse {N_SPARSE}", sp, 30, unarmed["sparse"], sring)):
        if run["peak"] >= 80e9:
            raise AssertionError(f"{label} under delay peaks at {run['peak'] / 1e9:.1f} GB")
        if run["launches"] != ticks:
            raise AssertionError(f"{label} under delay: {run['launches']} launches in {ticks} ticks")
        phase("delay-main", f"{label}, D = {d}, mean {CONFIG3_DELAY_MEAN}: {beside(run['ms_tick'], ref)}, "
                            f"peak {run['peak'] / 2 ** 30:.2f} GiB (rings {ring:.2f} GiB), flag reads "
                            f"{run['flags']:.1f}/tick, launches {run['launches'] / ticks:.2f}/tick")
    return {"delay-main-pview": pv["launches"], "delay-main-sparse": sp["launches"]}


def telemetry_pair(device, make, label: str, windows: int, per: int = 10) -> dict:
    """``make()`` -> a fresh driver (one seed, nothing watched): one unarmed
    and one armed with the telemetry plane step a 5-tick warm-up and
    ``windows`` timed ``step(per)``, then 2 ticks under the sync-debug mode.
    Both states must be bit-equal, the armed steps must take no driver
    readback and wait for the device no more often than the unarmed ones;
    one ``flush()`` and one ring read follow. Returns launches per run."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery

    drivers, rec = {}, {}
    for arm in (False, True):
        d = make()
        if arm:
            d.arm_telemetry()
        d.step(5)
        d.sync()
        reads = d.dispatch_stats["readbacks"]
        delivery.delivery_combine.launches = 0
        _tensor.HOST_SYNCS.count = 0
        t0 = time.perf_counter()
        for _ in range(windows):
            d.step(per)
        d.sync()
        wall = time.perf_counter() - t0
        launches, flags = delivery.delivery_combine.launches, _tensor.HOST_SYNCS.count
        waits = count_waits(lambda: d.step(2))
        drivers[arm] = d
        rec[arm] = dict(ms_tick=wall / (windows * per) * 1e3, launches=launches, flags=flags / (windows * per),
                        waits=waits, readbacks=d.dispatch_stats["readbacks"] - reads)
        # the unarmed driver stays for the comparison; its window's
        # temporaries go back to the allocator
        torch.cuda.empty_cache()
    diff = device_state_differences(drivers[False].state, drivers[True].state)
    if diff:
        raise AssertionError(f"[telemetry] {label}: the armed driver's state differs in {diff}")
    armed_, plain = rec[True], rec[False]
    if armed_["readbacks"] or plain["readbacks"]:
        raise AssertionError(f"[telemetry] {label}: {armed_['readbacks']} readbacks while the armed driver stepped")
    if armed_["waits"] != plain["waits"]:
        raise AssertionError(f"[telemetry] {label}: the armed steps waited {armed_['waits']} times, the unarmed "
                             f"{plain['waits']}")
    d = drivers[True]
    d.flush()
    t0 = time.perf_counter()
    snap = d.telemetry.collect()
    read_s = time.perf_counter() - t0
    rows = snap["ring"]["rows"]
    names = snap["ring"]["names"]
    last = dict(zip(names, rows[-1]))
    if len(rows) != windows + 2 or last["tick"] != float(d.tick):
        raise AssertionError(f"[telemetry] {label}: ring rows {len(rows)}, last tick {last['tick']} "
                             f"(driver at {d.tick})")
    phase("telemetry", f"{label}: armed {beside(armed_['ms_tick'], plain['ms_tick'])} over {windows} x step({per}); "
                       f"state bit-equal to the unarmed driver's, 0 readbacks while stepping, device waits in 2 "
                       f"ticks {armed_['waits']} armed / {plain['waits']} unarmed, flag reads {armed_['flags']:.1f}/tick, "
                       f"launches {armed_['launches']}; flush and one ring read ({len(rows)} rows x {len(names)} "
                       f"series, {read_s * 1e3:.1f} ms): newest window n_up {last['n_up']:g}, gossip_msgs "
                       f"{last['gossip_msgs']:g}, rumor_coverage_mean {last['rumor_coverage_mean']:.4f}")
    del drivers
    torch.cuda.empty_cache()
    return {"armed": armed_["launches"], "unarmed": plain["launches"]}


def run_telemetry(device) -> dict:
    """Phase 38: the telemetry plane on each engine's driver at full width
    — pview at 1M (config16's widths, 8 rumors, a crash wave of 1,024
    rows), sparse at 49,152 (config5's widths, 2 rumors, 491 crashes) and
    dense at 10,000 (config4's partition), each a warm-up and
    ``MAIN_PVIEW_WINDOWS`` (pview) or one timed ``step(10)`` — against the unarmed driver of the same seed."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    def pview_driver():
        n = N_MAIN
        d = SimDriver(config16_params(n), n, warm=True, seed=0, device=device)
        for s in range(d.params.rumor_slots):
            d.spread_rumor((s * 997) % n, f"rumor {s}")
        for r in range(n // 2, n // 2 + n // 1024):
            d.crash(r)
        return d

    def sparse_driver():
        n = N_SPARSE
        d = SimDriver(config5_params(n), n, warm=True, seed=0, device=device)
        for s in range(d.params.rumor_slots):
            d.spread_rumor((s * 997) % n, f"rumor {s}")
        for r in range(n // 2, n // 2 + n // 100):
            d.crash(r)
        return d

    def dense_driver():
        n = N_DENSE
        d = SimDriver(config4_params(n), n, warm=True, seed=0, device=device)
        d.block_partition(list(range(n // 10)), list(range(n // 10, n)))
        return d

    out = {}
    for key, make, label, windows in (("pview", pview_driver, f"pview {N_MAIN}", MAIN_PVIEW_WINDOWS),
                                      ("sparse", sparse_driver, f"sparse {N_SPARSE}", 1),
                                      ("dense", dense_driver, f"dense {N_DENSE}", 1)):
        rec = telemetry_pair(device, make, label, windows)
        out[f"telemetry-{key}-armed"] = rec["armed"]
        out[f"telemetry-{key}-unarmed"] = rec["unarmed"]
    return out


# -- the causal trace plane, the control plane and incident replay (phases 39-44)

TRACE_TRACERS = 4  # tracer rows of every traced path (TraceConfig's default count)
TRACE_SLOTS = (0, 1)  # traced rumor slots
TRACE_WINDOW_TICKS = 12  # the CPU-vs-card traced windows of phase 39 (24, then 16 before)
TRACE_DELAY_WINDOW_TICKS = 16  # its pview window under D = 6 (24 before): the first suspicion is raised at tick 15
TRACE_RING = 1024  # the CPU-vs-card windows' ring: at most 16 ticks x 4 tracers = 64 records


def trace_spec(tracers, ring_len: int = TRACE_RING, ping_req_k: int = 3):
    from scalecube_cluster_tpu_torch.trace.schema import TraceSpec

    return TraceSpec(tracer_rows=tuple(int(r) for r in tracers), rumor_slots=TRACE_SLOTS, ring_len=ring_len,
                     ping_req_k=ping_req_k)


def traced_window_run(mod, make_traced, params, n: int, draws, start, spec):
    """The traced window at ``n`` from ``start(dev)``: a crash wave of
    tracers and rumors before tick 0, a partition between the two halves at
    a third of the window, its heal at two thirds; the ring on ``dev``.
    Returns ``run(dev) -> (state, metrics with the ring as one more
    [1, ring_len, F] int32 series)``."""
    from scalecube_cluster_tpu_torch.trace.rings import TraceRing

    ticks = len(draws)
    cuts = (0, ticks // 3, 2 * ticks // 3, ticks)
    half = (list(range(n // 2)), list(range(n // 2, n)))

    def run(dev):
        st = start(dev)
        ring = TraceRing(spec, device=dev)
        parts = []
        for i in range(3):
            if i == 1:
                st = mod.block_partition(st, *half)
            if i == 2:
                st = mod.heal_partition(st, *half)
            k = cuts[i + 1] - cuts[i]
            st, ms, _ = make_traced(params, k, spec)(st, ring, draws[cuts[i]:cuts[i + 1]])
            parts.append(ms)
        ms = {k: torch.cat([p[k] for p in parts]).cpu() for k in parts[0]}
        ms["trace ring"] = ring.buf[None].cpu()
        ms["trace records"] = torch.tensor([[ring.records]])
        return st, ms

    return run


def check_trace_windows(device, n: int = 4096, ticks: int = TRACE_WINDOW_TICKS,
                        delay_ticks: int = TRACE_DELAY_WINDOW_TICKS) -> dict:
    """Phase 39: each engine's traced window on the CPU (plain versions) and
    on the card (the kernel) from the same draws, ``ticks`` ticks at ``n``:
    pview at config16's i16 widths, sparse at config5's widths with dense
    links, dense at config9's i16 widths; a crash wave whose first rows
    are the tracers, every rumor slot live, a partition between the halves
    and its heal; then the pview window again with the delay rings at D =
    6, ``delay_ticks`` ticks. Every state leaf, every metric and every
    trace-ring row equal. Returns the card's launches per window."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.ops import kernel as K
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import sparse as SP
    from scalecube_cluster_tpu_torch.ops import state as S

    crashed = list(range(n // 2, n // 2 + max(4, n // 1024)))
    tracers = crashed[:2] + [1, n // 4]
    spec = trace_spec(tracers)

    def pview_start(params, delay=0.0):
        return lambda dev: busy_state(params, n, dev, delay)

    def sparse_start(params):
        def start(dev):
            st = SP.init_sparse_state(params, n, warm=True, dense_links=True, uniform_loss=0.02, device=dev)
            for s in range(params.rumor_slots):
                st = SP.spread_rumor(st, s, (s * 997) % n)
            return SP.crash_rows(st, crashed)
        return start

    def dense_start(params):
        def start(dev):
            st = S.init_state(params, n, warm=True, uniform_loss=0.02, device=dev)
            for s in range(params.rumor_slots):
                st = S.spread_rumor(st, s, (s * 997) % n)
            return S.crash_rows(st, crashed)
        return start

    pv = config16_params(n)
    pv_delay = dc.replace(pv, delay_slots=6)
    sp = config5_params(n, fd_every=2, suspicion_mult=1, sync_every=20)
    de = dc.replace(config9_dense_params(n), fd_every=2, suspicion_mult=1, sync_every=20)
    out = {}
    for key, label, mod, make, params, start, ticks in (
        ("pview", "pview i16", PV, PV.make_pview_traced_run, pv, pview_start(pv), ticks),
        ("sparse", "sparse, dense links", SP, SP.make_sparse_traced_run, sp, sparse_start(sp), ticks),
        ("dense", "dense i16", S, K.make_traced_run, de, dense_start(de), ticks),
        ("pview-delay", "pview i16, D = 6, mean 1.5", PV, PV.make_pview_traced_run, pv_delay,
         pview_start(pv_delay, CONFIG3_DELAY_MEAN), delay_ticks),
    ):
        draws = cpu_draws(params, ticks, seed=31)
        run = traced_window_run(mod, make, params, n, draws, start, spec)
        cpu_ms, launches = count_launches(lambda: run_cpu_and_card(run, device, f"{label} traced windows"))
        out[f"trace-window-{key}"] = launches
        rows = cpu_ms["trace ring"][0].numpy()
        from scalecube_cluster_tpu_torch.trace.schema import decode_records

        kinds = sorted({e["kind"] for e in decode_records(rows, spec)})
        records = int(cpu_ms["trace records"])
        if records != ticks * spec.n_tracers or "probe" not in kinds or "suspect_raised" not in kinds:
            raise AssertionError(f"[trace-windows] {label}: {records} records, kinds {kinds}")
        if key != "dense" and torch.device(device).type == "cuda" and launches <= 0:
            raise AssertionError(f"[trace-windows] {label}: no delivery_combine launch on the card")
        phase("trace-windows", f"{label}, N={n}, {ticks} ticks, tracers {tracers}, rumor slots {list(TRACE_SLOTS)}: "
                               f"every state leaf, metric and trace-ring row ({records} records, {spec.n_fields} "
                               f"fields) equal on CPU and {device}; record kinds {kinds}; delivery_combine launches "
                               f"on the card {launches} in {ticks} ticks")
    return out


def trace_pair(device, make, label: str, windows: int, per: int = 10, tracers=None) -> dict:
    """``make()`` -> a fresh driver: one unarmed and one armed with the
    trace plane (``tracers``, rumor slots 0 and 1) step a 5-tick warm-up
    and ``windows`` timed ``step(per)``, then 2 ticks under the sync-debug
    mode. Both states bit-equal, no driver readback while stepping, the
    same device waits; then one ring read, whose record count must be K
    per tick plus K per window boundary. Returns launches per run."""
    from scalecube_cluster_tpu_torch.ops import _tensor, delivery

    drivers, rec = {}, {}
    for arm in (False, True):
        d = make()
        if arm:
            plane = d.arm_trace(tracer_rows=tracers, rumor_slots=TRACE_SLOTS)
        d.step(5)
        d.sync()
        reads = d.dispatch_stats["readbacks"]
        delivery.delivery_combine.launches = 0
        _tensor.HOST_SYNCS.count = 0
        t0 = time.perf_counter()
        for _ in range(windows):
            d.step(per)
        d.sync()
        wall = time.perf_counter() - t0
        launches, flags = delivery.delivery_combine.launches, _tensor.HOST_SYNCS.count
        waits = count_waits(lambda: d.step(2))
        drivers[arm] = d
        rec[arm] = dict(ms_tick=wall / (windows * per) * 1e3, launches=launches, flags=flags / (windows * per),
                        waits=waits, readbacks=d.dispatch_stats["readbacks"] - reads)
        torch.cuda.empty_cache()
    diff = device_state_differences(drivers[False].state, drivers[True].state)
    if diff:
        raise AssertionError(f"[trace-main] {label}: the armed driver's state differs in {diff}")
    armed_, plain = rec[True], rec[False]
    if armed_["readbacks"] or plain["readbacks"]:
        raise AssertionError(f"[trace-main] {label}: {armed_['readbacks']} readbacks while the armed driver stepped")
    if armed_["waits"] != plain["waits"]:
        raise AssertionError(f"[trace-main] {label}: the armed steps waited {armed_['waits']} times, the unarmed "
                             f"{plain['waits']}")
    if armed_["launches"] != plain["launches"]:
        raise AssertionError(f"[trace-main] {label}: armed launches {armed_['launches']}, unarmed {plain['launches']}")
    d = drivers[True]
    ds = d.dispatch_stats
    k = plane.spec.n_tracers
    want = k * (ds["ticks_dispatched"] + ds["windows_dispatched"])
    t0 = time.perf_counter()
    snap = plane.snapshot()
    read_s = time.perf_counter() - t0
    if plane.ring.records != want or ds["readbacks"] - reads != 1:
        raise AssertionError(f"[trace-main] {label}: {plane.ring.records} records (want {want}), "
                             f"{ds['readbacks'] - reads} readbacks for the ring read")
    kinds = sorted({e["kind"] for e in plane.events()})
    phase("trace-main", f"{label}: armed {beside(armed_['ms_tick'], plain['ms_tick'])} over {windows} x step({per}); "
                        f"state bit-equal to the unarmed driver's, 0 readbacks while stepping, device waits in 2 "
                        f"ticks {armed_['waits']} armed / {plain['waits']} unarmed, flag reads {armed_['flags']:.1f}/tick, "
                        f"launches {armed_['launches']} armed / {plain['launches']} unarmed in {windows * per} ticks; "
                        f"one ring read ({len(snap['rows'])} rows x {plane.spec.n_fields} fields, "
                        f"{read_s * 1e3:.1f} ms): {plane.ring.records} records = {k} x ({ds['ticks_dispatched']} ticks "
                        f"+ {ds['windows_dispatched']} window boundaries); kinds {kinds}")
    del drivers, d
    torch.cuda.empty_cache()
    return {"armed": armed_["launches"], "unarmed": plain["launches"], "ms": armed_["ms_tick"],
            "plain_ms": plain["ms_tick"]}


def run_trace_main(device) -> dict:
    """Phase 40: a trace-armed driver against an unarmed one from one seed
    at full width, 4 tracers (two crashed rows, two live) and rumor slots
    0 and 1: pview at 1M (config11's widths, 8 rumors, a crash wave of
    1,024 rows), sparse at 49,152 (config5's widths, 2 rumors, 491
    crashes), dense at 10,000 (config4's partition), one timed
    ``step(10)`` each."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    def pview_driver():
        n = N_MAIN
        d = SimDriver(config16_params(n), n, warm=True, seed=0, device=device)
        for s in range(d.params.rumor_slots):
            d.spread_rumor((s * 997) % n, f"rumor {s}")
        for r in range(n // 2, n // 2 + n // 1024):
            d.crash(r)
        return d

    def sparse_driver():
        n = N_SPARSE
        d = SimDriver(config5_params(n), n, warm=True, seed=0, device=device)
        for s in range(d.params.rumor_slots):
            d.spread_rumor((s * 997) % n, f"rumor {s}")
        for r in range(n // 2, n // 2 + n // 100):
            d.crash(r)
        return d

    def dense_driver():
        n = N_DENSE
        d = SimDriver(config4_params(n), n, warm=True, seed=0, device=device)
        d.block_partition(list(range(n // 10)), list(range(n // 10, n)))
        return d

    out = {}
    for key, make, n, label, windows in (("pview", pview_driver, N_MAIN, f"pview {N_MAIN}", MAIN_PVIEW_WINDOWS),
                                         ("sparse", sparse_driver, N_SPARSE, f"sparse {N_SPARSE}", 1),
                                         ("dense", dense_driver, N_DENSE, f"dense {N_DENSE}", 1)):
        tracers = (n // 2, n // 2 + 1, 1, n // 4) if key != "dense" else (1, 2, n // 10, n // 2)
        rec = trace_pair(device, make, label, windows, tracers=tracers)
        if key != "dense" and torch.device(device).type == "cuda" and rec["armed"] <= 0:
            raise AssertionError(f"[trace-main] {label}: no delivery_combine launch")
        out[f"trace-main-{key}-armed"] = rec["armed"]
        out[f"trace-main-{key}-unarmed"] = rec["unarmed"]
    return out


def run_trace_scenario(device, n: int = N_MAIN) -> dict:
    """Phase 41: ``run_scenario(trace=True)`` on phase 28's pview crash
    scenario at ``n`` (1M: config16's widths, 8 rumors, a crash wave of
    n/1024 rows and a partition healed, ``PVIEW_SCENARIO_HORIZON`` ticks) with the telemetry plane
    armed: the report ``ok`` with no violation and no readback while it
    steps, the first 4 crashed rows traced, each with a sewn detection tree,
    the rest named untraced; the Chrome/Perfetto document written under
    ``chiprun_out/``; then an 8-tick scenario with an unmeetable detection
    budget, whose violation writes a flight dump that must carry the trace
    section. Returns the launches of both runs."""
    from scalecube_cluster_tpu_torch.chaos import events as EV
    from scalecube_cluster_tpu_torch.config import TelemetryConfig
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.telemetry.flight import load_flight_dump

    out_dir = os.path.join("chiprun_out", "trace")
    os.makedirs(out_dir, exist_ok=True)
    g = min(1 << 16, n // 8)
    d = SimDriver(config16_params(n), n, warm=True, seed=0, device=device)
    d.arm_telemetry(TelemetryConfig(flight_dir=out_dir))
    for s in range(d.params.rumor_slots):
        d.spread_rumor((s * 997) % n, f"rumor {s}")
    wave = list(range(n // 2, n // 2 + max(8, n // 1024)))
    scn = EV.Scenario(name="pview-wave-split", events=[
        EV.Crash(rows=wave, at=2),
        EV.Partition(groups=[range(0, g), range(g, 2 * g)], at=5, heal_at=30)], horizon=PVIEW_SCENARIO_HORIZON)
    d.step(2)
    from scalecube_cluster_tpu_torch.chaos.engine import DriverChaosRunner

    def go():
        runner = DriverChaosRunner(d, scn, trace=True)
        base = d.dispatch_stats["readbacks"]
        t0 = time.perf_counter()
        runner.run()
        return runner, base, time.perf_counter() - t0

    (runner, base, wall), launches = count_launches(go)
    rep = runner.last_report
    # one readback for the report, one for the ring read behind trace_spans
    if d.dispatch_stats["readbacks"] != base + 2:
        raise AssertionError(f"[trace-scenario] {d.dispatch_stats['readbacks'] - base - 2} readbacks while stepping")
    if not rep["ok"] or rep["violations"]:
        raise AssertionError(f"[trace-scenario] report not ok: {rep['sentinels']}")
    traced = list(d.trace.spec.tracer_rows)
    if traced != wave[:4] or sorted(rep["trace_spans"]) != traced or rep["untraced_crash_rows"] != wave[4:]:
        raise AssertionError(f"[trace-scenario] traced {traced}, trees {sorted(rep['trace_spans'])}")
    depth = {r: len(t.get("children", ())) for r, t in rep["trace_spans"].items()}
    doc = d.trace.perfetto()
    path = os.path.join(out_dir, "pview_1m_detections.perfetto.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    phase("trace-scenario", f"pview {n}, {rep['ticks_run']} ticks, events {events_text(rep)}: ok, 0 violations, "
                            f"no readback while stepping ({wall / rep['ticks_run'] * 1e3:.2f} ms/tick with trace and "
                            f"telemetry armed); tracers {traced} each with a sewn detection tree (children {depth}), "
                            f"{len(rep['untraced_crash_rows'])} crashed rows named untraced; Perfetto document "
                            f"{path} ({len(doc['traceEvents'])} events); launches {launches}")
    # a traced row crashed again: its detection obligation cannot be met in
    # one tick, and its span tree rides the dump
    bad = EV.Scenario(name="forced-violation", events=[EV.Crash(rows=[traced[0]], at=1)], horizon=8,
                      detect_budget=1, check_interval=4)
    rep2, launches2 = count_launches(lambda: d.run_scenario(bad))
    if rep2["ok"] or not rep2.get("flight_dump"):
        raise AssertionError(f"[trace-scenario] the forced violation wrote no flight dump: {rep2['sentinels']}")
    dump = load_flight_dump(rep2["flight_dump"])
    tr = dump.get("trace") or {}
    if not tr.get("rows") or tr.get("tracer_rows") != traced:
        raise AssertionError("[trace-scenario] the flight dump carries no trace section")
    phase("trace-scenario", f"forced violation ({rep2['violations']} violation(s), detect budget 1): flight dump "
                            f"{rep2['flight_dump']} carries the trace section ({len(tr['rows'])} ring rows, span "
                            f"trees for rows {sorted(tr['span_trees'])}); launches {launches2}")
    del d
    torch.cuda.empty_cache()
    return {"trace-scenario": launches + launches2}


def run_config10(device, n: int = 4096, windows: int = 24, reps: int = 5, profile_ticks: int = 24) -> dict:
    """Phase 42: ``benchmarks/config10_trace.py`` as published — the trace
    plane's armed-idle overhead on the plain pipelined dense driver (N =
    4,096, 24 one-tick windows per span, interleaved median of 5 reps; 4
    tracer rows and one traced rumor slot) beside config10's 2% gate (the
    phase fails only on a readback while the armed loop steps), and the
    phase breakdown of the split window (``trace/profile.py:
    profile_driver``, 24 ticks), whose phase times must cover the split
    window's wall within 20%."""
    from scalecube_cluster_tpu_torch.ops.state import SimParams
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.trace.profile import profile_driver

    params = SimParams(capacity=n, fanout=3, repeat_mult=3, ping_req_k=3, fd_every=5, sync_every=150,
                       suspicion_mult=5, rumor_slots=8, seed_rows=(0,), full_metrics=False)
    loops = {}
    for armed in (False, True):
        d = SimDriver(params, n, warm=True, seed=0, device=device)
        if armed:
            d.arm_trace(tracer_rows=(0, 1, 2, 3), rumor_slots=(0,))
        d.step(1)
        d.sync()
        loops[armed] = d
    spans = {False: [], True: []}
    for _rep in range(reps):
        for armed, d in loops.items():
            base = d.dispatch_stats["readbacks"]
            t0 = time.perf_counter()
            for _ in range(windows):
                d.step(1)
            d.sync()
            spans[armed].append(time.perf_counter() - t0)
            if d.dispatch_stats["readbacks"] != base:
                raise AssertionError("[config10] a driver read the device back while stepping")
    plain, armed = statistics.median(spans[False]), statistics.median(spans[True])
    overhead = (armed / plain - 1.0) * 100.0
    phase("config10", f"dense N={n}, {reps} x {windows} one-tick windows: pipelined {windows / plain:.1f} ticks/s, "
                      f"trace-armed {windows / armed:.1f} ticks/s, armed overhead {overhead:+.2f}% (config10's gate "
                      f"2%: {'within' if overhead <= 2.0 else 'outside'}); no readback while stepping; "
                      f"{loops[True].trace.ring.records} records appended")
    prof = profile_driver(loops[True], n_ticks=profile_ticks)
    cover = prof["phase_coverage"]
    if abs(cover - 1.0) > 0.2:
        raise AssertionError(f"[config10] the phase times cover {cover} of the split window's wall")
    shares = ", ".join(f"{k} {v:.1f}%" for k, v in sorted(prof["phases_pct"].items(), key=lambda kv: -kv[1]))
    phase("config10", f"phase-split profile ({profile_ticks} ticks, CUDA events per phase): "
                      f"{prof['split_ticks_per_s']} split ticks/s against {windows / plain:.1f} fused "
                      f"({windows / plain / prof['split_ticks_per_s']:.2f}x), coverage {cover}; {shares}")
    del loops
    return {"overhead_pct": overhead, "phase_coverage": cover}


STORM_GRID = (20.0, 24.0, 28.0)  # config15's per-scenario storm floors (percent)
C15_N, C15_SEEDS = 48, 512  # config15's certification as published


def config15_cell(task) -> dict:
    """One shifting cell of config15's certification in a worker process:
    ``task`` is (cell index, N, seeds, device). Every arm's fleet draws
    from the JAX key chains ``PRNGKey(1000 + s)``."""
    from scalecube_cluster_tpu_torch.chaos import shifting as SH
    from scalecube_cluster_tpu_torch.control import certify_controller_mc
    from scalecube_cluster_tpu_torch.ops.keychain import KeyChain

    i, n, seeds, device = task
    cert = certify_controller_mc(cells=[SH.SHIFTING_FAMILY[i](n=n)], n=n, n_seeds=seeds, window=8,
                                 vary_storm_pct=STORM_GRID, device=device,
                                 draws=lambda cell, arm, rung: KeyChain(1000 + np.arange(seeds), device))
    return cert["entries"][0]


def jax_record(name: str) -> dict:
    """A record of the JAX package committed under ``reference/``
    (``reference/jax_records.py`` writes them on the CPU)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference", name)) as fh:
        return json.load(fh)


def run_config15(device, pooled: dict) -> dict:
    """Phase 43: ``benchmarks/config15_control.py``'s certification as
    published — ``certify_controller_mc`` over the three shifting cells at
    N = 48, 512 seeds per cell, 8-tick windows, storm floors 20/24/28%,
    every arm's fleet drawing from the JAX package's own key chains
    (``ops/keychain.py``: ``PRNGKey(1000 + s)`` per scenario, as JAX's
    harness seeds them), one cell per task of ``run_worker_pool`` on the
    card: every cell's controlled arm certified with 0 false-DEAD, the
    blind and unclamped controllers failing, and every arm's SLO, failure
    and false-DEAD counts and actuations equal to the JAX package's record
    of the same run (``reference/config15_certification.jax.json``); then
    the armed-idle check at full width: a control-armed sparse driver at
    49,152 (config5's widths) under clean conditions against an unarmed
    one: 0 actuations, one readback per control epoch, the state
    bit-equal, ms/tick beside the unarmed. Returns the launches of both
    kernels on each part."""
    from scalecube_cluster_tpu_torch.control import ControlSpec
    from scalecube_cluster_tpu_torch.sim import SimDriver

    seeds = C15_SEEDS
    entries = [e for e, _, _ in pooled["config15"]]
    cert = {"entries": entries, "n_cells": len(entries), "n_certified": sum(e["certified"] for e in entries)}
    ref = {e["cell"]: e for e in jax_record("config15_certification.jax.json")["certification"]["entries"]}
    keys = ("slo_met", "slo_wilson", "false_dead_scenarios", "fail_detect", "fail_fp", "fail_cost", "fail_spread",
            "actuations", "detect_latency_p50", "detect_latency_max")
    for e in cert["entries"]:
        arms = e["arms"]
        text = "; ".join(f"{k} {v['slo_met']}/{v['n_seeds']} {v['slo_wilson']} fp {v['false_dead_scenarios']}"
                         for k, v in arms.items())
        phase("config15", f"{e['cell']}: {'CERTIFIED' if e['certified'] else 'NOT certified'} (separation "
                          f"{e['separation']}, controlled false-DEAD {e['controlled_false_dead']}, blind fails "
                          f"{e['blind_fails_certification']}, unclamped fails {e['unclamped_fails_certification']}, "
                          f"actuations {e['controlled_actuations']} / unclamped {e['unclamped_actuations']}): {text}")
        if not (e["certified"] and e["controlled_false_dead"] == 0 and e["blind_fails_certification"]
                and e["unclamped_fails_certification"]):
            raise AssertionError(f"[config15] {e['cell']} not certified")
        differ = [f"{arm}.{k}" for arm, rec in arms.items() for k in keys
                  if rec[k] != ref[e["cell"]]["arms"][arm][k]]
        if differ:
            raise AssertionError(f"[config15] {e['cell']}: the card's counts differ from the JAX record in {differ}")
    cert_launches = sum(n for _, n, _ in pooled["config15"])
    cert_fleet = sum(n for _, _, n in pooled["config15"])
    phase("config15", f"certify_controller_mc: {cert['n_certified']}/{cert['n_cells']} cells certified at {seeds} "
                      f"seeds per cell (the shared worker pool); every arm's counts, intervals, actuations and "
                      f"latencies equal to the JAX package's record of the same key chains "
                      f"(reference/config15_certification.jax.json); the workers' launches: delivery_combine "
                      f"{cert_launches}, delivery_combine_fleet {cert_fleet}")

    def driver():
        d = SimDriver(config5_params(N_SPARSE), N_SPARSE, warm=True, seed=0, device=device)
        for s in range(d.params.rumor_slots):
            d.spread_rumor((s * 997) % N_SPARSE, f"rumor {s}")
        return d

    drivers, rec = {}, {}
    epochs, per = 3, 5
    spec = ControlSpec()

    def idle_pair():
        for arm in (False, True):
            d = driver()
            if arm:
                rec["plane"] = d.arm_control(spec=spec)
            else:
                d.arm_telemetry()  # the same telemetry ring, so only the controller differs
            d.step(5)
            d.sync()
            reads = d.dispatch_stats["readbacks"]
            t0 = time.perf_counter()
            for _ in range(epochs * spec.epoch_windows):
                d.step(per)
            d.sync()
            rec[arm] = dict(ms=(time.perf_counter() - t0) / (epochs * spec.epoch_windows * per) * 1e3,
                            readbacks=d.dispatch_stats["readbacks"] - reads)
            drivers[arm] = d

    _, idle_launches = count_launches(idle_pair)
    plane = rec["plane"]
    diff = device_state_differences(drivers[False].state, drivers[True].state)
    if diff or plane.state.actuations or rec[True]["readbacks"] != epochs or rec[False]["readbacks"]:
        raise AssertionError(f"[config15] armed idle: differs in {diff}, actuations {plane.state.actuations}, "
                             f"readbacks {rec[True]['readbacks']} (want {epochs})")
    phase("config15", f"armed idle, sparse {N_SPARSE}, {epochs} control epochs of {spec.epoch_windows} x step({per}): "
                      f"{beside(rec[True]['ms'], rec[False]['ms'])}; 0 actuations, {rec[True]['readbacks']} readbacks "
                      f"(one per epoch), state bit-equal to the unarmed driver's; rung {plane.state.rung} "
                      f"({plane.snapshot()['rung_name']}), last sensors {plane.state.last_sensors}; delivery_combine "
                      f"launches {idle_launches} (both drivers, {2 * (5 + epochs * spec.epoch_windows * per)} ticks)")
    del drivers
    torch.cuda.empty_cache()
    return {"launches": {"config15-certify": cert_launches, "config15-armed-idle": idle_launches},
            "fleet": {"config15-certify": cert_fleet}}


CONFIG17_ARMS = [  # benchmarks/config17_replay.py: ARMS
    {"name": "fast-fd", "fd_every": 1, "suspicion_mult": 2},
    {"name": "moderate-fd", "fd_every": 2, "suspicion_mult": 3},
    {"name": "wider-fanout", "fanout": 6},
]


def run_config17(device, n: int = 24, seeds: int = 256, detect_budget: int = 60, horizon: int = 96) -> dict:
    """Phase 44: ``benchmarks/config17_replay.py`` as published — the
    incident made on the card by a telemetry-armed driver (N = 24, the slow
    FD cadence whose detection misses a 60-tick budget, horizon 96); its
    flight dump round-trips (``validate_incident`` on a fresh card driver
    reproduces the recorded verdict); ``whatif`` runs the as-recorded arm
    and three counterfactual arms at 256 seeds each, at least one
    CI-separated from the as-recorded arm; and the card's dump replayed by
    the port on the CPU gives the same verdict. The driver, the replay and
    every arm's fleet draw from the JAX package's key chains
    (``ops/keychain.py``: ``PRNGKey(11)``, ``PRNGKey(1000 + s)``), so the
    round trip and every arm's counts, intervals and latencies must equal
    the JAX package's record of the same run
    (``reference/config17_replay.jax.json``)."""
    from scalecube_cluster_tpu_torch import replay as R
    from scalecube_cluster_tpu_torch.chaos.events import Crash, Scenario
    from scalecube_cluster_tpu_torch.config import TelemetryConfig
    from scalecube_cluster_tpu_torch.ops.keychain import KeyChain
    from scalecube_cluster_tpu_torch.ops.state import SimParams
    from scalecube_cluster_tpu_torch.sim import SimDriver

    def serial_chain(seed: int, params, dev):
        chain = KeyChain([seed], dev, serial=True)
        return lambda n_ticks: chain(n_ticks, params)

    flight_dir = os.path.join("chiprun_out", "replay")
    os.makedirs(flight_dir, exist_ok=True)
    params = SimParams(capacity=n, fanout=3, ping_req_k=2, fd_every=4, sync_every=40, suspicion_mult=5,
                       rumor_slots=8, seed_rows=(0,))
    d = SimDriver(params, n, warm=True, seed=11, device=device, draws=serial_chain(11, params, device))
    d.arm_telemetry(TelemetryConfig(ring_len=64, flight_windows=32, flight_dir=flight_dir))
    scenario = Scenario(name="slow-fd-missed-deadline", events=[Crash(rows=[7], at=8)], horizon=horizon,
                        detect_budget=detect_budget, converge_budget=horizon, check_interval=4)
    t0 = time.perf_counter()
    report = d.run_scenario(scenario)
    if not report.get("violations") or not report.get("flight_dump"):
        raise AssertionError("[config17] the slow-FD run met its deadline: no incident")
    incident = R.incident_from_flight(report["flight_dump"])
    validation = R.validate_incident(incident, device=device, draws=serial_chain(11, incident.params, device))
    t_validate = time.perf_counter() - t0
    ref = jax_record("config17_replay.jax.json")
    if {k: validation[k] for k in ("recorded", "replayed", "reproduced")} != ref["round_trip"]:
        raise AssertionError(f"[config17] the round trip differs from the JAX record: {ref['round_trip']}")
    if validation["reproduced"] is not True:
        raise AssertionError(f"[config17] the serial replay did not reproduce the verdict: {validation['replayed']}")
    phase("config17", f"incident on {device}: {report['violations']} violation(s), flight dump "
                      f"{report['flight_dump']} (backend {report['backend']}); round trip: recorded "
                      f"{validation['recorded']}, replayed {validation['replayed']}, reproduced "
                      f"({t_validate:.1f} s)")
    t0 = time.perf_counter()
    record = R.whatif(incident, CONFIG17_ARMS, seeds_per_arm=seeds, device=device,
                      draws=lambda name, p: (lambda k, c=KeyChain(1000 + np.arange(seeds), device): c(k, p)))
    t_whatif = time.perf_counter() - t0
    keys = ("green", "wilson", "fail_detect", "fail_converge", "false_dead_scenarios", "detect_latency_p50",
            "detect_latency_max", "separated")
    differ = [f"{a['arm']}.{k}" for a, r in zip(record["arms"], ref["whatif"]["arms"]) for k in keys
              if a[k] != r[k] or a["arm"] != r["arm"]]
    if differ:
        raise AssertionError(f"[config17] the card's arms differ from the JAX record in {differ}: "
                             f"{[(a['arm'], [a[k] for k in keys]) for a in record['arms']]}")
    for arm in record["arms"]:
        phase("config17", f"{arm['arm']}: P(green) {arm['p_green']} ({arm['green']}/{seeds}) wilson {arm['wilson']}, "
                          f"fails detect/converge {arm['fail_detect']}/{arm['fail_converge']}, false-DEAD scenarios "
                          f"{arm['false_dead_scenarios']}, detect latency p50 {arm['detect_latency_p50']} max "
                          f"{arm['detect_latency_max']}, separated {arm['separated']}")
    if record["n_arms"] < 4 or not record["any_arm_separated"]:
        raise AssertionError("[config17] no counterfactual arm CI-separated from the as-recorded arm")
    cpu_inc = R.incident_from_flight(report["flight_dump"])
    cpu_val = R.validate_incident(cpu_inc, device="cpu", draws=serial_chain(11, cpu_inc.params, "cpu"))
    if cpu_val["reproduced"] is not True:
        raise AssertionError(f"[config17] the card's dump replayed on the CPU gave {cpu_val['replayed']}")
    phase("config17", f"whatif: {record['n_arms']} arms x {seeds} seeds in {t_whatif:.1f} s, {record['n_separated']} "
                      f"CI-separated, every arm's counts, intervals and latencies equal to the JAX record's; "
                      f"the card's dump replayed on the CPU: {cpu_val['replayed']}, reproduced")
    return record


def fleet_kernel_entry(rows: dict, launches: dict) -> dict:
    """The kernels line's entry of the scenario-axis variant: its numbers at
    the full-width batch, the other shapes beside them; ``launches`` from
    the fleet paths of this run (the pview fleet main path's among them)."""
    full = rows["full width (pview 4,096)"]
    return {
        "name": "delivery_combine_fleet",
        "route": "cuda",
        "source": "scalecube_cluster_tpu_torch/csrc/delivery_combine.cu",
        "replaces": "scalecube_cluster_tpu/ops/pallas_delivery.py:251 (under the fleet's vmap: a leading [S])",
        "launches": launches.get("fleet-main-pview", 0),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "serial_launches_ms": full["serial_launches_ms"],
        "at_shapes": rows,
    }


def mesh_draws(params, ticks: int, device, seed: int) -> list:
    """``ticks`` full per-tick (fd, round) draw pairs from one generator on
    ``device`` (FD draws on FD ticks only, from tick 1), shared by a
    sharded window and its unsharded twin."""
    from scalecube_cluster_tpu_torch.ops import rand as PR

    gen = torch.Generator(device=device).manual_seed(seed)
    return [PR.draw_sparse_tick(gen, params, (t + 1) % params.fd_every == 0) for t in range(ticks)]


def metric_differences(a: dict, b: dict) -> list:
    """Names of the metrics of ``a`` that ``b`` does not hold equal."""
    return [k for k in a if k not in b or not torch.equal(a[k], b[k].to(a[k].device))]


def run_mesh_window(device, mesh, n: int = N_MAIN, ticks: int = MESH_TICKS) -> dict:
    """The sharded fused window at config16's widths against the unsharded
    one from a copy of one start state, with the same draws."""
    from scalecube_cluster_tpu_torch.ops import delivery, ragged_a2a
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import sharding as SH
    from scalecube_cluster_tpu_torch.ops.bitplane import words_for

    params = config16_params(n)
    wt = words_for(params.mr_pool) + words_for(params.rumor_slots) + params.rumor_slots
    nbytes = ragged_a2a.exchange_bytes(params.fanout, n, SH.member_mesh_size(mesh), wt)
    phase("mesh-window", f"N={n}: exchange buffer [W=1, B={params.fanout * n}, 3 + {wt}] int32, "
                         f"{nbytes / 2 ** 30:.3f} GiB sent and as much received per gossip tick")
    st = busy_state(params, n, device)
    start = copy_state(st, device)
    draws = mesh_draws(params, ticks, device, seed=11)

    def timed(window, state):
        """Tick 1 (it grows the allocator's pools), then ticks 2.. timed."""
        state, first, _ = window(1)(state, draws[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rest, _ = window(ticks - 1)(state, draws[1:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return state, {k: torch.cat([first[k], rest[k]]) for k in first}, wall / (ticks - 1) * 1e3

    delivery.delivery_combine.launches = 0
    st, ms, ms_u = timed(lambda t: PV.make_pview_fused_run(params, t), st)
    launches_u = delivery.delivery_combine.launches
    mine = SH.shard_pview_state(start, mesh)
    del start
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()  # the unsharded result and what earlier phases hold
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    mine, ms_s, ms_sh = timed(lambda t: SH.make_sharded_pview_fused_run(mesh, params, t), mine)
    launches = delivery.delivery_combine.launches
    peak = torch.cuda.max_memory_allocated()
    diff = device_state_differences(st, mine) + metric_differences(ms, ms_s)
    if diff:
        raise AssertionError(f"[mesh-window] the sharded window differs from the unsharded one in {diff}")
    overflow = int(ms_s["delivery_overflow"].sum())
    if overflow or launches or launches_u != ticks:
        raise AssertionError(f"[mesh-window] overflow {overflow}, sharded launches {launches}, unsharded "
                             f"launches {launches_u} of {ticks}")
    phase("mesh-window", f"N={n}, {ticks} ticks from one start state and draws: every leaf and metric "
                         f"bit-equal; ticks 2-{ticks} sharded {ms_sh:.2f} ms/tick against unsharded "
                         f"{ms_u:.2f} ({ms_sh / ms_u - 1:+.1%}), peak allocated "
                         f"{peak / 2 ** 30:.2f} GiB, {(peak - live) / 2 ** 30:.2f} GiB above the {live / 2 ** 30:.2f} "
                         f"live before the sharded window; delivery_overflow 0; delivery_combine launches 0 sharded, "
                         f"{launches_u} unsharded")
    del st, mine, draws
    torch.cuda.empty_cache()
    return {"mesh-window": launches}


def run_mesh_starved(device, mesh, cpu_mesh, n: int = MESH_SMALL_N, ticks: int = 8,
                     budget: int = MESH_STARVED_BUDGET) -> dict:
    """A starved exchange budget on the card and on the CPU (gloo) from one
    start state and one set of draws: equal states, metrics and overflow,
    the overflow > 0."""
    from scalecube_cluster_tpu_torch import convert
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import sharding as SH

    params = config16_params(n)
    start = busy_state(params, n, "cpu")
    draws = mesh_draws(params, ticks, "cpu", seed=5)
    out = {}
    delivery.delivery_combine.launches = 0
    for where, m in (("card", mesh), ("cpu", cpu_mesh)):
        run = SH.make_sharded_pview_fused_run(m, params, ticks, a2a_budget=budget)
        st, ms, _ = run(SH.shard_pview_state(start, m), draws)
        out[where] = (convert.state_to_numpy(st), {k: v.cpu() for k, v in ms.items()})
    launches = delivery.delivery_combine.launches
    (a, ma), (b, mb) = out["card"], out["cpu"]
    diff = [k for k in a if not np.array_equal(a[k], b[k])] + metric_differences(ma, mb)
    overflow = int(ma["delivery_overflow"].sum())
    if diff or overflow <= 0 or launches:
        raise AssertionError(f"[mesh-starved] card and CPU differ in {diff}; overflow {overflow}, launches {launches}")
    phase("mesh-starved", f"N={n}, budget {budget} of a lossless {params.fanout * n}, {ticks} ticks: card (NCCL) = "
                          f"CPU (gloo) in every leaf and metric; delivery_overflow {overflow} on both "
                          f"({ma['delivery_overflow'].tolist()}), rumor_sends {int(ma['rumor_sends'].sum())}")
    return {"mesh-starved": launches}


def mesh_driver_pair(device, mesh, params, n: int, label: str, trace: bool, step: int) -> dict:
    """An unsharded and a sharded ``SimDriver`` from one seed, the telemetry
    plane and (``trace``) the trace plane armed, a watched row, a crash
    and a rumor: one warm-up ``step(2)`` and one timed ``step(step)``
    each. States, planes, rings, events and readbacks must be equal; the
    sharded one launches the delivery kernel 0 times."""
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.sim import SimDriver

    rec = {}
    for sharded in (False, True):
        d = SimDriver(params, n, seed=0, device=device, mesh=mesh if sharded else None)
        d.arm_telemetry()
        if trace:
            d.arm_trace(tracer_rows=(0, 1, n // 2, n - 1), rumor_slots=(0, 1))
        d.watch(0)
        d.spread_rumor(n // 2, "mesh")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.crash(n // 2 + 1)  # a host mutation (a sharded driver's runs on the gathered state)
        torch.cuda.synchronize()
        mutation_ms = (time.perf_counter() - t0) * 1e3
        d.step(1)
        d.sync()
        delivery.delivery_combine.launches = 0
        t0 = time.perf_counter()
        d.step(step)
        d.sync()
        wall = time.perf_counter() - t0
        launches = delivery.delivery_combine.launches
        ring = d.telemetry.collect()["ring"]["rows"]
        rec[sharded] = dict(driver=d, ms_tick=wall / step * 1e3, launches=launches, ring=ring, mutation_ms=mutation_ms,
                            trace=d.trace.ring.buf.clone() if trace else None,
                            events=[(e.type.value, e.member.id) for e in d.events_of(0)],
                            readbacks=d.dispatch_stats["readbacks"])
        torch.cuda.empty_cache()
    u, s = rec[False], rec[True]
    diff = device_state_differences(u["driver"].state, s["driver"].state)
    if u["driver"].adaptive_state is not None:
        diff += [f"ad.{k}" for k in ("lh", "conf_key", "conf")
                 if not torch.equal(getattr(u["driver"].adaptive_state, k), getattr(s["driver"].adaptive_state, k))]
    for k in ("ring", "events", "readbacks"):
        if u[k] != s[k]:
            diff.append(k)
    if trace and not torch.equal(u["trace"], s["trace"]):
        diff.append("trace ring")
    if diff or s["launches"] or u["launches"] != step:
        raise AssertionError(f"[mesh-driver] {label}: differs in {diff}; launches {s['launches']} sharded, "
                             f"{u['launches']} unsharded")
    phase("mesh-driver", f"{label}: step({step}) sharded {s['ms_tick']:.2f} ms/tick against unsharded "
                         f"{u['ms_tick']:.2f} ({s['ms_tick'] / u['ms_tick'] - 1:+.1%}); state, planes, "
                         f"{len(s['ring'])} telemetry rows{', the trace ring' if trace else ''}, "
                         f"{len(s['events'])} events of row 0 and {s['readbacks']} readbacks equal; "
                         f"delivery_combine launches 0 sharded, {u['launches']} unsharded; a host mutation (crash) "
                         f"{s['mutation_ms']:.1f} ms sharded against {u['mutation_ms']:.1f} unsharded")
    del rec
    torch.cuda.empty_cache()
    return s["launches"]


def run_mesh_driver(device, mesh, n: int = N_MAIN, step: int = MESH_DRIVER_STEP) -> dict:
    params = config16_params(n)
    a = mesh_driver_pair(device, mesh, with_adaptive(params), n, f"N={n} adaptive + telemetry", False, step)
    b = mesh_driver_pair(device, mesh, params, n, f"N={n} trace + telemetry", True, step // 2)
    return {"mesh-driver": a + b}


def run_mesh_fleet(device, fleet=MESH_FLEET) -> dict:
    """The pview fleet on a 1-rank scenario mesh against the one-process
    fleet: every row and the coverage fold equal."""
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import pview as PV

    s, n, ticks = fleet
    params = config16_params(n)
    fmesh = FL.fleet_mesh(device.type)
    base = FL.fleet_inject_rumor(PV, FL.fleet_broadcast(PV.init_pview_state(params, n, device=device), s), 0,
                                 [(7 * i + 1) % n for i in range(s)])
    one, ms, _ = FL.make_fleet_run(params, ticks)(copy_state(base, device), FL.fleet_generator(3, device))
    delivery.delivery_combine_fleet.launches = 0
    mine, ms_m, _ = FL.make_fleet_run(params, ticks)(FL.shard_fleet(base, fmesh),
                                                     FL.fleet_draws(FL.fleet_generator(3, device), fmesh, s))
    launches = delivery.delivery_combine_fleet.launches
    hit = FL.fold_first_full_coverage(torch.full((s,), -1, dtype=torch.int32, device=device),
                                      ms["rumor_coverage"][:, :, 0], 0)
    hit_m = FL.fleet_gather(FL.fold_first_full_coverage(
        torch.full((FL.fleet_size(mine),), -1, dtype=torch.int32, device=device), ms_m["rumor_coverage"][:, :, 0], 0),
        fmesh)
    covered = FL.fleet_fold_sum((hit_m >= 0).sum().to(torch.int32), fmesh)
    diff = device_state_differences(one, mine) + metric_differences(ms, ms_m)
    if diff or not torch.equal(hit, hit_m) or int(covered) != int((hit >= 0).sum()):
        raise AssertionError(f"[mesh-fleet] the scenario-mesh fleet differs in {diff or 'its fold'}")
    phase("mesh-fleet", f"S={s} x N={n}, {ticks} ticks on a 1-rank scenario mesh: every row and metric equal to "
                        f"the one-process fleet, {int(covered)} of {s} scenarios fully covered (summed over the "
                        f"ranks), fleet kernel launches {launches}")
    return {"mesh-fleet": launches}


def mesh_delay_params(n: int):
    """config16's widths under config3's delay regime, with the push-pull leg."""
    import dataclasses as dc

    from scalecube_cluster_tpu_torch.dissemination.spec import DissemSpec

    return dc.replace(config16_params(n), delay_slots=MESH_DELAY_SLOTS, dissem=DissemSpec(strategy="push_pull"))


def run_mesh_delay(device, mesh, n: int = N_MAIN, ticks: int = MESH_TICKS) -> dict:
    """[mesh-delay]: the sharded fused window with the delay rings and the
    pull leg (their exact exchanges) against the unsharded one from a copy
    of one start state, with the same draws."""
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import sharding as SH

    params = mesh_delay_params(n)
    st = busy_state(params, n, device, delay=CONFIG3_DELAY_MEAN)
    start = copy_state(st, device)
    draws = mesh_draws(params, ticks, device, seed=13)

    def timed(window, state):
        state, first, _ = window(1)(state, draws[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rest, _ = window(ticks - 1)(state, draws[1:])
        torch.cuda.synchronize()
        return state, {k: torch.cat([first[k], rest[k]]) for k in first}, (time.perf_counter() - t0) / (ticks - 1) * 1e3

    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    st, ms, ms_u = timed(lambda t: PV.make_pview_fused_run(params, t), st)
    launches_u = delivery.delivery_combine.launches
    peak_u = torch.cuda.max_memory_allocated()
    mine = SH.shard_pview_state(start, mesh)
    del start
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    delivery.delivery_combine.launches = 0
    mine, ms_s, ms_sh = timed(lambda t: SH.make_sharded_pview_fused_run(mesh, params, t), mine)
    launches = delivery.delivery_combine.launches
    peak = torch.cuda.max_memory_allocated()
    diff = device_state_differences(st, mine) + metric_differences(ms, ms_s)
    if diff:
        raise AssertionError(f"[mesh-delay] the sharded window differs from the unsharded one in {diff}")
    overflow = int(ms_s["delivery_overflow"].sum())
    # ring rows holding a delivery (a reduction over the 12 GiB bool ring
    # that makes no wider copy of it)
    in_flight = int(mine.pending_inf.any(dim=-1).sum()) + int(mine.pending_minf.any(dim=-1).sum())
    if overflow or launches or launches_u != ticks or not in_flight:
        raise AssertionError(f"[mesh-delay] overflow {overflow}, sharded launches {launches}, unsharded "
                             f"launches {launches_u} of {ticks}, ring rows in flight {in_flight}")
    phase("mesh-delay", f"N={n}, D={params.delay_slots} (mean {CONFIG3_DELAY_MEAN}), push_pull, {ticks} ticks from "
                        f"one start state and draws: every leaf, ring row and metric bit-equal ({in_flight} ring "
                        f"rows in flight at the end); ticks 2-{ticks} sharded {ms_sh:.2f} ms/tick against unsharded "
                        f"{ms_u:.2f} ({ms_sh / ms_u - 1:+.1%}); peak allocated unsharded {peak_u / 2 ** 30:.2f} GiB, "
                        f"sharded {peak / 2 ** 30:.2f} GiB ({(peak - live) / 2 ** 30:.2f} above the "
                        f"{live / 2 ** 30:.2f} live before it); delivery_overflow 0; delivery_combine launches 0 "
                        f"sharded, {launches_u} unsharded (one rank: every exchange is a self-copy)")
    del st, mine, draws
    torch.cuda.empty_cache()
    return {"mesh-delay": launches}


def run_mesh_delay_starved(device, mesh, cpu_mesh, n: int = MESH_SMALL_N, ticks: int = 8,
                           budget: int = MESH_STARVED_BUDGET) -> dict:
    """[mesh-delay-starved]: a starved on-time budget with the rings and the
    pull leg, card (NCCL) against CPU (gloo) from one start and draws:
    equal, with overflow > 0 (the exact exchanges drop nothing)."""
    from scalecube_cluster_tpu_torch import convert
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import sharding as SH

    params = mesh_delay_params(n)
    start = busy_state(params, n, "cpu", delay=CONFIG3_DELAY_MEAN)
    draws = mesh_draws(params, ticks, "cpu", seed=5)
    out = {}
    delivery.delivery_combine.launches = 0
    for where, m in (("card", mesh), ("cpu", cpu_mesh)):
        run = SH.make_sharded_pview_fused_run(m, params, ticks, a2a_budget=budget)
        st, ms, _ = run(SH.shard_pview_state(start, m), draws)
        out[where] = (convert.state_to_numpy(st), {k: v.cpu() for k, v in ms.items()})
    launches = delivery.delivery_combine.launches
    (a, ma), (b, mb) = out["card"], out["cpu"]
    diff = [k for k in a if not np.array_equal(a[k], b[k])] + metric_differences(ma, mb)
    overflow = int(ma["delivery_overflow"].sum())
    in_flight = int(a["pending_inf"].sum()) + int(a["pending_minf"].sum())
    if diff or overflow <= 0 or launches or not in_flight:
        raise AssertionError(f"[mesh-delay-starved] card and CPU differ in {diff}; overflow {overflow}, launches "
                             f"{launches}, ring cells in flight {in_flight}")
    phase("mesh-delay-starved", f"N={n}, D={params.delay_slots}, push_pull, budget {budget} of a lossless "
                                f"{params.fanout * n}, {ticks} ticks: card (NCCL) = CPU (gloo) in every leaf, ring "
                                f"row and metric; delivery_overflow {overflow} on both "
                                f"({ma['delivery_overflow'].tolist()}), {in_flight} ring cells in flight")
    return {"mesh-delay-starved": launches}


def run_mesh_fleet2d(device, fleet=MESH_FLEET2D) -> dict:
    """[mesh-fleet2d]: the pview fleet on a 1 x 1 scenarios x members mesh
    (its collectives' vmap rules) against the one-process fleet."""
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import pview as PV
    from scalecube_cluster_tpu_torch.ops import sharding as SH

    s, n, ticks = fleet
    params = config16_params(n)
    mesh2d = SH.make_pview_mesh2d(1, device.type)
    base = FL.fleet_inject_rumor(PV, FL.fleet_broadcast(PV.init_pview_state(params, n, device=device), s), 0,
                                 [(7 * i + 1) % n for i in range(s)])
    def timed(make, fs, draws):
        """Fleet tick 1, then ticks 2.. timed, on one draw source."""
        fs, first, _ = make(1)(fs, draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs, rest, _ = make(ticks - 1)(fs, draws)
        torch.cuda.synchronize()
        return fs, {k: torch.cat([first[k], rest[k]], dim=1) for k in first}, (time.perf_counter() - t0) / (
            ticks - 1) * 1e3

    delivery.delivery_combine_fleet.launches = 0
    one, ms, ms_one = timed(lambda t: FL.make_fleet_run(params, t), copy_state(base, device),
                            FL.fleet_generator(3, device))
    launches_one = delivery.delivery_combine_fleet.launches
    delivery.delivery_combine.launches = delivery.delivery_combine_fleet.launches = 0
    mine, ms_m, ms_2d = timed(lambda t: SH.make_sharded_pview_fleet_run(mesh2d, params, t),
                              SH.shard_pview_fleet(base, mesh2d),
                              FL.fleet_draws(FL.fleet_generator(3, device), mesh2d, s))
    launches = delivery.delivery_combine.launches + delivery.delivery_combine_fleet.launches
    diff = device_state_differences(one, SH.gather_pview_fleet(mine, mesh2d)) + metric_differences(ms, ms_m)
    if diff or launches or launches_one != ticks or int(ms_m["delivery_overflow"].sum()):
        raise AssertionError(f"[mesh-fleet2d] differs in {diff}; launches {launches} on the 2-D mesh, "
                             f"{launches_one} one-process")
    phase("mesh-fleet2d", f"S={s} x N={n} ({s * n} member rows), {ticks} ticks on a 1 x 1 scenarios x members "
                          f"mesh: every row and metric equal to the one-process fleet; fleet ticks 2-{ticks} "
                          f"{ms_2d:.2f} ms each against {ms_one:.2f} ({ms_2d / ms_one - 1:+.1%}); "
                          f"delivery_combine_fleet launches 0 on the mesh, {launches_one} one-process")
    del one, mine, base
    torch.cuda.empty_cache()
    return {"mesh-fleet2d": launches}


def run_mesh_scenario(device, mesh, n: int = N_MAIN) -> dict:
    """[mesh-scenario]: phase 28's 1M pview scenario on the sharded driver,
    its report equal to the unsharded run of the same seed (phase 28's own
    when it ran in this call)."""
    from scalecube_cluster_tpu_torch.chaos.engine import DriverChaosRunner
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.sim import SimDriver

    def drive(sharded: bool):
        d = SimDriver(config16_params(n), n, warm=True, seed=0, device=device, mesh=mesh if sharded else None)
        for s in range(d.params.rumor_slots):
            d.spread_rumor((s * 997) % n, f"rumor {s}")
        d.step(2)
        mut = []
        apply = d._apply

        def timed_apply(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply(fn)
            torch.cuda.synchronize()
            mut.append((time.perf_counter() - t0) * 1e3)

        d._apply = timed_apply
        base = d.dispatch_stats["readbacks"]
        delivery.delivery_combine.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = DriverChaosRunner(d, pview_scenario(n)).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = dict(report=rep, ms_tick=wall / rep["ticks_run"] * 1e3, mutation_ms=mut,
                   readbacks=d.dispatch_stats["readbacks"] - base, launches=delivery.delivery_combine.launches)
        del d
        torch.cuda.empty_cache()
        return out

    s = drive(True)
    ref = dict(PVIEW_SCENARIO_REPORT) or drive(False)
    a, b = dict(ref["report"]), dict(s["report"])
    for r in (a, b):
        r.pop("host_cpus", None)
    if a != b or not b["ok"] or b["violations"] or s["launches"] or s["readbacks"] != 1:
        raise AssertionError(f"[mesh-scenario] sharded report {b} against unsharded {a}; launches {s['launches']}, "
                             f"readbacks {s['readbacks']}")
    dets = b["sentinels"]["detections"]
    det = [(x["row"], x["detected_at"]) for x in dets][:3]
    phase("mesh-scenario", f"N={n}, {b['ticks_run']} ticks, events {events_text(b)}: the sharded report equals the "
                           f"unsharded one ({'phase 28' if PVIEW_SCENARIO_REPORT else 'run here'}, seed 0): ok, 0 "
                           f"violations, crash obligations {len(dets)}, detected "
                           f"{sum(x['detected_at'] is not None for x in dets)} (first {det}; an obligation whose "
                           f"deadline falls after the horizon is not judged); "
                           f"{s['readbacks']} readback (the report), {s['ms_tick']:.2f} ms/tick sharded against "
                           f"{ref['ms_tick']:.2f}; host mutations (gather, mutate, shard) "
                           f"{', '.join(f'{m:.1f}' for m in s['mutation_ms'])} ms; delivery_combine launches 0")
    return {"mesh-scenario": s["launches"]}


def run_mesh_control_profile(device, mesh, n: int = N_MAIN, shape=MESH_CONTROL) -> dict:
    """[mesh-control] and [mesh-profile]: two sharded 1M drivers from one
    seed, a clean cluster with a rumor, telemetry armed on both; A arms the
    control plane, B does not, and ``profile_driver`` runs on B after its
    first window. A must end bit-equal to B with one ring read per control
    epoch more: the armed idle controller and the profile both leave the
    trajectory alone."""
    from scalecube_cluster_tpu_torch.control import ControlSpec
    from scalecube_cluster_tpu_torch.ops import delivery
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.trace.profile import profile_driver

    epochs, per = shape
    rec, drivers = {}, {}
    for armed in (True, False):
        d = SimDriver(config16_params(n), n, seed=0, device=device, mesh=mesh)
        d.arm_telemetry()
        plane = d.arm_control(spec=ControlSpec(epoch_windows=1)) if armed else None
        d.spread_rumor(n // 3, "control")
        reads = d.dispatch_stats["readbacks"]
        # the driver's own windows, the profile's excluded
        delivery.delivery_combine.launches = own = 0
        t0 = time.perf_counter()
        for w in range(epochs):
            d.step(per)
            if w == 0 and not armed:
                d.sync()
                own = delivery.delivery_combine.launches
                delivery.delivery_combine.launches = 0
                p0 = time.perf_counter()
                res = profile_driver(d, n_ticks=MESH_PROFILE_TICKS, warmup_ticks=1)
                rec["profile"] = dict(res=res, s=time.perf_counter() - p0, launches=delivery.delivery_combine.launches)
                delivery.delivery_combine.launches = 0
        d.sync()
        rec[armed] = dict(readbacks=d.dispatch_stats["readbacks"] - reads, s=time.perf_counter() - t0, plane=plane,
                          launches=own + delivery.delivery_combine.launches)
        drivers[armed] = d
    launches = rec[True]["launches"]
    plane = rec[True]["plane"]
    diff = device_state_differences(drivers[True].state, drivers[False].state)
    res = rec["profile"]["res"]
    if diff or plane.state.actuations or rec[True]["readbacks"] - rec[False]["readbacks"] != epochs or launches \
            or rec[False]["launches"]:
        raise AssertionError(f"[mesh-control] armed idle differs in {diff}; actuations {plane.state.actuations}, "
                             f"readbacks {rec[True]['readbacks']} against {rec[False]['readbacks']}, launches "
                             f"{launches} armed, {rec[False]['launches']} unarmed")
    if res["mesh"] != {"members": 1} or abs(res["phase_coverage"] - 1.0) > 0.2 or rec["profile"]["launches"]:
        raise AssertionError(f"[mesh-profile] mesh {res['mesh']}, phase coverage {res['phase_coverage']}, "
                             f"launches {rec['profile']['launches']}")
    phase("mesh-control", f"N={n} sharded, {epochs} control epochs of step({per}): armed idle (rung "
                          f"{plane.state.rung}, 0 actuations) bit-equal to the unarmed sharded driver, "
                          f"{rec[True]['readbacks'] - rec[False]['readbacks']} more readbacks (one ring read per "
                          f"epoch); delivery_combine launches {launches} (the armed driver's windows)")
    top = sorted(res["phases_s"].items(), key=lambda kv: -kv[1])[:4]
    phase("mesh-profile", f"profile_driver on the sharded N={n} driver between its windows ({res['ticks']} ticks + "
                          f"1 warm-up, {rec['profile']['s']:.2f} s): mesh {res['mesh']}, phase coverage "
                          f"{res['phase_coverage']}, wall {res['wall_s']:.4f} s (max over ranks "
                          f"{res['wall_s_max_over_ranks']:.4f}), top phases "
                          f"{', '.join(f'{k} {v:.4f} s' for k, v in top)}; the driver's trajectory untouched (its "
                          f"end state is the armed twin's); delivery_combine launches {rec['profile']['launches']}")
    profile_launches = rec["profile"]["launches"]
    del drivers, rec
    torch.cuda.empty_cache()
    return {"mesh-control": launches, "mesh-profile": profile_launches}


def run_mesh2(device, mesh, cpu_mesh) -> tuple:
    """Phase 46, [mesh-2]: on the same world-size-1 group, the pview engine
    whole on a member mesh."""
    launches = run_mesh_delay(device, mesh)
    launches.update(run_mesh_delay_starved(device, mesh, cpu_mesh))
    fleet = run_mesh_fleet2d(device)
    launches.update(run_mesh_scenario(device, mesh))
    launches.update(run_mesh_control_profile(device, mesh))
    launches["mesh-checkpoint"] = check_checkpoint(device, mesh=mesh)
    return launches, fleet


def run_mesh(device, marks=None) -> tuple:
    """Phase 45: a world-size-1 NCCL group (``file://`` init, the card as
    its device), a gloo group beside it for the CPU reference, the mesh
    phases, and the group destroyed at the end."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from scalecube_cluster_tpu_torch.ops import dcn
    from scalecube_cluster_tpu_torch.ops import sharding as SH

    init = tempfile.mkdtemp(prefix="pg-")
    t0 = time.perf_counter()
    dcn.initialize(f"file://{init}/init", 1, 0, device=device)
    try:
        mesh = dcn.global_mesh("cuda")
        cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu", mesh_dim_names=(SH.MEMBER_AXIS,))
        phase("mesh", f"process group: backend {dist.get_backend()}, world {dist.get_world_size()}, mesh "
                      f"{mesh.mesh_dim_names} on {SH.mesh_device(mesh)}; started in {time.perf_counter() - t0:.2f} s")
        launches = run_mesh_window(device, mesh)
        launches.update(run_mesh_starved(device, mesh, cpu_mesh))
        launches.update(run_mesh_driver(device, mesh))
        fleet = run_mesh_fleet(device)
        if marks is not None:
            marks.append(("phase 45 (mesh)", time.perf_counter()))
        more, fleet2 = run_mesh2(device, mesh, cpu_mesh)
        launches.update(more)
        fleet.update(fleet2)
        if marks is not None:
            marks.append(("phase 46 (mesh-2)", time.perf_counter()))
    finally:
        dist.destroy_process_group()
    phase("mesh", "process group destroyed")
    return launches, fleet


def run_phases_4_to_24(device, marks: list) -> dict:
    """Phases 4-24, as PRs 1-6 left them. Returns the kernel's launches on
    each of their paths, and under "unarmed" the unarmed main paths'
    ms/tick, flag reads and dense outcomes for the armed phases after."""
    from scalecube_cluster_tpu_torch.ops import pview as PV

    check_cross_device(device)
    main_run = run_main_path(device)
    st, gen, params = main_run["state"], main_run["gen"], main_run["params"]
    profile_phases(lambda: PV.run_pview_ticks_fused(st, gen, PROFILE_TICKS, params), PHASES)
    del main_run["state"], st
    torch.cuda.empty_cache()

    check_driver_window(device)
    driver_run = run_driver_path(device)
    profile_phases(lambda: driver_run["driver"].step(PROFILE_TICKS), PHASES, label="driver-profile")
    del driver_run["driver"]
    torch.cuda.empty_cache()
    check_checkpoint(device)
    marks.append(("phases 1-9 (build, kernels, pview)", time.perf_counter()))

    check_sparse_window(device)
    sparse_run = run_sparse_main_path(device)
    profile_sparse(sparse_run)
    sparse_run.pop("state")
    torch.cuda.empty_cache()
    check_driver_window(device, params=config5_params(4096, fd_every=2, suspicion_mult=1, sync_every=20),
                        label="sparse-driver-window", dense_links=True)
    sparse_driver_run = run_sparse_driver_path(device)
    torch.cuda.empty_cache()
    marks.append(("phases 10-14 (sparse)", time.perf_counter()))

    check_dense_window(device)
    check_dense_delay_window(device)
    dense_run = run_dense_main(device)
    torch.cuda.empty_cache()
    check_driver_window(device, params=config9_dense_params(4096), label="dense-driver-window",
                        dense_links=True)
    dense_driver_run = run_dense_driver(device)
    phase("dense-driver", f"driver {dense_driver_run['ms_tick']:.2f} ms/tick against the window's "
                          f"partitioned {dense_run['ms_part']:.2f} ({dense_driver_run['ms_tick'] / dense_run['ms_part'] - 1:+.1%})")
    torch.cuda.empty_cache()
    dense_delay_run = run_dense_delay(device)
    phase("dense", "the dense paths run plain PyTorch tensor ops only: the JAX dense engine reaches no "
                   "pl.pallas_call, and delivery_combine's fold is not their delivery")
    torch.cuda.empty_cache()
    marks.append(("phases 15-21 (dense)", time.perf_counter()))

    dissem_launches = check_dissem_windows(device)
    marks.append(("phase 22 (dissem-windows)", time.perf_counter()))
    pooled = run_worker_pool(device)
    certify_run = run_dissem_certify(device, pooled)
    marks.append(("phase 23 (dissem-certify, with the worker pool of phases 29 and 43)", time.perf_counter()))
    unarmed = {"pview": main_run["ms_tick"], "sparse": sparse_run["ms_tick"], "dense_part": dense_run["ms_part"],
               "dense_heal": dense_run["ms_heal"],
               "dense_ticks": (dense_run["detected"], dense_run["bulk"], dense_run["full"])}
    dissem_launches.update(run_dissem_main(device, unarmed))
    dissem_launches["dissem-certify"] = certify_run["launches"]
    marks.append(("phase 24 (dissem-main)", time.perf_counter()))
    unarmed["pview_flags"] = main_run["flags"]
    unarmed["sparse_flags"] = sparse_run["flags"]
    return {"window": main_run["launches"], "driver": driver_run["launches"],
            "sparse-window": sparse_run["launches"], "sparse-driver": sparse_driver_run["launches"],
            "dense-main": dense_run["launches"], "dense-driver": dense_driver_run["launches"],
            "dense-delay": dense_delay_run["launches"], **dissem_launches, "unarmed": unarmed, "pooled": pooled}


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    phase("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}; host CPU threads "
                    f"{torch.get_num_threads()} of {os.cpu_count()} cores")
    t_start = time.perf_counter()
    marks = []
    print(nvidia_smi(), flush=True)

    from scalecube_cluster_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build("delivery_combine")
    phase("build", f"delivery_combine built in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(_build.build_log("delivery_combine")):
        phase("build", f"ptxas delivery_combine_kernel {line}")

    if "--mesh-only" in argv:
        run_mesh(device, marks)
        last = t_start
        for what, at in marks:
            phase("time", f"{what}: {at - last:.1f} s")
            last = at
        phase("time", f"command time in all: {time.perf_counter() - t_start:.1f} s")
        return 0
    kern = check_kernels(device)
    kern_structured = check_structured_kernel(device)
    launches = run_phases_4_to_24(device, marks)
    unarmed = launches.pop("unarmed")
    pooled = launches.pop("pooled")
    new = check_adaptive_windows(device)
    marks.append(("phase 25 (adaptive-windows)", time.perf_counter()))
    new.update(run_adaptive_main(device, unarmed))
    marks.append(("phase 26 (adaptive-main)", time.perf_counter()))
    new.update(check_chaos_windows(device))
    marks.append(("phase 27 (chaos-windows)", time.perf_counter()))
    new.update(run_chaos_main(device, unarmed))
    marks.append(("phase 28 (chaos-main)", time.perf_counter()))
    c13 = run_config13(pooled)
    marks.append(("phase 29 (config13)", time.perf_counter()))
    _, c7_launches = count_launches(lambda: run_config7(device))
    marks.append(("phase 30 (config7)", time.perf_counter()))
    launches.update(new, config13=c13["launches"], config7=c7_launches)
    fleet_kern = check_fleet_kernel(device)
    marks.append(("phase 31 (fleet-kernel)", time.perf_counter()))
    fleet_launches = check_fleet_windows(device)
    marks.append(("phase 32 (fleet-windows)", time.perf_counter()))
    c14 = run_config14(device, pooled)
    fleet_launches.update(c14["launches"])
    marks.append(("phase 33 (config14)", time.perf_counter()))
    fleet_main = run_fleet_main(device)
    fleet_launches.update({f"fleet-main-{k}": v["launches"] for k, v in fleet_main.items()})
    marks.append(("phase 34 (fleet-main)", time.perf_counter()))
    delay = check_delay_windows(device)
    fleet_launches.update({k: delay.pop(k) for k in ("delay-fleet-sparse", "delay-fleet-pview")})
    launches.update(delay)
    marks.append(("phase 35 (delay-windows)", time.perf_counter()))
    launches["config3-delay"] = run_config3_delay(device)["launches"]
    marks.append(("phase 36 (config3-delay)", time.perf_counter()))
    launches.update(run_delay_main(device, unarmed))
    marks.append(("phase 37 (delay-main)", time.perf_counter()))
    launches.update(run_telemetry(device))
    marks.append(("phase 38 (telemetry)", time.perf_counter()))
    launches.update(check_trace_windows(device))
    marks.append(("phase 39 (trace-windows)", time.perf_counter()))
    launches.update(run_trace_main(device))
    marks.append(("phase 40 (trace-main)", time.perf_counter()))
    launches.update(run_trace_scenario(device))
    marks.append(("phase 41 (trace-scenario)", time.perf_counter()))
    _, launches["config10"] = count_launches(lambda: run_config10(device))
    marks.append(("phase 42 (config10)", time.perf_counter()))
    c15 = run_config15(device, pooled)
    launches.update(c15["launches"])
    fleet_launches.update(c15["fleet"])
    marks.append(("phase 43 (config15)", time.perf_counter()))
    _, launches["config17"], fleet_launches["config17"] = count_kernel_launches(lambda: run_config17(device))
    marks.append(("phase 44 (config17)", time.perf_counter()))
    mesh_launches, mesh_fleet = run_mesh(device, marks)
    launches.update(mesh_launches)
    fleet_launches.update(mesh_fleet)

    last = t_start
    for what, at in marks:
        phase("time", f"{what}: {at - last:.1f} s")
        last = at
    phase("time", f"command time in all: {time.perf_counter() - t_start:.1f} s")

    k1m = kern[(N_MAIN, 3, 8, 64, 0)]
    ksp = kern[SPARSE_CASE]
    print(json.dumps({"kernels": [{
        "name": "delivery_combine",
        "route": "cuda",
        "source": "scalecube_cluster_tpu_torch/csrc/delivery_combine.cu",
        "replaces": "scalecube_cluster_tpu/ops/pallas_delivery.py:251 and :282",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max([r["max_abs_err"] for r in kern.values()] + [kern_structured["max_abs_err"]]),
        "ms": k1m["ms"],
        "plain_ms": k1m["plain_ms"],
        "bound_ms": k1m["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "at_sparse_widths": {"n": N_SPARSE, "ms": ksp["ms"], "plain_ms": ksp["plain_ms"],
                             "bound_ms": ksp["bound_ms"], "max_abs_err": ksp["max_abs_err"]},
        "at_structured_inv": {"spec": "/".join(STRUCTURED_SPEC.values()), **kern_structured},
    }, fleet_kernel_entry(fleet_kern, fleet_launches)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1,  # the one card the run used
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
