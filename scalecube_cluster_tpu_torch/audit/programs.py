"""The audit matrix: every window the port runs, as a program to witness.

The port's counterpart of the JAX package's ``audit/programs.py``, with
its program names, variants and audit shapes. One :class:`AuditProgram`
is one window the port dispatches — a window builder of the
:class:`..ops.engine_api.EngineOps` descriptor (unarmed, trace-armed,
bridge-watched, strategy-armed, adaptive, fleet, delay-armed fleet,
controller rung, fused, member-mesh sharded) or a telemetry-plane device
step (the ring row and its in-place append) — with the **concrete** small
inputs it runs on (JAX lowers abstract ones; eager torch has no program
until it runs) and the bookkeeping the contract checkers need: which
state leaves the window updates in place (the torch spelling of JAX's
donated arguments), what one copy of the state weighs (per rank when
sharded), and which width makes a dimension "wide".

:meth:`AuditProgram.record` runs the window once under the dispatch
recorder (:mod:`.dispatch_walk`); :meth:`AuditProgram.memory` runs it
again without the recorder and measures its peak live bytes: on the CPU
from ``torch.profiler``'s memory events (every allocation and free of the
CPU allocator, summed in order), on a card from
``torch.cuda.max_memory_allocated``, with the waits of the sync-debug
mode and the delivery kernel's launches.

The start state is busy, so that a window reaches its gated phases: warm,
with two user rumors spread, a row crashed and a row joined, at the tick
before an FD round. Audit-shape precondition (JAX's): every sizing knob
that is NOT the member capacity (rumor/pool/announce slots, trace ring
length and field count, scenarios) is kept STRICTLY below ``capacity``,
so "dim >= capacity" is exactly "capacity-scaled dim" for the wide-plane
checks; :func:`_assert_audit_shape` asserts it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import engine_api
from . import dispatch_walk as W

#: ticks per audited window
DEFAULT_N_TICKS = 4
DEFAULT_CAPACITY = 128
#: sharded runs need capacity % (32 * ranks) == 0 (the word rule)
DEFAULT_SHARDED_CAPACITY = 256
#: the scenario axis of the fleet programs (kept below capacity)
DEFAULT_FLEET_SCENARIOS = 4
#: the seed of every program's draws
SEED = 12

MIB = 1 << 20

VARIANTS = ("unarmed", "traced", "telemetry", "sharded", "strategy", "adaptive", "fleet", "control", "fused",
            "replay", "bridge")


def _tensors_of(obj) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of an argument or result: a tensor, a dataclass of
    tensors (a state, an adaptive plane), a ring (its buffer), or a dict."""
    if isinstance(obj, torch.Tensor):
        return {"": obj}
    if isinstance(obj, dict):
        return {f"[{k!r}]": v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    if dataclasses.is_dataclass(obj):
        return {f".{f.name}": getattr(obj, f.name) for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor)}
    for name in ("buf", "_buf"):  # TraceRing, MetricRing
        if isinstance(getattr(obj, name, None), torch.Tensor):
            return {f".{name}": getattr(obj, name)}
    return {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(*objs) -> int:
    """Bytes of every tensor of ``objs`` (a storage shared by two leaves
    counts once)."""
    seen, total = set(), 0
    for obj in objs:
        for t in _tensors_of(obj).values():
            sid = W.storage_of(t)
            if sid and sid in seen:
                continue
            seen.add(sid)
            total += _nbytes(t)
    return total


@dataclasses.dataclass
class Recording:
    """One run of a program under the recorder, and what the checkers read."""

    rec: W.Recorder
    arg_storages: set
    #: (arg position, path, storage before, storage after, bytes) per in-place leaf
    inplace: List[Tuple[int, str, int, int, int]]
    #: (label, storage, node) per non-state output
    extras: List[Tuple[str, int, int]]
    carry_nodes: set
    ys_nodes: set


@dataclasses.dataclass
class AuditProgram:
    """One window and its audit metadata.

    ``fn(*make_args())`` runs it; ``inplace`` lists ``(arg position, leaf
    names)`` of the in-place leaves (``None``: the argument's own buffer);
    ``outputs(args, out)`` returns ``(objects, extras)``: the state after
    the window (the objects standing for the in-place arguments first, in
    ``inplace``'s order, then any other state) and the non-state outputs
    as ``(label, tensor)`` pairs."""

    name: str  # e.g. "dense/i32/unarmed"
    engine: str
    variant: str
    key_dtype: str
    capacity: int
    n_ticks: int
    fn: Callable
    make_args: Callable
    inplace: Tuple[Tuple[int, Optional[Tuple[str, ...]]], ...]
    outputs: Callable
    contracts: engine_api.EngineContracts
    budget_basis_bytes: int
    wide_threshold: int
    is_window: bool = True
    mesh_size: int = 1
    device: str = "cuda"

    _recording: Optional[Recording] = None
    _memory: Optional[Dict] = None

    # -- the in-place leaves -------------------------------------------------
    def _inplace_leaves(self, args) -> List[Tuple[int, str, torch.Tensor]]:
        out = []
        for pos, names in self.inplace:
            leaves = _tensors_of(args[pos])
            if names is not None:
                leaves = {f".{k}": leaves[f".{k}"] for k in names if f".{k}" in leaves}
            out += [(pos, f"arg{pos}{path}", t) for path, t in leaves.items()]
        return out

    def donated_leaf_info(self) -> List[Tuple[int, str, int]]:
        """(arg position, leaf path, bytes) of every in-place leaf."""
        rec = self.record()
        return [(pos, path, nbytes) for pos, path, _, _, nbytes in rec.inplace]

    # -- runs ------------------------------------------------------------------------
    def record(self) -> Recording:
        """The window run once under the recorder (cached)."""
        if self._recording is None:
            self._recording = self._run()
        return self._recording

    def _run(self) -> Recording:
        args = self.make_args()
        leaves = self._inplace_leaves(args)
        arg_storages = {W.storage_of(t) for a in args for t in _tensors_of(a).values()}
        with W.Recorder() as rec:
            out = self.fn(*args)
        objects, extras = self.outputs(args, out)
        after = {f"arg{pos}{path}": W.storage_of(t)
                 for (pos, _), obj in zip(self.inplace, objects) for path, t in _tensors_of(obj).items()}
        inplace = [(pos, path, W.storage_of(t), after.get(path, 0), _nbytes(t)) for pos, path, t in leaves]
        carry = {rec.current(t) for obj in objects for t in _tensors_of(obj).values()}
        ys = [(label, W.storage_of(t), rec.current(t)) for label, t in extras]
        return Recording(rec, arg_storages, inplace, ys, carry, {n for _, _, n in ys})

    def memory(self) -> Dict:
        """The window's peak live bytes: its inputs plus the peak above the
        pre-window baseline (JAX's ``memory_analysis`` counts its arguments
        too), beside the budget, from a second run without the recorder: on
        the CPU the profiler's memory events; on a card
        ``max_memory_allocated``, the sync-debug waits and their sites, and
        the delivery kernel's launches (cached)."""
        if self._memory is None:
            if torch.device(self.device).type == "cpu":
                self._memory = self._measure_cpu()
            else:
                self._memory = self._measure_cuda()
        self._memory["budget_bytes"] = budget_bytes(self)
        return self._memory

    def _measure_cpu(self) -> Dict:
        args = self.make_args()
        arg_bytes = tree_bytes(*args)
        prof = _cpu_memory_profile()
        with prof:
            out = self.fn(*args)
        del out, args
        return _memory_dict(arg_bytes, _cpu_peak(prof), "torch.profiler memory events (CPU run)")

    def _measure_cuda(self) -> Dict:
        import warnings

        from ..ops import delivery

        args = self.make_args()
        arg_bytes = tree_bytes(*args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launches = (delivery.delivery_combine.launches, delivery.delivery_combine_fleet.launches)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = self.fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        waits = [f"{W._rel(w.filename)}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]
        del out, args
        mem = _memory_dict(arg_bytes, peak, "torch.cuda.max_memory_allocated")
        mem.update(device_waits=len(waits), wait_sites=sorted(set(waits)),
                   kernel_launches=delivery.delivery_combine.launches - launches[0],
                   fleet_kernel_launches=delivery.delivery_combine_fleet.launches - launches[1])
        return mem


def _memory_dict(arg_bytes: int, peak_above: int, instrument: str) -> Dict:
    return {
        "argument_size_in_bytes": int(arg_bytes),
        "peak_above_baseline_bytes": int(max(0, peak_above)),
        "peak_live_bytes": int(arg_bytes + max(0, peak_above)),
        "instrument": instrument,
    }


def check_instruments(device) -> str:
    """Prove the memory and wait instruments of ``device`` live before any
    program is judged by them (an instrument that reads nothing would pass
    every budget): a 1 MiB allocation must show in the memory reading, and
    on a card a ``.item()`` must show as one wait of the sync-debug mode.
    Returns the instrument's name; raises when one is not live."""
    import warnings

    dev = torch.device(device)
    if dev.type == "cpu":
        prof = _cpu_memory_profile()
        with prof:
            probe = torch.empty(MIB, dtype=torch.uint8)
            del probe
        if _cpu_peak(prof) < MIB:
            raise RuntimeError("torch.profiler recorded no 1 MiB CPU allocation: the CPU memory instrument is "
                               "not live")
        return "torch.profiler memory events (CPU run)"
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    probe = torch.empty(MIB, dtype=torch.uint8, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe[:1].sum().item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    del probe
    if torch.cuda.max_memory_allocated(dev) - base < MIB:
        raise RuntimeError("max_memory_allocated missed a 1 MiB allocation: the card's memory instrument is not "
                           "live")
    if sum("called a synchronizing" in str(w.message) for w in caught) != 1:
        raise RuntimeError("the sync-debug mode did not count one .item() as one wait: the card's wait "
                           "instrument is not live")
    return "torch.cuda.max_memory_allocated"


def budget_bytes(prog: AuditProgram) -> int:
    """``memory_factor x budget basis + overhead``, the window's budget."""
    c = prog.contracts
    return int(c.memory_factor * prog.budget_basis_bytes + c.memory_overhead_mib * MIB)


def _cpu_memory_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU], profile_memory=True)


def _cpu_peak(prof) -> int:
    """The peak of the CPU allocator's live bytes above where the profile
    started: its memory events (allocations positive, frees negative)
    summed in time order."""
    events = sorted((e.start_ns(), e.nbytes()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "[memory]" and e.device_type() == torch.autograd.DeviceType.CPU)
    live = peak = 0
    for _, nbytes in events:
        live += nbytes
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------------------------
# audit shapes and start states
# ---------------------------------------------------------------------------


def _assert_audit_shape(name: str, capacity: int, sizes: Dict[str, int]) -> None:
    """The precondition that makes ``dim >= capacity`` mean
    ``capacity-scaled``: every non-capacity sizing knob strictly below
    capacity."""
    offenders = {k: v for k, v in sizes.items() if v >= capacity}
    if offenders:
        raise ValueError(
            f"audit matrix misconfigured for {name}: non-capacity dims {offenders} are >= capacity {capacity}, "
            "so the wide-plane checks could not tell pools from planes — shrink the knobs or raise --capacity")


def _audit_params(engine: str, capacity: int, key_dtype: str):
    """Small-but-real protocol params for the audit shapes (JAX's): bounded
    pools sized strictly below capacity."""
    if engine == "dense":
        from ..ops.state import SimParams

        p = SimParams(capacity=capacity, rumor_slots=16, key_dtype=key_dtype)
        sizes = {"rumor_slots": p.rumor_slots}
    elif engine == "sparse":
        from ..ops.sparse import SparseParams

        p = SparseParams(capacity=capacity, rumor_slots=16, mr_slots=capacity // 2, announce_slots=32)
        sizes = {"rumor_slots": p.rumor_slots, "mr_slots": p.mr_slots, "announce_slots": p.announce_slots}
    elif engine == "pview":
        from ..ops.pview import PviewParams

        p = PviewParams(capacity=capacity, rumor_slots=16, mr_slots=capacity // 2, announce_slots=32,
                        key_dtype=key_dtype)
        sizes = {"rumor_slots": p.rumor_slots, "mr_slots": p.mr_pool, "announce_slots": p.announce_slots,
                 "view_slots": p.view_slots}
    else:
        raise ValueError(f"unknown engine {engine!r}")
    _assert_audit_shape(f"{engine}/{key_dtype}", capacity, sizes)
    return p


def _trace_spec(capacity: int):
    from ..trace.schema import TraceSpec

    spec = TraceSpec(tracer_rows=(1, 2), rumor_slots=(0,), ring_len=64)
    _assert_audit_shape("trace", capacity, {"ring_len": spec.ring_len, "n_fields": spec.n_fields})
    return spec


def _n_initial(capacity: int) -> int:
    return max(2, (capacity * 3) // 4)


def start_state(eng, params, device, crash: int = 7):
    """The busy start state of every program (see the module docstring):
    ``n_initial`` warm members, user rumors 0 and 1 spread from rows 3 and
    5, row ``crash`` crashed, row ``n_initial`` joined, at the tick before
    an FD round."""
    n0 = _n_initial(params.capacity)
    st = eng.init_state(params, n0, True, eng.dense_links_default, device)
    st = eng.ops.spread_rumor(st, 0, 3)
    st = eng.ops.spread_rumor(st, 1, 5)
    st = eng.ops.crash_row(st, crash)
    st = eng.ops.join_row(st, n0, (0,))
    return st.replace(tick=max(0, params.fd_every - 2))


def _gen(device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    return g


def _fleet(eng, params, device, s: int = DEFAULT_FLEET_SCENARIOS):
    """S busy start states stacked to a fleet, each with its own crash."""
    from ..ops.fleet import fleet_stack

    return fleet_stack([start_state(eng, params, device, crash=7 + i) for i in range(s)])


def _fleet_contracts(contracts):
    """Fleets hold the budget per scenario x S with the engine's
    ``fleet_memory_factor`` when it declares one."""
    if contracts.fleet_memory_factor is None:
        return contracts
    return dataclasses.replace(contracts, memory_factor=contracts.fleet_memory_factor)


def _no_quiet_gates(params):
    """The fleet profile of ``params``: the quiet gates off where the engine
    has them (every production fleet runs so, as JAX audits it)."""
    if hasattr(params, "quiet_gates"):
        return dataclasses.replace(params, quiet_gates=False)
    return params


# -- output conventions -------------------------------------------------------------


def _window_out(args, out):
    """``run(state, ...) -> (state, ms, watched)``."""
    state, ms, watched = out
    return (state,), _extras(ms, watched)


def _traced_out(args, out):
    """``run(state, ring, draws) -> (state, ms, watched)``, the ring in place."""
    state, ms, watched = out
    return (state, args[1]), _extras(ms, watched)


def _adaptive_out(args, out):
    """``run(state, ad, ...) -> (state, ad, ms, watched)``."""
    state, ad, ms, watched = out
    return (state, ad), _extras(ms, watched)


def _extras(ms, watched) -> list:
    out = [(f"metric {k}", v) for k, v in ms.items()]
    if watched is not None:
        out.append(("watched rows", watched))
    return out


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


def build_engine_programs(
    engine_name: str,
    capacity: int = DEFAULT_CAPACITY,
    n_ticks: int = DEFAULT_N_TICKS,
    key_dtypes: Optional[Sequence[str]] = None,
    variants: Optional[Sequence[str]] = None,
    sharded_capacity: int = DEFAULT_SHARDED_CAPACITY,
    device="cuda",
    mesh=None,
) -> List[AuditProgram]:
    """The audit programs of one engine (JAX's names and variants): for each
    registered key dtype the unarmed, replay and fused windows, for the
    primary (i32) one the trace-armed, bridge, telemetry, strategy,
    adaptive, fleet, fused-adaptive and fused-fleet programs (and
    ``fused-pallas`` on pview, ``control-<rung>`` on dense), and where the
    engine runs on a member mesh and ``mesh`` is given, the sharded
    programs on it. ``variants`` filters (:data:`VARIANTS`)."""
    eng = engine_api.engine(engine_name)
    contracts = eng.contracts
    dtypes = tuple(key_dtypes) if key_dtypes else contracts.key_dtypes
    want = set(variants) if variants else set(VARIANTS)
    dev = torch.device(device)
    programs: List[AuditProgram] = []

    def add(name, variant, kd, fn, make_args, inplace, outputs, basis, contracts=contracts, is_window=True,
            cap=capacity, mesh_size=1):
        programs.append(AuditProgram(
            name=f"{engine_name}/{kd}/{name}", engine=engine_name, variant=variant, key_dtype=kd,
            capacity=cap, n_ticks=n_ticks, fn=fn, make_args=make_args, inplace=inplace, outputs=outputs,
            contracts=contracts, budget_basis_bytes=basis, wide_threshold=cap, is_window=is_window,
            mesh_size=mesh_size, device=str(dev),
        ))

    state_leaves = ((0, eng.inplace_leaves),)
    for kd in dtypes:
        params = _audit_params(engine_name, capacity, kd)
        st0 = start_state(eng, params, dev)
        state_bytes = tree_bytes(st0)
        first = kd == dtypes[0]

        def serial_args(p=params):
            return (start_state(eng, p, dev), _gen(dev))

        if "unarmed" in want:
            add("unarmed", "unarmed", kd, eng.make_run(params, n_ticks), serial_args, state_leaves, _window_out,
                state_bytes)

        if first and "traced" in want:
            from ..trace.rings import TraceRing

            spec = _trace_spec(capacity)
            ring_bytes = TraceRing(spec, device="meta").buf.numel() * 4
            add("traced", "traced", kd, eng.make_traced_run(params, n_ticks, spec),
                lambda spec=spec, p=params: (start_state(eng, p, dev), TraceRing(spec, device=dev), _gen(dev)),
                state_leaves + ((1, None),), _traced_out, state_bytes + ring_bytes)

        if first and "bridge" in want:
            # the window the driver runs while bridge endpoints hold watches
            # (watch_rows live). The wide-plane engines waive only the
            # materialization check, as JAX does: the view_key[watch_rows]
            # gather IS the price a watch costs (the seeded violation of
            # tests/test_torch_audit.py); pview synthesizes its rows from
            # O(N·k) state, so every check stays live there.
            w_bridge = 3
            _assert_audit_shape(f"{engine_name}/{kd}/bridge", capacity, {"bridged_rows": w_bridge})
            run = eng.make_run(params, n_ticks)
            vk = getattr(st0, "view_key", None)
            itemsize = vk.element_size() if vk is not None else 4
            bridge_contracts = contracts
            if not contracts.forbid_wide_values:
                bridge_contracts = dataclasses.replace(contracts, no_plane_materialization=False)
            add("bridge", "bridge", kd, lambda state, gen, w, _run=run: _run(state, gen, watch_rows=w),
                lambda sa=serial_args: (*sa(), torch.tensor([1, 2, 9], dtype=torch.int64, device=dev)),
                state_leaves, _window_out, state_bytes + n_ticks * w_bridge * capacity * itemsize,
                contracts=bridge_contracts)

        if first and "telemetry" in want:
            programs.extend(_telemetry_programs(eng, params, dev, capacity, n_ticks, contracts, state_bytes))

        if first and "strategy" in want:
            from ..dissemination import DissemSpec

            for strat, topo in contracts.strategy_variants:
                sp = dataclasses.replace(params, dissem=DissemSpec(strategy=strat, topology=topo))
                add(f"strategy-{strat}-{topo}", "strategy", kd, eng.make_run(sp, n_ticks),
                    lambda sa=serial_args, sp=sp: sa(sp), state_leaves, _window_out, state_bytes)

        if first and "adaptive" in want:
            from ..adaptive import AdaptiveSpec, init_adaptive_state

            ap = dataclasses.replace(params, adaptive=AdaptiveSpec(enabled=True))
            ad_bytes = tree_bytes(init_adaptive_state(capacity, device="cpu"))
            add("adaptive", "adaptive", kd, eng.make_adaptive_run(ap, n_ticks),
                lambda ap=ap: (start_state(eng, ap, dev), init_adaptive_state(capacity, device=dev), _gen(dev)),
                state_leaves, _adaptive_out, state_bytes + ad_bytes)

        if first and "fleet" in want:
            s_fleet = DEFAULT_FLEET_SCENARIOS
            _assert_audit_shape(f"{engine_name}/{kd}/fleet", capacity, {"fleet_scenarios": s_fleet})
            fp = _no_quiet_gates(params)
            add("fleet", "fleet", kd, eng.make_fleet_run(fp, n_ticks),
                lambda fp=fp: (_fleet(eng, fp, dev), _gen(dev)), state_leaves, _window_out,
                s_fleet * state_bytes, contracts=_fleet_contracts(contracts))

        if "replay" in want:
            # the incident-replay fleet: delay rings armed, quiet gates off
            s_fleet = DEFAULT_FLEET_SCENARIOS
            rp = _no_quiet_gates(dataclasses.replace(params, delay_slots=2))
            replay_bytes = tree_bytes(start_state(eng, rp, dev))
            add("replay", "replay", kd, eng.make_fleet_run(rp, n_ticks),
                lambda rp=rp: (_fleet(eng, rp, dev), _gen(dev)), state_leaves, _window_out,
                s_fleet * replay_bytes, contracts=_fleet_contracts(contracts))

        if "fused" in want:
            add("fused", "fused", kd, eng.make_fused_run(params, n_ticks), serial_args, state_leaves,
                _window_out, state_bytes)

        if first and "fused" in want and engine_name == "pview":
            # the delivery-kernel arm: on a card the fused window launches
            # csrc/delivery_combine.cu, on the CPU its plain version
            add("fused-pallas", "fused", kd, eng.make_fused_run(params, n_ticks), serial_args, state_leaves,
                _window_out, state_bytes)

        if first and "fused" in want:
            from ..adaptive import AdaptiveSpec, init_adaptive_state

            ap = dataclasses.replace(params, adaptive=AdaptiveSpec(enabled=True))
            ad_bytes = tree_bytes(init_adaptive_state(capacity, device="cpu"))
            add("fused-adaptive", "fused", kd, eng.make_fused_adaptive_run(ap, n_ticks),
                lambda ap=ap: (start_state(eng, ap, dev), init_adaptive_state(capacity, device=dev), _gen(dev)),
                state_leaves, _adaptive_out, state_bytes + ad_bytes)
            s_fleet = DEFAULT_FLEET_SCENARIOS
            _assert_audit_shape(f"{engine_name}/{kd}/fused-fleet", capacity, {"fleet_scenarios": s_fleet})
            fp = _no_quiet_gates(params)
            add("fused-fleet", "fused", kd, eng.make_fused_fleet_run(fp, n_ticks),
                lambda fp=fp: (_fleet(eng, fp, dev), _gen(dev)), state_leaves, _window_out,
                s_fleet * state_bytes, contracts=_fleet_contracts(contracts))

        if first and "control" in want and engine_name == "dense":
            programs.extend(_control_programs(eng, kd, dev, capacity, n_ticks, contracts))

        if "sharded" in want and eng.supports_mesh and mesh is not None:
            programs.extend(_sharded_programs(eng, kd, dev, sharded_capacity, n_ticks, contracts, mesh,
                                              first=first))

    return programs


def _control_programs(eng, kd, dev, capacity, n_ticks, contracts) -> List[AuditProgram]:
    """The controller's epoch programs: the fleet window of every rung of
    ``ControlSpec().ladder`` (the adaptive rungs with the fleet's adaptive
    plane), the programs a controller swaps between."""
    from ..adaptive import init_adaptive_state
    from ..control import ControlSpec, _fleet_params
    from ..ops.fleet import fleet_stack

    spec = ControlSpec()
    s_fleet = DEFAULT_FLEET_SCENARIOS
    out = []
    for rung in spec.ladder:
        rp = _fleet_params(capacity, rung, spec)
        _assert_audit_shape(f"dense/{kd}/control-{rung.name}", capacity,
                            {"rumor_slots": rp.rumor_slots, "fleet_scenarios": s_fleet})
        basis = s_fleet * tree_bytes(start_state(eng, rp, dev))
        if rung.adaptive:
            basis += s_fleet * tree_bytes(init_adaptive_state(capacity, device="cpu"))
            fn = eng.make_fleet_adaptive_run(rp, n_ticks)

            def make_args(rp=rp):
                ad = fleet_stack([init_adaptive_state(capacity, device=dev) for _ in range(s_fleet)])
                return _fleet(eng, rp, dev), ad, _gen(dev)

            outputs = _adaptive_out
        else:
            fn = eng.make_fleet_run(rp, n_ticks)
            make_args = lambda rp=rp: (_fleet(eng, rp, dev), _gen(dev))  # noqa: E731
            outputs = _window_out
        out.append(AuditProgram(
            name=f"dense/{kd}/control-{rung.name}", engine="dense", variant="control", key_dtype=kd,
            capacity=capacity, n_ticks=n_ticks, fn=fn, make_args=make_args, inplace=((0, eng.inplace_leaves),),
            outputs=outputs, contracts=_fleet_contracts(contracts), budget_basis_bytes=basis,
            wide_threshold=capacity, device=str(dev),
        ))
    return out


def _telemetry_programs(eng, params, dev, capacity, n_ticks, contracts, state_bytes) -> List[AuditProgram]:
    """What arming the telemetry plane adds to a window: the ring row (the
    engine's ``telemetry_window_vector`` and the sentinel columns, the
    plane's own :func:`..telemetry.plane.window_row`) and the ring's
    in-place append. The armed window itself is the unarmed one."""
    from ..telemetry.plane import SENTINEL_SERIES, window_row
    from ..telemetry.rings import MetricRing

    run = eng.make_run(params, n_ticks)
    names = tuple(eng.telemetry_series) + SENTINEL_SERIES
    ring_len = 64
    _assert_audit_shape(f"{eng.name}/telemetry", capacity, {"ring_len": ring_len, "n_series": len(names)})

    def row_args():
        st, ms, _ = run(start_state(eng, params, dev), _gen(dev))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return ms, st, zero, zero

    ms_bytes = tree_bytes(row_args()[0])

    def row_fn(ms, state, false_dead, key_regr):
        return window_row(eng.telemetry_window_vector, ms, state, false_dead, key_regr)

    def append_args():
        return MetricRing(names, ring_len, device=dev), torch.ones((len(names),), dtype=torch.float32, device=dev)

    def append(ring, row):
        ring.append(row)

    common = dict(engine=eng.name, key_dtype="i32", capacity=capacity, n_ticks=n_ticks, contracts=contracts,
                  wide_threshold=capacity, is_window=False, device=str(dev))
    return [
        AuditProgram(name=f"{eng.name}/i32/telemetry-row", variant="telemetry-row", fn=row_fn,
                     make_args=row_args, inplace=(), outputs=lambda args, out: ((), [("ring row", out)]),
                     budget_basis_bytes=state_bytes + ms_bytes, **common),
        AuditProgram(name=f"{eng.name}/i32/telemetry-append", variant="telemetry-append", fn=append,
                     make_args=append_args, inplace=((0, None),), outputs=lambda args, out: ((args[0],), []),
                     budget_basis_bytes=ring_len * len(names) * 4, **common),
    ]


def _sharded_programs(eng, kd, dev, capacity, n_ticks, contracts, mesh, first: bool) -> List[AuditProgram]:
    """The member-mesh programs of an engine on ``mesh`` (this rank's
    view), as JAX registers them: the sharded window for every key dtype
    and, for the primary dtype, the sharded telemetry row and append; for
    pview also the window's fused name, the fleet on the 2-D scenarios x
    members mesh (two ranks or more) and the gossip phase the mesh
    profiler times. Budgets are per rank."""
    from ..ops import sharding as SH
    from ..ops.fleet import fleet_stack
    from ..telemetry.plane import SENTINEL_SERIES, window_row
    from ..telemetry.rings import MetricRing

    name = eng.name
    params = _audit_params(name, capacity, kd)
    world = SH.member_mesh_size(mesh)

    def shard(p=params):
        return eng.shard_state(start_state(eng, p, "cpu"), mesh)

    shard_bytes = tree_bytes(shard())
    leaves = ((0, eng.inplace_leaves),)
    out = []

    def add(suffix, fn, make_args, inplace, outputs, basis, contracts=contracts, is_window=True, mesh_size=world):
        out.append(AuditProgram(
            name=f"{name}/{kd}/{suffix}", engine=name, variant="sharded", key_dtype=kd, capacity=capacity,
            n_ticks=n_ticks, fn=fn, make_args=make_args, inplace=inplace, outputs=outputs, contracts=contracts,
            budget_basis_bytes=basis, wide_threshold=capacity, is_window=is_window, mesh_size=mesh_size,
            device=str(dev)))

    pview = name == "pview"
    sharded_run = eng.make_sharded_run(mesh, params, n_ticks)
    add("sharded", sharded_run, lambda: (shard(), _gen(dev)), leaves, _window_out, shard_bytes)
    if pview:
        add("sharded-fused", eng.make_sharded_fused_run(mesh, params, n_ticks), lambda: (shard(), _gen(dev)),
            leaves, _window_out, shard_bytes)
    if not first:
        return out

    if pview and world >= 2:
        s_sc = 2
        _assert_audit_shape(f"{name}/{kd}/sharded-mesh2d", capacity, {"fleet_scenarios": s_sc})
        mesh2d = SH.make_pview_mesh2d(s_sc, dev.type)

        def fleet_block():
            host = fleet_stack([start_state(eng, params, "cpu", crash=7 + i) for i in range(s_sc)])
            return SH.shard_pview_fleet(host, mesh2d)

        add("sharded-mesh2d", eng.make_sharded_fleet_run(mesh2d, params, n_ticks),
            lambda: (fleet_block(), _gen(dev)), leaves, _window_out, tree_bytes(fleet_block()),
            contracts=_fleet_contracts(contracts), mesh_size=world)

    names = tuple(eng.telemetry_series) + SENTINEL_SERIES
    row = SH.make_sharded_telemetry_row(mesh, lambda ms, st, fd, kr: window_row(eng.telemetry_window_vector, ms,
                                                                                 st, fd, kr))

    def row_args():
        st, ms, _ = sharded_run(shard(), _gen(dev))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return ms, st, zero, zero

    add("sharded-telemetry-row", row, row_args, (), lambda args, o: ((), [("ring row", o)]),
        shard_bytes + tree_bytes(row_args()[0]), is_window=False)
    append = eng.make_sharded_telemetry_append(mesh)
    add("sharded-telemetry-append", append,
        lambda: (MetricRing(names, 64, device=dev), torch.ones((len(names),), dtype=torch.float32, device=dev)),
        ((0, None),), lambda args, o: ((args[0],), []), 64 * len(names) * 4, is_window=False)
    if not pview:
        return out

    def gossip(state, rd):
        from ..ops import pview as PV

        with SH.ragged_delivery_context(mesh, params.capacity):
            ctx = SH.active()
            ctx.begin_tick(None, rd)
            return PV._gossip_phase_fused(state, ctx.local_draws(rd), params)

    def gossip_args():
        from ..ops.rand import draw_sparse_tick

        return shard(), draw_sparse_tick(_gen(dev), params, False)[1]

    add("sharded-profile-gossip", gossip, gossip_args, (),
        lambda args, o: ((o[0],), [(f"metric {k}", v) for k, v in o[1].items()]), shard_bytes, is_window=False)
    return out


def build_matrix(
    engines: Optional[Sequence[str]] = None,
    capacity: int = DEFAULT_CAPACITY,
    n_ticks: int = DEFAULT_N_TICKS,
    variants: Optional[Sequence[str]] = None,
    sharded_capacity: int = DEFAULT_SHARDED_CAPACITY,
    device="cuda",
    mesh=None,
) -> List[AuditProgram]:
    """The full engine x key-dtype x variant audit matrix (the sharded
    programs on ``mesh``, when given)."""
    out: List[AuditProgram] = []
    for name in engines or ("dense", "sparse", "pview"):
        out.extend(build_engine_programs(name, capacity=capacity, n_ticks=n_ticks, variants=variants,
                                         sharded_capacity=sharded_capacity, device=device, mesh=mesh))
    return out
