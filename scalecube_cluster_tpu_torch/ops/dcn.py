"""Process groups: the simulation spanning processes and devices.

A port of the JAX package's ``ops/dcn.py`` onto ``torch.distributed``.
Every process runs the same program on the same inputs (SPMD) and holds its
own rows of the member axis (:mod:`.sharding`); the collectives go through
one process group: gloo for CPU tensors, NCCL for CUDA tensors.

Usage (one process per device)::

    from scalecube_cluster_tpu_torch.ops import dcn, sharding
    dcn.initialize("file:///shared/pg-init", num_processes=4, process_id=rank)
    mesh = dcn.global_mesh()                       # "members", on the cards
    params = PviewParams(capacity=N, ...)
    state = dcn.make_global_pview_state(params, N, mesh)
    run = sharding.make_sharded_pview_run(mesh, params, n_ticks=100)
    state, metrics, _ = run(state, torch.Generator("cuda").manual_seed(0))

:class:`LocalWorld` starts W such processes on this host (``LocalWorld(W,
"cpu")`` is the CPU lane the tests use: gloo, one thread each) and runs a
function on every rank.

The dense engine's ``make_global_state`` is not ported yet (ROADMAP A12
item 5).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import traceback
from typing import Optional

import torch
import torch.distributed as dist

#: how long a collective may wait for its peers before the group fails it
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    **kwargs,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address`` is an init method (``file://...``,
    ``tcp://host:port``) or a bare ``host:port``; the arguments fall back
    to the ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    environment. ``device`` picks the backend: NCCL for ``"cuda"`` (the
    default, with this rank's card set as the group's device), gloo for
    ``"cpu"``. A no-op when the group is already up."""
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = "env://"
    elif "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dev = torch.device(device)
    kw = {"timeout": TIMEOUT, **kwargs}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", process_id)) % max(
            1, torch.cuda.device_count())
        torch.cuda.set_device(index)
        kw.setdefault("device_id", torch.device("cuda", index))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id, **kw)


def cpu_collectives_available() -> bool:
    """Whether this torch build can run collectives over CPU tensors across
    processes (gloo)."""
    return dist.is_available() and dist.is_gloo_available()


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process in the group; (0, 1) outside one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


_MESHES: dict = {}


def global_mesh(device="cuda"):
    """One ``"members"`` mesh over every process of the group, on
    ``device``'s type (made once per device type)."""
    from .sharding import make_mesh

    kind = torch.device(device).type
    key = (kind, dist.get_world_size())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(kind)
    return _MESHES[key]


def make_global_pview_state(params, n_initial: int, mesh, **init_kwargs):
    """The initial ``PviewState`` on a mesh: every process builds the same
    host init (O(N·k), on the CPU) and moves only its own rows onto its
    device (:func:`.sharding.shard_pview_state`)."""
    from .pview import init_pview_state
    from .sharding import shard_pview_state

    host = init_pview_state(params, n_initial, device="cpu", **init_kwargs)
    return shard_pview_state(host, mesh)


def make_global_state(params, n_initial: int, mesh, **init_kwargs):
    """Refused: the dense engine on a mesh is not ported yet."""
    raise NotImplementedError("make_global_state (the dense engine on a mesh) is not ported yet (ROADMAP A12 "
                              "item 5)")


# ---------------------------------------------------------------------------
# the local lane: W processes on this host
# ---------------------------------------------------------------------------


def _serve(rank: int, world: int, init_file: str, device: str, tasks, results) -> None:
    torch.set_num_threads(1)
    try:
        initialize(f"file://{init_file}", world, rank, device=device)
    except Exception:  # report, then leave: the parent fails the lane
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except Exception:  # the call fails, the rank serves on
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class LocalWorld:
    """W processes on this host, each a rank of one process group (NCCL for
    ``device="cuda"``, the default as for every entry point of the port;
    gloo for ``"cpu"``, the tests' lane), serving calls until closed.

    :meth:`run` calls ``fn(*args)`` on every rank and returns the W results
    in rank order; ``fn`` must be importable by name (a module-level
    function). A rank that raises fails the call with its traceback."""

    def __init__(self, world: int, device: str = "cuda", timeout: float = 600.0):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.world = int(world)
        self.timeout = timeout
        self._dir = tempfile.mkdtemp(prefix="pg-")
        init_file = os.path.join(self._dir, "init")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_serve, args=(r, self.world, init_file, device, self._tasks[r], self._results),
                        daemon=True)
            for r in range(self.world)
        ]
        for p in self._procs:
            p.start()
        try:
            self._collect("start")
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str) -> list:
        import queue

        out: list = [None] * self.world
        errors = []
        for _ in range(self.world):
            # once a rank failed, the others may wait in a collective for it
            wait = self.timeout if not errors else 10.0
            try:
                rank, ok, value = self._results.get(timeout=wait)
            except queue.Empty:
                if errors:
                    break
                raise TimeoutError(f"LocalWorld: {what} timed out after {self.timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"LocalWorld: {what} failed\n" + "\n".join(errors))
        return out

    def run(self, fn, *args, **kwargs) -> list:
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "call"))

    def close(self) -> None:
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        import shutil

        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
