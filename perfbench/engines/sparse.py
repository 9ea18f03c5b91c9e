"""The system under test for a sparse-engine configuration: the port's
``ops/sparse.py`` — its warm start, its batched host mutators
(``crash_rows``, ``join_rows``, ``spread_rumor``) and its fused window
(``run_sparse_ticks_fused``, through ``ops/_tick.py: run_window``) —
driven as the benchmark's requests drive it."""

from __future__ import annotations

import dataclasses

import torch

#: the tick's phase functions, looked up in ``ops/sparse.py`` at call
#: time, which a traced run wraps in labelled ranges
PHASES = ("_fd_phase", "_suspicion_sweep", "_gossip_phase_fused", "_mr_apply", "_sync_phase",
          "_refute_phase", "_rumor_sweeps_fused", "alloc_phase", "state_metrics")
#: the phases whose device span ``gossip_device_ms`` reads
GOSSIP_PHASES = ("_gossip_phase_fused",)
#: the phase whose host time ``sync_host_ms`` reads
SYNC_PHASE = "_sync_phase"

PARAM_KEYS = ("capacity", "fanout", "repeat_mult", "ping_req_k", "fd_every", "sync_every", "suspicion_mult",
              "sweep_every", "sample_tries", "rumor_slots", "mr_slots", "announce_slots", "sync_announce")


def module():
    from scalecube_cluster_tpu_torch.ops import sparse

    return sparse


class Program:
    """One cluster of the port's sparse engine on ``device``."""

    def __init__(self, cfg: dict, device):
        SP = module()
        self.SP = SP
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = SP.SparseParams(**{k: cfg[k] for k in PARAM_KEYS}, seed_rows=tuple(cfg["seed_rows"]))
        self.st = None

    def start(self, n_up: int) -> None:
        self.st = self.SP.init_sparse_state(self.params, n_up, warm=True, uniform_loss=float(self.cfg.get("loss", 0.0)),
                                            device=self.device)

    def prepare(self, act: tuple) -> tuple:
        """An action with its rows on the device (made before the window)."""
        if act[0] in ("crash", "join"):
            return (act[0], torch.as_tensor(act[1], dtype=torch.int64).to(self.device))
        return act

    def apply(self, act: tuple) -> None:
        if act[0] == "crash":
            self.st = self.SP.crash_rows(self.st, act[1])
        elif act[0] == "join":
            self.st = self.SP.join_rows(self.st, act[1], self.params.seed_rows)
        elif act[0] == "rumor":
            self.st = self.SP.spread_rumor(self.st, act[1], act[2])
        else:
            raise ValueError(f"unknown action {act[0]!r}")

    def step(self, gen: torch.Generator, ticks: int) -> dict:
        self.st, ms, _ = self.SP.run_sparse_ticks_fused(self.st, gen, ticks, self.params)
        return ms

    def leaves(self) -> dict:
        return {f.name: getattr(self.st, f.name) for f in dataclasses.fields(self.st)}

    def state_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.leaves().values() if isinstance(v, torch.Tensor))

    def free(self) -> None:
        self.st = None
