"""The system under test for a partial-view configuration: the port's
``ops/pview.py`` — its warm start, the shared batched host mutators
(``crash_rows``, ``spread_rumor``) and its fused window
(``run_pview_ticks_fused``, through ``ops/_tick.py: run_window``) —
driven as the benchmark's requests drive it."""

from __future__ import annotations

import dataclasses

import torch

#: the tick's phase functions, looked up in ``ops/pview.py`` at call time,
#: which a traced run wraps in labelled ranges
PHASES = ("_fd_phase", "_maintenance_sweep", "_gossip_phase_fused", "_sync_phase", "_refute_phase",
          "_rumor_sweeps_fused", "alloc_phase", "state_metrics")
GOSSIP_PHASES = ("_gossip_phase_fused",)
SYNC_PHASE = "_sync_phase"

PARAM_KEYS = ("capacity", "view_slots", "active_slots", "fanout", "repeat_mult", "ping_req_k", "fd_every",
              "sync_every", "suspicion_mult", "sweep_every", "sample_tries", "rumor_slots", "mr_slots",
              "announce_slots", "sync_announce", "seed_sync_every", "apply_slots", "key_dtype")


def module():
    from scalecube_cluster_tpu_torch.ops import pview

    return pview


class Program:
    """One cluster of the port's partial-view engine on ``device``."""

    def __init__(self, cfg: dict, device):
        PV = module()
        self.PV = PV
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = PV.PviewParams(**{k: cfg[k] for k in PARAM_KEYS}, seed_rows=tuple(cfg["seed_rows"]))
        self.st = None

    def start(self, n_up: int) -> None:
        self.st = self.PV.init_pview_state(self.params, n_up, warm=True, uniform_loss=float(self.cfg.get("loss", 0.0)),
                                           device=self.device)

    def prepare(self, act: tuple) -> tuple:
        if act[0] == "crash":
            return (act[0], torch.as_tensor(act[1], dtype=torch.int64).to(self.device))
        if act[0] == "join":
            raise ValueError("no partial-view traffic mix joins members")
        return act

    def apply(self, act: tuple) -> None:
        if act[0] == "crash":
            self.st = self.PV.crash_rows(self.st, act[1])
        elif act[0] == "rumor":
            self.st = self.PV.spread_rumor(self.st, act[1], act[2])
        else:
            raise ValueError(f"unknown action {act[0]!r}")

    def step(self, gen: torch.Generator, ticks: int) -> dict:
        self.st, ms, _ = self.PV.run_pview_ticks_fused(self.st, gen, ticks, self.params)
        return ms

    def leaves(self) -> dict:
        return {f.name: getattr(self.st, f.name) for f in dataclasses.fields(self.st)}

    def state_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.leaves().values() if isinstance(v, torch.Tensor))

    def free(self) -> None:
        self.st = None
