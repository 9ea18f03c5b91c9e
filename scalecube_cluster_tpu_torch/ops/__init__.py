"""The vectorized SWIM tick in PyTorch.

* :mod:`lattice`    — the packed monotone precedence key (i32 / i16 layouts).
* :mod:`state`      — the dense engine's params, state, initial state and
  host mutators; the constants the engines share, the namespace tables.
* :mod:`kernel`     — the dense engine's tick (with the delay rings) and
  window runner.
* :mod:`bitplane`   — bool ⇄ 32-bit word packing and SWAR popcount.
* :mod:`rand`       — the stateless fetch hash and the per-tick draw layout.
* :mod:`delivery`   — the gossip delivery combine: CUDA kernel + plain version.
* :mod:`pool`       — the bounded membership-rumor pool (allocation phase).
* :mod:`_tick`      — helpers the pview and sparse tick phases share, and
  the window loop of all three engines.
* :mod:`pview`      — the partial-view engine: state, host seams, tick,
  window runner.
* :mod:`sparse`     — the sparse (record-queue) engine: the same parts over
  one [N, N] view plane.
* :mod:`engine_api` — the engine descriptor the driver resolves through,
  and the view-plane seams dense and sparse share.
* :mod:`fleet`      — the fleet engine: S clusters per window (each engine's
  tick under ``torch.func.vmap``), the batched chaos timeline and the Monte
  Carlo folds; its scenario mesh.
* :mod:`dcn`        — process groups (NCCL on the card, gloo on the CPU)
  and the member mesh over them; the local lane of spawned ranks.
* :mod:`sharding`   — the pview engine on a member mesh: each rank's rows,
  the tick's collectives, the sharded windows.
* :mod:`ragged_a2a` — the sharded delivery: the bucketed record exchange
  and the rank-local election.
"""
