"""Static dissemination-strategy spec (r13): a copy of the JAX package's
``dissemination/spec.py`` (it imports no JAX), so that the port's params
carry their own ``DissemSpec``.

One frozen, hashable dataclass describes WHICH gossip strategy the tick's
dissemination phase runs and ON WHAT overlay topology the fanout peers are
drawn — it rides every engine's static params object (``SimParams`` /
``SparseParams`` / ``PviewParams``), so the strategy is a compile-time
property of the window program: the default spec traces the byte-identical
program the repo has always shipped, and a non-default spec swaps ONLY the
gossip phase's peer selection / payload policy (FD probes and SYNC
anti-entropy keep the reference's uniform semantics untouched).

Strategies (PAPERS.md upgrades over uniform-random push):

* ``push`` — the shipped default: every sender pushes its payload to
  ``fanout`` peers per tick. On ``full`` it keeps the engine's own
  live-view sampler (bit-identical legacy program); on a structured
  topology the peers are random chords of the overlay.
* ``push_pull`` — push plus a pull reply: a peer that receives a payload-
  bearing message answers the same round trip with ITS young records and
  rumors (the anti-entropy phase of Karp et al.'s push-pull; referenced by
  arXiv:1504.03277 §1). Replies ride undelayed contacts only and share
  the established round trip (deviation DZ-2, see strategies.py).
* ``pipelined`` — pipelined gossip (arXiv:1504.03277): deterministic
  round-robin rotation over the topology's chord set plus a per-message
  USER-RUMOR budget of ``pipeline_budget`` slots selected by a rotating
  window — concurrent rumors share the wire in a pipeline instead of
  competing, which is the paper's steady-state-rate claim. Membership
  dissemination (failure-detection plumbing) is never throttled.
* ``accelerated`` — topology-structured deterministic schedule
  (arXiv:1805.08531's lesson transplanted to rumor spreading: exploit the
  graph's structure with a fixed polynomial-style iteration instead of
  uniform randomness; the rumor-spreading analogue is the doubling-chord
  schedule of randomness-efficient spreading, arXiv:1311.2839): each tick
  sends along ``fanout`` consecutive chords of the ascending chord set,
  advancing one chord per tick — on geometric chord sets the infected
  interval doubles per covered chord, giving a DETERMINISTIC O(log N)
  bound.
* ``tuneable`` — the robust/tuneable gossip family (arXiv:1506.02288,
  "A Robust and Tuneable Family of Gossiping Algorithms"): each send
  follows the deterministic doubling walk with probability
  ``tuneable_mix`` and an independently drawn uniform chord otherwise —
  one knob trades the deterministic schedule's speed against the
  randomized family's robustness to adversarial loss/crashes (the paper's
  interpolation, transplanted to circulant chord selection). ``mix=1``
  degenerates to the accelerated walk, ``mix=0`` to uniform random
  chords; both halves consume the SAME per-slot uniform (the decision's
  residual rescales into the random chord draw), so the engine draw
  stream is untouched.

Topologies (circulant overlays — every neighbor is ``(i + chord) mod N``,
so pview never materializes an [N, N] adjacency and even the dense engine
pays only O(N·fanout) selection work):

* ``full`` — no overlay constraint (uniform strategies use the live-view
  sampler; deterministic strategies synthesize a doubling chord set — a
  virtual hypercube).
* ``ring`` — chords {1, N-1}: the linear-diameter worst case.
* ``torus`` — chords {1, N-1, c, N-c} for an r x c wrap (2-D diameter).
* ``expander`` — odd geometric chords {1, 3, 5, 9, 17, ...}: a circulant
  expander with O(log N) diameter (odd so the chord set never traps a
  residue class — the pview warm-overlay lesson).
* ``geo`` — ``geo_zones`` contiguous zones: doubling chords WITHIN the
  zone plus one WAN chord to the next zone; ``geo_wan_delay_ticks`` is
  the mean extra delay the certifier applies to every cross-zone link
  (dense engine's per-link delay matrix — WAN-like delay rings).
"""

from __future__ import annotations

import dataclasses

STRATEGIES = ("push", "push_pull", "pipelined", "accelerated", "tuneable")
TOPOLOGIES = ("full", "ring", "torus", "expander", "geo")


@dataclasses.dataclass(frozen=True)
class DissemSpec:
    """Hashable static dissemination spec (defaults = the legacy program)."""

    strategy: str = "push"
    topology: str = "full"
    #: chord-count budget for expander/geo (0 = auto ceil_log2)
    degree: int = 0
    #: torus row count (0 = auto: largest divisor of N at or below sqrt(N))
    torus_rows: int = 0
    geo_zones: int = 4
    #: mean cross-zone link delay in ticks (host-applied by the certifier /
    #: bench on the dense engine's delay matrix; 0 = no WAN delay)
    geo_wan_delay_ticks: int = 0
    #: pipelined: user-rumor slots carried per message (rotating window)
    pipeline_budget: int = 1
    #: tuneable: probability each send follows the deterministic doubling
    #: walk instead of a uniform random chord (arXiv:1506.02288's knob)
    tuneable_mix: float = 0.5

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; one of {STRATEGIES}"
            )
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; one of {TOPOLOGIES}"
            )
        if self.degree < 0:
            raise ValueError("degree must be >= 0 (0 = auto)")
        if self.torus_rows < 0:
            raise ValueError("torus_rows must be >= 0 (0 = auto)")
        if self.geo_zones < 2:
            raise ValueError("geo_zones must be >= 2")
        if self.geo_wan_delay_ticks < 0:
            raise ValueError("geo_wan_delay_ticks must be >= 0")
        if self.pipeline_budget < 1:
            raise ValueError("pipeline_budget must be >= 1")
        if not (0.0 <= self.tuneable_mix <= 1.0):
            raise ValueError("tuneable_mix must be in [0, 1]")

    # -- static program-shape switches ---------------------------------------
    @property
    def is_default(self) -> bool:
        """True iff the spec selects the byte-identical legacy program."""
        return self.strategy == "push" and self.topology == "full"

    @property
    def uniform_selection(self) -> bool:
        """Peer selection stays the engine's own live-view sampler (the
        random strategies on the unconstrained topology)."""
        return self.topology == "full" and self.strategy in ("push", "push_pull")

    @property
    def deterministic(self) -> bool:
        return self.strategy in ("pipelined", "accelerated")

    @property
    def wants_pull(self) -> bool:
        return self.strategy == "push_pull"

    @staticmethod
    def from_config(config) -> "DissemSpec":
        """Map a ``ClusterConfig.dissemination`` block (or an absent one)
        onto a spec."""
        dc = getattr(config, "dissemination", None)
        if dc is None:
            return DissemSpec()
        return DissemSpec(
            strategy=dc.strategy,
            topology=dc.topology,
            degree=dc.degree,
            torus_rows=dc.torus_rows,
            geo_zones=dc.geo_zones,
            geo_wan_delay_ticks=dc.geo_wan_delay_ticks,
            pipeline_budget=dc.pipeline_budget,
            tuneable_mix=getattr(dc, "tuneable_mix", 0.5),
        )


#: the one shared default instance (``params.dissem`` default value)
DEFAULT = DissemSpec()
