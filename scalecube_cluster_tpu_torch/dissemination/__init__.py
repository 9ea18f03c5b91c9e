"""Dissemination strategy zoo (r13): pluggable gossip strategies,
topology-aware circulant adjacency, and certified spread-time curves — a
port of the JAX package's ``dissemination/``.

See :mod:`.spec` for the strategy/topology catalog, :mod:`.strategies`
for the engine seam, :mod:`.topology` for the chord generators, and
:mod:`.certify` for the theory-vs-measured certification harness
(``spread_certifier``, and its Monte Carlo half over the fleet engine:
``certify_spread_mc``, ``mc_spread_certifier``, ``fp_rate_mc``,
``adaptive_knob_sweep``)."""

from . import strategies, topology  # noqa: F401
from .spec import DEFAULT, STRATEGIES, TOPOLOGIES, DissemSpec  # noqa: F401


def __getattr__(name):
    # certify pulls in the engines; keep the package import light for the
    # params modules that only need the spec
    if name in ("certify", "spread_certifier", "measure_spread", "theory_bound",
                "certify_spread_mc", "fp_rate_mc", "mc_spread_certifier",
                "adaptive_knob_sweep", "DEFAULT_MC_MATRIX", "MC_MIN_SAMPLES"):
        import importlib

        # an import of the submodule by name: ``from . import certify``
        # would ask this hook for the attribute again
        _c = importlib.import_module(f"{__name__}.certify")
        if name == "certify":
            return _c
        return getattr(_c, name)
    raise AttributeError(name)
