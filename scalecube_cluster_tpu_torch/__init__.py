"""scalecube_cluster_tpu_torch — the SWIM tick engines in PyTorch and CUDA.

The PyTorch/CUDA counterpart of the JAX package ``scalecube_cluster_tpu``,
module for module (``ops/lattice.py``, ``ops/rand.py``, ``ops/bitplane.py``,
``ops/pview.py``, ``sim/driver.py``, ...). It imports ``torch`` and numpy
only: nothing of JAX and nothing of the JAX package, whose semantics it
copies and is held against bit for bit by ``tests/test_torch_*.py``.

What runs today: the dense engine's tick and window runner, with its
link-delay rings (:func:`.ops.kernel.run_ticks`), the sparse
("record-queue") engine's (:func:`.ops.sparse.run_sparse_ticks`) and the
partial-view ("pview") engine's (:func:`.ops.pview.run_pview_ticks`) —
each the JAX package's fused tick, which gives the same state as its
unfused one — with the sparse and pview gossip delivery combine as a
hand-written CUDA kernel (``csrc/delivery_combine.cu``, bound in
:mod:`.ops.delivery`); the dissemination strategies and topologies on all
three engines, with the spread certifier (:mod:`.dissemination`,
``params.dissem``); the adaptive failure-detection plane on all three
engines (:mod:`.adaptive`, ``params.adaptive``) and the chaos scenarios
with their invariant sentinels (:mod:`.chaos`,
``SimDriver.run_scenario``); the fleet engine, S clusters advanced by
one window on every engine with the batched chaos timeline and the Monte
Carlo certifier over it (:mod:`.ops.fleet`); :class:`.sim.SimDriver` /
:class:`.sim.SimCluster` over any engine; the engine policy
:func:`.sim.driver.auto_params` and a copy of the JAX package's
``ClusterConfig`` (:mod:`.config`).
Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the host.
"""

from .config import ClusterConfig, DisseminationConfig
from .dissemination import DissemSpec

__all__ = ["ClusterConfig", "DisseminationConfig", "DissemSpec"]
