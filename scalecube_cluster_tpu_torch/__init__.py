"""scalecube_cluster_tpu_torch — the SWIM tick engines in PyTorch and CUDA.

The PyTorch/CUDA counterpart of the JAX package ``scalecube_cluster_tpu``,
module for module (``ops/lattice.py``, ``ops/rand.py``, ``ops/bitplane.py``,
``ops/pview.py``, ``sim/driver.py``, ...). It imports ``torch`` and numpy
only: nothing of JAX and nothing of the JAX package, whose semantics it
copies and is held against bit for bit by ``tests/test_torch_*.py``.

What runs today: the partial-view ("pview") engine's tick and window runner
(:func:`.ops.pview.run_pview_ticks`) and the sparse ("record-queue")
engine's (:func:`.ops.sparse.run_sparse_ticks`) — each the JAX package's
fused tick, which gives the same state as its unfused one — with the gossip
delivery combine as a hand-written CUDA kernel
(``csrc/delivery_combine.cu``, bound in :mod:`.ops.delivery`), and
:class:`.sim.SimDriver` / :class:`.sim.SimCluster` over either engine.
Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the host.
"""
