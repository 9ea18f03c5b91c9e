"""The delivery combine's plain PyTorch version against both JAX spellings:
``delivery_combine_xla`` and the Pallas kernel ``delivery_combine`` run in
interpret mode, through both of its ``pallas_call`` sites (the whole-payload
grid and the forced membership-word column split). Exact equality."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scalecube_cluster_tpu.ops.pallas_delivery import (  # noqa: E402
    delivery_combine as jax_pallas_combine,
    delivery_combine_xla,
)
from scalecube_cluster_tpu_torch.ops import delivery  # noqa: E402

torch.set_num_threads(1)


def _inputs(n: int, f: int, r: int, wm: int, seed: int):
    """Random payload rows; inv with -1s and duplicate senders; origins
    that hit receiver rows."""
    rng = np.random.default_rng(seed)
    wu = -(-r // 32)
    payload = rng.integers(0, 2 ** 32, size=(n, wm + wu + r), dtype=np.uint64).astype(np.uint32)
    payload[:, wm + wu:] = rng.integers(-1, n, size=(n, r)).astype(np.int32).view(np.uint32)
    inv = rng.integers(-1, n, size=(f, n)).astype(np.int32)
    inv[:, : n // 4] = -1
    inv[:, n // 4 : n // 2] = rng.integers(0, 3, size=(f, n // 2 - n // 4))  # duplicates
    origin = rng.integers(-1, n, size=(r,)).astype(np.int32)
    return payload, inv, origin


def _port(payload, inv, origin, wm, r):
    return delivery.delivery_combine(
        torch.from_numpy(payload.view(np.int32)), torch.from_numpy(inv),
        torch.from_numpy(origin), wm, r,
    )


def _assert_equal(ref, got, label):
    for name, a, b in zip(("u_or", "src_max", "m_or", "cnt"), ref, got):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        b = b.numpy()
        assert b.shape == a.shape, f"{label}: {name} shape"
        assert np.array_equal(b, a), f"{label}: {name} differs"


@pytest.mark.parametrize("n", [33, 257])
@pytest.mark.parametrize("f", [1, 3])
@pytest.mark.parametrize("r", [8, 33])
def test_plain_version_matches_jax_xla(n, f, r):
    wm = 5
    payload, inv, origin = _inputs(n, f, r, wm, seed=n * 100 + f * 10 + r)
    _assert_equal(delivery_combine_xla(payload, inv, origin, wm, r),
                  _port(payload, inv, origin, wm, r), f"xla n={n} f={f} r={r}")


@pytest.mark.parametrize("n,f,r,wm,block_cols", [
    (33, 3, 8, 7, None),    # the row-block grid (pallas_delivery.py:251)
    (257, 1, 33, 4, None),
    (33, 3, 8, 7, 3),       # the column split (pallas_delivery.py:282)
    (257, 3, 33, 5, 2),
])
def test_plain_version_matches_jax_pallas_interpreted(n, f, r, wm, block_cols):
    payload, inv, origin = _inputs(n, f, r, wm, seed=n + f + r + wm)
    ref = jax_pallas_combine(payload, inv, origin, wm, r, block_rows=32,
                             block_cols=block_cols, interpret=True)
    _assert_equal(ref, _port(payload, inv, origin, wm, r), f"pallas n={n} cols={block_cols}")


def test_cpu_tensors_take_the_plain_version():
    payload, inv, origin = _inputs(33, 3, 8, 4, seed=5)
    before = delivery.delivery_combine.launches
    got = _port(payload, inv, origin, 4, 8)
    ref = delivery.delivery_combine_ref(
        torch.from_numpy(payload.view(np.int32)), torch.from_numpy(inv),
        torch.from_numpy(origin), 4, 8,
    )
    assert delivery.delivery_combine.launches == before
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
