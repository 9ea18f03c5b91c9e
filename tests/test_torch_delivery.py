"""The delivery combine's plain PyTorch version against both JAX spellings:
``delivery_combine_xla`` and the Pallas kernel ``delivery_combine`` run in
interpret mode, through both of its ``pallas_call`` sites (the whole-payload
grid and the forced membership-word column split). Exact equality. The
port's wrapper takes the payload's three planes; the JAX spellings take the
concatenated payload. Also: the wrapper's input checks, and the choice of
the kernel's compiled variant."""

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


def _planes(payload, wm, r):
    """The payload's three planes, as the gossip phase holds them."""
    pl = torch.from_numpy(payload.view(np.int32).copy())
    wu = -(-r // 32)
    return (pl[:, :wm].contiguous(), pl[:, wm : wm + wu].contiguous(),
            pl[:, wm + wu :].contiguous())


def _port(payload, inv, origin, wm, r):
    return delivery.delivery_combine(
        *_planes(payload, wm, r), torch.from_numpy(inv), torch.from_numpy(origin),
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


def test_planes_with_their_own_row_stride():
    """Planes that are column slices of one wider tensor (row stride larger
    than their width) give the same result as contiguous planes."""
    wm, r = 6, 33
    payload, inv, origin = _inputs(65, 3, r, wm, seed=9)
    pl = torch.from_numpy(payload.view(np.int32).copy())
    wu = -(-r // 32)
    views = (pl[:, :wm], pl[:, wm : wm + wu], pl[:, wm + wu :])
    assert all(not v.is_contiguous() for v in views)
    got = delivery.delivery_combine(*views, torch.from_numpy(inv), torch.from_numpy(origin))
    for a, b in zip(_port(payload, inv, origin, wm, r), got):
        assert torch.equal(a, b)


def _good_args(n=33, f=3, r=8, wm=4):
    payload, inv, origin = _inputs(n, f, r, wm, seed=3)
    return [*_planes(payload, wm, r), torch.from_numpy(inv), torch.from_numpy(origin)]


_ARG = {"ym_p": 0, "yu_p": 1, "infected_from": 2, "inv": 3, "rumor_origin": 4}


@pytest.mark.parametrize("name,bad,match", [
    ("ym_p", lambda t: t[:-1], "ym_p shape"),
    ("yu_p", lambda t: torch.cat([t, t], dim=1), "yu_p shape"),
    ("infected_from", lambda t: t[:, :-1], "yu_p shape|infected_from shape|rumor_origin shape"),
    ("inv", lambda t: t[:, :-1], "shape"),
    ("rumor_origin", lambda t: t[:-1], "rumor_origin shape"),
    ("ym_p", lambda t: t.to(torch.int64), "ym_p must be torch.int32"),
    ("yu_p", lambda t: t.to(torch.int16), "yu_p must be torch.int32"),
    ("infected_from", lambda t: t.to(torch.int64), "infected_from must be torch.int32"),
    ("inv", lambda t: t.to(torch.int64), "inv must be torch.int32"),
    ("rumor_origin", lambda t: t.to(torch.uint8), "rumor_origin must be torch.int32"),
    ("yu_p", lambda t: t.to("meta"), "yu_p on meta"),
    ("infected_from", lambda t: t.to("meta"), "infected_from on meta"),
    ("inv", lambda t: t.to("meta"), "inv on meta"),
    ("rumor_origin", lambda t: t.to("meta"), "rumor_origin on meta"),
    ("ym_p", lambda t: t.T.contiguous().T, "ym_p must be contiguous within each row"),
    ("inv", lambda t: t.T.contiguous().T, "inv must be contiguous"),
])
def test_wrapper_refuses_mismatched_planes(name, bad, match):
    """The wrapper's checks run before its device branch, so they hold on
    the CPU too."""
    args = _good_args()
    args[_ARG[name]] = bad(args[_ARG[name]])
    with pytest.raises(ValueError, match=match):
        delivery.delivery_combine(*args)


def test_wrapper_refuses_an_unsupported_device():
    args = [t.to("meta") for t in _good_args()]
    with pytest.raises(ValueError, match="unsupported device meta"):
        delivery.delivery_combine(*args)


@pytest.mark.parametrize("wm,f,ptr,stride,want", [
    (64, 3, 0x7F0000000000, 64, ("vector", 3)),  # the main path
    (64, 1, 0x7F0000000000, 64, ("vector", 1)),
    (64, 4, 0x7F0000000000, 64, ("vector", 4)),
    (64, 5, 0x7F0000000000, 64, ("vector", 0)),  # runtime F
    (64, 9, 0x7F0000000010, 68, ("vector", 0)),
    (8, 2, 0x7F0000000000, 12, ("vector", 2)),   # a row slice, 48-byte stride
    (64, 3, 0x7F0000000004, 64, ("scalar", 3)),  # base off 16 bytes
    (64, 3, 0x7F0000000000, 66, ("scalar", 3)),  # row stride off 16 bytes
    (5, 1, 0x7F0000000000, 5, ("scalar", 1)),    # Wm % 4 != 0
    (7, 6, 0x7F0000000000, 7, ("scalar", 0)),
    (4, 2, 0x7F0000000008, 4, ("scalar", 2)),
])
def test_instantiation_picks_path_and_fanout_variant(wm, f, ptr, stride, want):
    assert delivery.instantiation(wm, f, ptr, stride) == want
