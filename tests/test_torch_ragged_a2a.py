"""The port's ragged delivery exchange against the JAX package's.

The port splits JAX's ``ragged_delivery_combine`` into its per-rank pieces:
``bucket_records`` (records and buckets), the exchange (one
``all_to_all_single``) and ``elect_and_fold`` (the election and the fold).
Here the exchange is done in process — rank d receives bucket d of every
rank, in rank order, which is what ``all_to_all_single`` delivers — so the
pieces are held against JAX's ``shard_map`` on S = 2 and 4 virtual devices
on the same inputs without spawning processes: under the lossless budget
(and then also against the one-device combine), under a starved budget
(the overflow equal and non-zero), and in the refusals.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalecube_cluster_tpu.ops import ragged_a2a as JRA
from scalecube_cluster_tpu.ops import sharding as JSH
from scalecube_cluster_tpu_torch.ops import delivery as TD
from scalecube_cluster_tpu_torch.ops import ragged_a2a as TRA

torch.set_num_threads(1)

N, F, WM, R = 256, 3, 4, 8
WU = 1


def _inputs(seed: int, skew: bool = False):
    """Random payload words (the high bit set in many), receivers (with
    ``skew`` most of them on rank 0's rows), send masks and origins."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 1 << 32, size=(N, WM + WU + R), dtype=np.uint64).astype(np.uint32)
    payload[:, WM + WU:] = rng.integers(-1, N, size=(N, R)).astype(np.int32).view(np.uint32)
    hi = N // 4 if skew else N
    p_all = rng.integers(0, hi, size=(F, N)).astype(np.int32)
    ok = rng.random((F, N)) < 0.8
    origin = rng.integers(-1, N, size=(R,)).astype(np.int32)
    return payload, p_all, ok, origin


@functools.lru_cache(maxsize=None)
def _mesh(s: int):
    if len(jax.devices()) < s:
        pytest.skip(f"needs {s} (virtual) devices")
    return JSH.make_mesh(jax.devices()[:s])


@functools.lru_cache(maxsize=None)
def _jax_combine(s: int, budget):
    return jax.jit(functools.partial(JRA.ragged_delivery_combine, Wm=WM, R=R, mesh=_mesh(s),
                                     axis=JSH.MEMBER_AXIS, budget=budget))


def _jax(payload, p_all, ok, origin, s: int, budget=None):
    out = _jax_combine(s, budget)(jnp.asarray(payload), jnp.asarray(p_all), jnp.asarray(ok), jnp.asarray(origin))
    return [np.asarray(x) for x in out]


def _port(payload, p_all, ok, origin, s: int, budget=None):
    """Every rank's pieces, the exchange done in process."""
    L = N // s
    B = TRA.check_budget(F, N, s, budget)
    pl = torch.from_numpy(payload.view(np.int32))
    bufs, ovf = [], 0
    for r in range(s):
        rows = slice(r * L, (r + 1) * L)
        buf, o = TRA.bucket_records(pl[rows], torch.from_numpy(p_all[:, rows].copy()),
                                    torch.from_numpy(ok[:, rows].copy()), r * L, L, s, B)
        assert buf.shape == (s, B, TRA.HEADER_WORDS + WM + WU + R) and buf.dtype == torch.int32
        bufs.append(buf)
        ovf += int(o)
    outs, cnt = [], 0
    for d in range(s):
        got = torch.cat([bufs[r][d] for r in range(s)])
        u_or, src_max, m_or, c = TRA.elect_and_fold(got, torch.from_numpy(origin), d * L, L, F, WM, R)
        outs.append((u_or, src_max, m_or))
        cnt += int(c)
    cat = [torch.cat([o[i] for o in outs]).numpy() for i in range(3)]
    return cat[0], cat[1], cat[2].view(np.uint32), cnt, ovf


@pytest.mark.parametrize("s", [2, 4])
def test_lossless_budget_matches_jax_and_the_one_device_combine(s):
    payload, p_all, ok, origin = _inputs(s)
    j = _jax(payload, p_all, ok, origin, s)
    u_or, src_max, m_or, cnt, ovf = _port(payload, p_all, ok, origin, s)
    assert np.array_equal(u_or, j[0]) and np.array_equal(src_max, j[1]) and np.array_equal(m_or, j[2])
    assert cnt == int(j[3]) and ovf == int(j[4]) == 0
    # ... and the global election on one device
    rows = torch.arange(N, dtype=torch.int32)
    inv = torch.full((F, N), -1, dtype=torch.int32)
    inv.scatter_reduce_(1, torch.from_numpy(p_all).long(),
                        torch.where(torch.from_numpy(ok), rows[None, :].expand(F, N), -1), "amax")
    ref = TD.delivery_combine_ref(torch.from_numpy(payload.view(np.int32)), inv, torch.from_numpy(origin), WM, R)
    assert np.array_equal(u_or, ref[0].numpy()) and np.array_equal(src_max, ref[1].numpy())
    assert np.array_equal(m_or, ref[2].numpy().view(np.uint32)) and cnt == int(ref[3])
    assert cnt > 0 and u_or.any()


@pytest.mark.parametrize("s,budget", [(2, 24), (4, 5)])
def test_starved_budget_matches_jax_with_overflow(s, budget):
    payload, p_all, ok, origin = _inputs(10 + s, skew=True)
    j = _jax(payload, p_all, ok, origin, s, budget)
    u_or, src_max, m_or, cnt, ovf = _port(payload, p_all, ok, origin, s, budget)
    assert ovf == int(j[4]) > 0
    assert np.array_equal(u_or, j[0]) and np.array_equal(src_max, j[1]) and np.array_equal(m_or, j[2])
    assert cnt == int(j[3])
    full = _port(payload, p_all, ok, origin, s)
    assert full[3] > cnt, "the dropped records carried deliveries"


def test_default_budget_and_exchange_bytes():
    for f, n, s in ((2, 256, 8), (3, 96, 4), (3, 1 << 20, 1)):
        assert TRA.default_budget(f, n, s) == JRA.default_budget(f, n, s)
    # [W, B, 3 + Wt] int32: at 1M on one rank, F = 3 and Wt = 64 + 1 + 8
    assert TRA.exchange_bytes(3, 1 << 20, 1, 73) == 4 * 3 * (1 << 20) * 76
    assert TRA.HEADER_WORDS == JRA.HEADER_WORDS


@pytest.mark.parametrize("budget", [0, -1, F * (N // 2) + 1])
def test_bad_budget_refused_as_jax_refuses(budget):
    payload, p_all, ok, origin = _inputs(0)
    with pytest.raises(ValueError, match="budget"):
        _jax(payload, p_all, ok, origin, 2, budget)
    with pytest.raises(ValueError, match="budget"):
        TRA.check_budget(F, N, 2, budget)


def test_uneven_capacity_refused_as_jax_refuses():
    rng = np.random.default_rng(1)
    n = 250  # not divisible by 4
    payload = np.zeros((n, WM + WU + R), np.uint32)
    p_all = rng.integers(0, n, size=(F, n)).astype(np.int32)
    with pytest.raises(Exception, match="divisible"):
        JRA.ragged_delivery_combine(jnp.asarray(payload), jnp.asarray(p_all), jnp.ones((F, n), bool),
                                    jnp.zeros((R,), jnp.int32), WM, R, mesh=_mesh(4), axis=JSH.MEMBER_AXIS)
    with pytest.raises(ValueError, match="not divisible by member-mesh size 4"):
        TRA.check_budget(F, n, 4, None)
