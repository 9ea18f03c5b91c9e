"""The port's process-group layer (``ops/dcn.py``) through a real gloo lane.

Two spawned ranks (``LocalWorld``, one thread each) join one group: each
sees its rank and the world, a 1-D ``"members"`` mesh, its rows of the
global initial pview state (the host init's rows, nothing else), gathers
and reductions on the dtypes the collectives lack (int16 and bool cross as
bytes), and the ragged exchange's one ``all_to_all_single`` whose pieces
``tests/test_torch_ragged_a2a.py`` holds against JAX in process.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as RK
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import ragged_a2a as TRA
from scalecube_cluster_tpu_torch.ops import sharding as TSH
from scalecube_cluster_tpu_torch.ops import state as TS

torch.set_num_threads(1)

PARAMS = TPV.PviewParams(capacity=128, view_slots=8, active_slots=4, fanout=2, rumor_slots=4, seed_rows=(0, 1),
                         mr_slots=16, key_dtype="i16")


@pytest.fixture(scope="module")
def info():
    with dcn.LocalWorld(2, "cpu") as lw:
        yield lw.run(RK.dcn_info, PARAMS, 120)


def test_each_rank_joins_one_member_mesh(info):
    assert [r["rank"] for r in info] == [0, 1] and {r["world"] for r in info} == {2}
    for r in info:
        assert r["names"] == (TSH.MEMBER_AXIS,) and r["size"] == 2 and r["device"] == "cpu"
    assert [r["rows"] for r in info] == [(0, 64), (64, 128)]


def test_global_pview_state_holds_each_ranks_rows(info):
    host = convert.state_to_numpy(TPV.init_pview_state(PARAMS, 120, device="cpu"))
    tags = TSH.pview_state_shardings(None, False, 0)
    for r in info:
        lo, hi = r["rows"]
        for name, v in host.items():
            want = v[lo:hi] if getattr(tags, name) == TSH.ROW else v
            assert np.array_equal(r["shard"][name], want), (r["rank"], name)
            assert r["shard"][name].dtype == v.dtype, name


def test_delay_rings_split_on_the_member_dimension(info):
    for r in info:
        assert r["ring_shard"] == (2, 64, PARAMS.rumor_slots)
        assert r["rings_round_trip"]


def test_collectives_carry_narrow_and_bool_tensors(info):
    want = np.concatenate([((np.arange(6, dtype=np.int16).reshape(3, 2) - 3) * (k + 1)) for k in range(2)])
    for r in info:
        assert r["gathered_i16"].dtype == np.int16 and np.array_equal(r["gathered_i16"], want)
        assert r["any_all"] == ([True, False, True], [False, False, True])


def test_ragged_exchange_over_the_group_equals_the_pieces_in_process(info):
    """The composite (bucket, all_to_all_single, elect) on the lane against
    the same pieces with the exchange done in process."""
    rng = np.random.default_rng(5)
    n, F, Wm, R, s, B = 128, 2, 2, 4, 2, 3
    payload = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(n, Wm + 1 + R), dtype=np.int64)
                               .astype(np.int32))
    p_all = torch.from_numpy(rng.integers(0, n, size=(F, n)).astype(np.int32))
    ok = torch.from_numpy(rng.random((F, n)) < 0.7)
    origin = torch.from_numpy(rng.integers(-1, n, size=(R,)).astype(np.int32))
    L = n // s
    bufs, ovf = [], 0
    for r in range(s):
        buf, o = TRA.bucket_records(payload[r * L:(r + 1) * L], p_all[:, r * L:(r + 1) * L],
                                    ok[:, r * L:(r + 1) * L], r * L, L, s, B)
        bufs.append(buf)
        ovf += int(o)
    cnt = 0
    for d, rank in enumerate(info):
        got = TRA.elect_and_fold(torch.cat([b[d] for b in bufs]), origin, d * L, L, F, Wm, R)
        for a, b in zip(got[:3], rank["combine"]):
            assert np.array_equal(a.numpy(), b)
        cnt += int(got[3])
    assert ovf > 0
    for rank in info:
        assert rank["cnt"] == cnt and rank["overflow"] == ovf


def test_outside_a_group():
    assert dcn.process_info() == (0, 1)
    assert dcn.cpu_collectives_available()
    with pytest.raises(RuntimeError, match="process group"):
        TSH.make_mesh("cpu")
    # the dense engine's global state needs a member mesh to shard onto
    with pytest.raises(ValueError, match="1-D 'members' mesh"):
        dcn.make_global_state(TS.SimParams(capacity=8), 8, None)


def test_a_failing_rank_fails_the_call():
    with dcn.LocalWorld(2, "cpu") as lw:
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            lw.run(divmod, 1, 0)
        assert lw.run(divmod, 7, 2) == [(3, 1), (3, 1)]


def test_a_dead_rank_fails_the_call_within_seconds():
    """A rank that exits mid-call (rank 0 waiting for it in a barrier)
    fails the call within a few polls, not after the 600 s timeout, with
    its exit code in the message; the broken world refuses later calls at
    once and closes without waiting for the stuck survivor."""
    import time

    lw = dcn.LocalWorld(2, "cpu")
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1: exited with code 3"):
            lw.run(RK.exit_on_rank, 1, 3)
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(RuntimeError, match="broken"):
            lw.run(divmod, 7, 2)
    finally:
        t0 = time.monotonic()
        lw.close()
        assert time.monotonic() - t0 < 10.0
