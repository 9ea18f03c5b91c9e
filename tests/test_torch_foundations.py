"""The PyTorch port's foundations against the JAX package, exactly: the key
lattice, the bit planes and the stateless fetch hash. Also the rule that
the port imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import ast
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scalecube_cluster_tpu.ops import bitplane as JB  # noqa: E402
from scalecube_cluster_tpu.ops import lattice as JL  # noqa: E402
from scalecube_cluster_tpu.ops import rand as JR  # noqa: E402
from scalecube_cluster_tpu_torch.ops import bitplane as TB  # noqa: E402
from scalecube_cluster_tpu_torch.ops import lattice as TL  # noqa: E402
from scalecube_cluster_tpu_torch.ops import rand as TR  # noqa: E402

torch.set_num_threads(1)

_DT = {"i32": (jnp.int32, torch.int32, np.int32), "i16": (jnp.int16, torch.int16, np.int16)}


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_precedence_key_matches_jax(kd):
    jdt, tdt, _ = _DT[kd]
    rng = np.random.default_rng(1)
    n = 4096
    status = rng.integers(0, 5, n).astype(np.int32)
    # incarnations past both caps (511 narrow, 2**21 - 1 wide) saturate
    inc = rng.integers(0, 1 << 22, n).astype(np.int32)
    inc[:64] = [0, 1, 510, 511, 512, (1 << 21) - 1, 1 << 21, (1 << 22) - 1] * 8
    epoch = rng.integers(0, 1 << 10, n).astype(np.int32)  # folds mod 16 / mod 256
    ref = np.asarray(JL.precedence_key(jnp.asarray(status), jnp.asarray(inc),
                                       jnp.asarray(epoch), dtype=jdt))
    got = TL.precedence_key(torch.from_numpy(status), torch.from_numpy(inc),
                            torch.from_numpy(epoch), dtype=tdt).numpy()
    assert got.dtype == ref.dtype
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kd", ["i32", "i16"])
def test_bump_inc_matches_jax(kd):
    jdt, tdt, ndt = _DT[kd]
    info = np.iinfo(ndt)
    rng = np.random.default_rng(2)
    keys = rng.integers(info.min, info.max, 4096, endpoint=True).astype(ndt)
    lay = JL.layout_for(ndt)
    sat = (lay.inc_mask << 2) | 2  # SUSPECT at the incarnation cap
    keys[:6] = [-1, 0, sat, sat - 4, info.max, info.min]
    rank = rng.integers(0, 4, 4096).astype(ndt)
    ref = np.asarray(JL.bump_inc(jnp.asarray(keys), jnp.asarray(rank)))
    got = TL.bump_inc(torch.from_numpy(keys), torch.from_numpy(rank)).numpy()
    assert np.array_equal(got, ref)
    # the cap saturates instead of carrying into the epoch bits
    assert (int(got[2]) >> 2) & lay.inc_mask == lay.inc_mask


def test_key_narrowing_wraps_like_jax():
    """int32 -> int16 narrowing (the ``.astype(kdt)`` writes of the tick)
    wraps the same way in both frameworks."""
    vals = np.array([0, -1, 32767, 32768, -32769, 70000, -(1 << 31), (1 << 31) - 1], np.int32)
    ref = np.asarray(jnp.asarray(vals).astype(jnp.int16))
    got = torch.from_numpy(vals).to(torch.int16).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("length", [1, 31, 33, 64, 100, 2048 + 5])
def test_pack_unpack_matches_jax(length):
    rng = np.random.default_rng(length)
    x = rng.random((3, 5, length)) < 0.4
    ref = np.asarray(JB.pack_bits(jnp.asarray(x))).view(np.int32)
    got = TB.pack_bits(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), ref)
    assert torch.equal(TB.unpack_bits(got, length), torch.from_numpy(x))
    words = rng.integers(0, 1 << 32, (7, TB.words_for(length)), dtype=np.uint32)
    ref_u = np.asarray(JB.unpack_bits(jnp.asarray(words), length))
    got_u = TB.unpack_bits(torch.from_numpy(words.view(np.int32)), length).numpy()
    assert np.array_equal(got_u, ref_u)


def test_popcount_matches_jax_on_high_words():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, 8192, dtype=np.uint64).astype(np.uint32)
    words[:6] = [0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA]
    ref = np.asarray(JB.popcount(jnp.asarray(words)))
    got = TB.popcount(torch.from_numpy(words.view(np.int32))).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("rows", [1, 2, 7, 64, 1000])
def test_or_rows_is_the_bitwise_or(rows):
    rng = np.random.default_rng(rows)
    words = rng.integers(0, 1 << 32, (rows, 5), dtype=np.uint64).astype(np.uint32)
    ref = np.bitwise_or.reduce(words, axis=0).view(np.int32)
    assert np.array_equal(TB.or_rows(torch.from_numpy(words.view(np.int32))).numpy(), ref)


@pytest.mark.parametrize("salt", [JR.SALT_GOSSIP, JR.SALT_SYNC_REQ, JR.SALT_SYNC_ACK, 0, JR.SALT_PULL])
def test_fetch_uniform_matches_jax(salt):
    rng = np.random.default_rng(salt % 997)
    i = rng.integers(0, 1 << 21, 2048).astype(np.int32)
    j = rng.integers(0, 1 << 21, 2048).astype(np.int32)
    for tick in (0, 1, 37, 12345, (1 << 31) - 1):
        ref = np.asarray(JR.fetch_uniform(tick, salt, jnp.asarray(i), jnp.asarray(j)))
        got = TR.fetch_uniform(tick, salt, torch.from_numpy(i), torch.from_numpy(j)).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, ref), (tick, salt)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    roots = [pathlib.Path(REPO) / "scalecube_cluster_tpu_torch", pathlib.Path(REPO) / "chip_smoke.py",
             pathlib.Path(REPO) / "chip_memory.py"]
    files = [p for r in roots for p in ([r] if r.is_file() else sorted(r.rglob("*.py")))]
    walked = {p.relative_to(REPO).as_posix() for p in files}
    for module in ("ops/pview.py", "ops/sparse.py", "ops/kernel.py", "ops/state.py", "ops/engine_api.py",
                   "sim/driver.py", "convert.py", "config.py", "dissemination/__init__.py",
                   "dissemination/spec.py", "dissemination/topology.py", "dissemination/strategies.py",
                   "dissemination/certify.py", "utils/cluster_math.py", "adaptive.py",
                   "chaos/__init__.py", "chaos/events.py", "chaos/shifting.py", "chaos/sentinels.py",
                   "chaos/engine.py", "ops/fleet.py", "ops/delivery.py", "ops/_tensor.py",
                   "telemetry/__init__.py", "telemetry/bus.py", "telemetry/openmetrics.py",
                   "telemetry/flight.py", "telemetry/rings.py", "telemetry/plane.py",
                   "trace/__init__.py", "trace/schema.py", "trace/spans.py", "trace/export.py",
                   "trace/rings.py", "trace/capture.py", "trace/plane.py", "trace/profile.py",
                   "control.py", "replay.py", "ops/keychain.py", "ops/dcn.py", "ops/sharding.py",
                   "ops/ragged_a2a.py"):
        assert f"scalecube_cluster_tpu_torch/{module}" in walked, module
    bad = [
        f"{p.relative_to(REPO)}:{line}: import {name}"
        for p in files
        for line, name in _imports(p)
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "scalecube_cluster_tpu")
    ]
    assert bad == [], "\n".join(bad)


@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_key_chain_matches_jax(engine):
    """``ops/keychain.py`` reproduces the JAX package's per-tick key chain
    bit for bit: ``PRNGKey``, ``split``, ``uniform`` and every draw of five
    ticks of a fleet of four chains (``fleet_keys``), the chains' keys
    after them included."""
    import dataclasses

    import jax

    from scalecube_cluster_tpu.ops import fleet as JFL
    from scalecube_cluster_tpu.ops import sparse as JSP
    from scalecube_cluster_tpu.ops import state as JS
    from scalecube_cluster_tpu_torch import convert
    from scalecube_cluster_tpu_torch.ops import keychain as KC
    from test_torch_dense import dense_draws
    from test_torch_pview_fused import _jax_draws

    seeds = [1000, 1001, 7, 123456]
    assert np.array_equal(np.asarray(JFL.fleet_keys(seeds)).astype(np.int64), KC.prng_keys(seeds, "cpu").numpy())
    key5 = KC.prng_keys([5], "cpu")
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(5), 5)).astype(np.int64)
    assert np.array_equal(ref, KC.split(key5, 5)[0].numpy())
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (7, 3)))
    assert np.array_equal(ref, KC.uniform(key5, (7, 3))[0].numpy())
    params, draws = ((JS.SimParams(capacity=33, fanout=3, ping_req_k=2), dense_draws) if engine == "dense"
                     else (JSP.SparseParams(capacity=33, mr_slots=16), _jax_draws))
    chain = KC.KeyChain(seeds, "cpu")
    got = chain(5, convert.params_from_dict(dataclasses.asdict(params)))
    for s, seed in enumerate(seeds):
        key, want = draws(jax.random.PRNGKey(seed), 5, params)
        for t in range(5):
            for a, b in zip(want[t], got[t]):
                for f in dataclasses.fields(a):
                    assert np.array_equal(getattr(a, f.name).numpy(), getattr(b, f.name)[s].numpy()), (s, t, f.name)
        assert np.array_equal(np.asarray(key).astype(np.int64), chain.keys[s].numpy())
    serial = KC.KeyChain([seeds[0]], "cpu", serial=True)(1, convert.params_from_dict(dataclasses.asdict(params)))
    assert torch.equal(serial[0][1].sync_edge, got[0][1].sync_edge[0])
