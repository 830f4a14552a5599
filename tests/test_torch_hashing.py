"""The port's row hash (K1's plain version on the CPU) against the JAX
package's `hash_rows` and `slot_of`: bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu.ops import hashing as jh
from datafusion_parallelism_tpu_torch.kernels import hash_slot as k1
from datafusion_parallelism_tpu_torch.ops import hash_table as tht
from datafusion_parallelism_tpu_torch.ops import hashing as th

N = 2000


def _column(kind, rng):
    if kind == "int32":
        return rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64).astype(np.int32)
    if kind == "int64":
        return rng.integers(-(1 << 63), (1 << 63) - 1, N, dtype=np.int64)
    if kind == "float32":
        v = rng.normal(size=N).astype(np.float32) * 1e6
        v[::7] = 0.0
        v[3::7] = -0.0
        v[5] = np.inf
        return v
    if kind == "float64":
        v = rng.normal(size=N) * 1e12
        v[::7] = 0.0
        v[3::7] = -0.0
        v[5] = -np.inf
        return v
    if kind == "bool":
        return rng.random(N) < 0.5
    raise AssertionError(kind)


def _jax_hash(cols):
    h = jh.hash_rows([(jnp.asarray(v), jnp.asarray(m)) for v, m in cols])
    return np.asarray(h).view(np.int32)


def _port_hash(cols):
    return th.hash_rows([(torch.from_numpy(v), torch.from_numpy(m)) for v, m in cols]).numpy()


KINDS = ["int32", "int64", "float32", "float64", "bool"]


@pytest.mark.parametrize("kind", KINDS)
def test_hash_rows_single_column_matches_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    cols = [(_column(kind, rng), rng.random(N) >= 0.1)]   # 10% NULL
    np.testing.assert_array_equal(_port_hash(cols), _jax_hash(cols))


@pytest.mark.parametrize("kinds", [("int32", "int64"), ("int64", "int64", "bool"),
                                   ("float64", "int32", "float32", "int64")])
def test_hash_rows_multi_column_matches_jax(kinds):
    rng = np.random.default_rng(len(kinds))
    cols = [(_column(k, rng), rng.random(N) >= 0.2) for k in kinds]
    np.testing.assert_array_equal(_port_hash(cols), _jax_hash(cols))


def test_signed_zero_and_null_hash():
    z = np.array([0.0, -0.0, 1.0, 1.0])
    m = np.array([True, True, True, False])
    h = _port_hash([(z, m)])
    assert h[0] == h[1]
    assert h[3] == _port_hash([(np.zeros(1, np.int32), np.zeros(1, bool))])[0]
    np.testing.assert_array_equal(h, _jax_hash([(z, m)]))


def test_fmix32_and_combine_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    np.testing.assert_array_equal(th._fmix32(ta).numpy(),
                                  np.asarray(jh._fmix32(jnp.asarray(a))).astype(np.int64))
    np.testing.assert_array_equal(
        th.combine(ta, tb).numpy(),
        np.asarray(jh.combine(jnp.asarray(a), jnp.asarray(b))).astype(np.int64))


@pytest.mark.parametrize("T", [1 << 16, 1 << 20, 3 * (1 << 20) + 7, 604_000_000])
def test_hash_slot_plain_matches_jax_slot_of(T):
    """K1's slot on the probe side (no mask) and the build side (rows past
    num_rows and null keys go to bucket T), for pow2 and non-pow2 T."""
    rng = np.random.default_rng(T % 97)
    cols = [(_column("int64", rng), rng.random(N) >= 0.1),
            (_column("int32", rng), rng.random(N) >= 0.1)]
    words, kcols = th.key_words([(torch.from_numpy(v), torch.from_numpy(m)) for v, m in cols])
    h, slot = k1.hash_slot(words, kcols, T)
    jhash = jh.hash_rows([(jnp.asarray(v), jnp.asarray(m)) for v, m in cols])
    jslot = np.asarray(jht.slot_of(jhash, T))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jhash).view(np.int32))
    np.testing.assert_array_equal(slot.numpy(), jslot)
    num_rows = N - 300
    _, bslot = k1.hash_slot(words, kcols, T, torch.tensor(num_rows, dtype=torch.int32))
    ok = (np.arange(N) < num_rows) & cols[0][1] & cols[1][1]
    np.testing.assert_array_equal(bslot.numpy(), np.where(ok, jslot, T))
    np.testing.assert_array_equal(tht.slot_of(h, T).numpy(), jslot)


def test_hash_slot_on_cpu_runs_the_plain_version():
    words, kcols = th.key_words([(torch.arange(10, dtype=torch.int32),
                                  torch.ones(10, dtype=torch.bool))])
    before = k1.hash_slot.launches
    got = k1.hash_slot(words, kcols, 1 << 16)
    want = k1.hash_slot_plain(words, kcols, 1 << 16)
    assert k1.hash_slot.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kinds", [("int32",), ("int64",), ("bool", "int64", "int32")])
def test_join_hashes_packed_rows_like_jax_hash_rows(kinds):
    """The deferred join hands K1 the key columns' `key_words` rows, which
    its recheck plan (`_defer_key_plan`) names; a prepared build's plan
    names the same keys' words and validity bits in its packed rows. The
    hash over either equals JAX's hash_rows over the key columns."""
    from datafusion_parallelism_tpu_torch.ops import join as tjoin
    from datafusion_parallelism_tpu_torch.utils import columnar as tcol
    rng = np.random.default_rng(len(kinds) + 40)
    cols = [(_column(k, rng), rng.random(N) >= 0.1) for k in kinds]
    names = [f"k{i}" for i in range(len(kinds))]
    data = {n: v for n, (v, _) in zip(names, cols)}
    data["pad"] = rng.normal(size=N)
    table = tcol.HostTable.from_numpy(data, validity={n: m for n, (_, m) in zip(names, cols)}
                                      ).to_device(device="cpu")
    words, kcols = th.key_words([table.column(n) for n in names])
    assert tjoin._defer_key_plan(tjoin._word_keys(kcols), tjoin._word_keys(kcols)) is not None
    h, _ = k1.hash_slot(words, kcols)
    np.testing.assert_array_equal(h.numpy()[:N], _jax_hash(cols))
    pt = tcol.pack_table(table)
    packed = tjoin._packed_keys(pt.layout, names)
    assert tjoin._defer_key_plan(packed, tjoin._word_keys(kcols)) is not None
    pcols = [(th.KIND_I32 if len(rows) == 1 else th.KIND_I64, tuple(rows), valid)
             for _, rows, valid in packed]
    h, _ = k1.hash_slot(pt.packed, pcols)
    np.testing.assert_array_equal(h.numpy()[:N], _jax_hash(cols))


def test_hash_slot_spec_layout_and_checks():
    """The HashSpec the CUDA launcher receives: n_cols, then kind, lo, hi,
    vrow and vbit, each padded to 16 columns; malformed key columns raise
    before a launch."""
    spec = k1._spec([(th.KIND_I64, (0, 1), (4, 3)), (th.KIND_I32, (2,), (4, 31))], 5)
    pad = [0] * 14
    assert list(spec) == [2, th.KIND_I64, th.KIND_I32, *pad, 0, 2, *pad, 1, 2, *pad,
                          4, 4, *pad, 3, 31, *pad]
    with pytest.raises(ValueError, match="outside"):
        k1._spec([(th.KIND_I32, (5,), (0, 0))], 5)
    with pytest.raises(ValueError, match="word rows"):
        k1._spec([(th.KIND_I64, (0,), (1, 0))], 5)
    with pytest.raises(ValueError, match="1-16 key columns"):
        k1._spec([(th.KIND_I32, (0,), (1, 0))] * 17, 5)
