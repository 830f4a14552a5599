"""The port's columnar substrate against the JAX package's: the same seeded
host tables go through both; packed words must agree one for one."""

import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference

N = 300
CAP = 512


def _values(kind, rng):
    if kind in ("int32", "date32"):
        return rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64).astype(np.int32)
    if kind in ("int64", "decimal"):
        return rng.integers(-(1 << 62), 1 << 62, N, dtype=np.int64)
    if kind == "float32":
        v = rng.normal(size=N).astype(np.float32)
        v[:3] = [0.0, -0.0, np.inf]
        return v
    if kind == "float64":
        v = rng.normal(size=N)
        v[:3] = [0.0, -0.0, -np.inf]
        return v
    if kind == "bool":
        return rng.random(N) < 0.5
    if kind == "string":
        return rng.integers(0, 5, N).astype(np.int32)
    raise AssertionError(kind)


def _ref_table(kinds, seed):
    """A JAX-package HostTable with one column per kind, ~20% nulls."""
    rng = np.random.default_rng(seed)
    data, dtypes, valid, dicts = {}, {}, {}, {}
    for i, kind in enumerate(kinds):
        name = f"c{i}_{kind}"
        data[name] = _values(kind, rng)
        valid[name] = rng.random(N) >= 0.2
        k = jcol.Kind(kind)
        dtypes[name] = jcol.DType(k, 2 if k is jcol.Kind.DECIMAL else 0)
        if k is jcol.Kind.STRING:
            dicts[name] = jcol.Dictionary(np.array(list("abcde"), dtype=object))
    return jcol.HostTable.from_numpy(data, dtypes=dtypes, dictionaries=dicts, validity=valid)


ALL_KINDS = [k.value for k in jcol.Kind]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_pack_matches_jax_and_round_trips(kind):
    ref = _ref_table([kind, "int32"], seed=ALL_KINDS.index(kind))
    jt = ref.to_device(CAP)
    tt = host_table_from_reference(ref).to_device(CAP, device="cpu")
    jp, tp = jcol.pack_table(jt), tcol.pack_table(tt)
    assert tp.layout.fields == tuple((n, tcol.Kind(k.value), s, w)
                                     for n, k, s, w in jp.layout.fields)
    assert tp.layout.valid_base == jp.layout.valid_base
    assert tp.layout.width == jp.layout.width
    np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))
    for name, v in jp.f64s.items():
        np.testing.assert_array_equal(tp.f64s[name].numpy().view(np.int64),
                                      np.asarray(v).view(np.int64))
    back = tcol.unpack_table(tp, tt.schema, tt.num_rows)
    for name in tt.schema.names:
        (v0, m0), (v1, m1) = tt.column(name), back.column(name)
        assert v1.dtype == v0.dtype
        if v0.is_floating_point():
            bits = torch.int64 if v0.dtype == torch.float64 else torch.int32
            v0, v1 = v0.view(bits), v1.view(bits)
        assert torch.equal(v0, v1) and torch.equal(m0, m1)


def test_pack_many_columns_uses_two_validity_words():
    kinds = ["int32", "int64", "bool", "float64"] * 9   # 36 fields
    ref = _ref_table(kinds, seed=7)
    jp = jcol.pack_table(ref.to_device(CAP))
    tp = tcol.pack_table(host_table_from_reference(ref).to_device(CAP, device="cpu"))
    assert tp.packed.shape[0] == tp.layout.valid_base + 2
    np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))


def test_take_rows_matches_jax():
    ref = _ref_table(["int64", "float64", "string"], seed=3)
    jp = jcol.pack_table(ref.to_device(CAP))
    tp = tcol.pack_table(host_table_from_reference(ref).to_device(CAP, device="cpu"))
    idx = np.random.default_rng(3).integers(0, CAP, 1000).astype(np.int32)
    jg = jp.take_rows(idx)
    tg = tp.take_rows(torch.from_numpy(idx))
    np.testing.assert_array_equal(tg.packed.numpy(), np.asarray(jg.packed))
    for name, v in jg.f64s.items():
        np.testing.assert_array_equal(tg.f64s[name].numpy(), np.asarray(v))


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 5000, (1 << 26) + 1, 150_000_000])
def test_round_capacity_matches_jax(n):
    for minimum in (128, 1024):
        assert tcol.round_capacity(n, minimum) == jcol.round_capacity(n, minimum)


def test_pydict_conversion_and_device_round_trip():
    data = {"i": [1, None, -3], "s": ["x", "y", None], "f": [1.5, None, -0.0],
            "d": ["1994-03-15", None, "2000-01-01"], "m": [1.25, 2.5, None],
            "b": [True, False, None]}
    dtypes = {"d": jcol.DATE32, "m": jcol.DECIMAL(2)}
    ref = jcol.HostTable.from_pydict(data, dtypes)
    own = tcol.HostTable.from_pydict(data, {"d": tcol.DATE32, "m": tcol.DECIMAL(2)})
    conv = host_table_from_reference(ref)
    assert conv.to_pylist() == ref.to_pylist() == own.to_pylist()
    dev = conv.to_device(device="cpu")
    assert dev.capacity == 128 and int(dev.num_rows) == 3
    assert dev.row_mask().sum() == 3
    assert dev.to_host().to_pylist() == ref.to_pylist()
    with pytest.raises(ValueError):
        conv.to_device(2, device="cpu")


def test_hstack_and_null_columns():
    a = tcol.HostTable.from_pydict({"x": [1, 2]}).to_device(device="cpu")
    schema = tcol.Schema([tcol.Field("y", tcol.FLOAT64)])
    nulls = tcol.DeviceTable(schema, tcol.null_columns_like(schema, 128, device="cpu"),
                             torch.tensor(2, dtype=torch.int32))
    h = tcol.hstack_tables(a, nulls, 2)
    assert h.to_host().to_pylist() == [{"x": 1, "y": None}, {"x": 2, "y": None}]
    with pytest.raises(ValueError):
        tcol.hstack_tables(a, tcol.HostTable.from_pydict({"z": [1]}).to_device(256, device="cpu"), 1)
