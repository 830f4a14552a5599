"""K12 pack_rows, K13 append_rows and K10's accumulate mode: their plain
versions (what the wrappers run on CPU tensors) against the JAX code they
replace, on seeded inputs. K12 against `pack_table` / `unpack_table` word
for word (every kind, NULLs, more than 32 fields, int64 extremes, -0.0 and
NaN float32); the copied `pack_host_slice` against the JAX one; K13
against the row-union append of runtime/grace.py:544-553 (reproduced
here); K10's accumulate mode against `incoming | vis`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import append_rows as k13
from datafusion_parallelism_tpu_torch.kernels import match_flags as k10
from datafusion_parallelism_tpu_torch.kernels import pack_rows as k12
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference

N, CAP = 300, 512
KINDS = [k.value for k in jcol.Kind]


def _values(kind, rng, n=N):
    if kind in ("int32", "date32"):
        v = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
        v[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        return v
    if kind in ("int64", "decimal"):
        v = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        v[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 1 << 32]
        return v
    if kind == "float32":
        v = rng.normal(size=n).astype(np.float32)
        v[:4] = [0.0, -0.0, np.nan, -np.inf]
        return v
    if kind == "float64":
        v = rng.normal(size=n)
        v[:3] = [-0.0, np.nan, np.inf]
        return v
    if kind == "bool":
        return rng.random(n) < 0.5
    return rng.integers(0, 5, n).astype(np.int32)   # string codes


def _ref_table(kinds, seed, n=N):
    """A JAX-package HostTable, column i of kind kinds[i], ~20% NULLs."""
    rng = np.random.default_rng(seed)
    data, dtypes, valid, dicts = {}, {}, {}, {}
    for i, kind in enumerate(kinds):
        name = f"c{i}_{kind}"
        data[name] = _values(kind, rng, n)
        valid[name] = rng.random(n) >= 0.2
        k = jcol.Kind(kind)
        dtypes[name] = jcol.DType(k, 2 if k is jcol.Kind.DECIMAL else 0)
        if k is jcol.Kind.STRING:
            dicts[name] = jcol.Dictionary(np.array(list("abcde"), dtype=object))
    return jcol.HostTable.from_numpy(data, dtypes=dtypes, dictionaries=dicts, validity=valid)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32) \
        if a.dtype.kind == "f" else a


TABLES = {"every kind": KINDS,
          "40 fields, two validity words": [KINDS[i % len(KINDS)] for i in range(40)],
          "int64 and float32 only": ["int64", "float32", "decimal", "float32"]}


@pytest.mark.parametrize("name", list(TABLES))
def test_pack_and_unpack_match_jax(name):
    ref = _ref_table(TABLES[name], seed=len(TABLES[name]))
    jt = ref.to_device(CAP)
    tt = host_table_from_reference(ref).to_device(CAP, device="cpu")
    jp = jcol.pack_table(jt)
    layout = tcol.packed_layout(tt.schema)
    cols = [tt.columns[f[0]] for f in layout.fields]
    words = k12.pack_rows(layout, cols)            # the wrapper: plain on the CPU
    np.testing.assert_array_equal(words.numpy(), np.asarray(jp.packed))
    assert layout.width == words.shape[0] and (layout.width - layout.valid_base) == \
        (len(layout.fields) + 31) // 32

    back = k12.unpack_rows(layout, words)
    want = jcol.unpack_table(jp, jt.schema, jt.num_rows)
    for (fname, kind, _, _), (v, valid) in zip(layout.fields, back):
        jv, jvalid = want.columns[fname]
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        if v is None:
            assert kind is tcol.Kind.FLOAT64
            continue
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(jv))
    # pack_table / unpack_table reach K12 and round-trip the table
    rt = tcol.unpack_table(tcol.pack_table(tt), tt.schema, tt.num_rows)
    for fname in tt.schema.names:
        np.testing.assert_array_equal(_bits(rt.columns[fname][0].numpy()),
                                      _bits(tt.columns[fname][0].numpy()))
        np.testing.assert_array_equal(rt.columns[fname][1].numpy(),
                                      tt.columns[fname][1].numpy())


def test_launch_split_keeps_validity_words_whole():
    """A table past K12's 128 fields a launch splits at multiples of 32
    fields, each launch writing its own validity rows."""
    kinds = [KINDS[i % len(KINDS)] for i in range(300)]
    schema = host_table_from_reference(_ref_table(kinds, 3, n=4)).schema
    layout = tcol.packed_layout(schema)
    launches = list(k12._launches(layout))
    assert [n for _, n, _ in launches] == [128, 128, 44]
    assert [lo for lo, _, _ in launches] == [0, 128, 256]
    assert [row - layout.valid_base for _, _, row in launches] == [0, 4, 8]
    assert layout.width - layout.valid_base == 10


@pytest.mark.parametrize("rows", [None, "scattered"])
@pytest.mark.parametrize("n, lo", [(300, 0), (117, 40)])
def test_pack_host_slice_matches_jax(rows, n, lo):
    ref = _ref_table(KINDS + ["int32", "int64"], seed=5, n=400)
    host = host_table_from_reference(ref)
    names = [f.name for f in ref.schema.fields if not f.name.startswith("c2")]
    sel = np.sort(np.random.default_rng(1).choice(400, n, replace=False)) \
        if rows else None
    js, jl, jw, jf = jcol.pack_host_slice(ref, names, lo, n, CAP, rename_prefix="t.",
                                          rows=sel)
    ts, tl, tw, tf = tcol.pack_host_slice(host, names, lo, n, CAP, rename_prefix="t.",
                                          rows=sel)
    assert ts.names == js.names and tl.width == jl.width
    np.testing.assert_array_equal(tw, jw)
    assert list(tf) == list(jf)
    for k in jf:
        np.testing.assert_array_equal(_bits(tf[k]), _bits(jf[k]))
    # into used buffers (the pinned pool's): stale rows are cleared
    out = (np.full((tl.width, CAP), -7, np.int32),
           np.full((len(tl.f64_fields), CAP), 3.5, np.float64))
    _, _, ow, of = tcol.pack_host_slice(host, names, lo, n, CAP, rename_prefix="t.",
                                        rows=sel, out=out)
    assert ow is out[0]
    np.testing.assert_array_equal(ow, jw)
    for k in jf:
        np.testing.assert_array_equal(_bits(of[k]), _bits(jf[k]))


def _jax_union_append(acc_cols, acc_rows, acc_cap, out_cols, out_cap, out_rows):
    """runtime/grace.py:544-553, as the JAX package runs it."""
    idx = jnp.arange(out_cap, dtype=jnp.int32) + acc_rows
    valid_row = jnp.arange(out_cap) < out_rows
    idx = jnp.where(valid_row, idx, acc_cap)
    res = {}
    for name, (av, avalid) in acc_cols.items():
        v, vv = out_cols[name]
        res[name] = (av.at[idx].set(v, mode="drop"),
                     avalid.at[idx].set(vv & valid_row, mode="drop"))
    return res, acc_rows + out_rows


UNION_KINDS = ["int32", "int64", "float64", "bool", "float32"]


@pytest.mark.parametrize("acc_rows, out_rows, acc_cap, cap, kinds",
                         [(0, 200, 1024, 256, UNION_KINDS), (700, 250, 1024, 256, UNION_KINDS),
                          (900, 250, 1024, 256, UNION_KINDS), (1024, 5, 1024, 256, UNION_KINDS),
                          (701, 250, 1024, 256, UNION_KINDS), (702, 3, 1024, 256, UNION_KINDS),
                          (703, 256, 1024, 256, UNION_KINDS), (37, 0, 1024, 256, UNION_KINDS),
                          (3, 400, 256, 512, UNION_KINDS),
                          (333, 250, 1024, 256, ["int32", "int64", "bool", "float32"])],
                         ids=["first", "fits", "drops past acc_cap", "full",
                              "acc_rows 1 mod 4", "acc_rows 2 mod 4", "acc_rows 3 mod 4",
                              "no rows", "partition capacity past acc_cap", "no float64 column"])
def test_append_rows_matches_jax_union(acc_rows, out_rows, acc_cap, cap, kinds):
    """K13's plain version against the JAX row-union append: packed words
    and float64 bits equal exactly (tolerance: none), the count too."""
    ref = _ref_table(kinds, seed=9, n=cap)
    part = ref.to_device(cap)
    part = jcol.DeviceTable(part.schema, part.columns, jnp.int32(out_rows))
    prev = _ref_table(kinds, seed=10, n=acc_cap)
    acc = prev.to_device(acc_cap)
    # rows past acc_rows of an accumulator are never written before: zeros
    zero_past = jnp.arange(acc_cap) < acc_rows
    acc_cols = {k: (jnp.where(zero_past, v, jnp.zeros_like(v)), vv & zero_past)
                for k, (v, vv) in acc.columns.items()}
    want, want_rows = _jax_union_append(acc_cols, jnp.int32(acc_rows), acc_cap,
                                        part.columns, cap, out_rows)
    want_t = jcol.pack_table(jcol.DeviceTable(acc.schema, want, want_rows))

    def f64_rows(pt, n):
        return torch.from_numpy(np.stack([np.array(v) for v in pt.f64s.values()])
                                if pt.f64s else np.zeros((0, n)))

    jp = jcol.pack_table(jcol.DeviceTable(acc.schema, acc_cols, jnp.int32(acc_rows)))
    words = torch.from_numpy(np.array(jp.packed))
    f64 = f64_rows(jp, acc_cap)
    pp = jcol.pack_table(part)
    new_rows = k13.append_rows(words, f64, torch.tensor(acc_rows, dtype=torch.int32),
                               torch.from_numpy(np.array(pp.packed)), f64_rows(pp, cap),
                               torch.tensor(out_rows, dtype=torch.int32))
    assert int(new_rows) == int(want_rows) and new_rows.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), np.asarray(want_t.packed))
    assert f64.shape[0] == len(want_t.f64s)
    for i, v in enumerate(want_t.f64s.values()):
        np.testing.assert_array_equal(_bits(f64[i].numpy()), _bits(v))


def test_match_flags_accumulate_is_incoming_or_matches():
    rng = np.random.default_rng(4)
    n, bcap, mcap = 1000, 300, 200
    match = torch.from_numpy(rng.random(n) < 0.3)
    build_id = torch.from_numpy(rng.integers(0, bcap, n).astype(np.int32))
    probe_idx = torch.from_numpy(rng.integers(0, mcap, n).astype(np.int32))
    fresh, matched = k10.match_flags(match, build_id, probe_idx, bcap, mcap)
    incoming = torch.from_numpy(rng.random(bcap) < 0.2)
    want = incoming | fresh
    buf = incoming.clone()
    vis, matched_acc = k10.match_flags(match, build_id, probe_idx, bcap, mcap, buf)
    assert vis is buf                                  # in place
    assert torch.equal(vis, want)
    assert torch.equal(matched_acc, matched)           # probe flags start fresh
    # a second pass (a chunk retried after an overflow) changes nothing
    k10.match_flags(match, build_id, probe_idx, bcap, mcap, buf)
    assert torch.equal(buf, want)
