"""The port's INNER CSR hash join (K1-K4's plain versions on the CPU)
against the JAX package's `hash_join`: the same seeded tables go through
both; outputs are compared word for word and against the brute-force
oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from datafusion_parallelism_tpu.ops import join as jjoin
from datafusion_parallelism_tpu.ops.hash_table import JoinStrategy as JStrategy
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.entry import entry
from datafusion_parallelism_tpu_torch.ops import join as tjoin
from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference

from oracle import assert_rows_equal, oracle_join

NB, NP = 300, 500
DICT = jcol.Dictionary(np.array([f"s{i:03d}" for i in range(64)], dtype=object))


def _key(kind, rng, n, space):
    """(values, dtype) of a key column drawn from `space` distinct values."""
    k = rng.integers(0, space, n)
    if kind == "int32":
        return (k * 7919 - 1000).astype(np.int32), jcol.INT32
    if kind == "int64":
        return k * -(1 << 35) - 3, jcol.INT64
    if kind == "string":
        return (k % len(DICT)).astype(np.int32), jcol.STRING
    if kind == "date32":
        return (k + 8000).astype(np.int32), jcol.DATE32
    if kind == "decimal":
        return k * 125 - 10**12, jcol.DECIMAL(2)
    if kind == "bool":
        return k % 2 == 0, jcol.BOOL
    raise AssertionError(kind)


def _side(prefix, key_kinds, rng, n, space, null_frac=0.1, hot=0.0):
    data, dtypes, valid, dicts = {}, {}, {}, {}
    for i, kind in enumerate(key_kinds):
        name = f"{prefix}k{i}"
        data[name], dtypes[name] = _key(kind, rng, n, space)
        if hot:   # the same hot value on both sides
            data[name][rng.random(n) < hot] = _key(kind, rng, 1, 1)[0][0]
        valid[name] = rng.random(n) >= null_frac
        if kind == "string":
            dicts[name] = DICT
    data[f"{prefix}_f32"] = rng.random(n).astype(np.float32)
    data[f"{prefix}_f64"] = rng.normal(size=n)
    data[f"{prefix}_i64"] = rng.integers(-(1 << 60), 1 << 60, n)
    valid[f"{prefix}_f64"] = rng.random(n) >= 0.2
    host = jcol.HostTable.from_numpy(data, dtypes=dtypes, dictionaries=dicts, validity=valid)
    keys = [f"{prefix}k{i}" for i in range(len(key_kinds))]
    return host, keys


def _packed_prefix_equal(jt, tt, n):
    """Packed words of rows < n equal; validity words past n zero in both."""
    jp, tp = jcol.pack_table(jt), tcol.pack_table(tt)
    jw, tw = np.asarray(jp.packed), tp.packed.numpy()
    np.testing.assert_array_equal(tw[:, :n], jw[:, :n])
    vb = tp.layout.valid_base
    assert not jw[vb:, n:].any() and not tw[vb:, n:].any()
    for name, v in jp.f64s.items():
        np.testing.assert_array_equal(tp.f64s[name].numpy()[:n].view(np.int64),
                                      np.asarray(v)[:n].view(np.int64))


def _run_both(bhost, phost, bkeys, pkeys, out_cap):
    jout, jtotal = jjoin.hash_join(bhost.to_device(), phost.to_device(), bkeys, pkeys,
                                   jjoin.JoinType.INNER, out_cap)
    tb = host_table_from_reference(bhost).to_device(device="cpu")
    tp = host_table_from_reference(phost).to_device(device="cpu")
    tout, ttotal = tjoin.hash_join(tb, tp, bkeys, pkeys, tjoin.JoinType.INNER, out_cap)
    assert int(ttotal) == int(jtotal)
    n = int(tout.num_rows)
    assert n == int(jout.num_rows) and tout.capacity == out_cap
    assert tout.schema.names == jout.schema.names
    _packed_prefix_equal(jout, tout, n)
    return jout, tout, int(ttotal)


KEY_CASES = [("int32",), ("int64",), ("string",), ("date32",), ("decimal",), ("bool",),
             ("int32", "int64"), ("string", "decimal", "int32")]


@pytest.mark.parametrize("key_kinds", KEY_CASES, ids=["-".join(k) for k in KEY_CASES])
def test_inner_join_matches_jax_and_oracle(key_kinds):
    rng = np.random.default_rng(len(key_kinds) * 10 + KEY_CASES.index(key_kinds))
    space = 2 if key_kinds == ("bool",) else 120
    bhost, bkeys = _side("b", key_kinds, rng, NB, space)
    phost, pkeys = _side("p", key_kinds, rng, NP, space)
    out_cap = 1 << 16 if key_kinds == ("bool",) else 8192
    _, tout, total = _run_both(bhost, phost, bkeys, pkeys, out_cap)
    assert total <= out_cap
    expected = oracle_join(bhost.to_pylist(), phost.to_pylist(), bkeys, pkeys, "inner")
    assert_rows_equal(tout.to_host().to_pylist(), expected)


def test_hot_key_and_padding_match_jax():
    rng = np.random.default_rng(99)
    bhost, bkeys = _side("b", ("int64",), rng, NB, 200, hot=0.3)
    phost, pkeys = _side("p", ("int64",), rng, NP, 200, hot=0.05)
    jout, jtotal = jjoin.hash_join(bhost.to_device(1024), phost.to_device(2048), bkeys, pkeys,
                                   jjoin.JoinType.INNER, 1 << 15)
    tout, ttotal = tjoin.hash_join(host_table_from_reference(bhost).to_device(1024, device="cpu"),
                                   host_table_from_reference(phost).to_device(2048, device="cpu"),
                                   bkeys, pkeys, tjoin.JoinType.INNER, 1 << 15)
    assert int(ttotal) == int(jtotal) <= 1 << 15
    assert int(tout.num_rows) == int(jout.num_rows) > 1000
    _packed_prefix_equal(jout, tout, int(tout.num_rows))


def test_overflowing_out_cap_truncates_like_jax():
    rng = np.random.default_rng(3)
    bhost, bkeys = _side("b", ("int32",), rng, NB, 40)
    phost, pkeys = _side("p", ("int32",), rng, NP, 40)
    out_cap = 512
    _, tout, total = _run_both(bhost, phost, bkeys, pkeys, out_cap)
    assert total > out_cap
    assert int(tout.num_rows) <= out_cap


def test_plain_chain_equals_the_wrappers_on_cpu():
    rng = np.random.default_rng(4)
    bhost, bkeys = _side("b", ("int64", "int32"), rng, NB, 50)
    phost, pkeys = _side("p", ("int64", "int32"), rng, NP, 50)
    tb = host_table_from_reference(bhost).to_device(device="cpu")
    tp = host_table_from_reference(phost).to_device(device="cpu")
    a, ta = tjoin.inner_csr_join(tb, tp, bkeys, pkeys, 4096)
    b, tb_ = tjoin.inner_csr_join(tb, tp, bkeys, pkeys, 4096, tjoin.PLAIN)
    assert int(ta) == int(tb_) and int(a.num_rows) == int(b.num_rows)
    for name in a.schema.names:
        assert all(torch.equal(x, y) for x, y in zip(a.column(name), b.column(name)))


def test_entry_twin_matches_graft_entry():
    jstep, jargs = __graft_entry__.entry()
    js, jtotal = jstep(*jargs)
    tstep, targs = entry("cpu")
    ts, ttotal = tstep(*targs)
    assert int(ttotal) == int(jtotal)
    # float32 sums in another reduction order
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


def _tables(pkg):
    b = pkg.HostTable.from_numpy({"bk": np.arange(8, dtype=np.int32),
                                  "bf": np.arange(8.0),
                                  "bw": np.arange(8, dtype=np.int64)})
    p = pkg.HostTable.from_numpy({"pk": np.arange(8, dtype=np.int32) * 2,
                                  "pf": np.arange(8.0) * 2})
    if pkg is jcol:
        return b.to_device(), p.to_device()
    return b.to_device(device="cpu"), p.to_device(device="cpu")


def _residual(t):
    (bf, bv), (pf, pv) = t.column("bf"), t.column("pf")
    return bf <= pf, bv & pv


# the inputs that lay outside the INNER-only slice of the join
OUT_OF_SLICE = {
    "left_join": dict(join_type="LEFT"),
    "semi_join": dict(join_type="RIGHT_SEMI"),
    "sort_strategy": dict(strategy="SORT"),
    "oa_strategy": dict(strategy="OA"),
    "residual": dict(residual=_residual),
    "prepared": dict(prepared=True),
    "expanded": dict(expanded=True),
    "build_valid": dict(build_valid=np.arange(128) % 3 != 0),
    "probe_valid": dict(probe_valid=np.arange(128) % 2 == 0),
    "return_visited": dict(return_visited=True),
    "float_key": dict(keys=(["bf"], ["pf"])),
    "mixed_width_key": dict(keys=(["bw"], ["pk"])),
}


@pytest.mark.parametrize("case", list(OUT_OF_SLICE))
def test_out_of_slice_inputs_raise(case):
    """Every input of the former slice boundary, the SORT and OA
    strategies included, runs and gives the JAX package's rows (and mask or
    visited flags); a prepared build is each package's prepare_build of the
    same table."""
    kw = dict(OUT_OF_SLICE[case])
    jt = kw.pop("join_type", "INNER")
    bk, pk = kw.pop("keys", (["bk"], ["pk"]))
    b, p = _tables(tcol)
    jkw = dict(kw)
    if "strategy" in kw:
        kw["strategy"], jkw["strategy"] = JoinStrategy[kw["strategy"]], JStrategy[kw["strategy"]]
    if kw.get("prepared"):
        kw["prepared"] = tjoin.prepare_build(b, bk)
        jkw["prepared"] = jjoin.prepare_build(_tables(jcol)[0], bk)
    for name in ("build_valid", "probe_valid"):
        if name in kw:
            kw[name], jkw[name] = torch.from_numpy(kw[name]), jnp.asarray(jkw[name])
    got = tjoin.hash_join(b, p, bk, pk, tjoin.JoinType[jt], 128, **kw)
    want = jjoin.hash_join(*_tables(jcol), bk, pk, jjoin.JoinType[jt], 128, **jkw)
    if case == "expanded":
        (tt, tm, ttotal), (jt_, jm, jtotal) = got, want
        m = tm.numpy()
        np.testing.assert_array_equal(m, np.asarray(jm))
        for name in tt.schema.names:
            np.testing.assert_array_equal(tt.column(name)[0].numpy()[m],
                                          np.asarray(jt_.column(name)[0])[m])
    else:
        assert_rows_equal(got[0].to_host().to_pylist(), want[0].to_host().to_pylist())
        if case == "return_visited":
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[-1 if case != "return_visited" else 1]) == int(
        want[-1 if case != "return_visited" else 1])


def test_jax_strategy_enum_mirrors_the_port():
    assert [s.value for s in JStrategy] == [s.value for s in JoinStrategy]
    assert [t.value for t in jjoin.JoinType] == [t.value for t in tjoin.JoinType]
    schema = tjoin.join_output_schema(tcol.Schema([tcol.Field("a", tcol.INT32)]),
                                      tcol.Schema([tcol.Field("b", tcol.INT32)]),
                                      tjoin.JoinType.LEFT_SEMI)
    assert schema.names == ["a"]
