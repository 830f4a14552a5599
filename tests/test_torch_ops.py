"""The port's single-table operators (filter, project, hash aggregate,
sort, limit and the expressions) against the JAX package's: the same seeded
host tables go through both, with K5-K8's plain versions on the CPU.

Tolerances: bit-exact for counts, integer and decimal sums, min/max, group
keys, validity, orders and every expression value; float64 AVG of an exact
sum within rtol 1e-12; float64 sums (and AVGs built on them) within
rtol 1e-9 + 1e-12 * sum|x|, since the two packages reduce in different
orders. Values under a false validity bit are not compared."""

import math
import random

import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import aggregate as jagg
from datafusion_parallelism_tpu.ops import expressions as jex
from datafusion_parallelism_tpu.ops import filter as jfilter
from datafusion_parallelism_tpu.ops import project as jproject
from datafusion_parallelism_tpu.ops import sort as jsort
from datafusion_parallelism_tpu.ops.hashing import hash_rows as jhash_rows
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.ops import aggregate as tagg
from datafusion_parallelism_tpu_torch.ops import filter as tfilter
from datafusion_parallelism_tpu_torch.ops import project as tproject
from datafusion_parallelism_tpu_torch.ops import sort as tsort
from datafusion_parallelism_tpu_torch.ops.hashing import hash_rows as thash_rows
from datafusion_parallelism_tpu_torch.utils.convert import (expr_from_reference,
                                                           host_table_from_reference)

from oracle import assert_rows_equal

FLOAT_RTOL, FLOAT_ATOL_PER_ABS = 1e-9, 1e-12
AVG_RTOL = 1e-12


def both(host, capacity=None):
    """(JAX DeviceTable, port DeviceTable on the CPU) of one host table."""
    return (host.to_device(capacity),
            host_table_from_reference(host).to_device(capacity, device="cpu"))


def rows_of(port_table):
    return port_table.to_host().to_pylist()


def ref_rows(jax_table):
    return jax_table.to_host().to_pylist()


def assert_columns_equal(jt, tt, n, names=None, float_tol=None):
    """Columns of two tables over rows < n: validity equal, values equal
    where valid (floats within float_tol[name] = (rtol, atol) where given,
    else bit for bit)."""
    float_tol = float_tol or {}
    for name in names or jt.schema.names:
        jv, jm = (np.asarray(a)[:n] for a in jt.column(name))
        tv, tm = (a[:n].numpy() for a in tt.column(name))
        np.testing.assert_array_equal(tm, jm, err_msg=f"{name} validity")
        jv, tv = jv[jm], tv[jm]
        if name in float_tol:
            rtol, atol = float_tol[name]
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol, err_msg=name)
        else:
            if jv.dtype.kind == "f":
                jv, tv = jv.view(f"i{jv.itemsize}"), tv.view(f"i{tv.itemsize}")
            np.testing.assert_array_equal(tv, jv, err_msg=name)


# ---------------------------------------------------------------------------
# tests/test_ops.py:26-196, through the port, against the same python oracles
# and against the JAX package
# ---------------------------------------------------------------------------

def dt(data, **kw):
    return both(jcol.HostTable.from_pydict(data, **kw))


def _project_both(tables, exprs):
    jt, tt = tables
    jout = jproject.project_table(jt, exprs)
    tout = tproject.project_table(tt, [(expr_from_reference(e), n) for e, n in exprs])
    assert rows_of(tout) == ref_rows(jout)
    return rows_of(tout)


def _filter_both(tables, pred, out_cap=None):
    jt, tt = tables
    jout, jn = jfilter.filter_table(jt, pred, out_cap)
    tout, tn = tfilter.filter_table(tt, expr_from_reference(pred), out_cap)
    assert int(tn) == int(jn)
    assert rows_of(tout) == ref_rows(jout)
    return tout


def test_arith_and_comparison_with_nulls():
    rows = _project_both(dt({"a": [1, 2, None, 4], "b": [10, None, 30, 40]}), [
        (jex.BinOp("+", jex.Col("a"), jex.Col("b")), "s"),
        (jex.BinOp("<", jex.Col("a"), jex.Lit(3, jcol.INT32)), "lt"),
        (jex.IsNull(jex.Col("a")), "an"),
    ])
    assert [r["s"] for r in rows] == [11, None, None, 44]
    assert [r["lt"] for r in rows] == [True, True, None, False]
    assert [r["an"] for r in rows] == [False, False, True, False]


def test_three_valued_logic():
    rows = _project_both(dt({"a": [True, True, None, False, None],
                             "b": [True, None, False, None, None]}), [
        (jex.BinOp("and", jex.Col("a"), jex.Col("b")), "and_"),
        (jex.BinOp("or", jex.Col("a"), jex.Col("b")), "or_"),
    ])
    assert [r["and_"] for r in rows] == [True, None, False, False, None]
    assert [r["or_"] for r in rows] == [True, True, None, None, None]


def test_filter_null_rejects():
    out = _filter_both(dt({"a": [1, None, 3, 4], "v": [10, 20, 30, 40]}),
                       jex.BinOp(">", jex.Col("a"), jex.Lit(1, jcol.INT32)))
    assert [r["v"] for r in rows_of(out)] == [30, 40]


def test_case_and_coalesce():
    rows = _project_both(dt({"a": [1, 2, 3, None]}), [
        (jex.Case([(jex.BinOp("=", jex.Col("a"), jex.Lit(1, jcol.INT32)),
                    jex.Lit(100, jcol.INT32)),
                   (jex.BinOp("=", jex.Col("a"), jex.Lit(2, jcol.INT32)),
                    jex.Lit(200, jcol.INT32))], jex.Lit(0, jcol.INT32)), "c"),
        (jex.Coalesce([jex.Col("a"), jex.Lit(-1, jcol.INT32)]), "co"),
    ])
    assert [r["c"] for r in rows] == [100, 200, 0, 0]
    assert [r["co"] for r in rows] == [1, 2, 3, -1]


def test_extract_date_parts():
    rows = _project_both(dt({"d": ["1992-01-01", "1995-06-17", "1998-12-31", "2000-02-29"]},
                            dtypes={"d": jcol.DATE32}), [
        (jex.ExtractDatePart("year", jex.Col("d")), "y"),
        (jex.ExtractDatePart("month", jex.Col("d")), "m"),
        (jex.ExtractDatePart("day", jex.Col("d")), "dd"),
    ])
    assert [r["y"] for r in rows] == [1992, 1995, 1998, 2000]
    assert [r["m"] for r in rows] == [1, 6, 12, 2]
    assert [r["dd"] for r in rows] == [1, 17, 31, 29]


def test_in_codes_string_predicate():
    tables = dt({"s": ["apple", "banana", "cherry", None, "apple"]})
    d = tables[0].schema.field("s").dictionary
    codes = np.array([d.code_of("apple"), d.code_of("cherry")], dtype=np.int32)
    out = _filter_both(tables, jex.InCodes(jex.Col("s"), codes))
    assert [r["s"] for r in rows_of(out)] == ["apple", "cherry", "apple"]


def test_decimal_arithmetic():
    rows = _project_both(dt({"price": [10.50, 3.25], "disc": [0.10, 0.00]},
                            dtypes={"price": jcol.DECIMAL(2), "disc": jcol.DECIMAL(2)}), [
        (jex.BinOp("*", jex.Col("price"),
                   jex.BinOp("-", jex.Lit(1, jcol.INT32), jex.Col("disc"))), "rev"),
    ])
    assert abs(rows[0]["rev"] - 10.50 * 0.9) < 1e-9
    assert abs(rows[1]["rev"] - 3.25) < 1e-9


def _agg_both(tables, keys, aggs, out_cap=None, row_filter=None):
    """(port rows, port table, n_groups) after checking the port's table
    against the JAX package's."""
    jt, tt = tables
    jrf = None if row_filter is None else jt.row_mask() & row_filter
    trf = None if row_filter is None else torch.from_numpy(np.asarray(row_filter))
    jout, jn = jagg.hash_aggregate_counted(jt, keys, aggs, out_cap, jrf)
    tout, tn = tagg.hash_aggregate_counted(tt, keys, [expr_from_reference(a) for a in aggs],
                                           out_cap, trf)
    assert int(tn) == int(jn) and int(tout.num_rows) == int(jout.num_rows)
    assert tout.capacity == jout.capacity
    return jout, tout, int(tn)


def test_aggregate_grouped():
    rng = random.Random(5)
    ks = [rng.randrange(6) if rng.random() > 0.1 else None for _ in range(200)]
    vs = [rng.randrange(100) if rng.random() > 0.1 else None for _ in range(200)]
    aggs = [jagg.AggSpec("sum", "v", "s"), jagg.AggSpec("count", "v", "c"),
            jagg.AggSpec("count_star", None, "cs"), jagg.AggSpec("min", "v", "mn"),
            jagg.AggSpec("max", "v", "mx"), jagg.AggSpec("avg", "v", "a")]
    jout, tout, _ = _agg_both(dt({"k": ks, "v": vs}), ["k"], aggs)
    rows = rows_of(tout)
    assert_columns_equal(jout, tout, int(tout.num_rows), float_tol={"a": (AVG_RTOL, 0)})
    groups = {}
    for k, v in zip(ks, vs):
        groups.setdefault(k, []).append(v)
    expected = []
    for k, vals in groups.items():
        nn = [v for v in vals if v is not None]
        expected.append({
            "k": k, "s": sum(nn) if nn else None, "c": len(nn), "cs": len(vals),
            "mn": min(nn) if nn else None, "mx": max(nn) if nn else None,
            "a": (sum(nn) / len(nn)) if nn else None,
        })
    assert_rows_equal(rows, expected)


def test_aggregate_global():
    aggs = [jagg.AggSpec("sum", "v", "s"), jagg.AggSpec("count_star", None, "c"),
            jagg.AggSpec("avg", "v", "a")]
    jout, tout, _ = _agg_both(dt({"v": [1, 2, None, 4]}), [], aggs)
    assert_columns_equal(jout, tout, 1)
    assert_rows_equal(rows_of(tout), [{"s": 7, "c": 4, "a": 7 / 3}])


def test_aggregate_empty_input():
    tables = dt({"k": [1], "v": [1]})
    pred = jex.BinOp("<", jex.Col("v"), jex.Lit(0, jcol.INT32))
    jt, _ = jfilter.filter_table(tables[0], pred)
    tt, _ = tfilter.filter_table(tables[1], expr_from_reference(pred))
    _, tout, n = _agg_both((jt, tt), ["k"], [jagg.AggSpec("sum", "v", "s")])
    assert n == 0 and rows_of(tout) == []


def test_aggregate_hash_collision_groups():
    tables = dt({"a": [i % 13 for i in range(100)], "b": [i % 7 for i in range(100)],
                 "v": list(range(100))})
    jout, tout, _ = _agg_both(tables, ["a", "b"], [jagg.AggSpec("sum", "v", "s")])
    assert_columns_equal(jout, tout, int(tout.num_rows))
    groups = {}
    for i in range(100):
        groups[(i % 13, i % 7)] = groups.get((i % 13, i % 7), 0) + i
    assert_rows_equal(rows_of(tout),
                      [{"a": a, "b": b, "s": s} for (a, b), s in groups.items()])


def test_sort_multi_key_nulls_and_desc():
    jt, tt = dt({"a": [3, 1, None, 2, 1], "b": [1.0, None, 2.0, 0.5, 9.0]})
    keys = [jsort.SortKey("a", ascending=True, nulls_first=False),
            jsort.SortKey("b", ascending=False, nulls_first=True)]
    out = tsort.sort_table(tt, [expr_from_reference(k) for k in keys])
    assert rows_of(out) == ref_rows(jsort.sort_table(jt, keys))
    assert [(r["a"], r["b"]) for r in rows_of(out)] == [
        (1, None), (1, 9.0), (2, 0.5), (3, 1.0), (None, 2.0)]


def test_sort_strings_and_limit():
    jt, tt = dt({"s": ["pear", "apple", None, "fig"]})
    out = tsort.sort_table(tt, [tsort.SortKey("s")])
    jout = jsort.sort_table(jt, [jsort.SortKey("s")])
    assert [r["s"] for r in rows_of(out)] == ["apple", "fig", "pear", None]
    out2 = tsort.limit_table(out, 2)
    assert rows_of(out2) == ref_rows(jsort.limit_table(jout, 2))
    assert [r["s"] for r in rows_of(out2)] == ["apple", "fig"]


def test_filter_then_aggregate_pipeline():
    tables = dt({"k": [i % 4 for i in range(64)], "v": list(range(64))})
    f = _filter_both(tables, jex.BinOp(">", jex.Col("v"), jex.Lit(10, jcol.INT32)))
    out = tagg.hash_aggregate(f, ["k"], [tagg.AggSpec("sum", "v", "s")])
    groups = {}
    for i in range(11, 64):
        groups[i % 4] = groups.get(i % 4, 0) + i
    assert_rows_equal(rows_of(out), [{"k": k, "s": s} for k, s in groups.items()])


def test_groupby_hash_collision_interleaved_exact():
    """Two distinct composite keys whose row hashes collide, interleaved:
    the port's grouping sort must keep each key's rows together, exactly as
    the JAX package's does (tests/test_ops.py:196)."""
    a, b = 37513, 160754
    ones2 = torch.ones(2, dtype=torch.bool)
    h = thash_rows([(torch.tensor([a, b], dtype=torch.int32), ones2),
                    (torch.zeros(2, dtype=torch.int32), ones2)])
    jh = np.asarray(jhash_rows([(np.array([a, b], np.int32), np.ones(2, bool)),
                                (np.zeros(2, np.int32), np.ones(2, bool))]))
    assert int(h[0]) == int(h[1]), "expected a colliding pair; the hash changed"
    np.testing.assert_array_equal(h.numpy().view(np.uint32), jh.view(np.uint32))
    tables = dt({"k1": [a, b, a, b, a], "k2": [0] * 5, "v": [1] * 5})
    jout, tout, n = _agg_both(tables, ["k1", "k2"], [jagg.AggSpec("sum", "v", "s")])
    assert n == 2
    assert_columns_equal(jout, tout, n)
    assert sorted((r["k1"], r["s"]) for r in rows_of(tout)) == [(a, 3), (b, 2)]


# ---------------------------------------------------------------------------
# seeded parity: expressions
# ---------------------------------------------------------------------------

N = 300
CAP = 512


def _expr_table():
    rng = np.random.default_rng(7)
    data = {
        "i": rng.integers(-50, 50, N).astype(np.int32),
        "j": rng.integers(-5, 5, N).astype(np.int32),
        "l": rng.integers(-(1 << 40), 1 << 40, N),
        "d2": rng.integers(-99999, 99999, N),
        "d1": rng.integers(0, 100, N),
        "f": rng.normal(size=N) * 10,
        "g": rng.normal(size=N).astype(np.float32),
        "b": rng.random(N) < 0.5,
        "s": rng.integers(0, 6, N).astype(np.int32),
        "day": rng.integers(-800_000, 3_000_000, N).astype(np.int32),
    }
    data["j"][:20] = 0
    valid = {k: rng.random(N) >= 0.15 for k in data}
    dtypes = {"d2": jcol.DECIMAL(2), "d1": jcol.DECIMAL(1), "s": jcol.STRING,
              "day": jcol.DATE32}
    dicts = {"s": jcol.Dictionary(np.array(list("abcdef"), dtype=object))}
    return jcol.HostTable.from_numpy(data, dtypes=dtypes, dictionaries=dicts, validity=valid)


C, L = jex.Col, jex.Lit
EXPRS = {
    "int_arith": jex.BinOp("-", jex.BinOp("*", C("i"), C("j")), jex.BinOp("+", C("i"), L(3, jcol.INT32))),
    "int_div_by_zero": jex.BinOp("/", C("i"), C("j")),
    "int_mod_by_zero": jex.BinOp("%", C("i"), C("j")),
    "int64_mixed": jex.BinOp("+", C("l"), C("i")),
    "decimal_mul": jex.BinOp("*", C("d2"), jex.BinOp("-", L(1, jcol.INT32), C("d1"))),
    "decimal_add_scales": jex.BinOp("+", C("d2"), C("d1")),
    "decimal_falls_to_float": jex.BinOp("*", jex.BinOp("*", C("d2"), C("d2")), C("d1")),
    "decimal_div": jex.BinOp("/", C("d2"), C("d1")),
    "float_div": jex.BinOp("/", C("f"), jex.BinOp("-", C("g"), C("g"))),
    "float_mod": jex.BinOp("%", C("f"), L(3.0, jcol.FLOAT64)),
    "cmp_decimal_int": jex.BinOp(">=", C("d2"), C("i")),
    "cmp_decimal_decimal": jex.BinOp("<", C("d2"), C("d1")),
    "cmp_float_int": jex.BinOp("<>", C("f"), C("i")),
    "cmp_string": jex.BinOp("=", C("s"), L(2, jcol.STRING)),
    "and_or_not": jex.BinOp("or", jex.BinOp("and", C("b"), jex.Not(C("b"))),
                            jex.BinOp(">", C("i"), L(0, jcol.INT32))),
    "is_not_null": jex.IsNull(C("f"), negated=True),
    "cast_float": jex.Cast(C("d2"), jcol.FLOAT64),
    "cast_decimal": jex.Cast(C("f"), jcol.DECIMAL(2)),
    "cast_int": jex.Cast(C("l"), jcol.INT32),
    "in_codes": jex.InCodes(C("s"), np.array([1, 4], dtype=np.int32)),
    "not_in_codes": jex.InCodes(C("i"), np.array([-3, 0, 7], dtype=np.int32), negated=True),
    "case": jex.Case([(jex.BinOp("<", C("i"), L(0, jcol.INT32)), C("l")),
                      (C("b"), C("i"))], L(None, jcol.INT64)),
    "coalesce": jex.Coalesce([C("f"), C("g"), L(-1.5, jcol.FLOAT64)]),
    "year": jex.ExtractDatePart("year", C("day")),
    "month": jex.ExtractDatePart("month", C("day")),
    "day": jex.ExtractDatePart("day", C("day")),
    "decimal_lit": jex.BinOp("<=", C("d2"), L(12.34, jcol.DECIMAL(2))),
}


@pytest.fixture(scope="module")
def expr_tables():
    return both(_expr_table(), CAP)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name, expr_tables):
    jt, tt = expr_tables
    jv, jm, jdt = EXPRS[name].eval(jt)
    tv, tm, tdt = expr_from_reference(EXPRS[name]).eval(tt)
    assert (tdt.kind.value, tdt.scale) == (jdt.kind.value, jdt.scale)
    jv, jm = np.asarray(jv), np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert tv.numpy().dtype == jv.dtype
    if jv.dtype.kind == "f":
        jv, tv = jv.view(f"i{jv.itemsize}"), tv.numpy().view(f"i{jv.itemsize}")
    else:
        tv = tv.numpy()
    np.testing.assert_array_equal(tv[jm], jv[jm])


# ---------------------------------------------------------------------------
# seeded parity: filter, project, sort, limit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_cap", [None, 256, 64])
def test_filter_table_matches_jax(out_cap, expr_tables):
    jt, tt = expr_tables
    pred = jex.BinOp("and", jex.BinOp(">", C("i"), L(-20, jcol.INT32)), jex.Not(C("b")))
    jout, jn = jfilter.filter_table(jt, pred, out_cap)
    tout, tn = tfilter.filter_table(tt, expr_from_reference(pred), out_cap)
    n = int(jout.num_rows)
    assert int(tn) == int(jn) and int(tout.num_rows) == n
    assert tout.capacity == jout.capacity
    if out_cap == 64:
        assert int(jn) > out_cap       # the overflow case
    assert_columns_equal(jout, tout, n)
    for _, tm in tout.columns.values():   # validity past n is zero
        assert not tm[n:].any()


def test_filter_table_keeps_nothing(expr_tables):
    jt, tt = expr_tables
    pred = jex.BinOp(">", C("i"), L(1000, jcol.INT32))
    jout, _ = jfilter.filter_table(jt, pred)
    tout, tn = tfilter.filter_table(tt, expr_from_reference(pred))
    assert int(tn) == 0 == int(jout.num_rows)
    assert not any(tm.any() for _, tm in tout.columns.values())


def test_project_table_out_fields_matches_jax(expr_tables):
    jt, tt = expr_tables
    exprs = [(EXPRS["decimal_mul"], "rev"), (C("s"), "s2"), (EXPRS["case"], "c")]
    fields = [jcol.Field("rev", jcol.DECIMAL(3), False), jcol.Field("s2", jcol.STRING),
              jcol.Field("c", jcol.INT64)]
    jout = jproject.project_table(jt, exprs, fields)
    tout = tproject.project_table(tt, [(expr_from_reference(e), n) for e, n in exprs],
                                  [expr_from_reference(f) for f in fields])
    assert [(f.name, f.dtype.kind.value, f.dtype.scale, f.nullable)
            for f in tout.schema.fields] == [(f.name, f.dtype.kind.value, f.dtype.scale,
                                              f.nullable) for f in jout.schema.fields]
    assert_columns_equal(jout, tout, N)


def _sort_table_host():
    rng = np.random.default_rng(11)
    n = 400
    f = rng.normal(size=n)
    f[rng.random(n) < 0.1] = -0.0
    f[rng.random(n) < 0.1] = 0.0
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -np.nan
    f[rng.random(n) < 0.05] = np.inf
    f[rng.random(n) < 0.05] = -np.inf
    data = {"i": rng.integers(-3, 3, n).astype(np.int32),
            "l": rng.choice(np.array([-(1 << 62) + 1, -1, 0, 5, (1 << 62) - 1, 1 << 40]), n),
            "f": f, "g": f.astype(np.float32),
            "s": rng.integers(0, 5, n).astype(np.int32),
            "d": rng.integers(-500, 500, n), "b": rng.random(n) < 0.5,
            "row": np.arange(n, dtype=np.int32)}
    valid = {k: rng.random(n) >= 0.1 for k in data if k != "row"}
    return jcol.HostTable.from_numpy(
        data, dtypes={"s": jcol.STRING, "d": jcol.DECIMAL(2)},
        dictionaries={"s": jcol.Dictionary(np.array(list("abcde"), dtype=object))},
        validity=valid)


SORTS = {
    "int_asc": [("i", True, False)],
    "int64_extremes_desc": [("l", False, False)],
    "float_nan_neg_zero_asc": [("f", True, False)],
    "float_desc_nulls_last": [("f", False, False)],
    "float32_nulls_first": [("g", True, True)],
    "string_desc": [("s", False, True)],
    "multi_decimal_bool_int": [("d", True, False), ("b", False, False), ("i", True, True)],
    "multi_string_float": [("s", True, False), ("f", False, True)],
}


@pytest.fixture(scope="module")
def sort_tables():
    return both(_sort_table_host(), 512)


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_table_matches_jax(name, sort_tables):
    jt, tt = sort_tables
    keys = [jsort.SortKey(c, a, nf) for c, a, nf in SORTS[name]]
    jout = jsort.sort_table(jt, keys)
    tout = tsort.sort_table(tt, [expr_from_reference(k) for k in keys])
    n = int(jout.num_rows)
    assert int(tout.num_rows) == n and tout.capacity == jout.capacity
    assert_columns_equal(jout, tout, n)


@pytest.mark.parametrize("n", [0, 7, 400, 1000])
def test_limit_table_matches_jax(n, sort_tables):
    jt, tt = sort_tables
    assert int(tsort.limit_table(tt, n).num_rows) == int(jsort.limit_table(jt, n).num_rows)


def test_host_sort_table_matches_jax():
    host = _sort_table_host()
    keys = [jsort.SortKey("s", False, True), jsort.SortKey("f", True, False)]
    ref = jsort.host_sort_table(host, keys)
    got = tsort.host_sort_table(host_table_from_reference(host),
                                [expr_from_reference(k) for k in keys])
    for name in host.schema.names:
        np.testing.assert_array_equal(got.columns[name][0].view(np.uint8),
                                      ref.columns[name][0].view(np.uint8))


# ---------------------------------------------------------------------------
# seeded parity: hash_aggregate_counted, every path
# ---------------------------------------------------------------------------

def _agg_table_host():
    rng = np.random.default_rng(3)
    n = 600
    f = rng.normal(size=n) * 100
    fk = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.inf]), n)
    data = {"k32": rng.integers(-40, 40, n).astype(np.int32),
            "k64": rng.integers(-3, 3, n) * (1 << 36),
            "kd": rng.integers(0, 30, n).astype(np.int32),
            "ks": rng.integers(0, 4, n).astype(np.int32),
            "kb": rng.random(n) < 0.3,
            "kf": fk,
            "v32": rng.integers(-1000, 1000, n).astype(np.int32),
            "v64": rng.integers(-(1 << 50), 1 << 50, n),
            "vd": rng.integers(-10**6, 10**6, n),
            "vf": f, "vg": f.astype(np.float32)}
    valid = {k: rng.random(n) >= 0.1 for k in data}
    return jcol.HostTable.from_numpy(
        data, dtypes={"kd": jcol.DATE32, "ks": jcol.STRING, "vd": jcol.DECIMAL(2)},
        dictionaries={"ks": jcol.Dictionary(np.array(list("wxyz"), dtype=object))},
        validity=valid)


AGGS = [jagg.AggSpec("sum", "v32", "s32"), jagg.AggSpec("sum", "v64", "s64"),
        jagg.AggSpec("sum", "vd", "sd"), jagg.AggSpec("sum", "vf", "sf"),
        jagg.AggSpec("sum", "vg", "sg"), jagg.AggSpec("avg", "vd", "ad"),
        jagg.AggSpec("avg", "vf", "af"), jagg.AggSpec("min", "v32", "mn32"),
        jagg.AggSpec("max", "vd", "mxd"), jagg.AggSpec("min", "vf", "mnf"),
        jagg.AggSpec("max", "vg", "mxg"), jagg.AggSpec("count", "v64", "c64"),
        jagg.AggSpec("count_star", None, "cs")]
AGG_CASES = {
    # name: (group keys, out_cap)
    "global": ([], None),
    "direct_string": (["ks"], None),
    "direct_string_bool": (["ks", "kb"], None),
    "sorted_int32": (["k32"], None),
    "sorted_date": (["kd"], None),
    "sorted_bool_and_int32": (["kb", "k32"], None),
    "hash_int64": (["k64"], None),
    "hash_int64_string": (["k64", "ks"], None),
    "hash_float": (["kf"], None),
}


@pytest.fixture(scope="module")
def agg_tables():
    return both(_agg_table_host(), 1024)


def _float_tols(host, aggs, groups_of=None):
    """rtol 1e-9 + 1e-12 * sum|x| for float sums and their AVGs (sum|x|
    over the whole column bounds every group's), rtol 1e-12 for the AVG of
    an exact sum."""
    tol = {}
    for a in aggs:
        if a.func not in ("sum", "avg"):
            continue
        v, m = host.columns[a.input]
        if v.dtype.kind == "f":
            tol[a.output] = (FLOAT_RTOL, FLOAT_ATOL_PER_ABS * float(np.abs(v[m]).sum()))
        elif a.func == "avg":
            tol[a.output] = (AVG_RTOL, 0)
    return tol


@pytest.mark.parametrize("row_filter", [False, True], ids=["all_rows", "row_filter"])
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_hash_aggregate_matches_jax(case, row_filter, agg_tables):
    keys, out_cap = AGG_CASES[case]
    host = _agg_table_host()
    rf = None
    if row_filter:
        rf = np.zeros(1024, bool)
        rf[:600] = np.random.default_rng(9).random(600) < 0.6
    jout, tout, n = _agg_both(agg_tables, keys, AGGS, out_cap, rf)
    assert_columns_equal(jout, tout, int(tout.num_rows), float_tol=_float_tols(host, AGGS))


# the grouping gather (K5) takes the count of rows in the filter: rows past
# it come back as zeros, unread; nothing downstream reads them
GATHER_COUNT_CASES = {
    # name: (rows in the table, rows kept of the capacity, filter)
    "none_in_the_filter": (600, 600, "none"),
    "every_row_of_the_capacity": (1024, 1024, "all"),
    "data_past_the_count": (600, 1024, "random"),
}


@pytest.mark.parametrize("keys", [["k32"], ["k64", "ks"], ["kf"]], ids=["int32", "int64_string",
                                                                    "float"])
@pytest.mark.parametrize("case", sorted(GATHER_COUNT_CASES))
def test_hash_aggregate_grouping_gather_takes_the_count(case, keys):
    """A capacity-padded table under a row filter, grouped on the sorted
    path: n_valid 0, n_valid equal to the capacity, and non-zero rows past
    the table's rows and outside the filter (the table's 1,024 rows kept
    at capacity 1,024 with num_rows 600). Equal to the JAX package."""
    num_rows, kept, kind = GATHER_COUNT_CASES[case]
    host = _agg_table_host() if kept == 600 else _wide_agg_host(kept)
    jt, tt = both(host, 1024)
    if kept != num_rows:
        jt = jcol.DeviceTable(jt.schema, jt.columns, np.int32(num_rows))
        tt.num_rows = torch.tensor(num_rows, dtype=torch.int32)
    rf = {"none": np.zeros(1024, bool), "all": np.ones(1024, bool),
          "random": np.random.default_rng(11).random(1024) < 0.6}[kind]
    jout, tout, n = _agg_both((jt, tt), keys, AGGS, None, rf)
    if kind == "none":
        assert n == 0
    assert_columns_equal(jout, tout, int(tout.num_rows), float_tol=_float_tols(host, AGGS))


def _wide_agg_host(rows: int):
    """_agg_table_host's columns at `rows` rows (tiled), every row valid
    data: a table whose rows fill its capacity, or run past its num_rows."""
    base = _agg_table_host()
    reps = -(-rows // base.num_rows)
    cols = {name: np.tile(v, reps)[:rows] for name, (v, _) in base.columns.items()}
    valid = {name: np.tile(m, reps)[:rows] for name, (_, m) in base.columns.items()}
    return jcol.HostTable.from_numpy(
        cols, dtypes={"kd": jcol.DATE32, "ks": jcol.STRING, "vd": jcol.DECIMAL(2)},
        dictionaries={"ks": base.schema.field("ks").dictionary}, validity=valid)


def test_hash_aggregate_overflowing_out_cap(agg_tables):
    """out_cap below the group count: the true count comes back and all
    kept groups match, the last kept one included, whose counts and sums
    run to the end of the rows in both packages."""
    aggs = [jagg.AggSpec("sum", "v32", "s32"), jagg.AggSpec("min", "vd", "mn"),
            jagg.AggSpec("count_star", None, "cs")]
    for keys in (["k32"], ["k64", "ks"]):
        jout, tout, n = _agg_both(agg_tables, keys, aggs, out_cap=16)
        assert n > 16 and int(tout.num_rows) == 16
        assert_columns_equal(jout, tout, 16)
