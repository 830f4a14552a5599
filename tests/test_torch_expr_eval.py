"""K17's compiled expression programs on the CPU (`ops/expressions.py`
`compile_exprs` + `kernels/expr_eval.py::expr_eval_plain`, the kernel's
plain version) against the trees they compile: every expression class x
column type (int32, int64, date32 with dates before 1970, decimal scales
0-4, float32, float64, bool, string codes) with NULLs, division by zero
and negative operands; hypothesis-generated trees; and every expression
the 22 TPC-H plans evaluate at SF 0.002.

The same numpy columns go through the JAX package's `Expr.eval` (the tree
rebuilt in the port's classes by `utils/convert.py::expr_from_reference`)
and the port's tree `.eval`. The program equals the port's `.eval` bit for
bit over the whole capacity (values, validity, dtype, DType); against the
JAX package the validity is equal everywhere and the values bit for bit
where valid (a NULL row's value is whatever each framework's op leaves
there), with two exceptions where the frameworks differ and neither is
wrong: a NaN's sign and payload (any NaN equals any NaN), and a float
that is infinite or NaN converted to an integer (undefined in C: torch
gives INT_MIN, XLA saturates), whose rows are skipped. The true division
of two integer columns is float32 in torch and float64 in JAX (x64): the
JAX quotient is compared after rounding it to float32, which for a
division is the correctly rounded float32 quotient. No float tolerance
is needed: both compute in IEEE types."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from datafusion_parallelism_tpu.models import planner as jplanner
from datafusion_parallelism_tpu.ops import expressions as jx
from datafusion_parallelism_tpu.utils import columnar as jcol
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
from datafusion_parallelism_tpu_torch.models import planner as tplanner
from datafusion_parallelism_tpu_torch.ops import expressions as tx
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import expr_from_reference

N = 203
NUM = ["i32", "i64", "date", "d0", "d1", "d2", "d3", "d4", "f32", "f64"]


def _columns(seed=0, n=N):
    rng = np.random.default_rng(seed)
    cols = {"i32": rng.integers(-60, 60, n).astype(np.int32),
            "i64": rng.integers(-(1 << 40), 1 << 40, n) // rng.integers(1, 1 << 28, n),
            "date": rng.integers(-40000, 40000, n).astype(np.int32),
            "f32": (rng.normal(size=n) * 50).astype(np.float32),
            "f64": rng.normal(size=n) * 1e3,
            "b": rng.random(n) < 0.5,
            "s": rng.integers(0, 6, n).astype(np.int32)}
    for s in range(5):
        cols[f"d{s}"] = rng.integers(-99_999, 99_999, n)
    for name in ("i32", "i64", "f32", "f64", "d2", "date"):
        cols[name][rng.random(n) < 0.1] = 0
    cols["f64"][:4] = [-0.0, np.inf, -np.inf, np.nan]
    validity = {name: rng.random(n) >= 0.15 for name in cols}
    return cols, validity


def _host(pkg, cols, validity):
    dtypes = {"i32": pkg.INT32, "i64": pkg.INT64, "date": pkg.DATE32, "f32": pkg.FLOAT32,
              "f64": pkg.FLOAT64, "b": pkg.BOOL, "s": pkg.STRING,
              **{f"d{s}": pkg.DECIMAL(s) for s in range(5)}}
    d = pkg.Dictionary(np.array(list("abcdef"), dtype=object))
    return pkg.HostTable.from_numpy(cols, dtypes=dtypes, validity=validity,
                                    dictionaries={"s": d})


@pytest.fixture(scope="module")
def tables():
    cols, validity = _columns()
    jt = _host(jcol, cols, validity).to_device(N + 5)
    tt = _host(tcol, cols, validity).to_device(N + 5, device="cpu")
    return jt, tt


def _float_bits(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def assert_same(got, want):
    """(values, validity, DType) equal bit for bit over the whole capacity."""
    assert got[2] == want[2]
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(_float_bits(got[0].numpy()), _float_bits(want[0].numpy()))


def assert_like_jax(got, want, rows=None):
    """Validity everywhere; values bit for bit where valid (and in `rows`,
    where given), compared as the JAX dtype's values, any NaN equal to any
    NaN; the DType's kind and scale."""
    gv, gm = got[0].numpy(), got[1].numpy()
    wv, wm = np.asarray(want[0]), np.asarray(want[1])
    assert (got[2].kind.value, got[2].scale) == (want[2].kind.value, want[2].scale)
    np.testing.assert_array_equal(gm, wm)
    keep = wm if rows is None else wm & rows
    if gv.dtype.kind == wv.dtype.kind == "f" and gv.dtype.itemsize < wv.dtype.itemsize:
        # int / int: torch's default float32, JAX's (x64) float64; float64's
        # correctly rounded quotient rounds to float32's exactly
        wv = wv.astype(gv.dtype)
    g, w = gv[keep].astype(wv.dtype), wv[keep]
    if w.dtype.kind == "f":
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan)
        g, w = g[~nan], w[~nan]
    np.testing.assert_array_equal(_float_bits(g), _float_bits(w))


def _program(texpr, tt):
    """The compiled program's plain run (evaluate on a CPU table)."""
    return tx.evaluate([texpr], tt)[0]


def _suite(x, planner, pkg):
    """(label, expression) of every class x column type, in `x`'s classes."""
    out = [(f"{a} {op} {b}", x.BinOp(op, x.Col(a), x.Col(b)))
           for a, b in [(a, b) for a in NUM for b in NUM if NUM.index(a) <= NUM.index(b)
                        or (a, b) in (("f64", "i32"), ("d2", "i64"), ("f32", "d1"))]
           for op in ("+", "-", "*", "/", "%", "<", "=", ">=")]
    out += [(f"{a} {op} lit", x.BinOp(op, x.Col(a), x.Lit(-3, pkg.INT32)))
            for a in NUM for op in ("*", "/", "%", "<>")]
    out += [("d2 > 1.5", x.BinOp(">", x.Col("d2"), x.Lit(1.5, pkg.DECIMAL(2)))),
            ("d3 raw lit", x.BinOp("-", x.Col("d3"), x.Lit(1234, pkg.DECIMAL(3), True))),
            ("d4 * d1 past scale 4", x.BinOp("*", x.Col("d4"), x.Col("d1"))),
            ("f32 + f32 lit", x.BinOp("+", x.Col("f32"), x.Lit(0.1, pkg.FLOAT32))),
            ("s = s", x.BinOp("=", x.Col("s"), x.Col("s"))),
            ("s < lit", x.BinOp("<", x.Col("s"), x.Lit(3, pkg.STRING))),
            ("b and i32 < 0", x.BinOp("and", x.Col("b"),
                                      x.BinOp("<", x.Col("i32"), x.Lit(0, pkg.INT32)))),
            ("b or f64 > 0", x.BinOp("or", x.Col("b"),
                                     x.BinOp(">", x.Col("f64"), x.Lit(0.0, pkg.FLOAT64)))),
            ("b and b", x.BinOp("and", x.Col("b"), x.Col("b"))),
            ("not b", x.Not(x.Col("b"))), ("not i32", x.Not(x.Col("i32"))),
            ("i64 is null", x.IsNull(x.Col("i64"))),
            ("f64 is not null", x.IsNull(x.Col("f64"), True)),
            ("null + i32", x.BinOp("+", x.Lit(None, pkg.INT32), x.Col("i32"))),
            ("lit bool", x.Lit(True, pkg.BOOL)), ("lit date", x.Lit(-700, pkg.DATE32)),
            ("lit decimal", x.Lit(-2.675, pkg.DECIMAL(2)))]
    out += [(f"cast {a} {dt!r}", x.Cast(x.Col(a), dt)) for a in NUM + ["b", "s"]
            for dt in (pkg.INT32, pkg.INT64, pkg.FLOAT32, pkg.FLOAT64, pkg.BOOL, pkg.DATE32,
                       pkg.DECIMAL(0), pkg.DECIMAL(2), pkg.DECIMAL(4))]
    out += [("i32 in", x.InCodes(x.Col("i32"), np.array([-7, 0, 3, 11, 40]))),
            ("i64 in int32 codes", x.InCodes(x.Col("i64"), np.array([0, 5], dtype=np.int32))),
            ("f64 in", x.InCodes(x.Col("f64"), np.array([0.0, 1.5, np.nan]))),
            ("s not in", x.InCodes(x.Col("s"), np.array([1, 4], dtype=np.int32), True)),
            ("d2 in empty", x.InCodes(x.Col("d2"), np.array([], dtype=np.int32))),
            ("case", x.Case([(x.BinOp("<", x.Col("i32"), x.Lit(0, pkg.INT32)), x.Col("i32")),
                             (x.Col("b"), x.Col("i64"))], x.Col("d0"))),
            ("case no else", x.Case([(x.BinOp(">", x.Col("f64"), x.Lit(1.0, pkg.FLOAT64)),
                                      x.Col("f32"))])),
            ("case of decimals", x.Case([(x.Col("b"), x.Col("d2"))], x.Lit(0, pkg.DECIMAL(2)))),
            ("coalesce", x.Coalesce([x.Col("i32"), x.Col("i64"), x.Lit(5, pkg.INT64)])),
            ("coalesce f", x.Coalesce([x.Col("f32"), x.Col("d2")])),
            ("coalesce one", x.Coalesce([x.Col("date")]))]
    out += [(f"extract {p}", x.ExtractDatePart(p, x.Col("date")))
            for p in ("year", "month", "day")]
    new_dict = pkg.Dictionary(np.array(list("fedcba"), dtype=object))
    out += [("dictmap", planner.DictMap(x.Col("s"), np.array([5, 4, 3, 2, 1, 0]), new_dict)),
            ("dictmap clamps", planner.DictMap(x.Col("i32"), np.array([2, 0, 1]), new_dict)),
            ("scalar decimal", x.BinOp("<", x.Col("d2"),
                                       planner.ScalarValue([12.5], [pkg.DECIMAL(2)]))),
            ("scalar null", x.BinOp("+", x.Col("i64"), planner.ScalarValue([None], [pkg.INT64]))),
            ("scalar float", x.BinOp("*", x.Col("f64"),
                                     planner.ScalarValue([0.2], [pkg.FLOAT64])))]
    return out


JSUITE = dict(_suite(jx, jplanner, jcol))
TSUITE = dict(_suite(tx, tplanner, tcol))


def _port_tree(label):
    """The JAX tree rebuilt in the port's classes; the planner's DictMap
    and ScalarValue, which `expr_from_reference` does not map, from the
    port's own suite."""
    try:
        return expr_from_reference(JSUITE[label])
    except TypeError:
        return TSUITE[label]


@pytest.mark.parametrize("label", sorted(JSUITE))
def test_program_matches_tree_and_jax(tables, label):
    jt, tt = tables
    texpr = _port_tree(label)
    assert repr(texpr) == repr(TSUITE[label])
    got = _program(texpr, tt)
    assert_same(got, texpr.eval(tt))
    rows = None
    if label.startswith("cast f") and got[0].dtype not in (torch.float32, torch.float64):
        rows = np.isfinite(tt.column(label.split()[1])[0].numpy())
    assert_like_jax(got, JSUITE[label].eval(jt), rows)


def test_projection_runs_every_root_in_one_program(tables):
    """A projection's computed expressions share one program (one K17
    launch); its bare columns pass through as their own tensors."""
    _, tt = tables
    exprs = [e for _, e in sorted(TSUITE.items())[:40]] + [tx.Col("i32"),
                                                          tx.Cast(tx.Col("d2"), tcol.DECIMAL(2))]
    calls = []

    def counting(*args):
        calls.append(args)
        return k17.expr_eval_plain(*args)

    chain = tdfp.kernels.chain.PLAIN._replace(expr_eval=counting)
    got = tx.evaluate(exprs, tt, chain)
    assert len(calls) == 2                 # 40 computed roots: 32 + 8
    for g, e in zip(got, exprs):
        assert_same(g, e.eval(tt))
    assert got[-2][0] is tt.column("i32")[0] and got[-1][0] is tt.column("d2")[0]


def _wide_projection(limit: str):
    """(table, roots) past one launch's column or scalar limit with at most
    MAX_OUTS roots: 24 sums of 4 distinct columns of a 96-column table, or
    12 columns each compared with its own scalar subquery."""
    rng = np.random.default_rng(21)
    n_cols = 96 if limit == "columns" else 12
    cols = {f"c{i}": rng.integers(-50, 50, N).astype(np.int32) for i in range(n_cols)}
    validity = {name: rng.random(N) >= 0.1 for name in cols}
    tt = tcol.HostTable.from_numpy(cols, validity=validity).to_device(device="cpu")
    if limit == "columns":
        roots = []
        for r in range(n_cols // 4):
            e = tx.Col(f"c{4 * r}")
            for k in range(1, 4):
                e = tx.BinOp("+", e, tx.Col(f"c{4 * r + k}"))
            roots.append(e)
    else:
        roots = [tx.BinOp("<", tx.Col(f"c{i}"), tplanner.ScalarValue([i - 6], [tcol.INT32]))
                 for i in range(n_cols)]
    return tt, roots


@pytest.mark.parametrize("limit", ["columns", "scalars"])
def test_projection_past_column_or_scalar_limit_splits(limit):
    """A projection whose roots read more than MAX_COLS columns or more than
    MAX_SCALARS scalar subqueries runs as several launches, each within
    the kernel's limits, and equals the trees' eval."""
    tt, roots = _wide_projection(limit)
    assert len(roots) <= k17.MAX_OUTS
    whole = tx.compile_exprs(roots, tt)[0]
    assert len(whole.cols) > k17.MAX_COLS or len(whole.scalars) > k17.MAX_SCALARS
    programs = []

    def counting(program, *args):
        programs.append(program)
        return k17.expr_eval_plain(program, *args)

    got = tx.evaluate(roots, tt, tdfp.kernels.chain.PLAIN._replace(expr_eval=counting))
    assert len(programs) >= 2
    for p in programs:
        assert len(p.cols) <= k17.MAX_COLS and len(p.scalars) <= k17.MAX_SCALARS
        assert len(p.code) <= k17.MAX_CODE and p.n_regs <= k17.MAX_REGS
    for g, e in zip(got, roots, strict=True):
        assert_same(g, e.eval(tt))


@pytest.mark.parametrize("label", ["i32 < i64", "b and i32 < 0", "f64 in", "d2 > 1.5",
                                   "i64 is null", "not b"])
def test_predicate_mask_mode(tables, label):
    """Mask mode: valid & value in one bool, False past num_rows where
    asked, ANDed with a given mask."""
    _, tt = tables
    e = TSUITE[label]
    v, valid, _ = e.eval(tt)
    want = valid & v.to(torch.bool)
    assert torch.equal(tx.predicate_mask(e, tt), want)
    extra = torch.from_numpy(np.random.default_rng(1).random(tt.capacity) < 0.5)
    assert torch.equal(tx.predicate_mask(e, tt, in_rows=True, and_mask=extra),
                       want & tt.row_mask() & extra)


def test_program_is_cached_and_reads_scalars_at_each_run(tables):
    """The compiled program is cached on the tree; a scalar subquery's
    value is read when the program runs, not frozen into it."""
    _, tt = tables
    sv = tplanner.ScalarValue([1.5], [tcol.FLOAT64])
    e = tx.BinOp("<", tx.Col("f64"), sv)
    first = tx.compile_exprs([e], tt)[0]
    got1 = _program(e, tt)
    sv.holder[0] = -2.0
    assert tx.compile_exprs([e], tt)[0] is first
    got2 = _program(e, tt)
    assert_same(got1, tx.BinOp("<", tx.Col("f64"), tx.Lit(1.5, tcol.FLOAT64)).eval(tt))
    assert_same(got2, e.eval(tt))


def test_registers_are_reused():
    """Registers free after their last read: a long chain of additions
    needs a handful, however long it is."""
    cols, validity = _columns(3)
    tt = _host(tcol, cols, validity).to_device(device="cpu")
    e = tx.Col("i64")
    for k in range(60):
        e = tx.BinOp("+", e, tx.BinOp("*", tx.Col("i32"), tx.Lit(k, tcol.INT32)))
    program, _ = tx.compile_exprs([e], tt)
    assert len(program.code) > 150 and program.n_regs <= 4
    assert_same(_program(e, tt), e.eval(tt))


# ---------------------------------------------------------------------------
# hypothesis: random trees over a small schema
# ---------------------------------------------------------------------------

SMALL = ["i32", "i64", "d2", "f64", "date", "b"]


def _leaf():
    lits = st.one_of(st.builds(lambda v: tx.Lit(v, tcol.INT32), st.integers(-20, 20)),
                     st.builds(lambda v: tx.Lit(v, tcol.DECIMAL(2)),
                               st.floats(-50, 50, allow_nan=False).map(lambda f: round(f, 2))),
                     st.builds(lambda v: tx.Lit(v, tcol.FLOAT64),
                               st.floats(-1e3, 1e3, allow_nan=False)),
                     st.just(tx.Lit(None, tcol.INT64)))
    return st.one_of(st.sampled_from(SMALL).map(tx.Col), lits)


def _tree(children):
    arith = st.builds(lambda op, a, b: tx.BinOp(op, a, b), st.sampled_from(["+", "-", "*"]),
                      children, children)
    # division and remainder over leaves only: no wrapped product reaches
    # INT_MIN / -1, which the CPU traps on
    div = st.builds(lambda op, a, b: tx.BinOp(op, a, b), st.sampled_from(["/", "%"]),
                    _leaf(), _leaf())
    cmp = st.builds(lambda op, a, b: tx.BinOp(op, a, b),
                    st.sampled_from(["<", "<=", "=", "<>", ">", ">="]), children, children)
    logic = st.builds(lambda op, a, b: tx.BinOp(op, a, b), st.sampled_from(["and", "or"]),
                      cmp, cmp)
    return st.one_of(
        arith, div, cmp, logic, st.builds(tx.Not, cmp),
        st.builds(tx.IsNull, children, st.booleans()),
        st.builds(tx.Cast, children, st.sampled_from([tcol.INT64, tcol.FLOAT64, tcol.DECIMAL(2),
                                                      tcol.FLOAT32, tcol.BOOL])),
        st.builds(lambda c, v, o: tx.Case([(c, v)], o), cmp, children, children),
        st.builds(lambda a, b: tx.Coalesce([a, b]), children, children),
        st.builds(lambda c: tx.InCodes(c, np.array([-3, 0, 7])), children))


TREES = st.recursive(_leaf(), _tree, max_leaves=8)


@pytest.fixture(scope="module")
def small_table():
    cols, validity = _columns(7, 64)
    return _host(tcol, cols, validity).to_device(device="cpu")


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=TREES)
def test_hypothesis_trees_match_tree_eval(small_table, tree):
    try:
        want = tree.eval(small_table)
    except (TypeError, RuntimeError):   # a tree torch refuses: the program refuses it too
        with pytest.raises((TypeError, RuntimeError)):
            _program(tree, small_table)
        return
    assert_same(_program(tree, small_table), want)


# ---------------------------------------------------------------------------
# every expression of the 22 TPC-H plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_ctx():
    ctx = tdfp.SessionContext(device="cpu")
    for name, t in generate_tables(sf=0.002).items():
        ctx.register_table(name, t)
    return ctx


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_expressions_match_tree_eval(tpch_ctx, q, monkeypatch):
    """Every compile of the query's run is recorded with its table; each
    program's plain run equals the trees' `.eval` on that table."""
    seen = []
    compile_exprs = tx.compile_exprs

    def recording(exprs, t):
        seen.append((list(exprs), t))
        return compile_exprs(exprs, t)

    monkeypatch.setattr(tx, "compile_exprs", recording)
    tpch_ctx.sql(QUERIES[q]).collect()
    monkeypatch.undo()
    assert seen, f"Q{q} evaluated no expression"
    for exprs, t in seen:
        program, _ = tx.compile_exprs(exprs, t)
        cols = [t.column(c) for c in program.cols]
        scalars = tuple(node.literal().bits() for node in program.scalars)
        outs = k17.expr_eval_plain(program, cols, t.capacity, scalars)
        for (v, valid), e in zip(outs, exprs):
            want = e.eval(t)
            assert v.dtype == want[0].dtype
            np.testing.assert_array_equal(valid.numpy(), want[1].numpy())
            np.testing.assert_array_equal(_float_bits(v.numpy()), _float_bits(want[0].numpy()))
