"""Morsel streaming in the port (runtime/streaming.py) on the CPU, the
cases of tests/test_streaming.py: forced on SF 0.01 (threshold 0, chunks of
2048 rows so every query crosses chunk boundaries), each streamed result
equal to the oracle, and for Q1, Q13 and the four visited join types to
the JAX package run under the same env, with the same number of chunks.
`plan_stream_ex`'s (plan, reason) equals the JAX package's for all 22
queries, with and without the side-swap."""

import pytest
import torch

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.runtime.streaming import plan_stream_ex as jplan_stream_ex
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
from datafusion_parallelism_tpu_torch.runtime.streaming import plan_stream_ex
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.tpch.oracle import oracle_query

from oracle import assert_rows_equal


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: each chunk runs hundreds of small eager
    ops, which intra-op threads slow down on a CPU the other test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return generate_tables(sf=0.01)


@pytest.fixture(scope="module")
def jtables():
    return jgenerate(sf=0.01)


def _ctx(tables, pkg=tdfp):
    ctx = pkg.SessionContext(device="cpu") if pkg is tdfp else pkg.SessionContext()
    for n, t in tables.items():
        ctx.register_table(n, t)
    return ctx


def _stream(monkeypatch, chunk_rows=2048):
    monkeypatch.setenv("DFP_STREAM_THRESHOLD_BYTES", "0")
    monkeypatch.setenv("DFP_STREAM_CHUNK_ROWS", str(chunk_rows))


def _run_streamed(tables, sql, monkeypatch, chunk_rows=2048):
    _stream(monkeypatch, chunk_rows)
    handle = _ctx(tables).sql(sql)
    return handle.collect().to_pylist(), handle.metrics


# the JAX package's stream-eligible TPC-H shapes
@pytest.mark.parametrize("q", [1, 3, 5, 6, 10])
def test_tpch_streamed_matches(tables, jtables, q, monkeypatch):
    got, m = _run_streamed(tables, QUERIES[q], monkeypatch)
    assert_rows_equal(got, oracle_query(q, tables))
    assert m.streamed_chunks > 1 and m.route == "streamed"
    assert m.host_pack_s > 0
    if q == 1:
        jh = _ctx(jtables, jdfp).sql(QUERIES[q])
        assert_rows_equal(got, jh.collect().to_pylist())
        assert m.streamed_chunks == jh.metrics.streamed_chunks


@pytest.mark.parametrize("strategy", ["SORT", "OA"])
def test_tpch_streamed_under_strategy(tables, strategy, monkeypatch):
    """Q3 streamed under the SORT and OA strategies: the frozen builds are
    the strategy's tables, probed by every chunk."""
    _stream(monkeypatch)
    ctx = tdfp.SessionContext(tdfp.SessionConfig(join_strategy=JoinStrategy[strategy]),
                              device="cpu")
    for n, t in tables.items():
        ctx.register_table(n, t)
    handle = ctx.sql(QUERIES[3])
    assert_rows_equal(handle.collect().to_pylist(), oracle_query(3, tables))
    assert handle.metrics.route == "streamed" and handle.metrics.streamed_chunks > 1


def test_ineligible_falls_back(tables, monkeypatch):
    # Q21 scans lineitem three times (self-joins): the forced threshold
    # falls back to resident execution
    got, m = _run_streamed(tables, QUERIES[21], monkeypatch)
    assert_rows_equal(got, oracle_query(21, tables))
    assert m.streamed_chunks == 0 and m.route == "resident"


@pytest.mark.parametrize("q", [12, 8, 9])
def test_side_swap_unlocks_streaming(tables, q, monkeypatch):
    got, m = _run_streamed(tables, QUERIES[q], monkeypatch)
    assert_rows_equal(got, oracle_query(q, tables))
    assert m.streamed_chunks > 1 and m.route == "streamed after a side-swap"


def test_streamed_global_aggregate(monkeypatch):
    import numpy as np
    data = {"k": list(range(10000)), "v": [float(i % 97) for i in range(10000)]}
    ctx = tdfp.SessionContext(device="cpu")
    ctx.register_pydict("t", data)
    _stream(monkeypatch, 1024)
    handle = ctx.sql("SELECT SUM(v) AS s, COUNT(*) AS c, MIN(v) AS lo, "
                     "MAX(v) AS hi, AVG(v) AS a FROM t WHERE k % 2 = 0")
    [row] = handle.collect().to_pylist()
    v = np.array(data["v"])[np.arange(10000) % 2 == 0]
    assert row["c"] == 5000
    assert abs(row["s"] - v.sum()) < 1e-6
    assert row["lo"] == v.min() and row["hi"] == v.max()
    assert abs(row["a"] - v.mean()) < 1e-9
    assert handle.metrics.streamed_chunks == 10000 // 1024 + 1


def _skewed(pkg):
    """custs (small, build) + orders (big, streamed probe): orders covers
    only half the customers, so every build-emitting join type has deferred
    (unmatched-build) rows, and 5% of orders reference missing customers,
    so FULL has unmatched probe rows too."""
    import random
    rng = random.Random(7)
    n_orders = 20000
    custs = {"id": list(range(200)), "grp": [i % 7 for i in range(200)]}
    orders = {"oid": list(range(n_orders)),
              "cust": [rng.randrange(100) if rng.random() > 0.05
                       else 200 + rng.randrange(50) for _ in range(n_orders)],
              "v": [float(i % 13) for i in range(n_orders)]}
    ctx = pkg.SessionContext(device="cpu") if pkg is tdfp else pkg.SessionContext()
    ctx.register_pydict("custs", custs)
    ctx.register_pydict("orders", orders)
    return ctx


_VISITED_SQL = {
    "left": ("SELECT c.grp AS g, COUNT(o.v) AS cnt, SUM(o.v) AS s "
             "FROM custs c LEFT JOIN orders o ON c.id = o.cust GROUP BY c.grp"),
    "full": ("SELECT COUNT(*) AS n, SUM(o.v) AS s, MIN(c.grp) AS mg "
             "FROM custs c FULL JOIN orders o ON c.id = o.cust"),
    "left_semi": ("SELECT c.grp AS g, COUNT(*) AS cnt FROM custs c WHERE "
                  "EXISTS (SELECT 1 FROM orders o WHERE o.cust = c.id) "
                  "GROUP BY c.grp"),
    "left_anti": ("SELECT c.grp AS g, COUNT(*) AS cnt FROM custs c WHERE "
                  "NOT EXISTS (SELECT 1 FROM orders o WHERE o.cust = c.id) "
                  "GROUP BY c.grp"),
}


@pytest.mark.parametrize("jt", sorted(_VISITED_SQL))
def test_streamed_visited_join_types(jt, monkeypatch):
    """Build-emitting joins stream through the visited buffer folded
    across chunks (K10's accumulate mode) and the flush pass; the rows
    equal the resident run's and the JAX package's streamed run's."""
    sql = _VISITED_SQL[jt]
    resident = _skewed(tdfp).sql(sql).collect().to_pylist()
    _stream(monkeypatch)
    handle = _skewed(tdfp).sql(sql)
    got = handle.collect().to_pylist()
    jh = _skewed(jdfp).sql(sql)
    assert_rows_equal(got, resident)
    assert_rows_equal(got, jh.collect().to_pylist())
    assert handle.metrics.streamed_chunks > 1
    assert handle.metrics.streamed_chunks == jh.metrics.streamed_chunks


def test_streamed_q13_double_aggregate(tables, jtables, monkeypatch):
    # Q13: LEFT join with a residual under TWO stacked aggregates — the
    # merge point is the LOWEST aggregate; the outer one runs at finish
    got, m = _run_streamed(tables, QUERIES[13], monkeypatch)
    assert_rows_equal(got, oracle_query(13, tables))
    jh = _ctx(jtables, jdfp).sql(QUERIES[13])
    assert_rows_equal(got, jh.collect().to_pylist())
    assert m.streamed_chunks > 1 and m.streamed_chunks == jh.metrics.streamed_chunks


@pytest.mark.parametrize("case", ["q3", "left visited join"])
def test_streamed_join_overflow_retry(tables, case, monkeypatch):
    """A join inside the chunk overflows, grows and runs the CURRENT chunk
    again, the visited buffer of a build-emitting join included (its
    truncated first attempt set a subset of the flags)."""
    monkeypatch.setenv("DFP_NO_CAP_STORE", "1")
    if case == "q3":
        got, m = _run_streamed(tables, QUERIES[3], monkeypatch, chunk_rows=1024)
        assert_rows_equal(got, oracle_query(3, tables))
    else:
        monkeypatch.setenv("DFP_MAX_JOIN_SEED_CAP", "256")
        sql = _VISITED_SQL["left"]
        want = _skewed(tdfp).sql(sql).collect().to_pylist()
        _stream(monkeypatch, 1024)
        handle = _skewed(tdfp).sql(sql)
        got, m = handle.collect().to_pylist(), handle.metrics
        assert_rows_equal(got, want)
        assert m.retries > 0
    assert m.streamed_chunks > 1


def _describe(sp):
    if sp is None:
        return None
    return (sp.agg.describe(), sp.scan.label, sp.root.tree(),
            [j.describe() for j in sp.visited_joins])


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_plan_stream_matches_jax(tables, jtables, q):
    """(plan, reason) of plan_stream_ex equal the JAX package's, without
    and then with the side-swap (which rewrites the plan in place)."""
    tctx, jctx = _ctx(tables), _ctx(jtables, jdfp)
    th, jh = tctx.sql(QUERIES[q]), jctx.sql(QUERIES[q])
    for allow_swap in (False, True):
        tsp, treason = plan_stream_ex(th.plan, tctx.catalog, allow_swap)
        jsp, jreason = jplan_stream_ex(jh.plan, jctx.catalog, allow_swap)
        assert treason == jreason
        assert _describe(tsp) == _describe(jsp)
        assert th.plan.tree() == jh.plan.tree()
