"""Grace-partitioned execution in the port (runtime/grace.py) on the CPU,
the cases of tests/test_grace.py: forced on SF 0.01 under the JAX tests'
thresholds (3000 rows, partitions from 2048-row chunks, a residency
ceiling of 20000 rows), each result equal to the oracle; `_hash_mod` bit
for bit and `plan_grace`'s parts and kind equal to the JAX package's for
all 22 queries."""

import numpy as np
import pytest
import torch

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.runtime.grace import _hash_mod as j_hash_mod
from datafusion_parallelism_tpu.runtime.grace import plan_grace as jplan_grace
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
from datafusion_parallelism_tpu_torch.runtime.grace import _hash_mod, plan_grace
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


def _ctx(tables, pkg=tdfp):
    ctx = pkg.SessionContext(device="cpu") if pkg is tdfp else pkg.SessionContext()
    for n, t in tables.items():
        ctx.register_table(n, t)
    return ctx


def _force_grace(monkeypatch, chunk_rows=2048):
    monkeypatch.setenv("DFP_STREAM_ROW_THRESHOLD", "3000")
    monkeypatch.setenv("DFP_STREAM_CHUNK_ROWS", str(chunk_rows))
    monkeypatch.setenv("DFP_GRACE_RESIDENT_CEILING", "20000")
    monkeypatch.setenv("DFP_FORCE_GRACE", "1")


# Q17/Q18/Q21 self-join lineitem, Q2 self-joins partsupp (union merge, K13),
# Q7 joins the two biggest tables, Q8/Q9/Q12 partition under FORCE_GRACE
# (Q9 through the partsupp demotion), Q20 takes the mask merge
@pytest.mark.parametrize("q", [17, 18, 21, 2, 7, 8, 9, 12, 20])
def test_grace_tpch_matches_oracle(tables, q, monkeypatch):
    _force_grace(monkeypatch)
    h = _ctx(tables).sql(QUERIES[q])
    got = h.collect().to_pylist()
    assert_rows_equal(got, oracle_query(q, tables))
    assert h.metrics.streamed_chunks > 1, \
        f"Q{q} did not run grace-partitioned (chunks={h.metrics.streamed_chunks})"
    assert h.metrics.route.startswith("grace")


@pytest.mark.parametrize("strategy", ["SORT", "OA"])
def test_grace_under_strategy(tables, strategy, monkeypatch):
    """Q18 grace-partitioned (the aggregate merge) under the SORT and OA
    strategies, equal to the oracle."""
    _force_grace(monkeypatch)
    ctx = tdfp.SessionContext(tdfp.SessionConfig(join_strategy=JoinStrategy[strategy]),
                              device="cpu")
    for n, t in tables.items():
        ctx.register_table(n, t)
    h = ctx.sql(QUERIES[18])
    assert_rows_equal(h.collect().to_pylist(), oracle_query(18, tables))
    assert h.metrics.route.startswith("grace") and h.metrics.streamed_chunks > 1


def test_grace_eligibility(tables, monkeypatch):
    monkeypatch.setenv("DFP_GRACE_RESIDENT_CEILING", "20000")
    ctx = _ctx(tables)
    expect = {
        17: ({"lineitem": "l_partkey"}, "agg"),
        18: ({"lineitem": "l_orderkey", "orders": "o_orderkey"}, "agg"),
        21: ({"lineitem": "l_orderkey", "orders": "o_orderkey"}, "agg"),
        2: ({"partsupp": "ps_partkey"}, "union"),
        7: ({"lineitem": "l_orderkey", "orders": "o_orderkey"}, "agg"),
        8: ({"lineitem": "l_orderkey", "orders": "o_orderkey"}, "agg"),
        9: ({"lineitem": "l_orderkey", "orders": "o_orderkey"}, "agg"),
        12: ({"lineitem": "l_orderkey", "orders": "o_orderkey"}, "agg"),
        20: (None, "mask"),
    }
    for q, (cols, kind) in expect.items():
        h = _ctx(tables).sql(QUERIES[q])
        gp, reason = plan_grace(h.plan, ctx.catalog, 3000)
        assert gp is not None, f"Q{q} grace-ineligible: {reason}"
        if cols is not None:
            got = {s.table_name: c for s, c in gp.parts.values()}
            assert got == cols, f"Q{q}: {got} != {cols}"
        assert gp.kind == kind, f"Q{q}: kind {gp.kind} != {kind}"


def test_grace_self_join_semi_with_rows(monkeypatch):
    """Q18's shape with data dense enough that the semi join and both
    aggregates produce rows through several partitions."""
    n = 20000
    t = {"k": [i % 500 for i in range(n)],
         "c": [i % 7 for i in range(n)],
         "v": [float(i % 11) for i in range(n)]}
    ksum = {}
    for i in range(n):
        ksum[t["k"][i]] = ksum.get(t["k"][i], 0.0) + t["v"][i]
    hot = {k for k, s in ksum.items() if s > 200.0}
    assert 0 < len(hot) < 500
    expected = {}
    for i in range(n):
        if t["k"][i] in hot:
            expected[t["c"][i]] = expected.get(t["c"][i], 0.0) + t["v"][i]
    monkeypatch.setenv("DFP_STREAM_ROW_THRESHOLD", "1000")
    monkeypatch.setenv("DFP_STREAM_CHUNK_ROWS", "2048")
    ctx = tdfp.SessionContext(device="cpu")
    ctx.register_pydict("t", t)
    h = ctx.sql("SELECT c, SUM(v) AS s FROM t WHERE k IN "
                "(SELECT k FROM t GROUP BY k HAVING SUM(v) > 200.0) GROUP BY c")
    got = h.collect().to_pylist()
    assert_rows_equal(got, [{"c": c, "s": s} for c, s in expected.items()])
    assert h.metrics.streamed_chunks > 1


def test_grace_rejects_unkeyed_self_join(tables, monkeypatch):
    """A self-join NOT keyed by a common column cannot partition; the
    executor falls back to resident execution and is still correct."""
    _force_grace(monkeypatch)
    sql = ("SELECT COUNT(*) AS n FROM lineitem l1, lineitem l2 "
           "WHERE l1.l_orderkey = l2.l_partkey AND l1.l_linenumber = 7 "
           "AND l2.l_linenumber = 7 AND l1.l_quantity > 49")
    h = _ctx(tables).sql(sql)
    gp, reason = plan_grace(h.plan, _ctx(tables).catalog, 3000)
    assert gp is None and "partition" in reason
    got = h.collect().to_pylist()
    assert h.metrics.route == "resident"
    monkeypatch.delenv("DFP_STREAM_ROW_THRESHOLD")
    plain = _ctx(tables).sql(sql).collect().to_pylist()
    assert_rows_equal(got, plain)


@pytest.mark.parametrize("K", [1, 2, 15, 1000])
def test_hash_mod_matches_jax(K):
    rng = np.random.default_rng(K)
    for v in (rng.integers(-(1 << 62), 1 << 62, 5000), rng.integers(0, 1 << 20, 5000),
              rng.integers(-(1 << 31), 1 << 31, 5000).astype(np.int32),
              np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0])):
        got = _hash_mod(v, K)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, j_hash_mod(v, K))
    # equal values in int32 and int64 columns land in the same partition
    v = rng.integers(-(1 << 31), 1 << 31, 1000)
    np.testing.assert_array_equal(_hash_mod(v.astype(np.int32), K), _hash_mod(v, K))


@pytest.fixture(scope="module")
def jtables():
    return jgenerate(sf=0.01)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_plan_grace_matches_jax(tables, jtables, q, monkeypatch):
    monkeypatch.setenv("DFP_GRACE_RESIDENT_CEILING", "20000")
    tctx, jctx = _ctx(tables), _ctx(jtables, jdfp)
    th, jh = tctx.sql(QUERIES[q]), jctx.sql(QUERIES[q])
    tgp, treason = plan_grace(th.plan, tctx.catalog, 3000)
    jgp, jreason = jplan_grace(jh.plan, jctx.catalog, 3000)
    assert treason == jreason
    assert (tgp is None) == (jgp is None)
    if tgp is not None:
        assert tgp.kind == jgp.kind
        assert tgp.merge.describe() == jgp.merge.describe()
        assert ({label: (s.table_name, c) for label, (s, c) in tgp.parts.items()}
                == {label: (s.table_name, c) for label, (s, c) in jgp.parts.items()})
