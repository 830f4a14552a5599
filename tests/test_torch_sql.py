"""The port's SQL front end against the JAX package's: the copied parser
gives the same syntax trees, the copied planner and optimizer the same
plans (`explain()` text), and the SQL matrix of `tests/test_sql_matrix.py`
(on the CSR strategy, the one the port has) the same rows, with the port's
session on the CPU running its kernels' plain versions."""

import numpy as np
import pytest

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.models.sql_parser import parse_sql as jparse
from datafusion_parallelism_tpu.ops.hash_table import JoinStrategy as JStrategy
from datafusion_parallelism_tpu.tpch import QUERIES as JQUERIES
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu.utils.catalog import Statistics as JStatistics
from datafusion_parallelism_tpu_torch.models.physical import find_joins
from datafusion_parallelism_tpu_torch.models.sql_parser import parse_sql as tparse
from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
from datafusion_parallelism_tpu_torch.ops.join import JoinType
from datafusion_parallelism_tpu_torch.tpch import QUERIES
from datafusion_parallelism_tpu_torch.tpch import generate_tables as tgenerate
from datafusion_parallelism_tpu_torch.utils.catalog import Statistics as TStatistics

from oracle import assert_rows_equal


def _base(reg, stats):
    n = 64
    reg("ta", {"a_id": [i % 16 for i in range(n)], "a_val": list(range(n))})
    reg("tb", {"b_id": [i % 12 for i in range(n)], "b_val": [i * 2 for i in range(n)]})
    reg("tc", {"c_id": [i % 8 for i in range(32)], "c_val": [i * 3 for i in range(32)]})
    reg("tn", {"n_id": [None if i % 5 == 0 else i % 16 for i in range(48)],
               "n_val": list(range(48))})


def _with_tz(values):
    def setup(reg, stats):
        _base(reg, stats)
        reg("tz", values)
    return setup


def _steer(big_rows, small_rows):
    def setup(reg, stats):
        reg("big", {"id": [1, 2, 3, 4], "v": [1, 2, 3, 4]}, stats(big_rows))
        reg("small", {"id": [1, 2], "w": [10, 20]}, stats(small_rows))
    return setup


def _t_u(u):
    def setup(reg, stats):
        reg("t", {"x": [1, 2, 3, 4, 5]})
        reg("u", {"y": u})
    return setup


def _star(reg, stats):
    n = 128
    reg("fact", {"d1": [i % 8 for i in range(n)], "d2": [i % 4 for i in range(n)],
                 "d3": [i % 2 for i in range(n)], "m": list(range(n))}, stats(n))
    reg("dim1", {"k1": list(range(8)), "v1": [i * 10 for i in range(8)]}, stats(8))
    reg("dim2", {"k2": list(range(4)), "v2": [i * 100 for i in range(4)]}, stats(4))
    reg("dim3", {"k3": list(range(2)), "v3": [i * 1000 for i in range(2)]}, stats(2))


def _hot(reg, stats):
    reg("l", {"k": [7] * 300, "a": list(range(300))})
    reg("r", {"k": [7] * 300, "b": list(range(300))})


_TZ = {"z_id": [0, 1, 2, 100], "z_val": [5, 6, 7, 8]}

# name: (tables, query), the cases of tests/test_sql_matrix.py
MATRIX = {
    "inner_join_no_filter": (_base, "SELECT a_val, b_val, c_val FROM ta "
                                    "JOIN tb ON a_id = b_id JOIN tc ON b_id = c_id"),
    "inner_join_with_nulls": (_base, "SELECT a_val, n_val FROM ta JOIN tn ON a_id = n_id"),
    "inner_join_without_matches": (_with_tz({"z_id": [100, 101], "z_val": [1, 2]}),
                                   "SELECT a_val, z_val FROM ta JOIN tz ON a_id = z_id"),
    "left_join": (_base, "SELECT a_val, c_val FROM ta LEFT JOIN tc ON a_id = c_id"),
    "left_semi_join_via_exists": (_base, "SELECT a_val FROM ta WHERE EXISTS "
                                         "(SELECT * FROM tc WHERE tc.c_id = ta.a_id)"),
    "left_anti_join_via_not_exists": (_base, "SELECT a_val FROM ta WHERE NOT EXISTS "
                                             "(SELECT * FROM tc WHERE tc.c_id = ta.a_id)"),
    "exists_with_inner_filter": (_base, "SELECT a_val FROM ta WHERE EXISTS (SELECT * FROM tc "
                                        "WHERE tc.c_id = ta.a_id AND tc.c_val > 30)"),
    "right_join": (_base, "SELECT a_val, n_val FROM tn RIGHT JOIN ta ON n_id = a_id"),
    "full_join": (_with_tz(_TZ), "SELECT c_val, z_val FROM tc FULL OUTER JOIN tz "
                                 "ON c_id = z_id"),
    "full_join_with_filter": (_with_tz(_TZ), "SELECT c_val, z_val FROM tc FULL OUTER JOIN tz "
                                             "ON c_id = z_id AND c_val < z_val"),
    "statistics_steer_right_anti": (_steer(1_000_000, 2),
                                    "SELECT v FROM big WHERE NOT EXISTS "
                                    "(SELECT * FROM small WHERE small.id = big.id)"),
    "statistics_steer_left_anti": (_steer(2, 1_000_000),
                                   "SELECT v FROM big WHERE NOT EXISTS "
                                   "(SELECT * FROM small WHERE small.id = big.id)"),
    "in_subquery": (_t_u([2, 4, 9]), "SELECT x FROM t WHERE x IN (SELECT y FROM u)"),
    "not_in_subquery": (_t_u([2, 4, 9]), "SELECT x FROM t WHERE x NOT IN (SELECT y FROM u)"),
    "scalar_subquery": (_t_u([3, 4]), "SELECT x FROM t WHERE x > (SELECT min(y) FROM u)"),
    "group_by_having_order": (
        lambda reg, stats: reg("t", {"k": [1, 1, 2, 2, 2, 3], "v": [10, 20, 1, 2, 3, 9]}),
        "SELECT k, sum(v) AS s, count(*) AS c FROM t GROUP BY k HAVING count(*) > 1 "
        "ORDER BY s DESC"),
    "overflow_retry_grows_capacity": (_hot, "SELECT count(*) AS c FROM l JOIN r ON l.k = r.k"),
    "distinct": (lambda reg, stats: reg("t", {"x": [1, 2, 2, 3, 3, 3]}),
                 "SELECT DISTINCT x FROM t ORDER BY x"),
    "four_way_star_join": (_star, "SELECT sum(m + v1 + v2 + v3) AS s FROM fact, dim1, dim2, "
                                  "dim3 WHERE d1 = k1 AND d2 = k2 AND d3 = k3"),
    "aggregate_over_semi_join_fused": (
        _base, "SELECT a_id, SUM(a_val) AS s, COUNT(*) AS c FROM ta WHERE EXISTS "
               "(SELECT * FROM tc WHERE tc.c_id = ta.a_id) GROUP BY a_id ORDER BY a_id"),
    "global_aggregate_over_anti_join_fused": (
        _base, "SELECT SUM(a_val) AS s FROM ta WHERE NOT EXISTS "
               "(SELECT * FROM tc WHERE tc.c_id = ta.a_id)"),
    "aggregate_over_semi_join_with_extra_filter": (
        _base, "SELECT COUNT(*) AS c FROM ta WHERE a_val > 20 AND EXISTS "
               "(SELECT * FROM tc WHERE tc.c_id = ta.a_id)"),
    "left_join_group_by_order": (
        lambda reg, stats: (
            reg("orders", {"o_id": [1, 2, 3, 4], "o_cust": [10, 20, 10, None],
                           "amount": [5.0, 7.5, 1.25, 9.0]}),
            reg("custs", {"c_id": [10, 20, 40], "c_name": ["alice", "bob", "carol"]})),
        "SELECT c.c_name, SUM(o.amount) AS total FROM custs c LEFT JOIN orders o "
        "ON c.c_id = o.o_cust GROUP BY c.c_name ORDER BY total DESC"),
}


def _session(pkg, setup, strategy="CSR"):
    """A session of `pkg` under the join strategy named `strategy`, with
    `setup`'s tables registered."""
    if pkg is jdfp:
        ctx = jdfp.SessionContext(jdfp.SessionConfig(join_strategy=JStrategy[strategy]))
        stats = JStatistics
    else:
        ctx = tdfp.SessionContext(tdfp.SessionConfig(join_strategy=JoinStrategy[strategy]),
                                  device="cpu")
        stats = TStatistics

    def reg(name, data, statistics=None):
        ctx.register_pydict(name, data, statistics=statistics)

    setup(reg, lambda n: stats(row_count=n))
    return ctx


@pytest.mark.parametrize("strategy", [s.name for s in JoinStrategy])
@pytest.mark.parametrize("case", sorted(MATRIX))
def test_sql_matrix_matches_jax(case, strategy):
    """Every scenario under each join strategy, against the JAX session
    under the same strategy: the same plan text and rows."""
    setup, query = MATRIX[case]
    jh = _session(jdfp, setup, strategy).sql(query)
    th = _session(tdfp, setup, strategy).sql(query)
    assert th.explain() == jh.explain()
    want = jh.collect().to_pylist()
    got = th.collect().to_pylist()
    if "ORDER BY" in query:
        assert got == want
    else:
        assert_rows_equal(got, want)
    if case == "overflow_retry_grows_capacity":
        assert got == [{"c": 300 * 300}] and th.metrics.retries >= 1
    if case.startswith("statistics_steer"):
        want_type = JoinType.RIGHT_ANTI if case.endswith("right_anti") else JoinType.LEFT_ANTI
        assert find_joins(th.plan)[0].join_type is want_type


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_parser_matches_jax_on_the_matrix(case):
    query = MATRIX[case][1]
    assert repr(tparse(query)) == repr(jparse(query))


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_parser_matches_jax_on_tpch(q):
    assert QUERIES[q] == JQUERIES[q]
    assert repr(tparse(QUERIES[q])) == repr(jparse(JQUERIES[q]))


@pytest.fixture(scope="module")
def tpch_sessions():
    jctx, tctx = jdfp.SessionContext(), tdfp.SessionContext(device="cpu")
    for name, t in jgenerate(sf=0.002).items():
        jctx.register_table(name, t)
    for name, t in tgenerate(sf=0.002).items():
        tctx.register_table(name, t)
    return jctx, tctx


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_explain_matches_jax(q, tpch_sessions):
    jctx, tctx = tpch_sessions
    assert tctx.sql(QUERIES[q]).explain() == jctx.sql(QUERIES[q]).explain()


def test_infer_dtype_never_touches_a_device():
    """The planner's dtype probe evaluates the expression on an 8-row CPU
    table of zeros (the JAX package traces it with jax.eval_shape)."""
    from datafusion_parallelism_tpu_torch.models.planner import infer_dtype
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, Lit
    from datafusion_parallelism_tpu_torch.utils.columnar import (DECIMAL, FLOAT64, INT32,
                                                                 Field, Schema)
    schema = Schema([Field("a", INT32), Field("d", DECIMAL(2)), Field("f", FLOAT64)])
    assert infer_dtype(BinOp("+", Col("a"), Lit(1, INT32)), schema) == INT32
    assert infer_dtype(BinOp("*", Col("d"), Col("d")), schema) == DECIMAL(4)
    assert infer_dtype(BinOp("*", Col("f"), Col("a")), schema) == FLOAT64


def test_dictmap_lut_clamps_like_jax_clip():
    """DictMap moves its LUT to the codes' device once and clamps codes
    outside it, as jnp.take(mode="clip")."""
    import torch

    from datafusion_parallelism_tpu_torch.models.planner import DictMap
    from datafusion_parallelism_tpu_torch.ops.expressions import Col
    from datafusion_parallelism_tpu_torch.utils.columnar import (STRING, DeviceTable, Field,
                                                                 Schema)
    dm = DictMap(Col("s"), np.array([5, 6, 7]), None)
    t = DeviceTable(Schema([Field("s", STRING)]),
                    {"s": (torch.tensor([-2, 0, 2, 9], dtype=torch.int32),
                           torch.ones(4, dtype=torch.bool))},
                    torch.tensor(4, dtype=torch.int32))
    v, valid, _ = dm.eval(t)
    assert v.tolist() == [5, 5, 7, 7] and valid.all()


def test_session_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """Several partitions and the settings that steer them are taken, with
    the JAX package's defaults. Parquet registration (which raised naming
    ROADMAP item 14 before utils/parquet_io.py was ported) answers a query.
    Streaming a scan through the partitions (distributed morsel streaming,
    which raised before runtime/distributed_streaming.py was ported) runs
    streamed and gives the same answer."""
    from datafusion_parallelism_tpu_torch.utils.parquet_io import write_parquet
    from datafusion_parallelism_tpu_torch.runtime.distributed_executor import \
        DistributedQueryHandle
    settings = ("broadcast_threshold", "skew_salting", "skew_factor", "skew_threshold",
                "distributed_staged")
    jcfg, tcfg = jdfp.SessionConfig(), tdfp.SessionConfig()
    assert {s: getattr(tcfg, s) for s in settings} == {s: getattr(jcfg, s) for s in settings}
    for setting in settings:
        assert getattr(tdfp.SessionConfig(**{setting: 1}), setting) == 1
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=2), device="cpu")
    ctx.register_pydict("t", {"x": list(range(20))})
    handle = ctx.sql("SELECT sum(x) AS s FROM t")
    assert isinstance(handle, DistributedQueryHandle) and handle.mesh.P == 2
    assert handle.collect().to_pylist() == [{"s": 190}]
    path = str(tmp_path / "t.parquet")
    write_parquet(tdfp.HostTable.from_pydict({"x": list(range(20))}), path)
    pq = tdfp.SessionContext(device="cpu")
    pq.register_parquet("t", path)
    assert pq.sql("SELECT sum(x) AS s FROM t").collect().to_pylist() == [{"s": 190}]
    monkeypatch.setenv("DFP_STREAM_ROW_THRESHOLD", "10")
    streamed = ctx.sql("SELECT sum(x) AS s FROM t")
    assert streamed.collect().to_pylist() == [{"s": 190}]
    assert streamed.metrics.route == "streamed" and streamed.metrics.streamed_chunks >= 1


def test_streamed_scale_raises(monkeypatch):
    """Where the JAX executor streams a scan out of core, the port does
    too (it raised before runtime/streaming.py was ported): the 20-row
    table past a 10-row threshold runs streamed and gives the JAX
    package's answer."""
    monkeypatch.setenv("DFP_STREAM_ROW_THRESHOLD", "10")
    data = {"x": list(range(20))}
    ctx = tdfp.SessionContext(device="cpu")
    ctx.register_pydict("t", data)
    handle = ctx.sql("SELECT sum(x) AS s FROM t")
    got = handle.collect().to_pylist()
    jctx = jdfp.SessionContext()
    jctx.register_pydict("t", data)
    jhandle = jctx.sql("SELECT sum(x) AS s FROM t")
    assert got == jhandle.collect().to_pylist() == [{"s": 190}]
    assert handle.metrics.route == "streamed"
    assert handle.metrics.streamed_chunks == jhandle.metrics.streamed_chunks == 1


def test_analyze_reports_rows_per_operator():
    ctx = tdfp.SessionContext(device="cpu")
    _base(lambda n, d, s=None: ctx.register_pydict(n, d, statistics=s), None)
    text = ctx.sql("SELECT a_val, c_val FROM ta LEFT JOIN tc ON a_id = c_id").analyze()
    assert text.splitlines()[0].startswith("Project") and "rows=" in text
