"""All 22 TPC-H queries through the port's SQL surface on the CPU
(`SessionContext(device="cpu")`, the kernels' plain versions) at SF 0.002:
each result equals the port's copy of the oracle and the JAX package's
`SessionContext` result on the same tables (floats within rtol 1e-9,
tests/oracle.py's rule); and all 22 again under each of the SORT and OA
join strategies, equal to the oracle."""

import pytest

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.tpch.oracle import oracle_query

from oracle import assert_rows_equal


@pytest.fixture(scope="module")
def sessions():
    tables = generate_tables(sf=0.002)
    tctx = tdfp.SessionContext(device="cpu")
    for name, t in tables.items():
        tctx.register_table(name, t)
    jctx = jdfp.SessionContext()
    for name, t in jgenerate(sf=0.002).items():
        jctx.register_table(name, t)
    return tctx, jctx, tables


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_query_matches_oracle_and_jax(sessions, q):
    tctx, jctx, tables = sessions
    handle = tctx.sql(QUERIES[q])
    got = handle.collect().to_pylist()
    assert_rows_equal(got, oracle_query(q, tables))
    assert_rows_equal(got, jctx.sql(QUERIES[q]).collect().to_pylist())
    # the settled capacities run again without a retry
    retries = handle.metrics.retries
    assert_rows_equal(handle.collect().to_pylist(), got)
    assert handle.metrics.retries == retries


@pytest.fixture(scope="module")
def strategy_sessions():
    tables = generate_tables(sf=0.002)
    ctxs = {}
    for strategy in ("SORT", "OA"):
        ctxs[strategy] = tdfp.SessionContext(
            tdfp.SessionConfig(join_strategy=JoinStrategy[strategy]), device="cpu")
        for name, t in tables.items():
            ctxs[strategy].register_table(name, t)
    return ctxs, tables


@pytest.mark.parametrize("strategy", ["SORT", "OA"])
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_query_under_strategy_matches_oracle(strategy_sessions, q, strategy):
    ctxs, tables = strategy_sessions
    handle = ctxs[strategy].sql(QUERIES[q])
    assert f"/{strategy.lower()}]" in handle.explain() or "HashJoin" not in handle.explain()
    assert_rows_equal(handle.collect().to_pylist(), oracle_query(q, tables))
