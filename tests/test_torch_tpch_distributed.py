"""TPC-H through the port's distributed executor on the CPU
(`SessionConfig(target_partitions=8)`, `device="cpu"`: 8 partitions in
process, the kernels' plain versions) at SF 0.002, the port's copy of
tests/test_tpch_distributed.py: each query equal to the port's copy of the
oracle and to the JAX package's distributed result on its 8-device virtual
mesh, with the same settled capacities, per-partition candidate totals,
join modes and retries, and run again with no retry; Q3, Q5, Q9 and Q10
staged too (DFP_DIST_STAGED=1, one run a join stage). Queries 1-11 and the
staged Q3 and Q5 here, the rest in tests/test_torch_tpch_distributed_more.py
(the two files run on two workers under --dist loadfile)."""

import pytest

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.tpch.oracle import oracle_query

from oracle import assert_rows_equal
from test_torch_distributed_sql import _assert_like_jax


@pytest.fixture(scope="module")
def dataset():
    tables = generate_tables(sf=0.002)
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=8), device="cpu")
    jctx = jdfp.SessionContext(jdfp.SessionConfig(target_partitions=8))
    for name, t in jgenerate(sf=0.002).items():
        jctx.register_table(name, t)
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx, jctx, tables


def check_query(dataset, q):
    ctx, jctx, tables = dataset
    handle, jhandle = ctx.sql(QUERIES[q]), jctx.sql(QUERIES[q])
    actual = handle.collect().to_pylist()
    assert not handle.metrics.staged
    assert_rows_equal(actual, oracle_query(q, tables))
    assert_rows_equal(actual, jhandle.collect().to_pylist())
    _assert_like_jax(handle, jhandle)
    assert handle.metrics.retries == jhandle.metrics.retries
    retries = handle.metrics.retries
    assert_rows_equal(handle.collect().to_pylist(), actual)
    assert handle.metrics.retries == retries


def check_staged(dataset, q, monkeypatch):
    monkeypatch.setenv("DFP_DIST_STAGED", "1")
    ctx, jctx, tables = dataset
    handle, jhandle = ctx.sql(QUERIES[q]), jctx.sql(QUERIES[q])
    actual = handle.collect().to_pylist()
    assert handle.metrics.staged
    joins = [n for n in handle.plan.walk() if type(n).__name__ == "PHashJoin"]
    # one stage a join below the root, then the root
    assert len(handle.metrics.stage_bytes) == len(joins) + (handle.plan not in joins)
    assert all(sb["out_bytes_per_device"] > 0 for sb in handle.metrics.stage_bytes)
    assert_rows_equal(actual, oracle_query(q, tables))
    assert_rows_equal(actual, jhandle.collect().to_pylist())
    assert len(handle.metrics.stage_bytes) == len(jhandle.metrics.stage_bytes)
    _assert_like_jax(handle, jhandle)


@pytest.mark.parametrize("q", [q for q in sorted(QUERIES) if q <= 11])
def test_tpch_distributed(dataset, q):
    check_query(dataset, q)


@pytest.mark.parametrize("q", [3, 5])
def test_tpch_distributed_staged(dataset, q, monkeypatch):
    check_staged(dataset, q, monkeypatch)
