"""TPC-H queries 12-22 and the staged Q9 and Q10 through the port's
distributed executor at P = 8 on the CPU, against the oracle and the JAX
package's distributed results: the second half of
tests/test_torch_tpch_distributed.py, whose checks these are."""

import pytest

from datafusion_parallelism_tpu_torch.tpch import QUERIES

from test_torch_tpch_distributed import check_query, check_staged, dataset  # noqa: F401


@pytest.mark.parametrize("q", [q for q in sorted(QUERIES) if q > 11])
def test_tpch_distributed(dataset, q):  # noqa: F811
    check_query(dataset, q)


@pytest.mark.parametrize("q", [9, 10])
def test_tpch_distributed_staged(dataset, q, monkeypatch):  # noqa: F811
    check_staged(dataset, q, monkeypatch)


def test_staged_collect_settles(monkeypatch):
    """Q17 staged at SF 0.1: its subquery's grouped aggregate runs in a
    stage below the root, and the later stages leave its capacity alone, so
    a second collect() runs the settled capacities with no retry. (The JAX
    package's staged collect reads the aggregate's total as 0 in the later
    stages and shrinks its capacity 64x, so each collect() at this size
    retries once.)"""
    import datafusion_parallelism_tpu_torch as tdfp
    from datafusion_parallelism_tpu_torch.tpch import generate_tables
    from datafusion_parallelism_tpu_torch.tpch.oracle import oracle_query

    from oracle import assert_rows_equal

    monkeypatch.setenv("DFP_DIST_STAGED", "1")
    tables = generate_tables(sf=0.1)
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=8), device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    handle = ctx.sql(QUERIES[17])
    rows = handle.collect().to_pylist()
    assert handle.metrics.staged
    assert_rows_equal(rows, oracle_query(17, tables))
    retries, caps = handle.metrics.retries, dict(handle.metrics.join_caps)
    assert max(v for k, v in caps.items() if not isinstance(k, tuple)) > 4096
    assert_rows_equal(handle.collect().to_pylist(), rows)
    assert handle.metrics.retries == retries
    assert handle.metrics.join_caps == caps
