"""Staged execution in the port (runtime/executor.py `_run_staged`): large
multi-join plans run join subtrees one stage at a time with materialized
boundaries. Forced on with DFP_STAGE_THRESHOLD_BYTES=0, as
tests/test_staged.py forces it in the JAX package, and checked for result
equality with the single run and with the JAX package, for settling
per-stage overflow retries, and for a second collect() that runs no retry
and gives the same rows. (The JAX test's compiled-stage cache has no
counterpart: the port runs eagerly and compiles nothing per stage.)"""

import pytest

import datafusion_parallelism_tpu as jdfp
from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext
from datafusion_parallelism_tpu_torch.models.physical import find_joins

from oracle import assert_rows_equal

SQL = ("SELECT a_val, b_val, c_val FROM ta "
       "JOIN tb ON a_id = b_id JOIN tc ON b_id = c_id "
       "WHERE c_val > 6")

AGG_SQL = ("SELECT a_id, SUM(b_val) AS s, COUNT(*) AS n FROM ta "
           "JOIN tb ON a_id = b_id JOIN tc ON b_id = c_id "
           "GROUP BY a_id ORDER BY a_id")

LEFT_SQL = ("SELECT a_val, b_val, c_val FROM ta "
            "LEFT JOIN tb ON a_id = b_id JOIN tc ON a_id = c_id")


def make_ctx(ctx=None):
    ctx = ctx or SessionContext(SessionConfig(), device="cpu")
    n = 64
    ctx.register_pydict("ta", {"a_id": [i % 16 for i in range(n)], "a_val": list(range(n))})
    ctx.register_pydict("tb", {"b_id": [i % 12 for i in range(n)],
                               "b_val": [i * 2 for i in range(n)]})
    ctx.register_pydict("tc", {"c_id": [i % 8 for i in range(32)],
                               "c_val": [i * 3 for i in range(32)]})
    return ctx


@pytest.fixture
def force_staged(monkeypatch):
    monkeypatch.setenv("DFP_STAGE_THRESHOLD_BYTES", "0")


def run_both(sql, monkeypatch):
    single_handle = make_ctx().sql(sql)
    single = single_handle.collect().to_pylist()
    assert not single_handle.metrics.staged
    monkeypatch.setenv("DFP_STAGE_THRESHOLD_BYTES", "0")
    handle = make_ctx().sql(sql)
    staged = handle.collect().to_pylist()
    assert handle.metrics.staged
    return single, staged, handle


def test_staged_matches_single_program(monkeypatch):
    single, staged, handle = run_both(SQL, monkeypatch)
    assert len(find_joins(handle.plan)) == 2  # actually a multi-join plan
    assert_rows_equal(staged, single)


def test_staged_aggregate_pipeline(monkeypatch):
    single, staged, _ = run_both(AGG_SQL, monkeypatch)
    assert staged == single  # ORDER BY: exact order must match too


@pytest.mark.parametrize("sql", [SQL, AGG_SQL, LEFT_SQL], ids=["join", "aggregate", "left"])
def test_staged_matches_jax(sql, force_staged):
    """The port's staged run gives the JAX package's staged rows."""
    want = make_ctx(jdfp.SessionContext()).sql(sql).collect().to_pylist()
    got = make_ctx().sql(sql).collect().to_pylist()
    if "ORDER BY" in sql:
        assert got == want
    else:
        assert_rows_equal(got, want)


def test_staged_second_collect_runs_no_retry(force_staged):
    """A second collect() on one handle reruns every stage on the settled
    capacities: no retry and the same rows (the JAX package's check here is
    that no stage recompiles)."""
    handle = make_ctx().sql(SQL)
    first = handle.collect().to_pylist()
    retries, runs = handle.metrics.retries, handle.metrics.launches
    second = handle.collect().to_pylist()
    assert second == first
    assert handle.metrics.retries == retries
    # one run per stage: each join's stage and the plan's top
    assert handle.metrics.launches - runs == len(find_joins(handle.plan)) + 1


def test_staged_overflow_retry_settles(force_staged):
    handle = make_ctx().sql(SQL)
    rows = handle.collect().to_pylist()
    assert rows  # produced output
    # capacities settled: a second run does not retry further
    retries = handle.metrics.retries
    handle.collect()
    assert handle.metrics.retries == retries


def test_staged_per_stage_overflow_retries(force_staged, monkeypatch):
    """A seed capacity far below the join's output: the stage that owns
    the join grows it and reruns alone until it fits, and the result still
    equals the single run's."""
    monkeypatch.setenv("DFP_MAX_JOIN_SEED_CAP", "16")
    handle = make_ctx().sql(SQL)
    rows = handle.collect().to_pylist()
    assert handle.metrics.retries >= 1
    monkeypatch.delenv("DFP_MAX_JOIN_SEED_CAP")
    monkeypatch.delenv("DFP_STAGE_THRESHOLD_BYTES")
    assert_rows_equal(rows, make_ctx().sql(SQL).collect().to_pylist())
