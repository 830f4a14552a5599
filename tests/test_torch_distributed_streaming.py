"""The port's distributed morsel streaming (runtime/distributed_streaming.py)
on the CPU: the biggest scan chunked through `SessionConfig(target_partitions=8)`
(8 partitions in process, `device="cpu"`, the kernels' plain versions)
against the JAX package's streamed run on its 8-device virtual mesh, at
tests/test_distributed_streaming.py's settings (DFP_STREAM_THRESHOLD_BYTES=0,
DFP_STREAM_CHUNK_ROWS=2048): TPC-H SF 0.01 Q1, Q3, Q5 and Q13 and its LEFT,
NOT EXISTS and FULL cells over the same seeded tables, each equal to the
JAX package's rows, chunks, retries, comm bytes and settled capacities (by
plan place) and to an independent answer; the timeline's pack and upload
windows opening before the previous chunk is validated (the double
buffer's order; the device-side overlap is read on the card); a chunk
retried from the
state it started from; and no GPU, no CUDA session."""

import random

import pytest

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.tpch import QUERIES as JQUERIES
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu_torch.models.physical import PHashJoin
from datafusion_parallelism_tpu_torch.runtime import distributed_streaming as dstream
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.tpch.oracle import oracle_query

from oracle import assert_rows_equal
from test_torch_distributed_sql import _by_place

N_DEV = 8
STREAM_ENV = {"DFP_STREAM_THRESHOLD_BYTES": "0", "DFP_STREAM_CHUNK_ROWS": "2048"}
TPCH_QS = (1, 3, 5, 13)
# tests/test_distributed_streaming.py's visited cells
VISITED_SQL = {
    "left": "SELECT c.grp AS g, COUNT(o.v) AS cnt, SUM(o.v) AS s FROM custs c "
            "LEFT JOIN orders o ON c.id = o.cust GROUP BY c.grp",
    "not_exists": "SELECT c.grp AS g, COUNT(*) AS cnt FROM custs c WHERE NOT EXISTS "
                  "(SELECT 1 FROM orders o WHERE o.cust = c.id) GROUP BY c.grp",
    "full": "SELECT COUNT(*) AS n, SUM(o.v) AS s, MIN(c.grp) AS mg FROM custs c "
            "FULL JOIN orders o ON c.id = o.cust",
}


def _visited_data():
    """The JAX test's custs x orders, from its seed."""
    rng = random.Random(3)
    n = 20000
    custs = {"id": list(range(300)), "grp": [i % 5 for i in range(300)]}
    orders = {"oid": list(range(n)),
              "cust": [rng.randrange(150) if rng.random() > 0.04 else 300 + rng.randrange(40)
                       for _ in range(n)],
              "v": [float(i % 11) for i in range(n)]}
    return {"custs": custs, "orders": orders}


def _summary(h, rows):
    m = h.metrics
    return {"rows": rows, "chunks": m.streamed_chunks, "retries": m.retries,
            "comm": m.comm_bytes, "caps": _by_place(h.plan, m.join_caps)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's streamed runs, once: TPC-H at SF 0.01 and the
    visited cells."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in STREAM_ENV.items():
            mp.setenv(k, v)
        ctx = jdfp.SessionContext(jdfp.SessionConfig(target_partitions=N_DEV))
        for name, t in jgenerate(sf=0.01).items():
            ctx.register_table(name, t)
        for q in TPCH_QS:
            h = ctx.sql(JQUERIES[q])
            out[q] = _summary(h, h.collect().to_pylist())
        ctx = jdfp.SessionContext(jdfp.SessionConfig(target_partitions=N_DEV))
        for name, cols in _visited_data().items():
            ctx.register_pydict(name, cols)
        for cell, sql in VISITED_SQL.items():
            h = ctx.sql(sql)
            out[cell] = _summary(h, h.collect().to_pylist())
    return out


@pytest.fixture(scope="module")
def tpch_port():
    tables = generate_tables(sf=0.01)
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=N_DEV), device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx, tables, {}


def _stream(ctx, sql, monkeypatch):
    for k, v in STREAM_ENV.items():
        monkeypatch.setenv(k, v)
    h = ctx.sql(sql)
    return h, h.collect().to_pylist()


def _port_tpch(tpch_port, q, monkeypatch):
    """The port's streamed run of TPC-H query q, once a module."""
    ctx, _, runs = tpch_port
    if q not in runs:
        runs[q] = _stream(ctx, QUERIES[q], monkeypatch)
    return runs[q]


def _assert_like_jax(h, rows, want):
    assert h.metrics.route.startswith("streamed"), h.metrics.route
    assert h.metrics.streamed_chunks > 1
    assert h.metrics.comm_bytes > 0
    got = _summary(h, rows)
    assert_rows_equal(got.pop("rows"), want["rows"])
    assert got == {k: v for k, v in want.items() if k != "rows"}


@pytest.mark.parametrize("q", TPCH_QS)
def test_tpch_streamed_like_jax(tpch_port, jax_runs, q, monkeypatch):
    """Rows == the oracle and JAX's; chunks, retries, comm bytes (the
    prepare's last attempt, every dispatched chunk, the finish) and the
    settled capacities == JAX's."""
    h, rows = _port_tpch(tpch_port, q, monkeypatch)
    assert_rows_equal(rows, oracle_query(q, tpch_port[1]))
    _assert_like_jax(h, rows, jax_runs[q])


@pytest.mark.parametrize("cell", sorted(VISITED_SQL))
def test_visited_cells_streamed_like_jax(jax_runs, cell, monkeypatch):
    """LEFT, NOT EXISTS and FULL: per-partition visited masks over the
    frozen build shards and the flush pass, == JAX's streamed run and the
    port's own single-partition resident run."""
    data = _visited_data()
    single = tdfp.SessionContext(device="cpu")
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=N_DEV), device="cpu")
    for name, cols in data.items():
        single.register_pydict(name, cols)
        ctx.register_pydict(name, cols)
    want = single.sql(VISITED_SQL[cell]).collect().to_pylist()
    h, rows = _stream(ctx, VISITED_SQL[cell], monkeypatch)
    assert_rows_equal(rows, want)
    _assert_like_jax(h, rows, jax_runs[cell])
    assert [j.join_id for j in h.stream_plan().visited_joins], "no visited join streamed"


def test_timeline_overlaps_pack_and_compute(tpch_port, monkeypatch):
    """Chunk i + 1's pack and upload window opens before chunk i is
    validated (its totals read): the double buffer's order. Each window
    records whether the device still ran the previous step; on the CPU
    every step has ended when its dispatch returns, so none is busy (the
    card's reading is chip_smoke.py phase 22's)."""
    h, _ = _port_tpch(tpch_port, 3, monkeypatch)
    tl = h.metrics.stream_timeline
    packs = {e["chunk"]: e for e in tl if e["event"] == "pack_upload"}
    validated = {e["chunk"]: e for e in tl if e["event"] == "validated"}
    dispatched = [e["chunk"] for e in tl if e["event"] == "dispatch"]
    assert sorted(validated) == dispatched == list(range(h.metrics.streamed_chunks))
    overlapped = sum(1 for c, e in packs.items()
                     if c - 1 in validated and e["t0"] < validated[c - 1]["t"])
    assert overlapped == h.metrics.streamed_chunks - 1 > 0
    assert all(e["busy_t0"] is False and e["busy_t1"] is False for e in packs.values())
    assert h.metrics.host_pack_s > 0 and h.metrics.upload_s >= 0


def test_chunk_retry_from_its_start_state(monkeypatch):
    """A tiny seeded candidate capacity and probe send block on the
    streamed LEFT join: the first chunk overflows and runs again from the
    accumulators and visited masks it was given (which no step writes);
    the rows equal an unforced run's and every chunk is counted once."""
    data = _visited_data()
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=N_DEV), device="cpu")
    for name, cols in data.items():
        ctx.register_pydict(name, cols)
    free, want = _stream(ctx, VISITED_SQL["left"], monkeypatch)
    seen = []
    dispatch_join = dstream._dist_fused_child

    def fused_child(agg, tables, ctx, ex):
        before = {j: [v.clone() for v in vs] for j, vs in ctx.stream_visited.items()}
        out = dispatch_join(agg, tables, ctx, ex)
        for j, vs in before.items():   # the incoming masks left as they were
            assert all(bool((a == b).all()) for a, b in zip(vs, ctx.stream_visited[j]))
            seen.append(j)
        return out

    monkeypatch.setattr(dstream, "_dist_fused_child", fused_child)
    h = ctx.sql(VISITED_SQL["left"])
    join = next(n for n in h.plan.walk() if isinstance(n, PHashJoin))
    h._caps[join.join_id] = 256
    h._caps[(join.join_id, "ps")] = 64
    rows = h.collect().to_pylist()
    assert h.metrics.retries > 0
    assert seen
    assert_rows_equal(rows, want)
    assert h.metrics.streamed_chunks == free.metrics.streamed_chunks


def test_chunk_shards_follow_jax(monkeypatch):
    """The chunk rule for P partitions (JAX's `_chunk_shards`): a power of
    two (at least 128 rows a partition, at most the table rounded up) cut
    to a multiple of P, contiguous shards, the last chunk's rows on the
    first partitions."""
    assert dstream.stream_chunk_rows(60_000, 8) == 1 << 16
    assert dstream.stream_chunk_rows(100, 8) == 1024
    assert dstream.stream_chunk_rows(100, 6) == 1020
    monkeypatch.setenv("DFP_STREAM_CHUNK_ROWS", str(1 << 15))
    assert dstream.stream_chunk_rows(60_000, 8) == 1 << 15
    assert dstream.chunk_counts(60_000, 0, 1 << 15, 8) == [4096] * 8
    assert dstream.chunk_counts(60_000, 1 << 15, 1 << 15, 8) == [4096] * 6 + [2656, 0]
    assert dstream.chunk_counts(10, 0, 1024, 8) == [10] + [0] * 7


def test_no_gpu_no_cuda_session(monkeypatch):
    """Without a GPU the default device ("cuda") raises before any query
    runs; nothing falls back to the CPU."""
    for k, v in STREAM_ENV.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdfp.SessionContext(tdfp.SessionConfig(target_partitions=N_DEV))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdfp.SessionContext(tdfp.SessionConfig(target_partitions=N_DEV), device="cuda")
