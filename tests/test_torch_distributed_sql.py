"""The port's distributed SQL executor (`SessionConfig(target_partitions=8)`,
runtime/distributed_executor.py) on the CPU against the JAX package's on its
8-device virtual mesh (tests/conftest.py): the cases of
tests/test_distributed_sql.py on the same seeded inputs, each result equal to
the JAX package's (row multisets; the exact order under a root ORDER BY),
the settled capacities (`metrics.join_caps`), the per-partition candidate
totals (`metrics.balance`) and every join's `dist_mode` equal to JAX's,
keyed by the node's place in the plan (the two packages number their nodes
apart). Where the JAX tests read its compiled HLO, the port's collectives
are read through a recording Exchange. Also: replicated build shards that
stay unwritten, two gloo processes through ProcessGroupExchange, and the
graft entry's SQL, staged and streamed through the mesh."""

import os
import tempfile

import numpy as np
import pytest
import torch

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu_torch.models.physical import PHashJoin
from datafusion_parallelism_tpu_torch.parallel import shuffle as tshuffle
from datafusion_parallelism_tpu_torch.parallel.exchange import InProcessExchange

from oracle import _vals_equal, assert_rows_equal
from test_distributed_sql import QUERIES, STAGED_Q

N_DEV = 8


def _orders_custs(n_ord=400, n_cust=60):
    """tests/test_distributed_sql.py's _make_ctx tables (seed 5)."""
    rng = np.random.default_rng(5)
    return {
        "orders": {"o_id": list(range(n_ord)),
                   "o_cust": [int(x) for x in rng.integers(0, 80, n_ord)],
                   "amount": [round(float(x), 2) for x in rng.random(n_ord) * 100]},
        "custs": {"c_id": list(range(n_cust)),
                  "c_name": [f"c{i:03d}" for i in range(n_cust)],
                  "c_grp": [int(x) for x in rng.integers(0, 5, n_cust)]},
    }


def _sessions(data, partitions=N_DEV, **config):
    """(the port's session on the CPU, the JAX package's), the same tables
    registered in each."""
    t = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=partitions, **config),
                            device="cpu")
    j = jdfp.SessionContext(jdfp.SessionConfig(target_partitions=partitions, **config))
    for name, cols in data.items():
        t.register_pydict(name, dict(cols))
        j.register_pydict(name, dict(cols))
    return t, j


def _port(data, partitions=N_DEV, **config):
    return _sessions(data, partitions, **config)[0]


def _places(plan):
    """node_id / join_id -> the node's place in the plan's walk."""
    out = {}
    for i, n in enumerate(plan.walk()):
        key = getattr(n, "join_id", None) if type(n).__name__ == "PHashJoin" \
            else getattr(n, "node_id", None)
        if key is not None:
            out[key] = i
    return out


def _by_place(plan, metric):
    places = _places(plan)
    return {((places[k[0]], k[1]) if isinstance(k, tuple) else places[k]): v
            for k, v in metric.items()}


def _modes(plan):
    return [n.dist_mode for n in plan.walk() if type(n).__name__ == "PHashJoin"]


def _assert_in_order(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and all(_vals_equal(a[k], b[k]) for k in a), (a, b)


def _run_both(data, sql, partitions=N_DEV, **config):
    """The port's handle and rows, then the JAX package's, on one query."""
    t, j = _sessions(data, partitions, **config)
    th, jh = t.sql(sql), j.sql(sql)
    return th, th.collect().to_pylist(), jh, jh.collect().to_pylist()


def _assert_like_jax(th, jh):
    """Settled capacities, per-partition candidate totals and join modes
    equal to the JAX package's."""
    assert _modes(th.plan) == _modes(jh.plan)
    assert _by_place(th.plan, th.metrics.join_caps) == _by_place(jh.plan, jh.metrics.join_caps)
    assert _by_place(th.plan, th.metrics.balance) == _by_place(jh.plan, jh.metrics.balance)


class RecordingExchange(InProcessExchange):
    """InProcessExchange noting each collective: (kind, the rows an
    all-gather hands a shard along its gathered axis)."""

    def __init__(self, P, device="cpu"):
        super().__init__(P, device)
        self.calls = []

    def all_to_all(self, xs, dim):
        self.calls.append(("all_to_all", xs[0].shape[dim]))
        return super().all_to_all(xs, dim)

    def all_gather(self, xs, dim=0):
        out = super().all_gather(xs, dim)
        self.calls.append(("all_gather", out[0].shape[dim]))
        return out


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_distributed_matches_single(q):
    data = _orders_custs()
    th, got, jh, jgot = _run_both(data, QUERIES[q])
    single = _port(data, 1).sql(QUERIES[q]).collect().to_pylist()
    assert_rows_equal(got, jgot)
    assert_rows_equal(got, single)
    if "ORDER BY" in QUERIES[q] and "LIMIT" not in QUERIES[q]:
        _assert_in_order(got, jgot)
    _assert_like_jax(th, jh)


def test_distributed_broadcast_mode_picked():
    t, j = _sessions(_orders_custs())   # custs is tiny: under broadcast_threshold
    th, jh = t.sql(QUERIES[0]), j.sql(QUERIES[0])
    assert "broadcast" in _modes(th.plan)
    assert _modes(th.plan) == _modes(jh.plan)
    assert [n.probe_mcv_share for n in th.plan.walk() if isinstance(n, PHashJoin)] == \
        [n.probe_mcv_share for n in jh.plan.walk() if type(n).__name__ == "PHashJoin"]


def test_distributed_collect_compiles_once(monkeypatch):
    """The JAX handle compiles its step once; the port's second collect()
    runs the settled capacities with no retry and gives the same rows. As
    the JAX package's distributed handle, it never loads or saves the
    learned capacities (a single-device plan's would leak into P = 8)."""
    from datafusion_parallelism_tpu_torch.runtime.distributed_executor import \
        DistributedQueryHandle

    def refuse(*args):
        raise AssertionError("the distributed handle touched the learned-capacity store")
    monkeypatch.setattr(DistributedQueryHandle, "_load_caps", refuse)
    monkeypatch.setattr(DistributedQueryHandle, "_save_caps", refuse)
    h = _port(_orders_custs()).sql(QUERIES[0])
    first = h.collect().to_pylist()
    retries, launches = h.metrics.retries, h.metrics.launches
    again = h.collect().to_pylist()
    assert h.metrics.retries == retries
    assert h.metrics.launches == launches + 1
    assert_rows_equal(again, first)


def _topk_data(n=4000):
    rng = np.random.default_rng(7)
    return {"t": {"a": [int(x) for x in rng.integers(0, 1000, n)],
                  "b": [round(float(x), 6) for x in rng.random(n)]}}


def test_distributed_topk_gathers_only_k():
    """ORDER BY + LIMIT k moves P x 128 rows an all-gather at most, not the
    sorted child (512 rows a shard: 4,000 rows over 8 partitions)."""
    data = _topk_data()
    sql = "SELECT a, b FROM t ORDER BY b DESC, a LIMIT 10"
    t, j = _sessions(data)
    h = t.sql(sql)
    h.mesh = RecordingExchange(N_DEV)
    got = h.collect().to_pylist()
    jh = j.sql(sql)
    _assert_in_order(got, jh.collect().to_pylist())
    _assert_in_order(got, _port(data, 1).sql(sql).collect().to_pylist())
    gathers = [rows for kind, rows in h.mesh.calls if kind == "all_gather"]
    assert gathers, "no all-gather in the top-k plan"
    assert max(gathers) <= N_DEV * 128, h.mesh.calls
    assert not any(kind == "all_to_all" for kind, _ in h.mesh.calls)
    _assert_like_jax(h, jh)


def _skew_data(n=4096):
    """90% of the probe rows on key 0, the rest over 1,024 keys (seed 3)."""
    rng = np.random.default_rng(3)
    hot = rng.random(n) < 0.9
    keys = np.where(hot, 0, rng.integers(0, 1024, n)).tolist()
    return {"probe": {"k": keys, "v": list(range(n))},
            "build": {"k2": list(range(1024)), "w": [i * 3 for i in range(1024)]}}, rng


SKEW_SQL = ("SELECT SUM(b.w * p.v) AS s, COUNT(*) AS c "
            "FROM build b JOIN probe p ON b.k2 = p.k")


def test_skew_salting_balances_join_capacity():
    """Salting rebalances a skewed join: the largest per-partition candidate
    total (metrics.balance) falls by at least 2x when the hot probe rows
    stay on their partitions; the totals equal the JAX package's."""
    data, _ = _skew_data()
    peak, results = {}, {}
    for salting in (False, True):
        th, got, jh, jgot = _run_both(data, SKEW_SQL, skew_salting=salting,
                                      broadcast_threshold=0)
        assert got == jgot
        _assert_like_jax(th, jh)
        results[salting] = got
        jid = next(x.join_id for x in th.plan.walk() if isinstance(x, PHashJoin))
        peak[salting] = max(th.metrics.balance[jid])
    assert results[True] == results[False]
    assert peak[True] * 2 <= peak[False], peak


def test_distributed_skew_salted_sql():
    """Skewed probe keys through SQL, salting off and on, against the count
    and the sum in Python."""
    rng = np.random.default_rng(11)
    n = 600
    x = rng.random(n)
    skewed = ((30 * (16.0 ** x - 1) / 15.0)).astype(int).tolist()
    data = {"probe": {"k": skewed, "v": list(range(n))},
            "build": {"k2": list(range(32)), "w": [i * 10 for i in range(32)]}}
    sql = ("SELECT SUM(b.w * p.v) AS s, COUNT(*) AS n FROM build b "
           "JOIN probe p ON b.k2 = p.k")
    for salting in (False, True):
        th, got, jh, jgot = _run_both(data, sql, skew_salting=salting, broadcast_threshold=0)
        assert got[0]["n"] == sum(1 for k in skewed if k < 32)
        assert got[0]["s"] == sum(k2 * 10 * v for v, k2 in enumerate(skewed) if k2 < 32)
        assert got == jgot
        _assert_like_jax(th, jh)


def test_root_order_by_local_sort_no_collectives():
    """ORDER BY without LIMIT: shards sort locally and the host merge
    restores the order at collection; no collective moves the result
    (comm_bytes == 0, and none is called)."""
    rng = np.random.default_rng(13)
    n = 3000
    data = {"t": {"a": [int(x) for x in rng.integers(0, 500, n)],
                  "b": [round(float(x), 6) for x in rng.random(n)]}}
    h = _port(data).sql("SELECT a, b FROM t ORDER BY a, b DESC")
    h.mesh = RecordingExchange(N_DEV)
    got = h.collect().to_pylist()
    expected = sorted(({"a": a, "b": b} for a, b in zip(data["t"]["a"], data["t"]["b"])),
                      key=lambda r: (r["a"], -r["b"]))
    assert got == expected      # the exact order, not just the multiset
    assert h.metrics.comm_bytes == 0, h.metrics.comm_bytes
    assert h.mesh.calls == []


def _three_tables():
    """tests/test_distributed_sql.py's _ctx3 tables."""
    data = _orders_custs()
    data["grps"] = {"g_id": list(range(5)), "g_name": [f"g{i}" for i in range(5)]}
    return data


def test_distributed_staged_matches_whole_plan():
    """Staged execution (one run a join, its output kept as shards for the
    next stage) returns the whole plan's rows and JAX's, records a stage's
    bytes a partition for every stage, and runs again with no retry."""
    data = _three_tables()
    whole = _port(data, broadcast_threshold=0, distributed_staged=False).sql(STAGED_Q)
    wrows = whole.collect().to_pylist()
    assert not whole.metrics.staged and whole.metrics.stage_bytes == []
    hs, staged, jh, jrows = _run_both(data, STAGED_Q, broadcast_threshold=0,
                                      distributed_staged=True)
    assert hs.metrics.staged
    _assert_in_order(staged, wrows)
    _assert_in_order(staged, jrows)
    # one stage a non-root join, then the root
    assert len(hs.metrics.stage_bytes) >= 2, hs.metrics.stage_bytes
    assert len(hs.metrics.stage_bytes) == len(jh.metrics.stage_bytes)
    for sb in hs.metrics.stage_bytes:
        assert sb["leaf_bytes_per_device"] + sb["mat_bytes_per_device"] \
            + sb["out_bytes_per_device"] > 0
        assert sb["out_bytes_per_device"] > 0
    assert hs.metrics.comm_bytes == jh.metrics.comm_bytes > 0
    assert hs.metrics.comm_bytes == whole.metrics.comm_bytes
    assert hs.metrics.balance and all(len(v) == N_DEV for v in hs.metrics.balance.values())
    _assert_like_jax(hs, jh)
    retries = hs.metrics.retries
    again = hs.collect().to_pylist()
    assert hs.metrics.retries == retries
    _assert_in_order(again, staged)


def test_comm_bytes_and_balance_recorded_whole_plan():
    th, _, jh, _ = _run_both(_orders_custs(), QUERIES[0])
    assert th.metrics.comm_bytes > 0
    assert th.metrics.balance and all(len(v) == N_DEV for v in th.metrics.balance.values())
    _assert_like_jax(th, jh)


def test_auto_skew_salting_from_statistics():
    """skew_salting unset: the planner salts a join from the catalog's
    hot-key share when the probe side's hottest key would overload one
    partition, and leaves a uniform one partitioned, as JAX's does."""
    data, rng = _skew_data()
    th, hot_rows, jh, jrows = _run_both(data, SKEW_SQL, broadcast_threshold=0)
    assert th.config.skew_salting is None
    assert _modes(th.plan) == ["skew_salted"]
    assert hot_rows == jrows
    _assert_like_jax(th, jh)
    uniform = dict(data, probe={"k": [int(x) for x in rng.integers(0, 1024, 4096)],
                                "v": list(range(4096))})
    t, j = _sessions(uniform, broadcast_threshold=0)
    assert _modes(t.sql(SKEW_SQL).plan) == _modes(j.sql(SKEW_SQL).plan) == ["partitioned"]
    forced = _port(data, skew_salting=False, broadcast_threshold=0)
    assert hot_rows == forced.sql(SKEW_SQL).collect().to_pylist()


OWNER_DEDUP_SQL = [
    # LEFT (build-outer): every customer once per matching order, or once
    # with NULL
    "SELECT c.c_grp, COUNT(o.o_id) AS n, SUM(o.amount) AS s "
    "FROM custs c LEFT JOIN orders o ON c.c_id = o.o_cust "
    "GROUP BY c.c_grp ORDER BY c.c_grp",
    # FULL: both unmatched sides
    "SELECT COUNT(*) AS n, SUM(o.amount) AS s FROM custs c "
    "FULL JOIN orders o ON c.c_id = o.o_cust",
    # LEFT_SEMI / LEFT_ANTI via EXISTS / NOT EXISTS
    "SELECT c.c_grp, COUNT(*) AS n FROM custs c WHERE EXISTS "
    "(SELECT 1 FROM orders o WHERE o.o_cust = c.c_id) "
    "GROUP BY c.c_grp ORDER BY c.c_grp",
    "SELECT c.c_id FROM custs c WHERE NOT EXISTS "
    "(SELECT 1 FROM orders o WHERE o.o_cust = c.c_id) ORDER BY c.c_id",
]


def _owner_dedup_data(n_ord=4000):
    """tests/test_distributed_sql.py's owner-dedup tables (seed 11): 40
    customers (under broadcast_threshold), only even ids match."""
    rng = np.random.default_rng(11)
    return {"orders": {"o_id": list(range(n_ord)),
                       "o_cust": [int(x) for x in rng.integers(0, 60, n_ord)],
                       "amount": [round(float(x), 2) for x in rng.random(n_ord) * 10]},
            "custs": {"c_id": [2 * i for i in range(40)], "c_grp": [i % 4 for i in range(40)]}}


def test_broadcast_build_emitting_owner_dedup():
    """Broadcast LEFT, FULL, LEFT_SEMI and LEFT_ANTI: the replicated build
    dedups through the OR-reduced visited masks and owner emission."""
    data = _owner_dedup_data()
    for i, sql in enumerate(OWNER_DEDUP_SQL):
        th, got, jh, jgot = _run_both(data, sql)
        assert "broadcast" in _modes(th.plan), (i, _modes(th.plan))
        assert_rows_equal(got, jgot)
        assert_rows_equal(got, _port(data, 1).sql(sql).collect().to_pylist())
        _assert_like_jax(th, jh)


def test_broadcast_replicas_stay_unwritten(monkeypatch):
    """In process, the broadcast all-gather hands the 8 shards one table:
    the LEFT join's 8 local joins read it, and each shard's visited flags
    differ (each probes its own orders), so a write into the shared
    replica (a visited buffer, a row count) would change the other shards'
    answers. The replica's bytes are the same after the query, and the
    rows are JAX's and the single partition's."""
    replicas = []
    gather = tshuffle.all_gather_table

    def recording(ex, shards):
        out = gather(ex, shards)
        replicas.append((out, [(v.clone(), valid.clone()) for v, valid in
                               out[0].columns.values()], out[0].num_rows.clone()))
        return out

    from datafusion_parallelism_tpu_torch.runtime import distributed_executor
    monkeypatch.setattr(distributed_executor, "all_gather_table", recording)
    data = _owner_dedup_data()
    sql = OWNER_DEDUP_SQL[0]
    th, got, jh, jgot = _run_both(data, sql)
    build = [r for r in replicas if "c.c_id" in r[0][0].schema.names]
    assert build and all(t is build[0][0][0] for t in build[0][0]), "not one shared replica"
    for out, cols, n in build:
        assert torch.equal(out[0].num_rows, n)
        for (v, valid), (v0, valid0) in zip(out[0].columns.values(), cols):
            assert torch.equal(v, v0) and torch.equal(valid, valid0)
    join = next(x for x in th.plan.walk() if isinstance(x, PHashJoin))
    assert join.dist_mode == "broadcast" and join.join_type.value == "left"
    assert len(set(th.metrics.balance[join.join_id])) > 1   # the shards probe apart
    assert_rows_equal(got, jgot)
    assert_rows_equal(got, _port(data, 1).sql(sql).collect().to_pylist())


def test_skewed_send_cap_seeded_no_retry():
    """A hot probe key (share ~0.8) with salting off: the planner's hot-key
    share seeds the send capacity, so the first run fits."""
    rng = np.random.default_rng(13)
    n = 8192
    hot = rng.random(n) < 0.8
    data = {"orders": {"o_cust": [7 if h else int(x)
                                  for h, x in zip(hot, rng.integers(0, 500, n))],
                       "amount": [float(round(x, 2)) for x in rng.random(n) * 10]},
            "custs": {"c_id": list(range(500)), "c_grp": [i % 5 for i in range(500)]}}
    sql = ("SELECT c.c_grp, SUM(o.amount) AS s, COUNT(*) AS n "
           "FROM custs c JOIN orders o ON c.c_id = o.o_cust "
           "GROUP BY c.c_grp ORDER BY c.c_grp")
    th, got, jh, jgot = _run_both(data, sql, skew_salting=False, broadcast_threshold=0)
    assert_rows_equal(got, _port(data, 1).sql(sql).collect().to_pylist())
    _assert_in_order(got, jgot)
    assert th.metrics.retries == 0, f"seeded send caps still retried {th.metrics.retries}x"
    _assert_like_jax(th, jh)


def test_skew_salted_build_emitting_joins():
    """skew_salted for LEFT, FULL, LEFT_SEMI and LEFT_ANTI (the light/heavy
    split): each equal to the unsalted run and to JAX's, the optimizer
    picking the salted mode, and the LEFT join's per-partition candidate
    totals within ~2x of uniform."""
    rng = np.random.default_rng(5)
    n = 4096
    hot = rng.random(n) < 0.9
    keys = np.where(hot, 0, rng.integers(0, 1024, n))
    # 2% dangling probe keys (no build partner): FULL's probe-side emission
    keys = np.where(rng.random(n) < 0.02, 5000 + keys, keys).tolist()
    # half the build keys have no probe rows: deferred build emissions
    data = {"probe": {"k": keys, "v": list(range(n))},
            "build": {"k2": list(range(2048)), "w": [i * 3 for i in range(2048)]}}
    sqls = {
        "left": ("SELECT COUNT(*) AS c, SUM(p.v) AS s, SUM(b.w) AS bw "
                 "FROM build b LEFT JOIN probe p ON b.k2 = p.k"),
        "full": ("SELECT COUNT(*) AS c, SUM(p.v) AS s, SUM(b.w) AS bw "
                 "FROM build b FULL JOIN probe p ON b.k2 = p.k"),
        "left_semi": ("SELECT COUNT(*) AS c, SUM(b.w) AS bw FROM build b "
                      "WHERE EXISTS (SELECT 1 FROM probe p WHERE p.k = b.k2)"),
        "left_anti": ("SELECT COUNT(*) AS c, SUM(b.w) AS bw FROM build b "
                      "WHERE NOT EXISTS (SELECT 1 FROM probe p WHERE p.k = b.k2)"),
    }
    covered = set()
    for name, sql in sqls.items():
        results = {}
        for salting in (False, True):
            th, got, jh, jgot = _run_both(data, sql, skew_salting=salting,
                                          broadcast_threshold=0)
            assert_rows_equal(got, jgot)
            _assert_like_jax(th, jh)
            results[salting] = got
            join = next(x for x in th.plan.walk() if isinstance(x, PHashJoin))
            if salting:
                assert join.dist_mode == "skew_salted", join.dist_mode
                covered.add(join.join_type.value)
                if name == "left":
                    bal = th.metrics.balance[join.join_id]
                    assert max(bal) <= 2 * (sum(bal) / len(bal) + 1), bal
        assert_rows_equal(results[True], results[False])
    assert covered == {"left", "full", "left_semi", "left_anti"}, covered


def _gloo_rank(rank, store, out_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=__import__("datetime").timedelta(seconds=60))
    try:
        h = _port(_orders_custs(), 2).sql(QUERIES[0])
        rows = h.collect().to_pylist()
        torch.save((rows, repr(h.mesh), _by_place(h.plan, h.metrics.join_caps),
                    _by_place(h.plan, h.metrics.balance)), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gloo_two_processes_equal_in_process():
    """QUERIES[0] at target_partitions=2 in two spawned CPU processes, one
    partition each through ProcessGroupExchange over gloo: each process
    returns the rows, capacities and candidate totals of the in-process
    run at P = 2."""
    import torch.multiprocessing as mp
    want = _port(_orders_custs(), 2).sql(QUERIES[0])
    want_rows = want.collect().to_pylist()
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, store, d)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        for r in range(2):
            rows, mesh, caps, balance = torch.load(os.path.join(d, f"{r}.pt"))
            assert mesh.startswith("ProcessGroupExchange(P=2"), mesh
            _assert_in_order(rows, want_rows)
            assert caps == _by_place(want.plan, want.metrics.join_caps)
            assert balance == _by_place(want.plan, want.metrics.balance)


def test_send_blocks_sized_from_counts_past_the_budget(monkeypatch):
    """Past RECV_BUDGET_BYTES a shuffle's send capacity is the
    most rows one shard sends one partition (K18's counts), never more
    than the static one: the received shard holds the same rows, in order,
    in P x that capacity; the drops (and their retry) stay where the static
    capacity puts them; and SQL gives the JAX package's rows."""
    from datafusion_parallelism_tpu_torch import parallel as tpar
    from datafusion_parallelism_tpu_torch.utils.columnar import HostTable
    rng = np.random.default_rng(21)
    t = HostTable.from_pydict({"k": [int(x) for x in rng.integers(0, 300, 1000)],
                               "v": [float(x) for x in rng.random(1000)]})
    ex = tpar.make_mesh(N_DEV, "cpu")
    cols, num, schema, _ = tshuffle.partition_table(t, N_DEV)
    shards = tshuffle.local_shards(ex, schema, cols, num)
    static, d0 = tshuffle.shuffle_by_hash(ex, shards, ["k"], 1024)
    monkeypatch.setattr(tshuffle, "RECV_BUDGET_BYTES", 1)
    fitted, d1 = tshuffle.shuffle_by_hash(ex, shards, ["k"], 1024)
    assert int(d0) == int(d1) == 0
    assert fitted[0].capacity == N_DEV * 128 < static[0].capacity == N_DEV * 1024
    for a, b in zip(fitted, static):
        assert torch.equal(a.num_rows, b.num_rows)
        n = int(a.num_rows)
        for name in schema.names:
            assert torch.equal(a.columns[name][0][:n], b.columns[name][0][:n])
    _, dropped = tshuffle.shuffle_by_hash(ex, shards, ["k"], 4)
    assert int(dropped) == int(tshuffle.shuffle_by_hash(ex, shards, ["k"], 4)[1]) > 0
    for sql in (QUERIES[0], QUERIES[2], QUERIES[3]):
        _, got, _, jgot = _run_both(_orders_custs(), sql)
        assert_rows_equal(got, jgot)


def test_graft_entry_dryrun_sql(monkeypatch):
    """The SQL half of __graft_entry__.dryrun_multichip at P = 8: a
    three-table star query staged (DFP_DIST_STAGED=1) and a LEFT join
    whose order-less customers must each be emitted once, against the same
    Python oracle; both again streamed through the mesh
    (DFP_STREAM_THRESHOLD_BYTES=0), against the same oracle."""
    import collections
    rng = np.random.default_rng(1)
    n_ord = 64 * N_DEV
    data = {"orders": {"o_id": list(range(n_ord)),
                       "o_cust": [int(x) for x in rng.integers(0, 24, n_ord)],
                       "amount": [float(round(x, 2)) for x in rng.random(n_ord) * 9]},
            "custs": {"c_id": list(range(32)), "c_grp": [i % 3 for i in range(32)],
                      "c_nat": [i % 4 for i in range(32)]},
            "nations": {"n_id": list(range(4)), "n_name": [f"n{i}" for i in range(4)]}}
    orders, custs, nations = data["orders"], data["custs"], data["nations"]
    star = ("SELECT n.n_name, SUM(o.amount) AS total, COUNT(*) AS cnt "
            "FROM nations n JOIN custs c ON n.n_id = c.c_nat "
            "JOIN orders o ON c.c_id = o.o_cust GROUP BY n.n_name ORDER BY total DESC")
    left = ("SELECT c.c_grp AS grp, COUNT(*) AS cnt, SUM(o.amount) AS total FROM custs c "
            "LEFT JOIN orders o ON c.c_id = o.o_cust GROUP BY c.c_grp")
    nat_of = {c: nations["n_name"][custs["c_nat"][c]] for c in custs["c_id"]}
    star_want = collections.defaultdict(lambda: [0.0, 0])
    for cust, amt in zip(orders["o_cust"], orders["amount"]):
        star_want[nat_of[cust]][0] += amt
        star_want[nat_of[cust]][1] += 1
    left_want = collections.defaultdict(lambda: [0.0, 0])
    for c, grp in zip(custs["c_id"], custs["c_grp"]):
        m = [a for cu, a in zip(orders["o_cust"], orders["amount"]) if cu == c]
        left_want[grp][0] += sum(m)
        left_want[grp][1] += max(len(m), 1)

    monkeypatch.setenv("DFP_DIST_STAGED", "1")
    h = _port(data).sql(star)
    rows = h.collect().to_pylist()
    assert h.metrics.staged and h.metrics.stage_bytes
    assert [r["total"] for r in rows] == sorted((r["total"] for r in rows), reverse=True)
    assert {r["n_name"]: [pytest.approx(r["total"]), r["cnt"]] for r in rows} == \
        {k: list(v) for k, v in star_want.items()}
    rows = _port(data).sql(left).collect().to_pylist()
    assert {r["grp"]: [pytest.approx(r["total"] or 0.0), r["cnt"]] for r in rows} == \
        {k: list(v) for k, v in left_want.items()}
    monkeypatch.delenv("DFP_DIST_STAGED")
    monkeypatch.setenv("DFP_STREAM_THRESHOLD_BYTES", "0")
    h = _port(data).sql(star)
    rows = h.collect().to_pylist()
    assert h.metrics.route.startswith("streamed") and h.metrics.streamed_chunks >= 1
    assert [r["total"] for r in rows] == sorted((r["total"] for r in rows), reverse=True)
    assert {r["n_name"]: [pytest.approx(r["total"]), r["cnt"]] for r in rows} == \
        {k: list(v) for k, v in star_want.items()}
    h = _port(data).sql(left)
    rows = h.collect().to_pylist()
    assert h.metrics.route.startswith("streamed") and h.metrics.streamed_chunks >= 1
    assert {r["grp"]: [pytest.approx(r["total"] or 0.0), r["cnt"]] for r in rows} == \
        {k: list(v) for k, v in left_want.items()}
