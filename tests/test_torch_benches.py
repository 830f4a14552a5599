"""The port's microbenchmarks (`datafusion_parallelism_tpu_torch/benches/`)
on the CPU at the sizes `tests/test_bench_smoke.py` runs the JAX benches
at: each module's JSON line and keys, its scenario generator against the
JAX bench's on the same seed (the root `benches/bench_lib.py` and
`benches/my_benchmark.py` import only numpy and are loaded by path), and
its checked answer against the JAX bench's computation run here under
JAX_PLATFORMS=cpu. Tolerances: integers exact; float32 values summed
(float64 sums of them in another order) within rtol 1e-6. Each module is
called in process through `main(argv)`; without `--device cpu` each
raises, since this host has no card."""

import importlib
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu.ops.aggregate import AggSpec as JAggSpec
from datafusion_parallelism_tpu.ops.aggregate import hash_aggregate_counted as j_agg
from datafusion_parallelism_tpu.ops.hashing import hash_rows as j_hash_rows
from datafusion_parallelism_tpu.ops.join import JoinType as JJoinType
from datafusion_parallelism_tpu.ops.join import hash_join as j_hash_join
from datafusion_parallelism_tpu.ops.sort import SortKey as JSortKey
from datafusion_parallelism_tpu.ops.sort import sort_table as j_sort_table
from datafusion_parallelism_tpu.parallel import DistJoinConfig as JDistJoinConfig
from datafusion_parallelism_tpu.parallel import distributed_hash_join as j_dist_join
from datafusion_parallelism_tpu.parallel import make_mesh as j_make_mesh
from datafusion_parallelism_tpu.utils.columnar import HostTable as JHostTable
from datafusion_parallelism_tpu.utils.columnar import filter_rows as j_filter_rows
from datafusion_parallelism_tpu.utils.columnar import replicate_rows_exact
from datafusion_parallelism_tpu_torch import HostTable
from datafusion_parallelism_tpu_torch.benches import (bench_lib, build_speed,
                                                      dist_stream_sweep,
                                                      exponential_distribution,
                                                      lookup_speed, my_benchmark, roofline,
                                                      roofline_report, sort_bench)
from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 4096
SUM_RTOL = 1e-6
KEYS = {"bench", "rows", "best_ms", "mean_ms", "rows_per_s", "median_ms", "std_ms", "samples",
        "device", "power_limit_w"}
MODULES = ["build_speed", "lookup_speed", "exponential_distribution", "sort_bench",
           "my_benchmark", "roofline", "dist_stream_sweep"]


def jax_bench(name):
    """The root benches/<name>.py, loaded by path (it imports numpy only)."""
    mod = f"_jax_benches_{name}"
    if mod not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod, os.path.join(ROOT, "benches",
                                                                        f"{name}.py"))
        sys.modules[mod] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[mod])
    return sys.modules[mod]


def check_line(rec, name):
    assert KEYS <= set(rec), KEYS - set(rec)
    assert rec["bench"] == name and rec["device"] == "cpu" and rec["power_limit_w"] is None
    json.dumps(rec)


def jax_table(keys, strategy):
    n = keys.shape[0]
    valid = jnp.ones((n,), jnp.bool_)
    return jht.build_join_table(j_hash_rows([(jnp.asarray(keys), valid)]), valid, n,
                                jht.JoinStrategy(strategy))


def size512_keys(n):
    rng = np.random.default_rng(0)
    return rng.integers(0, n, n).astype(np.int32), rng.integers(0, n, n).astype(np.int32)


@pytest.mark.parametrize("n,max_value", [(1000, 1000), (4096, 4096), (10_000, 77)])
def test_exponential_keys_equal_jax(n, max_value):
    a = bench_lib.make_exponential_int_array(np.random.default_rng(3), n, max_value)
    b = jax_bench("bench_lib").make_exponential_int_array(np.random.default_rng(3), n,
                                                           max_value)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["csr", "sort", "oa"])
def test_build_speed_table_equals_jax(strategy):
    (rec,) = build_speed.main(["--rows", str(ROWS), "--strategy", strategy, "--iters", "1",
                               "--device", "cpu"])
    check_line(rec, f"build_speed/{strategy}/Size512")
    keys, _ = size512_keys(ROWS)
    got = build_speed.build_table(torch.from_numpy(keys), JoinStrategy(strategy))
    want = jax_table(keys, strategy)
    if strategy == "oa":
        # the JAX table leaves junk in the perm of an empty slot
        occupied = np.asarray(want.sorted_hash) != 0
        np.testing.assert_array_equal(got.sorted_hash.numpy(), np.asarray(want.sorted_hash))
        np.testing.assert_array_equal(got.perm.numpy()[occupied],
                                      np.asarray(want.perm)[occupied])
    else:
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    if strategy == "csr":
        np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))


def jax_lookup(strategy, n):
    """The JAX bench's probe body (benches/lookup_speed.py:54-67) on its
    scenario, in int64 (its int32 sum wraps only past these sizes)."""
    bkeys, pkeys = size512_keys(n)
    out_cap = 2 * n
    valid = jnp.ones((n,), jnp.bool_)
    table = jax_table(bkeys, strategy)
    ph = j_hash_rows([(jnp.asarray(pkeys), valid)])
    cr = jht.probe_candidates(table, ph, valid, n)
    sidecar = jnp.stack([jnp.arange(n, dtype=jnp.int32), cr.start - cr.base], axis=0)
    rep = replicate_rows_exact(sidecar, cr.base, cr.count, out_cap)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    build_idx = np.asarray(jnp.take(table.perm, rep[1] + j, mode="clip")).astype(np.int64)
    cand = np.asarray(j < cr.total)
    return int(cr.total) + int(np.where(cand, build_idx, 0).sum())


@pytest.mark.parametrize("strategy", ["csr", "sort", "oa"])
def test_lookup_speed_answer_equals_jax(strategy):
    (rec,) = lookup_speed.main(["--rows", str(ROWS), "--strategy", strategy, "--iters", "2",
                                "--device", "cpu"])
    check_line(rec, f"lookup_speed/{strategy}/Size512")
    assert rec["answer"] == jax_lookup(strategy, ROWS)


def test_lookup_speed_mismatch_raises(monkeypatch):
    """A plain path that differs makes the bench fail (a non-zero exit as
    a module)."""
    plain = lookup_speed.PLAIN
    bad = plain._replace(expand_ranges=lambda *a: tuple(
        x + (i == 2) for i, x in enumerate(plain.expand_ranges(*a))))
    monkeypatch.setattr(lookup_speed, "PLAIN", bad)
    with pytest.raises(bench_lib.Mismatch):
        lookup_speed.main(["--rows", "512", "--iters", "1", "--device", "cpu"])


def jax_scenario(rows, scenario):
    """The JAX bench's draws (benches/exponential_distribution.py:44-49)."""
    n_build, n_probe = rows, rows * (4 if scenario == "larger_probe" else 1)
    rng = np.random.default_rng(0)
    bk = jax_bench("bench_lib").make_exponential_int_array(rng, n_build, n_build).astype(
        np.int32)
    pk = rng.integers(0, n_build, n_probe).astype(np.int32)
    return (JHostTable.from_numpy({"b_key": bk, "b_val": rng.random(n_build).astype(np.float32)}),
            JHostTable.from_numpy({"p_key": pk, "p_val": rng.random(n_probe).astype(np.float32)}))


def test_exponential_single_equals_jax():
    recs = exponential_distribution.main(["--rows", str(ROWS), "--iters", "1",
                                          "--device", "cpu"])
    assert [r["bench"] for r in recs] == ["exp_dist/all_equal/single",
                                          "exp_dist/larger_probe/single"]
    for rec, scenario in zip(recs, exponential_distribution.SCENARIOS):
        check_line(rec, f"exp_dist/{scenario}/single")
        build, probe = exponential_distribution.make_scenario(ROWS, scenario)
        jb, jp = jax_scenario(ROWS, scenario)
        for port, jx in ((build, jb), (probe, jp)):
            for name, (v, valid) in port.columns.items():
                np.testing.assert_array_equal(v, jx.columns[name][0])
                np.testing.assert_array_equal(valid, jx.columns[name][1])
        out, total = j_hash_join(jb.to_device(), jp.to_device(), ["b_key"], ["p_key"],
                                 JJoinType.INNER, 8 * jp.num_rows)
        v, valid = out.column("b_val")
        keep = np.asarray(valid & out.row_mask())
        want_sum = float(np.asarray(v)[keep].astype(np.float64).sum())
        # the JAX bench's `matches` is its candidate total
        assert rec["candidates"] == int(total)
        assert rec["matches"] == int(out.num_rows)
        assert rec["sum_b_val"] == pytest.approx(want_sum, rel=SUM_RTOL)


def test_exponential_partitions_equal_jax():
    recs = exponential_distribution.main(["--rows", str(ROWS), "--partitions", "4",
                                          "--iters", "1", "--device", "cpu"])
    assert [r["bench"] for r in recs] == [
        f"exp_dist/{s}/{m}/partitions4" for s in exponential_distribution.SCENARIOS
        for m in exponential_distribution.MODES]
    mesh = j_make_mesh(4, platform="cpu")
    for rec in recs:
        _, scenario, mode, _ = rec["bench"].split("/")
        check_line(rec, rec["bench"])
        jb, jp = jax_scenario(ROWS, scenario)
        cfg = JDistJoinConfig(mode=mode, join_type=JJoinType.INNER, out_cap=8 * jp.num_rows)
        out, cfg = j_dist_join(mesh, jb, jp, ["b_key"], ["p_key"], cfg)
        v, valid = out.columns["b_val"]
        assert rec["matches"] == out.num_rows
        assert rec["sum_b_val"] == pytest.approx(float(v[valid].astype(np.float64).sum()),
                                                 rel=SUM_RTOL)
        assert rec["out_cap"] == cfg.out_cap


def test_sort_bench_outputs_equal_jax():
    recs = sort_bench.main(["--rows", str(ROWS), "--cols", "3", "--iters", "1",
                            "--device", "cpu"])
    assert [r["bench"] for r in recs] == [f"sort/{name}/3cols" for name in (
        "k6_perm", "k6_column_gather", "k6_packed_gather", "torch_sort_index_select")]
    for rec in recs:
        check_line(rec, rec["bench"])
    key, payload = sort_bench.make_columns(ROWS, 3)
    # the JAX bench's draws (benches/sort_bench.py:40-43)
    rng = np.random.default_rng(0)
    jkey = jnp.asarray(rng.integers(0, ROWS, ROWS).astype(np.int32))
    jpayload = [jnp.asarray(rng.integers(0, 1000, ROWS).astype(np.int32)) for _ in range(3)]
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for p, jp in zip(payload, jpayload):
        np.testing.assert_array_equal(p, np.asarray(jp))
    # the JAX bench's argsort_then_gather, whole
    perm = jnp.argsort(jkey, stable=True)
    want = [np.asarray(jnp.take(jkey, perm))] + list(np.asarray(
        jnp.take(jnp.stack(jpayload, axis=1), perm, axis=0)).T)
    fns = sort_bench.contenders(torch.from_numpy(key), [torch.from_numpy(p) for p in payload])
    np.testing.assert_array_equal(fns["k6_perm"]().numpy(), np.asarray(perm))
    for name, fn in fns.items():
        if name == "k6_perm":
            continue
        for got, w in zip(fn(), want):
            np.testing.assert_array_equal(got.numpy(), w)


def _host_tables_equal(a, b):
    assert a.num_rows == b.num_rows and a.schema.names == b.schema.names
    for fa, fb in zip(a.schema.fields, b.schema.fields):
        assert (fa.name, fa.dtype, fa.nullable) == (fb.name, fb.dtype, fb.nullable)
        assert (fa.dictionary is None) == (fb.dictionary is None)
        if fa.dictionary is not None:
            assert list(fa.dictionary.values) == list(fb.dictionary.values)
        for x, y in zip(a.columns[fa.name], b.columns[fb.name]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def size256_jax():
    """The JAX bench's Size256 tables at 8 base batches (its four 262,144-row
    string columns take seconds to draw, so once for the module)."""
    return jax_bench("my_benchmark").make_tables(8, np.random.default_rng(0))


def test_size256_tables_equal_jax_and_from_pydict(size256_jax):
    base, dims = my_benchmark.make_tables(8, np.random.default_rng(0))
    jbase, jdims = size256_jax
    assert my_benchmark.SQL == jax_bench("my_benchmark").SQL
    assert list(base) == list(jbase) and list(dims) == list(jdims)
    for name, col in base.items():
        if name == "note":
            assert col == jbase[name]
        else:
            np.testing.assert_array_equal(col, jbase[name])
    for name, data in dims.items():
        np.testing.assert_array_equal(data["id"], jdims[name]["id"])
        assert data["payload"] == jdims[name]["payload"]
        assert all(type(s) is str for s in data["payload"])
    for data in [base] + list(dims.values()):
        _host_tables_equal(my_benchmark.host_table(data), HostTable.from_pydict(data))


def test_size256_rows_equal_jax(size256_jax):
    from datafusion_parallelism_tpu import SessionContext as JSessionContext
    (rec,) = my_benchmark.main(["--base-batches", "8", "--iterations", "1", "--device", "cpu"])
    check_line(rec, "my_benchmark/Size256/4way_nested_join")
    assert rec["retries"] >= 0
    base, dims = size256_jax
    ctx = JSessionContext()
    ctx.register_pydict("base_table", base)
    for name, data in dims.items():
        ctx.register_pydict(name, data)
    assert rec["rows"] == int(ctx.sql(my_benchmark.SQL).run().num_rows) == 8 * 1024


def _port_rows(t):
    n = int(t.num_rows)
    return {name: (v[:n].numpy(), valid[:n].numpy()) for name, (v, valid) in t.columns.items()}


def _jax_rows(t):
    n = int(t.num_rows)
    return {name: (np.asarray(v)[:n], np.asarray(valid)[:n])
            for name, (v, valid) in t.columns.items()}


def _rows_equal(got, want, names=None):
    for name in names or want:
        np.testing.assert_array_equal(got[name][1], want[name][1], err_msg=name)
        np.testing.assert_array_equal(got[name][0][got[name][1]], want[name][0][want[name][1]],
                                      err_msg=name)


def test_roofline_operators_equal_jax():
    n = ROWS
    inp = roofline.make_inputs(n, torch.device("cpu"))
    ops = roofline.operators(inp, n)
    build, probe, agg = (inp[k].to_host() for k in ("build", "probe", "agg"))
    jbuild, jprobe, jagg = (JHostTable.from_numpy({name: v for name, (v, _) in t.columns.items()}
                                                  ).to_device() for t in (build, probe, agg))
    ones = jnp.ones((n,), jnp.bool_)
    bh = jnp.asarray(inp["bh"].numpy().view(np.uint32))
    ph = jnp.asarray(inp["ph"].numpy().view(np.uint32))
    out_cap = n + n // 2

    t = ops["build_csr"]()
    jt = jht.build_csr(bh, ones, n)
    np.testing.assert_array_equal(t.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(jt.offsets))

    # the JAX bench's f_probe (benches/roofline.py:236-246)
    total, idx_sum = ops["probe_expand"]()
    cr = jht.probe_candidates(jt, ph, ones, n)
    rep = replicate_rows_exact((cr.start - cr.base)[None, :], cr.base, cr.count, out_cap)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    bid = np.asarray(jnp.take(jt.perm, rep[0] + j, mode="clip")).astype(np.int64)
    assert int(total) == int(cr.total)
    assert int(idx_sum) == int(np.where(np.asarray(j < cr.total), bid, 0).sum())

    out, total = ops["inner_join_13col"]()
    jout, jtotal = j_hash_join(jbuild, jprobe, ["b_key"], ["p_key"], JJoinType.INNER, out_cap)
    assert int(total) == int(jtotal)
    _rows_equal(_port_rows(out), _jax_rows(jout))

    mask = (jbuild.column("c0")[0] & 1) == 0
    _rows_equal(_port_rows(ops["filter_compact"]()),
                _jax_rows(j_filter_rows(jbuild, mask & jbuild.row_mask())))

    jg, _ = j_agg(jagg, ["g"], [JAggSpec("sum", "x", "sx"), JAggSpec("max", "y", "my")],
                  1 << 17)
    _rows_equal(_port_rows(ops["hash_aggregate"]()), _jax_rows(jg))

    _rows_equal(_port_rows(ops["sort_table_13col"]()),
                _jax_rows(j_sort_table(jbuild, [JSortKey("b_key", True)])))


# hand counts at n = 1024 (T = table_size_for(1024) = 65,536 buckets)
BYTES_CASES = [
    # hashes 4n + perm 4n + offsets 4 (T + 2)
    ("build_csr", dict(c=0, widths=(4,)), 4096 + 4096 + 4 * 65_538),
    # hashes 4n + a bucket a row 32n + a perm entry a candidate 32c + pairs 8c
    ("probe_expand", dict(c=1500, widths=(4,)), 4096 + 32 * 1024 + 32 * 1500 + 8 * 1500),
    # build key 4n + probe columns 8n + 32 (n + 2c + 13 k) + output 60 k
    ("inner_join_13col", dict(c=1500, widths=(4,) * 13, out_rows=1000, probe_widths=(4, 4)),
     4096 + 8192 + 32 * (1024 + 3000 + 13_000) + 60 * 1000),
    # 52 n in, 52 k out
    ("filter_compact", dict(c=0, widths=(4,) * 13, out_rows=500), 52 * 1024 + 52 * 500),
    # 12 n in, 16 bytes a group out
    ("hash_aggregate", dict(c=0, widths=(4, 4, 4), out_rows=700, out_widths=(4, 8, 4)),
     12 * 1024 + 16 * 700),
    # 52 n in, 52 n out
    ("sort_table_13col", dict(c=0, widths=(4,) * 13), 2 * 52 * 1024),
]


@pytest.mark.parametrize("op,kw,want", BYTES_CASES, ids=[c[0] for c in BYTES_CASES])
def test_roofline_bytes_of_hand_counts(op, kw, want):
    kw = dict(kw)
    assert roofline.bytes_of(op, 1024, kw.pop("c"), kw.pop("widths"), **kw) == want


def test_roofline_bytes_of_rejects_unknown_op():
    with pytest.raises(ValueError):
        roofline.bytes_of("hash_join", 1024, 0, (4,))


def test_roofline_main_and_report(tmp_path, capsys):
    out = tmp_path / "roofline.json"
    art = roofline.main(["--rows", str(ROWS), "--iters", "1", "--rounds", "1", "--out",
                         str(out), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bench"] == "roofline" and line["device"] == "cpu"
    assert set(line["ratios"]) == set(roofline.OPS) == set(line["model_ratios"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    assert [r["op"] for r in art["operators"]] == list(roofline.OPS)
    for r in art["operators"]:
        assert r["byte_bound_ms"] == pytest.approx(r["bytes"] / roofline.HBM_BYTES_PER_S * 1e3)
    assert art["survivors"] < ROWS and art["matches"] <= art["candidates"]
    perf = tmp_path / "PERF.md"
    perf.write_text(f"head\n{roofline_report.BEGIN}\nold\n{roofline_report.END}\ntail\n")
    assert roofline_report.main(["--json", str(out), "--perf", str(perf)]) == 0
    text = perf.read_text()
    assert text.startswith("head\n") and text.endswith("tail\n") and "old" not in text
    for op in roofline.OPS:
        assert f"| {op} |" in text
    perf.write_text("no markers\n")
    assert roofline_report.main(["--json", str(out), "--perf", str(perf)]) == 1
    assert perf.read_text() == "no markers\n"


def test_dist_stream_sweep_checked(tmp_path):
    out = tmp_path / "sweep.json"
    before = {k: os.environ.get(k) for k in ("DFP_STREAM_THRESHOLD_BYTES",
                                             "DFP_STREAM_CHUNK_ROWS")}
    res = dist_stream_sweep.main(["--scale-factor", "0.01", "--concurrency", "2",
                                  "--chunk-rows", "8192", "--query", "1", "13",
                                  "--out", str(out), "--device", "cpu"])
    assert {k: os.environ.get(k) for k in before} == before
    assert json.loads(out.read_text())["queries"].keys() == {"1", "13"}
    for q, entry in res["queries"].items():
        assert entry["checked"] and entry["route"].startswith("streamed")
        assert entry["streamed_chunks"] > 1
        check_line(entry["line"], f"dist_stream_sweep/Q{q}/partitions2")
        # no device on the CPU: no chunk's pack overlaps a step
        assert entry["overlap_opened"] == entry["overlap_closed"] == 0


def test_overlap_stats_reads_the_device_flags():
    timeline = [{"event": "pack_upload", "chunk": 0, "busy_t0": False, "busy_t1": False},
                {"event": "dispatch", "chunk": 0, "t": 0.0},
                {"event": "pack_upload", "chunk": 1, "busy_t0": True, "busy_t1": True},
                {"event": "pack_upload", "chunk": 2, "busy_t0": True, "busy_t1": False},
                {"event": "pack_upload", "chunk": 3, "busy_t0": False, "busy_t1": False}]
    assert dist_stream_sweep.overlap_stats(timeline) == {
        "overlap_opened": 2, "overlap_closed": 1, "overlap_fraction": 1 / 3}


def test_sandwich_legs_and_env(monkeypatch):
    monkeypatch.setenv("DFP_BENCH_TEST_SWITCH", "keep")
    seen = []

    def make_fn():
        seen.append(os.environ.get("DFP_BENCH_TEST_SWITCH"))
        return lambda: None

    res = bench_lib.sandwich(make_fn, "DFP_BENCH_TEST_SWITCH", torch.device("cpu"), iters=2)
    assert seen == [None, "1", None]
    assert os.environ["DFP_BENCH_TEST_SWITCH"] == "keep"
    assert set(res["legs"]) == {"on1", "off", "on2"} and res["speedup"] > 0


@pytest.mark.parametrize("name", MODULES)
def test_benches_default_to_the_card(name):
    """No --device: the card, which this host lacks, so main raises before
    it makes any data."""
    mod = importlib.import_module(f"datafusion_parallelism_tpu_torch.benches.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
