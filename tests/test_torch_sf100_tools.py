"""The SF100 campaign's tools on the CPU: the port's `benches/merge_sf100.py`
and `benches/sf100_report.py` held to the root `benches/` copies over the
same fixture runs (every path kind, an error row, a FAIL), the report's
marker rewrite, `tools/sf100_run.py` at SF 0.01 with `--device cpu` (Q1 and
Q18, one process each, checked against the oracle, routes equal to
`tpch.eligibility`'s, a 0 s timeout turning a query into an error entry), and
the port's eligibility equal to the JAX package's under the thresholds that
campaign scales (x SF / 100), whose routes are those of
`results/sf100/eligibility.json`, and `chip_smoke.py`'s phase 25 run from a
checkout that holds no PERF.md."""

import copy
import importlib.util
import json
import os
import sys

import pytest
import torch

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu.tpch.eligibility import classify as jclassify
from datafusion_parallelism_tpu_torch.benches import merge_sf100, sf100_report
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.tpch.eligibility import classify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import sf100_run  # noqa: E402

SF = 0.01
SCALE = SF / 100       # the campaign's thresholds at SF100, scaled to SF


def _root_bench(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(ROOT, "benches", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(ms, oracle_ms):
    return {"iterations": 1, "median_warm_ms": ms, "stdev_warm_ms": 0.0, "min_ms": ms,
            "oracle_ms": oracle_ms}


def _metrics(chunks, retries=0):
    return {"compiles": 0, "compile_time_s": 0.0, "retries": retries,
            "route": "streamed", "streamed_chunks": chunks}


def _run(queries, errors=(), failed=()):
    return {"system_time": "t", "engine": "e", "engine_version": "0.1.0",
            "config": {"scale_factor": 100.0, "join_strategy": "csr"}, "args": {},
            "register_tables_time_s": 1.0,
            "query_times_ms": {str(q): [ms] for q, ms, _, _ in queries},
            "query_summary": {str(q): _summary(ms, o) for q, ms, o, _ in queries},
            "query_metrics": {**{str(q): _metrics(c) for q, _, _, c in queries},
                              **{str(q): {"error": e} for q, e in errors}},
            "checked": {str(q): q not in failed for q, _, _, _ in queries}}


# run A (the older): Q1 stream, Q2 grace row-union, Q9 stream + swap, Q13
# stream over orders, Q18 grace aggregate (a FAIL, rerun in B), Q7 an error
# that B repairs; run B: Q18 again, Q7, Q22 resident, Q5 an error only
RUN_A = _run([(1, 12_345.0, 4_000.0, 144), (2, 7_600.0, 900.0, 20),
              (9, 40_100.0, 15_500.0, 144), (13, 9_400.0, 2_600.0, 36),
              (18, 120_700.0, 30_200.0, 144)],
             errors=[(7, "OutOfMemoryError: CUDA out of memory. Tried to allocate 40 GiB")],
             failed=(18,))
RUN_B = _run([(18, 98_000.0, 29_800.0, 144), (7, 51_000.0, 12_000.0, 144),
              (22, 3_100.0, 800.0, 0)],
             errors=[(5, "timeout: killed after 1200 s")])
ELIG = {"scale_factor": 100.0, "queries": {
    "1": {"streamed_table": "lineitem", "eligible": True},
    "2": {"streamed_table": "partsupp", "eligible": True, "via_grace": True,
          "merge": "row-union", "partition_columns": {"partsupp": "partsupp.ps_partkey"}},
    "7": {"streamed_table": "lineitem", "eligible": True},
    "9": {"streamed_table": "lineitem", "eligible": True, "via_side_swap": True},
    "13": {"streamed_table": "orders", "eligible": True},
    "18": {"streamed_table": "lineitem", "eligible": True, "via_grace": True,
           "merge": "aggregate"},
    "22": {"streamed_table": "orders", "eligible": False, "reason": "r"}}}
DEVICE = {"nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W", "queries": {}}


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def runs(tmp_path):
    """The two runs as the JAX tool finds them (results/sf100 and
    results/sf100_r5 under a base) and as the port's takes them."""
    base = tmp_path / "results"
    _write(str(base / "sf100" / "results.json"), RUN_A)
    _write(str(base / "sf100_r5" / "results.json"), RUN_B)
    for name, run in (("a", RUN_A), ("b", RUN_B)):
        d = tmp_path / name
        _write(str(d / "results.json"), run)
        _write(str(d / "eligibility.json"), ELIG)
        _write(str(d / "device.json"), DEVICE)
        for q in run["query_summary"]:
            (d / f"q{q}.csv").write_text(f"run,{name}\n")
    return tmp_path


def test_merge_equals_the_root_merge(runs, monkeypatch, capsys):
    root = _root_bench("merge_sf100")
    monkeypatch.setattr(root, "BASE", str(runs / "results"))
    root.main()
    want_line = capsys.readouterr().out
    with open(runs / "results" / "sf100" / "results.json") as f:
        want = json.load(f)
    got = merge_sf100.merge([str(runs / "a"), str(runs / "b")], [4, 5])
    assert got.pop("device_by_run") == {"4": DEVICE, "5": DEVICE}
    assert got == want
    assert want["measured_in_round"] == {"1": 4, "2": 4, "9": 4, "13": 4, "18": 5, "7": 5,
                                         "22": 5}
    # the CLI: the same line, the answers of the run that measured each query
    out = runs / "merged"
    assert merge_sf100.main(["--run", str(runs / "a"), "--run", str(runs / "b"),
                             "--label", "4", "--label", "5", "--out", str(out)]) == 0
    assert capsys.readouterr().out == want_line
    assert (out / "q18.csv").read_text() == "run,b\n"
    assert (out / "q1.csv").read_text() == "run,a\n"
    assert json.loads((out / "eligibility.json").read_text()) == ELIG


def test_merge_drops_a_query_a_later_run_failed(runs):
    """Where a later run holds only an error for a query an earlier run
    measured, the port keeps the error alone (the CLI's own merge rule);
    the root tool overlays section by section, keeping the earlier
    summary beside the later error."""
    later = copy.deepcopy(RUN_B)
    later["query_metrics"]["1"] = {"error": "exit 1: MemoryError"}
    _write(str(runs / "b" / "results.json"), later)
    got = merge_sf100.merge([str(runs / "a"), str(runs / "b")], [4, 5])
    assert got["query_metrics"]["1"] == {"error": "exit 1: MemoryError"}
    for sect in ("query_times_ms", "query_summary", "checked", "measured_in_round"):
        assert "1" not in got[sect]


def test_report_rows_equal_the_root_render(runs, monkeypatch):
    root = _root_bench("sf100_report")
    merged = merge_sf100.merge([str(runs / "a"), str(runs / "b")], [4, 5])
    _write(str(runs / "results" / "sf100" / "results.json"), merged)
    _write(str(runs / "results" / "sf100" / "eligibility.json"), ELIG)
    monkeypatch.setattr(root, "ROOT", str(runs))
    want = root.render().splitlines()
    got = sf100_report.render(str(runs / "results" / "sf100")).splitlines()
    assert got[:-1] == want[:-1]
    paths = {line.split(" | ")[5] for line in got[2:-2] if " | — |" not in line}
    assert paths == {"stream", "grace/row-union", "stream+swap", "grace/aggregate",
                     "resident"}
    assert not any("FAIL" in line for line in got)    # B's Q18 PASS replaced A's FAIL
    assert "| Q5 | — |" in "\n".join(got)
    # the only difference: the closing line names the card the artifact records
    assert want[-1] == "7 of 22 queries oracle-checked at SF100 (600M-row lineitem) on one v5e."
    assert got[-1] == ("7 of 22 queries oracle-checked at SF100 on one NVIDIA H100 80GB "
                       "HBM3, 700.00 W (run 4, 5).")


def test_report_renders_a_fail(runs, monkeypatch):
    root = _root_bench("sf100_report")
    _write(str(runs / "results" / "sf100" / "results.json"), RUN_A)
    _write(str(runs / "results" / "sf100" / "eligibility.json"), ELIG)
    monkeypatch.setattr(root, "ROOT", str(runs))
    got = sf100_report.render(str(runs / "results" / "sf100")).splitlines()
    assert got[:-1] == root.render().splitlines()[:-1]
    assert "| Q18 | 121 | 144 | 0 | 30 | grace/aggregate | r? | FAIL |" in got
    assert "| Q7 | — | — | — | — | — | — | OutOfMemoryError: CUDA out of memory. Tr |" in got


def test_report_rewrites_only_between_markers(runs):
    perf = runs / "PERF.md"
    perf.write_text(f"head\n{sf100_report.BEGIN}\nold\n{sf100_report.END}\ntail\n")
    res = runs / "a"
    assert sf100_report.main(["--results", str(res), "--perf", str(perf)]) == 0
    once = perf.read_text()
    assert once.startswith(f"head\n{sf100_report.BEGIN}\n| query |")
    assert once.endswith(f"on one card not recorded.\n{sf100_report.END}\ntail\n")
    assert "old" not in once
    assert sf100_report.main(["--results", str(res), "--perf", str(perf)]) == 0
    assert perf.read_text() == once                       # re-running changes nothing


def test_report_refuses_without_markers(runs, capsys):
    perf = runs / "PERF.md"
    perf.write_text("no markers here\n")
    assert sf100_report.main(["--results", str(runs / "a"), "--perf", str(perf)]) == 1
    assert perf.read_text() == "no markers here\n"
    assert "no SF100 markers" in capsys.readouterr().out


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """tools/sf100_run.py at SF 0.01 on the CPU, Q1 and Q18, the thresholds
    scaled by SF / 100 and 16,384-row chunks (lineitem in 4)."""
    tmp = tmp_path_factory.mktemp("sf100_run")
    data, out = str(tmp / "data"), str(tmp / "out")
    mp = pytest.MonkeyPatch()
    mp.setenv("DFP_STREAM_CHUNK_ROWS", "16384")
    argv = ["--device", "cpu", "--scale-factor", str(SF), "--threshold-scale", str(SCALE),
            "--data", data, "--out", out, "--query", "1", "--query", "18", "--timeout", "600"]
    try:
        assert sf100_run.main(argv) == 0
        with open(os.path.join(out, "results.json")) as f:
            first = json.load(f)
        with open(os.path.join(out, "device.json")) as f:
            device = json.load(f)
    finally:
        mp.undo()
    return {"argv": argv, "data": data, "out": out, "first": first, "device": device}


def test_campaign_checks_each_query_in_its_own_process(campaign):
    res, device = campaign["first"], campaign["device"]
    assert res["checked"] == {"1": True, "18": True}
    recs = device["queries"]
    assert len({recs["1"]["pid"], recs["18"]["pid"], os.getpid()}) == 3
    for q in ("1", "18"):
        assert recs[q]["rc"] == 0 and not recs[q]["timed_out"]
        assert recs[q]["peak_rss_bytes"] > 0 and recs[q]["maxrss_bytes"] > 0
        assert res["query_metrics"][q]["peak_device_bytes"] is None    # off the card
        with open(os.path.join(campaign["out"], "logs", f"q{q}.log")) as f:
            said = [ln for ln in f.read().splitlines() if ln.startswith("Q")]
        assert len(said) == 1 and said[0].startswith(f"Q{q}: ") and "check=PASS" in said[0]
    assert device["nvidia_smi"] is None and device["data_reused"] is False
    assert device["thresholds"]["DFP_STREAM_ROW_THRESHOLD"] == str(int((1 << 26) * SCALE))


def test_campaign_routes_equal_eligibility(campaign):
    with open(os.path.join(campaign["out"], "eligibility.json")) as f:
        elig = json.load(f)["queries"]
    res = campaign["first"]
    assert res["query_metrics"]["1"]["route"] == sf100_run.executor_route(elig["1"]) \
        == "streamed"
    assert res["query_metrics"]["18"]["route"] == sf100_run.executor_route(elig["18"]) \
        == "grace agg"
    assert res["query_metrics"]["1"]["streamed_chunks"] == 4
    assert campaign["device"]["queries"]["18"]["route_expected"] == "grace agg"


def test_campaign_timeout_becomes_an_error_entry(campaign):
    argv = list(campaign["argv"])
    argv[argv.index("--timeout") + 1] = "0"
    argv[argv.index("--query") + 1] = "18"          # Q18 twice: Q1 is not rerun
    assert sf100_run.main(argv) == 0
    with open(os.path.join(campaign["out"], "results.json")) as f:
        res = json.load(f)
    with open(os.path.join(campaign["out"], "device.json")) as f:
        device = json.load(f)
    assert res["query_metrics"]["18"] == {"error": "timeout: killed after 0 s"}
    for sect in ("query_times_ms", "query_summary", "checked"):
        assert "18" not in res[sect]
    assert res["checked"]["1"] is True and res["query_summary"]["1"] == \
        campaign["first"]["query_summary"]["1"]
    assert device["data_reused"] is True and device["eligibility_reused"] is True
    assert device["queries"]["18"]["timed_out"] is True


def test_campaign_refuses_a_full_disk(tmp_path, monkeypatch):
    monkeypatch.setattr(sf100_run, "disk_free", lambda path: 1000)
    with pytest.raises(RuntimeError, match=r"1000 bytes free, \d+ short of \d+"):
        sf100_run.main(["--device", "cpu", "--scale-factor", "100", "--data",
                        str(tmp_path / "data"), "--out", str(tmp_path / "out")])
    assert not (tmp_path / "data").exists()


def test_campaign_needs_a_gpu_for_cuda(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))          # no nvidia-smi
    with pytest.raises(RuntimeError, match="needs a GPU"):
        sf100_run.main(["--scale-factor", str(SF), "--data", str(tmp_path / "d"),
                        "--out", str(tmp_path / "o")])


def test_smoke_phase_runs_from_a_checkout_without_perf_md(tmp_path, monkeypatch, capsys):
    """chip_smoke.py's phase 25 at SF 0.01 on the CPU, from a directory that
    holds only chip_smoke.py, tools/sf100_run.py, results/sf100/ and the
    package: its first run in a process beside the caller, the second over
    that run's tables, merged and rendered with no PERF.md there."""
    for rel in ("chip_smoke.py", os.path.join("tools", "sf100_run.py"),
                os.path.join("results", "sf100", "eligibility.json")):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(open(os.path.join(ROOT, rel), "rb").read())
    (tmp_path / "datafusion_parallelism_tpu_torch").symlink_to(
        os.path.join(ROOT, "datafusion_parallelism_tpu_torch"))
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", tmp_path / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "SF100_RUN_SF", SF)
    device = torch.device("cpu")
    first = smoke.start_sf100_first_run(device)
    try:
        smoke.phase_sf100_run(device, first)
    finally:
        smoke.stop_sf100_first_run(first)
    said = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("phase 25")]
    assert len(said) == 1 and said[0].startswith("phase 25 ok: ")
    assert "'18': 'grace agg'" in said[0] and "'2': 'grace union'" in said[0]
    assert not (tmp_path / "PERF.md").exists() and not os.path.exists(first["root"])


@pytest.fixture(scope="module")
def scaled_sessions():
    mp = pytest.MonkeyPatch()
    for k, v in sf100_run.THRESHOLDS.items():
        mp.setenv(k, str(int(v * SCALE)))
    tctx = tdfp.SessionContext(device="cpu")
    for n, t in generate_tables(sf=SF).items():
        tctx.register_table(n, t)
    jctx = jdfp.SessionContext()
    for n, t in jgenerate(sf=SF).items():
        jctx.register_table(n, t)
    yield tctx, jctx
    mp.undo()


@pytest.fixture(scope="module")
def sf100_reference():
    with open(os.path.join(ROOT, "results", "sf100", "eligibility.json")) as f:
        return json.load(f)["queries"]


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_scaled_eligibility_matches_jax_and_sf100(scaled_sessions, sf100_reference, q,
                                                  monkeypatch):
    """Under the campaign's thresholds x SF / 100 (row threshold 6,710, resident
    ceiling 10,066 rows at SF 0.01), the port classifies each plan as the JAX
    package does, and the route is the JAX package's at SF100."""
    for k, v in sf100_run.THRESHOLDS.items():
        monkeypatch.setenv(k, str(int(v * SCALE)))
    tctx, jctx = scaled_sessions
    got = classify(tctx.sql(QUERIES[q]).plan, tctx.catalog)
    assert got == jclassify(jctx.sql(QUERIES[q]).plan, jctx.catalog)
    assert sf100_run.route_of(got) == sf100_run.route_of(sf100_reference[str(q)])


def test_route_differences_names_each_field():
    a = {"1": {"streamed_table": "lineitem", "eligible": True, "streamed_rows": 5}}
    b = {"1": {"streamed_table": "lineitem", "eligible": True, "streamed_rows": 6},
         "2": {"eligible": True, "via_grace": True, "merge": "row-union"}}
    diff = sf100_run.route_differences(a, b)
    assert list(diff) == ["2"]
    assert diff["2"][1]["merge"] == "row-union" and diff["2"][0]["merge"] is None
    assert [sf100_run.executor_route(e) for e in (
        {}, {"eligible": True}, {"eligible": True, "via_side_swap": True},
        {"via_grace": True, "merge": "aggregate"}, {"via_grace": True, "merge": "row-union"})] \
        == ["resident", "streamed", "streamed after a side-swap", "grace agg", "grace union"]


def test_needed_bytes_at_sf100():
    assert sf100_run.needed_bytes(100) == 58_567_574_760 + (1 << 30)


def test_q1_oracle_in_passes_equals_one_pass():
    """The oracle's Q1 over lineitem in passes of a few thousand rows (as at
    SF100 in passes of 2^25) gives one pass's groups and counts, and its
    sums within rel 1e-12 (another summation order)."""
    from datafusion_parallelism_tpu_torch.tpch import oracle
    tables = generate_tables(sf=SF)
    assert tables["lineitem"].num_rows > 7 * 7919
    whole = oracle._q1_np(tables)
    parts = oracle._q1_np(tables, block_rows=7919)
    assert [(r["l_returnflag"], r["l_linestatus"], r["count_order"]) for r in parts] == \
        [(r["l_returnflag"], r["l_linestatus"], r["count_order"]) for r in whole]
    for a, b in zip(parts, whole):
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-12)
