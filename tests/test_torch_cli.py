"""The port's TPC-H harness on the CPU (`tpch/cli.py`, `tpch/diff_results.py`):
the CLI at SF 0.002 on `--device cpu` over Q1, Q3, Q6 and Q13 with --check
(the CLI's own rule: floats within rel 1e-6 or abs 1e-4); its results.json
holding every key of a JAX CLI run's (Q6 at SF 0.001), with the port's
additions named; `apply_config_file`, `_rows_match` and `diff_dirs` held
to the JAX package's on the same cases, and `diff_dirs` over a NULL beside
numbers, where the JAX copy raises; Q6 at --concurrency 8 equal to P = 1
under `diff_dirs`' rule; no GPU means `--device cuda` raises."""

import contextlib
import io
import json
import os

import pytest

from datafusion_parallelism_tpu import SessionConfig as JSessionConfig
from datafusion_parallelism_tpu.tpch import cli as jcli
from datafusion_parallelism_tpu.tpch import diff_results as jdiff
from datafusion_parallelism_tpu_torch import SessionConfig, __version__
from datafusion_parallelism_tpu_torch.tpch import cli, diff_results

CLI_QUERIES = (1, 3, 6, 13)
# the keys the port adds: the session's device, each query's route and peak device memory
PORT_ARGS = {"device"}
PORT_METRICS = {"route", "peak_device_bytes"}


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    argv = ["--device", "cpu", "--scale-factor", "0.002", "--iterations", "2", "--check",
            "--output-path", str(out)]
    for q in CLI_QUERIES:
        argv += ["--query", str(q)]
    return cli.run(argv), str(out)


@pytest.mark.parametrize("q", CLI_QUERIES)
def test_cli_check_passes(cpu_run, q):
    res, out = cpu_run
    assert res["checked"][q] is True
    assert "error" not in res["query_metrics"][q]
    assert len(res["query_times_ms"][q]) == 2
    assert res["query_metrics"][q]["route"] == "resident"
    assert res["query_metrics"][q]["compiles"] == 0
    assert res["query_metrics"][q]["compile_time_s"] == 0.0
    assert os.path.exists(os.path.join(out, f"q{q}.csv"))


def test_results_json(cpu_run):
    res, out = cpu_run
    with open(os.path.join(out, "results.json")) as f:
        on_disk = json.load(f)
    assert on_disk["engine"] == "datafusion_parallelism_tpu_torch"
    assert on_disk["engine_version"] == __version__ == "0.1.0"
    assert sorted(on_disk["checked"]) == sorted(str(q) for q in CLI_QUERIES)
    with open(os.path.join(out, "timings.csv")) as f:
        assert len(f.read().splitlines()) == 1 + 2 * len(CLI_QUERIES)


def test_results_keys_match_jax(tmp_path):
    """One JAX CLI run and one port run of Q6 at SF 0.001: the same
    top-level keys, and every key of the JAX run's sections in the port's
    (the port adds only PORT_ARGS and PORT_METRICS)."""
    outs = {}
    for name, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        out = str(tmp_path / name)
        mod.run(["--scale-factor", "0.001", "--query", "6", "--iterations", "2",
                 "--check", "--output-path", out] + extra)
        with open(os.path.join(out, "results.json")) as f:
            outs[name] = json.load(f)
    j, t = outs["jax"], outs["torch"]
    assert set(t) == set(j)
    assert set(t["config"]) == set(j["config"])
    assert set(t["args"]) - set(j["args"]) == PORT_ARGS
    assert set(j["args"]) <= set(t["args"])
    assert set(t["query_summary"]["6"]) == set(j["query_summary"]["6"])
    assert set(t["query_metrics"]["6"]) - set(j["query_metrics"]["6"]) == PORT_METRICS
    assert set(j["query_metrics"]["6"]) <= set(t["query_metrics"]["6"])
    assert set(t["query_metrics"]["6"]["decomposition"]) == \
        set(j["query_metrics"]["6"]["decomposition"])
    assert t["checked"] == j["checked"] == {"6": True}


CONFIG_CASES = {
    "literals": "broadcast_threshold = 128  # comment\nskew_salting=True\n",
    "blank_and_comments": "# only a comment\n\n  skew_factor = 2.5\n",
    "bare_string": "distributed_staged = yes\n",
    "none_and_tuple": "skew_salting = None\nreplacement_required = (1, 2)\n",
    "unknown_key": "not_a_key=1\n",
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_apply_config_file_matches_jax(tmp_path, case):
    p = tmp_path / "cfg"
    p.write_text(CONFIG_CASES[case])
    got, want = SessionConfig(), JSessionConfig()
    keys = [line.split("#")[0].partition("=")[0].strip()
            for line in CONFIG_CASES[case].splitlines()]
    keys = [k for k in keys if k]
    errors = []
    for mod, cfg in ((cli, got), (jcli, want)):
        try:
            mod.apply_config_file(cfg, str(p))
            errors.append(None)
        except KeyError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    if errors[0] is None:
        assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}


ROWS_CASES = {
    "equal": ([{"a": 1, "b": "x"}], [{"a": 1, "b": "x"}]),
    "reordered": ([{"a": 1}, {"a": 2}], [{"a": 2}, {"a": 1}]),
    "length": ([{"a": 1}], []),
    "float_close": ([{"s": 1.00000001}], [{"s": 1.0}]),
    "float_far": ([{"s": 1.01}], [{"s": 1.0}]),
    "large_sum": ([{"s": 1.2345678912e13}], [{"s": 1.2345678913e13}]),
    "small_abs": ([{"s": 0.00001}], [{"s": 0.0}]),
    "string_differs": ([{"a": "x"}], [{"a": "y"}]),
    "null": ([{"a": None}], [{"a": None}]),
    "null_vs_value": ([{"a": None}], [{"a": 0}]),
    "int_vs_float": ([{"a": 3}], [{"a": 3.0}]),
    "column_names": ([{"a": 1}], [{"b": 1}]),
}


@pytest.mark.parametrize("case", sorted(ROWS_CASES))
def test_rows_match_matches_jax(case):
    actual, expected = ROWS_CASES[case]
    assert cli._rows_match(actual, expected) == jcli._rows_match(actual, expected)


def _write_csv(d, q, text):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"q{q}.csv"), "w") as f:
        f.write(text)


DIFF_CASES = {
    "same": ({1: "a,b\n1,x\n2,y\n"}, {1: "a,b\n2,y\n1,x\n"}),
    "float_tolerance": ({1: "s\n1.000000001\n"}, {1: "s\n1.0\n"}),
    "float_differs": ({1: "s\n1.5\n"}, {1: "s\n1.6\n"}),
    "missing": ({1: "a\n1\n", 2: "a\n2\n"}, {1: "a\n1\n"}),
    "row_count": ({3: "a\n1\n2\n"}, {3: "a\n1\n"}),
    "strings": ({4: "n\nfoo\n"}, {4: "n\nbar\n"}),
    "empty": ({5: ""}, {5: ""}),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_dirs_matches_jax(tmp_path, case):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    left, right = DIFF_CASES[case]
    for q, text in left.items():
        _write_csv(a, q, text)
    for q, text in right.items():
        _write_csv(b, q, text)
    printed = []
    for mod in (diff_results, jdiff):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.diff_dirs(a, b)
        printed.append((rc, buf.getvalue()))
    assert printed[0] == printed[1]


@pytest.mark.parametrize("other, failures", [("", 0), ("7", 1)])
def test_diff_dirs_null_beside_numbers(tmp_path, other, failures):
    """A column holding an empty field (NULL) beside numbers sorts and
    compares (the JAX copy's sort raises TypeError there)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_csv(a, 1, "k,v\n1,\n1,2.5\n")
    _write_csv(b, 1, f"k,v\n1,2.5\n1,{other}\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert diff_results.diff_dirs(a, b) == failures
        with pytest.raises(TypeError):
            jdiff.diff_dirs(a, b)


def test_concurrency_8_equals_one(tmp_path):
    """Q6 over 8 partitions in process == P = 1 under diff_dirs' rule."""
    outs = []
    for p in (1, 8):
        out = str(tmp_path / f"p{p}")
        res = cli.run(["--device", "cpu", "--scale-factor", "0.002", "--query", "6",
                       "--iterations", "1", "--concurrency", str(p), "--output-path", out])
        assert "error" not in res["query_metrics"][6]
        outs.append(out)
    assert res["query_metrics"][6]["comm_bytes"] > 0
    assert len(res["query_metrics"][6]["balance"]) == 0   # Q6 has no join
    assert diff_results.diff_dirs(outs[1], outs[0]) == 0


def test_device_cuda_raises_without_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--scale-factor", "0.001", "--query", "6", "--iterations", "1"])
