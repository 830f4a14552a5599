"""The port's tracing (`utils/tracing.py`) on the CPU: the span /
span_report case of tests/test_optimizer.py's test_analyze_and_tracing on
the port's SessionContext; `profile(dir, device="cpu")` writing a Chrome
trace that names the query's operators (each plan node's range) and the
torch ops under them; `device="cuda"` raising without a GPU, and an unknown
device refused."""

import json
import os

import pytest
import torch

import datafusion_parallelism_tpu_torch as dfp
from datafusion_parallelism_tpu_torch.utils.catalog import Statistics
from datafusion_parallelism_tpu_torch.utils.tracing import (TRACE_FILE, profile, span,
                                                            span_report)


def _ctx():
    ctx = dfp.SessionContext(device="cpu")
    ctx.register_pydict("wide", {
        "k": [1, 2, 3, 4], "a": [1, 2, 3, 4], "b": [5, 6, 7, 8],
        "c": [9, 10, 11, 12], "d": [13, 14, 15, 16],
    }, statistics=Statistics(row_count=4))
    ctx.register_pydict("dim", {"k2": [1, 2], "v": [10, 20]},
                        statistics=Statistics(row_count=2))
    return ctx


def test_analyze_and_tracing():
    ctx = _ctx()
    h = ctx.sql("SELECT a FROM wide WHERE a > 1")
    span_report(reset=True)
    with span("analyze"):
        out = h.analyze()
    assert "Filter" in out and "rows=3" in out
    rep = span_report(reset=True)
    assert rep and rep[0][0] == "analyze"
    assert rep[0][1] == 1 and rep[0][2] >= rep[0][3] > 0
    assert span_report() == []


def test_profile_cpu_names_operators(tmp_path):
    h = _ctx().sql("SELECT k2, SUM(a) AS s FROM wide JOIN dim ON k = k2 "
                   "WHERE b > 5 GROUP BY k2 ORDER BY k2")
    h.collect()
    with profile(str(tmp_path), device="cpu") as prof:
        rows = h.collect().to_pylist()
    assert rows == [{"k2": 2, "s": 2}]
    path = os.path.join(tmp_path, TRACE_FILE)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"HashJoin", "Aggregate", "Sort", "Filter"} <= names
    assert any(n.startswith("aten::") for n in names if n)
    assert any(e.key == "HashJoin" for e in prof.key_averages())


def test_profile_cuda_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile(str(tmp_path), device="cuda"):
            pass
    with pytest.raises(ValueError):
        with profile(str(tmp_path), device="tpu"):
            pass
