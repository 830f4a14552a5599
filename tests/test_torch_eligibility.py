"""The port's out-of-core eligibility report (`tpch/eligibility.py`) on the
CPU: `classify` of each of the 22 TPC-H plans over one SF 0.01 catalog
equals the JAX package's dict for dict, under the JAX grace tests'
lowered thresholds (a 3,000-row grace threshold, a 20,000-row resident
ceiling) and with the byte threshold at 0; `main` writes the same report
from a data directory. Exact comparison."""

import json

import pytest

import datafusion_parallelism_tpu as jdfp
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu.tpch import generate_tables as jgenerate
from datafusion_parallelism_tpu.tpch.eligibility import classify as jclassify
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
from datafusion_parallelism_tpu_torch.tpch.eligibility import classify, main


@pytest.fixture(autouse=True)
def lowered(monkeypatch):
    monkeypatch.setenv("DFP_STREAM_THRESHOLD_BYTES", "0")
    monkeypatch.setenv("DFP_STREAM_ROW_THRESHOLD", "3000")
    monkeypatch.setenv("DFP_GRACE_RESIDENT_CEILING", "20000")


@pytest.fixture(scope="module")
def sessions():
    tctx = tdfp.SessionContext(device="cpu")
    for n, t in generate_tables(sf=0.01).items():
        tctx.register_table(n, t)
    jctx = jdfp.SessionContext()
    for n, t in jgenerate(sf=0.01).items():
        jctx.register_table(n, t)
    return tctx, jctx


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_classify_matches_jax(sessions, q):
    tctx, jctx = sessions
    got = classify(tctx.sql(QUERIES[q]).plan, tctx.catalog)
    want = jclassify(jctx.sql(QUERIES[q]).plan, jctx.catalog)
    assert got == want
    assert "eligible" in got


def test_main_writes_report(tmp_path, capsys):
    from datafusion_parallelism_tpu_torch.tpch.generate import run as generate
    data = tmp_path / "data"
    generate(["--scale-factor", "0.001", "--output", str(data), "--format", "parquet"])
    out = tmp_path / "eligibility.json"
    main(["--data-path", str(data), "--scale-factor", "0.001", "--out", str(out),
          "--device", "cpu"])
    report = json.loads(out.read_text())
    assert report["scale_factor"] == 0.001
    assert sorted(report["queries"], key=int) == [str(q) for q in sorted(QUERIES)]
    assert report["queries"]["1"]["eligible"] is True
    assert "Q 1: STREAMS" in capsys.readouterr().out
