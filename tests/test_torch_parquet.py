"""Parquet ingestion in the port (`utils/parquet_io.py`), the cases of
tests/test_parquet.py on `device="cpu"`: HostTable -> parquet -> HostTable
round-trips every column kind (strings re-dictionary-encode sorted and
unique, decimals stay scaled int64), `SessionContext.register_parquet`
answers a query, the CLI's --data-path loads parquet and matches the
oracle, config files apply, and the generate CLI's output loads back.
Beyond them, the port's `read_parquet` equals the JAX package's on the
same files. Every comparison is exact (the oracle check is the CLI's own
rule: floats within rel 1e-6 or abs 1e-4)."""

import os

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from datafusion_parallelism_tpu.utils.columnar import DECIMAL as JDECIMAL
from datafusion_parallelism_tpu.utils.columnar import HostTable as JHostTable
from datafusion_parallelism_tpu.utils.parquet_io import read_parquet as jread_parquet
from datafusion_parallelism_tpu.utils.parquet_io import write_parquet as jwrite_parquet
from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext
from datafusion_parallelism_tpu_torch.tpch.cli import apply_config_file, run
from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables
from datafusion_parallelism_tpu_torch.utils.columnar import DECIMAL, HostTable
from datafusion_parallelism_tpu_torch.utils.parquet_io import read_parquet, write_parquet

ALL_KINDS = {
    "i": [1, None, 3, 4],
    "big": [2**40, 5, None, 7],
    "f": [1.5, 2.5, None, 4.0],
    "s": ["b", None, "a", "b"],
    "b": [True, False, None, True],
    "d": [1.25, -4.56, None, 0.01],
}


def test_roundtrip_all_kinds(tmp_path):
    t = HostTable.from_pydict(ALL_KINDS, dtypes={"d": DECIMAL(2)})
    p = str(tmp_path / "t.parquet")
    write_parquet(t, p)
    back = read_parquet(p)
    assert back.to_pylist() == t.to_pylist()
    # dictionary invariant: sorted + unique
    f = next(f for f in back.schema.fields if f.name == "s")
    vals = list(f.dictionary.values)
    assert vals == sorted(set(vals))
    # decimals stayed exact scaled ints
    d = next(f for f in back.schema.fields if f.name == "d")
    assert d.dtype.scale == 2
    assert back.columns["d"][0].tolist()[:2] == [125, -456]


def test_query_over_parquet(tmp_path):
    t = HostTable.from_pydict({
        "k": [1, 2, 2, 3], "v": [10.0, 20.0, 30.0, None]})
    p = str(tmp_path / "t.parquet")
    write_parquet(t, p)
    ctx = SessionContext(device="cpu")
    ctx.register_parquet("t", p)
    rows = ctx.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
                   ).collect().to_pylist()
    assert rows == [{"k": 1, "s": 10.0}, {"k": 2, "s": 50.0},
                    {"k": 3, "s": None}]


def test_cli_data_path_parquet(tmp_path):
    tables = generate_tables(sf=0.001)
    for name, t in tables.items():
        write_parquet(t, str(tmp_path / f"{name}.parquet"))
    res = run(["--data-path", str(tmp_path), "--query", "6",
               "--iterations", "1", "--check", "--device", "cpu"])
    assert res["checked"][6] is True


def test_config_file(tmp_path):
    p = tmp_path / "cfg"
    p.write_text("broadcast_threshold = 128  # comment\nskew_salting=True\n")
    cfg = SessionConfig()
    apply_config_file(cfg, str(p))
    assert cfg.broadcast_threshold == 128
    assert cfg.skew_salting is True
    p.write_text("not_a_key=1\n")
    with pytest.raises(KeyError):
        apply_config_file(cfg, str(p))


def test_generate_cli_roundtrip(tmp_path):
    """generate CLI -> --data-path load -> oracle check, both formats."""
    from datafusion_parallelism_tpu_torch.tpch.generate import run as gen
    out_pq = str(tmp_path / "pq")
    gen(["--scale-factor", "0.001", "--output", out_pq])
    res = run(["--data-path", out_pq, "--query", "1",
               "--iterations", "1", "--check", "--device", "cpu"])
    assert res["checked"][1] is True
    out_tbl = str(tmp_path / "tbl")
    gen(["--scale-factor", "0.001", "--output", out_tbl, "--format", "tbl",
         "--tables", "region", "nation"])
    assert os.path.exists(os.path.join(out_tbl, "region.tbl"))


def _same_host(got, want):
    assert got.num_rows == want.num_rows
    assert [(f.name, f.dtype.kind.value, f.dtype.scale, f.nullable) for f in got.schema.fields] \
        == [(f.name, f.dtype.kind.value, f.dtype.scale, f.nullable) for f in want.schema.fields]
    for f, wf in zip(got.schema.fields, want.schema.fields):
        assert (f.dictionary is None) == (wf.dictionary is None)
        if f.dictionary is not None:
            assert list(f.dictionary.values) == list(wf.dictionary.values)
        (v, valid), (wv, wvalid) = got.columns[f.name], want.columns[f.name]
        assert v.dtype == wv.dtype
        np.testing.assert_array_equal(v, wv)
        np.testing.assert_array_equal(valid, wvalid)


@pytest.mark.parametrize("case", ["all_kinds", "tpch_parts", "jax_written"])
def test_read_parquet_matches_jax(tmp_path, case):
    """The port's read_parquet == the JAX package's on the same file(s):
    every kind with nulls, a directory of TPC-H part files, a file the JAX
    package wrote."""
    if case == "all_kinds":
        path = str(tmp_path / "t.parquet")
        write_parquet(HostTable.from_pydict(ALL_KINDS, dtypes={"d": DECIMAL(2)}), path)
    elif case == "tpch_parts":
        path = str(tmp_path / "parts")
        os.makedirs(path)
        li = generate_tables(sf=0.001)["lineitem"]
        half = li.num_rows // 2
        for i, (lo, hi) in enumerate([(0, half), (half, li.num_rows)]):
            part = HostTable(li.schema, {n: (v[lo:hi], m[lo:hi]) for n, (v, m) in li.columns.items()},
                             hi - lo)
            write_parquet(part, os.path.join(path, f"part{i}.parquet"))
    else:
        path = str(tmp_path / "j.parquet")
        jwrite_parquet(JHostTable.from_pydict(ALL_KINDS, dtypes={"d": JDECIMAL(2)}), path)
    _same_host(read_parquet(path), jread_parquet(path))
