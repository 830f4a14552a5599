"""The port's native host code (`native/`, `utils/binfmt.py`,
`tpch/tbl_loader.py`) against the JAX package's, on the CPU: the two C++
generators at SF 0.002 and one seed write byte-identical directories; the
port's `read_bin_table` equals the JAX package's column for column
(values, validity, dictionary, statistics_hint), memmapped and read whole,
and uploads a memmapped table as the same device table as one read whole;
the catalog's distinct counts (a sort, without the generator's hints)
equal the JAX catalog's (np.unique) and the hints;
the `.tbl` files `generate --format tbl` writes at SF 0.002 parse alike
through the port's native parser, its Python parser and the JAX package's
`load_tbl`. Every comparison is exact."""

import filecmp
import os

import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.native import tbl_library as jtbl_library
from datafusion_parallelism_tpu.tpch.tbl_loader import load_tbl as jload_tbl
from datafusion_parallelism_tpu.utils.catalog import RegisteredTable as JRegisteredTable
from datafusion_parallelism_tpu.utils.binfmt import generate_native as jgenerate_native
from datafusion_parallelism_tpu.utils.binfmt import read_bin_table as jread_bin_table
from datafusion_parallelism_tpu_torch.native import tbl_library
from datafusion_parallelism_tpu_torch.tpch.datagen import TABLE_NAMES
from datafusion_parallelism_tpu_torch.tpch.generate import run as generate
from datafusion_parallelism_tpu_torch.tpch.tbl_loader import (TBL_SCHEMAS, _load_tbl_python,
                                                              load_tbl, load_tpch_dir)
from datafusion_parallelism_tpu_torch.utils.binfmt import (generate_native, is_bin_table_dir,
                                                           read_bin_dataset, read_bin_table)
from datafusion_parallelism_tpu_torch.utils.catalog import RegisteredTable

SF = 0.002
SEED = 7


@pytest.fixture(scope="module")
def bin_dirs(tmp_path_factory):
    """(the port's directory, the JAX package's) from the same seed."""
    ours = tmp_path_factory.mktemp("bin_torch")
    theirs = tmp_path_factory.mktemp("bin_jax")
    generate_native(SF, str(ours), SEED)
    jgenerate_native(SF, str(theirs), SEED)
    return str(ours), str(theirs)


@pytest.fixture(scope="module")
def tbl_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("tbl")
    generate(["--scale-factor", str(SF), "--output", str(out), "--format", "tbl"])
    return str(out)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_generators_byte_identical(bin_dirs):
    ours, theirs = bin_dirs
    names = _files(ours)
    assert names == _files(theirs)
    assert {n.split(os.sep)[0] for n in names} == set(TABLE_NAMES)
    kinds = {os.path.splitext(n)[1] for n in names}
    assert kinds == {".bin", ".dict", ".json"}
    _, mismatch, errors = filecmp.cmpfiles(ours, theirs, names, shallow=False)
    assert not mismatch and not errors


def _host_equal(got, want):
    """A port HostTable == a JAX HostTable: schema, num_rows, every
    column's values and validity, each dictionary, statistics_hint."""
    assert got.num_rows == want.num_rows
    assert [(f.name, f.dtype.kind.value, f.dtype.scale, f.nullable)
            for f in got.schema.fields] == \
        [(f.name, f.dtype.kind.value, f.dtype.scale, f.nullable) for f in want.schema.fields]
    for f, wf in zip(got.schema.fields, want.schema.fields):
        if wf.dictionary is None:
            assert f.dictionary is None
        else:
            assert list(f.dictionary.values) == list(wf.dictionary.values)
        (v, valid), (wv, wvalid) = got.columns[f.name], want.columns[f.name]
        assert v.dtype == wv.dtype
        np.testing.assert_array_equal(np.asarray(v), np.asarray(wv))
        np.testing.assert_array_equal(np.asarray(valid), np.asarray(wvalid))
    gs, ws = getattr(got, "statistics_hint", None), getattr(want, "statistics_hint", None)
    assert (gs is None) == (ws is None)
    if ws is not None:
        assert (gs.row_count, gs.distinct, gs.mcv_share) == \
            (ws.row_count, ws.distinct, ws.mcv_share)


@pytest.mark.parametrize("memmap", [True, False])
@pytest.mark.parametrize("table", TABLE_NAMES)
def test_read_bin_table_matches_jax(bin_dirs, table, memmap):
    ours, theirs = bin_dirs
    got = read_bin_table(os.path.join(ours, table), memmap=memmap)
    _host_equal(got, jread_bin_table(os.path.join(theirs, table), memmap=memmap))
    v, valid = got.columns[got.schema.fields[0].name]
    assert isinstance(v, np.memmap) == memmap
    assert valid.strides == (0,)          # the zero-stride mask: no host bytes


def test_read_bin_dataset(bin_dirs):
    ours, _ = bin_dirs
    assert is_bin_table_dir(os.path.join(ours, "lineitem"))
    assert not is_bin_table_dir(ours)
    assert sorted(read_bin_dataset(ours)) == sorted(TABLE_NAMES)


@pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
def test_memmapped_upload_equals_whole_read(bin_dirs, table):
    """HostTable.to_device over memmapped values and a zero-stride mask
    gives the device table an upload of the arrays read whole gives."""
    path = os.path.join(bin_dirs[0], table)
    mapped = read_bin_table(path, memmap=True).to_device(device="cpu")
    whole = read_bin_table(path, memmap=False)
    whole.columns = {n: (v, np.ascontiguousarray(valid)) for n, (v, valid) in whole.columns.items()}
    want = whole.to_device(device="cpu")
    assert mapped.capacity == want.capacity
    assert int(mapped.num_rows) == int(want.num_rows)
    for name, (v, valid) in want.columns.items():
        mv, mvalid = mapped.columns[name]
        assert torch.equal(mv, v) and torch.equal(mvalid, valid), name


@pytest.mark.parametrize("table, col", [
    ("lineitem", "l_orderkey"), ("lineitem", ("l_partkey", "l_suppkey")),
    ("lineitem", ("l_suppkey", "l_partkey")), ("lineitem", "l_returnflag"),
    ("orders", "o_orderkey"), ("orders", "o_totalprice"), ("partsupp", ("ps_partkey", "ps_suppkey")),
    ("nation", "n_regionkey")])
def test_distinct_counts_match_jax(bin_dirs, table, col):
    ours, theirs = bin_dirs
    got = read_bin_table(os.path.join(ours, table))
    stats = getattr(got, "statistics_hint", None)
    hint = stats.distinct if stats is not None else {}
    count = RegisteredTable(table, got, device="cpu").distinct_of(col)
    assert count == JRegisteredTable(table, jread_bin_table(os.path.join(theirs, table))
                                     ).distinct_of(col)
    key = col if isinstance(col, str) else "\x00".join(col)
    if key in hint:
        assert count == hint[key]


@pytest.mark.parametrize("table", TABLE_NAMES)
def test_tbl_parsers_agree(tbl_dir, table):
    if tbl_library() is None or jtbl_library() is None:
        pytest.skip("no native toolchain")
    path = os.path.join(tbl_dir, f"{table}.tbl")
    native = load_tbl(path, table)
    python = _load_tbl_python(path, table)
    theirs = jload_tbl(path, table)
    assert native.num_rows > 0
    _host_equal(native, theirs)
    assert native.to_pylist() == python.to_pylist()
    assert [f.name for f in native.schema.fields] == [n for n, _ in TBL_SCHEMAS[table]]


def test_load_tpch_dir(tbl_dir):
    assert sorted(load_tpch_dir(tbl_dir)) == sorted(TABLE_NAMES)
