"""K8 direct_agg's and K5's compaction's plain versions against the JAX
functions they replace on their edge cases, their host-side plans (K8's
staged bytes and its warps' request sets, K5's tiles and scratch), and
tools/bench_agg_compact.py's cells at a tiny size, on the CPU. (The
CUDA kernels are held against these plain versions on the card by
chip_smoke.py, phases 2g, 8-12 and 15.)

Tolerances: bit-exact for compaction order, counts, integer sums, min/max
(-0.0 and 0.0 equal as numbers, NaN where NaN); float64 sums within rtol
1e-9 + 1e-12 * sum|x| over the finite inputs, infinities and NaN where the
JAX package has them, since the two reduce in different orders.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import aggregate as jagg
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference

FLOAT_RTOL, FLOAT_ATOL_PER_ABS = 1e-9, 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# K8 direct_agg at 64 groups
# ---------------------------------------------------------------------------

def _g64_table(rng, cap, n, specials, null_keys):
    """Two dictionary keys of 7 codes each (G = 8 x 8 = 64), a float64
    column holding NaN, +-inf and -0.0 in a `specials` share of its rows, an
    int64 column; 10% NULLs (every key NULL with `null_keys`)."""
    d7 = jcol.Dictionary(np.array([f"k{i}" for i in range(7)], dtype=object))
    f = rng.normal(size=cap) * 1e3
    at = rng.random(cap) < specials
    f[at] = rng.choice([np.nan, np.inf, -np.inf, -0.0], int(at.sum()))
    data = {"a": rng.integers(0, 7, cap).astype(np.int32),
            "b": rng.integers(0, 7, cap).astype(np.int32), "f": f,
            "v": rng.integers(-999, 999, cap)}
    valid = {k: rng.random(cap) > 0.1 for k in data}
    if null_keys:
        valid["a"][:] = valid["b"][:] = False
    return jcol.HostTable.from_numpy(
        {k: v[:n] for k, v in data.items()}, dtypes={"a": jcol.STRING, "b": jcol.STRING},
        dictionaries={"a": d7, "b": d7}, validity={k: v[:n] for k, v in valid.items()})


G64_CASES = {
    # name: (specials share, every key NULL, row filter)
    "nan_inf_negzero": (0.02, False, False),
    "nan_inf_negzero_filtered": (0.02, False, True),
    "all_null_groups": (0.02, True, False),
    "no_specials": (0.0, False, True),
}


@pytest.mark.parametrize("case", sorted(G64_CASES))
def test_direct_agg_plain_matches_jax_at_64_groups(case):
    specials, null_keys, filtered = G64_CASES[case]
    rng = np.random.default_rng(64 + len(case))
    cap, n = 4096, 4000
    host = _g64_table(rng, cap, n, specials, null_keys)
    jt = host.to_device(cap)
    tt = host_table_from_reference(host).to_device(cap, device="cpu")
    rf = rng.random(cap) < 0.5 if filtered else None
    keys = ["a", "b"]
    aggs = [jagg.AggSpec("sum", "f", "sf"), jagg.AggSpec("min", "f", "mnf"),
            jagg.AggSpec("max", "f", "mxf"), jagg.AggSpec("count", "f", "cf"),
            jagg.AggSpec("sum", "v", "sv"), jagg.AggSpec("count_star", None, "cs")]
    schema = jagg.agg_output_schema(jt.schema, keys, aggs)
    doms = jagg._direct_domains(jt.schema, keys)
    assert k8.n_groups_of(doms) == 64
    jout, jn = jagg._direct_aggregate(jt, keys, aggs, doms, 64, schema,
                                      None if rf is None else jnp.asarray(rf))
    reqs = [("sum", *tt.column("f")), ("min", *tt.column("f")), ("max", *tt.column("f")),
            ("count", *tt.column("f")), ("sum", *tt.column("v"))]
    rowcount, res = k8.direct_agg_plain([tt.column(k) for k in keys], doms, tt.num_rows,
                                        None if rf is None else torch.from_numpy(rf), reqs, cap)
    exists = rowcount > 0
    g = int(jn)
    assert int(exists.sum()) == g and (g == 1) == null_keys
    np.testing.assert_array_equal(rowcount[exists].numpy(), np.asarray(jout.column("cs")[0])[:g])
    f, fm = host.columns["f"]
    finite = np.abs(f[fm & np.isfinite(f)]).sum()
    for r, name in zip(res, ("sf", "mnf", "mxf", "cf", "sv")):
        jv, jm = (np.asarray(a)[:g] for a in jout.column(name))
        got = r[exists].numpy()[jm]
        if name == "sf":
            np.testing.assert_allclose(got, jv[jm], rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL_PER_ABS * finite, equal_nan=True)
        else:   # NaN where NaN; -0.0 == 0.0
            np.testing.assert_array_equal(got, jv[jm].astype(got.dtype))
    if specials:
        assert np.isnan(res[0][exists].numpy()).any()


def _kinds(reqs):
    return [k8.request_kind(f, v) for f, v in reqs] + [k8.request_kind("count", None)]


WARP_SET_CASES = {
    # name: ((func, dtype) of each request, the warps' set sizes)
    "q1": ([("count", torch.int64), ("sum", torch.int64)] * 3 + [("count", torch.float64),
           ("sum", torch.float64)] + [("count", torch.int64), ("sum", torch.int64)] * 3,
           [2, 2, 2, 2, 2, 2, 2, 1]),
    "q6": ([("count", torch.int64), ("sum", torch.int64)], [1, 1, 1, 0, 0, 0, 0, 0]),
    "64 groups, float64": ([("sum", torch.float64), ("min", torch.float64),
                            ("max", torch.float64)] * 2 + [("count", torch.float64)],
                           [1] * 8),
    "32 requests, 10 kinds": ([(f, t) for f in ("sum", "min", "max")
                               for t in (torch.int32, torch.int64, torch.float64)] * 3
                              + [("count", torch.int32)] * 5, [5] * 6 + [3, 0]),
    "no requests": ([], [1, 0, 0, 0, 0, 0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(WARP_SET_CASES))
def test_direct_agg_warp_sets(case):
    """K8's split of the requests over its 8 warps by kind: every request
    (and the row count) in exactly one warp; each warp's requests of one
    kind while the kinds allow; no warp more than one request past the
    least that could hold them."""
    spec, sizes = WARP_SET_CASES[case]
    kinds = _kinds([(f, torch.zeros(1, dtype=t)) for f, t in spec])
    order, start = k8.warp_sets(kinds)
    R = len(kinds)
    assert sorted(order) == list(range(R)) and start[0] == 0 and start[-1] == R
    assert len(start) == k8.WARPS + 1 and all(a <= b for a, b in zip(start, start[1:]))
    got = [b - a for a, b in zip(start, start[1:])]
    assert got == sizes
    if len(set(kinds)) <= k8.WARPS:
        for a, b in zip(start, start[1:]):
            assert len({kinds[order[x]] for x in range(a, b)}) <= 1
    # the row count is a count: it shares a warp with the other counts
    assert k8.request_kind("count", None) == kinds[-1] == 5


def test_direct_agg_stream_bytes_counts_each_column_once():
    """A count and a sum of one column read its validity once and its
    values once; a count reads no values; a bool key one byte a code."""
    v = torch.zeros(8, dtype=torch.int64)
    f = torch.zeros(8, dtype=torch.float32)
    m = torch.ones(8, dtype=torch.bool)
    codes, kvalid = torch.zeros(8, dtype=torch.bool), torch.ones(8, dtype=torch.bool)
    reqs = [("count", v, m), ("sum", v, m), ("min", f, None), ("count", f, None)]
    assert k8.stream_bytes([], reqs, None) == 1 + 8 + 4
    # the filter is the requests' validity column: still one byte
    assert k8.stream_bytes([(codes, kvalid)], reqs, m) == 1 + 8 + 4 + 1 + 1


# ---------------------------------------------------------------------------
# K5's compaction
# ---------------------------------------------------------------------------

def _packed(rng, cap, W=4, vb=2):
    words = rng.integers(-2**31, 2**31, (W, cap)).astype(np.int32)
    bits = rng.integers(-2**63, 2**63 - 1, (2, cap), dtype=np.int64)
    bits[:, ::5] = rng.integers(1, 1 << 52, bits[:, ::5].shape)   # denormals
    f64 = {"x": bits[0].view(np.float64), "y": bits[1].view(np.float64)}
    jlayout = jcol.PackedLayout((), ("x", "y"), vb, W)
    tlayout = tcol.PackedLayout((), ("x", "y"), vb, W)
    jpt = jcol.PackedTable(jnp.asarray(words), {k: jnp.asarray(v) for k, v in f64.items()},
                           jlayout)
    tpt = tcol.PackedTable(torch.from_numpy(words),
                           {k: torch.from_numpy(v.copy()) for k, v in f64.items()}, tlayout)
    return jpt, tpt, f64


COMPACT_EDGES = {
    # name: (cap, selectivity, out_cap)
    "past_out_cap_cap_off_the_tile": (3 * k5.COMPACT_TILE + 1234, 0.6, 5000),
    "one_row_past_a_tile": (k5.COMPACT_TILE + 1, 0.5, k5.COMPACT_TILE + 1),
    "tile_less_one_all_pass_past_out_cap": (k5.COMPACT_TILE - 1, 1.0, 2000),
    "two_tiles_none_pass": (2 * k5.COMPACT_TILE, 0.0, 2 * k5.COMPACT_TILE),
}


@pytest.mark.parametrize("case", sorted(COMPACT_EDGES))
def test_filter_compact_plain_matches_compact_rows(case):
    """The compaction past out_cap and at capacities off the new tile: the
    survivors in order (float64 sidecars bit for bit, NaN payloads and
    denormals included), the true count, zeros past it."""
    cap, p, out_cap = COMPACT_EDGES[case]
    rng = np.random.default_rng(cap)
    mask = rng.random(cap) < p
    jpt, tpt, f64 = _packed(rng, cap)
    (jout,), jn = jcol.compact_rows([jpt], jnp.asarray(mask), out_cap)
    (tout,), tn = tcol.compact_rows([tpt], torch.from_numpy(mask), out_cap)
    assert int(tn) == int(jn) == int(mask.sum())
    k = min(int(tn), out_cap)
    np.testing.assert_array_equal(tout.packed[:, :k].numpy(), np.asarray(jout.packed)[:, :k])
    for name in ("x", "y"):
        got = tout.f64s[name][:k].numpy().view(np.int64)
        np.testing.assert_array_equal(got, f64[name][mask][:k].view(np.int64))
    assert not tout.packed[:, k:].any() and not tout.f64s["x"][k:].view(torch.int64).any()


@pytest.mark.parametrize("cap,tiles", [(0, 0), (1, 1), (4095, 1), (4096, 1), (4097, 2),
                                       (67_108_864, 16_384)])
def test_compact_tiles_and_scratch(cap, tiles):
    """One look-back status word a tile of COMPACT_TILE rows, and the tile
    counter."""
    assert k5.compact_tiles(cap) == tiles
    assert k5.compact_scratch_bytes(cap) == 8 * (tiles + 1)


# ---------------------------------------------------------------------------
# tools/bench_agg_compact.py
# ---------------------------------------------------------------------------

def test_bench_cells_run_through_the_plain_versions(monkeypatch):
    """Every cell of the bench builds and runs at a tiny size through the
    plain versions (CPU tensors): the captured Q1, Q6 and Q19 calls (TPC-H
    at SF 0.002), the 64-group float64 cell and the K5 selectivities, each
    equal to its plain version and the same bits twice."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    sys.path.insert(0, REPO)
    import bench_agg_compact as bench
    import profile_agg_compact_call as prof
    monkeypatch.setattr(bench, "BIG", 4096)
    monkeypatch.setattr(bench, "cuda_ms", lambda fn: (fn(), 0.0)[1])
    captured = prof.capture(torch, 0.002, torch.device("cpu"))
    assert set(captured) == set(prof.CALLS)
    assert prof.k8_shape(torch, captured["K8 Q1"])["G"] == 12
    assert prof.k5_shape(captured["K5 compaction Q19"])["W"] > 0
    cells = bench.run_cells(torch, captured, torch.Generator().manual_seed(1),
                            torch.device("cpu"), False)
    assert set(cells) == (set(prof.CALLS) | set(bench.K5_CELLS)
                          | {"K8 64 groups, float64 sums/min/max over 2^26"})
    for name, cell in cells.items():
        assert cell["equal_plain"] and cell["same_bits_twice"], name
        assert cell["bound_bytes"] > 0, name
    assert cells["K5 50%, out_cap 2^24 (survivors drop)"]["shape"]["out_cap"] == 1024
