"""tools/profile_join.py's trace reading, on a hand-made chrome trace:
device work is attributed to the stage whose range launched it, the glue
gets the rest, and the busy share is the union of device intervals over the
join's window. tools/profile_ops.py reads its chains' traces the same way,
with K5-K8 (and K1) as the stages."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import profile_join  # noqa: E402
import profile_ops  # noqa: E402


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _trace():
    ev = [
        # join 0: host 0-100; a glue launch, a K1 launch; device work ends at 120
        _x("user_annotation", "join", 0, 100),
        _x("user_annotation", "stage:hash_slot", 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=2),
        _x("kernel", "pack", 10, 30, corr=1),
        _x("kernel", "hash_slot_kernel", 30, 20, corr=2),   # overlaps pack by 10
        _x("gpu_memcpy", "Memcpy DtoH", 110, 10, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 90, 1, corr=3),
        # join 1: host 200-260; one K4 launch
        _x("user_annotation", "join", 200, 60),
        _x("user_annotation", "stage:compact_gather", 210, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 215, 1, corr=4),
        _x("kernel", "pair_gather_kernel", 220, 30, corr=4),
        # outside every join: ignored
        _x("cuda_runtime", "cudaLaunchKernel", 300, 1, corr=5),
        _x("kernel", "stray", 300, 5, corr=5),
    ]
    return {"traceEvents": ev}


def test_breakdown_attributes_device_time_to_stages():
    res = profile_join.breakdown(_trace(), 2)
    assert res["stage_ms"]["hash_slot"] == pytest.approx(20 / 1e3 / 2)
    assert res["stage_ms"]["compact_gather"] == pytest.approx(30 / 1e3 / 2)
    assert res["stage_ms"]["glue"] == pytest.approx(40 / 1e3 / 2)
    # join 0: window 0-120, busy 10-50 and 110-120 = 50; join 1: window 60, busy 30
    assert res["window_ms"] == pytest.approx((120 + 60) / 2 / 1e3)
    assert res["busy_ms"] == pytest.approx((50 + 30) / 2 / 1e3)
    assert res["busy_share"] == pytest.approx((50 / 120 + 30 / 60) / 2)
    assert [name for name, _ in res["top"]] == ["pack", "pair_gather_kernel",
                                                "hash_slot_kernel", "Memcpy DtoH"]


def test_breakdown_refuses_a_trace_without_device_work():
    trace = {"traceEvents": [_x("user_annotation", "join", 0, 10)]}
    with pytest.raises(RuntimeError, match="device events"):
        profile_join.breakdown(trace, 1)


def test_breakdown_of_a_chain_with_agg_stages():
    ev = [
        _x("user_annotation", "chain", 0, 100),
        _x("user_annotation", "stage:radix_sort", 10, 20),
        _x("user_annotation", "stage:direct_agg", 40, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=3),
        _x("kernel", "elementwise", 6, 4, corr=1),
        _x("kernel", "digit_scatter_kernel", 16, 30, corr=2),
        _x("kernel", "direct_partial_kernel", 50, 50, corr=3),
        # a join range in the same trace is not a chain
        _x("user_annotation", "join", 200, 10),
    ]
    res = profile_join.breakdown({"traceEvents": ev}, 1, profile_ops.STAGES, "chain")
    assert set(res["stage_ms"]) == set(profile_ops.STAGES) | {"glue"}
    assert res["stage_ms"]["radix_sort"] == pytest.approx(0.030)
    assert res["stage_ms"]["direct_agg"] == pytest.approx(0.050)
    assert res["stage_ms"]["glue"] == pytest.approx(0.004)
    assert res["stage_ms"]["segment_agg"] == 0.0
    # window 0-100, busy 6-10, 16-46 and 50-100
    assert res["busy_ms"] == pytest.approx(0.084)


def test_profile_ops_stages_wrap_and_restore_every_entry_point():
    """staged() wraps each of the chain's kernels in its stage range and
    leaves the kernel table itself as it was."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF, KERNELS
    before = tuple(KERNELS)
    staged = profile_ops.staged()
    assert staged._fields == KERNELS._fields and tuple(KERNELS) == before
    assert all(s is not k for s, k in zip(staged, KERNELS))
    assert set(profile_ops.STAGES) == set(KERNEL_OF.values())
    idx = torch.tensor([2, 0], dtype=torch.int32)
    words = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    f64 = torch.zeros((0, 3), dtype=torch.float64)
    got = staged.gather_rows(words, f64, idx)
    assert torch.equal(got[0], KERNELS.gather_rows(words, f64, idx)[0])


def test_profile_sql_stages_cover_every_kernel_and_run_a_query():
    """tools/profile_sql.py's staged tables name a stage for each of the
    seventeen kernels, and a query run through them on the CPU gives the same
    rows as through the default tables."""
    import profile_sql

    import datafusion_parallelism_tpu_torch as tdfp
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF as CHAIN_OF
    from datafusion_parallelism_tpu_torch.ops.join import KERNEL_OF as JOIN_OF
    assert set(profile_sql.STAGES) == set(CHAIN_OF.values()) | set(JOIN_OF.values())
    join, chain = profile_sql.staged()
    ctx = tdfp.SessionContext(device="cpu")
    ctx.register_pydict("a", {"k": [1, 2, 2, 3], "x": [1.0, 2.0, 3.0, 4.0]})
    ctx.register_pydict("b", {"j": [2, 3, 5], "y": [10, 20, 30]})
    sql = "SELECT j, sum(x) AS s FROM a LEFT JOIN b ON k = j GROUP BY j ORDER BY j"
    assert (ctx.sql(sql, kernels=join, chain=chain).collect().to_pylist()
            == ctx.sql(sql).collect().to_pylist())


def test_profile_sql_splits_k5_by_entry_point():
    """tools/profile_sql.py splits K5's stage into its compaction and its
    row gather by the names of the device kernels each entry point
    launches; the compaction's memset is the rest of the stage."""
    import profile_sql
    ev = [
        _x("user_annotation", "query", 0, 100),
        _x("user_annotation", "stage:filter_compact", 10, 20),
        _x("user_annotation", "stage:filter_compact", 40, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=3),
        _x("gpu_memset", "Memset (Device)", 13, 2, corr=1),
        _x("kernel", "(anonymous namespace)::compact_kernel(unsigned char const*, long)", 16, 30,
           corr=2),
        _x("kernel", "void (anonymous namespace)::zero_tail_kernel(long const*, long)", 47, 3,
           corr=4),
        _x("kernel", "(anonymous namespace)::row_gather_kernel(int const*, int)", 50, 40, corr=3),
    ]
    res = profile_join.breakdown({"traceEvents": ev}, 1, profile_sql.STAGES, "query")
    assert res["stage_ms"]["filter_compact"] == pytest.approx(0.075)
    assert profile_sql.stage_split("filter_compact", res["stage_ms"]["filter_compact"],
                                   res["kernel_ms"]) == \
        pytest.approx({"compaction": 0.033, "gather": 0.040, "other": 0.002})
    assert profile_sql.bare_name("void (anonymous namespace)::row_gather_word4_kernel<4>(int "
                                 "const*, long)") == "row_gather_word4_kernel"
    assert profile_sql.bare_name("compact_scatter_kernel(int*)") == "compact_scatter_kernel"


def test_profile_sql_splits_k7_into_its_pass_and_zero_tail():
    """tools/profile_sql.py splits K7's stage into its one pass and its zero
    tail by their kernels' names (K5's zero tail, of another name, stays
    out); the status memset is the rest of the stage."""
    import profile_sql
    ev = [
        _x("user_annotation", "query", 0, 100),
        _x("user_annotation", "stage:segment_agg", 10, 60),
        _x("user_annotation", "stage:filter_compact", 80, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 82, 1, corr=4),
        _x("gpu_memset", "Memset (Device)", 13, 1, corr=1),
        _x("kernel", "(anonymous namespace)::seg_pass_kernel((anonymous namespace)::KeySpecs, "
           "dfp::(anonymous namespace)::AggSpec, (anonymous namespace)::Pass)", 16, 20, corr=2),
        _x("kernel", "(anonymous namespace)::seg_zero_tail_kernel(long long const*, long long)",
           40, 9, corr=3),
        _x("kernel", "void (anonymous namespace)::zero_tail_kernel(long const*, long)", 85, 3,
           corr=4),
    ]
    res = profile_join.breakdown({"traceEvents": ev}, 1, profile_sql.STAGES, "query")
    assert res["stage_ms"]["segment_agg"] == pytest.approx(0.030)
    assert profile_sql.stage_split("segment_agg", res["stage_ms"]["segment_agg"],
                                   res["kernel_ms"]) == \
        pytest.approx({"pass": 0.020, "zero tail": 0.009, "other": 0.001})
