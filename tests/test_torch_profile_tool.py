"""tools/profile_join.py's trace reading, on a hand-made chrome trace:
device work is attributed to the stage whose range launched it, the glue
gets the rest, and the busy share is the union of device intervals over the
join's window."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import profile_join  # noqa: E402


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
