"""Tracing & profiling (torch).

Counterpart of the JAX package's `utils/tracing.py`. The reference's
observability is ad-hoc SystemTime spans and commented-out println
instrumentation (SURVEY.md §5.1 — reference
version1/build_implementation.rs:112-126, new_map_3.rs:335-362, and unwired
pprof dev-deps). Here:

  * `span(name)` — host-side wall-clock spans, nestable, collected into a
    global registry (`span_report()`).
  * `profile(log_dir, device=...)` — wraps execution in
    `torch.profiler.profile` and writes a Chrome trace (`trace.json`) of
    the host's and, on "cuda", the card's timeline into `log_dir`. Each
    plan node's `execute` runs under a `record_function` range named after
    its operator (`operator_range`), so the trace names the query's
    operators around the kernels they launch.
  * `QueryHandle.analyze()` (runtime/executor.py) gives per-operator rows +
    wall time — the EXPLAIN ANALYZE the reference never implemented
    (its operators don't carry a MetricsSet, SURVEY.md §5.5).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

_SPANS: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SPANS[name].append(time.perf_counter() - t0)


def span_report(reset: bool = False) -> List[Tuple[str, int, float, float]]:
    """-> [(name, count, total_s, mean_s)] sorted by total desc."""
    out = [(n, len(ts), sum(ts), sum(ts) / len(ts))
           for n, ts in _SPANS.items()]
    out.sort(key=lambda r: -r[2])
    if reset:
        _SPANS.clear()
    return out


TRACE_FILE = "trace.json"
# the Chrome trace's categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace: dict) -> list:
    """The complete events of a Chrome trace that ran on the card."""
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


@contextlib.contextmanager
def profile(log_dir: str, device: str = "cuda"):
    """torch.profiler over the block, its Chrome trace written to
    `log_dir`/trace.json; yields the profiler (`key_averages()` once the
    block has ended). device "cuda" records the host's and the card's
    activity and raises when there is no card, or when the trace holds no
    work on the card; "cpu" records the host's only."""
    from torch.profiler import ProfilerActivity
    if device not in ("cuda", "cpu"):
        raise ValueError(f"profile: device {device!r} is neither 'cuda' nor 'cpu'")
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile: device='cuda' but no CUDA device; pass device='cpu'")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if device == "cuda":
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if device == "cuda":
        with open(path) as f:
            if not device_events(json.load(f)):
                raise RuntimeError(f"profile: {path} holds no work on the card (CUPTI "
                                   "unavailable?); time with CUDA events instead")


def operator_range(execute):
    """A plan node's `execute` under a torch.profiler range named after its
    operator ("HashJoin" for PHashJoin.execute) while a profiler runs;
    outside one the call goes straight through."""
    name = execute.__qualname__.split(".")[0][1:]

    @functools.wraps(execute)
    def run(self, tables, ctx):
        if not torch.autograd._profiler_enabled():
            return execute(self, tables, ctx)
        with torch.profiler.record_function(name):
            return execute(self, tables, ctx)
    return run
