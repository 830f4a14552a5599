"""The benches' shared harness: scenario helpers, timing and the report line.

Counterpart of the root `benches/bench_lib.py`. Its scenario helper is
copied as it is (`make_exponential_int_array`, so the skewed keys equal
the JAX bench's on the same seed). Its timing differs: the JAX harness
synchronises by fetching a scalar to the host, while here each call is
timed on the card by CUDA events recorded around it, with the host's wall
time (the call, then a wait for its end event) kept beside them. On the
CPU (`--device cpu`) there are no events and the wall time stands in; the
line then names the device "cpu" and no number in it is a device time.

Every report line carries the JAX bench's keys (`bench`, `rows`, `best_ms`,
`mean_ms`, `rows_per_s`, and `median_ms`, `std_ms`, `samples` where the
statistics are given) plus `device` (the card's name) and `power_limit_w`
(`nvidia-smi`'s power limit, null off the card).
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch


# the benches' default output directory, under the repo (git ignores it)
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "bench_out")


class Mismatch(AssertionError):
    """A bench's answer differs from its check; the module exits non-zero."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Mismatch(what)


def make_exponential_int_array(rng, n: int, max_value: int) -> np.ndarray:
    """Reference src/api_utils.rs:15-23: y = max * (16^x - 1) / 15, x~U[0,1]."""
    x = rng.random(n)
    return (max_value * (16.0 ** x - 1) / 15.0).astype(np.int64).clip(0, max_value - 1)


def device_of(name: str) -> torch.device:
    """The device a bench runs on: the card unless the caller names the CPU;
    raises when the card is asked for and there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benches time the card; pass --device cpu to "
                           "run the kernels' plain versions on the CPU")
    return device


@functools.lru_cache(maxsize=None)
def _power_limit_w(index: int):
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def card(device: torch.device) -> dict:
    """{"device": the card's name, "power_limit_w": its power limit} ("cpu"
    and None on the CPU)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(index), "power_limit_w": _power_limit_w(index)}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit_stats(fn, device: torch.device, warmup: int = 2, iters: int = 10) -> dict:
    """-> {best_s, mean_s, median_s, std_s, samples, wall_median_s, timer}: fn() timed `iters` times after `warmup` calls,
    each between two CUDA events on the current stream (on the CPU: its
    wall time); the wall times include the wait for the end event."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    on_card = device.type == "cuda"
    times, walls = [], []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn()
        if on_card:
            end.record()
            end.synchronize()
        walls.append(time.perf_counter() - t0)
        times.append(start.elapsed_time(end) / 1e3 if on_card else walls[-1])
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "median_s": statistics.median(times),
        "std_s": statistics.stdev(times) if len(times) > 1 else 0.0,
        "samples": len(times),
        "wall_median_s": statistics.median(walls),
        "timer": "cuda_events" if on_card else "wall",
    }


def sandwich(make_fn, env_var: str, device: torch.device, on_value: str | None = None,
             off_value: str = "1", warmup: int = 1, iters: int = 5) -> dict:
    """ON/OFF/ON A/B of one of the port's `DFP_*` switches in one process.

    make_fn() is called afresh for each leg (so code that reads the switch
    when it builds its plan sees the leg's value) and returns the callable
    to time. Returns each leg's timeit_stats plus:
      * speedup: OFF median / the median of the two ON medians (> 1: the
        switch's ON value wins);
      * drift: |on1 - on2| / that ON median; a speedup within the drift is
        noise, not a result.
    """
    legs = {}
    saved = os.environ.get(env_var)
    try:
        for leg, val in (("on1", on_value), ("off", off_value), ("on2", on_value)):
            if val is None:
                os.environ.pop(env_var, None)
            else:
                os.environ[env_var] = val
            legs[leg] = timeit_stats(make_fn(), device, warmup, iters)
    finally:
        if saved is None:
            os.environ.pop(env_var, None)
        else:
            os.environ[env_var] = saved
    on_med = statistics.median([legs["on1"]["median_s"], legs["on2"]["median_s"]])
    off_med = legs["off"]["median_s"]
    return {
        "legs": legs,
        "speedup": off_med / on_med if on_med else float("inf"),
        "drift": abs(legs["on1"]["median_s"] - legs["on2"]["median_s"]) / on_med
        if on_med else 0.0,
    }


def report(name: str, rows: int, best_s: float, mean_s: float, device: torch.device,
           extra=None, stats: dict | None = None) -> dict:
    """Print the bench's JSON line and return it."""
    out = {"bench": name, "rows": rows,
           "best_ms": round(best_s * 1e3, 4),
           "mean_ms": round(mean_s * 1e3, 4),
           "rows_per_s": round(rows / best_s, 1)}
    if stats:
        out["median_ms"] = round(stats["median_s"] * 1e3, 4)
        out["std_ms"] = round(stats["std_s"] * 1e3, 4)
        out["samples"] = stats["samples"]
        out["wall_median_ms"] = round(stats["wall_median_s"] * 1e3, 4)
        out["timer"] = stats["timer"]
    if extra:
        out.update(extra)
    out.update(card(device))
    print(json.dumps(out), flush=True)
    return out


def report_stats(name: str, rows: int, stats: dict, device: torch.device, extra=None) -> dict:
    return report(name, rows, stats["best_s"], stats["mean_s"], device, extra, stats)
