#!/usr/bin/env python3
"""The TPC-H SF100 campaign on one card: the port's CLI, one query a process.

    python3 tools/sf100_run.py --out DIR [--query N ...] [--data DIR] \
        [--scale-factor 100] [--timeout S] [--threshold-scale X] [--device cuda]

Holds no engine logic: every step is a subprocess of the port's own entry
points. In order:

1. records the card (`nvidia-smi --query-gpu=name,power.limit`), the free
   disk under --data and the host's free memory (/proc/meminfo) in
   DIR/device.json;
2. generates the tables with `tpch.generate --format bin` unless --data
   already holds them at this scale (a `generated.json` beside them says
   so), after refusing, with the shortfall named, when the disk cannot
   hold them (on a tmpfs such as /dev/shm, the disk and the memory);
3. writes the out-of-core routes of the 22 queries with `tpch.eligibility`
   (a process of its own, on the CPU: planning touches no device) to
   DIR/eligibility.json, and beside the data, where a later run over the
   same tables and thresholds takes it instead of planning again;
4. builds the CUDA kernels once, in this process, so that no query's only
   iteration carries the nvcc build;
5. runs each --query (repeatable; default all 22) as `tpch.cli --query q
   --iterations 1 --check --output-path DIR` in its own process, each under
   its own --timeout: the CLI merges the runs into DIR/results.json. A
   query whose process is killed or dies becomes an `error` entry there and
   the next query runs. Per query, DIR/device.json gets its seconds, exit
   code, the host's available memory before and at its lowest, and the
   process's peak resident set, sampled every SAMPLE_S from /proc (mapped
   table pages count), beside wait4's ru_maxrss (which exec seeds with this
   process's own peak); the CLI records its peak device memory.

One process a query because a host heap that outlives queries grows with
every pack cycle: the JAX package's batch of all 22 in one process was
killed for host memory during Q9 at SF100, and passed one query a process.

--threshold-scale X multiplies the three out-of-core thresholds
(DFP_STREAM_THRESHOLD_BYTES, DFP_STREAM_ROW_THRESHOLD,
DFP_GRACE_RESIDENT_CEILING) for every subprocess: X = SF / 100 gives a
smaller scale SF100's routes. DIR is written in place, so several calls
into several directories are merged afterwards by `python -m
datafusion_parallelism_tpu_torch.benches.merge_sf100`. The default device,
cuda, raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PKG = "datafusion_parallelism_tpu_torch"
SECTIONS = ("query_times_ms", "query_summary", "query_metrics", "checked")
# the executor's defaults (runtime/executor.py, runtime/grace.py)
THRESHOLDS = {"DFP_STREAM_THRESHOLD_BYTES": 6 << 30,
              "DFP_STREAM_ROW_THRESHOLD": 1 << 26,
              "DFP_GRACE_RESIDENT_CEILING": 96 << 20}
# the binary format at SF10 (the native generator), and room for the answers
BIN_BYTES_SF10 = 5_856_757_476
HEADROOM_BYTES = 1 << 30
TABLES = ("customer", "lineitem", "nation", "orders", "part", "partsupp", "region",
          "supplier")
# the eligibility fields that name a query's route
ROUTE_FIELDS = ("streamed_table", "eligible", "via_grace", "via_side_swap", "merge",
                "partition_columns")
SAMPLE_S = 0.2


def route_of(entry: dict) -> dict:
    """An eligibility entry's route: its ROUTE_FIELDS (absent ones None)."""
    return {k: entry.get(k) for k in ROUTE_FIELDS}


def executor_route(entry: dict) -> str:
    """The executor's `metrics.route` for a query of this eligibility."""
    if entry.get("via_grace"):
        return "grace agg" if entry.get("merge") == "aggregate" else "grace union"
    if entry.get("via_side_swap"):
        return "streamed after a side-swap"
    return "streamed" if entry.get("eligible") else "resident"


def route_differences(ours: dict, reference: dict) -> dict:
    """{query: (ours, reference)} where two eligibility reports' routes differ."""
    out = {}
    for q in sorted(set(ours) | set(reference), key=int):
        a, b = route_of(ours.get(q, {})), route_of(reference.get(q, {}))
        if a != b:
            out[q] = (a, b)
    return out


def peak_rss(pid: int) -> int | None:
    """The larger of /proc/<pid>/status's VmHWM and VmRSS in bytes: the
    process's own peak resident set where the kernel keeps one, else its
    resident set now (None once it has exited, or where neither is kept)."""
    found = []
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(("VmHWM:", "VmRSS:")):
                    found.append(int(line.split()[1]) * 1024)
    except OSError:
        pass
    return max(found, default=None)


def mem_available() -> int | None:
    """/proc/meminfo's MemAvailable in bytes (None where it cannot be read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def card() -> str:
    """nvidia-smi's name and power limit; raises without a GPU."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"--device cuda needs a GPU: nvidia-smi failed ({e})") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"--device cuda needs a GPU: nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def disk_free(path: str) -> int:
    """Free bytes on the file system that holds (or will hold) `path`."""
    path = os.path.abspath(path)
    while not os.path.exists(path):
        path = os.path.dirname(path)
    return shutil.disk_usage(path).free


def in_memory(path: str) -> bool:
    """True when `path` lies on a tmpfs (/proc/mounts): its files take the
    host's memory."""
    path = os.path.abspath(path)
    while not os.path.exists(path):
        path = os.path.dirname(path)
    path = os.path.realpath(path)
    best, fstype = "", None
    try:
        with open("/proc/mounts") as f:
            for line in f:
                mnt, typ = line.split()[1:3]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, fstype = mnt, typ
    except OSError:
        pass
    return fstype == "tmpfs"


def needed_bytes(sf: float) -> int:
    return math.ceil(sf / 10 * BIN_BYTES_SF10) + HEADROOM_BYTES


def data_ready(data: str, sf: float) -> bool:
    """True when `data` holds every table of this scale."""
    try:
        with open(os.path.join(data, "generated.json")) as f:
            made = json.load(f)
    except (OSError, ValueError):
        return False
    return (made.get("scale_factor") == sf
            and all(os.path.isfile(os.path.join(data, t, "meta.json")) for t in TABLES))


def _env(scale: float) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    if scale != 1.0:
        for k, v in THRESHOLDS.items():
            env[k] = str(int(v * scale))
    return env


def _run(cmd, env, log_path) -> None:
    """`cmd` to its end, its output to `log_path`; raises on a non-zero exit."""
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{' '.join(cmd)} exited {rc}:\n{tail}")


def run_query(q: int, argv, env, timeout: float, log_path: str) -> dict:
    """One query in its own process group, the host's memory sampled while
    it runs; killed past `timeout` seconds. -> its record."""
    rec = {"mem_available_before": mem_available()}
    low, hwm = rec["mem_available_before"], None
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)
        timed_out = False
        while True:
            peak = peak_rss(proc.pid)     # before wait4 reaps it
            if peak is not None:
                hwm = peak if hwm is None else max(hwm, peak)
            pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                break
            if time.perf_counter() - t0 >= timeout:
                os.killpg(proc.pid, signal.SIGKILL)
                pid, status, usage = os.wait4(proc.pid, 0)
                timed_out = True
                break
            m = mem_available()
            if m is not None:
                low = m if low is None else min(low, m)
            time.sleep(min(SAMPLE_S, max(0.0, timeout - (time.perf_counter() - t0))))
        proc.returncode = os.waitstatus_to_exitcode(status)
    rec.update(pid=proc.pid, seconds=round(time.perf_counter() - t0, 3), rc=proc.returncode,
               timed_out=timed_out, mem_available_min=low, peak_rss_bytes=hwm,
               maxrss_bytes=usage.ru_maxrss * 1024)
    if timed_out:
        rec["error"] = f"timeout: killed after {timeout:g} s"
    elif proc.returncode != 0:
        with open(log_path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        rec["error"] = (f"exit {proc.returncode}: {lines[-1] if lines else 'no output'}"
                        if proc.returncode > 0 else
                        f"killed by signal {-proc.returncode}")
    return rec


def record_error(out: str, q: int, error: str) -> None:
    """`error` as query q's only entry in out/results.json."""
    path = os.path.join(out, "results.json")
    res = {}
    if os.path.exists(path):
        with open(path) as f:
            res = json.load(f)
    for sect in SECTIONS:
        res.setdefault(sect, {}).pop(str(q), None)
    res["query_metrics"][str(q)] = {"error": error}
    with open(path, "w") as f:
        json.dump(res, f, indent=2, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the run's directory (results.json, ...)")
    ap.add_argument("--data", default=os.path.join(ROOT, "_data", "sf100_bin"),
                    help="the binary tables' directory (generated when missing)")
    ap.add_argument("--scale-factor", type=float, default=100.0)
    ap.add_argument("--query", type=int, action="append", default=None,
                    help="query number 1-22; repeatable; default all")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a query's process may run before it is killed")
    ap.add_argument("--threshold-scale", type=float, default=1.0,
                    help="factor on the out-of-core thresholds (SF / 100: SF100's routes)")
    ap.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    queries = args.query or list(range(1, 23))
    os.makedirs(os.path.join(args.out, "logs"), exist_ok=True)
    env = _env(args.threshold_scale)
    py = sys.executable
    dev_path = os.path.join(args.out, "device.json")
    device = {"nvidia_smi": card() if args.device == "cuda" else None,
              "device": args.device, "scale_factor": args.scale_factor,
              "thresholds": {k: env.get(k, str(v)) for k, v in THRESHOLDS.items()},
              "data": os.path.abspath(args.data),
              "disk_free_bytes": disk_free(args.data),
              "mem_available_bytes": mem_available(), "queries": {}}
    if os.path.exists(dev_path):
        with open(dev_path) as f:
            device["queries"] = json.load(f).get("queries", {})

    def save():
        with open(dev_path, "w") as f:
            json.dump(device, f, indent=1)

    print(f"sf100_run: {device['nvidia_smi'] or args.device}, disk free "
          f"{device['disk_free_bytes']} bytes, memory available "
          f"{device['mem_available_bytes']} bytes", flush=True)

    device["data_reused"] = data_ready(args.data, args.scale_factor)
    device["data_in_memory"] = in_memory(args.data)
    if not device["data_reused"]:
        need = needed_bytes(args.scale_factor)
        free = device["disk_free_bytes"]
        if device["data_in_memory"]:
            free = min(free, device["mem_available_bytes"] or 0)
        if free < need:
            save()
            raise RuntimeError(f"sf100_run writes TPC-H SF{args.scale_factor:g} under "
                               f"{args.data}: {free} bytes free, {need - free} short of {need}")
        shutil.rmtree(args.data, ignore_errors=True)
        t0 = time.perf_counter()
        _run([py, "-m", f"{PKG}.tpch.generate", "--format", "bin", "--scale-factor",
              str(args.scale_factor), "--output", args.data],
             env, os.path.join(args.out, "logs", "generate.log"))
        data_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(args.data) for f in fs)
        made = {"scale_factor": args.scale_factor, "bytes": data_bytes,
                "seconds": round(time.perf_counter() - t0, 3)}
        with open(os.path.join(args.data, "generated.json"), "w") as f:
            json.dump(made, f)
        device["generation"] = made
        print(f"sf100_run: generated {data_bytes} bytes in {made['seconds']} s", flush=True)
    device["disk_free_after_data_bytes"] = disk_free(args.data)
    device["mem_available_after_data_bytes"] = mem_available()
    save()

    # a process of its own: this one, whose children's memory is measured,
    # never maps the tables; a run over the same tables and thresholds
    # takes the copy kept beside them
    elig_path = os.path.join(args.out, "eligibility.json")
    kept = os.path.join(args.data, "eligibility_" + "_".join(device["thresholds"].values())
                        + ".json")
    t0 = time.perf_counter()
    device["eligibility_reused"] = os.path.isfile(kept)
    if not device["eligibility_reused"]:
        _run([py, "-m", f"{PKG}.tpch.eligibility", "--data-path", args.data,
              "--scale-factor", str(args.scale_factor), "--out", kept, "--device", "cpu"],
             env, os.path.join(args.out, "logs", "eligibility.log"))
    shutil.copyfile(kept, elig_path)
    device["eligibility_s"] = round(time.perf_counter() - t0, 3)
    with open(elig_path) as f:
        elig = json.load(f)["queries"]

    if args.device == "cuda":
        from datafusion_parallelism_tpu_torch.kernels import _build
        device["kernel_build_s"] = round(_build.build(), 3)
    save()

    for q in queries:
        argv_q = [py, "-m", f"{PKG}.tpch.cli", "--query", str(q), "--iterations", "1",
                  "--check", "--data-path", args.data, "--output-path", args.out,
                  "--device", args.device, "--scale-factor", str(args.scale_factor)]
        rec = run_query(q, argv_q, env, args.timeout,
                        os.path.join(args.out, "logs", f"q{q}.log"))
        rec["route_expected"] = executor_route(elig.get(str(q), {}))
        if "error" in rec:
            record_error(args.out, q, rec["error"])
        device["queries"][str(q)] = rec
        save()
        with open(os.path.join(args.out, "logs", f"q{q}.log")) as f:
            said = [ln for ln in f.read().splitlines() if ln.startswith(f"Q{q}:")]
        print(f"sf100_run Q{q}: {rec['seconds']} s, rc {rec['rc']}, host memory available "
              f"{rec['mem_available_before']} -> lowest {rec['mem_available_min']}, peak rss "
              f"{rec['peak_rss_bytes']}, maxrss {rec['maxrss_bytes']}; {said[-1] if said else rec.get('error')}", flush=True)
    device["seconds"] = round(time.perf_counter() - t_start, 3)
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
