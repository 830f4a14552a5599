"""The port's process bootstrap (parallel/multihost.py): tests/test_multihost.py's
query in two spawned CPU processes over gloo, each holding four of the
eight partitions (`init_multihost(..., local_device_count=4)`, P = 8
through ProcessGroupExchange). Both processes return the same rows, equal
to the Python oracle and to the in-process P = 8 run, with its settled
capacities and per-partition candidate totals; under the streaming
thresholds the query runs resident, as the JAX package's does across
processes. Also: the Exchange's collectives over 2 x 4 partitions equal
InProcessExchange's, and NCCL without a GPU raises."""

import os
import socket
import tempfile

import pytest
import torch

import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu_torch.parallel.exchange import InProcessExchange
from datafusion_parallelism_tpu_torch.parallel.multihost import init_multihost

from test_torch_distributed_sql import _by_place

N_DEV, N_PROC = 8, 2
N = 64
SQL = ("SELECT a_id, SUM(b_val) AS s, COUNT(*) AS c FROM ta "
       "JOIN tb ON a_id = b_id GROUP BY a_id ORDER BY a_id")
TOPK = "SELECT a_val, a_id FROM ta ORDER BY a_val DESC LIMIT 5"


def _session(partitions=N_DEV):
    ctx = tdfp.SessionContext(tdfp.SessionConfig(target_partitions=partitions), device="cpu")
    ctx.register_pydict("ta", {"a_id": [i % 16 for i in range(N)], "a_val": list(range(N))})
    ctx.register_pydict("tb", {"b_id": [i % 12 for i in range(N)],
                               "b_val": [i * 2 for i in range(N)]})
    return ctx


def _expected():
    """tests/test_multihost.py's oracle."""
    ids = [i % 16 for i in range(N)]
    bids = [i % 12 for i in range(N)]
    out = []
    for a in sorted(set(ids)):
        if a not in bids:
            continue
        matches = [i * 2 for i in range(N) if bids[i] == a]
        out.append({"a_id": a, "s": sum(matches) * ids.count(a), "c": len(matches) * ids.count(a)})
    return out


def _collectives(ex):
    """Each local shard's results of one all-to-all, all-gather and the
    two reductions over fixed per-partition tensors."""
    xs = [torch.arange(N_DEV * 3, dtype=torch.int32).reshape(N_DEV, 3) + 100 * r
          for r in ex.ranks]
    flags = [torch.tensor([(r + d) % 3 == 0 for d in range(N_DEV)]) for r in ex.ranks]
    return {"a2a": ex.all_to_all(xs, 0), "a2a_bool": ex.all_to_all(flags, 0),
            "gather": ex.all_gather([x[:2] for x in xs], 0),
            "gather_1": ex.all_gather([x[:, :1] for x in xs], 1),
            "sum": ex.all_reduce([torch.tensor(r + 1, dtype=torch.int64) for r in ex.ranks]),
            "max": ex.all_reduce([torch.tensor(3 * r, dtype=torch.int64) for r in ex.ranks],
                                 "max")}


def _worker(pid, port, out_dir):
    os.environ["DFP_NO_CAP_STORE"] = "1"
    from datafusion_parallelism_tpu_torch.parallel.multihost import shutdown_multihost
    init_multihost(f"localhost:{port}", num_processes=N_PROC, process_id=pid,
                   local_device_count=N_DEV // N_PROC, backend="gloo")
    try:
        h = _session().sql(SQL)
        rows = h.collect().to_pylist()
        topk = _session().sql(TOPK).collect().to_pylist()
        os.environ["DFP_STREAM_THRESHOLD_BYTES"] = "0"
        os.environ["DFP_STREAM_CHUNK_ROWS"] = "2048"
        hs = _session().sql(SQL)
        srows = hs.collect().to_pylist()
        coll = {k: [t.tolist() for t in v] for k, v in _collectives(h.mesh).items()}
        torch.save({"rows": rows, "topk": topk, "mesh": repr(h.mesh), "ranks": h.mesh.ranks,
                    "caps": _by_place(h.plan, h.metrics.join_caps),
                    "balance": _by_place(h.plan, h.metrics.balance),
                    "stream_rows": srows, "stream_route": hs.metrics.route,
                    "collectives": coll}, os.path.join(out_dir, f"{pid}.pt"))
    finally:
        shutdown_multihost()


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_four_partitions_each():
    import torch.multiprocessing as mp
    want = _session().sql(SQL)
    want_rows = want.collect().to_pylist()
    assert want_rows == _expected()
    want_topk = _session().sql(TOPK).collect().to_pylist()
    local = InProcessExchange(N_DEV, "cpu")
    want_coll = {k: [t.tolist() for t in v] for k, v in _collectives(local).items()}
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(pid, port, d)) for pid in range(N_PROC)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        got = [torch.load(os.path.join(d, f"{pid}.pt")) for pid in range(N_PROC)]
    for pid, g in enumerate(got):
        assert g["mesh"].startswith(f"ProcessGroupExchange(P={N_DEV}"), g["mesh"]
        assert g["ranks"] == list(range(pid * 4, pid * 4 + 4))
        assert g["rows"] == want_rows == _expected()
        assert g["topk"] == want_topk
        assert g["caps"] == _by_place(want.plan, want.metrics.join_caps)
        assert g["balance"] == _by_place(want.plan, want.metrics.balance)
        assert g["stream_route"] == "resident" and g["stream_rows"] == want_rows
        for k, v in g["collectives"].items():
            assert v == want_coll[k][pid * 4:pid * 4 + 4], k


def test_nccl_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        init_multihost("localhost:1", num_processes=1, process_id=0, local_device_count=8)
