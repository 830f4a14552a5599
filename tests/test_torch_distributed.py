"""The port's distributed layer (parallel/) against the JAX package's on
its 8-device virtual CPU mesh (tests/conftest.py), at P = 8 through the
port's InProcessExchange on the CPU (the kernels' plain versions):

  * the cases of tests/test_distributed.py: each result equal to JAX's
    `distributed_hash_join` row for row and to tests/oracle.py, and the
    returned DistJoinConfig equal to JAX's;
  * shuffle_by_hash, replicating_shuffle, key_histogram, salted_route and
    build_replication_mask per shard against the JAX functions inside
    `jax.shard_map`: every received shard row for row, dropped counts
    bit for bit;
  * the grow-and-retry loop (dropped rows, out_cap), the three modes
    agreeing (the first half of __graft_entry__.dryrun_multichip), P = 16
    against the oracle, and two gloo processes through
    ProcessGroupExchange equal to the in-process run.
"""

import logging
import os
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from datafusion_parallelism_tpu.ops.join import JoinType as JJoinType
from datafusion_parallelism_tpu.parallel import distributed as jdist
from datafusion_parallelism_tpu.parallel import make_mesh as jmake_mesh
from datafusion_parallelism_tpu.parallel import shuffle as jshuffle
from datafusion_parallelism_tpu.parallel import skew as jskew
from datafusion_parallelism_tpu.utils.columnar import HostTable as JHostTable

from datafusion_parallelism_tpu_torch import parallel as tpar
from datafusion_parallelism_tpu_torch.ops.join import JoinType
from datafusion_parallelism_tpu_torch.parallel import distributed as tdist
from datafusion_parallelism_tpu_torch.parallel import shuffle as tshuffle
from datafusion_parallelism_tpu_torch.parallel import skew as tskew
from datafusion_parallelism_tpu_torch.utils.columnar import HostTable
from datafusion_parallelism_tpu_torch.utils.convert import shards_from_reference

from oracle import assert_rows_equal, oracle_join

N_DEV = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(N_DEV, platform="cpu")


@pytest.fixture(scope="module")
def ex():
    return tpar.make_mesh(N_DEV, "cpu")


def _tables(rng, n_build=200, n_probe=300, key_range=50, skewed=False):
    """tests/test_distributed.py's tables: NULL keys sprinkled in, an
    exponential probe-key distribution when `skewed`."""
    if skewed:
        x = rng.random(n_probe)
        pkeys = ((key_range * (16.0 ** x - 1) / 15.0)).astype(np.int64)
        bkeys = rng.integers(0, key_range, n_build)
    else:
        pkeys = rng.integers(0, key_range, n_probe)
        bkeys = rng.integers(0, key_range, n_build)
    build = {"b_key": bkeys.tolist(), "b_val": list(range(n_build))}
    probe = {"p_key": pkeys.tolist(), "p_val": list(range(n_probe))}
    build["b_key"][3] = None
    probe["p_key"][5] = None
    return build, probe


def _cfg_fields(cfg):
    return (cfg.mode, cfg.join_type.value, cfg.strategy.value, cfg.build_send_cap,
            cfg.probe_send_cap, cfg.out_cap, cfg.skew_factor)


def _run_both(jmesh, ex, build, probe, join_type, mode, **cfg_kw):
    """(port rows, JAX rows, port config, JAX config) of one join."""
    tres, tcfg = tpar.distributed_hash_join(
        ex, HostTable.from_pydict(build), HostTable.from_pydict(probe), ["b_key"], ["p_key"],
        tpar.DistJoinConfig(mode=mode, join_type=join_type, **cfg_kw))
    jres, jcfg = jdist.distributed_hash_join(
        jmesh, JHostTable.from_pydict(build), JHostTable.from_pydict(probe), ["b_key"],
        ["p_key"], jdist.DistJoinConfig(mode=mode, join_type=JJoinType(join_type.value),
                                        **cfg_kw))
    return tres.to_pylist(), jres.to_pylist(), tcfg, jcfg


def _check(jmesh, ex, build, probe, join_type, mode, **cfg_kw):
    rows, jrows, tcfg, jcfg = _run_both(jmesh, ex, build, probe, join_type, mode, **cfg_kw)
    assert rows == jrows
    assert _cfg_fields(tcfg) == _cfg_fields(jcfg)
    expected = oracle_join([dict(zip(build, v)) for v in zip(*build.values())],
                           [dict(zip(probe, v)) for v in zip(*probe.values())],
                           ["b_key"], ["p_key"], join_type.value)
    assert_rows_equal(rows, expected)
    return tcfg


@pytest.mark.parametrize("join_type", list(JoinType))
def test_partitioned_all_types(jmesh, ex, join_type):
    build, probe = _tables(np.random.default_rng(42))
    _check(jmesh, ex, build, probe, join_type, "partitioned")


@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.RIGHT, JoinType.RIGHT_SEMI,
                                       JoinType.RIGHT_ANTI])
def test_broadcast_probe_driven(jmesh, ex, join_type):
    build, probe = _tables(np.random.default_rng(7), n_build=60)
    _check(jmesh, ex, build, probe, join_type, "broadcast")


@pytest.mark.parametrize("mode", ["broadcast", "skew_salted"])
def test_build_emitting_types_raise(ex, mode):
    build, probe = _tables(np.random.default_rng(7))
    with pytest.raises(ValueError):
        tpar.distributed_hash_join(ex, HostTable.from_pydict(build),
                                   HostTable.from_pydict(probe), ["b_key"], ["p_key"],
                                   tpar.DistJoinConfig(mode=mode, join_type=JoinType.LEFT))


@pytest.mark.parametrize("join_type", [JoinType.INNER, JoinType.RIGHT, JoinType.RIGHT_SEMI,
                                       JoinType.RIGHT_ANTI])
def test_skew_salted_exponential_keys(jmesh, ex, join_type):
    build, probe = _tables(np.random.default_rng(3), n_build=100, n_probe=500, key_range=40,
                           skewed=True)
    _check(jmesh, ex, build, probe, join_type, "skew_salted")


def test_partitioned_empty_probe(jmesh, ex):
    build = {"b_key": [1, 2, 3], "b_val": [10, 20, 30]}
    probe = {"p_key": [99, 98], "p_val": [0, 1]}
    _check(jmesh, ex, build, probe, JoinType.FULL, "partitioned")


def test_retries_grow_the_capacities_as_jax(jmesh, ex, monkeypatch, caplog):
    """Send blocks past their capacity drop rows, and candidates past
    out_cap overflow: both packages double the send capacities, then grow
    out_cap to round_capacity(total), and end with the same config and
    rows. Send capacities start at the shard capacity (the config's
    smaller ones are raised to it), which no shard's rows can pass, so
    both packages' partition_table report a sixteenth of it here."""
    def sixteenth(orig):
        def partition_table(t, P, shard_cap=None):
            cols, num_rows, schema, cap = orig(t, P, shard_cap)
            return cols, num_rows, schema, cap // 16
        return partition_table

    monkeypatch.setattr(jdist, "partition_table", sixteenth(jshuffle.partition_table))
    monkeypatch.setattr(tdist, "partition_table", sixteenth(tshuffle.partition_table))
    rng = np.random.default_rng(11)
    build = {"b_key": rng.integers(0, 3, 400).tolist(), "b_val": list(range(400))}
    probe = {"p_key": rng.integers(0, 3, 600).tolist(), "p_val": list(range(600))}
    with caplog.at_level(logging.INFO, logger=tdist.__name__):
        tres, tcfg = tpar.distributed_hash_join(
            ex, HostTable.from_pydict(build), HostTable.from_pydict(probe), ["b_key"],
            ["p_key"], tpar.DistJoinConfig(build_send_cap=1, probe_send_cap=1))
    retries = [r.getMessage().split(" ")[0] for r in caplog.records
               if r.name == tdist.__name__]
    jres, jcfg = jdist.distributed_hash_join(
        jmesh, JHostTable.from_pydict(build), JHostTable.from_pydict(probe), ["b_key"],
        ["p_key"], jdist.DistJoinConfig(build_send_cap=1, probe_send_cap=1))
    assert "dropped" in retries and "out_cap" in retries, retries
    assert _cfg_fields(tcfg) == _cfg_fields(jcfg)
    assert tres.to_pylist() == jres.to_pylist()
    assert tres.num_rows == sum(int(np.sum(np.array(build["b_key"]) == k))
                                * int(np.sum(np.array(probe["p_key"]) == k)) for k in range(3))


def test_three_modes_agree(ex):
    """The first half of __graft_entry__.dryrun_multichip: one step of each
    mode over the mesh, no overflow, the same sum of the probe values."""
    n = N_DEV
    rng = np.random.default_rng(0)
    n_build, n_probe = 16 * n, 32 * n
    build = HostTable.from_numpy({"b_key": rng.integers(0, 16, n_build).astype(np.int32),
                                  "b_val": rng.random(n_build).astype(np.float32)})
    probe = HostTable.from_numpy({"p_key": rng.integers(0, 16, n_probe).astype(np.int32),
                                  "p_val": rng.random(n_probe).astype(np.float32)})
    bcols, bnum, bschema, _ = tshuffle.partition_table(build, n)
    pcols, pnum, pschema, _ = tshuffle.partition_table(probe, n)
    builds = tshuffle.local_shards(ex, bschema, bcols, bnum)
    probes = tshuffle.local_shards(ex, pschema, pcols, pnum)
    sums = {}
    for mode in ("partitioned", "broadcast", "skew_salted"):
        cfg = tpar.DistJoinConfig(mode=mode, build_send_cap=n_build, probe_send_cap=n_probe,
                                  out_cap=32 * n_probe)
        outs, total, dropped = tdist.dist_join_shard(ex, builds, probes, ["b_key"], ["p_key"],
                                                     cfg)
        assert int(dropped) == 0 and int(total) <= cfg.out_cap, mode
        assert sum(int(o.num_rows) for o in outs) > 0, mode
        s = 0.0
        for o in outs:
            v, valid = o.column("p_val")
            s += float(torch.where(valid & o.row_mask(), v, 0.0).sum())
        assert np.isfinite(s)
        sums[mode] = s
    assert abs(sums["broadcast"] - sums["partitioned"]) < 1e-3, sums
    assert abs(sums["skew_salted"] - sums["partitioned"]) < 1e-3, sums


def test_sixteen_partitions_match_the_oracle():
    """P = 16: gather_shards concatenates in K11's groups of 8."""
    build, probe = _tables(np.random.default_rng(5), n_build=300, n_probe=400)
    res, _ = tpar.distributed_hash_join(
        tpar.make_mesh(16, "cpu"), HostTable.from_pydict(build), HostTable.from_pydict(probe),
        ["b_key"], ["p_key"], tpar.DistJoinConfig(join_type=JoinType.FULL))
    expected = oracle_join([dict(zip(build, v)) for v in zip(*build.values())],
                           [dict(zip(probe, v)) for v in zip(*probe.values())],
                           ["b_key"], ["p_key"], "full")
    assert_rows_equal(res.to_pylist(), expected)


# ---------------------------------------------------------------------------
# per shard, against the JAX functions inside shard_map
# ---------------------------------------------------------------------------

def _shard_inputs(rng, n=700, key_range=60, skewed=False):
    x = rng.random(n)
    keys = ((key_range * (16.0 ** x - 1) / 15.0).astype(np.int32) if skewed
            else rng.integers(0, key_range, n).astype(np.int32))
    valid = rng.random(n) > 0.05
    t = JHostTable.from_numpy({"k": keys, "v": rng.integers(-9, 9, n).astype(np.int64),
                               "f": rng.random(n)}, validity={"k": valid})
    return t, jshuffle.partition_table(t, N_DEV)


def _jax_step(jmesh, schema, fn, cols, num):
    axis = jmesh.axis_names[0]

    @partial(jax.shard_map, mesh=jmesh, in_specs=(JP(axis), JP(axis)),
             out_specs=(JP(axis), JP(axis), JP()))
    def step(cols, num):
        t = jshuffle.local_table(schema, cols, num)
        out, dropped = fn(t, axis)
        ocols, onum = jshuffle.unlocal_table(out)
        return ocols, onum, dropped

    return jax.jit(step)(cols, num)


def _assert_shards_equal(tshards, jcols, jnum):
    jnum = np.asarray(jnum)
    assert [int(t.num_rows) for t in tshards] == jnum.tolist()
    for p, t in enumerate(tshards):
        n = int(jnum[p])
        for name, (v, valid) in t.columns.items():
            jv, jvalid = (np.asarray(a)[p][:n] for a in jcols[name])
            np.testing.assert_array_equal(valid[:n].numpy(), jvalid)
            np.testing.assert_array_equal(np.where(jvalid, v[:n].numpy(), 0),
                                          np.where(jvalid, jv, 0))


@pytest.mark.parametrize("send_cap", [8, 256])
@pytest.mark.parametrize("skewed", [False, True])
def test_shuffle_by_hash_per_shard(jmesh, ex, send_cap, skewed):
    """Every received shard row for row, and the dropped count (send_cap 8
    drops rows), as JAX's shuffle_by_hash; a late-materialization mask."""
    rng = np.random.default_rng(21)
    t, (cols, num, schema, cap) = _shard_inputs(rng, skewed=skewed)
    late = rng.random((N_DEV, cap)) > 0.2

    def fn(lt, axis):
        me = jax.lax.axis_index(axis)
        return jshuffle.shuffle_by_hash(lt, ["k"], send_cap, axis,
                                        valid=jnp.asarray(late)[me])

    jcols, jnum, jdropped = _jax_step(jmesh, schema, fn, cols, num)
    shards = shards_from_reference(cols, num, schema, device=CPU)
    out, dropped = tshuffle.shuffle_by_hash(ex, shards, ["k"], send_cap,
                                            valid=[torch.from_numpy(m) for m in late])
    assert int(dropped) == int(jdropped)
    if send_cap == 64:
        assert int(dropped) > 0
    _assert_shards_equal(out, jcols, jnum)


@pytest.mark.parametrize("send_cap", [48, 512])
def test_salted_shuffles_per_shard(jmesh, ex, send_cap):
    """key_histogram, heavy_buckets, build_replication_mask with
    replicating_shuffle (the build side) and salted_route with
    shuffle_by_hash (the probe side), as skew_salted runs them; the
    port's build side both from the replicate flags and from the heavy
    table (K18's heavy_to_all, what the join runs)."""
    rng = np.random.default_rng(8)
    t, (cols, num, schema, cap) = _shard_inputs(rng, skewed=True)
    axis = jmesh.axis_names[0]

    @partial(jax.shard_map, mesh=jmesh, in_specs=(JP(axis), JP(axis)),
             out_specs=(JP(), JP(axis), JP(axis), JP(axis)))
    def routes(cols, num):
        lt = jshuffle.local_table(schema, cols, num)
        hist = jskew.key_histogram(lt, ["k"], axis)
        heavy = jskew.heavy_buckets(hist)
        dest, is_heavy = jskew.salted_route(lt, ["k"], heavy, axis)
        rep = jskew.build_replication_mask(lt, ["k"], heavy)
        return hist, dest[None], is_heavy[None], rep[None]

    jhist, jdest, jheavy, jrep = jax.jit(routes)(cols, num)
    shards = shards_from_reference(cols, num, schema, device=CPU)
    hist = tskew.key_histogram(ex, shards, ["k"])
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    heavy = tskew.heavy_buckets(hist)
    assert heavy.any()
    np.testing.assert_array_equal(heavy.numpy(), np.asarray(jskew.heavy_buckets(jhist)))
    for p, ((dest, is_heavy), rep) in enumerate(zip(
            tskew.salted_route(ex, shards, ["k"], heavy),
            tskew.build_replication_mask(shards, ["k"], heavy))):
        np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest)[p])
        np.testing.assert_array_equal(is_heavy.numpy(), np.asarray(jheavy)[p])
        np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep)[p])

    def build_side(lt, axis):
        heavy = jskew.heavy_buckets(jskew.key_histogram(lt, ["k"], axis))
        rep = jskew.build_replication_mask(lt, ["k"], heavy)
        return jshuffle.replicating_shuffle(lt, ["k"], send_cap, rep, axis)

    def probe_side(lt, axis):
        heavy = jskew.heavy_buckets(jskew.key_histogram(lt, ["k"], axis))
        dest, _ = jskew.salted_route(lt, ["k"], heavy, axis)
        return jshuffle.shuffle_by_hash(lt, ["k"], send_cap, axis, dest_override=dest)

    rep = tskew.build_replication_mask(shards, ["k"], heavy)
    for fn, (out, dropped) in (
            (build_side, tshuffle.replicating_shuffle(ex, shards, ["k"], send_cap, rep)),
            (build_side, tshuffle.replicating_shuffle(ex, shards, ["k"], send_cap,
                                                      heavy=heavy)),
            (probe_side, tshuffle.shuffle_by_hash(ex, shards, ["k"], send_cap, heavy=heavy))):
        jcols, jnum, jdropped = _jax_step(jmesh, schema, fn, cols, num)
        assert int(dropped) == int(jdropped)
        _assert_shards_equal(out, jcols, jnum)


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

def _gloo_rank(rank, store, build, probe, out_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=__import__("datetime").timedelta(seconds=60))
    try:
        ex = tpar.make_mesh(2, "cpu", process_group=True)
        res, cfg = tpar.distributed_hash_join(
            ex, HostTable.from_pydict(build), HostTable.from_pydict(probe), ["b_key"],
            ["p_key"], tpar.DistJoinConfig(join_type=JoinType.FULL))
        torch.save((res.to_pylist(), _cfg_fields(cfg)), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gloo_two_processes_equal_in_process():
    """Two spawned CPU processes, one partition each, joined through
    ProcessGroupExchange over gloo (a file store): each returns the rows
    and config of the in-process run at P = 2."""
    import torch.multiprocessing as mp
    build, probe = _tables(np.random.default_rng(9))
    want, want_cfg = tpar.distributed_hash_join(
        tpar.make_mesh(2, "cpu"), HostTable.from_pydict(build), HostTable.from_pydict(probe),
        ["b_key"], ["p_key"], tpar.DistJoinConfig(join_type=JoinType.FULL))
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, store, build, probe, d))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        for r in range(2):
            rows, cfg = torch.load(os.path.join(d, f"{r}.pt"))
            assert rows == want.to_pylist()
            assert cfg == _cfg_fields(want_cfg)


def test_mesh_without_a_gpu_raises():
    """make_mesh defaults to the card: with none visible it raises, and no
    join runs on the CPU in its place."""
    import subprocess
    import sys
    code = ("from datafusion_parallelism_tpu_torch import parallel as par\n"
            "try:\n"
            "    par.make_mesh(8)\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised:") and "no CUDA device" in proc.stdout
