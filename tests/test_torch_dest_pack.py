"""K18 dest_pack's and K19 key_histogram's plain versions against the JAX
code they replace (parallel/shuffle.py `_pack_by_dest` and
`replicating_shuffle`, parallel/skew.py `key_histogram`), the wrappers'
host-side argument checks, and `utils/convert.py::shards_from_reference`
against the port's own partition_table."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from datafusion_parallelism_tpu.ops.hashing import hash_rows as jhash_rows
from datafusion_parallelism_tpu.parallel import make_mesh as jmake_mesh
from datafusion_parallelism_tpu.parallel import shuffle as jshuffle
from datafusion_parallelism_tpu.parallel import skew as jskew
from datafusion_parallelism_tpu.utils.columnar import HostTable as JHostTable

from datafusion_parallelism_tpu_torch.kernels import _build
from datafusion_parallelism_tpu_torch.kernels import dest_pack as k18
from datafusion_parallelism_tpu_torch.kernels import key_histogram as k19
from datafusion_parallelism_tpu_torch.parallel import make_mesh
from datafusion_parallelism_tpu_torch.parallel import shuffle as tshuffle
from datafusion_parallelism_tpu_torch.utils.columnar import HostTable
from datafusion_parallelism_tpu_torch.utils.convert import shards_from_reference


def _table(rng, n, cap, key_range=100, skewed=False):
    """(JAX device table with a row-id column, the same keys' port hashes,
    row mask) with n rows in cap."""
    x = rng.random(n)
    keys = ((key_range * (16.0 ** x - 1) / 15.0).astype(np.int32) if skewed
            else rng.integers(0, key_range, n).astype(np.int32))
    valid = rng.random(n) > 0.05
    jt = JHostTable.from_numpy({"k": keys, "rid": np.arange(n, dtype=np.int32)},
                               validity={"k": valid}).to_device(cap)
    h = np.asarray(jhash_rows([jt.column("k")])).view(np.int32)
    return jt, torch.from_numpy(h.copy()), torch.arange(cap) < n


def _heavy(rng):
    return rng.random(256) < 0.1


@pytest.mark.parametrize("P", [1, 3, 8, 16])
@pytest.mark.parametrize("send_cap", [4, 64, 512])
@pytest.mark.parametrize("salted", [False, True])
def test_dest_pack_plain_equals_pack_by_dest(P, send_cap, salted):
    """The index grid (where send_valid), send_valid and dropped of JAX's
    _pack_by_dest, from the destinations JAX's shuffle_by_hash computes
    (with salted_route's override: heavy buckets stay on `rank`)."""
    rng = np.random.default_rng(P * 1000 + send_cap)
    jt, h, mask = _table(rng, 300, 512, skewed=salted)
    jh = jhash_rows([jt.column("k")])
    dest = jshuffle.route_of(jh, P)
    heavy, rank = None, P - 1
    if salted:
        heavy = _heavy(rng)
        dest = jnp.where(jnp.asarray(heavy)[jskew.bucket_of(jh)], rank, dest)
    dest = jnp.where(jt.row_mask(), dest, P)
    _, packed, _, send_valid, dropped = jshuffle._pack_by_dest(jt, dest, P, send_cap)
    rid_slot = [f[2] for f in jshuffle.pack_table(jt).layout.fields if f[0] == "rid"][0]
    jgrid = np.asarray(packed)[rid_slot]
    grid, counts, tdropped = k18.dest_pack_plain(
        h, mask, P, send_cap, None if heavy is None else torch.from_numpy(heavy), rank)
    sv = (torch.arange(send_cap)[None, :] < counts[:, None]).numpy()
    np.testing.assert_array_equal(sv, np.asarray(send_valid))
    np.testing.assert_array_equal(np.where(sv, grid.numpy(), 0), np.where(sv, jgrid, 0))
    assert (grid.numpy()[~sv] == 0).all()
    assert int(tdropped) == int(dropped)


@pytest.mark.parametrize("send_cap", [8, 100])
def test_dest_pack_plain_replicates_as_replicating_shuffle(send_cap):
    """Under JAX's replicating_shuffle (inside shard_map on the 8-device
    mesh) destination d receives, from each source s, the rows of s's grid
    row d; they and the dropped count equal dest_pack_plain's with the
    same replicate flags."""
    P = 8
    mesh = jmake_mesh(P, platform="cpu")
    axis = mesh.axis_names[0]
    rng = np.random.default_rng(send_cap)
    n = 600
    keys = rng.integers(0, 50, n).astype(np.int32)
    rep = rng.random(n) < 0.2
    t = JHostTable.from_numpy({"k": keys, "rid": np.arange(n, dtype=np.int32),
                               "src": np.zeros(n, dtype=np.int32), "rep": rep})
    cols, num, schema, cap = jshuffle.partition_table(t, P)
    # the source partition and the row's index in its shard
    src = np.repeat(np.arange(P)[:, None], cap, 1).astype(np.int32)
    cols["src"] = (jnp.asarray(src), cols["src"][1])
    cols["rid"] = (jnp.asarray(np.tile(np.arange(cap, dtype=np.int32), (P, 1))),
                   cols["rid"][1])

    @partial(jax.shard_map, mesh=mesh, in_specs=(JP(axis), JP(axis)),
             out_specs=(JP(axis), JP(axis), JP()))
    def step(cols, num):
        lt = jshuffle.local_table(schema, cols, num)
        flags = lt.column("rep")[0]
        out, dropped = jshuffle.replicating_shuffle(lt, ["k"], send_cap, flags, axis)
        ocols, onum = jshuffle.unlocal_table(out)
        return ocols, onum, dropped

    ocols, onum, jdropped = jax.jit(step)(cols, num)
    shards = shards_from_reference(cols, num, schema, device="cpu")
    total_dropped = 0
    grids = []
    for s, sh in enumerate(shards):
        h = tshuffle._hashes(sh, ["k"])
        grid, counts, dropped = k18.dest_pack_plain(h, sh.row_mask(), P, send_cap,
                                                    replicate=sh.column("rep")[0])
        grids.append((grid, counts))
        total_dropped += int(dropped)
    assert total_dropped == int(jdropped)
    for d in range(P):
        m = int(np.asarray(onum)[d])
        got_src = np.asarray(ocols["src"][0])[d][:m]
        got_rid = np.asarray(ocols["rid"][0])[d][:m]
        for s in range(P):
            grid, counts = grids[s]
            k = min(int(counts[d]), send_cap)
            np.testing.assert_array_equal(got_rid[got_src == s], grid[d, :k].numpy())


@pytest.mark.parametrize("P", [1, 8, 16])
@pytest.mark.parametrize("send_cap", [4, 512])
@pytest.mark.parametrize("with_flags", [False, True])
def test_dest_pack_plain_heavy_to_all_equals_replication_mask(P, send_cap, with_flags):
    """heavy_to_all (the heavy rows read off the hash, as the skewed build
    side runs K18) == the replicate flags of JAX's build_replication_mask,
    alone or ORed with other flags."""
    rng = np.random.default_rng(P * 7 + send_cap)
    jt, h, mask = _table(rng, 300, 512, skewed=True)
    heavy = _heavy(rng)
    flags = np.asarray(jskew.build_replication_mask(jt, ["k"], jnp.asarray(heavy)))
    other = torch.from_numpy(rng.random(512) < 0.1) if with_flags else None
    rep = torch.from_numpy(flags.copy())
    if with_flags:
        rep |= other
    want = k18.dest_pack_plain(h, mask, P, send_cap, replicate=rep)
    got = k18.dest_pack_plain(h, mask, P, send_cap, torch.from_numpy(heavy), P - 1, other,
                              heavy_to_all=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("n", [0, 1, 777])
def test_key_histogram_plain_equals_jax(n):
    """key_histogram_plain == JAX's key_histogram on a one-device mesh (its
    psum is the local histogram), rows outside the mask not counted."""
    rng = np.random.default_rng(n)
    jt, h, mask = _table(rng, n, 1024, skewed=True)
    late = rng.random(1024) > 0.3
    mesh = jmake_mesh(1, platform="cpu")
    axis = mesh.axis_names[0]

    @partial(jax.shard_map, mesh=mesh, in_specs=(), out_specs=JP())
    def hist():
        return jskew.key_histogram(jt, ["k"], axis, valid=jnp.asarray(late))

    got = k19.key_histogram_plain(h, mask & torch.from_numpy(late))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(hist)()))
    assert got.dtype == torch.int32


def _require_on_any_device(t, name, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def test_wrapper_argument_checks(monkeypatch):
    """What the wrappers refuse before a launch (their checks, without the
    CUDA-tensor one, on CPU tensors)."""
    monkeypatch.setattr(_build, "require", _require_on_any_device)
    h, m = torch.zeros(10, dtype=torch.int32), torch.ones(10, dtype=torch.bool)
    heavy = torch.zeros(256, dtype=torch.bool)
    assert k18.check_args(h, m, 8, 16, heavy, 7, m) == 10
    for bad in [dict(P=0), dict(P=k18.MAX_P + 1), dict(send_cap=-1), dict(rank=8),
                dict(heavy=torch.zeros(255, dtype=torch.bool)), dict(replicate=m[:9]),
                dict(send_cap=2**28), dict(heavy=None, heavy_to_all=True)]:
        args = dict(hashes=h, mask=m, P=8, send_cap=16, heavy=heavy, rank=0, replicate=None,
                    heavy_to_all=False)
        args.update(bad)
        with pytest.raises(ValueError):
            k18.check_args(**args)
    with pytest.raises(TypeError):
        k18.check_args(h.long(), m, 8, 16)
    with pytest.raises(ValueError):
        k18.check_args(h, m[:9], 8, 16)
    assert k19.check_args(h, m) == 10
    with pytest.raises(TypeError):
        k19.check_args(h, m.to(torch.uint8))
    with pytest.raises(ValueError):
        k19.check_args(h[:5], m)


def test_shards_from_reference_equal_the_ports_partition_table():
    rng = np.random.default_rng(4)
    data = {"k": rng.integers(0, 9, 301).astype(np.int32),
            "d": rng.random(301), "l": rng.integers(-5, 5, 301).astype(np.int64)}
    valid = {"k": rng.random(301) > 0.1}
    jt = JHostTable.from_numpy(data, validity=valid)
    ref = shards_from_reference(*jshuffle.partition_table(jt, 8)[:3], device="cpu")
    cols, num, schema, _ = tshuffle.partition_table(HostTable.from_numpy(data, validity=valid),
                                                    8)
    own = tshuffle.local_shards(make_mesh(8, "cpu"), schema, cols, num)
    assert len(ref) == len(own) == 8
    for a, b in zip(ref, own):
        assert a.schema.names == b.schema.names
        assert [f.dtype for f in a.schema.fields] == [f.dtype for f in b.schema.fields]
        assert int(a.num_rows) == int(b.num_rows)
        for name in a.schema.names:
            for x, y in zip(a.column(name), b.column(name)):
                assert torch.equal(x, y)
