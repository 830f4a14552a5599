"""K18 dest_pack's and K19 key_histogram's plain versions against the JAX
code they replace (parallel/shuffle.py `_pack_by_dest` and
`replicating_shuffle`, parallel/skew.py `key_histogram`), the wrappers'
host-side argument checks, and `utils/convert.py::shards_from_reference`
against the port's own partition_table."""

import ctypes
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import chip_smoke

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

    got = k19.key_histogram_plain([h], [torch.tensor(n, dtype=torch.int32)],
                                  [torch.from_numpy(late)])[0]
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
    n = torch.tensor(10, dtype=torch.int32)
    assert k19.check_args([h], [n], [m]) == 1
    with pytest.raises(TypeError):
        k19.check_args([h], [n], [m.to(torch.uint8)])
    with pytest.raises(ValueError):
        k19.check_args([h[:5]], [n], [m])


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


# ---------------------------------------------------------------------------
# K18's one-pass design replayed on the host
# ---------------------------------------------------------------------------

K18_CASES = [name for name, *_ in chip_smoke.K18_EDGES]


def _round_ranks(run, dd, aa, P):
    """One warp round as the kernel ranks it: (destination, position) of
    each member of the round's 32 rows, against the warp's running counts
    `run` [P] (updated). A round with a row of every destination (`aa`)
    takes a ballot a destination; else the lanes of one destination are
    its peers (__match_any_sync)."""
    lanes = np.arange(32)
    out = []
    if not aa.any():
        sent = dd < P
        peers = (dd[:, None] == dd[None, :]) & (lanes[None, :] < lanes[:, None])
        pos = run[np.minimum(dd, P - 1)] + peers.sum(1)
        out = [(int(q), int(p), int(j)) for j, (q, p) in enumerate(zip(dd, pos)) if sent[j]]
        np.add.at(run, dd[sent], 1)
        return out
    for q in range(P):
        member = (dd == q) | aa
        if not member.any():
            continue
        pos = run[q] + np.cumsum(member) - 1
        out += [(q, int(pos[j]), int(j)) for j in np.flatnonzero(member)]
        run[q] += int(member.sum())
    return out


def dest_pack_replay(h, mask, P, send_cap, heavy=None, rank=0, rep=None, to_all=False):
    """(grid, counts, dropped) as K18's launches write them: tiles of TILE
    rows, each warp ROUNDS rounds of 32 consecutive rows ranked twice
    (counts, then positions from the tile's prefix, carried tile to tile as
    the look-back carries it per destination), the members below send_cap
    written, then the zeros past each destination's members; raises unless
    every grid entry is written exactly once."""
    cap = len(h)
    hh = h.astype(np.int64) & 0xFFFFFFFF
    d = ((hh >> 16) * P) >> 16
    all_ = mask & rep if rep is not None else np.zeros(cap, bool)
    if heavy is not None:
        hv = mask & heavy[hh >> 24]
        if to_all:
            all_ = all_ | hv
        else:
            d = np.where(hv, rank, d)
    d = np.where(mask, d, P)
    grid = np.zeros((P, send_cap), np.int64)
    writes = np.zeros((P, send_cap), np.int64)
    carried = np.zeros(P, np.int64)     # per destination, the tiles before
    for f in range(0, cap, k18.TILE):
        run = np.zeros((8, P), np.int64)
        rounds = []
        for w in range(8):
            for k in range(k18.ROUNDS):
                rows = f + w * k18.ROUNDS * 32 + k * 32 + np.arange(32)
                inside = rows < cap
                at = np.minimum(rows, cap - 1)
                rounds.append((w, rows, np.where(inside, d[at], P), inside & all_[at]))
        for w, _, dd, aa in rounds:                   # counts
            _round_ranks(run[w], dd, aa, P)
        tile = run.sum(0)
        run = np.cumsum(run, 0) - run + carried       # each warp's first positions
        carried += tile
        for w, rows, dd, aa in rounds:                # positions
            for q, pos, j in _round_ranks(run[w], dd, aa, P):
                if pos < send_cap:
                    grid[q, pos] = rows[j]
                    writes[q, pos] += 1
    for q in range(P):                                # the tail
        writes[q, min(carried[q], send_cap):] += 1
    assert (writes == 1).all(), f"grid entries written {writes.min()}-{writes.max()} times"
    return grid, carried, int(np.maximum(carried - send_cap, 0).sum())


@pytest.mark.parametrize("case", K18_CASES)
def test_dest_pack_replay_matches_plain(case):
    """K18's one pass and tail give dest_pack_plain's grid, counts and
    dropped on its edge cases (at the host's size), each grid entry written
    once."""
    h, mask, P, send_cap, heavy, rank, rep, to_all = chip_smoke.k18_edge(case, on_card=False)
    got = dest_pack_replay(h, mask, P, send_cap, heavy, rank, rep, to_all)
    on = (lambda a: None if a is None else torch.from_numpy(a))
    want = k18.dest_pack_plain(torch.from_numpy(h.view(np.int32)), on(mask), P, send_cap,
                               on(heavy), rank, on(rep), to_all)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


@pytest.mark.parametrize("cap, P, tiles, nbytes", [
    (0, 1, 0, 8), (1, 8, 1, 72), (2048, 8, 1, 72), (2049, 8, 2, 136),
    (8_388_608, 8, 4096, 8 * 32769), (1 << 20, 1024, 512, 8 * (512 * 1024 + 1))])
def test_dest_pack_scratch_layout(cap, P, tiles, nbytes):
    """A look-back status word a tile and destination, then the tile
    counter."""
    assert k18.pack_tiles(cap) == tiles
    assert k18.scratch_bytes(cap, P) == nbytes


@pytest.fixture
def stub_launch(monkeypatch):
    """_build's device checks pass, its C entry points record their
    arguments and succeed; the device has 132 SMs."""
    calls = []

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    class Limits:
        sms = 132
    monkeypatch.setattr(_build, "require", _require_on_any_device)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(_build, "device_limits", lambda dev: Limits)
    return calls


def test_dest_pack_launch_plan(stub_launch):
    """The launch hands the kernel cap, P, send_cap, the grid, scratch_bytes
    of (cap, P) and the SM count, in the C entry's order."""
    cap, P, send_cap = 5000, 8, 700
    h, m = torch.zeros(cap, dtype=torch.int32), torch.ones(cap, dtype=torch.bool)
    grid, counts, dropped = k18._launch(h, m, P, send_cap, None, 0, None, False)
    (name, args), = stub_launch
    assert name == "dfp_dest_pack" and args[2:4] == (cap, P) and args[8] == send_cap
    assert args[4] is None and args[7] is None and args[6] == 0
    assert args[9] == grid.data_ptr() and args[10] == counts.data_ptr()
    assert args[13] == k18.scratch_bytes(cap, P) and args[14] == 132
    assert grid.shape == (P, send_cap) and counts.shape == (P,) and dropped.shape == ()


@pytest.mark.parametrize("bad", [dict(P=0), dict(P=1025), dict(send_cap=-1)],
                         ids=["P = 0", "P = 1025", "a negative send_cap"])
def test_dest_pack_refuses_before_a_launch(stub_launch, bad):
    args = dict(hashes=torch.zeros(10, dtype=torch.int32), mask=torch.ones(10, dtype=torch.bool),
                P=8, send_cap=16, heavy=None, rank=0, replicate=None, heavy_to_all=False)
    args.update(bad)
    with pytest.raises(ValueError):
        k18._launch(*args.values())
    assert stub_launch == []


@pytest.mark.parametrize("name", ["dfp_dest_pack_plan"])
def test_dest_pack_compiled_plan_reads_the_plan_entry(monkeypatch, name):
    values = [getattr(k18, n) for n in k18.PLAN]
    monkeypatch.setattr(_build, "function",
                        lambda n, a, r=None: (lambda i: values[i] if 0 <= i < len(values) else -1))
    assert k18.compiled_plan() == {n: getattr(k18, n) for n in k18.PLAN}
