"""K10 match_flags and K19 key_histogram: their plain versions against the
JAX code they replace (ops/join.py's visited / probe_matched scatter-sets,
parallel/skew.py `key_histogram`) with inputs made from a numpy seed, the
tolerance exact; Python replays of the two kernels' slot and row
partitions against the plain versions; the wrappers' host-side checks;
`hash_join` asking K10 for exactly the flags its join type reads; and the
salted step's probe shuffle from hashes made once, equal to JAX's."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from datafusion_parallelism_tpu.parallel import make_mesh as jmake_mesh
from datafusion_parallelism_tpu.parallel import shuffle as jshuffle
from datafusion_parallelism_tpu.parallel import skew as jskew
from datafusion_parallelism_tpu.utils.columnar import HostTable as JHostTable

from datafusion_parallelism_tpu_torch import parallel as tpar
from datafusion_parallelism_tpu_torch.kernels import _build
from datafusion_parallelism_tpu_torch.kernels import key_histogram as k19
from datafusion_parallelism_tpu_torch.kernels import match_flags as k10
from datafusion_parallelism_tpu_torch.ops import join as tjoin
from datafusion_parallelism_tpu_torch.ops.join import JoinType
from datafusion_parallelism_tpu_torch.parallel import shuffle as tshuffle
from datafusion_parallelism_tpu_torch.parallel import skew as tskew
from datafusion_parallelism_tpu_torch.utils.columnar import HostTable
from datafusion_parallelism_tpu_torch.utils.convert import shards_from_reference

N_DEV = 8
FLAGS = {"visited": (True, False), "probe": (False, True), "both": (True, True)}


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

def _k10_inputs(rng, n, total, bcap=700, mcap=900, junk_past_total=False):
    """(match, build_id, probe_idx) as K3 lays them out: candidates below
    min(total, n), a probe row's together in probe order, 60% matches,
    repeated build rows; past the total match False and ids 0 (or, with
    junk_past_total, random values the total must hide)."""
    k = max(0, min(total, n))
    match = np.zeros(n, bool)
    bid = np.zeros(n, np.int32)
    pidx = np.zeros(n, np.int32)
    match[:k] = rng.random(k) < 0.6
    bid[:k] = rng.integers(0, bcap, k)
    pidx[:k] = np.sort(rng.integers(0, mcap, k))
    if junk_past_total:
        match[k:] = rng.random(n - k) < 0.5
        bid[k:] = rng.integers(0, bcap, n - k)
        pidx[k:] = rng.integers(0, mcap, n - k)
    return match, bid, pidx


def _jax_flags(match, bid, pidx, total, bcap, mcap):
    """ops/join.py:363-368 of the JAX package over the slots below the
    total (K3 leaves every slot past it False)."""
    hit = jnp.asarray(match & (np.arange(match.shape[0]) < total))
    jv = jnp.zeros((bcap,), jnp.bool_).at[jnp.where(hit, bid, bcap)].set(True, mode="drop")
    jm = jnp.zeros((mcap,), jnp.bool_).at[jnp.where(hit, pidx, mcap)].set(True, mode="drop")
    return np.asarray(jv), np.asarray(jm)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("n,total", [(5000, 0), (5000, 3100), (5000, 5000), (5000, 7777),
                                     (1, 1), (0, 0), (37, 20)])
def test_match_flags_plain_equals_jax(flags, n, total):
    """Each flag selection at total 0, below n, equal to n and past n
    (clamped), n = 0 and 1; an unasked flag is None."""
    rng = np.random.default_rng(n + total)
    bcap, mcap = 700, 900
    match, bid, pidx = _k10_inputs(rng, n, total, bcap, mcap, junk_past_total=True)
    want_v, want_m = _jax_flags(match, bid, pidx, total, bcap, mcap)
    asked = FLAGS[flags]
    v, m = k10.match_flags(torch.from_numpy(match), torch.from_numpy(bid),
                           torch.from_numpy(pidx), bcap if asked[0] else None,
                           mcap if asked[1] else None,
                           total=torch.tensor(total, dtype=torch.int32))
    assert (v is None) != asked[0] and (m is None) != asked[1]
    if asked[0]:
        np.testing.assert_array_equal(v.numpy(), want_v)
    if asked[1]:
        np.testing.assert_array_equal(m.numpy(), want_m)


@pytest.mark.parametrize("total", [0, 2500, 9000])
@pytest.mark.parametrize("with_probe", [False, True])
def test_match_flags_accumulate_equals_jax_or(total, with_probe):
    """A given visited buffer keeps its flags and ORs the matches below the
    total in place (JAX's `incoming | vis`), twice with the same bits."""
    rng = np.random.default_rng(total + 3)
    n, bcap, mcap = 6000, 500, 800
    match, bid, pidx = _k10_inputs(rng, n, total, bcap, mcap, junk_past_total=True)
    incoming = rng.random(bcap) < 0.2
    want_v, want_m = _jax_flags(match, bid, pidx, total, bcap, mcap)
    buf = torch.from_numpy(incoming.copy())
    args = (torch.from_numpy(match), torch.from_numpy(bid), torch.from_numpy(pidx), bcap,
            mcap if with_probe else None, buf, torch.tensor(total, dtype=torch.int32))
    v, m = k10.match_flags(*args)
    assert v is buf
    np.testing.assert_array_equal(v.numpy(), incoming | want_v)
    if with_probe:
        np.testing.assert_array_equal(m.numpy(), want_m)
    else:
        assert m is None
    k10.match_flags(*args)
    np.testing.assert_array_equal(buf.numpy(), incoming | want_v)


def k10_replay(match, bid, pidx, total, bcap, mcap, head, threads=96):
    """csrc/match_flags.cu's two walks in numpy. The visited flags alone:
    the head and the tail one slot a thread of block 0, then a 16-slot
    chunk a thread (`threads` of them a round), skipped when its 16 match
    bytes are 0. The probe flags asked: a slot a thread, a lane whose
    probe id equals its left neighbour's (in a warp of 32) storing no
    probe flag. Both: a visited flag read first where the candidates are
    CHECK_RATIO or more times bcap. Returns (visited, probe_matched,
    stores into each)."""
    n = match.shape[0]
    k = n if total is None else max(0, min(int(total), n))
    vis = np.zeros(bcap, bool) if bcap is not None else None
    pm = np.zeros(mcap, bool) if mcap is not None else None
    check = bcap is not None and k >= 4 * bcap
    stores = [0, 0]

    def set_visited(j):
        if 0 <= bid[j] < bcap and not (check and vis[bid[j]]):
            vis[bid[j]] = True
            stores[0] += 1

    if pm is None:
        chunks = (k - head) // 16 if k > head else 0
        for t in range(32):                      # block 0's first 32 threads
            j = t if t < 16 else head + chunks * 16 + t - 16
            if ((j < head and j < k) if t < 16 else j < k) and match[j]:
                set_visited(j)
        for c in range(chunks):
            s0 = head + 16 * c
            if not match[s0:s0 + 16].any():
                continue
            for j in range(s0, s0 + 16):
                if match[j]:
                    set_visited(j)
        return vis, pm, stores
    for j in range(k):
        if not match[j]:
            continue
        if vis is not None:
            set_visited(j)
        left = pidx[j - 1] if j % 32 and match[j - 1] else -1
        if j % 32 == 0 or pidx[j] != left:
            if 0 <= pidx[j] < mcap:
                pm[pidx[j]] = True
                stores[1] += 1
    return vis, pm, stores


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("n,total,head", [(5000, 4000, 0), (5000, 4000, 7), (5003, 9999, 15),
                                          (17, 17, 15), (10, 10, 12), (3000, 0, 3),
                                          (40, 33, 1), (3000, 3000, 0)])
def test_match_flags_replay_equals_plain(flags, n, total, head):
    """The kernel's walks (head, 16-slot chunks and tail for the visited
    flags alone; a slot a thread with the left-neighbour probe dedup
    otherwise; the visited flag read first past CHECK_RATIO candidates a
    build row) set the same flags as the plain version, at heads 0-15 and
    totals inside, at and past n; the probe dedup stores a probe row's
    run once a warp."""
    rng = np.random.default_rng(n * 7 + head)
    bcap, mcap = (300, 400) if n != 3000 or total else (100, 400)
    match, bid, pidx = _k10_inputs(rng, n, total, bcap, mcap)
    asked = FLAGS[flags]
    head = min(head, n)
    bcap_a, mcap_a = bcap if asked[0] else None, mcap if asked[1] else None
    vis, pm, stores = k10_replay(match, bid, pidx, total, bcap_a, mcap_a, head)
    v, m = k10.match_flags_plain(torch.from_numpy(match), torch.from_numpy(bid),
                                 torch.from_numpy(pidx), bcap_a, mcap_a,
                                 total=torch.tensor(total, dtype=torch.int32))
    k = max(0, min(total, n))
    if asked[0]:
        np.testing.assert_array_equal(vis, v.numpy())
        assert stores[0] <= int(match[:k].sum())
        if k < 4 * bcap:          # no read first: a store a match
            assert stores[0] == int(match[:k].sum())
    if asked[1]:
        np.testing.assert_array_equal(pm, m.numpy())
        assert stores[1] <= int(match[:k].sum())


def _require_on_any_device(t, name, dtype, shape=None, device=None, contiguous=True):
    """_build.require without its CUDA-tensor check, for CPU tensors."""
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def test_match_flags_wrapper_checks(monkeypatch):
    """What K10's wrapper refuses before a launch (its checks on CPU
    tensors): no flag asked, capacities out of range, a visited buffer
    without bcap or of another shape, a total not int32 0-dim, and asked
    ids not 16-byte aligned where the match is; the head that brings the
    match to a 16-byte boundary."""
    monkeypatch.setattr(_build, "require", _require_on_any_device)
    base_m = torch.zeros(4096, dtype=torch.bool)
    base_i = torch.zeros(4096, dtype=torch.int32)
    m, b, p = base_m[:1000], base_i[:1000], base_i[:1000]
    t32 = torch.tensor(5, dtype=torch.int32)
    head0 = -m.data_ptr() % 16
    assert k10.check_args(m, b, p, 10, 20, None, t32) == (1000, head0)
    # the same offset into all three: aligned where the match is
    off = 16 - head0 + 3
    m3, b3 = base_m[off:off + 500], base_i[off:off + 500]
    n, head = k10.check_args(m3, b3, b3, 10, 20)
    assert n == 500 and (m3.data_ptr() + head) % 16 == 0 and (b3.data_ptr() + 4 * head) % 16 == 0
    bad_ids = base_i[off + 1:off + 501]
    with pytest.raises(ValueError, match="aligned"):   # the visited flags alone: 16-byte loads
        k10.check_args(m3, bad_ids, b3, 10, None)
    for bad in [(bad_ids, b3, 10, 20), (b3, bad_ids, None, 20), (bad_ids, bad_ids, 10, 20),
                (bad_ids, b3, None, 20)]:                # a slot a thread: any alignment
        assert k10.check_args(m3, *bad)[0] == 500
    for bad in [dict(bcap=None, mcap=None), dict(bcap=0), dict(mcap=2**31),
                dict(bcap=None, visited=torch.zeros(10, dtype=torch.bool)),
                dict(visited=torch.zeros(11, dtype=torch.bool)),
                dict(total=torch.tensor([5], dtype=torch.int32)), dict(build_id=b[:999])]:
        args = dict(match=m, build_id=b, probe_idx=p, bcap=10, mcap=20, visited=None,
                    total=t32)
        args.update(bad)
        with pytest.raises(ValueError):
            k10.check_args(**args)
    with pytest.raises(TypeError):
        k10.check_args(m, b, p, 10, 20, None, t32.long())
    with pytest.raises(TypeError):
        k10.check_args(m, b.long(), p, 10, 20)
    with pytest.raises(ValueError):
        k10.check_args(m, b, p, 10, 20, None, torch.tensor(5, dtype=torch.int32,
                                                           device="meta"))


def _recording_join_kernels(record):
    def match_flags(*args):
        record.append((args[3] is not None, args[4] is not None, args[5] is not None,
                       args[6] is not None))
        return k10.match_flags_plain(*args)
    return tjoin.KERNELS._replace(match_flags=match_flags)


READS = {JoinType.INNER: None, JoinType.LEFT: (True, False), JoinType.RIGHT: (False, True),
         JoinType.FULL: (True, True), JoinType.LEFT_SEMI: (True, False),
         JoinType.LEFT_ANTI: (True, False), JoinType.RIGHT_SEMI: (False, True),
         JoinType.RIGHT_ANTI: (False, True)}


@pytest.mark.parametrize("join_type", list(JoinType))
@pytest.mark.parametrize("return_visited", [False, True])
def test_hash_join_asks_only_the_flags_it_reads(join_type, return_visited):
    """hash_join calls K10 with the flags its join type reads (and the
    visited flags when it returns them), always with the candidate total;
    INNER without return_visited does not call it."""
    rng = np.random.default_rng(5)
    b = HostTable.from_numpy({"bk": rng.integers(0, 40, 300).astype(np.int32)})
    p = HostTable.from_numpy({"pk": rng.integers(0, 40, 200).astype(np.int32)})
    b, p = b.to_device(512, device="cpu"), p.to_device(256, device="cpu")
    record = []
    kw = dict(return_visited=True) if return_visited else {}
    tjoin.hash_join(b, p, ["bk"], ["pk"], join_type, 4096,
                    kernels=_recording_join_kernels(record), **kw)
    want = READS[join_type]
    if return_visited:
        want = (True, bool(want and want[1]))
    if want is None:
        assert record == []
    else:
        assert record == [want + (False, True)]


# ---------------------------------------------------------------------------
# K19
# ---------------------------------------------------------------------------

def _jax_local_hist(h, mask):
    """parallel/skew.py:49-58's local histogram of one shard (the psum over
    a one-device mesh is the shard's own), from its hashes and mask."""
    mesh = jmake_mesh(1, platform="cpu")
    axis = mesh.axis_names[0]
    b = jnp.where(jnp.asarray(mask), jskew.bucket_of(jnp.asarray(h.view(np.uint32))),
                  jskew.HIST_SIZE)

    @partial(jax.shard_map, mesh=mesh, in_specs=(), out_specs=JP())
    def hist():
        local = jnp.zeros((jskew.HIST_SIZE,), jnp.int32).at[b].add(1, mode="drop")
        return jax.lax.psum(local, axis)
    return np.asarray(jax.jit(hist)())


def _k19_shards(rng, S, cap, skew, with_valid, empty=False):
    """Per shard (hashes int32 [cap] as uint32 bits, rows, validity or
    None): rows below cap; skew 1 or 4 puts every hash in that many
    buckets; the last shard empty where asked."""
    out = []
    for k in range(S):
        h = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
        if skew:
            h = (rng.integers(0, skew, cap).astype(np.uint64) * 61 + 3) << 24 | (h & 0xFFFFFF)
        rows = int(rng.integers(cap // 2, cap + 1)) if k % 3 else cap
        if empty and k == S - 1:
            rows = 0
        valid = rng.random(cap) > 0.1 if with_valid else None
        out.append((h.astype(np.uint32).view(np.int32), rows, valid))
    return out


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("skew", [0, 1, 4])
def test_key_histogram_plain_equals_jax(S, with_valid, skew):
    """[S, 256], row k == JAX's local histogram of shard k over its row
    mask (num_rows below the capacity on most shards, the validity where
    given), uniform and skewed hashes; an empty shard where S = 8."""
    rng = np.random.default_rng(S * 10 + skew + with_valid)
    shards = _k19_shards(rng, S, 1000, skew, with_valid, empty=S == 8)
    got = k19.key_histogram(
        [torch.from_numpy(h.copy()) for h, _, _ in shards],
        [torch.tensor(r, dtype=torch.int32) for _, r, _ in shards],
        [None if v is None else torch.from_numpy(v) for _, _, v in shards])
    assert got.shape == (S, 256) and got.dtype == torch.int32
    for k, (h, rows, v) in enumerate(shards):
        mask = np.arange(h.shape[0]) < rows
        if v is not None:
            mask &= v
        np.testing.assert_array_equal(got[k].numpy(), _jax_local_hist(h, mask))


def k19_rows_replay(n, aligned, csize=4, threads=64, unroll=4):
    """The rows each (block rank, thread) of a shard's cluster takes in
    csrc/key_histogram.cu: quads of 4 rows by 16-byte loads, `unroll` a
    thread a round, strided over the cluster's threads, then the rows past
    the last whole quad (or every row of an unaligned shard) one a
    thread. Returns the count of visits of each row below n."""
    seen = np.zeros(n, np.int64)
    span = csize * threads
    for t in range(span):                    # rank * threads + thread
        scalar_from = 0
        if aligned:
            quads = n // 4
            for base in range(t, quads, span * unroll):
                for u in range(unroll):
                    q = base + u * span
                    if q < quads:
                        seen[4 * q:4 * q + 4] += 1
            scalar_from = quads * 4
        for i in range(scalar_from + t, n, span):
            seen[i] += 1
    return seen


@pytest.mark.parametrize("n", [0, 1, 3, 4, 255, 256, 1023, 1024, 1025, 5000, 8191])
@pytest.mark.parametrize("aligned", [True, False])
def test_key_histogram_replay_counts_each_row_once(n, aligned):
    """Every row below the row count is counted exactly once by the
    kernel's loops, with whole quads and a ragged tail, aligned or not."""
    assert (k19_rows_replay(n, aligned) == 1).all()


def test_key_histogram_plan():
    """The wrapper's copy of the kernel's plan: a cluster of CLUSTER blocks
    of THREADS threads a shard, MAX_SHARDS descriptors in SPEC_WORDS
    int64 words (csrc/key_histogram.cu's Spec: n and its padding, then
    four words a shard), whose compiled values phase 2i of chip_smoke.py
    holds against these."""
    assert k19.PLAN == ("BINS", "THREADS", "CLUSTER", "MAX_SHARDS")
    assert (k19.BINS, k19.THREADS, k19.CLUSTER, k19.MAX_SHARDS) == (256, 512, 16, 64)
    assert k19.SPEC_WORDS == 1 + 4 * k19.MAX_SHARDS


def test_key_histogram_wrapper_checks(monkeypatch):
    """What K19's wrapper refuses before a launch: no shard or more than
    MAX_SHARDS, lists of unequal length, a row count not int32 0-dim, a
    validity of another shape or type, a capacity of 2^31 rows."""
    monkeypatch.setattr(_build, "require", _require_on_any_device)
    h = torch.zeros(100, dtype=torch.int32)
    n = torch.tensor(60, dtype=torch.int32)
    v = torch.ones(100, dtype=torch.bool)
    assert k19.check_args([h] * 64, [n] * 64, None) == 64
    assert k19.check_args([h, h], [n, n], [v, None]) == 2
    for args in [([], [], None), ([h] * 65, [n] * 65, None), ([h, h], [n], None),
                 ([h], [n], [v, v]), ([h], [n.reshape(1)], None), ([h], [n], [v[:99]]),
                 ([torch.empty(2**31, dtype=torch.int32, device="meta")], [n], None)]:
        with pytest.raises(ValueError):
            k19.check_args(*args)
    with pytest.raises(TypeError):
        k19.check_args([h], [n.long()], None)
    with pytest.raises(TypeError):
        k19.check_args([h], [n], [v.to(torch.uint8)])


# ---------------------------------------------------------------------------
# the salted step: one hash a probe shard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(N_DEV, platform="cpu")


@pytest.fixture(scope="module")
def ex():
    return tpar.make_mesh(N_DEV, "cpu")


@pytest.mark.parametrize("send_cap", [48, 512])
def test_salted_probe_shuffle_from_hashes_made_once(jmesh, ex, send_cap):
    """The salted step's histogram and probe shuffle from the probe hashes
    made once (`hashes=`) == JAX's key_histogram and salted
    shuffle_by_hash, shard for shard, and == the port's own from hashes
    made inside; a late-materialization mask on the histogram."""
    rng = np.random.default_rng(send_cap)
    n = 900
    x = rng.random(n)
    keys = (60 * (16.0 ** x - 1) / 15.0).astype(np.int32)
    t = JHostTable.from_numpy({"k": keys, "v": rng.integers(-9, 9, n).astype(np.int64)},
                              validity={"k": rng.random(n) > 0.05})
    cols, num, schema, cap = jshuffle.partition_table(t, N_DEV)
    late = rng.random((N_DEV, cap)) > 0.2
    axis = jmesh.axis_names[0]

    @partial(jax.shard_map, mesh=jmesh, in_specs=(JP(axis), JP(axis)),
             out_specs=(JP(), JP(), JP(axis), JP(axis), JP()))
    def step(cols, num):
        lt = jshuffle.local_table(schema, cols, num)
        me = jax.lax.axis_index(axis)
        hist_late = jskew.key_histogram(lt, ["k"], axis, valid=jnp.asarray(late)[me])
        hist = jskew.key_histogram(lt, ["k"], axis)
        heavy = jskew.heavy_buckets(hist)
        dest, _ = jskew.salted_route(lt, ["k"], heavy, axis)
        out, dropped = jshuffle.shuffle_by_hash(lt, ["k"], send_cap, axis, dest_override=dest)
        ocols, onum = jshuffle.unlocal_table(out)
        return hist_late, hist, ocols, onum, dropped

    jhist_late, jhist, jcols, jnum, jdropped = jax.jit(step)(cols, num)
    shards = shards_from_reference(cols, num, schema, device="cpu")
    hashes = [tshuffle._hashes(s, ["k"]) for s in shards]
    hist = tskew.key_histogram(ex, shards, ["k"], hashes=hashes)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    late_t = [torch.from_numpy(late[p]) for p in range(N_DEV)]
    np.testing.assert_array_equal(
        tskew.key_histogram(ex, shards, ["k"], late_t, hashes=hashes).numpy(),
        np.asarray(jhist_late))
    heavy = tskew.heavy_buckets(hist)
    assert heavy.any()
    out, dropped = tshuffle.shuffle_by_hash(ex, shards, ["k"], send_cap, heavy=heavy,
                                            hashes=hashes)
    inside, dropped_inside = tshuffle.shuffle_by_hash(ex, shards, ["k"], send_cap, heavy=heavy)
    assert int(dropped) == int(jdropped) == int(dropped_inside)
    jnum = np.asarray(jnum)
    assert [int(s.num_rows) for s in out] == jnum.tolist()
    for p, (s, s2) in enumerate(zip(out, inside)):
        k = int(jnum[p])
        for name, (v, valid) in s.columns.items():
            jv, jvalid = (np.asarray(a)[p][:k] for a in jcols[name])
            np.testing.assert_array_equal(valid[:k].numpy(), jvalid)
            np.testing.assert_array_equal(np.where(jvalid, v[:k].numpy(), 0),
                                          np.where(jvalid, jv, 0))
            np.testing.assert_array_equal(v.numpy(), s2.columns[name][0].numpy())
            np.testing.assert_array_equal(valid.numpy(), s2.columns[name][1].numpy())


def test_salted_join_step_hashes_each_probe_shard_once(ex, monkeypatch):
    """dist_join_shard's salted branch hashes each probe shard once (K1 a
    shard, for the histogram and the shuffle both) and each build shard
    once, and its rows equal the partitioned mode's."""
    from datafusion_parallelism_tpu_torch.parallel import distributed as tdist
    rng = np.random.default_rng(9)
    x = rng.random(600)
    build = HostTable.from_numpy({"b_key": rng.integers(0, 40, 300).astype(np.int32)})
    probe = HostTable.from_numpy({"p_key": (40 * (16.0 ** x - 1) / 15.0).astype(np.int32)})
    calls = []
    real = tshuffle._hashes

    def counting(t, keys):
        calls.append(tuple(keys))
        return real(t, keys)
    monkeypatch.setattr(tshuffle, "_hashes", counting)
    monkeypatch.setattr(tdist, "_hashes", counting)
    monkeypatch.setattr(tskew, "_hashes", counting)
    bcols, bnum, bschema, _ = tshuffle.partition_table(build, N_DEV)
    pcols, pnum, pschema, _ = tshuffle.partition_table(probe, N_DEV)
    builds = tshuffle.local_shards(ex, bschema, bcols, bnum)
    probes = tshuffle.local_shards(ex, pschema, pcols, pnum)
    cfg = tpar.DistJoinConfig(mode="skew_salted", build_send_cap=4096, probe_send_cap=4096)
    outs, total, dropped = tdist.dist_join_shard(ex, builds, probes, ["b_key"], ["p_key"], cfg)
    assert calls.count(("p_key",)) == N_DEV and calls.count(("b_key",)) == N_DEV
    assert int(dropped) == 0
    rows = sum(int(o.num_rows) for o in outs)
    res, _ = tpar.distributed_hash_join(ex, build, probe, ["b_key"], ["p_key"],
                                        tpar.DistJoinConfig(mode="partitioned"))
    assert rows == res.num_rows
