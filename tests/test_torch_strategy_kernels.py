"""K14 sorted_probe, K15 oa_place and K16 oa_probe on the host: their CUDA
designs replayed in numpy from their launch plans, against the plain
versions and the JAX package's `probe_candidates` (SORT), `build_oa` and
`_probe_oa`, bit for bit.

K14's replay builds the bucket directory as csrc/sorted_probe.cu does
(each fill tile's first key by a search; the entries a tile's keys start,
or, past DIR_SCAN_KEYS keys, a search or gallop an entry), then finds each
probe row's bounds inside its bucket (read whole up to BUCKET_SCAN keys,
else a binary search, RUN_SCAN keys read on and a second search) and takes
the bases tile by tile. K15's replay counts the valid rows, carries the
displacement as a max of home - i + cap (home computed from the hash)
through tiles of PLACE_ITEMS-row threads,
writes each tile's slot span in SPAN_CHUNK chunks and the tail past the
last row, and checks that every slot is written exactly once. K16's
replay walks every ok probe row from its home, slot_of(hash, T): its
first THREAD_SLOTS slots on its own thread, the rest by its warp, 64 slots a read
settled by ballots, clamped at slot S - 1 as the JAX loop; then the bases
tile by tile. Also the launch plans
(directory bits, tiles, scratch bytes) and the wrappers' host checks with
the launchers stubbed."""

import ctypes

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu_torch.kernels import _build
from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
from datafusion_parallelism_tpu_torch.ops import hash_table as tht

INVALID = np.int64(1) << 33       # the SORT table's key of null keys and padding

# ---------------------------------------------------------------------------
# the replays
# ---------------------------------------------------------------------------


def _entry_of(keys: np.ndarray, bits: int) -> np.ndarray:
    """The directory entry each key starts: -1 below 0, its top bits, 2^bits
    from 2^32 on."""
    return np.where(keys < 0, -1, np.minimum(keys >> (32 - bits), 1 << bits))


def directory_replay(keys: np.ndarray, bits: int) -> np.ndarray:
    """dir int64[2^bits + 1] as the bounds and fill launches write it."""
    top = 1 << bits
    tiles = k14.directory_tiles(bits)
    entries = np.minimum(np.arange(tiles + 1, dtype=np.int64) * k14.DIR_TILE, top)
    thresholds = entries << (32 - bits)
    first = np.searchsorted(keys, thresholds, side="left")
    out = np.full(top + 1, -1, np.int64)
    for t in range(tiles):
        k0, lo, hi = t * k14.DIR_TILE, first[t], first[t + 1]
        if hi - lo <= k14.DIR_SCAN_KEYS:
            d = np.full(k14.DIR_TILE, hi, np.int64)
            e = _entry_of(keys[lo:hi], bits)
            before = np.concatenate([[k0 - 1], e[:-1]])
            assert ((e >= k0) & (e < k0 + k14.DIR_TILE)).all()
            for i in np.flatnonzero(e > before):    # key lo + i starts entries (before, e]
                d[before[i] + 1 - k0:e[i] + 1 - k0] = lo + i
        else:       # a hot tile: each entry's first key at or past it
            entries = k0 + np.arange(k14.DIR_TILE, dtype=np.int64)
            d = lo + np.searchsorted(keys[lo:hi], entries << (32 - bits), side="left")
        n = min(k14.DIR_TILE, top + 1 - k0)
        out[k0:k0 + n] = d[:n]
    assert (out >= 0).all()      # every entry written
    return out


def _bucket_bounds(keys: np.ndarray, lo: int, hi: int, key: int):
    bucket = keys[lo:hi]
    if hi - lo <= k14.BUCKET_SCAN:      # read whole
        return lo + int((bucket < key).sum()), lo + int((bucket <= key).sum())
    s = lo + int(np.searchsorted(bucket, key, side="left"))
    e = s
    stop = min(s + k14.RUN_SCAN, hi)
    while e < stop and keys[e] == key:
        e += 1
    if e == stop and stop < hi:         # a long run
        e += int(np.searchsorted(keys[e:hi], key, side="right"))
    return s, e


def sorted_probe_replay(hashes: np.ndarray, ok: np.ndarray, keys: np.ndarray,
                        bits: int = None):
    """(start, count, base, total) as K14's launches compute them."""
    bits = k14.directory_bits(len(keys)) if bits is None else bits
    d = directory_replay(keys, bits)
    h = hashes.astype(np.uint32).astype(np.int64)
    b = h >> (32 - bits)
    lo, hi = d[b], d[b + 1]
    bounds = [_bucket_bounds(keys, int(lo[i]), int(hi[i]), int(h[i])) for i in range(len(h))]
    start = np.array([s for s, _ in bounds], np.int64)
    count = np.where(ok, np.array([e - s for s, e in bounds], np.int64), 0)
    base = np.empty_like(count)
    carried = 0                          # the look-back's exclusive prefix
    for f in range(0, len(h), k14.PROBE_TILE):
        c = count[f:f + k14.PROBE_TILE]
        base[f:f + len(c)] = carried + np.concatenate([[0], np.cumsum(c)[:-1]])
        carried += int(c.sum())
    return start, count, base, carried


def oa_place_replay(order: np.ndarray, home: np.ndarray, hashes: np.ndarray, ok: np.ndarray,
                    S: int):
    """(slots, perm) as K15's launches write them; raises unless every slot
    is written exactly once."""
    cap = len(order)
    T = k15.home_slots(S)
    # the kernel's home: slot_of(hash, T), which the callers pass as `home`
    h64 = hashes.astype(np.int64) & 0xFFFFFFFF
    own_home = h64 & (T - 1) if T & (T - 1) == 0 else (h64 * T) >> 32
    np.testing.assert_array_equal(own_home[ok], home[ok])
    L = int(ok.sum())                    # the count launch
    slots = np.zeros(S, np.int64)
    perm = np.zeros(S, np.int64)
    writes = np.zeros(S, np.int64)
    tail_at, excl = 0, 0                 # 0: the max's identity (home - i + cap >= 1)
    for f in range(0, L, k15.PLACE_TILE):
        rows = np.arange(f, min(f + k15.PLACE_TILE, L))
        o = order[rows]
        v = own_home[o] - rows + cap
        # thread t takes rows f + 16 t .. +16: its running max, then the
        # block's exclusive max over the threads' maxima
        threads = (rows - f) // k15.PLACE_ITEMS
        inc = np.empty_like(v)
        agg = np.zeros(threads.max() + 1, np.int64)
        for t in range(len(agg)):
            mine = threads == t
            inc[mine] = np.maximum.accumulate(v[mine])
            agg[t] = inc[mine][-1]
        before = np.maximum(np.concatenate([[0], np.maximum.accumulate(agg)[:-1]]), excl)
        pos = rows + np.maximum(inc, before[threads]) - cap
        a = 0 if f == 0 else f + excl - cap
        e = min(int(pos[-1]), S - 1)
        val = (hashes[o].astype(np.int64) & 0xFFFFFFFF) << 32 | (o.astype(np.int64) + 1)
        c0 = a - a % k15.SPAN_CHUNK
        while c0 <= e:                   # a chunk: zeros, the rows in it, then out
            sl = np.zeros(k15.SPAN_CHUNK, np.int64)
            pm = np.zeros(k15.SPAN_CHUNK, np.int64)
            inside = (pos >= c0) & (pos < c0 + k15.SPAN_CHUNK)
            sl[pos[inside] - c0] = val[inside]
            pm[pos[inside] - c0] = o[inside]
            out = np.arange(c0, c0 + k15.SPAN_CHUNK)
            keep = (out >= a) & (out <= e)
            slots[out[keep]] = sl[keep]
            perm[out[keep]] = pm[keep]
            writes[out[keep]] += 1
            c0 += k15.SPAN_CHUNK
        excl = max(excl, int(agg.max()))
        if rows[-1] == L - 1:
            tail_at = min(int(pos[-1]) + 1, S)
    writes[tail_at:] += 1                # the tail launch
    assert (writes == 1).all(), f"slots written {writes.min()}-{writes.max()} times"
    return slots, perm


def _walk_steps(slots, S, h, home, cur, st, cnt, counting, live, steps):
    """`steps` of the JAX walk on each live row's own thread (the kernel's
    first THREAD_SLOTS slots), from `cur`: a step at slot S - 1 ends the walk,
    counting the steps left (home of them) where it is counting."""
    for _ in range(steps):
        at = np.flatnonzero(live)
        c = cur[at]
        v = slots[c]
        match = (v != 0) & (((v >> 32) & 0xFFFFFFFF) == h[at])
        was = counting[at]
        end = np.where(was, ~match, ~match & (v == 0))
        found = ~was & match
        st[at[found]] = c[found]
        cnt[at] += found | (was & match)
        counting[at] |= found
        last = ~end & (c == S - 1)
        cnt[at[last & counting[at]]] += home[at][last & counting[at]]
        live[at[end | last]] = False
        cur[at] += 1


def _warp_walks(slots, S, h, home, cur, st, cnt, counting, live):
    """The warp's walk of each live row from `cur`, 64 slots a read, two
    halves of 32 lanes each settled by the kernel's ballots: a seek stops
    at the first slot that matches or is empty, a run ends at the first
    in-range slot past its start that does not match; lanes past S - 1
    are out of range."""
    lanes = np.arange(32)
    while live.any():
        for half in (0, 1):
            at = np.flatnonzero(live)
            base = cur[at] + 32 * half
            p = base[:, None] + lanes
            inn = p <= S - 1
            v = np.where(inn, slots[np.minimum(p, S - 1)], 0)
            M = inn & (v != 0) & (((v >> 32) & 0xFFFFFFFF) == h[at][:, None])
            E = inn & (v == 0)
            every = inn.all(1)
            seeking = ~counting[at]
            stop = M | E
            first = np.argmax(stop, 1)
            stopped = stop.any(1)
            lost = seeking & ((~stopped & ~every) | (stopped & ~M[np.arange(len(at)), first]))
            found = seeking & stopped & ~lost
            st[at[found]] = base[found] + first[found]
            cnt[at[found]] = 0
            counting[at[found]] = True
            g0 = np.where(found, first, 0)
            live[at[lost]] = False
            going = counting[at] & ~lost
            ends = ~M & inn & (lanes >= g0[:, None])
            ended = going & ends.any(1)
            cnt[at[ended]] += (np.argmax(ends, 1) - g0)[ended]
            edge = going & ~ends.any(1) & ~every        # the run reaches slot S - 1
            cnt[at[edge]] += (inn.sum(1) - g0 + home[at])[edge]
            on = going & ~ended & ~edge
            cnt[at[on]] += 32 - g0[on]
            live[at[ended | edge]] = False
        cur[live] += 64


def oa_probe_replay(hashes: np.ndarray, ok: np.ndarray, slots: np.ndarray):
    """(start, count, base, total, rows the warps walked on) as K16's
    launch computes them: each ok row's first THREAD_SLOTS slots from its
    home on its own thread, then the warp's 64-slot reads, the bases tile
    by tile."""
    S = len(slots)
    T = k16.home_slots(S)
    h = hashes.astype(np.int64) & 0xFFFFFFFF
    home = h & (T - 1) if T & (T - 1) == 0 else (h * T) >> 32
    rows = np.flatnonzero(ok)
    hr, hm = h[rows], home[rows]
    cur = hm.copy()
    st = np.zeros(len(rows), np.int64)
    cnt = np.zeros(len(rows), np.int64)
    counting = np.zeros(len(rows), bool)
    live = np.ones(len(rows), bool)
    _walk_steps(slots, S, hr, hm, cur, st, cnt, counting, live, k16.THREAD_SLOTS)
    assert (cur[live] == hm[live] + k16.THREAD_SLOTS).all()
    warp = live.copy()
    _warp_walks(slots, S, hr, hm, cur, st, cnt, counting, live)
    start = np.zeros(len(h), np.int64)
    count = np.zeros(len(h), np.int64)
    start[rows] = np.where(counting, st, 0)
    count[rows] = np.where(counting, cnt, 0)
    base = np.empty_like(count)
    carried = 0                          # the look-back's exclusive prefix
    for f in range(0, len(h), k16.PROBE_TILE):
        c = count[f:f + k16.PROBE_TILE]
        base[f:f + len(c)] = carried + np.concatenate([[0], np.cumsum(c)[:-1]])
        carried += int(c.sum())
    return start, count, base, carried, int(warp.sum())


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


CASES = [name for name, *_ in chip_smoke.STRATEGY_EDGES]
# K16's cases: the strategy cases whose walks the plain lockstep loop runs
# in good time (the hot key's 70,000-slot walk takes it a minute on the
# host; phase 2c runs it on the card), and K16's own
K16_CASES = ([c for c in CASES if c not in chip_smoke.K16_LONG_WALKS
              and c != "a hot key past a fill tile's scan (70,000 rows)"]
             + [f"K16: {name}" for name, *_ in chip_smoke.K16_EDGES])


def _case(case):
    """(build hashes uint32[cap], ok bool[cap], probe hashes uint32[m],
    probe ok bool[m]): chip_smoke's edge case at the host's size."""
    return chip_smoke.strategy_edge(case, on_card=False)


def _k16_case(case):
    """(build hashes, ok, probe hashes, probe ok) of a K16 case."""
    if case.startswith("K16: "):
        return chip_smoke.k16_edge(case[len("K16: "):])
    return _case(case)


def _i32(u32):
    return torch.from_numpy(u32.view(np.int32).copy())


def _sorted_keys(h, ok):
    return np.sort(np.where(ok, h.astype(np.int64), INVALID), kind="stable")


@pytest.mark.parametrize("case", CASES)
def test_sorted_probe_replay_matches_plain_and_jax(case):
    """The directory and in-bucket search give sorted_probe_plain's start,
    count and base, and the JAX package's probe_candidates over its SORT
    table (the JAX int32 cumsum, where the total fits)."""
    h, ok, ph, pok = _case(case)
    keys = _sorted_keys(h, ok)
    got = sorted_probe_replay(ph, pok, keys)
    want = k14.sorted_probe_plain(_i32(ph), torch.from_numpy(pok), torch.from_numpy(keys))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[3] == int(want[3])
    table = jht.build_sorted(jnp.asarray(h), jnp.asarray(ok), len(h))
    np.testing.assert_array_equal(np.asarray(table.sorted_hash), keys)
    jc = jht.probe_candidates(table, jnp.asarray(ph), jnp.asarray(pok), len(ph))
    for g, w in zip(got, jc):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("bits", [0, 1, 5, 20, 28])
def test_sorted_probe_replay_at_any_directory_size(bits):
    """One bucket (bits 0: every row searches the whole table), a few, and
    far more buckets than keys (most of them empty) give the same ranges."""
    h, ok, ph, pok = _case("repeats, nulls and padding")
    keys = _sorted_keys(h, ok)
    if bits == 28:      # no 2^28-entry directory on the host: its fill tiles alone
        keys = keys[:64]
        ph, pok = ph[:128], pok[:128]
        d = directory_replay(keys, 14)
        np.testing.assert_array_equal(
            d, np.searchsorted(keys, np.arange((1 << 14) + 1, dtype=np.int64) << 18))
        return
    got = sorted_probe_replay(ph, pok, keys, bits)
    want = k14.sorted_probe_plain(_i32(ph), torch.from_numpy(pok), torch.from_numpy(keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_directory_holds_for_any_sorted_keys():
    """Negative keys lie before entry 0 and keys of 2^32 or more past the
    last; each entry is the first key at or past its threshold."""
    rng = np.random.default_rng(3)
    keys = np.sort(np.concatenate([rng.integers(-2**40, 0, 50), rng.integers(0, 1 << 32, 500),
                                   rng.integers(1 << 32, 1 << 40, 50), [1 << 33] * 30]))
    for bits in (0, 3, 9, 16):
        want = np.searchsorted(keys, np.arange((1 << bits) + 1, dtype=np.int64) << (32 - bits))
        np.testing.assert_array_equal(directory_replay(keys, bits), want)


@pytest.mark.parametrize("case", CASES)
def test_oa_place_replay_matches_plain_and_jax(case):
    """The tiled max-scan and span writes give oa_place_plain's slots and
    perm, and the JAX package's build_oa, each slot written once."""
    h, ok, _, _ = _case(case)
    cap = len(h)
    T = tht.table_size_for(cap)
    S = tht.oa_slots_for(T)
    home = tht.slot_of(_i32(h), T)
    composite = np.where(ok, (home.numpy().astype(np.int64) << 32) | h.astype(np.int64),
                         np.int64(1) << 62)
    order = np.argsort(composite, kind="stable").astype(np.int32)
    got = oa_place_replay(order, home.numpy(), h.view(np.int32), ok, S)
    want = k15.oa_place_plain(torch.from_numpy(order), home, _i32(h), torch.from_numpy(ok), S)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    jo = jht.build_oa(jnp.asarray(h), jnp.asarray(ok), cap)
    np.testing.assert_array_equal(got[0], np.asarray(jo.sorted_hash))
    np.testing.assert_array_equal(got[1], np.asarray(jo.perm))
    if case == "a one-home cluster over three tiles":   # its run crosses two tile edges
        run = np.flatnonzero(got[0][T // 3:] != 0)
        assert run[:3 * k15.PLACE_TILE].tolist() == list(range(3 * k15.PLACE_TILE))


@pytest.mark.parametrize("case", K16_CASES)
def test_oa_probe_replay_matches_plain_and_jax(case):
    """K16's walks from the homes it computes, through the pairs it loads,
    and its tiled bases give oa_probe_plain's ranges and the JAX package's
    `_probe_oa` over the JAX `build_oa` table (start, count; base and total
    its cumsum)."""
    h, ok, ph, pok = _k16_case(case)
    jo = jht.build_oa(jnp.asarray(h), jnp.asarray(ok), len(h))
    slots = np.asarray(jo.sorted_hash)
    got = oa_probe_replay(ph, pok, slots)
    want = k16.oa_probe_plain(_i32(ph), torch.from_numpy(pok), torch.from_numpy(slots))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[3] == int(want[3])
    jstart, jcount = jht._probe_oa(jo, jnp.asarray(ph), jnp.asarray(pok))
    np.testing.assert_array_equal(got[0], np.asarray(jstart))
    np.testing.assert_array_equal(got[1], np.asarray(jcount))
    if case in ("a one-home cluster over three tiles", "K16: a walk to the spill's end"):
        assert got[4] > 0                              # walks the warps take on
    if case == "K16: a walk to the spill's end":      # the last run ends at slot S - 2
        assert slots[-2] != 0 and slots[-1] == 0
        last = (slots[-2] >> 32) & 0xFFFFFFFF
        on_last = pok & (ph.astype(np.int64) == last)
        assert on_last.any() and (got[0][on_last] + got[1][on_last] == len(slots) - 1).all()


@pytest.mark.parametrize("S", [80, 81, 86])
def test_oa_probe_clamps_at_the_last_slot(S):
    """On slots that no build makes (slot S - 1 occupied), a walk that
    reaches S - 1 reads it for every step it has left, as the JAX loop's
    clamped position: a run there counts them all, a seek past it finds
    nothing. Replay, plain version and JAX agree, at an odd S too."""
    T = k16.home_slots(S)
    rng = np.random.default_rng(S)
    x, y = _home_hashes_at(rng, T, T - 5, 2).tolist()
    slots = np.zeros(S, np.int64)
    slots[T - 5:] = (np.int64(x) << 32) | 7          # one run from T - 5 to the end
    slots[T - 12:T - 9] = (np.int64(y) << 32) | 3
    z = _home_hashes_at(rng, T, T - 12, 1).tolist()
    ph = np.array([x, y, x, y] + z + [x], np.uint32)
    pok = np.array([True, True, False, True, True, True])
    got = oa_probe_replay(ph, pok, slots)
    want = k16.oa_probe_plain(_i32(ph), torch.from_numpy(pok), torch.from_numpy(slots))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w.numpy())
    table = jht.JoinTable(jnp.zeros((2,), jnp.int32), jnp.zeros((S,), jnp.int32),
                          jnp.asarray(slots), jnp.zeros((1,), jnp.int64))
    jstart, jcount = jht._probe_oa(table, jnp.asarray(ph), jnp.asarray(pok))
    np.testing.assert_array_equal(got[0], np.asarray(jstart))
    np.testing.assert_array_equal(got[1], np.asarray(jcount))
    # x: found at its home T - 5 on step 0, every one of the S steps counts
    assert (got[0][0], got[1][0]) == (T - 5, S)
    # y from T - 5: seeks past x's run to the end, never finds it
    assert (got[0][1], got[1][1]) == (0, 0) and got[1][2] == 0


def _home_hashes_at(rng, T, home, count):
    return chip_smoke._home_hashes(rng, T, home, count).astype(np.int64)


def _place_recorder(seen):
    """An oa_place that records whether its call meets the kernel's
    preconditions (the valid rows first in `order`, S = T + T/4, home =
    slot_of(hash, T) on the valid rows), then runs the plain version."""
    def place(order, home, hashes, ok, S):
        n = int(ok.sum())
        T = k15.home_slots(S)
        seen.append((bool(ok[order[:n].long()].all()) and not bool(ok[order[n:].long()].any()),
                     torch.equal(home[ok], tht.slot_of(hashes, T)[ok])))
        return k15.oa_place_plain(order, home, hashes, ok, S)
    return place


def test_build_oa_meets_the_kernel_preconditions():
    """`build_oa` hands K15 K6's order over (invalid, home, hash), the valid
    rows first, and home = slot_of(hash, T)."""
    for case in ("repeats, nulls and padding", "T not a power of two"):
        h, ok, _, _ = _case(case)
        seen = []
        T = tht.table_size_for(len(h))
        rows = torch.empty((0, len(h)), dtype=torch.int32)
        tht.oa_table_rows(_i32(h), torch.from_numpy(ok), T, rows,
                          place=_place_recorder(seen))
        assert seen == [(True, True)]


@pytest.mark.parametrize("keys", ["int32 with nulls", "int64 and int32"])
def test_the_join_meets_the_kernel_preconditions(keys):
    """The OA join, resident and prepared, hands K15 homes equal to
    slot_of(hash, T) on every valid row, and the valid rows first in
    `order`."""
    from datafusion_parallelism_tpu_torch import HostTable
    from datafusion_parallelism_tpu_torch.ops import join as tjoin
    rng = np.random.default_rng(5)

    def side(n, p):
        k = rng.integers(0, 300, n)
        return HostTable.from_numpy({f"{p}k": k.astype(np.int32), f"{p}l": k * (1 << 33) + 5},
                                    validity={f"{p}k": rng.random(n) >= 0.15,
                                              f"{p}l": rng.random(n) >= 0.1})
    build, probe = side(3000, "b").to_device(device="cpu"), side(4000, "p").to_device(
        device="cpu")
    bkeys, pkeys = (["bk"], ["pk"]) if keys == "int32 with nulls" else (["bl", "bk"], ["pl", "pk"])
    seen = []
    kernels = tjoin.PLAIN._replace(oa_place=_place_recorder(seen))
    tjoin.hash_join(build, probe, bkeys, pkeys, tjoin.JoinType.INNER, 1 << 16,
                    strategy=tjoin.JoinStrategy.OA, kernels=kernels)
    prepared = tjoin.prepare_build(build, bkeys, tjoin.JoinStrategy.OA, kernels)
    tjoin.hash_join(build, probe, bkeys, pkeys, tjoin.JoinType.INNER, 1 << 16,
                    strategy=tjoin.JoinStrategy.OA, kernels=kernels, prepared=prepared)
    assert seen == [(True, True)] * 2


@pytest.mark.parametrize("T", [1, 2, 1 << 16, 1 << 27, 1 << 31, 1 << 32, 3 * (1 << 20) + 5])
def test_slot_of_is_the_unsigned_reduction(T):
    """slot_of's one-pass int32 mask and its int64 paths give the mask of
    the hash as unsigned for a power of two, else floor(h * T / 2^32)."""
    h = np.random.default_rng(T % 1000).integers(0, 1 << 32, 4096, dtype=np.uint64)
    h[:3] = [0, (1 << 32) - 1, 1 << 31]
    want = h & np.uint64(T - 1) if T & (T - 1) == 0 else (h * np.uint64(T)) >> np.uint64(32)
    got = tht.slot_of(_i32(h.astype(np.uint32)), T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.astype(np.uint32))


def test_oa_table_rows_homes_every_row_by_its_hash():
    """The homes the OA table hands K15: slot_of(hash, T) on the valid rows
    and 0 on the rest, whatever the caller's slots were."""
    h, ok, _, _ = _case("repeats, nulls and padding")
    T = tht.table_size_for(len(h))
    homes = []

    def place(order, home, hashes, ok_, S):
        homes.append(home)
        return k15.oa_place_plain(order, home, hashes, ok_, S)
    tht.oa_table_rows(_i32(h), torch.from_numpy(ok), T, torch.empty((0, len(h)), dtype=torch.int32),
                      place=place)
    want = np.where(ok, tht.slot_of(_i32(h), T).numpy(), 0)
    np.testing.assert_array_equal(homes[0].numpy(), want)


@pytest.mark.parametrize("case", ["repeats, nulls and padding", "every row invalid"])
def test_chip_smoke_bounds_k15_by_what_it_reads(case):
    """K15's bound in chip_smoke: `ok` whole, the order entry and gathered
    hash of each valid row (`home` is not read), both outputs whole."""
    h, ok, _, _ = _case(case)
    T = tht.table_size_for(len(h))
    S = tht.oa_slots_for(T)
    z = torch.zeros(len(h), dtype=torch.int32)
    out = (torch.zeros(S, dtype=torch.int64), torch.zeros(S, dtype=torch.int32))
    got = chip_smoke.work(("join", "oa_place"), (z, z, _i32(h), torch.from_numpy(ok), S), out)
    assert got == (len(h) + 8 * int(ok.sum()) + 12 * S, 0)


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [k14, k15, k16], ids=["K14", "K15", "K16"])
def test_compiled_plan_reads_the_plan_entry_by_index(monkeypatch, mod):
    """compiled_plan asks the C plan entry for PLAN's constants in order,
    which chip_smoke holds against the module's copies."""
    values = [getattr(mod, name) for name in mod.PLAN]
    asked = []

    def function(name, argtypes, restype=ctypes.c_int):
        asked.append(name)
        return lambda i: values[i] if 0 <= i < len(values) else -1
    monkeypatch.setattr(_build, "function", function)
    assert mod.compiled_plan() == {name: getattr(mod, name) for name in mod.PLAN}
    assert asked == [f"dfp_{mod.__name__.rsplit('.', 1)[1]}_plan"]


@pytest.mark.parametrize("cap, bits", [(0, 0), (1, 0), (8, 0), (9, 1), (4096, 9),
                                       (4_194_304, 19), (15_000_000, 21), (1 << 25, 22),
                                       (2**31 - 1, 28)])
def test_directory_bits(cap, bits):
    """The least bits with at most KEYS_A_BUCKET capacity keys a bucket,
    below MAX_DIRECTORY_BITS."""
    assert k14.directory_bits(cap) == bits
    if 0 < cap and bits < k14.MAX_DIRECTORY_BITS:
        assert cap / 2**bits <= k14.KEYS_A_BUCKET < 2 * cap / 2**bits or bits == 0


@pytest.mark.parametrize("m, bits, tiles, nbytes", [
    (1, 0, 1, 16 + 8 + 8),
    (2048, 9, 1, 16 + 2056 + 8),
    (2049, 9, 1, 24 + 2056 + 8),
    (1 << 26, 22, 1025, 8 * 32769 + 16_777_224 + 4 * 1026)])
def test_sorted_probe_plan(m, bits, tiles, nbytes):
    assert k14.directory_tiles(bits) == tiles
    assert k14.probe_tiles(m) == -(-m // k14.PROBE_TILE)
    assert k14.scratch_bytes(m, bits) == nbytes


@pytest.mark.parametrize("cap, nbytes", [(0, 24), (1, 32), (2048, 32), (2049, 40),
                                         (1 << 25, 8 * 16385 + 16)])
def test_oa_place_plan(cap, nbytes):
    assert k15.scratch_bytes(cap) == nbytes
    assert k15.place_tiles(cap) == -(-cap // k15.PLACE_TILE)


# ---------------------------------------------------------------------------
# the wrappers' host checks, with the launchers stubbed
# ---------------------------------------------------------------------------


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
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(_build, "device_limits", lambda dev: Limits)
    monkeypatch.setattr(k14, "check_total", lambda total: total.to(torch.int32))
    return calls


@pytest.mark.parametrize("cap", [0, 1, 4096, 100_000])
def test_sorted_probe_launch_plan(stub_launch, cap):
    """The launch hands the kernel the table's capacity, directory_bits of
    it and scratch_bytes of both."""
    m = 5000
    sorted_hash = torch.zeros(cap, dtype=torch.int64)
    k14._launch(torch.zeros(m, dtype=torch.int32), torch.ones(m, dtype=torch.bool), sorted_hash)
    (name, args), = stub_launch
    bits = k14.directory_bits(cap)
    assert name == "dfp_sorted_probe" and args[2] == m and args[4] == cap and args[5] == bits
    assert args[11] == k14.scratch_bytes(m, bits)


@pytest.mark.parametrize("sorted_hash, probe, match", [
    (torch.zeros((2, 8), dtype=torch.int64), 4, "sorted_hash"),
    (torch.zeros(8, dtype=torch.int64), 0, "no rows")], ids=["a matrix", "an empty probe"])
def test_sorted_probe_refuses(stub_launch, sorted_hash, probe, match):
    with pytest.raises(ValueError, match=match):
        k14._launch(torch.zeros(probe, dtype=torch.int32), torch.ones(probe, dtype=torch.bool),
                    sorted_hash)


def test_oa_place_launch_plan(stub_launch):
    """The launch hands the kernel S, its T, scratch_bytes(cap) and the SM
    count."""
    cap, S = 5000, 25_600
    z = torch.zeros(cap, dtype=torch.int32)
    slots, perm = k15._launch(z, z, z, torch.ones(cap, dtype=torch.bool), S)
    (name, args), = stub_launch
    assert name == "dfp_oa_place" and args[3] == cap and args[4] == S and args[5] == 20_480
    assert args[9] == k15.scratch_bytes(cap) and args[10] == 132
    assert slots.shape == (S,) and slots.dtype == torch.int64 and perm.dtype == torch.int32


@pytest.mark.parametrize("T", [1, 2, 3, 4, 65_536, 65_539, 12_582_932, 1 << 27])
def test_home_slots_inverts_oa_slots_for(T):
    assert k15.home_slots(tht.oa_slots_for(T)) == T


@pytest.mark.parametrize("S", [5000, 4999, 2**31, 25_604])
def test_oa_place_refuses_a_slot_count_out_of_range(stub_launch, S):
    z = torch.zeros(5000, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot count"):
        k15._launch(z, z, z, torch.ones(5000, dtype=torch.bool), S)


@pytest.mark.parametrize("m, tiles, nbytes", [(1, 1, 16), (8192, 1, 16), (8193, 2, 24),
                                              (5 * 8192 + 7, 6, 56),
                                              (1 << 26, 8192, 8 * 8193)])
def test_oa_probe_plan(m, tiles, nbytes):
    """A look-back status word a tile of PROBE_TILE probe rows, then the
    tile counter."""
    assert k16.probe_tiles(m) == tiles
    assert k16.scratch_bytes(m) == nbytes


@pytest.mark.parametrize("m, S", [(5000, 81_920), (1, 2), (2049, 25_601)])
def test_oa_probe_launch_plan(stub_launch, monkeypatch, m, S):
    """The launch hands the kernel m, S and T = 4S/5 (no home slots) and
    scratch_bytes(m), in the C entry's order."""
    monkeypatch.setattr(k16, "check_total", lambda total: total.to(torch.int32))
    hashes, ok = torch.zeros(m, dtype=torch.int32), torch.ones(m, dtype=torch.bool)
    slots = torch.zeros(S, dtype=torch.int64)
    start, count, base, _ = k16._launch(hashes, ok, slots)
    (name, args), = stub_launch
    assert name == "dfp_oa_probe" and len(args) == 13
    assert args[:6] == (hashes.data_ptr(), ok.data_ptr(), m, slots.data_ptr(), S, 4 * S // 5)
    assert args[6:9] == (start.data_ptr(), count.data_ptr(), base.data_ptr())
    assert args[11] == k16.scratch_bytes(m) == 8 * (k16.probe_tiles(m) + 1)
    assert start.shape == count.shape == base.shape == (m,)


@pytest.mark.parametrize("m, slots, match", [
    (0, torch.zeros(80, dtype=torch.int64), "no rows"),
    (4, torch.zeros(1, dtype=torch.int64), "slots"),
    (4, torch.zeros((2, 40), dtype=torch.int64), "slots")],
    ids=["an empty probe", "one slot", "a matrix"])
def test_oa_probe_refuses(stub_launch, m, slots, match):
    with pytest.raises(ValueError, match=match):
        k16._launch(torch.zeros(m, dtype=torch.int32), torch.ones(m, dtype=torch.bool), slots)
    assert stub_launch == []


@pytest.mark.parametrize("case", ["repeats, nulls and padding", "every row invalid"])
def test_chip_smoke_bounds_k16_by_what_it_reads(case):
    """K16's bound in chip_smoke: `hashes` and `ok` whole, each ok row's
    run and the slot that ends its walk, the three outputs and the int32
    total;
    phase 15 also prints it as counted before, with the int32 home array."""
    h, ok, ph, pok = _case(case)
    jo = jht.build_oa(jnp.asarray(h), jnp.asarray(ok), len(h))
    args = (_i32(ph), torch.from_numpy(pok), torch.from_numpy(np.asarray(jo.sorted_hash)))
    out = k16.oa_probe_plain(*args)
    m, total = len(ph), int(out[3])
    want = 5 * m + min(8 * len(args[2]), 8 * (int(pok.sum()) + total)) + 12 * m + 4
    got = chip_smoke.work(("join", "oa_probe"), args, out)
    assert got == (want, 0)
    before = (want + 4 * m) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert f"bound as counted before (with a home array) {before:.3f}" in chip_smoke.join_detail(
        ("join", "oa_probe"), args, out)


@pytest.mark.parametrize("strategy", ["CSR", "SORT", "OA"])
def test_the_join_asks_k1_for_a_probe_slot_only_under_csr(strategy):
    """The probe side's K1 call gets T under CSR (K3 reads the buckets) and
    none under SORT and OA (K14 and K16 work from the hashes); K16 gets
    the probe's hashes, ok rows and the table's slots."""
    from datafusion_parallelism_tpu_torch import HostTable
    from datafusion_parallelism_tpu_torch.ops import join as tjoin
    rng = np.random.default_rng(7)

    def side(n, p):
        k = rng.integers(0, 300, n).astype(np.int32)
        return HostTable.from_numpy({f"{p}k": k}, validity={f"{p}k": rng.random(n) >= 0.1}
                                    ).to_device(device="cpu")
    build, probe = side(3000, "b"), side(4000, "p")
    hashed, probed = [], []

    def hash_slot(words, cols, T=None, *rest):
        hashed.append((words.shape[1], T))
        return tjoin.PLAIN.hash_slot(words, cols, T, *rest)

    def oa_probe(*args):
        probed.append(len(args))
        return tjoin.PLAIN.oa_probe(*args)
    kernels = tjoin.PLAIN._replace(hash_slot=hash_slot, oa_probe=oa_probe)
    out, _ = tjoin.hash_join(build, probe, ["bk"], ["pk"], tjoin.JoinType.INNER, 1 << 16,
                             strategy=tjoin.JoinStrategy[strategy], kernels=kernels)
    T = tht.table_size_for(build.capacity)
    assert hashed == [(build.capacity, T), (probe.capacity, T if strategy == "CSR" else None)]
    assert probed == ([3] if strategy == "OA" else [])
    want, _ = tjoin.hash_join(build, probe, ["bk"], ["pk"], tjoin.JoinType.INNER, 1 << 16,
                              strategy=tjoin.JoinStrategy.CSR, kernels=tjoin.PLAIN)
    assert out.num_rows == want.num_rows
