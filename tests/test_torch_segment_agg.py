"""K7 segment_agg on the CPU: its plain version against the JAX package's
sorted path (`hash_aggregate_counted`) at the shapes the kernel's tiling
stresses (n_valid at 0, 1 and either side of a tile, a group over several
tiles, groups dropped at out_cap on a tile edge, a 17-column key with 33
requests); the one-pass algorithm of `csrc/segment_agg.cu` replayed in
Python (tiles, threads' rows, block scans, the windows' carries, the
tile-head groups, the zero tail) against the plain version; the wrapper's
host-side checks and its scratch layout; chip_smoke.py's count of the
bytes a call moves; tools/bench_segment_agg.py's cells at a tiny size. (The CUDA kernel
is held against the plain version on the card by chip_smoke.py, phases
2h, 8, 12, 15 and 18.)

Tolerances: bit-exact for starts, sizes, counts, integer sums, min/max
and the group count; float64 sums within rtol 1e-9 + 1e-12 * sum|x|,
since the two reduce in different orders.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import aggregate as jagg
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import segment_agg as k7
from datafusion_parallelism_tpu_torch.ops.hashing import key_words
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference

FLOAT_RTOL, FLOAT_ATOL_PER_ABS = 1e-9, 1e-12
TILE = k7.TILE_ROWS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

def _table(rng, cap, n, keys, n_cols=1, n_vals=1):
    """n rows of `cap` in key order: int32 key columns k0.. (k0 = `keys`,
    the others functions of it, NULL on some of its values), int64 v*,
    float64 f* and int32 i* value columns with 10% NULLs."""
    data, valid = {}, {}
    data["k0"] = keys[:n].astype(np.int32)
    valid["k0"] = np.ones(n, bool)
    for c in range(1, n_cols):   # functions of k0, so the rows stay in group order
        data[f"k{c}"] = (keys[:n] * c % 11).astype(np.int32)
        valid[f"k{c}"] = keys[:n] % (c + 2) != 0
    for j in range(n_vals):
        data[f"v{j}"] = rng.integers(-10**12, 10**12, n)
        data[f"f{j}"] = rng.normal(size=n) * 100
        data[f"i{j}"] = rng.integers(-50, 50, n).astype(np.int32)
        for name in (f"v{j}", f"f{j}", f"i{j}"):
            valid[name] = rng.random(n) > 0.1
    return jcol.HostTable.from_numpy(data, validity=valid)


def _aggs(n_vals):
    """JAX aggregates and the port's requests over the same columns."""
    jaggs, reqs = [], []
    for j in range(n_vals):
        for func, col in (("sum", f"v{j}"), ("count", f"f{j}"), ("min", f"i{j}"),
                          ("max", f"v{j}"), ("sum", f"f{j}"), ("min", f"f{j}")):
            jaggs.append(jagg.AggSpec(func, col, f"{func}_{col}"))
            reqs.append((func, col))
    jaggs.append(jagg.AggSpec("count_star", None, "cs"))
    return jaggs, reqs


def _port(tt, keys, reqs, out_cap):
    words, cols = key_words([tt.column(k) for k in keys])
    treqs = [(f, *tt.column(c)) for f, c in reqs]
    return k7.segment_agg_plain(words, cols, tt.num_rows, treqs, out_cap), treqs


def _by_group(host, keys, jout, g, names, starts=None, res=None, sizes=None):
    """{key tuple: (size, result tuple)} of the first g groups: from the
    JAX output's columns, or from the port's starts (the key at a group's
    first row), sizes and results."""
    out = {}
    for i in range(g):
        if starts is None:
            key = tuple(None if not np.asarray(jout.column(k)[1])[i]
                        else int(np.asarray(jout.column(k)[0])[i]) for k in keys)
            size = int(np.asarray(jout.column("cs")[0])[i])
            vals = tuple((np.asarray(jout.column(nm)[0])[i].item(),
                          bool(np.asarray(jout.column(nm)[1])[i])) for nm in names)
        else:
            s = int(starts[i])
            key = tuple(None if not host.columns[k][1][s] else int(host.columns[k][0][s])
                        for k in keys)
            size = int(sizes[i])
            vals = tuple(r[i].item() for r in res)
        out[key] = (size, vals)
    return out


def _check_against_jax(host, keys, n_vals, cap, out_cap, positional):
    jaggs, reqs = _aggs(n_vals)
    jout, jn = jagg.hash_aggregate_counted(host.to_device(cap), keys, jaggs, out_cap)
    tt = host_table_from_reference(host).to_device(cap, device="cpu")
    (starts, sizes, res, n), treqs = _port(tt, keys, reqs, out_cap)
    assert int(n) == int(jn)
    g = min(int(jn), out_cap)
    names = [a.output for a in jaggs[:-1]]
    if positional:   # the JAX package keeps a one-word key's value order
        np.testing.assert_array_equal(sizes[:g].numpy(), np.asarray(jout.column("cs")[0])[:g])
        np.testing.assert_array_equal(tt.column(keys[0])[0][starts[:g].long()].numpy(),
                                      np.asarray(jout.column(keys[0])[0])[:g])
        got = {i: (int(sizes[i]), tuple(r[i].item() for r in res)) for i in range(g)}
        want = {i: (int(np.asarray(jout.column("cs")[0])[i]),
                    tuple((np.asarray(jout.column(nm)[0])[i].item(),
                           bool(np.asarray(jout.column(nm)[1])[i])) for nm in names))
                for i in range(g)}
    else:
        got = _by_group(host, keys, None, g, names, starts, res, sizes)
        want = _by_group(host, keys, jout, g, names)
    assert set(got) == set(want)
    for key, (size, vals) in got.items():
        wsize, wvals = want[key]
        assert size == wsize, key
        for (func, col), x, (y, ok), (_, values, validity) in zip(reqs, vals, wvals, treqs,
                                                                   strict=True):
            if not ok:   # the JAX package leaves a group with no valid row NULL
                continue
            if func == "sum" and col.startswith("f"):
                scale = float(torch.where(validity, values.abs(), 0.0).sum())
                assert math.isclose(x, y, rel_tol=FLOAT_RTOL,
                                    abs_tol=FLOAT_ATOL_PER_ABS * scale), (key, func, col)
            else:
                assert x == y, (key, func, col)
    # past the kept groups: zeros
    assert not starts[g:].any() and not sizes[g:].any()
    assert all(not r[g:].any() for r in res)


def _runs(n, sizes):
    """Sorted int32 keys over n rows in runs of the given sizes (the last
    run takes the rest)."""
    keys = np.empty(n, np.int64)
    at, k = 0, -7
    for s in sizes:
        keys[at:at + s] = k
        at, k = at + s, k + 3
    keys[at:] = k
    return keys


JAX_CASES = {
    # name: (cap, n_valid, run sizes, out_cap, key columns, value column sets)
    "n_valid 0": (2 * TILE, 0, [5], None, 1, 1),
    "n_valid 1": (2 * TILE, 1, [5], None, 1, 1),
    "n_valid a tile - 1": (2 * TILE, TILE - 1, [3] * 2000, None, 1, 1),
    "n_valid a tile": (2 * TILE, TILE, [3] * 2000, None, 1, 1),
    "n_valid a tile + 1": (2 * TILE, TILE + 1, [3] * 2000, None, 1, 1),
    "a group over several tiles": (4 * TILE, 4 * TILE - 3, [7, 3 * TILE + 11, 5], None, 1, 1),
    "groups dropped at out_cap, the last kept ending on a tile edge":
        (2 * TILE, 2 * TILE - 100, [TILE - 10, 6, 4] + [9] * 300, 3, 1, 1),
    "a 17-column key and 33 requests": (TILE, TILE - 9, [1, 2, 40] * 30, None, 17, 6),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_segment_agg_plain_matches_jax_at_tile_shapes(case):
    cap, n, runs, out_cap, n_cols, n_vals = JAX_CASES[case]
    rng = np.random.default_rng(len(case))
    host = _table(rng, cap, n, _runs(max(n, 1), runs), n_cols, n_vals)
    keys = [f"k{c}" for c in range(n_cols)]
    assert len(_aggs(n_vals)[1]) == 6 * n_vals
    _check_against_jax(host, keys, n_vals, cap, out_cap if out_cap is not None else cap,
                       positional=n_cols == 1)


def test_drop_case_ends_the_last_kept_group_on_a_tile_edge():
    """The drop case's third group ends at row TILE - 1: out_cap 3 keeps
    it, and its sums run on to n_valid."""
    keys = _runs(2 * TILE - 100, JAX_CASES[
        "groups dropped at out_cap, the last kept ending on a tile edge"][2])
    first = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    assert first[3] == TILE and len(first) > 3


# ---------------------------------------------------------------------------
# the one-pass algorithm of csrc/segment_agg.cu, replayed
# ---------------------------------------------------------------------------

I64_MIN, I64_MAX = -2**63, 2**63 - 1
FIRST_NONE = -1


def _wrap(x):
    x &= 2**64 - 1
    return x - 2**64 if x >= 2**63 else x


def _op(func, values):
    if func != "count" and values.is_floating_point():
        return {"sum": "dsum", "min": "dmin", "max": "dmax"}[func]
    return {"count": "isum", "sum": "isum", "min": "imin", "max": "imax"}[func]


IDENT = {"isum": 0, "dsum": 0.0, "imin": I64_MAX, "imax": I64_MIN, "dmin": math.inf,
         "dmax": -math.inf, "first": FIRST_NONE}


def _comb(op, a, b):
    """agg.cuh's agg_combine (a the earlier rows), and the segment starts."""
    if op == "isum":
        return _wrap(a + b)
    if op == "dsum":
        return a + b
    if op in ("imin", "imax"):
        return (b if b < a else a) if op == "imin" else (b if b > a else a)
    if op in ("dmin", "dmax"):
        if a != a:
            return a
        if b != b:
            return b
        return (b if b < a else a) if op == "dmin" else (b if b > a else a)
    return a if a != FIRST_NONE else b


def _row_values(func, values, validity, op, nv):
    vals = values.tolist()
    ok = [True] * len(vals) if validity is None else validity.tolist()
    out = []
    for i in range(nv):
        if not ok[i]:
            out.append(IDENT[op])
        elif func == "count":
            out.append(1)
        else:
            out.append(float(vals[i]) if op.startswith("d") else int(vals[i]))
    return out


def replay(words, cols, n_valid, reqs, out_cap, items, threads, window):
    """segment_agg's outputs as csrc/segment_agg.cu computes them, with
    `threads` threads of `items` rows a tile and windows of `window` tiles,
    the tiles taken in order. The boundary flags come from
    boundaries_plain; outputs start as a sentinel, so a group the pass
    leaves unwritten shows."""
    n = words.shape[1]
    tile_rows = items * threads
    tiles = -(-n // tile_rows)
    nv = max(0, min(int(n_valid), n))
    flag = k7.boundaries_plain(words, cols, n_valid).tolist() + [False] * (items + 1)
    sentinel = 0x5EED
    starts, sizes = [sentinel] * out_cap, [sentinel] * out_cap
    out = [[sentinel] * out_cap for _ in reqs]
    ops = [_op(f, v) for f, v, _ in reqs] + ["first"]
    vals = [_row_values(f, v, m, op, nv) for (f, v, m), op in zip(reqs, ops)]
    vals.append(list(range(nv)))
    vagg, vflags, vinc = {}, {}, {}
    n_groups, prefix = None, 0

    def emit(a, g, val, last):
        if ops[a] in ("isum", "dsum", "first"):
            g = min(g, out_cap - 1)
            if g < 0:
                return
            if ops[a] == "first":
                sizes[g] = last + 1 - val
            else:
                out[a][g] = val
        elif 0 <= g < out_cap:
            out[a][g] = val

    for t in range(tiles):
        first = t * tile_rows
        if first >= nv:
            if t == 0:
                n_groups = 0
            break
        i0s = [first + th * items for th in range(threads)]
        fl = [sum(1 << j for j in range(items + 1) if flag[i0 + j]) if i0 < nv else 0
              for i0 in i0s]
        cnt = [bin(f & ((1 << items) - 1)).count("1") for f in fl]
        tile_cnt = sum(cnt)
        if nv <= first + tile_rows:
            n_groups = prefix + tile_cnt
        gbase = [prefix + sum(cnt[:th]) for th in range(threads)]
        fs = []
        for th, i0 in enumerate(i0s):
            g, bits = gbase[th], 0
            for j in range(items + 1):
                if fl[th] >> j & 1:
                    if g < out_cap:
                        bits |= 1 << j
                        if j < items:
                            starts[g] = i0 + j
                    g += 1
            fs.append(bits)
        head = {}
        tile_v, tile_f = [], []
        for a, op in enumerate(ops):
            pairs, heads = [], []
            for th, i0 in enumerate(i0s):
                rel = fs[th] if op in ("isum", "dsum", "first") else fl[th]
                c = max(0, min(nv - i0, items))
                run, hd, seen, ends = IDENT[op], IDENT[op], False, None
                if c > 0:
                    for k in range(items):
                        v = vals[a][i0 + k] if k < c else IDENT[op]
                        if rel >> k & 1:
                            if k > 0:
                                g = gbase[th] + bin(fl[th] & ((1 << k) - 1)).count("1") - 1
                                if not seen:
                                    hd, ends = run, (i0 + k - 1, g)
                                else:
                                    emit(a, g, run, i0 + k - 1)
                            seen, run = True, IDENT[op]
                        run = _comb(op, run, v)
                    if not seen:
                        hd = run
                    if rel >> items & 1 or i0 + items >= nv:
                        g = gbase[th] + cnt[th] - 1
                        last = min(i0 + items, nv) - 1
                        if seen:
                            emit(a, g, run, last)
                        else:
                            ends = (last, g)
                pairs.append((seen, run if seen else hd))
                heads.append((hd, ends))
            # the block's exclusive segmented scan, thread by thread
            ef, ev = False, IDENT[op]
            for (seen, v), (hd, ends) in zip(pairs, heads):
                if ends is not None:
                    val = _comb(op, ev, hd)
                    if ef:
                        emit(a, ends[1], val, ends[0])
                    else:
                        head[a] = (val, ends)
                ev = v if seen else _comb(op, ev, v)
                ef = ef or seen
            tile_f.append(ef)
            tile_v.append(ev)
        for a in range(len(ops)):
            vagg[a, t] = tile_v[a]
        vflags[t] = (tile_cnt > 0, tile_cnt > 0 and prefix < out_cap)
        base, m = t // window * window, t % window
        carry = []
        for a, op in enumerate(ops):
            rel = [vflags[base + j][1 if op in ("isum", "dsum", "first") else 0]
                   for j in range(m)]
            last = max((j for j in range(m) if rel[j]), default=None)
            c = IDENT[op]
            for j in range(0 if last is None else last, m):
                c = _comb(op, c, vagg[a, base + j])
            if last is None and base > 0:
                c = _comb(op, vinc[a, base // window - 1], c)
            carry.append(c)
        if m == window - 1:
            for a, op in enumerate(ops):
                vinc[a, t // window] = tile_v[a] if tile_f[a] else _comb(op, carry[a], tile_v[a])
        for a, (val, (last, g)) in head.items():
            emit(a, g, _comb(ops[a], carry[a], val), last)
        prefix += tile_cnt
    if tiles == 0:
        n_groups = 0
    kept = min(n_groups, out_cap)
    for g in range(kept, out_cap):
        starts[g] = sizes[g] = 0
        for row in out:
            row[g] = 0
    return starts, sizes, out, n_groups


def _replay_case(rng, n, nv, runs, out_cap, n_cols=1, floats=False):
    """segment_agg's arguments: key columns over n rows (k0 in `runs`,
    others constant with 3% NULLs; the first nv rows valid), and requests
    of every function over int32, int64, bool and (with `floats`) float32
    and float64 values with NULLs."""
    keys = _runs(max(n, 1), runs)[:n]
    cols = [(torch.from_numpy(keys.astype(np.int32)), torch.ones(n, dtype=torch.bool))]
    for _ in range(1, n_cols):
        cols.append((torch.full((n,), 3, dtype=torch.int64),
                     torch.from_numpy(rng.random(n) > 0.03)))
    words, kc = key_words(cols)
    valid = torch.from_numpy(rng.random(n) > 0.2)
    i32 = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    i64 = torch.from_numpy(rng.integers(-2**62, 2**62, n))
    b = torch.from_numpy(rng.random(n) < 0.5)
    reqs = [("count", i32, valid), ("sum", i64, valid), ("min", i32, None), ("max", i64, valid),
            ("sum", b, None), ("max", b, valid)]
    if floats:
        f64 = rng.normal(size=n) * 1e3
        f64[rng.random(n) < 0.05] = -0.0
        f32 = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        reqs += [("min", torch.from_numpy(f64), valid), ("max", f32, None),
                 ("sum", torch.from_numpy(f64), valid)]
    return words, kc, torch.tensor(nv, dtype=torch.int32), reqs, out_cap


REPLAY_CASES = {
    # name: (n, n_valid, runs, out_cap, key columns, floats, (items, threads, window))
    "nothing valid": (40, 0, [3], 40, 1, False, (2, 4, 3)),
    "one row": (40, 1, [3], 40, 1, False, (2, 4, 3)),
    "a tile - 1": (40, 7, [2, 1, 3], 40, 1, False, (2, 4, 3)),
    "a tile": (40, 8, [2, 1, 3], 40, 1, False, (2, 4, 3)),
    "a tile + 1": (40, 9, [2, 1, 3], 40, 1, False, (2, 4, 3)),
    "one group over every row (windows chained)": (203, 203, [1000], 203, 1, True, (2, 4, 3)),
    "one group, out_cap 0": (100, 100, [1000], 0, 1, False, (2, 4, 3)),
    "a group over one tile edge": (64, 60, [5, 6, 100], 64, 1, True, (2, 4, 3)),
    "groups of one row": (90, 77, [1] * 90, 90, 1, True, (2, 4, 3)),
    "drops, the last kept ending on a tile edge": (120, 115, [3, 5, 8, 2] * 20, 3, 1, True,
                                                   (2, 4, 3)),
    "drops at a window edge": (200, 190, [24, 24, 1, 3] * 20, 4, 1, True, (2, 4, 3)),
    "out_cap past the groups": (100, 97, [4, 9] * 20, 95, 1, True, (2, 4, 3)),
    "a capacity not a multiple of the tile": (101, 101, [2, 7, 1] * 20, 101, 1, True,
                                              (4, 4, 2)),
    "a 17-column key": (120, 111, [2, 9, 30] * 5, 120, 17, True, (4, 2, 2)),
    "the kernel's tile, groups of ~4": (3 * TILE + 5, 3 * TILE, [4, 3, 5] * TILE, 3 * TILE, 1,
                                        True, (16, 512, 32)),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_one_pass_replay_matches_plain(case):
    n, nv, runs, out_cap, n_cols, floats, shape = REPLAY_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    args = _replay_case(rng, n, nv, runs, out_cap, n_cols, floats)
    starts, sizes, res, n_groups = k7.segment_agg_plain(*args)
    got = replay(*args, *shape)
    assert got[3] == int(n_groups)
    assert got[0] == starts.tolist()
    assert got[1] == sizes.tolist()
    for (func, values, validity), g, w in zip(args[3], got[2], res, strict=True):
        if w.dtype == torch.float64 and func == "sum":
            scale = float(torch.where(validity, values.double().abs(), 0.0).sum())
            np.testing.assert_allclose(g, w.numpy(), rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL_PER_ABS * scale)
        elif w.dtype == torch.float64:
            np.testing.assert_array_equal(np.array(g, np.float64), w.numpy())
        else:
            assert g == w.tolist(), func


# ---------------------------------------------------------------------------
# the wrapper's host side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_aggs", [(0, 0), (1, 0), (TILE, 1), (TILE + 1, 32),
                                      (1 << 26, 2), (32 * TILE + 1, 5)])
def test_scratch_layout(n, n_aggs):
    """The status words and tile counter, a state word a tile (zeroed), then
    the tiles' values and the windows' inclusive values, A + 1 slots each,
    every part on a 256-byte boundary."""
    zeroed, total = k7.scratch_layout(n, n_aggs)
    tiles = -(-n // TILE)
    windows = -(-tiles // k7.WINDOW)
    assert zeroed == 12 * tiles + 8
    slots = n_aggs + 1

    def align(b):
        return -(-b // 256) * 256
    assert total == align(zeroed) + align(8 * slots * tiles) + align(8 * slots * windows)
    assert total % 256 == 0 and total >= zeroed


def _key(n, n_cols=1):
    cols = [(torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool))] * n_cols
    return key_words(cols)


def test_check_args_accepts_the_main_path_and_returns_a_spec_a_run():
    words, kc = _key(10, 17)
    specs = k7.check_args(words, kc, torch.tensor(10, dtype=torch.int32), 10)
    assert len(specs) == 2 and specs[0][0] == 16 and specs[1][0] == 1


@pytest.mark.parametrize("bad", ["words_1d", "words_int64", "words_strided", "n_valid_int64",
                                 "n_valid_1d", "out_cap_negative", "out_cap_2_31",
                                 "129_key_columns", "key_row_outside"])
def test_check_args_refuses(bad):
    words, kc = _key(10, 129 if bad == "129_key_columns" else 1)
    n_valid = torch.tensor(10, dtype=torch.int32)
    out_cap = 10
    if bad == "words_1d":
        words = words[0]
    elif bad == "words_int64":
        words = words.long()
    elif bad == "words_strided":
        words = torch.cat([words, words], 1)[:, ::2]
    elif bad == "n_valid_int64":
        n_valid = n_valid.long()
    elif bad == "n_valid_1d":
        n_valid = n_valid.reshape(1)
    elif bad == "out_cap_negative":
        out_cap = -1
    elif bad == "out_cap_2_31":
        out_cap = 2**31
    elif bad == "key_row_outside":
        kind, rows, (vrow, vbit) = kc[0]
        kc = [(kind, rows, (vrow + 5, vbit))]
    with pytest.raises((ValueError, TypeError)):
        k7.check_args(words, kc, n_valid, out_cap)


def test_k7_work_counts_the_valid_rows_and_each_input_once():
    """chip_smoke.py's K7 bound: the inputs below n_valid, once each."""
    n, nv, out_cap = 1000, 300, 64
    words, kc = _key(n, 2)           # two int32 columns: a value and a validity row each
    v = torch.zeros(n, dtype=torch.int64)
    m = torch.ones(n, dtype=torch.bool)
    f = torch.zeros(n, dtype=torch.float32)
    reqs = [("sum", v, m), ("max", v, m), ("count", f, m), ("count", f, None), ("min", f, None)]
    # four key word rows; v (8 B) and m (1 B) once; f (4 B) for the min
    # only; outputs whole
    assert words.shape[0] == 4
    want = 4 * nv * 4 + nv * (8 + 1 + 4) + out_cap * (4 + 8 + 8 * len(reqs)) + 8
    assert chip_smoke.k7_work(words, kc, torch.tensor(nv, dtype=torch.int32), reqs,
                              out_cap) == want
    assert chip_smoke.k7_work(words, kc, torch.tensor(2 * n, dtype=torch.int32), reqs, out_cap) \
        == want + 4 * (n - nv) * 4 + (n - nv) * 13


# ---------------------------------------------------------------------------
# tools/bench_segment_agg.py
# ---------------------------------------------------------------------------

def test_bench_cells_run_through_the_plain_version(monkeypatch):
    """Every cell of the bench builds and runs at a tiny size through the
    plain version (CPU tensors): Q18's captured calls (TPC-H at SF 0.01)
    and the synthetic cells, each equal to the plain version, the same bits
    twice, with both bounds and the partial yardstick."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_segment_agg as bench
    monkeypatch.setattr(bench, "BIG", 4096)
    monkeypatch.setattr(bench, "FEW_CAP", 8192)
    monkeypatch.setattr(bench, "FEW_ROWS", 100)
    monkeypatch.setattr(bench, "cuda_ms", lambda fn: (fn(), 0.0)[1])
    captured = bench.capture(torch, 0.01, torch.device("cpu"))
    assert int(captured["K7 Q18, the most valid rows"][2]) > 0
    cells = bench.run_cells(torch, captured, torch.Generator().manual_seed(1),
                            torch.device("cpu"), False)
    assert set(cells) == set(captured) | set(bench.SYNTHETIC)
    for name, cell in cells.items():
        assert cell["equal_plain"] and cell["same_bits_twice"], name
        assert 0 < cell["bound_bytes"] <= cell["bound_all_rows_bytes"], name
    assert cells["one group over 2^26 rows, int64 sum"]["shape"]["n_groups"] == 1
    few = cells["4,473 valid rows in 2^25, groups of ~7, int64 sum"]["shape"]
    assert (few["cap"], few["n_valid"]) == (8192, 100)
