"""The deferred join's back half on the host: K4 `compact_gather` over the
input tables' columns, K3's second pass over row-major or word-major build
rows, and the recheck plan taken from `key_words` instead of packed rows.

The port's kernels run their plain versions here (CPU tensors); the same
seeded rows go through the JAX package's `hash_join` (its `pairs_table`)
and the port's, which must give the same rows in the same order. The
CUDA wrappers' host-side checks run with their launchers stubbed."""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import join as jjoin
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import _build
from datafusion_parallelism_tpu_torch.kernels import compact_gather as k4
from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
from datafusion_parallelism_tpu_torch.kernels import hash_slot as k1
from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
from datafusion_parallelism_tpu_torch.ops import join as tjoin
from datafusion_parallelism_tpu_torch.ops.hash_table import table_size_for
from datafusion_parallelism_tpu_torch.ops.hashing import KIND_I32, KIND_I64, key_words
from datafusion_parallelism_tpu_torch.utils import columnar as tcol

from oracle import assert_rows_equal

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))


# ---------------------------------------------------------------------------
# seeded tables of every column kind, in both packages
# ---------------------------------------------------------------------------

CITIES = np.array(["lima", "oslo", "pune", "riga", "suva"], dtype=object)


def _tables(pkg, seed: int, n_build: int, n_probe: int, key_space: int):
    """(build, probe) host tables of `pkg`: keys k and k3 (int32), k64
    (int64), kd (date) and kb (bool), values of every kind (int32, int64, date,
    decimal, a dictionary-coded string, float64, float32, bool), 15% nulls
    in keys and values."""
    rng = np.random.default_rng(seed)

    def side(n, p):
        keys = rng.integers(0, key_space, n)
        data = {f"{p}k": keys.astype(np.int32), f"{p}k64": keys * (1 << 33) - 7,
                f"{p}kd": (keys + 9000).astype(np.int32), f"{p}kb": keys % 2 == 0,
                f"{p}k3": (keys * 3 - 5).astype(np.int32),
                f"{p}i": rng.integers(-2**31, 2**31, n).astype(np.int32),
                f"{p}l": rng.integers(-2**62, 2**62, n),
                f"{p}d": rng.integers(0, 20000, n).astype(np.int32),
                f"{p}dec": rng.integers(-10**9, 10**9, n),
                f"{p}s": rng.integers(0, len(CITIES), n).astype(np.int32),
                f"{p}f": np.where(rng.random(n) < 0.05, -0.0, rng.normal(size=n)),
                f"{p}g": rng.normal(size=n).astype(np.float32),
                f"{p}b": rng.random(n) < 0.5}
        dtypes = {f"{p}kd": pkg.DATE32, f"{p}d": pkg.DATE32, f"{p}dec": pkg.DECIMAL(2),
                  f"{p}s": pkg.STRING}
        validity = {name: rng.random(n) >= 0.15 for name in data}
        return pkg.HostTable.from_numpy(data, dtypes,
                                        {f"{p}s": pkg.Dictionary(CITIES)}, validity)
    return side(n_build, "b"), side(n_probe, "p")


KEYS = {"int32": (["bk"], ["pk"]), "int64": (["bk64"], ["pk64"]), "date": (["bkd"], ["pkd"]),
        "bool + int32": (["bkb", "bk"], ["pkb", "pk"]),
        "int64 + date": (["bk64", "bkd"], ["pk64", "pkd"])}


def _rows(t):
    return t.to_host().to_pylist()


@pytest.mark.parametrize("prepared", [False, True], ids=["resident", "prepared"])
@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "RIGHT", "FULL"])
def test_deferred_join_equals_jax_pairs_table(join_type, keys, prepared):
    """compact_gather_plain's columns through the port's hash_join equal
    the JAX package's `pairs_table` output row for row, for every column
    kind with nulls in keys and values, with and without a prepared
    build."""
    bkeys, pkeys = KEYS[keys]
    jb, jp = _tables(jcol, 5, 300, 400, 60)
    tb, tp = _tables(tcol, 5, 300, 400, 60)
    jbd, tbd = jb.to_device(512), tb.to_device(512, device="cpu")
    jpd, tpd = jp.to_device(), tp.to_device(device="cpu")
    jkw, tkw = {}, {}
    if prepared:
        jkw["prepared"] = jjoin.prepare_build(jbd, bkeys)
        tkw["prepared"] = tjoin.prepare_build(tbd, bkeys)
    want, jtotal = jjoin.hash_join(jbd, jpd, bkeys, pkeys, jjoin.JoinType[join_type], 1 << 14,
                                   **jkw)
    got, total = tjoin.hash_join(tbd, tpd, bkeys, pkeys, tjoin.JoinType[join_type], 1 << 14,
                                 **tkw)
    assert int(total) == int(jtotal)
    assert int(got.num_rows) == int(want.num_rows) > 0
    if join_type == "INNER":   # the pairs in the candidates' order
        assert _rows(got) == _rows(want)
    else:
        assert_rows_equal(_rows(got), _rows(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_gather_plain_zeros_past_the_matches(seed):
    """Rows at or past n_match are zeros (float +0.0) and False, the rest
    the gathered rows bit for bit (NaN payloads, -0.0), in slot order."""
    rng = np.random.default_rng(seed)
    cap, out_cap = 50, 300
    f = rng.normal(size=cap)
    f[:5] = -0.0
    f.view(np.uint64)[5:8] = 0x7FF8000000000000 | 0xABC
    cols = [(torch.from_numpy(f), torch.from_numpy(rng.random(cap) < 0.8)),
            (torch.from_numpy(rng.integers(-9, 9, cap)), torch.ones(cap, dtype=torch.bool)),
            (torch.from_numpy(rng.random(cap) < 0.5), torch.from_numpy(rng.random(cap) < 0.5))]
    match = torch.from_numpy(rng.random(out_cap) < 0.4)
    ids = torch.from_numpy(rng.integers(0, cap, out_cap).astype(np.int32))
    out_b, out_p, n = k4.compact_gather_plain(match, ids, ids.flip(0), cols, cols[:1])
    slots = np.flatnonzero(match.numpy())
    assert int(n) == len(slots)
    for (v, valid), (ov, ovalid) in zip(cols, out_b):
        want = v.numpy()[ids.numpy()[slots]]
        got = ov.numpy()
        assert got[:len(slots)].tobytes() == want.tobytes()
        assert (ovalid.numpy()[:len(slots)] == valid.numpy()[ids.numpy()[slots]]).all()
        assert not got[len(slots):].any() and not ovalid.numpy()[len(slots):].any()
        assert np.signbit(got[len(slots):]).sum() == 0
    assert out_p[0][0].numpy()[:len(slots)].tobytes() == \
        cols[0][0].numpy()[ids.flip(0).numpy()[slots]].tobytes()


# ---------------------------------------------------------------------------
# the recheck plan from key_words against the parent's packed plan
# ---------------------------------------------------------------------------

def _packed_plan(blayout, playout, build_keys, probe_keys):
    """The recheck plan the deferred join took from packed rows: packed row
    ids to gather (de-duplicated) and, per key, the word and validity
    (row, bit) indices into them; None for float or mixed-width keys."""
    binfo, pinfo = tjoin._field_info(blayout), tjoin._field_info(playout)
    brows, prows, compares = [], [], []

    def row_of(rows, r):
        if r not in rows:
            rows.append(r)
        return rows.index(r)

    for bk, pk in zip(build_keys, probe_keys):
        kb, sb, nb, vwb, bb = binfo[bk]
        kp, sp, np_, vwp, bp = pinfo[pk]
        if (nb != np_ or nb == 0 or kb in (tcol.Kind.FLOAT64, tcol.Kind.FLOAT32)
                or kp in (tcol.Kind.FLOAT64, tcol.Kind.FLOAT32)):
            return None
        compares.append(([row_of(brows, sb + i) for i in range(nb)],
                         [row_of(prows, sp + i) for i in range(nb)],
                         (row_of(brows, vwb), bb), (row_of(prows, vwp), bp)))
    return brows, prows, compares


def _hash_cols(compares, side):
    return [(KIND_I32 if len(c[side]) == 1 else KIND_I64, tuple(c[side]), c[2 + side])
            for c in compares]


def _candidates(bwords, bcols, pwords, pcols, compares, T, build, probe, pkeys,
                row_major=False, brows=None):
    """K1 over both sides, K2 (over `brows`, else bwords), K3's two passes
    (plain versions): the hashes, slots, table and (match, probe_idx,
    build_id)."""
    bh, bslot = k1.hash_slot_plain(bwords, bcols, T, build.num_rows)
    _, offsets, perm, _, rows = k2.csr_build_plain(bslot, T, bwords if brows is None else brows,
                                                   row_major)
    ph, pslot = k1.hash_slot_plain(pwords, pcols, T)
    ok = probe.row_mask()
    for k in pkeys:
        ok = ok & probe.column(k)[1]
    ranges = k3.probe_ranges_plain(pslot, ok, offsets)
    found = k3.expand_ranges_plain(*ranges, pwords, rows, compares, 1 << 15)
    return (bh, bslot, ph, pslot, offsets, perm) + tuple(found)


@pytest.mark.parametrize("n_keys", [1, 2, 3, 4, 5])
def test_key_words_plan_equals_the_packed_plan(n_keys):
    """The plan from key_words' rows finds the same hashes, slots, perm,
    offsets and candidates (match, probe_idx, build_id) as the plan from
    the packed rows, on 1-5 keys (5 is past one launch's 4 keys: two key
    groups on the card). As the join builds it, the new plan tests no
    build-side validity and K2 carries the build's key words alone: null
    build keys (15% here) never become candidates."""
    names = ["k", "k64", "kd", "kb", "k3"][:n_keys]
    bkeys, pkeys = [f"b{n}" for n in names], [f"p{n}" for n in names]
    build, probe = (t.to_device(device="cpu") for t in _tables(tcol, 11, 400, 500, 6))
    bp, pp = tcol.pack_table(build, CHAIN_PLAIN), tcol.pack_table(probe, CHAIN_PLAIN)
    brows, prows, old = _packed_plan(bp.layout, pp.layout, bkeys, pkeys)
    bnarrow = torch.stack([bp.packed[r] for r in brows])
    pnarrow = torch.stack([pp.packed[r] for r in prows])
    bwords, bcols = key_words([build.column(k) for k in bkeys])
    pwords, pcols = key_words([probe.column(k) for k in pkeys])
    new = tjoin._defer_key_plan(tjoin._word_keys(bcols, valid=False), tjoin._word_keys(pcols))
    assert len(k3.key_groups(new)) == (2 if n_keys == 5 else 1)
    assert all(c[2] is None for c in new) and all(c[2] is not None for c in old)
    key_rows = bwords[:bwords.shape[0] - n_keys]
    assert key_rows.shape[0] + 1 <= k2.MAX_ROW_WORDS
    T = table_size_for(build.capacity)
    want = _candidates(bnarrow, _hash_cols(old, 0), pnarrow, _hash_cols(old, 1), old, T,
                       build, probe, pkeys)
    for row_major in (False, True):
        got = _candidates(bwords, bcols, pwords, pcols, new, T, build, probe, pkeys,
                          row_major, key_rows)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    assert int(want[-3].sum()) > 0


@pytest.mark.parametrize("keys", [(["bf"], ["pf"]), (["bg"], ["pg"]), (["bk"], ["pk64"]),
                                  (["bk64", "bk"], ["pk64", "pl"])],
                         ids=["float64", "float32", "int32 x int64", "mixed widths"])
def test_no_plan_for_float_or_mixed_width_keys(keys):
    build, probe = (t.to_device(device="cpu") for t in _tables(tcol, 3, 50, 60, 9))
    bcols = key_words([build.column(k) for k in keys[0]])[1]
    pcols = key_words([probe.column(k) for k in keys[1]])[1]
    assert tjoin._defer_key_plan(tjoin._word_keys(bcols), tjoin._word_keys(pcols)) is None
    bp = tcol.pack_table(build, CHAIN_PLAIN)
    assert tjoin._defer_key_plan(tjoin._packed_keys(bp.layout, keys[0]),
                                 tjoin._word_keys(pcols)) is None


# ---------------------------------------------------------------------------
# K3's second pass under both layouts of the build rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 2, 3, 4, 6, 7])
def test_expand_ranges_plain_is_the_same_under_both_layouts(R):
    """expand_ranges_plain over row-major build rows (K2's row_major) gives
    what it gives over the same rows word-major."""
    rng = np.random.default_rng(R)
    n, m, T = 3000, 2000, 4096
    slot = torch.from_numpy(rng.integers(0, T + 1, n).astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, 3, (R, n)).astype(np.int32))
    word = k2.csr_build_plain(slot, T, rows)
    row = k2.csr_build_plain(slot, T, rows, True)
    for a, b in zip(word, row, strict=True):
        assert torch.equal(a, b)
    rm = row[4]
    assert rm.stride() == (1, k2.row_words(R)) and not rm.is_contiguous()
    assert k3.build_strides(rm) == (1, k2.row_words(R)) or rm.data_ptr() % 16
    pslot = torch.from_numpy(rng.integers(0, T + 1, m).astype(np.int32))
    ok = torch.from_numpy(rng.random(m) < 0.9)
    pwords = torch.from_numpy(rng.integers(0, 3, (R, m)).astype(np.int32))
    compares = [([w], [w], (w, 0), (w, 0)) for w in range(R)]
    ranges = k3.probe_ranges_plain(pslot, ok, word[1])
    for out_cap in (int(ranges[3]) // 2 + 1, int(ranges[3]) + 100):
        a = k3.expand_ranges_plain(*ranges, pwords, word[4], compares, out_cap)
        b = k3.expand_ranges_plain(*ranges, pwords, rm, compares, out_cap)
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y)


def test_row_words_pads_to_four_or_eight():
    assert [k2.row_words(R) for R in range(8)] == [4, 4, 4, 4, 8, 8, 8, 8]
    with pytest.raises(ValueError, match="row-major"):
        k2.row_words(8)


# ---------------------------------------------------------------------------
# no pack on the deferred INNER path
# ---------------------------------------------------------------------------

def _refuse(*args):
    raise AssertionError("the deferred INNER join packed or unpacked a table")


@pytest.mark.parametrize("strategy", ["CSR", "SORT", "OA"])
def test_deferred_inner_join_packs_nothing(strategy):
    """A deferred INNER join whose chain's pack_rows and unpack_rows raise
    runs to its end: no K12 launch is left on that path; and it equals the
    JAX package's join."""
    jb, jp = _tables(jcol, 7, 200, 300, 40)
    tb, tp = _tables(tcol, 7, 200, 300, 40)
    chain = CHAIN_PLAIN._replace(pack_rows=_refuse, unpack_rows=_refuse)
    got, total = tjoin.hash_join(tb.to_device(device="cpu"), tp.to_device(device="cpu"),
                                 ["bk64"], ["pk64"], tjoin.JoinType.INNER, 1 << 14,
                                 strategy=tjoin.JoinStrategy[strategy], kernels=tjoin.PLAIN,
                                 chain=chain)
    from datafusion_parallelism_tpu.ops import hash_table as jht
    want, jtotal = jjoin.hash_join(jb.to_device(), jp.to_device(), ["bk64"], ["pk64"],
                                   jjoin.JoinType.INNER, 1 << 14,
                                   strategy=jht.JoinStrategy[strategy])
    assert int(total) == int(jtotal) and int(got.num_rows) > 0
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("strategy", ["CSR", "SORT"])
def test_deferred_join_hands_k2_the_key_words_alone(keys, strategy):
    """The resident deferred join's build rows are its key words (no 0/1
    validity rows), row-major under CSR, and its recheck plan tests the
    probe's validity alone; a prepared build keeps its packed validity."""
    seen = {}

    def csr_build(slot, T, rows, row_major=False):
        seen.update(rows=rows.shape[0], row_major=row_major)
        return k2.csr_build_plain(slot, T, rows, row_major)

    def gather_rows(words, f64, perm, count=None):
        seen.setdefault("rows", words.shape[0] - 1)
        return CHAIN_PLAIN.gather_rows(words, f64, perm, count)

    def expand(*args):
        seen["plan"] = args[6]
        return k3.expand_ranges_plain(*args)
    kernels = tjoin.PLAIN._replace(csr_build=csr_build, expand_ranges=expand)
    chain = CHAIN_PLAIN._replace(gather_rows=gather_rows)
    bkeys, pkeys = KEYS[keys]
    tb, tp = _tables(tcol, 9, 200, 300, 40)
    build, probe = tb.to_device(device="cpu"), tp.to_device(device="cpu")
    n_words = key_words([build.column(k) for k in bkeys])[0].shape[0] - len(bkeys)
    tjoin.hash_join(build, probe, bkeys, pkeys, tjoin.JoinType.INNER, 1 << 14,
                    strategy=tjoin.JoinStrategy[strategy], kernels=kernels, chain=chain)
    assert seen["rows"] == n_words
    assert seen.get("row_major", False) == (strategy == "CSR")
    assert [c[2] for c in seen["plan"]] == [None] * len(bkeys)
    assert all(c[3] is not None for c in seen["plan"])
    prepared = tjoin.prepare_build(build, bkeys, tjoin.JoinStrategy[strategy], kernels, chain)
    tjoin.hash_join(build, probe, bkeys, pkeys, tjoin.JoinType.INNER, 1 << 14,
                    strategy=tjoin.JoinStrategy[strategy], kernels=kernels, chain=chain,
                    prepared=prepared)
    assert all(c[2] is not None for c in seen["plan"])


def test_the_full_fetch_still_packs():
    """The refusing chain above is not vacuous: a join that takes the full
    fetch (float keys) reaches K12's pack."""
    tb, tp = _tables(tcol, 7, 50, 60, 9)
    chain = CHAIN_PLAIN._replace(pack_rows=_refuse, unpack_rows=_refuse)
    with pytest.raises(AssertionError, match="packed"):
        tjoin.hash_join(tb.to_device(device="cpu"), tp.to_device(device="cpu"), ["bf"], ["pf"],
                        tjoin.JoinType.INNER, 1 << 12, chain=chain)


# ---------------------------------------------------------------------------
# the wrappers' host checks, with the launchers stubbed
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_launch(monkeypatch):
    """_build's device checks pass, its C entry points record their
    arguments (a K4 spec read back as its columns) and succeed."""
    calls = []

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*args):
            if name == "dfp_compact_gather":
                spec = args[0]._obj
                args = ([(spec.c[k].width, spec.c[k].side) for k in range(spec.n)],) + args[1:]
            calls.append((name, args))
            return 64 if name.endswith("scratch_bytes") else 0
        return fn

    def require(t, name, dtype, shape=None, device=None, contiguous=True):
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")

    monkeypatch.setattr(_build, "require", require)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    return calls


class _Cuda(torch.Tensor):
    """A CPU tensor that a wrapper's `is_cuda` test takes for a card's, so
    that its launch path runs against the stubbed launchers."""

    @property
    def is_cuda(self):
        return True


def _launch_k4(build_cols, probe_cols, n=16, total=None):
    """K4's CUDA launch path on CPU tensors."""
    match = torch.zeros(n, dtype=torch.bool).as_subclass(_Cuda)
    ids = torch.zeros(n, dtype=torch.int32)
    return k4.compact_gather(match, ids, ids, build_cols, probe_cols, total)


def _cols(n_cols, cap=8, dtype=torch.int32):
    return [(torch.zeros(cap, dtype=dtype), torch.ones(cap, dtype=torch.bool))
            for _ in range(n_cols)]


@pytest.mark.parametrize("n_build,n_probe,launches", [(1, 1, 1), (64, 0, 1), (63, 2, 2),
                                                      (70, 5, 2), (100, 100, 4), (0, 0, 1)])
def test_compact_gather_takes_a_launch_a_group_of_columns(stub_launch, n_build, n_probe,
                                                          launches):
    """Past MAX_COLS descriptors the columns split over launches, build's
    first, each with its side; every output column has the capacity
    out_cap."""
    out_b, out_p, _ = _launch_k4(_cols(n_build), _cols(n_probe, 5))
    runs = [args for name, args in stub_launch if name == "dfp_compact_gather"]
    assert len(runs) == launches == len(k4.col_groups(n_build, n_probe))
    described = [c for args in runs for c in args[0]]
    assert described == [(4, 0)] * n_build + [(4, 1)] * n_probe
    assert all(len(args[0]) <= k4.MAX_COLS for args in runs)
    assert all(v.shape == (16,) and valid.dtype == torch.bool for v, valid in out_b + out_p)


def test_compact_gather_describes_each_width(stub_launch):
    cols = [(torch.zeros(8, dtype=dt), torch.ones(8, dtype=torch.bool))
            for dt in (torch.float64, torch.int64, torch.int32, torch.float32, torch.bool)]
    out_b, _, _ = _launch_k4(cols, cols[:1], total=torch.tensor(9, dtype=torch.int32))
    (name, args), = [c for c in stub_launch if c[0] == "dfp_compact_gather"]
    assert args[0] == [(8, 0), (8, 0), (4, 0), (4, 0), (1, 0), (8, 1)]
    assert [v.dtype for v, _ in out_b] == [v.dtype for v, _ in cols]


@pytest.mark.parametrize("bad", ["dtype", "capacity", "validity", "total"])
def test_compact_gather_refuses_what_it_cannot_read(stub_launch, bad):
    cols = _cols(2)
    total = None
    if bad == "dtype":
        cols[1] = (torch.zeros(8, dtype=torch.int16), cols[1][1])
    elif bad == "capacity":
        cols[1] = (torch.zeros(9, dtype=torch.int32), torch.ones(9, dtype=torch.bool))
    elif bad == "validity":
        cols[1] = (cols[1][0], torch.ones(8, dtype=torch.uint8))
    else:
        total = torch.tensor(3, dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        _launch_k4(cols, _cols(1), total=total)
    assert not [c for c in stub_launch if c[0] == "dfp_compact_gather"]


@pytest.mark.parametrize("bvalid,vb_row", [((1, 0), 1), (None, -1)],
                         ids=["build validity", "none"])
def test_expand_ranges_hands_the_kernel_the_build_strides(stub_launch, bvalid, vb_row):
    """The second pass gets the build rows' word and row strides: (n, 1)
    word-major, (1, 4 or 8) row-major; other strides are refused. A key
    without a build validity row reaches the kernel's spec as row -1."""
    m, n = 6, 40
    start = torch.zeros(m, dtype=torch.int32)
    total = torch.tensor(5, dtype=torch.int32)
    pwords = torch.zeros((3, m), dtype=torch.int32)
    plan = [([0], [0], bvalid, (1, 0))]
    word = torch.zeros((3, n), dtype=torch.int32)
    for rows, strides in ((word, (n, 1)), (k2.to_row_major(word), (1, 4)),
                          (k2.to_row_major(torch.zeros((6, n), dtype=torch.int32)), (1, 8))):
        if rows.data_ptr() % 16:
            continue
        del stub_launch[:]
        k3.expand_ranges(start.as_subclass(_Cuda), start, start, total, pwords, rows, plan, 8)
        (name, args), = [c for c in stub_launch if c[0] == "dfp_probe_expand"]
        assert name == "dfp_probe_expand" and (args[7], args[8]) == strides
        # the spec: n_eq, eq_b[8], eq_p[8], n_keys, vb_row[4], ...
        assert args[9] == rows.shape[0] and list(args[10])[17:19] == [1, vb_row]
    odd = torch.zeros((n, 3), dtype=torch.int32).t()   # row stride 3: no vector load
    with pytest.raises(ValueError, match="strides"):
        k3.build_strides(odd)


def test_csr_build_row_major_launch_plan(stub_launch):
    """Row-major rows: the kernel gets the padded width and a perm buffer of
    its own; rows_out is the [R+1, n] view of an [n, width] buffer."""
    slot = torch.zeros(10, dtype=torch.int32)
    counts, offsets, perm, start_count, rows_out = k2._launch(
        slot, 64, torch.zeros((4, 10), dtype=torch.int32), True)
    (name, args), = [c for c in stub_launch if c[0] == "dfp_csr_build"]
    assert args[11] == 8 and args[9] == perm.data_ptr() and args[10] == rows_out.data_ptr()
    assert rows_out.shape == (5, 10) and rows_out.stride() == (1, 8)
    assert perm.shape == (10,) and perm.is_contiguous()
    with pytest.raises(ValueError, match="row-major"):
        k2._launch(slot, 64, torch.zeros((8, 10), dtype=torch.int32), True)


# ---------------------------------------------------------------------------
# tools/profile_sql.py: K12's stage split by its caller
# ---------------------------------------------------------------------------

def test_profile_sql_charges_k12_calls_from_the_join_to_the_join(monkeypatch):
    import profile_sql
    names = []

    class Range:
        def __init__(self, name):
            names.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    wrapped = profile_sql._wrap("pack_rows", lambda *a: "packed")
    scope = {"wrapped": wrapped}
    exec(compile("def call():\n    return wrapped()\n",
                 os.path.join("pkg", "ops", "join.py"), "exec"), scope)
    assert scope["call"]() == "packed" and wrapped() == "packed"
    assert names == ["stage:pack_rows@join", "stage:pack_rows"]
    stage_ms = {"pack_rows": 2.0, profile_sql.JOIN_K12: 3.0}
    assert profile_sql.join_caller(stage_ms) == {"join": 3.0, "other": 2.0}
    assert stage_ms == {"pack_rows": 5.0}


def test_k4_bound_counts_the_matches_and_the_whole_output():
    """chip_smoke's K4 bound: the flags of the slots below min(total,
    out_cap), two ids a match, each match's values and validity read,
    every output column written whole, the count."""
    import chip_smoke
    cols = [(torch.zeros(10, dtype=torch.float64), torch.ones(10, dtype=torch.bool)),
            (torch.zeros(10, dtype=torch.bool), torch.ones(10, dtype=torch.bool))]
    probe = [(torch.zeros(7, dtype=torch.int32), torch.ones(7, dtype=torch.bool))]
    row = (8 + 1) + (1 + 1) + (4 + 1)
    assert chip_smoke.k4_bytes(100, 40, 30, cols, probe) == 40 + 8 * 30 + row * 130 + 8
    match = torch.zeros(100, dtype=torch.bool)
    match[:30] = True
    ids = torch.zeros(100, dtype=torch.int32)
    args = (match, ids, ids, cols, probe, torch.tensor(40, dtype=torch.int32))
    out = k4.compact_gather_plain(*args)
    assert chip_smoke.work(("join", "compact_gather"), args, out) == \
        (chip_smoke.k4_bytes(100, 40, 30, cols, probe), 0)
