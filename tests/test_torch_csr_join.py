"""The CSR join's build (K2 csr_build) and probe (K3 probe_ranges,
expand_ranges) on the host: their plain versions against the JAX package
on seeded tables and edge cases, the launch plans of the CUDA kernels
(digit passes from T, the fill's tiles, K3's first-pass tiles), K2's
T-side fill replayed in numpy against the plain version, and the wrappers'
host checks. Exact: every array is integer."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu.ops import hashing as jh
from datafusion_parallelism_tpu_torch.kernels import _build
from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
from datafusion_parallelism_tpu_torch.ops import hash_table as tht
from datafusion_parallelism_tpu_torch.utils.convert import join_table_from_reference

# ---------------------------------------------------------------------------
# K2's T-side fill, replayed in numpy from its launch plan
# ---------------------------------------------------------------------------


def fill_replay(sorted_keys: np.ndarray, T: int):
    """(offsets, start_count) as csrc/csr_build.cu's FILL writes them from
    the sorted bucket ids: tile bounds by one search a tile, then per tile
    the counts from run boundaries (or, past FILL_SCAN_KEYS keys, one
    search a bucket) and the offsets from their scan."""
    tiles = k2.fill_tiles(T)
    first = np.searchsorted(sorted_keys, np.arange(tiles + 1, dtype=np.int64) * k2.FILL_TILE)
    offsets = np.full(T + 2, -1, np.int64)
    start_count = np.full((2, T + 1), -1, np.int64)
    for t in range(tiles):
        b0, lo, hi = t * k2.FILL_TILE, first[t], first[t + 1]
        keys = sorted_keys[lo:hi].astype(np.int64)
        if hi - lo <= k2.FILL_SCAN_KEYS:
            cnt = np.zeros(k2.FILL_TILE, np.int64)
            i = np.arange(hi - lo)
            starts = (i == 0) | (np.roll(keys, 1) != keys)
            ends = (i == hi - lo - 1) | (np.roll(keys, -1) != keys)
            np.add.at(cnt, keys[starts] - b0, -i[starts])
            np.add.at(cnt, keys[ends] - b0, i[ends] + 1)
        else:
            ends = np.searchsorted(keys, b0 + np.arange(k2.FILL_TILE), side="right")
            cnt = np.diff(np.concatenate([[0], ends]))
        off = lo + np.concatenate([[0], np.cumsum(cnt)[:-1]])
        nxt = np.concatenate([off[1:], [hi]])
        b = b0 + np.arange(k2.FILL_TILE)
        keep = b <= T + 1
        offsets[b[keep]] = off[keep]
        keep = b <= T
        start_count[0, b[keep]] = off[keep]
        start_count[1, b[keep]] = (nxt - off)[keep]
    assert (offsets >= 0).all() and (start_count >= 0).all()   # every bucket written
    return offsets, start_count


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

T_CASES = [1, 2, 255, 256, 65_536, 3 * (1 << 20) + 7, 1 << 24, (1 << 27) + 5, 2**31 - 3]


@pytest.mark.parametrize("T", T_CASES)
def test_digit_passes_cover_the_bits_of_T(T):
    widths = k2.digit_passes(T)
    assert sum(widths) == T.bit_length()
    assert len(widths) == -(-T.bit_length() // k2.DIGIT_BITS)
    assert all(w == k2.DIGIT_BITS for w in widths[:-1]) and 1 <= widths[-1] <= k2.DIGIT_BITS


@pytest.mark.parametrize("T", T_CASES)
def test_fill_tiles_split_the_buckets(T):
    """Every one of the T + 2 offsets lies in exactly one fill tile."""
    tiles = k2.fill_tiles(T)
    assert (tiles - 1) * k2.FILL_TILE < T + 2 <= tiles * k2.FILL_TILE


def _slots(case: str, rng):
    """(slot int32[n], T) of one K2 edge case the CPU can hold."""
    if case == "T = 1":
        return rng.integers(0, 2, 3000), 1
    if case == "T = 255, one digit pass":
        return rng.integers(0, 256, 5000), 255
    if case == "n = 1":
        return np.array([17]), 65_536
    if case == "n = 0":
        return np.zeros(0, np.int64), 65_536
    if case == "n not a multiple of the tile":
        return rng.integers(0, 4 * 9001 + 1, 9001), 4 * 9001
    if case == "sparse: 10% valid, the rest in bucket T":
        T = 1 << 20
        s = np.full(T // 4, T)
        s[: T // 40] = rng.integers(0, T, T // 40)
        return s, T
    if case == "every row in bucket T":
        return np.full(50_000, 1 << 18), 1 << 18
    if case == "hot key: half the rows in one bucket":
        s = rng.integers(0, 1 << 18, 80_000)
        s[rng.random(80_000) < 0.5] = 12_345
        return s, 1 << 18
    if case == "T not a power of two":
        T = 3 * (1 << 16) + 7
        return rng.integers(0, T + 1, 40_000), T
    raise KeyError(case)


K2_CASES = ["T = 1", "T = 255, one digit pass", "n = 1", "n = 0",
            "n not a multiple of the tile", "sparse: 10% valid, the rest in bucket T",
            "every row in bucket T", "hot key: half the rows in one bucket",
            "T not a power of two"]


@pytest.mark.parametrize("case", K2_CASES)
def test_fill_replay_equals_csr_build_plain(case):
    """The FILL design's tiles, run boundaries and per-bucket searches give
    csr_build_plain's offsets and start_count (counts its second row)."""
    slot, T = _slots(case, np.random.default_rng(K2_CASES.index(case)))
    slot = torch.from_numpy(slot.astype(np.int32))
    counts, offsets, perm, start_count, rows_out = k2.csr_build_plain(
        slot, T, torch.empty((0, slot.shape[0]), dtype=torch.int32))
    got_off, got_sc = fill_replay(np.sort(slot.numpy(), kind="stable"), T)
    np.testing.assert_array_equal(got_off, offsets.numpy())
    np.testing.assert_array_equal(got_sc, start_count.numpy())
    assert torch.equal(counts, start_count[1]) and torch.equal(perm, rows_out[-1])


def _jax_build(keys, valid, num_rows):
    """The JAX package's CSR table and the hashes, as int32 tensors."""
    jhash = jh.hash_rows([(jnp.asarray(keys), jnp.asarray(valid))])
    return (jht.build_csr(jhash, jnp.asarray(valid), num_rows),
            torch.from_numpy(np.asarray(jhash).view(np.int32).copy()))


@pytest.mark.parametrize("case", ["every row in bucket T", "n = 1", "hot key",
                                  "T not a power of two"])
def test_csr_build_plain_matches_jax_on_edge_cases(case):
    """K2's plain version, through the port's build_csr, against the JAX
    package's build_csr: every row padding, one row, a hot key (half the
    rows), and a capacity whose table size is not a power of two."""
    rng = np.random.default_rng(3)
    cap = {"n = 1": 1, "T not a power of two": 20_000}.get(case, 4096)
    keys = rng.integers(0, cap, cap).astype(np.int32)
    if case == "hot key":
        keys[rng.random(cap) < 0.5] = 5
    valid = np.ones(cap, bool)
    num_rows = 0 if case == "every row in bucket T" else cap
    jt, th = _jax_build(keys, valid, num_rows)
    tt = tht.build_csr(th, torch.from_numpy(valid), torch.tensor(num_rows, dtype=torch.int32))
    np.testing.assert_array_equal(tt.offsets.numpy(), np.asarray(jt.offsets))
    np.testing.assert_array_equal(tt.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(tt.start_count.numpy(), np.asarray(jt.start_count))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, k3.RANGE_TILE - 1, k3.RANGE_TILE, k3.RANGE_TILE + 1,
                               67_108_864])
def test_range_tiles_cover_the_probe_rows(m):
    tiles = k3.range_tiles(m)
    assert (tiles - 1) * k3.RANGE_TILE < m <= tiles * k3.RANGE_TILE


def _probe_case(case: str, rng):
    """(build keys, build valid, probe keys, probe ok) of one K3 edge case."""
    cap = 4096
    bk = rng.integers(0, cap // 2, cap).astype(np.int32)
    pk = rng.integers(0, cap // 2, cap).astype(np.int32)
    bv, pv = np.ones(cap, bool), np.ones(cap, bool)
    if case == "total 0: no key in common":
        pk += cap
    elif case == "total 0: every probe key null":
        pv[:] = False
    elif case == "one probe row owns every candidate":
        bk[:] = 9
        pk[:] = cap + 1
        pk[cap // 3] = 9
    elif case == "m = 1":
        pk = pk[:1]
        pv = pv[:1]
    elif case == "nulls on both sides":
        bv = rng.random(cap) >= 0.1
        pv = rng.random(cap) >= 0.1
    return bk, bv, pk, pv


K3_CASES = ["total 0: no key in common", "total 0: every probe key null",
            "one probe row owns every candidate", "m = 1", "nulls on both sides"]


@pytest.mark.parametrize("case", K3_CASES)
def test_probe_ranges_from_offsets_match_jax(case):
    """probe_ranges_plain over the table's offsets gives the JAX package's
    probe_candidates (start, count, base, total), on the JAX package's own
    table and on the port's."""
    bk, bv, pk, pv = _probe_case(case, np.random.default_rng(K3_CASES.index(case)))
    jt, th = _jax_build(bk, bv, bk.shape[0])
    tt = tht.build_csr(th, torch.from_numpy(bv), torch.tensor(bk.shape[0], dtype=torch.int32))
    jph = jh.hash_rows([(jnp.asarray(pk), jnp.asarray(pv))])
    cr = jht.probe_candidates(jt, jph, jnp.asarray(pv), pk.shape[0])
    ph = torch.from_numpy(np.asarray(jph).view(np.int32).copy())
    T = tht.table_size_for(bk.shape[0])
    ok = torch.from_numpy(pv)
    ref = join_table_from_reference(jt.offsets, jt.perm, jt.start_count, device="cpu")
    for offsets in (ref.offsets, tt.offsets):
        start, count, base, total = k3.probe_ranges_plain(tht.slot_of(ph, T), ok, offsets)
        np.testing.assert_array_equal(start.numpy(), np.asarray(cr.start))
        np.testing.assert_array_equal(count.numpy(), np.asarray(cr.count))
        np.testing.assert_array_equal(base.numpy(), np.asarray(cr.base))
        assert int(total) == int(cr.total)


# ---------------------------------------------------------------------------
# the wrappers' host checks, with the launchers stubbed
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_launch(monkeypatch):
    """_build's device checks pass, its C entry points record their
    arguments and succeed, sizes of scratch are 64 bytes."""
    calls = []

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*args):
            calls.append((name, args))
            return 64 if name.endswith("scratch_bytes") else 0
        return fn

    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(k3, "check_total", lambda total: total.to(torch.int32))
    return calls


@pytest.mark.parametrize("T", [1, 255, 1 << 20, (1 << 27) + 1])
def test_csr_build_launch_plan(stub_launch, T):
    """The launch hands the kernel digit_passes(T) and buffers of the
    contract's shapes; counts and perm are views of start_count and
    rows_out."""
    slot = torch.zeros(10, dtype=torch.int32)
    if T > 1 << 20:   # no buffers of 2^27 on the host: only the plan
        assert k2.digit_passes(T) == (8, 8, 8, 4)
        return
    counts, offsets, perm, start_count, rows_out = k2._launch(
        slot, T, torch.zeros((3, 10), dtype=torch.int32))
    (name, args), = [c for c in stub_launch if c[0] == "dfp_csr_build"]
    widths = k2.digit_passes(T)
    assert list(args[5][:len(widths)]) == list(widths) and args[6] == len(widths)
    assert offsets.shape == (T + 2,) and start_count.shape == (2, T + 1)
    assert rows_out.shape == (4, 10) and perm.data_ptr() == rows_out[3].data_ptr()
    assert counts.data_ptr() == start_count[1].data_ptr() and counts.shape == (T + 1,)


@pytest.mark.parametrize("T", [0, -3, 2**31 - 2])
def test_csr_build_refuses_a_table_size_out_of_range(stub_launch, T):
    with pytest.raises(ValueError, match="table size"):
        k2._launch(torch.zeros(4, dtype=torch.int32), T, torch.zeros((0, 4), dtype=torch.int32))


def test_csr_build_refuses_rows_not_a_matrix(stub_launch):
    with pytest.raises(ValueError, match="rows"):
        k2._launch(torch.zeros(4, dtype=torch.int32), 8, torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("m", [1, k3.RANGE_TILE + 1])
def test_probe_ranges_launch_plan(stub_launch, m):
    """The first pass gets the table's offsets and look-back scratch of
    8 bytes a tile and 8 for the counter."""
    offsets = torch.zeros(66, dtype=torch.int32)
    k3._ranges_launch(torch.zeros(m, dtype=torch.int32), torch.ones(m, dtype=torch.bool), offsets)
    (name, args), = stub_launch
    assert name == "dfp_probe_ranges" and args[2] == m and args[3] == offsets.data_ptr()
    assert args[9] == 8 * (k3.range_tiles(m) + 1)


@pytest.mark.parametrize("offsets", [torch.zeros((2, 33), dtype=torch.int32),
                                     torch.zeros(2, dtype=torch.int32)],
                         ids=["start_count's shape", "too short"])
def test_probe_ranges_refuses_anything_but_offsets(stub_launch, offsets):
    with pytest.raises(ValueError, match="offsets"):
        k3._ranges_launch(torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                          offsets)


def test_probe_ranges_refuses_an_empty_probe(stub_launch):
    with pytest.raises(ValueError, match="no rows"):
        k3._ranges_launch(torch.zeros(0, dtype=torch.int32), torch.ones(0, dtype=torch.bool),
                          torch.zeros(66, dtype=torch.int32))


def test_expand_ranges_refuses_what_it_refused(stub_launch):
    start = torch.zeros(4, dtype=torch.int32)
    words = torch.zeros((2, 4), dtype=torch.int32)
    plan = [([0], [0], (0, 31), (0, 31))]
    with pytest.raises(ValueError, match="out_cap"):
        k3._check_expand(start, words, words, plan, 0)
    with pytest.raises(ValueError, match="word row"):
        k3._check_expand(start, words, words, [([1], [0], (0, 31), (0, 31))], 8)
    too_many = [([0], [0], (0, 31), (0, 31))] * 9
    assert len(k3._check_expand(start, words, torch.zeros((2, 4), dtype=torch.int32),
                                too_many, 8)) == 3     # 4 + 4 + 1 keys: three launches
