"""The plain versions of the port's kernels K5-K8 against the JAX functions
they replace, on seeded numpy inputs, on the CPU. (The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.)

Tolerances: bit-exact for permutations, compaction order, counts, integer
sums, min/max and group boundaries; float64 sums within rtol 1e-9 +
1e-12 * sum|x|, since the two reduce in different orders. Rows past a
survivor or group count are not compared except for their (zero) validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from datafusion_parallelism_tpu.ops import aggregate as jagg
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import _agg
from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
from datafusion_parallelism_tpu_torch.kernels import segment_agg as k7
from datafusion_parallelism_tpu_torch.ops.hashing import key_words
from datafusion_parallelism_tpu_torch.ops.sort import float_sort_bits
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference

FLOAT_RTOL, FLOAT_ATOL_PER_ABS = 1e-9, 1e-12


# ---------------------------------------------------------------------------
# K5 filter_compact
# ---------------------------------------------------------------------------

def _packed(rng, cap, W=4, vb=2):
    words = rng.integers(-2**31, 2**31, (W, cap)).astype(np.int32)
    f64 = {"x": rng.normal(size=cap), "y": rng.normal(size=cap)}
    jlayout = jcol.PackedLayout((), ("x", "y"), vb, W)
    tlayout = tcol.PackedLayout((), ("x", "y"), vb, W)
    jpt = jcol.PackedTable(jnp.asarray(words), {k: jnp.asarray(v) for k, v in f64.items()},
                           jlayout)
    tpt = tcol.PackedTable(torch.from_numpy(words),
                           {k: torch.from_numpy(v) for k, v in f64.items()}, tlayout)
    return jpt, tpt


COMPACT_CASES = {
    # name: (cap, selectivity, out_cap)
    "half": (1000, 0.5, 1000),
    "none_survive": (512, 0.0, 512),
    "all_survive": (512, 1.0, 512),
    "out_cap_overflow": (1000, 0.6, 128),
    "sparse": (4096, 0.01, 4096),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_rows_matches_jax(case):
    cap, p, out_cap = COMPACT_CASES[case]
    rng = np.random.default_rng(len(case))
    mask = rng.random(cap) < p
    jpt, tpt = _packed(rng, cap)
    (jout,), jn = jcol.compact_rows([jpt], jnp.asarray(mask), out_cap)
    (tout,), tn = tcol.compact_rows([tpt], torch.from_numpy(mask), out_cap)
    assert int(tn) == int(jn) == int(mask.sum())
    k = min(int(tn), out_cap)
    np.testing.assert_array_equal(tout.packed[:, :k].numpy(), np.asarray(jout.packed)[:, :k])
    for name in ("x", "y"):
        np.testing.assert_array_equal(tout.f64s[name][:k].numpy().view(np.int64),
                                      np.asarray(jout.f64s[name])[:k].view(np.int64))
    # validity words past the count are zero in both (the port zeroes the
    # whole row)
    assert not np.asarray(jout.packed)[2:, k:].any()
    assert not tout.packed[:, k:].any() and not tout.f64s["x"][k:].any()


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compaction_indices_matches_jax(p):
    rng = np.random.default_rng(int(p * 10))
    mask = rng.random(777) < p
    jidx, jn = jcol.compaction_indices(jnp.asarray(mask))
    tidx, tn = tcol.compaction_indices(torch.from_numpy(mask))
    n = int(jn)
    assert int(tn) == n and tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx[:n].numpy(), np.asarray(jidx)[:n])


def test_filter_compact_plain_out_cap_past_cap():
    """out_cap above the input capacity: the survivors, then zeros."""
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random(100) < 0.5)
    words = torch.from_numpy(rng.integers(0, 9, (2, 100)).astype(np.int32))
    f64 = torch.from_numpy(rng.random((1, 100)))
    out, out_f64, n = k5.filter_compact_plain(mask, words, f64, 300)
    assert out.shape == (2, 300) and int(n) == int(mask.sum())
    np.testing.assert_array_equal(out[:, :int(n)].numpy(), words[:, mask].numpy())
    assert not out[:, int(n):].any() and not out_f64[:, int(n):].any()


@pytest.mark.parametrize("entry", ["gather_rows", "gather_rows_counted", "filter_compact"])
def test_float64_sidecars_move_bit_for_bit(entry):
    """K5's plain entries copy sidecar bits: int64 keys below 2^34 (denormal
    doubles, as the SORT build carries them), NaN payloads and -0.0 come
    out as they went in, also with denormals flushed in arithmetic."""
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 1 << 34, (2, 64))
    bits[1, :3] = [0x7FF8_0000_0000_BEEF, np.int64(-1), np.int64(-(1 << 63))]
    f64 = torch.from_numpy(bits).view(torch.float64)
    words = torch.from_numpy(rng.integers(0, 9, (1, 64)).astype(np.int32))
    idx = torch.from_numpy(rng.permutation(64).astype(np.int32))
    mask = torch.from_numpy(rng.random(64) < 0.5)
    torch.set_flush_denormal(True)
    try:
        if entry == "filter_compact":
            _, out_f64, n = k5.filter_compact_plain(mask, words, f64, 64)
            want = bits[:, mask.numpy()]
        else:
            n = torch.tensor(40) if entry == "gather_rows_counted" else None
            _, out_f64 = k5.gather_rows_plain(words, f64, idx, n)
            want = bits[:, idx.numpy()][:, :40 if n is not None else 64]
    finally:
        torch.set_flush_denormal(False)
    k = want.shape[1]
    np.testing.assert_array_equal(out_f64.view(torch.int64)[:, :k].numpy(), want)


@pytest.mark.parametrize("with_count", [False, True])
def test_take_rows_matches_jax(with_count):
    """PackedTable.take_rows (one K5 gather), indices clipped as JAX's
    mode="clip"; with a count, rows past it are zeros."""
    rng = np.random.default_rng(6)
    jpt, tpt = _packed(rng, 500)
    idx = rng.integers(-20, 520, 300).astype(np.int32)
    jg = jpt.take_rows(jnp.asarray(idx))
    n = torch.tensor(123) if with_count else None
    tg = tpt.take_rows(torch.from_numpy(idx), n)
    k = 123 if with_count else 300
    np.testing.assert_array_equal(tg.packed[:, :k].numpy(), np.asarray(jg.packed)[:, :k])
    np.testing.assert_array_equal(tg.f64s["y"][:k].numpy(), np.asarray(jg.f64s["y"])[:k])
    if with_count:
        assert not tg.packed[:, k:].any()


def test_take_rows_fused_matches_jax():
    rng = np.random.default_rng(8)
    ja, ta = _packed(rng, 300, W=3, vb=1)
    jb, tb = _packed(rng, 300, W=2, vb=1)
    jb = jcol.PackedTable(jb.packed, {"z": jb.f64s["x"]}, jb.layout)
    tb = tcol.PackedTable(tb.packed, {"z": tb.f64s["x"]}, tb.layout)
    idx = rng.integers(0, 300, 200).astype(np.int32)
    jout = jcol.take_rows_fused([ja, jb], jnp.asarray(idx))
    tout = tcol.take_rows_fused([ta, tb], torch.from_numpy(idx))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        assert list(t.f64s) == list(j.f64s)
        for name in t.f64s:
            np.testing.assert_array_equal(t.f64s[name].numpy(), np.asarray(j.f64s[name]))
    with pytest.raises(ValueError):
        tcol.take_rows_fused([ta, ta], torch.from_numpy(idx))


def test_gather_table_matches_jax():
    host = jcol.HostTable.from_numpy(
        {"a": np.arange(50, dtype=np.int32), "b": np.linspace(0, 1, 50),
         "c": np.arange(50) * (1 << 35)},
        validity={"a": np.arange(50) % 3 != 0})
    jt = host.to_device(64)
    tt = host_table_from_reference(host).to_device(64, device="cpu")
    idx = np.random.default_rng(2).integers(0, 50, 40).astype(np.int32)
    jg = jcol.gather_table(jt, jnp.asarray(idx), 40)
    tg = tcol.gather_table(tt, torch.from_numpy(idx), 40)
    assert tg.to_host().to_pylist() == jg.to_host().to_pylist()


# ---------------------------------------------------------------------------
# K6 radix_sort
# ---------------------------------------------------------------------------

def _jax_perm(operands):
    n = operands[0].shape[0]
    res = jax.lax.sort(tuple(jnp.asarray(o) for o in operands)
                       + (jnp.arange(n, dtype=jnp.int32),),
                       dimension=0, is_stable=True, num_keys=len(operands))
    return np.asarray(res[-1])


SORT_WORDS = {
    # name: (rows, per-word value ranges, signed flags)
    "one_word_full_range": (3000, [(-2**31, 2**31)], [True]),
    "one_word_unsigned": (3000, [(-2**31, 2**31)], [False]),
    "small_ints_many_ties": (4000, [(-3, 3), (0, 4)], [True, True]),
    "int64_split": (2000, [(-5, 5), (-2**31, 2**31)], [True, False]),
    "constant_word": (1000, [(7, 8), (-100, 100)], [True, True]),
    "four_words": (2500, [(0, 2), (-2**31, 2**31), (-9, 9), (-2**31, 2**31)],
                   [True, False, True, False]),
    # exactly 32, 33, 64 and 65 varying bits: one 32-bit key, the first
    # 64-bit one, a full 64-bit key, and three 32-bit chunks, the last of
    # one bit
    "bits_32": (3000, [(0, 2**16), (0, 2**16)], [True, False]),
    "bits_33": (3000, [(0, 2), (-2**31, 2**31)], [False, False]),
    "bits_64": (3000, [(-2**31, 2**31), (-2**31, 2**31)], [True, False]),
    "bits_65": (3000, [(0, 2), (-2**31, 2**31), (-2**31, 2**31)], [False, True, False]),
}
SORT_WORDS_BITS = {"bits_32": 32, "bits_33": 33, "bits_64": 64, "bits_65": 65}


@pytest.mark.parametrize("case", sorted(SORT_WORDS))
def test_radix_sort_plain_matches_lax_sort(case):
    n, ranges, signed = SORT_WORDS[case]
    rng = np.random.default_rng(n)
    words = np.stack([rng.integers(lo, hi, n).astype(np.int32) for lo, hi in ranges])
    perm = k6.radix_sort_plain(torch.from_numpy(words), signed)
    # JAX compares an unsigned word as uint32
    ops = [w if s else w.view(np.uint32) for w, s in zip(words, signed)]
    np.testing.assert_array_equal(perm.numpy(), _jax_perm(ops))


def _lsd_emulation(words: np.ndarray, signed):
    """The CUDA kernel's algorithm in numpy: the varying bits packed into
    one key (pack_key_plain, the pack kernel's twin), then the planned
    digit passes over it, each a stable sort, least significant first,
    chunk by chunk past 64 bits."""
    plan = k6.planned(torch.from_numpy(words), signed)
    chunks = k6.pack_key_plain(torch.from_numpy(words), plan).numpy().view(np.uint64)
    perm = np.arange(words.shape[1])
    for c, shift, width in plan.passes:
        digit = (chunks[c][perm] >> np.uint64(shift)) & np.uint64((1 << width) - 1)
        perm = perm[np.argsort(digit, kind="stable")]
    return perm


@pytest.mark.parametrize("case", sorted(SORT_WORDS))
def test_radix_sort_pass_plan_is_exact(case):
    """The kernel sorts the packed varying bits by the planned digits: the
    stable lexicographic argsort, as radix_sort_plain and JAX's lax.sort
    give it."""
    n, ranges, signed = SORT_WORDS[case]
    rng = np.random.default_rng(n + 1)
    words = np.stack([rng.integers(lo, hi, n).astype(np.int32) for lo, hi in ranges])
    plan = k6.planned(torch.from_numpy(words), signed)
    if case in SORT_WORDS_BITS:
        assert plan.bits == SORT_WORDS_BITS[case]
        assert plan.key_bits == (64 if 32 < plan.bits <= 64 else 32)
        assert plan.chunks == -(-plan.bits // plan.key_bits)
    ref = k6.radix_sort_plain(torch.from_numpy(words), signed).numpy()
    np.testing.assert_array_equal(_lsd_emulation(words, signed), ref)
    ops = [w if s else w.view(np.uint32) for w, s in zip(words, signed)]
    np.testing.assert_array_equal(ref, _jax_perm(ops))


def test_radix_sort_plan_skips_shared_digits():
    # word 0 is constant, word 1 varies in its low byte: one 8-bit pass
    plan = k6.sort_plan([5, 0x100], [5, 0x1FF], [True, False])
    assert plan.masks == (0, 0xFF) and plan.bits == 8 and plan.key_bits == 32
    assert plan.passes == ((0, 0, 8),)
    # a full signed word: four 8-bit passes over a 32-bit key
    plan = k6.sort_plan([0], [0xFFFFFFFF], [True])
    assert plan.flips == (0x80000000,) and plan.bits == 32
    assert plan.passes == ((0, 0, 8), (0, 8, 8), (0, 16, 8), (0, 24, 8))
    # OA's (invalid, home, hash): 1 + 21 + 32 bits, one 54-bit key in 7
    # passes (the last 6 bits wide), the words packed below each other
    plan = k6.sort_plan([0, 0, 0], [1, (1 << 21) - 1, 0xFFFFFFFF], [False] * 3)
    assert plan.bits == 54 and plan.key_bits == 64 and plan.offsets == (53, 32, 0)
    assert [p[1:] for p in plan.passes] == [(s, 8) for s in range(0, 48, 8)] + [(48, 6)]
    # 65 bits: two full 32-bit chunks, then one of one bit; no bit varies:
    # no pass
    plan = k6.sort_plan([0, 0, 0], [1, 0xFFFFFFFF, 0xFFFFFFFF], [False] * 3)
    assert plan.key_bits == 32 and plan.chunks == 3 and len(plan.passes) == 9
    assert plan.passes[-1] == (2, 0, 1) and plan.passes[4] == (1, 0, 8)
    assert k6.sort_plan([7, 7], [7, 7], [True, False]).passes == ()
    # non-contiguous varying bits are moved down in order
    words = torch.tensor([[0b1010_0000, 0b0010_0000, 0b1000_0000]], dtype=torch.int32)
    plan = k6.sort_plan([0b0010_0000 & 0b1000_0000], [0b1010_0000], [False])
    assert plan.masks == (0b1010_0000,)
    assert k6.pack_key_plain(words, plan).tolist() == [[3, 1, 2]]


@st.composite
def _sort_words(draw):
    """1-6 key words, each constant or varying in a drawn set of bits
    (narrow, full, or scattered), mixed signed flags, and totals of 0, 1,
    32, 33, 64 and 65+ varying bits among the draws."""
    total = draw(st.sampled_from([0, 1, 32, 33, 64, 65, 96, None]))
    if total is None:
        widths = draw(st.lists(st.sampled_from([0, 1, 3, 8, 17, 31, 32]), min_size=1,
                               max_size=6))
    else:   # full words and the rest, among constant words, in a drawn order
        widths = [32] * (total // 32) + ([total % 32] if total % 32 or not total else [])
        widths += [0] * draw(st.integers(0, 6 - len(widths)))
        widths = draw(st.permutations(widths))
    n = draw(st.integers(1, 3000)) if sum(widths) == 0 else draw(st.integers(2, 3000))
    signed = draw(st.lists(st.booleans(), min_size=len(widths), max_size=len(widths)))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    rows = []
    for b in widths:
        low = draw(st.booleans())   # the low b bits, or b bits anywhere in the word
        pos = np.arange(b) if low else np.sort(rng.choice(32, b, replace=False))
        mask = int(sum(1 << int(p) for p in pos))
        base = int(rng.integers(0, 2**32)) & ~mask
        v = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) & mask) | base
        if b:   # two rows differ in every bit of the mask
            v[0], v[1] = base, base | mask
        rows.append(v.astype(np.uint32).view(np.int32))
    return np.stack(rows), signed, sum(widths)


@settings(max_examples=50, deadline=None)
@given(case=_sort_words())
def test_radix_sort_packed_key_orders_as_the_words(case):
    """Sorting the packed key (its chunks, most significant first) equals
    sorting the words, and the planned digit passes give that order."""
    words, signed, bits = case
    plan = k6.planned(torch.from_numpy(words), signed)
    assert plan.bits == bits
    ref = k6.radix_sort_plain(torch.from_numpy(words), signed).numpy()
    chunks = k6.pack_key_plain(torch.from_numpy(words), plan).numpy().view(np.uint64)
    packed = (np.lexsort(chunks) if len(chunks) else np.arange(words.shape[1]))
    np.testing.assert_array_equal(packed, ref)
    np.testing.assert_array_equal(_lsd_emulation(words, signed), ref)


def test_float_sort_order_matches_lax_sort():
    """JAX's sort puts -0.0 and 0.0 together (stable) and every NaN, of
    either sign, after +inf; float_sort_bits + K6's plain version give the
    same permutation, also under DESC negation."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=600)
    for value, share in ((-0.0, 0.1), (0.0, 0.1), (np.nan, 0.05), (-np.nan, 0.05),
                         (np.inf, 0.05), (-np.inf, 0.05), (5e-324, 0.02), (-5e-324, 0.02)):
        x[rng.random(600) < share] = value
    for v in (x, -x):
        ref = _jax_perm([v])
        lo, hi = tcol.int64_words(float_sort_bits(torch.from_numpy(v)))
        perm = k6.radix_sort_plain(torch.stack([hi, lo]), [True, False]).numpy()
        np.testing.assert_array_equal(perm, ref)
        # JAX really canonicalises: the zeros keep input order, NaNs trail
        zeros = np.flatnonzero(v[ref] == 0)
        assert (np.diff(ref[zeros]) > 0).all()
        assert np.isnan(v[ref][-int(np.isnan(v).sum()):]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sort_table_subnormal_keys_match_jax(dtype):
    """XLA reads subnormals as zero, so the JAX package sorts them among the
    zeros (stably); the port flushes them before K6 and agrees."""
    from datafusion_parallelism_tpu.ops import sort as jsort
    from datafusion_parallelism_tpu_torch.ops import sort as tsort
    tiny = np.finfo(dtype).tiny
    v = np.array([tiny / 4, 1.0, 0.0, -tiny / 8, -0.0, tiny, -1.0, tiny / 2], dtype=dtype)
    host = jcol.HostTable.from_numpy({"v": v, "row": np.arange(8, dtype=np.int32)})
    for asc in (True, False):
        keys = [jsort.SortKey("v", asc)]
        want = jsort.sort_table(host.to_device(16), keys).to_host().to_pylist()
        got = tsort.sort_table(host_table_from_reference(host).to_device(16, device="cpu"),
                               [tsort.SortKey("v", asc)]).to_host().to_pylist()
        assert [r["row"] for r in got] == [r["row"] for r in want]


# ---------------------------------------------------------------------------
# K7 segment_agg
# ---------------------------------------------------------------------------

def _sorted_key_table(rng, n, n_groups, null_share):
    """A table already in group order (valid keys ascending, then the NULL
    keys, then padding) as the single-word grouping sort leaves it."""
    keys = np.sort(rng.integers(-n_groups, n_groups, n)).astype(np.int32)
    n_null = int(n * null_share)
    kvalid = np.arange(n) < n - n_null
    data = {"k": keys, "v": rng.integers(-10**6, 10**6, n),
            "f": rng.normal(size=n) * 100, "i": rng.integers(-50, 50, n).astype(np.int32)}
    valid = {"k": kvalid, "v": rng.random(n) > 0.1, "f": rng.random(n) > 0.1,
             "i": rng.random(n) > 0.1}
    return jcol.HostTable.from_numpy(data, validity=valid)


@pytest.mark.parametrize("n_groups,null_share", [(1, 0.0), (20, 0.1), (400, 0.0), (400, 0.3)],
                         ids=["one_group", "groups_nulls", "many_groups", "many_nulls"])
def test_segment_agg_plain_matches_jax_sorted_path(n_groups, null_share):
    rng = np.random.default_rng(n_groups)
    host = _sorted_key_table(rng, 700, n_groups, null_share)
    cap = 1024
    aggs = [jagg.AggSpec("sum", "v", "s"), jagg.AggSpec("count", "f", "c"),
            jagg.AggSpec("min", "i", "mn"), jagg.AggSpec("max", "v", "mx"),
            jagg.AggSpec("sum", "f", "sf"), jagg.AggSpec("count_star", None, "cs")]
    jout, jn = jagg.hash_aggregate_counted(host.to_device(cap), ["k"], aggs)
    tt = host_table_from_reference(host).to_device(cap, device="cpu")
    words, cols = key_words([tt.column("k")])
    reqs = [("sum", *tt.column("v")), ("count", *tt.column("f")), ("min", *tt.column("i")),
            ("max", *tt.column("v")), ("sum", *tt.column("f"))]
    starts, sizes, res, n = k7.segment_agg_plain(words, cols, tt.num_rows, reqs, cap)
    g = int(jn)
    assert int(n) == g
    np.testing.assert_array_equal(sizes[:g].numpy(), np.asarray(jout.column("cs")[0])[:g])
    np.testing.assert_array_equal(tt.column("k")[0][starts[:g].long()].numpy(),
                                  np.asarray(jout.column("k")[0])[:g])
    for r, name in zip(res[:4], ("s", "c", "mn", "mx")):
        jv, jm = (np.asarray(a)[:g] for a in jout.column(name))
        np.testing.assert_array_equal(r[:g].numpy()[jm], jv[jm].astype(np.int64))
    f, fm = host.columns["f"]
    np.testing.assert_allclose(res[4][:g].numpy(), np.asarray(jout.column("sf")[0])[:g],
                               rtol=FLOAT_RTOL, atol=FLOAT_ATOL_PER_ABS * np.abs(f[fm]).sum())
    # past the groups: zeros
    assert not starts[g:].any() and not sizes[g:].any() and not res[0][g:].any()


def _boundaries_np(cols, n_valid):
    """Reference group boundaries: adjacent rows differ in a key column
    (valid in both and unequal as numbers, or valid in one)."""
    n = len(cols[0][0])
    b = np.zeros(n, bool)
    b[0] = n_valid > 0
    for v, m in cols:
        same = (m[1:] & m[:-1] & (v[1:] == v[:-1])) | (~m[1:] & ~m[:-1])
        b[1:] |= ~same
    b[n_valid:] = False
    return b


def test_segment_agg_plain_float_and_multi_column_keys():
    """-0.0 == 0.0 and NaN != NaN on float keys, NULL == NULL, a two-column
    key, rows past n_valid in no group, and an out_cap below the group
    count (the true count comes back, and the last kept group's size and
    sums run to n_valid, as in the JAX package)."""
    rng = np.random.default_rng(21)
    n = 400
    fk = np.sort(rng.choice(np.array([-1.5, 0.0, 2.0, np.inf]), n))
    fk[(fk == 0) & (rng.random(n) < 0.5)] = -0.0
    fk[-30:] = np.nan
    ik = np.sort(rng.integers(0, 2, n) * (1 << 40))
    fm, im = rng.random(n) > 0.05, rng.random(n) > 0.05
    cols_np = [(fk, fm), (ik, im)]
    cols = [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in cols_np]
    words, kc = key_words(cols)
    n_valid = 380
    expect = _boundaries_np(cols_np, n_valid)
    assert k7.boundaries_plain(words, kc, torch.tensor(n_valid)).numpy().tolist() \
        == expect.tolist()
    vals = torch.from_numpy(rng.integers(0, 100, n))
    for out_cap in (n, 10):
        starts, sizes, (s,), ng = k7.segment_agg_plain(words, kc, torch.tensor(n_valid),
                                                       [("sum", vals, None)], out_cap)
        assert int(ng) == int(expect.sum())
        first = np.flatnonzero(expect)
        k = min(len(first), out_cap)
        ends = np.append(first[1:k], n_valid)
        np.testing.assert_array_equal(starts[:k].numpy(), first[:k])
        np.testing.assert_array_equal(sizes[:k].numpy(), ends - first[:k])
        ref = [int(vals[a:b].sum()) for a, b in zip(first[:k], ends[:k])]
        assert s[:k].tolist() == ref


# ---------------------------------------------------------------------------
# K8 direct_agg
# ---------------------------------------------------------------------------

def _direct_table(rng, cap, n):
    codes = rng.integers(0, 3, cap).astype(np.int32)
    data = {"s": codes, "b": rng.random(cap) < 0.4, "v": rng.integers(-999, 999, cap),
            "f": rng.normal(size=cap), "g": rng.normal(size=cap).astype(np.float32)}
    valid = {k: rng.random(cap) > 0.1 for k in data}
    host = jcol.HostTable.from_numpy(
        {k: v[:n] for k, v in data.items()}, dtypes={"s": jcol.STRING},
        dictionaries={"s": jcol.Dictionary(np.array(["x", "y", "z"], dtype=object))},
        validity={k: v[:n] for k, v in valid.items()})
    return host


@pytest.mark.parametrize("keys", [[], ["s"], ["s", "b"]], ids=["global", "one_key", "two_keys"])
@pytest.mark.parametrize("filtered", [False, True], ids=["all_rows", "row_filter"])
def test_direct_agg_plain_matches_jax(keys, filtered):
    rng = np.random.default_rng(31 + len(keys))
    cap, n = 1024, 900
    host = _direct_table(rng, cap, n)
    jt = host.to_device(cap)
    tt = host_table_from_reference(host).to_device(cap, device="cpu")
    rf = rng.random(cap) < 0.5 if filtered else None
    aggs = [jagg.AggSpec("sum", "v", "sv"), jagg.AggSpec("sum", "f", "sf"),
            jagg.AggSpec("min", "g", "mn"), jagg.AggSpec("max", "v", "mx"),
            jagg.AggSpec("count", "f", "c"), jagg.AggSpec("count_star", None, "cs")]
    schema = jagg.agg_output_schema(jt.schema, keys, aggs)
    jrf = None if rf is None else jnp.asarray(rf)
    if keys:
        doms = jagg._direct_domains(jt.schema, keys)
        jout, jn = jagg._direct_aggregate(jt, keys, aggs, doms, 64, schema, jrf)
    else:
        doms = []
        jout = jagg._global_aggregate(jt, aggs, schema, jrf)
        jn = 1
    reqs = [("sum", *tt.column("v")), ("sum", *tt.column("f")), ("min", *tt.column("g")),
            ("max", *tt.column("v")), ("count", *tt.column("f"))]
    rowcount, res = k8.direct_agg_plain([tt.column(k) for k in keys], doms, tt.num_rows,
                                        None if rf is None else torch.from_numpy(rf), reqs, cap)
    G = k8.n_groups_of(doms)
    assert rowcount.shape == (G,) and [r.dtype for r in res] == [
        torch.int64, torch.float64, torch.float64, torch.int64, torch.int64]
    # JAX compacts the existing groups to the front, in gid order
    exists = rowcount > 0 if keys else torch.ones(1, dtype=torch.bool)
    g = int(jn)
    assert int(exists.sum()) == g
    np.testing.assert_array_equal(rowcount[exists].numpy(), np.asarray(jout.column("cs")[0])[:g])
    for r, name in zip(res, ("sv", "sf", "mn", "mx", "c")):
        jv, jm = (np.asarray(a)[:g] for a in jout.column(name))
        got = r[exists].numpy()[jm]
        if name == "sf":
            f, fm = host.columns["f"]
            np.testing.assert_allclose(got, jv[jm], rtol=FLOAT_RTOL,
                                       atol=FLOAT_ATOL_PER_ABS * np.abs(f[fm]).sum())
        else:
            np.testing.assert_array_equal(got, jv[jm].astype(got.dtype))


def test_agg_identities_for_empty_groups():
    """A group with no valid input row holds the accumulator's identity
    (the outputs mask it invalid): 0 for counts and sums, the type's max or
    min (+-inf for floats) for min and max."""
    seg = torch.tensor([0, 0, 2])
    v = torch.tensor([1.5, 2.5, 3.0])
    m = torch.tensor([True, True, False])
    assert _agg.reduce_plain("min", v, m, seg, 3).tolist() == [1.5, float("inf"), float("inf")]
    assert _agg.reduce_plain("max", v.long(), m, seg, 3).tolist() == [
        2, torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).min]
    assert _agg.reduce_plain("count", v, m, seg, 3).tolist() == [2, 0, 0]
