"""The port's SORT and OA join tables against the JAX package's
`build_sorted` / `build_oa` / `probe_ranges` / `probe_candidates`, bit for
bit (perm, sorted keys or slots, start, count, base, total), on
numpy-seeded hashes: null keys and padding past num_rows, repeated hashes,
a single-home cluster, the 64k-bucket floor and a table size that is not a
power of two (slot_of's Lemire branch). The port's wrappers run the plain
versions here (CPU tensors): K6, K5's gather, K14, K15 and K16; each plain
version is also held against the JAX code it replaces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
from datafusion_parallelism_tpu_torch.ops import hash_table as tht

CASES = ["nulls_padding", "repeats", "one_home_cluster", "floor_64k", "lemire"]


def _cluster(rng, T, home, count):
    """`count` uint32 hashes whose slot_of(., T) is `home`."""
    if T & (T - 1) == 0:
        return home + T * rng.integers(0, (1 << 32) // T, count, dtype=np.uint64)
    lo = -(-home * (1 << 32) // T)
    hi = -(-(home + 1) * (1 << 32) // T)
    return rng.integers(lo, hi, count, dtype=np.uint64)


def _case(case):
    """(hashes uint32[cap], key_valid bool[cap], num_rows, probe hashes
    uint32[m], probe key_valid, probe num_rows)."""
    rng = np.random.default_rng(CASES.index(case))
    cap = {"floor_64k": 100, "lemire": 3 * (1 << 14)}.get(case, 4096)
    T = tht.table_size_for(cap)
    pool = rng.integers(0, 1 << 32, 50 if case == "repeats" else cap, dtype=np.uint64)
    h = rng.choice(pool, cap)
    if case in ("one_home_cluster", "lemire"):
        h[rng.choice(cap, 1500, replace=False)] = _cluster(rng, T, T // 3, 1500)
    valid = rng.random(cap) >= (0.1 if case != "repeats" else 0.0)
    num_rows = cap - cap // 5 if case in ("nulls_padding", "lemire") else cap
    m = 2 * cap
    ph = np.where(rng.random(m) < 0.7, rng.choice(h, m),
                  rng.integers(0, 1 << 32, m, dtype=np.uint64))
    if case in ("one_home_cluster", "lemire"):
        ph[:200] = _cluster(rng, T, T // 3, 200)
    pvalid = rng.random(m) >= 0.05
    return (h.astype(np.uint32), valid, num_rows, ph.astype(np.uint32), pvalid, m - 7)


def _i32(u32):
    return torch.from_numpy(u32.view(np.int32).copy())


def _tables(case, strategy):
    h, valid, num_rows, *_ = _case(case)
    jt = jht.build_join_table(jnp.asarray(h), jnp.asarray(valid), num_rows,
                              jht.JoinStrategy[strategy])
    tt = tht.build_join_table(_i32(h), torch.from_numpy(valid),
                              torch.tensor(num_rows, dtype=torch.int32),
                              tht.JoinStrategy[strategy])
    return jt, tt


@pytest.mark.parametrize("strategy", ["SORT", "OA"])
@pytest.mark.parametrize("case", CASES)
def test_build_matches_jax(case, strategy):
    jt, tt = _tables(case, strategy)
    assert tt.strategy is tht.JoinStrategy[strategy]
    assert tt.is_sort == jt.is_sort and tt.is_oa == jt.is_oa
    np.testing.assert_array_equal(tt.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(tt.sorted_hash.numpy(), np.asarray(jt.sorted_hash))
    if strategy == "OA":   # S = T + T/4 slots, empty ones 0 in both arrays
        T = tht.table_size_for(len(_case(case)[0]))
        assert tt.sorted_hash.shape[0] == T + T // 4 == tht.oa_slots_for(T)


@pytest.mark.parametrize("strategy", ["SORT", "OA"])
@pytest.mark.parametrize("case", CASES)
def test_probe_matches_jax(case, strategy):
    jt, tt = _tables(case, strategy)
    _, _, _, ph, pvalid, pn = _case(case)
    jr = jht.probe_candidates(jt, jnp.asarray(ph), jnp.asarray(pvalid), pn)
    tr = tht.probe_candidates(tt, _i32(ph), torch.from_numpy(pvalid),
                              torch.tensor(pn, dtype=torch.int32))
    for got, want in zip(tr, jr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    start, count = tht.probe_ranges(tt, _i32(ph), torch.from_numpy(pvalid),
                                    torch.tensor(pn, dtype=torch.int32))
    assert torch.equal(start, tr.start) and torch.equal(count, tr.count)
    assert int(tr.total) > 0


@pytest.mark.parametrize("case", CASES)
def test_sort_words_order_equals_jax_argsort(case):
    """K6's plain version over (invalid, hash as unsigned) is JAX's stable
    argsort of the int64 key with its 2^33 sentinel; over (invalid, home,
    hash) the argsort of OA's composite key with its 2^62 sentinel."""
    h, valid, num_rows, *_ = _case(case)
    ok = valid & (np.arange(len(h)) < num_rows)
    th, tok = _i32(h), torch.from_numpy(ok)
    inval = (~tok).to(torch.int32)
    key = np.where(ok, h.astype(np.int64), np.int64(1) << 33)
    perm = k6.radix_sort_plain(torch.stack([inval, torch.where(tok, th, 0)]), [False, False])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jnp.argsort(key, stable=True)))
    T = tht.table_size_for(len(h))
    home = np.asarray(jht.slot_of(jnp.asarray(h), T)).astype(np.int64)
    composite = np.where(ok, (home << 32) | h.astype(np.int64), np.int64(1) << 62)
    order = k6.radix_sort_plain(
        torch.stack([inval, torch.where(tok, torch.from_numpy(home.astype(np.int32)), 0),
                     torch.where(tok, th, 0)]), [False] * 3)
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.argsort(composite, stable=True)))


@pytest.mark.parametrize("case", CASES)
def test_kernel_plain_versions_match_jax(case):
    """K14's, K15's and K16's plain versions on their own, against the JAX
    lines they replace: searchsorted left/right; the parking placement and
    slot scatter; the lockstep linear-probe walk."""
    h, valid, num_rows, ph, pvalid, pn = _case(case)
    cap, T = len(h), tht.table_size_for(len(h))
    ok = valid & (np.arange(cap) < num_rows)
    pok = pvalid & (np.arange(len(ph)) < pn)
    # K14 against the SORT table
    js = jht.build_sorted(jnp.asarray(h), jnp.asarray(valid), num_rows)
    start, count, base, total = k14.sorted_probe_plain(
        _i32(ph), torch.from_numpy(pok), torch.from_numpy(np.asarray(js.sorted_hash)))
    key = jnp.asarray(ph.astype(np.int64))
    jstart = jnp.searchsorted(js.sorted_hash, key, side="left")
    jend = jnp.searchsorted(js.sorted_hash, key, side="right")
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(count.numpy(), np.where(pok, np.asarray(jend - jstart), 0))
    np.testing.assert_array_equal(base.numpy(), np.cumsum(count.numpy()) - count.numpy())
    assert int(total) == int(count.sum())
    # K15 from the JAX build's sort order
    jo = jht.build_oa(jnp.asarray(h), jnp.asarray(valid), num_rows)
    home = tht.slot_of(_i32(h), T)
    composite = np.where(ok, (home.numpy().astype(np.int64) << 32) | h.astype(np.int64),
                         np.int64(1) << 62)
    order = torch.from_numpy(np.asarray(jnp.argsort(composite, stable=True)).astype(np.int32))
    slots, perm = k15.oa_place_plain(order, home, _i32(h), torch.from_numpy(ok),
                                     tht.oa_slots_for(T))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jo.sorted_hash))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jo.perm))
    # K16 against the JAX walk
    jstart, jcount = jht._probe_oa(jo, jnp.asarray(ph), jnp.asarray(pok))
    start, count, base, total = k16.oa_probe_plain(_i32(ph), torch.from_numpy(pok), slots)
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    assert int(total) == int(np.asarray(jcount).sum())


def test_oa_cluster_is_displaced_past_its_home():
    """A one-home cluster parks in consecutive slots from its home on:
    the thousand slots past it are all taken."""
    _, tt = _tables("one_home_cluster", "OA")
    T = tht.table_size_for(4096)
    assert bool((tt.sorted_hash[T // 3:T // 3 + 1000] != 0).all())
    assert int(tt.sorted_hash[T // 3 - 1]) == 0 or T // 3 == 0


def test_sorted_probe_raises_past_int32_total():
    """K14's plain version keeps K3's contract: a candidate total of 2^31
    or more raises instead of wrapping."""
    sorted_hash = torch.zeros(1 << 16, dtype=torch.int64)
    hashes = torch.zeros(1 << 16, dtype=torch.int32)   # 2^16 x 2^16 candidates
    with pytest.raises(OverflowError):
        k14.sorted_probe_plain(hashes, torch.ones(hashes.shape[0], dtype=torch.bool),
                               sorted_hash)
