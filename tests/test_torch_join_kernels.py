"""The plain versions of K9 pair_fetch, K10 match_flags, K11 concat_rows
and K1's row mask against the JAX code they replace, bit for bit: the
full-fetch join body (`_perm_rows`, `replicate_rows_exact`, `take_rows`,
the value recheck), the visited/probe_matched scatter-sets,
`concat_tables`, and `build_csr` under a chain-fused `build_valid`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu.ops import hashing as jh
from datafusion_parallelism_tpu.ops import join as jjoin
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import concat_rows as k11
from datafusion_parallelism_tpu_torch.kernels import hash_slot as k1
from datafusion_parallelism_tpu_torch.kernels import match_flags as k10
from datafusion_parallelism_tpu_torch.kernels import pair_fetch as k9
from datafusion_parallelism_tpu_torch.ops import hash_table as tht
from datafusion_parallelism_tpu_torch.ops import join as tjoin
from datafusion_parallelism_tpu_torch.ops.hashing import key_words
from datafusion_parallelism_tpu_torch.utils import columnar as tcol
from datafusion_parallelism_tpu_torch.utils.convert import host_table_from_reference


def _np(x):
    return np.asarray(x)


def _tables(case, rng):
    """(JAX build, JAX probe, keys): float64 keys with -0.0/NaN/NULL, or an
    int32 build key against an int64 probe key, each side with a float64
    and a float32 payload and padding."""
    n_b, n_p = 300, 400
    if case == "float64":
        bk = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5, -7.0]), n_b)
        pk = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, 9.0, -7.0]), n_p)
        bdt, pdt = jcol.FLOAT64, jcol.FLOAT64
    else:
        bk = rng.integers(-20, 20, n_b).astype(np.int32)
        pk = rng.integers(-20, 20, n_p).astype(np.int64)
        bdt, pdt = jcol.INT32, jcol.INT64
    b = jcol.HostTable.from_numpy(
        {"bk": bk, "bd": rng.normal(size=n_b), "bs": rng.random(n_b).astype(np.float32),
         "bl": rng.integers(-(1 << 50), 1 << 50, n_b)},
        dtypes={"bk": bdt}, validity={"bk": rng.random(n_b) > 0.1, "bd": rng.random(n_b) > 0.2})
    p = jcol.HostTable.from_numpy(
        {"pk": pk, "pd": rng.normal(size=n_p), "pi": rng.integers(0, 9, n_p).astype(np.int32)},
        dtypes={"pk": pdt}, validity={"pk": rng.random(n_p) > 0.1})
    return b.to_device(512), p.to_device(512)


@pytest.mark.parametrize("out_cap", [64, 4096, 40000])
@pytest.mark.parametrize("case", ["float64", "int32_int64"])
def test_pair_fetch_plain_matches_the_full_fetch_body(case, out_cap):
    rng = np.random.default_rng(["float64", "int32_int64"].index(case))
    jb, jp = _tables(case, rng)
    # the JAX full-fetch body (ops/join.py:322-352)
    bh = jh.hash_rows([jb.column("bk")])
    table = jht.build_join_table(bh, jjoin._keys_valid(jb, ["bk"]), jb.num_rows)
    cr = jht.probe_candidates(table, jh.hash_rows([jp.column("pk")]),
                              jjoin._keys_valid(jp, ["pk"]), jp.num_rows)
    bperm = jjoin._perm_rows(jb, table)
    pp = jcol.pack_table(jp)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    sidecar = jnp.stack([jnp.arange(jp.capacity, dtype=jnp.int32), cr.start - cr.base])
    rep = jcol.replicate_rows_exact(jnp.concatenate([pp.packed, sidecar]), cr.base, cr.count,
                                    out_cap)
    probe_idx, pos = rep[-2], rep[-1] + j
    gb = bperm.take_rows(pos)
    gbt = jcol.unpack_table(jcol.PackedTable(gb.packed[:-1], gb.f64s, gb.layout), jb.schema,
                            out_cap)
    gpt = jcol.unpack_table(jcol.PackedTable(rep[:-2], {k: jnp.take(v, probe_idx, mode="clip")
                                                        for k, v in pp.f64s.items()},
                                             pp.layout), jp.schema, out_cap)
    (bv, bval), (pv, pval) = gbt.column("bk"), gpt.column("pk")
    wide = jnp.promote_types(bv.dtype, pv.dtype)
    jmatch = (j < cr.total) & bval & pval & (bv.astype(wide) == pv.astype(wide))

    # the port: K1 and K2's plain versions give the same table (and perm
    # rows), K3's the same ranges; K9's plain version the rest
    tb = host_table_from_reference(jb.to_host()).to_device(512, device="cpu")
    tp = host_table_from_reference(jp.to_host()).to_device(512, device="cpu")
    T = tht.table_size_for(512)
    tbp, tpp = tcol.pack_table(tb), tcol.pack_table(tp)
    _, bslot = k1.hash_slot_plain(*key_words([tb.column("bk")]), T, tb.num_rows)
    _, offsets, perm, _, bwords = tjoin.PLAIN.csr_build(bslot, T, tjoin._with_f64_pairs(tbp))
    np.testing.assert_array_equal(perm.numpy(), _np(table.perm))
    _, pslot = k1.hash_slot_plain(*key_words([tp.column("pk")]), T)
    start, _, base, total = tjoin.PLAIN.probe_ranges(
        pslot, tp.row_mask() & tp.column("pk")[1], offsets)
    assert int(total) == int(cr.total)
    keys = tjoin._fetch_keys(tbp.layout, tpp.layout, ["bk"], ["pk"])
    out_b, out_bf, out_p, out_pf, t_idx, t_bid, t_match = k9.pair_fetch_plain(
        start, base, total, tpp.packed, tcol.f64_matrix(tpp), bwords, len(tbp.f64s), keys,
        out_cap)
    k = min(int(total), out_cap)
    np.testing.assert_array_equal(t_match.numpy(), _np(jmatch))
    np.testing.assert_array_equal(t_idx.numpy()[:k], _np(probe_idx)[:k])
    np.testing.assert_array_equal(t_bid.numpy()[:k], _np(gb.packed[-1])[:k])
    np.testing.assert_array_equal(out_b.numpy()[:, :k], _np(gb.packed[:-1])[:, :k])
    np.testing.assert_array_equal(out_p.numpy()[:, :k], _np(rep[:-2])[:, :k])
    for i, name in enumerate(tbp.f64s):
        np.testing.assert_array_equal(out_bf[i].numpy()[:k].view(np.int64),
                                      _np(gb.f64s[name])[:k].view(np.int64))
    for i, name in enumerate(tpp.f64s):
        np.testing.assert_array_equal(out_pf[i].numpy()[:k].view(np.int64),
                                      _np(pp.f64s[name])[_np(probe_idx)[:k]].view(np.int64))
    # past the candidates: zeros
    assert not out_b.numpy()[:, k:].any() and not t_match.numpy()[k:].any()


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_match_flags_plain_matches_the_scatter_set(density):
    rng = np.random.default_rng(int(density * 10))
    n, bcap, mcap = 5000, 700, 900
    match = rng.random(n) < density
    bid = rng.integers(0, bcap, n).astype(np.int32)
    pidx = rng.integers(0, mcap, n).astype(np.int32)
    jv = jnp.zeros((bcap,), jnp.bool_).at[jnp.where(match, bid, bcap)].set(True, mode="drop")
    jm = jnp.zeros((mcap,), jnp.bool_).at[jnp.where(match, pidx, mcap)].set(True, mode="drop")
    v, m = k10.match_flags_plain(torch.from_numpy(match), torch.from_numpy(bid),
                                 torch.from_numpy(pidx), bcap, mcap)
    np.testing.assert_array_equal(v.numpy(), _np(jv))
    np.testing.assert_array_equal(m.numpy(), _np(jm))


@pytest.mark.parametrize("rows", [(5, 0, 17), (0, 0, 0), (128, 64, 200), (1, 1, 1),
                                  (128, 0, 256), (100, 64, 0, 1, 3, 0, 128, 17),
                                  (5, 0, 0, 1, 0, 0, 0, 20)])
def test_concat_rows_plain_matches_concat_tables(rows):
    """Parts with some, no and all rows valid, 3 or 8 of them, empty parts
    between full ones; packed words (validity included) and float64
    sidecars equal bit for bit over the whole capacity (tolerance: none)."""
    rng = np.random.default_rng(sum(rows))
    caps = (128, 64, 256) if len(rows) == 3 else (128, 64, 256, 1, 3, 64, 128, 32)
    jparts, tparts = [], []
    for cap, n in zip(caps, rows):
        h = jcol.HostTable.from_numpy(
            {"a": rng.integers(-9, 9, n).astype(np.int32), "b": rng.normal(size=n),
             "c": rng.integers(-(1 << 40), 1 << 40, n)},
            validity={"a": rng.random(n) > 0.2, "b": rng.random(n) > 0.2})
        jparts.append(h.to_device(cap))
        tparts.append(host_table_from_reference(h).to_device(cap, device="cpu"))
    want = jcol.pack_table(jcol.concat_tables(jparts))
    got_t = tcol.concat_tables(tparts, k11.concat_rows_plain)
    got = tcol.pack_table(got_t)
    assert int(got_t.num_rows) == sum(rows) and got_t.capacity == sum(caps)
    np.testing.assert_array_equal(got.packed.numpy(), _np(want.packed))
    np.testing.assert_array_equal(got.f64s["b"].numpy().view(np.int64),
                                  _np(want.f64s["b"]).view(np.int64))


@pytest.mark.parametrize("case", ["mask", "mask_and_nulls", "mask_and_padding"])
def test_hash_slot_row_mask_matches_a_masked_build_csr(case):
    """K1 with a row mask gives JAX's buckets for `key_valid & build_valid`
    (ops/join.py:221-225), and K2 over them JAX's table."""
    rng = np.random.default_rng(len(case))
    cap = 2048
    keys = rng.integers(0, 500, cap).astype(np.int32)
    valid = rng.random(cap) > (0.1 if "nulls" in case else 0.0)
    num_rows = cap // 2 if "padding" in case else cap
    mask = rng.random(cap) < 0.6
    jhash = jh.hash_rows([(jnp.asarray(keys), jnp.asarray(valid))])
    jt = jht.build_csr(jhash, jnp.asarray(valid & mask), num_rows)
    T = tht.table_size_for(cap)
    words, cols = key_words([(torch.from_numpy(keys), torch.from_numpy(valid))])
    _, slot = k1.hash_slot_plain(words, cols, T, torch.tensor(num_rows, dtype=torch.int32),
                                 torch.from_numpy(mask))
    _, offsets, perm, start_count, _ = tjoin.PLAIN.csr_build(
        slot, T, torch.empty((0, cap), dtype=torch.int32))
    np.testing.assert_array_equal(offsets.numpy(), _np(jt.offsets))
    np.testing.assert_array_equal(perm.numpy(), _np(jt.perm))
    np.testing.assert_array_equal(start_count.numpy(), _np(jt.start_count))
    # without the mask, the unmasked table
    _, slot0 = k1.hash_slot_plain(words, cols, T, torch.tensor(num_rows, dtype=torch.int32))
    jt0 = jht.build_csr(jhash, jnp.asarray(valid), num_rows)
    assert torch.equal(tjoin.PLAIN.csr_build(slot0, T, torch.empty((0, cap),
                                                                   dtype=torch.int32))[2],
                       torch.from_numpy(_np(jt0.perm)))
