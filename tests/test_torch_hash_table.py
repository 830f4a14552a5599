"""The port's CSR table (K2's plain version) and probe (K3's plain
version) against the JAX package's `build_csr` / `probe_candidates` /
`replicate_rows_exact`: exact for every integer array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu.ops import hashing as jh
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
from datafusion_parallelism_tpu_torch.ops import hash_table as tht
from datafusion_parallelism_tpu_torch.utils.convert import join_table_from_reference

CAP = 4096


def _keys(case, rng, n):
    """(keys int32[CAP], key_valid bool[CAP], num_rows)."""
    keys = rng.integers(0, n, CAP).astype(np.int32)
    valid = np.ones(CAP, bool)
    num_rows = CAP
    if case == "padding":
        num_rows = CAP // 2
    elif case == "nulls":
        valid = rng.random(CAP) >= 0.10
    elif case == "hot_key":
        keys[rng.random(CAP) < 0.30] = 7
    return keys, valid, num_rows


CASES = ["padding", "nulls", "hot_key"]


def _both_tables(case, seed=0):
    rng = np.random.default_rng(seed + CASES.index(case))
    keys, valid, num_rows = _keys(case, rng, CAP // 2)
    jhash = jh.hash_rows([(jnp.asarray(keys), jnp.asarray(valid))])
    jt = jht.build_csr(jhash, jnp.asarray(valid), num_rows)
    th = torch.from_numpy(np.asarray(jhash).view(np.int32).copy())
    tt = tht.build_csr(th, torch.from_numpy(valid), torch.tensor(num_rows, dtype=torch.int32))
    return jt, tt, th, keys, valid, num_rows


@pytest.mark.parametrize("case", CASES)
def test_build_csr_matches_jax(case):
    jt, tt, *_ = _both_tables(case)
    np.testing.assert_array_equal(tt.offsets.numpy(), np.asarray(jt.offsets))
    np.testing.assert_array_equal(tt.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(tt.start_count.numpy(), np.asarray(jt.start_count))


@pytest.mark.parametrize("case", CASES)
def test_csr_build_permutes_narrow_rows_like_jax(case):
    """K2's rows_out is the JAX deferred join's narrow permute: the narrow
    words plus the row id, gathered into perm order."""
    jt, _, th, keys, valid, num_rows = _both_tables(case)
    T = tht.table_size_for(CAP)
    ok = (np.arange(CAP) < num_rows) & valid
    slot = torch.where(torch.from_numpy(ok), tht.slot_of(th, T), T).to(torch.int32)
    rows = np.stack([keys, valid.astype(np.int32)])
    counts, offsets, perm, start_count, rows_out = k2.csr_build(slot, T, torch.from_numpy(rows))
    assert counts.shape == (T + 1,) and offsets.shape == (T + 2,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jt.start_count)[1])
    src = np.concatenate([rows, np.arange(CAP, dtype=np.int32)[None]])
    want = jcol.PackedTable(jnp.asarray(src), {}, None).take_rows(jt.perm).packed
    np.testing.assert_array_equal(rows_out.numpy(), np.asarray(want))


def test_non_pow2_table_size():
    rng = np.random.default_rng(11)
    T = 3 * (1 << 16) + 1
    slot = torch.from_numpy(rng.integers(0, T + 1, CAP).astype(np.int32))
    slot[:100] = T
    counts, offsets, perm, start_count, _ = k2.csr_build(slot, T, torch.empty((0, CAP), dtype=torch.int32))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(slot.numpy(), kind="stable"))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(slot.numpy(), minlength=T + 1))
    assert int(offsets[-1]) == CAP and torch.equal(start_count[0], offsets[:-1])


def _probe(rng, n_keys, m=CAP):
    keys = rng.integers(0, n_keys, m).astype(np.int32)
    keys[:20] = 7                     # hot probe rows
    valid = rng.random(m) >= 0.1
    return keys, valid, m - 100


@pytest.mark.parametrize("case", CASES)
def test_probe_candidates_on_a_jax_built_table(case):
    jt, *_ = _both_tables(case)
    table = join_table_from_reference(jt.offsets, jt.perm, jt.start_count, device="cpu")
    keys, valid, num_rows = _probe(np.random.default_rng(5), CAP // 2)
    ph = jh.hash_rows([(jnp.asarray(keys), jnp.asarray(valid))])
    want = jht.probe_candidates(jt, ph, jnp.asarray(valid), num_rows)
    got = tht.probe_candidates(table, torch.from_numpy(np.asarray(ph).view(np.int32).copy()),
                               torch.from_numpy(valid), torch.tensor(num_rows, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    start, count = tht.probe_ranges(table, torch.from_numpy(np.asarray(ph).view(np.int32).copy()),
                                    torch.from_numpy(valid), torch.tensor(num_rows, dtype=torch.int32))
    assert torch.equal(start, got.start) and torch.equal(count, got.count)


def test_jax_probes_a_port_built_table():
    _, tt, *_ = _both_tables("nulls")
    jt = jht.JoinTable(jnp.asarray(tt.offsets.numpy()), jnp.asarray(tt.perm.numpy()),
                       jnp.zeros((1,), jnp.int64), jnp.asarray(tt.start_count.numpy()))
    keys, valid, num_rows = _probe(np.random.default_rng(6), CAP // 2)
    ph = jh.hash_rows([(jnp.asarray(keys), jnp.asarray(valid))])
    want = jht.probe_candidates(jt, ph, jnp.asarray(valid), num_rows)
    got = tht.probe_candidates(tt, torch.from_numpy(np.asarray(ph).view(np.int32).copy()),
                               torch.from_numpy(valid), torch.tensor(num_rows, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_cap", [CAP * 8, 1000])
def test_probe_expand_replicates_like_jax(out_cap):
    """K3's probe row and perm position per output slot equal the JAX
    package's replicate_rows_exact sidecars, for j < min(total, out_cap);
    past that, match is False and the ids are 0."""
    jt, tt, *_ = _both_tables("hot_key")
    T = tht.table_size_for(CAP)
    keys, valid, num_rows = _probe(np.random.default_rng(7), CAP // 2)
    ph = torch.from_numpy(np.asarray(jh.hash_rows([(jnp.asarray(keys), jnp.asarray(valid))]))
                          .view(np.int32).copy())
    ok = torch.from_numpy((np.arange(CAP) < num_rows) & valid)
    # bwords: the build's perm position itself, then a row id row
    perm_pos = torch.arange(CAP, dtype=torch.int32)
    bwords = torch.stack([perm_pos, tt.perm])
    start, count, base, total = k3.probe_ranges(tht.slot_of(ph, T), ok, tt.offsets)
    match, probe_idx, build_id = k3.expand_ranges(
        start, count, base, total, torch.zeros((1, CAP), dtype=torch.int32), bwords,
        [([0], [0], (0, 31), (0, 31))], out_cap)
    cr = jht.probe_candidates(jt, jnp.asarray(ph.numpy().view(np.uint32)),
                              jnp.asarray(ok.numpy()), CAP)
    assert int(total) == int(cr.total)
    src = jnp.stack([jnp.arange(CAP, dtype=jnp.int32), cr.start - cr.base])
    rep = np.asarray(jcol.replicate_rows_exact(src, cr.base, cr.count, out_cap))
    n = min(int(total), out_cap)
    np.testing.assert_array_equal(probe_idx.numpy()[:n], rep[0][:n])
    np.testing.assert_array_equal(build_id.numpy()[:n],
                                  np.asarray(jt.perm)[rep[1][:n] + np.arange(n)])
    assert not match.any()            # validity bit 31 is never set here
    assert (probe_idx[n:] == 0).all() and (build_id[n:] == 0).all()


def test_candidate_total_past_int32_raises():
    offsets = torch.tensor([0, 1 << 30, 1 << 30], dtype=torch.int32)   # bucket 0 of T = 1
    slot = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(OverflowError):
        k3.probe_ranges(slot, torch.ones(3, dtype=torch.bool), offsets)
