"""ROADMAP queue 3: queries the JAX package runs that the card's kernels
refused, each at its smallest input (chip_smoke.py's `queue3_cases`).

The kernel wrappers check their limits only for CUDA tensors, so these
tests run the port on the CPU through kernel tables whose entry points
first apply the CUDA wrapper's own host-side checks (K1's and K3's
`_spec`, K4's descriptor table, K9's `_spec`, `_agg.spec`,
`ops/expressions.py::_fits`) to every launch the wrapper would make, then
run the plain version. Each query
must pass those checks and equal the JAX package's rows and the answer
chip_smoke.py holds the card to.
"""

from collections import Counter

import pytest
import torch

import datafusion_parallelism_tpu as jdfp
from datafusion_parallelism_tpu.ops import join as jjoin
from datafusion_parallelism_tpu.utils import columnar as jcol
import datafusion_parallelism_tpu_torch as tdfp
from datafusion_parallelism_tpu_torch.kernels import _agg, _build
from datafusion_parallelism_tpu_torch.kernels import compact_gather as k4
from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
from datafusion_parallelism_tpu_torch.kernels import hash_slot as k1
from datafusion_parallelism_tpu_torch.kernels import pair_fetch as k9
from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
from datafusion_parallelism_tpu_torch.ops import expressions as texpr
from datafusion_parallelism_tpu_torch.ops.join import PLAIN as JOIN_PLAIN
from datafusion_parallelism_tpu_torch.ops.join import JoinType, hash_join
from datafusion_parallelism_tpu_torch.utils.columnar import INT32, HostTable

import chip_smoke
from oracle import assert_rows_equal

CASES = chip_smoke.queue3_cases()


def _require_on_any_device(t, name, dtype, shape=None, device=None):
    """_build.require without its CUDA check: the argument checks the
    wrappers make before a launch, on CPU tensors."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _checked_tables(launches: Counter):
    """(join kernels, chain kernels): the plain versions behind the CUDA
    wrappers' host-side checks, applied per launch as the wrappers cut
    their work; `launches` counts the launches the card would make."""

    def hash_slot(words, cols, *args):
        for group in k1.col_groups(cols):
            k1._spec(group, words.shape[0])
            launches["hash_slot"] += 1
        return k1.hash_slot_plain(words, cols, *args)

    def expand_ranges(start, count, base, total, pwords, bwords, compares, out_cap):
        for group in k3.key_groups(compares):
            k3._spec(group)
            launches["expand_ranges"] += 1
        return k3.expand_ranges_plain(start, count, base, total, pwords, bwords, compares,
                                      out_cap)

    def compact_gather(match, build_id, probe_idx, build_cols, probe_cols, total=None):
        for group in k4.col_groups(len(build_cols), len(probe_cols)):
            spec = k4.SpecC(n=len(group))   # raises past the table's MAX_COLS fields
            for k, (side, c) in enumerate(group):
                values = (build_cols, probe_cols)[side][c][0]
                spec.c[k].width, spec.c[k].side = k4._WIDTH[values.dtype], side
            launches["compact_gather"] += 1
        return k4.compact_gather_plain(match, build_id, probe_idx, build_cols, probe_cols,
                                       total)

    def pair_fetch(start, base, total, pwords, pf64, bwords, n_bf64, keys, out_cap):
        for group in k9.key_groups(keys):
            k9._spec(group, bwords.shape[0] - 1, pwords.shape[0], pf64.shape[0])
            launches["pair_fetch"] += 1
        return k9.pair_fetch_plain(start, base, total, pwords, pf64, bwords, n_bf64, keys,
                                   out_cap)

    def segment_agg(words, cols, n_valid, reqs, out_cap):
        specs = [k1._spec(g, words.shape[0]) for g in k1.col_groups(cols)]
        launches["segment_agg_key_specs"] += len(specs)
        for group in _agg.request_groups(reqs):
            _agg.spec(group, words.shape[1], words.device)
            launches["segment_agg"] += 1
        return CHAIN_PLAIN.segment_agg(words, cols, n_valid, reqs, out_cap)

    def direct_agg(keys, doms, num_rows, row_filter, reqs, cap):
        for group in _agg.request_groups(reqs):
            _agg.spec(group, cap, num_rows.device)
            launches["direct_agg"] += 1
        return CHAIN_PLAIN.direct_agg(keys, doms, num_rows, row_filter, reqs, cap)

    def expr_eval(program, *args, **kwargs):
        assert texpr._fits(program), (len(program.code), program.n_regs)
        launches["expr_eval"] += 1
        return k17.expr_eval_plain(program, *args, **kwargs)

    join = JOIN_PLAIN._replace(hash_slot=hash_slot, expand_ranges=expand_ranges,
                               compact_gather=compact_gather, pair_fetch=pair_fetch)
    chain = CHAIN_PLAIN._replace(hash_slot=hash_slot, segment_agg=segment_agg,
                                 direct_agg=direct_agg, expr_eval=expr_eval)
    return join, chain


def _jax_rows(tables, sql):
    ctx = jdfp.SessionContext()
    for name, data in tables.items():
        ctx.register_pydict(name, data)
    return ctx.sql(sql).collect().to_pylist()


# the launches each case must make past one launch's limits
MORE_THAN_ONE = {"case32": None, "or33": ("expr_eval", 2), "or65": ("expr_eval", 2),
                 "join5": ("pair_fetch", 2), "join5_residual": ("pair_fetch", 2),
                 "agg34_sorted": ("segment_agg", 2), "agg34_direct": ("direct_agg", 2),
                 "agg34_global": ("direct_agg", 2), "group17": ("segment_agg_key_specs", 2)}


@pytest.mark.parametrize("name", list(CASES))
def test_queue3_case_passes_the_card_checks_and_equals_jax(name, monkeypatch):
    tables, sql, what = CASES[name]
    monkeypatch.setattr(_build, "require", _require_on_any_device)
    launches = Counter()
    join, chain = _checked_tables(launches)
    ctx = tdfp.SessionContext(device="cpu")
    for tname, data in tables.items():
        ctx.register_pydict(tname, data)
    rows = ctx.sql(sql, kernels=join, chain=chain).collect().to_pylist()
    want = _jax_rows(tables, sql)
    assert_rows_equal(rows, want)
    assert chip_smoke.queue3_answer(rows, what) == chip_smoke.queue3_answer(want, what)
    assert chip_smoke.queue3_answer(want, what) == chip_smoke.QUEUE3_JAX[name]
    if MORE_THAN_ONE[name] is not None:
        entry, at_least = MORE_THAN_ONE[name]
        assert launches[entry] >= at_least, launches


def test_case32_fits_one_launch_after_last_first_emission():
    """The 32-branch CASE compiles into one program within K17's limits:
    its branches fold from the last, so a few registers stay live."""
    a = CASES["case32"][0]["t"]["a"]
    lit = lambda v: texpr.Lit(v, INT32)   # noqa: E731
    case = texpr.Case([(texpr.BinOp("=", texpr.Col("a"), lit(i)), lit(3 * i))
                       for i in range(32)], lit(0))
    program, _ = texpr.compile_exprs([case], HostTable.from_pydict({"a": a}).to_device(
        device="cpu"))
    assert texpr._fits(program)
    assert program.n_regs <= 4


@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "RIGHT_SEMI"])
def test_five_key_deferred_join_rechecks_in_key_groups(join_type, monkeypatch):
    """A join on 5 int32 keys takes the deferred path: K3's second pass
    rechecks the keys in two launches (4 + 1), each within its spec, and
    the join equals the JAX package's."""
    tables = CASES["join5"][0]
    monkeypatch.setattr(_build, "require", _require_on_any_device)
    launches = Counter()
    join, chain = _checked_tables(launches)
    bk, pk = [f"l{i}" for i in range(5)], [f"r{i}" for i in range(5)]
    lt, rt = (HostTable.from_pydict(tables[n]) for n in ("l", "r"))
    out, total = hash_join(lt.to_device(device="cpu"), rt.to_device(device="cpu"), bk, pk,
                           JoinType[join_type], 1 << 16, kernels=join, chain=chain)
    assert launches["expand_ranges"] == 2 and launches["pair_fetch"] == 0, launches
    # the pairs' columns in one K4 launch (a semi join emits no pairs)
    assert launches["compact_gather"] == int(join_type != "RIGHT_SEMI"), launches
    jl, jr = (jcol.HostTable.from_pydict(tables[n]) for n in ("l", "r"))
    want, jtotal = jjoin.hash_join(jl.to_device(), jr.to_device(), bk, pk,
                                   jjoin.JoinType[join_type], 1 << 16)
    assert int(total) == int(jtotal)
    assert_rows_equal(out.to_host().to_pylist(), want.to_host().to_pylist())


def test_one_launch_would_be_refused():
    """Each fault's work, in one launch, is past the kernel's limits: the
    wrappers' checks raise on it, so the repairs above are what runs."""
    cols = [(0, (i,), (17 + i, 0)) for i in range(17)]
    with pytest.raises(ValueError):
        k1._spec(cols, 34)
    compares = [([i], [i], (5, i), (5, i)) for i in range(5)]
    with pytest.raises(ValueError):
        k3._spec(compares)
    assert [len(g) for g in k3.key_groups(compares)] == [4, 1]
    reqs = [("sum", torch.zeros(4, dtype=torch.int64), None)] * 34
    with pytest.raises(ValueError):
        _agg.spec(reqs, 4, torch.device("cpu"))
    assert [len(g) for g in _agg.request_groups(reqs)] == [32, 2]
