"""All eight join types of the port's hash join, under each of the CSR,
SORT and OA strategies, against the JAX package's `hash_join` under the same
strategy (and the brute-force oracle): the same seeded rows go through
both; row multisets and candidate totals must be equal. The port runs its
kernels' plain versions here (CPU tensors): K1-K6, K9-K11 and K14-K16."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_parallelism_tpu.ops import hash_table as jht
from datafusion_parallelism_tpu.ops import join as jjoin
from datafusion_parallelism_tpu.utils import columnar as jcol
from datafusion_parallelism_tpu_torch.ops import join as tjoin
from datafusion_parallelism_tpu_torch.utils import columnar as tcol

from oracle import assert_rows_equal, oracle_join

TYPES = [t.name for t in tjoin.JoinType]
STRATEGIES = [s.name for s in tjoin.JoinStrategy]

# every test runs under each strategy, in both packages
pytestmark = pytest.mark.parametrize("strategy", STRATEGIES)
EXPANDABLE = ["INNER", "LEFT_SEMI", "LEFT_ANTI", "RIGHT_SEMI", "RIGHT_ANTI"]


def _host(pkg, rows, dtypes=None):
    names = sorted({k for r in rows for k in r})
    return pkg.HostTable.from_pydict({n: [r.get(n) for r in rows] for n in names}, dtypes)


def _strategy_kw(strategy):
    """(JAX kwargs, port kwargs) naming the strategy in each package."""
    return {"strategy": jht.JoinStrategy[strategy]}, {"strategy": tjoin.JoinStrategy[strategy]}


def _both(build, probe, bkeys, pkeys, jt, strategy, out_cap=None, bdtypes=None,
          pdtypes=None, bcap=None, pcap=None, **kw):
    """(port result tuple, JAX result tuple) of one join on the same rows,
    under `strategy` in both packages."""
    cap = out_cap or max(128, 4 * (len(build) + 1) * (len(probe) + 1))
    jb, jp = _host(jcol, build, bdtypes), _host(jcol, probe, pdtypes)
    tb, tp = _host(tcol, build, bdtypes), _host(tcol, probe, pdtypes)
    js, ts = _strategy_kw(strategy)
    jkw, tkw = {**kw, **js}, {**kw, **ts}
    jkw.pop("visited_into", None)   # the port's accumulate mode; JAX ORs outside
    for name in ("build_valid", "probe_valid"):
        if name in kw:
            jkw[name], tkw[name] = jnp.asarray(kw[name]), torch.from_numpy(kw[name])
    for name in ("residual",):
        if name in kw:
            jkw[name], tkw[name] = kw[name](jnp), kw[name](torch)
    jbd, tbd = jb.to_device(bcap), tb.to_device(bcap, device="cpu")
    if kw.get("prepared"):   # each package's frozen build of the same rows
        jkw["prepared"] = jjoin.prepare_build(jbd, bkeys, js["strategy"])
        tkw["prepared"] = tjoin.prepare_build(tbd, bkeys, ts["strategy"])
    want = jjoin.hash_join(jbd, jp.to_device(pcap), bkeys, pkeys, jjoin.JoinType[jt], cap,
                           **jkw)
    got = tjoin.hash_join(tbd, tp.to_device(pcap, device="cpu"), bkeys, pkeys,
                          tjoin.JoinType[jt], cap, **tkw)
    return got, want


def _check(build, probe, bkeys, pkeys, jt, strategy, residual_rows=None, **kw):
    got, want = _both(build, probe, bkeys, pkeys, jt, strategy, **kw)
    assert int(got[1]) == int(want[1])
    rows = got[0].to_host().to_pylist()
    assert_rows_equal(rows, want[0].to_host().to_pylist())
    expected = oracle_join(build, probe, bkeys, pkeys, jt.lower(), residual=residual_rows)
    assert_rows_equal(rows, expected)
    return got, want


def make_rows(n, key_space, seed, nulls=False, extra="v"):
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        k = rng.randrange(key_space)
        key = None if (nulls and rng.random() < 0.15) else k
        rows.append({"k": key, extra: i})
    return rows


@pytest.mark.parametrize("jt", TYPES)
def test_join_types_random(jt, strategy):
    build = [{"bk": r["k"], "bv": r["v"]} for r in make_rows(57, 20, 1, nulls=True)]
    probe = [{"pk": r["k"], "pv": r["v"]} for r in make_rows(91, 20, 2, nulls=True)]
    _check(build, probe, ["bk"], ["pk"], jt, strategy)


@pytest.mark.parametrize("jt", TYPES)
def test_join_no_matches(jt, strategy):
    build = [{"bk": i, "bv": i} for i in range(10)]
    probe = [{"pk": i + 100, "pv": i} for i in range(14)]
    _check(build, probe, ["bk"], ["pk"], jt, strategy)


@pytest.mark.parametrize("jt", TYPES)
def test_join_heavy_duplicates(jt, strategy):
    build = [{"bk": 7 if i % 3 else i, "bv": i} for i in range(40)]
    probe = [{"pk": 7 if i % 4 else i, "pv": i} for i in range(60)]
    _check(build, probe, ["bk"], ["pk"], jt, strategy)


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "FULL", "RIGHT_ANTI"])
def test_multi_key_join(jt, strategy):
    rng = random.Random(3)
    build = [{"a": rng.randrange(4), "b": rng.randrange(4), "bv": i} for i in range(30)]
    probe = [{"c": rng.randrange(4), "d": rng.randrange(4), "pv": i} for i in range(30)]
    _check(build, probe, ["a", "b"], ["c", "d"], jt, strategy)


def _parity_residual(xp):
    def residual(pair):
        bv, bvalid = pair.column("bv")
        pv, pvalid = pair.column("pv")
        return (bv + pv) % 2 == 0, bvalid & pvalid
    return residual


@pytest.mark.parametrize("jt", ["INNER", "FULL", "LEFT", "RIGHT", "LEFT_SEMI", "RIGHT_ANTI"])
def test_join_with_residual_filter(jt, strategy):
    build = [{"bk": i % 5, "bv": i} for i in range(20)]
    probe = [{"pk": i % 5, "pv": i} for i in range(20)]
    _check(build, probe, ["bk"], ["pk"], jt, strategy, residual=_parity_residual,
           residual_rows=lambda r: (r["bv"] + r["pv"]) % 2 == 0)


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "RIGHT_SEMI"])
def test_string_key_join(jt, strategy):
    """String keys share one dictionary; a probe string absent from it is
    NULL and never matches."""
    build = [{"bk": k, "bv": i} for i, k in enumerate(["a", "b", "c", None, "a"])]
    probe = [{"pk": k, "pv": i} for i, k in enumerate(["a", "c", "c", None, "x"])]
    results = []
    for pkg in (jcol, tcol):
        bt = _host(pkg, build)
        d = bt.schema.field("bk").dictionary
        codes = np.array([d.code_of(r["pk"]) if r["pk"] is not None else 0 for r in probe],
                         dtype=np.int32)
        valid = np.array([r["pk"] is not None and d.code_of(r["pk"]) >= 0 for r in probe])
        pt = pkg.HostTable.from_numpy({"pk": codes, "pv": np.arange(5, dtype=np.int32)},
                                      dtypes={"pk": pkg.STRING}, dictionaries={"pk": d},
                                      validity={"pk": valid})
        if pkg is jcol:
            res = jjoin.hash_join(bt.to_device(), pt.to_device(), ["bk"], ["pk"],
                                  jjoin.JoinType[jt], 256, **_strategy_kw(strategy)[0])
        else:
            res = tjoin.hash_join(bt.to_device(device="cpu"), pt.to_device(device="cpu"),
                                  ["bk"], ["pk"], tjoin.JoinType[jt], 256,
                                  **_strategy_kw(strategy)[1])
        results.append((res[0].to_host().to_pylist(), int(res[1])))
    assert results[0][1] == results[1][1]
    assert_rows_equal(results[1][0], results[0][0])


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "RIGHT_SEMI", "FULL", "LEFT_ANTI"])
def test_float_keys_signed_zero_and_nan(jt, strategy):
    """float64 keys take the full-fetch path (K9): -0.0 meets 0.0, NaN
    meets nothing (not even NaN), NULL meets nothing."""
    vals = [0.0, -0.0, float("nan"), 1.5, None, 2.25, 1.5, -3.0]
    build = [{"bk": v, "bv": i} for i, v in enumerate(vals)]
    probe = [{"pk": v, "pv": i} for i, v in enumerate([-0.0, float("nan"), 1.5, 7.0, None,
                                                       0.0, -3.0, 2.25, 1.5])]
    got, want = _both(build, probe, ["bk"], ["pk"], jt, strategy)
    assert int(got[1]) == int(want[1])

    def rows(t):   # NaN as a string, so that equal rows compare equal
        return [{k: "NaN" if isinstance(v, float) and v != v else v for k, v in r.items()}
                for r in t.to_host().to_pylist()]

    assert sorted(map(repr, rows(got[0]))) == sorted(map(repr, rows(want[0])))


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "LEFT_ANTI", "RIGHT"])
@pytest.mark.parametrize("widths", ["int32_int64", "int64_int32", "float32_int32"])
def test_mixed_width_keys(jt, widths, strategy):
    """Keys of different types compare in their promoted type (K9)."""
    rng = np.random.default_rng(5)
    a, b = widths.split("_")
    dt = {"int32": jcol.INT32, "int64": jcol.INT64, "float32": jcol.FLOAT32}
    tdt = {"int32": tcol.INT32, "int64": tcol.INT64, "float32": tcol.FLOAT32}
    bk = [int(x) if x >= 0 else None for x in rng.integers(-3, 30, 60)]
    pk = [int(x) if x >= 0 else None for x in rng.integers(-3, 30, 80)]
    if a == "float32":
        bk = [None if x is None else float(x) / 2 for x in bk]
    build = [{"bk": k, "bv": i} for i, k in enumerate(bk)]
    probe = [{"pk": k, "pv": i} for i, k in enumerate(pk)]
    results = []
    for pkg, d, run, skw in ((jcol, dt, jjoin, _strategy_kw(strategy)[0]),
                             (tcol, tdt, tjoin, _strategy_kw(strategy)[1])):
        bt = _host(pkg, build, {"bk": d[a]})
        pt = _host(pkg, probe, {"pk": d[b]})
        kw = {} if pkg is jcol else {"device": "cpu"}
        res = run.hash_join(bt.to_device(**kw), pt.to_device(**kw), ["bk"], ["pk"],
                            run.JoinType[jt], 8192, **skw)
        results.append((res[0].to_host().to_pylist(), int(res[1])))
    assert results[0][1] == results[1][1]
    assert_rows_equal(results[1][0], results[0][0])


def _masked_rows(t, mask):
    """The rows where `mask` is True, as dicts (None for NULL)."""
    m = np.asarray(mask)
    cols = {}
    for name in t.schema.names:
        v, valid = t.column(name)
        cols[name] = (np.asarray(v)[m], np.asarray(valid)[m])
    return [{n: (None if not cols[n][1][i] else cols[n][0][i].item()) for n in cols}
            for i in range(int(m.sum()))]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("jt", EXPANDABLE)
def test_expanded(jt, residual, strategy):
    """Late materialization: INNER gives the uncompacted candidate slots
    (full fetch, K9) with the match mask, semi/anti the input side with its
    flag, with or without a residual filter; the masked rows equal the JAX
    package's."""
    build = [{"bk": r["k"], "bv": r["v"]} for r in make_rows(40, 12, 7, nulls=True)]
    probe = [{"pk": r["k"], "pv": float(r["v"])} for r in make_rows(50, 12, 8, nulls=True)]
    kw = {"residual": _parity_residual} if residual else {}
    (tt, tm, ttotal), (jt_, jm, jtotal) = _both(build, probe, ["bk"], ["pk"], jt, strategy,
                                                expanded=True, **kw)
    assert int(ttotal) == int(jtotal)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tt.capacity == jt_.capacity
    assert _masked_rows(tt, tm.numpy()) == _masked_rows(jt_, np.asarray(jm))


@pytest.mark.parametrize("jt", TYPES)
def test_build_and_probe_valid(jt, strategy):
    """Chain fusion: masked rows take no part (K1's row mask on the build
    side, the candidate mask on the probe side) and are never unmatched."""
    build = [{"bk": r["k"], "bv": r["v"]} for r in make_rows(45, 15, 11, nulls=True)]
    probe = [{"pk": r["k"], "pv": r["v"]} for r in make_rows(60, 15, 12, nulls=True)]
    rng = np.random.default_rng(13)
    bvalid, pvalid = rng.random(128) < 0.7, rng.random(128) < 0.6
    got, want = _both(build, probe, ["bk"], ["pk"], jt, strategy, build_valid=bvalid,
                      probe_valid=pvalid)
    assert int(got[1]) == int(want[1])
    assert_rows_equal(got[0].to_host().to_pylist(), want[0].to_host().to_pylist())
    expected = oracle_join([r for i, r in enumerate(build) if bvalid[i]],
                           [r for i, r in enumerate(probe) if pvalid[i]],
                           ["bk"], ["pk"], jt.lower())
    assert_rows_equal(got[0].to_host().to_pylist(), expected)


@pytest.mark.parametrize("jt", ["INNER", "LEFT", "LEFT_SEMI", "LEFT_ANTI"])
def test_return_visited(jt, strategy):
    """The raw build-side visited mask (K10) comes back after the result."""
    build = [{"bk": r["k"], "bv": r["v"]} for r in make_rows(30, 10, 21, nulls=True)]
    probe = [{"pk": r["k"], "pv": r["v"]} for r in make_rows(25, 10, 22)]
    got, want = _both(build, probe, ["bk"], ["pk"], jt, strategy, return_visited=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[1]) == int(want[1])
    assert_rows_equal(got[0].to_host().to_pylist(), want[0].to_host().to_pylist())


def test_padding_and_overflow_like_jax(strategy):
    """Inputs padded past their rows, and an out_cap below the candidate
    total: the totals agree and the kept rows are a subset of the JAX
    package's own truncated LEFT result's pair rows."""
    build = [{"bk": i % 6, "bv": i} for i in range(50)]
    probe = [{"pk": i % 6, "pv": i} for i in range(70)]
    got, want = _both(build, probe, ["bk"], ["pk"], "LEFT", strategy, out_cap=256, bcap=256,
                      pcap=512)
    assert int(got[1]) == int(want[1]) > 256
    assert int(got[0].num_rows) == int(want[0].num_rows)
    assert_rows_equal(got[0].to_host().to_pylist(), want[0].to_host().to_pylist())


@pytest.mark.parametrize("keys", ["int", "float", "residual"])
@pytest.mark.parametrize("jt", TYPES)
def test_prepared_build_matches_jax(jt, keys, strategy):
    """hash_join(prepared=prepare_build(...)): the frozen build of the
    streamed and grace paths (K1 + K2 once, its rows in perm order kept),
    on the deferred path (int keys), the full-fetch path (float keys) and
    with a residual, equal to the JAX package's and the oracle's rows."""
    build = [{"bk": r["k"], "bv": r["v"]} for r in make_rows(57, 20, 11, nulls=True)]
    probe = [{"pk": r["k"], "pv": r["v"]} for r in make_rows(91, 20, 12, nulls=True)]
    kw, residual_rows = {}, None
    if keys == "float":
        for r in build:
            r["bk"] = None if r["bk"] is None else r["bk"] * 0.5
        for r in probe:
            r["pk"] = None if r["pk"] is None else r["pk"] * 0.5
    elif keys == "residual":
        kw["residual"] = _parity_residual
        residual_rows = lambda r: (r["bv"] + r["pv"]) % 2 == 0   # noqa: E731
    _check(build, probe, ["bk"], ["pk"], jt, strategy, residual_rows, prepared=True, bcap=64,
           **kw)


@pytest.mark.parametrize("jt", ["LEFT", "FULL", "LEFT_SEMI", "LEFT_ANTI"])
def test_visited_into_is_incoming_or_visited(jt, strategy):
    """visited_into (K10's accumulate mode): the matches ORed into the
    caller's buffer, as the JAX package's streamed fold `incoming | vis`."""
    build = [{"bk": r["k"], "bv": r["v"]} for r in make_rows(57, 20, 21)]
    probe = [{"pk": r["k"], "pv": r["v"]} for r in make_rows(31, 40, 22)]
    incoming = np.random.default_rng(3).random(64) < 0.3
    expanded = jt in ("LEFT_SEMI", "LEFT_ANTI")
    buf = torch.from_numpy(incoming.copy())
    got, want = _both(build, probe, ["bk"], ["pk"], jt, strategy, bcap=64, return_visited=True,
                      expanded=expanded, visited_into=buf)
    assert got[-1] is buf
    np.testing.assert_array_equal(buf.numpy(), incoming | np.asarray(want[-1]))
