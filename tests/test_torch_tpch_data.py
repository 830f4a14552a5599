"""The port's copies of the TPC-H generator and oracle against the JAX
package's originals, the JAX planner's Q1 and Q6 operator chains run
through the port's operators (ops/plan.py) against the JAX executor, and
chip_smoke.py's Q18- and Q20-shaped chains against numpy.

Tolerances: generated columns and oracle answers equal exactly; the
chains' outputs equal the JAX executor's in order, floats (sums of float
columns and averages) within rel 1e-9, everything else exactly."""

import math

import numpy as np
import pytest

import chip_smoke
from datafusion_parallelism_tpu.api import SessionContext
from datafusion_parallelism_tpu.models import physical as jphys
from datafusion_parallelism_tpu.tpch import datagen as jdatagen
from datafusion_parallelism_tpu.tpch import oracle as joracle
from datafusion_parallelism_tpu.tpch.queries import query_sql
from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS, ChainKernels
from datafusion_parallelism_tpu_torch.ops.plan import run_steps
from datafusion_parallelism_tpu_torch.tpch import datagen as tdatagen
from datafusion_parallelism_tpu_torch.tpch import oracle as toracle
from datafusion_parallelism_tpu_torch.utils.convert import (expr_from_reference,
                                                           host_table_from_reference)

TABLES = ["region", "nation", "supplier", "customer", "part", "partsupp", "orders",
          "lineitem"]
CHAIN_REL = 1e-9


@pytest.fixture(scope="module")
def generated():
    """(JAX package's tables, the port's) at SF 0.01, both numpy paths."""
    return jdatagen.generate_tables(0.01, use_native=False), tdatagen.generate_tables(0.01)


def _fields(t):
    return [(f.name, f.dtype.kind.value, f.dtype.scale, f.nullable) for f in t.schema.fields]


@pytest.mark.parametrize("name", TABLES)
def test_generate_tables_copy_matches_original(name, generated):
    j, t = generated[0][name], generated[1][name]
    assert t.num_rows == j.num_rows and _fields(t) == _fields(j)
    for f in j.schema.fields:
        (jv, jm), (tv, tm) = j.columns[f.name], t.columns[f.name]
        assert tv.dtype == jv.dtype
        np.testing.assert_array_equal(tv, jv, err_msg=f.name)
        np.testing.assert_array_equal(tm, jm, err_msg=f.name)
        tf = t.schema.field(f.name)
        if f.dictionary is None:
            assert tf.dictionary is None
        else:
            assert list(tf.dictionary.values) == list(f.dictionary.values)


@pytest.fixture(scope="module")
def small():
    """(JAX package's tables, the port's) at SF 0.002."""
    return jdatagen.generate_tables(0.002, use_native=False), tdatagen.generate_tables(0.002)


@pytest.mark.parametrize("q", range(1, 23))
def test_oracle_copy_matches_original(q, small):
    assert toracle.oracle_query(q, small[1]) == joracle.oracle_query(q, small[0])


# Q1, Q16, Q19 and Q21: the copy's changed numpy paths
@pytest.mark.parametrize("q", [1, 6, 16, 19, 21])
def test_numpy_oracle_copy_matches_original(q, generated):
    fn = f"_q{q}_np"
    assert getattr(toracle, fn)(generated[1]) == getattr(joracle, fn)(generated[0])


# ---------------------------------------------------------------------------
# the planner's Q1 and Q6 chains through the port's operators
# ---------------------------------------------------------------------------

def plan_steps(plan):
    """(scan label, steps) of a single-table physical plan, bottom up, in
    ops/plan.py run_steps' form, every expression converted to the port's
    classes."""
    steps = []
    node = plan
    while not isinstance(node, jphys.PScan):
        if isinstance(node, jphys.PProject):
            fields = None if node.out_fields is None else [expr_from_reference(f)
                                                           for f in node.out_fields]
            steps.append(("project", [(expr_from_reference(e), n) for e, n in node.exprs],
                          fields))
        elif isinstance(node, jphys.PFilter):
            steps.append(("filter", expr_from_reference(node.predicate)))
        elif isinstance(node, jphys.PAggregate):
            steps.append(("aggregate", list(node.group_keys),
                          [expr_from_reference(a) for a in node.aggs]))
        elif isinstance(node, jphys.PSort):
            steps.append(("sort", [expr_from_reference(k) for k in node.keys]))
        elif isinstance(node, jphys.PLimit):
            steps.append(("limit", node.n))
        else:
            raise TypeError(type(node).__name__)
        node = node.child
    return node.label, steps[::-1]


@pytest.fixture(scope="module")
def planned(small):
    """{q: (label, steps, the JAX executor's rows)} for Q1 and Q6."""
    ctx = SessionContext()
    for name, t in small[0].items():
        ctx.register_table(name, t)
    out = {}
    for q in (1, 6):
        handle = ctx.sql(query_sql(q))
        out[q] = (*plan_steps(handle.plan), handle.collect().to_pylist())
    return out


@pytest.mark.parametrize("q", [1, 6])
def test_planner_chain_through_port_matches_jax_executor(q, planned, small):
    label, steps, want = planned[q]
    t = host_table_from_reference(small[0]["lineitem"]).to_device(device="cpu")
    out, _ = run_steps(chip_smoke.qualify(t, label), steps)
    got = out.to_host().to_pylist()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, wv in w.items():
            if isinstance(wv, float):
                assert math.isclose(g[k], wv, rel_tol=CHAIN_REL), (k, g[k], wv)
            else:
                assert g[k] == wv, (k, g[k], wv)
    # and the copied oracle agrees with both
    oracle = toracle.oracle_query(q, small[1])
    assert [sorted(r) for r in oracle] == [sorted(r) for r in got]


@pytest.mark.parametrize("q", [1, 6])
def test_chip_smoke_chains_equal_planner_trees(q, planned):
    """chip_smoke.py's hand-written Q1 and Q6 steps are the planner's
    (projections compared without their plan-time out_fields)."""
    _, steps, _ = planned[q]
    bare = [s[:2] if s[0] == "project" else s for s in steps]
    assert {1: chip_smoke.q1_steps, 6: chip_smoke.q6_steps}[q]() == bare


def _counting(calls):
    """KERNELS with each entry point's calls counted in `calls`."""
    def count(entry, fn):
        def run(*args):
            calls[entry] = calls.get(entry, 0) + 1
            return fn(*args)
        return run
    return ChainKernels(*(count(e, fn) for e, fn in zip(ChainKernels._fields, KERNELS)))


@pytest.mark.parametrize("chain, entries", [
    ("Q1", {"direct_agg", "filter_compact", "radix_sort", "gather_rows", "pack_rows",
            "unpack_rows", "expr_eval"}),
    ("Q6", {"direct_agg", "expr_eval"}),
    ("Q18-shaped", {"radix_sort", "gather_rows", "segment_agg", "filter_compact", "pack_rows",
                    "unpack_rows", "expr_eval"}),
    ("Q20-shaped", {"hash_slot", "radix_sort", "gather_rows", "segment_agg", "pack_rows",
                    "unpack_rows", "expr_eval"})])
def test_chains_reach_every_kernel_through_the_table(chain, entries, small):
    """run_steps hands its `kernels` to every operator: each kernel the
    chain runs is called through the table (what chip_smoke.py's plain
    path and recorder rely on), and the shaped chains equal numpy."""
    host = small[1]["lineitem"]
    li = chip_smoke.qualify(host.to_device(device="cpu"), "lineitem")
    calls = {}
    out, _ = run_steps(li, chip_smoke.CHAINS[chain](), {}, _counting(calls))
    assert set(calls) == entries
    if chain == "Q18-shaped":
        chip_smoke.check_q18(out, host)
    elif chain == "Q20-shaped":
        assert chip_smoke.check_q20(out, host) > 0
