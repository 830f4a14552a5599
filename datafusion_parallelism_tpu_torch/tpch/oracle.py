"""Independent reference implementations of the 22 TPC-H queries.

Pure Python over row dicts — deliberately naive and engine-independent, the
answer-checking role of the reference's first-iteration result CSVs
(reference tpc/src/main.rs:368-377). Used by tests to assert result equality
on the generated dataset.

A copy of the JAX package's `tpch/oracle.py` over the port's HostTable (the
machine with the GPU has no jax); a test holds it equal to the original.
Its numpy paths give the original's answers in less time at SF10: plain
uniques go through `_unique` (a sort), Q1 groups by a count over its small
key range and sums each column once, in passes of 2^25 lineitem rows (at
SF100 its temporaries at once would take ~48 GB of host memory), and Q19
tests only the rows its ship mode and instruction keep.
"""

from __future__ import annotations

from collections import defaultdict
from datetime import date, timedelta
from typing import Dict, List

from ..utils.columnar import HostTable, date32_of


def _rows(t: HostTable) -> List[dict]:
    return t.to_pylist()


def _d(s: str) -> int:
    return date32_of(s)


def _year(days: int) -> int:
    return (date(1970, 1, 1) + timedelta(days=days)).year


def _sorted_limit(rows, key, limit=None):
    rows = sorted(rows, key=key)
    return rows[:limit] if limit else rows


def oracle_query(q: int, tables: Dict[str, HostTable]) -> List[dict]:
    # big inputs take the numpy fast path where one exists (60M row dicts
    # cost ~60 GB / hours at SF10); the row-dict oracle stays the authority
    # via tests that assert fast == slow on small data
    if tables["lineitem"].num_rows > 2_000_000 and q in _FAST:
        return _FAST[q](tables)
    li = _rows(tables["lineitem"])
    return _IMPL[q](tables, li)


def _q1(t, li):
    cutoff = _d("1998-12-01") - 90
    groups = defaultdict(list)
    for r in li:
        if r["l_shipdate"] <= cutoff:
            groups[(r["l_returnflag"], r["l_linestatus"])].append(r)
    out = []
    for (rf, ls), rows in groups.items():
        n = len(rows)
        disc_price = [r["l_extendedprice"] * (1 - r["l_discount"]) for r in rows]
        charge = [r["l_extendedprice"] * (1 - r["l_discount"]) * (1 + r["l_tax"])
                  for r in rows]
        out.append({
            "l_returnflag": rf, "l_linestatus": ls,
            "sum_qty": sum(r["l_quantity"] for r in rows),
            "sum_base_price": sum(r["l_extendedprice"] for r in rows),
            "sum_disc_price": sum(disc_price),
            "sum_charge": sum(charge),
            "avg_qty": sum(r["l_quantity"] for r in rows) / n,
            "avg_price": sum(r["l_extendedprice"] for r in rows) / n,
            "avg_disc": sum(r["l_discount"] for r in rows) / n,
            "count_order": n,
        })
    return _sorted_limit(out, lambda r: (r["l_returnflag"], r["l_linestatus"]))


def _q2(t, li):
    part = _rows(t["part"])
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    ps = _rows(t["partsupp"])
    nat = {r["n_nationkey"]: r for r in _rows(t["nation"])}
    reg = {r["r_regionkey"]: r for r in _rows(t["region"])}

    def in_europe(s):
        return reg[nat[s["s_nationkey"]]["n_regionkey"]]["r_name"] == "EUROPE"

    min_cost = {}
    for r in ps:
        s = supp[r["ps_suppkey"]]
        if in_europe(s):
            k = r["ps_partkey"]
            min_cost[k] = min(min_cost.get(k, 1e30), r["ps_supplycost"])
    out = []
    for p in part:
        if p["p_size"] != 15 or not p["p_type"].endswith("BRASS"):
            continue
        for r in ps:
            if r["ps_partkey"] != p["p_partkey"]:
                continue
            s = supp[r["ps_suppkey"]]
            if not in_europe(s):
                continue
            if r["ps_supplycost"] == min_cost.get(p["p_partkey"]):
                n = nat[s["s_nationkey"]]
                out.append({"s_acctbal": s["s_acctbal"], "s_name": s["s_name"],
                            "n_name": n["n_name"], "p_partkey": p["p_partkey"],
                            "p_mfgr": p["p_mfgr"], "s_address": s["s_address"],
                            "s_phone": s["s_phone"], "s_comment": s["s_comment"]})
    return _sorted_limit(out, lambda r: (-r["s_acctbal"], r["n_name"],
                                         r["s_name"], r["p_partkey"]), 100)


def _q3(t, li):
    cut = _d("1995-03-15")
    cust = {r["c_custkey"]: r for r in _rows(t["customer"])
            if r["c_mktsegment"] == "BUILDING"}
    orders = {r["o_orderkey"]: r for r in _rows(t["orders"])
              if r["o_orderdate"] < cut and r["o_custkey"] in cust}
    groups = defaultdict(float)
    meta = {}
    for r in li:
        o = orders.get(r["l_orderkey"])
        if o is None or r["l_shipdate"] <= cut:
            continue
        k = (r["l_orderkey"], o["o_orderdate"], o["o_shippriority"])
        groups[k] += r["l_extendedprice"] * (1 - r["l_discount"])
        meta[k] = o
    out = [{"l_orderkey": k[0], "revenue": v, "o_orderdate": k[1],
            "o_shippriority": k[2]} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: (-r["revenue"], r["o_orderdate"]), 10)


def _q4(t, li):
    lo, hi = _d("1993-07-01"), _d("1993-10-01")
    late = {r["l_orderkey"] for r in li
            if r["l_commitdate"] < r["l_receiptdate"]}
    groups = defaultdict(int)
    for o in _rows(t["orders"]):
        if lo <= o["o_orderdate"] < hi and o["o_orderkey"] in late:
            groups[o["o_orderpriority"]] += 1
    out = [{"o_orderpriority": k, "order_count": v} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: r["o_orderpriority"])


def _q5(t, li):
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    nat = {r["n_nationkey"]: r for r in _rows(t["nation"])}
    reg = {r["r_regionkey"]: r for r in _rows(t["region"])}
    asia = {k: n for k, n in nat.items()
            if reg[n["n_regionkey"]]["r_name"] == "ASIA"}
    cust = {r["c_custkey"]: r for r in _rows(t["customer"])}
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    orders = {r["o_orderkey"]: r for r in _rows(t["orders"])
              if lo <= r["o_orderdate"] < hi}
    groups = defaultdict(float)
    for r in li:
        o = orders.get(r["l_orderkey"])
        if o is None:
            continue
        c = cust[o["o_custkey"]]
        s = supp[r["l_suppkey"]]
        if c["c_nationkey"] != s["s_nationkey"]:
            continue
        n = asia.get(s["s_nationkey"])
        if n is None:
            continue
        groups[n["n_name"]] += r["l_extendedprice"] * (1 - r["l_discount"])
    out = [{"n_name": k, "revenue": v} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: -r["revenue"])


def _q6(t, li):
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    rev = sum(r["l_extendedprice"] * r["l_discount"] for r in li
              if lo <= r["l_shipdate"] < hi
              and 0.05 <= r["l_discount"] <= 0.07
              and r["l_quantity"] < 24)
    return [{"revenue": rev if rev else None}]


def _q7(t, li):
    lo, hi = _d("1995-01-01"), _d("1996-12-31")
    nat = {r["n_nationkey"]: r["n_name"] for r in _rows(t["nation"])}
    cust = {r["c_custkey"]: r for r in _rows(t["customer"])}
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    orders = {r["o_orderkey"]: r for r in _rows(t["orders"])}
    groups = defaultdict(float)
    for r in li:
        if not (lo <= r["l_shipdate"] <= hi):
            continue
        s = supp[r["l_suppkey"]]
        o = orders[r["l_orderkey"]]
        c = cust[o["o_custkey"]]
        n1, n2 = nat[s["s_nationkey"]], nat[c["c_nationkey"]]
        if {n1, n2} != {"FRANCE", "GERMANY"}:
            continue
        key = (n1, n2, _year(r["l_shipdate"]))
        groups[key] += r["l_extendedprice"] * (1 - r["l_discount"])
    out = [{"supp_nation": k[0], "cust_nation": k[1], "l_year": k[2],
            "revenue": v} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: (r["supp_nation"], r["cust_nation"],
                                         r["l_year"]))


def _q8(t, li):
    lo, hi = _d("1995-01-01"), _d("1996-12-31")
    nat = {r["n_nationkey"]: r for r in _rows(t["nation"])}
    reg = {r["r_regionkey"]: r["r_name"] for r in _rows(t["region"])}
    cust = {r["c_custkey"]: r for r in _rows(t["customer"])}
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    part = {r["p_partkey"]: r for r in _rows(t["part"])}
    orders = {r["o_orderkey"]: r for r in _rows(t["orders"])}
    by_year = defaultdict(lambda: [0.0, 0.0])  # year -> [brazil_vol, total]
    for r in li:
        p = part[r["l_partkey"]]
        if p["p_type"] != "ECONOMY ANODIZED STEEL":
            continue
        o = orders[r["l_orderkey"]]
        if not (lo <= o["o_orderdate"] <= hi):
            continue
        c = cust[o["o_custkey"]]
        if reg[nat[c["c_nationkey"]]["n_regionkey"]] != "AMERICA":
            continue
        s = supp[r["l_suppkey"]]
        vol = r["l_extendedprice"] * (1 - r["l_discount"])
        y = _year(o["o_orderdate"])
        by_year[y][1] += vol
        if nat[s["s_nationkey"]]["n_name"] == "BRAZIL":
            by_year[y][0] += vol
    out = [{"o_year": y, "mkt_share": bz / tot if tot else None}
           for y, (bz, tot) in by_year.items()]
    return _sorted_limit(out, lambda r: r["o_year"])


def _q9(t, li):
    nat = {r["n_nationkey"]: r["n_name"] for r in _rows(t["nation"])}
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    part = {r["p_partkey"]: r for r in _rows(t["part"])}
    ps_cost = {(r["ps_partkey"], r["ps_suppkey"]): r["ps_supplycost"]
               for r in _rows(t["partsupp"])}
    orders = {r["o_orderkey"]: r for r in _rows(t["orders"])}
    groups = defaultdict(float)
    for r in li:
        p = part[r["l_partkey"]]
        if "green" not in p["p_name"]:
            continue
        s = supp[r["l_suppkey"]]
        cost = ps_cost[(r["l_partkey"], r["l_suppkey"])]
        o = orders[r["l_orderkey"]]
        amount = (r["l_extendedprice"] * (1 - r["l_discount"])
                  - cost * r["l_quantity"])
        groups[(nat[s["s_nationkey"]], _year(o["o_orderdate"]))] += amount
    out = [{"nation": k[0], "o_year": k[1], "sum_profit": v}
           for k, v in groups.items()]
    return _sorted_limit(out, lambda r: (r["nation"], -r["o_year"]))


def _q10(t, li):
    lo, hi = _d("1993-10-01"), _d("1994-01-01")
    nat = {r["n_nationkey"]: r["n_name"] for r in _rows(t["nation"])}
    cust = {r["c_custkey"]: r for r in _rows(t["customer"])}
    orders = {r["o_orderkey"]: r for r in _rows(t["orders"])
              if lo <= r["o_orderdate"] < hi}
    groups = defaultdict(float)
    for r in li:
        if r["l_returnflag"] != "R":
            continue
        o = orders.get(r["l_orderkey"])
        if o is None:
            continue
        c = cust[o["o_custkey"]]
        k = (c["c_custkey"], c["c_name"], c["c_acctbal"], c["c_phone"],
             nat[c["c_nationkey"]], c["c_address"], c["c_comment"])
        groups[k] += r["l_extendedprice"] * (1 - r["l_discount"])
    out = [{"c_custkey": k[0], "c_name": k[1], "revenue": v, "c_acctbal": k[2],
            "n_name": k[4], "c_address": k[5], "c_phone": k[3],
            "c_comment": k[6]} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: -r["revenue"], 20)


def _q11(t, li):
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    nat = {r["n_nationkey"]: r["n_name"] for r in _rows(t["nation"])}
    groups = defaultdict(float)
    total = 0.0
    for r in _rows(t["partsupp"]):
        if nat[supp[r["ps_suppkey"]]["s_nationkey"]] != "GERMANY":
            continue
        v = r["ps_supplycost"] * r["ps_availqty"]
        groups[r["ps_partkey"]] += v
        total += v
    thresh = total * 0.0001
    out = [{"ps_partkey": k, "value": v} for k, v in groups.items()
           if v > thresh]
    return _sorted_limit(out, lambda r: -r["value"])


def _q12(t, li):
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    prio = {r["o_orderkey"]: r["o_orderpriority"] for r in _rows(t["orders"])}
    groups = defaultdict(lambda: [0, 0])
    for r in li:
        if (r["l_shipmode"] in ("MAIL", "SHIP")
                and r["l_commitdate"] < r["l_receiptdate"]
                and r["l_shipdate"] < r["l_commitdate"]
                and lo <= r["l_receiptdate"] < hi):
            high = prio[r["l_orderkey"]] in ("1-URGENT", "2-HIGH")
            groups[r["l_shipmode"]][0 if high else 1] += 1
    out = [{"l_shipmode": k, "high_line_count": v[0], "low_line_count": v[1]}
           for k, v in groups.items()]
    return _sorted_limit(out, lambda r: r["l_shipmode"])


def _q13(t, li):
    import re
    pat = re.compile("^.*special.*requests.*$")
    counts = defaultdict(int)
    for o in _rows(t["orders"]):
        if not pat.match(o["o_comment"]):
            counts[o["o_custkey"]] += 1
    dist = defaultdict(int)
    for c in _rows(t["customer"]):
        dist[counts.get(c["c_custkey"], 0)] += 1
    out = [{"c_count": k, "custdist": v} for k, v in dist.items()]
    return _sorted_limit(out, lambda r: (-r["custdist"], -r["c_count"]))


def _q14(t, li):
    lo, hi = _d("1995-09-01"), _d("1995-10-01")
    ptype = {r["p_partkey"]: r["p_type"] for r in _rows(t["part"])}
    promo = total = 0.0
    for r in li:
        if not (lo <= r["l_shipdate"] < hi):
            continue
        v = r["l_extendedprice"] * (1 - r["l_discount"])
        total += v
        if ptype[r["l_partkey"]].startswith("PROMO"):
            promo += v
    return [{"promo_revenue": 100.0 * promo / total if total else None}]


def _q15(t, li):
    lo, hi = _d("1996-01-01"), _d("1996-04-01")
    rev = defaultdict(float)
    for r in li:
        if lo <= r["l_shipdate"] < hi:
            rev[r["l_suppkey"]] += r["l_extendedprice"] * (1 - r["l_discount"])
    if not rev:
        return []
    mx = max(rev.values())
    out = []
    for s in _rows(t["supplier"]):
        v = rev.get(s["s_suppkey"])
        if v is not None and v == mx:
            out.append({"s_suppkey": s["s_suppkey"], "s_name": s["s_name"],
                        "s_address": s["s_address"], "s_phone": s["s_phone"],
                        "total_revenue": v})
    return _sorted_limit(out, lambda r: r["s_suppkey"])


def _q16(t, li):
    import re
    bad = {r["s_suppkey"] for r in _rows(t["supplier"])
           if re.match("^.*Customer.*Complaints.*$", r["s_comment"])}
    sizes = {49, 14, 23, 45, 19, 3, 36, 9}
    part = {r["p_partkey"]: r for r in _rows(t["part"])}
    groups = defaultdict(set)
    for r in _rows(t["partsupp"]):
        p = part[r["ps_partkey"]]
        if (p["p_brand"] != "Brand#45"
                and not p["p_type"].startswith("MEDIUM POLISHED")
                and p["p_size"] in sizes
                and r["ps_suppkey"] not in bad):
            groups[(p["p_brand"], p["p_type"], p["p_size"])].add(r["ps_suppkey"])
    out = [{"p_brand": k[0], "p_type": k[1], "p_size": k[2],
            "supplier_cnt": len(v)} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: (-r["supplier_cnt"], r["p_brand"],
                                         r["p_type"], r["p_size"]))


def _q17(t, li):
    part_ok = {r["p_partkey"] for r in _rows(t["part"])
               if r["p_brand"] == "Brand#23" and r["p_container"] == "MED BOX"}
    qty = defaultdict(list)
    for r in li:
        qty[r["l_partkey"]].append(r["l_quantity"])
    total = 0.0
    any_row = False
    for r in li:
        if r["l_partkey"] not in part_ok:
            continue
        avg = sum(qty[r["l_partkey"]]) / len(qty[r["l_partkey"]])
        if r["l_quantity"] < 0.2 * avg:
            total += r["l_extendedprice"]
            any_row = True
    return [{"avg_yearly": total / 7.0 if any_row else None}]


def _q18(t, li):
    qty = defaultdict(float)
    for r in li:
        qty[r["l_orderkey"]] += r["l_quantity"]
    big = {k for k, v in qty.items() if v > 300}
    cust = {r["c_custkey"]: r for r in _rows(t["customer"])}
    out = []
    for o in _rows(t["orders"]):
        if o["o_orderkey"] not in big:
            continue
        c = cust[o["o_custkey"]]
        out.append({"c_name": c["c_name"], "c_custkey": c["c_custkey"],
                    "o_orderkey": o["o_orderkey"],
                    "o_orderdate": o["o_orderdate"],
                    "o_totalprice": o["o_totalprice"],
                    "sum_qty": qty[o["o_orderkey"]]})
    return _sorted_limit(out, lambda r: (-r["o_totalprice"], r["o_orderdate"]),
                         100)


def _q19(t, li):
    part = {r["p_partkey"]: r for r in _rows(t["part"])}
    branches = [
        ("Brand#12", {"SM CASE", "SM BOX", "SM PACK", "SM PKG"}, 1, 11, 5),
        ("Brand#23", {"MED BAG", "MED BOX", "MED PKG", "MED PACK"}, 10, 20, 10),
        ("Brand#34", {"LG CASE", "LG BOX", "LG PACK", "LG PKG"}, 20, 30, 15),
    ]
    rev = 0.0
    matched = False
    for r in li:
        if (r["l_shipmode"] not in ("AIR", "AIR REG")
                or r["l_shipinstruct"] != "DELIVER IN PERSON"):
            continue
        p = part[r["l_partkey"]]
        for brand, conts, qlo, qhi, smax in branches:
            if (p["p_brand"] == brand and p["p_container"] in conts
                    and qlo <= r["l_quantity"] <= qhi
                    and 1 <= p["p_size"] <= smax):
                rev += r["l_extendedprice"] * (1 - r["l_discount"])
                matched = True
                break
    return [{"revenue": rev if matched else None}]


def _q20(t, li):
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    forest = {r["p_partkey"] for r in _rows(t["part"])
              if r["p_name"].startswith("forest")}
    shipped = defaultdict(float)
    for r in li:
        if lo <= r["l_shipdate"] < hi:
            shipped[(r["l_partkey"], r["l_suppkey"])] += r["l_quantity"]
    good_supp = set()
    for r in _rows(t["partsupp"]):
        k = (r["ps_partkey"], r["ps_suppkey"])
        if (r["ps_partkey"] in forest and k in shipped
                and r["ps_availqty"] > 0.5 * shipped[k]):
            good_supp.add(r["ps_suppkey"])
    nat = {r["n_nationkey"]: r["n_name"] for r in _rows(t["nation"])}
    out = [{"s_name": s["s_name"], "s_address": s["s_address"]}
           for s in _rows(t["supplier"])
           if s["s_suppkey"] in good_supp
           and nat[s["s_nationkey"]] == "CANADA"]
    return _sorted_limit(out, lambda r: r["s_name"])


def _q21(t, li):
    status = {r["o_orderkey"]: r["o_orderstatus"] for r in _rows(t["orders"])}
    nat = {r["n_nationkey"]: r["n_name"] for r in _rows(t["nation"])}
    supp = {r["s_suppkey"]: r for r in _rows(t["supplier"])}
    by_order = defaultdict(list)
    for r in li:
        by_order[r["l_orderkey"]].append(r)
    groups = defaultdict(int)
    for r in li:
        if r["l_receiptdate"] <= r["l_commitdate"]:
            continue
        if status.get(r["l_orderkey"]) != "F":
            continue
        s = supp[r["l_suppkey"]]
        if nat[s["s_nationkey"]] != "SAUDI ARABIA":
            continue
        others = [x for x in by_order[r["l_orderkey"]]
                  if x["l_suppkey"] != r["l_suppkey"]]
        if not others:
            continue
        if any(x["l_receiptdate"] > x["l_commitdate"] for x in others):
            continue
        groups[s["s_name"]] += 1
    out = [{"s_name": k, "numwait": v} for k, v in groups.items()]
    return _sorted_limit(out, lambda r: (-r["numwait"], r["s_name"]), 100)


def _q22(t, li):
    codes = {"13", "31", "23", "29", "30", "18", "17"}
    cust = _rows(t["customer"])
    eligible = [c for c in cust if c["c_phone"][:2] in codes]
    pos = [c["c_acctbal"] for c in eligible if c["c_acctbal"] > 0.0]
    if not pos:
        return []
    avg = sum(pos) / len(pos)
    has_order = {r["o_custkey"] for r in _rows(t["orders"])}
    groups = defaultdict(lambda: [0, 0.0])
    for c in eligible:
        if c["c_acctbal"] > avg and c["c_custkey"] not in has_order:
            g = groups[c["c_phone"][:2]]
            g[0] += 1
            g[1] += c["c_acctbal"]
    out = [{"cntrycode": k, "numcust": v[0], "totacctbal": v[1]}
           for k, v in groups.items()]
    return _sorted_limit(out, lambda r: r["cntrycode"])


_IMPL = {1: _q1, 2: _q2, 3: _q3, 4: _q4, 5: _q5, 6: _q6, 7: _q7, 8: _q8,
         9: _q9, 10: _q10, 11: _q11, 12: _q12, 13: _q13, 14: _q14, 15: _q15,
         16: _q16, 17: _q17, 18: _q18, 19: _q19, 20: _q20, 21: _q21, 22: _q22}


# ---------------------------------------------------------------------------
# numpy fast paths for big scale factors
#
# The row-dict implementations above are the readable ground truth, but at
# SF10 materializing 60M python dicts costs ~60 GB and hours. These compute
# the same answers vectorized; tests/test_tpch_fast_oracle.py asserts
# row-dict == numpy on small data, so the slow oracle remains the authority.
# ---------------------------------------------------------------------------

def _col(t, name):
    return t.columns[name][0]


def _dec(t, name, rows=None):
    """A decimal column as float64, of `rows` only when given."""
    import numpy as np
    f = next(f for f in t.schema.fields if f.name == name)
    v = _col(t, name) if rows is None else _col(t, name)[rows]
    return v.astype(np.float64) / (10 ** f.dtype.scale)


def _dict_of(t, name):
    return next(f for f in t.schema.fields if f.name == name).dictionary


def _unique(x):
    """np.unique(x) through a sort: NumPy 2.3+ finds plain uniques with a
    hash table, many times slower than a sort over SF10's 60M int64 keys."""
    import numpy as np
    s = np.sort(x)
    return s[np.concatenate(([True], s[1:] != s[:-1]))] if len(s) else s


def _unique_inverse_small(key):
    """np.unique(key, return_inverse=True) for non-negative keys of a small
    range (dictionary codes combined), by a count over the range in place
    of a sort."""
    import numpy as np
    uniq = np.flatnonzero(np.bincount(key))
    lut = np.zeros(int(uniq[-1]) + 1 if len(uniq) else 0, np.int64)
    lut[uniq] = np.arange(len(uniq))
    return uniq, lut[key]


Q1_BLOCK_ROWS = 1 << 25   # lineitem rows a pass of _q1_np: about 3 GB of temporaries


def _q1_np(t, li=None, block_rows=Q1_BLOCK_ROWS):
    """Q1 in passes of `block_rows` lineitem rows, each group's sums
    accumulated over the passes (one pass below block_rows rows): the
    temporaries of a 600M-row lineitem would take ~48 GB at once."""
    import numpy as np
    l = t["lineitem"]
    rfd, lsd = _dict_of(l, "l_returnflag"), _dict_of(l, "l_linestatus")
    width = max(len(rfd.values), 1) * 1000
    n = np.zeros(width)
    sums = np.zeros((5, width))      # qty, price, disc, disc_price, charge
    cutoff = _d("1998-12-01") - 90
    for lo in range(0, l.num_rows, block_rows):
        rows = slice(lo, lo + block_rows)
        m = np.flatnonzero(_col(l, "l_shipdate")[rows] <= cutoff) + lo
        key = _col(l, "l_returnflag")[m].astype(np.int64) * 1000 + _col(l, "l_linestatus")[m]
        qty, price = _dec(l, "l_quantity", m), _dec(l, "l_extendedprice", m)
        disc, tax = _dec(l, "l_discount", m), _dec(l, "l_tax", m)
        disc_price = price * (1 - disc)
        charge = disc_price * (1 + tax)
        n += np.bincount(key, minlength=width)
        for i, x in enumerate((qty, price, disc, disc_price, charge)):
            sums[i] += np.bincount(key, weights=x, minlength=width)
    uniq = np.flatnonzero(n)
    s_qty, s_price, s_disc, s_disc_price, s_charge = sums[:, uniq]
    n = n[uniq]
    out = []
    for i, k in enumerate(uniq):
        out.append({
            "l_returnflag": rfd.values[int(k) // 1000],
            "l_linestatus": lsd.values[int(k) % 1000],
            "sum_qty": float(s_qty[i]),
            "sum_base_price": float(s_price[i]),
            "sum_disc_price": float(s_disc_price[i]),
            "sum_charge": float(s_charge[i]),
            "avg_qty": float(s_qty[i] / n[i]),
            "avg_price": float(s_price[i] / n[i]),
            "avg_disc": float(s_disc[i] / n[i]),
            "count_order": int(n[i]),
        })
    return _sorted_limit(out, lambda r: (r["l_returnflag"], r["l_linestatus"]))


def _q5_np(t, li=None):
    import numpy as np
    nat, reg = t["nation"], t["region"]
    sup, cus, orde, l = t["supplier"], t["customer"], t["orders"], t["lineitem"]
    asia_reg = _col(reg, "r_regionkey")[
        _col(reg, "r_name") == _dict_of(reg, "r_name").code_of("ASIA")]
    nk = _col(nat, "n_nationkey")
    asia_nat = np.isin(_col(nat, "n_regionkey"), asia_reg)
    nat_in_asia = np.zeros(nk.max() + 1, np.bool_)
    nat_in_asia[nk[asia_nat]] = True

    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    od = _col(orde, "o_orderdate")
    owin = (od >= lo) & (od < hi)
    okey, ocust = _col(orde, "o_orderkey"), _col(orde, "o_custkey")
    ord_cust = np.full(int(okey.max()) + 1, -1, np.int64)
    ord_cust[okey[owin]] = ocust[owin]

    ck = _col(cus, "c_custkey")
    cust_nat = np.full(int(ck.max()) + 1, -1, np.int64)
    cust_nat[ck] = _col(cus, "c_nationkey")
    sk = _col(sup, "s_suppkey")
    supp_nat = np.full(int(sk.max()) + 1, -1, np.int64)
    supp_nat[sk] = _col(sup, "s_nationkey")

    lc = ord_cust[_col(l, "l_orderkey")]
    sn = supp_nat[_col(l, "l_suppkey")]
    m = (lc >= 0) & (cust_nat[np.maximum(lc, 0)] == sn) & nat_in_asia[sn]
    rev = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m]
    groups = np.bincount(sn[m], weights=rev, minlength=nk.max() + 1)
    nname = _dict_of(nat, "n_name")
    name_of = {int(k): nname.values[int(c)]
               for k, c in zip(nk, _col(nat, "n_name"))}
    out = [{"n_name": name_of[int(k)], "revenue": float(v)}
           for k, v in enumerate(groups) if nat_in_asia[k] and v != 0]
    return _sorted_limit(out, lambda r: -r["revenue"])


def _q9_np(t, li=None):
    import numpy as np
    nat, sup, part, ps = t["nation"], t["supplier"], t["part"], t["partsupp"]
    orde, l = t["orders"], t["lineitem"]
    pnames = _dict_of(part, "p_name").values.astype(str)
    green_code = np.char.find(pnames, "green") >= 0
    pk = _col(part, "p_partkey")
    part_green = np.zeros(int(pk.max()) + 1, np.bool_)
    part_green[pk] = green_code[_col(part, "p_name")]

    sk = _col(sup, "s_suppkey")
    supp_nat = np.full(int(sk.max()) + 1, -1, np.int64)
    supp_nat[sk] = _col(sup, "s_nationkey")

    # (partkey, suppkey) -> supplycost via sorted composite keys
    psk = (_col(ps, "ps_partkey").astype(np.int64) << 20) | _col(ps, "ps_suppkey")
    order_ = np.argsort(psk)
    psk_sorted = psk[order_]
    cost_sorted = _dec(ps, "ps_supplycost")[order_]

    okey = _col(orde, "o_orderkey")
    ord_year = np.zeros(int(okey.max()) + 1, np.int64)
    # vectorized year extraction: epoch days -> datetime64[Y] + 1970
    ord_year[okey] = (_col(orde, "o_orderdate").astype("datetime64[D]")
                      .astype("datetime64[Y]").astype(np.int64) + 1970)

    lpk = _col(l, "l_partkey")
    m = part_green[lpk]
    lsk = _col(l, "l_suppkey")[m]
    lpk = lpk[m]
    lkey = (lpk.astype(np.int64) << 20) | lsk
    cost = cost_sorted[np.searchsorted(psk_sorted, lkey)]
    amount = (_dec(l, "l_extendedprice")[m] * (1 - _dec(l, "l_discount")[m])
              - cost * _dec(l, "l_quantity")[m])
    natk = supp_nat[lsk]
    year = ord_year[_col(l, "l_orderkey")[m]]
    gkey = natk * 10000 + year
    uniq, inv = np.unique(gkey, return_inverse=True)
    sums = np.bincount(inv, weights=amount, minlength=len(uniq))
    nname = _dict_of(nat, "n_name")
    nk = _col(nat, "n_nationkey")
    name_of = {int(k): nname.values[int(c)]
               for k, c in zip(nk, _col(nat, "n_name"))}
    out = [{"nation": name_of[int(k) // 10000], "o_year": int(k) % 10000,
            "sum_profit": float(v)} for k, v in zip(uniq, sums)]
    return _sorted_limit(out, lambda r: (r["nation"], -r["o_year"]))


def _q3_np(t, li=None):
    import numpy as np
    cus, orde, l = t["customer"], t["orders"], t["lineitem"]
    cut = _d("1995-03-15")
    bldg = _col(cus, "c_mktsegment") == _dict_of(
        cus, "c_mktsegment").code_of("BUILDING")
    ck = _col(cus, "c_custkey")
    cust_bldg = np.zeros(int(ck.max()) + 1, np.bool_)
    cust_bldg[ck[bldg]] = True
    od, okey = _col(orde, "o_orderdate"), _col(orde, "o_orderkey")
    om = (od < cut) & cust_bldg[_col(orde, "o_custkey")]
    ord_date = np.full(int(okey.max()) + 1, -1, np.int64)
    ord_date[okey[om]] = od[om]
    ord_prio = np.zeros(int(okey.max()) + 1, np.int64)
    ord_prio[okey[om]] = _col(orde, "o_shippriority")[om]

    lok = _col(l, "l_orderkey")
    m = (ord_date[lok] >= 0) & (_col(l, "l_shipdate") > cut)
    rev = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m]
    lok = lok[m]
    uniq, inv = np.unique(lok, return_inverse=True)
    sums = np.bincount(inv, weights=rev, minlength=len(uniq))
    out = [{"l_orderkey": int(k), "revenue": float(v),
            "o_orderdate": int(ord_date[int(k)]),
            "o_shippriority": int(ord_prio[int(k)])}
           for k, v in zip(uniq, sums)]
    return _sorted_limit(out, lambda r: (-r["revenue"], r["o_orderdate"]), 10)


def _q6_np(t, li=None):
    import numpy as np
    l = t["lineitem"]
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    ship = _col(l, "l_shipdate")
    disc = _dec(l, "l_discount")
    m = ((ship >= lo) & (ship < hi) & (disc >= 0.05) & (disc <= 0.07)
         & (_dec(l, "l_quantity") < 24))
    rev = float(np.sum((_dec(l, "l_extendedprice") * disc)[m]))
    return [{"revenue": rev if rev else None}]


def _q12_np(t, li=None):
    import numpy as np
    orde, l = t["orders"], t["lineitem"]
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    okey = _col(orde, "o_orderkey")
    pd_ = _dict_of(orde, "o_orderpriority")
    high_codes = {pd_.code_of("1-URGENT"), pd_.code_of("2-HIGH")}
    is_high = np.isin(_col(orde, "o_orderpriority"),
                      np.array(sorted(high_codes)))
    ord_high = np.zeros(int(okey.max()) + 1, np.bool_)
    ord_high[okey] = is_high
    sm = _col(l, "l_shipmode")
    smd = _dict_of(l, "l_shipmode")
    rec = _col(l, "l_receiptdate")
    m = (np.isin(sm, np.array(sorted({smd.code_of("MAIL"),
                                      smd.code_of("SHIP")})))
         & (_col(l, "l_commitdate") < rec)
         & (_col(l, "l_shipdate") < _col(l, "l_commitdate"))
         & (rec >= lo) & (rec < hi))
    high = ord_high[_col(l, "l_orderkey")[m]]
    codes = sm[m]
    out = []
    for c in sorted(set(codes.tolist())):
        cm = codes == c
        out.append({"l_shipmode": smd.values[c],
                    "high_line_count": int(np.sum(cm & high)),
                    "low_line_count": int(np.sum(cm & ~high))})
    return _sorted_limit(out, lambda r: r["l_shipmode"])


def _q21_np(t, li=None):
    import numpy as np
    orde, nat, sup, l = t["orders"], t["nation"], t["supplier"], t["lineitem"]

    okey = _col(orde, "o_orderkey")
    f_code = _dict_of(orde, "o_orderstatus").code_of("F")
    ord_f = np.zeros(int(okey.max()) + 1, np.bool_)
    ord_f[okey[_col(orde, "o_orderstatus") == f_code]] = True

    nk = _col(nat, "n_nationkey")
    saudi_code = _dict_of(nat, "n_name").code_of("SAUDI ARABIA")
    saudi_nat = np.zeros(int(nk.max()) + 1, np.bool_)
    saudi_nat[nk[_col(nat, "n_name") == saudi_code]] = True
    sk = _col(sup, "s_suppkey")
    supp_saudi = np.zeros(int(sk.max()) + 1, np.bool_)
    supp_saudi[sk] = saudi_nat[_col(sup, "s_nationkey")]

    lok = _col(l, "l_orderkey").astype(np.int64)
    lsk = _col(l, "l_suppkey").astype(np.int64)
    late = _col(l, "l_receiptdate") > _col(l, "l_commitdate")

    # EXISTS(other supplier in order)     <=> order's distinct-supplier
    #   count >= 2 (the row's own supplier is always in the set)
    # NOT EXISTS(late other supplier)     <=> order's distinct LATE-supplier
    #   count == 1 (the row itself is late, so its supplier is in the set)
    S = int(lsk.max()) + 1
    nord = int(lok.max()) + 1
    pairs = _unique(lok * S + lsk)
    nsupp = np.bincount((pairs // S).astype(np.int64), minlength=nord)
    pairs_late = _unique(lok[late] * S + lsk[late])
    nsupp_late = np.bincount((pairs_late // S).astype(np.int64),
                             minlength=nord)

    m = (late & ord_f[lok] & supp_saudi[lsk]
         & (nsupp[lok] >= 2) & (nsupp_late[lok] == 1))
    numwait = np.bincount(lsk[m], minlength=S)

    sname = _dict_of(sup, "s_name")
    name_code = np.zeros(S, np.int64)
    name_code[sk] = _col(sup, "s_name")
    out = [{"s_name": sname.values[int(name_code[k])],
            "numwait": int(v)}
           for k, v in enumerate(numwait) if v > 0]
    return _sorted_limit(out, lambda r: (-r["numwait"], r["s_name"]), 100)


def _lut(keys, vals, fill=0):
    """Dense key -> value lookup array (TPC-H keys are small ints)."""
    import numpy as np
    out = np.full(int(keys.max()) + 1, fill,
                  vals.dtype if hasattr(vals, "dtype") else np.int64)
    out[keys] = vals
    return out


def _contains_seq(values, a: str, b: str):
    """bool per string: contains `a` then `b` strictly after it (the
    LIKE '%a%b%' shape of Q13/Q16)."""
    import numpy as np
    v = values.astype(str)
    f1 = np.char.find(v, a)
    f2 = np.char.find(v, b, np.maximum(f1 + len(a), 0))
    return (f1 >= 0) & (f2 >= 0)


def _q2_np(t, li=None):
    import numpy as np
    part, sup, ps = t["part"], t["supplier"], t["partsupp"]
    nat, reg = t["nation"], t["region"]
    eu_regs = _col(reg, "r_regionkey")[
        _col(reg, "r_name") == _dict_of(reg, "r_name").code_of("EUROPE")]
    nk = _col(nat, "n_nationkey")
    nat_eu = _lut(nk, np.isin(_col(nat, "n_regionkey"), eu_regs), False)
    sk = _col(sup, "s_suppkey")
    supp_eu = _lut(sk, nat_eu[_col(sup, "s_nationkey")], False)

    pk = _col(part, "p_partkey")
    types = _dict_of(part, "p_type").values.astype(str)
    part_ok = _lut(pk, (_col(part, "p_size") == 15)
                   & np.char.endswith(types, "BRASS")[_col(part, "p_type")],
                   False)

    psk, pspk = _col(ps, "ps_suppkey"), _col(ps, "ps_partkey")
    cost = _dec(ps, "ps_supplycost")
    eu = supp_eu[psk]
    mincost = np.full(int(pspk.max()) + 1, np.inf)
    np.minimum.at(mincost, pspk[eu], cost[eu])
    sel = np.flatnonzero(eu & part_ok[pspk] & (cost == mincost[pspk]))

    s_nat = _lut(sk, _col(sup, "s_nationkey"))
    n_name = _dict_of(nat, "n_name").values
    nat_name = _lut(nk, _col(nat, "n_name"))
    sd = {c: (_lut(sk, _col(sup, c)), _dict_of(sup, c).values)
          for c in ("s_name", "s_address", "s_phone", "s_comment")}
    s_bal = _lut(sk, _dec(sup, "s_acctbal"), 0.0)
    p_mfgr = _lut(pk, _col(part, "p_mfgr"))
    mfgr_vals = _dict_of(part, "p_mfgr").values
    out = []
    for i in sel:
        s, p = int(psk[i]), int(pspk[i])
        out.append({
            "s_acctbal": float(s_bal[s]),
            "s_name": sd["s_name"][1][int(sd["s_name"][0][s])],
            "n_name": n_name[int(nat_name[int(s_nat[s])])],
            "p_partkey": p, "p_mfgr": mfgr_vals[int(p_mfgr[p])],
            "s_address": sd["s_address"][1][int(sd["s_address"][0][s])],
            "s_phone": sd["s_phone"][1][int(sd["s_phone"][0][s])],
            "s_comment": sd["s_comment"][1][int(sd["s_comment"][0][s])]})
    return _sorted_limit(out, lambda r: (-r["s_acctbal"], r["n_name"],
                                         r["s_name"], r["p_partkey"]), 100)


def _q4_np(t, li=None):
    import numpy as np
    orde, l = t["orders"], t["lineitem"]
    lo, hi = _d("1993-07-01"), _d("1993-10-01")
    lok = _col(l, "l_orderkey")
    late = np.zeros(int(lok.max()) + 1, np.bool_)
    late[lok[_col(l, "l_commitdate") < _col(l, "l_receiptdate")]] = True
    od, okey = _col(orde, "o_orderdate"), _col(orde, "o_orderkey")
    m = (od >= lo) & (od < hi) & late[np.minimum(okey, len(late) - 1)] \
        & (okey <= lok.max())
    prio = _col(orde, "o_orderpriority")[m]
    pd_ = _dict_of(orde, "o_orderpriority")
    out = [{"o_orderpriority": pd_.values[int(c)], "order_count": int(n)}
           for c, n in zip(*np.unique(prio, return_counts=True))]
    return _sorted_limit(out, lambda r: r["o_orderpriority"])


def _q7_np(t, li=None):
    import numpy as np
    nat, sup, cus, orde, l = (t["nation"], t["supplier"], t["customer"],
                              t["orders"], t["lineitem"])
    lo, hi = _d("1995-01-01"), _d("1996-12-31")
    nk = _col(nat, "n_nationkey")
    nd = _dict_of(nat, "n_name")
    fr, de = nd.code_of("FRANCE"), nd.code_of("GERMANY")
    nat_code = _lut(nk, _col(nat, "n_name"), -1)
    supp_nat = _lut(_col(sup, "s_suppkey"), _col(sup, "s_nationkey"), -1)
    cust_nat = _lut(_col(cus, "c_custkey"), _col(cus, "c_nationkey"), -1)
    ord_cust = _lut(_col(orde, "o_orderkey"), _col(orde, "o_custkey"), -1)

    ship = _col(l, "l_shipdate")
    m = (ship >= lo) & (ship <= hi)
    n1 = nat_code[supp_nat[_col(l, "l_suppkey")[m]]]
    n2 = nat_code[cust_nat[ord_cust[_col(l, "l_orderkey")[m]]]]
    pair = ((n1 == fr) & (n2 == de)) | ((n1 == de) & (n2 == fr))
    year = (ship[m][pair].astype("datetime64[D]")
            .astype("datetime64[Y]").astype(np.int64) + 1970)
    rev = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m][pair]
    gkey = (n1[pair].astype(np.int64) * 100 + n2[pair]) * 10000 + year
    uniq, inv = np.unique(gkey, return_inverse=True)
    sums = np.bincount(inv, weights=rev, minlength=len(uniq))
    out = [{"supp_nation": nd.values[int(k) // 1000000],
            "cust_nation": nd.values[(int(k) // 10000) % 100],
            "l_year": int(k) % 10000, "revenue": float(v)}
           for k, v in zip(uniq, sums)]
    return _sorted_limit(out, lambda r: (r["supp_nation"], r["cust_nation"],
                                         r["l_year"]))


def _q8_np(t, li=None):
    import numpy as np
    nat, reg, cus, sup, part, orde, l = (
        t["nation"], t["region"], t["customer"], t["supplier"], t["part"],
        t["orders"], t["lineitem"])
    lo, hi = _d("1995-01-01"), _d("1996-12-31")
    steel = _dict_of(part, "p_type").code_of("ECONOMY ANODIZED STEEL")
    part_ok = _lut(_col(part, "p_partkey"),
                   _col(part, "p_type") == steel, False)
    am_regs = _col(reg, "r_regionkey")[
        _col(reg, "r_name") == _dict_of(reg, "r_name").code_of("AMERICA")]
    nk = _col(nat, "n_nationkey")
    nat_am = _lut(nk, np.isin(_col(nat, "n_regionkey"), am_regs), False)
    brazil = _dict_of(nat, "n_name").code_of("BRAZIL")
    nat_br = _lut(nk, _col(nat, "n_name") == brazil, False)
    cust_am = _lut(_col(cus, "c_custkey"),
                   nat_am[_col(cus, "c_nationkey")], False)
    supp_br = _lut(_col(sup, "s_suppkey"),
                   nat_br[_col(sup, "s_nationkey")], False)
    okey, od = _col(orde, "o_orderkey"), _col(orde, "o_orderdate")
    owin = (od >= lo) & (od <= hi) & cust_am[_col(orde, "o_custkey")]
    ord_year = _lut(okey, np.where(
        owin, (od.astype("datetime64[D]").astype("datetime64[Y]")
               .astype(np.int64) + 1970), 0), 0)

    lok = _col(l, "l_orderkey")
    m = part_ok[_col(l, "l_partkey")] & (ord_year[lok] > 0)
    vol = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m]
    year = ord_year[lok[m]]
    br = supp_br[_col(l, "l_suppkey")[m]]
    uniq, inv = np.unique(year, return_inverse=True)
    tot = np.bincount(inv, weights=vol, minlength=len(uniq))
    bz = np.bincount(inv, weights=vol * br, minlength=len(uniq))
    out = [{"o_year": int(y), "mkt_share": float(b / s) if s else None}
           for y, b, s in zip(uniq, bz, tot)]
    return _sorted_limit(out, lambda r: r["o_year"])


def _q10_np(t, li=None):
    import numpy as np
    nat, cus, orde, l = t["nation"], t["customer"], t["orders"], t["lineitem"]
    lo, hi = _d("1993-10-01"), _d("1994-01-01")
    okey, od = _col(orde, "o_orderkey"), _col(orde, "o_orderdate")
    owin = (od >= lo) & (od < hi)
    ord_cust = _lut(okey, np.where(owin, _col(orde, "o_custkey"), -1), -1)
    rcode = _dict_of(l, "l_returnflag").code_of("R")
    lok = _col(l, "l_orderkey")
    m = (_col(l, "l_returnflag") == rcode) & (ord_cust[lok] >= 0)
    rev = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m]
    ck = ord_cust[lok[m]]
    uniq, inv = np.unique(ck, return_inverse=True)
    sums = np.bincount(inv, weights=rev, minlength=len(uniq))
    top = np.argsort(-sums, kind="stable")[:20]

    cck = _col(cus, "c_custkey")
    cust_row = _lut(cck, np.arange(len(cck)), -1)
    nat_name = _lut(_col(nat, "n_nationkey"), _col(nat, "n_name"), -1)
    nname = _dict_of(nat, "n_name").values
    sd = {c: (_col(cus, c), _dict_of(cus, c).values)
          for c in ("c_name", "c_phone", "c_address", "c_comment")}
    bal = _dec(cus, "c_acctbal")
    out = []
    for i in top:
        k = int(uniq[i])
        r = int(cust_row[k])
        out.append({
            "c_custkey": k,
            "c_name": sd["c_name"][1][int(sd["c_name"][0][r])],
            "revenue": float(sums[i]), "c_acctbal": float(bal[r]),
            "n_name": nname[int(nat_name[int(_col(cus, "c_nationkey")[r])])],
            "c_address": sd["c_address"][1][int(sd["c_address"][0][r])],
            "c_phone": sd["c_phone"][1][int(sd["c_phone"][0][r])],
            "c_comment": sd["c_comment"][1][int(sd["c_comment"][0][r])]})
    return _sorted_limit(out, lambda r: -r["revenue"], 20)


def _q11_np(t, li=None):
    import numpy as np
    sup, nat, ps = t["supplier"], t["nation"], t["partsupp"]
    de = _dict_of(nat, "n_name").code_of("GERMANY")
    nat_de = _lut(_col(nat, "n_nationkey"), _col(nat, "n_name") == de, False)
    supp_de = _lut(_col(sup, "s_suppkey"),
                   nat_de[_col(sup, "s_nationkey")], False)
    m = supp_de[_col(ps, "ps_suppkey")]
    val = (_dec(ps, "ps_supplycost") * _col(ps, "ps_availqty"))[m]
    pk = _col(ps, "ps_partkey")[m]
    uniq, inv = np.unique(pk, return_inverse=True)
    sums = np.bincount(inv, weights=val, minlength=len(uniq))
    thresh = float(val.sum()) * 0.0001
    out = [{"ps_partkey": int(k), "value": float(v)}
           for k, v in zip(uniq, sums) if v > thresh]
    return _sorted_limit(out, lambda r: -r["value"])


def _q13_np(t, li=None):
    import numpy as np
    cus, orde = t["customer"], t["orders"]
    bad = _contains_seq(_dict_of(orde, "o_comment").values,
                        "special", "requests")
    keep = ~bad[_col(orde, "o_comment")]
    ck = _col(cus, "c_custkey")
    counts = np.bincount(_col(orde, "o_custkey")[keep],
                         minlength=int(ck.max()) + 1)
    c_count = counts[ck]
    uniq, cnt = np.unique(c_count, return_counts=True)
    out = [{"c_count": int(k), "custdist": int(v)}
           for k, v in zip(uniq, cnt)]
    return _sorted_limit(out, lambda r: (-r["custdist"], -r["c_count"]))


def _q14_np(t, li=None):
    import numpy as np
    part, l = t["part"], t["lineitem"]
    lo, hi = _d("1995-09-01"), _d("1995-10-01")
    types = _dict_of(part, "p_type").values.astype(str)
    promo = _lut(_col(part, "p_partkey"),
                 np.char.startswith(types, "PROMO")[_col(part, "p_type")],
                 False)
    ship = _col(l, "l_shipdate")
    m = (ship >= lo) & (ship < hi)
    v = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m]
    total = float(v.sum())
    pr = float(v[promo[_col(l, "l_partkey")[m]]].sum())
    return [{"promo_revenue": 100.0 * pr / total if total else None}]


def _q15_np(t, li=None):
    import numpy as np
    sup, l = t["supplier"], t["lineitem"]
    lo, hi = _d("1996-01-01"), _d("1996-04-01")
    ship = _col(l, "l_shipdate")
    m = (ship >= lo) & (ship < hi)
    sk = _col(l, "l_suppkey")[m]
    rev = (_dec(l, "l_extendedprice") * (1 - _dec(l, "l_discount")))[m]
    if sk.size == 0:
        return []
    sums = np.bincount(sk, weights=rev)
    seen = np.bincount(sk, minlength=len(sums)) > 0
    mx = sums[seen].max()
    ssk = _col(sup, "s_suppkey")
    sd = {c: (_col(sup, c), _dict_of(sup, c).values)
          for c in ("s_name", "s_address", "s_phone")}
    out = []
    for r in np.flatnonzero((ssk < len(sums)) & seen[np.minimum(ssk, len(sums) - 1)]):
        k = int(ssk[r])
        if sums[k] == mx:
            out.append({"s_suppkey": k,
                        "s_name": sd["s_name"][1][int(sd["s_name"][0][r])],
                        "s_address": sd["s_address"][1][int(sd["s_address"][0][r])],
                        "s_phone": sd["s_phone"][1][int(sd["s_phone"][0][r])],
                        "total_revenue": float(sums[k])})
    return _sorted_limit(out, lambda r: r["s_suppkey"])


def _q16_np(t, li=None):
    import numpy as np
    sup, part, ps = t["supplier"], t["part"], t["partsupp"]
    bad_c = _contains_seq(_dict_of(sup, "s_comment").values,
                          "Customer", "Complaints")
    bad = _lut(_col(sup, "s_suppkey"), bad_c[_col(sup, "s_comment")], False)
    pk = _col(part, "p_partkey")
    types = _dict_of(part, "p_type").values.astype(str)
    b45 = _dict_of(part, "p_brand").code_of("Brand#45")
    sizes = np.array([49, 14, 23, 45, 19, 3, 36, 9])
    ok = ((_col(part, "p_brand") != b45)
          & ~np.char.startswith(types, "MEDIUM POLISHED")[_col(part, "p_type")]
          & np.isin(_col(part, "p_size"), sizes))
    part_ok = _lut(pk, ok, False)
    part_brand = _lut(pk, _col(part, "p_brand"))
    part_type = _lut(pk, _col(part, "p_type"))
    part_size = _lut(pk, _col(part, "p_size"))

    pspk, pssk = _col(ps, "ps_partkey"), _col(ps, "ps_suppkey")
    m = part_ok[pspk] & ~bad[pssk]
    # distinct suppliers per (brand, type, size): dedupe composite + supplier
    b, ty, sz = part_brand[pspk[m]], part_type[pspk[m]], part_size[pspk[m]]
    gkey = ((b.astype(np.int64) * 1000 + ty) * 100 + sz)
    comp = _unique(gkey * (int(pssk.max()) + 1) + pssk[m])
    gids, cnts = np.unique(comp // (int(pssk.max()) + 1), return_counts=True)
    bvals = _dict_of(part, "p_brand").values
    tvals = _dict_of(part, "p_type").values
    out = [{"p_brand": bvals[int(g) // 100000],
            "p_type": tvals[(int(g) // 100) % 1000],
            "p_size": int(g) % 100, "supplier_cnt": int(n)}
           for g, n in zip(gids, cnts)]
    return _sorted_limit(out, lambda r: (-r["supplier_cnt"], r["p_brand"],
                                         r["p_type"], r["p_size"]))


def _q17_np(t, li=None):
    import numpy as np
    part, l = t["part"], t["lineitem"]
    b23 = _dict_of(part, "p_brand").code_of("Brand#23")
    box = _dict_of(part, "p_container").code_of("MED BOX")
    part_ok = _lut(_col(part, "p_partkey"),
                   (_col(part, "p_brand") == b23)
                   & (_col(part, "p_container") == box), False)
    lpk = _col(l, "l_partkey")
    qty = _dec(l, "l_quantity")
    n = np.bincount(lpk, minlength=int(lpk.max()) + 1)
    s = np.bincount(lpk, weights=qty, minlength=int(lpk.max()) + 1)
    avg = s / np.maximum(n, 1)
    m = part_ok[lpk] & (qty < 0.2 * avg[lpk])
    if not m.any():
        return [{"avg_yearly": None}]
    return [{"avg_yearly": float(_dec(l, "l_extendedprice")[m].sum() / 7.0)}]


def _q18_np(t, li=None):
    import numpy as np
    cus, orde, l = t["customer"], t["orders"], t["lineitem"]
    lok = _col(l, "l_orderkey")
    qty = np.bincount(lok, weights=_dec(l, "l_quantity"),
                      minlength=int(lok.max()) + 1)
    okey = _col(orde, "o_orderkey")
    big = (okey < len(qty)) & (qty[np.minimum(okey, len(qty) - 1)] > 300)
    rows = np.flatnonzero(big)
    cust_row = _lut(_col(cus, "c_custkey"),
                    np.arange(len(_col(cus, "c_custkey"))), -1)
    cname = _col(cus, "c_name")
    cname_vals = _dict_of(cus, "c_name").values
    tp = _dec(orde, "o_totalprice")
    od = _col(orde, "o_orderdate")
    ocust = _col(orde, "o_custkey")
    out = []
    for r in rows:
        ck = int(ocust[r])
        out.append({"c_name": cname_vals[int(cname[int(cust_row[ck])])],
                    "c_custkey": ck, "o_orderkey": int(okey[r]),
                    "o_orderdate": int(od[r]),
                    "o_totalprice": float(tp[r]),
                    "sum_qty": float(qty[int(okey[r])])})
    return _sorted_limit(out, lambda r: (-r["o_totalprice"], r["o_orderdate"]),
                         100)


def _q19_np(t, li=None):
    import numpy as np
    part, l = t["part"], t["lineitem"]
    pk = _col(part, "p_partkey")
    bd = _dict_of(part, "p_brand")
    cd = _dict_of(part, "p_container")
    part_brand = _lut(pk, _col(part, "p_brand"), -1)
    part_cont = _lut(pk, _col(part, "p_container"), -1)
    part_size = _lut(pk, _col(part, "p_size"), -1)
    smd = _dict_of(l, "l_shipmode")
    sid = _dict_of(l, "l_shipinstruct")
    base = (np.isin(_col(l, "l_shipmode"),
                    np.array(sorted({smd.code_of("AIR"),
                                     smd.code_of("AIR REG")})))
            & (_col(l, "l_shipinstruct") == sid.code_of("DELIVER IN PERSON")))
    # the branches test only the rows `base` keeps: the same rows, in row
    # order, as masking every row
    rows = np.flatnonzero(base)
    lpk = _col(l, "l_partkey")[rows]
    qty = _dec(l, "l_quantity", rows)
    sz, brand_of, cont_of = part_size[lpk], part_brand[lpk], part_cont[lpk]
    m = np.zeros(len(lpk), np.bool_)
    for brand, conts, qlo, qhi, smax in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15)):
        ccodes = np.array(sorted(cd.code_of(c) for c in conts))
        m |= ((brand_of == bd.code_of(brand))
              & np.isin(cont_of, ccodes)
              & (qty >= qlo) & (qty <= qhi)
              & (sz >= 1) & (sz <= smax))
    if not m.any():
        return [{"revenue": None}]
    sel = rows[m]
    rev = _dec(l, "l_extendedprice", sel) * (1 - _dec(l, "l_discount", sel))
    return [{"revenue": float(rev.sum())}]


def _q20_np(t, li=None):
    import numpy as np
    part, sup, nat, ps, l = (t["part"], t["supplier"], t["nation"],
                             t["partsupp"], t["lineitem"])
    lo, hi = _d("1994-01-01"), _d("1995-01-01")
    names = _dict_of(part, "p_name").values.astype(str)
    forest = _lut(_col(part, "p_partkey"),
                  np.char.startswith(names, "forest")[_col(part, "p_name")],
                  False)
    ship = _col(l, "l_shipdate")
    m = (ship >= lo) & (ship < hi)
    SK = int(max(_col(l, "l_suppkey").max(), _col(ps, "ps_suppkey").max())) + 1
    lkey = _col(l, "l_partkey")[m].astype(np.int64) * SK \
        + _col(l, "l_suppkey")[m]
    uniq, inv = np.unique(lkey, return_inverse=True)
    shipped = np.bincount(inv, weights=_dec(l, "l_quantity")[m],
                          minlength=len(uniq))
    pskey = _col(ps, "ps_partkey").astype(np.int64) * SK + _col(ps, "ps_suppkey")
    pos = np.searchsorted(uniq, pskey)
    pos_ok = (pos < len(uniq))
    hit = np.zeros(len(pskey), np.bool_)
    hit[pos_ok] = uniq[np.minimum(pos, len(uniq) - 1)][pos_ok] == pskey[pos_ok]
    good = (forest[_col(ps, "ps_partkey")] & hit
            & (_col(ps, "ps_availqty")
               > 0.5 * shipped[np.minimum(pos, len(uniq) - 1)]))
    good_supp = np.zeros(SK, np.bool_)
    good_supp[_col(ps, "ps_suppkey")[good]] = True
    canada = _dict_of(nat, "n_name").code_of("CANADA")
    nat_ca = _lut(_col(nat, "n_nationkey"),
                  _col(nat, "n_name") == canada, False)
    ssk = _col(sup, "s_suppkey")
    sm = good_supp[ssk] & nat_ca[_col(sup, "s_nationkey")]
    sn = _dict_of(sup, "s_name").values
    sa = _dict_of(sup, "s_address").values
    out = [{"s_name": sn[int(_col(sup, "s_name")[r])],
            "s_address": sa[int(_col(sup, "s_address")[r])]}
           for r in np.flatnonzero(sm)]
    return _sorted_limit(out, lambda r: r["s_name"])


def _q22_np(t, li=None):
    import numpy as np
    cus, orde = t["customer"], t["orders"]
    phones = _dict_of(cus, "c_phone").values.astype(str)
    cc = np.array([p[:2] for p in phones], dtype=object)
    codes = {"13", "31", "23", "29", "30", "18", "17"}
    ok_phone = np.array([c in codes for c in cc], np.bool_)
    elig = ok_phone[_col(cus, "c_phone")]
    bal = _dec(cus, "c_acctbal")
    pos = bal[elig & (bal > 0.0)]
    if pos.size == 0:
        return []
    avg = float(pos.mean())
    ck = _col(cus, "c_custkey")
    has_order = np.zeros(int(ck.max()) + 1, np.bool_)
    oc = _col(orde, "o_custkey")
    has_order[oc[oc <= ck.max()]] = True
    m = elig & (bal > avg) & ~has_order[ck]
    code_per_cust = cc[_col(cus, "c_phone")[m]]
    groups = {}
    for c, b in zip(code_per_cust, bal[m]):
        g = groups.setdefault(c, [0, 0.0])
        g[0] += 1
        g[1] += float(b)
    out = [{"cntrycode": k, "numcust": v[0], "totacctbal": v[1]}
           for k, v in groups.items()]
    return _sorted_limit(out, lambda r: r["cntrycode"])


_FAST = {1: _q1_np, 2: _q2_np, 3: _q3_np, 4: _q4_np, 5: _q5_np, 6: _q6_np,
         7: _q7_np, 8: _q8_np, 9: _q9_np, 10: _q10_np, 11: _q11_np,
         12: _q12_np, 13: _q13_np, 14: _q14_np, 15: _q15_np, 16: _q16_np,
         17: _q17_np, 18: _q18_np, 19: _q19_np, 20: _q20_np, 21: _q21_np,
         22: _q22_np}
