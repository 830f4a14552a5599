"""TPC-H data generator (spec-shaped, deterministic).

The reference shells out to `tpchgen-cli` (reference tpc/scripts/generate.sh:
9-12) and loads parquet; the engine carries its own generator: schema, key
relationships, value ranges and the string vocabularies follow the TPC-H
spec so the benchmark queries exercise the same selectivities (validation
is result-equality against the numpy oracle over the SAME generated data,
not against official dbgen bytes).

A copy of the JAX package's numpy generator (`datafusion_parallelism_tpu/
tpch/datagen.py`, its `use_native=False` path), importing the port's
HostTable: the machine with the GPU has no jax. The same seed gives the same
tables column for column.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..utils.columnar import (DECIMAL, DATE32, HostTable, INT32, STRING,
                              Dictionary, Field, Schema, date32_of)

TABLE_NAMES = ["region", "nation", "supplier", "customer", "part", "partsupp",
               "orders", "lineitem"]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, region)
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hotpink", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
    "white", "yellow",
]
COMMENT_WORDS = [
    "furiously", "quickly", "carefully", "blithely", "slyly", "regular",
    "express", "special", "pending", "final", "ironic", "even", "bold",
    "silent", "unusual", "deposits", "requests", "accounts", "packages",
    "instructions", "foxes", "pearls", "ideas", "theodolites", "platelets",
    "Customer", "Complaints", "Recommends", "sleep", "wake", "nag", "haggle",
]

START_DATE = date32_of("1992-01-01")
END_DATE = date32_of("1998-12-01")
CURRENT_DATE = date32_of("1995-06-17")


def _dict_col(rng, choices, n):
    """Uniform draw from a vocabulary. Dictionaries must be SORTED and
    UNIQUE (utils/columnar.py contract: code order == string order); codes
    are uniform so drawing over the sorted list is distribution-identical."""
    vals = sorted(set(choices))
    d = Dictionary(np.array(vals, dtype=object))
    codes = rng.integers(0, len(vals), n).astype(np.int32)
    return d, codes


def _encode_fixed(values_by_code: List[str], codes: np.ndarray):
    """Dictionary-encode values where `codes` index an (unsorted) vocab:
    re-encode against the sorted unique vocabulary."""
    vocab = np.array(values_by_code, dtype=object)
    uniq = np.array(sorted(set(values_by_code)), dtype=object)
    idx = {v: i for i, v in enumerate(uniq)}
    lut = np.array([idx[v] for v in vocab], dtype=np.int32)
    return Dictionary(uniq), lut[codes]


_COMMENT_VOCABS: Dict[Tuple[int, int, int], "Dictionary"] = {}


def _comment_vocab(rng_seed: int, lo: int, hi: int, size: int = 4096):
    """A fixed vocabulary of pseudo-comments (built once, reused): keeps the
    generator fully vectorized — rows just draw codes. Q13-style
    '%special%requests%' predicates get spec-like selectivity from the word
    mix."""
    key = (rng_seed, lo, hi)
    if key not in _COMMENT_VOCABS:
        vr = np.random.default_rng(rng_seed)
        words = vr.integers(0, len(COMMENT_WORDS), (size, hi))
        lens = vr.integers(lo, hi + 1, size)
        vals = sorted({" ".join(COMMENT_WORDS[w] for w in words[i, :lens[i]])
                       for i in range(size)})
        _COMMENT_VOCABS[key] = Dictionary(np.array(vals, dtype=object))
    return _COMMENT_VOCABS[key]


def _comment_codes(rng, n, lo=2, hi=6):
    """(Dictionary, codes): dictionary-encoded comments, no per-row loop."""
    d = _comment_vocab(7, lo, hi)
    return d, rng.integers(0, len(d), n).astype(np.int32)


def _str_table(values):
    """object array -> (Dictionary, codes) with stable codes."""
    uniq, codes = np.unique(values.astype(str), return_inverse=True)
    return Dictionary(uniq.astype(object)), codes.astype(np.int32)


def generate_tables(sf: float = 0.01, seed: int = 19940315) -> Dict[str, HostTable]:
    """All eight TPC-H tables at scale factor `sf` as HostTables."""
    rng = np.random.default_rng(seed)
    t: Dict[str, HostTable] = {}

    # ---- region / nation (fixed) -------------------------------------------
    t["region"] = HostTable.from_numpy(
        {"r_regionkey": np.arange(5, dtype=np.int32),
         "r_name": np.arange(5, dtype=np.int32),
         "r_comment": np.arange(5, dtype=np.int32)},
        dtypes={"r_name": STRING, "r_comment": STRING},
        dictionaries={"r_name": Dictionary(np.array(REGIONS, dtype=object)),
                      "r_comment": Dictionary(np.array(
                          [f"comment {r}" for r in REGIONS], dtype=object))})

    n_names = [n for n, _ in NATIONS]
    nnd, nnc = _encode_fixed(n_names, np.arange(25))
    ncd, ncc = _encode_fixed([f"comment {n}" for n in n_names], np.arange(25))
    t["nation"] = HostTable.from_numpy(
        {"n_nationkey": np.arange(25, dtype=np.int32),
         "n_name": nnc,
         "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int32),
         "n_comment": ncc},
        dtypes={"n_name": STRING, "n_comment": STRING},
        dictionaries={"n_name": nnd, "n_comment": ncd})

    # ---- supplier -----------------------------------------------------------
    n_supp = max(int(sf * 10_000), 10)
    sk = np.arange(1, n_supp + 1, dtype=np.int32)
    base_d, sc0 = _comment_codes(rng, n_supp)
    # spec: 5 suppliers per SF*10000 get "Customer ... Complaints" (Q16)
    svals = base_d.values[sc0].copy()
    bad = rng.choice(n_supp, max(n_supp // 2000, 1), replace=False)
    svals[bad] = "take Customer strange Complaints sleep"
    sd, sc = _str_table(svals)
    s_name_dict = Dictionary(np.array(
        [f"Supplier#{k:09d}" for k in sk], dtype=object))
    t["supplier"] = HostTable.from_numpy(
        {"s_suppkey": sk,
         "s_name": np.arange(n_supp, dtype=np.int32),
         "s_address": np.arange(n_supp, dtype=np.int32),
         "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
         "s_phone": np.arange(n_supp, dtype=np.int32),
         "s_acctbal": rng.integers(-99999, 999999, n_supp),
         "s_comment": sc},
        dtypes={"s_name": STRING, "s_address": STRING, "s_phone": STRING,
                "s_acctbal": DECIMAL(2), "s_comment": STRING},
        dictionaries={"s_name": s_name_dict,
                      "s_address": Dictionary(np.array(
                          [f"addr s{k:09d}" for k in sk], dtype=object)),
                      "s_phone": Dictionary(np.array(
                          [f"{10+int(k)%25}-{k%900+100}-{k%9000+1000}" for k in sk],
                          dtype=object)),
                      "s_comment": sd},
        validity=None)
    # s_acctbal was generated as raw cents already
    t["supplier"].columns["s_acctbal"] = (
        t["supplier"].columns["s_acctbal"][0].astype(np.int64),
        t["supplier"].columns["s_acctbal"][1])

    # ---- customer -----------------------------------------------------------
    n_cust = max(int(sf * 150_000), 30)
    ck = np.arange(1, n_cust + 1, dtype=np.int32)
    c_nat = rng.integers(0, 25, n_cust).astype(np.int32)
    seg_d, seg_c = _dict_col(rng, SEGMENTS, n_cust)
    ccd, ccc = _comment_codes(rng, n_cust)
    # phone country code = 10 + nationkey (Q22 depends on this)
    phones = np.array([f"{10+int(nk)}-{int(k)%900+100}-{int(k)%9000+1000}"
                       for k, nk in zip(ck, c_nat)], dtype=object)
    pd_, pc = _str_table(phones)
    t["customer"] = HostTable.from_numpy(
        {"c_custkey": ck,
         "c_name": np.arange(n_cust, dtype=np.int32),
         "c_address": np.arange(n_cust, dtype=np.int32),
         "c_nationkey": c_nat,
         "c_phone": pc,
         "c_acctbal": rng.integers(-99999, 999999, n_cust).astype(np.int64),
         "c_mktsegment": seg_c,
         "c_comment": ccc},
        dtypes={"c_name": STRING, "c_address": STRING, "c_phone": STRING,
                "c_acctbal": DECIMAL(2), "c_mktsegment": STRING,
                "c_comment": STRING},
        dictionaries={"c_name": Dictionary(np.array(
            [f"Customer#{k:09d}" for k in ck], dtype=object)),
            "c_address": Dictionary(np.array(
                [f"addr c{k:09d}" for k in ck], dtype=object)),
            "c_phone": pd_, "c_mktsegment": seg_d, "c_comment": ccd})

    # ---- part ---------------------------------------------------------------
    n_part = max(int(sf * 200_000), 40)
    pk = np.arange(1, n_part + 1, dtype=np.int32)
    w = rng.integers(0, len(P_NAME_WORDS), (n_part, 5))
    p_names = np.array([" ".join(P_NAME_WORDS[j] for j in w[i]) for i in range(n_part)],
                       dtype=object)
    pnd, pnc = _str_table(p_names)
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    types = np.array([f"{TYPE_S1[a]} {TYPE_S2[b]} {TYPE_S3[c]}"
                      for a, b, c in zip(rng.integers(0, 6, n_part),
                                         rng.integers(0, 5, n_part),
                                         rng.integers(0, 5, n_part))], dtype=object)
    ptd, ptc = _str_table(types)
    containers = np.array([f"{CONTAINER_S1[a]} {CONTAINER_S2[b]}"
                           for a, b in zip(rng.integers(0, 5, n_part),
                                           rng.integers(0, 8, n_part))], dtype=object)
    pcd, pcc = _str_table(containers)
    pbd, pbc = _str_table(np.array([f"Brand#{b}" for b in brand], dtype=object))
    t["part"] = HostTable.from_numpy(
        {"p_partkey": pk,
         "p_name": pnc,
         "p_mfgr": rng.integers(0, 5, n_part).astype(np.int32),
         "p_brand": pbc,
         "p_type": ptc,
         "p_size": rng.integers(1, 51, n_part).astype(np.int32),
         "p_container": pcc,
         "p_retailprice": (90000 + (pk.astype(np.int64) % 20001) * 10 +
                           (pk.astype(np.int64) % 1000) * 100),
         "p_comment": np.zeros(n_part, dtype=np.int32)},
        dtypes={"p_name": STRING, "p_mfgr": STRING, "p_brand": STRING,
                "p_type": STRING, "p_container": STRING,
                "p_retailprice": DECIMAL(2), "p_comment": STRING},
        dictionaries={"p_name": pnd,
                      "p_mfgr": Dictionary(np.array(
                          [f"Manufacturer#{i}" for i in range(1, 6)], dtype=object)),
                      "p_brand": pbd,
                      "p_type": ptd, "p_container": pcd,
                      "p_comment": Dictionary(np.array(["c"], dtype=object))})

    # ---- partsupp -----------------------------------------------------------
    n_ps = 4 * n_part
    ps_pk = np.repeat(pk, 4)
    ps_sk = ((ps_pk.astype(np.int64) +
              np.tile(np.arange(4), n_part) * (n_supp // 4 + 1)) % n_supp + 1
             ).astype(np.int32)
    psd, psc = _comment_codes(rng, n_ps)
    t["partsupp"] = HostTable.from_numpy(
        {"ps_partkey": ps_pk,
         "ps_suppkey": ps_sk,
         "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int32),
         "ps_supplycost": rng.integers(100, 100001, n_ps).astype(np.int64),
         "ps_comment": psc},
        dtypes={"ps_supplycost": DECIMAL(2), "ps_comment": STRING},
        dictionaries={"ps_comment": psd})

    # ---- orders + lineitem --------------------------------------------------
    n_ord = max(int(sf * 1_500_000), 150)
    ok = np.arange(1, n_ord + 1, dtype=np.int32)
    o_cust = (rng.integers(0, n_cust // 3 * 2, n_ord) * 3 % n_cust + 1
              ).astype(np.int32)  # spec: only 2/3 of customers have orders
    o_date = rng.integers(START_DATE, END_DATE - 151, n_ord).astype(np.int32)
    pr_d, pr_c = _dict_col(rng, PRIORITIES, n_ord)
    ocd, occ = _comment_codes(rng, n_ord)
    n_line_per = rng.integers(1, 8, n_ord)
    n_li = int(n_line_per.sum())
    li_order = np.repeat(ok, n_line_per)
    li_odate = np.repeat(o_date, n_line_per)
    li_linenumber = (np.arange(n_li) -
                     np.repeat(np.cumsum(n_line_per) - n_line_per, n_line_per)
                     + 1).astype(np.int32)
    l_pk = rng.integers(1, n_part + 1, n_li).astype(np.int32)
    supp_off = rng.integers(0, 4, n_li)
    l_sk = ((l_pk.astype(np.int64) + supp_off * (n_supp // 4 + 1)) % n_supp + 1
            ).astype(np.int32)
    l_qty = rng.integers(1, 51, n_li).astype(np.int64) * 100
    p_retail = np.asarray(t["part"].columns["p_retailprice"][0])
    l_eprice = (l_qty // 100) * p_retail[l_pk - 1]
    l_disc = rng.integers(0, 11, n_li).astype(np.int64)       # 0.00-0.10
    l_tax = rng.integers(0, 9, n_li).astype(np.int64)         # 0.00-0.08
    l_ship = li_odate + rng.integers(1, 122, n_li).astype(np.int32)
    l_commit = li_odate + rng.integers(30, 91, n_li).astype(np.int32)
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype(np.int32)
    # sorted dictionary ["A","N","R"]: returnable lines draw R(2)/A(0), open N(1)
    returnable = l_receipt <= CURRENT_DATE
    rf = np.where(returnable, rng.integers(0, 2, n_li) * 2, 1).astype(np.int32)
    ls = (l_ship > CURRENT_DATE).astype(np.int32)             # O if open else F
    sm_d, sm_c = _dict_col(rng, SHIPMODES, n_li)
    in_d, in_c = _dict_col(rng, INSTRUCTIONS, n_li)
    lcd, lcc = _comment_codes(rng, n_li, lo=1, hi=3)

    # order status/totalprice derived from lineitems
    li_total = l_eprice * (100 - l_disc) * (100 + l_tax) // 10000
    o_total = np.zeros(n_ord + 1, dtype=np.int64)
    np.add.at(o_total, li_order, li_total)
    o_total = o_total[1:]
    open_cnt = np.zeros(n_ord + 1, dtype=np.int64)
    np.add.at(open_cnt, li_order, ls)
    open_cnt = open_cnt[1:]
    # sorted dictionary ["F","O","P"]: O=1, F=0, P=2
    o_status = np.where(open_cnt == n_line_per, 1,
                        np.where(open_cnt == 0, 0, 2)).astype(np.int32)

    t["orders"] = HostTable.from_numpy(
        {"o_orderkey": ok,
         "o_custkey": o_cust,
         "o_orderstatus": o_status,
         "o_totalprice": o_total,
         "o_orderdate": o_date,
         "o_orderpriority": pr_c,
         "o_clerk": (rng.integers(1, max(int(sf * 1000), 2), n_ord)
                     ).astype(np.int32),
         "o_shippriority": np.zeros(n_ord, dtype=np.int32),
         "o_comment": occ},
        dtypes={"o_orderstatus": STRING, "o_totalprice": DECIMAL(2),
                "o_orderdate": DATE32, "o_orderpriority": STRING,
                "o_clerk": INT32, "o_comment": STRING},
        dictionaries={"o_orderstatus": Dictionary(np.array(["F", "O", "P"],
                                                           dtype=object)),
                      "o_orderpriority": pr_d, "o_comment": ocd})

    t["lineitem"] = HostTable.from_numpy(
        {"l_orderkey": li_order,
         "l_partkey": l_pk,
         "l_suppkey": l_sk,
         "l_linenumber": li_linenumber,
         "l_quantity": l_qty,
         "l_extendedprice": l_eprice,
         "l_discount": l_disc,
         "l_tax": l_tax,
         "l_returnflag": rf,
         "l_linestatus": ls,
         "l_shipdate": l_ship,
         "l_commitdate": l_commit,
         "l_receiptdate": l_receipt,
         "l_shipinstruct": in_c,
         "l_shipmode": sm_c,
         "l_comment": lcc},
        dtypes={"l_quantity": DECIMAL(2), "l_extendedprice": DECIMAL(2),
                "l_discount": DECIMAL(2), "l_tax": DECIMAL(2),
                "l_returnflag": STRING, "l_linestatus": STRING,
                "l_shipdate": DATE32, "l_commitdate": DATE32,
                "l_receiptdate": DATE32, "l_shipinstruct": STRING,
                "l_shipmode": STRING, "l_comment": STRING},
        dictionaries={"l_returnflag": Dictionary(np.array(["A", "N", "R"],
                                                          dtype=object)),
                      "l_linestatus": Dictionary(np.array(["F", "O"],
                                                          dtype=object)),
                      "l_shipinstruct": in_d, "l_shipmode": sm_d,
                      "l_comment": lcd})
    return t
