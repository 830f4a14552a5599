// Native TPC-H dataset generator -> binary columnar directory.
//
// The reference shells out to tpchgen-cli (reference tpc/scripts/generate.sh:
// 9-12); this container has no egress and the numpy generator
// (tpch/datagen.py) is memory-bandwidth- and Python-loop-bound (~40 min for
// SF10 on this host), which makes SF100-class datasets impractical. This is
// the same data distribution generated in one streaming C++ pass per table
// and written as the engine's binary columnar format:
//
//   <out>/<table>/meta.json            {"num_rows": N, "columns": [...]}
//   <out>/<table>/<col>.bin            raw little-endian values (i32 / i64)
//   <out>/<table>/<col>.dict           sorted unique strings, '\n'-separated
//
// String columns are dictionary codes (i32) against the SORTED dict — the
// engine's invariant (code order == string order). All columns are non-null.
// Distributions mirror tpch/datagen.py (the definition of the data shape);
// RNG streams differ, so datasets are statistically equivalent, not
// byte-identical — correctness checks re-derive expectations from the data.
//
// Entry: dfp_generate(sf, seed, outdir) via ctypes (tpch/generate.py).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <sys/stat.h>
#include <vector>

namespace {

// ---- RNG: splitmix64 -------------------------------------------------------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // uniform in [lo, hi)  (modulo bias irrelevant at benchmark scale)
  int64_t uniform(int64_t lo, int64_t hi) {
    return lo + (int64_t)(next() % (uint64_t)(hi - lo));
  }
};

// ---- vocabularies (mirrors tpch/datagen.py) --------------------------------
const char* REGIONS[] = {"AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"};
struct NationDef { const char* name; int region; };
const NationDef NATIONS[] = {
    {"ALGERIA", 0}, {"ARGENTINA", 1}, {"BRAZIL", 1}, {"CANADA", 1},
    {"EGYPT", 4}, {"ETHIOPIA", 0}, {"FRANCE", 3}, {"GERMANY", 3},
    {"INDIA", 2}, {"INDONESIA", 2}, {"IRAN", 4}, {"IRAQ", 4},
    {"JAPAN", 2}, {"JORDAN", 4}, {"KENYA", 0}, {"MOROCCO", 0},
    {"MOZAMBIQUE", 0}, {"PERU", 1}, {"CHINA", 2}, {"ROMANIA", 3},
    {"SAUDI ARABIA", 4}, {"VIETNAM", 2}, {"RUSSIA", 3},
    {"UNITED KINGDOM", 3}, {"UNITED STATES", 1}};
const char* SEGMENTS[] = {"AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                          "HOUSEHOLD"};
const char* PRIORITIES[] = {"1-URGENT", "2-HIGH", "3-MEDIUM",
                            "4-NOT SPECIFIED", "5-LOW"};
const char* SHIPMODES[] = {"REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                           "FOB"};
const char* INSTRUCTIONS[] = {"DELIVER IN PERSON", "COLLECT COD", "NONE",
                              "TAKE BACK RETURN"};
const char* TYPE_S1[] = {"STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                         "PROMO"};
const char* TYPE_S2[] = {"ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                         "BRUSHED"};
const char* TYPE_S3[] = {"TIN", "NICKEL", "BRASS", "STEEL", "COPPER"};
const char* CONTAINER_S1[] = {"SM", "LG", "MED", "JUMBO", "WRAP"};
const char* CONTAINER_S2[] = {"CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                              "CAN", "DRUM"};
const char* P_NAME_WORDS[] = {
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
    "grey", "honeydew", "hot", "hotpink", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow"};
const char* COMMENT_WORDS[] = {
    "furiously", "quickly", "carefully", "blithely", "slyly", "regular",
    "express", "special", "pending", "final", "ironic", "even", "bold",
    "silent", "unusual", "deposits", "requests", "accounts", "packages",
    "instructions", "foxes", "pearls", "ideas", "theodolites", "platelets",
    "Customer", "Complaints", "Recommends", "sleep", "wake", "nag", "haggle"};

const int32_t START_DATE = 8036;    // 1992-01-01 (days since 1970-01-01)
const int32_t END_DATE = 10561;     // 1998-12-01
const int32_t CURRENT_DATE = 9298;  // 1995-06-17

// ---- output plumbing -------------------------------------------------------
struct Meta {
  std::string dir;
  int64_t num_rows = 0;
  std::string cols;      // accumulated JSON entries
  std::string distinct;  // exact distinct-count hints (planner statistics)
  void add(const std::string& name, const char* kind, bool dict) {
    if (!cols.empty()) cols += ",\n  ";
    cols += "{\"name\": \"" + name + "\", \"kind\": \"" + kind + "\"";
    if (dict) cols += ", \"dict\": \"" + name + ".dict\"";
    cols += ", \"file\": \"" + name + ".bin\"}";
  }
  // `key` is a column name or "a,b" composite
  void hint(const std::string& key, int64_t n) {
    if (!distinct.empty()) distinct += ", ";
    distinct += "\"" + key + "\": " + std::to_string(n);
  }
  void finish() const {
    std::string p = dir + "/meta.json";
    FILE* f = fopen(p.c_str(), "w");
    fprintf(f, "{\"num_rows\": %lld,\n \"distinct\": {%s},\n"
            " \"columns\": [\n  %s\n]}\n",
            (long long)num_rows, distinct.c_str(), cols.c_str());
    fclose(f);
  }
};

FILE* open_col(const Meta& m, const std::string& name) {
  std::string p = m.dir + "/" + name + ".bin";
  return fopen(p.c_str(), "wb");
}

void write_i32(Meta& m, const std::string& name, const std::vector<int32_t>& v,
               const char* kind = "i32", bool dict = false) {
  FILE* f = open_col(m, name);
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
  m.add(name, kind, dict);
}

void write_i64(Meta& m, const std::string& name, const std::vector<int64_t>& v,
               const char* kind = "i64") {
  FILE* f = open_col(m, name);
  fwrite(v.data(), 8, v.size(), f);
  fclose(f);
  m.add(name, kind, false);
}

void write_dict(const Meta& m, const std::string& name,
                const std::vector<std::string>& sorted_vals) {
  std::string p = m.dir + "/" + name + ".dict";
  FILE* f = fopen(p.c_str(), "wb");
  for (size_t i = 0; i < sorted_vals.size(); i++) {
    fwrite(sorted_vals[i].data(), 1, sorted_vals[i].size(), f);
    fputc('\n', f);
  }
  fclose(f);
}

// dictionary-encode arbitrary strings: sort unique, remap codes
void write_str_col(Meta& m, const std::string& name,
                   std::vector<std::string>& vals) {
  std::vector<int32_t> order(vals.size());
  std::vector<std::string> sorted = vals;
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());
  std::vector<int32_t> codes(vals.size());
  for (size_t i = 0; i < vals.size(); i++) {
    codes[i] = (int32_t)(std::lower_bound(sorted.begin(), sorted.end(),
                                          vals[i]) - sorted.begin());
  }
  write_dict(m, name, sorted);
  write_i32(m, name, codes, "str", true);
}

std::vector<std::string> sorted_vocab(const char* const* words, int n) {
  std::vector<std::string> v(words, words + n);
  std::sort(v.begin(), v.end());
  return v;
}

// pseudo-comment vocabulary: `size` strings of lo..hi words (mirrors
// datagen.py::_comment_vocab — planted rows handled by the caller)
std::vector<std::string> comment_vocab(uint64_t seed, int lo, int hi,
                                       int size = 4096) {
  Rng r(seed);
  std::vector<std::string> out;
  out.reserve(size);
  for (int i = 0; i < size; i++) {
    int len = (int)r.uniform(lo, hi + 1);
    std::string s;
    for (int j = 0; j < len; j++) {
      if (j) s += ' ';
      s += COMMENT_WORDS[r.uniform(0, 32)];
    }
    out.push_back(s);
  }
  std::sort(out.begin(), out.end());
  out.erase(std::unique(out.begin(), out.end()), out.end());
  return out;
}

std::string fmt(const char* pat, long long v) {
  char buf[64];
  snprintf(buf, sizeof buf, pat, v);
  return buf;
}

int64_t retail_price(int64_t pk) {
  return 90000 + (pk % 20001) * 10 + (pk % 1000) * 100;
}

bool make_table_dir(const std::string& base, const char* table,
                    Meta& m) {
  m.dir = base + "/" + table;
  return mkdir(m.dir.c_str(), 0755) == 0 || errno == EEXIST;
}

}  // namespace

extern "C" int64_t dfp_generate(double sf, uint64_t seed, const char* outdir) {
  std::string base(outdir);
  mkdir(base.c_str(), 0755);
  Rng rng(seed);

  // ---- region --------------------------------------------------------------
  {
    Meta m;
    if (!make_table_dir(base, "region", m)) return -1;
    m.num_rows = 5;
    std::vector<int32_t> keys = {0, 1, 2, 3, 4};
    write_i32(m, "r_regionkey", keys);
    std::vector<std::string> names(REGIONS, REGIONS + 5);  // already sorted
    write_dict(m, "r_name", names);
    write_i32(m, "r_name", keys, "str", true);
    std::vector<std::string> comments;
    for (auto& r : names) comments.push_back("comment " + r);
    write_dict(m, "r_comment", comments);
    write_i32(m, "r_comment", keys, "str", true);
    m.finish();
  }

  // ---- nation --------------------------------------------------------------
  {
    Meta m;
    if (!make_table_dir(base, "nation", m)) return -1;
    m.num_rows = 25;
    std::vector<int32_t> keys(25), regions(25);
    std::vector<std::string> names(25), comments(25);
    for (int i = 0; i < 25; i++) {
      keys[i] = i;
      regions[i] = NATIONS[i].region;
      names[i] = NATIONS[i].name;
      comments[i] = std::string("comment ") + NATIONS[i].name;
    }
    write_i32(m, "n_nationkey", keys);
    write_str_col(m, "n_name", names);
    write_i32(m, "n_regionkey", regions);
    write_str_col(m, "n_comment", comments);
    m.finish();
  }

  const int64_t n_supp = std::max((int64_t)(sf * 10000), (int64_t)10);
  const int64_t n_cust = std::max((int64_t)(sf * 150000), (int64_t)30);
  const int64_t n_part = std::max((int64_t)(sf * 200000), (int64_t)40);
  const int64_t n_ord = std::max((int64_t)(sf * 1500000), (int64_t)150);

  // ---- supplier ------------------------------------------------------------
  {
    Meta m;
    if (!make_table_dir(base, "supplier", m)) return -1;
    m.num_rows = n_supp;
    std::vector<int32_t> sk(n_supp), nat(n_supp), codes(n_supp);
    std::vector<int64_t> bal(n_supp);
    std::vector<std::string> names(n_supp), addrs(n_supp), phones(n_supp);
    for (int64_t k = 0; k < n_supp; k++) {
      sk[k] = (int32_t)(k + 1);
      nat[k] = (int32_t)rng.uniform(0, 25);
      bal[k] = rng.uniform(-99999, 999999);
      names[k] = fmt("Supplier#%09lld", k + 1);
      addrs[k] = fmt("addr s%09lld", k + 1);
      char buf[32];
      snprintf(buf, sizeof buf, "%lld-%lld-%lld",
               (long long)(10 + (k + 1) % 25), (long long)((k + 1) % 900 + 100),
               (long long)((k + 1) % 9000 + 1000));
      phones[k] = buf;
    }
    write_i32(m, "s_suppkey", sk);
    write_dict(m, "s_name", names);  // zero-padded: sorted == key order
    std::vector<int32_t> arange(n_supp);
    for (int64_t k = 0; k < n_supp; k++) arange[k] = (int32_t)k;
    write_i32(m, "s_name", arange, "str", true);
    write_dict(m, "s_address", addrs);
    write_i32(m, "s_address", arange, "str", true);
    write_i32(m, "s_nationkey", nat);
    write_str_col(m, "s_phone", phones);
    write_i64(m, "s_acctbal", bal, "dec2");
    // comment vocab + planted Customer..Complaints rows (Q16 selectivity)
    std::vector<std::string> vocab = comment_vocab(7, 2, 6);
    const std::string planted = "take Customer strange Complaints sleep";
    bool present = std::binary_search(vocab.begin(), vocab.end(), planted);
    std::vector<std::string> full = vocab;
    if (!present) {
      full.insert(std::lower_bound(full.begin(), full.end(), planted),
                  planted);
    }
    int32_t planted_code = (int32_t)(std::lower_bound(full.begin(), full.end(),
                                                      planted) - full.begin());
    int64_t n_bad = std::max(n_supp / 2000, (int64_t)1);
    for (int64_t k = 0; k < n_supp; k++)
      codes[k] = (int32_t)rng.uniform(0, (int64_t)vocab.size());
    // remap: codes referenced `vocab`; shift those >= planted position
    if (!present)
      for (int64_t k = 0; k < n_supp; k++)
        if (codes[k] >= planted_code) codes[k]++;
    for (int64_t b = 0; b < n_bad; b++)
      codes[rng.uniform(0, n_supp)] = planted_code;
    write_dict(m, "s_comment", full);
    m.hint("s_suppkey", n_supp);
    m.hint("s_nationkey", std::min<int64_t>(25, n_supp));
    write_i32(m, "s_comment", codes, "str", true);
    m.finish();
  }

  // ---- customer ------------------------------------------------------------
  {
    Meta m;
    if (!make_table_dir(base, "customer", m)) return -1;
    m.num_rows = n_cust;
    std::vector<int32_t> ck(n_cust), nat(n_cust), seg(n_cust), com(n_cust),
        arange(n_cust);
    std::vector<int64_t> bal(n_cust);
    std::vector<std::string> names(n_cust), addrs(n_cust), phones(n_cust);
    std::vector<std::string> vocab = comment_vocab(7, 2, 6);
    for (int64_t k = 0; k < n_cust; k++) {
      ck[k] = (int32_t)(k + 1);
      arange[k] = (int32_t)k;
      nat[k] = (int32_t)rng.uniform(0, 25);
      seg[k] = (int32_t)rng.uniform(0, 5);
      com[k] = (int32_t)rng.uniform(0, (int64_t)vocab.size());
      bal[k] = rng.uniform(-99999, 999999);
      names[k] = fmt("Customer#%09lld", k + 1);
      addrs[k] = fmt("addr c%09lld", k + 1);
      char buf[32];  // phone country code = 10 + nationkey (Q22)
      snprintf(buf, sizeof buf, "%d-%lld-%lld", 10 + nat[k],
               (long long)((k + 1) % 900 + 100),
               (long long)((k + 1) % 9000 + 1000));
      phones[k] = buf;
    }
    write_i32(m, "c_custkey", ck);
    write_dict(m, "c_name", names);
    write_i32(m, "c_name", arange, "str", true);
    write_dict(m, "c_address", addrs);
    write_i32(m, "c_address", arange, "str", true);
    write_i32(m, "c_nationkey", nat);
    write_str_col(m, "c_phone", phones);
    write_i64(m, "c_acctbal", bal, "dec2");
    write_dict(m, "c_mktsegment", sorted_vocab(SEGMENTS, 5));
    write_i32(m, "c_mktsegment", seg, "str", true);
    write_dict(m, "c_comment", vocab);
    m.hint("c_custkey", n_cust);
    m.hint("c_nationkey", std::min<int64_t>(25, n_cust));
    write_i32(m, "c_comment", com, "str", true);
    m.finish();
  }

  // ---- part ----------------------------------------------------------------
  {
    Meta m;
    if (!make_table_dir(base, "part", m)) return -1;
    m.num_rows = n_part;
    std::vector<int32_t> pk(n_part), mfgr(n_part), brand(n_part),
        ptype(n_part), psize(n_part), pcont(n_part), pcom(n_part, 0);
    std::vector<int64_t> retail(n_part);
    std::vector<std::string> pnames(n_part);
    // precompute sorted combo vocabularies + index maps
    std::vector<std::string> types, conts;
    for (int a = 0; a < 6; a++)
      for (int b = 0; b < 5; b++)
        for (int c = 0; c < 5; c++)
          types.push_back(std::string(TYPE_S1[a]) + " " + TYPE_S2[b] + " " +
                          TYPE_S3[c]);
    std::sort(types.begin(), types.end());
    for (int a = 0; a < 5; a++)
      for (int b = 0; b < 8; b++)
        conts.push_back(std::string(CONTAINER_S1[a]) + " " + CONTAINER_S2[b]);
    std::sort(conts.begin(), conts.end());
    std::vector<std::string> brands;
    for (int mf = 1; mf <= 5; mf++)
      for (int b = 1; b <= 5; b++)
        brands.push_back(fmt("Brand#%lld", mf * 10 + b));
    std::sort(brands.begin(), brands.end());
    for (int64_t k = 0; k < n_part; k++) {
      pk[k] = (int32_t)(k + 1);
      mfgr[k] = (int32_t)rng.uniform(0, 5);
      std::string bs = fmt("Brand#%lld",
                           rng.uniform(1, 6) * 10 + rng.uniform(1, 6));
      brand[k] = (int32_t)(std::lower_bound(brands.begin(), brands.end(), bs) -
                           brands.begin());
      std::string ts = std::string(TYPE_S1[rng.uniform(0, 6)]) + " " +
                       TYPE_S2[rng.uniform(0, 5)] + " " +
                       TYPE_S3[rng.uniform(0, 5)];
      ptype[k] = (int32_t)(std::lower_bound(types.begin(), types.end(), ts) -
                           types.begin());
      std::string cs = std::string(CONTAINER_S1[rng.uniform(0, 5)]) + " " +
                       CONTAINER_S2[rng.uniform(0, 8)];
      pcont[k] = (int32_t)(std::lower_bound(conts.begin(), conts.end(), cs) -
                           conts.begin());
      psize[k] = (int32_t)rng.uniform(1, 51);
      retail[k] = retail_price(k + 1);
      std::string nm;
      for (int j = 0; j < 5; j++) {
        if (j) nm += ' ';
        nm += P_NAME_WORDS[rng.uniform(0, 90)];
      }
      pnames[k] = nm;
    }
    write_i32(m, "p_partkey", pk);
    write_str_col(m, "p_name", pnames);
    std::vector<std::string> mfgrs;
    for (int i = 1; i <= 5; i++) mfgrs.push_back(fmt("Manufacturer#%lld", i));
    write_dict(m, "p_mfgr", mfgrs);
    write_i32(m, "p_mfgr", mfgr, "str", true);
    write_dict(m, "p_brand", brands);
    write_i32(m, "p_brand", brand, "str", true);
    write_dict(m, "p_type", types);
    write_i32(m, "p_type", ptype, "str", true);
    write_i32(m, "p_size", psize);
    write_dict(m, "p_container", conts);
    write_i32(m, "p_container", pcont, "str", true);
    write_i64(m, "p_retailprice", retail, "dec2");
    write_dict(m, "p_comment", {"c"});
    m.hint("p_partkey", n_part);
    write_i32(m, "p_comment", pcom, "str", true);
    m.finish();
  }

  // ---- partsupp ------------------------------------------------------------
  {
    Meta m;
    if (!make_table_dir(base, "partsupp", m)) return -1;
    int64_t n_ps = 4 * n_part;
    m.num_rows = n_ps;
    std::vector<int32_t> ppk(n_ps), psk(n_ps), avail(n_ps), com(n_ps);
    std::vector<int64_t> cost(n_ps);
    std::vector<std::string> vocab = comment_vocab(7, 2, 6);
    for (int64_t k = 0; k < n_part; k++) {
      for (int64_t j = 0; j < 4; j++) {
        int64_t i = k * 4 + j;
        ppk[i] = (int32_t)(k + 1);
        psk[i] = (int32_t)(((k + 1) + j * (n_supp / 4 + 1)) % n_supp + 1);
        avail[i] = (int32_t)rng.uniform(1, 10000);
        cost[i] = rng.uniform(100, 100001);
        com[i] = (int32_t)rng.uniform(0, (int64_t)vocab.size());
      }
    }
    write_i32(m, "ps_partkey", ppk);
    write_i32(m, "ps_suppkey", psk);
    write_i32(m, "ps_availqty", avail);
    write_i64(m, "ps_supplycost", cost, "dec2");
    write_dict(m, "ps_comment", vocab);
    m.hint("ps_partkey", n_part);
    m.hint("ps_suppkey", n_supp);
    m.hint("ps_partkey,ps_suppkey", n_ps);
    write_i32(m, "ps_comment", com, "str", true);
    m.finish();
  }

  // ---- orders + lineitem (streamed; lineitem first for order aggregates) ---
  {
    Meta ml, mo;
    if (!make_table_dir(base, "lineitem", ml)) return -1;
    if (!make_table_dir(base, "orders", mo)) return -1;

    std::vector<uint8_t> n_line(n_ord);
    std::vector<int32_t> o_date(n_ord);
    std::vector<int64_t> o_total(n_ord, 0);
    std::vector<int32_t> open_cnt(n_ord, 0);
    for (int64_t o = 0; o < n_ord; o++) {
      n_line[o] = (uint8_t)rng.uniform(1, 8);
      o_date[o] = (int32_t)rng.uniform(START_DATE, END_DATE - 151);
    }

    const char* li_cols_i32[] = {"l_orderkey", "l_partkey", "l_suppkey",
                                 "l_linenumber", "l_returnflag",
                                 "l_linestatus", "l_shipdate", "l_commitdate",
                                 "l_receiptdate", "l_shipinstruct",
                                 "l_shipmode", "l_comment"};
    const char* li_cols_i64[] = {"l_quantity", "l_extendedprice", "l_discount",
                                 "l_tax"};
    FILE* f32[12];
    FILE* f64[4];
    for (int i = 0; i < 12; i++) f32[i] = open_col(ml, li_cols_i32[i]);
    for (int i = 0; i < 4; i++) f64[i] = open_col(ml, li_cols_i64[i]);
    std::vector<std::string> li_vocab = comment_vocab(7, 1, 3);

    const int64_t BLOCK = 1 << 20;
    std::vector<int32_t> b32[12];
    std::vector<int64_t> b64[4];
    for (auto& b : b32) b.reserve(BLOCK + 8);
    for (auto& b : b64) b.reserve(BLOCK + 8);
    int64_t n_li = 0;
    auto flush = [&]() {
      for (int i = 0; i < 12; i++) {
        fwrite(b32[i].data(), 4, b32[i].size(), f32[i]);
        b32[i].clear();
      }
      for (int i = 0; i < 4; i++) {
        fwrite(b64[i].data(), 8, b64[i].size(), f64[i]);
        b64[i].clear();
      }
    };
    for (int64_t o = 0; o < n_ord; o++) {
      for (int ln = 0; ln < n_line[o]; ln++) {
        int64_t pk = rng.uniform(1, n_part + 1);
        int64_t sk = ((pk + rng.uniform(0, 4) * (n_supp / 4 + 1)) % n_supp) + 1;
        int64_t qty = rng.uniform(1, 51) * 100;
        int64_t eprice = (qty / 100) * retail_price(pk);
        int64_t disc = rng.uniform(0, 11);
        int64_t tax = rng.uniform(0, 9);
        int32_t ship = o_date[o] + (int32_t)rng.uniform(1, 122);
        int32_t commit = o_date[o] + (int32_t)rng.uniform(30, 91);
        int32_t receipt = ship + (int32_t)rng.uniform(1, 31);
        // sorted dict ["A","N","R"]: returned lines draw A(0)/R(2), open N(1)
        int32_t rf = receipt <= CURRENT_DATE ? (int32_t)rng.uniform(0, 2) * 2
                                             : 1;
        int32_t lstat = ship > CURRENT_DATE ? 1 : 0;  // ["F","O"]
        b32[0].push_back((int32_t)(o + 1));
        b32[1].push_back((int32_t)pk);
        b32[2].push_back((int32_t)sk);
        b32[3].push_back(ln + 1);
        b32[4].push_back(rf);
        b32[5].push_back(lstat);
        b32[6].push_back(ship);
        b32[7].push_back(commit);
        b32[8].push_back(receipt);
        b32[9].push_back((int32_t)rng.uniform(0, 4));
        b32[10].push_back((int32_t)rng.uniform(0, 7));
        b32[11].push_back((int32_t)rng.uniform(0, (int64_t)li_vocab.size()));
        b64[0].push_back(qty);
        b64[1].push_back(eprice);
        b64[2].push_back(disc);
        b64[3].push_back(tax);
        o_total[o] += eprice * (100 - disc) * (100 + tax) / 10000;
        open_cnt[o] += lstat;
        n_li++;
      }
      if ((int64_t)b32[0].size() >= BLOCK) flush();
    }
    flush();
    for (int i = 0; i < 12; i++) fclose(f32[i]);
    for (int i = 0; i < 4; i++) fclose(f64[i]);

    ml.num_rows = n_li;
    // meta order == datagen.py column order (SELECT * parity)
    ml.add("l_orderkey", "i32", false);
    ml.add("l_partkey", "i32", false);
    ml.add("l_suppkey", "i32", false);
    ml.add("l_linenumber", "i32", false);
    ml.add("l_quantity", "dec2", false);
    ml.add("l_extendedprice", "dec2", false);
    ml.add("l_discount", "dec2", false);
    ml.add("l_tax", "dec2", false);
    ml.add("l_returnflag", "str", true);
    ml.add("l_linestatus", "str", true);
    ml.add("l_shipdate", "date", false);
    ml.add("l_commitdate", "date", false);
    ml.add("l_receiptdate", "date", false);
    ml.add("l_shipinstruct", "str", true);
    ml.add("l_shipmode", "str", true);
    ml.add("l_comment", "str", true);
    ml.hint("l_orderkey", n_ord);
    ml.hint("l_partkey", std::min(n_part, n_li));
    ml.hint("l_suppkey", std::min(n_supp, n_li));
    ml.hint("l_partkey,l_suppkey", std::min(4 * n_part, n_li));
    write_dict(ml, "l_returnflag", {"A", "N", "R"});
    write_dict(ml, "l_linestatus", {"F", "O"});
    write_dict(ml, "l_shipinstruct", sorted_vocab(INSTRUCTIONS, 4));
    write_dict(ml, "l_shipmode", sorted_vocab(SHIPMODES, 7));
    write_dict(ml, "l_comment", li_vocab);
    ml.finish();

    // orders
    mo.num_rows = n_ord;
    std::vector<int32_t> ok(n_ord), ocust(n_ord), ostat(n_ord), oprio(n_ord),
        oclerk(n_ord), oship(n_ord, 0), ocom(n_ord);
    std::vector<std::string> vocab = comment_vocab(7, 2, 6);
    int64_t clerk_hi = std::max((int64_t)(sf * 1000), (int64_t)2);
    for (int64_t o = 0; o < n_ord; o++) {
      ok[o] = (int32_t)(o + 1);
      // spec: only 2/3 of customers have orders
      ocust[o] = (int32_t)(rng.uniform(0, n_cust / 3 * 2) * 3 % n_cust + 1);
      // sorted dict ["F","O","P"]
      ostat[o] = open_cnt[o] == n_line[o] ? 1 : (open_cnt[o] == 0 ? 0 : 2);
      oprio[o] = (int32_t)rng.uniform(0, 5);
      oclerk[o] = (int32_t)rng.uniform(1, clerk_hi);
      ocom[o] = (int32_t)rng.uniform(0, (int64_t)vocab.size());
    }
    write_i32(mo, "o_orderkey", ok);
    write_i32(mo, "o_custkey", ocust);
    write_dict(mo, "o_orderstatus", {"F", "O", "P"});
    write_i32(mo, "o_orderstatus", ostat, "str", true);
    write_i64(mo, "o_totalprice", o_total, "dec2");
    write_i32(mo, "o_orderdate", o_date, "date");
    write_dict(mo, "o_orderpriority", sorted_vocab(PRIORITIES, 5));
    write_i32(mo, "o_orderpriority", oprio, "str", true);
    write_i32(mo, "o_clerk", oclerk);
    write_i32(mo, "o_shippriority", oship);
    mo.hint("o_orderkey", n_ord);
    mo.hint("o_custkey", std::max<int64_t>(n_cust * 2 / 3, 1));
    write_dict(mo, "o_comment", vocab);
    write_i32(mo, "o_comment", ocom, "str", true);
    mo.finish();
  }
  return 0;
}
