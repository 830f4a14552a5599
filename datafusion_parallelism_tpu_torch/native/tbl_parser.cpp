// Native columnar .tbl (TPC-H dbgen) parser.
//
// The reference ingests tpchgen-generated parquet through DataFusion's Rust
// readers (reference tpc/src/main.rs:196-224); this is the engine's native
// data-loader equivalent: a single-pass '|'-delimited parser that types
// columns straight into caller-allocated numpy buffers, dictionary-encoding
// strings on the fly (device columns are int codes; see utils/columnar.py).
//
// C ABI, driven by ctypes from native/__init__.py.
//
// Column type tags:
//   0 int32   1 int64   2 float64   3 date32 (YYYY-MM-DD -> days since epoch)
//   4 decimal2 (-> int64 cents)     5 string (-> int32 dict codes)
//   -1 skip
//
// Build: g++ -O3 -march=native -shared -fPIC tbl_parser.cpp -o libtbl.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct StringDict {
    std::unordered_map<std::string, int32_t> index;
    std::vector<std::string> values;
    int32_t code(const char* s, size_t len) {
        auto it = index.find(std::string(s, len));
        if (it != index.end()) return it->second;
        int32_t c = (int32_t)values.size();
        values.emplace_back(s, len);
        index.emplace(values.back(), c);
        return c;
    }
};

struct ParseState {
    std::vector<StringDict*> dicts;  // per column; null for non-string
    ~ParseState() { for (auto* d : dicts) delete d; }
};

// Howard Hinnant's civil-date algorithm: y/m/d -> days since 1970-01-01.
inline int32_t days_from_civil(int y, int m, int d) {
    y -= m <= 2;
    const int era = (y >= 0 ? y : y - 399) / 400;
    const unsigned yoe = (unsigned)(y - era * 400);
    const unsigned doy = (153u * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + (int)doe - 719468;
}

inline int64_t parse_int(const char* s, const char* end) {
    bool neg = false;
    if (s < end && (*s == '-' || *s == '+')) { neg = (*s == '-'); ++s; }
    int64_t v = 0;
    while (s < end && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
    return neg ? -v : v;
}

inline int64_t parse_decimal2(const char* s, const char* end) {
    bool neg = false;
    if (s < end && (*s == '-' || *s == '+')) { neg = (*s == '-'); ++s; }
    int64_t v = 0;
    while (s < end && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
    v *= 100;
    if (s < end && *s == '.') {
        ++s;
        int mult = 10;
        while (s < end && *s >= '0' && *s <= '9' && mult >= 1) {
            v += (int64_t)(*s++ - '0') * mult;
            mult /= 10;
        }
    }
    return neg ? -v : v;
}

}  // namespace

extern "C" {

int64_t tbl_count_rows(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    static const size_t BUF = 1 << 20;
    std::vector<char> buf(BUF);
    int64_t lines = 0;
    size_t got;
    char last = '\n';
    while ((got = fread(buf.data(), 1, BUF, f)) > 0) {
        for (size_t i = 0; i < got; i++) lines += buf[i] == '\n';
        last = buf[got - 1];
    }
    fclose(f);
    if (last != '\n') lines++;  // unterminated final row
    return lines;
}

// Parse `path` into caller buffers. Returns an opaque handle holding the
// string dictionaries (fetch + free via the functions below), or null on
// error. bufs[i] must match col_types[i] (int32*/int64*/double*); skip
// columns pass null.
void* tbl_parse(const char* path, int32_t n_cols, const int32_t* col_types,
                void** bufs, int64_t n_rows) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* st = new ParseState();
    st->dicts.resize(n_cols, nullptr);
    for (int c = 0; c < n_cols; c++)
        if (col_types[c] == 5) st->dicts[c] = new StringDict();

    static const size_t BUF = 1 << 22;
    std::vector<char> buf(BUF + 1);
    size_t have = 0;
    int64_t row = 0;
    bool bad = false;
    while (!bad) {
        size_t got = fread(buf.data() + have, 1, BUF - have, f);
        size_t total = have + got;
        if (total == 0) break;
        buf[total] = '\0';
        size_t pos = 0;
        while (true) {
            // find end of current line
            char* nl = (char*)memchr(buf.data() + pos, '\n', total - pos);
            if (!nl) {
                if (got == 0 && pos < total) nl = buf.data() + total;  // last row
                else break;
            }
            if (row >= n_rows) { bad = true; break; }
            const char* p = buf.data() + pos;
            for (int c = 0; c < n_cols; c++) {
                const char* fend = p;
                while (fend < nl && *fend != '|') ++fend;
                switch (col_types[c]) {
                    case 0: ((int32_t*)bufs[c])[row] = (int32_t)parse_int(p, fend); break;
                    case 1: ((int64_t*)bufs[c])[row] = parse_int(p, fend); break;
                    case 2: {
                        char tmp[64];
                        size_t len = (size_t)(fend - p) < 63 ? (size_t)(fend - p) : 63;
                        memcpy(tmp, p, len); tmp[len] = '\0';
                        ((double*)bufs[c])[row] = atof(tmp);
                        break;
                    }
                    case 3: {
                        int y = (int)parse_int(p, p + 4);
                        int m = (int)parse_int(p + 5, p + 7);
                        int d = (int)parse_int(p + 8, p + 10);
                        ((int32_t*)bufs[c])[row] = days_from_civil(y, m, d);
                        break;
                    }
                    case 4: ((int64_t*)bufs[c])[row] = parse_decimal2(p, fend); break;
                    case 5: ((int32_t*)bufs[c])[row] =
                                st->dicts[c]->code(p, (size_t)(fend - p)); break;
                    default: break;  // skip
                }
                p = fend < nl ? fend + 1 : nl;
            }
            row++;
            pos = (size_t)(nl - buf.data()) + 1;
            if (pos >= total) break;
        }
        if (bad) break;
        have = total - (pos < total ? pos : total);
        if (have) memmove(buf.data(), buf.data() + pos, have);
        if (got == 0) break;
    }
    fclose(f);
    if (bad) { delete st; return nullptr; }
    return st;
}

int64_t tbl_dict_size(void* h, int32_t col) {
    auto* st = (ParseState*)h;
    return st->dicts[col] ? (int64_t)st->dicts[col]->values.size() : -1;
}

int64_t tbl_dict_bytes(void* h, int32_t col) {
    auto* st = (ParseState*)h;
    if (!st->dicts[col]) return -1;
    int64_t n = 0;
    for (auto& v : st->dicts[col]->values) n += (int64_t)v.size();
    return n;
}

// blob: concatenated values; offsets: size+1 prefix offsets into blob.
void tbl_dict_fetch(void* h, int32_t col, char* blob, int64_t* offsets) {
    auto* st = (ParseState*)h;
    int64_t off = 0, i = 0;
    for (auto& v : st->dicts[col]->values) {
        offsets[i++] = off;
        memcpy(blob + off, v.data(), v.size());
        off += (int64_t)v.size();
    }
    offsets[i] = off;
}

void tbl_free(void* h) { delete (ParseState*)h; }

}  // extern "C"
