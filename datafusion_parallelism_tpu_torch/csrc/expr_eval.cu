// K17 expr_eval: one launch evaluates every expression of a projection, a
// filter predicate, a join residual or a fused row filter.
//
// Replaces the JAX package's elementwise expression evaluation
// (ops/expressions.py:84-325, `*.eval`; models/planner.py:85,
// `DictMap.eval`), which XLA fuses into one loop per jitted program. The
// port's plain torch version makes one pass over the rows per operator,
// each writing a full temporary.
//
// Bound on the H100: memory traffic. Each referenced column's values and
// validity are read once and each output written once; the instructions
// in between stay on the SM. The program (ops/expressions.py
// `compile_exprs`: typed instructions over registers, each an 8-byte value
// and a validity bit a row) is interpreted over tiles of rows. A block
// decodes the program once into shared memory; then, for each tile of T
// rows, it takes each instruction's `switch` once and runs that one op
// over the tile in a tight loop (a thread takes rows t, t + 256, ...).
// Registers are shared-memory columns [reg][T] of 8-byte values, so a warp
// reads 32 neighbouring values without bank conflicts. Validity is one
// 32-bit word per register and warp strip of 32 rows, built with
// __ballot_sync: an op whose validity is its operands' (ANDed, copied)
// computes it after its rows, a word per lane, and AND, OR, NOT, ISNULL,
// SELECT and COALESCE cost a few word ops per 32 rows. CONST and SCALAR
// registers are uniform, and so is the result of an op whose operands all
// are (a CAST or a product of literals): its value is computed once per
// block, at decode, and an operand that reads one reads that slot (an
// index mask of 0, and a loop with the value hoisted where the op is hot)
// instead of a column. The wrapper picks T from the program's registers
// so that three blocks' register files share an SM's shared memory where
// they can (kernels/expr_eval.py `plan_tile`); a launch that cannot get
// its shared memory fails and the wrapper raises. A row is only ever touched by one
// thread, and a validity word by one warp, so no barrier runs inside a
// tile: each op ends with __syncwarp, and an op whose rows read validity
// words it may overwrite (dst == an operand) syncs the warp between
// reading and writing them. What bounds it in practice is the traffic of
// the register file in shared memory and its latency (PERF.md, PR 9).
//
// Exactness: every op is the torch op the tree's `.eval` applies, bit for
// bit: IEEE float arithmetic through the _rn intrinsics (never contracted
// into an fma), `rint` for torch.round's half-to-even, floor division and
// the divisor's sign for `%` on integers, fmod-based remainder on floats,
// two's-complement wrap-around for int32 and int64, division by zero as
// NULL (0 for integers), torch's float<->int conversions.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int MAX_CODE = 256, MAX_REGS = 64, MAX_COLS = 64, MAX_OUTS = 32, MAX_SCALARS = 8;
constexpr int INS = 8;  // int32 words per instruction

enum Dt { BOOL = 0, I32, I64, F32, F64 };
enum Op {
  COL = 0, CONST, SCALAR, CAST, EQ, NE, LT, LE, GT, GE, ADD, SUB, MUL, IDIV, FDIV, MOD, AND, OR,
  NOT, ISNULL, INSET, SELECT, COALESCE, DATEPART, LUT, ROUND
};

struct ColRef { const void* values; const uint8_t* valid; int dt; int pad; };
struct OutRef { void* values; uint8_t* valid; int reg; int dt; };
struct Params {
  const int32_t* code;
  const i64* tables;
  const int32_t* num_rows;   // mask mode: rows at or past it are False (may be null)
  const uint8_t* and_mask;   // mask mode: ANDed in (may be null)
  uint8_t* mask_out;         // non-null selects mask mode
  i64 n;
  int n_code, n_out, mask_reg, n_regs;
  int tile, pad;  // tile: rows a block takes at a time
  i64 scalar_bits[MAX_SCALARS];
  int scalar_valid[MAX_SCALARS];
  ColRef cols[MAX_COLS];
  OutRef outs[MAX_OUTS];
};

// register value <-> typed value: bool 0/1, int32 sign-extended, int64,
// float32 bits in the low word, float64 bits
__device__ __forceinline__ double as_f64(i64 x) { return __longlong_as_double(x); }
__device__ __forceinline__ float as_f32(i64 x) { return __int_as_float((int)(uint32_t)x); }
__device__ __forceinline__ i64 of_f64(double d) { return __double_as_longlong(d); }
__device__ __forceinline__ i64 of_f32(float f) { return (i64)(uint32_t)__float_as_int(f); }
__device__ __forceinline__ i64 wrap32(i64 x) { return (i64)(int32_t)(uint32_t)(u64)x; }

// torch's .to(): from the register type `from` to `to`
__device__ __forceinline__ i64 cast(i64 x, int from, int to) {
  if (from == F32 || from == F64) {
    const double d = from == F32 ? (double)as_f32(x) : as_f64(x);
    switch (to) {
      case BOOL: return d != 0.0;
      case I32: return from == F32 ? (i64)(int32_t)as_f32(x) : (i64)(int32_t)d;
      case I64: return from == F32 ? (i64)as_f32(x) : (i64)d;
      case F32: return from == F32 ? x : of_f32(__double2float_rn(d));
      default: return of_f64(d);
    }
  }
  switch (to) {  // integer source: bool 0/1, int32 sign-extended, int64
    case BOOL: return x != 0;
    case I32: return wrap32(x);
    case I64: return x;
    case F32: return of_f32(__ll2float_rn(x));
    default: return of_f64(__ll2double_rn(x));
  }
}

__device__ __forceinline__ bool compare(int op, i64 x, i64 y, int dt) {
  if (dt == F32 || dt == F64) {
    const double a = dt == F32 ? (double)as_f32(x) : as_f64(x);
    const double b = dt == F32 ? (double)as_f32(y) : as_f64(y);
    switch (op) {
      case EQ: return a == b; case NE: return a != b; case LT: return a < b;
      case LE: return a <= b; case GT: return a > b; default: return a >= b;
    }
  }
  switch (op) {
    case EQ: return x == y; case NE: return x != y; case LT: return x < y;
    case LE: return x <= y; case GT: return x > y; default: return x >= y;
  }
}

__device__ __forceinline__ i64 arith(int op, i64 x, i64 y, int dt) {
  switch (dt) {
    case F32: {
      const float a = as_f32(x), b = as_f32(y);
      return of_f32(op == ADD ? __fadd_rn(a, b) : op == SUB ? __fsub_rn(a, b) : __fmul_rn(a, b));
    }
    case F64: {
      const double a = as_f64(x), b = as_f64(y);
      return of_f64(op == ADD ? __dadd_rn(a, b) : op == SUB ? __dsub_rn(a, b) : __dmul_rn(a, b));
    }
    case BOOL: return op == ADD ? (x | y) : (x & y);  // torch's bool + and *
    default: {
      const u64 a = (u64)x, b = (u64)y;
      const i64 r = (i64)(op == ADD ? a + b : op == SUB ? a - b : a * b);
      return dt == I32 ? wrap32(r) : r;
    }
  }
}

// torch's floor division of integers (d != 0)
__device__ __forceinline__ i64 floor_div(i64 a, i64 d) {
  if (d == -1) return (i64)(0ULL - (u64)a);
  const i64 q = a / d;
  return ((a % d != 0) && ((a < 0) != (d < 0))) ? q - 1 : q;
}

__device__ __forceinline__ i64 fdiv_pos(i64 a, i64 d) {  // floor division, d > 0
  const i64 q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

// ExtractDatePart's civil-calendar algorithm on int32 days
__device__ __forceinline__ i64 date_part(i64 days, int part) {
  const i64 z = wrap32(days + 719468);
  const i64 era = fdiv_pos(z, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = fdiv_pos(doe - fdiv_pos(doe, 1460) + fdiv_pos(doe, 36524) -
                           fdiv_pos(doe, 146096), 365);
  i64 y = yoe + era * 400;
  const i64 doy = doe - (365 * yoe + fdiv_pos(yoe, 4) - fdiv_pos(yoe, 100));
  const i64 mp = fdiv_pos(5 * doy + 2, 153);
  const i64 d = doy - fdiv_pos(153 * mp + 2, 5) + 1;
  const i64 m = mp + (mp < 10 ? 3 : -9);
  y += m <= 2;
  return wrap32(part == 0 ? y : part == 1 ? m : d);
}

// a compile-time value, for dispatching a uniform op, type or operand kind
// once per tile
template <int V> struct K { static constexpr int value = V; };

template <class F> __device__ __forceinline__ void with_dt(int dt, F f) {
  switch (dt) {
    case BOOL: f(K<BOOL>()); break;
    case I32: f(K<I32>()); break;
    case I64: f(K<I64>()); break;
    case F32: f(K<F32>()); break;
    default: f(K<F64>());
  }
}

template <class F> __device__ __forceinline__ void with_cmp(int op, F f) {
  switch (op) {
    case EQ: f(K<EQ>()); break;
    case NE: f(K<NE>()); break;
    case LT: f(K<LT>()); break;
    case LE: f(K<LE>()); break;
    case GT: f(K<GT>()); break;
    default: f(K<GE>());
  }
}

template <class F> __device__ __forceinline__ void with_arith(int op, F f) {
  switch (op) {
    case ADD: f(K<ADD>()); break;
    case SUB: f(K<SUB>()); break;
    default: f(K<MUL>());
  }
}

// an operand's kind from its index mask: K<1> a uniform slot, K<0> a column
template <class F> __device__ __forceinline__ void with_u(int mask, F f) {
  if (mask == 0) f(K<1>()); else f(K<0>());
}

constexpr int BLOCK = 256, COL_BATCH = 4;

// One decoded instruction. An operand x reads value V[vx + (i & mx)] at
// row i of the tile and validity word W[wx + (g & mx)] in word g: mx = -1
// for a register column, 0 for a uniform slot (a CONST's or SCALAR's value,
// one per instruction, after the columns).
struct Dec {
  i64 imm;
  int op, dt, dst, a, b, c;
  int va, vb, vc, wa, wb, wc, ma, mb, mc;
  int pad;
};
static_assert(sizeof(Dec) == 72, "kernels/expr_eval.py DEC_BYTES");

// The dynamic shared memory of a launch (kernels/expr_eval.py
// `smem_bytes`), in order, each part 16-byte aligned: R register columns
// of T 8-byte values and one uniform slot per instruction; their validity
// words (one per register and 32 rows, one per instruction) and a scratch
// word per 32 rows; one Dec per instruction and per root.
__host__ __device__ __forceinline__ i64 value_bytes(int R, int C, int T) {
  return (8LL * ((i64)R * T + C) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ i64 word_bytes(int R, int C, int T) {
  return (4LL * ((i64)(R + 1) * (T / 32) + C) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ i64 smem_bytes(int R, int C, int roots, int T) {
  return value_bytes(R, C, T) + word_bytes(R, C, T) + (i64)(C + roots) * (i64)sizeof(Dec);
}

__device__ __forceinline__ int n_reads(int op) {
  switch (op) {
    case COL: case CONST: case SCALAR: return 0;
    case SELECT: return 3;
    case CAST: case NOT: case ISNULL: case INSET: case DATEPART: case LUT: case ROUND: return 1;
    default: return 2;
  }
}

// a column's element as a register value
template <int DT> __device__ __forceinline__ i64 load_t(const void* p, i64 row) {
  if (DT == BOOL) return ((const uint8_t*)p)[row] != 0;
  if (DT == I32) return ((const int32_t*)p)[row];
  if (DT == F32) return (i64)((const uint32_t*)p)[row];
  return ((const i64*)p)[row];  // I64, F64
}

template <int DT> __device__ __forceinline__ void store_t(void* p, i64 row, i64 x) {
  if (DT == BOOL) ((uint8_t*)p)[row] = x != 0;
  else if (DT == I32) ((int32_t*)p)[row] = (int32_t)x;
  else if (DT == F32) ((uint32_t*)p)[row] = (uint32_t)x;
  else ((i64*)p)[row] = x;
}

// operand x at row i: one slot when uniform (U), else its column
template <int U> __device__ __forceinline__ i64 rd(const i64* x, int i) { return U ? x[0] : x[i]; }

__device__ __forceinline__ bool bit_of(uint32_t w, int lane) { return (w >> lane) & 1u; }

// One op on one row's operands (values x, y, z; validity vx, vy, vz): the
// per-row semantics the tile loops below run. The decode runs it once for
// an op whose operands are all uniform, so its result is uniform too.
__device__ i64 eval_row(const Params& p, const Dec& d, i64 x, i64 y, i64 z, bool vx, bool vy,
                        bool vz, bool& ok) {
  const int op = d.op, dt = d.dt, b = d.b, c = d.c;
  switch (op) {
    case CAST: ok = vx; return cast(x, c, dt);
    case EQ: case NE: case LT: case LE: case GT: case GE:
      ok = vx && vy;
      return compare(op, x, y, c);
    case ADD: case SUB: case MUL:
      ok = vx && vy;
      return arith(op, x, y, dt);
    case IDIV: {
      const bool nz = y != 0;
      ok = vx && vy && nz;
      const i64 q = floor_div(x, nz ? y : 1);
      return ok ? (dt == I32 ? wrap32(q) : q) : 0;
    }
    case FDIV:
      if (dt == F32) {
        const float fy = as_f32(y);
        ok = vx && vy && fy != 0.0f;
        return of_f32(__fdiv_rn(as_f32(x), fy != 0.0f ? fy : 1.0f));
      } else {
        const double fy = as_f64(y);
        ok = vx && vy && fy != 0.0;
        return of_f64(__ddiv_rn(as_f64(x), fy != 0.0 ? fy : 1.0));
      }
    case MOD:
      if (dt == F32) {
        const float y0 = as_f32(y), fy = y0 != 0.0f ? y0 : 1.0f;
        float m = fmodf(as_f32(x), fy);
        if (m != 0.0f && ((fy < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, fy);
        ok = vx && vy && y0 != 0.0f;
        return of_f32(m);
      } else if (dt == F64) {
        const double y0 = as_f64(y), fy = y0 != 0.0 ? y0 : 1.0;
        double m = fmod(as_f64(x), fy);
        if (m != 0.0 && ((fy < 0.0) != (m < 0.0))) m = __dadd_rn(m, fy);
        ok = vx && vy && y0 != 0.0;
        return of_f64(m);
      } else {
        const bool nz = y != 0;
        const i64 iy = nz ? y : 1;
        i64 m = iy == -1 ? 0 : x % iy;
        if (m != 0 && ((m < 0) != (iy < 0))) m += iy;
        ok = vx && vy && nz;
        return dt == I32 ? wrap32(m) : m;
      }
    case AND: case OR: {
      const bool lb = x != 0, rb = y != 0;
      if (op == AND) {
        ok = (vx && vy) || (vx && !lb) || (vy && !rb);
        return (vx ? lb : true) && (vy ? rb : true);
      }
      ok = (vx && vy) || (vx && lb) || (vy && rb);
      return (vx ? lb : false) || (vy ? rb : false);
    }
    case NOT: ok = vx; return x == 0;
    case ISNULL: ok = true; return b ? vx : !vx;
    case INSET: {
      const i64 off = d.imm >> 32, cnt = d.imm & 0xffffffffLL;
      const i64* set = p.tables + off;
      i64 lo = 0, hi = cnt;
      bool member;
      if (c == F32 || c == F64) {
        const double f = c == F32 ? (double)as_f32(x) : as_f64(x);
        while (lo < hi) {
          const i64 mid = (lo + hi) >> 1;
          if (as_f64(set[mid]) < f) lo = mid + 1; else hi = mid;
        }
        member = lo < cnt && as_f64(set[lo]) == f;
      } else {
        while (lo < hi) {
          const i64 mid = (lo + hi) >> 1;
          if (set[mid] < x) lo = mid + 1; else hi = mid;
        }
        member = lo < cnt && set[lo] == x;
      }
      ok = vx;
      return member != (b != 0);
    }
    case SELECT: {
      const bool hit = vx && x != 0;
      ok = hit ? vy : vz;
      return hit ? y : z;
    }
    case COALESCE: ok = vx || vy; return vx ? x : y;
    case DATEPART: ok = vx; return date_part(x, b);
    case LUT: {
      const i64 off = d.imm >> 32, cnt = d.imm & 0xffffffffLL;
      ok = vx;
      return wrap32(p.tables[off + (x < 0 ? 0 : x >= cnt ? cnt - 1 : x)]);
    }
    case ROUND: ok = vx; return of_f64(rint(as_f64(x)));
    default: ok = false; return 0;
  }
}

// __grid_constant__: the kernel indexes the parameters (columns, outputs,
// scalars) at run time; without it every thread would copy them to local
// memory first.
__global__ void __launch_bounds__(BLOCK, 3) expr_eval_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.n_regs, C = p.n_code, T = p.tile, G = T / 32, S = T / BLOCK;
  const bool mask_mode = p.mask_out != nullptr;
  const int roots = mask_mode ? 1 : p.n_out;
  i64* V = (i64*)smem;
  uint32_t* W = (uint32_t*)(smem + value_bytes(R, C, T));
  Dec* D = (Dec*)(smem + value_bytes(R, C, T) + word_bytes(R, C, T));
  if (threadIdx.x == 0) {
    // decode once a block: bind each operand to its register column or to
    // the uniform slot of the CONST / SCALAR that last wrote it
    int src[MAX_REGS];
    for (int r = 0; r < MAX_REGS; ++r) src[r] = -1;
    auto bind = [&](int reg, int& v, int& w, int& m) {
      if (src[reg] >= 0) { v = R * T + src[reg]; w = R * G + src[reg]; m = 0; }
      else { v = reg * T; w = reg * G; m = -1; }
    };
    for (int pc = 0; pc < C; ++pc) {
      const int32_t* ins = p.code + pc * INS;
      Dec d;
      d.op = ins[0]; d.dt = ins[1]; d.dst = ins[2]; d.a = ins[3]; d.b = ins[4]; d.c = ins[5];
      d.imm = (i64)(((u64)(uint32_t)ins[7] << 32) | (u64)(uint32_t)ins[6]);
      d.va = d.vb = d.vc = d.wa = d.wb = d.wc = d.ma = d.mb = d.mc = d.pad = 0;
      const int k = n_reads(d.op);
      if (k > 0) bind(d.a, d.va, d.wa, d.ma);
      if (k > 1) bind(d.b, d.vb, d.wb, d.mb);
      if (k > 2) bind(d.c, d.vc, d.wc, d.mc);
      if (d.op == CONST || d.op == SCALAR) {
        const bool ok = d.op == CONST ? d.b != 0 : p.scalar_valid[d.a] != 0;
        V[R * T + pc] = ok ? (d.op == CONST ? d.imm : p.scalar_bits[d.a]) : 0;
        W[R * G + pc] = ok ? ~0u : 0u;
        src[d.dst] = pc;
      } else if (k > 0 && d.ma == 0 && (k < 2 || d.mb == 0) && (k < 3 || d.mc == 0)) {
        // every operand uniform: the result is too, computed once here
        bool ok;
        V[R * T + pc] = eval_row(p, d, V[d.va], V[d.vb], V[d.vc], W[d.wa] != 0, W[d.wb] != 0,
                                 W[d.wc] != 0, ok);
        W[R * G + pc] = ok ? ~0u : 0u;
        src[d.dst] = pc;
        d.op = CONST;  // nothing left to run a tile
      } else {
        src[d.dst] = -1;
      }
      D[pc] = d;
    }
    for (int k = 0; k < roots; ++k) {
      Dec r = {};
      bind(mask_mode ? p.mask_reg : p.outs[k].reg, r.va, r.wa, r.ma);
      D[C + k] = r;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const int wbase = warp * S;  // the warp's validity word of strip s: wbase + s
  uint32_t* scratch = W + R * G + C;
  const i64 num_rows = p.num_rows != nullptr ? (i64)*p.num_rows : p.n;
  const i64 step = (i64)gridDim.x * T;
  for (i64 base = (i64)blockIdx.x * T; base < p.n; base += step) {
    const int rows = (int)(p.n - base < T ? p.n - base : T);
    const int strips = (rows + BLOCK - 1) / BLOCK;
    // f(s, i): the thread's rows i = s * BLOCK + t of the tile's strips
    auto each_row = [&](auto f) {
#pragma unroll 4
      for (int s = 0; s < strips; ++s) f(s, s * BLOCK + t);
    };
    // f(g): the warp's validity words, one a lane (strips <= 32)
    auto each_word = [&](auto f) {
      if (lane < strips) f(wbase + lane);
    };
    for (int pc = 0; pc < C; ++pc) {
      const Dec d = D[pc];
      const i64* A = V + d.va;
      const i64* B = V + d.vb;
      const i64* Cv = V + d.vc;
      const uint32_t* WA = W + d.wa;
      const uint32_t* WB = W + d.wb;
      const uint32_t* WC = W + d.wc;
      const int ma = d.ma, mb = d.mb, mc = d.mc;
      i64* out = V + d.dst * T;
      uint32_t* wout = W + d.dst * G;
      switch (d.op) {
        case CONST: case SCALAR: break;  // uniform: written at decode
        case COL: {
          const ColRef& col = p.cols[d.a];
          with_dt(col.dt, [&](auto k) {
            constexpr int DT = decltype(k)::value;
            // COL_BATCH strips' loads in flight before their stores
            for (int s0 = 0; s0 < strips; s0 += COL_BATCH) {
              i64 x[COL_BATCH];
              bool ok[COL_BATCH];
#pragma unroll
              for (int u = 0; u < COL_BATCH; ++u) {
                const int i = (s0 + u) * BLOCK + t;
                const bool in = s0 + u < strips && i < rows;
                x[u] = in ? load_t<DT>(col.values, base + i) : 0;
                ok[u] = in && col.valid[base + i] != 0;
              }
#pragma unroll
              for (int u = 0; u < COL_BATCH; ++u) {
                if (s0 + u < strips) {
                  out[(s0 + u) * BLOCK + t] = x[u];
                  const uint32_t w = __ballot_sync(~0u, ok[u]);
                  if (lane == 0) wout[wbase + s0 + u] = w;
                }
              }
            }
          });
          break;
        }
        case CAST:
          with_dt(d.c, [&](auto f) {
            with_dt(d.dt, [&](auto k) {
              with_u(ma, [&](auto ua) {
                each_row([&](int, int i) {
                  out[i] = cast(rd<decltype(ua)::value>(A, i), decltype(f)::value,
                                decltype(k)::value);
                });
              });
            });
          });
          each_word([&](int g) { wout[g] = WA[g & ma]; });
          break;
        case EQ: case NE: case LT: case LE: case GT: case GE:
          with_cmp(d.op, [&](auto o) {
            with_dt(d.c, [&](auto k) {
              with_u(mb, [&](auto ub) {
                each_row([&](int, int i) {
                  out[i] = compare(decltype(o)::value, A[i & ma],
                                   rd<decltype(ub)::value>(B, i), decltype(k)::value);
                });
              });
            });
          });
          each_word([&](int g) { wout[g] = WA[g & ma] & WB[g & mb]; });
          break;
        case ADD: case SUB: case MUL:
          with_arith(d.op, [&](auto o) {
            with_dt(d.dt, [&](auto k) {
              with_u(ma, [&](auto ua) {
                with_u(mb, [&](auto ub) {
                  each_row([&](int, int i) {
                    out[i] = arith(decltype(o)::value, rd<decltype(ua)::value>(A, i),
                                   rd<decltype(ub)::value>(B, i), decltype(k)::value);
                  });
                });
              });
            });
          });
          each_word([&](int g) { wout[g] = WA[g & ma] & WB[g & mb]; });
          break;
        case IDIV:
          each_row([&](int s, int i) {
            const int g = wbase + s;
            const i64 y = B[i & mb];
            const bool nz = y != 0;
            const uint32_t w = WA[g & ma] & WB[g & mb] & __ballot_sync(~0u, nz);
            const i64 q = floor_div(A[i & ma], nz ? y : 1);
            __syncwarp();
            out[i] = bit_of(w, lane) ? (d.dt == I32 ? wrap32(q) : q) : 0;
            if (lane == 0) wout[g] = w;
          });
          break;
        case FDIV:
          // the divisor's non-zero bits into the scratch words, then the
          // validity a word a lane
          if (d.dt == F32) {
            with_u(mb, [&](auto ub) {
              each_row([&](int s, int i) {
                const float x = as_f32(A[i & ma]), y = as_f32(rd<decltype(ub)::value>(B, i));
                const uint32_t nz = __ballot_sync(~0u, y != 0.0f);
                out[i] = of_f32(__fdiv_rn(x, y != 0.0f ? y : 1.0f));
                if (lane == 0) scratch[wbase + s] = nz;
              });
            });
          } else {
            with_u(mb, [&](auto ub) {
              each_row([&](int s, int i) {
                const double x = as_f64(A[i & ma]), y = as_f64(rd<decltype(ub)::value>(B, i));
                const uint32_t nz = __ballot_sync(~0u, y != 0.0);
                out[i] = of_f64(__ddiv_rn(x, y != 0.0 ? y : 1.0));
                if (lane == 0) scratch[wbase + s] = nz;
              });
            });
          }
          __syncwarp();
          each_word([&](int g) { wout[g] = WA[g & ma] & WB[g & mb] & scratch[g]; });
          break;
        case MOD:
          if (d.dt == F32) {
            each_row([&](int s, int i) {
              const float x = as_f32(A[i & ma]), y0 = as_f32(B[i & mb]);
              const float y = y0 != 0.0f ? y0 : 1.0f;
              float m = fmodf(x, y);
              if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y);
              const uint32_t nz = __ballot_sync(~0u, y0 != 0.0f);
              out[i] = of_f32(m);
              if (lane == 0) scratch[wbase + s] = nz;
            });
          } else if (d.dt == F64) {
            each_row([&](int s, int i) {
              const double x = as_f64(A[i & ma]), y0 = as_f64(B[i & mb]);
              const double y = y0 != 0.0 ? y0 : 1.0;
              double m = fmod(x, y);
              if (m != 0.0 && ((y < 0.0) != (m < 0.0))) m = __dadd_rn(m, y);
              const uint32_t nz = __ballot_sync(~0u, y0 != 0.0);
              out[i] = of_f64(m);
              if (lane == 0) scratch[wbase + s] = nz;
            });
          } else {
            each_row([&](int s, int i) {
              const i64 y0 = B[i & mb];
              const bool nz = y0 != 0;
              const i64 y = nz ? y0 : 1;
              i64 m = y == -1 ? 0 : A[i & ma] % y;
              if (m != 0 && ((m < 0) != (y < 0))) m += y;
              const uint32_t w = __ballot_sync(~0u, nz);
              out[i] = d.dt == I32 ? wrap32(m) : m;
              if (lane == 0) scratch[wbase + s] = w;
            });
          }
          __syncwarp();
          each_word([&](int g) { wout[g] = WA[g & ma] & WB[g & mb] & scratch[g]; });
          break;
        case AND: case OR: {
          const bool is_and = d.op == AND;
          each_row([&](int s, int i) {
            const int g = wbase + s;
            const uint32_t lval = WA[g & ma], rval = WB[g & mb];
            const uint32_t lb = __ballot_sync(~0u, A[i & ma] != 0);
            const uint32_t rb = __ballot_sync(~0u, B[i & mb] != 0);
            // AND: (lval ? lb : true) && (rval ? rb : true); OR: with false
            const uint32_t v = is_and ? (~lval | lb) & (~rval | rb) : (lval & lb) | (rval & rb);
            const uint32_t ok = is_and ? (lval & rval) | (lval & ~lb) | (rval & ~rb)
                                       : (lval & rval) | (lval & lb) | (rval & rb);
            __syncwarp();
            out[i] = bit_of(v, lane);
            if (lane == 0) wout[g] = ok;
          });
          break;
        }
        case NOT:
          each_row([&](int, int i) { out[i] = A[i & ma] == 0; });
          each_word([&](int g) { wout[g] = WA[g & ma]; });
          break;
        case ISNULL: {
          const uint32_t flip = d.b ? 0u : ~0u;  // IS NOT NULL: the validity itself
          each_row([&](int s, int i) { out[i] = bit_of(WA[(wbase + s) & ma] ^ flip, lane); });
          __syncwarp();
          each_word([&](int g) { wout[g] = ~0u; });
          break;
        }
        case INSET: {
          const i64 off = d.imm >> 32, cnt = d.imm & 0xffffffffLL;
          const i64* set = p.tables + off;
          const bool neg = d.b != 0, fl = d.c == F32 || d.c == F64, f32 = d.c == F32;
          each_row([&](int, int i) {
            const i64 xr = A[i & ma];
            i64 lo = 0, hi = cnt;
            bool member;
            if (fl) {
              const double x = f32 ? (double)as_f32(xr) : as_f64(xr);
              while (lo < hi) {
                const i64 mid = (lo + hi) >> 1;
                if (as_f64(set[mid]) < x) lo = mid + 1; else hi = mid;
              }
              member = lo < cnt && as_f64(set[lo]) == x;
            } else {
              while (lo < hi) {
                const i64 mid = (lo + hi) >> 1;
                if (set[mid] < xr) lo = mid + 1; else hi = mid;
              }
              member = lo < cnt && set[lo] == xr;
            }
            out[i] = member != neg;
          });
          each_word([&](int g) { wout[g] = WA[g & ma]; });
          break;
        }
        case SELECT:
          each_row([&](int s, int i) {
            const int g = wbase + s;
            const uint32_t hit = WA[g & ma] & __ballot_sync(~0u, A[i & ma] != 0);
            const uint32_t ok = (hit & WB[g & mb]) | (~hit & WC[g & mc]);
            const i64 x = bit_of(hit, lane) ? B[i & mb] : Cv[i & mc];
            __syncwarp();
            out[i] = x;
            if (lane == 0) wout[g] = ok;
          });
          break;
        case COALESCE:
          each_row([&](int s, int i) {
            const int g = wbase + s;
            const uint32_t va = WA[g & ma], vb = WB[g & mb];
            const i64 x = bit_of(va, lane) ? A[i & ma] : B[i & mb];
            __syncwarp();
            out[i] = x;
            if (lane == 0) wout[g] = va | vb;
          });
          break;
        case DATEPART:
          each_row([&](int, int i) { out[i] = date_part(A[i & ma], d.b); });
          each_word([&](int g) { wout[g] = WA[g & ma]; });
          break;
        case LUT: {
          const i64 off = d.imm >> 32, cnt = d.imm & 0xffffffffLL;
          each_row([&](int, int i) {
            const i64 x = A[i & ma];
            out[i] = wrap32(p.tables[off + (x < 0 ? 0 : x >= cnt ? cnt - 1 : x)]);
          });
          each_word([&](int g) { wout[g] = WA[g & ma]; });
          break;
        }
        case ROUND:
          each_row([&](int, int i) { out[i] = of_f64(rint(as_f64(A[i & ma]))); });
          each_word([&](int g) { wout[g] = WA[g & ma]; });
          break;
        default: break;
      }
      __syncwarp();
    }
    // write back: each thread its own rows, neighbouring threads
    // neighbouring rows
    if (mask_mode) {
      const Dec r = D[C];
      each_row([&](int s, int i) {
        if (i < rows) {
          const i64 row = base + i;
          bool m = bit_of(W[r.wa + ((wbase + s) & r.ma)], lane) && V[r.va + (i & r.ma)] != 0;
          m = m && row < num_rows;
          if (p.and_mask != nullptr) m = m && p.and_mask[row] != 0;
          p.mask_out[row] = m;
        }
      });
    } else {
      for (int k = 0; k < p.n_out; ++k) {
        const Dec r = D[C + k];
        const OutRef& o = p.outs[k];
        with_dt(o.dt, [&](auto dt) {
          each_row([&](int s, int i) {
            if (i < rows) {
              store_t<decltype(dt)::value>(o.values, base + i, V[r.va + (i & r.ma)]);
              o.valid[base + i] = bit_of(W[r.wa + ((wbase + s) & r.ma)], lane);
            }
          });
        });
      }
    }
    __syncwarp();
  }
}

}  // namespace

// sizeof(Params), which kernels/expr_eval.py's `_Params` must equal
extern "C" long long dfp_expr_eval_params_bytes() { return (long long)sizeof(Params); }

// the dynamic shared memory of a launch (kernels/expr_eval.py `smem_bytes`)
extern "C" long long dfp_expr_eval_smem_bytes(int n_regs, int n_code, int roots, int tile) {
  return smem_bytes(n_regs, n_code, roots, tile);
}

// `params` is a host struct laid out as Params (kernels/expr_eval.py
// `_Params`); it is copied into the launch's parameters. p.tile rows a
// tile (a multiple of 256, from the wrapper's `plan_tile`); a launch whose
// shared memory the device does not grant returns an error and runs
// nothing.
extern "C" int dfp_expr_eval(const void* params, void* stream) {
  const Params& p = *(const Params*)params;
  if (p.n_code < 0 || p.n_code > MAX_CODE || p.n_out > MAX_OUTS || p.n_regs < 0 ||
      p.n_regs > MAX_REGS || p.tile < BLOCK || p.tile % BLOCK != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.n <= 0) return (int)cudaGetLastError();
  const int roots = p.mask_out != nullptr ? 1 : p.n_out;
  const i64 bytes = smem_bytes(p.n_regs, p.n_code, roots, p.tile);
  int device = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  // the kernel's opt-in limit, raised once a device
  static bool raised[64] = {false};
  if (device < 64 && !raised[device]) {
    e = cudaFuncSetAttribute(expr_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    raised[device] = true;
  }
  // blocks an SM holds at this shared memory, asked once a size and device
  static i64 asked[64] = {0};
  static int held[64] = {0};
  int per_sm = device < 64 && asked[device] == bytes ? held[device] : 0;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expr_eval_kernel, BLOCK, (size_t)bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (device < 64) { asked[device] = bytes; held[device] = per_sm; }
  }
  const i64 tiles = (p.n + p.tile - 1) / p.tile;
  const i64 blocks = tiles < (i64)sms * per_sm ? tiles : (i64)sms * per_sm;
  expr_eval_kernel<<<(unsigned)blocks, BLOCK, (size_t)bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
