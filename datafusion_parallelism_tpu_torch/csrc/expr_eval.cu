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
// in between stay in registers. The program (ops/expressions.py
// `compile_exprs`: typed instructions over per-row registers, each an
// 8-byte value and a validity bit) is interpreted by one thread a row: the
// block copies it into shared memory once, and every thread of a warp runs
// the same instruction, so the `switch` costs no divergence. The
// instructions and the code sets / LUTs reach the card once per program;
// what a launch names (column and output pointers, scalar subquery values)
// rides by value in the kernel's parameters, so no launch waits on a copy.
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
  int n_code, n_out, mask_reg, pad;
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

__device__ __forceinline__ i64 load(const void* p, int dt, i64 row) {
  switch (dt) {
    case BOOL: return ((const uint8_t*)p)[row] != 0;
    case I32: return ((const int32_t*)p)[row];
    case F32: return (i64)((const uint32_t*)p)[row];
    default: return ((const i64*)p)[row];  // I64, F64
  }
}

__device__ __forceinline__ void store(void* p, int dt, i64 row, i64 x) {
  switch (dt) {
    case BOOL: ((uint8_t*)p)[row] = x != 0; break;
    case I32: ((int32_t*)p)[row] = (int32_t)x; break;
    case F32: ((uint32_t*)p)[row] = (uint32_t)x; break;
    default: ((i64*)p)[row] = x;
  }
}

// torch's .to(): from the register type `from` to `to`
__device__ i64 cast(i64 x, int from, int to) {
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

__device__ i64 arith(int op, i64 x, i64 y, int dt) {
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
__device__ i64 date_part(i64 days, int part) {
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

// __grid_constant__: the kernel indexes the parameters (columns, outputs,
// scalars) at run time; without it every thread would copy them to local
// memory first.
__global__ void __launch_bounds__(256) expr_eval_kernel(const __grid_constant__ Params p) {
  __shared__ int32_t code[MAX_CODE * INS];
  for (int k = threadIdx.x; k < p.n_code * INS; k += blockDim.x) code[k] = p.code[k];
  __syncthreads();
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < p.n; row += stride) {
    i64 r[MAX_REGS];
    u64 v = 0;  // validity bit per register
    for (int pc = 0; pc < p.n_code; ++pc) {
      const int32_t* ins = code + pc * INS;
      const int op = ins[0], dt = ins[1], dst = ins[2], a = ins[3], b = ins[4], c = ins[5];
      const i64 imm = (i64)(((u64)(uint32_t)ins[7] << 32) | (u64)(uint32_t)ins[6]);
      i64 out = 0;
      bool ok = false;
      switch (op) {
        case COL: {
          const ColRef& col = p.cols[a];
          out = load(col.values, col.dt, row);
          ok = col.valid[row] != 0;
          break;
        }
        case CONST: ok = b != 0; out = ok ? imm : 0; break;
        case SCALAR: ok = p.scalar_valid[a] != 0; out = ok ? p.scalar_bits[a] : 0; break;
        case CAST: out = cast(r[a], c, dt); ok = (v >> a) & 1; break;
        case EQ: case NE: case LT: case LE: case GT: case GE:
          out = compare(op, r[a], r[b], c);
          ok = ((v >> a) & (v >> b)) & 1;
          break;
        case ADD: case SUB: case MUL:
          out = arith(op, r[a], r[b], dt);
          ok = ((v >> a) & (v >> b)) & 1;
          break;
        case IDIV: {
          const bool nz = r[b] != 0;
          ok = (((v >> a) & (v >> b)) & 1) && nz;
          const i64 q = floor_div(r[a], nz ? r[b] : 1);
          out = ok ? (dt == I32 ? wrap32(q) : q) : 0;
          break;
        }
        case FDIV:
          if (dt == F32) {
            const float x = as_f32(r[a]), y = as_f32(r[b]);
            out = of_f32(__fdiv_rn(x, y != 0.0f ? y : 1.0f));
            ok = (((v >> a) & (v >> b)) & 1) && y != 0.0f;
          } else {
            const double x = as_f64(r[a]), y = as_f64(r[b]);
            out = of_f64(__ddiv_rn(x, y != 0.0 ? y : 1.0));
            ok = (((v >> a) & (v >> b)) & 1) && y != 0.0;
          }
          break;
        case MOD:
          if (dt == F32) {
            const float x = as_f32(r[a]), y0 = as_f32(r[b]);
            const float y = y0 != 0.0f ? y0 : 1.0f;
            float m = fmodf(x, y);
            if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y);
            out = of_f32(m);
            ok = (((v >> a) & (v >> b)) & 1) && y0 != 0.0f;
          } else if (dt == F64) {
            const double x = as_f64(r[a]), y0 = as_f64(r[b]);
            const double y = y0 != 0.0 ? y0 : 1.0;
            double m = fmod(x, y);
            if (m != 0.0 && ((y < 0.0) != (m < 0.0))) m = __dadd_rn(m, y);
            out = of_f64(m);
            ok = (((v >> a) & (v >> b)) & 1) && y0 != 0.0;
          } else {
            const bool nz = r[b] != 0;
            const i64 y = nz ? r[b] : 1;
            i64 m = y == -1 ? 0 : r[a] % y;
            if (m != 0 && ((m < 0) != (y < 0))) m += y;
            out = dt == I32 ? wrap32(m) : m;
            ok = (((v >> a) & (v >> b)) & 1) && nz;
          }
          break;
        case AND: case OR: {
          const bool lval = (v >> a) & 1, rval = (v >> b) & 1;
          const bool lb = r[a] != 0, rb = r[b] != 0;
          if (op == AND) {
            out = (lval ? lb : true) && (rval ? rb : true);
            ok = (lval && rval) || (lval && !lb) || (rval && !rb);
          } else {
            out = (lval ? lb : false) || (rval ? rb : false);
            ok = (lval && rval) || (lval && lb) || (rval && rb);
          }
          break;
        }
        case NOT: out = r[a] == 0; ok = (v >> a) & 1; break;
        case ISNULL: {
          const bool va = (v >> a) & 1;
          out = b ? va : !va;
          ok = true;
          break;
        }
        case INSET: {
          const i64 off = imm >> 32, cnt = imm & 0xffffffffLL;
          const i64* set = p.tables + off;
          i64 lo = 0, hi = cnt;
          bool member;
          if (c == F32 || c == F64) {
            const double x = c == F32 ? (double)as_f32(r[a]) : as_f64(r[a]);
            while (lo < hi) {
              const i64 mid = (lo + hi) >> 1;
              if (as_f64(set[mid]) < x) lo = mid + 1; else hi = mid;
            }
            member = lo < cnt && as_f64(set[lo]) == x;
          } else {
            const i64 x = r[a];
            while (lo < hi) {
              const i64 mid = (lo + hi) >> 1;
              if (set[mid] < x) lo = mid + 1; else hi = mid;
            }
            member = lo < cnt && set[lo] == x;
          }
          out = member != (b != 0);
          ok = (v >> a) & 1;
          break;
        }
        case SELECT: {
          const bool hit = ((v >> a) & 1) && r[a] != 0;
          out = hit ? r[b] : r[c];
          ok = hit ? ((v >> b) & 1) : ((v >> c) & 1);
          break;
        }
        case COALESCE: {
          const bool va = (v >> a) & 1;
          out = va ? r[a] : r[b];
          ok = va || ((v >> b) & 1);
          break;
        }
        case DATEPART: out = date_part(r[a], b); ok = (v >> a) & 1; break;
        case LUT: {
          const i64 off = imm >> 32, cnt = imm & 0xffffffffLL;
          const i64 x = r[a];
          out = wrap32(p.tables[off + (x < 0 ? 0 : x >= cnt ? cnt - 1 : x)]);
          ok = (v >> a) & 1;
          break;
        }
        case ROUND: out = of_f64(rint(as_f64(r[a]))); ok = (v >> a) & 1; break;
        default: break;
      }
      r[dst] = out;
      v = ok ? (v | (1ull << dst)) : (v & ~(1ull << dst));
    }
    if (p.mask_out != nullptr) {
      bool m = ((v >> p.mask_reg) & 1) && r[p.mask_reg] != 0;
      if (p.num_rows != nullptr) m = m && row < (i64)*p.num_rows;
      if (p.and_mask != nullptr) m = m && p.and_mask[row] != 0;
      p.mask_out[row] = m;
    } else {
      for (int k = 0; k < p.n_out; ++k) {
        const OutRef& o = p.outs[k];
        store(o.values, o.dt, row, r[o.reg]);
        o.valid[row] = (v >> o.reg) & 1;
      }
    }
  }
}

}  // namespace

// `params` is a host struct laid out as Params (kernels/expr_eval.py
// `_Params`); it is copied into the launch's parameters.
extern "C" int dfp_expr_eval(const void* params, void* stream) {
  const Params& p = *(const Params*)params;
  if (p.n_code < 0 || p.n_code > MAX_CODE || p.n_out > MAX_OUTS) return (int)cudaErrorInvalidValue;
  if (p.n > 0) {
    i64 blocks = (p.n + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    expr_eval_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
