// Big-field arithmetic on 16-bit digit planes: one launch per call.
//
// No Pallas kernel corresponds.  The JAX package computes these functions
// as lax.scans over the digit count inside jit, which XLA fuses into a few
// device programs: ringo_tpu/ops/bigmul.py BigMul.mul_mod and reduce_cols
// (schoolbook columns, ripple, Barrett), ringo_tpu/fields/limb.py add,
// sub, neg and geq, and the tree sum of ringo_tpu/ops/horner.py.  The
// port's plain versions (ops/bigmul.py, fields/limb.py, ops/horner.py) run
// them eagerly, one launch per digit step: ~1,200 launches a product.
//
// Values are little-endian base-2^16 digit planes [w, ...] in int64 lanes.
// Every operand is read through its own element strides over up to four
// value dims (0 on a broadcast axis) and a digit stride, so a broadcast
// [w, 1] constant or a sliced view is never copied; the output is a
// contiguous [w, n].  The field's constants (p, mu = floor(B^(2w) / p)
// and B^(2w-1) mod p) travel by value in the launch's parameters.
//
// mul_mod and reduce_cols: one thread per lane computes the plain
// version's integers, digit for digit: the product x * y (column sums of
// 32-bit products kept in a 64-bit accumulator, which ripples one digit a
// column: the same digits as the plain version's lazy columns and ripple),
// the fold of reduce_cols above B^(2w-1), then HAC 14.42 Barrett: q_hat =
// floor(floor(z / B^(w-1)) * mu / B^(w+1)) mod B^(w+1), r = (z - q_hat * p)
// mod B^(w+2), two conditional subtractions of p.  Every truncation is the
// plain version's, so a digit plane outside [0, p) gives the same digits
// there too.  Templated on w for the seven fields (7, 8, 14, 15, 16, 28,
// 55): the loops are unrolled and the digits live in registers; at w = 55
// the column loops stay loops and their digits live in local memory
// (`-Xptxas -v`: a 672-byte stack frame for mul_mod, 912 for reduce_cols).
// tree_sum: grid-stride modular sums of canonical values into
// per-block partials (warp shuffles, then shared memory), a second launch
// reduces the partials; modular addition of values < p is exact and
// associative, so the order does not change the digits.  add, sub, neg,
// geq: one thread per lane, the plain version's carry and borrow chains
// in int64 over a digit count given at run time, inputs read twice (the
// first pass decides the selection, the second writes), q read through
// its pointer.
//
// What bounds it on the H100: bytes.  mul_mod at [16, 2^19] reads two
// int64 planes and writes one (201 MB, 0.060 ms at 3.35 TB/s) against
// ~2,000 32-bit operations a lane (~0.03 ms at the integer rate); the tree
// sum of [16, 1, 2^19] reads 67 MB (0.020 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 55;
// above this width the column loops stay loops (their digits then live in
// local memory): fully unrolled, w = 55 took ptxas 20 s for mul_mod alone
constexpr int kUnrollW = 32;
constexpr long long kMask = 0xFFFF;

// op codes and header slots: ringo_tpu_torch/fields/bigfield.py
enum Op { MUL_MOD = 0, REDUCE_COLS = 1, TREE_SUM = 2, ADD = 3, SUB = 4,
          NEG = 5, GEQ = 6 };
enum Slot { H_W = 0, H_N = 1, H_M = 2, H_MSTRIDE = 3, H_SHAPE = 4,
            H_OUT = 8, H_SCRATCH = 9, H_PARTS = 10, H_OPS = 11,
            H_OP_LEN = 6 };

struct Operand {
  const long long* ptr;
  long long dstride;     // elements between digit planes
  long long stride[4];   // elements per step of each value dim
};

struct Args {
  int w;                 // digits of the operation
  int m;                 // reduce_cols: columns; tree_sum: summed length
  unsigned n;            // output lanes
  int parts;             // tree_sum: partial sums per row
  unsigned shape[4];     // value dims, outermost first
  long long mstride;     // tree_sum: elements per step of the summed axis
  long long* out;
  unsigned* scratch;     // tree_sum: partials [w, n * parts]
  Operand op[3];
};

struct Consts {
  uint32_t p[kMaxW + 2];   // p's digits, two zero digits above
  uint32_t mu[kMaxW + 2];  // floor(B^(2w) / p)
  uint32_t bs[kMaxW];      // B^(2w-1) mod p
};

// element offsets of lane i in the first NOPS operands
template <int NOPS>
__device__ __forceinline__ void lane_offsets(const Args& a, unsigned i,
                                             long long (&off)[NOPS]) {
  const unsigned i3 = i % a.shape[3];
  i /= a.shape[3];
  const unsigned i2 = i % a.shape[2];
  i /= a.shape[2];
  const unsigned i1 = i % a.shape[1];
  const unsigned i0 = i / a.shape[1];
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    const long long* s = a.op[k].stride;
    off[k] = i0 * s[0] + i1 * s[1] + i2 * s[2] + i3 * s[3];
  }
}

// r = z mod p for the 2W+1 digits of z (HAC 14.42, the plain version's
// _barrett step for step); r has W+2 digits, the low W are the result.
template <int W>
__device__ __forceinline__ void barrett(const uint32_t (&z)[2 * W + 1],
                                        const Consts& c, uint32_t (&r)[W + 2]) {
  // q_hat: digits W+1 .. 2W+1 of zh * mu, zh = z[W-1 .. 2W]
  uint32_t qh[W + 1];
  uint64_t acc = 0;
#pragma unroll (W > kUnrollW ? 1 : 2 * W + 2)
  for (int col = 0; col <= 2 * W + 1; ++col) {
#pragma unroll
    for (int i = 0; i < W + 2; ++i) {
      const int j = col - i;
      if (j >= 0 && j < W + 2) acc += (uint64_t)z[W - 1 + i] * c.mu[j];
    }
    if (col >= W + 1) qh[col - W - 1] = (uint32_t)(acc & kMask);
    acc >>= 16;
  }
  // r = (z - q_hat * p) mod B^(W+2)
  acc = 0;
  int borrow = 0;
#pragma unroll (W > kUnrollW ? 1 : W + 2)
  for (int col = 0; col < W + 2; ++col) {
#pragma unroll
    for (int i = 0; i < W + 1; ++i) {
      const int j = col - i;
      if (j >= 0 && j < W) acc += (uint64_t)qh[i] * c.p[j];
    }
    const int s = (int)z[col] - (int)(acc & kMask) - borrow;
    acc >>= 16;
    r[col] = (uint32_t)s & kMask;
    borrow = s < 0;
  }
  // two conditional subtractions of p (W+2 digits)
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    uint32_t d[W + 2];
    borrow = 0;
#pragma unroll
    for (int j = 0; j < W + 2; ++j) {
      const int s = (int)r[j] - (int)c.p[j] - borrow;
      d[j] = (uint32_t)s & kMask;
      borrow = s < 0;
    }
    if (!borrow) {
#pragma unroll
      for (int j = 0; j < W + 2; ++j) r[j] = d[j];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(128)
mul_mod_kernel(const Args a, const Consts c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  long long off[2];
  lane_offsets<2>(a, i, off);
  uint32_t x[W], y[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    x[j] = (uint32_t)a.op[0].ptr[off[0] + j * a.op[0].dstride];
    y[j] = (uint32_t)a.op[1].ptr[off[1] + j * a.op[1].dstride];
  }
  // z = x * y: 2W column sums rippled to 2W+1 digits
  uint32_t z[2 * W + 1];
  uint64_t acc = 0;
#pragma unroll (W > kUnrollW ? 1 : 2 * W)
  for (int col = 0; col < 2 * W; ++col) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = col - k;
      if (j >= 0 && j < W) acc += (uint64_t)x[k] * y[j];
    }
    z[col] = (uint32_t)(acc & kMask);
    acc >>= 16;
  }
  z[2 * W] = (uint32_t)(acc & kMask);
  uint32_t r[W + 2];
  barrett<W>(z, c, r);
#pragma unroll
  for (int j = 0; j < W; ++j) a.out[(long long)j * a.n + i] = r[j];
}

template <int W>
__global__ void __launch_bounds__(128)
reduce_cols_kernel(const Args a, const Consts c) {
  constexpr int S = 2 * W - 1;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  long long off[1];
  lane_offsets<1>(a, i, off);
  const long long* col = a.op[0].ptr + off[0];
  const long long ds = a.op[0].dstride;
  const int m = a.m;
  // z = ripple(cols, m + 1): low digits z[0 .. S-1], high digits z[S ..];
  // above z[S + 2W] nothing reaches the 2W+1 digits kept below
  uint32_t lo[S], hi[2 * W + 1];
  long long carry = 0;
#pragma unroll
  for (int j = 0; j < S + 2 * W + 1; ++j) {
    uint32_t d = 0;
    if (j < m) {
      const long long s = col[j * ds] + carry;
      d = (uint32_t)(s & kMask);
      carry = s >> 16;
    } else if (j == m) {
      d = (uint32_t)(carry & kMask);
    }
    if (j < S) lo[j] = d; else hi[j - S] = d;
  }
  // z' = (z mod B^S + floor(z / B^S) * (B^S mod p)) mod B^(2W+1)
  uint32_t z[2 * W + 1];
  uint64_t acc = 0;
  const bool fold = m + 1 > S;
#pragma unroll (W > kUnrollW ? 1 : 2 * W + 1)
  for (int k = 0; k <= 2 * W; ++k) {
    if (k < S) acc += lo[k];
    if (fold) {
#pragma unroll
      for (int t = 0; t <= 2 * W; ++t) {
        const int j = k - t;
        if (j >= 0 && j < W) acc += (uint64_t)hi[t] * c.bs[j];
      }
    }
    z[k] = (uint32_t)(acc & kMask);
    acc >>= 16;
  }
  uint32_t r[W + 2];
  barrett<W>(z, c, r);
#pragma unroll
  for (int j = 0; j < W; ++j) a.out[(long long)j * a.n + i] = r[j];
}

// acc = (acc + v) mod p for canonical acc, v (limb.add's steps)
template <int W>
__device__ __forceinline__ void add_mod(uint32_t (&acc)[W],
                                        const uint32_t (&v)[W],
                                        const Consts& c) {
  uint32_t t[W], d[W];
  uint32_t carry = 0;
  int borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint32_t s = acc[j] + v[j] + carry;
    t[j] = s & kMask;
    carry = s >> 16;
    const int e = (int)t[j] - (int)c.p[j] - borrow;
    d[j] = (uint32_t)e & kMask;
    borrow = e < 0;
  }
  const bool use_d = carry != 0 || !borrow;
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = use_d ? d[j] : t[j];
}

// the sum mod p of the block's values, valid in thread 0; blockDim.x a
// multiple of 32, at most 1024
template <int W>
__device__ __forceinline__ void block_sum(uint32_t (&acc)[W], const Consts& c) {
  __shared__ uint32_t warp_sums[32][W];
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    uint32_t o[W];
#pragma unroll
    for (int j = 0; j < W; ++j) o[j] = __shfl_down_sync(0xFFFFFFFFu, acc[j], sh);
    add_mod<W>(acc, o, c);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) warp_sums[warp][j] = acc[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = lane < nw ? warp_sums[lane][j] : 0u;
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) {
      uint32_t o[W];
#pragma unroll
      for (int j = 0; j < W; ++j) o[j] = __shfl_down_sync(0xFFFFFFFFu, acc[j], sh);
      add_mod<W>(acc, o, c);
    }
  }
}

constexpr int kSumThreads = 256;

// pass 1: block b of row r sums elements part, part + parts * 256, ... of
// the row into the partial scratch[:, r * parts + part]
template <int W>
__global__ void __launch_bounds__(kSumThreads)
tree_sum_partials(const Args a, const Consts c) {
  const unsigned row = blockIdx.x / a.parts;
  const unsigned part = blockIdx.x % a.parts;
  long long off[1];
  lane_offsets<1>(a, row, off);
  const long long* x = a.op[0].ptr + off[0];
  const long long ds = a.op[0].dstride;
  uint32_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  for (long long e = (long long)part * kSumThreads + threadIdx.x; e < a.m;
       e += (long long)a.parts * kSumThreads) {
    uint32_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = (uint32_t)x[e * a.mstride + j * ds];
    add_mod<W>(acc, v, c);
  }
  block_sum<W>(acc, c);
  if (threadIdx.x == 0) {
    const long long np = (long long)a.n * a.parts;
#pragma unroll
    for (int j = 0; j < W; ++j) a.scratch[j * np + blockIdx.x] = acc[j];
  }
}

// pass 2: block r sums row r's partials into out[:, r]
template <int W>
__global__ void __launch_bounds__(kSumThreads)
tree_sum_rows(const Args a, const Consts c) {
  const long long np = (long long)a.n * a.parts;
  const unsigned* s = a.scratch + (long long)blockIdx.x * a.parts;
  uint32_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  for (int e = threadIdx.x; e < a.parts; e += kSumThreads) {
    uint32_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = s[j * np + e];
    add_mod<W>(acc, v, c);
  }
  block_sum<W>(acc, c);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) a.out[(long long)j * a.n + blockIdx.x] = acc[j];
  }
}

// limb.add / sub / neg / geq, the plain version's int64 steps: a digit is
// s & 0xFFFF, a carry s >> 16, a borrow s < 0
__global__ void __launch_bounds__(256)
limb_kernel(const Args a, int op) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  // operands: a, b, q (add, sub); a, q (neg); a, b (geq)
  long long off[3];
  lane_offsets<3>(a, i, off);
  const bool two = op == NEG || op == GEQ;
  const long long* A = a.op[0].ptr + off[0];
  const long long* B = a.op[1].ptr + off[1];
  const long long* Q = two ? B : a.op[2].ptr + off[2];
  const long long da = a.op[0].dstride, db = a.op[1].dstride,
                  dq = two ? db : a.op[2].dstride;
  const int w = a.w;
  long long* out = a.out + i;
  if (op == ADD) {
    // t = a + b (carry out top), t - q; keep t - q where top or no borrow
    long long carry = 0, borrow = 0;
    for (int j = 0; j < w; ++j) {
      const long long s = A[j * da] + B[j * db] + carry;
      carry = s >> 16;
      const long long e = (s & kMask) - Q[j * dq] - borrow;
      borrow = e < 0;
    }
    const bool use_d = carry != 0 || borrow == 0;
    carry = 0;
    borrow = 0;
    for (int j = 0; j < w; ++j) {
      const long long s = A[j * da] + B[j * db] + carry;
      carry = s >> 16;
      const long long e = (s & kMask) - Q[j * dq] - borrow;
      borrow = e < 0;
      out[(long long)j * a.n] = use_d ? (e & kMask) : (s & kMask);
    }
  } else if (op == SUB) {
    // d = a - b; d + q where it borrowed
    long long borrow = 0;
    for (int j = 0; j < w; ++j) borrow = A[j * da] - B[j * db] - borrow < 0;
    const bool fix = borrow != 0;
    long long carry = 0;
    borrow = 0;
    for (int j = 0; j < w; ++j) {
      const long long s = A[j * da] - B[j * db] - borrow;
      borrow = s < 0;
      const long long f = (s & kMask) + Q[j * dq] + carry;
      carry = f >> 16;
      out[(long long)j * a.n] = fix ? (f & kMask) : (s & kMask);
    }
  } else if (op == NEG) {
    // q - a, 0 where a is 0
    bool zero = true;
    for (int j = 0; j < w; ++j) zero = zero && A[j * da] == 0;
    long long borrow = 0;
    for (int j = 0; j < w; ++j) {
      const long long s = Q[j * dq] - A[j * da] - borrow;
      borrow = s < 0;
      out[(long long)j * a.n] = zero ? 0 : (s & kMask);
    }
  } else {
    // a >= b: no borrow out of a - b
    long long borrow = 0;
    for (int j = 0; j < w; ++j) borrow = A[j * da] - B[j * db] - borrow < 0;
    reinterpret_cast<uint8_t*>(a.out)[i] = borrow == 0;
  }
}

template <int W>
int launch(int op, const Args& a, const Consts& c, cudaStream_t st) {
  const unsigned grid = (a.n + 127) / 128;
  if (op == MUL_MOD) {
    mul_mod_kernel<W><<<grid, 128, 0, st>>>(a, c);
  } else if (op == REDUCE_COLS) {
    reduce_cols_kernel<W><<<grid, 128, 0, st>>>(a, c);
  } else {
    tree_sum_partials<W><<<a.n * a.parts, kSumThreads, 0, st>>>(a, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tree_sum_rows<W><<<a.n, kSumThreads, 0, st>>>(a, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: the Op above; hdr: host int64 header (the Slot layout above);
// consts: host int64 [3w + 4], p's digits (w + 2), mu's (w + 2) and
// B^(2w-1) mod p's (w), or NULL for the limb ops.  Returns the CUDA error
// of the launch (0 = success).
extern "C" int ringo_bigfield(int op, const long long* hdr,
                              const long long* consts, void* stream) {
  Args a;
  a.w = (int)hdr[H_W];
  a.n = (unsigned)hdr[H_N];
  a.m = (int)hdr[H_M];
  a.mstride = hdr[H_MSTRIDE];
  for (int k = 0; k < 4; ++k) {
    a.shape[k] = (unsigned)hdr[H_SHAPE + k];
    if (a.shape[k] == 0) return (int)cudaErrorInvalidValue;
  }
  a.out = (long long*)hdr[H_OUT];
  a.scratch = (unsigned*)hdr[H_SCRATCH];
  a.parts = (int)hdr[H_PARTS];
  for (int k = 0; k < 3; ++k) {
    const long long* o = hdr + H_OPS + H_OP_LEN * k;
    a.op[k].ptr = (const long long*)o[0];
    a.op[k].dstride = o[1];
    for (int d = 0; d < 4; ++d) a.op[k].stride[d] = o[2 + d];
  }
  if (a.n == 0 || a.w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (op >= ADD && op <= GEQ) {
    limb_kernel<<<(a.n + 255) / 256, 256, 0, st>>>(a, op);
    return (int)cudaGetLastError();
  }
  if (op < MUL_MOD || op > TREE_SUM || consts == nullptr || a.w > kMaxW ||
      (op == TREE_SUM && (a.parts <= 0 || a.m <= 0)))
    return (int)cudaErrorInvalidValue;
  Consts c = {};
  for (int j = 0; j < a.w + 2; ++j) {
    c.p[j] = (uint32_t)consts[j];
    c.mu[j] = (uint32_t)consts[a.w + 2 + j];
  }
  for (int j = 0; j < a.w; ++j) c.bs[j] = (uint32_t)consts[2 * a.w + 4 + j];
  switch (a.w) {
    case 7: return launch<7>(op, a, c, st);
    case 8: return launch<8>(op, a, c, st);
    case 14: return launch<14>(op, a, c, st);
    case 15: return launch<15>(op, a, c, st);
    case 16: return launch<16>(op, a, c, st);
    case 28: return launch<28>(op, a, c, st);
    case 55: return launch<55>(op, a, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
