// Big-field arithmetic on 16-bit digit planes: one launch per call.
//
// No Pallas kernel corresponds.  The JAX package computes these functions
// as lax.scans over the digit count inside jit, which XLA fuses into a few
// device programs: ringo_tpu/ops/bigmul.py BigMul.mul_mod and reduce_cols
// (schoolbook columns, ripple, Barrett), ringo_tpu/fields/limb.py add,
// sub, neg and geq, and ringo_tpu/ops/horner.py's evaluation
// (horner_eval_traced: powers by doubling, products, tree sum) and powers.
// The port's plain versions (ops/bigmul.py, fields/limb.py,
// ops/horner.py) run them eagerly, one launch per digit step: ~1,200
// launches a product.
//
// Values are little-endian base-2^16 digit planes [w, ...] in int64 lanes.
// Every operand is read through its own element strides over up to four
// value dims (0 on a broadcast axis) and a digit stride, so a broadcast
// [w, 1] constant or a sliced view is never copied; the output is a
// contiguous [w, n].  The field's constants (p, mu = floor(B^(2w) / p)
// and B^(2w-1) mod p) travel by value in the launch's parameters.
//
// One Barrett product serves every kernel that multiplies: each thread
// computes the plain version's integers for one lane on 32-bit words (word
// k holds digits 2k and 2k + 1; a w-digit value takes ceil(w / 2) words):
// the product (mul_words), for reduce_cols the fold above B^(2w-1), for
// Horner's step the addend in the low words, then HAC 14.42 Barrett
// (barrett_words) with the plain version's mu = floor(B^(2w) / p): q_hat =
// floor(floor(z / B^(w-1)) * mu / B^(w+1)) mod B^(w+1), r = (z - q_hat *
// p) mod B^(w+2), two conditional subtractions of p on w + 2 digits.
// Shifts by an odd digit count are funnel shifts, and every truncation is
// the plain version's, at its digit, so any input the plain version takes
// (digit planes >= p, m = 4w + 3 columns of up to 2^23) gives the same
// digits (section below).  Templated on w for the seven fields (7, 8, 14,
// 15, 16, 28, 55): fully unrolled, the words in registers.
// add, sub, neg, geq: one thread per lane, the plain version's carry and
// borrow chains in int64 over a digit count given at run time, inputs read
// twice (the first pass decides the selection, the second writes), q read
// through its pointer.
//
// tree_sum, horner and powers are one launch each.  tree_sum: grid-stride
// column sums of the digits into per-block partials (warp shuffles, then
// shared memory; carried into 16-bit digits only where a column could
// overflow, no modular addition); the last block of a row to finish, by a
// ticket counter, adds the row's partials, reduces the value mod p once and
// resets the counter.  horner: sum_i v[i] * x^i mod
// p for t rows at once with one multiply-add mod p a coefficient (Horner's
// rule in x^S over a lane's coefficients i = g mod S) and the lane weights
// x^g from three small shared tables, the same last-block finish; no power
// plane and no product plane goes to device memory (section below).
// powers: x^0 .. x^(n-1) from the same tables, one product an element.
// Modular arithmetic on values below p is exact and associative, and
// barrett_words reduces any x * y + a < B^(2w), so the digits equal the
// plain composition's (powers by doubling, products, tree sum) for any
// order.
//
// What bounds it on the H100.  mul_mod at [16, 2^19] reads two int64
// planes and writes one (201 MB, 0.060 ms at 3.35 TB/s) against 189 word
// products a lane (756 32-bit operations, 0.012 ms at the integer rate):
// bytes, as for reduce_cols at BigLinMap's 2w + 1 columns.  The
// tree sum of [16, 1, 2^19] reads 67 MB (0.020 ms): bytes.  horner at
// [16, 1, 2^19] reads the same 67 MB and does 2^19 multiply-adds mod p,
// 189 word products each (0.012 ms at the integer rate): bytes too.
// powers at [14, 2^15] writes 3.7 MB (0.0011 ms) after its tables: a
// chain of products a lane and the launch set its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 55;
constexpr int kMaxWords = (kMaxW + 3) / 2;   // words of w + 2 digits
constexpr long long kMask = 0xFFFF;

// op codes and header slots: ringo_tpu_torch/fields/bigfield.py
enum Op { MUL_MOD = 0, REDUCE_COLS = 1, TREE_SUM = 2, ADD = 3, SUB = 4,
          NEG = 5, GEQ = 6, HORNER = 7, POWERS = 8 };
enum Slot { H_W = 0, H_N = 1, H_M = 2, H_MSTRIDE = 3, H_SHAPE = 4,
            H_PARTS = 8, H_AUX = 9, H_OPS = 10, H_OP_LEN = 5 };

struct Operand {
  const long long* ptr;
  long long dstride;     // elements between digit planes
  long long stride[4];   // elements per step of each value dim
};

struct Args {
  int w;                 // digits of the operation
  long long m;           // reduce_cols: columns; tree_sum: summed length;
                         // horner, powers: coefficients
  unsigned n;            // output lanes (horner: rows)
  int parts;             // tree_sum: partial sums per row; horner, powers:
                         // blocks per row (a power of two)
  unsigned shape[4];     // value dims, outermost first
  long long mstride;     // tree_sum, horner: elements per step of the
                         // summed axis
  long long* out;
  unsigned* scratch;     // tree_sum: partials [w, n * parts]; horner:
                         // [n, parts, w]
  unsigned* count;       // tree_sum, horner: a zeroed ticket counter a row
  int aux;               // tree_sum: 16-byte pair loads; horner, powers:
                         // step count logn (op[1]: steps [logn, w])
  Operand op[3];
};

struct Consts {
  uint32_t p[kMaxW + 2];   // p's digits, two zero digits above
  uint32_t mu[kMaxW + 2];  // floor(B^(2w) / p)
  uint32_t bs[kMaxW];      // B^(2w-1) mod p
};

// the same constants on 32-bit words (the products), zero above
struct Words {
  uint32_t p[kMaxWords];   // p (w + 2 digits)
  uint32_t mu[kMaxWords];  // mu (w + 2 digits)
  uint32_t bs[kMaxWords];  // B^(2w-1) mod p (w digits)
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

// ------------------------------------------- mul_mod and reduce_cols on words
//
// The plain version's integers on 32-bit words, word k holding digits 2k
// (low half) and 2k + 1; a w-digit value takes H = ceil(w / 2) words.  A
// product is product scanning: column k's 32 x 32 -> 64-bit products go
// into a three-word accumulator, each by one self-contained carry chain
// (mad.lo.cc, madc.hi.cc, addc), and the accumulator moves up a word a
// column; of the top column kept only the low word is needed, so its
// products are plain 32-bit multiply-adds.  ceil(w/2)^2 word products
// replace w^2 digit products.  Barrett (barrett_words) keeps the plain
// version's truncations at their digits:
//   zh = floor(z / B^(w-1))            (a funnel shift where w - 1 is odd)
//   q_hat = floor(zh * mu / B^(w+1)) mod B^(w+1)   (product words 0 .. w)
//   r = (z - q_hat * p) mod B^(w+2), then r - p twice where no borrow on
//       w + 2 digits, and the low w digits out.
// reduce_cols ripples its int64 columns in 64-bit, as the plain version
// does, packing the digits into words as they come (mod B^(m+1)); where m +
// 1 > 2w - 1 it folds z' = (z mod B^(2w-1) + hi * (B^(2w-1) mod p)) mod
// B^(2w+1), hi = floor(z / B^(2w-1)) mod B^(2w+1), by rows of hi's words
// (only those the m columns reach: 2 at BigLinMap's 2w + 1), and reduces z'.
//
// Latency: a thread loads its lane's digits (the low 32-bit word of each
// int64, one LDG each) before its first product; at 46-78 registers (w <=
// 16) 8 blocks of 128 threads an SM hold a Buckler shape's lanes in one
// wave, and the warps' loads, products and stores overlap.  Two lanes a
// thread (the second's loads arriving under the first's products), 64 or
// 256 threads a block measured no faster (PERF.md).  No local memory at
// any width (-Xptxas -v, chip_smoke.py's register log).

constexpr int kWordThreads = 128;

// (c2:c1:c0) += a * b, one carry chain
__device__ __forceinline__ void mac(uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                    uint32_t a, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(a), "r"(b));
}

// out = a * b mod 2^(32 NO): a[i] (i < NA), b[j] (j < NB), product scanning
template <int NA, int NB, int NO, class A, class B>
__device__ __forceinline__ void mul_words(const A& a, const B& b,
                                          uint32_t (&out)[NO]) {
  uint32_t c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < NO; ++k) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = k - i;
      if (j >= 0 && j < NB) {
        if (k == NO - 1) c0 += a[i] * b[j];
        else mac(c0, c1, c2, a[i], b[j]);
      }
    }
    out[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
}

// out = floor(v / B^S) mod 2^(32 NO) for the NI words v (zero above)
template <int S, int NI, int NO>
__device__ __forceinline__ void shr_digits(const uint32_t (&v)[NI],
                                           uint32_t (&out)[NO]) {
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const int o = S / 2 + k;
    const uint32_t lo = o < NI ? v[o] : 0u;
    if (S % 2 == 0) {
      out[k] = lo;
    } else {
      const uint32_t hi = o + 1 < NI ? v[o + 1] : 0u;
      out[k] = __funnelshift_r(lo, hi, 16);
    }
  }
}

// v mod B^D for the ceil(D / 2) words v
template <int D, int N>
__device__ __forceinline__ void keep_digits(uint32_t (&v)[N]) {
  static_assert(N == (D + 1) / 2, "keep_digits: word count");
  if (D % 2) v[D / 2] &= 0xFFFFu;
}

// r = (a - b) mod 2^(32 N); returns the borrow out
template <int N, class A, class B>
__device__ __forceinline__ uint32_t sub_words(const A& a, const B& b,
                                              uint32_t (&r)[N]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint64_t t = (uint64_t)a[k] - b[k] - borrow;
    r[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// r = z mod p for z (NZ words, zero above) < B^(2W+1): the plain
// version's _barrett on words; r holds W + 2 digits, the low W the result
template <int W, int NZ>
__device__ __forceinline__ void barrett_words(const uint32_t (&z)[NZ],
                                              const Words& c,
                                              uint32_t (&r)[(W + 3) / 2]) {
  constexpr int H = (W + 1) / 2, HQ = (W + 2) / 2, HZ = (W + 3) / 2;
  uint32_t zh[HZ];                   // floor(z / B^(W-1)), W + 2 digits
  shr_digits<W - 1>(z, zh);
  uint32_t q[W + 1];                 // zh * mu mod B^(2W+2)
  mul_words<HZ, HZ, W + 1>(zh, c.mu, q);
  uint32_t qh[HQ];                   // q_hat: digits W+1 .. 2W+1 of q, so
  shr_digits<W + 1>(q, qh);          // mod B^(W+1) (q has no word W+1)
  uint32_t qp[HZ], zl[HZ];           // q_hat * p, z mod B^(W+2)
  mul_words<HQ, H, HZ>(qh, c.p, qp);
#pragma unroll
  for (int k = 0; k < HZ; ++k) zl[k] = k < NZ ? z[k] : 0u;
  sub_words<HZ>(zl, qp, r);
  keep_digits<W + 2>(r);
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    uint32_t d[HZ];
    if (!sub_words<HZ>(r, c.p, d)) {
#pragma unroll
      for (int k = 0; k < HZ; ++k) r[k] = d[k];
    }
  }
}

// the W digits at x (digit stride dstride), packed into words: the low
// 32-bit word of each int64 digit (< 2^16), two digits a word
template <int W>
__device__ __forceinline__ void load_words(const long long* x, long long dstride,
                                           uint32_t (&v)[(W + 1) / 2]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(x);
  const long long ds = 2 * dstride;
#pragma unroll
  for (int k = 0; k < (W + 1) / 2; ++k) {
    const uint32_t lo = __ldg(p + (2 * k) * ds);
    const uint32_t hi = 2 * k + 1 < W ? __ldg(p + (2 * k + 1) * ds) : 0u;
    v[k] = __byte_perm(lo, hi, 0x5410);
  }
}

// the low W digits of r into the contiguous [W, n] output, lane i
template <int W, int N>
__device__ __forceinline__ void store_words(const Args& a, unsigned i,
                                             const uint32_t (&r)[N]) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    a.out[(long long)j * a.n + i] = (r[j / 2] >> (16 * (j % 2))) & 0xFFFFu;
}

// register caps 65,536 / (128 threads x blocks): 128 at w <= 16, then 255
#define WORD_MIN_BLOCKS(W) ((W) <= 16 ? 4 : (W) <= 28 ? 2 : 1)

template <int W>
__global__ void __launch_bounds__(kWordThreads, WORD_MIN_BLOCKS(W))
mul_mod_kernel(const Args a, const Words c) {
  constexpr int H = (W + 1) / 2;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  long long off[2];
  lane_offsets<2>(a, i, off);
  uint32_t x[H], y[H];
  load_words<W>(a.op[0].ptr + off[0], a.op[0].dstride, x);
  load_words<W>(a.op[1].ptr + off[1], a.op[1].dstride, y);
  uint32_t z[2 * H];
  mul_words<H, H, 2 * H>(x, y, z);
  uint32_t r[(W + 3) / 2];
  barrett_words<W>(z, c, r);
  store_words<W>(a, i, r);
}

template <int W>
__global__ void __launch_bounds__(kWordThreads, WORD_MIN_BLOCKS(W))
reduce_cols_kernel(const Args a, const Words c) {
  constexpr int S = 2 * W - 1, ND = 4 * W, H = (W + 1) / 2;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  // digits past ND - 1 = S + 2W reach none of the 2W + 1 digits of z'
  const int m = (int)(a.m < ND ? a.m : ND);
  // hi's words that the m columns reach (none without a fold)
  const int hw = m + 1 > S ? ((m + 1 < ND ? m + 1 : ND) - S + 1) / 2 : 0;
  const long long ds = a.op[0].dstride;
  long long off[1];
  lane_offsets<1>(a, i, off);
  const long long* col = a.op[0].ptr + off[0];
  // z = ripple(cols, m + 1) mod B^ND, in 64-bit, two digits a word
  uint32_t z[2 * W];
  long long carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) {
    uint32_t d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * k + h;
      d[h] = 0;
      if (j < m) {
        const long long s = __ldg(col + j * ds) + carry;
        d[h] = (uint32_t)(s & kMask);
        carry = s >> 16;
      } else if (j == m) {
        d[h] = (uint32_t)(carry & kMask);
      }
    }
    z[k] = d[0] | d[1] << 16;
  }
  // hi = floor(z / B^S) mod B^(2W+1) (z stops at digit S + 2W); f = hi *
  // bs mod B^(2W+1) by rows i < hw: row i adds into f[i .. i+H-1] and
  // writes its carry to the word f[i+H], which no earlier row reached
  // (t < 2^64: a 32 x 32-bit product plus two words)
  uint32_t hi[W + 1], f[W + 1];
  shr_digits<S>(z, hi);
#pragma unroll
  for (int k = 0; k <= W; ++k) f[k] = 0;
#pragma unroll
  for (int row = 0; row <= W; ++row) {
    if (row < hw) {
      uint32_t up = 0;
#pragma unroll
      for (int j = 0; j < H && row + j <= W; ++j) {
        const uint64_t t = (uint64_t)hi[row] * c.bs[j] + f[row + j] + up;
        f[row + j] = (uint32_t)t;
        up = (uint32_t)(t >> 32);
      }
      if (row + H <= W) f[row + H] = up;
    }
  }
  // z' = (z mod B^S + f) mod B^(2W+1)
  uint32_t zf[W + 1];
  uint32_t cy = 0;
#pragma unroll
  for (int k = 0; k <= W; ++k) {
    const uint32_t lo = k < W - 1 ? z[k] : k == W - 1 ? z[k] & 0xFFFFu : 0u;
    const uint64_t t = (uint64_t)lo + f[k] + cy;
    zf[k] = (uint32_t)t;
    cy = (uint32_t)(t >> 32);
  }
  keep_digits<2 * W + 1>(zf);
  uint32_t r[(W + 3) / 2];
  barrett_words<W>(zf, c, r);
  store_words<W>(a, i, r);
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

// Whether this block is the last of ``blocks`` to finish row ``row``: thread
// 0 publishes the block's partial (written before the call) and takes a
// ticket; the last block reads every partial and resets the counter for the
// next launch (finish_row).  No second launch and no host sync.
__device__ __forceinline__ bool last_of_row(unsigned* count, unsigned row,
                                            unsigned blocks) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(count + row, 1u) == blocks - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

// the last block's sum of ``parts`` partials [W] at s, s + stride, ... (read
// through L2: other blocks wrote them) into out[:, row] (n rows)
template <int W>
__device__ __forceinline__ void finish_row(const Args& a, const Consts& c,
                                           const unsigned* s, long long stride,
                                           long long dstride, unsigned row) {
  uint32_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  for (int e = threadIdx.x; e < a.parts; e += blockDim.x) {
    uint32_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = __ldcg(s + e * stride + j * dstride);
    add_mod<W>(acc, v, c);
  }
  block_sum<W>(acc, c);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) a.out[(long long)j * a.n + row] = acc[j];
    a.count[row] = 0;
  }
}

// The tree sum adds digits, not residues: a thread adds digit j of each of
// its values into a 32-bit column sum S[j], with no carry and no
// comparison with p, and carries the columns into 16-bit digits only where
// a column could pass 2^31 (every kFold values, at the thread's end, for
// the block's and the row's sums).  A sum of fewer than 2^31 values below
// p is below 2^31 p < B^(W+2), so W + 2 digits hold every partial; the
// row's last block reduces the row's value mod p once (barrett_words).
constexpr int kFold = 1 << 15;   // S[j] < 2^16 + kFold * (2^16 - 1) < 2^32

// the column sums s (each < 2^32 - 2^16) as N 16-bit digits of the same
// value; the caller's bound on the value keeps the carry out of the top 0
template <int N>
__device__ __forceinline__ void carry_digits(uint32_t (&s)[N]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t t = s[j] + c;
    s[j] = t & kMask;
    c = t >> 16;
  }
}

// the block's column sums of digit vectors (each column < 2^16), valid in
// thread 0: < 2^16 * 1024 = 2^26
template <int N>
__device__ __forceinline__ void block_add(uint32_t (&s)[N]) {
  __shared__ uint32_t warp_sums[32][N];
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] += __shfl_down_sync(0xFFFFFFFFu, s[j], sh);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) warp_sums[warp][j] = s[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = lane < nw ? warp_sums[lane][j] : 0u;
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) s[j] += __shfl_down_sync(0xFFFFFFFFu, s[j], sh);
    }
  }
}

// block b of row r adds elements part, part + parts * 256, ... of the row
// (with aux, pairs of neighbours in 16-byte loads) into the partial
// scratch[:, r * parts + part], W + 2 digits; the row's last block adds
// the partials and reduces the sum mod p
template <int W>
__global__ void __launch_bounds__(kSumThreads)
tree_sum_kernel(const Args a, const Words c) {
  constexpr int D = W + 2;
  const unsigned row = blockIdx.x / a.parts;
  const unsigned part = blockIdx.x % a.parts;
  long long off[1];
  lane_offsets<1>(a, row, off);
  const long long* x = a.op[0].ptr + off[0];
  const long long ds = a.op[0].dstride;
  const long long step = (long long)a.parts * kSumThreads;
  uint32_t s[D];
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = 0;
  int since = 0;   // values added since the last carry
  long long e = (long long)part * kSumThreads + threadIdx.x;
  if (a.aux) {
    for (; 2 * e + 1 < a.m; e += step) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const longlong2 d = reinterpret_cast<const longlong2*>(x + j * ds)[e];
        s[j] += (uint32_t)d.x + (uint32_t)d.y;
      }
      if ((since += 2) >= kFold) {
        carry_digits<D>(s);
        since = 0;
      }
    }
    e = 2 * e < a.m ? 2 * e : a.m;   // the odd last element, if this lane's
  }
  for (; e < a.m; e += step) {
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] += (uint32_t)x[e * a.mstride + j * ds];
    if (++since >= kFold) {
      carry_digits<D>(s);
      since = 0;
    }
  }
  carry_digits<D>(s);
  block_add<D>(s);
  const long long np = (long long)a.n * a.parts;
  if (threadIdx.x == 0) {
    carry_digits<D>(s);
#pragma unroll
    for (int j = 0; j < D; ++j) a.scratch[j * np + blockIdx.x] = s[j];
  }
  if (!last_of_row(a.count, row, a.parts)) return;
  const unsigned* ps = a.scratch + (long long)row * a.parts;
#pragma unroll
  for (int j = 0; j < D; ++j) s[j] = 0;
  for (int k = threadIdx.x; k < a.parts; k += blockDim.x) {
#pragma unroll
    for (int j = 0; j < D; ++j) s[j] += __ldcg(ps + k + j * np);
  }
  block_add<D>(s);
  if (threadIdx.x == 0) {
    carry_digits<D>(s);
    uint32_t z[(D + 1) / 2], r[(W + 3) / 2];
#pragma unroll
    for (int k = 0; k < (D + 1) / 2; ++k)
      z[k] = s[2 * k] | (2 * k + 1 < D ? s[2 * k + 1] << 16 : 0u);
    barrett_words<W>(z, c, r);
#pragma unroll
    for (int j = 0; j < W; ++j)
      a.out[(long long)j * a.n + row] = (r[j / 2] >> (16 * (j % 2))) & kMask;
    a.count[row] = 0;
  }
}

// ------------------------------------- Horner's evaluation, the powers of x
//
// Thread g of a row (g < S = blocks * T, a power of two) owns coefficients
// g, g + S, g + 2S, ... and runs Horner's rule in u = x^S over them from
// the top: acc = acc * u + v (one mul_add_words a coefficient, the next
// coefficient loaded ahead; the first enters as it is, since barrett_words
// takes any acc * u + v < B^(2W) <= B^(2W+1)).  Its weight x^g = x^lane * x^(32 warp) * x^(bT)
// comes from three small tables that three warps build by the step digits
// x^(2^k) while the others start: x^l for l < 32, x^(32m) for m < T/32,
// the block's base x^(bT) as a product tree over the set bits of b.  acc *
// x^lane is summed over the warp, times x^(32 warp) over the block, times
// the base; the row's last block sums the partials.  POWERS: thread g
// writes x^g (two products from the tables) and steps by u.
//
// Every value of these two kernels is held in words (H = ceil(W / 2), as
// mul_mod_kernel holds them) and every product is mul_words then
// barrett_words, inlined: the steps, the tables and u live in registers
// and shared memory, none in local memory at w <= 28 (chip_smoke.py's
// register log).  The modular sums stay on digits (add_mod, shared with
// the tree sum and the last block's finish): a thread unpacks its words
// once, after its lane weight, and packs them again for the warp and block
// weights.

#define HORNER_THREADS(W) ((W) > 32 ? 128 : 256)

template <int W, int T>
struct PowTables {
  uint32_t lo[32][(W + 1) / 2];       // x^l
  uint32_t hi[T / 32][(W + 1) / 2];   // x^(32m)
  uint32_t base[(W + 1) / 2];         // x^(bT)
  uint32_t st[32][(W + 1) / 2];       // x^(2^k), 1 for k >= logn
};

// r = (x * y + v) mod p (v only where ADD) for x, y, v < B^W: the product's
// 2H words, v added into the low H, then barrett_words (x * y + v <
// B^(2W), so its result is below p); the low H words out.  r may alias x,
// y or v.
template <int W, bool ADD>
__device__ __forceinline__ void mul_add_words(const uint32_t (&x)[(W + 1) / 2],
                                              const uint32_t (&y)[(W + 1) / 2],
                                              const uint32_t (&v)[(W + 1) / 2],
                                              const Words& c,
                                              uint32_t (&r)[(W + 1) / 2]) {
  constexpr int H = (W + 1) / 2;
  uint32_t z[2 * H];
  mul_words<H, H, 2 * H>(x, y, z);
  if (ADD) {
    uint32_t cy = 0;
#pragma unroll
    for (int k = 0; k < 2 * H; ++k) {
      const uint64_t t = (uint64_t)z[k] + (k < H ? v[k] : 0u) + cy;
      z[k] = (uint32_t)t;
      cy = (uint32_t)(t >> 32);
    }
  }
  uint32_t t[(W + 3) / 2];   // < p: digits W, W + 1 are 0
  barrett_words<W>(z, c, t);
#pragma unroll
  for (int k = 0; k < H; ++k) r[k] = t[k];
}

template <int W>
__device__ __forceinline__ void mul_mod_words(const uint32_t (&x)[(W + 1) / 2],
                                              const uint32_t (&y)[(W + 1) / 2],
                                              const Words& c,
                                              uint32_t (&r)[(W + 1) / 2]) {
  mul_add_words<W, false>(x, y, y, c, r);
}

template <int N>
__device__ __forceinline__ void copy_words(uint32_t (&d)[N], const uint32_t (&s)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) d[k] = s[k];
}

template <int N>
__device__ __forceinline__ void set_one(uint32_t (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = k == 0;
}

// the W digits of the words v, and back
template <int W>
__device__ __forceinline__ void unpack_digits(const uint32_t (&v)[(W + 1) / 2],
                                              uint32_t (&d)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) d[j] = (v[j / 2] >> (16 * (j % 2))) & 0xFFFFu;
}

template <int W>
__device__ __forceinline__ void pack_digits(const uint32_t (&d)[W],
                                            uint32_t (&v)[(W + 1) / 2]) {
#pragma unroll
  for (int k = 0; k < (W + 1) / 2; ++k)
    v[k] = d[2 * k] | (2 * k + 1 < W ? d[2 * k + 1] << 16 : 0u);
}

// the step table: tb.st[k] = the words of x^(2^k), or 1 for k >= logn (an
// exponent with bit k set is at least 2^logn >= n, so only lanes without a
// coefficient reach those), loaded by the whole block; visible after the
// caller's next __syncthreads
template <int W, int T>
__device__ __forceinline__ void load_steps(const Args& a, PowTables<W, T>& tb) {
  constexpr int H = (W + 1) / 2;
  const Operand& st = a.op[1];
  for (int i = threadIdx.x; i < 32 * H; i += blockDim.x) {
    const int k = i / H, j = i % H;
    uint32_t v = j == 0;
    if (k < a.aux) {
      const long long* d = st.ptr + k * st.stride[0] + 2 * j * st.dstride;
      v = (uint32_t)d[0] | (2 * j + 1 < W ? (uint32_t)d[st.dstride] << 16 : 0u);
    }
    tb.st[k][j] = v;
  }
}

template <int W, int T>
__device__ __forceinline__ void load_step(const PowTables<W, T>& tb, int k,
                                          uint32_t (&s)[(W + 1) / 2]) {
  if (k < 32) copy_words(s, tb.st[k]);
  else set_one(s);
}

// v = x^e from the bits of e in [b0, b1): one product a set bit
template <int W, int T>
__device__ __forceinline__ void pow_bits(const PowTables<W, T>& tb,
                                         const Words& c, unsigned e, int b0,
                                         int b1, uint32_t (&v)[(W + 1) / 2]) {
  set_one(v);
  for (int k = b0; k < b1; ++k) {
    if ((e >> k) & 1u) {
      uint32_t s[(W + 1) / 2];
      load_step(tb, k, s);
      mul_mod_words<W>(v, s, c, v);
    }
  }
}

// the tables of block b (log2 T = lt, log2 blocks = lg) from the step
// table, built by warps 0-2 (warps 0 and 2 through one pow_bits); visible
// after the caller's next __syncthreads
template <int W, int T>
__device__ __forceinline__ void build_tables(const Words& c, unsigned b,
                                             int lt, int lg, PowTables<W, T>& tb) {
  constexpr int H = (W + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t v[H];
  if (warp == 0 || (warp == 2 && lane < T / 32)) {
    const bool lo = warp == 0;
    pow_bits(tb, c, lo ? lane : 32u * lane, lo ? 0 : 5, lo ? 5 : lt, v);
    copy_words(lo ? tb.lo[lane] : tb.hi[lane], v);
  } else if (warp == 1) {
    // lane j holds x^(2^(lt + j)) where bit j of b is set, else 1; a
    // product tree leaves x^(bT) in lane 0
    if (lane < lg && ((b >> lane) & 1u)) load_step(tb, lt + lane, v);
    else set_one(v);
    for (int sh = 1; sh < lg; sh <<= 1) {
      uint32_t o[H];
#pragma unroll
      for (int k = 0; k < H; ++k)
        o[k] = __shfl_sync(0xFFFFFFFFu, v[k], (lane + sh) & 31);
      if ((lane & (2 * sh - 1)) == 0 && lane + sh < lg) mul_mod_words<W>(v, o, c, v);
    }
    if (lane == 0) copy_words(tb.base, v);
  }
}

// the digits' warp sum mod p (block_sum's first stage), valid in lane 0
template <int W>
__device__ __forceinline__ void warp_sum(uint32_t (&d)[W], const Consts& c) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    uint32_t o[W];
#pragma unroll
    for (int j = 0; j < W; ++j) o[j] = __shfl_down_sync(0xFFFFFFFFu, d[j], sh);
    add_mod<W>(d, o, c);
  }
}

template <int W>
__global__ void __launch_bounds__(HORNER_THREADS(W), W <= 16 ? 2 : 1)
horner_kernel(const Args a, const Consts c, const Words wc) {
  constexpr int T = HORNER_THREADS(W), H = (W + 1) / 2;
  __shared__ PowTables<W, T> tb;
  __shared__ uint32_t warp_part[T / 32][W];
  const unsigned b = blockIdx.x, row = blockIdx.y;
  const int lt = 31 - __clz(T), lg = 31 - __clz(gridDim.x);
  const long long S = (long long)gridDim.x * T, g = (long long)b * T + threadIdx.x;
  load_steps(a, tb);
  __syncthreads();
  build_tables<W, T>(wc, b, lt, lg, tb);

  long long off[1];
  lane_offsets<1>(a, row, off);
  const long long* x = a.op[0].ptr + off[0];
  const long long ds = a.op[0].dstride, ms = a.mstride;
  uint32_t acc[H];
#pragma unroll
  for (int k = 0; k < H; ++k) acc[k] = 0;
  if (g < a.m) {
    long long k = (a.m - 1 - g) / S;          // this lane's top coefficient
    load_words<W>(x + (g + k * S) * ms, ds, acc);
    uint32_t u[H], v[H];
    load_step(tb, lt + lg, u);
    if (k > 0) load_words<W>(x + (g + (k - 1) * S) * ms, ds, v);
    for (--k; k >= 0; --k) {
      // the next coefficient, loaded ahead (the last one again at k = 0)
      uint32_t next[H];
      load_words<W>(x + (g + (k > 0 ? k - 1 : 0) * S) * ms, ds, next);
      mul_add_words<W, true>(acc, u, v, wc, acc);
      copy_words(v, next);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t d[W];
  {
    uint32_t l[H];
    copy_words(l, tb.lo[lane]);
    mul_mod_words<W>(acc, l, wc, acc);
    unpack_digits<W>(acc, d);
  }
  // the warp's sum; warp 0 multiplies warp m's by x^(32m) in lane m and
  // sums those
  warp_sum<W>(d, c);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) warp_part[warp][j] = d[j];
  }
  __syncthreads();
  const long long np = (long long)gridDim.x;
  unsigned* part = a.scratch + ((long long)row * np) * W;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < W; ++j) d[j] = 0;
    if (lane < T / 32) {
      uint32_t h[H];
      pack_digits<W>(warp_part[lane], acc);
      copy_words(h, tb.hi[lane]);
      mul_mod_words<W>(acc, h, wc, acc);
      unpack_digits<W>(acc, d);
    }
    warp_sum<W>(d, c);
    if (lane == 0) {
      uint32_t bs[H];
      pack_digits<W>(d, acc);
      copy_words(bs, tb.base);
      mul_mod_words<W>(acc, bs, wc, acc);
      unpack_digits<W>(acc, d);
#pragma unroll
      for (int j = 0; j < W; ++j) part[b * W + j] = d[j];
    }
  }
  if (last_of_row(a.count, row, gridDim.x))
    finish_row<W>(a, c, part, W, 1, row);
}

template <int W>
__global__ void __launch_bounds__(HORNER_THREADS(W), W <= 16 ? 2 : 1)
powers_kernel(const Args a, const Words wc) {
  constexpr int T = HORNER_THREADS(W), H = (W + 1) / 2;
  __shared__ PowTables<W, T> tb;
  const unsigned b = blockIdx.x;
  const int lt = 31 - __clz(T), lg = 31 - __clz(gridDim.x);
  const long long S = (long long)gridDim.x * T, g = (long long)b * T + threadIdx.x;
  load_steps(a, tb);
  __syncthreads();
  build_tables<W, T>(wc, b, lt, lg, tb);
  __syncthreads();
  if (g >= a.m) return;
  // v = x^g = x^lane * x^(32 warp) * x^(bT)
  uint32_t v[H], l[H], h[H], u[H];
  copy_words(l, tb.lo[threadIdx.x & 31]);
  copy_words(h, tb.hi[threadIdx.x >> 5]);
  mul_mod_words<W>(l, h, wc, v);
  copy_words(h, tb.base);
  mul_mod_words<W>(v, h, wc, v);
  load_step(tb, lt + lg, u);
  for (long long i = g;;) {
#pragma unroll
    for (int j = 0; j < W; ++j)
      a.out[(long long)j * a.m + i] = (v[j / 2] >> (16 * (j % 2))) & 0xFFFFu;
    i += S;
    if (i >= a.m) break;
    mul_mod_words<W>(v, u, wc, v);
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
int launch(int op, const Args& a, const Consts& c, const Words& wc,
           cudaStream_t st) {
  constexpr int T = kWordThreads;
  if (op == MUL_MOD) {
    mul_mod_kernel<W><<<(a.n + T - 1) / T, T, 0, st>>>(a, wc);
  } else if (op == REDUCE_COLS) {
    reduce_cols_kernel<W><<<(a.n + T - 1) / T, T, 0, st>>>(a, wc);
  } else if (op == TREE_SUM) {
    tree_sum_kernel<W><<<a.n * a.parts, kSumThreads, 0, st>>>(a, wc);
  } else if (op == HORNER) {
    horner_kernel<W><<<dim3(a.parts, a.n), HORNER_THREADS(W), 0, st>>>(a, c, wc);
  } else {
    powers_kernel<W><<<a.parts, HORNER_THREADS(W), 0, st>>>(a, wc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: the Op above; hdr: host int64 header (the Slot layout above: per
// operand its digit stride and strides[4]); consts: host int64 [3w + 4], p's digits
// (w + 2), mu's (w + 2) and B^(2w-1) mod p's (w), or NULL for the limb
// ops; out, the three operands' pointers, scratch and count: device
// pointers (NULL where the op has none).  Returns the CUDA error of the
// launch (0 = success).
extern "C" int ringo_bigfield(int op, const long long* hdr,
                              const long long* consts, void* out,
                              const void* op0, const void* op1,
                              const void* op2, void* scratch, void* count,
                              void* stream) {
  Args a;
  a.w = (int)hdr[H_W];
  a.n = (unsigned)hdr[H_N];
  a.m = hdr[H_M];
  a.mstride = hdr[H_MSTRIDE];
  for (int k = 0; k < 4; ++k) {
    a.shape[k] = (unsigned)hdr[H_SHAPE + k];
    if (a.shape[k] == 0) return (int)cudaErrorInvalidValue;
  }
  a.out = (long long*)out;
  a.scratch = (unsigned*)scratch;
  a.count = (unsigned*)count;
  a.parts = (int)hdr[H_PARTS];
  a.aux = (int)hdr[H_AUX];
  const void* ptrs[3] = {op0, op1, op2};
  for (int k = 0; k < 3; ++k) {
    const long long* o = hdr + H_OPS + H_OP_LEN * k;
    a.op[k].ptr = (const long long*)ptrs[k];
    a.op[k].dstride = o[0];
    for (int d = 0; d < 4; ++d) a.op[k].stride[d] = o[1 + d];
  }
  if (a.n == 0 || a.w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (op >= ADD && op <= GEQ) {
    limb_kernel<<<(a.n + 255) / 256, 256, 0, st>>>(a, op);
    return (int)cudaGetLastError();
  }
  const bool pow2_parts = a.parts > 0 && (a.parts & (a.parts - 1)) == 0;
  if (op < MUL_MOD || op > POWERS || consts == nullptr || a.w > kMaxW ||
      (op == TREE_SUM && (a.parts <= 0 || a.m <= 0 || a.scratch == nullptr ||
                          a.count == nullptr)) ||
      (op == HORNER && (!pow2_parts || a.m <= 0 || a.aux <= 0 ||
                        a.n > 65535 || a.scratch == nullptr ||
                        a.count == nullptr)) ||
      (op == POWERS && (!pow2_parts || a.m <= 0 || a.aux <= 0)))
    return (int)cudaErrorInvalidValue;
  Consts c = {};
  for (int j = 0; j < a.w + 2; ++j) {
    c.p[j] = (uint32_t)consts[j];
    c.mu[j] = (uint32_t)consts[a.w + 2 + j];
  }
  for (int j = 0; j < a.w; ++j) c.bs[j] = (uint32_t)consts[2 * a.w + 4 + j];
  // the same digits packed two a word: digit j into word j / 2
  Words wc = {};
  for (int j = 0; j < a.w + 2; ++j) {
    wc.p[j / 2] |= c.p[j] << (16 * (j % 2));
    wc.mu[j / 2] |= c.mu[j] << (16 * (j % 2));
    if (j < a.w) wc.bs[j / 2] |= c.bs[j] << (16 * (j % 2));
  }
  switch (a.w) {
    case 7: return launch<7>(op, a, c, wc, st);
    case 8: return launch<8>(op, a, c, wc, st);
    case 14: return launch<14>(op, a, c, wc, st);
    case 15: return launch<15>(op, a, c, wc, st);
    case 16: return launch<16>(op, a, c, wc, st);
    case 28: return launch<28>(op, a, c, wc, st);
    case 55: return launch<55>(op, a, c, wc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
