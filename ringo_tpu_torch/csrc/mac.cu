// The Ajtai MAC of the commitment: exact products mod q on the tensor cores.
//
// Replaces the JAX package's int8 dot_general in ringo_tpu/ops/mac_matmul.py:179
// (mod_mac; the product itself at :226), which has no Pallas kernel.  Same
// function, per prime l and NTT slot e (d = 256 slots, innermost):
//   out[l, j, n, e] = sum_k key[l, j, k, e] * x[l, k, n, e] * R^-1  mod q_l
// with R = 2^32, q_l < 2^31, key and x int32 residues, out int32.  The
// caller holds key' = key * R^-1 mod q (ops/mac_matmul.py folded),
// once per key.  With f_a = 2^8a * key'[j, k] mod q (a = 0..3) and byte_b
// the b-th byte,
//   T_b[j, n] = sum_{k, a} byte_b(f_a[j, k]) * byte_a(x[k, n])
//   out[j, n] = (sum_b 2^(8b) * T_b[j, n]) mod q,
// because sum_b 2^8b byte_b(f_a) = f_a and sum_a 2^8a byte_a(x) = x.  Both
// operands are unsigned bytes (u8 x u8 -> s32), so the -128 offset of the
// TPU's signed matrix unit and its correction have no part here, and the
// key's pieces are the bytes of f_a, not the JAX package's 7-bit pieces:
// four planes, not five.  T_b <= 255 * 255 * 4K < 2^31 for K <= 8192
// (MAX_K), eight times the longest contraction of the package's MACs.
//
// What bounds it on the H100: bytes.  At the commit's inner MAC (L = 3,
// J = 10, K = 545, n = 65) the key and x are 16.7 and 109 MB of residues
// against 8.6e9 byte products on the tensor cores, so the bound is the
// 128 MB moved (0.0381 ms); the verifier's n = 1 MACs are all key.  The
// key therefore stays residues (4 bytes a residue; its byte pieces would
// be 16, float64 planes 160), and the kernel makes the pieces itself.
//
// Design.
// * Slots.  A block owns 8 neighbouring slots of one prime (32 bytes of
//   every (k, n) row: whole sectors), one tile of at most 16 key rows j and
//   one tile of N columns n (N in 8 .. 80, from the call's n).  Four
//   warpgroups own two slots each.
// * Loads.  TMA copies a chunk of 8 k of x (the box [8 k, N n, 8 slots],
//   strided views taken as they are) and of the key ([Jt j, 8 k, 8 slots])
//   into a ring of stages; rows and k past the tensor arrive as zeros.
// * Operands.  wgmma takes 8-bit operands K-major only, and one slot's
//   product is strided by 1 KB in memory, so every thread then writes
//   the chunk into per-slot operand tiles in the no-swizzle core-matrix
//   layout (8 rows x 16 bytes; 16-byte K halves 128 B apart, 8-row groups
//   256 B apart), with the contraction index 4k + a: a word of x enters as
//   its four bytes, with no byte split.  The key tile (A, 64 rows 4j + b)
//   gets the pieces made here: three Shoup products by 2^8, 2^16 and 2^24
//   mod q and a 4 x 4 byte transpose (eight byte permutes), whose four
//   words land in four neighbouring rows.  Each thread's tile offsets are
//   the same in every chunk and are computed once; lanes are mapped so
//   that no copy or store meets a bank conflict.
// * MMA.  One m64nNk32 (u8 x u8 -> s32) per slot and chunk, A the key
//   tile, B the x tile, issued while the next chunk's tiles are written
//   (three operand buffers, one block barrier a chunk).
// * Epilogue.  The plane sums of one output sit in rows 4j + b of other
//   threads, so the accumulators go through shared memory; a thread then
//   sums s = sum_b 2^8b T_b < 2^55.1 for its (j, n), reduces it with the
//   wrapper's mu = floor(2^64 / q) (qhat = (s * mu) >> 64 is floor(s / q) or
//   one less for any s < 2^64, so one conditional subtraction remains),
//   and stores the 8 slots as 32 bytes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 8;        // slots e a block: 32 bytes of a (k, n) row
constexpr int KC = 8;           // k a chunk: 32 contraction bytes, one k32 step
constexpr int PLANES = 4;       // byte planes of the key pieces
constexpr int MAX_JT = 16;      // key rows a tile: 4 * 16 = 64 A rows
constexpr int MAX_K = 8192;     // 255 * 255 * 4K < 2^31
constexpr int NWG = 4;          // warpgroups, two slots each
constexpr int THREADS = 128 * NWG;
constexpr int A_TILE = 64 * 32 + 16;          // key pieces of a slot, + bank pad
constexpr int RAW_KEY = MAX_JT * KC * SLOTS * 4;
constexpr int SMEM_CAP = 227 * 1024;

template <int N>
struct Shape {
  // operand buffers: the MMAs of chunk c may run until chunk c + OPS - 2
  // is written (four or five buffers measured no faster)
  static constexpr int OPS = 3;
  static constexpr int RAW_X = KC * N * SLOTS * 4;
  static constexpr int STAGE = RAW_X + RAW_KEY;
  static constexpr int B_TILE = 32 * N + 16;  // x bytes of a slot, + bank pad
  static constexpr int OP = SLOTS * (A_TILE + B_TILE);
  static constexpr int FREE = SMEM_CAP - 2048 - OPS * OP;
  static constexpr int STAGES = FREE / STAGE > 8 ? 8 : FREE / STAGE;
  static constexpr int PIPE = STAGES * STAGE + OPS * OP;
  static constexpr int RS = N + 8;            // accumulator row stride, words
  static constexpr int T_BYTES = SLOTS * 64 * RS * 4;
  static constexpr int BODY = PIPE > T_BYTES ? PIPE : T_BYTES;
  static constexpr int SMEM = 1024 + BODY + 8 * STAGES;
  static_assert(STAGES >= 2, "stages");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier's phase differs from `parity`.  A wait that
// lasts two seconds is a fault of the pipeline: trap, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  unsigned long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t0 == 0) t0 = t;
    else if (t - t0 > 2000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Matrix descriptor of a K-major operand tile without swizzle: core
// matrices of 8 rows x 16 bytes, the two 16-byte halves of a 32-byte k step
// 128 B apart (leading offset), 8-row groups 256 B apart (stride offset).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// The 32-bit word (row r, k) of a tile in that layout: bytes 4k .. 4k + 3
// of the row, the contraction index 4k + a.
__device__ __forceinline__ int tile_word(int r, int k) {
  return (r >> 3) * 64 + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int W>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(W) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above the
// wait that completes the asynchronous MMAs.
template <int R>
__device__ __forceinline__ void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(d, o)                                                          \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),               \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// d (+)= A[64 x 32 B, u8] * B[N x 32 B, u8]^T; d is overwritten when
// acc is 0.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(int (&d)[4], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 {"
        "%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(int (&d)[8], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : ACC8(d, 0)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<24> {
  static __device__ __forceinline__ void run(int (&d)[12], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11}, %12, %13, p;\n}\n"
        : ACC8(d, 0), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : ACC8(d, 0), ACC8(d, 8)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<48> {
  static __device__ __forceinline__ void run(int (&d)[24], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23}, %24, %25, p;\n}\n"
        : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, %32, %33, p;\n}\n"
        : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<80> {
  static __device__ __forceinline__ void run(int (&d)[40], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.u8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p;\n}\n"
        : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32)
        : "l"(da), "l"(db), "r"(acc));
  }
};
// w * c mod q by Shoup's method: cs = floor(c * 2^32 / q), c < q < 2^31,
// any w < 2^32.  qhat = (w * cs) >> 32 is floor(w c / q) or one less, so
// r = w c - qhat q < 2q and one conditional subtraction remains.
__device__ __forceinline__ uint32_t shoup(uint32_t w, uint32_t c, uint32_t cs,
                                          uint32_t q) {
  const uint32_t r = w * c - __umulhi(w, cs) * q;
  return min(r, r - q);   // r - q wraps above r when r < q
}

// s mod q for s < 2^64 with mu = floor(2^64 / q): qhat = (s * mu) >> 64 is
// floor(s / q) or one less, so r = s - qhat q < 2q < 2^32.
__device__ __forceinline__ uint32_t reduce(unsigned long long s, uint32_t q,
                                           unsigned long long mu) {
  const uint32_t r = (uint32_t)s - (uint32_t)__umul64hi(s, mu) * q;
  return min(r, r - q);
}

// The 4 x 4 byte transpose: w[b] = bytes b of f0, f1, f2, f3, in that order.
__device__ __forceinline__ void planes(uint32_t f0, uint32_t f1, uint32_t f2,
                                       uint32_t f3, uint32_t (&w)[PLANES]) {
  const uint32_t t0 = __byte_perm(f0, f1, 0x5140), t1 = __byte_perm(f0, f1, 0x7362);
  const uint32_t t2 = __byte_perm(f2, f3, 0x5140), t3 = __byte_perm(f2, f3, 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// consts[l]: q, mu = floor(2^64 / q), then (c, floor(c * 2^32 / q)) for
// c = 2^8, 2^16, 2^24 mod q.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
mac_kernel(const __grid_constant__ CUtensorMap tm_x,    // x words
           const __grid_constant__ CUtensorMap tm_key,  // key' [L, J, K, 256]
           const unsigned long long* __restrict__ consts,  // [L, 8]
           uint32_t* __restrict__ out,                  // [L, J, n, 256]
           int J, int K, int n, int j_tiles, int jt_rows, int kn_order) {
  using S = Shape<N>;
  constexpr int KEY_PER = MAX_JT * KC * SLOTS / THREADS;   // residues a thread
  constexpr int X_UNITS = 2 * KC * N;                      // 16-byte copies
  constexpr int X_PER = (X_UNITS + THREADS - 1) / THREADS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw_addr);
  const uint32_t bars = base + S::BODY;   // [STAGES] full barriers

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * SLOTS, n0 = blockIdx.y * N;
  const int l = blockIdx.z / j_tiles, j0 = (blockIdx.z % j_tiles) * jt_rows;
  const int Jt = jt_rows;
  const int n_chunks = (K + KC - 1) / KC;
  const unsigned long long* cl = consts + 8 * l;
  const uint32_t q = (uint32_t)cl[0];
  const uint32_t c1 = (uint32_t)cl[2], c1s = (uint32_t)cl[3];
  const uint32_t c2 = (uint32_t)cl[4], c2s = (uint32_t)cl[5];
  const uint32_t c3 = (uint32_t)cl[6], c3s = (uint32_t)cl[7];
  const uint32_t stage_bytes = S::RAW_X + KC * SLOTS * 4 * Jt;

  auto issue = [&](int c) {   // the TMA copies of chunk c, by one thread
    const int s = c % S::STAGES;
    const uint32_t dst = base + s * S::STAGE, bar = bars + 8 * s;
    mbar_expect_tx(bar, stage_bytes);
    if (kn_order)
      tma_load_4d(dst, &tm_x, bar, e0, n0, c * KC, l);
    else
      tma_load_4d(dst, &tm_x, bar, e0, c * KC, n0, l);
    tma_load_4d(dst + S::RAW_X, &tm_key, bar, e0, c * KC, j0, l);
  };

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < S::STAGES && c < n_chunks; ++c) issue(c);

  // This thread's words in every chunk (-1: none).  Key residue i =
  // (j * KC + k) * 8 + e of the stage: its four planes to rows 4j .. 4j + 3
  // of slot e's A tile, four words apart.  x: 16 bytes (four slots) of one
  // (k, n) to four B tiles; lanes take (h, n, k) or (h, k, n) as their low
  // bits, whichever keeps the stage's reads free of bank conflicts.
  int key_src[KEY_PER], key_dst[KEY_PER], x_src[X_PER], x_dst[X_PER];
#pragma unroll
  for (int m = 0; m < KEY_PER; ++m) {
    const int i = tid + m * THREADS;
    const int e = i & 7, k = (i >> 3) & 7, j = i >> 6;
    key_src[m] = j < Jt ? S::RAW_X / 4 + i : -1;
    key_dst[m] = e * (A_TILE / 4) + tile_word(4 * j, k);
  }
#pragma unroll
  for (int m = 0; m < X_PER; ++m) {
    const int u = tid + m * THREADS;
    const int ln = u & 31, grp = u >> 5;
    const int h = ln & 1;
    const int nlo = kn_order ? (ln >> 1) & 3 : ln >> 3;
    const int klo = kn_order ? ln >> 3 : (ln >> 1) & 3;
    const int k = (grp / (N / 4)) * 4 + klo, nn = (grp % (N / 4)) * 4 + nlo;
    x_src[m] = u < X_UNITS ? (kn_order ? (k * N + nn) * 8 : (nn * KC + k) * 8) + 4 * h
                           : -1;
    x_dst[m] = (SLOTS * A_TILE + 4 * h * S::B_TILE) / 4 + tile_word(nn, k);
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int acc[2][N / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < N / 2; ++r) acc[i][r] = 0;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S::STAGES;
    mbar_wait(bars + 8 * s, (c / S::STAGES) & 1);
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(sm + s * S::STAGE);
    uint32_t* ob = reinterpret_cast<uint32_t*>(sm + S::STAGES * S::STAGE +
                                               (c % S::OPS) * S::OP);
#pragma unroll
    for (int m = 0; m < KEY_PER; ++m) {
      if (key_src[m] < 0) continue;
      const uint32_t w = raw[key_src[m]];
      uint32_t pw[PLANES];
      planes(w, shoup(w, c1, c1s, q), shoup(w, c2, c2s, q),
             shoup(w, c3, c3s, q), pw);
      uint32_t* at = ob + key_dst[m];
#pragma unroll
      for (int b = 0; b < PLANES; ++b) at[4 * b] = pw[b];
    }
#pragma unroll
    for (int m = 0; m < X_PER; ++m) {
      if (x_src[m] < 0) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + x_src[m]);
      uint32_t* bt = ob + x_dst[m];
      bt[0] = v.x;
      bt[S::B_TILE / 4] = v.y;
      bt[2 * S::B_TILE / 4] = v.z;
      bt[3 * S::B_TILE / 4] = v.w;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && c + S::STAGES < n_chunks) issue(c + S::STAGES);

    const uint32_t ob_addr = smem_u32(ob);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int slot = 2 * wg + i;
      Mma<N>::run(acc[i], tile_desc(ob_addr + slot * A_TILE),
                  tile_desc(ob_addr + SLOTS * A_TILE + slot * S::B_TILE),
                  c > 0);
    }
    wgmma_commit();
    // chunk c - OPS + 2's MMAs have read their buffer, which chunk c + 2
    // writes after the next barrier
    wgmma_wait<S::OPS - 2>();
  }
  wgmma_wait<0>();
  acc_fence(acc[0]);
  acc_fence(acc[1]);
  __syncthreads();

  // plane sums to shared memory: T[slot][row][col], rows 4j + b
  int* T = reinterpret_cast<int*>(sm);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int* ts = T + (2 * wg + i) * 64 * S::RS;
#pragma unroll
    for (int r = 0; r < N / 2; r += 2) {
      const int row = 16 * warp + 8 * ((r >> 1) & 1) + g;
      const int col = 8 * (r >> 2) + 2 * tig;
      if (row < PLANES * Jt)
        *reinterpret_cast<int2*>(ts + row * S::RS + col) =
            make_int2(acc[i][r], acc[i][r + 1]);
    }
  }
  __syncthreads();

  const unsigned long long mu = cl[1];
  const int nv = min(N, n - n0), jv = min(Jt, J - j0);
#pragma unroll 1
  for (int it = tid; it < jv * nv; it += THREADS) {
    const int j = it / nv, nn = it - j * nv;
    uint32_t res[SLOTS];
#pragma unroll
    for (int e = 0; e < SLOTS; ++e) {
      const int* te = T + (e * 64 + 4 * j) * S::RS + nn;
      unsigned long long s = 0;
#pragma unroll
      for (int b = 0; b < PLANES; ++b)
        s += (unsigned long long)(uint32_t)te[b * S::RS] << (8 * b);
      res[e] = reduce(s, q, mu);
    }
    uint4* o = reinterpret_cast<uint4*>(
        out + (((size_t)l * J + j0 + j) * n + n0 + nn) * 256 + e0);
    o[0] = make_uint4(res[0], res[1], res[2], res[3]);
    o[1] = make_uint4(res[4], res[5], res[6], res[7]);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library links
// against nothing but cudart.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-4 uint32 tensor map without swizzle; dims, strides (bytes, from
// the second dimension on) and box are innermost first.  Elements outside
// the tensor arrive as zeros.
bool make_map(CUtensorMap* tm, const void* ptr, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_key,
           const void* consts, void* out, int L, int J, int K, int n,
           int j_tiles, int jt_rows, int kn_order, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        mac_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Shape<N>::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(256 / SLOTS, (n + N - 1) / N, L * j_tiles);
  mac_kernel<N><<<grid, THREADS, Shape<N>::SMEM, stream>>>(
      tm_x, tm_key, (const unsigned long long*)consts, (uint32_t*)out, J, K,
      n, j_tiles, jt_rows, kn_order);
  return (int)cudaGetLastError();
}

// The tile width for n columns: the narrowest wgmma width that holds them,
// up to 80 (then tiles of 80).  ops/mac_matmul.py tile_width is the same.
int tile_width(int n) {
  const int widths[7] = {8, 16, 24, 32, 48, 64, 80};
  for (int w : widths)
    if (n <= w) return w;
  return 80;
}

}  // namespace

// key: int32 [L, J, K, 256], key' = key * R^-1 mod q, contiguous; x: int32
// [L, K, n, 256] with element strides sx_l, sx_k, sx_n (the last 1, each a
// multiple of 4); consts: uint64 [L, 8] (see mac_kernel); out: int32
// [L, J, n, 256].  Returns the CUDA error of the launch.
extern "C" int ringo_mac(const void* key, const void* x, const void* consts,
                         void* out, int L, int J, int K, int n,
                         long long sx_l, long long sx_k, long long sx_n,
                         void* stream) {
  if (L <= 0 || J <= 0 || K <= 0 || K > MAX_K || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int N = tile_width(n);
  const int j_tiles = (J + MAX_JT - 1) / MAX_JT;
  const int jt_rows = (J + j_tiles - 1) / j_tiles;
  if ((long long)L * j_tiles > 65535 || (n + N - 1) / N > 65535)
    return (int)cudaErrorInvalidValue;
  // the smaller of x's strides of k and n is the map's second dimension
  const int kn_order = sx_n <= sx_k;
  CUtensorMap tm_x, tm_key;
  const cuuint64_t xd[4] = {256, (cuuint64_t)(kn_order ? n : K),
                            (cuuint64_t)(kn_order ? K : n), (cuuint64_t)L};
  const cuuint64_t xs[3] = {(cuuint64_t)(kn_order ? sx_n : sx_k) * 4,
                            (cuuint64_t)(kn_order ? sx_k : sx_n) * 4,
                            (cuuint64_t)sx_l * 4};
  const cuuint32_t xb[4] = {SLOTS, (cuuint32_t)(kn_order ? N : KC),
                            (cuuint32_t)(kn_order ? KC : N), 1};
  const cuuint64_t kd[4] = {256, (cuuint64_t)K, (cuuint64_t)J, (cuuint64_t)L};
  const cuuint64_t ks[3] = {256 * 4, (cuuint64_t)K * 256 * 4,
                            (cuuint64_t)J * K * 256 * 4};
  const cuuint32_t kb[4] = {SLOTS, KC, (cuuint32_t)jt_rows, 1};
  if (!make_map(&tm_x, x, xd, xs, xb) || !make_map(&tm_key, key, kd, ks, kb))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 8: return launch<8>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
    case 16: return launch<16>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
    case 24: return launch<24>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
    case 32: return launch<32>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
    case 48: return launch<48>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
    case 64: return launch<64>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
    default: return launch<80>(tm_x, tm_key, consts, out, L, J, K, n, j_tiles, jt_rows, kn_order, st);
  }
}
