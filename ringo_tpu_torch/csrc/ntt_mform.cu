// Fused matmul NTT (ntt∘mform, and intt∘imform with the inverse map) for
// the d = 256 RNS rings of the commitment.
//
// Replaces the Pallas kernel ringo_tpu/ops/ntt_pallas.py:106 (_kernel,
// launched by _run :159, wrapped by PallasNTT.ntt_mform / intt_imform
// :230-234).  Same function, per prime l and row r:
//   T[e'] = sum_{a,j} (byte_a(v[r, j]) - 128) * F[l][a*256 + j][e']
//           + corr[l][e']                       (int32, exact: < 2^27)
//   out[r, e] = (sum_b 2^(7b) * T[b*256 + e]) mod q_l
// with F the [1024, 1280] int8 plane expansion of the NTT map and
// corr = 128 * colsum(F).  The -128 offset exists because the TPU's matrix
// unit takes signed bytes only.  Hopper's wgmma multiplies u8 by s8, so
// here the bytes enter unsigned and T = sum byte_a(v[r, j]) * F[..] is the
// same integer without the correction column: all four byte planes, all
// five 7-bit planes, 1024 x 1280 multiply-adds per row.
//
// What bounds it on the H100: operations.  At the commit's encode shape
// (33,345 rows, 3 primes) it does 1.3e11 int8 multiply-adds against about
// 209 MB of traffic, so it sits on the tensor-core side of the roofline,
// and what a design has to watch is how often operands are re-read from
// L2 and from shared memory.  Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W limit (chip_smoke.py, bench_ntt.py): 0.20 ms for that shape
// against a bound of 0.1325 ms; the MMA loop alone is at 0.16 ms.
//
// Design.
// * Contraction order.  The contraction index is taken as k = 4*j + a, so
//   a row of A is the row of v read as 1024 little-endian bytes: there is
//   no byte split, and TMA copies rows of v straight into the A stages.
//   The map is stored to match (planes_k [L, 1280, 1024], k-major; built
//   once per ring in ops/ntt_matmul.py).
// * Tile.  A block owns one prime and one 32-wide slice of the output
//   columns e, and keeps that slice of the map, all five planes, resident
//   in shared memory: 160 rows x 1024 B = 160 KB, loaded once in eight
//   k chunks.  It then walks many 64-row tiles of v (persistent blocks:
//   8 slices x G groups x L primes fill the SMs once), so the map is read
//   from L2 once per block, not once per row tile, and the rows of v are
//   read once per slice.
// * wgmma.  One m64n160k32 (u8 x s8 -> s32) per 32 bytes of k, both
//   operands in shared memory in the 128-byte-swizzled K-major layout that
//   TMA writes.  The 160 columns are ordered b*32 + e, and a thread's
//   accumulator columns repeat with period 8, so the five plane sums of
//   one (row, e) sit in one thread (registers 16b + i) and the recombine
//   and the reduction mod q stay thread-local: 80 accumulators a thread.
// * Pipeline.  Each of the two consumer warpgroups has its own producer
//   warp and its own ring of A_STAGES x [64 rows x 128 B] stages with
//   full/empty mbarriers, and walks its own row tiles, so one warpgroup's
//   epilogue overlaps the other's MMAs.
// * Epilogue.  s < 2^56; Barrett with a constant from the wrapper: for
//   q > 2^24 one 32 x 64-bit product of s >> 24 with floor(2^88 / q), which
//   is floor(s / q) or one less, then one conditional subtraction.  No
//   division.  All 16 residues of a thread are computed before the first
//   masked store, so the chains of 64-bit multiplies overlap.
//
// NTT_A_STAGES and NTT_MAX_GROUPS are compile-time constants; nothing in
// the package sets them.  bench_ntt.py rebuilds this file with other
// values to time the steps of the design (one stage; one tile pair per
// block) against the shipped one.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef NTT_A_STAGES
#define NTT_A_STAGES 4
#endif
#ifndef NTT_MAX_GROUPS
#define NTT_MAX_GROUPS 0   // 0: as many groups as fill the SMs once
#endif

namespace {

constexpr int D = 256;             // ring degree
constexpr int KDIM = 4 * D;        // contraction depth in bytes
constexpr int P7 = 5;              // 7-bit output planes
constexpr int E = 32;              // output columns e per block
constexpr int NT = P7 * E;         // wgmma N: 160 map columns, b*E + e
constexpr int SLICES = D / E;      // 8
constexpr int KC = 128;            // bytes of k per chunk (one swizzle row)
constexpr int NCHUNK = KDIM / KC;  // 8
constexpr int ROWS = 64;           // rows per warpgroup tile (wgmma M)
constexpr int A_STAGES = NTT_A_STAGES;
constexpr int NWG = 2;             // consumer warpgroups
constexpr int B_CHUNK_BYTES = NT * KC;            // 20,480
constexpr int B_BYTES = NCHUNK * B_CHUNK_BYTES;   // 163,840
constexpr int A_STAGE_BYTES = ROWS * KC;          // 8,192
constexpr int A_BYTES = NWG * A_STAGES * A_STAGE_BYTES;
constexpr int N_BARS = NCHUNK + 2 * NWG * A_STAGES;
constexpr int SMEM_BYTES = 1024 + B_BYTES + A_BYTES + 8 * N_BARS;
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 32 * NWG;   // + one producer warp each

static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* tm,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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

// Shared-memory matrix descriptor of a K-major tile whose rows are 128 B
// with the 128-byte swizzle (what TMA wrote): 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// s mod q for s < 2^56 without a division.  The wrapper passes
// mu = floor(2^88 / q) for q > 2^24 and floor(2^64 / q) below.  Either way
// qhat is floor(s / q) or one less, so r = s - qhat * q < 2q < 2^32 and one
// conditional subtraction gives the canonical residue.
//   q > 2^24: qhat = (floor(s / 2^24) * mu) >> 64, a 32 x 64-bit product.
//     It falls short of s / q by less than 2^24 / q + 2^-32 < 1.
//   q <= 2^24: the quotient can pass 32 bits; qhat = (s * mu) >> 64 in
//     full, whose low 32 bits are enough for r.
template <bool WIDE>
__device__ __forceinline__ uint32_t barrett(unsigned long long s, uint32_t q,
                                            unsigned long long mu) {
  uint32_t qhat;
  if (WIDE) {
    const uint32_t s24 = (uint32_t)(s >> 24);
    const unsigned long long w = (unsigned long long)s24 * (uint32_t)(mu >> 32) +
                                 __umulhi(s24, (uint32_t)mu);
    qhat = (uint32_t)(w >> 32);
  } else {
    qhat = (uint32_t)__umul64hi(s, mu);
  }
  const uint32_t r = (uint32_t)s - qhat * q;
  return min(r, r - q);   // r - q wraps above r when r < q
}

#define ACC8(d, o)                                                          \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),               \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// Keeps the compiler from moving reads of the accumulators above the
// wait that completes the asynchronous MMAs.
__device__ __forceinline__ void acc_fence(int (&d)[80]) {
  asm volatile("" : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
               ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56),
               ACC8(d, 64), ACC8(d, 72)::"memory");
}

// d (+)= A[64 x 32 B, u8] * B[160 x 32 B, s8]^T; d is overwritten when
// accumulate is 0.
__device__ __forceinline__ void wgmma_m64n160k32(int (&d)[80], uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " %80, %81, p;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56), ACC8(d, 64), ACC8(d, 72)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Epilogue of one 64-row tile: recombine the 7-bit planes, reduce mod q,
// store.  acc[16b + 4ec + 2h + cc]: plane b, column 8ec + 2tig + cc, row
// row0 + 8h; `out` points at (row0, this thread's first column).  All 16
// residues are computed before the first masked store, so that no branch
// cuts the independent chains apart.
template <bool WIDE>
__device__ __forceinline__ void epilogue(const int (&acc)[80], uint32_t* out,
                                         int row0, int n, uint32_t q,
                                         unsigned long long mu) {
  uint32_t res[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    unsigned long long s = 0;
#pragma unroll
    for (int b = 0; b < P7; ++b)
      s += (unsigned long long)(uint32_t)acc[16 * b + i] << (7 * b);
    res[i] = barrett<WIDE>(s, q, mu);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row0 + 8 * h < n) {
#pragma unroll
      for (int ec = 0; ec < E / 8; ++ec)
        *reinterpret_cast<uint2*>(out + (size_t)(8 * h) * D + 8 * ec) =
            make_uint2(res[4 * ec + 2 * h], res[4 * ec + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ntt_mform_kernel(const __grid_constant__ CUtensorMap tm_v,    // [L, n, 1024] u8
                 const __grid_constant__ CUtensorMap tm_map,  // [L, 5, 256, 1024]
                 const int* __restrict__ qs,                  // [L]
                 const unsigned long long* __restrict__ mus,  // [L]
                 uint32_t* __restrict__ out,                  // [L, n, D]
                 int n) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_smem = base;                  // [NCHUNK][NT][KC]
  const uint32_t a_smem = base + B_BYTES;        // [NWG][A_STAGES][ROWS][KC]
  const uint32_t bars = a_smem + A_BYTES;
  const uint32_t b_full = bars;                            // [NCHUNK]
  const uint32_t a_full = bars + 8 * NCHUNK;               // [NWG][A_STAGES]
  const uint32_t a_empty = a_full + 8 * NWG * A_STAGES;    // [NWG][A_STAGES]

  const int tid = threadIdx.x;
  const int slice = blockIdx.x, l = blockIdx.z;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int n_streams = NWG * gridDim.y;   // one stream of tiles per warpgroup

  if (tid == 0) {
    for (int i = 0; i < NCHUNK; ++i) mbar_init(b_full + 8 * i, 1);
    for (int i = 0; i < NWG * A_STAGES; ++i) {
      mbar_init(a_full + 8 * i, 1);
      mbar_init(a_empty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producers: warp p of them feeds warpgroup p, and warp 0 also
    // loads the map slice; one lane issues the copies
    const int p = (tid - CONSUMERS) >> 5;
    if ((tid & 31) != 0) return;
    const uint32_t my_full = a_full + 8 * p * A_STAGES;
    const uint32_t my_empty = a_empty + 8 * p * A_STAGES;
    const uint32_t my_a = a_smem + p * A_STAGES * A_STAGE_BYTES;
    int stage = 0;
    uint32_t phase = 1;   // the stages start empty
    for (int tile = NWG * blockIdx.y + p; tile < n_tiles; tile += n_streams) {
      const bool load_map = p == 0 && tile == NWG * (int)blockIdx.y;
#pragma unroll 1
      for (int c = 0; c < NCHUNK; ++c) {
        if (load_map) {
          mbar_expect_tx(b_full + 8 * c, B_CHUNK_BYTES);
          tma_load_4d(b_smem + c * B_CHUNK_BYTES, &tm_map, b_full + 8 * c,
                      c * KC, slice * E, 0, l);
        }
        mbar_wait(my_empty + 8 * stage, phase);
        mbar_expect_tx(my_full + 8 * stage, A_STAGE_BYTES);
        tma_load_3d(my_a + stage * A_STAGE_BYTES, &tm_v, my_full + 8 * stage,
                    c * KC, tile * ROWS, l);
        if (++stage == A_STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumers: warpgroup p walks tiles NWG*group + p, + n_streams, ...
  const int p = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5, lane = wtid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t my_full = a_full + 8 * p * A_STAGES;
  const uint32_t my_empty = a_empty + 8 * p * A_STAGES;
  const uint32_t my_a = a_smem + p * A_STAGES * A_STAGE_BYTES;
  const uint32_t q = (uint32_t)qs[l];
  const unsigned long long mu = mus[l];   // Barrett constant of q
  const bool wide = q > (1u << 24);
  uint32_t* out_l = out + (size_t)l * n * D + slice * E + 2 * tig;

  int acc[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  bool map_ready = false;
  for (int tile = NWG * blockIdx.y + p; tile < n_tiles; tile += n_streams) {
    int prev_stage = 0;
#pragma unroll 1
    for (int c = 0; c < NCHUNK; ++c) {
      if (!map_ready) mbar_wait(b_full + 8 * c, 0);
      mbar_wait(my_full + 8 * stage, phase);
      const uint64_t da = smem_desc(my_a + stage * A_STAGE_BYTES);
      const uint64_t db = smem_desc(b_smem + c * B_CHUNK_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)   // 32 B of k: +2 in 16-byte units
        wgmma_m64n160k32(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      wgmma_commit();
      if (A_STAGES == 1) {   // no ring: finish before the stage is refilled
        wgmma_wait<0>();
        mbar_arrive(my_empty);
      } else if (c > 0) {
        wgmma_wait<1>();   // the previous chunk's MMAs have read their stage
        mbar_arrive(my_empty + 8 * prev_stage);
      }
      prev_stage = stage;
      if (++stage == A_STAGES) { stage = 0; phase ^= 1; }
    }
    map_ready = true;
    wgmma_wait<0>();
    acc_fence(acc);
    if (A_STAGES > 1) mbar_arrive(my_empty + 8 * prev_stage);

    const int row0 = tile * ROWS + 16 * warp + g;
    if (wide) epilogue<true>(acc, out_l + (size_t)row0 * D, row0, n, q, mu);
    else epilogue<false>(acc, out_l + (size_t)row0 * D, row0, n, q, mu);
    acc_fence(acc);
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

// A u8 tensor map with the 128-byte swizzle; dims, strides (bytes, from the
// second dimension on) and box are innermost first.
bool make_map(CUtensorMap* tm, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// v: uint32 [L, n, 256]; planes_k: int8 [L, 1280, 1024] (row = output
// plane column b*256 + e, column = 4*j + a); q: int32 [L]; mu: uint64 [L],
// floor(2^88 / q) for q > 2^24, else floor(2^64 / q); out: uint32
// [L, n, 256].  Returns the CUDA error of
// the launch.
extern "C" int ringo_ntt_mform(const void* v, const void* planes_k,
                               const void* q, const void* mu, void* out,
                               int L, int n, void* stream) {
  if (L <= 0 || L > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ntt_mform_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err != cudaSuccess) { sm_count = 0; return (int)err; }
  }

  CUtensorMap tm_v, tm_map;
  // rows of v beyond n are zero-filled by the copy and masked on store
  const cuuint64_t v_dims[3] = {KDIM, (cuuint64_t)n, (cuuint64_t)L};
  const cuuint64_t v_strides[2] = {KDIM, (cuuint64_t)n * KDIM};
  const cuuint32_t v_box[3] = {KC, ROWS, 1};
  // the map as [L, plane b, e, k]: one box is the k chunk of all five
  // planes of a slice, landing as rows b*E + e
  const cuuint64_t m_dims[4] = {KDIM, D, P7, (cuuint64_t)L};
  const cuuint64_t m_strides[3] = {KDIM, (cuuint64_t)D * KDIM,
                                   (cuuint64_t)P7 * D * KDIM};
  const cuuint32_t m_box[4] = {KC, E, P7, 1};
  if (!make_map(&tm_v, v, 3, v_dims, v_strides, v_box) ||
      !make_map(&tm_map, planes_k, 4, m_dims, m_strides, m_box))
    return (int)cudaErrorInvalidValue;

  const int n_tiles = (n + ROWS - 1) / ROWS;
  int groups = sm_count / (SLICES * L);   // fill the SMs once
  if (NTT_MAX_GROUPS > 0) groups = NTT_MAX_GROUPS;
  if (groups > (n_tiles + NWG - 1) / NWG) groups = (n_tiles + NWG - 1) / NWG;
  if (groups < 1) groups = 1;
  dim3 grid(SLICES, groups, L);
  ntt_mform_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tm_v, tm_map, (const int*)q, (const unsigned long long*)mu,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
