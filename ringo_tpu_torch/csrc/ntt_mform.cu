// Fused matmul NTT (ntt∘mform, and intt∘imform with the inverse map) for
// the d = 256 RNS rings of the commitment.
//
// Replaces the Pallas kernel ringo_tpu/ops/ntt_pallas.py:106 (_kernel,
// launched by _run :159, wrapped by PallasNTT.ntt_mform / intt_imform
// :230-234).  Same function, per prime l and row r:
//   T[e'] = sum_{a,j} (byte_a(v[r, j]) - 128) * F[l][a*256 + j][e']
//           + corr[l][e']                       (int32, exact: < 2^27)
//   out[r, e] = (sum_b 2^(7b) * T[b*256 + e]) mod q_l
// with F the [1024, 1280] int8 plane expansion of the NTT map.  The four
// byte planes are summed into the int32 accumulator before the -128
// correction column is added, as in the Pallas kernel.
//
// What bounds it on the H100: operations.  At the commit's encode shape
// (33,345 rows, 3 primes) it does 2.6e11 int8 multiply-adds against about
// 205 MB of traffic, so it sits on the tensor-core side of the roofline.
// Design: int8 tensor cores through mma.sync m16n8k32 (s8 x s8 -> s32).
// One block per (row tile of 32, 128-wide tile of the output column e,
// prime); its eight warps each own 16 rows x 32 e and keep the five 7-bit
// plane accumulators of the same e in registers (80 int32 per thread), so
// the recombine and the reduction mod q run in the epilogue and only the
// final residue is written.  The input rows are byte-split once into
// shared memory; the 1.3 MB map of the prime streams through shared memory
// in 64-deep k chunks.  Rows are padded to stride 272 and map rows to 80
// bytes so the fragment loads hit 32 distinct banks.  wgmma and TMA are
// left for a later kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 256;            // ring degree
constexpr int KDIM = 4 * D;       // contraction depth (4 byte planes)
constexpr int P7 = 5;             // 7-bit output planes
constexpr int NDIM = P7 * D;      // map columns
constexpr int ROWS = 32;          // rows per block
constexpr int ETILE = 128;        // output columns e per block
constexpr int KC = 64;            // k depth per map chunk
constexpr int XS_STRIDE = D + 16;     // bytes per byte-plane row in smem
constexpr int FS_STRIDE = KC + 16;    // bytes per map row in smem
constexpr int XS_BYTES = 4 * ROWS * XS_STRIDE;          // 34,816
constexpr int FS_BYTES = P7 * ETILE * FS_STRIDE;        // 51,200
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
ntt_mform_kernel(const uint32_t* __restrict__ v,       // [L, n, D]
                 const int8_t* __restrict__ planes_t,  // [L, NDIM, KDIM]
                 const int* __restrict__ corr,         // [L, NDIM]
                 const int* __restrict__ qs,           // [L]
                 uint32_t* __restrict__ out,           // [L, n, D]
                 int n) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;              // [4][ROWS][XS_STRIDE] offset bytes
  int8_t* fs = smem + XS_BYTES;   // [P7*ETILE][FS_STRIDE] map chunk

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp & 1;        // 16-row group
  const int we = warp >> 1;       // 32-column group of the e tile
  const int row0 = blockIdx.x * ROWS;
  const int eblk = blockIdx.y * ETILE;
  const int l = blockIdx.z;
  const uint32_t* vl = v + (size_t)l * n * D;
  const int8_t* fl = planes_t + (size_t)l * NDIM * KDIM;

  // byte-split the block's rows once: xs[a][r][j] = byte_a(v[r, j]) - 128
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, j = idx % D;
    const uint32_t x = (row0 + r < n) ? vl[(size_t)(row0 + r) * D + j] : 0u;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      xs[(a * ROWS + r) * XS_STRIDE + j] =
          (int8_t)((int)((x >> (8 * a)) & 0xFFu) - 128);
  }

  int acc[P7][4][4];
#pragma unroll
  for (int b = 0; b < P7; ++b)
#pragma unroll
    for (int et = 0; et < 4; ++et)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[b][et][i] = 0;

  for (int k0 = 0; k0 < KDIM; k0 += KC) {
    __syncthreads();  // previous chunk consumed (and xs written)
    // map chunk: local row nl = b*ETILE + el holds map column
    // b*D + eblk + el, bytes k0 .. k0+KC-1, as 16-byte copies
    for (int idx = tid; idx < P7 * ETILE * (KC / 16); idx += THREADS) {
      const int nl = idx / (KC / 16), c = idx % (KC / 16);
      const int b = nl / ETILE, el = nl % ETILE;
      const int4 val = *reinterpret_cast<const int4*>(
          fl + (size_t)(b * D + eblk + el) * KDIM + k0 + 16 * c);
      *reinterpret_cast<int4*>(fs + nl * FS_STRIDE + 16 * c) = val;
    }
    __syncthreads();
    const int a = k0 / D;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 32) {
      const int j0 = (k0 % D) + kk;
      const int8_t* xa = xs + (a * ROWS + wr * 16 + g) * XS_STRIDE + j0 + 4 * tig;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xa + 8 * XS_STRIDE);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + 16);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(xa + 8 * XS_STRIDE + 16);
#pragma unroll
      for (int b = 0; b < P7; ++b) {
#pragma unroll
        for (int et = 0; et < 4; ++et) {
          const int nl = b * ETILE + we * 32 + et * 8 + g;
          const int8_t* fb = fs + nl * FS_STRIDE + kk + 4 * tig;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(fb);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(fb + 16);
          mma_s8(acc[b][et], a0, a1, a2, a3, b0, b1);
        }
      }
    }
  }

  // epilogue: + corr, recombine the 7-bit planes, reduce mod q, store
  const unsigned long long q = (unsigned long long)qs[l];
  const int* cl = corr + (size_t)l * NDIM;
#pragma unroll
  for (int et = 0; et < 4; ++et) {
    const int e = eblk + we * 32 + et * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const int row = row0 + wr * 16 + g + 8 * h;
      uint32_t res[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        unsigned long long s = 0;
#pragma unroll
        for (int b = 0; b < P7; ++b) {
          const int t = acc[b][et][2 * h + c] + cl[b * D + e + c];
          s += (unsigned long long)(uint32_t)t << (7 * b);
        }
        res[c] = (uint32_t)(s % q);
      }
      if (row < n)
        *reinterpret_cast<uint2*>(out + ((size_t)l * n + row) * D + e) =
            make_uint2(res[0], res[1]);
    }
  }
}

}  // namespace

// v: uint32 [L, n, 256]; planes_t: int8 [L, 1280, 1024] (map column-major:
// row = output plane column b*256+e, column = a*256+j); corr: int32
// [L, 1280]; q: int32 [L]; out: uint32 [L, n, 256].  Returns the CUDA
// error of the launch.
extern "C" int ringo_ntt_mform(const void* v, const void* planes_t,
                               const void* corr, const void* q, void* out,
                               int L, int n, void* stream) {
  if (L <= 0 || L > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int smem = XS_BYTES + FS_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_mform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + ROWS - 1) / ROWS, D / ETILE, L);
  ntt_mform_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)v, (const int8_t*)planes_t, (const int*)corr,
      (const int*)q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
