// ChaCha20 keystream for the commit path's entropy.
//
// Replaces the Pallas kernel ringo_tpu/ops/chacha_pallas.py:47 (_kernel,
// launched by keystream_u32_pallas :70).  Same function: state = the four
// constants, the 8-word key, a 64-bit block counter equal to the block
// index, nonce 0; 10 double rounds; out[t][b][w] = word w of block b of
// stream t (the layout of ringo_tpu.csprng.chacha.keystream_u32).
//
// What bounds it on the H100: operations.  About 1,000 32-bit integer
// operations per 64-byte block against 64 bytes written puts it on the
// integer side of the roofline, though not far from the stores.  Design:
// one thread per block in native uint32 ARX (rotates are single funnel
// shifts), the state in registers, the 16 words written as four 16-byte
// stores, and the stream index in gridDim.y, so a batch of keys is one
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define QR(a, b, c, d)          \
  a += b; d ^= a; d = rotl(d, 16); \
  c += d; b ^= c; b = rotl(b, 12); \
  a += b; d ^= a; d = rotl(d, 8);  \
  c += d; b ^= c; b = rotl(b, 7);

__global__ void __launch_bounds__(256)
chacha20_kernel(const uint32_t* __restrict__ keys, uint4* __restrict__ out,
                int n_blocks) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  const uint32_t* k = keys + 8 * blockIdx.y;
  const uint32_t s0 = 0x61707865u, s1 = 0x3320646Eu, s2 = 0x79622D32u,
                 s3 = 0x6B206574u;
  const uint32_t s4 = k[0], s5 = k[1], s6 = k[2], s7 = k[3], s8 = k[4],
                 s9 = k[5], s10 = k[6], s11 = k[7];
  const uint32_t s12 = (uint32_t)blk;  // counter low word; high word 0
  uint32_t x0 = s0, x1 = s1, x2 = s2, x3 = s3, x4 = s4, x5 = s5, x6 = s6,
           x7 = s7, x8 = s8, x9 = s9, x10 = s10, x11 = s11, x12 = s12,
           x13 = 0, x14 = 0, x15 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    QR(x0, x4, x8, x12) QR(x1, x5, x9, x13)
    QR(x2, x6, x10, x14) QR(x3, x7, x11, x15)
    QR(x0, x5, x10, x15) QR(x1, x6, x11, x12)
    QR(x2, x7, x8, x13) QR(x3, x4, x9, x14)
  }
  uint4* o = out + ((size_t)blockIdx.y * n_blocks + blk) * 4;
  o[0] = make_uint4(x0 + s0, x1 + s1, x2 + s2, x3 + s3);
  o[1] = make_uint4(x4 + s4, x5 + s5, x6 + s6, x7 + s7);
  o[2] = make_uint4(x8 + s8, x9 + s9, x10 + s10, x11 + s11);
  o[3] = make_uint4(x12 + s12, x13, x14, x15);
}

}  // namespace

// keys: uint32 [T, 8]; out: uint32 [T, n_blocks, 16].  Returns the CUDA
// error of the launch (0 = success).
extern "C" int ringo_chacha20(const void* keys, void* out, int T,
                              int n_blocks, void* stream) {
  if (T <= 0 || T > 65535 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n_blocks + 255) / 256, T);
  chacha20_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (uint4*)out, n_blocks);
  return (int)cudaGetLastError();
}
