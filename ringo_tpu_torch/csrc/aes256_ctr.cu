// AES-256-CTR keystream of the host samplers (csprng/uniform.py).
//
// No Pallas kernel corresponds: the JAX package draws this keystream on the
// host through OpenSSL (ringo_tpu/csprng/uniform.py:34, the `cryptography`
// CTR encryptor), which the port's host does not have.  Same function as
// the port's numpy `ctr_keystream`: the keystream bytes of the counter
// blocks iv + block0 + i (mod 2^128), i < n_blocks, the 16-byte counter
// one big-endian integer whose low 64 bits carry into the high 64 bits.
//
// What bounds it on the H100: operations.  A block is about 680 32-bit
// operations (14 rounds of table lookups, byte selects and XORs) against
// 16 bytes written.  Design: one thread per counter block; the four
// 1 KiB T-tables (built from the S-box by each block's 256 threads) and
// the S-box in shared memory; the 60 round-key words and the start counter
// by value in the parameter bank, so no upload per call; the 14 rounds in
// registers; each output block one 16-byte store of the byte-swapped
// words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AesCtrArgs {
  uint32_t rk[60];   // FIPS-197 round keys, big-endian words
  uint32_t ctr[4];   // iv + block0 mod 2^128, big-endian words
};

__device__ const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

__device__ __forceinline__ uint32_t ror(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__global__ void __launch_bounds__(256)
aes256_ctr_kernel(const AesCtrArgs a, uint4* __restrict__ out, int n_blocks) {
  __shared__ uint32_t te0[256], te1[256], te2[256], te3[256];
  __shared__ uint32_t sbox[256];
  {
    // Te0[x] = (2s, s, s, 3s) as a big-endian word, s = S(x); Te1..3 are
    // its rotations (FIPS-197 section 5.2.1's T-table form)
    const uint32_t t = threadIdx.x;
    const uint32_t s = kSbox[t];
    const uint32_t s2 = ((s << 1) ^ ((s & 0x80u) ? 0x11Bu : 0u)) & 0xFFu;
    const uint32_t w = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
    te0[t] = w;
    te1[t] = ror(w, 8);
    te2[t] = ror(w, 16);
    te3[t] = ror(w, 24);
    sbox[t] = s;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_blocks) return;

  const uint64_t hi0 = ((uint64_t)a.ctr[0] << 32) | a.ctr[1];
  const uint64_t lo0 = ((uint64_t)a.ctr[2] << 32) | a.ctr[3];
  const uint64_t lo = lo0 + (uint64_t)i;           // wraps mod 2^64
  const uint64_t hi = hi0 + (lo < lo0 ? 1u : 0u);  // the 2^128 wrap too
  uint32_t s0 = (uint32_t)(hi >> 32) ^ a.rk[0];
  uint32_t s1 = (uint32_t)hi ^ a.rk[1];
  uint32_t s2 = (uint32_t)(lo >> 32) ^ a.rk[2];
  uint32_t s3 = (uint32_t)lo ^ a.rk[3];
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    const uint32_t t0 = te0[s0 >> 24] ^ te1[(s1 >> 16) & 0xFF] ^
                        te2[(s2 >> 8) & 0xFF] ^ te3[s3 & 0xFF] ^ a.rk[4 * r];
    const uint32_t t1 = te0[s1 >> 24] ^ te1[(s2 >> 16) & 0xFF] ^
                        te2[(s3 >> 8) & 0xFF] ^ te3[s0 & 0xFF] ^ a.rk[4 * r + 1];
    const uint32_t t2 = te0[s2 >> 24] ^ te1[(s3 >> 16) & 0xFF] ^
                        te2[(s0 >> 8) & 0xFF] ^ te3[s1 & 0xFF] ^ a.rk[4 * r + 2];
    const uint32_t t3 = te0[s3 >> 24] ^ te1[(s0 >> 16) & 0xFF] ^
                        te2[(s1 >> 8) & 0xFF] ^ te3[s2 & 0xFF] ^ a.rk[4 * r + 3];
    s0 = t0; s1 = t1; s2 = t2; s3 = t3;
  }
  // last round: SubBytes and ShiftRows, no MixColumns
  const uint32_t o0 = ((sbox[s0 >> 24] << 24) | (sbox[(s1 >> 16) & 0xFF] << 16) |
                       (sbox[(s2 >> 8) & 0xFF] << 8) | sbox[s3 & 0xFF]) ^ a.rk[56];
  const uint32_t o1 = ((sbox[s1 >> 24] << 24) | (sbox[(s2 >> 16) & 0xFF] << 16) |
                       (sbox[(s3 >> 8) & 0xFF] << 8) | sbox[s0 & 0xFF]) ^ a.rk[57];
  const uint32_t o2 = ((sbox[s2 >> 24] << 24) | (sbox[(s3 >> 16) & 0xFF] << 16) |
                       (sbox[(s0 >> 8) & 0xFF] << 8) | sbox[s1 & 0xFF]) ^ a.rk[58];
  const uint32_t o3 = ((sbox[s3 >> 24] << 24) | (sbox[(s0 >> 16) & 0xFF] << 16) |
                       (sbox[(s1 >> 8) & 0xFF] << 8) | sbox[s2 & 0xFF]) ^ a.rk[59];
  // bytes in stream order: each word most significant byte first
  out[i] = make_uint4(bswap(o0), bswap(o1), bswap(o2), bswap(o3));
}

}  // namespace

// args: host uint32[64], the 60 round-key words then the four counter
// words (iv + block0 mod 2^128, most significant first), copied into the
// launch's parameters; out: uint8 [16 * n_blocks] on the card.  Returns
// the CUDA error of the launch (0 = success).
extern "C" int ringo_aes256_ctr(const void* args, void* out, int n_blocks,
                                void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  AesCtrArgs a;
  const uint32_t* src = (const uint32_t*)args;
  for (int k = 0; k < 60; ++k) a.rk[k] = src[k];
  for (int k = 0; k < 4; ++k) a.ctr[k] = src[60 + k];
  aes256_ctr_kernel<<<(n_blocks + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      a, (uint4*)out, n_blocks);
  return (int)cudaGetLastError();
}
