// AES-256-CTR keystream of the host samplers (csprng/uniform.py), and the
// samplers' folded refills.
//
// No Pallas kernel corresponds: the JAX package draws this keystream on the
// host through OpenSSL (ringo_tpu/csprng/uniform.py:34, the `cryptography`
// CTR encryptor), which the port's host does not have.
//
// ringo_aes256_ctr: the port's numpy `ctr_keystream`, the keystream bytes of
// the counter blocks iv + block0 + i (mod 2^128), i < n_blocks, the 16-byte
// counter one big-endian integer whose low 64 bits carry into the high 64
// bits.
//
// ringo_aes256_ctr_fold: what m refills of UniformSampler._take_bytes
// compute (the reference's _refill, ringo_tpu/csprng/uniform.py:45-48).
// Given the 8 KiB carry (the sampler's current buffer) and the keystream
// from byte offset pos on, cut into 8 KiB chunks ks_0 .. ks_{m-1}, out chunk
// j = carry ^ ks_0 ^ ... ^ ks_j.  pos may be any byte offset.
//
// What bounds it on the H100: operations.  A block is about 680 32-bit
// operations (14 rounds of table lookups, byte selects and XORs) against
// 16 bytes written.  Design: one T-table (Te0; Te1..3 are its byte
// rotations, one funnel shift each) replicated 32 times in shared memory,
// copy l at bank l, so lane l of a warp only ever reads bank l and the
// random byte indices never conflict (32 KB a block).  The byte index and
// the lane's bank form the address in two operations.  The S-box of the
// last round is a byte of Te0.  The round keys and the start counter travel
// by value in the launch's parameters.  The keystream kernel runs two
// counter blocks at once per thread for latency, four per thread in all.
// The fold kernel gives each thread one 16-byte column of a segment of at
// most four chunks: it XOR-scans its column down the segment in registers,
// a block of 1,024 threads (4 columns x 256 segments) scans the segments'
// totals across its warps (shuffles, then shared memory), and each output
// 16 bytes is stored once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTabBytes = 256 * 32 * 4;  // 256 entries x 32 bank copies
constexpr int kChunkCols = 512;          // 16-byte columns of an 8 KiB chunk
constexpr int kFoldCols = 4;             // columns of a fold block
constexpr int kFoldSegs = 256;           // segments of a fold block
constexpr int kFoldMaxSeg = 4;           // chunks a segment holds at most

struct AesCtrArgs {
  uint32_t rk[60];   // FIPS-197 round keys, big-endian words
  uint32_t ctr[4];   // iv + block0 mod 2^128, big-endian words
};

struct FoldArgs {
  uint32_t rk[60];
  uint32_t ctr[4];   // iv + (pos >> 4) mod 2^128
  int shift;         // pos & 15
  int m;             // chunks
  int seg;           // chunks a segment, <= kFoldMaxSeg
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

// Te0[x] = (2s, s, s, 3s) as a big-endian word, s = S(x) (FIPS-197 section
// 5.2.1's T-table form), stored at word x * 32 + copy for all 32 copies.
__device__ __forceinline__ void load_table(uint32_t* tab) {
  for (int e = threadIdx.x; e < 256 * 32; e += blockDim.x) {
    const uint32_t s = kSbox[e >> 5];
    const uint32_t s2 = ((s << 1) ^ ((s & 0x80u) ? 0x11Bu : 0u)) & 0xFFu;
    tab[e] = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
  }
}

// Byte offsets into the replicated table of byte 3 (most significant) .. 0
// of a state word: the byte times 128 (the entry's 32 copies) plus lane * 4.
__device__ __forceinline__ uint32_t t3(const char* tab, uint32_t s, uint32_t l4) {
  return *(const uint32_t*)(tab + (((s >> 17) & 0x7F80u) | l4));
}
__device__ __forceinline__ uint32_t t2(const char* tab, uint32_t s, uint32_t l4) {
  return *(const uint32_t*)(tab + (((s >> 9) & 0x7F80u) | l4));
}
__device__ __forceinline__ uint32_t t1(const char* tab, uint32_t s, uint32_t l4) {
  return *(const uint32_t*)(tab + (((s >> 1) & 0x7F80u) | l4));
}
__device__ __forceinline__ uint32_t t0(const char* tab, uint32_t s, uint32_t l4) {
  return *(const uint32_t*)(tab + (((s << 7) & 0x7F80u) | l4));
}

// The counter block base + i (mod 2^128), base = (hi0, lo0).
__device__ __forceinline__ void counter(const uint32_t* ctr, uint64_t i,
                                        uint32_t* s) {
  const uint64_t hi0 = ((uint64_t)ctr[0] << 32) | ctr[1];
  const uint64_t lo0 = ((uint64_t)ctr[2] << 32) | ctr[3];
  const uint64_t lo = lo0 + i;                     // wraps mod 2^64
  const uint64_t hi = hi0 + (lo < lo0 ? 1u : 0u);  // the 2^128 wrap too
  s[0] = (uint32_t)(hi >> 32);
  s[1] = (uint32_t)hi;
  s[2] = (uint32_t)(lo >> 32);
  s[3] = (uint32_t)lo;
}

// Encrypts NB counter blocks side by side; out[b][k] are the keystream's
// 16 bytes of block b as four little-endian words in stream order.
template <int NB>
__device__ __forceinline__ void encrypt(const char* tab, uint32_t l4,
                                        const uint32_t* rk,
                                        uint32_t (&st)[NB][4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) st[b][k] ^= rk[k];
#pragma unroll
  for (int r = 1; r < 14; ++r) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        t[c] = t3(tab, st[b][c], l4) ^ ror(t2(tab, st[b][(c + 1) & 3], l4), 8) ^
               ror(t1(tab, st[b][(c + 2) & 3], l4), 16) ^
               ror(t0(tab, st[b][(c + 3) & 3], l4), 24) ^ rk[4 * r + c];
#pragma unroll
      for (int c = 0; c < 4; ++c) st[b][c] = t[c];
    }
  }
  // last round: SubBytes and ShiftRows, no MixColumns; S(x) is byte 1 and
  // byte 2 of Te0[x]
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    uint32_t o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = (((t3(tab, st[b][c], l4) << 8) & 0xFF000000u) |
              (t2(tab, st[b][(c + 1) & 3], l4) & 0x00FF0000u) |
              (t1(tab, st[b][(c + 2) & 3], l4) & 0x0000FF00u) |
              ((t0(tab, st[b][(c + 3) & 3], l4) >> 8) & 0xFFu)) ^ rk[56 + c];
    // bytes in stream order: each word most significant byte first
#pragma unroll
    for (int c = 0; c < 4; ++c) st[b][c] = bswap(o[c]);
  }
}

constexpr int kCtrThreads = 256;
constexpr int kCtrPerThread = 4;   // counter blocks a thread, two at a time

__global__ void __launch_bounds__(kCtrThreads)
aes256_ctr_kernel(const __grid_constant__ AesCtrArgs a, uint4* __restrict__ out,
                  long long n_blocks) {
  extern __shared__ uint32_t tab[];
  load_table(tab);
  __syncthreads();
  const uint32_t l4 = (threadIdx.x & 31) * 4;
  const long long base =
      (long long)blockIdx.x * (kCtrThreads * kCtrPerThread) + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kCtrPerThread; p += 2) {
    const long long i0 = base + (long long)p * kCtrThreads;
    const long long i1 = i0 + kCtrThreads;
    if (i0 >= n_blocks) break;
    uint32_t st[2][4];
    counter(a.ctr, (uint64_t)i0, st[0]);
    counter(a.ctr, (uint64_t)i1, st[1]);
    encrypt<2>((const char*)tab, l4, a.rk, st);
    out[i0] = make_uint4(st[0][0], st[0][1], st[0][2], st[0][3]);
    if (i1 < n_blocks) out[i1] = make_uint4(st[1][0], st[1][1], st[1][2], st[1][3]);
  }
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint4 shfl_up4(uint4 v, int d) {
  return make_uint4(__shfl_up_sync(0xFFFFFFFFu, v.x, d),
                    __shfl_up_sync(0xFFFFFFFFu, v.y, d),
                    __shfl_up_sync(0xFFFFFFFFu, v.z, d),
                    __shfl_up_sync(0xFFFFFFFFu, v.w, d));
}

// The 16 keystream bytes at stream offset 16 * blk + shift (blk counted
// from the launch's start counter): one block when shift is 0, else the
// tail of block blk and the head of block blk + 1.
__device__ __forceinline__ uint4 ks16(const FoldArgs& a, const char* tab,
                                      uint32_t l4, uint64_t blk) {
  if (a.shift == 0) {
    uint32_t st[1][4];
    counter(a.ctr, blk, st[0]);
    encrypt<1>(tab, l4, a.rk, st);
    return make_uint4(st[0][0], st[0][1], st[0][2], st[0][3]);
  }
  uint32_t st[2][4];
  counter(a.ctr, blk, st[0]);
  counter(a.ctr, blk + 1, st[1]);
  encrypt<2>(tab, l4, a.rk, st);
  uint8_t b[32];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t w = st[k >> 2][k & 3];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[4 * k + q] = (uint8_t)(w >> (8 * q));
  }
  uint32_t o[4];
  for (int k = 0; k < 4; ++k) {
    uint32_t w = 0;
    for (int q = 0; q < 4; ++q) w |= (uint32_t)b[a.shift + 4 * k + q] << (8 * q);
    o[k] = w;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kFoldCols * kFoldSegs)
aes256_ctr_fold_kernel(const __grid_constant__ FoldArgs a, const uint4* __restrict__ carry,
                       uint4* __restrict__ out) {
  extern __shared__ uint32_t tab[];
  __shared__ uint4 warp_tot[kFoldSegs * kFoldCols / 32][kFoldCols];
  load_table(tab);
  __syncthreads();
  const uint32_t l4 = (threadIdx.x & 31) * 4;
  const int c = blockIdx.x * kFoldCols + (threadIdx.x % kFoldCols);
  const int g = threadIdx.x / kFoldCols;
  const int j0 = g * a.seg;
  uint4 pre[kFoldMaxSeg];
  uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kFoldMaxSeg; ++k) {
    const int j = j0 + k;
    if (k < a.seg && j < a.m) {
      acc = xor4(acc, ks16(a, (const char*)tab, l4,
                           (uint64_t)j * kChunkCols + c));
    }
    pre[k] = acc;
  }
  // exclusive XOR-scan of the segments' totals, column by column: within
  // the warp (8 segments, lanes kFoldCols apart), then across the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4 incl = acc;
#pragma unroll
  for (int d = kFoldCols; d < 32; d *= 2) {
    const uint4 v = shfl_up4(incl, d);
    if (lane >= d) incl = xor4(incl, v);
  }
  if (lane >= 32 - kFoldCols) warp_tot[warp][lane % kFoldCols] = incl;
  __syncthreads();
  uint4 p = xor4(carry[c], xor4(incl, acc));
  for (int w = 0; w < warp; ++w) p = xor4(p, warp_tot[w][lane % kFoldCols]);
#pragma unroll
  for (int k = 0; k < kFoldMaxSeg; ++k) {
    const int j = j0 + k;
    if (k < a.seg && j < a.m) out[(size_t)j * kChunkCols + c] = xor4(p, pre[k]);
  }
}

void copy_keys(const uint32_t* src, uint32_t* rk, uint32_t* ctr) {
  for (int k = 0; k < 60; ++k) rk[k] = src[k];
  for (int k = 0; k < 4; ++k) ctr[k] = src[60 + k];
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
  copy_keys((const uint32_t*)args, a.rk, a.ctr);
  const int per = kCtrThreads * kCtrPerThread;
  aes256_ctr_kernel<<<(n_blocks + per - 1) / per, kCtrThreads, kTabBytes,
                      (cudaStream_t)stream>>>(a, (uint4*)out, n_blocks);
  return (int)cudaGetLastError();
}

// args: host uint32[64] as for ringo_aes256_ctr, the counter words being
// iv + (pos >> 4); shift = pos & 15; carry: uint8 [8192] on the card; out:
// uint8 [8192 * m] on the card, m <= 1024; carry may alias the last chunk
// of an earlier launch's out.  Returns the CUDA error of the launch.
extern "C" int ringo_aes256_ctr_fold(const void* args, int shift,
                                     const void* carry, void* out, int m,
                                     void* stream) {
  if (m <= 0 || m > kFoldSegs * kFoldMaxSeg || shift < 0 || shift > 15)
    return (int)cudaErrorInvalidValue;
  FoldArgs a;
  copy_keys((const uint32_t*)args, a.rk, a.ctr);
  a.shift = shift;
  a.m = m;
  a.seg = (m + kFoldSegs - 1) / kFoldSegs;
  aes256_ctr_fold_kernel<<<kChunkCols / kFoldCols, kFoldCols * kFoldSegs,
                           kTabBytes, (cudaStream_t)stream>>>(
      a, (const uint4*)carry, (uint4*)out);
  return (int)cudaGetLastError();
}
