// Twin-CDT table search of the commit path's Gaussian sampling.
//
// Replaces the Pallas kernel ringo_tpu/ops/twin_pallas.py:57 (_kernel,
// launched by _run :95, wrapped by TwinSearchPallas.__call__ :140) and the
// exact u64 recount of tied lanes that follows it there (:164-176).  For
// each lane and both twin tables c0, c1: the Go BinarySearch position of
// the uint64 draw u in CDF table row c (first entry >= u; found -> pos-1).
//
// What bounds it on the H100: memory.  Per lane it reads two int32 table
// indices and one u64 draw and writes two int64 results (32 bytes), while
// a search is 7 compares.  The TPU needed a one-hot matrix product over
// byte planes because it lacks fast gathers; here the whole [128, T] u64
// table (91 KB for sigma 4.79, 126 KB for 6.77) is copied into shared
// memory once per block, and each thread runs an exact 64-bit binary
// search for its lanes, so there is no 24-bit tier and no recount.  The
// search for c1 is skipped where c1 == c0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long bsearch_row(
    const unsigned long long* __restrict__ row, int T, unsigned long long u) {
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < u) lo = mid + 1; else hi = mid;
  }
  return lo - ((lo < T && row[lo] == u) ? 1 : 0);
}

__global__ void __launch_bounds__(1024)
twin_search_kernel(const unsigned long long* __restrict__ tables,
                   const int* __restrict__ c0, const int* __restrict__ c1,
                   const unsigned long long* __restrict__ u,
                   long long* __restrict__ v0, long long* __restrict__ v1,
                   int T, int n) {
  extern __shared__ unsigned long long tbl[];  // [128 * T]
  for (int i = threadIdx.x; i < 128 * T; i += blockDim.x) tbl[i] = tables[i];
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long uu = u[i];
    const int a = c0[i] & 127, b = c1[i] & 127;
    const long long r0 = bsearch_row(tbl + a * T, T, uu);
    v0[i] = r0;
    v1[i] = (a == b) ? r0 : bsearch_row(tbl + b * T, T, uu);
  }
}

}  // namespace

// tables: u64 [128, T] (T <= 128); c0, c1: int32 [n]; u: u64 [n];
// v0, v1: int64 [n].  Returns the CUDA error of the launch.
extern "C" int ringo_twin_search(const void* tables, const void* c0,
                                 const void* c1, const void* u, void* v0,
                                 void* v1, int T, int n, void* stream) {
  if (T <= 0 || T > 128 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = (size_t)128 * T * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      twin_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 1024;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 2 * sms) blocks = 2 * sms;
  twin_search_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned long long*)tables, (const int*)c0, (const int*)c1,
      (const unsigned long long*)u, (long long*)v0, (long long*)v1, T, n);
  return (int)cudaGetLastError();
}
