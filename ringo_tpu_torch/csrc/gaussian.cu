// One wavefront step of the samplers' Ziggurat (RoundedGaussianSampler's
// norm_float) and COSAC rejection loop (COSACSampler.sample), for a
// compacted list of pending lanes (csprng/gaussian.py, the *_device
// methods).
//
// No Pallas kernel corresponds: the JAX package runs these samplers on its
// host in numpy (ringo_tpu/csprng/gaussian.py:62-111 and :440-468, called
// by ringo_tpu/jindo/prover.py:852-893).  Every lane reads its uniform
// draws from the sampler's folded stream at the offset its rank among the
// pending lanes fixes (the wrapper hands each step the draws in lane order),
// so the stream is consumed exactly as the numpy loop consumes it.
//
// Arithmetic: one IEEE rounding per numpy operation, in numpy's order
// (__dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn, so nothing contracts into
// an FMA; rint rounds ties to even as np.round).  exp and log are not
// numpy's to the bit, so every decision or rounding that went through
// them is flagged (dec = 2) when it passes within the margin of its
// threshold; the wrapper decides the flagged lanes on the host with the
// numpy rule on the same draws.
//
// Ops, each over n lanes (i < n), dec: 1 accept, 0 reject, 2 flagged;
// cnt[0] counts accepts, cnt[1] flags (ZIG: wedge lanes, tail lanes):
//   ZIG:    r [n] u64 draws -> x = +-j * wn[i], dec 0 accept / 1 wedge /
//           2 tail (j < kn[i]; i = r % 128, j = (r >> 7) % 2^52, sign r >> 63)
//   WEDGE:  lane = idx[k] of the ZIG arrays r, x; u = r2[k] -> accept if
//           u (fn[i-1] - fn[i]) < exp(-x^2 / 2) - fn[i]
//   TAIL:   uu = -log(u(r)) / RN, vv = -log(u(r2)) -> out_f = uu, accept if
//           vv + vv >= uu * uu
//   DIRECT: accept if u(r) < exp(-cf^2 / (2 s^2)) / (sqrt(2 pi) s);
//           out_i = center (the rounded centre) where accepted, else 0
//   COSAC:  lane = idx[k] of cf, s; y = s x[k]; bit = r[k] & 1; rr = u(r2[k])
//           -> out_f = y_round = rint(y) -+ 1, accept if the side test and
//           rr < exp(-((y_round + cf)^2 - y^2) / (2 s^2)) hold; also
//           flagged where x came from the tail (src[k] >= 0; no src: no
//           tail lane) and y is within the margin of a half; an accepted
//           lane writes out_i[lane] = y_round + center[lane]
//   ROUND:  out_i = rint(center + x s), flagged as COSAC's rounding
//
// What bounds it on the H100: memory, barely: a lane reads 16-40 bytes and
// does a few dozen f64 operations (one exp or log).  One thread a lane,
// counts by warp-aggregated atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Op { ZIG = 0, WEDGE = 1, TAIL = 2, DIRECT = 3, COSAC = 4, ROUND = 5 };

// slots of the int64 header (csprng/gaussian.py _H)
enum {
  H_N, H_R, H_R2, H_IDX, H_X, H_SRC, H_CF, H_S, H_CENTER, H_TAB, H_OUTF,
  H_OUTI, H_DEC, H_CNT, H_MARGIN, H_INV_RN, H_SQ2PI, H_LEN
};

constexpr double kTiny = 0x1p-1000;

struct Args {
  long long n;
  const unsigned long long* r;
  const unsigned long long* r2;
  const long long* idx;
  const double* x;
  const double* src;
  const double* cf;
  const double* s;
  const double* center;
  const unsigned long long* kn;  // Ziggurat tables, 128 each
  const double* wn;
  const double* fn;
  double* out_f;
  long long* out_i;
  signed char* dec;
  int* cnt;
  double margin, inv_rn, sq2pi;
};

__device__ __forceinline__ double unit(unsigned long long u) {
  // sample_float: the low 52 bits over 2^52 (exact)
  return __dmul_rn(__ull2double_rn(u & ((1ull << 52) - 1)), 0x1p-52);
}

__device__ __forceinline__ bool near(const Args& a, double p, double q,
                                     double scale) {
  return fabs(__dsub_rn(p, q)) <= __dadd_rn(__dmul_rn(a.margin, scale), kTiny);
}

__device__ __forceinline__ bool near_half(const Args& a, double y) {
  const double f = __dsub_rn(y, floor(y));
  return fabs(__dsub_rn(f, 0.5)) <= __dadd_rn(__dmul_rn(a.margin, fabs(y)), kTiny);
}

__device__ __forceinline__ void count(int* cnt, bool p, bool q) {
  const unsigned mp = __ballot_sync(0xFFFFFFFFu, p);
  const unsigned mq = __ballot_sync(0xFFFFFFFFu, q);
  if ((threadIdx.x & 31) == 0) {
    if (mp) atomicAdd(cnt, __popc(mp));
    if (mq) atomicAdd(cnt + 1, __popc(mq));
  }
}

template <int OP>
__global__ void __launch_bounds__(256) gauss_kernel(const __grid_constant__ Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool p = false, q = false;
  if (i < a.n) {
    if (OP == ZIG) {
      const unsigned long long u = a.r[i];
      const int k = (int)(u & 127);
      const unsigned long long j = (u >> 7) & ((1ull << 52) - 1);
      const double mag = __ull2double_rn(j);
      a.out_f[i] = __dmul_rn((u >> 63) ? -mag : mag, a.wn[k]);
      const bool acc = j < a.kn[k];
      p = !acc && k > 0;
      q = !acc && k == 0;
      a.dec[i] = acc ? 0 : (p ? 1 : 2);
    } else if (OP == WEDGE) {
      const long long lane = a.idx[i];
      const int k = (int)(a.r[lane] & 127);
      const double x = a.x[lane];
      const double f1 = a.fn[k];
      const double lhs = __dmul_rn(unit(a.r2[i]), __dsub_rn(a.fn[k - 1], f1));
      const double e = exp(__dmul_rn(__dmul_rn(-0.5, x), x));
      const double rhs = __dsub_rn(e, f1);
      q = near(a, lhs, rhs, e);
      p = !q && lhs < rhs;
      a.dec[i] = q ? 2 : (p ? 1 : 0);
    } else if (OP == TAIL) {
      const double uu = __dmul_rn(-log(unit(a.r[i])), a.inv_rn);
      const double vv = -log(unit(a.r2[i]));
      const double lhs = __dadd_rn(vv, vv), rhs = __dmul_rn(uu, uu);
      q = near(a, lhs, rhs, rhs);
      p = !q && lhs >= rhs;
      a.out_f[i] = uu;
      a.dec[i] = q ? 2 : (p ? 1 : 0);
    } else if (OP == DIRECT) {
      const double c = a.cf[i], s = a.s[i];
      const double e = exp(__ddiv_rn(-__dmul_rn(c, c),
                                     __dmul_rn(2.0, __dmul_rn(s, s))));
      const double t = __ddiv_rn(e, __dmul_rn(a.sq2pi, s));
      const double r = unit(a.r[i]);
      q = near(a, r, t, t);
      p = !q && r < t;
      a.out_i[i] = p ? (long long)a.center[i] : 0;
      a.dec[i] = q ? 2 : (p ? 1 : 0);
    } else if (OP == COSAC) {
      const long long lane = a.idx[i];
      const double sf = a.s[lane], c = a.cf[lane];
      const double y = __dmul_rn(sf, a.x[i]);
      const double ry = rint(y);
      const bool b0 = (a.r[i] & 1) == 0;
      const double yr = b0 ? __dsub_rn(ry, 1.0) : __dadd_rn(ry, 1.0);
      const bool cmp = b0 ? (yr <= 0.5) : (yr >= -0.5);
      const double a1 = __dadd_rn(yr, c);
      const double num = __dsub_rn(__dmul_rn(a1, a1), __dmul_rn(y, y));
      const double acc =
          exp(__ddiv_rn(-num, __dmul_rn(__dmul_rn(2.0, sf), sf)));
      const double rr = unit(a.r2[i]);
      q = (a.src != nullptr && a.src[i] >= 0.0 && near_half(a, y)) ||
          (cmp && near(a, rr, acc, acc));
      p = !q && cmp && rr < acc;
      if (p) a.out_i[lane] = (long long)__dadd_rn(yr, a.center[lane]);
      a.out_f[i] = yr;
      a.dec[i] = q ? 2 : (p ? 1 : 0);
    } else {  // ROUND
      const double v = __dadd_rn(a.center[i], __dmul_rn(a.x[i], a.s[i]));
      q = a.src != nullptr && a.src[i] >= 0.0 && near_half(a, v);
      a.out_i[i] = (long long)rint(v);
      a.dec[i] = q ? 2 : 0;
    }
  }
  count(a.cnt, p, q);
}

template <int OP>
int launch(const Args& a, cudaStream_t st) {
  const long long blocks = (a.n + 255) / 256;
  gauss_kernel<OP><<<(unsigned)blocks, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

double as_double(long long bits) {
  double d;
  memcpy(&d, &bits, sizeof d);
  return d;
}

}  // namespace

// op: one of ZIG .. ROUND; hdr: host int64 [H_LEN], the lane count, the
// pointers (0 where the op reads none) and the three doubles as their bits;
// cnt is zeroed on the stream before the launch.  Returns the CUDA error of
// the launch (0 = success).
extern "C" int ringo_gauss(int op, const long long* hdr, void* stream) {
  Args a;
  a.n = hdr[H_N];
  if (a.n <= 0 || a.n > (1ll << 31) || op < ZIG || op > ROUND)
    return (int)cudaErrorInvalidValue;
  a.r = (const unsigned long long*)hdr[H_R];
  a.r2 = (const unsigned long long*)hdr[H_R2];
  a.idx = (const long long*)hdr[H_IDX];
  a.x = (const double*)hdr[H_X];
  a.src = (const double*)hdr[H_SRC];
  a.cf = (const double*)hdr[H_CF];
  a.s = (const double*)hdr[H_S];
  a.center = (const double*)hdr[H_CENTER];
  const unsigned long long* tab = (const unsigned long long*)hdr[H_TAB];
  a.kn = tab;
  a.wn = (const double*)(tab + 128);
  a.fn = (const double*)(tab + 256);
  a.out_f = (double*)hdr[H_OUTF];
  a.out_i = (long long*)hdr[H_OUTI];
  a.dec = (signed char*)hdr[H_DEC];
  a.cnt = (int*)hdr[H_CNT];
  a.margin = as_double(hdr[H_MARGIN]);
  a.inv_rn = as_double(hdr[H_INV_RN]);
  a.sq2pi = as_double(hdr[H_SQ2PI]);
  if (a.dec == nullptr || a.cnt == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(a.cnt, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  switch (op) {
    case ZIG: return launch<ZIG>(a, st);
    case WEDGE: return launch<WEDGE>(a, st);
    case TAIL: return launch<TAIL>(a, st);
    case DIRECT: return launch<DIRECT>(a, st);
    case COSAC: return launch<COSAC>(a, st);
    default: return launch<ROUND>(a, st);
  }
}
