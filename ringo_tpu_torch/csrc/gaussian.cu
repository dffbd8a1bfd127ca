// The samplers' Ziggurat (RoundedGaussianSampler.norm_float) and COSAC
// (COSACSampler.sample) rejection loops on the card (csprng/gaussian.py).
//
// No Pallas kernel corresponds: the JAX package runs these samplers on its
// host in numpy (ringo_tpu/csprng/gaussian.py:62-111 and :440-468, called
// by ringo_tpu/jindo/prover.py:885 and :891).
//
// Two entries share the per-op arithmetic (the __device__ functions below):
//
// ringo_gauss_loop: one cooperative launch draws a whole sample_device call.
//   The grid is every block that can be resident (occupancy x SMs), and
//   the kernel walks the numpy loop's phases in order, each block holding
//   the same copy of the counters:
//     COSAC:   DIRECT, then per round {ZIG, WEDGE, TAIL..., KEEP} until m
//              values are filled (norm_float), then COSAC, until no lane is
//              pending;
//     ROUNDED: CHECK (std_dev > 0), {ZIG, WEDGE, TAIL..., KEEP}, ROUND.
//   A phase decides its lanes (each block a contiguous segment of the
//   pending list, in chunks of 256), writes its block's counts, and after a
//   grid barrier every block takes the exclusive prefix of the counts
//   before it, ranks its own survivors in lane order (warp ballots, then
//   the warps' totals) and scatters them into the other half of a
//   ping-pong list; a second barrier ends the phase.  So the lists keep
//   lane order and every draw lands where numpy's lands: the k-th pending
//   lane reads the stream's u64 at byte offset + 8k of its read-ahead (uu's
//   before vv's in TAIL, a COSAC round's bits before its rr's), from any
//   byte offset (two aligned words shifted together).
//   The kernel returns to the host only at the end (status DONE), after a
//   phase whose decisions hit the margin (FLAGGED: dec holds 2 there; the
//   host decides those lanes with the numpy rule, writes dec and out, and
//   relaunches into the phase's compaction), before a phase whose draws
//   pass its read-ahead (EXHAUSTED: the host commits what was read, reads
//   further ahead and relaunches into the phase), or when a rounded call
//   has a std_dev <= 0 (BAD_SIGMA, before any draw).  Its state (int64
//   [S_LEN]: phase, stage, counts, stream offsets) comes in as an argument
//   and goes out through st_out.
//
// ringo_gauss: one step of those loops over n lanes (the per-op unit that
//   chip_smoke.py holds against csprng/gaussian.py gauss_plain):
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
//   dec: 1 accept, 0 reject, 2 flagged; cnt[0] counts accepts, cnt[1] flags
//   (ZIG: wedge lanes, tail lanes).
//
// Arithmetic: one IEEE rounding per numpy operation, in numpy's order
// (__dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn, so nothing contracts into
// an FMA; rint rounds ties to even as np.round).  exp and log are not
// numpy's to the bit, so every decision or rounding that went through
// them is flagged (dec = 2) when it passes within the margin of its
// threshold, and a tail lane keeps the uniform draw of its uu (src) so that
// a later rounding of its x near a half is flagged too.
//
// What bounds it on the H100: memory, barely: a lane reads 16-40 bytes a
// phase and does a few dozen f64 operations (one exp or log).  The loop's
// cost is its ~2 grid barriers a phase (a commit's COSAC call runs ~100
// phases), not its arithmetic; the step entry's was the host's launches
// and syncs between steps, which the loop removes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

enum Op { ZIG = 0, WEDGE = 1, TAIL = 2, DIRECT = 3, COSAC = 4, ROUND = 5 };

// slots of the step's int64 header (csprng/gaussian.py H_*)
enum {
  H_N, H_R, H_R2, H_IDX, H_X, H_SRC, H_CF, H_S, H_CENTER, H_TAB, H_OUTF,
  H_OUTI, H_DEC, H_CNT, H_MARGIN, H_INV_RN, H_SQ2PI, H_LEN
};

// the loop: kinds, phases, statuses, state slots and argument slots
// (csprng/gaussian.py COSAC_CALL.., P_*, DONE.., S_*, A_*)
enum { K_COSAC = 0, K_ROUNDED = 1 };
enum {
  P_CHECK, P_DIRECT, P_ZIG, P_WEDGE, P_TAIL, P_KEEP, P_COSAC, P_ROUND, P_DONE
};
enum { DONE = 0, FLAGGED = 1, EXHAUSTED = 2, BAD_SIGMA = 3 };
enum {
  S_STATUS, S_PHASE, S_STAGE, S_M, S_FILLED, S_NEED, S_NW, S_NT, S_PP, S_TPP,
  S_OFF_B, S_OFF_R, S_WANT, S_NFLAG, S_PHASES, S_BARRIERS, S_ROUNDS, S_GRID,
  S_LEN
};
enum {
  A_KIND, A_N, A_C, A_CF, A_S, A_OUT, A_WIN_B, A_START_B, A_LEN_B, A_WIN_R,
  A_START_R, A_LEN_R, A_P, A_TP, A_W, A_X, A_SRC, A_RZ, A_XZ, A_SRCZ, A_ZST,
  A_DEC, A_BLK, A_BLK_CAP, A_ST_OUT, A_TAB, A_MARGIN, A_INV_RN, A_SQ2PI, A_RN,
  A_ST, A_LEN = A_ST + S_LEN
};

constexpr double kTiny = 0x1p-1000;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// what every op reads besides its lanes: the Ziggurat tables, 128 each,
// and the constants
struct Consts {
  const u64* kn;
  const double* wn;
  const double* fn;
  double margin, inv_rn, sq2pi, rn;
};

// ------------------------------------------------------ per-op arithmetic

__device__ __forceinline__ double unit(u64 u) {
  // sample_float: the low 52 bits over 2^52 (exact)
  return __dmul_rn(__ull2double_rn(u & ((1ull << 52) - 1)), 0x1p-52);
}

__device__ __forceinline__ bool near(const Consts& k, double p, double q,
                                     double scale) {
  return fabs(__dsub_rn(p, q)) <= __dadd_rn(__dmul_rn(k.margin, scale), kTiny);
}

__device__ __forceinline__ bool near_half(const Consts& k, double y) {
  const double f = __dsub_rn(y, floor(y));
  return fabs(__dsub_rn(f, 0.5)) <=
         __dadd_rn(__dmul_rn(k.margin, fabs(y)), kTiny);
}

__device__ __forceinline__ int decision(bool q, bool p) {
  return q ? 2 : (p ? 1 : 0);
}

// ZIG: x of draw u; cls 0 accept, 1 wedge, 2 tail
__device__ __forceinline__ double zig_x(const Consts& k, u64 u, int& cls) {
  const int i = (int)(u & 127);
  const u64 j = (u >> 7) & ((1ull << 52) - 1);
  const double mag = __ull2double_rn(j);
  const bool acc = j < __ldg(k.kn + i);
  cls = acc ? 0 : (i > 0 ? 1 : 2);
  return __dmul_rn((u >> 63) ? -mag : mag, __ldg(k.wn + i));
}

// WEDGE: the ZIG lane's draw r and x, the wedge draw u
__device__ __forceinline__ int wedge_dec(const Consts& k, u64 r, double x,
                                         u64 u) {
  const int i = (int)(r & 127);
  const double f1 = __ldg(k.fn + i);
  const double lhs = __dmul_rn(unit(u), __dsub_rn(__ldg(k.fn + i - 1), f1));
  const double e = exp(__dmul_rn(__dmul_rn(-0.5, x), x));
  const double rhs = __dsub_rn(e, f1);
  const bool q = near(k, lhs, rhs, e);
  return decision(q, !q && lhs < rhs);
}

// TAIL: the draws of uu and vv; uu out
__device__ __forceinline__ int tail_dec(const Consts& k, u64 fa, u64 fb,
                                        double& uu) {
  uu = __dmul_rn(-log(unit(fa)), k.inv_rn);
  const double vv = -log(unit(fb));
  const double lhs = __dadd_rn(vv, vv), rhs = __dmul_rn(uu, uu);
  const bool q = near(k, lhs, rhs, rhs);
  return decision(q, !q && lhs >= rhs);
}

// DIRECT: the lane's centre fraction c, sigma s and draw r
__device__ __forceinline__ int direct_dec(const Consts& k, double c, double s,
                                          u64 r) {
  const double e = exp(__ddiv_rn(-__dmul_rn(c, c),
                                 __dmul_rn(2.0, __dmul_rn(s, s))));
  const double t = __ddiv_rn(e, __dmul_rn(k.sq2pi, s));
  const double u = unit(r);
  const bool q = near(k, u, t, t);
  return decision(q, !q && u < t);
}

// COSAC: sigma sf, centre fraction c, the norm_float value x and its tail
// draw src (< 0: not from the tail), the bit's and rr's draws; y_round out
__device__ __forceinline__ int cosac_dec(const Consts& k, double sf, double c,
                                         double x, double src, u64 bits,
                                         u64 rrb, double& yr) {
  const double y = __dmul_rn(sf, x);
  const double ry = rint(y);
  const bool b0 = (bits & 1) == 0;
  yr = b0 ? __dsub_rn(ry, 1.0) : __dadd_rn(ry, 1.0);
  const bool cmp = b0 ? (yr <= 0.5) : (yr >= -0.5);
  const double a1 = __dadd_rn(yr, c);
  const double num = __dsub_rn(__dmul_rn(a1, a1), __dmul_rn(y, y));
  const double acc = exp(__ddiv_rn(-num, __dmul_rn(__dmul_rn(2.0, sf), sf)));
  const double rr = unit(rrb);
  const bool q = (src >= 0.0 && near_half(k, y)) || (cmp && near(k, rr, acc, acc));
  return decision(q, !q && cmp && rr < acc);
}

// ROUND: rint(center + x s) out
__device__ __forceinline__ int round_dec(const Consts& k, double center,
                                         double x, double s, double src,
                                         long long& v) {
  const double y = __dadd_rn(center, __dmul_rn(x, s));
  v = (long long)rint(y);
  return (src >= 0.0 && near_half(k, y)) ? 2 : 0;
}

// ---------------------------------------------------------- the step entry

struct Args {
  long long n;
  const u64* r;
  const u64* r2;
  const long long* idx;
  const double* x;
  const double* src;
  const double* cf;
  const double* s;
  const double* center;
  Consts k;
  double* out_f;
  long long* out_i;
  signed char* dec;
  int* cnt;
};

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
  int d = 0;
  if (i < a.n) {
    if (OP == ZIG) {
      a.out_f[i] = zig_x(a.k, a.r[i], d);
    } else if (OP == WEDGE) {
      const long long lane = a.idx[i];
      d = wedge_dec(a.k, a.r[lane], a.x[lane], a.r2[i]);
    } else if (OP == TAIL) {
      d = tail_dec(a.k, a.r[i], a.r2[i], a.out_f[i]);
    } else if (OP == DIRECT) {
      d = direct_dec(a.k, a.cf[i], a.s[i], a.r[i]);
      a.out_i[i] = d == 1 ? (long long)a.center[i] : 0;
    } else if (OP == COSAC) {
      const long long lane = a.idx[i];
      double yr;
      d = cosac_dec(a.k, a.s[lane], a.cf[lane], a.x[i],
                    a.src != nullptr ? a.src[i] : -1.0, a.r[i], a.r2[i], yr);
      if (d == 1) a.out_i[lane] = (long long)__dadd_rn(yr, a.center[lane]);
      a.out_f[i] = yr;
    } else {  // ROUND
      d = round_dec(a.k, a.center[i], a.x[i], a.s[i],
                    a.src != nullptr ? a.src[i] : -1.0, a.out_i[i]);
    }
    a.dec[i] = (signed char)d;
  }
  // ZIG counts wedge (1) and tail (2) lanes, the others accepts and flags
  count(a.cnt, d == 1, d == 2);
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

Consts consts(long long tab, const long long* f) {
  Consts k;
  k.kn = (const u64*)tab;
  k.wn = (const double*)(k.kn + 128);
  k.fn = (const double*)(k.kn + 256);
  k.margin = as_double(f[0]);
  k.inv_rn = as_double(f[1]);
  k.sq2pi = as_double(f[2]);
  k.rn = as_double(f[3]);
  return k;
}

// ---------------------------------------------------------- the loop entry

struct Loop {
  long long n;
  int kind;
  const double* c;   // COSAC: the rounded centres; ROUNDED: the centres
  const double* cf;  // COSAC: rounded centre - centre
  const double* s;
  long long* out;
  const u64* win[2];      // read-aheads (base, rounded): 8-aligned bases
  long long start[2];     // byte of the next stream byte in each
  long long len[2];       // bytes of stream in each from start
  long long* P;           // [2][n] COSAC pending lanes
  long long* TP;          // [2][n] tail pending lanes of the ZIG batch
  long long* W;           // [n] wedge lanes of the ZIG batch
  double* X;              // [n] norm_float values and their tail draws
  double* SRC;
  u64* rz;                // [n] the ZIG batch: draws, x, tail draw, class
  double* xz;
  double* srcz;
  signed char* zst;       // 0 accepted, 1 wedge, 2 tail, 3 rejected
  signed char* dec;       // [n] the phase's decisions
  int* blk;               // [grid][4] block counts: class a, class b, flags
  long long* st_out;
  Consts k;
  long long st[S_LEN];
};

// the k-th u64 of stream w from byte off of its read-ahead
__device__ __forceinline__ u64 draw(const Loop& a, int w, long long off,
                                    long long k) {
  const long long pos = a.start[w] + off + 8 * k;
  const u64* p = a.win[w] + (pos >> 3);
  const int sh = (int)(pos & 7) * 8;
  const u64 lo = __ldg(p);
  return sh ? (lo >> sh) | (__ldg(p + 1) << (64 - sh)) : lo;
}

// this block's contiguous segment [lo, hi) of a list of L lanes
__device__ __forceinline__ void segment(long long L, long long& lo,
                                        long long& hi) {
  const long long seg = (L + gridDim.x - 1) / gridDim.x;
  lo = min(L, (long long)blockIdx.x * seg);
  hi = min(L, lo + seg);
}

struct Shared {
  int cnt[3];
  int warp[2][kWarps];
  long long red[5][kWarps];
};

// runs f(k) over this block's segment of L lanes, in chunks of 256 (every
// thread of the block takes the same number of turns); f returns the
// lane's class (0 none, 1 a, 2 b) | 4 if flagged.  Writes the block's
// counts of a, b and flagged lanes to blk.
template <class F>
__device__ void decide(const Loop& a, Shared& sh, long long L, F f) {
  if (threadIdx.x < 3) sh.cnt[threadIdx.x] = 0;
  __syncthreads();
  long long lo, hi;
  segment(L, lo, hi);
  for (long long base = lo; base < hi; base += kThreads) {
    const long long k = base + threadIdx.x;
    const int code = k < hi ? f(k) : 0;
    const unsigned ma = __ballot_sync(0xFFFFFFFFu, (code & 3) == 1);
    const unsigned mb = __ballot_sync(0xFFFFFFFFu, (code & 3) == 2);
    const unsigned mf = __ballot_sync(0xFFFFFFFFu, (code & 4) != 0);
    if ((threadIdx.x & 31) == 0) {
      if (ma) atomicAdd(&sh.cnt[0], __popc(ma));
      if (mb) atomicAdd(&sh.cnt[1], __popc(mb));
      if (mf) atomicAdd(&sh.cnt[2], __popc(mf));
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) a.blk[4 * blockIdx.x + threadIdx.x] = sh.cnt[threadIdx.x];
  __syncthreads();
}

struct Totals {
  long long pre[2];  // class a / b lanes of the blocks before this one
  long long tot[3];  // class a / b / flagged lanes of the grid
};

// after a grid barrier: the counts every block wrote, summed
__device__ Totals totals(const Loop& a, Shared& sh) {
  long long v[5] = {0, 0, 0, 0, 0};
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const int ca = __ldcg(a.blk + 4 * j), cb = __ldcg(a.blk + 4 * j + 1);
    v[2] += ca;
    v[3] += cb;
    v[4] += __ldcg(a.blk + 4 * j + 2);
    if (j < (int)blockIdx.x) {
      v[0] += ca;
      v[1] += cb;
    }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_down_sync(0xFFFFFFFFu, v[i], o);
    if (lane == 0) sh.red[i][w] = v[i];
  }
  __syncthreads();
  Totals t;
  long long s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    s[i] = 0;
    for (int j = 0; j < kWarps; ++j) s[i] += sh.red[i][j];
  }
  __syncthreads();
  t.pre[0] = s[0];
  t.pre[1] = s[1];
  t.tot[0] = s[2];
  t.tot[1] = s[3];
  t.tot[2] = s[4];
  return t;
}

// runs over this block's segment again, in the same chunks: cls(k) gives
// the lane's class (0 none, 1 a, 2 b); emit(k, class, rank) gets each
// class-a / class-b lane with its rank among the grid's lanes of its class
// in lane order (pre: the lanes of the blocks before this one)
template <class C, class E>
__device__ void scatter(Shared& sh, long long L, const Totals& t, C cls,
                        E emit) {
  long long lo, hi;
  segment(L, lo, hi);
  long long ra0 = t.pre[0], rb0 = t.pre[1];
  const unsigned lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  for (long long base = lo; base < hi; base += kThreads) {
    const long long k = base + threadIdx.x;
    const int c = k < hi ? cls(k) : 0;
    const unsigned ma = __ballot_sync(0xFFFFFFFFu, c == 1);
    const unsigned mb = __ballot_sync(0xFFFFFFFFu, c == 2);
    if (lane == 0) {
      sh.warp[0][w] = __popc(ma);
      sh.warp[1][w] = __popc(mb);
    }
    __syncthreads();
    long long oa = 0, ob = 0, ta = 0, tb = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int ca = sh.warp[0][i], cb = sh.warp[1][i];
      if (i < (int)w) {
        oa += ca;
        ob += cb;
      }
      ta += ca;
      tb += cb;
    }
    __syncthreads();
    if (c == 1) emit(k, 0, ra0 + oa + __popc(ma & lt));
    if (c == 2) emit(k, 1, rb0 + ob + __popc(mb & lt));
    ra0 += ta;
    rb0 += tb;
  }
}

// runs f(k) over this block's segment (no counts)
template <class F>
__device__ void each(long long L, F f) {
  long long lo, hi;
  segment(L, lo, hi);
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads) f(k);
}

__global__ void __launch_bounds__(kThreads) gauss_loop_kernel(
    const __grid_constant__ Loop a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared sh;
  const Consts& K = a.k;
  const long long n = a.n;
  long long phase = a.st[S_PHASE], stage = a.st[S_STAGE], m = a.st[S_M];
  long long filled = a.st[S_FILLED], need = a.st[S_NEED], nw = a.st[S_NW];
  long long nt = a.st[S_NT], pp = a.st[S_PP], tpp = a.st[S_TPP];
  long long off_b = a.st[S_OFF_B], off_r = a.st[S_OFF_R];
  long long phases = a.st[S_PHASES], barriers = a.st[S_BARRIERS];
  long long rounds = a.st[S_ROUNDS];
  long long status = -1, want = 0, nflag = 0;
  Totals t;
  auto barrier = [&]() {
    grid.sync();
    ++barriers;
  };
  // after a phase's decisions: the grid's counts; an exit if any flagged
  auto decided = [&]() {
    barrier();
    ++phases;
    t = totals(a, sh);
    if (t.tot[2] > 0) {
      status = FLAGGED;
      nflag = t.tot[2];
      stage = 1;
    }
  };
  // a resumed phase: its counts again from dec (the host settled it)
  auto recount = [&](long long L) {
    decide(a, sh, L, [&](long long k) { return __ldcg(a.dec + k) == 0 ? 1 : 0; });
    barrier();
    t = totals(a, sh);
  };
  auto rejected = [&](long long k) { return __ldcg(a.dec + k) == 0 ? 1 : 0; };
  auto short_of = [&](long long off, int w, long long bytes) {
    if (off + bytes <= a.len[w]) return false;
    status = EXHAUSTED;
    want = bytes;
    return true;
  };

  while (status < 0) {
    if (phase == P_CHECK) {
      decide(a, sh, n, [&](long long k) { return __ldg(a.s + k) <= 0.0 ? 4 : 0; });
      barrier();
      ++phases;
      t = totals(a, sh);
      if (t.tot[2] > 0) {
        status = BAD_SIGMA;
        break;
      }
      m = n;
      filled = 0;
      phase = P_ZIG;
    } else if (phase == P_DIRECT) {
      if (stage == 0) {
        if (short_of(off_b, 0, 8 * n)) break;
        decide(a, sh, n, [&](long long k) {
          const int d = direct_dec(K, __ldg(a.cf + k), __ldg(a.s + k),
                                   draw(a, 0, off_b, k));
          a.out[k] = d == 1 ? (long long)__ldg(a.c + k) : 0;
          a.dec[k] = (signed char)d;
          return d == 0 ? 1 : (d == 2 ? 4 : 0);
        });
        decided();
        if (status >= 0) break;
      } else {
        recount(n);
      }
      scatter(sh, n, t, rejected,
              [&](long long k, int, long long r) { a.P[r] = k; });
      barrier();
      off_b += 8 * n;
      m = t.tot[0];
      pp = 0;
      filled = 0;
      stage = 0;
      phase = m ? P_ZIG : P_DONE;
    } else if (phase == P_ZIG) {
      if (short_of(off_r, 1, 8 * (m - filled))) break;
      need = m - filled;
      decide(a, sh, need, [&](long long k) {
        const u64 u = draw(a, 1, off_r, k);
        int cls;
        a.xz[k] = zig_x(K, u, cls);
        a.rz[k] = u;
        a.srcz[k] = -1.0;
        a.zst[k] = (signed char)cls;
        return cls;
      });
      barrier();
      ++phases;
      t = totals(a, sh);
      scatter(sh, need, t, [&](long long k) { return (int)__ldcg(a.zst + k); },
              [&](long long k, int cls, long long r) {
                if (cls == 0) a.W[r] = k;
                else a.TP[r] = k;
              });
      barrier();
      off_r += 8 * need;
      nw = t.tot[0];
      nt = t.tot[1];
      tpp = 0;
      phase = nw ? P_WEDGE : (nt ? P_TAIL : P_KEEP);
    } else if (phase == P_WEDGE) {
      if (stage == 0) {
        if (short_of(off_r, 1, 8 * nw)) break;
        decide(a, sh, nw, [&](long long k) {
          const long long lane = __ldcg(a.W + k);
          const int d = wedge_dec(K, __ldcg(a.rz + lane), __ldcg(a.xz + lane),
                                  draw(a, 1, off_r, k));
          a.dec[k] = (signed char)d;
          return d == 2 ? 4 : 0;
        });
        decided();
        if (status >= 0) break;
      }
      each(nw, [&](long long k) {
        a.zst[__ldcg(a.W + k)] = __ldcg(a.dec + k) == 1 ? 0 : 3;
      });
      barrier();
      off_r += 8 * nw;
      stage = 0;
      phase = nt ? P_TAIL : P_KEEP;
    } else if (phase == P_TAIL) {
      const long long* tp = a.TP + tpp * n;
      if (stage == 0) {
        if (short_of(off_r, 1, 16 * nt)) break;
        decide(a, sh, nt, [&](long long k) {
          const long long lane = __ldcg(tp + k);
          const u64 fa = draw(a, 1, off_r, k);
          double uu;
          const int d = tail_dec(K, fa, draw(a, 1, off_r, nt + k), uu);
          const double tu = __dadd_rn(uu, K.rn);
          a.xz[lane] = (__ldcg(a.rz + lane) >> 63) ? -tu : tu;
          a.srcz[lane] = unit(fa);
          a.dec[k] = (signed char)d;
          return d == 0 ? 1 : (d == 2 ? 4 : 0);
        });
        decided();
        if (status >= 0) break;
      } else {
        recount(nt);
      }
      long long* next = a.TP + (1 - tpp) * n;
      scatter(sh, nt, t, rejected,
              [&](long long k, int, long long r) { next[r] = __ldcg(tp + k); });
      barrier();
      off_r += 16 * nt;
      nt = t.tot[0];
      tpp = 1 - tpp;
      stage = 0;
      phase = nt ? P_TAIL : P_KEEP;
    } else if (phase == P_KEEP) {
      auto kept = [&](long long k) { return __ldcg(a.zst + k) != 3 ? 1 : 0; };
      decide(a, sh, need, kept);
      barrier();
      ++phases;
      t = totals(a, sh);
      scatter(sh, need, t, kept, [&](long long k, int, long long r) {
        a.X[filled + r] = __ldcg(a.xz + k);
        a.SRC[filled + r] = __ldcg(a.srcz + k);
      });
      barrier();
      filled += t.tot[0];
      phase = filled < m ? P_ZIG : (a.kind == K_COSAC ? P_COSAC : P_ROUND);
    } else if (phase == P_COSAC) {
      const long long* pend = a.P + pp * n;
      if (stage == 0) {
        if (short_of(off_b, 0, 16 * m)) break;
        decide(a, sh, m, [&](long long k) {
          const long long lane = __ldcg(pend + k);
          double yr;
          const int d = cosac_dec(K, __ldg(a.s + lane), __ldg(a.cf + lane),
                                  __ldcg(a.X + k), __ldcg(a.SRC + k),
                                  draw(a, 0, off_b, k),
                                  draw(a, 0, off_b, m + k), yr);
          if (d == 1) a.out[lane] = (long long)__dadd_rn(yr, __ldg(a.c + lane));
          a.dec[k] = (signed char)d;
          return d == 0 ? 1 : (d == 2 ? 4 : 0);
        });
        decided();
        if (status >= 0) break;
      } else {
        recount(m);
      }
      long long* next = a.P + (1 - pp) * n;
      scatter(sh, m, t, rejected,
              [&](long long k, int, long long r) { next[r] = __ldcg(pend + k); });
      barrier();
      off_b += 16 * m;
      m = t.tot[0];
      pp = 1 - pp;
      filled = 0;
      ++rounds;
      stage = 0;
      phase = m ? P_ZIG : P_DONE;
    } else if (phase == P_ROUND) {
      if (stage == 0) {
        decide(a, sh, n, [&](long long k) {
          long long v;
          const int d = round_dec(K, __ldg(a.c + k), __ldcg(a.X + k),
                                  __ldg(a.s + k), __ldcg(a.SRC + k), v);
          a.out[k] = v;
          a.dec[k] = (signed char)d;
          return d == 2 ? 4 : 0;
        });
        decided();
        if (status >= 0) break;
      }
      stage = 0;
      phase = P_DONE;
    } else {
      status = DONE;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long* o = a.st_out;
    o[S_STATUS] = status;
    o[S_PHASE] = phase;
    o[S_STAGE] = stage;
    o[S_M] = m;
    o[S_FILLED] = filled;
    o[S_NEED] = need;
    o[S_NW] = nw;
    o[S_NT] = nt;
    o[S_PP] = pp;
    o[S_TPP] = tpp;
    o[S_OFF_B] = off_b;
    o[S_OFF_R] = off_r;
    o[S_WANT] = want;
    o[S_NFLAG] = nflag;
    o[S_PHASES] = phases;
    o[S_BARRIERS] = barriers;
    o[S_ROUNDS] = rounds;
    o[S_GRID] = gridDim.x;
  }
}

// blocks of the loop kernel that fit on the current device at once
// (asked once a device)
int loop_grid(int& grid) {
  static int cached[64];
  int dev, sms, per_sm, coop;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && cached[dev] > 0) {
    grid = cached[dev];
    return 0;
  }
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gauss_loop_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  grid = per_sm * sms;
  if (grid <= 0) return (int)cudaErrorLaunchOutOfResources;
  if (dev < 64) cached[dev] = grid;
  return 0;
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
  a.r = (const u64*)hdr[H_R];
  a.r2 = (const u64*)hdr[H_R2];
  a.idx = (const long long*)hdr[H_IDX];
  a.x = (const double*)hdr[H_X];
  a.src = (const double*)hdr[H_SRC];
  a.cf = (const double*)hdr[H_CF];
  a.s = (const double*)hdr[H_S];
  a.center = (const double*)hdr[H_CENTER];
  const long long f[4] = {hdr[H_MARGIN], hdr[H_INV_RN], hdr[H_SQ2PI], 0};
  a.k = consts(hdr[H_TAB], f);
  a.out_f = (double*)hdr[H_OUTF];
  a.out_i = (long long*)hdr[H_OUTI];
  a.dec = (signed char*)hdr[H_DEC];
  a.cnt = (int*)hdr[H_CNT];
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

// args: host int64 [A_LEN]: the kind, the lane count, the pointers (0
// where the kind reads none), the read-aheads, the count array and its
// capacity in blocks, st_out, the tables, the four doubles as their bits,
// then the state to start from.  One cooperative launch of every block
// that can be resident (at most the count array's capacity): a grid that
// cannot be resident fails the launch.  Returns the CUDA error (0 =
// success).
extern "C" int ringo_gauss_loop(const long long* args, void* stream) {
  Loop a;
  a.n = args[A_N];
  a.kind = (int)args[A_KIND];
  if (a.n <= 0 || a.n >= (1ll << 31) || (a.kind != K_COSAC && a.kind != K_ROUNDED))
    return (int)cudaErrorInvalidValue;
  a.c = (const double*)args[A_C];
  a.cf = (const double*)args[A_CF];
  a.s = (const double*)args[A_S];
  a.out = (long long*)args[A_OUT];
  a.win[0] = (const u64*)args[A_WIN_B];
  a.start[0] = args[A_START_B];
  a.len[0] = args[A_LEN_B];
  a.win[1] = (const u64*)args[A_WIN_R];
  a.start[1] = args[A_START_R];
  a.len[1] = args[A_LEN_R];
  a.P = (long long*)args[A_P];
  a.TP = (long long*)args[A_TP];
  a.W = (long long*)args[A_W];
  a.X = (double*)args[A_X];
  a.SRC = (double*)args[A_SRC];
  a.rz = (u64*)args[A_RZ];
  a.xz = (double*)args[A_XZ];
  a.srcz = (double*)args[A_SRCZ];
  a.zst = (signed char*)args[A_ZST];
  a.dec = (signed char*)args[A_DEC];
  a.blk = (int*)args[A_BLK];
  a.st_out = (long long*)args[A_ST_OUT];
  a.k = consts(args[A_TAB], args + A_MARGIN);
  for (int i = 0; i < S_LEN; ++i) a.st[i] = args[A_ST + i];
  if (a.c == nullptr || a.s == nullptr || a.out == nullptr || a.TP == nullptr ||
      a.W == nullptr || a.X == nullptr || a.SRC == nullptr || a.rz == nullptr ||
      a.xz == nullptr || a.srcz == nullptr || a.zst == nullptr ||
      a.dec == nullptr || a.blk == nullptr || a.st_out == nullptr ||
      a.win[1] == nullptr ||
      (a.kind == K_COSAC && (a.cf == nullptr || a.P == nullptr || a.win[0] == nullptr)))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int err = loop_grid(grid);
  if (err != 0) return err;
  if (grid > args[A_BLK_CAP]) grid = (int)args[A_BLK_CAP];
  void* params[] = {&a};
  cudaLaunchCooperativeKernel((const void*)gauss_loop_kernel, dim3(grid),
                              dim3(kThreads), params, 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
