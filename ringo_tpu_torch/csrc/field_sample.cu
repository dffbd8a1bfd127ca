// Uniform field elements and raw bytes of a uniform sampler's stream, on
// the card (csprng/field_sample.py draw_segments).
//
// No Pallas kernel corresponds: the JAX package draws these on its host in
// numpy, sample_field_digits (ringo_tpu/jindo/prover.py:28-45, a
// top-bit-masked rejection loop) and the commit's two ChaCha20 keys
// (ringo_tpu/jindo/prover.py:804-805, 32 bytes each).
//
// ringo_field_sample: one block draws a list of segments one after another
// from a read-ahead of the stream (UniformSampler.read_ahead: the sampler's
// 8 KiB buffer with its next refills folded behind it; byte `start` of the
// read-ahead is the next byte _take_bytes would return).  A segment is
//   FIELD: n uniform elements in [0, p) as w digit planes, in the rounds of
//          the host loop: in round r the m_r lanes still needed, in
//          increasing lane order, take candidate j from stream bytes
//          [off + 2w j, off + 2w (j + 1)); digit i is the little-endian u16
//          at byte 2i of the candidate, the top digit ANDed with top_mask; a
//          lane is accepted iff the candidate is < p (compared from the top
//          digit; equal is rejected, as limb.geq decides); an accepted lane
//          writes its w digits into out[:, base + lane] (int64 planes, row
//          stride `stride`); the rejected lanes, in order, are the next
//          round's need list; off grows by 2w m_r;
//   RAW:   k bytes copied to raw[base, base + k); off grows by k.
// The rejected lanes are ranked in order by warp ballots and the 32 warps'
// exclusive prefix (as csrc/gaussian.cu ranks its survivors), one chunk of
// 1024 candidates at a time, into the other half of a ping-pong need list
// in device memory (int32 [2, nmax]).
//
// The block returns to the host at the end (status DONE) or before a round
// or RAW copy whose bytes would pass `avail` (status WANT, `want` = the bytes
// it needs from the current offset): the host then commits the bytes used,
// reads further ahead and relaunches, and the kernel resumes at the state it
// left (segment, lanes still needed, fresh list or not, ping-pong half).
// The state (int64 [S_LEN]) comes in as an argument and goes out through
// st_out.
//
// What bounds it on the H100: neither bytes nor operations.  A commit's
// draws read ~0.57 MB of stream and write ~1.2 MB of digit planes (~0.5 us
// at 3.35 TB/s); every round depends on the one before, so the draws run as
// ~25 rounds in one block, each a chain of L2 loads and two block barriers
// per chunk.  One block and one launch a call is what removes the host's
// rounds (a synchronising host round trip each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 64;        // digits of the widest field (ZP880: 55)
constexpr int kThreads = 1024;   // one block; candidates a chunk
constexpr int kWarps = kThreads / 32;

// segment kinds, statuses, state slots and argument slots
// (csprng/field_sample.py FIELD.., DONE.., S_*, A_*)
enum { FIELD = 0, RAW = 1 };
enum { DONE = 0, WANT = 1 };
enum {
  S_STATUS, S_SEG, S_M, S_FRESH, S_PP, S_OFF, S_WANT, S_ROUNDS, S_CHUNKS,
  S_LEN
};
enum {
  A_OUT, A_STRIDE, A_RAW, A_WIN, A_START, A_AVAIL, A_NEED, A_NMAX, A_SEGS,
  A_NSEG, A_W, A_TOP_MASK, A_ST_OUT, A_P, A_ST = A_P + kMaxW,
  A_LEN = A_ST + S_LEN
};

struct Args {
  long long* out;          // int64 [w, stride]
  long long stride;
  uint8_t* raw;            // uint8 [raw bytes]
  const uint8_t* win;      // the read-ahead
  long long start, avail;  // its first unread byte, bytes readable from it
  int* need;               // int32 [2, nmax]
  long long nmax;
  const long long* segs;   // int64 [nseg, 3]: kind, count, output base
  long long nseg;
  int w;
  unsigned top_mask;
  long long* st_out;       // int64 [S_LEN]
  unsigned short p[kMaxW]; // p's digits, little-endian
  long long st[S_LEN];
};

__device__ __forceinline__ unsigned digit(const uint8_t* q, int i) {
  return (unsigned)__ldg(q + 2 * i) | ((unsigned)__ldg(q + 2 * i + 1) << 8);
}

__global__ void __launch_bounds__(kThreads)
    field_sample_kernel(const __grid_constant__ Args a) {
  __shared__ unsigned short sp[kMaxW];
  __shared__ int warp_cnt[kWarps];
  __shared__ int warp_pre[kWarps + 1];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int w = a.w;
  const unsigned top = a.top_mask;
  const long long nb = 2ll * w;   // stream bytes of a candidate
  if (tid < kMaxW) sp[tid] = a.p[tid];
  __syncthreads();
  const uint8_t* src = a.win + a.start;
  // the loop's state: identical in every thread
  long long seg = a.st[S_SEG], m = a.st[S_M], off = a.st[S_OFF];
  int fresh = (int)a.st[S_FRESH], pp = (int)a.st[S_PP];
  long long rounds = a.st[S_ROUNDS], chunks = a.st[S_CHUNKS], want = 0;
  int status = DONE;
  while (seg < a.nseg) {
    const long long kind = a.segs[3 * seg], cnt = a.segs[3 * seg + 1];
    const long long base = a.segs[3 * seg + 2];
    if (kind == RAW) {
      if (off + cnt > a.avail) {
        status = WANT;
        want = cnt;
        break;
      }
      for (long long k = tid; k < cnt; k += kThreads) a.raw[base + k] = src[off + k];
      off += cnt;
      ++seg;
      continue;
    }
    if (m < 0) {  // the segment starts: every lane needed, in order
      m = cnt;
      fresh = 1;
    }
    while (m > 0) {
      const long long bytes = nb * m;
      if (off + bytes > a.avail) {
        status = WANT;
        want = bytes;
        break;
      }
      const int* cur = a.need + (long long)pp * a.nmax;
      int* nxt = a.need + (long long)(pp ^ 1) * a.nmax;
      const uint8_t* rs = src + off;
      long long nrej = 0;
      for (long long c0 = 0; c0 < m; c0 += kThreads) {
        const long long j = c0 + tid;
        bool rej = false;
        int ln = 0;
        if (j < m) {
          ln = fresh ? (int)j : cur[j];
          const uint8_t* q = rs + nb * j;
          rej = true;  // equal to p is rejected
          for (int i = w - 1; i >= 0; --i) {
            const unsigned d = i == w - 1 ? digit(q, i) & top : digit(q, i);
            if (d != sp[i]) {
              rej = d > sp[i];
              break;
            }
          }
          if (!rej) {
            long long* o = a.out + base + ln;
            for (int i = 0; i < w; ++i)
              o[i * a.stride] = i == w - 1 ? digit(q, i) & top : digit(q, i);
          }
        }
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, rej);
        if (lane == 0) warp_cnt[wid] = __popc(bal);
        __syncthreads();
        if (wid == 0) {
          const int v = warp_cnt[lane];
          int incl = v;
          for (int s = 1; s < 32; s <<= 1) {
            const int t = __shfl_up_sync(0xFFFFFFFFu, incl, s);
            if (lane >= s) incl += t;
          }
          warp_pre[lane] = incl - v;
          if (lane == 31) warp_pre[kWarps] = incl;
        }
        __syncthreads();
        if (rej) nxt[nrej + warp_pre[wid] + __popc(bal & ((1u << lane) - 1u))] = ln;
        nrej += warp_pre[kWarps];
        ++chunks;
      }
      off += bytes;
      m = nrej;
      fresh = 0;
      pp ^= 1;
      ++rounds;
      __syncthreads();  // the next round reads the list this one wrote
    }
    if (status == WANT) break;
    ++seg;
    m = -1;
  }
  if (tid == 0) {
    long long* o = a.st_out;
    o[S_STATUS] = status;
    o[S_SEG] = seg;
    o[S_M] = m;
    o[S_FRESH] = fresh;
    o[S_PP] = pp;
    o[S_OFF] = off;
    o[S_WANT] = want;
    o[S_ROUNDS] = rounds;
    o[S_CHUNKS] = chunks;
  }
}

}  // namespace

// args: host int64 [A_LEN]: the pointers and sizes, p's digits (A_P..,
// zero above w) and the state (A_ST..).  Returns the CUDA error of the
// launch (0 = success).
extern "C" int ringo_field_sample(const long long* args, void* stream) {
  Args a;
  a.out = (long long*)args[A_OUT];
  a.stride = args[A_STRIDE];
  a.raw = (uint8_t*)args[A_RAW];
  a.win = (const uint8_t*)args[A_WIN];
  a.start = args[A_START];
  a.avail = args[A_AVAIL];
  a.need = (int*)args[A_NEED];
  a.nmax = args[A_NMAX];
  a.segs = (const long long*)args[A_SEGS];
  a.nseg = args[A_NSEG];
  a.w = (int)args[A_W];
  a.top_mask = (unsigned)args[A_TOP_MASK];
  a.st_out = (long long*)args[A_ST_OUT];
  for (int i = 0; i < kMaxW; ++i) a.p[i] = (unsigned short)args[A_P + i];
  for (int i = 0; i < S_LEN; ++i) a.st[i] = args[A_ST + i];
  if (a.win == nullptr || a.segs == nullptr || a.st_out == nullptr ||
      a.nseg <= 0 || a.w < 1 || a.w > kMaxW || a.top_mask > 0xFFFFu ||
      a.start < 0 || a.avail < 0 || a.nmax < 0 || a.nmax >= (1ll << 31) ||
      a.stride < 0 || a.st[S_SEG] < 0 || a.st[S_SEG] > a.nseg)
    return (int)cudaErrorInvalidValue;
  field_sample_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
