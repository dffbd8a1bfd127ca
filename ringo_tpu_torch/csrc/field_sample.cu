// Uniform field elements and raw bytes of a uniform sampler's stream, on
// the card (csprng/field_sample.py draw_segments).
//
// No Pallas kernel corresponds: the JAX package draws these on its host in
// numpy, sample_field_digits (ringo_tpu/jindo/prover.py:28-45, a
// top-bit-masked rejection loop) and the commit's two ChaCha20 keys
// (ringo_tpu/jindo/prover.py:804-805, 32 bytes each).
//
// ringo_field_sample: one launch draws a list of segments one after another
// from a read-ahead of the stream (UniformSampler.read_ahead: the sampler's
// 8 KiB buffer with its next refills folded behind it; byte `start` of the
// read-ahead is the next byte _take_bytes would return).  A segment is
//   FIELD: n uniform elements in [0, p) as w digit planes, in the rounds of
//          the host loop: in round r the m_r lanes still needed, in
//          increasing lane order, take candidate j from stream bytes
//          [off + 2w j, off + 2w (j + 1)); digit i is the little-endian u16
//          at byte 2i of the candidate, the top digit ANDed with top_mask; a
//          lane is accepted iff the candidate is < p (compared from the top;
//          equal is rejected, as limb.geq decides); an accepted lane writes
//          its w digits into out[:, base + lane] (int64 planes, row stride
//          `stride`); the rejected lanes, in order, are the next round's
//          need list; off grows by 2w m_r;
//   RAW:   k bytes copied to raw[base, base + k); off grows by k.
//
// Whether a candidate is accepted does not depend on the lane that takes
// it, so a segment's rounds are not run one after another.  Number the
// candidates from the segment's first byte (c = 0, 1, ...; round r takes
// c in [B_r, B_r + m_r), B_0 = 0, B_(r+1) = B_r + m_r); with R(x) the
// rejects among candidates [0, x), m_(r+1) = R(B_r + m_r) - R(B_r).  The
// launch is one cluster of kCluster = 8 blocks of 512 threads, one an SM,
// and does, a field segment:
//   1. flags, split over the cluster's warps in chunks of up to 4 groups
//      of 32 candidates: a warp stages a chunk's bytes in its shared slab
//      with 16-byte loads (up to 8 a lane in flight) and tests each
//      candidate from its top 32-bit word down, a ballot a word of reject
//      bits, which it stores into every block's tile (distributed shared
//      memory; a cluster barrier ends the pass); round 0's accepted
//      candidates (c < m_0, lane c or need[pp][c]) write their digits here;
//   2. in every block, a block-wide exclusive scan of the words' reject
//      counts (warp shuffles, then the warps' totals), so R(x) is one
//      lookup and a popc, and rej[k] = the k-th reject's candidate;
//   3. in every block, one thread walks the rounds' boundaries B_r, m_r
//      from R, O(1) a round, into a table in shared memory; where a round
//      passes the flagged candidates the cluster flags further (step 1
//      again, to the expected end of the rounds left), where it would pass
//      `avail` the segment stops there (WANT);
//   4. split over the cluster's warps as the flags are, each accepted
//      candidate of round r >= 1 at position j, staged again, finds its
//      lane by walking back: j <- rej[R(B_(r-1)) + j] - B_(r-1) down to
//      round 0, where the lane is j (a fresh segment) or need[pp][j] (a
//      resumed round), and writes its w digits from the warp's slab.  A
//      segment that stops writes the pending round's need list by the same
//      walk.
// The tile (reject bits, by the segment's parity, so that a block may flag
// the next segment into another block's tile while that one still reads
// the last; counts; rej) lives in shared memory up to sh_cap candidates; a
// segment that needs more moves it to a scratch area in device memory
// (int32, from the wrapper, as large as the read-ahead's candidates, an
// area a block).  A segment of at most 32 lanes (Buckler's blinds) takes a warp-only path:
// warp 0 runs the host loop's rounds itself, one candidate a lane, from a
// window of up to 128 candidates staged at once, through the run of such
// segments, with no block barrier.  The counts S_ROUNDS and S_CHUNKS
// (ceil(m_r / 1024) a round) are computed from the rounds.
//
// Every block so holds the whole segment's counts, rounds and lanes, and
// writes only its share of the output (chunks of candidates, raw bytes and
// need lists by index): one block alone took 0.131 ms for a commit's draw
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), its time growing with the
// candidates as one SM's shared-memory and store bandwidth would have it
// (the draw writes 1.2 MB of digits).  A pending need list that belongs in the half its segment's
// rounds read is written to the other half and moved after a cluster
// barrier.
//
// The launch returns to the host at the end (status DONE) or before a round
// or RAW copy whose bytes would pass `avail` (status WANT, `want` = the bytes
// it needs from the current offset), or after kMaxRounds rounds of one
// segment (WANT as well; the host reads ahead and relaunches): the host then
// commits the bytes used and relaunches, and the kernel resumes at the
// state it left (segment, lanes still needed, fresh list or not, ping-pong
// half of the need list int32 [2, nmax]).  The state (int64 [S_LEN]) comes
// in as an argument and goes out through st_out.
//
// What bounds it on the H100: neither bytes nor operations.  A commit's
// draws read ~0.57 MB of stream and write ~1.2 MB of digit planes (~0.5 us
// at 3.35 TB/s); a field segment costs about ten block barriers and one
// cluster barrier a flag pass, one serial walk of its ~20 rounds in shared
// memory, and per warp a staging round or two and the digit stores of its
// chunks, so the launch and those latencies set the time (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxW = 64;          // digits of the widest field (ZP880: 55)
constexpr int kThreads = 1024;     // candidates a chunk of the host loop
constexpr int kBlock = 512;        // threads a block
constexpr int kWarps = kBlock / 32;
constexpr int kMaxRounds = 256;    // rounds of one segment in a launch
constexpr int kTiny = 32;          // lanes at most of the warp-only path
constexpr int kSmem = 160 * 1024;  // dynamic shared memory: slabs and tile
constexpr int kVec = 8;            // 16-byte loads a lane in flight, staging
constexpr int kGroups = 4;         // groups of 32 candidates a warp stages
constexpr int kCluster = 8;        // blocks of the launch: one cluster

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
  A_NSEG, A_W, A_TOP_MASK, A_ST_OUT, A_SCRATCH, A_SCRATCH_CAP, A_P,
  A_ST = A_P + kMaxW, A_LEN = A_ST + S_LEN
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
  unsigned top_mask;       // of the top digit
  unsigned top_word;       // of the top 32-bit word
  float accept;            // p / 2^bits, about
  long long* st_out;       // int64 [S_LEN]
  int* scr;                // int32 [cap / 32 masks, cap / 32 counts, cap rej]
  long long scr_cap;       // candidates of the scratch area
  int slab;                // bytes of a warp's slab
  int groups;              // groups of 32 candidates a warp stages at once
  int sh_cap;              // candidates of the shared tile
  unsigned p[kMaxW / 2];   // p's 32-bit words, little-endian
  long long st[S_LEN];
};

// the flags of a segment's candidates: reject bits a word of 32, the rejects
// before each word, the rejects' candidates in order
struct Tile {
  unsigned* mask;
  int* pre;
  int* rej;
  long long cap;
};

// the 16 bytes at v, those outside [lo, hi) read as 0 (a read-ahead's ends)
__device__ __noinline__ uint4 edge_load(const uint8_t* v, const uint8_t* lo,
                                        const uint8_t* hi) {
  unsigned b[4] = {0, 0, 0, 0};
  for (int i = 0; i < 16; ++i)
    if (v + i >= lo && v + i < hi) b[i >> 2] |= (unsigned)v[i] << (8 * (i & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// the nbytes bytes at q (within [lo, hi) of the read-ahead) into the warp's
// slab, by aligned 16-byte loads, kVec a lane in flight at once; returns
// the slab offset of q.  Collective over the warp.
__device__ __forceinline__ int stage(const uint8_t* q, long long nbytes,
                                     const uint8_t* lo, const uint8_t* hi,
                                     uint4* slab, int lane) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(q) & ~uintptr_t(15);
  const int shift = (int)(reinterpret_cast<uintptr_t>(q) - a0);
  const int nvec = (int)((shift + nbytes + 15) >> 4);
  const uint8_t* v0 = reinterpret_cast<const uint8_t*>(a0);
  __syncwarp();   // the slab's last readers are done
  for (int k0 = 0; k0 < nvec; k0 += 32 * kVec) {
    uint4 r[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int k = k0 + lane + 32 * i;
      const uint8_t* v = v0 + 16 * k;
      if (k < nvec)
        r[i] = v >= lo && v + 16 <= hi ? __ldg(reinterpret_cast<const uint4*>(v))
                                       : edge_load(v, lo, hi);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int k = k0 + lane + 32 * i;
      if (k < nvec) slab[k] = r[i];
    }
  }
  __syncwarp();
  return shift;
}

// the little-endian 32-bit word at byte o of a slab
__device__ __forceinline__ unsigned slab_word(const unsigned* s, int o) {
  return __funnelshift_r(s[o >> 2], s[(o >> 2) + 1], 8 * (o & 3));
}

// whether the candidate at byte o of a slab is >= p: its words from the
// top (the top one masked; at odd w its upper half, the next candidate's
// bytes, is masked off), equal to p rejected
__device__ __forceinline__ bool rejected(const unsigned* s, int o, int hw,
                                         unsigned top_word, const unsigned* p) {
  for (int k = hw - 1; k >= 0; --k) {
    unsigned v = slab_word(s, o + 4 * k);
    if (k == hw - 1) v &= top_word;
    if (v != p[k]) return v > p[k];
  }
  return true;
}

// the candidate's w digits at byte o of a slab into out[:, lane]: two
// digits a funnel shift of two slab words, the loads of an iteration
// independent of the last one's (so the unrolled loop overlaps them), the
// top digit masked
__device__ __forceinline__ void write_digits(const Args& a, const unsigned* s,
                                             int o, long long* out) {
  const unsigned* q = s + (o >> 2);
  const int sh = 8 * (o & 3), top = (a.w - 1) / 2;   // words below the top
  const long long st = a.stride;
#pragma unroll 4
  for (int k = 0; k < top; ++k) {
    const unsigned v = __funnelshift_r(q[k], q[k + 1], sh);
    out[2 * k * st] = v & 0xFFFFu;
    out[(2 * k + 1) * st] = v >> 16;
  }
  const unsigned v = __funnelshift_r(q[top], q[top + 1], sh);
  if (a.w % 2) {
    out[(a.w - 1) * st] = v & a.top_mask;
  } else {
    out[(a.w - 2) * st] = v & 0xFFFFu;
    out[(a.w - 1) * st] = (v >> 16) & a.top_mask;
  }
}

// R(x) for x <= F: the rejects before word x / 32 and the word's bits below
// x (tot at x = F)
__device__ __forceinline__ long long rejects_before(const Tile& t, long long F,
                                                    long long tot, long long x) {
  if (x >= F) return tot;
  return t.pre[x >> 5] + __popc(t.mask[x >> 5] & ((1u << (x & 31)) - 1u));
}

// the lane of position j of round r: the walk back to round 0
__device__ __forceinline__ long long lane_of(const Tile& t, const long long* rB,
                                             const long long* rR, int r,
                                             long long j, int fresh,
                                             const int* need) {
  for (; r > 0; --r) j = t.rej[rR[r - 1] + j] - rB[r - 1];
  return fresh ? j : need[j];
}

// groups of 32 candidates in a chunk: as many as spread `groups` over the
// cluster's warps, at most K (a slab's)
__device__ __forceinline__ int chunk_groups(int K, int groups) {
  const int per = (groups + kCluster * kWarps - 1) / (kCluster * kWarps);
  return per < 1 ? 1 : per < K ? per : K;
}

// field f (kind, count, output base) of the segment table's entry k, read
// from device memory where it is used: holding the base in a register
// across the block path spilled at 128 registers (PERF.md)
__device__ __forceinline__ long long seg_at(const Args& a, long long k, int f) {
  return __ldg(a.segs + 3 * k + f);
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// block r's scratch area: reject bits of two segments (by parity), the
// counts, the rejects' candidates
__device__ __forceinline__ int* area(const Args& a, int r) {
  return a.scr + r * (3 * (a.scr_cap / 32) + a.scr_cap);
}

// word g of block r's reject bits of the segment of parity par: in its
// shared tile (the same offset in every block) or, once the segment's tile
// moved, in its scratch area
__device__ __forceinline__ unsigned* mask_in(const Args& a, const Tile& t,
                                             bool moved, int par, int r,
                                             long long g) {
  if (moved)
    return reinterpret_cast<unsigned*>(area(a, r) + par * (a.scr_cap / 32)) + g;
  return cg::this_cluster().map_shared_rank(t.mask + g, r);
}

// The cluster's kCluster blocks (one an SM) each hold the whole draw's
// flags, counts, rounds and lanes (the same in every block) and flag and
// write only their share of it: candidate groups of 32 in chunks (as many
// groups as spread the pass over the cluster's warps, at most `groups`),
// chunk q to block q mod kCluster; raw bytes and need lists by index; the
// warp-only path's digits and the state from block 0.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kBlock)
    field_sample_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint4 smem[];
  __shared__ unsigned sp[kMaxW / 2];
  __shared__ long long rB[kMaxRounds], rM[kMaxRounds], rR[kMaxRounds];
  __shared__ int wsum[kWarps + 1];
  __shared__ long long sv[8];
  __shared__ int tiny_ln[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rank = blockIdx.x;
  const int w = a.w, hw = (w + 1) / 2, K = a.groups;
  const long long nb = 2ll * w;   // stream bytes of a candidate
  uint4* slab4 = smem + wid * (a.slab / 16);
  const unsigned* slab = reinterpret_cast<const unsigned*>(slab4);
  // the tile: reject bits of two segments (by parity: a block may flag the
  // next segment into another block's tile while that one still reads the
  // last segment's), the counts, the rejects' candidates
  unsigned* sh_mask = reinterpret_cast<unsigned*>(smem + kWarps * (a.slab / 16));
  int* sh_pre = reinterpret_cast<int*>(sh_mask + 2 * (a.sh_cap / 32));
  int* sh_rej = sh_pre + a.sh_cap / 32;
  int par = 1;   // parity of the block-path segments
  if (tid < hw) sp[tid] = a.p[tid];
  __syncthreads();
  const uint8_t* src = a.win + a.start;
  const uint8_t* lo = a.win;
  const uint8_t* hi = src + a.avail;
  // the loop's state: identical in every thread of the cluster
  long long seg = a.st[S_SEG], m = a.st[S_M], off = a.st[S_OFF];
  int fresh = (int)a.st[S_FRESH], pp = (int)a.st[S_PP];
  long long rounds = a.st[S_ROUNDS], chunks = a.st[S_CHUNKS], want = 0;
  int status = DONE;
  // a stopped segment leaves its pending need list in half pp0 ^ 1 (pp0:
  // the half its first round read); `move` = it belongs in half pp0
  int pp0 = pp, move = 0;
  while (seg < a.nseg) {
    const long long kind = seg_at(a, seg, 0), cnt = seg_at(a, seg, 1);
    if (kind == RAW) {
      if (off + cnt > a.avail) {
        status = WANT;
        want = cnt;
        break;
      }
      for (long long k = rank * kBlock + tid; k < cnt; k += kCluster * kBlock)
        a.raw[seg_at(a, seg, 2) + k] = src[off + k];
      off += cnt;
      ++seg;
      continue;
    }
    if (m < 0) {  // the segment starts: every lane needed, in order
      m = cnt;
      fresh = 1;
    }
    if (m == 0) {
      ++seg;
      m = -1;
      continue;
    }
    pp0 = pp;
    if (m <= kTiny) {
      // ---- warp 0 runs the host loop's rounds through this run of small
      // field segments, from a window of the stream staged in its slab
      // (restaged where a round passes it); the block takes its state after
      // one barrier
      if (wid == 0) {
        const long long cap = (long long)K * 32 * nb;   // bytes a window
        long long wb = 0, we = 0;                        // the window
        int sh = 0;
        while (true) {
          const long long sbase = seg_at(a, seg, 2);
          pp0 = pp;
          int ln = lane < m ? (fresh ? lane : a.need[pp * a.nmax + lane]) : 0;
          int done = 0;
          while (m > 0) {
            if (off + nb * m > a.avail) {
              status = WANT;
              want = nb * m;
              if (done) {   // the pending lanes, into half pp0 ^ 1
                if (rank == 0 && lane < m) a.need[(pp0 ^ 1) * a.nmax + lane] = ln;
                move = (done & 1) == 0;
              }
              break;
            }
            if (off < wb || off + nb * m > we) {
              wb = off;
              we = off + (a.avail - off < cap ? a.avail - off : cap);
              sh = stage(src + wb, we - wb, lo, hi, slab4, lane);
            }
            bool rej = false;
            if (lane < m) {
              const int o = sh + (int)(off - wb) + (int)nb * lane;
              rej = rejected(slab, o, hw, a.top_word, sp);
              if (!rej && rank == 0) write_digits(a, slab, o, a.out + sbase + ln);
            }
            const unsigned bal = __ballot_sync(0xFFFFFFFFu, rej);
            if (rej) tiny_ln[__popc(bal & ((1u << lane) - 1u))] = ln;
            __syncwarp();
            off += nb * m;
            m = __popc(bal);
            ln = lane < m ? tiny_ln[lane] : 0;
            __syncwarp();
            fresh = 0;
            pp ^= 1;
            ++rounds;
            ++chunks;
            ++done;
          }
          if (status == WANT) break;
          ++seg;
          m = -1;
          if (seg >= a.nseg || seg_at(a, seg, 0) != FIELD ||
              seg_at(a, seg, 1) > kTiny)
            break;
          m = seg_at(a, seg, 1);   // an empty one takes no round
          fresh = 1;
        }
        if (lane == 0) {
          sv[0] = seg; sv[1] = m; sv[2] = off; sv[3] = fresh;
          sv[4] = pp | pp0 << 1 | move << 2; sv[5] = rounds; sv[6] = chunks;
          sv[7] = status == WANT ? want : -1;
        }
      }
      __syncthreads();
      seg = sv[0]; m = sv[1]; off = sv[2]; fresh = (int)sv[3];
      pp = (int)sv[4] & 1; pp0 = ((int)sv[4] >> 1) & 1; move = (int)sv[4] >> 2;
      rounds = sv[5]; chunks = sv[6];
      if (sv[7] >= 0) {
        status = WANT;
        want = sv[7];
      }
      __syncthreads();   // sv is written again by the next run
      if (status == WANT) break;
      continue;
    }

    // ---- the block path: flags, scan, boundaries, walk-back
    const int* need = a.need + (long long)pp * a.nmax;
    const long long rd = (a.avail - off) / nb;   // candidates readable
    const uint8_t* sb = src + off;                // candidate 0
    par ^= 1;
    Tile t{sh_mask + par * (a.sh_cap / 32), sh_pre, sh_rej, a.sh_cap};
    bool moved = false;         // the tile in the scratch area
    long long F = 0, tot = 0;   // candidates flagged, rejects among them
    long long B = 0, mm = m;    // the round the walk stands at
    int nr = 0, pend = 0;       // rounds walked; stopped before round nr
    while (true) {
      if (tid == 0) {
        long long RB = rejects_before(t, F, tot, B);
        while (mm > 0) {
          if (nr == kMaxRounds || B + mm > rd) {
            pend = 1;
            break;
          }
          if (B + mm > F) break;   // flag further first
          rB[nr] = B;
          rM[nr] = mm;
          rR[nr] = RB;
          const long long RE = rejects_before(t, F, tot, B + mm);
          B += mm;
          mm = RE - RB;
          RB = RE;
          ++nr;
        }
        sv[0] = B; sv[1] = mm; sv[2] = nr; sv[3] = pend;
      }
      __syncthreads();
      B = sv[0]; mm = sv[1]; nr = (int)sv[2]; pend = (int)sv[3];
      if (mm == 0 || pend) break;
      // flag [F, F1): to the expected end of the rounds left, within reach
      long long F1 = B + (long long)((float)mm / a.accept * 1.0625f) + 64;
      F1 = (F1 + 31) & ~31ll;
      if (F1 > rd) F1 = rd;
      if (F1 > t.cap) {   // the shared tile is full: move to the scratch area
        const long long cw = a.scr_cap / 32;
        int* own = area(a, rank);
        const Tile g{reinterpret_cast<unsigned*>(own + par * cw), own + 2 * cw,
                     own + 3 * cw, a.scr_cap};
        for (long long i = tid; i < (F + 31) / 32; i += kBlock) {
          g.mask[i] = t.mask[i];
          g.pre[i] = t.pre[i];
        }
        for (long long i = tid; i < tot; i += kBlock) g.rej[i] = t.rej[i];
        __syncthreads();
        t = g;
        moved = true;
      }
      // this block flags its chunks of groups of 32 (chunk q = g / KF,
      // block q mod kCluster) and sends each reject word to every block's
      // tile (round 0, candidates [0, m), writes its accepted lanes here:
      // its lanes are j or need[pp][j], and the pass covers it whole).
      // Group and chunk indices fit 32 bits (a tile holds < 2^31
      // candidates).
      const int G0 = (int)(F / 32), G1 = (int)((F1 + 31) / 32);
      const int KF = chunk_groups(K, G1 - G0);
      const int q0 = G0 / KF, q1 = (G1 + KF - 1) / KF;
      for (int q = q0 - q0 % kCluster + rank + kCluster * wid; q < q1;
           q += kCluster * kWarps) {
        if (q < q0) continue;
        const int gs = q * KF > G0 ? q * KF : G0;
        const int ge = q * KF + KF < G1 ? q * KF + KF : G1;
        const long long c0 = 32ll * gs;
        const long long n = F1 - c0 < 32 * (ge - gs) ? F1 - c0 : 32 * (ge - gs);
        const int sh = stage(sb + nb * c0, nb * n, lo, hi, slab4, lane);
        for (int g = gs; g < ge; ++g) {
          const int j = 32 * (g - gs) + lane, o = sh + (int)nb * j;
          const bool rej = j < n && rejected(slab, o, hw, a.top_word, sp);
          const unsigned bal = __ballot_sync(0xFFFFFFFFu, rej);
          if (lane < kCluster) *mask_in(a, t, moved, par, lane, g) = bal;
          const long long c = c0 + j;
          if (j < n && !rej && c < m)
            write_digits(a, slab, o,
                         a.out + seg_at(a, seg, 2) + (fresh ? c : need[c]));
        }
      }
      cluster_sync();
      // the rejects before each new word, carried from tot
      long long carry = tot;
      for (long long g0 = G0; g0 < G1; g0 += kBlock) {
        const long long gi = g0 + tid;
        const int v = gi < G1 ? __popc(t.mask[gi]) : 0;
        int incl = v;
        for (int s = 1; s < 32; s <<= 1) {
          const int u = __shfl_up_sync(0xFFFFFFFFu, incl, s);
          if (lane >= s) incl += u;
        }
        if (lane == 31) wsum[wid] = incl;
        __syncthreads();
        if (wid == 0) {
          const int x = lane < kWarps ? wsum[lane] : 0;
          int xi = x;
          for (int s = 1; s < 32; s <<= 1) {
            const int u = __shfl_up_sync(0xFFFFFFFFu, xi, s);
            if (lane >= s) xi += u;
          }
          if (lane < kWarps) wsum[lane] = xi - x;
          if (lane == 31) wsum[kWarps] = xi;
        }
        __syncthreads();
        if (gi < G1) t.pre[gi] = (int)(carry + wsum[wid] + incl - v);
        carry += wsum[kWarps];
        __syncthreads();   // wsum is written again
      }
      for (long long gi = G0 + tid; gi < G1; gi += kBlock) {   // rej, a word
        unsigned mk = t.mask[gi];                                  // a thread
        for (int k = t.pre[gi]; mk; mk &= mk - 1u) t.rej[k++] = (int)(32 * gi + __ffs(mk) - 1);
      }
      F = F1;
      tot = carry;
      __syncthreads();
    }
    // rounds 0 .. nr - 1 are complete: candidates [0, B) consumed.  Rounds
    // 1 .. nr - 1 (candidates [m, B)): this block's chunks, lanes by the
    // walk back
    {
      const int gm = (int)(m / 32), g1 = (int)((B + 31) / 32);
      const int KW = chunk_groups(K, g1 - gm), qs = gm / KW;
      for (int q = qs - qs % kCluster + rank + kCluster * wid; q * KW < g1;
           q += kCluster * kWarps) {
        if (q < qs) continue;
        const long long c0 = 32ll * q * KW;
        const long long n = B - c0 < 32 * KW ? B - c0 : 32 * KW;
        const int sh = stage(sb + nb * c0, nb * n, lo, hi, slab4, lane);
        for (int j = lane; j < n; j += 32) {
          const long long c = c0 + j;
          if (c < m || ((t.mask[c >> 5] >> (c & 31)) & 1u)) continue;
          int r0 = 1, r1 = nr - 1;   // the last round starting at or before c
          while (r0 < r1) {
            const int mid = (r0 + r1 + 1) >> 1;
            if (rB[mid] <= c) r0 = mid;
            else r1 = mid - 1;
          }
          write_digits(a, slab, sh + (int)nb * j,
                       a.out + seg_at(a, seg, 2) +
                           lane_of(t, rB, rR, r0, c - rB[r0], fresh, need));
        }
      }
    }
    // a stopped segment: the pending round's need list, into half pp ^ 1
    if (pend && nr > 0) {
      for (long long j = rank * kBlock + tid; j < mm; j += kCluster * kBlock)
        a.need[(pp ^ 1) * a.nmax + j] = (int)lane_of(
            t, rB, rR, nr - 1, t.rej[rR[nr - 1] + j] - rB[nr - 1], fresh, need);
      move = (nr & 1) == 0;
    }
    off += nb * B;
    rounds += nr;
    for (int r = 0; r < nr; ++r) chunks += (rM[r] + kThreads - 1) / kThreads;
    if (nr > 0) {
      fresh = 0;
      pp ^= nr & 1;
    }
    __syncthreads();   // the slabs, the tile and the round table are reused
    if (pend) {
      m = mm;
      status = WANT;
      want = nb * mm;
      break;
    }
    ++seg;
    m = -1;
  }
  // a pending list that belongs in the half its segment's first round read:
  // moved there once every block has read that half
  if (move) {
    cluster_sync();
    for (long long j = rank * kBlock + tid; j < m; j += kCluster * kBlock)
      a.need[pp0 * a.nmax + j] = a.need[(pp0 ^ 1) * a.nmax + j];
  }
  if (rank == 0 && tid == 0) {
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
// zero above w), the scratch area (int32, kCluster areas of 3 cap / 32 +
// cap, cap = A_SCRATCH_CAP candidates: at least avail / 2w + 32, a
// multiple of 32) and the state (A_ST..).
// Returns the CUDA error of the launch (0 = success).
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
  a.scr = (int*)args[A_SCRATCH];
  a.scr_cap = args[A_SCRATCH_CAP];
  for (int i = 0; i < S_LEN; ++i) a.st[i] = args[A_ST + i];
  if (a.win == nullptr || a.segs == nullptr || a.st_out == nullptr ||
      a.scr == nullptr || a.nseg <= 0 || a.w < 1 || a.w > kMaxW ||
      a.top_mask > 0xFFFFu || a.start < 0 || a.avail < 0 || a.nmax < 0 ||
      a.nmax >= (1ll << 31) || a.stride < 0 || a.st[S_SEG] < 0 ||
      a.st[S_SEG] > a.nseg || a.scr_cap % 32 ||
      a.scr_cap < a.avail / (2 * a.w) + 32 || a.scr_cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int w = a.w, hw = (w + 1) / 2;
  for (int k = 0; k < kMaxW / 2; ++k)
    a.p[k] = (unsigned)args[A_P + 2 * k] | (unsigned)args[A_P + 2 * k + 1] << 16;
  a.top_word = w % 2 ? a.top_mask : a.top_mask << 16 | 0xFFFFu;
  a.accept = ((float)a.p[hw - 1] + 1.0f) / ((float)a.top_word + 1.0f);
  // a warp's slab: `groups` x 32 candidates (as many as kVec loads a lane
  // stage in one round, at most kGroups), the 16-byte alignment before and
  // after, one more vector for the word reads past the last byte
  a.groups = (int)((32 * kVec * 16 - 30) / (64 * w));
  if (a.groups > kGroups) a.groups = kGroups;
  if (a.groups < 1) a.groups = 1;
  a.slab = (int)(((a.groups * 64 * w + 30) / 16) * 16 + 16);
  const long long rest = kSmem - (long long)kWarps * a.slab;
  a.sh_cap = (int)(rest * 32 / (32 * 4 + 12) / 1024 * 1024);
  const int smem = kWarps * a.slab + a.sh_cap * 4 + a.sh_cap / 32 * 12;
  cudaError_t err = cudaFuncSetAttribute(
      field_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  field_sample_kernel<<<kCluster, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
