// merkle_roots: the blob ids of a pass's chunks from its page-digest
// table, one launch.
//
// Replaces the root stage of volsync_tpu/ops/segment.py
// _root_digests_loop: a while_loop that gathers [C, 17] digest words a
// step, splices them into "VMRK1" || le64(len) || leaf digests message
// blocks and runs one SHA-256 compression per lane (the XLA sha256_blocks
// scan, ops/sha256.py:145). Lane c's digest stream is D(t) = word t % 8
// of page page0[c] + t / 8 (word-major table: flat[j * npp + p];
// page-major: flat[p * 8 + j]); the 13-byte header shifts it to byte 13,
// so message word q is (D(q-4) << 24) | (D(q-3) >> 8) with D zero outside
// [0, 8 * nleaves), words 0..2 are the header constants, the FIPS 0x80
// terminator lands in word 3 + 8 * nleaves and the bit length in word
// 16 * nb - 1. As in the reference, a lane with no leaves (every dead
// lane) hashes the empty leaf list (one block), every lane stays at H0
// when no lane is live, and no lane runs more than nb_max blocks. The
// tail-leaf override is applied to the table before the launch.
//
// What bounds it on the H100. A lane is a serial chain of 64 rounds a
// block, and a pass's lanes are few and uneven: a fused segment has ~37
// live lanes of 65-1,025 blocks, a batched pass of 16 lanes of 32 MiB
// ~440 beside ~1,600 dead ones. So the launch takes at least its
// longest lane's chain, and three things decide how close it comes:
//
// - The issue of a round. A round is 10 logic and shift instructions
//   (Sigma0, Sigma1: 3 funnel shifts + 1 LOP3 each; Ch, Maj: 1 LOP3
//   each) and 4 sums of 2-3 terms. The logic and shifts issue only on
//   the sub-partition's 16-lane integer ALU pipe, 2 cycles a warp
//   instruction: 20 cycles a round. An add compiled as IADD3 goes there
//   too (left to ptxas, a round had 12 ALU instructions, 28.7 cycles).
//   Here every add is an IMAD (mad.lo by a 1 that ptxas cannot see,
//   the kernel's ``one`` argument) on the FMA pipe beside it, so the
//   ALU pipe carries the 10 alone (SASS a block: 640 LOP3/SHF, 521
//   IMAD, no IADD3). The chain of e is 3 dependent instructions (funnel
//   shift, LOP3, add): d + h + K[t] + W[t] and (T1's) h + K[t] + W[t]
//   are summed rounds ahead, off the chain, and Ch joins them before
//   Sigma1 is ready; a lags e by two instructions and feeds d three
//   rounds later. A lone warp still takes ~25.7 cycles a round: its
//   in-order issue stalls between dependent instructions.
// - Placement. Two chains on one sub-partition share its ALU pipe, each
//   at about half speed. The grid is one block a SM (its dynamic shared
//   memory lets no second block in), four warps a block, one a
//   sub-partition. Every block sorts the lanes itself, the same way: a
//   counting sort by block count, longest first (448 log-spaced keys,
//   16 an octave; each warp ranks a quarter of the lanes in index order
//   with one ballot a key bit), and warp w takes the ranks a snake over
//   the W warps gives it (w, 2W-1-w, 2W+w, ...): the longest lanes get
//   a sub-partition each, later rounds even the sums. No host sync, no
//   library sort, no state across launches: a graph replay does the
//   same, and the digests do not depend on the order. Above kLanesCap
//   lanes the sort does not fit in shared memory and each lane runs as
//   a chain in index order.
// - Short lanes. A lane whose key is at most that of longest / 4 blocks
//   (every dead lane) runs one a thread, 32 a warp, its own schedule in
//   registers (as sha256_lanes): 1,024 logic and shift instructions a
//   block for 32 lanes where a warp's chain issues 640 for one. In the
//   sorted order the short lanes follow the chains, so each group of 32
//   holds lanes of like length; a group ranks as a chain of twice the
//   limit.
//
// A chain's warp streams its lane's digests through a two-tile ring in
// shared memory with cp.async: a tile is 64 pages of digests (512
// words, 2 KiB; word-major: 8 runs of 64 contiguous words, 4-byte
// copies coalesced across the warp; page-major: 2 KiB contiguous, 16-byte
// copies), and tile k+1 is in flight while the chain consumes tile k (32
// message blocks). At the start of each tile the 32 threads build the 32
// blocks' message words, one block a thread, expand their schedules and
// store K[t] + W[t] in shared memory (a 68-word row a block, so the
// 16-byte stores of 8 threads hit 32 banks); the chain then runs on
// every thread of the warp alike and reads four rounds' K + W with one
// warp-uniform 16-byte load (a broadcast). Threads 0-7 write the state.
//
// vt_merkle_roots_split launches the same kernel with clock64 and
// %globaltimer reads around its phases and writes one MerkleSplit record
// a warp (never a product path; tools/time_root_calls.py reads it).
#include "common.cuh"
#include "sha256.cuh"

static constexpr int kWarps = 4;  // a block's warps: one a sub-partition
static constexpr int kThreads = 32 * kWarps;
static constexpr int kTilePages = 64;
static constexpr int kTileWords = 8 * kTilePages;    // 512
static constexpr int kTileBlocks = kTileWords / 16;  // 32 message blocks
static constexpr int kKwStride = 64 + 4;  // words of a block's K+W row
static constexpr int kKeys = 448;         // lane_key's range
static constexpr int kLanesCap = 16384;   // lanes the placement sorts
// One block a SM (two of these do not fit in its 228 KB).
static constexpr int kSmemBytes = 160 * 1024;
static constexpr uint32_t kDomainWord0 = 0x564D524Bu;  // "VMRK"
static constexpr uint32_t kDomainByte4 = 0x31u;         // "1"

// One warp's record in the split instances: where it ran, when, what it
// hashed and the SM cycles of its phases.
enum MerkleSplit {
  kSplitSm,          // %smid
  kSplitSub,         // %warpid & 3: the SM sub-partition (scheduler)
  kSplitT0,          // %globaltimer (ns) at the warp's start
  kSplitT1,          // ... and at its end
  kSplitCycles,      // clock64 from start to end
  kSplitLong,        // lanes the warp ran as a warp's chain
  kSplitLongBlocks,  // their blocks
  kSplitShort,       // lanes it ran one a thread
  kSplitShortBlocks, // their longest lanes' blocks, summed over groups
  kSplitPrologue,    // cycles outside lanes (liveness, the sort, ranks)
  kSplitBuild,       // message words, schedules and K+W stores
  kSplitWait,        // cp.async waits
  kSplitRounds,      // the chains' rounds
  kSplitShortCyc,    // the one-a-thread groups
  kSplitLane,        // the warp's longest chain lane
  kSplitLaneBlocks,  // its blocks
  kSplitPass1,       // cycles until the sorted table is ready
  kSplitN
};

struct WarpRing {
  uint32_t d[2][kTileWords];             // digest tiles, slot k & 1
  uint32_t kw[kTileBlocks][kKwStride];   // K[t] + W[t] of the tile's blocks
};

struct BlockShared {
  WarpRing ring[kWarps];
  int cnt[kWarps][kKeys];     // lanes of a key in a warp's quarter, then
                              // their first place in the sorted table
  int kstart[kKeys];          // lanes of longer keys
  int longest;                // the longest lane's blocks
  unsigned short key[kLanesCap];     // a lane's key
  unsigned short local[kLanesCap];   // its place among its quarter's key
  unsigned short sorted[kLanesCap];  // lanes longest key first
};
static_assert(sizeof(BlockShared) <= kSmemBytes, "shared memory");

__device__ __forceinline__ long long vt_globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int vt_smid() {
  int v;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int vt_warpid() {
  int v;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(v));
  return v;
}

// x + y as an IMAD (x * one + y) on the FMA pipe; ``one`` is 1 and comes
// from a kernel argument, so ptxas cannot fold it into an IADD3.
__device__ __forceinline__ uint32_t fadd(uint32_t x, uint32_t y,
                                         uint32_t one) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(one), "r"(y));
  return d;
}

// Blocks lane c runs (its message's, at most nb_max).
__device__ __forceinline__ int lane_nb(const int64_t* __restrict__ nleaves,
                                       int c, int nb_max) {
  const long long nl = nleaves[c] < 0 ? 0 : nleaves[c];
  const long long nb = (32 * nl + 13 + 9 + 63) / 64;
  return nb < nb_max ? static_cast<int>(nb) : (nb_max < 0 ? 0 : nb_max);
}

// A monotone key of a block count: exact below 32, then 16 a doubling.
__device__ __forceinline__ int lane_key(int nb) {
  if (nb < 32) return nb;
  const int e = 31 - __clz(nb);
  return 32 + (e - 5) * 16 + ((nb >> (e - 4)) & 15);
}

// Digest word t of the stream from the ring (0 outside [0, nl8)); both
// the current tile and the one before it are resident.
template <bool kPageMajor>
__device__ __forceinline__ uint32_t ring_word(const WarpRing& r, int t,
                                              int nl8) {
  if (t < 0 || t >= nl8) return 0u;
  const int slot = (t / kTileWords) & 1;
  const int i = t % kTileWords;
  return kPageMajor ? r.d[slot][i] : r.d[slot][(i & 7) * kTilePages + (i >> 3)];
}

// Copies of tile k (pages 64k.. of the lane's stream) into slot k & 1;
// pages past the stream are not read.
template <bool kPageMajor>
__device__ __forceinline__ void issue_tile(WarpRing& r, const uint32_t* flat,
                                           long long flat_len, int npp,
                                           long long page0, long long nl,
                                           int k, int lane) {
  uint32_t* slot = r.d[k & 1];
  const long long pl0 = static_cast<long long>(k) * kTilePages;
  if (kPageMajor) {
#pragma unroll
    for (int q = 0; q < kTileWords / 4 / 32; ++q) {  // 4 x 16 B a thread
      const int w = (q * 32 + lane) * 4;
      const long long g = (page0 + pl0) * 8 + w;
      const bool ok = pl0 + w / 8 < nl && g >= 0 && g + 4 <= flat_len;
      vt_cp_async16(slot + w, ok ? flat + g : flat, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kTileWords / 32; ++q) {  // 16 x 4 B a thread
      const int j = q >> 1;
      const int pp = (q & 1) * 32 + lane;
      const long long g = static_cast<long long>(j) * npp + page0 + pl0 + pp;
      const bool ok = pl0 + pp < nl && g >= 0 && g < flat_len;
      vt_cp_async4(slot + j * kTilePages + pp, ok ? flat + g : flat,
                   ok ? 4 : 0);
    }
  }
  vt_cp_async_commit();
}

// The header words of a lane's message: w1 = "1" || le32(len) bytes 0-2,
// w2 = len byte 3 (bytes 4-7 of le64(len) are zero below 4 GiB).
__device__ __forceinline__ uint32_t header_w1(uint32_t len) {
  return (kDomainByte4 << 24) | ((len & 0xFFu) << 16) |
         (((len >> 8) & 0xFFu) << 8) | ((len >> 16) & 0xFFu);
}

__device__ __forceinline__ uint32_t header_w2(uint32_t len) {
  return ((len >> 24) & 0xFFu) << 24;
}

// One lane as one warp's chain (every thread of the warp calls it with
// the same c; any lane is live).
template <bool kPageMajor, bool kSplit>
__device__ __forceinline__ void run_chain(
    WarpRing& r, const uint32_t* __restrict__ flat, long long flat_len,
    int npp, const int64_t* __restrict__ page0,
    const int64_t* __restrict__ nleaves, const int64_t* __restrict__ lens,
    uint32_t* __restrict__ out, int c, int nb_max, uint32_t one, int lane,
    long long* acc) {
  long long c0 = 0, c1 = 0;
  if (kSplit) c0 = clock64();
  const long long nl = nleaves[c] < 0 ? 0 : nleaves[c];
  const long long nb = (32 * nl + 13 + 9 + 63) / 64;
  const int nb_run = lane_nb(nleaves, c, nb_max);
  // Words past block nb_run are never read: int indices suffice.
  const int nl8 = static_cast<int>(8 * nl < 16LL * nb_run ? 8 * nl
                                                          : 16LL * nb_run);
  const long long qterm = 3 + 8 * nl;
  const long long qlen = nb * 16 - 1;
  const uint32_t bitlen = static_cast<uint32_t>((13 + 32 * nl) * 8);
  const uint32_t len = static_cast<uint32_t>(lens[c]);
  const uint32_t w1 = header_w1(len), w2 = header_w2(len);
  const long long p0 = page0[c];

  uint32_t s[8];
  sha256_init(s);
  __syncwarp();  // the ring's last reader (an earlier lane) is done
  if (nb_run > 0 && nl8 > 0) {
    issue_tile<kPageMajor>(r, flat, flat_len, npp, p0, nl, 0, lane);
  }
  for (int m0 = 0; m0 < nb_run; m0 += kTileBlocks) {
    const int k = m0 / kTileBlocks;
    vt_cp_async_wait<0>();
    __syncwarp();  // tile k landed for every thread; last tile's kw read
    if (kSplit) {
      c1 = clock64(); acc[kSplitWait] += c1 - c0; c0 = c1;
    }
    {
      // This thread's block m = m0 + lane: its 16 message words from
      // digest words 16m-4 .. 16m+12, then its schedule, as K + W.
      const int m = m0 + lane;
      uint32_t w[16];
      uint32_t prev = ring_word<kPageMajor>(r, 16 * m - 4, nl8);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const long long q = 16LL * m + i;
        const uint32_t next = ring_word<kPageMajor>(r, 16 * m + i - 3, nl8);
        uint32_t v = (prev << 24) | (next >> 8);
        prev = next;
        if (q == 0) v = kDomainWord0;
        if (q == 1) v = w1;
        if (q == 2) v = w2;
        if (q == qterm) v |= 0x00800000u;
        if (q == qlen) v = bitlen;
        w[i] = v;
      }
      uint32_t* row = r.kw[lane];
#pragma unroll
      for (int t4 = 0; t4 < 64; t4 += 4) {
        uint32_t kw4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t4 + i;
          uint32_t wt;
          if (t < 16) {
            wt = w[t];
          } else {
            const uint32_t w15 = w[(t - 15) & 15];
            const uint32_t w2_ = w[(t - 2) & 15];
            const uint32_t s0 =
                vt_rotr(w15, 7) ^ vt_rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 =
                vt_rotr(w2_, 17) ^ vt_rotr(w2_, 19) ^ (w2_ >> 10);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
            w[t & 15] = wt;
          }
          kw4[i] = kSha256K[t] + wt;
        }
        *reinterpret_cast<uint4*>(row + t4) =
            make_uint4(kw4[0], kw4[1], kw4[2], kw4[3]);
      }
    }
    __syncwarp();  // kw visible; tile k-1 no longer read
    if ((k + 1) * kTileWords < nl8 && m0 + kTileBlocks < nb_run) {
      issue_tile<kPageMajor>(r, flat, flat_len, npp, p0, nl, k + 1, lane);
    }
    const int nblk = nb_run - m0 < kTileBlocks ? nb_run - m0 : kTileBlocks;
    if (kSplit) {
      c1 = clock64(); acc[kSplitBuild] += c1 - c0; c0 = c1;
    }
    for (int b = 0; b < nblk; ++b) {
      uint32_t a = s[0], bb = s[1], cc = s[2], d = s[3];
      uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
      const uint32_t* row = r.kw[b];
#pragma unroll
      for (int t4 = 0; t4 < 64; t4 += 4) {
        const uint4 q4 = *reinterpret_cast<const uint4*>(row + t4);
        const uint32_t kw4[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // h and d are e and a of three rounds ago: their sums with
          // K + W are ready long before e is.
          const uint32_t hk = fadd(h, kw4[i], one);
          const uint32_t dhk = fadd(d, hk, one);
          const uint32_t ch = g ^ (e & (f ^ g));
          const uint32_t S1 = vt_rotr(e, 6) ^ vt_rotr(e, 11) ^ vt_rotr(e, 25);
          const uint32_t maj = (a & (bb | cc)) | (bb & cc);
          const uint32_t S0 = vt_rotr(a, 2) ^ vt_rotr(a, 13) ^ vt_rotr(a, 22);
          const uint32_t e2 = fadd(fadd(dhk, ch, one), S1, one);
          const uint32_t t1 = fadd(fadd(hk, ch, one), S1, one);
          const uint32_t a2 = fadd(fadd(t1, maj, one), S0, one);
          h = g; g = f; f = e; e = e2;
          d = cc; cc = bb; bb = a; a = a2;
        }
      }
      s[0] = fadd(s[0], a, one); s[1] = fadd(s[1], bb, one);
      s[2] = fadd(s[2], cc, one); s[3] = fadd(s[3], d, one);
      s[4] = fadd(s[4], e, one); s[5] = fadd(s[5], f, one);
      s[6] = fadd(s[6], g, one); s[7] = fadd(s[7], h, one);
    }
    if (kSplit) {
      c1 = clock64(); acc[kSplitRounds] += c1 - c0; c0 = c1;
    }
  }
  uint32_t v = s[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    if (lane == j) v = s[j];
  }
  if (lane < 8) out[static_cast<size_t>(c) * 8 + lane] = v;
  if (kSplit) {
    ++acc[kSplitLong];
    acc[kSplitLongBlocks] += nb_run;
    if (nb_run > acc[kSplitLaneBlocks] || acc[kSplitLong] == 1) {
      acc[kSplitLane] = c;
      acc[kSplitLaneBlocks] = nb_run;
    }
  }
}

// Digest word t of lane p0's stream, from the table (0 outside [0, nl8)).
template <bool kPageMajor>
__device__ __forceinline__ uint32_t table_word(
    const uint32_t* __restrict__ flat, long long flat_len, int npp,
    long long p0, long long t, long long nl8) {
  if (t < 0 || t >= nl8) return 0u;
  const long long p = p0 + (t >> 3);
  const int j = static_cast<int>(t & 7);
  const long long g = kPageMajor ? p * 8 + j : static_cast<long long>(j) * npp + p;
  return g >= 0 && g < flat_len ? flat[g] : 0u;
}

// One short lane a thread (c < 0: none); any lane is live.
template <bool kPageMajor>
__device__ __forceinline__ int run_short(
    const uint32_t* __restrict__ flat, long long flat_len, int npp,
    const int64_t* __restrict__ page0, const int64_t* __restrict__ nleaves,
    const int64_t* __restrict__ lens, uint32_t* __restrict__ out, int c,
    int nb_max) {
  if (c < 0) return 0;
  const long long nl = nleaves[c] < 0 ? 0 : nleaves[c];
  const long long nl8 = 8 * nl;
  const long long nb = (32 * nl + 13 + 9 + 63) / 64;
  const int nb_run = lane_nb(nleaves, c, nb_max);
  const long long qterm = 3 + nl8;
  const uint32_t bitlen = static_cast<uint32_t>((13 + 32 * nl) * 8);
  const uint32_t len = static_cast<uint32_t>(lens[c]);
  const long long p0 = page0[c];
  uint32_t s[8];
  sha256_init(s);
  uint32_t d[17];
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    d[i] = table_word<kPageMajor>(flat, flat_len, npp, p0, i - 4, nl8);
  }
  for (int m = 0; m < nb_run; ++m) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long q = 16LL * m + i;
      uint32_t v = (d[i] << 24) | (d[i + 1] >> 8);
      if (q == qterm) v |= 0x00800000u;
      w[i] = v;
    }
    if (m == 0) {
      w[0] = kDomainWord0;
      w[1] = header_w1(len);
      w[2] = header_w2(len);
    }
    if (m == nb - 1) w[15] = bitlen;
    // the next block's words are loaded while this one compresses
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      d[i] = table_word<kPageMajor>(flat, flat_len, npp, p0,
                                    16LL * (m + 1) + i - 4, nl8);
    }
    sha256_compress(s, w);
  }
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(c) * 8);
  o[0] = make_uint4(s[0], s[1], s[2], s[3]);
  o[1] = make_uint4(s[4], s[5], s[6], s[7]);
  return nb_run;
}

template <bool kPageMajor, bool kSplit = false>
__global__ void __launch_bounds__(kThreads, 1)
merkle_roots_kernel(const uint32_t* __restrict__ flat, long long flat_len,
                    int npp, const int64_t* __restrict__ page0,
                    const int64_t* __restrict__ nleaves,
                    const int64_t* __restrict__ lens,
                    const bool* __restrict__ live, uint32_t* __restrict__ out,
                    int C, int nb_max, uint32_t one,
                    long long* __restrict__ split = nullptr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BlockShared& sh = *reinterpret_cast<BlockShared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int W = gridDim.x * kWarps;
  // Ranks fill sub-partition wid of every SM before the next one.
  const int gw = wid * gridDim.x + blockIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  long long acc[kSplitN] = {};
  long long cs = 0;
  if (kSplit) {
    acc[kSplitT0] = vt_globaltimer();
    cs = clock64();
  }

  // Pass 1, each warp over its quarter of the lanes (32 at a time, in
  // index order): is any lane live, the longest lane's blocks, each
  // lane's key and its place among the quarter's lanes of that key.
  for (int k = tid; k < kWarps * kKeys; k += kThreads) {
    sh.cnt[k / kKeys][k % kKeys] = 0;
  }
  if (tid == 0) sh.longest = 0;
  __syncthreads();
  const int Q = ((C + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int q1 = (wid + 1) * Q < C ? (wid + 1) * Q : C;
  int* cnt = sh.cnt[wid];
  int any = 0, longest = 0;
  for (int b0 = wid * Q; b0 < q1; b0 += 4 * 32) {
    int nb[4];
    bool lv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // four chunks' loads in flight
      const int c = b0 + u * 32 + lane;
      nb[u] = c < q1 ? lane_nb(nleaves, c, nb_max) : -1;
      lv[u] = c < q1 && live[c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = b0 + u * 32 + lane;
      const bool ok = nb[u] >= 0;
      if (!__any_sync(0xffffffffu, ok)) break;
      any |= lv[u] ? 1 : 0;
      longest = nb[u] > longest ? nb[u] : longest;
      const int k = ok ? lane_key(nb[u]) : 0;
      // the chunk's lanes of the same key, from one ballot a key bit
      unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
      for (int bit = 0; bit < 9; ++bit) {
        const unsigned on = __ballot_sync(0xffffffffu, ok && ((k >> bit) & 1));
        peers &= ((k >> bit) & 1) ? on : ~on;
      }
      const int place = ok ? cnt[k] + __popc(peers & lt) : 0;
      __syncwarp();  // every lane read cnt[k] before its leader adds
      if (ok && lane == 31 - __clz(peers)) cnt[k] += __popc(peers);
      __syncwarp();
      if (ok && c < kLanesCap) {
        sh.key[c] = static_cast<unsigned short>(k);
        sh.local[c] = static_cast<unsigned short>(place);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_xor_sync(0xffffffffu, longest, o);
    longest = v > longest ? v : longest;
  }
  if (lane == 0) atomicMax(&sh.longest, longest);
  any = __syncthreads_or(any);
  if (!any) {  // the reference runs no block: every lane stays at H0
    for (int c = blockIdx.x * kThreads + tid; c < C; c += gridDim.x * kThreads) {
      uint32_t s[8];
      sha256_init(s);
      uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(c) * 8);
      o[0] = make_uint4(s[0], s[1], s[2], s[3]);
      o[1] = make_uint4(s[4], s[5], s[6], s[7]);
    }
    return;
  }
  if (C > kLanesCap) {
    // Too many lanes to sort here: each lane a chain, in index order.
    for (int c = gw; c < C; c += W) {
      run_chain<kPageMajor, kSplit>(sh.ring[wid], flat, flat_len, npp,
                                    page0, nleaves, lens, out, c, nb_max,
                                    one, lane, acc);
    }
  } else {
    longest = sh.longest;
    // A lane whose key is at most kshort's (at most ~longest / 4 blocks)
    // runs one a thread; its groups rank as chains of twice that.
    const int short_max = longest / 4 > 1 ? longest / 4 : 1;
    const int kshort = lane_key(short_max);
    const int gkey = lane_key(2 * short_max);
    if (wid == 0) {
      // the sorted table: keys from the longest down, then quarters,
      // then each quarter's order
      constexpr int kPer = kKeys / 32;  // 14 keys a thread, from the top
      int tot[kPer];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = kKeys - 1 - (lane * kPer + i);
        tot[i] = sh.cnt[0][k] + sh.cnt[1][k] + sh.cnt[2][k] + sh.cnt[3][k];
        sum += tot[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = kKeys - 1 - (lane * kPer + i);
        sh.kstart[k] = run;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int n = sh.cnt[w][k];
          sh.cnt[w][k] = run;
          run += n;
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      sh.sorted[sh.cnt[c / Q][sh.key[c]] + sh.local[c]] =
          static_cast<unsigned short>(c);
    }
    __syncthreads();
    // chains: the lanes of keys above kshort (sorted places 0..n_long-1);
    // the groups of 32 short lanes rank after the chains of gkey
    const int n_long = sh.kstart[kshort];
    const int n_ge = sh.kstart[gkey - 1];
    const int n_groups = (C - n_long + 31) / 32;
    const int n_tasks = n_long + n_groups;
    if (kSplit) acc[kSplitPass1] = clock64() - cs;
    for (int i = 0;; ++i) {
      // the snake: rank i * W + gw, then (i + 1) * W + W - 1 - gw, ...
      const int r = i * W + ((i & 1) ? W - 1 - gw : gw);
      if (r >= n_tasks) break;
      if (r < n_ge || r >= n_ge + n_groups) {
        const int c = sh.sorted[r < n_ge ? r : r - n_groups];
        run_chain<kPageMajor, kSplit>(sh.ring[wid], flat, flat_len, npp,
                                      page0, nleaves, lens, out, c, nb_max,
                                      one, lane, acc);
        continue;
      }
      const int p = n_long + 32 * (r - n_ge) + lane;
      long long c0 = 0;
      if (kSplit) c0 = clock64();
      const int ran = run_short<kPageMajor>(flat, flat_len, npp, page0,
                                            nleaves, lens, out,
                                            p < C ? sh.sorted[p] : -1,
                                            nb_max);
      if (kSplit) {
        int most = ran;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const int v = __shfl_xor_sync(0xffffffffu, most, o);
          most = v > most ? v : most;
        }
        acc[kSplitShort] += __popc(__ballot_sync(0xffffffffu, p < C));
        acc[kSplitShortBlocks] += most;
        acc[kSplitShortCyc] += clock64() - c0;
      }
      __syncwarp();
    }
  }
  if (kSplit) {
    acc[kSplitCycles] = clock64() - cs;
    acc[kSplitPrologue] = acc[kSplitCycles] - acc[kSplitBuild] -
                          acc[kSplitWait] - acc[kSplitRounds] -
                          acc[kSplitShortCyc];
    acc[kSplitT1] = vt_globaltimer();
    acc[kSplitSm] = vt_smid();
    acc[kSplitSub] = vt_warpid() & 3;
    if (lane < kSplitN) {
      long long x = 0;
#pragma unroll
      for (int j = 0; j < kSplitN; ++j) {
        if (lane == j) x = acc[j];
      }
      split[static_cast<size_t>(gw) * kSplitN + lane] = x;
    }
  }
}

// The launch's grid: one block a SM of ``device`` (cached).
static int merkle_grid(int device) {
  static int sms[64];
  if (device < 0 || device >= 64) return 0;
  if (sms[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess) {
      return 0;
    }
    sms[device] = n;
  }
  return sms[device];
}

template <bool kPageMajor, bool kSplit>
static int merkle_launch_one(int device, int grid, const uint32_t* f,
                             long long flat_len, int npp, const int64_t* p0,
                             const int64_t* nl, const int64_t* ln,
                             const bool* lv, uint32_t* o, int C, int nb_max,
                             long long* split, cudaStream_t st) {
  static bool ready[64];  // the shared-memory attribute, set once a device
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        merkle_roots_kernel<kPageMajor, kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[device] = true;
  }
  merkle_roots_kernel<kPageMajor, kSplit><<<grid, kThreads, kSmemBytes, st>>>(
      f, flat_len, npp, p0, nl, ln, lv, o, C, nb_max, 1u, split);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit>
static int merkle_launch(const void* flat, long long flat_len, int npp,
                         const void* page0, const void* nleaves,
                         const void* lens, const void* live, void* out,
                         int C, int nb_max, int pagemajor, long long* split,
                         int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = merkle_grid(device);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint32_t*>(flat);
  const auto* p0 = static_cast<const int64_t*>(page0);
  const auto* nl = static_cast<const int64_t*>(nleaves);
  const auto* ln = static_cast<const int64_t*>(lens);
  const auto* lv = static_cast<const bool*>(live);
  auto* o = static_cast<uint32_t*>(out);
  return pagemajor
             ? merkle_launch_one<true, kSplit>(device, grid, f, flat_len, npp,
                                               p0, nl, ln, lv, o, C, nb_max,
                                               split, st)
             : merkle_launch_one<false, kSplit>(device, grid, f, flat_len,
                                                npp, p0, nl, ln, lv, o, C,
                                                nb_max, split, st);
}

VT_EXPORT int vt_merkle_roots(const void* flat, long long flat_len, int npp,
                              const void* page0, const void* nleaves,
                              const void* lens, const void* live, void* out,
                              int C, int nb_max, int pagemajor, int device,
                              void* stream) {
  return merkle_launch<false>(flat, flat_len, npp, page0, nleaves, lens,
                              live, out, C, nb_max, pagemajor, nullptr,
                              device, stream);
}

// The number of MerkleSplit records vt_merkle_roots_split writes (one a
// warp of the launch).
VT_EXPORT int vt_merkle_roots_split_warps(int C, int device) {
  return merkle_grid(device) * kWarps;
}

// vt_merkle_roots with a MerkleSplit record (kSplitN int64) of every warp
// written to ``split`` ([vt_merkle_roots_split_warps(C), kSplitN]).
VT_EXPORT int vt_merkle_roots_split(const void* flat, long long flat_len,
                                    int npp, const void* page0,
                                    const void* nleaves, const void* lens,
                                    const void* live, void* out, int C,
                                    int nb_max, int pagemajor, void* split,
                                    int device, void* stream) {
  return merkle_launch<true>(flat, flat_len, npp, page0, nleaves, lens, live,
                             out, C, nb_max, pagemajor,
                             static_cast<long long*>(split), device, stream);
}
