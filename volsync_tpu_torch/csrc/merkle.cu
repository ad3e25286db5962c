// merkle_roots: the blob ids of a segment's chunks from its page-digest
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
// 16 * nb - 1.
//
// One warp per lane. The warp streams its chunk's digests through a
// two-tile ring in shared memory with cp.async: a tile is 64 pages of
// digests (512 words, 2 KiB; word-major: 8 runs of 64 contiguous words,
// 4-byte copies coalesced across the warp; page-major: 2 KiB contiguous,
// 16-byte copies), and tile k+1 is in flight while the chain consumes
// tile k (32 message blocks). No [C, 16 * nb_max] message array exists,
// and a lane runs its own nb blocks. SHA-256 of one message is a serial
// chain, and its message schedule does not depend on the state: at the
// start of each tile the 32 threads build the 32 blocks' message words
// in registers, one block a thread, expand their schedules and store
// K[t] + W[t] in shared memory. The chain then runs on every thread of
// the warp alike (warp-uniform shared-memory reads are broadcasts: no
// bank conflicts, no divergence), its rounds hold only the state
// updates, and h + K[t] + W[t] is one add of values known rounds ahead,
// off the chain of e and a. Threads 0-7 write the 8 state words.
//
// As in the reference, a lane that is not live hashes the empty leaf list
// (nleaves 0, one block), every lane stays at H0 when no lane is live,
// and no lane runs more than nb_max blocks. The tail-leaf override is
// applied to the table before the launch. Bound: the longest live lane's
// chain (blocks x one block's dependent latency); a segment's 128 lanes
// each get a warp, so the card is never full.
#include "common.cuh"
#include "sha256.cuh"

static constexpr int kWarps = 2;             // lanes (warps) a block
static constexpr int kTilePages = 64;
static constexpr int kTileWords = 8 * kTilePages;  // 512
static constexpr int kTileBlocks = kTileWords / 16;  // 32 message blocks
static constexpr uint32_t kDomainWord0 = 0x564D524Bu;  // "VMRK"
static constexpr uint32_t kDomainByte4 = 0x31u;         // "1"

struct LaneRing {
  uint32_t d[2][kTileWords];          // digest tiles, slot k & 1
  uint32_t kw[64][kTileBlocks];       // K[t] + W[t] of the tile's blocks
};

// Digest word t of the stream from the ring (0 outside [0, nl8)); both
// the current tile and the one before it are resident.
template <bool kPageMajor>
__device__ __forceinline__ uint32_t ring_word(const LaneRing& r, long long t,
                                              long long nl8) {
  if (t < 0 || t >= nl8) return 0u;
  const int slot = static_cast<int>((t / kTileWords) & 1);
  const int i = static_cast<int>(t % kTileWords);
  return kPageMajor ? r.d[slot][i] : r.d[slot][(i & 7) * kTilePages + (i >> 3)];
}

// Copies of tile k (pages 64k.. of the lane's stream) into slot k & 1;
// pages past the stream are not read.
template <bool kPageMajor>
__device__ __forceinline__ void issue_tile(LaneRing& r, const uint32_t* flat,
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

template <bool kPageMajor>
__global__ void __launch_bounds__(32 * kWarps)
merkle_roots_kernel(const uint32_t* __restrict__ flat, long long flat_len,
                    int npp, const int64_t* __restrict__ page0,
                    const int64_t* __restrict__ nleaves,
                    const int64_t* __restrict__ lens,
                    const bool* __restrict__ live, uint32_t* __restrict__ out,
                    int C, int nb_max) {
  __shared__ LaneRing rings[kWarps];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;  // whole warps only; no block-wide barrier below
  LaneRing& r = rings[threadIdx.x >> 5];

  bool any = false;  // the reference runs no block when no lane is live
  for (int base = 0; base < C && !any; base += 32) {
    const int i = base + lane;
    any = __any_sync(0xffffffffu, i < C && live[i]);
  }
  const long long nl = nleaves[c] < 0 ? 0 : nleaves[c];
  const long long nl8 = 8 * nl;
  const long long nb = (32 * nl + 13 + 9 + 63) / 64;
  const int nb_run = any ? static_cast<int>(nb < nb_max ? nb : nb_max) : 0;
  const long long qterm = 3 + nl8;
  const long long qlen = nb * 16 - 1;
  const uint32_t bitlen = static_cast<uint32_t>((13 + 32 * nl) * 8);
  const uint32_t len = static_cast<uint32_t>(lens[c]);
  const uint32_t w1 = (kDomainByte4 << 24) | ((len & 0xFFu) << 16) |
                      (((len >> 8) & 0xFFu) << 8) | ((len >> 16) & 0xFFu);
  const uint32_t w2 = ((len >> 24) & 0xFFu) << 24;
  const long long p0 = page0[c];

  uint32_t s[8];
  sha256_init(s);
  if (nb_run > 0 && nl8 > 0) {
    issue_tile<kPageMajor>(r, flat, flat_len, npp, p0, nl, 0, lane);
  }
  for (int m0 = 0; m0 < nb_run; m0 += kTileBlocks) {
    const int k = m0 / kTileBlocks;
    vt_cp_async_wait<0>();
    __syncwarp();  // tile k landed for every thread; last tile's kw read
    {
      // This thread's block m = m0 + lane: its 16 message words from
      // digest words 16m-4 .. 16m+12, then its schedule, as K + W.
      const long long m = m0 + lane;
      uint32_t w[16];
      uint32_t prev = ring_word<kPageMajor>(r, 16 * m - 4, nl8);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const long long q = 16 * m + i;
        const uint32_t next = ring_word<kPageMajor>(r, q - 3, nl8);
        uint32_t v = (prev << 24) | (next >> 8);
        prev = next;
        if (q == 0) v = kDomainWord0;
        if (q == 1) v = w1;
        if (q == 2) v = w2;
        if (q == qterm) v |= 0x00800000u;
        if (q == qlen) v = bitlen;
        w[i] = v;
      }
#pragma unroll
      for (int t = 0; t < 64; ++t) {
        uint32_t wt;
        if (t < 16) {
          wt = w[t];
        } else {
          const uint32_t w15 = w[(t - 15) & 15];
          const uint32_t w2_ = w[(t - 2) & 15];
          const uint32_t s0 = vt_rotr(w15, 7) ^ vt_rotr(w15, 18) ^ (w15 >> 3);
          const uint32_t s1 =
              vt_rotr(w2_, 17) ^ vt_rotr(w2_, 19) ^ (w2_ >> 10);
          wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
          w[t & 15] = wt;
        }
        r.kw[t][lane] = kSha256K[t] + wt;
      }
    }
    __syncwarp();  // kw visible; tile k-1 no longer read
    if (static_cast<long long>(k + 1) * kTileWords < nl8 &&
        m0 + kTileBlocks < nb_run) {
      issue_tile<kPageMajor>(r, flat, flat_len, npp, p0, nl, k + 1, lane);
    }
    const int nblk = nb_run - m0 < kTileBlocks ? nb_run - m0 : kTileBlocks;
    for (int b = 0; b < nblk; ++b) {
      uint32_t a = s[0], bb = s[1], cc = s[2], d = s[3];
      uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
      for (int t = 0; t < 64; ++t) {
        const uint32_t hkw = h + r.kw[t][b];  // off the e/a chain
        const uint32_t S1 = vt_rotr(e, 6) ^ vt_rotr(e, 11) ^ vt_rotr(e, 25);
        const uint32_t ch = g ^ (e & (f ^ g));
        const uint32_t t1 = hkw + S1 + ch;
        const uint32_t S0 = vt_rotr(a, 2) ^ vt_rotr(a, 13) ^ vt_rotr(a, 22);
        const uint32_t maj = (a & (bb | cc)) | (bb & cc);
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = bb; bb = a; a = t1 + S0 + maj;
      }
      s[0] += a; s[1] += bb; s[2] += cc; s[3] += d;
      s[4] += e; s[5] += f; s[6] += g; s[7] += h;
    }
  }
  uint32_t v = s[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    if (lane == j) v = s[j];
  }
  if (lane < 8) out[static_cast<size_t>(c) * 8 + lane] = v;
}

VT_EXPORT int vt_merkle_roots(const void* flat, long long flat_len, int npp,
                              const void* page0, const void* nleaves,
                              const void* lens, const void* live, void* out,
                              int C, int nb_max, int pagemajor, int device,
                              void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (C > 0) {
    const int grid = (C + kWarps - 1) / kWarps;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* f = static_cast<const uint32_t*>(flat);
    const auto* p0 = static_cast<const int64_t*>(page0);
    const auto* nl = static_cast<const int64_t*>(nleaves);
    const auto* ln = static_cast<const int64_t*>(lens);
    const auto* lv = static_cast<const bool*>(live);
    auto* o = static_cast<uint32_t*>(out);
    if (pagemajor) {
      merkle_roots_kernel<true><<<grid, 32 * kWarps, 0, st>>>(
          f, flat_len, npp, p0, nl, ln, lv, o, C, nb_max);
    } else {
      merkle_roots_kernel<false><<<grid, 32 * kWarps, 0, st>>>(
          f, flat_len, npp, p0, nl, ln, lv, o, C, nb_max);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
