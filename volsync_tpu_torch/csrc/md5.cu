// md5_slices: batched MD5 (RFC 1321) of the rsync delta engine, one
// thread a message.
//
// Replaces the XLA programs of volsync_tpu/ops/md5.py: md5_blocks (a
// lax.scan of the 64-round compression over [B, N, 16] little-endian
// words, :113), md5_fixed_blocks_device (a clamped [B, padded] byte
// gather, the padding laid over it with index masks, then md5_blocks,
// :168) and md5_contiguous_blocks_device (a word pack, the K3 Pallas
// transpose that puts blocks on the TPU's lane axis, then the scan,
// :203). On the TPU the transpose is a layout device for the lane axis;
// here a thread owns a message and reads its bytes in place, so neither
// the gathered copy nor the transpose is made: one pass reads each byte
// of a window once.
//
// One template, md5_slices_kernel<Lanes>, with two entry points:
// - vt_md5_windows: B windows of one length ``len`` at int64 byte starts
//   of a resident buffer [L] (the signature's contiguous blocks, and the
//   delta scan's candidate windows at any offset). As in the reference,
//   every byte index is clamped into [0, L - 1]: a window that runs past
//   the buffer repeats its last byte, a negative start reads byte 0. The
//   padding (0x80, zeros, the 64-bit little-endian bit length) is built
//   in registers.
// - vt_md5_lanes: pre-padded lanes [B, N, 16] words with a block count a
//   lane (md5_many's md5_pack_host layout); a lane is the message bytes
//   b * N * 64 .. + 64 * min(max(nblocks[b], 0), N), already padded.
//
// Bound: the compression chain. A round is one logic function (a LOP3),
// a three-input add, and the rotation and add (compiled as an IMAD and
// a LEA), each on the previous round's result: 64 dependent rounds a
// 64-byte block, 18.5 SM cycles a round on the H100 (csrc/probe.cu
// probe_md5_chain). At every shape the delta engine launches, a
// scheduler holds one or two warps, so the longest lane's chain, not the
// card's ALU rate or its memory rate, sets the time; chip_smoke.py logs
// the compiled round's chain and both bounds.
//
// Design. Each thread owns its rows of an 8-stage cp.async ring in
// shared memory and copies them itself, so a thread waits only for its
// own copies (cp.async.wait_group, no barrier): a lane at an edge of the
// buffer delays no other lane, and a block's words are read from the
// ring and funnel-shifted while the previous block's rounds run. A row
// is the 16-byte aligned window (80 bytes) that covers the lane's
// message block t; the copies of block t + 7 are issued at block t.
// MD5's words are little-endian, the card's byte order: word i of a
// block is one funnel shift of two aligned ring words by 8 * (s & 3)
// bits, s the start's byte offset in its 16 bytes. A per-lane plan made
// once gives the blocks that lie wholly inside the buffer and the
// message ([t_lo, t_hi)): their words are the ring's, with no compare a
// word. The few others (the padding block, a block that straddles an
// end of the buffer, the message's last partial block, blocks wholly
// past either end) take the ring's in-bounds bytes and lay the clamped
// end bytes, the terminator and the length over them with byte masks;
// the lane's two end bytes are read once. Those blocks branch, but every
// lane of a warp walks the same block index, so the rounds stay
// converged.
//
// md5_slices_kernel<Lanes, true> is the same kernel with clock64 reads
// around its parts, for one chosen lane (vt_md5_windows_split): never
// launched on a product path.

#include "common.cuh"

static constexpr int kMd5Threads = 64;
static constexpr int kMd5Ring = 8;  // stages; a power of two
static constexpr int kMd5Ahead = kMd5Ring - 1;  // blocks copied ahead
static constexpr int kMd5Pitch = 64 + 16;  // 80-byte rows: 5 pieces
static constexpr int kMd5Stage = kMd5Threads * kMd5Pitch;

// T[i] = floor(2^32 * |sin(i + 1)|) (RFC 1321 section 3.4); ops/md5.py
// _T holds the same table.
static __constant__ uint32_t kMd5T[64] = {
    0xD76AA478u, 0xE8C7B756u, 0x242070DBu, 0xC1BDCEEEu, 0xF57C0FAFu,
    0x4787C62Au, 0xA8304613u, 0xFD469501u, 0x698098D8u, 0x8B44F7AFu,
    0xFFFF5BB1u, 0x895CD7BEu, 0x6B901122u, 0xFD987193u, 0xA679438Eu,
    0x49B40821u, 0xF61E2562u, 0xC040B340u, 0x265E5A51u, 0xE9B6C7AAu,
    0xD62F105Du, 0x02441453u, 0xD8A1E681u, 0xE7D3FBC8u, 0x21E1CDE6u,
    0xC33707D6u, 0xF4D50D87u, 0x455A14EDu, 0xA9E3E905u, 0xFCEFA3F8u,
    0x676F02D9u, 0x8D2A4C8Au, 0xFFFA3942u, 0x8771F681u, 0x6D9D6122u,
    0xFDE5380Cu, 0xA4BEEA44u, 0x4BDECFA9u, 0xF6BB4B60u, 0xBEBFBC70u,
    0x289B7EC6u, 0xEAA127FAu, 0xD4EF3085u, 0x04881D05u, 0xD9D4D039u,
    0xE6DB99E5u, 0x1FA27CF8u, 0xC4AC5665u, 0xF4292244u, 0x432AFF97u,
    0xAB9423A7u, 0xFC93A039u, 0x655B59C3u, 0x8F0CCC92u, 0xFFEFF47Du,
    0x85845DD1u, 0x6FA87E4Fu, 0xFE2CE6E0u, 0xA3014314u, 0x4E0811A1u,
    0xF7537E82u, 0xBD3AF235u, 0x2AD7D2BBu, 0xEB86D391u,
};

__device__ __forceinline__ void md5_init(uint32_t s[4]) {
  s[0] = 0x67452301u; s[1] = 0xEFCDAB89u; s[2] = 0x98BADCFEu;
  s[3] = 0x10325476u;
}

// One compression of the 16 little-endian words ``m`` into ``s``. Fully
// unrolled, so each shift amount and message index is a constant; a + T
// + m is summed apart from f, so the chain is f, one add, the rotation
// and the add of b. The last 16 rounds use each word once: before them
// ``prefetch()`` runs, and after round i the word it used is dead and
// takes ``refill(g)``, the next block's word g, so the next block's
// words are read beside the rounds and no copy of them is made.
template <class Prefetch, class Refill>
__device__ __forceinline__ void md5_compress(uint32_t s[4], uint32_t m[16],
                                             Prefetch prefetch,
                                             Refill refill) {
  constexpr int kS[4][4] = {{7, 12, 17, 22}, {5, 9, 14, 20},
                            {4, 11, 16, 23}, {6, 10, 15, 21}};
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = d ^ (b & (c ^ d));  // (b & c) | (~b & d)
      g = i;
    } else if (i < 32) {
      f = c ^ (d & (b ^ c));  // (d & b) | (~d & c)
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    if (i == 48) prefetch();
    const uint32_t tmp = (a + (kMd5T[i] + m[g])) + f;
    if (i >= 48) m[g] = refill(g);
    a = d;
    d = c;
    c = b;
    b = b + __funnelshift_l(tmp, tmp, kS[i >> 4][i & 3]);
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
}

// A lane's plan, made once: its message (start, len) in bytes of the
// buffer, its nb padded blocks, the blocks [t_lo, t_hi) whose 64 bytes
// are all message bytes inside the buffer (their words are the ring's),
// the first t_row of them whose whole 80-byte row lies inside the buffer
// (copied with no bound check), and of the t_full blocks wholly of
// message bytes, those [0, f_lo) wholly before byte 0 and [f_hi, t_full)
// wholly past the end (each byte the clamped end byte).
struct Md5Plan {
  long long start, len;
  int nb, t_lo, t_hi, t_row, t_full, f_lo, f_hi;
};

static __device__ __forceinline__ int md5_clamp_blocks(long long t, int nb) {
  return static_cast<int>(t < 0 ? 0 : (t > nb ? nb : t));
}

// The two kinds of lanes.
struct Windows {
  static constexpr bool kPadded = false;
  const int64_t* starts;
  long long len;
  __device__ Md5Plan plan(int b, long long L) const {
    Md5Plan p;
    p.start = starts[b];
    p.len = len;
    p.nb = static_cast<int>((len + 72) / 64);
    const long long s = p.start;
    // p0(t) = s + 64 t >= 0; p0(t) + 64 <= L; 64 (t + 1) <= len
    const long long lo = s >= 0 ? 0 : (63 - s) / 64;
    const long long in = L - 64 - s < 0 ? 0 : (L - 64 - s) / 64 + 1;
    const long long hi = in < len / 64 ? in : len / 64;
    const long long row =
        L - 80 - (s & ~15LL) < 0 ? 0 : (L - 80 - (s & ~15LL)) / 64 + 1;
    p.t_lo = md5_clamp_blocks(lo, p.nb);
    p.t_hi = max(p.t_lo, md5_clamp_blocks(hi, p.nb));
    p.t_row = min(max(p.t_lo, md5_clamp_blocks(row, p.nb)), p.t_hi);
    p.t_full = md5_clamp_blocks(len / 64, p.nb);
    // p0(t) + 64 <= 0 below f_lo; p0(t) >= L from f_hi on
    p.f_lo = md5_clamp_blocks(s < 0 ? -s / 64 : 0, p.nb);
    p.f_hi = md5_clamp_blocks(L - s <= 0 ? 0 : (L - s + 63) / 64, p.nb);
    return p;
  }
};

struct PaddedLanes {
  static constexpr bool kPadded = true;
  const int32_t* nblocks;
  int N;
  __device__ Md5Plan plan(int b, long long) const {
    const int nb = nblocks[b];
    Md5Plan p;
    p.start = static_cast<long long>(b) * N * 64;
    p.nb = nb < 0 ? 0 : (nb > N ? N : nb);
    p.len = 64LL * p.nb;
    p.t_lo = p.f_lo = 0;
    p.t_hi = p.t_row = p.t_full = p.f_hi = p.nb;
    return p;
  }
};

// The low ``n`` bytes (0..4) of a word as a mask.
static __device__ __forceinline__ uint32_t md5_low_bytes(int n) {
  return n <= 0 ? 0u : (n >= 4 ? 0xFFFFFFFFu : 0xFFFFFFFFu >> (32 - 8 * n));
}

// Words of a window's block t outside [t_lo, t_hi), laid over ``w``
// (the ring's words of the block's row, whose in-bounds message bytes
// were copied): byte j of the message (buffer position p) is the
// buffer's byte at p clamped into [0, L - 1] (``first`` = data[0] and
// ``last`` = data[L - 1], four times each), the terminator at j ==
// len, else 0; the last block ends with the 64-bit bit length.
static __device__ __forceinline__ void md5_edge_words(
    uint32_t w[16], const Md5Plan& p, long long L, int t, uint32_t first,
    uint32_t last) {
  if (t < p.t_full && (t < p.f_lo || t >= p.f_hi)) {
    const uint32_t fill = t < p.f_lo ? first : last;  // wholly past an end
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = fill;
    return;
  }
  const long long j0 = 64LL * t;
  const long long p0 = p.start + j0;
  const long long left = p.len - j0;
  if (left <= 0) {  // padding only
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = 0u;
    if (left == 0) w[0] = 0x80u;
  } else {
    // Bytes before byte 0 of the buffer, inside it, and past its end;
    // message bytes, then the terminator. Offsets clamped to a block.
    const int below = static_cast<int>(min(max(-p0, -8LL), 72LL));
    const int inside = static_cast<int>(min(max(L - p0, -8LL), 72LL));
    const int msg = static_cast<int>(min(left, 72LL));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t lo = md5_low_bytes(below - 4 * i);
      const uint32_t in = md5_low_bytes(inside - 4 * i);
      const uint32_t v = (w[i] & in & ~lo) | (first & lo) | (last & ~in);
      const int m = msg - 4 * i;
      const uint32_t term = (m >= 0 && m < 4) ? 0x80u << (8 * m) : 0u;
      w[i] = (v & md5_low_bytes(m)) | term;
    }
  }
  if (t == p.nb - 1) {
    const unsigned long long bits = static_cast<unsigned long long>(p.len)
                                    * 8;
    w[14] = static_cast<uint32_t>(bits);
    w[15] = static_cast<uint32_t>(bits >> 32);
  }
}

// A shared-memory word load and a funnel shift kept where the source
// puts them (asm volatile): left to the compiler, the next block's words
// are read after the current block's rounds, on the chain between
// blocks, instead of beside them. And a 16-byte cp.async issued only
// where ``on`` holds: a predicated instruction, not a branch.
static __device__ __forceinline__ uint32_t md5_lds(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

static __device__ __forceinline__ uint32_t md5_shf(uint32_t lo, uint32_t hi,
                                                   int n) {
  uint32_t v;
  asm volatile("shf.r.wrap.b32 %0, %1, %2, %3;"
               : "=r"(v) : "r"(lo), "r"(hi), "r"(n));
  return v;
}

static __device__ __forceinline__ void md5_cp_async16_if(void* smem,
                                                         const void* gmem,
                                                         bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n"
      :: "r"(s), "l"(gmem), "r"(static_cast<int>(on)) : "memory");
}

// The split of one lane's block loop (kSplit instances only): SM cycles
// summed over its blocks in each part, then the loop's whole span and
// its block count.
enum Md5Split {
  kSplitWait,      // cp.async wait (and any barrier)
  kSplitWords,     // block classification and word assembly
  kSplitEdge,      // of which the edge blocks' words
  kSplitRounds,    // the 64 rounds
  kSplitIssue,     // copy issue
  kSplitLoop,      // the whole loop, first block to last
  kSplitBlocks,    // blocks the lane compressed
  kSplitN
};

template <class Lanes, bool kSplit = false>
__global__ void __launch_bounds__(kMd5Threads)
md5_slices_kernel(const uint8_t* __restrict__ data, long long L, Lanes lanes,
                  uint32_t* __restrict__ out, int B,
                  long long* __restrict__ split = nullptr, int split_lane = 0) {
  __shared__ __align__(16) uint8_t ring[kMd5Ring * kMd5Stage];
  const int b = blockIdx.x * kMd5Threads + threadIdx.x;
  if (b >= B) return;  // no barrier below: a thread waits for itself only
  const Md5Plan p = lanes.plan(b, L);
  long long acc[kSplitN] = {};
  long long c0 = 0, c1 = 0;
  if (kSplit) c0 = clock64();
  const long long loop0 = c0;

  uint8_t* const row0 = ring + threadIdx.x * kMd5Pitch;
  const long long base = p.start & ~15LL;  // the rows' 16-byte alignment
  const int sh = static_cast<int>(p.start & 15);
  const int rot = 8 * (sh & 3);
  // A padded lane's rows are 16-aligned: its fifth piece (the next
  // block's first bytes) is never read; nor is a window's at sh == 0.
  const bool fifth = !Lanes::kPadded && sh != 0;
  uint32_t first = 0, last = 0;  // the clamped end bytes, four times
  if (!Lanes::kPadded) {
    first = 0x01010101u * data[0];
    last = 0x01010101u * data[L - 1];
  }

  // Block t's copies into its ring slot: the fast copy (four or five
  // predicated cp.async, no bound check) inside [t_lo, t_row); bounded
  // copies for the blocks at either edge whose bytes the words need
  // (issue_edge); nothing elsewhere.
  auto issue_fast = [&](int t) {
    const bool on = t >= p.t_lo && t < p.t_row;
    uint8_t* dst = row0 + (t & (kMd5Ring - 1)) * kMd5Stage;
    const uint8_t* src = data + (on ? base + 64LL * t : 0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      md5_cp_async16_if(dst + 16 * r, src + 16 * r, on);
    if (!Lanes::kPadded) md5_cp_async16_if(dst + 64, src + 64, on && fifth);
  };
  auto edge_copy = [&](int t) {
    return !Lanes::kPadded && t < p.nb &&
           (t == p.t_lo - 1 || (t >= p.t_row && t <= p.t_hi));
  };
  auto issue_edge = [&](int t) {
    uint8_t* dst = row0 + (t & (kMd5Ring - 1)) * kMd5Stage;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const long long o = base + 64LL * t + 16 * r;
      if (o >= 0 && o < L) {
        vt_cp_async16(dst + 16 * r, data + o,
                      L - o < 16 ? static_cast<int>(L - o) : 16);
      }
    }
  };
  auto edge = [&](int t) {
    return !Lanes::kPadded && t < p.nb && (t < p.t_lo || t >= p.t_hi);
  };
  // Iterations with nothing at an edge: block t + 1 inside [t_lo, t_hi)
  // and block t + 7 a fast copy.
  const int q_lo = p.t_lo - 1;
  const unsigned q_n = static_cast<unsigned>(
      max(min(p.t_hi - 1, p.t_row - kMd5Ahead) - q_lo, 0));
  // The ring words of block t (17: a word straddles two) and block t's
  // word g from them.
  uint32_t r[17];
  auto ring_read = [&](int t) {
    const uint32_t* r32 = reinterpret_cast<const uint32_t*>(
        row0 + (t & (kMd5Ring - 1)) * kMd5Stage) + (sh >> 2);
#pragma unroll
    for (int i = 0; i < (Lanes::kPadded ? 16 : 17); ++i)
      r[i] = md5_lds(r32 + i);
  };
  auto word = [&](int g) {
    return Lanes::kPadded ? r[g] : md5_shf(r[g], r[g + 1], rot);
  };

  for (int t = 0; t < kMd5Ahead; ++t) {
    issue_fast(t);
    if (edge_copy(t)) issue_edge(t);
    vt_cp_async_commit();
  }
  if (kSplit) { c1 = clock64(); acc[kSplitIssue] += c1 - c0; c0 = c1; }
  vt_cp_async_wait<kMd5Ahead - 1>();  // block 0 landed
  if (kSplit) { c1 = clock64(); acc[kSplitWait] += c1 - c0; c0 = c1; }
  uint32_t m[16];
  ring_read(0);
#pragma unroll
  for (int g = 0; g < 16; ++g) m[g] = word(g);
  if (edge(0)) md5_edge_words(m, p, L, 0, first, last);
  if (kSplit) { c1 = clock64(); acc[kSplitWords] += c1 - c0; c0 = c1; }
  uint32_t s[4];
  md5_init(s);
  // Block t: copy block t + 7 (into the slot block t - 1 was read from),
  // then the rounds, which read block t + 1's words from the ring as
  // they free block t's; the rare edge copies and words after them,
  // then the commit of block t + 7's copies. No branch splits the copies
  // from the rounds, so the compiler can place them among the rounds.
#pragma unroll 1
  for (int t = 0; t < p.nb; ++t) {
    const int tc = t + kMd5Ahead;
    issue_fast(tc);
    if (kSplit) { c1 = clock64(); acc[kSplitIssue] += c1 - c0; c0 = c1; }
    md5_compress(s, m, [&]() {
      if (kSplit) { c1 = clock64(); acc[kSplitRounds] += c1 - c0; c0 = c1; }
      vt_cp_async_wait<kMd5Ahead - 2>();  // block t + 1 landed
      if (kSplit) { c1 = clock64(); acc[kSplitWait] += c1 - c0; c0 = c1; }
      ring_read(t + 1);
      if (kSplit) { c1 = clock64(); acc[kSplitWords] += c1 - c0; c0 = c1; }
    }, word);
    if (kSplit) {
      c1 = clock64(); acc[kSplitRounds] += c1 - c0; c0 = c1;
      ++acc[kSplitBlocks];
    }
    if (static_cast<unsigned>(t - q_lo) >= q_n) {  // at an edge
      if (edge_copy(tc)) issue_edge(tc);
      if (kSplit) { c1 = clock64(); acc[kSplitIssue] += c1 - c0; c0 = c1; }
      if (edge(t + 1)) {
        md5_edge_words(m, p, L, t + 1, first, last);
        if (kSplit) {
          c1 = clock64(); acc[kSplitWords] += c1 - c0;
          acc[kSplitEdge] += c1 - c0; c0 = c1;
        }
      }
    }
    vt_cp_async_commit();
  }
  vt_cp_async_wait<0>();
  if (kSplit && b == split_lane) {
    acc[kSplitLoop] = clock64() - loop0;
#pragma unroll
    for (int k = 0; k < kSplitN; ++k) split[k] = acc[k];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[static_cast<size_t>(b) * 4 + j] = s[j];
}

template <class Lanes>
static int vt_md5_launch(const void* data, long long L, Lanes lanes,
                         uint32_t* out, int B, int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (B > 0) {
    md5_slices_kernel<Lanes>
        <<<(B + kMd5Threads - 1) / kMd5Threads, kMd5Threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(data), L, lanes, out, B);
  }
  return static_cast<int>(cudaGetLastError());
}

// [B, 4] states of B windows of ``len`` bytes at int64 ``starts`` of the
// [L] buffer ``data`` (16-byte aligned, L > 0).
VT_EXPORT int vt_md5_windows(const void* data, long long L,
                             const int64_t* starts, long long len,
                             uint32_t* out, int B, int device,
                             void* stream) {
  return vt_md5_launch(data, L, Windows{starts, len}, out, B, device,
                       stream);
}

// vt_md5_windows with the clock64 split of lane ``split_lane``'s block
// loop written to ``split`` (kSplitN int64: the Md5Split parts).
VT_EXPORT int vt_md5_windows_split(const void* data, long long L,
                                   const int64_t* starts, long long len,
                                   uint32_t* out, int B, void* split,
                                   int split_lane, int device,
                                   void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (split_lane < 0 || split_lane >= B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  md5_slices_kernel<Windows, true>
      <<<(B + kMd5Threads - 1) / kMd5Threads, kMd5Threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(data), L, Windows{starts, len}, out, B,
          static_cast<long long*>(split), split_lane);
  return static_cast<int>(cudaGetLastError());
}

// [B, 4] states of B pre-padded lanes: ``blocks`` [B, N, 16] words
// (16-byte aligned), ``nblocks`` [B] int32.
VT_EXPORT int vt_md5_lanes(const void* blocks, const int32_t* nblocks,
                           uint32_t* out, int B, int N, int device,
                           void* stream) {
  return vt_md5_launch(blocks, static_cast<long long>(B) * N * 64,
                       PaddedLanes{nblocks, N}, out, B, device, stream);
}
