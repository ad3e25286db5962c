// SHA-256 kernels of the port: page leaves (K1), leaves at 64-byte rows
// of the raw segment (K2), pre-padded message lanes and slices at any
// byte offset.
//
// sha256_pages (K1) replaces volsync_tpu/ops/sha256.py
// _sha256_leaf_kernel as launched by ops/segment.py _page_digests_flat:
// SHA-256 of every 4 KiB page of a segment. The TPU kernel walks a
// (lane tile, message block) grid in order and carries the state in VMEM
// scratch across the 64 block steps, over words that an elementwise pack
// and the K3 transpose laid out first; here blocks run in no order, so
// one thread owns one page and loops over its 64 message blocks with the
// state in registers, then compresses the constant FIPS pad block of a
// 4096-byte message. It reads the raw segment bytes: no byte-swapped,
// zero-padded or transposed copy of the segment is made. A block of T
// threads owns T consecutive pages and keeps a ring of kRing (4) stages
// in dynamic shared memory; stage t holds message block t (64 bytes) of
// each of its pages, one row a page, rows padded to 80 bytes so that
// each thread's 16-byte reads of its own row are free of bank conflicts
// (a quarter-warp's 8 rows start 20 words apart: 8 disjoint bank quads).
// Stages fill with 16-byte cp.async: 4 consecutive threads copy one
// page's 64 contiguous bytes, so every 32-byte sector fetched is used,
// and pages past the segment's end are zero-filled copies (they hash a
// zero page). While a thread compresses block t, the copies of blocks
// t+1 .. t+kRing-1 are in flight: the memory latency that one warp per
// scheduler left exposed is off its chain. One barrier a block orders
// the ring. The loop body is one compression, so the instructions a
// warp streams through stay about 24 KB. Each thread byte-swaps its
// words with __byte_perm. Output keeps the TPU kernel's word-major
// layout out[j * npp + p], or with kPageMajor is page-major out[p * 8 +
// j] as two 16-byte stores a page: that instance does the work of K4
// (volsync_tpu/ops/segment.py _pallas_pagemajor), which otherwise reads
// and writes the whole table again in a launch of its own; only the
// store differs. Bound: integer logic and shifts (1,024
// LOP3/SHF per 64-byte block, 65 blocks a page) on the ALU pipe; with
// 12,288 pages a scheduler holds at most one warp, whose 65 x 1,024 ALU
// instructions at 16 lanes a cycle floor it above the whole card's
// operations bound. The threads per block are a launch argument:
// scripts/tune_sha.py swept the TPU kernel's lane tile (lane_sub
// 32/16/8), and its counterpart here is a sweep of K1's block size
// (chip_smoke.py, 32 to 256 threads); the library launches
// ops/sha256.py PAGES_THREADS (64) a block. The ring has 4 stages, 80
// KiB at the largest block the wrapper takes (256 threads).
//
// sha256_rows (K2) replaces volsync_tpu/ops/sha256.py _sha256_rows_pallas
// (the split-phase engine's full 4 KiB leaves): the TPU route packs the
// whole segment into big-endian words (pack_words), gathers each leaf's
// 64 rows and transposes them to [64, 16, B] before K1's kernel runs.
// Here K2 is K1 with a leaf at any 64-byte row instead of a page: it
// reads the raw segment bytes at 64 * rows0[b] through K1's ring (the
// packing, gather and transpose passes are gone). A block of T threads
// (ops/sha256.py ROWS_THREADS, 64) owns lanes [first, first + T), and 4
// consecutive threads copy one leaf's 64 contiguous bytes of a block
// (the leaves of a warp lie about 4 KiB apart), so every 32-byte sector
// fetched is used and a compression never waits on its own loads.
// Each thread reads the rows of the 4 leaves it copies pieces of once,
// clamped into the buffer, and keeps their addresses in registers.
// Lanes past B are zero copies. The copies go through L1 (cp.async.ca):
// the engine pads the lanes to a power of two with row 0, so thousands
// of padding lanes copy the same 64 bytes at every stage, which through
// L2 alone queue on one slice. The loop runs leaf_blocks (any positive
// count) data blocks, then the FIPS pad block of leaf_blocks * 512 bits;
// output [B, 8]. Bound: the same ALU work as K1 per leaf.
//
// sha256_lanes replaces the XLA-level sha256_blocks scan
// (volsync_tpu/ops/sha256.py:144-169) over pre-padded message blocks
// (sha256_blocks / sha256_many): lane b runs nblocks[b] compressions over
// blocks[b, 0:nblocks[b], 16], one thread a lane, each block read as four
// 16-byte loads. No engine launches it: slices of a resident buffer go to
// sha256_slices, Merkle roots to merkle_roots (merkle.cu).
//
// sha256_slices replaces volsync_tpu/ops/sha256.py sha256_chunks_device
// (an XLA byte gather of [B, 65 * 64] bytes, about 15 elementwise ops that
// lay the FIPS padding over it, a pack into words and the sha256_blocks
// scan) for the tail leaves of the fused and span paths and every leaf of
// the legacy engine: SHA-256 of B slices of at most N blocks, each at any
// byte offset of a resident buffer, read from the raw bytes. One thread
// owns a slice; a block of 64 keeps K1's 4-stage cp.async ring of 80-byte
// rows, where stage t holds for each row the 16-byte-aligned window that
// covers the slice's message block t (five 16-byte pieces, copied by 5
// consecutive threads), so the slice's byte shift s & 15 is the same at
// every block and a big-endian word is one PRMT of two aligned shared
// words. The terminator and the bit length are built in registers from
// the block index and the length: no padded message exists in memory.
// The loop runs to the block's longest lane (one barrier a block orders
// the ring); a lane past its own block count idles, and padding-only
// blocks copy nothing. The block where a message ends takes the same
// PRMTs, masked past the end, with the terminator laid in: a lane pays
// it once, but a warp whose lanes end at different blocks pays it at
// each of them, so it stays inline at a few ops a word. Bytes that the reference
// reads through its index clamp (before the buffer: its first byte; past
// it: its last) come from an out-of-line per-byte path, which only
// slices that leave the buffer take. One template serves three entry
// points, one for each kind of lanes: vt_sha256_slices (SliceLanes:
// starts and lengths), and the table forms vt_sha256_tail_chunks
// (ChunkTails: the fused segment's chunk tables) and vt_sha256_tail_spans
// (SpanTails: page-aligned spans), which derive each
// lane's partial tail leaf themselves and write its digest straight into
// the page-digest table, word-major or page-major, in place of the
// reference's _apply_tail_overrides scatter. Bound: the same ALU work as
// K1 per block; the longest lane's blocks at one warp's issue rate.
#include "common.cuh"
#include "sha256.cuh"

static constexpr int kLanesBlock = 32;

__device__ __forceinline__ uint32_t vt_bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// The ring of K1 and K2: kRing stages, each one message block (64 bytes)
// of every message of the thread block, one 80-byte row a message;
// kRingMaxThreads a block at most.
static constexpr int kRing = 4;
static constexpr int kRingPitch = 64 + 16;
static constexpr int kRingMaxThreads = 256;

// The ring loop K1 and K2 share: the blockDim.x threads of a block hash
// one message each, nblocks 64-byte blocks long, into ``s``. Copy r (0..3)
// of a thread at a stage is piece ``piece`` (16 bytes) of the block's
// message ``row``; ``live(row)`` says whether that message exists, and
// ``src(r, row, t, piece)`` is the global address of the piece in its
// message block t. A message that does not exist is zero copies, which
// pass ``any`` as an address and read nothing. kL1 copies through L1
// (vt_cp_async16_l1) instead of L2 alone.
template <bool kL1, typename Live, typename Src>
__device__ __forceinline__ void sha256_ring(uint8_t* ring,
                                            const uint8_t* any, int nblocks,
                                            Live live, Src src,
                                            uint32_t s[8]) {
  const int T = blockDim.x;
  const int stage_bytes = T * kRingPitch;

  // Copies of message block t of every message into slot t % kRing: 4
  // consecutive threads copy one message's 64 bytes, 16 each.
  auto issue = [&](int t) {
    uint8_t* slot = ring + (t % kRing) * stage_bytes;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = r * T + threadIdx.x;
      const int row = c >> 2;
      const int piece = c & 3;
      const bool real = live(row);
      uint8_t* dst = slot + row * kRingPitch + piece * 16;
      const uint8_t* from = real ? src(r, row, t, piece) : any;
      if (kL1) {
        vt_cp_async16_l1(dst, from, real ? 16 : 0);
      } else {
        vt_cp_async16(dst, from, real ? 16 : 0);
      }
    }
  };

  for (int t = 0; t < kRing - 1; ++t) {
    if (t < nblocks) issue(t);
    vt_cp_async_commit();
  }
  sha256_init(s);
#pragma unroll 1
  for (int t = 0; t < nblocks; ++t) {
    vt_cp_async_wait<kRing - 2>();  // this thread's copies of block t landed
    __syncthreads();  // everyone's have, and slot (t-1) % kRing is read
    if (t + kRing - 1 < nblocks) issue(t + kRing - 1);
    vt_cp_async_commit();  // one group a block (empty at the end)
    const uint4* row = reinterpret_cast<const uint4*>(
        ring + (t % kRing) * stage_bytes + threadIdx.x * kRingPitch);
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = row[q];
      w[4 * q] = vt_bswap32(v.x);
      w[4 * q + 1] = vt_bswap32(v.y);
      w[4 * q + 2] = vt_bswap32(v.z);
      w[4 * q + 3] = vt_bswap32(v.w);
    }
    sha256_compress(s, w);
  }
}

template <bool kPageMajor>
__global__ void __launch_bounds__(kRingMaxThreads)
sha256_pages_kernel(const uint8_t* __restrict__ data,
                    uint32_t* __restrict__ out, int n_pages, int npp) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int first = blockIdx.x * blockDim.x;
  uint32_t s[8];
  sha256_ring<false>(
      ring, data, 64, [&](int row) { return first + row < n_pages; },
      [&](int, int row, int t, int piece) {
        return data + static_cast<size_t>(first + row) * 4096 + t * 64 +
               piece * 16;
      },
      s);
  const int p = first + threadIdx.x;
  if (p >= npp) return;
  uint32_t pad[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) pad[j] = 0u;
  pad[0] = 0x80000000u;
  pad[15] = 4096u * 8u;
  sha256_compress(s, pad);
  if (kPageMajor) {
    // Page p's 32 bytes as two 16-byte stores: a warp writes 1 KiB
    // contiguous.
    uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * 8);
    o[0] = make_uint4(s[0], s[1], s[2], s[3]);
    o[1] = make_uint4(s[4], s[5], s[6], s[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[static_cast<size_t>(j) * npp + p] = s[j];
  }
}

__global__ void __launch_bounds__(kRingMaxThreads)
sha256_rows_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ rows0,
                   uint32_t* __restrict__ out, int B, int n_rows,
                   int leaf_blocks) {
  extern __shared__ __align__(16) uint8_t ring[];
  const int first = blockIdx.x * blockDim.x;
  // The first bytes of the 4 pieces this thread copies at every stage
  // (copy r is piece c & 3 of lane first + c / 4, c = r * T + thread),
  // read once. Leaf starts come from the host's leaf plan and lie
  // inside the buffer; the clamp only keeps a bad row from reading past
  // it.
  const uint8_t* piece0[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = r * blockDim.x + threadIdx.x;
    const int lane = first + (c >> 2);
    int row = lane < B ? rows0[lane] : 0;
    row = row < 0 ? 0 : (row > n_rows - leaf_blocks ? n_rows - leaf_blocks
                                                    : row);
    piece0[r] = data + static_cast<size_t>(row) * 64 + (c & 3) * 16;
  }
  uint32_t s[8];
  sha256_ring<true>(
      ring, data, leaf_blocks, [&](int row) { return first + row < B; },
      [&](int r, int, int t, int) { return piece0[r] + t * 64; }, s);
  const int b = first + threadIdx.x;
  if (b >= B) return;
  // FIPS pad of a message of exactly leaf_blocks * 64 bytes.
  const uint64_t bits = static_cast<uint64_t>(leaf_blocks) * 512u;
  uint32_t pad[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) pad[j] = 0u;
  pad[0] = 0x80000000u;
  pad[14] = static_cast<uint32_t>(bits >> 32);
  pad[15] = static_cast<uint32_t>(bits);
  sha256_compress(s, pad);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[static_cast<size_t>(b) * 8 + j] = s[j];
}

__global__ void sha256_lanes_kernel(const uint32_t* __restrict__ blocks,
                                    const int32_t* __restrict__ nblocks,
                                    uint32_t* __restrict__ out, int B,
                                    int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int nb = nblocks[b];
  nb = nb < 0 ? 0 : (nb > N ? N : nb);
  uint32_t s[8];
  sha256_init(s);
  const uint4* msg =
      reinterpret_cast<const uint4*>(blocks + static_cast<size_t>(b) * N * 16);
  for (int n = 0; n < nb; ++n) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(msg + static_cast<size_t>(n) * 4 + q);
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    sha256_compress(s, w);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[static_cast<size_t>(b) * 8 + j] = s[j];
}

// ---------------------------------------------------------------------------
// sha256_slices: lanes of at most N message blocks read from any byte offset
// ---------------------------------------------------------------------------

static constexpr int kSlicesThreads = 64;
static constexpr int kSlicePieces = kRingPitch / 16;  // 5 a row

__device__ __forceinline__ long long vt_floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The lanes of the three forms. Each gives lane b's slice: (start, len) of
// the bytes hashed, and for the table forms (kTable) the page whose digest
// it replaces (-1: the lane has no partial tail leaf and writes nothing).
// The tail formulas are the twin's (ops/segment.py _tail_lanes).

// The tail leaf of a lane whose data ends at ``end`` (``has``: it ends off
// the page grid), on page ``base`` + its page in the lane.
__device__ __forceinline__ void tail_slice(long long end, bool has,
                                           long long base, long long L,
                                           long long& start, long long& len,
                                           long long& page) {
  const long long local = vt_floordiv(end - 1 > 0 ? end - 1 : 0, 4096);
  len = has ? end - local * 4096 : 0;
  page = has ? base + local : -1;
  const long long s = (base + local) * 4096;
  start = s < 0 ? 0 : (s > L - 1 ? L - 1 : s);
}

// [B] int32 starts and lengths; the digests go to out[B, 8].
struct SliceLanes {
  static constexpr bool kTable = false;
  const int32_t* starts;
  const int32_t* lengths;
  __device__ void lane(int b, long long, long long& start, long long& len,
                       long long& page) const {
    start = starts[b];
    len = lengths[b];
    page = -1;
  }
};

// The fused segment's chunk tables: [S, cap] int32 chunk starts and
// lengths, [S] int32 counts; lane s's tail is its last chunk's partial
// leaf, on page s * lane_pages + its page in the lane.
struct ChunkTails {
  static constexpr bool kTable = true;
  const int32_t* starts;
  const int32_t* lens;
  const int32_t* count;
  int cap;
  int lane_pages;
  __device__ void lane(int b, long long L, long long& start, long long& len,
                       long long& page) const {
    const int c = count[b];
    long long end = 0;
    bool has = false;
    if (c > 0) {
      const size_t k = static_cast<size_t>(b) * cap + (c - 1);
      end = static_cast<long long>(starts[k]) + lens[k];
      has = end - vt_floordiv(end, 4096) * 4096 != 0;
    }
    tail_slice(end, has, static_cast<long long>(b) * lane_pages, L, start,
               len, page);
  }
};

// Page-aligned spans: [N] int64 starts and lengths (<= 0: a padding lane).
struct SpanTails {
  static constexpr bool kTable = true;
  const int64_t* starts;
  const int64_t* lens;
  __device__ void lane(int b, long long L, long long& start, long long& len,
                       long long& page) const {
    const long long n = lens[b];
    const long long lc = n > 0 ? n : 0;
    tail_slice(starts[b] + lc, n > 0 && lc % 4096 != 0, 0, L, start, len,
               page);
  }
};

// One big-endian message word of a block whose message bytes leave the
// buffer: byte j of the slice (buffer position p) is the ring's byte, or
// the buffer's first or last byte where p falls outside it (the reference
// clamps every byte index into [0, L - 1]); past the message it is the
// FIPS terminator at j == len, else 0. Out of line: only slices that leave
// the buffer come here.
__device__ __noinline__ uint32_t slice_word(const uint8_t* row, int sh,
                                            long long j, long long len,
                                            long long p, long long L,
                                            const uint8_t* data) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long jk = j + k;
    uint32_t v;
    if (jk < len) {
      const long long pk = p + k;
      v = pk < 0 ? data[0]
                 : (pk >= L ? data[L - 1]
                            : row[sh + static_cast<int>(jk & 63)]);
    } else {
      v = jk == len ? 0x80u : 0u;
    }
    w = (w << 8) | v;
  }
  return w;
}

// ``out``: the [B, 8] digests (SliceLanes), or the [8 * npp] page-digest
// table the tails are written into (the table forms).
template <class Lanes>
__global__ void __launch_bounds__(kSlicesThreads)
sha256_slices_kernel(const uint8_t* __restrict__ data, long long L,
                     Lanes lanes, uint32_t* __restrict__ out, int npp,
                     int pagemajor, int B, int N) {
  constexpr int T = kSlicesThreads;
  constexpr int kStage = T * kRingPitch;
  __shared__ __align__(16) uint8_t ring[kRing * kStage];
  __shared__ long long row_off[T];  // the row's slice start, 16-aligned
  __shared__ long long row_lim[T];  // its copies end: min(end, L); -1: none
  __shared__ int block_nb;
  const int b = blockIdx.x * T + threadIdx.x;
  long long start = 0, len = 0, page = -1;
  int nb = 0;
  long long nb_full = 0;  // FIPS block count, before the clamp to N
  if (b < B) {
    lanes.lane(b, L, start, len, page);
    if (!Lanes::kTable || page >= 0) {
      nb_full = vt_floordiv(len + 72, 64);
      nb = static_cast<int>(nb_full < 0 ? 0 : (nb_full > N ? N : nb_full));
    }
  }
  if (threadIdx.x == 0) block_nb = 0;
  row_off[threadIdx.x] = start & ~15LL;
  row_lim[threadIdx.x] =
      nb > 0 ? (start + len < L ? start + len : L) : -1;
  __syncthreads();
  atomicMax(&block_nb, nb);
  // Copy r (0..4) of this thread at every stage: piece c % 5 of row c / 5,
  // c = r * T + thread, so 5 consecutive threads copy one row's 80
  // contiguous bytes. Its source at block 0 and its limit, read once.
  long long off[kSlicePieces], lim[kSlicePieces];
  int dst[kSlicePieces];
#pragma unroll
  for (int r = 0; r < kSlicePieces; ++r) {
    const int c = r * T + threadIdx.x;
    const int row = c / kSlicePieces, piece = c % kSlicePieces;
    off[r] = row_off[row] + piece * 16;
    lim[r] = row_lim[row];
    dst[r] = row * kRingPitch + piece * 16;
  }
  __syncthreads();
  const int nb_max = block_nb;

  // Stage t holds, for each row, the 16-byte-aligned window of the
  // buffer covering the row's message block t: five pieces, each copied
  // only if it starts inside the buffer and before the message's end (the
  // tail of a piece past L is zero-filled).
  auto issue = [&](int t) {
    uint8_t* slot = ring + (t % kRing) * kStage;
#pragma unroll
    for (int r = 0; r < kSlicePieces; ++r) {
      const long long o = off[r] + 64LL * t;
      if (o >= 0 && o < lim[r]) {
        const long long rem = L - o;
        vt_cp_async16(slot + dst[r], data + o,
                      rem < 16 ? static_cast<int>(rem) : 16);
      }
    }
  };

  for (int t = 0; t < kRing - 1; ++t) {
    if (t < nb_max) issue(t);
    vt_cp_async_commit();
  }
  const int sh = static_cast<int>(start & 15);
  const int b4 = sh & 3;
  const uint32_t sel = (b4 << 12) | ((b4 + 1) << 8) | ((b4 + 2) << 4) |
                       (b4 + 3);
  const uint32_t bitlen = static_cast<uint32_t>(len * 8);
  uint32_t s[8];
  sha256_init(s);
#pragma unroll 1
  for (int t = 0; t < nb_max; ++t) {
    vt_cp_async_wait<kRing - 2>();  // this thread's copies of block t landed
    __syncthreads();  // everyone's have, and slot (t-1) % kRing is read
    if (t + kRing - 1 < nb_max) issue(t + kRing - 1);
    vt_cp_async_commit();
    if (t >= nb) continue;
    const uint8_t* row =
        ring + (t % kRing) * kStage + threadIdx.x * kRingPitch;
    const long long j0 = 64LL * t;  // the block's first message byte
    const long long p0 = start + j0;  // and its place in the buffer
    const long long left = len - j0;  // message bytes from this block on
    const uint32_t* r32 = reinterpret_cast<const uint32_t*>(row) + (sh >> 2);
    uint32_t w[16];
    if (left >= 64 && p0 >= 0 && p0 + 64 <= L) {
      // All message, all in the buffer: big-endian word i is bytes sh +
      // 4i .. sh + 4i + 3 of the row, one PRMT over two aligned words.
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = __byte_perm(r32[i], r32[i + 1], sel);
    } else if (left > 0 && p0 >= 0 && p0 + left <= L) {
      // The message ends in this block, inside the buffer: the same PRMT,
      // then word i keeps its m message bytes (the ring past them holds
      // stale bytes) and takes the terminator after them.
      const int n = static_cast<int>(left);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int m = min(max(n - 4 * i, -1), 4);
        const uint32_t keep =
            m >= 4 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (8 * max(m, 0)));
        const uint32_t term = (m >= 0 && m < 4) ? 0x80000000u >> (8 * m) : 0u;
        w[i] = (__byte_perm(r32[i], r32[i + 1], sel) & keep) | term;
      }
    } else if (left <= 0) {  // padding only
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = 0u;
      if (j0 == len) w[0] = 0x80000000u;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = slice_word(row, sh, j0 + 4 * i, len, p0 + 4 * i, L, data);
    }
    // The last block ends with the bit length; its bytes 56..59 lie past
    // the terminator and are zero already. Like the reference, only the
    // low 32 bits are set (len < 2**28).
    if (t == nb_full - 1) w[15] = bitlen;
    sha256_compress(s, w);
  }
  if (b >= B) return;
  if (!Lanes::kTable) {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[static_cast<size_t>(b) * 8 + j] = s[j];
  } else if (page >= 0) {
    // The digest-table index of ops/segment.py _word_index_fn; an index
    // outside the table is dropped, as the reference's scatter drops it.
    const long long words = 8LL * npp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long idx = pagemajor ? page * 8 + j : j * npp + page;
      if (idx >= 0 && idx < words) out[idx] = s[j];
    }
  }
}

template <class Lanes>
static int vt_slices_launch(const void* data, long long L, Lanes lanes,
                            uint32_t* out, int npp, int pagemajor, int B,
                            int N, int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (B > 0) {
    sha256_slices_kernel<Lanes>
        <<<(B + kSlicesThreads - 1) / kSlicesThreads, kSlicesThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(data), L, lanes, out, npp, pagemajor,
            B, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch a ring kernel (K1 or K2) on ``grid`` blocks of ``threads``: its
// kRing stages take kRing * threads * 80 bytes of dynamic shared memory,
// which above the default 48 KiB the kernel must opt into.
template <typename Kernel, typename... Args>
static int vt_ring_launch(Kernel kernel, int grid, int threads, void* stream,
                          Args... args) {
  const size_t smem = static_cast<size_t>(kRing) * threads * kRingPitch;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_sha256_pages(const void* data, void* out, int n_pages,
                              int npp, int threads, int pagemajor,
                              int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (npp <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = (npp + threads - 1) / threads;
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (pagemajor) {
    return vt_ring_launch(sha256_pages_kernel<true>, grid, threads, stream,
                          d, o, n_pages, npp);
  }
  return vt_ring_launch(sha256_pages_kernel<false>, grid, threads, stream, d,
                        o, n_pages, npp);
}

VT_EXPORT int vt_sha256_rows(const void* data, const void* rows0, void* out,
                             int B, int n_rows, int leaf_blocks, int threads,
                             int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return vt_ring_launch(sha256_rows_kernel, (B + threads - 1) / threads,
                        threads, stream, static_cast<const uint8_t*>(data),
                        static_cast<const int32_t*>(rows0),
                        static_cast<uint32_t*>(out), B, n_rows, leaf_blocks);
}

VT_EXPORT int vt_sha256_lanes(const void* blocks, const void* nblocks,
                              void* out, int B, int N, int device,
                              void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (B > 0) {
    const int grid = (B + kLanesBlock - 1) / kLanesBlock;
    sha256_lanes_kernel<<<grid, kLanesBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(blocks),
        static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out), B,
        N);
  }
  return static_cast<int>(cudaGetLastError());
}

// [B, 8] digests of B slices (int32 starts and lengths) into ``out``.
VT_EXPORT int vt_sha256_slices(const void* data, long long L,
                               const int32_t* starts, const int32_t* lengths,
                               uint32_t* out, int B, int N, int device,
                               void* stream) {
  return vt_slices_launch(data, L, SliceLanes{starts, lengths}, out, 0, 0, B,
                          N, device, stream);
}

// The tail leaf of each of S lanes of the fused segment's chunk tables,
// written into the [8 * npp] page-digest ``table``.
VT_EXPORT int vt_sha256_tail_chunks(const void* data, long long L,
                                    const int32_t* starts,
                                    const int32_t* lens,
                                    const int32_t* count, int cap,
                                    int lane_pages, uint32_t* table, int npp,
                                    int pagemajor, int S, int N, int device,
                                    void* stream) {
  return vt_slices_launch(data, L,
                          ChunkTails{starts, lens, count, cap, lane_pages},
                          table, npp, pagemajor, S, N, device, stream);
}

// The tail leaf of each of n page-aligned spans (int64 starts and
// lengths), written into the [8 * npp] page-digest ``table``.
VT_EXPORT int vt_sha256_tail_spans(const void* data, long long L,
                                   const int64_t* starts,
                                   const int64_t* lens, uint32_t* table,
                                   int npp, int pagemajor, int n, int N,
                                   int device, void* stream) {
  return vt_slices_launch(data, L, SpanTails{starts, lens}, table, npp,
                          pagemajor, n, N, device, stream);
}
