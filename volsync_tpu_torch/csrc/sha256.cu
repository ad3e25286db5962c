// SHA-256 kernels of the port: page leaves (K1), leaves at 64-byte rows
// of the raw segment (K2) and message lanes.
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
// layout out[j * npp + p]. Bound: integer logic and shifts (1,024
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
// (volsync_tpu/ops/sha256.py:144-169) as used by the tail leaf
// (sha256_chunks_device) and the split-phase and legacy engines' leaf
// lanes: lane b runs nblocks[b] compressions over blocks[b, 0:nblocks[b],
// 16]. One thread per lane, so the chained compressions of a long
// message run in one thread while lanes run in parallel; each block is
// read as four 16-byte loads. The fused path's Merkle roots have their
// own kernel (merkle.cu).
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
#pragma unroll
  for (int j = 0; j < 8; ++j) out[static_cast<size_t>(j) * npp + p] = s[j];
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
                              int npp, int threads, int device,
                              void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (npp <= 0) return static_cast<int>(cudaGetLastError());
  return vt_ring_launch(sha256_pages_kernel, (npp + threads - 1) / threads,
                        threads, stream, static_cast<const uint8_t*>(data),
                        static_cast<uint32_t*>(out), n_pages, npp);
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
