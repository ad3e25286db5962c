// SHA-256 kernels of the port: page leaves (K1), leaves at 64-byte rows
// of the raw segment (K2) and message lanes.
//
// sha256_pages (K1) replaces volsync_tpu/ops/sha256.py
// _sha256_leaf_kernel as launched by ops/segment.py _page_digests_flat:
// SHA-256 of every 4 KiB page of a segment. The TPU kernel walks a
// (lane tile, message block) grid in order and carries the state in VMEM
// scratch across the 64 block steps; here blocks run in no order, so one
// thread owns one page and loops over its 64 message blocks with the
// state in registers, then compresses the constant FIPS pad block of a
// 4096-byte message. Input is the transposed page-word table
// xt[w * npp + p] (word w of page p, big-endian, from K3), so the 32
// threads of a warp read 32 consecutive words: coalesced 128-byte loads.
// Output keeps the TPU kernel's word-major layout out[j * npp + p].
// Bound: integer logic and shifts (1,024 LOP3/SHF per 64-byte block,
// 65 blocks a page) on the ALU pipe; the page bytes are read once. The
// threads per block are a launch argument: scripts/tune_sha.py swept the
// TPU kernel's lane tile (lane_sub 32/16/8), and its counterpart here is
// a sweep of K1's block size (chip_smoke.py, 32 to 256 threads); the
// library launches ops/sha256.py PAGES_THREADS (64) a block.
//
// sha256_rows (K2) replaces volsync_tpu/ops/sha256.py _sha256_rows_pallas
// (the split-phase engine's full 4 KiB leaves): the TPU route packs the
// whole segment into big-endian words (pack_words), gathers each leaf's
// 64 rows and transposes them to [64, 16, B] before K1's kernel runs.
// Here one thread per leaf reads its leaf straight from the raw segment
// bytes at 64 * rows0[b] as four 16-byte loads per block, byte-swaps the
// words in registers and runs the compressions plus the constant pad
// block with the state in registers: the packing, gather and transpose
// passes (a read and a write of the segment each) are gone. Leaves are
// 64-byte aligned but may start anywhere on that grid, so a warp's 32
// loads touch 32 leaves about 4 KiB apart: poorly coalesced, left for a
// later redesign (staging blocks through shared memory). Bound: the same
// ALU work as K1 per leaf.
//
// sha256_lanes replaces the XLA-level sha256_blocks scan
// (volsync_tpu/ops/sha256.py:144-169) as used by the tail leaf
// (sha256_chunks_device) and the Merkle root loop
// (ops/segment.py _root_digests_loop): lane b runs nblocks[b]
// compressions over blocks[b, 0:nblocks[b], 16]. One thread per lane, so
// the chained compressions of a long chunk run in one thread while lanes
// run in parallel; each block is read as four 16-byte loads.
#include "common.cuh"
#include "sha256.cuh"

static constexpr int kLanesBlock = 32;
// One warp per block spreads the few thousand leaves of a segment over
// as many SMs as possible.
static constexpr int kRowsBlock = 32;

__device__ __forceinline__ uint32_t vt_bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__global__ void sha256_pages_kernel(const uint32_t* __restrict__ xt,
                                    uint32_t* __restrict__ out, int npp) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npp) return;
  uint32_t s[8];
  sha256_init(s);
  const uint32_t* col = xt + p;
  for (int t = 0; t < 64; ++t) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      w[j] = __ldg(col + static_cast<size_t>(t * 16 + j) * npp);
    }
    sha256_compress(s, w);
  }
  uint32_t pad[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) pad[j] = 0u;
  pad[0] = 0x80000000u;
  pad[15] = 4096u * 8u;
  sha256_compress(s, pad);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[static_cast<size_t>(j) * npp + p] = s[j];
}

__global__ void sha256_rows_kernel(const uint8_t* __restrict__ data,
                                   const int32_t* __restrict__ rows0,
                                   uint32_t* __restrict__ out, int B,
                                   int n_rows, int leaf_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // Leaf starts come from the host's leaf plan and lie inside the
  // buffer; the clamp only keeps a bad row from reading past it.
  int r = rows0[b];
  r = r < 0 ? 0 : (r > n_rows - leaf_blocks ? n_rows - leaf_blocks : r);
  const uint4* msg =
      reinterpret_cast<const uint4*>(data) + static_cast<size_t>(r) * 4;
  uint32_t s[8];
  sha256_init(s);
  for (int t = 0; t < leaf_blocks; ++t) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(msg + static_cast<size_t>(t) * 4 + q);
      w[4 * q] = vt_bswap32(v.x);
      w[4 * q + 1] = vt_bswap32(v.y);
      w[4 * q + 2] = vt_bswap32(v.z);
      w[4 * q + 3] = vt_bswap32(v.w);
    }
    sha256_compress(s, w);
  }
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

VT_EXPORT int vt_sha256_pages(const void* xt, void* out, int npp, int threads,
                              int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (npp > 0) {
    const int grid = (npp + threads - 1) / threads;
    sha256_pages_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(xt), static_cast<uint32_t*>(out), npp);
  }
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_sha256_rows(const void* data, const void* rows0, void* out,
                             int B, int n_rows, int leaf_blocks, int device,
                             void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (B > 0) {
    const int grid = (B + kRowsBlock - 1) / kRowsBlock;
    sha256_rows_kernel<<<grid, kRowsBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data),
        static_cast<const int32_t*>(rows0), static_cast<uint32_t*>(out), B,
        n_rows, leaf_blocks);
  }
  return static_cast<int>(cudaGetLastError());
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
