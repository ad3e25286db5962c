// Layout kernels of the page-digest stage: K3 and K4.
//
// K3 transpose_u32: 32-bit transpose [R, C] -> [C, R] through
// shared-memory tiles. Replaces volsync_tpu/ops/segment.py
// _pallas_transpose / _transpose_kernel (256x256 VMEM tiles on the TPU).
// Here a 32x32 tile with one pad column (no shared-memory bank conflicts
// on the column-wise read) is staged by a 32x8 thread block: each thread
// moves four words in and four words out, and both the global read and
// the global write are row-contiguous across a warp. The ragged edge is
// masked, so any R and C work. Bound: bytes (each word read once and
// written once). The fused page stage no longer needs it (K1 reads the
// raw segment bytes); it stays for the rsync MD5 path, whose reference
// (volsync_tpu/ops/md5.py md5_contiguous_blocks_device) reuses the
// transpose.
//
// K4 pagemajor_u32: the word-major digest table [8, npp] -> page-major
// [npp * 8] (word j of page p at p*8 + j). Replaces
// volsync_tpu/ops/segment.py _pallas_pagemajor / _relayout_kernel, which
// shuffles [8, 512] VMEM tiles into [32, 128] rows. The table has only 8
// rows, so no shared-memory tile is needed: one thread per page reads
// its 8 words strided by npp (each of the 8 loads is coalesced across
// the warp's 32 consecutive pages) and writes them as two 16-byte
// stores, which together cover 1 KiB contiguous per warp. Bound: bytes,
// 32 read and 32 written per page.
#include "common.cuh"

static constexpr int kTile = 32;
static constexpr int kRows = 8;
static constexpr int kPagemajorBlock = 128;

__global__ void transpose_u32_kernel(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out, int R,
                                     int C) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
#pragma unroll
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int r = r0 + k, c = c0 + tx;
    if (r < R && c < C) tile[k][tx] = in[static_cast<size_t>(r) * C + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = threadIdx.y; k < kTile; k += kRows) {
    const int c = c0 + k, r = r0 + tx;
    if (c < C && r < R) out[static_cast<size_t>(c) * R + r] = tile[tx][k];
  }
}

__global__ void pagemajor_u32_kernel(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out, int npp) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npp) return;
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = __ldg(in + static_cast<size_t>(j) * npp + p);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * 8);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

VT_EXPORT int vt_pagemajor_u32(const void* in, void* out, int npp, int device,
                               void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (npp > 0) {
    const int grid = (npp + kPagemajorBlock - 1) / kPagemajorBlock;
    pagemajor_u32_kernel<<<grid, kPagemajorBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), npp);
  }
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_transpose_u32(const void* in, void* out, int R, int C,
                               int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (R > 0 && C > 0) {
    const dim3 grid((C + kTile - 1) / kTile, (R + kTile - 1) / kTile);
    const dim3 block(kTile, kRows);
    transpose_u32_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}
