// fastcdc_walk: the FastCDC boundary walk over successor tables.
//
// Replaces the lax.while_loop of volsync_tpu/ops/segment.py
// _select_boundaries_device (segment.py:205-227). With page-aligned cuts
// every reachable chunk start is a multiple of the alignment, so the cut
// decision is a pure function of the start row: cut_tab[r] / emit_tab[r]
// are precomputed for every row (torch.searchsorted, on the device) and
// the walk is a chain of table reads. The walk is sequential within a
// segment, so one thread walks one segment lane; a batch of S segments
// runs S threads. Writes starts/lens (zero-initialised by the caller),
// the chunk count and the bytes consumed, truncating at chunk_cap
// exactly as the reference does. Bound: latency of the dependent loads
// (a handful of bytes per chunk); there is no host sync per chunk.
#include "common.cuh"

static constexpr int kWalkBlock = 32;

__global__ void fastcdc_walk_kernel(const int32_t* __restrict__ cut_tab,
                                    const int32_t* __restrict__ emit_tab,
                                    const int32_t* __restrict__ valid_len,
                                    int32_t* __restrict__ starts,
                                    int32_t* __restrict__ lens,
                                    int32_t* __restrict__ count,
                                    int32_t* __restrict__ consumed, int S,
                                    int n_rows, int chunk_cap, int shift) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int32_t* cut = cut_tab + static_cast<size_t>(s) * n_rows;
  const int32_t* emit = emit_tab + static_cast<size_t>(s) * n_rows;
  int32_t* st = starts + static_cast<size_t>(s) * chunk_cap;
  int32_t* ln = lens + static_cast<size_t>(s) * chunk_cap;
  const int32_t L = valid_len[s];
  int32_t pos = 0;
  int cnt = 0;
  while (pos < L && cnt < chunk_cap) {
    int r = pos >> shift;
    r = r > n_rows - 1 ? n_rows - 1 : r;
    if (!emit[r]) break;  // non-eof tail: resume in the next segment
    const int32_t c = cut[r];
    st[cnt] = pos;
    ln[cnt] = c - pos + 1;
    ++cnt;
    pos = c + 1;
  }
  count[s] = cnt;
  consumed[s] = pos;
}

VT_EXPORT int vt_fastcdc_walk(const void* cut_tab, const void* emit_tab,
                              const void* valid_len, void* starts, void* lens,
                              void* count, void* consumed, int S, int n_rows,
                              int chunk_cap, int shift, int device,
                              void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (S > 0) {
    const int grid = (S + kWalkBlock - 1) / kWalkBlock;
    fastcdc_walk_kernel<<<grid, kWalkBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cut_tab),
        static_cast<const int32_t*>(emit_tab),
        static_cast<const int32_t*>(valid_len), static_cast<int32_t*>(starts),
        static_cast<int32_t*>(lens), static_cast<int32_t*>(count),
        static_cast<int32_t*>(consumed), S, n_rows, chunk_cap, shift);
  }
  return static_cast<int>(cudaGetLastError());
}
