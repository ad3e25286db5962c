// fastcdc_walk: the FastCDC boundary walk over the compacted candidate
// lists, with the cut decision made in the kernel.
//
// Replaces the lax.while_loop of volsync_tpu/ops/segment.py
// _select_boundaries_device (segment.py:145-227). XLA cannot search per
// chunk cheaply, so the reference precomputes the decision for every
// start row (two batched searchsorted calls, :196-202) and walks those
// successor tables. Here one warp walks one segment lane and decides
// each chunk at its start pos, as the reference's per-iteration form
// cut_emit(pos) (:172-194) does:
//   lo = pos + min - 1, mid = pos + avg - 1, hi = pos + max - 1;
//   i = the first pos_s index >= lo (side "left", over the padded row),
//   found_s = i < ns && pos_s[i] <= min(mid - 1, L - 1, hi);
//   j = the first pos_l index >= max(lo, mid),
//   found_l = j < nl && pos_l[j] <= min(hi, L - 1);
//   cut = pos_s[i] if found_s, else pos_l[j] if found_l, else hi if
//   hi <= L - 1, else L - 1; emit = found_s | found_l | hi <= L - 1 |
//   eof, and a chunk that does not emit ends the walk (a non-eof tail
//   resumes in the next segment).
// With page-aligned cuts every reachable pos is a multiple of the
// alignment below L, so this equals the reference's table lookup.
//
// Both search keys only grow with pos, so each list has a cursor that
// only moves forward. The warp holds the 32 candidates at the cursor in
// registers (one coalesced load) and finds the first one >= the key
// with __ballot_sync and __ffs; it moves on by 32 only when the whole
// window lies below the key. The window after it is already loaded, so
// a chunk waits on memory only when its cut lies past both windows.
// Entries past the row's end read as +infinity, which gives an index >=
// cap exactly where searchsorted returns cap (the sentinel padding is
// larger than any key, so past ns the search lands on index ns). Lane 0
// writes starts and lens; the warp zero-fills [count, chunk_cap) and
// writes count and consumed, so the wrapper allocates with torch.empty
// and no torch op runs around the launch. Bound: the serial chain of
// decisions, each a ballot and a shuffle on the previous cut, not bytes
// (a few candidates a chunk); chip_smoke.py logs the longest lane's
// chunks x one dependent load (probe.cu).
#include "common.cuh"

__device__ __forceinline__ int64_t vt_min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// One list's cursor: ``v`` is this lane's entry of the window at ``cur``,
// ``next`` its entry of the window after it.
struct WalkCursor {
  const int64_t* row;
  int cap;
  int cur;
  int64_t v, next;

  __device__ __forceinline__ int64_t at(int k) const {
    return k < cap ? row[k] : INT64_MAX;
  }

  __device__ __forceinline__ WalkCursor(const int64_t* r, int c, int lane)
      : row(r), cap(c), cur(0) {
    v = at(lane);
    next = at(32 + lane);
  }

  // The first index >= key (searchsorted side "left"; >= cap when no
  // entry is) and its entry, the same in every lane.
  __device__ __forceinline__ int first_ge(int64_t key, int lane,
                                          int64_t* value) {
    unsigned hit;
    while ((hit = __ballot_sync(0xFFFFFFFFu, v >= key)) == 0u) {
      cur += 32;
      v = next;
      next = at(cur + 32 + lane);
    }
    const int k = __ffs(hit) - 1;
    *value = __shfl_sync(0xFFFFFFFFu, v, k);
    return cur + k;
  }
};

__global__ void __launch_bounds__(32)
fastcdc_walk_kernel(const int64_t* __restrict__ pos_s,
                    const int64_t* __restrict__ ns,
                    const int64_t* __restrict__ pos_l,
                    const int64_t* __restrict__ nl,
                    const int64_t* __restrict__ valid_len,
                    const bool* __restrict__ eof,
                    int32_t* __restrict__ starts, int32_t* __restrict__ lens,
                    int32_t* __restrict__ count,
                    int32_t* __restrict__ consumed, int cap_s, int cap_l,
                    int chunk_cap, int64_t min_size, int64_t avg_size,
                    int64_t max_size) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  WalkCursor cs(pos_s + static_cast<size_t>(s) * cap_s, cap_s, lane);
  WalkCursor cl(pos_l + static_cast<size_t>(s) * cap_l, cap_l, lane);
  int32_t* st = starts + static_cast<size_t>(s) * chunk_cap;
  int32_t* ln = lens + static_cast<size_t>(s) * chunk_cap;
  const int64_t L = valid_len[s];
  const int64_t n_s = ns[s];
  const int64_t n_l = nl[s];
  const bool at_eof = eof[s];
  int64_t pos = 0;
  int cnt = 0;
  while (pos < L && cnt < chunk_cap) {
    const int64_t lo = pos + (min_size - 1);
    const int64_t mid = pos + (avg_size - 1);
    const int64_t hi = pos + (max_size - 1);
    int64_t c_s, c_l;
    const int i = cs.first_ge(lo, lane, &c_s);
    const bool found_s =
        i < n_s && c_s <= vt_min64(vt_min64(mid - 1, L - 1), hi);
    const int j = cl.first_ge(mid > lo ? mid : lo, lane, &c_l);
    const bool found_l = j < n_l && c_l <= vt_min64(hi, L - 1);
    const bool hi_ok = hi <= L - 1;
    if (!(found_s || found_l || hi_ok || at_eof)) break;
    const int64_t cut =
        found_s ? c_s : (found_l ? c_l : (hi_ok ? hi : L - 1));
    if (lane == 0) {
      st[cnt] = static_cast<int32_t>(pos);
      ln[cnt] = static_cast<int32_t>(cut - pos + 1);
    }
    ++cnt;
    pos = cut + 1;
  }
  for (int k = cnt + lane; k < chunk_cap; k += 32) {
    st[k] = 0;
    ln[k] = 0;
  }
  if (lane == 0) {
    count[s] = cnt;
    consumed[s] = static_cast<int32_t>(pos);
  }
}

VT_EXPORT int vt_fastcdc_walk(const void* pos_s, const void* ns,
                              const void* pos_l, const void* nl,
                              const void* valid_len, const void* eof,
                              void* starts, void* lens, void* count,
                              void* consumed, int S, int cap_s, int cap_l,
                              int chunk_cap, long long min_size,
                              long long avg_size, long long max_size,
                              int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (S > 0) {
    fastcdc_walk_kernel<<<S, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(pos_s), static_cast<const int64_t*>(ns),
        static_cast<const int64_t*>(pos_l), static_cast<const int64_t*>(nl),
        static_cast<const int64_t*>(valid_len),
        static_cast<const bool*>(eof), static_cast<int32_t*>(starts),
        static_cast<int32_t*>(lens), static_cast<int32_t*>(count),
        static_cast<int32_t*>(consumed), cap_s, cap_l, chunk_cap, min_size,
        avg_size, max_size);
  }
  return static_cast<int>(cudaGetLastError());
}
