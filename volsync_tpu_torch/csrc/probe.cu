// probe_chase: the latency of one dependent load, for chip_smoke.py's
// chain bounds. Not a port of a TPU kernel, and no path of the library
// launches it.
//
// One thread follows a random cycle next[j] through ``steps`` loads,
// each address the value of the load before it, and times the chase
// with clock64() (SM cycles) and %globaltimer (ns). From global memory
// the loads are ld.global.cg, which caches in L2 only, after one
// untimed lap of the whole cycle has brought it into L2; from shared
// memory the block first copies the cycle there (at most
// kProbeSharedMax entries). out = {cycles, ns, last index} of the timed
// chase.
#include "common.cuh"

static constexpr int kProbeSharedMax = 4096;

__device__ __forceinline__ unsigned long long vt_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void probe_chase_kernel(const int32_t* __restrict__ next, int n,
                                   int steps, int from_shared,
                                   long long* __restrict__ out) {
  __shared__ int32_t s_next[kProbeSharedMax];
  if (from_shared) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_next[i] = next[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int j = 0;
  if (!from_shared) {
    for (int k = 0; k < n; ++k) j = __ldcg(next + j);
  }
  const long long c0 = clock64();
  const unsigned long long t0 = vt_globaltimer();
  if (from_shared) {
    const volatile int32_t* v = s_next;
    for (int k = 0; k < steps; ++k) j = v[j];
  } else {
    for (int k = 0; k < steps; ++k) j = __ldcg(next + j);
  }
  const unsigned long long t1 = vt_globaltimer();
  const long long c1 = clock64();
  out[0] = c1 - c0;
  out[1] = static_cast<long long>(t1 - t0);
  out[2] = j;
}

VT_EXPORT int vt_probe_chase(const void* next, int n, int steps,
                             int from_shared, void* out, int device,
                             void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  if (from_shared && n > kProbeSharedMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  probe_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), n, steps, from_shared,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
