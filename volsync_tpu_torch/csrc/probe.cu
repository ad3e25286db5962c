// Probes of dependent latency for chip_smoke.py's chain bounds. Not
// ports of a TPU kernel, and no path of the library launches them.
//
// probe_chase: the latency of one dependent load.
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

// probe_md5_chain: the cycles of one MD5 round on its dependency chain.
// One thread compresses ``blocks`` 64-byte blocks in a row, each on the
// state the one before left, with md5.cu's round (a logic function, a
// three-input add, a rotation and an add, each on the previous round's
// result), the message and the constants in registers and constant
// memory, and times the loop with clock64() (SM cycles) and
// %globaltimer (ns). out = {cycles, ns, the state folded} (the fold
// keeps the loop from being compiled away).
static __constant__ uint32_t kProbeMd5T[64] = {
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

__global__ void probe_md5_chain_kernel(const uint32_t* __restrict__ words,
                                       int blocks,
                                       long long* __restrict__ out) {
  if (threadIdx.x != 0) return;
  constexpr int kS[4][4] = {{7, 12, 17, 22}, {5, 9, 14, 20},
                            {4, 11, 16, 23}, {6, 10, 15, 21}};
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = words[i];
  uint32_t s0 = 0x67452301u, s1 = 0xEFCDAB89u, s2 = 0x98BADCFEu,
           s3 = 0x10325476u;
  const long long c0 = clock64();
  const unsigned long long t0 = vt_globaltimer();
  for (int k = 0; k < blocks; ++k) {
    uint32_t a = s0, b = s1, c = s2, d = s3;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      uint32_t f;
      int g;
      if (i < 16) {
        f = d ^ (b & (c ^ d));
        g = i;
      } else if (i < 32) {
        f = c ^ (d & (b ^ c));
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        f = b ^ c ^ d;
        g = (3 * i + 5) & 15;
      } else {
        f = c ^ (b | ~d);
        g = (7 * i) & 15;
      }
      const uint32_t tmp = a + f + kProbeMd5T[i] + m[g];
      a = d;
      d = c;
      c = b;
      b = b + __funnelshift_l(tmp, tmp, kS[i >> 4][i & 3]);
    }
    s0 += a; s1 += b; s2 += c; s3 += d;
  }
  const unsigned long long t1 = vt_globaltimer();
  const long long c1 = clock64();
  out[0] = c1 - c0;
  out[1] = static_cast<long long>(t1 - t0);
  out[2] = static_cast<long long>(s0 ^ s1 ^ s2 ^ s3);
}

VT_EXPORT int vt_probe_md5_chain(const void* words, int blocks, void* out,
                                 int device, void* stream) {
  int rc = vt_begin(device);
  if (rc != 0) return rc;
  probe_md5_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), blocks,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
