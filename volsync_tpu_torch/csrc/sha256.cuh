// SHA-256 compression (FIPS 180-4 section 6.2.2) for the port's SHA kernels.
//
// The state and the 16-word rolling message schedule live in registers:
// with the 64 rounds fully unrolled every w[] index is a compile-time
// constant. Rotations are funnel shifts; the round constants sit in
// constant memory and are read with uniform indices.
#pragma once

#include <stdint.h>

static __constant__ uint32_t kSha256K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t vt_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void sha256_init(uint32_t s[8]) {
  s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u;
  s[3] = 0xA54FF53Au; s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu;
  s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
}

// One compression of the 16 big-endian words ``w`` into state ``s``
// (``w`` is consumed as the rolling schedule window).
__device__ __forceinline__ void sha256_compress(uint32_t s[8],
                                                uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = vt_rotr(w15, 7) ^ vt_rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = vt_rotr(w2, 17) ^ vt_rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = vt_rotr(e, 6) ^ vt_rotr(e, 11) ^ vt_rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + S1 + ch + kSha256K[t] + wt;
    const uint32_t S0 = vt_rotr(a, 2) ^ vt_rotr(a, 13) ^ vt_rotr(a, 22);
    const uint32_t maj = (a & (b | c)) | (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}
