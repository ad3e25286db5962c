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
// A block of 64 threads keeps the 4-stage cp.async ring of sha256.cu's
// sha256_slices: stage t holds, for each thread's row, the 16-byte
// aligned window (80 bytes, five 16-byte pieces) that covers its message
// block t, copied by 5 consecutive threads, so a message's byte shift
// s & 15 is the same at every block. MD5's words are little-endian, the
// card's byte order: word i of a block is one funnel shift of two
// aligned ring words by 8 * (s & 3) bits. While a thread compresses
// block t, the copies of blocks t+1 .. t+3 are in flight. Rows past
// the buffer's end zero-fill. A block whose message bytes lie wholly past
// either end of the buffer repeats the clamped end byte; one that
// straddles an end takes a per-byte path that reads the clamped bytes
// from global memory (one or two blocks of a window at an edge).
//
// Bound: the compression chain. A round is one logic function (a LOP3),
// a three-input add, a rotation (SHF) and an add, each on the previous
// round's result: 64 dependent rounds a 64-byte block. At the signature's shape (16,384 windows of 32 KiB, 513 blocks
// each) a scheduler holds about one warp, so the longest lane's chain,
// not the card's ALU rate or its memory rate, sets the time;
// chip_smoke.py logs the compiled block's instructions and both bounds.

#include "common.cuh"

static constexpr int kMd5Threads = 64;
static constexpr int kMd5Ring = 4;
static constexpr int kMd5Pitch = 64 + 16;  // 80-byte rows: 5 pieces
static constexpr int kMd5Pieces = kMd5Pitch / 16;

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
// unrolled, so each shift amount and message index is a constant.
__device__ __forceinline__ void md5_compress(uint32_t s[4],
                                             const uint32_t m[16]) {
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
    const uint32_t tmp = a + f + kMd5T[i] + m[g];
    a = d;
    d = c;
    c = b;
    b = b + __funnelshift_l(tmp, tmp, kS[i >> 4][i & 3]);
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
}

// The two kinds of lanes. Each gives lane b's message: (start, len) in
// bytes of the buffer; kPadded lanes are whole pre-padded blocks.
struct Windows {
  static constexpr bool kPadded = false;
  const int64_t* starts;
  long long len;
  __device__ void lane(int b, long long& start, long long& n) const {
    start = starts[b];
    n = len;
  }
};

struct PaddedLanes {
  static constexpr bool kPadded = true;
  const int32_t* nblocks;
  int N;
  __device__ void lane(int b, long long& start, long long& n) const {
    const int nb = nblocks[b];
    start = static_cast<long long>(b) * N * 64;
    n = 64LL * (nb < 0 ? 0 : (nb > N ? N : nb));
  }
};

// One little-endian word of a block whose message bytes straddle an end of
// the buffer: byte j of the message (buffer position p) is the buffer's
// byte at p clamped into [0, L - 1]; past the message it is the terminator
// at j == len, else 0. Out of line: at most two blocks of a window come
// here.
__device__ __noinline__ uint32_t md5_edge_word(const uint8_t* data,
                                               long long L, long long j,
                                               long long len, long long p) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long jk = j + k;
    uint32_t v;
    if (jk < len) {
      const long long pk = p + k;
      v = data[pk < 0 ? 0 : (pk >= L ? L - 1 : pk)];
    } else {
      v = jk == len ? 0x80u : 0u;
    }
    w |= v << (8 * k);
  }
  return w;
}

template <class Lanes>
__global__ void __launch_bounds__(kMd5Threads)
md5_slices_kernel(const uint8_t* __restrict__ data, long long L, Lanes lanes,
                  uint32_t* __restrict__ out, int B) {
  constexpr int T = kMd5Threads;
  constexpr int kStage = T * kMd5Pitch;
  __shared__ __align__(16) uint8_t ring[kMd5Ring * kStage];
  __shared__ long long row_off[T];  // the row's message start, 16-aligned
  __shared__ long long row_lim[T];  // its copies end: min(end, L); -1: none
  __shared__ int block_nb;
  const int b = blockIdx.x * T + threadIdx.x;
  long long start = 0, len = 0;
  int nb = 0;
  if (b < B) {
    lanes.lane(b, start, len);
    nb = static_cast<int>(Lanes::kPadded ? len / 64 : (len + 72) / 64);
  }
  if (threadIdx.x == 0) block_nb = 0;
  row_off[threadIdx.x] = start & ~15LL;
  row_lim[threadIdx.x] = nb > 0 ? (start + len < L ? start + len : L) : -1;
  __syncthreads();
  atomicMax(&block_nb, nb);
  // Copy r (0..4) of this thread at every stage: piece c % 5 of row c / 5,
  // c = r * T + thread. A padded lane's rows are 16-aligned, so its fifth
  // piece (the next block's first bytes) is never copied.
  long long off[kMd5Pieces], lim[kMd5Pieces];
  int dst[kMd5Pieces];
#pragma unroll
  for (int r = 0; r < kMd5Pieces; ++r) {
    const int c = r * T + threadIdx.x;
    const int row = c / kMd5Pieces, piece = c % kMd5Pieces;
    off[r] = row_off[row] + piece * 16;
    lim[r] = (Lanes::kPadded && piece == kMd5Pieces - 1) ? -1
                                                         : row_lim[row];
    dst[r] = row * kMd5Pitch + piece * 16;
  }
  __syncthreads();
  const int nb_max = block_nb;

  auto issue = [&](int t) {
    uint8_t* slot = ring + (t % kMd5Ring) * kStage;
#pragma unroll
    for (int r = 0; r < kMd5Pieces; ++r) {
      const long long o = off[r] + 64LL * t;
      if (o >= 0 && o < lim[r]) {
        const long long rem = L - o;
        vt_cp_async16(slot + dst[r], data + o,
                      rem < 16 ? static_cast<int>(rem) : 16);
      }
    }
  };

  for (int t = 0; t < kMd5Ring - 1; ++t) {
    if (t < nb_max) issue(t);
    vt_cp_async_commit();
  }
  const int sh = static_cast<int>(start & 15);
  const int rot = 8 * (sh & 3);
  const unsigned long long bitlen = static_cast<unsigned long long>(len) * 8;
  uint32_t s[4];
  md5_init(s);
#pragma unroll 1
  for (int t = 0; t < nb_max; ++t) {
    vt_cp_async_wait<kMd5Ring - 2>();  // this thread's copies of t landed
    __syncthreads();  // everyone's have, and slot (t-1) % kMd5Ring is read
    if (t + kMd5Ring - 1 < nb_max) issue(t + kMd5Ring - 1);
    vt_cp_async_commit();
    if (t >= nb) continue;
    const uint32_t* r32 = reinterpret_cast<const uint32_t*>(
        ring + (t % kMd5Ring) * kStage + threadIdx.x * kMd5Pitch) + (sh >> 2);
    uint32_t w[16];
    if (Lanes::kPadded) {
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = r32[i];
    } else {
      const long long j0 = 64LL * t;  // the block's first message byte
      const long long p0 = start + j0;  // and its place in the buffer
      const long long left = len - j0;  // message bytes from here on
      if (left >= 64 && p0 >= 0 && p0 + 64 <= L) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] = __funnelshift_r(r32[i], r32[i + 1], rot);
      } else if (left > 0 && (p0 >= L || p0 + min(left, 64LL) <= 0 ||
                              (p0 >= 0 && p0 + left <= L))) {
        // The message ends in this block inside the buffer, or the block's
        // message bytes lie wholly past either end of it (each is then the
        // clamped byte data[L - 1] or data[0]): word i keeps its m message
        // bytes (the ring past them holds other bytes) and takes the
        // terminator after them.
        const bool flat = p0 >= L || p0 < 0;
        const uint32_t fill = flat ? 0x01010101u * data[p0 < 0 ? 0 : L - 1]
                                   : 0u;
        const int n = static_cast<int>(min(left, 64LL));
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int m = min(max(n - 4 * i, -1), 4);
          const uint32_t keep =
              m >= 4 ? 0xFFFFFFFFu
                     : (m <= 0 ? 0u : 0xFFFFFFFFu >> (32 - 8 * m));
          const uint32_t term = (m >= 0 && m < 4) ? 0x80u << (8 * m) : 0u;
          const uint32_t raw =
              flat ? fill : __funnelshift_r(r32[i], r32[i + 1], rot);
          w[i] = (raw & keep) | term;
        }
      } else if (left <= 0) {  // padding only
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = 0u;
        if (j0 == len) w[0] = 0x80u;
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] = md5_edge_word(data, L, j0 + 4 * i, len, p0 + 4 * i);
      }
      // The last block ends with the 64-bit little-endian bit length; its
      // words 14 and 15 lie past the terminator and are zero already.
      if (t == nb - 1) {
        w[14] = static_cast<uint32_t>(bitlen);
        w[15] = static_cast<uint32_t>(bitlen >> 32);
      }
    }
    md5_compress(s, w);
  }
  if (b >= B) return;
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

// [B, 4] states of B pre-padded lanes: ``blocks`` [B, N, 16] words
// (16-byte aligned), ``nblocks`` [B] int32.
VT_EXPORT int vt_md5_lanes(const void* blocks, const int32_t* nblocks,
                           uint32_t* out, int B, int N, int device,
                           void* stream) {
  return vt_md5_launch(blocks, static_cast<long long>(B) * N * 64,
                       PaddedLanes{nblocks, N}, out, B, device, stream);
}
